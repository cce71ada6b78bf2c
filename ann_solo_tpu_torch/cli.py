"""Command-line interface (the port of `ann_solo_tpu/cli.py`; reference:
ann_solo/ann_solo.py).

    python -m ann_solo_tpu_torch.cli library queries out.mztab [options]

The same arguments as the JAX package's CLI.  The search runs on the CUDA
GPU, or on the CPU with ``--no_gpu``; without ``--no_gpu`` and without a
GPU it fails.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import List, Optional, Union

from ann_solo_tpu_torch import rndm

rndm.set_seeds()

from ann_solo_tpu_torch.config import config


def ann_solo(
    spectral_library_filename: str,
    query_filename: str,
    out_filename: str,
    **kwargs: Union[bool, float, int, str],
) -> int:
    """Run a search with explicit settings (reference ann_solo.py:14-55).

    Keys must match the command-line arguments (without the '--' prefix);
    boolean flags toggle with True/False.
    """
    args = sum(
        [
            ["--" + k, str(v)]
            for k, v in kwargs.items()
            if not isinstance(v, bool)
        ],
        [],
    )
    flags = [
        "--" + k for k, v in kwargs.items() if v and isinstance(v, bool)
    ]
    return main(
        [spectral_library_filename, query_filename, out_filename,
         *args, *flags]
    )


def main(args: Optional[Union[str, List[str]]] = None) -> int:
    logging.captureWarnings(True)
    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    if not any(
        getattr(h, "_ann_solo_tpu", False) for h in root.handlers
    ):  # repeated main() calls must not stack handlers
        handler = logging.StreamHandler(sys.stderr)
        handler.setLevel(logging.DEBUG)
        handler.setFormatter(
            logging.Formatter(
                "{asctime} {levelname} [{name}/{processName}] "
                "{module}.{funcName} : {message}",
                style="{",
            )
        )
        handler._ann_solo_tpu = True
        root.addHandler(handler)
    try:
        return _run(args)
    finally:  # also when the run raises, as a refused option does
        root.handlers[:] = [
            h for h in root.handlers
            if not getattr(h, "_ann_solo_tpu", False)
        ]


def _run(args: Optional[Union[str, List[str]]]) -> int:
    config.parse(args)

    from ann_solo_tpu_torch import search
    from ann_solo_tpu_torch.io import mztab
    from ann_solo_tpu_torch.utils.profiling import profiler

    profiler.reset()

    # The query filename may be a glob: all matching files are searched
    # by ONE engine instance (library store and indexes stay resident).
    # This is the production fan-out pattern -- the reference ran one
    # process per raw file (4,207 independent invocations for Kim2014,
    # kim2014_stats.ipynb), paying the library load every time.
    import glob as _glob

    is_glob = _glob.has_magic(config.query_filename)
    query_files = (
        sorted(_glob.glob(config.query_filename))
        or [config.query_filename]
    )

    def out_for(query_filename: str) -> str:
        # Per-file naming applies whenever the query side was a glob (or
        # the output is a directory/template) -- even a glob matching
        # one file must land inside the requested directory.
        base = os.path.splitext(os.path.basename(query_filename))[0]
        if os.path.isdir(config.out_filename):
            return os.path.join(config.out_filename, base + ".mztab")
        if "{}" in config.out_filename:
            return config.out_filename.format(base)
        if len(query_files) == 1 and not is_glob:
            return config.out_filename
        raise ValueError(
            "Multiple query files matched; out_filename must be a "
            "directory or contain a '{}' placeholder"
        )

    # Validate the naming scheme BEFORE the (expensive) engine build.
    out_names = [out_for(f) for f in query_files]
    if len(set(out_names)) != len(out_names):
        raise ValueError(
            "Query files map to colliding output names (same basename "
            "in different directories?): use a '{}' template with "
            "distinct names"
        )

    spec_lib = search.SpectralLibrary(
        config.spectral_library_filename,
        device="cpu" if config.no_gpu else None,
    )
    try:
        for query_filename, out_filename in zip(query_files, out_names):
            with profiler.stage("search"):
                identifications = spec_lib.search(query_filename)
            with profiler.stage("mzTab write"):
                mztab.write_mztab(
                    identifications,
                    out_filename,
                    spec_lib._store.get_version(),
                    config,
                    query_filename=query_filename,
                )
    finally:
        spec_lib.shutdown()
    return 0


if __name__ == "__main__":
    main()
