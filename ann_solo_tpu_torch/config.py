"""Configuration system: a copy of `ann_solo_tpu/config.py`.

The same arguments, defaults and ``-c/--config`` file precedence, so a
command line or config file means the same search to both packages and
`io.store.hyperparameter_hash` hashes it to the same value.  One flag
differs in meaning: ``--no_gpu`` runs the search on the CPU (the JAX
package accepts it and ignores it); without it the search needs CUDA.

A singleton `config` exposing ~35 search settings with precedence
CLI > config.ini > defaults, implemented with stdlib argparse +
configparser (the reference uses the external configargparse package).
Tests inject settings by patching ``config._namespace`` -- the same pattern
the reference test-suite uses (src/tests/utils_test.py:75-78).
"""

from __future__ import annotations

import argparse
import configparser
import os
from typing import Any, Dict, List, Optional


def _add_arguments(parser: argparse.ArgumentParser) -> None:
    # IO
    parser.add_argument(
        "spectral_library_filename",
        help="spectral library file (supported formats: splib, sptxt, mgf, "
        "fasta)",
    )
    parser.add_argument(
        "query_filename",
        help="query file (supported formats: mgf, mzml, mzxml)",
    )
    parser.add_argument(
        "out_filename",
        help="name of the mzTab output file containing the search results",
    )
    # PREPROCESSING
    parser.add_argument(
        "--resolution",
        default=None,
        type=int,
        help="spectral library resolution; masses will be rounded to the "
        "given number of decimals (default: no rounding)",
    )
    parser.add_argument("--min_mz", default=11, type=int)
    parser.add_argument("--max_mz", default=2010, type=int)
    parser.add_argument("--remove_precursor", action="store_true")
    parser.add_argument(
        "--remove_precursor_tolerance", default=0, type=float
    )
    parser.add_argument("--min_intensity", default=0.01, type=float)
    parser.add_argument("--min_peaks", default=10, type=int)
    parser.add_argument("--min_mz_range", default=250, type=float)
    parser.add_argument("--max_peaks_used", default=50, type=int)
    parser.add_argument("--max_peaks_used_library", default=50, type=int)
    parser.add_argument(
        "--scaling", default="rank", type=str, choices=["sqrt", "rank"]
    )
    # MATCHING
    parser.add_argument(
        "--precursor_tolerance_mass", type=float, required=True
    )
    parser.add_argument(
        "--precursor_tolerance_mode",
        type=str,
        choices=["Da", "ppm"],
        required=True,
    )
    parser.add_argument("--precursor_tolerance_mass_open", type=float)
    parser.add_argument(
        "--precursor_tolerance_mode_open", type=str, choices=["Da", "ppm"]
    )
    parser.add_argument("--fragment_mz_tolerance", type=float, required=True)
    parser.add_argument("--allow_peak_shifts", action="store_true")
    parser.add_argument("--fdr", default=0.01, type=float)
    parser.add_argument(
        "--model", default="rf", type=str, choices=["rf", "svm", "none"]
    )
    parser.add_argument("--fdr_min_group_size", default=100, type=int)
    # MODE
    parser.add_argument(
        "--mode", default="ann", type=str, choices=["ann", "bf"]
    )
    parser.add_argument("--bin_size", default=0.04, type=float)
    parser.add_argument("--hash_len", default=800, type=int)
    # Shipped default 512 (reference: 1024, config.py:199-204).  The
    # round-5 QUALITY ladder measured 256/512/1024 candidates
    # IDs-identical at 1% FDR on the 200k corpus (ann/bf ratio
    # 0.9884/0.9883/0.9883, QUALITY_r05_c{256,512}.json) -- candidate
    # recall plateaus by k~100 (tools/probe_diag.py), so depth beyond
    # 512 buys nothing and costs ~30% throughput (BENCH_r05).
    parser.add_argument("--num_candidates", default=512, type=int)
    parser.add_argument("--batch_size", default=16384, type=int)
    parser.add_argument(
        "--num_list",
        default=0,
        type=int,
        help="IVF list count; 0 (default) = size-aware auto "
        "(~13*sqrt(n) per charge, power-of-two -- the SWEEP_r03 "
        "IDs@FDR Pareto winner; the reference's fixed 256 can be "
        "restored explicitly)",
    )
    parser.add_argument(
        "--num_probe",
        default=0,
        type=int,
        help="IVF lists probed per query; <= 0 = size-aware auto "
        "(num_list/8 clamped to [512, 2048], never past num_list -- "
        "index.ivf.resolve_num_probe).  The reference default is a "
        "fixed 128 at num_list=256 (config.py:179-211 there -- 50%% "
        "of lists); a fixed count tuned at one scale is stale at "
        "another, so the auto rule pins the measured 1/8 ratio "
        "instead: at the 200k canonical scale it reproduces the "
        "round-5 probe-ladder winner p=512 exactly (ann/bf IDs ratio "
        "0.9949 at a 3%% bench throughput cost, "
        "QUALITY_r05_p512.json), while at 2.1M rows the shallower "
        "fixed depths measured 0.947 (1/16) and 0.923 (1/64) "
        "(QUALITY_r05_2m_p1024 vs _p256).",
    )
    parser.add_argument(
        "--no_gpu",
        action="store_true",
        help="run on the CPU (the plain PyTorch versions of the kernels); "
        "without it the search runs on the CUDA GPU and fails when there "
        "is none",
    )
    parser.add_argument("--add_decoys", action="store_true")
    parser.add_argument(
        "--fragment_tol_mode",
        type=str,
        choices=["Da", "ppm"],
        default="ppm",
    )
    # Knobs of the JAX package (no reference counterpart).
    parser.add_argument(
        "--num_shards",
        default=0,
        type=int,
        help="shard each charge's IVF lists over this many CUDA devices "
        "(0 = every device); devices left over become data-parallel query "
        "replicas.  With one device, or with --no_gpu, the search stays "
        "unsharded",
    )
    parser.add_argument(
        "--ivf_redundancy",
        default=2,
        type=int,
        help="store each library vector in its R nearest lists "
        "(ScaNN/SOAR-style redundant assignment). R=2 (default) "
        "roughly halves coarse-quantizer misses for open-search "
        "queries whose vectors diverge from their library spectrum; "
        "R=1 matches FAISS single-assignment memory",
    )
    parser.add_argument(
        "--soar_lambda",
        default=1.0,
        type=float,
        help="SOAR residual-decorrelation weight for the redundant "
        "copy's list assignment (Sun et al., NeurIPS 2023): the second "
        "copy goes to the candidate list maximizing v.c - l/2*((v-c)."
        "r1)^2 instead of the coarse rank-2 list, so queries displaced "
        "along the primary residual -- exactly the ones that miss the "
        "primary list -- find the copy. 0 restores rank-2 assignment. "
        "Measured (round 4, 200k corpus): probed-list recall@256 "
        "0.9780 -> 0.9828 at identical storage and scan cost",
    )
    parser.add_argument(
        "--index_dtype",
        default="int8",
        type=str,
        choices=["bf16", "f32", "int8"],
        help="IVF list storage precision: int8 (default; SQ8 per-row "
        "scales -- QUALITY_r04_int8 measured IDs@1%%FDR, accuracy, and "
        "candidate recall IDENTICAL to bf16 on the 200k corpus at 1/4 "
        "the scan traffic, and the exact rescoring stage absorbs the "
        "residual candidate-set differences), bf16 (the FAISS "
        "useFloat16 analog), or f32",
    )
    # Prosit / Koina (remote prediction of FASTA libraries).
    parser.add_argument("--prosit_batch_size", default=1000, type=int)
    parser.add_argument(
        "--prosit_server_url",
        default="koina.proteomicsdb.org:443",
        type=str,
    )
    parser.add_argument(
        "--prosit_model_name", default="Prosit_2020_intensity_HCD", type=str
    )
    parser.add_argument("--min_precursor_charge", type=int, default=2)
    parser.add_argument("--max_precursor_charge", type=int, default=3)
    parser.add_argument(
        "--collision_energies", nargs="+", type=int, default=[32]
    )
    parser.add_argument("--missed_cleavages", type=int, default=2)
    parser.add_argument("--protease", type=str, default="trypsin")


class Config:
    """Singleton search configuration.

    Precedence: CLI args > config file (``config.ini`` in the working
    directory, or a path given with ``-c``/``--config``) > defaults.
    """

    def __init__(self) -> None:
        self._namespace: Optional[Dict[str, Any]] = None

    def parse(self, args_str: Optional[List[str]] = None) -> None:
        """Parse configuration from CLI args (or sys.argv if None)."""
        # Extract an explicit config-file path first.
        pre = argparse.ArgumentParser(add_help=False)
        pre.add_argument("-c", "--config", default=None)
        pre_args, remaining = pre.parse_known_args(args_str)
        config_file = pre_args.config
        if config_file is None and os.path.isfile("config.ini"):
            config_file = "config.ini"

        parser = argparse.ArgumentParser(
            prog="ann_solo_tpu_torch",
            description="ANN-SoLo-TPU in PyTorch: approximate nearest "
            "neighbor spectral library searching on a CUDA GPU",
        )
        _add_arguments(parser)
        if config_file is not None:
            defaults = _read_config_file(config_file, parser)
            parser.set_defaults(**defaults)
            # Settings supplied via the config file are no longer required
            # on the command line.
            for action in parser._actions:
                if action.dest in defaults:
                    action.required = False
        self._namespace = vars(parser.parse_args(remaining))

    def __getattr__(self, option: str) -> Any:
        if option.startswith("_"):
            raise AttributeError(option)
        namespace = self.__dict__.get("_namespace")
        if namespace is None:
            raise RuntimeError("The configuration has not been initialized")
        return namespace[option]

    def __getitem__(self, item: str) -> Any:
        return self.__getattr__(item)


def _read_config_file(
    path: str, parser: argparse.ArgumentParser
) -> Dict[str, Any]:
    """Read an ini-style config file and coerce values via parser types."""
    ini = configparser.ConfigParser()
    # Support both sectioned ini files and bare "key = value" files.
    with open(path) as f_in:
        content = f_in.read()
    if not content.lstrip().startswith("["):
        content = "[DEFAULT]\n" + content
    ini.read_string(content)
    values: Dict[str, str] = dict(ini["DEFAULT"])
    for section in ini.sections():
        values.update(dict(ini[section]))

    actions = {a.dest: a for a in parser._actions}
    coerced: Dict[str, Any] = {}
    for key, raw in values.items():
        action = actions.get(key)
        if action is None:
            continue
        if isinstance(
            action, (argparse._StoreTrueAction, argparse._StoreFalseAction)
        ):
            coerced[key] = raw.strip().lower() in ("1", "true", "yes", "on")
        elif action.nargs in ("+", "*"):
            typ = action.type or str
            coerced[key] = [typ(v) for v in raw.split()]
        elif action.type is not None:
            coerced[key] = action.type(raw)
        else:
            coerced[key] = raw
    return coerced


config = Config()
