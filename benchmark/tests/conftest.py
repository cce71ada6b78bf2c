"""Fixtures of the benchmark's CPU tests: a tiny checkout root holding a
cell of its own, whose files are made from the real ones."""

import json
import os
import shutil
import time

import pytest

from benchmark import workload

REPO = workload.ROOT
TINY_CELL = "tiny.openmod"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs the CUDA card; skips without one")


class HostStandIn:
    """The card's part in a run, played by the CPU for the tests: batches
    timed by the host's clock."""

    device = "cpu"

    @staticmethod
    def activities():
        """The CPU stands in for the device; no operation of it is a
        device operation."""
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU]

    def mark(self):
        return time.perf_counter()

    @staticmethod
    def elapsed_ms(start, stop) -> float:
        return (stop - start) * 1e3

    def synchronize(self) -> None:
        pass

    def free(self) -> None:
        pass

    def info(self) -> dict:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}


def tiny_config() -> dict:
    with open(os.path.join(REPO, "benchmark", "configs",
                           "iprg2012_c2_131k.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", n_library=2048, num_list=32, num_probe=8,
               num_candidates=32)
    return cfg


def tiny_traffic(name: str = "openmod") -> dict:
    with open(os.path.join(REPO, "benchmark", "traffic", f"{name}.json")) as f:
        traffic = json.load(f)
    traffic.update(batch=64, pool_batches=2, warmup_batches=1)
    return traffic


def make_root(path, limits=None) -> str:
    """A checkout root with BENCHMARK.json's metrics and one tiny cell
    (`TINY_CELL`): the real metric readers, a tiny configuration and
    traffic mix, and check limits (the real cell's by default)."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"] = [{"name": "tiny", "source": "test",
                        "file": "benchmark/configs/tiny.json", "reduced": [],
                        "why": "test"}]
    spec["workloads"] = [{"name": TINY_CELL, "config": "tiny",
                          "traffic": "tiny", "chips": 1, "why": "test"}]
    bench = os.path.join(path, "benchmark")
    for sub in ("configs", "traffic", "checks"):
        os.makedirs(os.path.join(bench, sub))
    shutil.copytree(os.path.join(REPO, "benchmark", "metrics"),
                    os.path.join(bench, "metrics"))
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as f:
        json.dump(tiny_config(), f)
    with open(os.path.join(bench, "traffic", "tiny.json"), "w") as f:
        json.dump(tiny_traffic(), f)
    if limits is None:
        with open(os.path.join(REPO, "benchmark", "checks",
                               "massivekb_c2_2m.openmod.json")) as f:
            limits = json.load(f)
        limits["sample"] = 64
    with open(os.path.join(bench, "checks", f"{TINY_CELL}.json"), "w") as f:
        json.dump(limits, f)
    return str(path)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
