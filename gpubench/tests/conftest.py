"""Harness tests: ``python -m pytest gpubench/tests -q`` from the checkout's
root, on the CPU (the receiver runs its plain PyTorch versions there, at
chip length 8 and short windows); tests marked ``cuda`` need the card and
skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


#: the cells the tests run, as (configuration, traffic mix, chips)
CELLS = {
    "nb_all.live16": ("nb_all", "live_16", 1),
}


def cell_of(cell_name: str):
    """A cell of ``CELLS`` at its own size, from its configuration and mix
    files."""
    import json

    from gpubench import catalog

    config, traffic, chips = CELLS[cell_name]
    with open(os.path.join(ROOT, "gpubench", "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "gpubench", "traffic", f"{traffic}.json")) as f:
        t = json.load(f)
    ends = ["setup_s", "emit_latency_p95_ms", "emit_latency_p50_ms"]
    units = {"setup_s": "s", "emit_latency_p95_ms": "ms", "emit_latency_p50_ms": "ms"}
    return catalog.Cell(cell_name, cfg, t, chips, ends, [], units)


def tiny(cell_name: str):
    """A cell cut to a CPU's size: chip length 8, paced below real time
    (the CPU decodes slowly), an earlier window checked."""
    cell = cell_of(cell_name)
    cfg, t = cell.config, cell.traffic
    cfg["symbollength"] = 8
    cfg["flags"] = [f.replace("-symbollength=72", "-symbollength=8") for f in cfg["flags"]]
    cfg["sample_rate"] = 65536
    t["check_windows"] = [5, 20]
    t["warmup_blocks"] = 32
    return cell


def wide_tiny(channel_plan: str = "parallel"):
    """The test-only wideband cell (``wb4_test.json`` and ``wb4_mix.json``
    beside this file): 4 channels at chip length 8, paced below real time,
    its packets placed by ``channel_plan``."""
    import json

    from gpubench import catalog

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "wb4_test.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(here, "wb4_mix.json")) as f:
        t = json.load(f)
    t["channel_plan"] = channel_plan
    ends = ["setup_s", "emit_latency_p95_ms", "emit_latency_p50_ms"]
    units = {"setup_s": "s", "emit_latency_p95_ms": "ms", "emit_latency_p50_ms": "ms"}
    return catalog.Cell(f"wb4_test.{channel_plan}", cfg, t, 1, ends, [], units)


@pytest.fixture
def run_tiny():
    """Run a tiny cell on the CPU; returns the result line's object."""
    import time

    from gpubench import harness

    def run(cell, seed=20251017, seconds=2.0, trace=False):
        return harness.run_cell(cell, seed, seconds, trace, time.monotonic(), device="cpu",
                                log=lambda *a: None)

    return run
