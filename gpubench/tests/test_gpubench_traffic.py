"""The traffic generator: seeded plans, every type, no overlaps, the same
mix of work for every seed, the one-channel plan and stream fixed by
digest, and the feeder's pacing arithmetic."""

import hashlib
import json

import numpy as np
import pytest

from conftest import cell_of
from gpubench.traffic import feeder
from gpubench.traffic.plan import CHIPS, make_plan, render

CELLS = ["nb_all.live16"]


def test_open_loop_plan_is_seeded():
    cell = cell_of("nb_all.live16")
    a = make_plan(cell.config, cell.traffic, 3_000_000_001, 20)
    assert a == make_plan(cell.config, cell.traffic, 3_000_000_001, 20)
    c = make_plan(cell.config, cell.traffic, 2**31 + 12345, 20)
    assert [p.meter_id for p in a.packets] != [p.meter_id for p in c.packets]
    count = lambda plan, k: sum(p.kind == k for p in plan.packets)
    for k in ("scm", "scm+", "idm", "r900"):
        assert abs(count(a, k) - count(c, k)) <= 1


@pytest.mark.parametrize("name", CELLS)
def test_plan_types_ids_and_spacing(name):
    cell = cell_of(name)
    plan = make_plan(cell.config, cell.traffic, 77, 20)
    assert {p.kind for p in plan.packets} == {"scm", "scm+", "idm", "r900"}
    assert len({p.meter_id for p in plan.packets}) == len(plan.packets)
    bs = plan.block_size
    for p in plan.packets:
        assert p.offset >= bs and p.end + bs <= plan.samples
        assert p.length == CHIPS[p.kind] * plan.chip_length
    for a, b in zip(plan.packets, plan.packets[1:]):
        assert b.offset >= a.end + bs, "packets closer than a block"


def test_render_is_seeded():
    cell = cell_of("nb_all.live16")
    plan = make_plan(cell.config, cell.traffic, 11, 1)
    a = render(cell.config, plan)
    assert a.dtype == np.uint8 and a.size == plan.stream_bytes
    assert np.array_equal(a, render(cell.config, plan))
    assert not np.array_equal(a, render(cell.config, make_plan(cell.config, cell.traffic, 12, 1)))


def plan_digest(plan) -> str:
    rows = [[p.index, p.kind, p.offset, p.length, p.meter_id, [list(f) for f in p.fields]]
            for p in plan.packets]
    head = [plan.samples, plan.chip_length, plan.block_size, plan.window,
            plan.packet_length, plan.noise_seed]
    return hashlib.sha256(json.dumps([head, rows]).encode()).hexdigest()


#: nb_all.live16's plan of a 20 s run and the sha256 of its stream's first
#: 64 MiB, as the generator made them before it took wideband streams
NB_DIGESTS = {
    3_180_000_001: (325, "d11c4839a01bef0781ea96537f35eb3a66253655252a3b4a487211354bcdde07",
                    "1844f6a618130b814eb740ff11dd9dea7637607d999c5df3e8e93c1dc120d888"),
    2**31 + 77: (325, "5ce33344579d389bd8c391fcccf3c00b12950359dd30f532048313c1052d5792",
                 "bb2147110210fb4e3cfa8c54e9b5a413c38fdc408649c9cdd628e6f712e73faa"),
}


@pytest.mark.parametrize("seed", sorted(NB_DIGESTS))
def test_one_channel_plan_and_stream_unchanged(seed):
    cell = cell_of("nb_all.live16")
    plan = make_plan(cell.config, cell.traffic, seed, 20.0)
    count, want_plan, want_stream = NB_DIGESTS[seed]
    assert plan.channels == 1 and all(p.channel == 0 for p in plan.packets)
    assert len(plan.packets) == count and plan_digest(plan) == want_plan
    data = render(cell.config, plan)
    assert hashlib.sha256(data[: 64 << 20].tobytes()).hexdigest() == want_stream


def test_schedule_and_lateness():
    due = feeder.schedule(4, 10.0, 0.5)
    assert np.allclose(due, [10.5, 11.0, 11.5, 12.0])
    late = np.array([0.0, 0.002, 0.010, 0.011])
    own = np.array([0.0, 0.002, 0.0005, 0.0001])  # the last two held up by back-pressure
    r = feeder.lateness_report(late, own, 0.0035)
    assert r["own_late_over_one_block"] == 0
    assert r["held_over_one_block"] == 2
    assert r["late_ms_max"] == pytest.approx(11.0)
    assert feeder.lateness_report(late, late, 0.0035)["own_late_over_one_block"] == 2

