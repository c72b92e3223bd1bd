"""The wideband stream: the generator's plans and IQ, the reference
channelizer against the receiver's plain K2 (exact), the canonical form
with a channel, a whole run on the CPU under each channel plan, and the
control of K2's comparison."""

import json

import numpy as np
import pytest
import torch

from conftest import wide_tiny
from gpubench import check
from gpubench.control import control_numbers
from gpubench.reference import channelizer as rc
from gpubench.traffic.feeder import SharedBytes
from gpubench.traffic.plan import CHIPS, make_plan, render

SEED = 3_180_000_021


def _wide_u16(rng, frames, n):
    """Random wideband bytes: half the frames uniform, half around 127.5
    (the branch sums land on both sides of the clip)."""
    b = rng.integers(0, 256, 2 * frames * n, dtype=np.uint8)
    b[: frames * n] = np.clip(np.rint(rng.normal(127.5, 40.0, frames * n)), 0, 255)
    return b.view(np.uint16)


@pytest.mark.parametrize("n", [4, 12])
@pytest.mark.parametrize("first", [True, False])
def test_reference_channelizer_equals_the_receivers_plain_k2(n, first):
    from rtlamr_tpu_torch.ops.channelizer import ChannelizerSpec
    from rtlamr_tpu_torch.ops.channelizer_fused import channelize_requantize_plain

    rng = np.random.default_rng(n + 10 * first)
    wb = _wide_u16(rng, 5000, n)
    hist = _wide_u16(rng, rc.TAPS, n)
    want = channelize_requantize_plain(ChannelizerSpec(n_channels=n), torch.from_numpy(hist.copy()),
                                       torch.from_numpy(wb.copy()), first).numpy()
    got = rc.channelize(n, wb, None if first else hist)
    assert got.dtype == np.uint16 and np.array_equal(got, want)
    # The control: a bfloat16 mix differs on many samples.
    assert np.count_nonzero(rc.channelize(n, wb, None if first else hist, mix="bfloat16") != want) > 100


@pytest.mark.parametrize("f0, f1", [(-40, 300), (0, 300), (3, 300), (8, 300), (100, 9000)])
def test_spans_and_pool_equal_one_pass(f0, f1):
    """A span starting anywhere, split over the pool or not, equals the
    same frames of one pass from the stream head (zeros before it)."""
    n = 4
    u16 = _wide_u16(np.random.default_rng(1), 9000, n)
    whole = rc.channelize(n, u16, None)

    def samples(lo, hi):
        out = np.zeros(hi - lo, np.uint16)
        a, b = max(lo, 0), min(hi, u16.size)
        out[a - lo : b - lo] = u16[a:b]
        return out

    got = rc.channelize_span(n, samples, f0, f1)
    assert np.array_equal(got[:, max(-f0, 0) :], whole[:, max(f0, 0) : f1])
    assert not got[:, : max(-f0, 0)].any()
    shared = SharedBytes(u16.size * 2)
    shared.array[:] = u16.view(np.uint8)
    with check.pool(shared) as pool:
        assert np.array_equal(check.channel_rows(pool, n, f0, f1), got)


@pytest.mark.parametrize("how", ["parallel", "round_robin"])
def test_plan_places_packets_on_channels(how):
    cell = wide_tiny(how)
    n = cell.config["channels"]
    a = make_plan(cell.config, cell.traffic, SEED, 2.0)
    assert a == make_plan(cell.config, cell.traffic, SEED, 2.0) and a.channels == n
    assert len({p.meter_id for p in a.packets}) == len(a.packets)
    assert [p.index for p in a.packets] == list(range(len(a.packets)))
    assert {p.channel for p in a.packets} == set(range(n))
    bs = a.block_size
    for p in a.packets:
        assert p.offset >= bs and p.end + bs <= a.samples
        assert p.length == CHIPS[p.kind] * a.chip_length
    for c in range(n):
        own = [p for p in a.packets if p.channel == c]
        for x, y in zip(own, own[1:]):
            assert y.offset >= x.end + bs, "packets of one channel closer than a block"
    if how == "round_robin":
        assert [p.channel for p in a.packets] == [i % n for i in range(len(a.packets))]
        assert all(y.offset >= x.end + bs for x, y in zip(a.packets, a.packets[1:]))
    else:
        overlap = sum(y.offset < x.end for x, y in zip(a.packets, a.packets[1:]))
        assert overlap > 0, "a parallel plan overlaps packets across channels"
    b = make_plan(cell.config, cell.traffic, 2**31 + 5, 2.0)
    for k in ("scm", "scm+", "idm", "r900"):
        count = lambda plan: sum(p.kind == k for p in plan.packets)
        assert abs(count(a) - count(b)) <= n


def test_render_puts_each_packet_on_its_channel():
    """Channelized by the reference, a lone packet's chips sit on its own
    channel, at its offset; the render is seeded."""
    cell = wide_tiny("round_robin")
    cfg = dict(cell.config, assumed=dict(cell.config["assumed"], noise_sigma=0.0))
    plan = make_plan(cfg, cell.traffic, SEED, 1.0)
    wb = render(cfg, plan)
    assert wb.dtype == np.uint8 and wb.size == plan.stream_bytes
    assert np.array_equal(wb, render(cfg, plan))
    n = plan.channels
    rows = rc.channelize(n, wb.view(np.uint16), None)
    i = (rows & 255).astype(np.float64) - 127.5
    q = (rows >> 8).astype(np.float64) - 127.5
    power = i * i + q * q
    for p in plan.packets[:n]:
        seg = power[:, p.offset : p.end].mean(axis=1)
        assert int(np.argmax(seg)) == p.channel, (p, seg)
        assert seg[p.channel] > 100 * power[p.channel, p.end + 64 : p.end + 512].mean() + 1


def test_canonical_adds_a_channel_only_when_the_line_has_one():
    fields = {"ID": 5, "Consumption": 7}
    one = json.dumps({"Time": "t", "Offset": 0, "Length": 0, "Type": "SCM", "Message": fields})
    assert check.canonical_line(one) == '{"Message":{"Consumption":7,"ID":5},"Type":"SCM"}'
    wide = json.dumps({"Time": "t", "Offset": 0, "Length": 0, "Type": "SCM", "Message": fields,
                       "Channel": 3})
    assert check.canonical_line(wide) == check.canonical("SCM", fields, 3) != check.canonical_line(one)


def test_messages_compared_in_block_then_channel_order():
    order = {"a": (5, 0), "b": (5, 1), "c": (6, 0), "d": (6, 0)}
    want = ["a", "b", "c", "d"]
    ok = check.compare_messages(want, ["a", "b", "d", "c"], set(want), order)
    assert ok == {"missing": 0, "extra": 0, "out_of_order": 0}
    bad = check.compare_messages(want, ["b", "a", "c", "d"], set(want), order)
    assert bad["out_of_order"] == 2


@pytest.mark.parametrize("how", ["parallel", "round_robin"])
def test_wideband_run_is_correct(how, run_tiny):
    res = run_tiny(wide_tiny(how), seed=SEED)
    numbers = {k: v["value"] for k, v in res["checks"].items()}
    assert res["correct"], numbers
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(numbers) >= {"missing", "extra", "out_of_order", "k1_bits_diff", "k2_frames_diff"}
    assert res["metrics"]["emit_latency_p95_ms"]["value"] > 0


def test_k2_control_is_rejected():
    numbers = control_numbers(wide_tiny("parallel"), SEED, seconds=2.0)
    assert numbers["k2_frames_diff"] > 0, numbers


def test_traced_wideband_run_leaves_k2_work(run_tiny, monkeypatch):
    """A traced wideband run puts K2's work on a super-step's shapes beside
    K1's in what the roofline readers read."""
    from gpubench import trace, yardstick

    kept = []
    orig = trace.SubWindow.reduce

    def reduce(self, names):
        kept.append(orig(self, names))
        return kept[-1]

    monkeypatch.setattr(trace.SubWindow, "reduce", reduce)
    cell = wide_tiny("parallel")
    cell.per_layer = ["device.idle_share.live"]
    res = run_tiny(cell, seed=SEED, trace=True)
    assert res["correct"], res["checks"]
    ref = kept[0].reference
    window = 16 * 512  # -windowblocks=16 of 512-sample blocks at chip length 8
    assert ref["k2_shape"] == (4, 8, window) and "k1_live_words" in ref
    assert ref["k2_work"] == yardstick.channelizer_work(4, 8, window)


@pytest.mark.parametrize("blocks", [16, 64])
def test_chunked_reference_equals_one_decode_of_each_channel(blocks, monkeypatch):
    """The wideband reference, channelized and decoded in chunks of a few
    blocks, finds exactly what one continuous oracle decode of each channel
    finds, block for block, up to what was sent."""
    from gpubench.reference.decoder import ReferenceDecoder
    from gpubench.reference.protocols import new_parser

    monkeypatch.setattr(check, "PIECE_BLOCKS", blocks)
    cell = wide_tiny("parallel")
    plan = make_plan(cell.config, cell.traffic, SEED, 2.0)
    n, bs = plan.channels, plan.block_size
    sent = (plan.samples // bs - 5) * bs
    wb = render(cell.config, plan)
    rows = rc.channelize(n, wb.view(np.uint16)[: sent * n], None)
    want = []
    for c in range(n):
        dec = ReferenceDecoder([new_parser(x, plan.chip_length) for x in cell.config["msgtype"]],
                               arithmetic="int")
        want += [(b, c, m.meter_id(), check.canonical(m.msg_type(), m.to_dict(), c))
                 for b, m in dec.decode_capture(rows[c].view(np.uint8))]
    want.sort(key=lambda x: x[:2])
    shared, channels = SharedBytes(plan.stream_bytes), SharedBytes(plan.stream_bytes)
    shared.array[:] = wb
    with check.pool(shared, channels) as pool:
        got = check.wideband_messages(pool, cell.config, plan, sent)
    assert len(want) > 50 and got == want
