"""The port's wideband decoder (rtlamr_tpu_torch/parallel/wideband.py)
against the JAX package's ``WidebandDecoder`` (backend jnp) and the port's
copy of the NumPy oracle, on tests/test_wideband.py's capture recipe: four
channels at chip length 8, 24-block windows, packets planted on distinct
channels (one straddles a super-step boundary, one spans two)."""

import numpy as np
import pytest
import torch

from rtlamr_tpu.parallel.wideband import WidebandDecoder as JaxWideband
from rtlamr_tpu.protocols import new_parser as jax_parser
from rtlamr_tpu_torch.ops.channelizer_fused import channelize_requantize_plain
from rtlamr_tpu_torch.parallel import WidebandDecoder
from rtlamr_tpu_torch.protocols import new_parser as torch_parser
from rtlamr_tpu_torch.ref import ReferenceDecoder, synth

# The suite runs in several worker processes at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

N = 4
CHIP = 8
NAMES = ("scm", "scm+", "idm", "r900")
WINDOW_BLOCKS = 24  # smallest halo-covering window at chip 8, all-protocol


def port(**kw):
    return WidebandDecoder([torch_parser(p, CHIP) for p in NAMES], n_channels=N,
                           window_blocks=WINDOW_BLOCKS, device="cpu", **kw)


def jax_dec(**kw):
    return JaxWideband([jax_parser(p, CHIP) for p in NAMES], n_channels=N,
                       window_blocks=WINDOW_BLOCKS, **kw)


def as_list(msgs):
    return [(c, b, str(m)) for c, b, m in msgs]


@pytest.fixture(scope="module")
def capture():
    """tests/test_wideband.py ``_build_wideband``: (wideband bytes, planted
    (channel, type, id) triples, window)."""
    window = port().spec.window
    planted = [
        (0, "SCM", 111001, synth.bits_to_burst(
            synth.make_scm_bits(meter_id=111001, consumption=1), 3000)),
        # Straddles the super-step boundary on channel 1.
        (1, "SCM", 222002, synth.bits_to_burst(
            synth.make_scm_bits(meter_id=222002, consumption=2), window - 700)),
        (2, "R900", 333003, synth.r900_burst(
            synth.make_r900_symbols(meter_id=333003), 5000)),
        # IDM spans most of super-steps 0-1 on channel 3.
        (3, "IDM", 444004, synth.bits_to_burst(synth.make_idm_bits(serial=444004), 300)),
        (0, "SCM", 555005, synth.bits_to_burst(
            synth.make_scm_bits(meter_id=555005, consumption=5), 20000)),
        (2, "SCM", 666006, synth.bits_to_burst(
            synth.make_scm_bits(meter_id=666006, consumption=6), 2 * window - 2000)),
    ]
    wb = synth.render_wideband(3 * window, [(c, b) for c, _, _, b in planted], N, CHIP,
                               amplitude=90.0, noise=2.0, seed=21)
    return wb, [(c, t, mid) for c, t, mid, _ in planted], window


@pytest.fixture(scope="module")
def jax_stream(capture):
    return as_list(jax_dec().decode_capture(capture[0]))


def test_wideband_matches_jax(capture, jax_stream):
    wb, planted, _ = capture
    dec = port()
    msgs = dec.decode_capture(wb)
    got = as_list(msgs)
    assert got == jax_stream
    got_ids = {(c, m.meter_id()) for c, _, m in msgs}
    assert {(c, mid) for c, _, mid in planted} <= got_ids
    jd = jax_dec()
    assert dec.window_bytes == jd.window_bytes
    assert dec.wideband_sample_rate == jd.wideband_sample_rate
    np.testing.assert_array_equal(dec.channel_center_freqs(915_000_000),
                                  jd.channel_center_freqs(915_000_000))
    snap = dec.metrics_snapshot()
    assert snap["windows_decoded"] == 3 * N and snap["messages_out"] == len(got)


def test_wideband_metrics_snapshot_sums_counters_only(capture):
    """The counters summed over the channels; the time since the decoder was
    made taken once, not summed over them."""
    dec = port()
    dec.decode_capture(capture[0])
    snap = dec.metrics_snapshot()
    chans = [c.metrics for c in dec._chan]
    assert set(snap) == {"elapsed_s", *chans[0].counters()}
    for k in chans[0].counters():
        assert snap[k] == sum(m.counters()[k] for m in chans), k
    assert snap["samples_in"] == 3 * N * dec.spec.window
    assert 0 < snap["elapsed_s"] <= round(chans[0].elapsed(), 3)


def port_channel_streams(dec, wb):
    """The port's channelized u8 streams, chunked exactly like the decoder
    (super-steps of window_bytes, history carried, zero head)."""
    chspec, n, p = dec.chspec, dec.n_channels, dec.chspec.history_frames
    hist = torch.zeros(p * n, dtype=torch.uint16)
    outs = []
    for i, lo in enumerate(range(0, wb.size, dec.window_bytes)):
        u16 = torch.from_numpy(wb[lo : lo + dec.window_bytes].view(np.uint16).copy())
        outs.append(channelize_requantize_plain(chspec, hist, u16, i == 0).numpy())
        hist = u16[u16.shape[0] - p * n :]
    return np.concatenate(outs, axis=1).view(np.uint8)  # (N, 2F) interleaved


def test_wideband_union_vs_oracle(capture):
    """The port's stream equals the union of exact-int oracle runs over the
    port's own channel streams."""
    wb = capture[0]
    dec = port()
    got = as_list(dec.decode_capture(wb))
    streams = port_channel_streams(dec, wb)
    want = []
    for c in range(N):
        oracle = ReferenceDecoder([torch_parser(p, CHIP) for p in NAMES], arithmetic="int")
        want.extend((c, b, str(m)) for b, m in oracle.decode_capture(streams[c]))
    assert sorted(got) == sorted(want)


def test_wideband_feed_ragged_chunks(capture, jax_stream):
    """Streaming feed() in ragged chunk sizes == one-shot decode_capture."""
    wb = capture[0]
    dec = port()
    got = []
    rng = np.random.default_rng(11)
    pos = 0
    while pos < wb.size:
        n = int(rng.integers(1, 3 * dec.cfg.block_size))
        got.extend(as_list(dec.feed(wb[pos : pos + n])))
        pos += n
    got.extend(as_list(dec.flush()))
    assert got == jax_stream


def test_wideband_cross_channel_dedup(capture):
    """Ghosts of strong bursts in the adjacent slab collapse: exactly the
    planted packets, each once, on its own channel."""
    wb, planted, _ = capture
    dec = port(cross_channel_dedup=True)
    msgs = dec.decode_capture(wb)
    assert sorted((c, m.msg_type(), m.meter_id()) for c, _, m in msgs) == sorted(planted)
    assert as_list(msgs) == as_list(jax_dec(cross_channel_dedup=True).decode_capture(wb))
    assert dec.metrics_snapshot()["messages_dropped_dup"] > 0


def jax_state(dec):
    """The JAX decoder's stream state, read from its attributes."""
    return {
        "wb_hist": np.asarray(dec._wb_hist),
        "chan_tail": np.asarray(dec._chan_tail),
        "first": dec._first,
        "window_index": dec._window_index,
        "channels": [{
            "carry": np.asarray(c._carry),
            "first": c._first,
            "window_index": c._window_index,
            "last_block": c._last_block,
            "dedup_prev": c._deduper.prev,
            "dedup_next": c._deduper.next,
            "pending": np.asarray(c._pending),
        } for c in dec._chan],
        "xchan_seen": [(tuple(d), b, c) for d, (b, c) in dec._xchan.seen.items()],
        "pending": np.asarray(dec._pending),
    }


@pytest.mark.parametrize("xchan", [False, True])
def test_state_handover_from_jax(capture, jax_stream, xchan):
    """The JAX decoder runs the first super-step, its state moves to the
    port at that boundary, the port finishes: the stream of one JAX run.
    Then the port's own export_state/load_state, cut mid-super-step."""
    wb = capture[0]
    want = jax_stream if not xchan else as_list(
        jax_dec(cross_channel_dedup=True).decode_capture(wb))
    first = jax_dec(cross_channel_dedup=xchan)
    cut = first.window_bytes
    head = as_list(first.feed(wb[:cut]) + first.drain())
    dec = port(cross_channel_dedup=xchan)
    dec.load_state(jax_state(first))
    assert not dec._first and dec._window_index == 1
    tail = as_list(dec.feed(wb[cut:]) + dec.flush())
    assert head + tail == want

    a = port(cross_channel_dedup=xchan)
    cut2 = int(1.6 * a.window_bytes) | 1
    head2 = as_list(a.feed(wb[:cut2]) + a.drain())
    state = a.export_state()
    assert state["pending"].size == cut2 - a.window_bytes
    b = port(cross_channel_dedup=xchan)
    b.load_state(state)
    assert head2 + as_list(b.feed(wb[cut2:]) + b.flush()) == want


def test_export_state_needs_drain_and_matching_geometry(capture):
    dec = port()
    dec.feed(capture[0][: dec.window_bytes])
    with pytest.raises(RuntimeError, match="drain"):
        dec.export_state()
    dec.drain()
    state = dec.export_state()
    state["chan_tail"] = state["chan_tail"][:, :-1]
    with pytest.raises(ValueError, match="load_state"):
        port().load_state(state)


def test_feed_copies_the_chunk(capture, jax_stream):
    wb = capture[0]
    dec = port()
    buf = np.empty(50001, np.uint8)
    out = []
    for pos in range(0, wb.size, buf.size):
        part = wb[pos : pos + buf.size]
        buf[: part.size] = part
        out.extend(dec.feed(buf[: part.size]))
        buf[:] = 0  # reusing the read buffer must not change the result
    out.extend(dec.flush())
    assert as_list(out) == jax_stream


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WidebandDecoder([torch_parser("scm", 72)], n_channels=4)
