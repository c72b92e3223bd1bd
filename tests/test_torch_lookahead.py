"""The window program's look-ahead: each streamed window of a
``WindowDecoder`` also searches the next window's first blocks with the
bits it already holds, after the window's own buffer has left for the
host, and the blocks whose messages are all known go out with the feed
that brings them.

On the CPU the decoder, fed a block at a time and completing each window
at once as the CLI's ``-latency`` loop does, gives the oracle's stream
message for message, each message no later than a decoder without the
look-ahead would (with the feed that completes its window) and its short
packets a window sooner; the look-ahead's search gives the next window's
rows; its state and checkpoints carry the last block it emitted. The
``cuda``-marked tests hold the look-ahead's mask kernel and the variant's
buffer to the plain versions on the card; run them with
``python -m pytest --noconftest tests/test_torch_lookahead.py -m cuda``."""

import dataclasses

import numpy as np
import pytest
import torch

from rtlamr_tpu_torch.decoder import WindowDecoder
from rtlamr_tpu_torch.ops.frontend import (
    decode_window_staged_packed,
    lookahead_size,
    pack_results,
    unpack_lookahead,
    unpack_results,
)
from rtlamr_tpu_torch.ops.search import lookahead_guards, search_slice
from rtlamr_tpu_torch.ops.spec import (
    lookahead_geometry,
    lookahead_spec,
    resolved_blocks,
    staged_geometry,
)
from rtlamr_tpu_torch.ops.stencil import lookahead_mask, masks_plain, stencil_plain
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.protocols.base import build_decoder_config
from rtlamr_tpu_torch.ref import ReferenceDecoder, synth
from rtlamr_tpu_torch.utils import observability
from rtlamr_tpu_torch.utils.bits import unpack_bits
from rtlamr_tpu_torch.utils.observability import TRACER

# The suite runs in several worker processes at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

NB_ALL = ("scm", "scm+", "idm", "r900")
SIX = ("scm", "scm+", "idm", "netidm", "r900", "r900bcd")


def parsers(names, chip):
    return [new_parser(n, chip) for n in names]


def config(names, chip):
    return build_decoder_config(parsers(names, chip))


def burst(kind, i, start):
    """A packet of ``kind`` (its fields from ``i``) from sample ``start``."""
    if kind == "scm":
        return synth.bits_to_burst(synth.make_scm_bits(meter_id=100000 + i, consumption=i), start)
    if kind == "scm+":
        return synth.bits_to_burst(synth.make_scmplus_bits(endpoint_id=200000 + i, consumption=i),
                                   start)
    if kind == "idm":
        return synth.bits_to_burst(synth.make_idm_bits(serial=300000 + i), start)
    if kind == "netidm":
        return synth.bits_to_burst(synth.make_netidm_bits(serial=400000 + i), start)
    if kind == "5555scm+":  # an SCM+ packet behind the bits that begin IDM's preamble
        bits = np.concatenate([unpack_bits(np.frombuffer(b"\x55\x55", np.uint8)),
                               synth.make_scmplus_bits(endpoint_id=200000 + i, consumption=i)])
        return synth.bits_to_burst(bits, start - 16 * 2 * 72)
    return synth.r900_burst(synth.make_r900_symbols(meter_id=500000 + i, consumption=i), start)


def planted(names, chip, events, blocks, seed=3):
    """``blocks`` blocks of noisy idle carrier with a packet for each
    (kind, position, id) event, found by the decoders at that search
    position: a packet is found PacketLength + SymbolLength samples after
    its first sample, its block the one of its first preamble hit, some
    half a chip earlier."""
    cfg = config(names, chip)
    lead = cfg.packet_length + cfg.symbol_length
    return synth.render_iq(blocks * cfg.block_size,
                           [burst(kind, i, q - lead) for kind, q, i in events],
                           chip, noise=3.0, seed=seed)


def train(names, chip, blocks, seed, gap_blocks=2):
    """The benchmark cell's traffic in small: the types in turn, one every
    PacketLength + ``gap_blocks`` blocks, each shifted by under a block."""
    cfg = config(names, chip)
    rng = np.random.default_rng(seed)
    events, q, i = [], 2 * cfg.block_size, 0
    while q + cfg.packet_length < (blocks - 2) * cfg.block_size:
        events.append((names[i % len(names)], q + int(rng.integers(cfg.block_size)), i))
        q += cfg.packet_length + gap_blocks * cfg.block_size
        i += 1
    return planted(names, chip, events, blocks, seed)


def feed_blocks(dec, iq):
    """The ``-latency`` loop: one block a feed, each window completed at
    once. (feed call, block, message) rows; the flush's call is the
    number of feeds."""
    step = 2 * dec.cfg.block_size
    rows = []
    for call, pos in enumerate(range(0, iq.size, step)):
        rows += [(call, b, line(m)) for b, m in dec.feed(iq[pos : pos + step]) + dec.drain()]
    rows += [(-(-iq.size // step), b, line(m)) for b, m in dec.flush()]
    return rows


def line(msg):
    return f"{msg.msg_type()} {msg}"


def stream(rows):
    return [(b, m) for _, b, m in rows]


def oracle(names, chip, iq):
    dec = ReferenceDecoder(parsers(names, chip), arithmetic="int")
    return [(b, line(m)) for b, m in dec.decode_capture(iq)]


def both(names, chip, window_blocks, iq, **kw):
    """(the rows without the look-ahead, the decoder's rows, the decoder).
    Without it a message goes out with the feed that completes its window,
    or with the flush."""
    dec = WindowDecoder(parsers(names, chip), window_blocks=window_blocks, device="cpu", **kw)
    assert dec.lookahead
    rows = feed_blocks(dec, iq)
    flush = -(-iq.size // (2 * dec.cfg.block_size))
    wb = window_blocks
    return [(min((b // wb + 1) * wb - 1, flush), b, m) for _, b, m in rows], rows, dec


def sooner(without, ahead):
    """Messages the look-ahead emitted in an earlier feed call."""
    return [(t[1], t[2]) for t, a in zip(without, ahead) if a[0] < t[0]]


# ---------------------------------------------------------------------------
# Geometry


def test_geometry_of_the_benchmark_configuration():
    """At -msgtype=all and chip length 72 the look-ahead is 12 blocks; each
    short type fits PacketLength less its own length (the R900 digits'
    reach below that), IDM nothing. A spec whose longest packet is its only
    one has no look-ahead."""
    dec = WindowDecoder(parsers(NB_ALL, 72), window_blocks=16, device="cpu")
    la = lookahead_geometry(dec.spec)
    assert la.extent == 12 * 8192
    assert la.fits == (105984 - 96 * 144, 105984 - 128 * 144, 0, 105984 - 116 * 144)
    assert dec.lookahead
    scm = WindowDecoder(parsers(["scm"], 72), window_blocks=16, device="cpu")
    assert lookahead_geometry(scm.spec).extent == 0 and not scm.lookahead


def test_resolved_blocks_rule():
    """A block is resolved when every group's packets fit through its end
    or the group has no raw hit from its fit to the block's end."""
    spec = WindowDecoder(parsers(NB_ALL, 72), window_blocks=16, device="cpu").spec
    la = lookahead_geometry(spec)
    none = [la.extent] * 4
    assert resolved_blocks(spec, none) == 12
    # An IDM hit (fit 0) in block 2 stops the run there.
    assert resolved_blocks(spec, [la.extent, la.extent, 2 * 8192 + 5, la.extent]) == 2
    assert resolved_blocks(spec, [la.extent, la.extent, 0, la.extent]) == 0
    # An SCM hit just past its fit (11.25 blocks) leaves 11 blocks.
    assert resolved_blocks(spec, [la.fits[0], la.extent, la.extent, la.extent]) == 11
    # SCM+ and R900 fit 10 whole blocks: a hit past either fit cuts to 10.
    assert resolved_blocks(spec, [la.extent, la.fits[1] + 3, la.extent, la.extent]) == 10
    assert resolved_blocks(spec, [la.extent, la.extent, la.extent, la.fits[3]]) == 10


# ---------------------------------------------------------------------------
# The window program's variant


def staged_windows(spec, iq, k):
    """The first ``k`` windows of ``iq`` staged as the feed path stages
    them (the carried halo first, zeros before the stream)."""
    hs, w = spec.halo_staged, spec.window
    u16 = np.concatenate([np.zeros(hs, np.uint16), iq.view(np.uint16)])
    out = np.zeros((k, staged_geometry(spec).staged_samples), np.uint16)
    for i in range(k):
        part = u16[i * w : i * w + hs + w]
        out[i, : part.size] = part
    return out


def rows_by_position(res, g, lo, hi, shift):
    """Group ``g``'s kept rows with positions in ``[lo, hi)``, shifted."""
    idx = np.asarray(res["idx"][g])
    sel = (idx >= lo) & (idx < hi)
    out = [idx[sel] - shift, res["pvalid"][g][sel], res["bytes"][g][sel]]
    if g in res["symbols"]:
        out.append(res["symbols"][g][sel])
    return out


@pytest.mark.parametrize("names, chip, window_blocks", [
    (NB_ALL, 72, 16), (NB_ALL, 8, 4), (SIX, 8, 24)])
def test_variant_keeps_the_window_buffer_and_gives_the_next_windows_rows(
        names, chip, window_blocks):
    """With the look-ahead the window's buffer is the plain call's byte for byte;
    the look-ahead's rows in its resolved blocks are the rows the later
    windows find there, position for position."""
    spec = WindowDecoder(parsers(names, chip), window_blocks=window_blocks, device="cpu").spec
    la = lookahead_geometry(spec)
    w, bs = spec.window, spec.block_size
    windows = 5 + la.extent // w
    iq = train(names, chip, windows * window_blocks + la.extent // bs + 2, seed=21, gap_blocks=1)
    staged = staged_windows(spec, iq, windows)
    bufs = [decode_window_staged_packed(spec, torch.from_numpy(row), i == 0).numpy()
            for i, row in enumerate(staged)]
    resolved_rows = 0
    for s in range(1, windows - la.extent // w - 1):
        t = torch.from_numpy(staged[s])
        buf, ahead_fn = decode_window_staged_packed(spec, t, False, lookahead=True)
        assert np.array_equal(buf.numpy(), bufs[s])
        got = ahead_fn().numpy()
        assert got.size == lookahead_size(spec)
        ahead, guards = unpack_lookahead(spec, got)
        n = resolved_blocks(spec, guards)
        assert n > 0
        for j in range(n):  # block j of the look-ahead: a block of window s + 1 + j // wb
            later = s + 1 + j * bs // w
            lo = (j * bs) % w
            want = unpack_results(spec, bufs[later])
            for g in range(len(spec.groups)):
                a = rows_by_position(ahead, g, j * bs, (j + 1) * bs, j * bs - lo)
                b = rows_by_position(want, g, lo, lo + bs, 0)
                for x, y in zip(a, b):
                    assert np.array_equal(x, y), (s, j, g)
                resolved_rows += a[0].size
    assert resolved_rows > 0


@pytest.mark.parametrize("window_blocks", [24, 4])
def test_lookahead_buffer_is_search_slice_past_the_window(window_blocks):
    """The look-ahead's buffer is ``search_slice`` over the streams from the
    window's end on, at capacities scaled to its extent, with the mask of
    ``masks_plain`` there, then the guards: each group's first raw hit at
    or past its fit."""
    names, chip = NB_ALL, 8
    spec = WindowDecoder(parsers(names, chip), window_blocks=window_blocks, device="cpu").spec
    la, la_spec = lookahead_geometry(spec), lookahead_spec(spec)
    scale = la.extent / spec.window
    assert la_spec.max_hits == -(-spec.max_hits * la.extent // spec.window) >= spec.max_hits * scale
    assert la_spec.gather_hits >= spec.gather_hits * scale
    assert la_spec.gather_rows == min(-(-spec.gather_rows * la.extent // spec.window),
                                      la.extent // 128)
    windows = 4 + la.extent // spec.window
    iq = train(names, chip, (windows + 1) * window_blocks + la.extent // spec.block_size,
               seed=5, gap_blocks=1)
    w = spec.window
    for row in staged_windows(spec, iq, windows)[1:]:  # the first with a hit ahead
        t = torch.from_numpy(row)
        bits, q6, _ = stencil_plain(spec, t, False)
        ahead2d = lookahead_mask(spec, bits)
        if ahead2d.any():
            break
    assert ahead2d.any()
    assert torch.equal(ahead2d, masks_plain(dataclasses.replace(spec, window=la.extent), bits[w:]))
    guards = lookahead_guards(spec, ahead2d)
    want = torch.cat([pack_results(search_slice(la_spec, bits[w:], q6[w:], ahead2d)),
                      guards.view(torch.uint8)])
    _, ahead_fn = decode_window_staged_packed(spec, t, False, lookahead=True)
    assert torch.equal(ahead_fn(), want)
    flat = ahead2d.reshape(-1).numpy()
    for g, fit in enumerate(la.fits):
        hits = np.nonzero((flat >> g) & 1)[0]
        hits = hits[hits >= fit]
        assert int(guards[g]) == (hits[0] if hits.size else la.extent)


# ---------------------------------------------------------------------------
# The stream: the oracle's, message for message


def case_train(names, chip, window_blocks, blocks, seed, gap_blocks=2):
    return names, chip, window_blocks, train(names, chip, blocks, seed, gap_blocks), {}


def case_events(chip, window_blocks, blocks, events, **kw):
    """Events at (kind, window, block of the window, offset in the block),
    and the fields' seed when two packets are to be the same."""
    cfg = config(NB_ALL, chip)
    bs, w = cfg.block_size, window_blocks * cfg.block_size
    ev = [(e[0], e[1] * w + e[2] * bs + e[3], e[4] if len(e) > 4 else i)
          for i, e in enumerate(events)]
    return NB_ALL, chip, window_blocks, planted(NB_ALL, chip, ev, blocks), kw


CASES = {
    # the cell's traffic at its geometry, and small
    "train_72x16": lambda: case_train(NB_ALL, 72, 16, 16 * 9, seed=1),
    "train_8x24": lambda: case_train(NB_ALL, 8, 24, 24 * 9, seed=2, gap_blocks=1),
    # -windowblocks=4, below the look-ahead (12 blocks at 72, 20 at 8)
    "windowblocks4_72": lambda: case_train(NB_ALL, 72, 4, 16 * 8, seed=3),
    "windowblocks4_8": lambda: case_train(NB_ALL, 8, 4, 24 * 8, seed=4, gap_blocks=1),
    # all six types registered
    "six_72": lambda: case_train(SIX, 72, 16, 16 * 12, seed=5),
    "six_8": lambda: case_train(SIX, 8, 24, 24 * 9, seed=6, gap_blocks=1),
    # an IDM packet in window 2's first blocks, found by window 1's
    # look-ahead: its raw hit cuts the look-ahead at its block, an SCM
    # before it goes early
    "idm_guard": lambda: case_events(72, 16, 16 * 6, [
        ("scm", 2, 0, 300), ("idm", 2, 2, 500), ("scm+", 3, 15, 400)]),
    # an SCM+ packet right behind the bits that begin IDM's preamble: the
    # IDM raw hit guards the block the SCM+ packet is found in
    "short_after_idm_start": lambda: case_events(72, 16, 16 * 6, [
        ("scm", 2, 0, 300), ("5555scm+", 2, 4, 3000), ("r900", 3, 3, 100)]),
    # preamble plateaus straddling window 2's first block (window 1's
    # look-ahead): the hits in the window's last block emit, those in the
    # look-ahead's first are the same digest and dedup drops them
    "plateau_straddle": lambda: case_events(72, 16, 16 * 6, [
        ("scm", 2, 0, 20), ("r900", 3, 0, 25), ("scm+", 4, 0, 15)]),
    # the same SCM packet twice, found in window 1's last block and in its
    # look-ahead's first: equal digests in adjacent blocks, the second
    # dropped
    "equal_digests": lambda: case_events(72, 16, 16 * 6, [
        ("scm", 1, 15, 100, 7), ("scm", 2, 0, 100 - 8192 + 13824 + 300, 7)]),
    # two SCM packets in one look-ahead with room for one candidate: the
    # look-ahead overflows and defers its blocks to their window, which
    # escalates
    "overflow": lambda: case_events(72, 16, 16 * 6, [
        ("scm", 2, 1, 100), ("scm", 2, 5, 200), ("scm+", 3, 2, 300)], max_hits=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stream_is_the_oracles(case):
    """Fed a block at a time and each window completed at once, the
    decoder emits the oracle's stream, in order, each message in the feed
    call that completes its window or sooner."""
    names, chip, window_blocks, iq, kw = CASES[case]()
    without, ahead, dec = both(names, chip, window_blocks, iq, **kw)
    assert stream(ahead) == stream(without) == oracle(names, chip, iq)
    assert all(a[0] <= t[0] for t, a in zip(without, ahead))
    early = sooner(without, ahead)
    wb = window_blocks
    if case.startswith(("train", "six", "windowblocks")):
        assert len(without) >= 4 and early
        assert not [m for _, m in early if m.startswith("IDM ")]
    elif case == "idm_guard":
        # window 1's look-ahead: blocks 32-43; the IDM hit at block 34 stops it
        assert [b for b, _ in early] == [2 * wb]
        assert any(m.startswith("IDM ") for _, m in stream(without))
    elif case == "short_after_idm_start":
        assert [b for b, _ in early] == [2 * wb, 3 * wb + 3]
        assert any(m.startswith("SCM+ ") for _, m in stream(without))  # the SCM+ packet decodes
    elif case == "plateau_straddle":
        assert len(without) == 3 and not early  # each in its window's last block
        assert [b % wb for b, _ in stream(without)] == [wb - 1] * 3
    elif case == "equal_digests":
        assert len(without) == 1 and stream(without)[0][0] == 2 * wb - 1
    elif case == "overflow":
        assert dec.metrics.hit_overflows >= 1
        scm = [t for t in without if t[2].startswith("SCM ")]
        assert len(scm) == 2 and not [m for b, m in early if b < 3 * wb]


def test_short_packets_surface_with_their_block():
    """Fed a block at a time with synchronous completion, an SCM, an SCM+
    and an R900 message found in a window's first blocks surface in the
    feed call that brings their block (found by the window before), not in
    the one that completes their window; an IDM message surfaces in the
    one that completes its window."""
    names, chip, wb, iq, _ = case_events(72, 16, 16 * 7, [
        ("scm", 2, 3, 500), ("scm+", 3, 5, 500), ("r900", 4, 8, 500), ("idm", 5, 2, 500)])
    without, ahead, _ = both(names, chip, wb, iq)
    assert stream(ahead) == oracle(names, chip, iq) and len(without) == 4
    seen = {}
    for t, a in zip(without, ahead):
        kind = t[2].split()[0]
        seen[kind] = t[1]
        assert t[0] == (t[1] // wb + 1) * wb - 1  # without: its window's last feed
        assert a[0] == (t[0] if kind == "IDM" else t[1])
    assert seen == {"SCM": 2 * wb + 3, "SCM+": 3 * wb + 5, "R900": 4 * wb + 8, "IDM": 5 * wb + 2}


@pytest.mark.parametrize("cut_block", [4 * 16 + 6, 4 * 16, 4 * 16 + 1, 4 * 16 + 2])
def test_flush_of_a_short_final_window(cut_block):
    """The stream ends in a short window, flushed, after or among the
    blocks a look-ahead resolved (an R900 packet found in window 4's block
    1, resolved by window 3's look-ahead): the stream is the oracle's,
    message for message; a block resolved but never fed whole emits
    nothing."""
    chip, wb = 72, 16
    events = [("scm", 2, 1, 500), ("scm+", 3, 2, 500), ("r900", 4, 1, 500)]
    names, _, _, full, _ = case_events(chip, wb, 16 * 6, events)
    bs2 = 2 * config(names, chip).block_size
    iq = full[: cut_block * bs2 + 3000]
    without, ahead, _ = both(names, chip, wb, iq)
    assert stream(ahead) == stream(without) == oracle(names, chip, iq)
    r900 = [t for t in without if t[2].startswith("R900 ")]
    assert len(r900) == (cut_block > 4 * wb + 1)
    assert len(sooner(without, ahead)) == 2 + (cut_block > 4 * wb + 1)


def test_decode_capture_and_first_and_short_windows():
    """``decode_capture`` (which looks ahead) gives the oracle's stream; a
    first window and a short window read no look-ahead; a second one's is
    fetched once a block of it is fed."""
    names, chip, wb, iq, _ = case_train(NB_ALL, 8, 24, 24 * 7, seed=9, gap_blocks=1)
    ahead = WindowDecoder(parsers(names, chip), window_blocks=wb, device="cpu")
    got = [(b, line(m)) for b, m in ahead.decode_capture(iq)]
    assert got == oracle(names, chip, iq) and got and ahead._lookahead_mark > 0
    ahead.reset()
    w2 = 2 * ahead.spec.window
    ahead.feed(iq[:w2])  # the first window, completed at once: no look-ahead read
    ahead.drain()
    assert ahead._lookahead_mark == -1
    ahead.feed(iq[w2 : 2 * w2 - 4 * ahead.cfg.block_size])
    ahead.flush()  # a short window: none either
    assert ahead._lookahead_mark == -1
    ahead.reset()
    ahead.feed(iq[: 2 * w2])  # a whole second window reads it, once its next block is fed
    ahead.drain()
    assert ahead._ahead_fetch is not None and ahead._ahead is None
    ahead.feed(iq[2 * w2 : 2 * w2 + 2 * ahead.cfg.block_size])
    assert ahead._ahead_fetch is None and ahead._lookahead_mark >= 2 * wb


def test_windows_staged_by_the_caller_keep_the_stream():
    """Windows the caller stages (``process_host_staged``, as
    ``StagingRing.submit`` hands them over), each completed at once: no
    feed brings the look-ahead's blocks, so they go out when their window
    is dispatched, before its own blocks, and the stream is the oracle's
    over those windows."""
    names, chip, wb, iq, _ = case_train(NB_ALL, 8, 4, 24 * 7, seed=12, gap_blocks=1)
    dec = WindowDecoder(parsers(names, chip), window_blocks=wb, device="cpu")
    n = iq.size // dec.window_bytes
    out = []
    for row in staged_windows(dec.spec, iq, n):
        out += dec.process_host_staged(row) + dec.drain()
    got = [(b, line(m)) for b, m in out]
    assert got == oracle(names, chip, iq[: n * dec.window_bytes]) and len(got) >= 4
    assert dec._lookahead_mark >= 0


def test_lookahead_span_counts_engaged_windows():
    """The tracer's ``pipeline.lookahead`` span is entered once for each
    window whose look-ahead emitted blocks."""
    names, chip, wb, iq, _ = case_train(NB_ALL, 8, 24, 24 * 6, seed=10, gap_blocks=1)
    dec = WindowDecoder(parsers(names, chip), window_blocks=wb, device="cpu")
    TRACER.reset()
    observability.enable()
    try:
        feed_blocks(dec, iq)
        totals = TRACER.snapshot().totals
    finally:
        observability.disable()
        TRACER.reset()
    windows = iq.size // dec.window_bytes
    assert 1 <= totals["pipeline.lookahead"][0] <= windows - 1


def test_state_carries_the_mark():
    """``export_state`` carries the last block the look-ahead emitted and
    ``load_state`` restores it. A stream stopped after a look-ahead emitted
    a block of the window under way, its bytes since the window boundary
    dropped (as a checkpoint does), and resumed from the boundary neither
    repeats nor loses a message. A state without the mark (the JAX
    package's) loads as none."""
    names, chip, wb, iq, _ = case_train(NB_ALL, 8, 4, 24 * 7, seed=11, gap_blocks=1)
    rows = feed_blocks(
        WindowDecoder(parsers(names, chip), window_blocks=wb, device="cpu"), iq)
    # a message emitted by the feed of its own block, before its window's end
    call = next(c for c, b, _ in rows if c == b and c % wb != wb - 1)
    a = WindowDecoder(parsers(names, chip), window_blocks=wb, device="cpu")
    step = 2 * a.cfg.block_size
    head = []
    for pos in range(0, (call + 1) * step, step):
        head += [(b, line(m)) for b, m in a.feed(iq[pos : pos + step]) + a.drain()]
    boundary = (call + 1) * step - a.discard_pending()
    state = a.export_state()
    assert boundary == call // wb * wb * step and state["lookahead_mark"] >= call
    resumed = WindowDecoder(parsers(names, chip), window_blocks=wb, device="cpu")
    resumed.load_state(state)
    assert head + stream(feed_blocks(resumed, iq[boundary:])) == stream(rows)
    resumed.load_state({k: v for k, v in state.items() if k != "lookahead_mark"})
    assert resumed.export_state()["lookahead_mark"] is None


# ---------------------------------------------------------------------------
# On the card


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the look-ahead's mask kernel and K1 run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("names, chip, window_blocks", [
    (NB_ALL, 72, 16), (NB_ALL, 72, 4), (SIX, 8, 24), (("scm", "idm"), 78, 4)])
def test_cuda_mask_kernel_and_variant_buffer(names, chip, window_blocks):
    """On the card: the look-ahead's mask kernel equals ``masks_plain`` on
    the bits from the window on; the window's buffer (eager, captured and
    replayed) is the plain call's and the look-ahead's equals the CPU's; K1 is
    launched once a window and the mask kernel once a look-ahead, a
    graph's replays counted."""
    need_card()
    from rtlamr_tpu_torch.ops.frontend import SEARCH_GRAPHS
    from rtlamr_tpu_torch.ops.stencil import decode_stencil

    spec = WindowDecoder(parsers(names, chip), window_blocks=window_blocks, device="cpu").spec
    la = lookahead_geometry(spec)
    windows = 6
    iq = train(names, chip, windows * window_blocks + la.extent // spec.block_size + 2,
               seed=31, gap_blocks=1)
    staged = staged_windows(spec, iq, windows)
    for k in [k for k in SEARCH_GRAPHS if k[0] == spec]:
        del SEARCH_GRAPHS[k]
    for i, row in enumerate(staged):
        t = torch.from_numpy(row).cuda()
        bits, _, _ = decode_stencil(spec, t, i == 0)
        mask = lookahead_mask(spec, bits)
        assert torch.equal(mask.cpu(), masks_plain(
            dataclasses.replace(spec, window=la.extent), bits.cpu()[spec.window :]))
        before, masks = decode_stencil.launches, lookahead_mask.launches
        got, ahead_fn = decode_window_staged_packed(spec, t, i == 0, lookahead=True)
        assert decode_stencil.launches == before + 1
        ahead = ahead_fn()
        assert lookahead_mask.launches == masks + 1
        plain = decode_window_staged_packed(spec, t, i == 0)
        cpu, cpu_fn = decode_window_staged_packed(spec, torch.from_numpy(row), i == 0,
                                                  lookahead=True)
        assert torch.equal(got, plain) and torch.equal(got.cpu(), cpu)
        assert torch.equal(ahead.cpu(), cpu_fn()), (names, window_blocks, i)
    assert any(k[-1] == "lookahead" for k in SEARCH_GRAPHS if k[0] == spec)


@pytest.mark.cuda
def test_cuda_stream_is_the_cpu_stream():
    """The card's look-ahead decoder, fed a block at a time, gives the CPU
    look-ahead decoder's rows, feed call for feed call."""
    need_card()
    names, chip, wb, iq, _ = case_train(NB_ALL, 72, 16, 16 * 9, seed=1)
    without, cpu, _ = both(names, chip, wb, iq)
    card = feed_blocks(WindowDecoder(parsers(names, chip), window_blocks=wb, device=None), iq)
    assert card == cpu and sooner(without, card)
