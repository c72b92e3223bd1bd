"""The window program's search replayed from a CUDA graph
(``ops/frontend.decode_window_staged_packed``, ``SearchGraph``).

On the card K1 is launched as a kernel of its own and the search after it
is captured once for each (spec, device, stream) and replayed: the
``cuda``-marked tests hold the replayed bytes to the plain search's, the
streams to a CPU decoder's, and the launch counts and the K1 tap that the
benchmark's check reads to one call a window. On the CPU the search runs
eagerly and no graph is made.

Run the card tests with
``python -m pytest --noconftest tests/test_torch_search_graph.py -m cuda``."""

import numpy as np
import pytest
import torch

from rtlamr_tpu_torch.decoder import WindowDecoder
from rtlamr_tpu_torch.ops import frontend
from rtlamr_tpu_torch.ops.frontend import (
    SEARCH_GRAPHS,
    SearchGraph,
    decode_core_staged,
    decode_window_staged_packed,
    decode_windows_scan,
    pack_results,
)
from rtlamr_tpu_torch.ops.search import search_slice
from rtlamr_tpu_torch.ops.spec import staged_geometry
from rtlamr_tpu_torch.ops.stencil import decode_stencil, stencil_plain
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.protocols.base import build_decoder_config
from rtlamr_tpu_torch.ref import synth
from rtlamr_tpu_torch.utils import observability
from rtlamr_tpu_torch.utils.observability import TRACER

# The suite runs in several worker processes at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

NB_ALL = ("scm", "scm+", "idm", "r900")
GRAPH_SPANS = ("frontend.search_replay", "frontend.search_capture")


def parsers(names, chip_length):
    return [new_parser(n, chip_length) for n in names]


def planted_capture(names, chip_length, window, windows, seed=7, gap_blocks=1, noise=3.0):
    """``windows`` windows of ``window`` samples and a block more, with
    bursts of ``names`` in turn every PacketLength + ``gap_blocks`` blocks
    (so packets straddle window boundaries)."""
    cfg = build_decoder_config(parsers(names, chip_length))
    total = windows * window + cfg.block_size
    bursts, offset, i = [], cfg.block_size // 2, 0
    while offset + cfg.packet_length < total:
        kind = names[i % len(names)]
        if kind == "scm":
            bits = synth.make_scm_bits(meter_id=100000 + i, consumption=i)
        elif kind == "scm+":
            bits = synth.make_scmplus_bits(endpoint_id=200000 + i, consumption=i)
        elif kind == "idm":
            bits = synth.make_idm_bits(serial=300000 + i)
        else:
            bits = None
        if bits is None:
            bursts.append(synth.r900_burst(synth.make_r900_symbols(meter_id=500000 + i), offset))
        else:
            bursts.append(synth.bits_to_burst(bits, offset))
        offset += cfg.packet_length + gap_blocks * cfg.block_size
        i += 1
    return synth.render_iq(total, bursts, chip_length, noise=noise, seed=seed)


def staged_windows(spec, iq, k):
    """The first ``k`` windows of ``iq`` staged as the decoder's feed path
    stages them (the carried halo first, zeros before the stream)."""
    hs, w = spec.halo_staged, spec.window
    u16 = np.concatenate([np.zeros(hs, np.uint16), iq.view(np.uint16)])
    out = np.zeros((k, staged_geometry(spec).staged_samples), np.uint16)
    for i in range(k):
        out[i, : hs + w] = u16[i * w : i * w + hs + w]
    return out


def as_list(msgs):
    return [(b, str(m)) for b, m in msgs]


def graph_keys(spec):
    return [k for k in SEARCH_GRAPHS if k[0] == spec]


def forget(spec):
    for k in graph_keys(spec):
        del SEARCH_GRAPHS[k]


# ---------------------------------------------------------------------------
# On the CPU: the search runs eagerly, as before


CPU_CASES = [(NB_ALL, 72, 16), (("scm",), 72, 16), (NB_ALL, 8, 24)]


def cpu_windows(names, chip_length, window_blocks, k=2):
    """A CPU decoder, a six-window capture and its first ``k`` windows
    staged."""
    dec = WindowDecoder(parsers(names, chip_length), window_blocks=window_blocks, device="cpu")
    iq = planted_capture(names, chip_length, dec.spec.window, 6)
    return dec, iq, staged_windows(dec.spec, iq, k)


@pytest.mark.parametrize("names, chip_length, window_blocks", CPU_CASES)
def test_cpu_packed_bytes_unchanged(names, chip_length, window_blocks):
    """The CPU path packs the eager search over the plain stencil, byte for
    byte, window after window."""
    dec, _, staged = cpu_windows(names, chip_length, window_blocks)
    spec = dec.spec
    for i, row in enumerate(staged):
        t = torch.from_numpy(row)
        got = decode_window_staged_packed(spec, t, i == 0)
        assert torch.equal(got, pack_results(decode_core_staged(spec, t, i == 0)))
        assert torch.equal(got, pack_results(search_slice(spec, *stencil_plain(spec, t, i == 0))))


def assert_same_results(got, want):
    """Two search result dicts hold the same tensors: keys, dtypes, shapes
    and values."""
    assert got.keys() == want.keys()
    for key in want:
        a, b = got[key], want[key]
        if isinstance(b, torch.Tensor):
            a, b = [a], [b]
        if isinstance(b, dict):
            assert a.keys() == b.keys(), key
            a, b = [a[g] for g in sorted(a)], [b[g] for g in sorted(b)]
        assert len(a) == len(b), key
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), key


@pytest.mark.parametrize("names, chip_length, window_blocks", CPU_CASES)
def test_result_views_invert_pack_results(names, chip_length, window_blocks):
    """``result_views`` reads back the search's result dict from its packed
    buffer, the dict the card's window API returns from the kernels'."""
    dec, _, staged = cpu_windows(names, chip_length, window_blocks)
    spec = dec.spec
    for i, row in enumerate(staged):
        res = search_slice(spec, *stencil_plain(spec, torch.from_numpy(row), i == 0))
        buf = pack_results(res)
        views = frontend.result_views(spec, buf)
        assert_same_results(views, res)
        assert torch.equal(pack_results(views), buf)


@pytest.mark.parametrize("names, chip_length, window_blocks", CPU_CASES)
def test_cpu_decode_leaves_no_graph(names, chip_length, window_blocks):
    """A CPU decoder's stream and window calls add no key to the graph
    cache."""
    dec, iq, staged = cpu_windows(names, chip_length, window_blocks)
    before = dict(SEARCH_GRAPHS)
    msgs = dec.decode_capture(iq)
    for i, row in enumerate(staged):
        decode_window_staged_packed(dec.spec, torch.from_numpy(row), i == 0)
    decode_windows_scan(dec.spec, torch.from_numpy(staged), [True, False])
    assert SEARCH_GRAPHS == before
    assert not any(k[1].type == "cpu" for k in SEARCH_GRAPHS)
    assert len(msgs) > 0


@pytest.mark.parametrize("names, chip_length, window_blocks", CPU_CASES)
def test_cpu_decode_opens_no_replay_span(names, chip_length, window_blocks):
    """With the tracer on, a CPU decoder's windows open ``frontend.enqueue``
    spans and neither graph span."""
    dec, iq, _ = cpu_windows(names, chip_length, window_blocks)
    TRACER.reset()
    observability.enable()
    try:
        dec.decode_capture(iq)
        totals = TRACER.snapshot().totals
    finally:
        observability.disable()
        TRACER.reset()
    assert "frontend.enqueue" in totals or "setup.first_window" in totals
    assert not set(GRAPH_SPANS) & set(totals)


# ---------------------------------------------------------------------------
# On the card


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and the search's CUDA graph run only there")


CUDA_CASES = [(NB_ALL, 16), (NB_ALL, 1024), (("scm",), 16), (("scm",), 1024)]


def plain_packed(spec, staged, first):
    """The plain search's packed buffer over K1's outputs on the card: what
    the kernels' buffer, replayed or not, is held to."""
    return pack_results(search_slice(spec, *decode_stencil(spec, staged, first)))


@pytest.mark.cuda
@pytest.mark.parametrize("names, window_blocks", CUDA_CASES)
def test_cuda_replay_equals_eager_and_cpu(names, window_blocks):
    """Six windows with planted packets, the first with ``first``: the
    replayed packed buffer equals the plain search's, window by window (the
    first call of the key eager, the second captured, the rest replayed),
    and the card decoder's stream equals a CPU decoder's."""
    need_card()
    dec = WindowDecoder(parsers(names, 72), window_blocks=window_blocks, device=None)
    spec = dec.spec
    forget(spec)
    iq = planted_capture(names, 72, spec.window, 6)
    staged = torch.from_numpy(staged_windows(spec, iq, 6)).cuda()
    TRACER.reset()
    observability.enable()
    try:
        for i in range(6):
            got = decode_window_staged_packed(spec, staged[i], i == 0)
            want = plain_packed(spec, staged[i], i == 0)
            assert torch.equal(got, want), (names, window_blocks, i)
        totals = TRACER.snapshot().totals
    finally:
        observability.disable()
        TRACER.reset()
    assert totals["frontend.search_capture"][0] == 1
    assert totals["frontend.search_replay"][0] == 5
    cpu = WindowDecoder(parsers(names, 72), window_blocks=window_blocks, device="cpu")
    want_msgs = as_list(cpu.decode_capture(iq))
    got_msgs = as_list(dec.decode_capture(iq))
    assert got_msgs == want_msgs and len(want_msgs) >= 4


@pytest.mark.cuda
def test_cuda_escalation_equals_eager_decoder():
    """Windows holding more candidates than ``max_hits`` escalate to the
    high-capacity program, run eagerly the first time and replayed once it
    repeats; the messages equal a CPU decoder's."""
    need_card()
    names = ("scm",)
    dec = WindowDecoder(parsers(names, 72), window_blocks=16, max_hits=1, device=None)
    iq = planted_capture(names, 72, dec.spec.window, 6, noise=0.0)
    cpu = WindowDecoder(parsers(names, 72), window_blocks=16, max_hits=1, device="cpu")
    want = as_list(cpu.decode_capture(iq))
    got = as_list(dec.decode_capture(iq))
    assert got == want and len(want) >= 6
    assert dec.metrics.hit_overflows == cpu.metrics.hit_overflows >= 3
    big = graph_keys(dec._big_spec())
    assert len(big) == 1 and isinstance(SEARCH_GRAPHS[big[0]], SearchGraph)


@pytest.mark.cuda
def test_cuda_held_results_stay_intact():
    """Two results held across replays keep their own bytes."""
    need_card()
    dec = WindowDecoder(parsers(NB_ALL, 72), window_blocks=16, device=None)
    spec = dec.spec
    iq = planted_capture(NB_ALL, 72, spec.window, 4)
    staged = torch.from_numpy(staged_windows(spec, iq, 4)).cuda()
    want = [plain_packed(spec, staged[i], i == 0) for i in range(4)]
    assert not torch.equal(want[2], want[3])
    for i in range(2):  # the key's eager call and its capture
        decode_window_staged_packed(spec, staged[i], i == 0)
    a = decode_window_staged_packed(spec, staged[2], False)
    b = decode_window_staged_packed(spec, staged[3], False)
    torch.cuda.synchronize()
    assert torch.equal(a, want[2]) and torch.equal(b, want[3])


@pytest.mark.cuda
def test_cuda_one_capture_a_key_and_one_launch_a_window():
    """A key's first call runs eagerly, its second captures, later calls
    replay that graph; another stream is another key. K1 launches once a
    call throughout."""
    need_card()
    dec = WindowDecoder(parsers(NB_ALL, 72), window_blocks=16, device=None)
    spec = dec.spec
    forget(spec)
    iq = planted_capture(NB_ALL, 72, spec.window, 3)
    staged = torch.from_numpy(staged_windows(spec, iq, 3)).cuda()
    want = [plain_packed(spec, staged[i], i == 0) for i in range(3)]
    dev = staged.device
    key = (spec, dev, torch.cuda.current_stream(dev).cuda_stream)
    seen = []
    for i in range(3):
        before = decode_stencil.launches
        got = decode_window_staged_packed(spec, staged[i], i == 0)
        assert decode_stencil.launches == before + 1
        assert torch.equal(got, want[i])
        seen.append(SEARCH_GRAPHS[key])
    assert seen[0] is None and isinstance(seen[1], SearchGraph) and seen[2] is seen[1]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        side_key = (spec, dev, side.cuda_stream)
        for i in range(3):
            before = decode_stencil.launches
            got = decode_window_staged_packed(spec, staged[i], i == 0)
            assert decode_stencil.launches == before + 1
            assert (SEARCH_GRAPHS[side_key] is None) == (i == 0)
            side.synchronize()
            assert torch.equal(got, want[i])
    assert len(graph_keys(spec)) == 2 and SEARCH_GRAPHS[side_key] is not seen[1]


@pytest.mark.cuda
def test_cuda_k1_tap_sees_every_window():
    """A stand-in for ``frontend.decode_stencil`` shaped like the
    benchmark's K1 tap (called by name, three positional arguments) sees
    every window of a card decoder, replayed ones too, and its outputs are
    the plain stencil's; the messages equal the untapped CPU decoder's."""
    need_card()
    dec = WindowDecoder(parsers(NB_ALL, 72), window_blocks=16, device=None)
    spec = dec.spec
    iq = planted_capture(NB_ALL, 72, spec.window, 6)
    orig = frontend.decode_stencil
    taps = []

    def tap(spec_, staged, first):
        res = orig(spec_, staged, first)
        if spec_ is spec:
            taps.append((staged.cpu(), bool(first), [None if x is None else x.cpu() for x in res]))
        return res

    frontend.decode_stencil = tap
    try:
        before = decode_stencil.launches
        got = as_list(dec.decode_capture(iq))
        launches = decode_stencil.launches - before
    finally:
        frontend.decode_stencil = orig
    n = dec.metrics.windows_decoded
    assert len(taps) == n == launches - dec.metrics.hit_overflows and n >= 6
    assert [first for _, first, _ in taps] == [True] + [False] * (n - 1)
    for staged, first, outs in taps:
        for a, b in zip(outs, stencil_plain(spec, staged, first)):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)
    cpu = WindowDecoder(parsers(NB_ALL, 72), window_blocks=16, device="cpu")
    assert got == as_list(cpu.decode_capture(iq))


@pytest.mark.cuda
def test_cuda_benchmark_k1_tap_on_a_replayed_window():
    """The benchmark's own K1 tap, at a window whose search is replayed,
    holds that window's K1 outputs."""
    need_card()
    from gpubench.harness import K1Tap

    dec = WindowDecoder(parsers(NB_ALL, 72), window_blocks=16, device=None)
    spec = dec.spec
    iq = planted_capture(NB_ALL, 72, spec.window, 6)
    staged = staged_windows(spec, iq, 6)
    with K1Tap(frontend, 4) as tap:
        dec.decode_capture(iq)
    bits, q6, mask, first = tap.host()
    want = stencil_plain(spec, torch.from_numpy(staged[4]), False)
    assert not first and tap.calls == dec.metrics.windows_decoded
    for a, b in zip((bits, q6, mask), want):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.cuda
def test_cuda_windows_scan_equals_eager():
    """``decode_windows_scan`` over three rows, twice (the key's eager call,
    capture and replays, then replays alone), equals the eager rows."""
    need_card()
    dec = WindowDecoder(parsers(NB_ALL, 72), window_blocks=16, device=None)
    spec = dec.spec
    forget(spec)
    iq = planted_capture(NB_ALL, 72, spec.window, 3)
    staged = torch.from_numpy(staged_windows(spec, iq, 3)).cuda()
    firsts = [True, False, False]
    want = torch.stack([plain_packed(spec, staged[i], firsts[i])
                        for i in range(3)])
    for _ in range(2):
        before = decode_stencil.launches
        got = decode_windows_scan(spec, staged, firsts)
        assert decode_stencil.launches == before + 3
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_a_graph_a_card():
    """With the current device left at card 0, each card's windows are
    captured and replayed on that card (the mesh's shards run so), equal to
    the plain search there. Skips with fewer than two cards."""
    need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dec = WindowDecoder(parsers(NB_ALL, 72), window_blocks=16, device=None)
    spec = dec.spec
    forget(spec)
    iq = planted_capture(NB_ALL, 72, spec.window, 3)
    host = torch.from_numpy(staged_windows(spec, iq, 3))
    assert torch.cuda.current_device() == 0
    for d in range(torch.cuda.device_count()):
        staged = host.to(f"cuda:{d}")
        want = [plain_packed(spec, staged[i], i == 0) for i in range(3)]
        for i in range(3):
            got = decode_window_staged_packed(spec, staged[i], i == 0)
            assert got.device == staged.device and torch.equal(got, want[i]), (d, i)
        key = (spec, staged.device, torch.cuda.current_stream(staged.device).cuda_stream)
        assert isinstance(SEARCH_GRAPHS[key], SearchGraph)
    assert len(graph_keys(spec)) == torch.cuda.device_count()
