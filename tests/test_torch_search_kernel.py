"""The hand-written search (``ops/search.search_kernel``,
``csrc/search.cu``) against the plain search on the card: the packed
buffer is byte-identical to ``pack_results(search_slice(...))`` for the
window programs' specs, the look-ahead's with its guards, escalation's
high-capacity spec, and masks that overflow each capacity in turn; the
window API's result dict is read from the kernels' buffer; one
launch sequence is counted for each search, a CUDA graph's replays
included.

Run on the card with
``python -m pytest --noconftest tests/test_torch_search_kernel.py -m cuda``."""

import dataclasses

import numpy as np
import pytest
import torch

from rtlamr_tpu_torch.decoder import WindowDecoder
from rtlamr_tpu_torch.ops import frontend
from rtlamr_tpu_torch.ops.frontend import decode_window_staged_packed, pack_results
from rtlamr_tpu_torch.ops.search import lookahead_guards, search_kernel, search_slice
from rtlamr_tpu_torch.ops.spec import LANES, lookahead_geometry, lookahead_spec
from rtlamr_tpu_torch.ops.stencil import decode_stencil, lookahead_mask
from rtlamr_tpu_torch.protocols import new_parser

from test_torch_search_graph import (
    CUDA_CASES,
    NB_ALL,
    assert_same_results,
    forget,
    planted_capture,
    staged_windows,
)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the search kernels run only there")


def decoder(names, window_blocks):
    return WindowDecoder([new_parser(n, 72) for n in names], window_blocks=window_blocks,
                         device=None)


def k1_outputs(spec, names, windows=3):
    """K1's outputs on the card for the first ``windows`` windows of a
    planted capture."""
    iq = planted_capture(names, 72, spec.window, windows)
    staged = torch.from_numpy(staged_windows(spec, iq, windows)).cuda()
    return [decode_stencil(spec, staged[i], i == 0) for i in range(windows)]


def plain(spec, bits, q6, mask2d):
    return pack_results(search_slice(spec, bits, q6, mask2d))


def assert_same(got, want, what):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    diff = (got != want).nonzero()
    assert diff.numel() == 0, f"{what}: {diff.numel()} bytes differ, first at {diff[:4].tolist()}"


@pytest.mark.cuda
@pytest.mark.parametrize("names, window_blocks", CUDA_CASES)
def test_cuda_kernel_equals_plain(names, window_blocks):
    """Each window's search, and its look-ahead's with the guards, byte for
    byte; the escalation's high-capacity spec on the same windows."""
    need_card()
    dec = decoder(names, window_blocks)
    spec, w = dec.spec, dec.spec.window
    la = lookahead_geometry(spec)
    for i, (bits, q6, mask2d) in enumerate(k1_outputs(spec, names)):
        assert_same(search_kernel(spec, bits, q6, mask2d), plain(spec, bits, q6, mask2d),
                    f"window {i}")
        big = dec._big_spec()
        assert_same(search_kernel(big, bits, q6, mask2d), plain(big, bits, q6, mask2d),
                    f"window {i}, high capacity")
        if la.extent:
            ahead = lookahead_mask(spec, bits)
            q6a = None if q6 is None else q6[w:]
            want = torch.cat([plain(lookahead_spec(spec), bits[w:], q6a, ahead),
                              lookahead_guards(spec, ahead).view(torch.uint8)])
            got = search_kernel(lookahead_spec(spec), bits[w:], q6a, ahead, la.fits)
            assert_same(got, want, f"window {i}, look-ahead")


def planted_masks(spec, rng):
    """(label, mask) pairs over the window, each past one capacity: rows
    with a hit (one a row), hit positions (whole rows of group 0 in a few
    rows), a group's hits (group 1 alone), its survivors (isolated hits of
    group 2, none collapsed); then a random mask of every group."""
    rows, k_gather = spec.window // LANES, spec.gather_hits
    k_any = min(len(spec.groups) * k_gather, spec.gather_rows * LANES)
    k_slice = min(spec.slice_hits, k_gather)
    g1, g2 = 1 % len(spec.groups), 2 % len(spec.groups)
    out = []
    m = np.zeros((rows, LANES), np.uint8)
    m[: spec.gather_rows + 1, 5] = 1
    out.append(("rows", m))
    m = np.zeros((rows, LANES), np.uint8)
    m[: -(-(k_any + 1) // LANES)] = 1
    out.append(("positions", m))
    m = np.zeros(rows * LANES, np.uint8)
    m[: k_gather + 1] = 1 << g1
    out.append(("group", m.reshape(rows, LANES)))
    m = np.zeros(rows * LANES, np.uint8)
    m[1 : 2 * (k_slice + 1) : 2] = 1 << g2
    out.append(("survivors", m.reshape(rows, LANES)))
    out.append(("random", rng.integers(0, 1 << len(spec.groups), (rows, LANES)).astype(np.uint8)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("window_blocks", [16, 1024])
def test_cuda_overflowing_masks_equal_plain(window_blocks):
    """Masks planted past each capacity in turn, over a planted window's
    streams: the same bytes, ``counts`` reporting the overflow."""
    need_card()
    spec = decoder(NB_ALL, window_blocks).spec
    bits, q6, _ = k1_outputs(spec, NB_ALL, 2)[1]
    rng = np.random.default_rng(window_blocks)
    for label, m in planted_masks(spec, rng):
        if label == "rows" and spec.gather_rows >= spec.window // LANES:
            continue
        mask2d = torch.from_numpy(m).cuda()
        want = plain(spec, bits, q6, mask2d)
        assert_same(search_kernel(spec, bits, q6, mask2d), want, label)
        counts = want[: 8 * len(spec.groups)].view(torch.int32).view(-1, 2)
        assert bool((counts[:, 0] > spec.gather_hits).any()), label


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [dict(gather_rows=1), dict(gather_hits=8), dict(slice_hits=1),
                                 dict(device_validate=False)])
def test_cuda_cut_capacities_equal_plain(cut):
    """The planted windows under capacities cut below what they hold, and
    without the gates."""
    need_card()
    spec = dataclasses.replace(decoder(NB_ALL, 16).spec, **cut)
    for i, (bits, q6, mask2d) in enumerate(k1_outputs(spec, NB_ALL, 4)):
        assert_same(search_kernel(spec, bits, q6, mask2d), plain(spec, bits, q6, mask2d),
                    f"{cut} window {i}")


@pytest.mark.cuda
def test_cuda_one_launch_sequence_a_search():
    """Through the window program: one launch sequence for each window's
    search and each look-ahead, the key's eager call, capture and replays
    alike."""
    need_card()
    spec = decoder(NB_ALL, 16).spec
    forget(spec)
    iq = planted_capture(NB_ALL, 72, spec.window, 5)
    staged = torch.from_numpy(staged_windows(spec, iq, 5)).cuda()
    before = search_kernel.launches
    for i in range(5):
        buf, ahead = decode_window_staged_packed(spec, staged[i], i == 0, lookahead=True)
        ahead()
    torch.cuda.synchronize()
    assert search_kernel.launches - before == 10


@pytest.mark.cuda
def test_cuda_result_dict_comes_from_the_kernels():
    """The window API's result dict on the card (``decode_core_staged``,
    ``decode_window_staged``) is read from one launch sequence of the
    kernels, and equals the plain search's dict over K1's outputs."""
    need_card()
    spec = decoder(NB_ALL, 16).spec
    iq = planted_capture(NB_ALL, 72, spec.window, 3)
    staged = torch.from_numpy(staged_windows(spec, iq, 3)).cuda()
    for i in range(3):
        want = search_slice(spec, *decode_stencil(spec, staged[i], i == 0))
        for fn in (frontend.decode_core_staged, frontend.decode_window_staged):
            before = search_kernel.launches
            got = fn(spec, staged[i], i == 0)
            assert search_kernel.launches == before + 1, fn.__name__
            assert got["idx"][0].device == staged.device
            assert_same_results(got, want)
