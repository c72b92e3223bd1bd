"""The frozen reference against the receiver's plain versions (tests may
import the receiver; the reference may not), and the controls: computed a
precision lower, the comparison rejects them."""

import numpy as np
import pytest
import torch

from gpubench import check
from gpubench.reference import stencil as rs
from gpubench.reference.protocols import build_decoder_config, new_parser

NAMES = ("scm", "scm+", "idm", "r900")


def _geo(cl, wb):
    return rs.window_geometry(build_decoder_config([new_parser(n, cl) for n in NAMES]), wb)


def _samples(geo, seed):
    rng = np.random.default_rng(seed)
    n = geo.halo_staged + geo.window
    i = rng.integers(118, 138, n).astype(np.uint16)
    i[rng.random(n) < 0.3] = 230  # OOK chips: sums far past 2**24
    return i | (rng.integers(118, 138, n).astype(np.uint16) << 8)


@pytest.mark.parametrize("cl,wb,first", [(72, 16, False), (72, 16, True), (8, 64, False)])
def test_stencil_equals_the_receivers_plain_stencil(cl, wb, first):
    from rtlamr_tpu_torch.ops.spec import make_frontend_spec, staged_geometry
    from rtlamr_tpu_torch.ops.stencil import stencil_plain
    from rtlamr_tpu_torch.protocols import new_parser as pnew
    from rtlamr_tpu_torch.protocols.base import build_decoder_config as pcfg

    geo = _geo(cl, wb)
    spec = make_frontend_spec(pcfg([pnew(n, cl) for n in NAMES]), wb, 256)
    s = _samples(geo, cl + wb)
    staged = np.zeros(staged_geometry(spec).staged_samples, np.uint16)
    staged[: s.size] = s
    b, q, m = stencil_plain(spec, torch.from_numpy(staged), first)
    rb, rq, rm = rs.stencil(geo, s, first)
    assert np.array_equal(b.numpy(), rb) and np.array_equal(q.numpy(), rq)
    assert np.array_equal(m.numpy().reshape(-1), rm)


@pytest.mark.parametrize("first", [False, True])
def test_chunked_stencil_equals_whole(first):
    geo = _geo(72, 16)
    s = _samples(geo, 3)
    whole = rs.stencil(geo, s, first)
    with check.pool() as pool:
        chunked = check.k1_reference(pool, geo, s, first)
    for a, b in zip(whole, chunked[:3]):
        assert np.array_equal(a, b)
    for a, b in zip(rs.live_words(geo, whole[0]), chunked[3]):
        assert np.array_equal(a, b)


def test_controls_are_rejected():
    """The control of the kernel comparison, at a size the tests hold."""
    geo = _geo(72, 16)
    s = _samples(geo, 9)
    exact = rs.stencil(geo, s, False)
    low = rs.stencil(geo, s, False, "float32")
    numbers = check.compare_k1((*low, False, False), exact)
    assert sum(numbers.values()) > 0, numbers


def _full_r900_quantized(dec):
    """The R900 filter bank over the decoder's whole buffer (the
    reference's every-block form), in exact integers."""
    cfg = dec.cfg
    cl = cfg.chip_length
    limit = cfg.buffer_length - 4 * cl
    csum = np.concatenate([np.zeros(1, np.int64), np.cumsum(dec.r900_signal)])
    c = [csum[k * cl : k * cl + limit] * (1 if k in (0, 4) else 2) for k in range(5)]
    a = np.stack([c[2] - c[4] - c[0], c[1] - c[2] + c[3] - c[4] - c[0], c[1] - c[3] + c[4] - c[0]])
    am = np.argmax(np.abs(a), axis=0)
    chosen = np.take_along_axis(a, am[None, :], axis=0)[0]
    return (am + np.where(chosen > 0, 3, 0)).astype(np.uint8)


def test_oracle_block_filter_equals_whole_buffer_filter():
    """The oracle filters only the newest block's R900 positions and stops a
    preamble search once no position is left: at every block its R900
    stream equals the whole buffer's filter, and its messages are found."""
    from gpubench.reference import packets as pk
    from gpubench.reference.decoder import ReferenceDecoder

    dec = ReferenceDecoder([new_parser(n, 8) for n in NAMES], arithmetic="int")
    cfg = dec.cfg
    bs, rng = cfg.block_size, np.random.default_rng(4)
    n_blocks = 3 * cfg.buffer_length // bs
    i = rng.normal(128, 3, n_blocks * bs)
    bursts = [(pk.r900_chips(pk.make_r900_symbols(123_456 + k)), (2 + 9 * k) * bs + 100)
              for k in range(3)]
    bursts.append((pk.manchester_chips(pk.make_scm_bits(7_654_321, consumption=9)), 30 * bs))
    for chips, at in bursts:
        span = np.repeat(chips, 8)
        i[at : at + span.size] += 100 * span
    q = rng.normal(127, 3, i.size)
    iq = np.stack([i, q], axis=1).clip(0, 255).round().astype(np.uint8).reshape(-1)
    found = []
    for b in range(n_blocks):
        for _, msgs in dec.decode_block(iq[b * cfg.block_size2 : (b + 1) * cfg.block_size2]):
            found.extend(m.meter_id() for m in msgs)
        limit = cfg.buffer_length - 4 * cfg.chip_length
        assert np.array_equal(dec.r900_quantized[:limit], _full_r900_quantized(dec)), b
    assert {123_456, 123_457, 123_458, 7_654_321} <= set(found)
