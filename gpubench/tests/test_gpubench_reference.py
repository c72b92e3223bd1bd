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
