"""The port's raw-u8 window API (rtlamr_tpu_torch/ops/frontend.py
``stage_iq``, ``decode_core``, ``frontend_stage``, ``bits_q6``,
``decode_window``, ``decode_window_staged``, ``decode_window_packed`` and
``run_window``) against the JAX package's on the same bytes: seeded u8 IQ
windows, halo first, with packets of every protocol, at 16 and 64 blocks a
window, the stream's first window and a later one. Every result is equal
element for element (the packed buffer byte for byte); ``stage_iq`` equals
``stage_host``.

The JAX package runs its jnp backend on the CPU, as its own tests run it. It
is imported inside the helpers that use it, so the ``cuda`` test runs on a
machine without JAX: ``python -m pytest --noconftest
tests/test_torch_window_api.py -m cuda``."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from rtlamr_tpu_torch.ops import decode_window, run_window
from rtlamr_tpu_torch.ops import frontend as tf
from rtlamr_tpu_torch.ops.spec import make_frontend_spec, stage_host, staged_geometry
from rtlamr_tpu_torch.ops.stencil import decode_stencil
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.protocols.base import build_decoder_config
from rtlamr_tpu_torch.ref import synth

# The suite runs in several worker processes at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

NAMES = ("scm", "scm+", "idm", "netidm", "r900", "r900bcd")
CHIP = 8
CASES = [(16, True), (16, False), (64, True), (64, False)]


@functools.lru_cache(maxsize=None)
def port_spec(window_blocks: int):
    return make_frontend_spec(build_decoder_config([new_parser(n, CHIP) for n in NAMES]),
                              window_blocks)


@functools.lru_cache(maxsize=None)
def capture(window_blocks: int) -> np.ndarray:
    """One window and its halo of u8 IQ: bursts of every protocol in turn
    from sample 100 while they fit, in noise."""
    spec = port_spec(window_blocks)
    sl = spec.symbol_length
    makers = [
        (100, lambda i, at: synth.bits_to_burst(
            synth.make_scm_bits(meter_id=1000 + i, consumption=i), at)),
        (132, lambda i, at: synth.bits_to_burst(
            synth.make_scmplus_bits(endpoint_id=2000 + i, consumption=i), at)),
        (740, lambda i, at: synth.bits_to_burst(synth.make_idm_bits(serial=3000 + i), at)),
        (740, lambda i, at: synth.bits_to_burst(synth.make_netidm_bits(serial=4000 + i), at)),
        (120, lambda i, at: synth.r900_burst(synth.make_r900_symbols(meter_id=5000 + i), at)),
    ]
    bursts, pos, i = [], 100, 0
    while pos + makers[i % len(makers)][0] * sl < spec.total_samples:
        symbols, make = makers[i % len(makers)]
        bursts.append(make(i, pos))
        pos += symbols * sl
        i += 1
    return synth.render_iq(spec.total_samples, bursts, CHIP, noise=3.0,
                           seed=window_blocks)


def numpy_tree(x):
    """A result (dict, list, tuple, tensor or array) as numpy arrays."""
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [numpy_tree(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return None if x is None else np.asarray(x)


def assert_tree_equal(got, want):
    got, want = numpy_tree(got), numpy_tree(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_tree_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_tree_equal(a, b)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def jax_results(window_blocks: int, first: bool) -> dict:
    """Every JAX function's result on the capture, as numpy."""
    import jax
    import jax.numpy as jnp

    from rtlamr_tpu.ops import frontend as jf
    from rtlamr_tpu.protocols import new_parser as jax_parser
    from rtlamr_tpu.protocols.base import build_decoder_config as jax_config

    js = jf.make_frontend_spec(jax_config([jax_parser(n, CHIP) for n in NAMES]),
                               window_blocks)
    iq = capture(window_blocks)
    jiq, jfirst = jnp.asarray(iq), jnp.asarray(first)
    staged = jf.stage_host(js, iq)

    def jit(fn):
        return jax.jit(fn, static_argnums=0)

    return numpy_tree({
        "stage_iq": jit(jf.stage_iq)(js, jiq),
        "decode_core": jit(jf.decode_core)(js, jiq, jfirst),
        "frontend_stage": jit(jf.frontend_stage)(js, jiq, jfirst),
        "bits_q6": jit(jf.bits_q6)(js, jiq, jfirst),
        "decode_window": jf.decode_window(js, jiq, jfirst),
        "decode_window_staged": jf.decode_window_staged(js, jnp.asarray(staged), jfirst),
        "decode_window_packed": jf.decode_window_packed(js, jiq, jfirst),
        "run_window": jf.run_window(js, iq, first),
    })


def port_result(name: str, window_blocks: int, first: bool, device="cpu"):
    spec, iq = port_spec(window_blocks), capture(window_blocks)
    t = torch.from_numpy(iq).to(device)
    return {
        "stage_iq": lambda: tf.stage_iq(spec, t),
        "decode_core": lambda: tf.decode_core(spec, t, first),
        "frontend_stage": lambda: tf.frontend_stage(spec, t, first),
        "bits_q6": lambda: tf.bits_q6(spec, t, first),
        "decode_window": lambda: decode_window(spec, iq, first, device=device),
        "decode_window_staged": lambda: tf.decode_window_staged(
            spec, stage_host(spec, iq), first, device=device),
        "decode_window_packed": lambda: tf.decode_window_packed(spec, t, first, device=device),
        "run_window": lambda: run_window(spec, iq, first, device=device),
    }[name]()


FUNCTIONS = ("stage_iq", "decode_core", "frontend_stage", "bits_q6", "decode_window",
             "decode_window_staged", "decode_window_packed", "run_window")


@pytest.mark.parametrize("window_blocks,first", CASES)
@pytest.mark.parametrize("name", FUNCTIONS)
def test_equals_the_jax_function(name, window_blocks, first):
    got = port_result(name, window_blocks, first)
    want = jax_results(window_blocks, first)[name]
    assert_tree_equal(got, want)
    if name == "decode_window_packed":
        assert got.dtype == torch.uint8 and got.numel() == tf.packed_size(port_spec(window_blocks))
    if name == "stage_iq":
        np.testing.assert_array_equal(
            got.numpy(), stage_host(port_spec(window_blocks), capture(window_blocks)))


@pytest.mark.parametrize("window_blocks", [16, 64])
def test_the_capture_decodes(window_blocks):
    """The windows are not empty: in the later window every preamble group
    keeps a candidate at 64 blocks, and two groups do at 16."""
    res = run_window(port_spec(window_blocks), capture(window_blocks), False, device="cpu")
    counts = np.asarray(res["counts"])
    assert (counts[:, 1] >= 1).sum() >= (4 if window_blocks == 64 else 2)


def test_stage_iq_refusals():
    spec = port_spec(16)
    for bad in (torch.zeros(3, dtype=torch.uint8), torch.zeros(4, dtype=torch.int16),
                torch.zeros(2 * (staged_geometry(spec).staged_samples - spec.pad_shift) + 2,
                            dtype=torch.uint8)):
        with pytest.raises(ValueError, match="stage_iq"):
            tf.stage_iq(spec, bad)


def test_entry_points_need_a_card_or_the_cpu():
    """``device=None`` means the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    spec, iq = port_spec(16), capture(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_window(spec, iq, True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_window(spec, iq, True)


@pytest.mark.cuda
def test_cuda_run_window_equals_cpu():
    """On the card, run_window (through K1) equals its CPU result, and every
    other function reaches K1 there with the same results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode stencil kernel runs only there")
    for window_blocks, first in CASES:
        spec, iq = port_spec(window_blocks), capture(window_blocks)
        before = decode_stencil.launches
        got = run_window(spec, iq, first)
        assert decode_stencil.launches == before + 1
        assert_tree_equal(got, run_window(spec, iq, first, device="cpu"))
        for name in FUNCTIONS[1:]:
            before = decode_stencil.launches
            got = port_result(name, window_blocks, first, device="cuda")
            assert decode_stencil.launches == before + 1, name
            assert_tree_equal(got, port_result(name, window_blocks, first))
