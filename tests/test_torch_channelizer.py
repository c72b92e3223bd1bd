"""The port's channelizer (rtlamr_tpu_torch/ops/channelizer.py and
ops/channelizer_fused.py) against the JAX package's ``ops/channelizer.py``,
on inputs made with numpy from a seed.

The filter designs are numpy in both packages and must be equal to the bit.
The float chains are compared through the requantized u16 output under the
reference's own contract (tests/test_pallas.py ``_assert_requant_parity``):
at most 1e-4 of samples differ, each by at most one u8 LSB per component.
The reason is the JAX side: XLA on the CPU may contract ``a*b + c`` into a
fused multiply-add inside a jitted program, so two f32 chains in the same
order can differ by one ulp, which flips the requantize only exactly at a
.5 boundary. The port's own versions (the plain chain and the CUDA kernel)
round every product and sum and are held to exact equality.

The CUDA kernel itself is held against the plain version by the
``cuda``-marked test, which runs only on a machine with a card:
``python -m pytest --noconftest tests/test_torch_channelizer.py -m cuda``.
"""

import types

import numpy as np
import pytest
import torch

from rtlamr_tpu_torch.ops import build
from rtlamr_tpu_torch.ops import channelizer as tc
from rtlamr_tpu_torch.ops.channelizer_fused import (
    channelize_requantize_fused,
    channelize_requantize_plain,
    kernel_library,
)

# The suite runs in several worker processes at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)


def jax_ref():
    """The JAX package's channelizer (imported here, so the ``cuda`` test
    also collects on a card machine without JAX)."""
    import jax
    import jax.numpy as jnp

    from rtlamr_tpu.ops import channelizer

    return types.SimpleNamespace(jax=jax, jnp=jnp, ch=channelizer)


def assert_requant_parity(got, want):
    """The reference's contract (tests/test_pallas.py:70-87): at most 1e-4
    of samples differ, each within one LSB per component (see the module
    docstring for why the JAX side needs it)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint16
    mism = got != want
    assert mism.mean() <= 1e-4, f"mismatch rate {mism.mean()}"
    if mism.any():
        for shift in (0, 8):
            g = (got.astype(np.int32) >> shift) & 255
            w = (want.astype(np.int32) >> shift) & 255
            assert np.abs(g - w).max() <= 1


def random_wideband(n, frames, seed):
    return np.random.default_rng(seed).integers(0, 256, 2 * n * frames, dtype=np.uint8)


SPECS = [(1, 8, 1.0), (4, 8, 1.0), (12, 8, 1.0), (12, 4, 1.5), (32, 8, 1.0)]


@pytest.mark.parametrize("n,taps,cutoff", SPECS)
def test_filter_design_equals_jax(n, taps, cutoff):
    ref = jax_ref()
    js = ref.ch.ChannelizerSpec(n_channels=n, taps_per_branch=taps, cutoff_scale=cutoff)
    ts = tc.ChannelizerSpec(n_channels=n, taps_per_branch=taps, cutoff_scale=cutoff)
    assert (ts.length, ts.history_frames, ts.history, tc.history_len(ts)) == (
        js.length, js.history_frames, js.history, ref.ch.history_len(js))
    for a, b in ((tc.prototype_lowpass(ts), ref.ch.prototype_lowpass(js)),
                 (tc._polyphase_taps(ts), ref.ch._polyphase_taps(js))):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tc._mix_matrix(ts), ref.ch._mix_matrix(js)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tc.channel_offsets_hz(ts, 2359296), ref.ch.channel_offsets_hz(js, 2359296))


def test_spec_bounds_match_jax():
    ref = jax_ref()
    assert tc.MAX_CHANNELS == ref.ch.MAX_CHANNELS == 32
    for n in (0, 33):
        with pytest.raises(ValueError):
            tc.ChannelizerSpec(n_channels=n)
        with pytest.raises(ValueError):
            ref.ch.ChannelizerSpec(n_channels=n)
    for n in (1, 32):
        assert tc.ChannelizerSpec(n_channels=n).n_channels == n
    np.testing.assert_array_equal(
        tc.channel_offsets_hz(tc.ChannelizerSpec(n_channels=4), 100), [0, 100, -200, -100])


@pytest.mark.parametrize("n", [4, 12, 32])
def test_branches_and_mix_match_jax(n):
    """The branches and the DFT mix, a channel block included, against the
    JAX functions: eagerly and inside ``jax.jit`` (the decoder's path)."""
    ref = jax_ref()
    js, ts = ref.ch.ChannelizerSpec(n_channels=n), tc.ChannelizerSpec(n_channels=n)
    p, f = ts.history_frames, 4096
    wb = random_wideband(n, p + f, seed=n)
    tf = tc.iq_bytes_to_frames(ts, torch.from_numpy(wb))
    jf = ref.ch.iq_bytes_to_frames(js, ref.jnp.asarray(wb))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(
        tc.iq_bytes_to_planes_u16(ts, torch.from_numpy(wb).view(torch.uint16)).numpy(),
        np.asarray(ref.ch.iq_bytes_to_planes_u16(js, ref.jnp.asarray(wb.view(np.uint16)))))
    th, tx = tf[:, :, :p], tf[:, :, p:]
    jh, jx = jf[:, :, :p], jf[:, :, p:]

    ty = tc.polyphase_branches(ts, th, tx)
    jy = ref.ch.polyphase_branches(js, jh, jx)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-4)
    got = tc.requantize_u16(tc.mix_channels(ts, ty))
    assert_requant_parity(got.numpy(), ref.ch.requantize_u16(ref.ch.mix_channels(js, jy)))
    jitted = ref.jax.jit(
        lambda h, x: ref.ch.requantize_u16(ref.ch.channelize(js, h, x)))
    assert_requant_parity(got.numpy(), jitted(jh, jx))
    np.testing.assert_array_equal(
        tc.requantize_u8(tc.mix_channels(ts, ty)).numpy(),
        got.numpy().view(np.uint8).reshape(n, -1))

    c0, cnt = n // 4, n // 2
    blk = tc.mix_channels(ts, ty, c0, cnt)
    jblk = ref.ch.mix_channels(js, jy, c0, cnt)
    assert_requant_parity(tc.requantize_u16(blk).numpy(), ref.ch.requantize_u16(jblk))


def test_mix_channels_block_equals_full():
    """A block of channel rows is exactly the same rows of the full mix."""
    spec = tc.ChannelizerSpec(n_channels=8)
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.normal(size=(2, 8, 256)).astype(np.float32))
    hist = torch.zeros((2, 8, spec.history_frames))
    y = tc.polyphase_branches(spec, hist, xs)
    full = tc.mix_channels(spec, y)
    for c0, cnt in ((0, 2), (2, 4), (6, 2)):
        assert torch.equal(tc.mix_channels(spec, y, c0, cnt), full[:, c0 : c0 + cnt])


def channel_blocks(n):
    """Every block (c0, rows) of n channels with rows dividing n: the
    channel shards of a wideband mesh with n // rows channel shards."""
    return [(n, c0, rows) for rows in range(1, n + 1) if n % rows == 0
            for c0 in range(0, n, rows)]


BLOCKS = channel_blocks(4) + channel_blocks(12)


@pytest.mark.parametrize("n,c0,rows", BLOCKS, ids=[f"n{n}-{c0}+{r}" for n, c0, r in BLOCKS])
def test_channel_block(n, c0, rows):
    """A block of channel rows, as a wideband mesh's channel shard mixes
    it: the generated mix program of the block, emulated, equals the same
    rows of the full program exactly (zeros among the branch outputs); the
    plain K2 of the block equals those rows of the full plain K2 exactly,
    and the JAX ``mix_channels(..., channel_start, channel_count)`` within
    the reference's 1e-4 / one LSB contract."""
    from rtlamr_tpu_torch.ops.channelizer_mix import emulate_mix

    ref = jax_ref()
    rng = np.random.default_rng(n * 100 + c0 * 10 + rows)
    y = rng.normal(scale=60.0, size=(2, n, 1000)).astype(np.float32)
    y[:, :, :20] = 0.0
    y[:, :, 20:40] = -0.0
    full = emulate_mix(n, y[0], y[1])
    blk = emulate_mix(n, y[0], y[1], c0, rows)
    assert blk.shape == (2, rows, 1000)
    assert np.array_equal(blk.view(np.uint32), full[:, c0 : c0 + rows].view(np.uint32))

    ts, js = tc.ChannelizerSpec(n_channels=n), ref.ch.ChannelizerSpec(n_channels=n)
    p, f = ts.history_frames, 2048
    u16 = torch.from_numpy(random_wideband(n, p + f, seed=n + 7 * c0 + rows).view(np.uint16).copy())
    hist, wb = u16[: p * n], u16[p * n :]
    for first in (True, False):
        got = channelize_requantize_fused(ts, hist, wb, first, channel_start=c0,
                                          channel_count=rows)
        want = channelize_requantize_plain(ts, hist, wb, first)[c0 : c0 + rows]
        assert torch.equal(got, want)
    frames = tc.iq_bytes_to_frames(ts, wb)
    jy = ref.ch.polyphase_branches(js, ref.jnp.asarray(tc.iq_bytes_to_frames(ts, hist).numpy()),
                                   ref.jnp.asarray(frames.numpy()))
    assert_requant_parity(got.numpy(), ref.ch.requantize_u16(ref.ch.mix_channels(js, jy, c0, rows)))


def test_channel_block_refusals():
    spec = tc.ChannelizerSpec(n_channels=4)
    u16 = torch.zeros(4 * 64, dtype=torch.uint16)
    hist = torch.zeros(4 * spec.history_frames, dtype=torch.uint16)
    for c0, rows in ((3, 2), (-1, 2), (0, 0), (4, 1)):
        with pytest.raises(ValueError, match="channel block"):
            channelize_requantize_fused(spec, hist, u16, True, channel_start=c0,
                                        channel_count=rows)
    with pytest.raises(ValueError, match=r"out must be \(2, 64\)"):
        channelize_requantize_fused(spec, hist, u16, True, out=torch.zeros((4, 64),
                                    dtype=torch.uint16), channel_start=2, channel_count=2)


def test_channelizer_tone_selectivity():
    """A tone at channel c's center lands on channel c at unity gain and is
    strongly rejected everywhere else."""
    n = 4
    spec = tc.ChannelizerSpec(n_channels=n)
    f = 4096
    t = np.arange(f * n)
    hist = torch.zeros((2, n, spec.history_frames))
    for c in range(n):
        x = np.exp(2j * np.pi * c * t / n) * 50.0
        ri = torch.from_numpy(np.stack([x.real, x.imag]).astype(np.float32))
        ch = tc.channelize(spec, hist, tc.ri_to_frames(spec, ri)).numpy()
        body = ch[:, :, 64:-64]  # skip the filter's edge transients
        gains = np.sqrt((body**2).sum(0).mean(axis=1)) / 50.0
        assert gains[c] == pytest.approx(1.0, abs=0.02)
        assert np.delete(gains, c).max() < 0.02


def test_stream_head_matches_jnp_reference():
    """The first chunk of a stream: the port reads the history as 0.0 (the
    jnp reference's zero f32 history), not as a packed u16 sample. The JAX
    Pallas path packs that zero history as round(127.5) = 128, i.e. +0.5:
    its first taps_per_branch frames differ from the jnp chain, and the
    port's ``first=False`` with history samples 0x8080 reproduces that."""
    ref = jax_ref()
    n, f = 4, 2048
    js, ts = ref.ch.ChannelizerSpec(n_channels=n), tc.ChannelizerSpec(n_channels=n)
    p = ts.history_frames
    wb = random_wideband(n, f, seed=17)
    u16 = torch.from_numpy(wb.view(np.uint16).copy())
    junk = torch.from_numpy(random_wideband(n, p, seed=5).view(np.uint16).copy())

    head = channelize_requantize_plain(ts, junk, u16, first=True)
    jzero = ref.jnp.zeros((2, n, p), ref.jnp.float32)
    jframes = ref.ch.iq_bytes_to_frames(js, ref.jnp.asarray(wb))
    want = ref.jax.jit(lambda h, x: ref.ch.requantize_u16(ref.ch.channelize(js, h, x)))(
        jzero, jframes)
    assert_requant_parity(head.numpy(), want)

    # The Pallas history: 0x8080 samples read back as +0.5 each.
    half = torch.full((p * n,), 0x8080, dtype=torch.int32).to(torch.uint16)
    frames = tc.iq_bytes_to_frames(ts, torch.from_numpy(wb))
    zero_f = tc.channelize(ts, torch.zeros((2, n, p)), frames)
    half_f = tc.channelize(ts, torch.full((2, n, p), 0.5), frames)
    assert not torch.equal(zero_f[:, :, :p], half_f[:, :, :p])
    assert torch.equal(zero_f[:, :, p:], half_f[:, :, p:])
    assert torch.equal(channelize_requantize_plain(ts, half, u16, first=False),
                       tc.requantize_u16(half_f))
    assert torch.equal(head, tc.requantize_u16(zero_f))


@pytest.mark.parametrize("n", [4, 12])
def test_fused_on_cpu_equals_unfused_chain(n):
    """On a CPU tensor the wrapper is the plain version, equal to the
    unfused chain exactly, over two chunks of a stream (zero and carried
    history); ``out=`` writes into a strided view; no kernel launch is
    counted; a layout the kernel does not take is refused."""
    spec = tc.ChannelizerSpec(n_channels=n)
    p, f = spec.history_frames, 3 * 1024 + 40
    chunks = [random_wideband(n, f, seed=s) for s in (1, 2)]
    before = channelize_requantize_fused.launches
    hist = torch.zeros(p * n, dtype=torch.uint16)
    hist_f = torch.zeros((2, n, p))
    for i, wb in enumerate(chunks):
        u16 = torch.from_numpy(wb.view(np.uint16).copy())
        frames = tc.iq_bytes_to_frames(spec, torch.from_numpy(wb))
        want = tc.requantize_u16(tc.channelize(spec, hist_f, frames))
        got = channelize_requantize_fused(spec, hist, u16, first=(i == 0))
        assert got.dtype == torch.uint16 and torch.equal(got, want)
        staged = torch.full((n, f + 100), 7, dtype=torch.int32).to(torch.uint16)
        view = staged[:, 60 : 60 + f]
        assert channelize_requantize_fused(spec, hist, u16, i == 0, out=view) is view
        assert torch.equal(staged[:, 60 : 60 + f], want)
        assert (staged[:, :60].to(torch.int32) == 7).all()
        assert (staged[:, 60 + f :].to(torch.int32) == 7).all()
        hist = u16[(f - p) * n :].clone()
        hist_f = frames[:, :, f - p :]
    assert channelize_requantize_fused.launches == before
    with pytest.raises(ValueError, match="whole frames"):
        channelize_requantize_fused(spec, hist, u16[:-1], False)
    with pytest.raises(ValueError, match="out must be"):
        channelize_requantize_fused(spec, hist, u16, False, out=staged[:, :f].T)
    with pytest.raises(ValueError, match="unsupported device"):
        channelize_requantize_fused(spec, hist.to("meta"), u16.to("meta"), False)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel equals its plain version on the card, byte for byte,
    at every compiled-in class of N (1, 2, 3, 4, 5, 8, 12, 16, 31, 32) with 8
    taps a branch and at N = 12 with the runtime tap loop (4 and 12 taps),
    over a ragged frame count and fewer frames than one tile, with the
    stream head's zero history, a carried history and a chunk off 16-byte
    alignment, into a fresh tensor and into the columns of a staged batch at
    an odd offset; a history of the wrong length is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the channelizer kernel runs only there")
    cases = [(n, 8) for n in (1, 2, 3, 4, 5, 8, 12, 16, 31, 32)] + [(12, 4), (12, 12)]
    # one library an (N, tap class), all nvcc together rather than one a case
    build.build_many(list(dict.fromkeys(kernel_library(n, p == 8) for n, p in cases)))
    # at 2 frames a thread and 512 a tile the last tile holds 125 frames and
    # its last thread one; 37 frames are less than one tile
    for n, p in cases:
        spec = tc.ChannelizerSpec(n_channels=n, taps_per_branch=p)
        for f in (3 * 8192 + 640 + 37, 37):
            wb = torch.from_numpy(
                random_wideband(n, f + p + 1, seed=n + p).view(np.uint16).copy()).cuda()
            hist = wb[: p * n]
            for first, lo in ((True, p * n), (False, p * n), (False, p * n + 1)):
                chunk = wb[lo : lo + f * n]
                before = channelize_requantize_fused.launches
                got = channelize_requantize_fused(spec, hist, chunk, first)
                assert channelize_requantize_fused.launches == before + 1
                want = channelize_requantize_plain(spec, hist, chunk, first)
                staged = torch.zeros((n, f + 512), dtype=torch.uint16, device="cuda")
                channelize_requantize_fused(spec, hist, chunk, first, out=staged[:, 257 : 257 + f])
                torch.cuda.synchronize()
                what = f"N={n} P={p} F={f} first={first} offset={lo}"
                assert got.is_cuda and torch.equal(got.view(torch.int16), want.view(torch.int16)), what
                assert torch.equal(staged[:, 257 : 257 + f].view(torch.int16),
                                   want.view(torch.int16)), what
                assert int(staged[:, :257].view(torch.int16).abs().sum()) == 0, what
                assert int(staged[:, 257 + f :].view(torch.int16).abs().sum()) == 0, what
    with pytest.raises(ValueError):
        channelize_requantize_fused(spec, hist[:-1], chunk, False)  # short history
