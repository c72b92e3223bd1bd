"""The general traffic generator: a seeded packet plan and its IQ.

A traffic mix is a JSON file of parameters (``gpubench/traffic/<name>.json``);
a configuration fixes the protocols, the chip length, the rate, the number
of channels and the signal levels. From them and ``--seed`` this module
plans one stream of ``lead_seconds`` + the run's seconds + ``tail_seconds``
at the configuration's real-time rate, and renders the u8 interleaved IQ the
receiver reads: packets of the configuration's message types in turn
(``types``), one every PacketLength + ``gap_blocks`` blocks, each offset
jittered by less than one block; meter IDs unique in the run and every
field drawn from the seed.

No packet starts in the first block of the stream or ends in its last, and
the packets of one channel are at least one block apart. Noise and packet
levels are the configuration's ``assumed`` values.

One channel (``channels`` 1) is one rtl-sdr dongle's stream: OOK on I.
With ``channels`` N > 1 the stream is one wideband stream of N channels at
N times the rate (frame m is wideband samples ``m N .. m N + N - 1``), and
the mix's ``channel_plan`` places the packets: ``round_robin``, the one
train above with packet i on channel i mod N; or ``parallel``, a train of
its own for each channel (its start and jitter drawn from the seed), so
packets overlap in time across channels. A packet on channel c is its chip
envelope on a carrier ``c / N`` of the wideband rate above the stream's
centre (the filter bank's channel c), at a phase drawn from the seed, in
complex Gaussian noise around 127.5. Offsets and lengths are in one
channel's samples either way.
"""

from __future__ import annotations

import concurrent.futures
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..reference import packets as pk
from ..reference.protocols import build_decoder_config, new_parser

#: slice of the stream one render task fills, in samples
RENDER_SLICE = 1 << 22
#: threads that render a stream
RENDER_THREADS = min(8, os.cpu_count() or 1)
#: meter IDs are drawn from [1, ID_LIMIT): SCM carries 26 bits of ID
ID_LIMIT = 1 << 26
#: the mix's ``channel_plan`` values (read only when channels > 1)
CHANNEL_PLANS = ("round_robin", "parallel")


@dataclass(frozen=True)
class Packet:
    """One planted packet: ``offset`` and ``length`` in samples."""

    index: int
    kind: str  # scm | scm+ | idm | r900
    offset: int
    length: int
    meter_id: int
    fields: Tuple[Tuple[str, int], ...]
    #: the filter bank's channel it is sent on (0 in a one-channel stream)
    channel: int = 0

    @property
    def end(self) -> int:
        return self.offset + self.length

    def chips(self) -> np.ndarray:
        f = dict(self.fields)
        if self.kind == "scm":
            return pk.manchester_chips(pk.make_scm_bits(self.meter_id, **f))
        if self.kind == "scm+":
            return pk.manchester_chips(pk.make_scmplus_bits(self.meter_id, **f))
        if self.kind == "idm":
            return pk.manchester_chips(pk.make_idm_bits(self.meter_id, **f))
        if self.kind == "r900":
            return pk.r900_chips(pk.make_r900_symbols(self.meter_id, **f))
        raise ValueError(f"unknown packet kind {self.kind!r}")


#: the fields drawn for each kind, with their widths in bits
FIELDS: Dict[str, Tuple[Tuple[str, int], ...]] = {
    "scm": (("meter_type", 4), ("tamper_phy", 2), ("tamper_enc", 2), ("consumption", 24)),
    "scm+": (("endpoint_type", 8), ("consumption", 32), ("tamper", 16)),
    "idm": (("ert_type", 4), ("consumption", 32)),
    "r900": (("unkn1", 8), ("nouse", 6), ("backflow", 2), ("consumption", 24),
             ("unkn3", 2), ("leak", 4), ("leaknow", 2)),
}
#: chips a packet of each kind renders (manchester: 2 a bit; R900: 32
#: preamble symbols of 2 chips and 42 payload symbols of 4)
CHIPS = {"scm": 2 * 96, "scm+": 2 * 128, "idm": 2 * 736, "r900": 2 * 32 + 4 * 42}


@dataclass(frozen=True)
class Plan:
    packets: Tuple[Packet, ...]
    #: samples of the stream
    samples: int
    chip_length: int
    block_size: int
    window: int  # samples a window of the cell's flags
    #: the decoder config's PacketLength: a packet starting at sample s is
    #: found once the block holding sample s + PacketLength is decoded
    packet_length: int
    #: the seed of the noise (the run's)
    noise_seed: int
    #: channels of the stream; ``samples`` and every offset count one
    #: channel's samples
    channels: int = 1

    def found_by(self, p: Packet) -> int:
        """The sample by which a decoder has found ``p``: a block past its
        start plus PacketLength."""
        return p.offset + self.packet_length + self.block_size

    @property
    def wide_block(self) -> int:
        """Samples of the stream in one block of a channel."""
        return self.channels * self.block_size

    @property
    def stream_samples(self) -> int:
        return self.channels * self.samples

    @property
    def stream_bytes(self) -> int:
        return 2 * self.stream_samples


def decoder_config(config: dict):
    """The reference decoder config of a configuration's message types."""
    return build_decoder_config([new_parser(n, config["symbollength"]) for n in config["msgtype"]])


def window_blocks(traffic: dict) -> int:
    """Blocks a window of the mix's CLI preset (``-windowblocks=N``)."""
    for flag in traffic["flags"]:
        if flag.startswith("-windowblocks="):
            return int(flag.split("=", 1)[1])
    raise ValueError("a traffic mix's flags set -windowblocks")


def make_plan(config: dict, traffic: dict, seed: int, seconds: float) -> Plan:
    """The packet plan of one run of a cell."""
    n = int(config.get("channels", 1))
    cfg = decoder_config(config)
    bs, cl = cfg.block_size, cfg.chip_length
    window = window_blocks(traffic) * bs
    airtime = traffic["lead_seconds"] + seconds + traffic["tail_seconds"]
    samples = -(-int(airtime * config["sample_rate"]) // bs) * bs
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    gap = cfg.packet_length + traffic["gap_blocks"] * bs
    kinds = traffic["types"]
    how = "round_robin" if n == 1 else traffic.get("channel_plan")
    if how not in CHANNEL_PLANS:
        raise ValueError(f"channel_plan {how!r}: want one of {CHANNEL_PLANS}")
    if how == "round_robin":
        slots = [(o, kind, i % n) for i, (o, kind, _) in enumerate(_train(
            np.random.default_rng(np.random.SeedSequence([seed, 1])),
            kinds, bs, bs, gap, cl, samples, 0))]
    else:
        slots = []
        for c in range(n):
            g = np.random.default_rng(np.random.SeedSequence([seed, 1, c]))
            start = bs + int(g.integers(0, gap))
            slots.extend(_train(g, kinds[c % len(kinds):] + kinds[: c % len(kinds)],
                                start, bs, gap, cl, samples, c))
        slots.sort(key=lambda t: (t[0], t[2]))
    ids: List[int] = []
    seen = set()
    while len(ids) < len(slots):
        v = int(rng.integers(1, ID_LIMIT))
        if v not in seen:
            seen.add(v)
            ids.append(v)
    packets = []
    for k, ((o, kind, c), mid) in enumerate(zip(slots, ids)):
        fields = tuple((name, int(rng.integers(0, 1 << width))) for name, width in FIELDS[kind])
        packets.append(Packet(k, kind, o, CHIPS[kind] * cl, mid, fields, c))
    return Plan(tuple(packets), samples, cl, bs, window, cfg.packet_length, seed, n)


def _train(pos_rng, kinds, offset: int, bs: int, gap: int, cl: int, samples: int,
           channel: int) -> List[Tuple[int, str, int]]:
    """(offset, kind, channel) of one train: ``kinds`` in turn from
    ``offset``, one every ``gap`` samples, each jittered by less than a
    block, while the packet and a block after it fit."""
    slots = []
    i = 0
    while True:
        kind = kinds[i % len(kinds)]
        o = offset + int(pos_rng.integers(0, bs))
        if o + CHIPS[kind] * cl + bs > samples:
            break
        slots.append((o, kind, channel))
        offset += gap
        i += 1
    return slots


def render(config: dict, plan: Plan, out: Optional[np.ndarray] = None) -> np.ndarray:
    """The plan's u8 interleaved IQ (into ``out`` when given). One channel:
    OOK on I between the assumed low and high levels, Q at 127, both plus
    Gaussian noise of the assumed sigma (the receiver's synthetic capture
    recipe), rendered in slices on a few threads. Several: see
    :func:`render_wideband`."""
    if plan.channels > 1:
        out = np.empty(plan.stream_bytes, np.uint8) if out is None else out
        render_wideband(config, plan, out)
        return out
    a = config["assumed"]
    hi, lo, noise = float(a["ook_high"]), float(a["ook_low"]), float(a["noise_sigma"])
    total, cl = plan.samples, plan.chip_length
    spans = [(p.offset, p.end, p.chips()) for p in plan.packets]
    if out is None:
        out = np.empty(2 * total, np.uint8)

    def fill(k: int) -> None:
        a0, a1 = k * RENDER_SLICE, min((k + 1) * RENDER_SLICE, total)
        g = np.random.default_rng(np.random.SeedSequence([plan.noise_seed, 2, k]))
        i = np.full(a1 - a0, lo, np.float32)
        for start, end, chips in spans:
            s0, s1 = max(start, a0), min(end, a1)
            if s0 < s1:
                on = chips[(np.arange(s0, s1) - start) // cl] > 0
                i[s0 - a0 : s1 - a0][on] = hi
        i += g.standard_normal(a1 - a0, dtype=np.float32) * np.float32(noise)
        q = g.standard_normal(a1 - a0, dtype=np.float32) * np.float32(noise) + np.float32(127.0)
        out[2 * a0 : 2 * a1 : 2] = np.clip(np.rint(i), 0, 255)
        out[2 * a0 + 1 : 2 * a1 : 2] = np.clip(np.rint(q), 0, 255)

    _run_slices(fill, -(-total // RENDER_SLICE))
    return out


def render_wideband(config: dict, plan: Plan, out: np.ndarray) -> int:
    """The plan's wideband u8 interleaved IQ into ``out``: each packet's chip
    envelope, of the assumed ``amplitude``, on its channel's carrier at a
    phase drawn from the seed, plus complex Gaussian noise of the assumed
    sigma around 127.5; rounded and clipped to u8, in slices of whole frames
    on a few threads. Returns the number of components the clip changed."""
    a = config["assumed"]
    amp, noise = float(a["amplitude"]), float(a["noise_sigma"])
    n, cl, frames = plan.channels, plan.chip_length, plan.samples
    g = np.random.default_rng(np.random.SeedSequence([plan.noise_seed, 4]))
    phase = g.uniform(0.0, 2 * np.pi, len(plan.packets))
    spans = []
    for p, ph in zip(plan.packets, phase):
        ang = 2 * np.pi * p.channel * np.arange(n) / n + ph
        spans.append((p.offset, p.end, p.chips().astype(np.float32) * np.float32(amp),
                      np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)))
    step = max(RENDER_SLICE // n, 1)
    clipped = [0] * -(-frames // step)

    def fill(k: int) -> None:
        f0, f1 = k * step, min((k + 1) * step, frames)
        g = np.random.default_rng(np.random.SeedSequence([plan.noise_seed, 3, k]))
        m = (f1 - f0) * n
        re = g.standard_normal(m, dtype=np.float32) * np.float32(noise) + np.float32(127.5)
        im = g.standard_normal(m, dtype=np.float32) * np.float32(noise) + np.float32(127.5)
        re2, im2 = re.reshape(-1, n), im.reshape(-1, n)
        for start, end, env, cr, ci in spans:
            s0, s1 = max(start, f0), min(end, f1)
            if s0 < s1:
                e = env[(np.arange(s0, s1) - start) // cl][:, None]
                re2[s0 - f0 : s1 - f0] += e * cr
                im2[s0 - f0 : s1 - f0] += e * ci
        re, im = np.rint(re), np.rint(im)
        clipped[k] = int(np.count_nonzero((re < 0) | (re > 255))
                         + np.count_nonzero((im < 0) | (im > 255)))
        out[2 * f0 * n : 2 * f1 * n : 2] = np.clip(re, 0, 255)
        out[2 * f0 * n + 1 : 2 * f1 * n : 2] = np.clip(im, 0, 255)

    _run_slices(fill, len(clipped))
    return sum(clipped)


def _run_slices(fill, slices: int) -> None:
    with concurrent.futures.ThreadPoolExecutor(RENDER_THREADS) as pool:
        for f in [pool.submit(fill, k) for k in range(slices)]:
            f.result()


class Stream:
    """The stream a run feeds: the rendered bytes; before its first sample
    and past its last it reads as zeros. Samples count the stream's own
    (wideband ones when it has several channels)."""

    def __init__(self, plan: Plan, data: np.ndarray):
        self.plan = plan
        self.u16 = np.ascontiguousarray(data).view(np.uint16)

    def samples_u16(self, lo: int, hi: int) -> np.ndarray:
        """Samples ``[lo, hi)`` as u16, I in the low byte."""
        out = np.zeros(hi - lo, np.uint16)
        a, b = max(lo, 0), min(hi, self.u16.size)
        if b > a:
            out[a - lo : b - lo] = self.u16[a:b]
        return out

    def bytes(self, lo: int, hi: int) -> np.ndarray:
        """u8 IQ of samples ``[lo, hi)``."""
        return self.samples_u16(lo, hi).view(np.uint8)
