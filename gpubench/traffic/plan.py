"""The general traffic generator: a seeded packet plan and its IQ.

A traffic mix is a JSON file of parameters (``gpubench/traffic/<name>.json``);
a configuration fixes the protocols, the chip length, the rate and the
signal levels. From them and ``--seed`` this module plans one stream of
``lead_seconds`` + the run's seconds + ``tail_seconds`` at the
configuration's real-time rate, and renders the u8 interleaved IQ the
receiver reads: packets of the configuration's message types in turn
(``types``), one every PacketLength + ``gap_blocks`` blocks, each offset
jittered by less than one block; meter IDs unique in the run and every
field drawn from the seed.

No packet starts in the first block of the stream or ends in its last, and
packets are at least one block apart. Noise and packet levels are the
configuration's ``assumed`` values.
"""

from __future__ import annotations

import concurrent.futures
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..reference import packets as pk
from ..reference.protocols import build_decoder_config, new_parser

#: slice of the stream one render task fills, in samples
RENDER_SLICE = 1 << 22
#: threads that render a stream
RENDER_THREADS = min(8, os.cpu_count() or 1)
#: meter IDs are drawn from [1, ID_LIMIT): SCM carries 26 bits of ID
ID_LIMIT = 1 << 26


@dataclass(frozen=True)
class Packet:
    """One planted packet: ``offset`` and ``length`` in samples."""

    index: int
    kind: str  # scm | scm+ | idm | r900
    offset: int
    length: int
    meter_id: int
    fields: Tuple[Tuple[str, int], ...]

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

    def found_by(self, p: Packet) -> int:
        """The sample by which a decoder has found ``p``: a block past its
        start plus PacketLength."""
        return p.offset + self.packet_length + self.block_size

    @property
    def stream_bytes(self) -> int:
        return 2 * self.samples


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
    if config.get("channels", 1) != 1:
        raise ValueError("the generator renders one channel's stream")
    cfg = decoder_config(config)
    bs, cl = cfg.block_size, cfg.chip_length
    window = window_blocks(traffic) * bs
    airtime = traffic["lead_seconds"] + seconds + traffic["tail_seconds"]
    samples = -(-int(airtime * config["sample_rate"]) // bs) * bs
    pos_rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    gap = cfg.packet_length + traffic["gap_blocks"] * bs
    slots: List[Tuple[int, str]] = []
    offset, i = bs, 0
    kinds = traffic["types"]
    while True:
        kind = kinds[i % len(kinds)]
        o = offset + int(pos_rng.integers(0, bs))
        if o + CHIPS[kind] * cl + bs > samples:
            break
        slots.append((o, kind))
        offset += gap
        i += 1
    ids: List[int] = []
    seen = set()
    while len(ids) < len(slots):
        v = int(rng.integers(1, ID_LIMIT))
        if v not in seen:
            seen.add(v)
            ids.append(v)
    packets = []
    for k, ((o, kind), mid) in enumerate(zip(slots, ids)):
        fields = tuple((name, int(rng.integers(0, 1 << width))) for name, width in FIELDS[kind])
        packets.append(Packet(k, kind, o, CHIPS[kind] * cl, mid, fields))
    return Plan(tuple(packets), samples, cl, bs, window, cfg.packet_length, seed)


def render(config: dict, plan: Plan) -> np.ndarray:
    """The plan's u8 interleaved IQ: OOK on I between the assumed low and
    high levels, Q at 127, both plus Gaussian noise of the assumed sigma
    (the receiver's synthetic capture recipe), rendered in slices on a few
    threads."""
    a = config["assumed"]
    hi, lo, noise = float(a["ook_high"]), float(a["ook_low"]), float(a["noise_sigma"])
    total, cl = plan.samples, plan.chip_length
    spans = [(p.offset, p.end, p.chips()) for p in plan.packets]
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

    _run_slices(fill, total)
    return out


def _run_slices(fill, total: int) -> None:
    with concurrent.futures.ThreadPoolExecutor(RENDER_THREADS) as pool:
        for f in [pool.submit(fill, k) for k in range(-(-total // RENDER_SLICE))]:
            f.result()


class Stream:
    """The stream a run feeds: the rendered bytes; before its first sample
    and past its last it reads as zeros."""

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
