"""NumPy oracle decoder — the conformance ground truth.

A scalar/NumPy re-implementation of the reference's per-block DSP chain
(protocol/decode.go) with the exact buffer-shift semantics, frozen here as the
benchmark's oracle of the message stream (numpy and the parsers of
``gpubench.reference.protocols`` only). Two arithmetic modes:

- ``"float32"``: bit-for-bit emulation of the Go arithmetic — f32 magnitude
  LUT (decode.go:209-216), sequential f32 cumulative sum (decode.go:233-236),
  sign-bit quantization including the -0.0 case (decode.go:243), and the
  R900 parser's own f32 filter (r900/r900.go:96-149).
- ``"int"``: the exact-integer formulation of the window program. The LUT
  values scaled by 255^2 are integers ((255-2v)^2 with v the u8 sample), so
  every matched-filter output is an exact integer and the bit decisions are
  deterministic. Near-tie samples (|f| below the f32 rounding error of the
  Go cumsum, ~2^-10) may differ from "float32" mode; decoded message sets
  agree on all but pathological captures.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .protocols.base import (
    Candidate,
    DecoderConfig,
    Message,
    Parser,
    build_decoder_config,
)
from .protocols.r900 import PAYLOAD_SYMBOLS


def mag_lut_f32() -> np.ndarray:
    """256-entry normalized squared-deviation LUT (decode.go:209-216)."""
    idx = np.arange(256, dtype=np.float32)
    lut = (np.float32(127.5) - idx) / np.float32(127.5)
    return (lut * lut).astype(np.float32)


def mag_int(iq_bytes: np.ndarray) -> np.ndarray:
    """Exact-integer magnitude: 255^2 * (lut[i] + lut[q]) as int64.

    (255 - 2v)^2 is the integer form of ((127.5 - v)/127.5)^2 * 255^2.
    """
    v = iq_bytes.astype(np.int64)
    d = 255 - 2 * v
    sq = d * d
    return sq[0::2] + sq[1::2]


class ReferenceDecoder:
    """Block-at-a-time oracle with the Go buffer-shift semantics."""

    def __init__(self, parsers: Sequence[Parser], arithmetic: str = "float32"):
        assert arithmetic in ("float32", "int")
        self.arithmetic = arithmetic
        self.parsers = list(parsers)
        self.cfg: DecoderConfig = build_decoder_config(self.parsers)
        cfg = self.cfg

        if arithmetic == "float32":
            self.signal = np.zeros(cfg.block_size + cfg.symbol_length, np.float32)
            self.lut = mag_lut_f32()
        else:
            self.signal = np.zeros(cfg.block_size + cfg.symbol_length, np.int64)
        self.quantized = np.zeros(cfg.buffer_length, np.uint8)

        # Preamble groups in registration order, with their bit arrays and
        # per-group slice widths.
        self.groups: List[Tuple[str, np.ndarray, int, List[Parser]]] = []
        for preamble, group_parsers in cfg.preamble_groups.items():
            bits = np.frombuffer(preamble.encode(), np.uint8) - ord("0")
            self.groups.append(
                (
                    preamble,
                    bits,
                    cfg.group_packet_symbols(preamble),
                    group_parsers,
                )
            )

        # R900 state (r900/r900.go:161-170): the R900 parser keeps its own
        # copy of the magnitude signal sized BufferLength and a 6-ary
        # quantized stream derived from it.
        self.wants_r900 = cfg.wants_r900
        if self.wants_r900:
            dtype = np.float32 if arithmetic == "float32" else np.int64
            self.r900_signal = np.zeros(cfg.buffer_length, dtype)
            self.r900_quantized = np.zeros(cfg.buffer_length, np.uint8)

    # -- DSP stages ---------------------------------------------------------

    def _demodulate(self, block: np.ndarray) -> np.ndarray:
        if self.arithmetic == "float32":
            return (self.lut[block[0::2]] + self.lut[block[1::2]]).astype(
                np.float32
            )
        return mag_int(block)

    def _filter_quantize(self) -> np.ndarray:
        """Manchester matched filter + 1-bit quantize (decode.go:229-245)."""
        cfg = self.cfg
        n = cfg.block_size
        cl, sl = cfg.chip_length, cfg.symbol_length
        if self.arithmetic == "float32":
            csum = np.concatenate(
                [np.zeros(1, np.float32), np.cumsum(self.signal, dtype=np.float32)]
            )
            lower = csum[cl : cl + n]
            f = (lower - csum[:n]) - (csum[sl : sl + n] - lower)
            return (~np.signbit(f)).astype(np.uint8)
        csum = np.concatenate([np.zeros(1, np.int64), np.cumsum(self.signal)])
        f = 2 * csum[cl : cl + n] - csum[:n] - csum[sl : sl + n]
        return (f >= 0).astype(np.uint8)

    def _search(self, preamble_bits: np.ndarray) -> np.ndarray:
        """Exact preamble positions in [0, BlockSize) (decode.go:255-328).

        The reference's two-stage byte elimination is a scalar-CPU
        optimization with a result identical to the exhaustive stride check,
        which is what runs here.
        """
        cfg = self.cfg
        n = cfg.block_size
        sl = cfg.symbol_length
        ok = np.ones(n, dtype=bool)
        for k, bit in enumerate(preamble_bits):
            ok &= self.quantized[k * sl : k * sl + n] == bit
            # No position left: no later bit can bring one back.
            if k % 8 == 7 and not ok.any():
                break
        return np.nonzero(ok)[0]

    def _slice(self, indices: np.ndarray, n_symbols: int) -> List[Candidate]:
        """Strided bit gather per hit (decode.go:353-375)."""
        sl = self.cfg.symbol_length
        out = []
        for idx in indices:
            if idx > self.cfg.block_size:
                continue
            bits = self.quantized[idx : idx + n_symbols * sl : sl].copy()
            out.append(Candidate(idx=int(idx), bits=bits))
        return out

    def _r900_filter(self) -> None:
        """R900 3-kernel filter bank + 6-ary quantize (r900/r900.go:82-150).

        In ``"int"`` arithmetic every output is an exact integer function
        of the 4 ChipLength samples from its position, so the positions
        whose samples all lie in the shifted part of the buffer keep the
        previous block's outputs, shifted by one block, and only the last
        BlockSize positions are computed (from a prefix sum that starts
        where they read): the same bytes as filtering the whole buffer."""
        cfg = self.cfg
        cl = cfg.chip_length
        limit = cfg.buffer_length - 4 * cl
        start = 0
        if self.arithmetic == "float32":
            csum = np.concatenate(
                [
                    np.zeros(1, np.float32),
                    np.cumsum(self.r900_signal, dtype=np.float32),
                ]
            )
        else:
            start = cfg.packet_length - 4 * cl
            bs = cfg.block_size
            self.r900_quantized[:start] = self.r900_quantized[bs : bs + start]
            csum = np.concatenate([np.zeros(1, np.int64), np.cumsum(self.r900_signal[start:])])
            limit -= start
        c0 = csum[:limit]
        c1 = 2 * csum[cl : cl + limit]
        c2 = 2 * csum[2 * cl : 2 * cl + limit]
        c3 = 2 * csum[3 * cl : 3 * cl + limit]
        c4 = csum[4 * cl : 4 * cl + limit]
        a0 = c2 - c4 - c0  # 1100
        a1 = c1 - c2 + c3 - c4 - c0  # 1010
        a2 = c1 - c3 + c4 - c0  # 1001
        m0, m1, m2 = np.abs(a0), np.abs(a1), np.abs(a2)
        # The first of the largest, as the strict > comparisons of
        # r900.go:133-143 choose.
        argmax = (m1 > m0).astype(np.uint8)
        argmax[m2 > np.maximum(m0, m1)] = 2
        chosen = np.where(argmax == 0, a0, np.where(argmax == 1, a1, a2))
        q = argmax + np.where(chosen > 0, 3, 0).astype(np.uint8)
        self.r900_quantized[start : start + limit] = q

    def _r900_symbols(self, idx: int) -> np.ndarray:
        """42 payload symbols at stride 4*ChipLength (r900/r900.go:187-193)."""
        cfg = self.cfg
        payload_idx = idx + cfg.preamble_length - cfg.symbol_length
        stride = 4 * cfg.chip_length
        return self.r900_quantized[
            payload_idx : payload_idx + PAYLOAD_SYMBOLS * stride : stride
        ].copy()

    # -- Block decode -------------------------------------------------------

    def decode_block(self, block_bytes: np.ndarray) -> List[Tuple[Parser, List[Message]]]:
        """Decode one BlockSize2-byte sample block (decode.go:163-197).

        Returns (parser, messages) pairs in deterministic registration order
        (the reference fans out to parser goroutines; order there is
        scheduler-dependent, the message set is not).
        """
        cfg = self.cfg
        block = np.asarray(block_bytes, dtype=np.uint8)
        assert block.size == cfg.block_size2, (block.size, cfg.block_size2)

        # Shift history buffers (decode.go:165-166).
        bs = cfg.block_size
        self.signal[: cfg.symbol_length] = self.signal[bs:]
        self.quantized[: cfg.packet_length] = self.quantized[bs:]

        self.signal[cfg.symbol_length :] = self._demodulate(block)
        self.quantized[cfg.packet_length :] = self._filter_quantize()

        if self.wants_r900:
            # r900/r900.go:169-170: shift own signal, append decoder signal.
            self.r900_signal[: cfg.packet_length] = self.r900_signal[bs:]
            self.r900_signal[cfg.packet_length :] = self.signal[cfg.symbol_length :]
            self._r900_filter()

        results: List[Tuple[Parser, List[Message]]] = []
        for _, pre_bits, n_symbols, group_parsers in self.groups:
            hits = self._search(pre_bits)
            cands = self._slice(hits, n_symbols)
            needs_r900 = any(p.wants_r900_symbols for p in group_parsers)
            if needs_r900:
                for cand in cands:
                    cand.r900_symbols = self._r900_symbols(cand.idx)
            for p in group_parsers:
                results.append((p, p.parse(cands)))
        return results

    def decode_capture(
        self, iq_bytes: np.ndarray, dedup: bool = True
    ) -> List[Tuple[int, Message]]:
        """Decode a whole capture block-by-block with digest dedup.

        Mirrors the Run loop's steady state (main.go:207-295) minus
        filters/encoders. Returns (block_index, message) pairs.
        """
        from .dedup import BlockDeduper
        from .protocols.base import digest as mk_digest

        iq_bytes = np.asarray(iq_bytes, dtype=np.uint8)
        bs2 = self.cfg.block_size2
        n_blocks = iq_bytes.size // bs2
        deduper = BlockDeduper()
        out: List[Tuple[int, Message]] = []
        for b in range(n_blocks):
            deduper.start_block()
            block = iq_bytes[b * bs2 : (b + 1) * bs2]
            for _parser, msgs in self.decode_block(block):
                for msg in msgs:
                    if not dedup or deduper.check(mk_digest(msg)):
                        out.append((b, msg))
            deduper.end_block()
        return out
