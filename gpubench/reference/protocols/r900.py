"""R900 — Neptune R900 water-meter message (reference: r900/r900.go).

The R900 signal is 4-ary: each data symbol spans 4 chips and is one of six
patterns (1100, 1010, 1001 and their inversions). The shared Manchester
front-end finds preamble hits (preamble
``00000000000000001110010101100100``, 32 symbols, center frequency
912380000 Hz, r900/r900.go:57-65); the frontend then samples 42 payload
symbols from its own 6-ary quantized stream at stride 4*ChipLength starting
at hit + PreambleLength - SymbolLength (r900/r900.go:187-193). This module
implements the host-side remainder: base-6 digit pairs -> 21 x 5-bit symbols
(reject any pair > 31, :199-207), GF(32) Reed-Solomon syndrome check over a
31-symbol codeword with 5 parity symbols at offset 29 (:215-221), and
bitfield extraction (:223-242).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..utils.gf import r900_field
from .base import (
    Candidate,
    Digest,
    Message,
    PacketConfig,
    Parser,
    register_parser,
)

PAYLOAD_SYMBOLS = 42  # r900/r900.go:30
PACKET_SYMBOLS = 116
PREAMBLE = "00000000000000001110010101100100"


def packet_config(chip_length: int) -> PacketConfig:
    return PacketConfig(
        protocol="r900",
        preamble=PREAMBLE,
        data_rate=32768,
        chip_length=chip_length,
        preamble_symbols=32,
        packet_symbols=PACKET_SYMBOLS,
        center_freq=912380000,
    )


@dataclass
class R900(Message):
    ID: int
    Unkn1: int
    NoUse: int
    BackFlow: int
    Consumption: int
    Unkn3: int
    Leak: int
    LeakNow: int
    checksum_symbols: bytes = b""

    _TYPE = "R900"

    def msg_type(self) -> str:
        return self._TYPE

    def meter_id(self) -> int:
        return self.ID

    def meter_type(self) -> int:
        return self.Unkn1

    def checksum(self) -> bytes:
        return self.checksum_symbols

    def __str__(self) -> str:
        return (
            f"{{ID:{self.ID:10d} Unkn1:0x{self.Unkn1:02X} "
            f"NoUse:{self.NoUse:2d} BackFlow:{self.BackFlow:1d} "
            f"Consumption:{self.Consumption:8d} Unkn3:0x{self.Unkn3:02X} "
            f"Leak:{self.Leak:2d} LeakNow:{self.LeakNow:1d}}}"
        )

    def record(self) -> List[str]:
        return [
            str(self.ID),
            str(self.Unkn1),
            str(self.NoUse),
            str(self.BackFlow),
            str(self.Consumption),
            str(self.Unkn3),
            str(self.Leak),
            str(self.LeakNow),
        ]

    def to_dict(self) -> dict:
        return {
            "ID": self.ID,
            "Unkn1": self.Unkn1,
            "NoUse": self.NoUse,
            "BackFlow": self.BackFlow,
            "Consumption": self.Consumption,
            "Unkn3": self.Unkn3,
            "Leak": self.Leak,
            "LeakNow": self.LeakNow,
        }


def symbols_to_message(symbols: np.ndarray) -> Optional[R900]:
    """Decode 42 4-ary payload symbols into an R900 message, or None.

    Mirrors r900/r900.go:187-244: base-6 digit pairs -> 5-bit symbols
    (reject > 31), RS syndrome must be all-zero, then bitfield extraction.
    """
    digits = np.asarray(symbols, dtype=np.int64)
    pairs = digits.reshape(21, 2)
    sym = pairs[:, 0] * 6 + pairs[:, 1]
    if (sym > 31).any():
        return None
    sym = sym.astype(np.uint8)

    # 31-symbol RS codeword: data in [0:16], parity in [26:31] (r900.go:215-217)
    codeword = np.zeros(31, dtype=np.uint8)
    codeword[:16] = sym[:16]
    codeword[26:] = sym[16:]
    if r900_field().syndrome(codeword, 5, 29).any():
        return None

    bits = np.unpackbits(sym[:, None], axis=1)[:, 3:].reshape(-1)  # 21*5 bits

    def bf(lo: int, hi: int) -> int:
        v = 0
        for b in bits[lo:hi]:
            v = (v << 1) | int(b)
        return v

    return R900(
        ID=bf(0, 32),
        Unkn1=bf(32, 40),
        NoUse=bf(40, 46),
        BackFlow=bf(46, 48),
        Consumption=bf(48, 72),
        Unkn3=bf(72, 74),
        Leak=bf(74, 78),
        LeakNow=bf(78, 80),
        checksum_symbols=bytes(sym[16:21]),
    )


class R900Parser(Parser):
    wants_r900_symbols = True

    def __init__(self, chip_length: int):
        super().__init__(packet_config(chip_length))

    def valid_mask(self, data, syms):
        """Batched base-6 digit check + GF(32) RS syndrome (r900.go:199-221)."""
        from ..utils.gf import rs_syndromes_batch

        if syms is None:
            return np.zeros(data.shape[0], dtype=bool)
        digits = syms.astype(np.int64).reshape(syms.shape[0], 21, 2)
        sym = digits[:, :, 0] * 6 + digits[:, :, 1]  # (N, 21)
        in_range = ~(sym > 31).any(axis=1)
        codewords = np.zeros((syms.shape[0], 31), dtype=np.uint8)
        codewords[:, :16] = sym[:, :16] & 31
        codewords[:, 26:] = sym[:, 16:] & 31
        syn_ok = ~rs_syndromes_batch(codewords, 5, 29).any(axis=1)
        return in_range & syn_ok

    def device_validator(self):
        from .base import DeviceValidator

        return DeviceValidator(rs=True)

    def _wrap(self, msg: R900) -> Message:
        return msg

    def parse(self, candidates: Sequence[Candidate]) -> List[Message]:
        out: List[Message] = []
        seen = set()
        for cand in candidates:
            if cand.r900_symbols is None:
                continue
            digits = np.asarray(cand.r900_symbols, dtype=np.int64)
            pairs = digits.reshape(21, 2)
            sym = pairs[:, 0] * 6 + pairs[:, 1]
            if (sym > 31).any():
                continue
            key = bytes(sym.astype(np.uint8))
            if key in seen:
                continue
            seen.add(key)
            msg = symbols_to_message(cand.r900_symbols)
            if msg is None:
                continue
            out.append(self._wrap(msg))
        return out

    def parse_batch(self, data, syms, valid=None):
        """Whole-window vectorized parse: batched base-6 conversion, batched
        RS syndromes, batched bitfields (r900/r900.go:187-244)."""
        from ..utils.bits import bitfield_rows as f

        if syms is None:
            return {}
        if valid is None:
            valid = self.valid_mask(data, syms)
        rows = np.nonzero(valid)[0]
        if rows.size == 0:
            return {}
        digits = syms[rows].astype(np.int64).reshape(rows.size, 21, 2)
        sym = (digits[:, :, 0] * 6 + digits[:, :, 1]).astype(np.uint8)
        # 21 x 5-bit symbols -> 105 payload bits per row.
        bits = np.unpackbits(sym[:, :, None], axis=2)[:, :, 3:].reshape(
            rows.size, 105
        )
        ids = f(bits, 0, 32).tolist()
        unkn1 = f(bits, 32, 40).tolist()
        nouse = f(bits, 40, 46).tolist()
        backflow = f(bits, 46, 48).tolist()
        consumption = f(bits, 48, 72).tolist()
        unkn3 = f(bits, 72, 74).tolist()
        leak = f(bits, 74, 78).tolist()
        leaknow = f(bits, 78, 80).tolist()
        chk = np.ascontiguousarray(sym[:, 16:21]).tobytes()
        wrap = self._wrap
        out = {}
        for j, r in enumerate(rows.tolist()):
            m = wrap(
                R900(
                    ID=ids[j],
                    Unkn1=unkn1[j],
                    NoUse=nouse[j],
                    BackFlow=backflow[j],
                    Consumption=consumption[j],
                    Unkn3=unkn3[j],
                    Leak=leak[j],
                    LeakNow=leaknow[j],
                    checksum_symbols=chk[5 * j : 5 * j + 5],
                )
            )
            # _wrap may retype (R900BCD): read the digest type off the
            # wrapped message.
            m._digest = Digest(
                m._TYPE, unkn1[j], ids[j], chk[5 * j : 5 * j + 5]
            )
            out[r] = m
        return out


register_parser("r900", R900Parser)
