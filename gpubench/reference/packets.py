"""Packet builders: valid ERT packets (correct CRCs and Reed-Solomon
parity) as Manchester or 4-ary chip streams.

A frozen copy of the receiver's synthetic-packet builders; the traffic
generator (``gpubench/traffic/plan.py``) renders the chips into IQ.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from .utils.bits import pack_bits, unpack_bits
from .utils.crc import CRC, crc_table
from .utils.gf import GF, r900_field
from .protocols import r900 as r900_proto
from .protocols import scm as scm_proto

# ---------------------------------------------------------------------------
# CRC tail solving (GF(2) linear algebra)


def _crc_run(state: int, data: Sequence[int], poly: int) -> int:
    tbl = crc_table(poly)
    for b in data:
        state = ((state << 8) ^ int(tbl[((state >> 8) ^ b) & 0xFF])) & 0xFFFF
    return state


def solve_crc_tail(crc: CRC, prefix: Sequence[int], target: Optional[int] = None) -> bytes:
    """Two bytes t such that checksum(prefix + t) == target (residue).

    The table CRC update is linear over GF(2) in (state, bytes), so the map
    from the 16 unknown tail bits to the final state is affine; solve the
    16x16 system by Gaussian elimination.
    """
    if target is None:
        target = crc.residue
    state = _crc_run(crc.init, [int(b) for b in prefix], crc.poly)
    base = _crc_run(state, [0, 0], crc.poly)
    # Column i: effect of tail bit i (bit 15 = MSB of first byte).
    cols = []
    for i in range(16):
        word = 1 << (15 - i)
        tail = [(word >> 8) & 0xFF, word & 0xFF]
        cols.append(_crc_run(0, tail, crc.poly) ^ _crc_run(0, [0, 0], crc.poly))
    rhs = base ^ target

    # Gaussian elimination over GF(2): find x with xor of chosen cols == rhs.
    pivots = {}
    reduced = []
    for i, col in enumerate(cols):
        vec, sel = col, 1 << i
        for bit, (pvec, psel) in pivots.items():
            if vec & bit:
                vec ^= pvec
                sel ^= psel
        if vec:
            msb = 1 << (vec.bit_length() - 1)
            pivots[msb] = (vec, sel)
        reduced.append((vec, sel))
    x = 0
    v = rhs
    for bit in sorted(pivots, reverse=True):
        if v & bit:
            pvec, psel = pivots[bit]
            v ^= pvec
            x ^= psel
    if v:
        raise ValueError("CRC tail system is inconsistent")
    word = 0
    for i in range(16):
        if x & (1 << i):
            word |= 1 << (15 - i)
    return bytes([(word >> 8) & 0xFF, word & 0xFF])


# ---------------------------------------------------------------------------
# Reed-Solomon parity solving for R900


def solve_r900_parity(data_symbols: np.ndarray, field: Optional[GF] = None) -> np.ndarray:
    """Five parity symbols making all R900 syndromes vanish.

    The codeword is 31 symbols: data at [0:16], parity at [26:31]
    (r900/r900.go:215-217); syndrome i evaluates the codeword at
    alpha^(29+i) via Horner (gf.go:152-172). Solves the 5x5 GF(32) system.
    """
    field = field or r900_field()
    data_symbols = np.asarray(data_symbols, dtype=np.uint8)
    assert data_symbols.size == 16

    def gf_pow(base_log_e: int, k: int) -> int:
        # alpha^(e*k) given exponent e
        return field.exp_((base_log_e * k) % field.order) if k >= 0 else 0

    a = np.zeros((5, 5), dtype=np.uint8)  # coefficients for parity unknowns
    b = np.zeros(5, dtype=np.uint8)  # data contributions (rhs)
    for i in range(5):
        e = (29 + i) % field.order
        for k in range(5):  # parity p_k at codeword position 26+k
            a[i, k] = gf_pow(e, 4 - k)
        acc = 0
        for j in range(16):
            acc ^= field.mul(int(data_symbols[j]), gf_pow(e, 30 - j))
        b[i] = acc

    # Gaussian elimination over GF(32).
    a = a.astype(np.int64)
    b = b.astype(np.int64)
    n = 5
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r, col] != 0)
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            b[[col, piv]] = b[[piv, col]]
        inv = field.inv(int(a[col, col]))
        for c in range(n):
            a[col, c] = field.mul(int(a[col, c]), inv)
        b[col] = field.mul(int(b[col]), inv)
        for r in range(n):
            if r != col and a[r, col]:
                factor = int(a[r, col])
                for c in range(n):
                    a[r, c] ^= field.mul(factor, int(a[col, c]))
                b[r] ^= field.mul(factor, int(b[col]))
    return b.astype(np.uint8)


# ---------------------------------------------------------------------------
# Packet builders (bits / chips)

BCH = CRC("BCH", 0, 0x6F63, 0)
CCITT = CRC("CCITT", 0xFFFF, 0x1021, 0x1D0F)


def make_scm_bits(
    meter_id: int,
    meter_type: int = 7,
    tamper_phy: int = 0,
    tamper_enc: int = 0,
    consumption: int = 0,
) -> np.ndarray:
    """96-bit SCM packet with valid BCH CRC (layout scm/scm.go:104-109)."""
    bits = np.zeros(96, dtype=np.uint8)
    pre = scm_proto.packet_config(8).preamble_bits
    bits[0:21] = pre
    bits[21:23] = [(meter_id >> 25) & 1, (meter_id >> 24) & 1]
    bits[24:26] = [(tamper_phy >> 1) & 1, tamper_phy & 1]
    bits[26:30] = [(meter_type >> k) & 1 for k in (3, 2, 1, 0)]
    bits[30:32] = [(tamper_enc >> 1) & 1, tamper_enc & 1]
    bits[32:56] = [(consumption >> k) & 1 for k in range(23, -1, -1)]
    bits[56:80] = [(meter_id >> k) & 1 for k in range(23, -1, -1)]
    # BCH over bytes[2:12] must be 0; bytes 10:12 are the checksum.
    data = pack_bits(bits)
    tail = solve_crc_tail(BCH, data[2:10], target=0)
    bits[80:88] = unpack_bits(np.frombuffer(tail[:1], np.uint8))
    bits[88:96] = unpack_bits(np.frombuffer(tail[1:], np.uint8))
    return bits


def make_scmplus_bits(
    endpoint_id: int,
    endpoint_type: int = 0x9C,
    consumption: int = 0,
    tamper: int = 0,
) -> np.ndarray:
    """128-bit SCM+ packet (layout scmplus/scmplus.go:95-109)."""
    b = bytearray(16)
    b[0:2] = (0x16A3).to_bytes(2, "big")  # FrameSync == preamble
    b[2] = 0x1E  # ProtocolID required by scmplus.go:84
    b[3] = endpoint_type
    b[4:8] = endpoint_id.to_bytes(4, "big")
    b[8:12] = consumption.to_bytes(4, "big")
    b[12:14] = tamper.to_bytes(2, "big")
    b[14:16] = solve_crc_tail(CCITT, b[2:14])
    return unpack_bits(np.frombuffer(bytes(b), np.uint8))


def _idm_common(serial: int, ert_type: int, packet_type: int) -> bytearray:
    b = bytearray(92)
    b[0:2] = (0x5555).to_bytes(2, "big")  # training
    b[2:4] = (0x16A3).to_bytes(2, "big")  # frame sync
    b[4] = packet_type
    b[5] = 0x5C  # packet length MSB
    b[6] = 0xC6  # hamming of length
    b[7] = 0x04  # application version
    b[8] = ert_type & 0x0F
    b[9:13] = serial.to_bytes(4, "big")
    return b


def _finish_idm(b: bytearray) -> np.ndarray:
    b[88:90] = solve_crc_tail(CCITT, b[9:13])  # serial CRC (idm.go:82-87)
    b[90:92] = solve_crc_tail(CCITT, b[4:90])  # packet CRC (idm.go:77)
    return unpack_bits(np.frombuffer(bytes(b), np.uint8))


def make_idm_bits(
    serial: int,
    ert_type: int = 7,
    consumption: int = 0,
    interval_count: int = 1,
    intervals: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """736-bit IDM packet (layout idm/idm.go:121-148)."""
    b = _idm_common(serial, ert_type, packet_type=0x1C)
    b[13] = interval_count
    b[14] = 0xA5  # module programming state
    b[29:33] = consumption.to_bytes(4, "big")
    bits = unpack_bits(np.frombuffer(bytes(b), np.uint8))
    if intervals:
        for i, v in enumerate(intervals[:47]):
            lo = 264 + 9 * i
            bits[lo : lo + 9] = [(v >> k) & 1 for k in range(8, -1, -1)]
        b = bytearray(pack_bits(bits).tobytes())
    return _finish_idm(b)


def make_r900_symbols(
    meter_id: int,
    unkn1: int = 0x1C,
    nouse: int = 0,
    backflow: int = 0,
    consumption: int = 0,
    unkn3: int = 0,
    leak: int = 0,
    leaknow: int = 0,
) -> np.ndarray:
    """42 4-ary payload symbols with valid RS parity (r900/r900.go:187-221)."""
    bits = np.zeros(80, dtype=np.uint8)

    def put(lo: int, hi: int, v: int) -> None:
        for k in range(hi - lo):
            bits[lo + k] = (v >> (hi - lo - 1 - k)) & 1

    put(0, 32, meter_id)
    put(32, 40, unkn1)
    put(40, 46, nouse)
    put(46, 48, backflow)
    put(48, 72, consumption)
    put(72, 74, unkn3)
    put(74, 78, leak)
    put(78, 80, leaknow)
    data_symbols = np.zeros(16, dtype=np.uint8)
    for i in range(16):
        v = 0
        for k in range(5):
            v = (v << 1) | int(bits[5 * i + k])
        data_symbols[i] = v
    parity = solve_r900_parity(data_symbols)
    symbols5 = np.concatenate([data_symbols, parity])
    digits = np.zeros(42, dtype=np.uint8)
    digits[0::2] = symbols5 // 6
    digits[1::2] = symbols5 % 6
    return digits


# ---------------------------------------------------------------------------
# Chip rendering

_R900_BASE = {0: (1, 1, 0, 0), 1: (1, 0, 1, 0), 2: (1, 0, 0, 1)}


def manchester_chips(bits: np.ndarray) -> np.ndarray:
    """bit 1 -> chips (1,0); bit 0 -> chips (0,1) (decode.go:229-245 sign)."""
    bits = np.asarray(bits, dtype=np.uint8)
    out = np.empty(bits.size * 2, dtype=np.uint8)
    out[0::2] = bits
    out[1::2] = 1 - bits
    return out


def r900_chips(digits: np.ndarray) -> np.ndarray:
    """Chips for an R900 packet: 32 Manchester preamble symbols followed by
    42 4-chip payload symbols. The payload starts right after the preamble:
    the decoder samples it at hit + PreambleLength - SymbolLength in its own
    quantized stream (r900/r900.go:187), whose indexing is offset by one
    SymbolLength from the shared Manchester-quantized stream, so that index
    corresponds to sample time hit_start + PreambleLength."""
    pre_bits = r900_proto.packet_config(8).preamble_bits
    chips = [manchester_chips(pre_bits)]
    for d in np.asarray(digits, dtype=np.uint8):
        base = _R900_BASE[int(d) % 3]
        if d < 3:
            base = tuple(1 - c for c in base)
        chips.append(np.array(base, dtype=np.uint8))
    return np.concatenate(chips)


@dataclass
class Burst:
    """A packet burst to embed: chip stream + sample offset."""

    chips: np.ndarray
    offset: int  # sample index of the first chip


def bits_to_burst(bits: np.ndarray, offset: int) -> Burst:
    return Burst(chips=manchester_chips(bits), offset=offset)


def r900_burst(digits: np.ndarray, offset: int) -> Burst:
    return Burst(chips=r900_chips(digits), offset=offset)
