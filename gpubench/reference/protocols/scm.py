"""SCM — Standard Consumption Message (reference: scm/scm.go).

96-symbol packet, 21-bit preamble ``111110010101001100000``, BCH CRC-16
(init 0, poly 0x6F63) over bytes[2:12] must be zero (scm/scm.go:41,76).
Field layout (scm/scm.go:104-109): ID = bits[21:23] ++ bits[56:80] (26 bits),
Type = bits[26:30], TamperPhy = bits[24:26], TamperEnc = bits[30:32],
Consumption = bits[32:56], Checksum = bits[80:96]. Messages with ID == 0 are
dropped (scm/scm.go:83).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..utils.bits import bitfield
from ..utils.crc import CRC
from .base import (
    Candidate,
    Digest,
    Message,
    PacketConfig,
    Parser,
    register_parser,
)

PACKET_SYMBOLS = 96
PACKET_BYTES = PACKET_SYMBOLS >> 3


def packet_config(chip_length: int) -> PacketConfig:
    return PacketConfig(
        protocol="scm",
        preamble="111110010101001100000",
        data_rate=32768,
        chip_length=chip_length,
        preamble_symbols=21,
        packet_symbols=PACKET_SYMBOLS,
        center_freq=912600155,
    )


@dataclass
class SCM(Message):
    ID: int
    Type: int
    TamperPhy: int
    TamperEnc: int
    Consumption: int
    ChecksumVal: int

    #: xml:"Checksum,attr" (scm/scm.go:100); JSON keeps ChecksumVal.
    XML_RENAMES = {"ChecksumVal": "Checksum"}

    def msg_type(self) -> str:
        return "SCM"

    def meter_id(self) -> int:
        return self.ID

    def meter_type(self) -> int:
        return self.Type

    def checksum(self) -> bytes:
        return self.ChecksumVal.to_bytes(2, "big")

    def __str__(self) -> str:
        return (
            f"{{ID:{self.ID:8d} Type:{self.Type:2d} "
            f"Tamper:{{Phy:{self.TamperPhy:02X} Enc:{self.TamperEnc:02X}}} "
            f"Consumption:{self.Consumption:8d} CRC:0x{self.ChecksumVal:04X}}}"
        )

    def record(self) -> List[str]:
        return [
            str(self.ID),
            str(self.Type),
            f"0x{self.TamperPhy:x}",
            f"0x{self.TamperEnc:x}",
            str(self.Consumption),
            f"0x{self.ChecksumVal:x}",
        ]

    def to_dict(self) -> dict:
        return {
            "ID": self.ID,
            "Type": self.Type,
            "TamperPhy": self.TamperPhy,
            "TamperEnc": self.TamperEnc,
            "Consumption": self.Consumption,
            "ChecksumVal": self.ChecksumVal,
        }


def parse_scm(bits: np.ndarray) -> SCM:
    """Extract fields from a 96-bit packet (scm/scm.go:103-118)."""
    ert_id = (bitfield(bits, 21, 23) << 24) | bitfield(bits, 56, 80)
    return SCM(
        ID=ert_id,
        Type=bitfield(bits, 26, 30),
        TamperPhy=bitfield(bits, 24, 26),
        TamperEnc=bitfield(bits, 30, 32),
        Consumption=bitfield(bits, 32, 56),
        ChecksumVal=bitfield(bits, 80, 96),
    )


class SCMParser(Parser):
    def __init__(self, chip_length: int):
        super().__init__(packet_config(chip_length))
        self.crc = CRC("BCH", 0, 0x6F63, 0)

    def valid_mask(self, data, syms):
        """Batched BCH CRC over bytes[2:12] == 0 (scm/scm.go:76)."""
        return self.crc.checksum_batch(data[:, 2:12]) == 0

    def device_validator(self):
        from .base import CrcCheck, DeviceValidator

        return DeviceValidator(crcs=(CrcCheck(0, 0x6F63, 0, ((2, 12),)),))

    def parse(self, candidates: Sequence[Candidate]) -> List[Message]:
        out: List[Message] = []
        seen = set()
        for cand in candidates:
            data = cand.packed_bytes(PACKET_SYMBOLS)
            key = data.tobytes()
            if key in seen:
                continue
            seen.add(key)
            if self.crc.checksum(data[2:12]) != 0:
                continue
            msg = parse_scm(cand.bit_array(PACKET_SYMBOLS))
            if msg.ID == 0:
                continue
            out.append(msg)
        return out

    def parse_batch(self, data, syms, valid=None):
        """Whole-window vectorized parse: batched CRC, batched bitfields,
        dataclasses only for emitted rows (scm/scm.go:61-118)."""
        from ..utils.bits import bitfield_rows as f

        ok = valid if valid is not None else (
            self.crc.checksum_batch(data[:, 2:12]) == 0
        )
        rows = np.nonzero(ok)[0]
        if rows.size == 0:
            return {}
        bits = np.unpackbits(data[rows], axis=1)
        ert_id = (f(bits, 21, 23) << np.uint64(24)) | f(bits, 56, 80)
        typ = f(bits, 26, 30)
        t_phy = f(bits, 24, 26)
        t_enc = f(bits, 30, 32)
        cons = f(bits, 32, 56)
        cksum = f(bits, 80, 96)
        ids, typl = ert_id.tolist(), typ.tolist()
        phyl, encl = t_phy.tolist(), t_enc.tolist()
        consl, ckl = cons.tolist(), cksum.tolist()
        rl = rows.tolist()
        out = {}
        for j in np.nonzero(ert_id != 0)[0].tolist():
            m = SCM(
                ID=ids[j],
                Type=typl[j],
                TamperPhy=phyl[j],
                TamperEnc=encl[j],
                Consumption=consl[j],
                ChecksumVal=ckl[j],
            )
            m._digest = Digest(
                "SCM", typl[j], ids[j], ckl[j].to_bytes(2, "big")
            )
            out[rl[j]] = m
        return out


register_parser("scm", SCMParser)
