"""SCM+ — Standard Consumption Message Plus (reference: scmplus/scmplus.go).

16-byte packet, 16-bit preamble ``0001011010100011``; CCITT CRC-16
(init 0xFFFF, poly 0x1021) over bytes[2:] must equal the residue 0x1D0F
(scmplus/scmplus.go:48,77). Fields are a big-endian struct
(scmplus/scmplus.go:95-109): FrameSync u16, ProtocolID u8, EndpointType u8,
EndpointID u32, Consumption u32, Tamper u16, PacketCRC u16. Messages require
EndpointID != 0 and ProtocolID == 0x1E (scmplus/scmplus.go:84).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..utils.crc import CRC
from .base import (
    Candidate,
    Digest,
    Message,
    PacketConfig,
    Parser,
    register_parser,
)

PACKET_BYTES = 16
PACKET_SYMBOLS = PACKET_BYTES * 8


def packet_config(chip_length: int) -> PacketConfig:
    return PacketConfig(
        protocol="scm+",
        preamble="0001011010100011",
        data_rate=32768,
        chip_length=chip_length,
        preamble_symbols=16,
        packet_symbols=PACKET_SYMBOLS,
        center_freq=912600155,
    )


@dataclass
class SCMPlus(Message):
    FrameSync: int
    ProtocolID: int
    EndpointType: int
    EndpointID: int
    Consumption: int
    Tamper: int
    PacketCRC: int

    #: xml:"Checksum,attr" (scmplus/scmplus.go:102); the json tag there is
    #: malformed Go struct-tag syntax, so JSON keeps PacketCRC.
    XML_RENAMES = {"PacketCRC": "Checksum"}

    def msg_type(self) -> str:
        return "SCM+"

    def meter_id(self) -> int:
        return self.EndpointID

    def meter_type(self) -> int:
        return self.EndpointType

    def checksum(self) -> bytes:
        return self.PacketCRC.to_bytes(2, "big")

    def __str__(self) -> str:
        return (
            f"{{ProtocolID:0x{self.ProtocolID:02X} "
            f"EndpointType:0x{self.EndpointType:02X} "
            f"EndpointID:{self.EndpointID:10d} "
            f"Consumption:{self.Consumption:10d} "
            f"Tamper:0x{self.Tamper:04X} PacketCRC:0x{self.PacketCRC:04X}}}"
        )

    def record(self) -> List[str]:
        return [
            f"0x{self.FrameSync:x}",
            f"0x{self.ProtocolID:x}",
            f"0x{self.EndpointType:x}",
            str(self.EndpointID),
            str(self.Consumption),
            f"0x{self.Tamper:x}",
            f"0x{self.PacketCRC:x}",
        ]

    def to_dict(self) -> dict:
        return {
            "FrameSync": self.FrameSync,
            "ProtocolID": self.ProtocolID,
            "EndpointType": self.EndpointType,
            "EndpointID": self.EndpointID,
            "Consumption": self.Consumption,
            "Tamper": self.Tamper,
            "PacketCRC": self.PacketCRC,
        }


def parse_scmplus(data: np.ndarray) -> SCMPlus:
    """Big-endian struct read of a 16-byte packet (scmplus/scmplus.go:105-109)."""
    b = bytes(np.asarray(data, dtype=np.uint8)[:PACKET_BYTES])
    return SCMPlus(
        FrameSync=int.from_bytes(b[0:2], "big"),
        ProtocolID=b[2],
        EndpointType=b[3],
        EndpointID=int.from_bytes(b[4:8], "big"),
        Consumption=int.from_bytes(b[8:12], "big"),
        Tamper=int.from_bytes(b[12:14], "big"),
        PacketCRC=int.from_bytes(b[14:16], "big"),
    )


class SCMPlusParser(Parser):
    def __init__(self, chip_length: int):
        super().__init__(packet_config(chip_length))
        self.crc = CRC("CCITT", 0xFFFF, 0x1021, 0x1D0F)

    def valid_mask(self, data, syms):
        """Batched CCITT CRC over bytes[2:] == residue (scmplus.go:77)."""
        return self.crc.checksum_batch(data[:, 2:16]) == self.crc.residue

    def device_validator(self):
        from .base import CrcCheck, DeviceValidator

        return DeviceValidator(
            crcs=(CrcCheck(0xFFFF, 0x1021, 0x1D0F, ((2, 16),)),)
        )

    def parse(self, candidates: Sequence[Candidate]) -> List[Message]:
        out: List[Message] = []
        seen = set()
        for cand in candidates:
            data = cand.packed_bytes(PACKET_SYMBOLS)
            key = data.tobytes()
            if key in seen:
                continue
            seen.add(key)
            if self.crc.checksum(data[2:]) != self.crc.residue:
                continue
            msg = parse_scmplus(data)
            if msg.EndpointID == 0 or msg.ProtocolID != 0x1E:
                continue
            out.append(msg)
        return out

    def parse_batch(self, data, syms, valid=None):
        """Whole-window vectorized parse: batched CRC, big-endian struct
        fields as column arithmetic (scmplus.go:62-109)."""
        import numpy as np

        ok = valid if valid is not None else (
            self.crc.checksum_batch(data[:, 2:16]) == self.crc.residue
        )
        rows = np.nonzero(ok)[0]
        if rows.size == 0:
            return {}
        d = data[rows].astype(np.uint64)

        def be(lo, hi):
            v = d[:, lo]
            for c in range(lo + 1, hi):
                v = (v << np.uint64(8)) | d[:, c]
            return v

        endpoint_id = be(4, 8)
        keep = (endpoint_id != 0) & (d[:, 2] == 0x1E)
        frame_sync, cons = be(0, 2), be(8, 12)
        tamper, crc_v = be(12, 14), be(14, 16)
        fsl, eidl, consl = frame_sync.tolist(), endpoint_id.tolist(), cons.tolist()
        taml, crcl = tamper.tolist(), crc_v.tolist()
        pidl, etl = d[:, 2].tolist(), d[:, 3].tolist()
        rl = rows.tolist()
        out = {}
        for j in np.nonzero(keep)[0].tolist():
            m = SCMPlus(
                FrameSync=fsl[j],
                ProtocolID=pidl[j],
                EndpointType=etl[j],
                EndpointID=eidl[j],
                Consumption=consl[j],
                Tamper=taml[j],
                PacketCRC=crcl[j],
            )
            m._digest = Digest(
                "SCM+", etl[j], eidl[j], crcl[j].to_bytes(2, "big")
            )
            out[rl[j]] = m
        return out


register_parser("scm+", SCMPlusParser)
