"""IDM — Interval Data Message (reference: idm/idm.go).

92-byte packet, 32-bit preamble ``01010101010101010001011010100011``
(16 alternating training bits + frame sync 0x16A3). Two CCITT CRC checks
(idm/idm.go:77-87): the packet CRC over bytes[4:92] and the serial-number
CRC over bytes[9:13] ++ bytes[88:90], both against residue 0x1D0F. Field
layout idm/idm.go:121-148, including 47 x 9-bit differential consumption
intervals starting at bit 264. Messages with serial number 0 are dropped.
"""

from __future__ import annotations

import functools
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

PACKET_BYTES = 92
PACKET_SYMBOLS = PACKET_BYTES * 8
PREAMBLE = "01010101010101010001011010100011"


def packet_config(chip_length: int) -> PacketConfig:
    return PacketConfig(
        protocol="idm",
        preamble=PREAMBLE,
        data_rate=32768,
        chip_length=chip_length,
        preamble_symbols=32,
        packet_symbols=PACKET_SYMBOLS,
        center_freq=912600155,
    )


@dataclass
class IDM(Message):
    Preamble: int
    PacketTypeID: int
    PacketLength: int
    HammingCode: int
    ApplicationVersion: int
    ERTType: int
    ERTSerialNumber: int
    ConsumptionIntervalCount: int
    ModuleProgrammingState: int
    TamperCounters: bytes  # 6 bytes
    AsynchronousCounters: int
    PowerOutageFlags: bytes  # 6 bytes
    LastConsumptionCount: int
    DifferentialConsumptionIntervals: tuple  # 47 x 9-bit
    TransmitTimeOffset: int
    SerialNumberCRC: int
    PacketCRC: int

    #: The Go struct is untagged (idm/idm.go:101-119), so encoding/xml
    #: marshals every field as a child element of <Message>.
    XML_STYLE = "elements"

    def msg_type(self) -> str:
        return "IDM"

    def meter_id(self) -> int:
        return self.ERTSerialNumber

    def meter_type(self) -> int:
        return self.ERTType

    def checksum(self) -> bytes:
        return self.PacketCRC.to_bytes(2, "big")

    def __str__(self) -> str:
        intervals = "[" + " ".join(
            str(v) for v in self.DifferentialConsumptionIntervals
        ) + "]"
        fields = [
            f"Preamble:0x{self.Preamble:08X}",
            f"PacketTypeID:0x{self.PacketTypeID:02X}",
            f"PacketLength:0x{self.PacketLength:02X}",
            f"HammingCode:0x{self.HammingCode:02X}",
            f"ApplicationVersion:0x{self.ApplicationVersion:02X}",
            f"ERTType:0x{self.ERTType:02X}",
            f"ERTSerialNumber:{self.ERTSerialNumber: 10d}",
            f"ConsumptionIntervalCount:{self.ConsumptionIntervalCount}",
            f"ModuleProgrammingState:0x{self.ModuleProgrammingState:02X}",
            f"TamperCounters:{self.TamperCounters.hex().upper()}",
            f"AsynchronousCounters:0x{self.AsynchronousCounters:02X}",
            f"PowerOutageFlags:{self.PowerOutageFlags.hex().upper()}",
            f"LastConsumptionCount:{self.LastConsumptionCount}",
            f"DifferentialConsumptionIntervals:{intervals}",
            f"TransmitTimeOffset:{self.TransmitTimeOffset}",
            f"SerialNumberCRC:0x{self.SerialNumberCRC:04X}",
            f"PacketCRC:0x{self.PacketCRC:04X}",
        ]
        return "{" + " ".join(fields) + "}"

    def record(self) -> List[str]:
        r = [
            f"0x{self.Preamble:08X}",
            f"0x{self.PacketTypeID:02X}",
            f"0x{self.PacketLength:02X}",
            f"0x{self.HammingCode:02X}",
            f"0x{self.ApplicationVersion:02X}",
            f"0x{self.ERTType:02X}",
            str(self.ERTSerialNumber),
            str(self.ConsumptionIntervalCount),
            f"0x{self.ModuleProgrammingState:02X}",
            self.TamperCounters.hex().upper(),
            f"0x{self.AsynchronousCounters:02X}",
            self.PowerOutageFlags.hex().upper(),
            str(self.LastConsumptionCount),
        ]
        r += [str(v) for v in self.DifferentialConsumptionIntervals]
        r += [
            str(self.TransmitTimeOffset),
            f"0x{self.SerialNumberCRC:04X}",
            f"0x{self.PacketCRC:04X}",
        ]
        return r

    def to_dict(self) -> dict:
        import base64

        # TamperCounters/PowerOutageFlags are []byte in the Go struct
        # (idm/idm.go:111,113); encoding/json marshals []byte as base64.
        return {
            "Preamble": self.Preamble,
            "PacketTypeID": self.PacketTypeID,
            "PacketLength": self.PacketLength,
            "HammingCode": self.HammingCode,
            "ApplicationVersion": self.ApplicationVersion,
            "ERTType": self.ERTType,
            "ERTSerialNumber": self.ERTSerialNumber,
            "ConsumptionIntervalCount": self.ConsumptionIntervalCount,
            "ModuleProgrammingState": self.ModuleProgrammingState,
            "TamperCounters": base64.b64encode(self.TamperCounters).decode(),
            "AsynchronousCounters": self.AsynchronousCounters,
            "PowerOutageFlags": base64.b64encode(self.PowerOutageFlags).decode(),
            "LastConsumptionCount": self.LastConsumptionCount,
            "DifferentialConsumptionIntervals": list(
                self.DifferentialConsumptionIntervals
            ),
            "TransmitTimeOffset": self.TransmitTimeOffset,
            "SerialNumberCRC": self.SerialNumberCRC,
            "PacketCRC": self.PacketCRC,
        }

    def xml_items(self) -> list:
        # encoding/xml writes []byte fields as raw character data
        # (marshalSimple), not base64 — hand the raw bytes to the encoder.
        items = super().xml_items()
        return [
            (k, self.TamperCounters if k == "TamperCounters"
             else self.PowerOutageFlags if k == "PowerOutageFlags" else v)
            for k, v in items
        ]


def parse_idm(bits: np.ndarray, data: np.ndarray) -> IDM:
    """Extract IDM fields from packet bits/bytes (idm/idm.go:121-148)."""
    from ..utils.bits import bitfields_strided

    b = bytes(np.asarray(data, dtype=np.uint8)[:PACKET_BYTES])
    intervals = tuple(int(v) for v in bitfields_strided(bits, 264, 9, 47))
    return IDM(
        Preamble=int.from_bytes(b[0:4], "big"),
        PacketTypeID=b[4],
        PacketLength=b[5],
        HammingCode=b[6],
        ApplicationVersion=b[7],
        ERTType=b[8] & 0x0F,
        ERTSerialNumber=int.from_bytes(b[9:13], "big"),
        ConsumptionIntervalCount=b[13],
        ModuleProgrammingState=b[14],
        TamperCounters=b[15:21],
        AsynchronousCounters=int.from_bytes(b[21:23], "big"),
        PowerOutageFlags=b[23:29],
        LastConsumptionCount=int.from_bytes(b[29:33], "big"),
        DifferentialConsumptionIntervals=intervals,
        TransmitTimeOffset=int.from_bytes(b[86:88], "big"),
        SerialNumberCRC=int.from_bytes(b[88:90], "big"),
        PacketCRC=int.from_bytes(b[90:92], "big"),
    )


class IDMParser(Parser):
    msg_name = "idm"

    def __init__(self, chip_length: int):
        super().__init__(packet_config(chip_length))
        self.crc = CRC("CCITT", 0xFFFF, 0x1021, 0x1D0F)

    def _extract(self, cand: Candidate, data: np.ndarray) -> Message:
        return parse_idm(cand.bit_array(PACKET_SYMBOLS), data)

    def _valid_id(self, msg: Message) -> bool:
        return msg.meter_id() != 0

    def valid_mask(self, data, syms):
        """Batched dual CCITT CRC: packet bytes[4:92] and serial-number
        bytes[9:13] ++ bytes[88:90], both == residue (idm/idm.go:77-87)."""
        pkt_ok = self.crc.checksum_batch(data[:, 4:92]) == self.crc.residue
        serial = np.concatenate([data[:, 9:13], data[:, 88:90]], axis=1)
        return pkt_ok & (self.crc.checksum_batch(serial) == self.crc.residue)

    def device_validator(self):
        from .base import CrcCheck, DeviceValidator

        return DeviceValidator(
            crcs=(
                CrcCheck(0xFFFF, 0x1021, 0x1D0F, ((4, 92),)),
                CrcCheck(0xFFFF, 0x1021, 0x1D0F, ((9, 13), (88, 90))),
            )
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
            if self.crc.checksum(data[4:92]) != self.crc.residue:
                continue
            serial_buf = np.concatenate([data[9:13], data[88:90]])
            if self.crc.checksum(serial_buf) != self.crc.residue:
                continue
            msg = self._extract(cand, data)
            if not self._valid_id(msg):
                continue
            out.append(msg)
        return out

    #: (start, width, count) of the strided interval fields (idm.go:136-141)
    _INTERVALS = (264, 9, 47)

    @staticmethod
    def _be_cols(d64: np.ndarray, a: int, b: int) -> list:
        """Big-endian int column over bytes [a:b), as a Python-int list."""
        v = d64[:, a]
        for c in range(a + 1, b):
            v = (v << 8) | d64[:, c]
        return v.tolist()

    def _build_rows(self, rows, d, intervals):
        """Per-row message construction from whole-column Python lists
        (one ``tolist()`` per field instead of per-row int conversions)."""
        be = functools.partial(self._be_cols, d.astype(np.int64))
        pre, sn = be(0, 4), be(9, 13)
        ac, lcc = be(21, 23), be(29, 33)
        tto, scrc, pcrc = be(86, 88), be(88, 90), be(90, 92)
        ptid, plen = d[:, 4].tolist(), d[:, 5].tolist()
        ham, av = d[:, 6].tolist(), d[:, 7].tolist()
        ert = (d[:, 8] & 0x0F).tolist()
        cic, mps = d[:, 13].tolist(), d[:, 14].tolist()
        tamper = d[:, 15:21].tobytes()
        outage = d[:, 23:29].tobytes()
        ivals = intervals.tolist()
        out = {}
        for j, r in enumerate(rows.tolist()):
            m = IDM(
                Preamble=pre[j],
                PacketTypeID=ptid[j],
                PacketLength=plen[j],
                HammingCode=ham[j],
                ApplicationVersion=av[j],
                ERTType=ert[j],
                ERTSerialNumber=sn[j],
                ConsumptionIntervalCount=cic[j],
                ModuleProgrammingState=mps[j],
                TamperCounters=tamper[6 * j : 6 * j + 6],
                AsynchronousCounters=ac[j],
                PowerOutageFlags=outage[6 * j : 6 * j + 6],
                LastConsumptionCount=lcc[j],
                DifferentialConsumptionIntervals=tuple(ivals[j]),
                TransmitTimeOffset=tto[j],
                SerialNumberCRC=scrc[j],
                PacketCRC=pcrc[j],
            )
            m._digest = Digest(
                "IDM", ert[j], sn[j], pcrc[j].to_bytes(2, "big")
            )
            out[r] = m
        return out

    def parse_batch(self, data, syms, valid=None):
        """Whole-window vectorized parse: batched dual CRC + batched
        interval extraction + whole-column field extraction; the only
        per-row work is the emitted dataclass (idm/idm.go:61-148)."""
        from ..utils.bits import bitfields_strided_rows

        ok = valid if valid is not None else self.valid_mask(data, None)
        # serial != 0 without unpacking: bytes[9:13] big-endian.
        serial_nz = data[:, 9:13].any(axis=1)
        rows = np.nonzero(ok & serial_nz)[0]
        if rows.size == 0:
            return {}
        d = data[rows]
        bits = np.unpackbits(d, axis=1)
        start, width, count = self._INTERVALS
        intervals = bitfields_strided_rows(bits, start, width, count)
        return self._build_rows(rows, d, intervals)


register_parser("idm", IDMParser)
