"""Protocol descriptors, message interfaces and the parser registry.

Mirrors the reference's protocol layer (protocol/parse.go, protocol/decode.go
config handling) as pure data + host-side parsing logic:

- ``PacketConfig``   per-protocol radio configuration (decode.go:27-42).
- ``DecoderConfig``  the merged configuration derived by registering one or
  more protocols (decode.go:100-160): max-merge of DataRate/ChipLength/
  PreambleSymbols/PacketSymbols, last-writer-wins CenterFreq, and the derived
  SymbolLength/SampleRate/BlockSize/PacketLength/BufferLength values.
- ``Message``        the decoded-message interface (parse.go:78-84).
- ``Digest``         cross-block identity for dedup (parse.go:87-101).
- ``register_parser`` / ``new_parser``  the name→factory registry
  (parse.go:28-51); parser modules self-register at import time the way the
  Go packages do in their init() functions.

Parsers here are *host-side field extractors*: the device frontend (ops/)
hands them fixed-shape candidate matrices (preamble-hit indices + sliced
packet bits, plus R900 4-ary payload symbols), and they perform the
per-block dedup, checksum validation and bitfield extraction exactly as the
reference parsers do (scm/scm.go:61-91 etc.).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Configuration


@dataclass(frozen=True)
class PacketConfig:
    """Packet-specific radio configuration (protocol/decode.go:27-42)."""

    protocol: str
    preamble: str  # ASCII '0'/'1' preamble bit pattern
    data_rate: int
    chip_length: int
    preamble_symbols: int
    packet_symbols: int
    center_freq: int

    @property
    def preamble_bits(self) -> np.ndarray:
        return np.frombuffer(self.preamble.encode(), dtype=np.uint8) - ord("0")


def next_power_of_2(v: int) -> int:
    """1 << ceil(log2(v)) (protocol/decode.go:377-379)."""
    return 1 << math.ceil(math.log2(v))


@dataclass
class DecoderConfig:
    """Merged decoder configuration (protocol/decode.go:100-160).

    Built by :func:`build_decoder_config` from the registered parsers.
    """

    center_freq: int = 0
    data_rate: int = 0
    chip_length: int = 0
    preamble_symbols: int = 0
    packet_symbols: int = 0

    symbol_length: int = 0
    sample_rate: int = 0
    preamble_length: int = 0
    packet_length: int = 0
    block_size: int = 0
    block_size2: int = 0
    buffer_length: int = 0

    protocols: List[str] = field(default_factory=list)
    # preamble bit-string -> parsers sharing it, in registration order
    # (decode.go:124: IDM and NetIDM share one preamble and both parse the
    # same sliced packets).
    preamble_groups: Dict[str, List["Parser"]] = field(default_factory=dict)

    def register(self, parser: "Parser") -> None:
        cfg = parser.cfg
        self.center_freq = cfg.center_freq  # last writer wins (decode.go:105)
        self.data_rate = max(self.data_rate, cfg.data_rate)
        self.chip_length = max(self.chip_length, cfg.chip_length)
        self.preamble_symbols = max(self.preamble_symbols, cfg.preamble_symbols)
        self.packet_symbols = max(self.packet_symbols, cfg.packet_symbols)
        self.protocols.append(cfg.protocol)
        self.preamble_groups.setdefault(cfg.preamble, []).append(parser)
        parser.set_decoder(self)

    def allocate(self) -> None:
        """Derive lengths (protocol/decode.go:131-160)."""
        self.symbol_length = self.chip_length << 1
        self.sample_rate = self.data_rate * self.chip_length
        self.preamble_length = self.preamble_symbols * self.symbol_length
        self.packet_length = self.packet_symbols * self.symbol_length
        self.block_size = next_power_of_2(self.preamble_length)
        self.block_size2 = self.block_size << 1
        self.buffer_length = self.packet_length + self.block_size

    @property
    def wants_r900(self) -> bool:
        return any(p.wants_r900_symbols for ps in self.preamble_groups.values() for p in ps)

    def group_packet_symbols(self, preamble: str) -> int:
        """Symbols to slice for one preamble group.

        The reference slices the merged (max) PacketSymbols for every hit
        (decode.go:363) and each parser truncates to its own size
        (scm/scm.go:66-67); slicing only the group's max is equivalent and
        avoids gathering bits no parser in the group will read.
        """
        return max(p.cfg.packet_symbols for p in self.preamble_groups[preamble])

    def describe(self) -> str:
        lines = [
            f"CenterFreq: {self.center_freq}",
            f"SampleRate: {self.sample_rate}",
            f"DataRate: {self.data_rate}",
            f"ChipLength: {self.chip_length}",
            f"PreambleSymbols: {self.preamble_symbols}",
            f"PreambleLength: {self.preamble_length}",
            f"PacketSymbols: {self.packet_symbols}",
            f"PacketLength: {self.packet_length}",
            f"Protocols: {','.join(self.protocols)}",
            f"Preambles: {','.join(self.preamble_groups)}",
        ]
        return "\n".join(lines)


def build_decoder_config(parsers: Sequence["Parser"]) -> DecoderConfig:
    cfg = DecoderConfig()
    for p in parsers:
        cfg.register(p)
    cfg.allocate()
    return cfg


# ---------------------------------------------------------------------------
# Messages


class Message:
    """Decoded-message interface (protocol/parse.go:78-84)."""

    #: Per-field XML attribute renames from Go struct tags (e.g.
    #: ``ChecksumVal`` -> ``Checksum``, scm/scm.go:100).
    XML_RENAMES: dict = {}

    #: How Go's encoding/xml renders this struct's fields inside the
    #: ``<Message>`` child element: ``"attrs"`` when every field carries an
    #: ``xml:",attr"`` tag (scm/scm.go:94-101, scmplus/scmplus.go:95-102,
    #: r900/r900.go:250-258); ``"elements"`` when the struct is untagged so
    #: each field marshals as a child element (idm/idm.go:101-119,
    #: netidm/netidm.go:114-131).
    XML_STYLE: str = "attrs"

    def msg_type(self) -> str:
        raise NotImplementedError

    def meter_id(self) -> int:
        raise NotImplementedError

    def meter_type(self) -> int:
        raise NotImplementedError

    def checksum(self) -> bytes:
        raise NotImplementedError

    def record(self) -> List[str]:
        """CSV field list (csv/csv.go Recorder interface)."""
        raise NotImplementedError

    def to_dict(self) -> dict:
        """Ordered field mapping with Go encoding/json value semantics
        (notably ``[]byte`` fields render as base64 strings)."""
        raise NotImplementedError

    def xml_items(self) -> list:
        """Ordered (name, value) pairs for the XML encoder, struct-tag
        renames applied. Values may be int/str (simple), ``bytes`` (Go
        writes []byte as raw character data, marshalSimple in
        encoding/xml), or tuple (Go repeats the element per entry).
        Default: the JSON mapping, which matches whenever the struct has
        no []byte fields."""
        return [
            (self.XML_RENAMES.get(k, k), v) for k, v in self.to_dict().items()
        ]


class Digest(NamedTuple):
    """Uniquely identifies a message spanning two sample blocks
    (protocol/parse.go:87-101)."""

    msg_type: str
    meter_type: int
    meter_id: int
    checksum: bytes


def digest(msg: Message) -> Digest:
    """Digest of a message (protocol/parse.go:87-101). parse_batch
    implementations precompute and attach ``_digest`` from their
    whole-column field arrays — the method-call formulation below is the
    fallback for scalar-path messages."""
    d = getattr(msg, "_digest", None)
    if d is not None:
        return d
    return Digest(msg.msg_type(), msg.meter_type(), msg.meter_id(), msg.checksum())


# ---------------------------------------------------------------------------
# Device-side validity descriptors

from dataclasses import dataclass as _frozen_dataclass  # noqa: E402


@_frozen_dataclass(frozen=True)
class CrcCheck:
    """One CRC-16 gate over a concatenation of packed-byte ranges.

    Static data baked into the jitted window program (ops/frontend): the
    candidate passes when the MSB-first table CRC (crc/crc.go:49-55) of
    ``bytes[a0:b0] ++ bytes[a1:b1] ++ ...`` equals ``residue``.
    """

    init: int
    poly: int
    residue: int
    ranges: Tuple[Tuple[int, int], ...]


@_frozen_dataclass(frozen=True)
class DeviceValidator:
    """A parser's candidate-validity predicate, evaluable on device.

    ``crcs`` must ALL pass; ``rs`` additionally requires the R900 base-6
    digit range check + all-zero GF(32) Reed-Solomon syndromes
    (r900/r900.go:199-221). Must accept a SUPERSET of what the parser's
    :meth:`Parser.parse` turns into messages (same contract as
    :meth:`Parser.valid_mask`, which remains the host-side mirror).
    """

    crcs: Tuple[CrcCheck, ...] = ()
    rs: bool = False


# ---------------------------------------------------------------------------
# Candidates and parsers


@dataclass
class Candidate:
    """One preamble hit handed from the frontend to host parsers.

    ``idx`` is the hit position within the block's search window — the same
    quantity as Go's Data.Idx (decode.go:370). The sliced packet symbols are
    carried as either a 0/1 bit array (``bits``, oracle path) or MSB-first
    packed bytes (``packed``, device path — the frontend packs on device);
    each representation is derived lazily from the other. ``r900_symbols``
    carries the 42 4-ary payload symbols for the R900 group
    (r900/r900.go:187-193), pre-gathered since the device owns the 6-ary
    quantized stream.
    """

    idx: int
    bits: Optional[np.ndarray] = None
    packed: Optional[np.ndarray] = None
    r900_symbols: Optional[np.ndarray] = None

    def packed_bytes(self, n_symbols: int) -> np.ndarray:
        nbytes = (n_symbols + 7) >> 3
        if self.packed is not None:
            return self.packed[:nbytes]
        from ..utils.bits import pack_bits

        padded = np.zeros(nbytes * 8, np.uint8)
        n = min(len(self.bits), nbytes * 8)
        padded[:n] = self.bits[:n]
        return pack_bits(padded)

    def bit_array(self, n_symbols: int) -> np.ndarray:
        if self.bits is not None:
            return self.bits[:n_symbols]
        return np.unpackbits(self.packed)[:n_symbols]


class Parser:
    """Host-side protocol parser (protocol/parse.go:72-76)."""

    def __init__(self, cfg: PacketConfig):
        self.cfg = cfg
        self.decoder: Optional[DecoderConfig] = None

    #: True when the frontend must produce R900 4-ary payload symbols.
    wants_r900_symbols: bool = False

    def set_decoder(self, d: DecoderConfig) -> None:
        self.decoder = d

    def parse(self, candidates: Sequence[Candidate]) -> List[Message]:
        """Parse one block's candidates into messages.

        Called once per sample block; implementations replicate the per-call
        ``seen`` dedup of the reference parsers.
        """
        raise NotImplementedError

    def parse_batch(
        self,
        data: np.ndarray,
        syms: Optional[np.ndarray],
        valid: Optional[np.ndarray] = None,
    ) -> Dict[int, "Message"]:
        """Vectorized whole-window parse: ``{row: Message}`` for every row
        of the (N, nbytes) candidate matrix that yields a message.

        Semantics are exactly :meth:`parse` minus the per-call ``seen``
        dedup (the caller collapses exact duplicates per block first, see
        decoder/pipeline._parse_window). The concrete parsers override this
        with matrix-op implementations — batched CRC/RS + batched bitfield
        extraction — so Python-object work happens only for rows that
        become messages. ``valid``, when given, is this parser's
        already-computed :meth:`valid_mask` over the same rows (the
        pipeline computes it for the group pre-filter; passing it in
        avoids recomputing the batched CRC/RS). This base fallback
        delegates to :meth:`parse` per row for parsers without a
        vectorized path.
        """
        out: Dict[int, Message] = {}
        for r in range(data.shape[0]):
            if valid is not None and not valid[r]:
                continue
            cand = Candidate(
                idx=0,
                packed=data[r],
                r900_symbols=syms[r] if syms is not None else None,
            )
            msgs = self.parse([cand])
            if msgs:
                out[r] = msgs[0]
        return out

    def valid_mask(
        self, data: np.ndarray, syms: Optional[np.ndarray]
    ) -> np.ndarray:
        """Vectorized candidate validity over a whole window.

        ``data`` is the (N, nbytes) packed-packet matrix, ``syms`` the
        (N, 42) R900 payload-symbol matrix (or None). Returns an (N,) bool
        mask that must be a SUPERSET of the candidates :meth:`parse` would
        turn into messages — the pipeline uses it to drop checksum-failing
        candidates in one batched pass (crc/crc.go:49-55, r900/r900.go:215)
        before any per-candidate Python work; :meth:`parse` remains the
        semantic authority on the survivors.
        """
        return np.ones(data.shape[0], dtype=bool)

    def device_validator(self) -> Optional[DeviceValidator]:
        """Static descriptor of :meth:`valid_mask` for the device program.

        When every parser of a preamble group provides one, the jitted
        window program drops checksum-failing candidates BEFORE result
        compaction (SURVEY §2 C9/C10 build targets), so only valid
        candidates occupy the max_hits output slots. None (the default)
        disables device-side filtering for the group.
        """
        return None


# ---------------------------------------------------------------------------
# Registry (protocol/parse.go:16-51)

_REGISTRY: Dict[str, Callable[[int], Parser]] = {}


def register_parser(name: str, factory: Callable[[int], Parser]) -> None:
    if factory is None:
        raise ValueError("parser: new parser func is nil")
    if name in _REGISTRY:
        raise ValueError(f"parser: parser already registered ({name})")
    _REGISTRY[name] = factory


def new_parser(name: str, chip_length: int) -> Parser:
    if name not in _REGISTRY:
        raise ValueError(f"invalid message type: {name!r}")
    return _REGISTRY[name](chip_length)


def registered_protocols() -> List[str]:
    return sorted(_REGISTRY)
