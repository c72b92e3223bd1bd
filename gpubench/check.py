"""How ``correct`` is decided: the plain reference's answers against what
the timed path produced.

Every comparison is exact (limit 0):

- the message stream: every planted packet whose bytes the CLI read in the
  window is emitted exactly as the frozen oracle (``reference/decoder.py``,
  exact-integer arithmetic) decodes it from the generated bytes, in stream
  order, and nothing else is emitted (``missing``, ``extra``,
  ``out_of_order``);
- K1's bits, q6 and hit mask for one window of the timed path, drawn from
  the seed, against ``reference/stencil.py``;
- in a wideband stream, K2's channel rows for one super-step of the timed
  path, drawn from the seed, against ``reference/channelizer.py``
  (``k2_frames_diff``), and K1's window of one channel of that super-step;
- the stream the receiver was given: the native ingest drops the newest
  bytes when its ring is full, and past a drop the receiver decodes a
  spliced stream that the reference never had; the bytes it dropped in the
  timed call (``ingest_dropped_bytes``).

The reference runs after the window, on worker processes. In a
one-channel stream each worker decodes one packet's stretch of the stream,
from two blocks before it to two blocks past the sample it is found by (a
decoder finds a packet once it holds PacketLength samples from its start),
or to the last sample sent: a packet begun before the stream's end, found
by the CLI's flush from what was sent, is known too.
In a wideband stream the workers channelize everything the receiver read
and decode every channel whole, in chunks (each decoded from a buffer's
length before it): the reference is every message the receiver may emit,
with its channel, in the receiver's order (block by block, then channel).
A packet's messages are those of its meter on every channel, its own and
any neighbour its sidelobes decode on (the receiver keeps such ghosts
unless ``-crosschanneldedup`` is set); a message of no planted meter that
the oracle decodes is due as well, when its block was due in the window.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .reference import channelizer as ref_channelizer
from .reference import stencil as ref_stencil
from .reference.decoder import ReferenceDecoder
from .reference.protocols import build_decoder_config, new_parser

#: worker processes of the reference
WORKERS = min(8, os.cpu_count() or 1)
#: blocks of the stream decoded on each side of a packet
MARGIN_BLOCKS = 2
#: blocks of a channel that one worker task of the wideband reference takes
PIECE_BLOCKS = 64


def canonical(msg_type: str, fields: dict, channel=None) -> str:
    """A message as the comparison sees it: its type, its fields and, in a
    wideband stream, its channel; not the time, Offset or Length."""
    d = {"Type": msg_type, "Message": fields}
    if channel is not None:
        d["Channel"] = channel
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


def canonical_line(line: str) -> str:
    """A JSON line of the CLI's ``-format=json`` encoder, canonical."""
    d = json.loads(line)
    return canonical(d["Type"], d["Message"], d.get("Channel"))


def decode_segment(task) -> Tuple[int, List[str]]:
    """(packet index, canonical messages of the packet's meter) of the
    oracle over one stretch of the stream's u8 IQ."""
    index, names, chip_length, meter_id, data = task
    dec = ReferenceDecoder([new_parser(x, chip_length) for x in names], arithmetic="int")
    out = [canonical(m.msg_type(), m.to_dict())
           for _, m in dec.decode_capture(data) if m.meter_id() == meter_id]
    return index, out


def k1_chunk(task):
    geo, samples, first, q0, q1 = task
    return ref_stencil.stencil_chunk(geo, samples, first, q0, q1)


def k1_reference(pool, geo, samples: np.ndarray, first: bool):
    """K1's exact outputs for one window's samples, its positions split
    over the pool: (bits, q6, mask, live words)."""
    step = -(-geo.lp // (32 * WORKERS)) * 32
    tasks = []
    for q0 in range(0, geo.lp, step):
        q1 = min(q0 + step, geo.lp)
        lo, hi = ref_stencil.chunk_samples_needed(geo, q0, q1)
        tasks.append((geo, samples[lo:hi], first, q0, q1))
    parts = list(pool.map(k1_chunk, tasks))
    live = [np.concatenate([p[3][g] for p in parts], axis=1) for g in range(len(geo.groups))]
    q6 = None if parts[0][1] is None else np.concatenate([p[1] for p in parts])
    return (np.concatenate([p[0] for p in parts]), q6,
            np.concatenate([p[2] for p in parts]), live)


def pool(*shared) -> concurrent.futures.ProcessPoolExecutor:
    """The reference's workers; each maps the ``feeder.SharedBytes`` given
    (a wideband stream, then its channels' streams), for the tasks that
    read them."""
    if not shared:
        return concurrent.futures.ProcessPoolExecutor(
            WORKERS, mp_context=multiprocessing.get_context("spawn"))
    return concurrent.futures.ProcessPoolExecutor(
        WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_map, initargs=shared)


#: the arrays of ``pool(*shared)``, in a worker
_MAPS: List[np.ndarray] = []


def _map(*shared) -> None:
    _MAPS[:] = [s.array for s in shared]


def _wide_samples(lo: int, hi: int) -> np.ndarray:
    """Samples ``[lo, hi)`` of the mapped wideband stream; zeros outside it."""
    u16 = _MAPS[0].view(np.uint16)
    out = np.zeros(hi - lo, np.uint16)
    a, b = max(lo, 0), min(hi, u16.size)
    if b > a:
        out[a - lo : b - lo] = u16[a:b]
    return out


def _channels(n: int) -> np.ndarray:
    """The mapped (n, samples) u16 channel streams."""
    return _MAPS[1].view(np.uint16).reshape(n, -1)


def channel_span(task) -> np.ndarray:
    """(n, f1 - f0) u16: the reference channelizer over frames ``[f0, f1)``
    of the mapped stream."""
    n, f0, f1, mix = task
    return ref_channelizer.channelize_span(n, _wide_samples, f0, f1, mix)


def channel_rows(pool, n: int, f0: int, f1: int, mix: str = "float32") -> np.ndarray:
    """:func:`channel_span` of frames ``[f0, f1)``, split over the pool."""
    step = -(-(f1 - f0) // WORKERS)
    parts = pool.map(channel_span, [(n, a, min(a + step, f1), mix) for a in range(f0, f1, step)])
    return np.concatenate(list(parts), axis=1)


def superstep_rows(pool, n: int, geo, step: int, mix: str = "float32") -> np.ndarray:
    """(n, halo_staged + W) u16: each channel's staged window of super-step
    ``step`` (its halo the frames before it; zeros before the stream), the
    window's frames being what K2 writes in that super-step."""
    return channel_rows(pool, n, step * geo.window - geo.halo_staged,
                        (step + 1) * geo.window, mix)


def _channelize_into(task) -> None:
    n, f0, f1 = task
    _channels(n)[:, f0:f1] = ref_channelizer.channelize_span(n, _wide_samples, f0, f1)


def decode_channel(task) -> List[Tuple[int, int, int, str]]:
    """(block, channel, meter ID, canonical message) of every message the
    oracle finds in blocks ``[lo, hi)`` of one mapped channel stream,
    decoding from ``margin`` samples before ``lo`` (a whole buffer and
    more: the oracle's state there is what it would be from the stream's
    start)."""
    lo, hi, margin, names, chip_length, block_size, n, c = task
    a = max(lo - margin, 0)
    dec = ReferenceDecoder([new_parser(x, chip_length) for x in names], arithmetic="int")
    out = []
    for b, m in dec.decode_capture(_channels(n)[c, a:hi].view(np.uint8)):
        block = a // block_size + b
        if block >= lo // block_size:
            out.append((block, c, m.meter_id(), canonical(m.msg_type(), m.to_dict(), c)))
    return out


def wideband_messages(pool, config: dict, plan, sent: int) -> List[Tuple[int, int, int, str]]:
    """(block, channel, meter ID, canonical message) of every message the
    oracle decodes from the first ``sent`` samples of every channel (what
    the receiver read), in block, then channel order. The pool maps the
    wideband stream and an (N, samples) u16 buffer of its channels: the
    stream is channelized into it in chunks of ``PIECE_BLOCKS`` blocks,
    then each (chunk, channel) is decoded."""
    n, bs = plan.channels, plan.block_size
    step = PIECE_BLOCKS * bs
    list(pool.map(_channelize_into, [(n, a, min(a + step, sent)) for a in range(0, sent, step)]))
    margin = (-(-plan.packet_length // bs) + 2) * bs
    names = tuple(config["msgtype"])
    tasks = [(a, min(a + step, sent), margin, names, plan.chip_length, bs, n, c)
             for a in range(0, sent, step) for c in range(n)]
    found = [x for part in pool.map(decode_channel, tasks) for x in part]
    found.sort(key=lambda x: x[:2])
    return found


def _names_for(config: dict, kind: str) -> tuple:
    """The parsers that decode a packet of ``kind``'s stretch: all of the
    configuration's, less R900's for another kind when that leaves the
    decoder config's sizes as they are. The R900 parser's filter bank is
    the oracle's costliest part and finds nothing in another kind's
    packet."""
    names = tuple(config["msgtype"])
    if kind == "r900" or "r900" not in names:
        return names
    fewer = tuple(x for x in names if x != "r900")
    full = build_decoder_config([new_parser(x, config["symbollength"]) for x in names])
    part = build_decoder_config([new_parser(x, config["symbollength"]) for x in fewer])
    same = (part.packet_length, part.block_size, part.buffer_length) == (
        full.packet_length, full.block_size, full.buffer_length)
    return fewer if same else names


def segment_tasks(config: dict, stream, packets, sent: int) -> list:
    """One oracle task for each planted packet of ``packets``, its stretch
    cut at ``sent``, the samples the receiver read."""
    plan = stream.plan
    bs = plan.block_size
    names_by_kind = {k: _names_for(config, k) for k in {p.kind for p in packets}}
    tasks = []
    for p in packets:
        lo = max((p.offset // bs - MARGIN_BLOCKS) * bs, 0)
        hi = min(-(-plan.found_by(p) // bs) * bs + MARGIN_BLOCKS * bs, plan.samples, sent)
        tasks.append((p.index, names_by_kind[p.kind], plan.chip_length, p.meter_id,
                      stream.bytes(lo, hi)))
    return tasks


def compare_messages(expected: Sequence[str], emitted: Sequence[str],
                     known: set, order: Optional[dict] = None) -> Dict[str, int]:
    """``expected``: the canonical messages due, in stream order; ``emitted``:
    the CLI's, in its order, of packets due or not (``known`` holds every
    planted packet's expected messages, so a message of a packet not due is
    not counted as extra). With ``order`` (message -> its (block, channel)
    in a wideband stream) the order compared is that key's: the receiver
    fixes none between the messages of one block and channel."""
    want = Counter(expected)
    due_emitted = [m for m in emitted if m in want]
    got = Counter(due_emitted)
    missing = sum(max(0, c - got[m]) for m, c in want.items())
    extra = sum(max(0, c - want[m]) for m, c in got.items())
    extra += sum(1 for m in emitted if m not in known)
    out_of_order = 0
    if missing == 0 and extra == 0:
        key = (lambda m: m) if order is None else order.__getitem__
        out_of_order = sum(key(a) != key(b) for a, b in zip(due_emitted, expected))
    return {"missing": missing, "extra": extra, "out_of_order": out_of_order}


def compare_k1(program, reference) -> Dict[str, int]:
    """Elements of bits, q6 and mask where the timed path's window differs
    from the reference's (``program`` None: the tap saw no such window)."""
    if program is None:
        return {"k1_window_missing": 1}
    bits, q6, mask, first, want_first = program
    rb, rq, rm = reference[:3]
    out = {
        "k1_bits_diff": _diff(bits, rb),
        "k1_q6_diff": _diff(q6, rq),
        "k1_mask_diff": _diff(mask, rm),
    }
    if bool(first) != bool(want_first):
        out["k1_first_flag"] = 1
    return out


def compare_k2(program, reference) -> Dict[str, int]:
    """Channel samples where K2's rows for the checked super-step differ
    from the reference's (``program`` None: the tap saw no such step)."""
    if program is None:
        return {"k2_step_missing": 1}
    rows, first, want_first = program
    out = {"k2_frames_diff": _diff(rows, reference)}
    if bool(first) != bool(want_first):
        out["k2_first_flag"] = 1
    return out


def _diff(a, b) -> int:
    if a is None or b is None:
        return 0 if a is None and b is None else 1
    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int(np.count_nonzero(a != b))
