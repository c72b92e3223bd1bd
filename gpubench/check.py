"""How ``correct`` is decided: the plain reference's answers against what
the timed path produced.

Two comparisons, each exact (limit 0):

- the message stream: every planted packet whose bytes the CLI read in the
  window is emitted exactly as the frozen oracle (``reference/decoder.py``,
  exact-integer arithmetic) decodes it from the generated bytes, in stream
  order, and nothing else is emitted (``missing``, ``extra``,
  ``out_of_order``);
- K1's bits, q6 and hit mask for one window of the timed path, drawn from
  the seed, against ``reference/stencil.py``.

The reference runs after the window, on worker processes; each worker
decodes one packet's stretch of the stream, from two blocks before it to
two blocks past the sample it is found by (a decoder finds a packet once it
holds PacketLength samples from its start).
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .reference import stencil as ref_stencil
from .reference.decoder import ReferenceDecoder
from .reference.protocols import build_decoder_config, new_parser

#: worker processes of the reference
WORKERS = min(8, os.cpu_count() or 1)
#: blocks of the stream decoded on each side of a packet
MARGIN_BLOCKS = 2


def canonical(msg_type: str, fields: dict) -> str:
    """A message as the comparison sees it: its type and its fields; not
    the time, Offset or Length."""
    d = {"Type": msg_type, "Message": fields}
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


def canonical_line(line: str) -> str:
    """A JSON line of the CLI's ``-format=json`` encoder, canonical."""
    d = json.loads(line)
    return canonical(d["Type"], d["Message"])


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


def pool() -> concurrent.futures.ProcessPoolExecutor:
    return concurrent.futures.ProcessPoolExecutor(
        WORKERS, mp_context=multiprocessing.get_context("spawn"))


def _names_for(config: dict, kind: str) -> tuple:
    """The parsers that decode a packet of ``kind``'s stretch: all of the
    configuration's, less R900's for another kind when that leaves the
    decoder config's sizes as they are. The R900 parser's filter bank is
    the oracle's costliest part (a filter over its whole buffer every
    block) and finds nothing in another kind's packet."""
    names = tuple(config["msgtype"])
    if kind == "r900" or "r900" not in names:
        return names
    fewer = tuple(x for x in names if x != "r900")
    full = build_decoder_config([new_parser(x, config["symbollength"]) for x in names])
    part = build_decoder_config([new_parser(x, config["symbollength"]) for x in fewer])
    same = (part.packet_length, part.block_size, part.buffer_length) == (
        full.packet_length, full.block_size, full.buffer_length)
    return fewer if same else names


def segment_tasks(config: dict, stream, packets) -> list:
    """One oracle task for each planted packet of ``packets``."""
    plan = stream.plan
    bs = plan.block_size
    names_by_kind = {k: _names_for(config, k) for k in {p.kind for p in packets}}
    tasks = []
    for p in packets:
        lo = max((p.offset // bs - MARGIN_BLOCKS) * bs, 0)
        hi = min(-(-plan.found_by(p) // bs) * bs + MARGIN_BLOCKS * bs, plan.samples)
        tasks.append((p.index, names_by_kind[p.kind], plan.chip_length, p.meter_id,
                      stream.bytes(lo, hi)))
    return tasks


def compare_messages(expected: Sequence[str], emitted: Sequence[str],
                     known: set) -> Dict[str, int]:
    """``expected``: the canonical messages due, in stream order; ``emitted``:
    the CLI's, in its order, of packets due or not (``known`` holds every
    planted packet's expected messages, so a message of a packet not due is
    not counted as extra)."""
    want = Counter(expected)
    due_emitted = [m for m in emitted if m in want]
    got = Counter(due_emitted)
    missing = sum(max(0, c - got[m]) for m, c in want.items())
    extra = sum(max(0, c - want[m]) for m, c in got.items())
    extra += sum(1 for m in emitted if m not in known)
    out_of_order = 0
    if missing == 0 and extra == 0:
        out_of_order = sum(a != b for a, b in zip(due_emitted, expected))
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


def _diff(a, b) -> int:
    if a is None or b is None:
        return 0 if a is None and b is None else 1
    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int(np.count_nonzero(a != b))
