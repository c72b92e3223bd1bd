"""The window program and its packed result buffer.

A window decode is the stencil (:func:`~.stencil.decode_stencil`: the CUDA
kernel on the card) followed by the search, with every output flattened
into ONE u8 buffer so the host fetches a window's results in a single
device-to-host copy. The layout (:func:`~.spec.result_layout`) is
byte-identical to the JAX package's ``pack_results`` (int32 fields
little-endian), so the same :func:`unpack_results` reads either. On the
card the search is :func:`~.search.search_kernel`, the hand-written CUDA
kernels that write that buffer themselves; on the CPU it is
:func:`~.search.search_slice` and :func:`pack_results`.

On the card, :func:`decode_window_staged_packed` launches K1 as a kernel of
its own, then replays the search from a CUDA graph: the search is sync-free
with every shape fixed by the spec, so after K1 its launches are one pure
function of K1's three outputs. The graph is captured once for each (spec,
device, current stream), the second time that key runs (the first runs
eagerly and warms what a capture cannot do: the syndrome table's copy to
the card, the kernels' build and CUDA's lazy module loads), and replayed
for every later window: K1's outputs are copied into its static inputs and
its packed buffer is copied out. A CPU tensor runs the search eagerly.

The look-ahead (``decode_window_staged_packed(..., lookahead=True)``)
searches the next window's first blocks with the bits and R900 digits K1
has already computed for this window, in a graph of its own that the
caller enqueues once the window's buffer is on its way to the host, so the
window's messages never wait for it: :func:`lookahead_size` bytes, read by
:func:`unpack_lookahead`.

The raw-u8 window API takes one window of u8 interleaved IQ, its halo
first (``2 * (halo + window)`` bytes), as the JAX package's does:
:func:`stage_iq` stages it on its device, :func:`decode_core`,
:func:`frontend_stage` and :func:`bits_q6` decode a tensor where it lies,
:func:`decode_window`, :func:`decode_window_staged` and
:func:`decode_window_packed` take numpy or a tensor to ``device`` (``None``:
the card) first, and :func:`run_window` stages on the host and returns
NumPy results. On the card the functions that return the result dict
(:func:`decode_core_staged` and those built on it) read it from the
kernels' buffer (:func:`result_views`).

K1's library and the search's are built together on a cold start, one
``nvcc`` each at once (:func:`_stencil`): the window program loads both.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..protocols.r900 import PAYLOAD_SYMBOLS
from ..utils.observability import span
from .search import lookahead_guards, search_kernel, search_slice
from .spec import (
    FrontendSpec,
    lookahead_geometry,
    lookahead_spec,
    packed_size,
    result_layout,
    stage_host,
    staged_geometry,
)
from .stencil import decode_stencil, lookahead_mask


@functools.lru_cache(maxsize=None)
def _build_window_program() -> None:
    from .build import build_many

    with span("setup.kernel_load"):
        build_many(["decode_stencil", "search"])


def _stencil(spec: FrontendSpec, staged: torch.Tensor, first: bool):
    """K1 over a staged window; on the card the window program's two
    libraries are built (together) before the first launch."""
    if staged.device.type == "cuda":
        _build_window_program()
    return decode_stencil(spec, staged, first)


def decode_core_staged(spec: FrontendSpec, staged: torch.Tensor, first: bool):
    """Stencil + search over one staged u16 window (result dict: on the
    card, views of the kernels' packed buffer)."""
    bits, q6, mask2d = _stencil(spec, staged, first)
    if bits.device.type == "cuda":
        return result_views(spec, search_kernel(spec, bits, q6, mask2d))
    return search_slice(spec, bits, q6, mask2d)


def stage_iq(spec: FrontendSpec, iq: torch.Tensor) -> torch.Tensor:
    """u8 interleaved IQ -> staged u16 buffer, on ``iq``'s device.

    ``iq`` covers stream samples ``[window_start - halo, window_start +
    window)``; it lands at staged offset ``pad_shift``, zeros elsewhere.
    Bytes already on the host are staged with
    :func:`~rtlamr_tpu_torch.ops.spec.stage_host` instead."""
    size = staged_geometry(spec).staged_samples
    if iq.dtype != torch.uint8 or iq.numel() % 2 or spec.pad_shift + iq.numel() // 2 > size:
        raise ValueError(f"stage_iq: want an even count of at most "
                         f"{2 * (size - spec.pad_shift)} u8 bytes, got {iq.dtype} {tuple(iq.shape)}")
    u16 = iq.reshape(-1).contiguous().view(torch.uint16)
    out = torch.zeros(size, dtype=torch.int16, device=iq.device)
    out[spec.pad_shift : spec.pad_shift + u16.numel()] = u16.view(torch.int16)
    return out.view(torch.uint16)


def decode_core(spec: FrontendSpec, iq: torch.Tensor, first: bool):
    """Decode one window of u8 interleaved IQ, halo first, on its device:
    the result dict of :func:`decode_core_staged`."""
    return decode_core_staged(spec, stage_iq(spec, iq), first)


def frontend_stage(spec: FrontendSpec, iq: torch.Tensor, first: bool):
    """The stencil stage over u8 interleaved IQ: ``(bits, q6, mask2d)``."""
    return _stencil(spec, stage_iq(spec, iq), first)


def bits_q6(spec: FrontendSpec, iq: torch.Tensor, first: bool):
    """The quantized streams only: ``(bits, q6)``."""
    bits, q6, _ = frontend_stage(spec, iq, first)
    return bits, q6


def _to(x, device: DeviceLike) -> torch.Tensor:
    """A numpy array or tensor on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev)


def decode_window(spec: FrontendSpec, iq, first: bool, device: DeviceLike = None):
    """:func:`decode_core` of ``iq`` (numpy or a tensor) on ``device``."""
    return decode_core(spec, _to(iq, device), bool(first))


def decode_window_staged(spec: FrontendSpec, staged, first: bool,
                         device: DeviceLike = None):
    """:func:`decode_core_staged` of a staged u16 buffer (numpy or a
    tensor) on ``device``."""
    return decode_core_staged(spec, _to(staged, device), bool(first))


def _as_u8(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.uint8:
        return x.reshape(-1)
    assert x.dtype == torch.int32
    return x.contiguous().view(torch.uint8).reshape(-1)  # little-endian


def pack_results(res: Dict[str, object]) -> torch.Tensor:
    """Flatten a search_slice result dict into one uint8 buffer."""
    parts = [_as_u8(res["counts"])]
    parts += [_as_u8(x) for x in res["idx"]]
    parts += [_as_u8(x) for x in res["keep"]]
    parts += [_as_u8(x) for x in res["pvalid"]]
    parts += [_as_u8(x) for x in res["bytes"]]
    parts += [_as_u8(res["symbols"][g]) for g in sorted(res["symbols"])]
    return torch.cat(parts)


def result_views(spec: FrontendSpec, buf: torch.Tensor) -> Dict[str, object]:
    """The :func:`~.search.search_slice` result dict that ``buf``, its
    packed buffer, holds, as views of ``buf`` on its device: the inverse of
    :func:`pack_results`."""
    k = min(spec.slice_hits, spec.gather_hits)
    out: Dict[str, object] = {"idx": [], "keep": [], "pvalid": [], "bytes": [], "symbols": {}}
    for name, off, size in result_layout(spec)[:-1]:
        view = buf[off : off + size]
        field = name.rstrip("0123456789")
        if field == "counts":
            out["counts"] = view.view(torch.int32).reshape(len(spec.groups), 2)
        elif field == "idx":
            out["idx"].append(view.view(torch.int32))
        elif field == "bytes":
            out["bytes"].append(view.reshape(k, size // k))
        elif field == "symbols":
            out["symbols"][int(name[len(field):])] = view.reshape(k, PAYLOAD_SYMBOLS)
        else:
            out[field].append(view)
    return out


def lookahead_size(spec: FrontendSpec) -> int:
    """Bytes of the look-ahead's buffer: its search's packed buffer at
    :func:`~.spec.lookahead_spec`'s capacities, then the (G,) int32
    guards."""
    return packed_size(lookahead_spec(spec)) + 4 * len(spec.groups)


def unpack_lookahead(spec: FrontendSpec, buf: np.ndarray) -> Tuple[Dict[str, object], np.ndarray]:
    """The look-ahead's :func:`unpack_results` dict, its ``idx`` positions
    from the window's end (the next window's), and its guards."""
    buf = np.asarray(buf, np.uint8)
    la = lookahead_spec(spec)
    p = packed_size(la)
    return unpack_results(la, buf[:p]), buf[p : lookahead_size(spec)].view(np.int32)


def _search_packed(spec: FrontendSpec, bits, q6, mask2d) -> torch.Tensor:
    """The search's packed buffer: the kernels on the card, the plain
    search on the CPU."""
    if bits.device.type == "cuda":
        return search_kernel(spec, bits, q6, mask2d)
    return pack_results(search_slice(spec, bits, q6, mask2d))


def _lookahead_packed(spec: FrontendSpec, bits, q6, mask2d=None) -> torch.Tensor:
    """The look-ahead's buffer from a window's bits and R900 digits: its
    mask (:func:`~.stencil.lookahead_mask`), the search over the streams
    from the window's end on, and the guards."""
    w = spec.window
    ahead2d = lookahead_mask(spec, bits)
    la, q6 = lookahead_spec(spec), None if q6 is None else q6[w:]
    if bits.device.type == "cuda":
        return search_kernel(la, bits[w:], q6, ahead2d, lookahead_geometry(spec).fits)
    res = search_slice(la, bits[w:], q6, ahead2d)
    return torch.cat([pack_results(res), _as_u8(lookahead_guards(spec, ahead2d))])


#: the kernels' launch counters that a search graph's replays add to
_GRAPH_COUNTED = (lookahead_mask, search_kernel)


class SearchGraph:
    """A search's packed buffer (``search``: the window's, or the
    look-ahead's, which computes its own mask) captured as a CUDA graph
    over static copies of K1's outputs; :meth:`replay` runs it on new
    ones."""

    def __init__(self, spec: FrontendSpec, bits: torch.Tensor, q6: Optional[torch.Tensor],
                 mask2d: Optional[torch.Tensor], search=_search_packed):
        dev = bits.device
        self.bits = bits.clone()
        self.q6 = None if q6 is None else q6.clone()
        self.mask2d = None if mask2d is None else mask2d.clone()
        self.graph = torch.cuda.CUDAGraph()
        before = [f.launches for f in _GRAPH_COUNTED]
        # A capture stream on the inputs' card (the graph's default one
        # lies on whichever card made the first graph); "thread_local": a
        # CUDA call of another thread does not break the capture.
        with torch.cuda.device(dev), torch.cuda.graph(
                self.graph, stream=torch.cuda.Stream(dev), capture_error_mode="thread_local"):
            self.packed = search(spec, self.bits, self.q6, self.mask2d)
        #: launches of each of ``_GRAPH_COUNTED`` that a replay makes (the
        #: calls under capture ran nothing, so they are not counted)
        self.launches = [f.launches - b for f, b in zip(_GRAPH_COUNTED, before)]
        for f, b in zip(_GRAPH_COUNTED, before):
            f.launches = b

    def replay(self, bits: torch.Tensor, q6: Optional[torch.Tensor],
               mask2d: Optional[torch.Tensor]) -> torch.Tensor:
        """The packed buffer of the search over these K1 outputs: a fresh
        copy, so a result the caller holds survives the next replay. Every
        step is enqueued on the current stream of the inputs' card."""
        self.bits.copy_(bits)
        if q6 is not None:
            self.q6.copy_(q6)
        if mask2d is not None:
            self.mask2d.copy_(mask2d)
        self.graph.replay()
        for f, n in zip(_GRAPH_COUNTED, self.launches):
            f.launches += n
        return self.packed.clone()


#: (spec, device, current stream), with "lookahead" last for the
#: look-ahead's -> None once it has run eagerly, then its
#: :class:`SearchGraph` (graphs and their memory pools live as long as the
#: process)
SEARCH_GRAPHS: Dict[tuple, Optional[SearchGraph]] = {}
_graphs_lock = threading.Lock()


def _searched(spec: FrontendSpec, bits, q6, mask2d, name: str = "search",
              search=_search_packed) -> torch.Tensor:
    """``search``'s buffer over K1's outputs: eager on the CPU and the first
    time its key runs on the card, then replayed from the key's
    :class:`SearchGraph` (spans ``frontend.<name>_capture`` and
    ``frontend.<name>_replay``)."""
    if bits.device.type != "cuda":
        return search(spec, bits, q6, mask2d)
    dev = bits.device
    key = (spec, dev, torch.cuda.current_stream(dev).cuda_stream)
    if name != "search":
        key += (name,)
    # Held across the replay too: two threads on one stream would otherwise
    # interleave their copies into the static inputs.
    with _graphs_lock:
        if key not in SEARCH_GRAPHS:
            SEARCH_GRAPHS[key] = None
            return search(spec, bits, q6, mask2d)
        graph = SEARCH_GRAPHS[key]
        if graph is None:
            with span(f"frontend.{name}_capture"):
                graph = SEARCH_GRAPHS[key] = SearchGraph(spec, bits, q6, mask2d, search)
        with span(f"frontend.{name}_replay"):
            return graph.replay(bits, q6, mask2d)


def decode_window_staged_packed(spec: FrontendSpec, staged: torch.Tensor, first: bool,
                                lookahead: bool = False):
    """Staged-input window decode with all outputs in one u8 buffer (the
    hot path: the host stages raw IQ bytes into the StagedGeometry layout,
    the device starts at the stencil).

    K1 is launched (and counted) once a call; on the card the search is
    then replayed from the key's :class:`SearchGraph` (spans
    ``frontend.search_capture``, ``frontend.search_replay``), the first
    call of a key running it eagerly. The bytes are the eager path's.

    With ``lookahead`` (a spec whose :func:`~.spec.lookahead_geometry` has
    an extent) it returns the pair (buffer, ahead): ``ahead()`` enqueues
    the look-ahead's search over this window's K1 outputs (its own graph,
    key ending in "lookahead", spans ``frontend.lookahead_capture`` and
    ``frontend.lookahead_replay``) and returns its buffer. Call it once the
    window's buffer is on its way to the host."""
    bits, q6, mask2d = _stencil(spec, staged, first)
    buf = _searched(spec, bits, q6, mask2d)
    if not lookahead:
        return buf
    return buf, functools.partial(_searched, spec, bits, q6, None, "lookahead",
                                  _lookahead_packed)


def decode_window_packed(spec: FrontendSpec, iq, first: bool, device: DeviceLike = None):
    """:func:`decode_window` with every output in one u8 buffer (on the
    card, the kernels' search run eagerly)."""
    return _search_packed(spec, *frontend_stage(spec, _to(iq, device), bool(first)))


def decode_windows_scan(
    spec: FrontendSpec, staged_batch: Sequence[torch.Tensor], firsts: Sequence[bool]
) -> torch.Tensor:
    """Decode K staged windows, a (K, staged_samples) tensor or K such rows
    on one device, into one (K, P) u8 result matrix.

    The JAX package runs the K windows as one ``lax.scan`` program; here
    they are K window programs enqueued back to back on the current stream,
    each writing its row of one buffer, so the host still fetches once.
    """
    k = len(staged_batch)
    out = torch.empty((k, packed_size(spec)), dtype=torch.uint8,
                      device=staged_batch[0].device)
    for i in range(k):
        out[i] = decode_window_staged_packed(spec, staged_batch[i], bool(firsts[i]))
    return out


def unpack_results(spec: FrontendSpec, buf: np.ndarray) -> Dict[str, object]:
    """Host-side unpack of the single result buffer into the dict layout.

    Applies each group's keep mask: the returned per-group arrays hold
    exactly ``counts[g, 1]`` surviving candidates in ascending position
    order."""
    buf = np.asarray(buf, np.uint8)
    k = min(spec.slice_hits, spec.gather_hits)
    out: Dict[str, object] = {"idx": [], "pvalid": [], "bytes": [], "symbols": {}}
    keeps: List[np.ndarray] = []
    for name, off, size in result_layout(spec):
        view = buf[off : off + size]
        if name == "counts":
            out["counts"] = view.view(np.int32).reshape(len(spec.groups), 2)
        elif name.startswith("idx"):
            out["idx"].append(view.view(np.int32))
        elif name.startswith("keep"):
            keeps.append(view.astype(bool))
        elif name.startswith("pvalid"):
            out["pvalid"].append(view)
        elif name.startswith("bytes"):
            g = len(out["bytes"])
            nbytes = (spec.groups[g].packet_symbols + 7) >> 3
            out["bytes"].append(view.reshape(k, nbytes))
        elif name.startswith("symbols"):
            g = int(name[len("symbols") :])
            out["symbols"][g] = view.reshape(k, PAYLOAD_SYMBOLS)
    for g, mask in enumerate(keeps):
        out["idx"][g] = out["idx"][g][mask]
        out["pvalid"][g] = out["pvalid"][g][mask]
        out["bytes"][g] = out["bytes"][g][mask]
        if g in out["symbols"]:
            out["symbols"][g] = out["symbols"][g][mask]
    return out


def run_window(spec: FrontendSpec, iq: np.ndarray, first: bool,
               device: DeviceLike = None) -> Dict[str, object]:
    """Host wrapper: stage on the host, one transfer to ``device`` (``None``:
    the card) and one packed transfer back; NumPy results."""
    staged = torch.from_numpy(stage_host(spec, iq)).to(resolve_device(device))
    buf = decode_window_staged_packed(spec, staged, bool(first))
    return unpack_results(spec, buf.cpu().numpy())
