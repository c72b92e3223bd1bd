"""Host-clock spans around the program's callables, for the traced run.

A span is named by where its callable lives, ``<module>:<attr path>``, for
example ``rtlamr_tpu_torch.decoder.pipeline:WindowDecoder.feed`` or
``rtlamr_tpu_torch.decoder.pipeline:decode_window_staged_packed`` (a
function one module imported by name is wrapped in that module's
namespace). Its short name is the module's last part and the attribute
path: ``pipeline.WindowDecoder.feed``.

:class:`HostTimer` (the receiver's ``chip_smoke.py`` ``HostClock``, with
call counts and snapshots) replaces each callable with a timed call of the
same thing that also opens a ``torch.profiler.record_function`` of the
span's short name, so a profiler trace shows the host layer that launched
each kernel; ``restore()`` puts every original back. Only the traced run
installs it.
"""

from __future__ import annotations

import importlib
import time
from typing import Callable, Dict, Iterable, Optional, Tuple


def short_name(spec: str) -> str:
    module, _, path = spec.partition(":")
    return f"{module.rsplit('.', 1)[-1]}.{path}"


class HostTimer:
    """Host seconds and calls inside named callables, accumulated per span."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self._undo = []
        #: called with the span's short name at the entry of every span
        self.on_enter: Optional[Callable[[str], None]] = None

    def install(self, specs: Iterable[str]) -> None:
        for spec in dict.fromkeys(specs):
            module, _, path = spec.partition(":")
            owner = importlib.import_module(module)
            *parents, attr = path.split(".")
            for p in parents:
                owner = getattr(owner, p)
            self._wrap(owner, attr, short_name(spec))

    def _wrap(self, owner, attr: str, name: str) -> None:
        from torch.profiler import record_function

        fn = getattr(owner, attr)
        self.seconds[name] = 0.0
        self.calls[name] = 0

        def timed(*args, **kwargs):
            if self.on_enter is not None:
                self.on_enter(name)
            t = time.perf_counter()
            try:
                with record_function(name):
                    return fn(*args, **kwargs)
            finally:
                self.seconds[name] += time.perf_counter() - t
                self.calls[name] += 1

        self._undo.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, timed)

    def snapshot(self) -> Dict[str, Tuple[float, int]]:
        return {k: (self.seconds[k], self.calls[k]) for k in self.seconds}

    def restore(self) -> None:
        for owner, attr, old in reversed(self._undo):
            if old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
        self._undo.clear()


def between(a: Dict[str, Tuple[float, int]], b: Dict[str, Tuple[float, int]]) -> Dict[str, Tuple[float, int]]:
    """Seconds and calls of each span from snapshot ``a`` to snapshot ``b``."""
    return {k: (b[k][0] - a.get(k, (0.0, 0))[0], b[k][1] - a.get(k, (0.0, 0))[1]) for k in b}
