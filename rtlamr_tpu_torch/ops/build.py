"""Build the port's CUDA sources into plain-C shared libraries.

Each :class:`Library` is compiled from ``csrc/<source>.cu`` on first use
with ``nvcc`` for ``sm_90a`` into ``rtlamr_tpu_torch/_build/<name>-<hash>.so``,
keyed by a hash of the source, the flags and the header, and loaded with
``ctypes``. A library may add ``-D`` flags (one source built for several
shapes) and a header that its caller generates, written at build time into
``_build/gen-<hash>/`` on the include path. Only the sources in the package
are used. A failed build raises; there is no fallback. :func:`build_many`
starts one ``nvcc`` per library at once, so adding kernels does not lengthen
a cold start by their sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

from ..utils.observability import span

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class Library(NamedTuple):
    """A library built from ``csrc/<source>.cu``, named ``<source>`` or
    ``<source>.<variant>``, with extra ``nvcc`` flags and a generated header
    (file name, text)."""

    name: str
    flags: Tuple[str, ...] = ()
    header: Optional[Tuple[str, str]] = None

    @property
    def source(self) -> str:
        return self.name.partition(".")[0]


#: name -> {"seconds": build seconds (0.0 when cached), "log": nvcc output,
#: kept beside the library so a cached build still reports it}
BUILD_LOG: Dict[str, Dict[str, object]] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(lib: Library) -> pathlib.Path:
    src = (CSRC_DIR / f"{lib.source}.cu").read_bytes()
    header = "\0".join(lib.header or ())
    key = hashlib.sha256(
        src + " ".join(NVCC_FLAGS + lib.flags).encode() + header.encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{lib.name}-{key}.so"


def _include_flags(lib: Library) -> List[str]:
    """Write ``lib``'s header into a directory named by its hash; the -I
    flag of that directory."""
    if lib.header is None:
        return []
    file_name, text = lib.header
    inc = BUILD_DIR / f"gen-{hashlib.sha256(text.encode()).hexdigest()[:16]}"
    inc.mkdir(parents=True, exist_ok=True)
    tmp = inc / f"{file_name}.{os.getpid()}.tmp"
    tmp.write_text(text)
    os.replace(tmp, inc / file_name)
    return ["-I", str(inc)]


def build_many(libs: Sequence[Union[str, Library]]) -> Dict[str, pathlib.Path]:
    """Build every library that is not built yet (a name stands for the
    library of that source alone), all ``nvcc`` runs in parallel. Returns
    name -> library path; raises on the first failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, pathlib.Path] = {}
    running: List[tuple] = []
    for lib in libs:
        lib = Library(lib) if isinstance(lib, str) else lib
        name, target = lib.name, _target(lib)
        out[name] = target
        if target.exists():
            log = target.with_suffix(".log")
            BUILD_LOG.setdefault(
                name,
                {"seconds": 0.0, "log": log.read_text() if log.exists() else ""},
            )
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *lib.flags, *_include_flags(lib), "-o", str(tmp),
               str(CSRC_DIR / f"{lib.source}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, target, tmp, proc, time.perf_counter()))
    errors = []
    for name, target, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
            continue
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(lib: Union[str, Library]) -> ctypes.CDLL:
    """The loaded library (a name stands for the library of that source
    alone), built at first use (the span ``setup.kernel_load``)."""
    name = lib if isinstance(lib, str) else lib.name
    loaded = _LIBS.get(name)
    if loaded is None:
        with span("setup.kernel_load"):
            loaded = ctypes.CDLL(str(build_many([lib])[name]))
        _LIBS[name] = loaded
    return loaded
