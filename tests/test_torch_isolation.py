"""The port stands alone: importing every module of ``rtlamr_tpu_torch`` and
``chip_smoke.py`` loads neither JAX nor anything of the JAX package
``rtlamr_tpu``, and no source line of the port imports them."""

import ast
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "rtlamr_tpu_torch"

PROBE = r"""
import importlib, pkgutil, sys
import rtlamr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rtlamr_tpu_torch.__path__, "rtlamr_tpu_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its main() runs only as a script
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "rtlamr_tpu" or m.startswith("rtlamr_tpu."))
assert {"rtlamr_tpu_torch.decoder.checkpoint", "rtlamr_tpu_torch.ref.decoder",
        "rtlamr_tpu_torch.utils.modes", "rtlamr_tpu_torch.data",
        "rtlamr_tpu_torch.native", "rtlamr_tpu_torch.parallel.mesh",
        "rtlamr_tpu_torch.parallel.wideband_mesh",
        "rtlamr_tpu_torch.parallel.distributed"} <= set(names)
print(len(names), loaded)
"""


def test_import_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    ).stdout.split(None, 1)
    n_modules, loaded = int(out[0]), out[1].strip()
    assert n_modules >= 30
    assert loaded == "[]"


def test_no_source_line_imports_the_reference():
    pattern = re.compile(
        r"^\s*(import\s+(jax|rtlamr_tpu)\b(?!_torch)|from\s+(jax|rtlamr_tpu)\b(?!_torch))"
    )
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [
        f"{f.relative_to(ROOT)}:{i}"
        for f in files
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if pattern.match(line)
    ]
    assert len(files) > 30 and bad == []


def test_checkpoint_module_knows_no_decoder():
    """``decoder/checkpoint.py`` holds the file formats beneath every
    decoder, which builds and restores its own kind: it imports no
    ``parallel`` module and not ``decoder.pipeline``, and names no decoder
    class."""
    package = ["rtlamr_tpu_torch", "decoder"]
    tree = ast.parse((PORT / "decoder" / "checkpoint.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = package[: len(package) - node.level + 1] if node.level else []
            module = ".".join(base + ([node.module] if node.module else []))
            imported |= {module} | {f"{module}.{a.name}" for a in node.names}
    assert "numpy" in imported
    assert sorted(m for m in imported if m.startswith(
        ("rtlamr_tpu_torch.parallel", "rtlamr_tpu_torch.decoder.pipeline"))) == []
    decoders = {"WindowDecoder", "MeshDecoder", "WidebandDecoder", "WidebandMeshDecoder",
                "MultiHostDecoder"}
    assert sorted({n.id for n in ast.walk(tree) if isinstance(n, ast.Name)} & decoders) == []
