"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the receiver either (top-level module names,
compared whole)."""

import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "rtlamr_tpu"}


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint('\\n'.join(sys.modules))"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300, check=True)
    return {m.split(".")[0] for m in out.stdout.split()}


def test_reference_imports_nothing_of_the_receiver():
    tops = _modules("import gpubench.reference.decoder, gpubench.reference.stencil, "
                    "gpubench.reference.packets, gpubench.reference.channelizer, "
                    "gpubench.check, gpubench.yardstick")
    assert not tops & (FORBIDDEN | {"rtlamr_tpu_torch", "torch"})


@pytest.mark.parametrize("cell", ["tiny('nb_all.live16')", "wide_tiny('parallel')"])
def test_a_run_loads_no_jax(cell):
    """A dry run of the harness's module graph on the CPU: a tiny cell
    through the CLI, then what ``sys.modules`` holds."""
    code = (
        "import sys, time\n"
        "sys.path.insert(0, 'gpubench/tests')\n"
        "from conftest import tiny, wide_tiny\n"
        "from gpubench import harness\n"
        f"cell = {cell}\n"
        "res = harness.run_cell(cell, 5, 1.0, False, time.monotonic(), device='cpu', log=lambda *a: None)\n"
        "assert res['correct'], res\n"
    )
    tops = _modules(code)
    assert "rtlamr_tpu_torch" in tops
    assert not tops & FORBIDDEN
