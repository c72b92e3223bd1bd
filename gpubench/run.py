"""Run one cell of the benchmark once:

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards. The
last line of standard output is the result, one JSON object; the numbers
the correctness check compared, each beside its limit, are the last lines
of standard error and the result's last key. With no card, too few cards,
no receiver package beside this one, a JAX module loaded, or a late
feeder, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402


def _caches() -> None:
    """Keep CUDA's kernel cache inside the checkout, at a fixed path."""
    from .catalog import ROOT

    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "gpubench" / "_cache" / "cuda"))
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    from . import catalog, harness

    try:
        cell = catalog.load_cell(args.workload)
        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    except harness.NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    except (harness.HarnessFault, harness.ForbiddenModules) as e:
        print(f"no result: {type(e).__name__}: {e}", file=sys.stderr)
        return 3
    except Exception:  # the run failed: say why, print no result
        traceback.print_exc()
        print("no result: the run failed", file=sys.stderr)
        return 1
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
