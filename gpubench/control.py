"""The control of the correctness check: the plain reference put in the
program's place and computed in the precision below the one that the
configuration states, over the window a run of that seed checks: K1's
function with float32 prefix sums, where the configuration states exact
integer arithmetic; in a wideband stream also K2's with its DFT mix in
bfloat16, where the configuration states float32, over the super-step a
run of that seed checks. The comparison that decides ``correct`` has to
reject it.

Each seed prints one JSON line with the numbers the run would compare and
their limits; ``correct`` must come out false on every seed. Run it at the
cell's own size on the machine the cells run on:

    python3 -m gpubench.control --workload nb_all.live16 --seeds 1,2,3

The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import catalog, check
from .harness import draw
from .reference import stencil as ref_stencil
from .traffic.feeder import SharedBytes
from .traffic.plan import Stream, decoder_config, make_plan, render, window_blocks


def control_numbers(cell: catalog.Cell, seed: int, seconds: float = 20.0) -> dict:
    """The compared numbers of the control, at the cell's own size."""
    config, traffic = cell.config, cell.traffic
    plan = make_plan(config, traffic, seed, seconds)
    index = draw(seed, *traffic["check_windows"], tag=5)
    geo = ref_stencil.window_geometry(decoder_config(config), window_blocks(traffic))
    first = index == 0
    n = plan.channels
    if n == 1:
        stream = Stream(plan, render(config, plan))
        samples = ref_stencil.window_samples(geo, stream.samples_u16, index)
        with check.pool() as pool:
            exact = check.k1_reference(pool, geo, samples, first)
        numbers = {}
    else:
        channel = draw(seed, 0, n - 1, tag=6)
        shared = SharedBytes(plan.stream_bytes)
        render(config, plan, shared.array)
        with check.pool(shared) as pool:
            rows = check.superstep_rows(pool, n, geo, index)
            low = check.superstep_rows(pool, n, geo, index, mix="bfloat16")
            samples = rows[channel]
            exact = check.k1_reference(pool, geo, samples, first)
        hs = geo.halo_staged
        numbers = check.compare_k2((low[:, hs:], first, first), rows[:, hs:])
    bits, q6, mask = ref_stencil.stencil(geo, samples, first, "float32")
    numbers.update(check.compare_k1((bits, q6, mask, first, first), exact))
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    cell = catalog.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control_numbers(cell, seed)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": all(v <= 0 for v in numbers.values()),
                          "checks": {k: {"value": v, "limit": 0} for k, v in numbers.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
