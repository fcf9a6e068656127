"""The correctness control of a cell: the plain reference, computed in the
precision below the configuration's (TF32 for float32 with TF32 off), put
in the program's place and judged by the cell's own check, as a run judges
the program. It has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--precisions tf32,fp32] [--device cpu]

Prints one JSON line a seed and precision: {"seed", "precision",
"correct", "checks": {name: {"value", "limit"}}}. ``fp32`` (the reference
in complex64, no rounding) is the witness of what float32 alone reads;
``fp64`` reads the reference against itself. The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def judged(cell, seed: int, device, prec) -> dict:
    """The control's state for ``seed`` in ``prec``, judged by the cell's
    check: {"correct", "checks"}."""
    from benchmark.core import harness
    checks = cell.kind().check(cell.kind().control(cell, seed, device,
                                                   prec))
    return dict(correct=harness.judge(checks),
                checks={n: dict(value=float(v), limit=float(lim))
                        for n, v, lim in checks})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--precisions", default="tf32")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from benchmark.core import cells
    from benchmark.reference.precision import Precision

    cell = cells.find(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for name in args.precisions.split(","):
            t = time.perf_counter()
            out = judged(cell, seed, torch.device(args.device),
                         Precision(name))
            print(json.dumps(dict(seed=seed, precision=name, **out,
                                  seconds=time.perf_counter() - t)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
