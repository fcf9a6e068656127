"""Run one cell of the benchmark of passiveradar_torch on the cards of this
machine and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, configurations, traffic mixes and metrics are named in
BENCHMARK.json and found by name under this directory (core/cells.py).
With ``--trace 0`` the line holds the cell's end-to-end metrics; with
``--trace 1`` the window runs under the profiler and the line holds its
per-layer metrics, the device's busy and window seconds and a breakdown.
Every run checks what its window produced against the plain reference
(reference/) and prints each compared number beside its limit, last on
standard error and under ``checks`` in the line.

Exits 2, printing no result, without CUDA or with fewer cards than the cell
asks for, and 3 when a module of JAX or of the JAX package is loaded once
the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's own build directory is inside the checkout
# (passiveradar_torch/csrc/build); any other cache goes there too
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(REPO, "benchmark", ".cache", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(REPO, "benchmark", ".cache", "torch_ext"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.core import cells, harness

    chips = int(cells.find(args.workload).entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: {args.workload} needs {chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t_start=_T0)
    found = harness.forbidden_modules()
    if found:
        print(f"error: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
