"""One run of one cell: inputs, set-up, the measured window, the readers of
the per-layer metrics, the check against the reference, the result line.

A traffic kind (``traffic/<kind>.py``) provides:

* ``make_inputs(cell, seed, device)``: the inputs from the seed (made on
  the device, handed to the host as the system's callers hold them);
* ``setup(cell, inputs, device, seed)``: the system under test made and
  warmed up on every shape the window uses; returns the run's state;
* ``window(state, seconds)``: the measured window; returns ``metrics``
  (the end-to-end metrics it measures), ``attempted``, ``failed``,
  ``units`` (the batches or pushes it ran, for the per-layer readers) and
  ``notes`` (lines for standard error);
* ``release(state)``: the system's state freed once the window closed;
* ``check(state)``: the comparison with the plain reference: a list of
  (name, value, limit), each correct when value <= limit.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from benchmark.core import cells, trace, work
from benchmark.reference import geometry

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "passiveradar_tpu")


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the traced window's device operations
    and host spans, its length, the batches or pushes it ran, the cell and
    its geometry, the frozen work counts. ``note`` tells why a reader
    found nothing."""
    ops: list
    spans: list
    window_s: float
    units: int
    cell: cells.Cell
    geometry: dict
    work: object = work
    notes: list = dataclasses.field(default_factory=list)

    def note(self, msg: str) -> None:
        self.notes.append(msg)


def judge(checks) -> bool:
    """``correct``: every compared number within its limit."""
    return all(v <= lim for _, v, lim in checks)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_info(dev: torch.device, count: int) -> dict:
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=count,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                count=count,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev)))


def run(name: str, seed: int, seconds: float, traced: bool,
        device="cuda", root: str = cells.BENCH_DIR,
        t_start: float | None = None, log=None) -> dict:
    """One run of the cell ``name``. Returns the result line's object (its
    ``checks`` last). ``log`` (default stderr) gets the notes and, last,
    each compared number beside its limit."""
    log = log or sys.stderr
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cell = cells.find(name, root)
    kind = cell.kind()
    t_inputs = time.perf_counter()
    inputs = kind.make_inputs(cell, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t_warm = time.perf_counter()
    state = kind.setup(cell, inputs, dev, seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    print(f"note: set-up {setup_s:.3f} s: start {t_inputs - t_start:.3f}, "
          f"inputs {t_warm - t_inputs:.3f}, program and warm-up "
          f"{t_start + setup_s - t_warm:.3f}", file=log)

    with trace.Profile(traced) as prof:
        out = kind.window(state, seconds)
    for msg in out.get("notes", ()):
        print(f"note: {msg}", file=log)
    dev_info = device_info(dev, int(cell.entry.get("chips", 1)))
    kind.release(state)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = kind.check(state)
    print(f"note: check {time.perf_counter() - t_check:.3f} s", file=log)

    result = dict(correct=judge(checks),
                  attempted=int(out["attempted"]), failed=int(out["failed"]))
    metrics = {}
    if traced:
        ctx = Context(prof.ops, prof.spans, prof.window_s, out["units"],
                      cell, geometry.derive(cell.config))
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is None:
                continue
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
        for msg in ctx.notes:
            print(f"note: {msg}", file=log)
        dev_info["busy_s"] = trace.busy_ns(prof.ops) * 1e-9
        dev_info["window_s"] = prof.window_s
    else:
        measured = dict(out["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] not in measured:
                raise RuntimeError(f"{name} measured no {m['name']}")
            metrics[m["name"]] = dict(value=float(measured[m["name"]]),
                                      unit=m["unit"])
    result["metrics"] = metrics
    result["device"] = dev_info
    if traced:
        result["breakdown"] = trace.breakdown(prof.ops, prof.spans)
    result["checks"] = {n: dict(value=float(v), limit=float(lim))
                        for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=log)
    return result
