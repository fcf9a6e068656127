"""The traced run's profile: the device's operations in the window, read
from a ``torch.profiler`` trace that the benchmark takes itself.

``Profile`` wraps the measured window in ``torch.profiler.profile`` (host
and device activity) and, when it closes, keeps the device's operations
(kernels, copies, sets; graph replays' kernels one by one) as ``Op``s and
the host's operator spans as ``Span``s, both in nanoseconds on the
profiler's clock. The helpers reduce them: the busy time as the union of
the operations' intervals, the idle gaps between them, and a kernel's
launches found by name.
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    kind: str          # "kernel", "memcpy" or "memset"
    start: int         # ns
    end: int           # ns
    nbytes: int        # copies: bytes moved (0 when the trace lacks it)

    @property
    def direction(self) -> str:
        """"HtoD", "DtoH", "DtoD" for a copy, else ""."""
        for d in ("HtoD", "DtoH", "DtoD"):
            if d in self.name:
                return d
        return ""


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start: int
    end: int


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def _nbytes(ev) -> int:
    for get in (lambda: ev.nbytes(),
                lambda: json.loads("{" + ev.metadata_json() + "}")
                .get("bytes", 0)):
        try:
            value = int(get() or 0)
        except (AttributeError, ValueError, TypeError, RuntimeError):
            continue
        if value:
            return value
    return 0


class Profile:
    """``with Profile(on) as p:`` around the window; ``p.ops`` and
    ``p.spans`` after it, ``p.window_s`` its length on the host clock."""

    def __init__(self, on: bool):
        self.on = on
        self.ops: list = []
        self.spans: list = []
        self.window_s = 0.0
        self._prof = None

    def __enter__(self):
        if self.on:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.on and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is None:
            for ev in self._prof.profiler.kineto_results.events():
                start = int(ev.start_ns())
                end = start + int(ev.duration_ns())
                if ev.device_type() == torch.autograd.DeviceType.CUDA:
                    name = ev.name()
                    self.ops.append(Op(name, _kind(name), start, end,
                                       _nbytes(ev)))
                else:
                    self.spans.append(Span(ev.name(), start, end))
        self.ops.sort(key=lambda o: o.start)
        self._prof = None
        return False


def busy_intervals(ops) -> list:
    """The union of the operations' [start, end) as sorted disjoint
    intervals."""
    out = []
    for op in sorted(ops, key=lambda o: o.start):
        if out and op.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], op.end)
        else:
            out.append([op.start, op.end])
    return out


def busy_ns(ops) -> int:
    return sum(e - s for s, e in busy_intervals(ops))


def gaps(ops) -> list:
    """The idle gaps between busy intervals: (start, end) pairs."""
    iv = busy_intervals(ops)
    return [(a[1], b[0]) for a, b in zip(iv, iv[1:])]


def launches(ops, needle: str) -> list:
    """The kernels whose name holds ``needle``."""
    return [o for o in ops if o.kind == "kernel" and needle in o.name]


def large_copy(op: Op, threshold: int = 1 << 20) -> bool:
    """A copy of at least ``threshold`` bytes (by its duration at 4 GB/s
    where the trace gives no size)."""
    if op.kind != "memcpy":
        return False
    if op.nbytes:
        return op.nbytes >= threshold
    return (op.end - op.start) >= threshold / 4.0


def batch_starts(ops) -> list:
    """Where each batch's device work begins: a large host-to-device copy
    whose previous copy went the other way (a batch ends by copying its
    maps to the host), or the first large one."""
    starts, last_dir = [], None
    for op in ops:
        if op.kind != "memcpy":
            continue
        if op.direction == "HtoD" and large_copy(op) and last_dir != "HtoD":
            starts.append(op)
        if op.direction == "DtoH" or large_copy(op):
            last_dir = op.direction
    return starts


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its template arguments and parameter list,
    at most ``limit`` characters."""
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    short = "".join(out).strip() or name
    return short[:limit]


def breakdown(ops, spans, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    longest idle gaps, each named by the innermost host operator that was
    running across most of it."""
    by_name: dict = {}
    for op in ops:
        name = short_name(op.name)
        by_name[name] = by_name.get(name, 0) + (op.end - op.start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps(ops), key=lambda g: g[0] - g[1])[:top]
    idle = []
    for s, e in longest:
        best, best_cover = "(no host operator)", 0
        for sp in spans:
            cover = min(e, sp.end) - max(s, sp.start)
            if cover <= 0:
                continue
            # innermost: the shortest span covering at least half the gap
            if cover >= 0.5 * (e - s) and (best_cover == 0 or
                                           sp.end - sp.start < best_cover):
                best, best_cover = sp.name, sp.end - sp.start
        idle.append([best, (e - s) * 1e-9])
    return dict(device_ops=[[n, ns * 1e-9] for n, ns in device_ops],
                idle_gaps=idle)
