#!/usr/bin/env python3
"""Build, check and drive the PyTorch port on one CUDA card.

    python3 chip_smoke.py          (from the repository root)

Phases, one JSON line each; any failure exits non-zero:

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: every csrc/*.cu for sm_90a (the five kernels: the resampler,
   NLMS, the fused FFT, the tracker step and the LS canceller's Levinson
   recursion), csrc/mix_regroup.cu again at each setting of
   MR_VARIANTS, one nvcc each, all started at once, from the checkout, with
   ptxas' registers and spills;
3. kernels: every CUDA kernel against its plain torch version on the card,
   at the FM shapes and at ragged small ones (the resampler also on the FM
   bank with zeroed bands, timed at the FM and push shapes, without its
   phase skip and on the complex taps, with its config table of
   MR_VARIANTS builds; the NLMS kernel in both
   zero-window semantics, with a zero run, a ragged tap count, a warm
   start, zero runs from a block's edge and from mid-block, steps no
   multiple of the block and 512 taps; the fused FFT at every supported
   length, forward and inverse, at one and three frames, also against
   cuFFT, and on a strided view), with times (kernel, plain version, one
   library call where there is one) and the reckoned bound; the NLMS
   kernel also at the shape of bench_nlms.py and, for each frame count of
   NLMS_DESIGN_FRAMES, at the FM length in µs a block with the CTAs a
   frame that the launch took, each design also checked (the
   design table);
   the FFT at a stream push's shapes and at that of bench_fft_fused.py,
   with its device time per pass and cuFFT's; then the whole chain on the
   card against the CPU at a small geometry, for the LS and both NLMS
   clutter methods;
4. main path: an FM broadcast capture (2.4 MS/s, 200 kHz channel, 2 s CPI,
   16 frames, two targets) through ``passiveradar_torch.cli.process`` on
   the card with the LS canceller; then (``hdf5``) that capture as an
   ``.h5`` file through ``io/hdf5_min.py`` (h5py blocked), ``cli.process``
   with the default HDF5 maps (peaks, launches, the stack bit-equal to the
   zarr one, wall frames/s against zarr's in turns), ``--resume`` from
   frames_done = 4, a two-part ``cli.concat``, ms a stored frame HDF5
   against zarr, the committed h5py fixture (tests/data/h5py_fixture.h5)
   and ``cli.track_multi``'s tracker on the HDF5 stack; then the capture with
   ``clutter_method: nlms_pallas`` and ``nlms``, each with the kernel
   launch counts of its run (counts set to 0 just before it) and the
   ground-truth peaks of the range-Doppler maps; then one FM batch of 3
   frames with ``nlms_pallas``, card against CPU, at full width; then one
   FM batch with the LS canceller's full-length FFTs on the fused kernel
   (``PASSIVERADAR_PALLAS_FFT=1``) against the cuFFT route; then
   (``levinson_kernel``) the Levinson kernel on the systems of that FM batch
   and of the wideband band, against its plain loop and the loop in
   complex128, and the FM map stack with the recursion on each of the
   three, with times, ns a step, the bound and a dense-solve yardstick;
5. streaming: the same capture through ``passiveradar_torch.cli.stream``
   (CAF, CFAR and the multitarget tracker per push) with the LS canceller
   under ``PASSIVERADAR_PALLAS_FFT=1`` and with ``nlms_pallas``, in full
   and summary detail, with the launch counts of each run, its push
   latency, and a confirmed track at the strong target; each streamed CAF
   against ``process_frames`` over the same frames; the LS push in full
   and summary detail in turns on one processor;
6. postprocess: the LS maps of step 4 through load_maps, cfar_stack, both
   batch trackers and the display frames on the card, per frame, with a
   confirmed track and the simple tracker's lock at the strong target, the
   card against the CPU, and (where matplotlib imports) ``cli.plot``,
   ``cli.track_multi`` and ``cli.track_simple`` in a work directory; then
   (``tracker_kernel``) the tracker-step kernel against its plain version
   on the same card candidates at the FM stream's shape (those maps' CFAR
   stack) and the wideband stream's (8 channels of a drifting-target
   scene), over 16 frames and for one frame from live tables, the whole
   step under ``torch.cuda.set_sync_debug_mode("error")``, its launches
   (at most TRACKER_MAX_LAUNCHES for 8 channels), times and bound;
7. wideband: bench_wideband.py's 8-channel DVB-T-class band, WIDE_CPIS
   CPIs with one echo, through ``cli.wideband --integrate`` (the echo's
   cell in every stack, CPI/s) and ``cli.stream`` on cuFFT and on the fused
   FFT (a confirmed track at the echo in every channel, each channel's
   streamed tracks against the tracker replayed on the CPU, push latency
   by stage), and one CPI on cuFFT and on the fused FFT against the CPU;
8. steady state, for the LS canceller and for ``nlms_pallas``:
   ``process_frames`` on one device-resident FM batch, per stage, with peak
   device memory; then one batch under torch.profiler (kernel launches,
   device busy and idle share, the heaviest kernels) and the preprocess
   stage alone (every kernel by name); then the LS batch on
   cuFFT and on the fused FFT in turns, and one profiled fused batch; then
   (``clutter_graph``) the LS clutter stage as a replayed CUDA graph
   against the eager stage for the FM batch, one stream frame and a
   wideband batch (ms in turns, bit-equality, peak memory, the graph's pool
   and capture seconds), and the FM stage eager on the plain Levinson
   loop, eager on the kernel and graphed, in turns and traced; then
   (``batch_graph``) the whole FM batch as one replayed CUDA graph
   (pipeline.process_frames) for LS on cuFFT and on the fused FFT,
   nlms_pallas and segment + the flattop CAF, int16 and float32 input:
   each replay bit-equal to the eager chain on the card, ms a batch eager,
   with the LS stage graphed and as a batch graph in turns, a bare
   replay's ms, one traced replay (device kernels, idle share), the pool,
   warm-up and capture seconds and the launches of a replay; then
   (``run_capture_trace``) two consecutive batches dispatched from pinned
   buffers as the two earlier loops did (phases by a blocking copy, the
   eager chain; pinned buffers into the batch graph), in turns:
   whether batch 0 still ran when batch 1 had been enqueued, host enqueue
   and wall ms, traced; then run_capture through its card feed, traced
   (kernel ms inside each stage span, the feed's counters); the steady
   state above times the batch graph beside the eager stages in turns;
9. cancellers: the steady-state FM batch through every clutter_impl
   (carry, coupled, segment) × clutter_solver (levinson, gs_matrix,
   gs_dense, cholesky), the clutter stage graphed and eager in turns (median
   ms, bit-equality, peak memory, the graph's pool), each
   map stack against carry/levinson's (ALT_TOL, argmax equal); one 3-frame
   FM batch with coupled + gs_dense + the flattop CAF, card against CPU;
10. alternative paths: the FM capture through ``cli.process`` with
   coupled + gs_dense + ``caf_short_filt: false`` (launch counts, the
   strong peak, the weak one reported, the flattop CAF stage against the
   boxcar's in turns) and through ``cli.stream`` with segment + the
   flattop CAF (a confirmed track at the strong target, push latency, each
   streamed CAF against ``process_frames``), and one wideband CPI with the
   flattop CAF, card against CPU;
11. ops_rest: ls_filter, ls_filter_svd, ls_filter_toeplitz, gal_jpe (µs a
   sample), direct_xambg, decimate_taps, offset_compensation and
   channel_preprocessing at small sizes, card against CPU, ms each;
12. the sharded, grouped, profiled and multi-process runs: the FM batch
   through process_frames_shmap on a mesh of [cuda:0], of [cuda:0,
   cuda:0] and of every card where there are several, for LS and
   nlms_pallas (maps against process_frames, halo exchanges, launches, ms
   against one device in turns); ``cli.process --dispatch-groups 2``
   against G = 1 in turns, and process_frames_groups on two stacked
   batches; ``cli.process --profile`` (the Chrome trace
   names the resampler kernel); two ``cli.process --num-processes 2``
   processes sharing the card over gloo, then ``cli.concat``, against the
   single-process maps and one process alone; one FM CPI through
   fast_xambg_tp on 2 and 4 shards of the card; wideband_frames_shmap on
   2 shards and ``cli.wideband --shard``;
13. the last modules: ``synth_capture_device`` on the card at the FM
   geometry (16 frames of the main path's scene, both output forms,
   seconds and peak memory, the scene's levels) and its first 8 + 2 frames
   through process_frames (the strong target at its cell); ``caf_batch``
   on that batch against process_frames' maps (difference 0) and its ms;
   ``cli.preview``'s numeric core on the main path's capture, card against
   CPU; the native ingest helper (``csrc/pr_io.cc``) built by g++ into
   the port's build directory, bit-equal to numpy at NATIVE_N samples,
   ms against numpy's, the JAX package's ``native/libpr_io.so``
   untouched; and the batch-width sweep: process_frames at SWEEP_WIDTHS
   frames a batch for ``ls_multiple`` and ``nlms_pallas`` on two
   device-resident 66-frame captures (the shared frames against the
   8-frame batch's, launches and peak memory a call, the largest width's
   footprint reckoned first, frames/s from the median of SWEEP_RUNS runs
   with the widths in turns).

``python3 chip_smoke.py --parallel`` runs the build, the main path of
step 4 and step 12 alone (on several cards: a mesh of every card, a
process a card). Then the script's seconds, the ``{"kernels": [...]}`` line (each
kernel's launches on the main path and, in ``launches_by_path``, on every
path that runs it), the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

import contextlib
import ctypes
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".bench_data", "chip_smoke")

# the FM broadcast geometry of .claude/skills/verify/gencap.py
FM = dict(
    input_sample_rate=2_400_000,
    input_center_freq=102_000_000,
    channel_freq=101_900_000,
    channel_bandwidth=200_000,
    cpi_seconds_nominal=2.0,
    max_doppler_nominal=256.0,
    max_range_nominal=200.0,
    overlap_cpi=True,
)
# the small geometry of the CPU tests (tests/test_torch_pipeline.py)
TINY = dict(
    input_sample_rate=49152,
    input_center_freq=1_000_000,
    channel_freq=990_170,
    channel_bandwidth=12800,
    cpi_seconds_nominal=1.0,
    max_doppler_nominal=128.0,
    max_range_nominal=400.0,
    overlap_cpi=True,
    frame_batch=4,
)
FRAMES = 16
BATCH = 8
# H100 SXM data sheet: FP32 (non-tensor) peak and HBM3 rate
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
KERNEL_TOL = 2e-6        # max |kernel - plain| over the peak |plain|
CHAIN_TOL = 1e-4         # card vs CPU, whole chain, over the map peak
STEADY_RUNS = 10
# NLMS kernel vs its plain version: sums in another order over thousands of
# dependent steps; the port's plain loop and the JAX scan differ by ~4e-7
NLMS_TOL = 1e-5
NLMS_CHECK_N = 16384     # length of the kernel-vs-plain checks
NLMS_EDGE_N = 4096       # length of the block-edge checks: steps % P == 7
# csrc/nlms.cu's design table: frame counts timed at the FM length (a
# push's 1, the FM batch's 10, bench_nlms.py's 128, two frames an SM), and
# on each side of the card's cluster count, found at run time ("edges")
NLMS_DESIGN_FRAMES = (1, 10, 128, 264)
NLMS_BENCH = dict(B=128, N=262144, filter_len=175, peek=10)  # bench_nlms.py
FFT_BENCH = (8, 262144)  # bench_fft_fused.py
# csrc/mix_regroup.cu's config table: its defaults, and the builds timed
# against them (groups a thread, warps a CTA, columns a chunk, span buffers
# a CTA, CTAs an SM its registers are capped for)
MR_DEFAULTS = dict(MR_GT=2, MR_KSPLIT=8, MR_CHUNK=8, MR_NBUF=1, MR_MINB=2)
MR_VARIANTS = ({"MR_NBUF": 2, "MR_MINB": 1},
               {"MR_GT": 3, "MR_NBUF": 2, "MR_MINB": 1},
               {"MR_GT": 1, "MR_NBUF": 2}, {"MR_KSPLIT": 4},
               {"MR_CHUNK": 4}, {"MR_CHUNK": 16, "MR_MINB": 1})
STREAM_TOL = 1e-3        # streamed CAF vs process_frames, over the map peak
FUSED_FFT_ENV = "PASSIVERADAR_PALLAS_FFT"
# LS maps on the fused FFT vs the float64-FFT route, over the cuFFT route's
# own distance from it (phase_ls_fused)
FUSED_VS_F64 = 1.5
# the Levinson kernel's x, and the FM map stack on it, vs the complex128
# recursion, over the plain float32 loop's own distance from it
# (phase_levinson_kernel)
LEVINSON_VS_F64 = 2.0
GRAPH_TURNS = 5          # eager, graph, graph, eager: timed runs each x2
INT16_SCALE = 1.0 / 4096  # the FM batch as int16 samples (phase_batch_graph)
# the ground-truth cells of the FM capture (Doppler row, range column)
STRONG_CELL = (432, 153)
WEAK_CELL = (672, 120)
# the simple tracker holds the strong target: locked, within this many
# cells, over the last SIMPLE_LAST frames (phase_postprocess)
SIMPLE_CELLS = 3
SIMPLE_LAST = 4
# bench_wideband.py's DVB-T-class band: 8 MS/s in K = 8 channels of 1 MHz
WIDE = dict(
    input_sample_rate=8_000_000,
    input_center_freq=0,
    channel_freq=0,
    channel_bandwidth=8_000_000,
    cpi_seconds_nominal=0.25,
    max_doppler_nominal=256.0,
    max_range_nominal=60.0,
    wideband_channels=8,
)
WIDE_CPIS = 12           # a track confirms in its 10th CPI at the earliest
WIDE_BATCH = 5           # CPIs a cli.wideband batch
# the echo: 12 channel samples late (3.6 km bistatic), +6 Doppler cells
# (+22.9 Hz). A preliminary track takes the gated candidate nearest the
# origin (the reference's quirk), so it creeps along the echo's sidelobes
# and the noise towards the origin; here, next to the zeroed short-range
# rows and zero-Doppler columns, there is nowhere for it to creep to
WIDE_DELAY = 12
WIDE_DOPPLER_CELLS = 6
# a streamed track is at the echo when its estimate lies within this many
# of the tracker's cells of the echo's cell, in range and in Doppler
ECHO_GATE_CELLS = 1.5
WIDE_TOL = 2e-4          # one CPI, card vs CPU, over the channel's peak
# the other cancellers and the flattop CAF: every clutter_impl ×
# clutter_solver against carry/levinson on the card, and a batch on the
# card against the CPU, within the golden pipeline bound
# (tests/test_golden_e2e.py:93-100): LS amplifies each solver's float32
# rounding at FM (ROADMAP §C)
ALT_TOL = 2e-3
OPS_TOL = 1e-4           # the remaining ops, card vs CPU, over the peak
# the sharded, grouped and multi-process paths: maps against the
# single-device run over its peak (tests/test_pipeline.py's and
# tests/test_multihost.py's bound), argmax equal
SHARD_TOL = 1e-3
SHARD_RUNS = 5           # timed runs each, sharded and on one device
MP_FRAMES = 15           # frames of the multi-process run: 7 + 8
MP_TOL = 1e-3
TP_TOL = 1e-5            # tensor-parallel CAF (tests/test_caf.py)
WIDE_SHARD_TOL = 1e-4    # sharded wideband path (tests/test_wideband.py)
# step 13: the FM scene generated on the card (targets of the main path's
# capture, as (delay samples, Doppler Hz, amplitude))
SYNTH_FRAMES = 16
SYNTH_TARGETS = ((200, 40.0, 0.05), (500, -80.0, 0.03))
PREVIEW_TOL = 1e-4       # preview arrays, card vs CPU, over the peak
NATIVE_N = 20_000_000    # samples of the native helpers' checks
# the batch-width sweep: frames a batch (each + 2 halo frames), timed runs
# of each width, widths in turns; the frames that two batches share within
# the sharded-map bound (LS turns another cuFFT batch into ~1e-4)
SWEEP_WIDTHS = (8, 16, 32, 64)
SWEEP_RUNS = 5
SWEEP_TOL = 1e-3
# the tracker-step kernel against its plain version (tests/test_torch_
# detect.py's tolerances, (atol, rtol) a leaf): float32 4×4 products in
# another order; the slots of a stream's table; the step's launches for
# the 8 wideband channels together (profiler events, memsets included)
TRACKER_TOL = dict(estimate=(1e-4, 1e-6), measurement=(1e-4, 1e-6),
                   x=(1e-4, 1e-5), P=(1e-4, 1e-5), S=(1e-4, 1e-5))
TRACKER_SLOTS = 10
TRACKER_MAX_LAUNCHES = 64


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 2,
            queue: bool = False) -> float:
    """Mean milliseconds of fn() on the card, from CUDA events. With
    ``queue`` the card first sleeps ~2.5 ms, so that the host has enqueued
    the calls before they run and a call shorter than its own enqueue is
    timed on the card, not on the host."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queue:
        torch.cuda._sleep(5_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_launch_ms(torch, fn, launches: int = 100,
                    replays: int = 5) -> float:
    """Mean milliseconds a call of fn() from CUDA events around replays of
    one CUDA graph that holds ``launches`` back-to-back calls (torch.profiler
    drops kernel events, ROADMAP §C; a graph replay takes no host time
    between the calls). fn is called once first, outside the capture."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (replays * launches)
    del graph
    return ms


def kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled one: _ZN<n><namespace><n><name>...,
    with the template arguments I Li<k>E [Lb<0|1>E] E as <k[, bool]>."""
    import re
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    i = m.end() + int(m.group(1))
    m = re.match(r"(\d+)", mangled[i:])
    if not m:
        return mangled
    i += m.end()
    name = mangled[i:i + int(m.group(1))]
    t = re.match(r"ILi(\d+)E(?:Lb([01])E)?", mangled[i + len(name):])
    if not t:
        return name
    flag = "" if t.group(2) is None else \
        (", true" if t.group(2) == "1" else ", false")
    return f"{name}<{t.group(1)}{flag}>"


def ptxas_summary(log: str) -> list:
    """ptxas -v output → one line per kernel: registers and spills."""
    import re
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = kernel_name(m.group(1))
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def flops_bound(nbytes: float, flops: float):
    """(bound ms, "bytes" or "operations") on the H100's published peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def check_regroup(torch, rk, x, bank, down, groups, up, pad_left):
    """Kernel vs plain version on the same card tensors: (max abs err,
    peak |plain|)."""
    got = rk.mix_regroup_matmul(x, bank, down, groups, up, pad_left)
    want = rk.mix_regroup_matmul_plain(x, bank, down, groups, up, pad_left)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    if not (math.isfinite(err) and err <= KERNEL_TOL * peak):
        raise AssertionError(f"mix_regroup_matmul disagrees with its plain "
                             f"version: err {err} peak {peak}")
    return err, peak


def zero_band_bank(bank_ri, up):
    """The FM bank with zeroed bands: an interior run of all-zero columns
    (whole chunks with no nonzero tap) and one phase that is all zero."""
    b = bank_ri.copy()
    b[:, 96:144] = 0
    b[up // 2] = b[up + up // 2] = 0
    return b


def regroup_launch_info(lib) -> dict:
    info = (ctypes.c_int * 4)()
    lib.mix_regroup_last_launch(info)
    return dict(grid=info[0], ctas_per_sm=info[1], smem_bytes=info[2],
                groups_an_item=info[3])


def phase_kernels(torch, dev, variant_libs):
    """The resampler kernel against its plain version at the FM shape, on a
    ragged small geometry and on the FM bank with zeroed bands; timed at the
    FM shape (and without its phase skip) and at a push's shape (F = 1),
    beside the plain version and one library call; then the config table:
    each build of ``variant_libs`` checked and timed at both shapes."""
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.ops import fir
    from passiveradar_torch.ops import resample_kernel as rk

    cfg = derive_config(FM)
    up, down = cfg.resamp_up, cfg.resamp_dn
    n = cfg.input_chunk_length // 2
    f = BATCH + 2
    h_pad, _, _ = fir._resample_design(n, up, down, ("kaiser", 5.0))
    st = fir._mix_resample_static(h_pad.tobytes(), up, down,
                                  cfg.offset_freq / cfg.input_sample_rate, n,
                                  "line")
    groups, pad = st["groups"], st["pad_l"] + st["ext"]
    bank_ri = st["bank_ri"]
    bank = rk.pack_bank(torch.from_numpy(bank_ri).to(dev), up)
    w = bank.taps.shape[1]
    # complex taps the function needs: the nonzero entries of the bank
    taps = int(np.count_nonzero((bank_ri[:up] != 0) | (bank_ri[up:] != 0)))
    ph = bank.phases.cpu().numpy()
    macs_run = int(np.maximum(0, ph[:, 1] - ph[:, 0] + 1).sum()) * bank.chunk
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((f, n, 2), generator=gen, device=dev)
    err, peak = check_regroup(torch, rk, x, bank, down, groups, up, pad)
    launch = regroup_launch_info(rk._library())

    # ragged small geometry: groups no multiple of the 64-group tile
    up2, down2, n2, f2 = 3, 17, 17 * 140 + 5, 3
    bank2 = rk.pack_bank(torch.randn((2 * up2, 3 * down2), generator=gen,
                                     device=dev), up2)
    x2 = torch.randn((f2, n2, 2), generator=gen, device=dev)
    groups2 = (n2 + 9 - 3 * down2) // down2 + 2
    err2, peak2 = check_regroup(torch, rk, x2, bank2, down2, groups2, up2, 9)
    # the FM bank with zeroed bands: empty chunks inside the run
    band = rk.pack_bank(torch.from_numpy(zero_band_bank(bank_ri, up)).to(dev),
                        up)
    err3, peak3 = check_regroup(torch, rk, x, band, down, groups, up, pad)
    band_ph = band.phases.cpu().numpy()

    # the same function as one library call: unfold + complex einsum
    bank_c = torch.view_as_complex(bank.taps)

    def library():
        xc = torch.view_as_complex(x)
        total = (groups - 1) * down + w
        xp = torch.nn.functional.pad(xc, (pad, max(0, total - n - pad)))
        win = xp[:, :total].unfold(-1, w, down)
        return torch.einsum("fgc,pc->fgp", win, bank_c)

    lib_out = library()
    plain = rk.mix_regroup_matmul_plain(x, bank, down, groups, up, pad)
    lib_err = (lib_out - plain).abs().max().item()
    del lib_out, plain

    x1 = x[:1].clone()                 # a stream push: one frame

    def timed(b, xx=x):
        return cuda_ms(torch, lambda: rk.mix_regroup_matmul(
            xx, b, down, groups, up, pad), 20, queue=True)

    ms = timed(bank)
    push_ms = timed(bank, x1)
    plain_ms = cuda_ms(torch, lambda: rk.mix_regroup_matmul_plain(
        x, bank, down, groups, up, pad), 5)
    library_ms = cuda_ms(torch, library, 5)
    # the same kernel with every phase marked live in every chunk (what the
    # skip saves), and on the complex taps, the bank's factors left out
    dense = bank._replace(phases=torch.tensor(
        [[0, up - 1]] * bank.phases.shape[0], dtype=torch.int32, device=dev))
    no_skip_ms = timed(dense)
    complex_ms = timed(bank._replace(real=None, phasor=None))

    # the config table: each build, checked at the FM shape, timed at the FM
    # and push shapes
    table = []
    for label, lib in variant_libs:
        vb = rk.pack_bank(torch.from_numpy(bank_ri).to(dev), up,
                          chunk=lib.mix_regroup_chunk())
        vph = vb.phases.cpu().numpy()
        with mock.patch.object(rk, "_library", return_value=lib):
            verr, _ = check_regroup(torch, rk, x, vb, down, groups, up, pad)
            info = regroup_launch_info(lib)
            table.append(dict(
                label, **info, rel_err=verr / peak, ms=timed(vb),
                push_ms=timed(vb, x1),
                macs_per_group=int(np.maximum(0, vph[:, 1] - vph[:, 0] + 1)
                                   .sum()) * vb.chunk))
    del x1

    factored = bank.real is not None
    bank_bytes = sum(t.numel() * 4 for t in (bank.real, bank.phasor)) \
        if factored else bank.taps.numel() * 4
    nbytes = x.numel() * 4 + bank_bytes + f * groups * up * 8
    flops = 8.0 * f * groups * taps             # 4 FMAs per complex MAC
    # what the kernel runs on the table's live pairs: a complex MAC is 2
    # FMAs on the factors (4 on complex taps), and each live column's sample
    # is turned by its phasor once (2 multiplies and 2 FMAs)
    cols_run = int((ph[:, 0] <= ph[:, 1]).sum()) * bank.chunk
    flops_run = f * groups * (4.0 * macs_run + 6.0 * cols_run) if factored \
        else 8.0 * f * groups * macs_run
    bound_ms, bound_by = flops_bound(nbytes, flops)
    push_bytes = n * 8 + bank_bytes + groups * up * 8
    push_bound_ms, _ = flops_bound(push_bytes, 8.0 * groups * taps)
    row = dict(name="mix_regroup_matmul", route="cuda",
               source="passiveradar_torch/csrc/mix_regroup.cu",
               replaces="passiveradar_tpu/ops/resample_pallas.py:162",
               launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    emit(dict(phase="kernels", shape=dict(F=f, n=n, up=up, down=down, W=w,
                                          W_bank=bank_ri.shape[1],
                                          groups=groups, pad_left=pad),
              launch=launch, max_abs_err=err, peak=peak, rel_err=err / peak,
              ragged=dict(F=f2, n=n2, up=up2, down=down2, groups=groups2,
                          max_abs_err=err2, rel_err=err2 / peak2),
              zero_band=dict(empty_chunks=int((band_ph[:, 0] >
                                               band_ph[:, 1]).sum()),
                             max_abs_err=err3, rel_err=err3 / peak3),
              factored=factored, library_max_abs_err=lib_err, kernel_ms=ms,
              kernel_ms_no_skip=no_skip_ms, kernel_ms_complex_taps=complex_ms,
              plain_ms=plain_ms,
              library_ms=library_ms, bytes=nbytes, taps=taps, flops=flops,
              macs_per_group_run=macs_run, macs_per_group_dense=up * w,
              columns_turned_per_group=cols_run if factored else 0,
              flops_run=flops_run, bound_ms=bound_ms,
              bound_bytes_ms=nbytes / PEAK_BYTES * 1e3,
              bound_ops_ms=flops / PEAK_FP32 * 1e3,
              bound_share=bound_ms / ms,
              achieved_gbytes_per_s=nbytes / ms / 1e6,
              run_tflops=flops_run / ms / 1e9,
              push=dict(F=1, kernel_ms=push_ms, bound_ms=push_bound_ms,
                        bound_share=push_bound_ms / push_ms),
              config_table=table))
    return row


def phase_chain_parity(torch, dev):
    """The whole chain on the card against the CPU at the small geometry."""
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io.synthetic import Target, synth_capture_arrays
    from passiveradar_torch.ops import resample_kernel as rk
    from passiveradar_torch.pipeline import frame_phases, process_frames

    cfg = derive_config(TINY)
    nfr = 4
    ref, srv = synth_capture_arrays(cfg, nfr, targets=(Target(40, 20.0, 0.1),))
    length = cfg.input_chunk_length
    ref = ref[:nfr * length].reshape(nfr, length // 2, 2)
    srv = srv[:nfr * length].reshape(nfr, length // 2, 2)
    ph = frame_phases(cfg, list(range(nfr)))
    before = rk.mix_regroup_matmul.launches
    got = process_frames(ref, srv, ph, cfg, device=dev).cpu().numpy()
    if rk.mix_regroup_matmul.launches != before + 2:
        raise AssertionError("the small chain did not run the CUDA kernel")
    want = process_frames(ref, srv, ph, cfg, device="cpu").numpy()
    rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    same_argmax = all(
        np.argmax(np.abs(got[i])) == np.argmax(np.abs(want[i]))
        for i in range(nfr))
    emit(dict(phase="chain_parity", geometry="tiny", frames=nfr,
              rel_err=rel, argmax_equal=same_argmax))
    if not (rel < CHAIN_TOL and same_argmax and np.all(np.isfinite(got))):
        raise AssertionError(f"card vs CPU chain: rel {rel}, argmax "
                             f"{same_argmax}")


def check_nlms(torch, nk, ref, srv, flen, mu, **kw):
    """NLMS kernel vs plain version on the same card tensors: equal NaN
    masks, the finite parts within NLMS_TOL of the peak. Returns (max abs
    err, peak, NaN count) over the outputs and, with return_filter, the
    taps."""
    got = nk.nlms_filter_batch(ref, srv, flen, mu, **kw)
    want = nk.nlms_filter_batch_plain(ref, srv, flen, mu, **kw)
    torch.cuda.synchronize()
    pairs = zip(got, want) if kw.get("return_filter") else [(got, want)]
    err, peak, nans = 0.0, 0.0, 0
    for g, w in pairs:
        mask = torch.isnan(w)
        if not torch.equal(torch.isnan(g), mask):
            raise AssertionError(f"NLMS kernel NaN mask differs ({kw})")
        nans += int(mask.sum())
        if mask.all():
            continue
        e = (g[~mask] - w[~mask]).abs().max().item()
        p = w[~mask].abs().max().item()
        if not (math.isfinite(e) and e <= NLMS_TOL * p):
            raise AssertionError(f"NLMS kernel disagrees with its plain "
                                 f"version ({kw}): err {e} peak {p}")
        err, peak = max(err, e), max(peak, p)
    return err, peak, nans


def nlms_inputs(torch, gen, dev, f, n):
    """Clutter-like NLMS inputs on the card: srv is a delayed copy of ref
    plus a weak reversed copy and noise."""
    ref = torch.randn((f, n), dtype=torch.complex64, generator=gen,
                      device=dev)
    srv = 0.5 * torch.roll(ref, 3, dims=1) + 0.01 * ref.flip(1) \
        + 0.1 * torch.randn((f, n), dtype=torch.complex64, generator=gen,
                            device=dev)
    return ref, srv


def phase_nlms_kernels(torch, dev):
    """The NLMS kernel against its plain version: both zero-window modes
    with zero windows in one frame, a ragged tap count, a warm start, and
    the block form's edges (a zero run from a block's first step and from
    mid-block, in both modes, steps no multiple of P, m = 512); timed at
    the FM shape and bench_nlms.py's; then the design table: each design
    (a cluster of two CTAs a frame, or one CTA alone, picked by the frame
    count) checked at its first frame count, and the kernel timed at the FM
    length at NLMS_DESIGN_FRAMES and on each side of the card's cluster
    count."""
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.ops import nlms_kernel as nk

    cfg = derive_config(FM)
    flen, mu, peek = cfg.num_range_cells, cfg.nlms_mu, 10
    m = flen + peek
    f = BATCH + 2
    gen = torch.Generator(device=dev).manual_seed(1)
    n = NLMS_CHECK_N
    ref, srv = nlms_inputs(torch, gen, dev, f, n)
    ref[3, n // 3:n // 3 + 2 * m] = 0      # all-zero windows in frame 3
    checks = {}
    for zw in nk.ZERO_WINDOWS:
        err, peak, nans = check_nlms(torch, nk, ref, srv, flen, mu,
                                     zero_window=zw)
        if (nans > 0) != (zw == "nan"):
            raise AssertionError(f"zero_window={zw}: {nans} NaN outputs")
        checks[zw] = dict(max_abs_err=err, rel_err=err / peak, nan=nans)
    err, peak, _ = check_nlms(torch, nk, ref, srv, 23, mu)        # m = 33
    checks["ragged_m33"] = dict(max_abs_err=err, rel_err=err / peak)
    _, taps = nk.nlms_filter_batch(ref[:, :n // 2], srv[:, :n // 2], flen,
                                   mu, return_filter=True)
    err, peak, _ = check_nlms(torch, nk, ref, srv, flen, mu,
                              initial_taps=taps, return_filter=True)
    checks["warm_start_taps"] = dict(max_abs_err=err, rel_err=err / peak)
    # the block form's edges, at NLMS_EDGE_N (steps % P == 7)
    p_block = nk._library().nlms_block_steps()
    edge = {}
    for where, start in (("block_edge", 40 * p_block + 1),
                         ("mid_block", 40 * p_block + 14)):
        r, v = nlms_inputs(torch, gen, dev, 3, NLMS_EDGE_N)
        r[1, start:start + m + 50] = 0    # first zero window: step start-1
        edge[where] = (r, v)
        for zw in nk.ZERO_WINDOWS:
            err, peak, nans = check_nlms(torch, nk, r, v, flen, mu,
                                         zero_window=zw, return_filter=True)
            if (nans > 0) != (zw == "nan"):
                raise AssertionError(f"{where}/{zw}: {nans} NaN outputs")
            checks[f"zero_run_{where}_{zw}"] = dict(
                max_abs_err=err, rel_err=err / peak, nan=nans)
    r, v = edge["mid_block"]
    for zw in nk.ZERO_WINDOWS:
        err, peak, _ = check_nlms(torch, nk, r, v, nk.MAX_TAPS - 10, mu,
                                  zero_window=zw, return_filter=True)
        checks[f"m512_{zw}"] = dict(max_abs_err=err, rel_err=err / peak)
    max_err = max(c["max_abs_err"] for c in checks.values())
    check_ms = cuda_ms(torch, lambda: nk.nlms_filter_batch(
        ref, srv, flen, mu), 3, warmup=1)
    plain_ms = cuda_ms(torch, lambda: nk.nlms_filter_batch_plain(
        ref, srv, flen, mu), 1, warmup=0)
    del ref, srv, taps, edge

    # the FM batch: F = 10 frames of output_chunk_length samples
    big_n = cfg.output_chunk_length
    ref, srv = nlms_inputs(torch, gen, dev, f, big_n)
    out = nk.nlms_filter_batch(ref, srv, flen, mu)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("NLMS kernel output at the FM shape not finite")
    ms = cuda_ms(torch, lambda: nk.nlms_filter_batch(ref, srv, flen, mu), 5,
                 warmup=1)
    steps = big_n - m
    flops = 16.0 * m * steps * f      # 8m for wᴴu, 8m for the update
    nbytes = 3.0 * f * big_n * 8      # ref, srv in; out
    bound_ms, bound_by = flops_bound(nbytes, flops)
    del ref, srv, out

    # bench_nlms.py's shape: 128 frames, 175 + 10 taps
    bb, bn = NLMS_BENCH["B"], NLMS_BENCH["N"]
    bm = NLMS_BENCH["filter_len"] + NLMS_BENCH["peek"]
    ref, srv = nlms_inputs(torch, gen, dev, bb, bn)
    bench_ms = cuda_ms(torch, lambda: nk.nlms_filter_batch(
        ref, srv, NLMS_BENCH["filter_len"], mu, peek=NLMS_BENCH["peek"]), 3,
        warmup=1)
    bench_flops = 16.0 * bm * (bn - bm) * bb
    del ref, srv

    # the design table: the CTAs a frame by frame count, each design checked
    # (zero run mid-block, "nan") at its first frame count, and the kernel
    # timed at the FM length on each side of every change of design
    ctas = [nk.cluster_ctas(k, dev) for k in range(1, 2 * max(
        NLMS_DESIGN_FRAMES))]
    firsts = {c: ctas.index(c) + 1 for c in sorted(set(ctas), reverse=True)}
    edges = {e for k in firsts.values() if k > 1 for e in (k - 1, k)}
    designs = {}
    for c, k in firsts.items():
        r, v = nlms_inputs(torch, gen, dev, max(k, 3), NLMS_EDGE_N)
        r[1, 40 * p_block + 14:40 * p_block + 14 + m + 50] = 0
        err, peak, _ = check_nlms(torch, nk, r, v, flen, mu,
                                  zero_window="nan", return_filter=True)
        designs[str(c)] = dict(first_frames=k, checked_frames=max(k, 3),
                               rel_err=err / peak)
        del r, v
    blocks = -(-steps // p_block)
    table = {}
    ref, srv = nlms_inputs(torch, gen, dev, max(NLMS_DESIGN_FRAMES), big_n)
    for k in sorted(set(NLMS_DESIGN_FRAMES) | edges):
        k_ms = cuda_ms(torch, lambda: nk.nlms_filter_batch(
            ref[:k], srv[:k], flen, mu), 3, warmup=1)
        table[str(k)] = dict(ctas=nk.cluster_ctas(k, dev), kernel_ms=k_ms,
                             us_a_block=k_ms * 1e3 / blocks)
    del ref, srv

    row = dict(name="nlms_filter_pallas", route="cuda",
               source="passiveradar_torch/csrc/nlms.cu",
               replaces="passiveradar_tpu/ops/nlms_pallas.py:157",
               launches=None, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    emit(dict(phase="kernels_nlms", block_steps=p_block,
              checks=dict(F=f, n=n, edge_n=NLMS_EDGE_N, m=m, tol=NLMS_TOL,
                          **checks),
              kernel_ms_at_check_n=check_ms, plain_ms_at_check_n=plain_ms,
              shape=dict(F=f, N=big_n, m=m, steps=steps), kernel_ms=ms,
              ns_per_step=ms * 1e6 / steps, flops=flops, bytes=nbytes,
              bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
              gflops_per_s=flops / ms / 1e6,
              library_ms=None,
              library_note="no single PyTorch call computes NLMS",
              bench_nlms_shape=dict(B=bb, N=bn, m=bm, ms=bench_ms,
                                    ns_per_step=bench_ms * 1e6 / (bn - bm),
                                    gflops_per_s=bench_flops / bench_ms
                                    / 1e6),
              designs=designs, design_table=table))
    return row


def fft_bound(b: int, n: int):
    """(bound ms, bound_by, bytes, flops) of b transforms of n points: each
    complex64 sample read once and written once; 5·n·log2(n) FLOP each."""
    nbytes = 2.0 * b * n * 8
    flops = 5.0 * n * math.log2(n) * b
    return flops_bound(nbytes, flops) + (nbytes, flops)


def fft_device_ms(torch, fn, iters: int = 10) -> dict:
    """Device ms per call of fn's kernels, from torch.profiler over
    ``iters`` calls: the fused FFT's two passes by name and the sum of
    every kernel (``total``); None where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict(fft_columns=0.0, fft_rows=0.0, total=0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        out["total"] += us
        for name in ("fft_columns", "fft_rows"):
            if name in e.name:
                out[name] += us
    return {k: v / iters / 1e3 if v else None for k, v in out.items()}


def phase_fft_kernels(torch, dev):
    """The fused FFT against its plain version and cuFFT at every supported
    length, forward and inverse, at B = 1 and 3 (test_mxufft.py's
    tolerances), on a strided view; timed at the FM clutter shapes, a
    stream push's shapes and bench_fft_fused.py's, with the device time of
    each pass; at the clutter's forward shape its error against the
    complex128 transform may not exceed cuFFT's."""
    from passiveradar_torch.ops import fft_kernel as fk

    gen = torch.Generator(device=dev).manual_seed(3)
    checks = []
    for n in sorted(fk._SPLITS):
        for b in (1, 3):
            x = torch.randn((b, n), dtype=torch.complex64, generator=gen,
                            device=dev)
            for inverse in (False, True):
                got = fk.fft_fused(x, inverse=inverse)
                plain = fk.fft_fused_reference(x, inverse=inverse)
                lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
                torch.cuda.synchronize()
                tol = 2e-5 if inverse else 2e-5 * math.sqrt(n)
                e_plain = (got - plain).abs().max().item()
                e_lib = (got - lib).abs().max().item()
                checks.append(dict(n=n, b=b, inverse=inverse,
                                   err_plain=e_plain, err_cufft=e_lib,
                                   tol=tol))
                if not (e_plain < tol and e_lib < tol):
                    raise AssertionError(f"fft_fused disagrees at n={n}, "
                                         f"b={b}, inverse={inverse}: "
                                         f"{checks[-1]}")

    n = 262144
    f = BATCH + 2
    shapes = dict(forward=((f, 3, n), False), inverse=((f, n), True),
                  bench=(FFT_BENCH, False), push_forward=((3, n), False),
                  push_inverse=((1, n), True))
    timed = {}
    for key, (shape, inverse) in shapes.items():
        x = torch.randn(shape, dtype=torch.complex64, generator=gen,
                        device=dev)
        lib_fn = torch.fft.ifft if inverse else torch.fft.fft
        got = fk.fft_fused(x, inverse=inverse)
        plain = fk.fft_fused_reference(x, inverse=inverse)
        exact = lib_fn(x.to(torch.complex128))
        torch.cuda.synchronize()
        err = (got - plain).abs().max().item()
        # both float32 FFTs against the complex128 transform: max |error|,
        # and over the output's rms
        rms = exact.abs().pow(2).mean().sqrt().item()
        e_k = (got - exact).abs().max().item()
        e_c = (lib_fn(x) - exact).abs().max().item()
        err_f64 = dict(kernel=e_k, cufft=e_c, kernel_over_rms=e_k / rms,
                       cufft_over_rms=e_c / rms)
        tol = 2e-5 if inverse else 2e-5 * math.sqrt(n)
        if not err < tol:
            raise AssertionError(f"fft_fused disagrees at {shape}: {err}")
        if key == "forward" and not e_k <= e_c:
            raise AssertionError(f"fft_fused less accurate than cuFFT at "
                                 f"{shape}: {err_f64}")
        del got, plain, exact
        b = x.numel() // n
        bound_ms, bound_by, nbytes, flops = fft_bound(b, n)
        ms = cuda_ms(torch, lambda: fk.fft_fused(x, inverse=inverse), 20)
        plain_ms = cuda_ms(torch, lambda: fk.fft_fused_reference(
            x, inverse=inverse), 5)
        lib_ms = cuda_ms(torch, lambda: lib_fn(x), 20)
        device_ms = fft_device_ms(torch, lambda: fk.fft_fused(
            x, inverse=inverse))
        lib_device_ms = fft_device_ms(torch, lambda: lib_fn(x))["total"]
        timed[key] = dict(shape=list(shape), inverse=inverse,
                          max_abs_err=err, err_vs_complex128=err_f64,
                          kernel_ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, library_ratio=ms / lib_ms,
                          bound_ms=bound_ms, two_pass_floor_ms=2 * bound_ms,
                          bound_by=bound_by, bytes=nbytes, flops=flops,
                          bound_share=bound_ms / ms,
                          achieved_gbytes_per_s=nbytes / ms / 1e6,
                          device_ms=device_ms,
                          library_device_ms=lib_device_ms)
        del x

    # a strided view: ls_filter_multiple hands over f_extra[:, 0]
    x = torch.randn((f, 3, n), dtype=torch.complex64, generator=gen,
                    device=dev)
    got = fk.fft_fused(x[:, 1])
    strided_err = (got - torch.fft.fft(x[:, 1])).abs().max().item()
    torch.cuda.synchronize()
    if not strided_err < 2e-5 * math.sqrt(n):
        raise AssertionError(f"fft_fused on a strided view: {strided_err}")
    del x, got

    fwd = timed["forward"]
    emit(dict(phase="kernels_fft", checks=checks,
              strided_view_err_cufft=strided_err, **timed))
    return dict(name="fft_fused", route="cuda",
                source="passiveradar_torch/csrc/fft_fused.cu",
                replaces="passiveradar_tpu/ops/fft_pallas.py:116",
                launches=None, max_abs_err=fwd["max_abs_err"],
                ms=fwd["kernel_ms"], plain_ms=fwd["plain_ms"],
                bound_ms=fwd["bound_ms"], bound_by=fwd["bound_by"],
                library_ms=fwd["library_ms"])


class fused_fft:
    """Context: the LS canceller's full-length FFTs on the fused kernel."""

    def __enter__(self):
        os.environ[FUSED_FFT_ENV] = "1"

    def __exit__(self, *exc):
        os.environ.pop(FUSED_FFT_ENV, None)


class float64_fft:
    """Context: the transforms that the fused route takes, in complex128
    through cuFFT and rounded to complex64 — the reference both routes are
    held against."""

    def __enter__(self):
        import torch
        from passiveradar_torch.ops import fft_kernel as fk

        def f64(x, inverse=False):
            fn = torch.fft.ifft if inverse else torch.fft.fft
            return fn(x.to(torch.complex128)).to(torch.complex64)

        self.fk, self.kernel = fk, fk.fft_fused
        fk.fft_fused = f64
        os.environ[FUSED_FFT_ENV] = "1"

    def __exit__(self, *exc):
        self.fk.fft_fused = self.kernel
        os.environ.pop(FUSED_FFT_ENV, None)


def phase_ls_fused(torch, dev, cfg):
    """One FM batch (8 + 2 frames) with the LS canceller, its two
    full-length FFTs on the fused kernel, against the cuFFT route and
    against the same chain with those FFTs in float64. The LS solve
    amplifies any change to them: the cuFFT route is itself ~1e-4 of the
    peak from the float64 one (PERF.md, Findings), so the fused route must have
    every frame's argmax equal to the cuFFT route's and be no farther from
    the float64 route than FUSED_VS_F64 times the cuFFT route is."""
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.ops import fft_kernel as fk

    f = BATCH + 2
    ref, srv, ph, _, _ = fm_batch(torch, dev, cfg)

    def maps():
        return pl._process_frames_impl(ref, srv, ph, cfg).cpu().numpy()

    cufft = maps()
    with float64_fft():
        f64 = maps()
    with fused_fft():
        before = fk.fft_fused.launches
        got = maps()
        launches = fk.fft_fused.launches - before

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    same = all(np.argmax(np.abs(got[i])) == np.argmax(np.abs(cufft[i]))
               for i in range(f))
    out = dict(rel_fused_vs_cufft=rel(got, cufft),
               rel_fused_vs_f64=rel(got, f64),
               rel_cufft_vs_f64=rel(cufft, f64))
    emit(dict(phase="ls_fused_fft", frames=f, fft_fused_launches=launches,
              argmax_equal=same, finite=bool(np.all(np.isfinite(got))),
              **out))
    if not (same and launches == 2 and np.all(np.isfinite(got))
            and out["rel_fused_vs_f64"]
            <= FUSED_VS_F64 * out["rel_cufft_vs_f64"]):
        raise AssertionError(f"LS on the fused FFT: {out}, argmax {same}, "
                             f"{launches} launches")


class levinson_route:
    """Context: the clutter stage's Levinson recursion through ``fn`` in
    place of the kernel (``levinson_kernel.levinson_first_col_kernel``,
    which ops/clutter.py looks up at call time and every graph's key
    holds)."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from passiveradar_torch.ops import levinson_kernel as lk
        self.lk, self.kernel = lk, lk.levinson_first_col_kernel
        lk.levinson_first_col_kernel = self.fn

    def __exit__(self, *exc):
        self.lk.levinson_first_col_kernel = self.kernel


def levinson_routes(torch):
    """The two stand-ins of the kernel: its plain loop on the card in
    complex64, and the same loop in complex128 rounded to complex64 (the
    reference both are held against)."""
    from passiveradar_torch.ops import levinson_kernel as lk

    def f64(c):
        return lk.levinson_first_col_plain(c.to(torch.complex128)).to(
            torch.complex64)

    return dict(plain=lk.levinson_first_col_plain, f64=f64)


def fm_batch(torch, dev, cfg):
    """The FM capture's first BATCH + 2 frames on the card: raw ref, srv,
    phases, and the preprocessed (F, n) ref and srv the clutter stage
    takes."""
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.io.hdf5 import CaptureReader

    reader = CaptureReader(cfg, estimate_offset=False, device=dev)
    f = BATCH + 2
    ref_np, srv_np = reader.read_pair_frames(0, f)
    reader.close()
    ref = torch.from_numpy(ref_np).to(dev)
    srv = torch.from_numpy(srv_np).to(dev)
    ph = torch.from_numpy(pl.frame_phases(cfg, list(range(f)))).to(dev)
    return (ref, srv, ph, pl._preprocess_impl(ref, ph, cfg),
            pl._preprocess_impl(srv, ph, cfg))


def wide_batch(torch, dev):
    """bench_wideband.py's band, WIDE_BATCH CPIs with the echo, as the
    (WIDE_BATCH · channels, cpi_samples) ref and srv rows its clutter stage
    takes, and the config."""
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io.synthetic import wideband_capture_arrays
    from passiveradar_torch.wideband import channel_inputs

    wcfg = derive_config(dict(WIDE, input_file="", output_fname="wb"))
    wref, wsrv = wideband_capture_arrays(
        wcfg, WIDE_BATCH, delay_samples=WIDE_DELAY * wcfg.wideband_channels,
        doppler_hz=WIDE_DOPPLER_CELLS * wcfg.doppler_cell_width, seed=11)
    wref = torch.from_numpy(wref.view(np.complex64).reshape(WIDE_BATCH, -1)
                            ).to(dev)
    wsrv = torch.from_numpy(wsrv.view(np.complex64).reshape(WIDE_BATCH, -1)
                            ).to(dev)
    rc, sc = channel_inputs(wref, wsrv, wcfg)
    return rc, sc, wcfg


def stage_systems(torch, call):
    """The guarded (B, nb, m) autocorrelations that the LS stage hands its
    solver when ``call()`` runs the eager stage once."""
    from passiveradar_torch.ops import clutter

    seen, real = [], clutter._solver_data

    def spy(ac_all, m, solver):
        seen.append(ac_all.clone())
        return real(ac_all, m, solver)

    with mock.patch.object(clutter, "_solver_data", spy):
        call()
    return seen[0]


def per_system_rel(got, want):
    """Largest distance of one system's x from the reference, over that
    system's peak |x| (a guarded zero system's x is 1e25·e0 and would
    swamp the live ones under one peak)."""
    w = want.abs().amax(-1).clamp_min(1e-30)
    return float(((got - want).abs().amax(-1) / w).max())


def levinson_systems(torch, dev, cfg):
    """The guarded systems the LS stage hands the Levinson kernel: the FM
    batch's (BATCH + 2 frames × 5 bins, m = 185) and one CPI of
    bench_wideband.py's band (8 channels × 5 bins, m = 210), each (B, m)
    contiguous; and the FM batch's raw ref, srv and phases."""
    from passiveradar_torch.ops import clutter

    ref, srv, ph, r, s = fm_batch(torch, dev, cfg)
    fm_ac = stage_systems(torch, lambda: clutter.ls_filter_multiple(
        r, s, cfg.num_range_cells, cfg.IF_sample_rate,
        cfg.clutter_doppler_bins))
    rc, sc, wcfg = wide_batch(torch, dev)
    chans = len(wcfg.wideband_channel_select)        # one CPI's rows
    rc, sc = rc[:chans], sc[:chans]
    wide_ac = stage_systems(torch, lambda: clutter.ls_filter_multiple(
        rc, sc, wcfg.num_range_cells, wcfg.IF_sample_rate,
        wcfg.clutter_doppler_bins))
    return (ref, srv, ph), {
        name: ac.reshape(-1, ac.shape[-1]).contiguous()
        for name, ac in (("fm", fm_ac), ("wideband", wide_ac))}


def phase_levinson_kernel(torch, dev, cfg):
    """The Levinson kernel (csrc/levinson.cu) on the systems of the real FM
    batch (BATCH + 2 frames × 5 bins, m = 185, after the stage's guard) and
    of bench_wideband.py's band (8 channels × 5 bins, m = 210): the kernel,
    its plain loop on the card and the plain loop in complex128; the
    kernel's per-system distance from the complex128 route at most
    LEVINSON_VS_F64 times the plain loop's. Then the FM map stack
    (process_frames, the clutter stage graphed) with the recursion on the
    kernel, on the plain loop and in complex128: every frame's argmax equal
    to the complex128 stack's, and the kernel stack no farther from it than
    LEVINSON_VS_F64 times the plain stack; the kernel stack against the
    plain one beside CHAIN_TOL. Times: the kernel's device time a call
    (profiler) and ns a step, the same from CUDA events around one graph of
    100 launches, the call with its host side, the plain loop, and the
    dense Cholesky solve of the same systems as a two-call yardstick; the
    bound. Returns the kernels line's row."""
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.ops import clutter
    from passiveradar_torch.ops import levinson_kernel as lk

    lib_order = lk._library().levinson_max_order()
    if lib_order != lk.MAX_ORDER:
        raise AssertionError(f"csrc/levinson.cu takes m <= {lib_order}, the "
                             f"wrapper {lk.MAX_ORDER}")
    routes = levinson_routes(torch)
    (ref, srv, ph), systems = levinson_systems(torch, dev, cfg)
    shapes, bad = {}, []
    for name, c in systems.items():
        b, m = c.shape
        got = lk.levinson_first_col_kernel(c)
        plain = routes["plain"](c)
        f64 = routes["f64"](c)
        torch.cuda.synchronize()
        dist = dict(kernel_vs_f64=per_system_rel(got, f64),
                    plain_vs_f64=per_system_rel(plain, f64),
                    kernel_vs_plain=per_system_rel(got, plain))
        e0 = torch.zeros_like(c)
        e0[:, 0] = 1.0
        dev_ms = kernel_device_ms(
            torch, lambda c=c: lk.levinson_first_col_kernel(c),
            "levinson_kernel")
        ms = dict(kernel=dev_ms,
                  kernel_graph=graph_launch_ms(
                      torch, lambda c=c: lk.levinson_first_col_kernel(c)),
                  kernel_call=cuda_ms(
                      torch, lambda c=c: lk.levinson_first_col_kernel(c), 50),
                  plain=cuda_ms(torch, lambda c=c: routes["plain"](c), 3,
                                warmup=1),
                  dense_solve_yardstick=cuda_ms(
                      torch, lambda c=c: clutter._solve_complex(
                          clutter._toeplitz_matrix(c), e0, assume_pd=True),
                      10))
        nbytes = 2 * b * m * 8
        flops = b * (12.0 * m * (m - 1) + 16.0 * (m - 1))
        bound_ms, bound_by = flops_bound(nbytes, flops)
        shapes[name] = dict(
            systems=b, m=m, finite=bool(torch.isfinite(
                torch.view_as_real(got)).all()),
            max_abs_err_vs_plain=float((got - plain).abs().max()),
            distance=dist, ms=ms, ns_per_step=dev_ms * 1e6 / max(m - 1, 1),
            ns_per_step_graph=ms["kernel_graph"] * 1e6 / max(m - 1, 1),
            bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by,
            bound_share=bound_ms / dev_ms)
        if not (shapes[name]["finite"] and dist["kernel_vs_f64"]
                <= LEVINSON_VS_F64 * dist["plain_vs_f64"]):
            bad.append(name)

    def stack():
        return pl._process_frames_impl(ref, srv, ph, cfg).cpu().numpy()

    stacks = dict(kernel=stack())
    for route in ("plain", "f64"):
        with levinson_route(routes[route]):
            stacks[route] = stack()
    kernel_f64, same = compare_to(stacks["kernel"], stacks["f64"])
    plain_f64, plain_same = compare_to(stacks["plain"], stacks["f64"])
    kernel_plain, _ = compare_to(stacks["kernel"], stacks["plain"])
    maps = dict(frames=BATCH + 2, kernel_vs_f64=kernel_f64,
                plain_vs_f64=plain_f64, kernel_vs_plain=kernel_plain,
                chain_tol=CHAIN_TOL, argmax_equal_kernel_vs_f64=same,
                argmax_equal_plain_vs_f64=plain_same)
    emit(dict(phase="levinson_kernel", tol_vs_f64=LEVINSON_VS_F64,
              max_order=lib_order, map_stack=maps, **shapes))
    if bad or not same or kernel_f64 > LEVINSON_VS_F64 * plain_f64 or \
            not np.all(np.isfinite(stacks["kernel"])):
        raise AssertionError(f"levinson kernel: systems {bad}, maps {maps}")
    r = shapes["fm"]
    return dict(name="levinson_first_col", route="cuda",
                source="passiveradar_torch/csrc/levinson.cu",
                replaces="passiveradar_tpu/ops/clutter.py:113",
                launches=None,
                max_abs_err=max(x["max_abs_err_vs_plain"]
                                for x in shapes.values()),
                ms=r["ms"]["kernel"], plain_ms=r["ms"]["plain"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=None)


def clutter_key(ref, srv, filter_len, sample_rate, doppler_bins=(0,),
                solver="levinson", impl="carry"):
    """The key that ops/clutter.ls_filter_multiple_graphed keeps its graph
    under for these arguments (graphs.graph_key, kind "clutter")."""
    from passiveradar_torch.ops import graphs
    return graphs.graph_key("clutter", (ref, srv), (
        int(filter_len), float(sample_rate),
        tuple(float(b) for b in doppler_bins), impl, solver))


def graph_entry(key):
    """The graph kept under ``key`` (ops/graphs.py)."""
    from passiveradar_torch.ops import graphs
    entry = graphs.lookup(key, key[1])
    if entry is None:
        raise AssertionError(f"no graph kept under the key of kind {key[0]}")
    return entry


def eager_vs_graph(torch, eager, graphed, key):
    """``eager()`` and ``graphed()`` (one clutter stage each) in turns:
    the graphed stage's first call (warm-up and capture) timed on the host,
    then eager, graph, graph, eager GRAPH_TURNS times by CUDA events; the
    replay against the eager result (bit-equal, else the largest
    difference over the peak); peak memory of an eager call above its
    inputs, of a replay, and the graph's private pool."""
    torch.cuda.synchronize()
    first, first_ms = synced_ms(torch, graphed)
    entry = graph_entry(key)
    want = eager()
    got = graphed()
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    rel = float((got - want).abs().max() / want.abs().max())
    rel_first = float((first - want).abs().max() / want.abs().max())
    del first, got
    ms = dict(eager=[], graph=[])
    for _ in range(GRAPH_TURNS):
        for which in ("eager", "graph", "graph", "eager"):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            (eager if which == "eager" else graphed)()
            ev[1].record()
            torch.cuda.synchronize()
            ms[which].append(ev[0].elapsed_time(ev[1]))
    peak = {}
    for which, fn in (("eager", eager), ("graph", graphed)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        peak[which] = torch.cuda.max_memory_allocated() - base
        del out
    return dict(bit_equal=equal, rel_diff_over_peak=rel,
                first_call_rel_diff=rel_first,
                ms_median={k: float(np.median(v)) for k, v in ms.items()},
                ms_runs=ms, first_call_ms=first_ms,
                warmup_s=entry.warmup_s, capture_s=entry.capture_s,
                pool_bytes=entry.pool_bytes,
                launches_a_replay=entry.launches,
                peak_bytes_eager=peak["eager"],
                peak_bytes_replay=peak["graph"])


def phase_clutter_graph(torch, dev, cfg):
    """The LS clutter stage (carry, levinson, cuFFT) graphed against eager
    (eager_vs_graph) for the FM batch (BATCH + 2 frames), the stream's one
    frame and bench_wideband.py's WIDE_BATCH-CPI batch (8 channels each);
    for the FM batch also the eager stage with the plain Levinson loop (the
    stage as it was), the three in turns (plain, kernel, graph, graph,
    kernel, plain; CUDA events), and one traced call of each: device
    kernels, busy and idle share. The replay must equal the eager stage bit
    for bit."""
    from passiveradar_torch.ops import clutter, graphs

    _, _, _, r, s = fm_batch(torch, dev, cfg)
    rc, sc, wcfg = wide_batch(torch, dev)
    cases = dict(fm=(r, s, cfg), fm_push=(r[:1].contiguous(),
                                          s[:1].contiguous(), cfg),
                 wideband=(rc, sc, wcfg))
    out, bad = {}, []
    for name, (x, y, c) in cases.items():
        args = (x, y, c.num_range_cells, c.IF_sample_rate,
                c.clutter_doppler_bins)
        row = eager_vs_graph(
            torch, lambda args=args: clutter.ls_filter_multiple(*args),
            lambda args=args: clutter.ls_filter_multiple_graphed(*args),
            clutter_key(*args))
        row.update(rows=x.shape[0], samples=x.shape[1])
        out[name] = row
        if not row["bit_equal"]:
            bad.append(name)

    args = (r, s, cfg.num_range_cells, cfg.IF_sample_rate,
            cfg.clutter_doppler_bins)
    plain = levinson_route(levinson_routes(torch)["plain"])
    runs = dict(eager_plain=[], eager_kernel=[], graph=[])

    def one(which):
        if which == "eager_plain":
            with plain:
                return clutter.ls_filter_multiple(*args)
        if which == "eager_kernel":
            return clutter.ls_filter_multiple(*args)
        return clutter.ls_filter_multiple_graphed(*args)

    for which in runs:
        one(which)
    for _ in range(3):
        for which in ("eager_plain", "eager_kernel", "graph", "graph",
                      "eager_kernel", "eager_plain"):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            one(which)
            ev[1].record()
            torch.cuda.synchronize()
            runs[which].append(ev[0].elapsed_time(ev[1]))
    traces = {}
    for which in runs:
        t = trace(torch, lambda which=which: one(which))
        t.pop("by_name", None)
        traces[which] = t
    fm_stage = dict(ms_median={k: float(np.median(v)) for k, v in
                               runs.items()}, ms_runs=runs, traced=traces)
    emit(dict(phase="clutter_graph", impl="carry", solver="levinson",
              graph_budget_bytes=graphs.budget(dev), fm_stage=fm_stage,
              **out))
    if bad:
        raise AssertionError(f"clutter graph replays differ from eager: "
                             f"{ {k: out[k]['rel_diff_over_peak'] for k in bad} }")


@contextlib.contextmanager
def eager_ls_stage(pl):
    """Context: the pipeline's LS stage eager on the card (what it runs
    inside a graph being built) in place of its own graph, so that
    ``pl._process_frames_impl`` is the wholly eager chain."""
    from passiveradar_torch.ops import clutter
    graphed = pl.ls_filter_multiple_graphed
    pl.ls_filter_multiple_graphed = clutter.ls_filter_multiple
    try:
        yield
    finally:
        pl.ls_filter_multiple_graphed = graphed


def bits_equal(torch, got, want) -> bool:
    """Bit for bit (NaN frames compare equal to themselves)."""
    def bits(x):
        return torch.view_as_real(x).contiguous().view(torch.int32) \
            if x.is_complex() else x.contiguous().view(torch.int32)
    return bool(torch.equal(bits(got), bits(want)))


def int16_pairs(torch, x):
    """Float32 IQ pairs as the int16 samples of an SDR capture, read back
    as x·INT16_SCALE (cfg.int16_scale)."""
    return torch.round(x / INT16_SCALE).to(torch.int16)


def phase_batch_graph(torch, dev, params):
    """The FM batch (BATCH + 2 frames, int16 and float32 IQ pairs) as one
    replayed CUDA graph (pipeline.process_frames), for LS on cuFFT and on
    the fused FFT, nlms_pallas and segment + the flattop CAF: each replay
    (and the key's first call, its warm-up) bit-equal to the eager chain on
    the same card, both as it was (the LS stage its own graph) and wholly
    eager; ms a batch in turns (eager, stage graph, batch graph, batch
    graph, stage graph, eager; GRAPH_TURNS times, CUDA events), and a bare
    replay's; the device kernels and idle share of one traced replay; the
    graph's pool, warm-up and capture seconds; launches a replay from the
    counters, equal to an eager batch's. Returns the LS cuFFT float32
    case's row."""
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.ops import graphs

    cases = (("ls_cufft", {}, False), ("ls_fused", {}, True),
             ("nlms_pallas", dict(clutter_method="nlms_pallas"), False),
             ("segment_flattop", dict(clutter_impl="segment",
                                      caf_short_filt=False), False))
    rows, bad, main_row = [], [], None
    for name, over, fused in cases:
        for dtype in ("int16", "float32"):
            cfg = derive_config(dict(params, int16_scale=INT16_SCALE, **over)
                                if dtype == "int16" else dict(params, **over))
            ref, srv, ph, _, _ = fm_batch(torch, dev, cfg)
            if dtype == "int16":
                ref, srv = int16_pairs(torch, ref), int16_pairs(torch, srv)
            route = fused_fft if fused else contextlib.nullcontext
            with route():
                def eager():
                    with eager_ls_stage(pl):
                        return pl._process_frames_impl(ref, srv, ph, cfg)

                runs = dict(
                    eager=eager,
                    stage_graph=lambda: pl._process_frames_impl(
                        ref, srv, ph, cfg),
                    batch_graph=lambda: pl.process_frames(ref, srv, ph,
                                                          cfg))
                zero_counts()
                want = runs["eager"]()
                torch.cuda.synchronize()
                eager_counts = read_counts()
                stage = runs["stage_graph"]()
                first = runs["batch_graph"]()
                entry = graph_entry(graphs.graph_key(
                    "frames", (ref, srv, ph), cfg, dev))
                got = [runs["batch_graph"]() for _ in range(2)]
                torch.cuda.synchronize()
                equal = dict(
                    first_call=bits_equal(torch, first, want),
                    replays=all(bits_equal(torch, g, want) for g in got),
                    stage_graph=bits_equal(torch, stage, want))
                del first, got, stage
                ms = dict(eager=[], stage_graph=[], batch_graph=[])
                for _ in range(GRAPH_TURNS):
                    for which in ("eager", "stage_graph", "batch_graph",
                                  "batch_graph", "stage_graph", "eager"):
                        ev = [torch.cuda.Event(enable_timing=True)
                              for _ in range(2)]
                        torch.cuda.synchronize()
                        ev[0].record()
                        runs[which]()
                        ev[1].record()
                        torch.cuda.synchronize()
                        ms[which].append(ev[0].elapsed_time(ev[1]))
                replay_ms = cuda_ms(torch, lambda: graphs.replay(entry), 10)
                traced = trace(torch, runs["batch_graph"])
                traced.pop("by_name", None)
            row = dict(case=name, input_dtype=dtype, clutter_method=(
                cfg.clutter_method), clutter_impl=cfg.clutter_impl,
                caf_short_filt=cfg.caf_short_filt, fused_fft=fused,
                frames=int(ref.shape[0]), bit_equal=equal,
                ms_median={k: float(np.median(v)) for k, v in ms.items()},
                ms_runs=ms, replay_only_ms=replay_ms,
                frames_per_s_batch_graph=BATCH / float(
                    np.median(ms["batch_graph"])) * 1e3,
                traced_replay=traced, pool_bytes=entry.pool_bytes,
                warmup_s=entry.warmup_s, capture_s=entry.capture_s,
                launches_a_replay=entry.launches,
                launches_eager_batch={k: v for k, v in eager_counts.items()
                                      if v})
            rows.append(row)
            emit(dict(phase="batch_graph", **row))
            if not all(equal.values()) or row["launches_a_replay"] != \
                    row["launches_eager_batch"]:
                bad.append(f"{name}/{dtype}")
            if name == "ls_cufft" and dtype == "float32":
                main_row = row
            del ref, srv, ph, want
    emit(dict(phase="graph_cache", budget_bytes=graphs.budget(dev),
              graphs=graphs.cache_info()))
    if bad:
        raise AssertionError(f"batch graph replays differ from the eager "
                             f"chain or count other launches: {bad}")
    return main_row


class NullWriter:
    """A map writer that keeps nothing (run_capture's timing)."""
    frames_done = 0

    def write(self, frames, start):
        pass


def phase_run_capture_trace(torch, dev, params):
    """Two consecutive FM batches dispatched from pinned host buffers as
    run_capture's two earlier dispatches did: "before", the phases copied
    with a blocking .to(device), then the eager chain; "after", raw, phases
    and maps through pinned buffers straight into and out of the batch
    graph, the one-card loop's dispatch until its card feed (feed.py)
    replaced it. In turns (before, after, after, before; 3 times): each
    batch's host enqueue ms, whether batch 0's device work was still
    running when batch 1 had been enqueued (its event not yet reached: one
    batch in flight), the two batches' wall ms, and one traced pair each
    (device kernels, idle share). Then run_capture itself over the 16-frame
    capture, through its card feed, traced: the card's kernel time inside
    each ``capture.stage`` span (above 0 after the first batch where the
    card still ran the previous batch while the host staged the next) and
    the feed's counters (``feed.stage_info``: two slots a channel reused
    at every batch after a call's first)."""
    from passiveradar_torch import feed
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io.hdf5 import CaptureReader

    cfg = derive_config(params)
    f = BATCH + 2
    reader = CaptureReader(cfg, estimate_offset=False, device=dev)
    bufs = []
    for s0 in (0, FRAMES - f):
        r, s = reader.read_pair_frames(s0, f)
        bufs.append(dict(
            ref=torch.from_numpy(r).pin_memory(),
            srv=torch.from_numpy(s).pin_memory(),
            ph=torch.from_numpy(pl.frame_phases(
                cfg, list(range(s0, s0 + f)))).pin_memory(),
            out=torch.empty((f, cfg.num_doppler_cells,
                             cfg.num_range_cells + 1), dtype=torch.complex64,
                            pin_memory=True)))

    def dispatch(variant, b):
        if variant == "before":
            ph = torch.from_numpy(b["ph"].numpy().copy())    # pageable
            return pl._process_frames_impl(
                b["ref"].to(dev, non_blocking=True),
                b["srv"].to(dev, non_blocking=True), ph.to(dev), cfg)
        return pl._graphed("frames", (b["ref"], b["srv"], b["ph"]), cfg,
                           device=dev, fresh=False)

    def two(variant):
        torch.cuda.synchronize()
        events, host_ms, running = [], [], None
        t0 = time.perf_counter()
        for i, b in enumerate(bufs):
            t = time.perf_counter()
            b["out"].copy_(dispatch(variant, b), non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            host_ms.append((time.perf_counter() - t) * 1e3)
            if i:
                running = not events[0].query()
            events.append(ev)
        for ev in events:
            ev.synchronize()
        return dict(host_enqueue_ms=host_ms,
                    batch0_running_after_batch1_enqueued=running,
                    wall_ms=(time.perf_counter() - t0) * 1e3)

    for variant in ("before", "after"):
        two(variant)
    runs = dict(before=[], after=[])
    for _ in range(3):
        for variant in ("before", "after", "after", "before"):
            runs[variant].append(two(variant))
    maps = {v: [b["out"].clone() for b in bufs] for v in ("before",)}
    two("after")
    same = all(torch.equal(a, b["out"]) for a, b in zip(maps["before"], bufs))
    traced = {}
    for variant in runs:
        t = trace(torch, lambda variant=variant: two(variant))
        t.pop("by_name", None)
        traced[variant] = t
    counted = feed.stage_info()
    loop = trace(torch, lambda: pl.run_capture(reader, NullWriter(), cfg,
                                               progress=False, device=dev))
    loop.pop("by_name", None)
    reader.close()
    fed = {k: v - counted[k] for k, v in feed.stage_info().items()}
    summary = {v: dict(
        wall_ms_median=float(np.median([r["wall_ms"] for r in rs])),
        host_enqueue_ms_median=[float(np.median([r["host_enqueue_ms"][i]
                                                 for r in rs]))
                                for i in range(2)],
        batch0_running_after_batch1_enqueued=[
            r["batch0_running_after_batch1_enqueued"] for r in rs])
        for v, rs in runs.items()}
    emit(dict(phase="run_capture_trace", frames_a_batch=f,
              order="before, after, after, before; x3", summary=summary,
              runs=runs, traced_two_batches=traced,
              maps_equal_before_after=same,
              run_capture_16_frames_traced=loop, run_capture_feed=fed))
    if not same:
        raise AssertionError("run_capture's batches differ before and "
                             "after the phases repair")
    if fed["frames_reused"] != 2 * 2 * (fed["batches"] - fed["calls"]):
        raise AssertionError(f"run_capture's feed reused {fed}: not two "
                             "slots a channel at every batch after a "
                             "call's first")


def phase_ls_route_ab(torch, dev, cfg):
    """The LS steady-state batch on the cuFFT route and on the fused-FFT
    route in turns (cuFFT, fused, fused, cuFFT, five times): batch and
    clutter-stage ms by CUDA events, the host time to enqueue one forward
    FFT of the clutter's shape on each route (the median of ten loops of
    20 calls, in the same turns), and one profiled batch on the fused
    route."""
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.ops import fft_kernel as fk

    f = BATCH + 2
    ref, srv, ph, _, _ = fm_batch(torch, dev, cfg)

    def run():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        r = pl._preprocess_impl(ref, ph, cfg)
        s = pl._preprocess_impl(srv, ph, cfg)
        ev[1].record()
        pl._caf_batch_impl(r, pl._clutter_impl(r, s, cfg), cfg)
        ev[2].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[2]), ev[1].elapsed_time(ev[2])

    for _ in range(2):
        run()
        with fused_fft():
            run()
    times = dict(cufft=dict(total=[], clutter_caf=[]),
                 fused=dict(total=[], clutter_caf=[]))
    for _ in range(5):
        for route in ("cufft", "fused", "fused", "cufft"):
            if route == "fused":
                with fused_fft():
                    t, c = run()
            else:
                t, c = run()
            times[route]["total"].append(t)
            times[route]["clutter_caf"].append(c)

    x = torch.randn((f, 3, cfg.output_chunk_length), dtype=torch.complex64,
                    device=dev)
    fns = dict(cufft=lambda: torch.fft.fft(x),
               fused=lambda: fk.fft_fused(x))
    enqueue_runs = dict(cufft=[], fused=[])
    for route in ("cufft", "fused") + ("cufft", "fused", "fused", "cufft") * 5:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fns[route]()
        enqueue_runs[route].append((time.perf_counter() - t0) / 20 * 1e3)
        torch.cuda.synchronize()
    enqueue_runs = {r: v[1:] for r, v in enqueue_runs.items()}   # warm-up
    enqueue = {r: float(np.median(v)) for r, v in enqueue_runs.items()}
    del x
    emit(dict(phase="ls_route_ab", buffer_frames=f, runs_each=10,
              order="cufft, fused, fused, cufft; x5",
              median_ms={r: {k: float(np.median(v)) for k, v in t.items()}
                         for r, t in times.items()},
              runs_ms=times, enqueue_ms_per_forward_fft=enqueue,
              enqueue_runs_ms=enqueue_runs))
    with fused_fft():
        profile_batch(torch, pl, ref, srv, ph, cfg)


def push_breakdown(torch, sp, ref, srv, method):
    """Where one push's time goes, on the processor's state after a stream:
    preprocess + clutter of one frame (one graph), its CAF + CFAR graph,
    the eager CAF and CFAR, and the tracker step, each timed alone by CUDA
    events (host launch gaps included), and the tracker step's kernel
    launches under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from passiveradar_torch.detect.trackers import multitarget_step
    from passiveradar_torch.ops.caf import fast_xambg
    from passiveradar_torch.ops.cfar import cfar_2d

    cfg = sp.cfg
    h = cfg.window_overlap
    cur = sp._clean(ref, srv)
    r, s = cur[0][0], cur[1][0]
    z = torch.zeros(h, dtype=r.dtype, device=r.device)
    r_in, s_in = torch.cat([z, r, z]), torch.cat([z, s, z])
    caf = fast_xambg(r_in, s_in, cfg.num_range_cells, cfg.num_doppler_cells,
                     window=sp._window)
    mag = caf.abs()
    cf = cfar_2d(mag, *sp.cfar_kernel)

    def track():
        return multitarget_step(sp._tracks, cf, sp._extent, sp.n_tracks,
                                cfg.candidate_budget)

    from passiveradar_torch.ops import graphs
    from passiveradar_torch.streaming import _caf_cfar
    cfar_kernel = tuple(sp.cfar_kernel)

    def caf_cfar():
        # the push's CAF + CFAR graph, as StreamingProcessor._finish runs it
        return graphs.graphed("stream_caf", lambda *a: _caf_cfar(
            *a, cfg=cfg, window=sp._window, cfar_kernel=cfar_kernel),
            (z, r, z, z, s, z), (cfg, cfar_kernel))

    ms = dict(
        clean=cuda_ms(torch, lambda: sp._clean(ref, srv), 5, warmup=1),
        caf_cfar_graph=cuda_ms(torch, caf_cfar, 5, warmup=1),
        caf=cuda_ms(torch, lambda: fast_xambg(
            r_in, s_in, cfg.num_range_cells, cfg.num_doppler_cells,
            window=sp._window), 5, warmup=1),
        cfar=cuda_ms(torch, lambda: cfar_2d(mag, *sp.cfar_kernel), 5,
                     warmup=1),
        tracker=cuda_ms(torch, track, 5, warmup=1))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        track()
        torch.cuda.synchronize()
    launches = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    emit(dict(phase="stream_breakdown", clutter_method=method,
              n_tracks=sp.n_tracks, stage_ms=ms,
              tracker_kernel_launches=launches))


def summary_ab(torch, dev, cfg, ref, srv, route):
    """The push in full and in summary detail in turns (full, summary,
    summary, full, ...) on one processor over the device-resident frames:
    each push's host milliseconds (the card synchronised on both sides)
    and each detail's median; the first push, which returns nothing, is
    left out."""
    from passiveradar_torch.streaming import StreamingProcessor

    sp = StreamingProcessor(cfg, device=dev)
    turns = ("full", "summary", "summary", "full")
    ms = dict(full=[], summary=[])
    with route():
        sp.push(ref[0], srv[0])
        for i in range(1, ref.shape[0]):
            detail = turns[(i - 1) % len(turns)]
            _, t = synced_ms(torch, lambda: sp.push(ref[i], srv[i],
                                                    detail=detail))
            ms[detail].append(t)
    emit(dict(phase="stream_summary_ab", clutter_method=cfg.clutter_method,
              turns=list(turns), push_ms=ms,
              push_ms_median={d: float(np.median(v)) for d, v in ms.items()},
              summary_over_full=float(np.median(ms["summary"])
                                      / np.median(ms["full"]))))


def phase_stream(torch, dev, params):
    """cli.stream on the FM capture: LS under the fused-FFT opt-in and
    nlms_pallas, full and summary detail, with each run's launch counts
    (set to 0 just before it) and push latency; a confirmed track within the
    confirmed gate (4 km, 20 Hz) of the strong target; then every streamed
    CAF (device-resident pushes) against process_frames over the same
    frames. Returns the launch counts of the full-detail runs."""
    import yaml

    from passiveradar_torch.cli.stream import main as stream_main
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io.hdf5 import CaptureReader
    from passiveradar_torch.pipeline import frame_phases, process_frames
    from passiveradar_torch.streaming import StreamingProcessor

    counters = kernel_counters()
    runs = {}
    for method in ("ls_multiple", "nlms_pallas"):
        p = dict(params, clutter_method=method)
        cfg = derive_config(p)
        cfg_path = os.path.join(WORK, f"stream_{method}.yaml")
        with open(cfg_path, "w") as fh:
            yaml.safe_dump(p, fh)
        target = strong_target(cfg)
        fused = method == "ls_multiple"
        route = fused_fft if fused else contextlib.nullcontext
        for detail in ("full", "summary"):
            for c in counters.values():
                c.launches = 0
            with route():
                res = stream_main(["--config", cfg_path, "--detail", detail])
                torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counters.items()}
            table = res["tracks"]
            status = np.asarray(table["status"])
            est = np.asarray(table["estimate"])
            hits = [int(i) for i in np.where(status == 2)[0]
                    if abs(est[i, 0] - target[0]) < 4
                    and abs(est[i, 1] - target[1]) < 20]
            lat = np.asarray(res["push_ms"])
            emit(dict(phase="stream", clutter_method=method,
                      fused_fft=fused, detail=detail, frames=res["frames"],
                      launches=launches, wall_s=res["seconds"],
                      push_ms_median=float(np.median(lat)),
                      push_ms_max=float(lat.max()),
                      push_ms_steady_median=float(np.median(lat[1:-1])),
                      push_ms=lat.tolist(),
                      realtime=bool(lat.max() < 1e3 * cfg.frame_interval),
                      strong_target_km_hz=target,
                      confirmed=[[int(i), float(est[i, 0]), float(est[i, 1])]
                                 for i in np.where(status == 2)[0]],
                      confirmed_at_strong_target=hits))
            # the tracker: a step a frame and one at the processor's
            # construction (its warm-up)
            want = dict(mix_regroup_matmul=2 * FRAMES,
                        nlms_filter_pallas=0 if fused else FRAMES,
                        fft_fused=2 * FRAMES if fused else 0,
                        multitarget_step=FRAMES + 1,
                        levinson_first_col=FRAMES if fused else 0)
            if res["frames"] != FRAMES or launches != want:
                raise AssertionError(f"stream {method}/{detail}: frames "
                                     f"{res['frames']}, launches {launches}")
            if not hits:
                raise AssertionError(f"stream {method}/{detail}: no "
                                     f"confirmed track at {target}")
            if detail == "full":
                runs[method] = launches

        # every streamed CAF against the batch chain over the same frames
        reader = CaptureReader(cfg, estimate_offset=False, device=dev)
        ref_c, srv_c = reader.read_iq_frames(0, FRAMES)
        ref_p, srv_p = reader.read_pair_frames(0, FRAMES)
        reader.close()
        with route():
            batch = process_frames(ref_p, srv_p,
                                   frame_phases(cfg, list(range(FRAMES))),
                                   cfg, device=dev).abs().cpu().numpy()
            sp = StreamingProcessor(cfg, device=dev)
            rc = torch.from_numpy(ref_c).to(dev)
            sc = torch.from_numpy(srv_c).to(dev)
            streamed = [sp.push(rc[i], sc[i]) for i in range(FRAMES)]
            streamed = [r for r in streamed if r is not None] + [sp.flush()]
        errs = [float(np.max(np.abs(np.abs(r.caf) - batch[r.frame_index]))
                      / np.max(batch[r.frame_index])) for r in streamed]
        with route():
            push_breakdown(torch, sp, rc[0], sc[0], method)
        if method == "ls_multiple":
            summary_ab(torch, dev, cfg, rc, sc, route)
        emit(dict(phase="stream_vs_process_frames", clutter_method=method,
                  fused_fft=fused, frames=len(streamed),
                  max_rel_err=max(errs), tol=STREAM_TOL))
        if [r.frame_index for r in streamed] != list(range(FRAMES)) or \
                not max(errs) < STREAM_TOL:
            raise AssertionError(f"streamed CAFs vs process_frames "
                                 f"({method}): {errs}")
        del batch, streamed
    return runs


def tracker_point(cfg, cell):
    """A map cell (Doppler row, range column) on the tracker's axes: range
    from get_measurements' range points, Doppler from its Doppler points
    after the fliplr of the map's Doppler rows."""
    import torch
    from passiveradar_torch.detect.measurements import _linspace
    nf, nr = cfg.num_doppler_cells, cfg.num_range_cells + 1
    d = torch.tensor(cfg.max_doppler_actual, dtype=torch.float32)
    r = torch.tensor(cfg.max_range_actual, dtype=torch.float32)
    rpts = _linspace(r, torch.zeros(()), nr)
    dpts = _linspace(-d, d, nf)
    return float(rpts[cell[1]]), float(dpts[nf - 1 - cell[0]])


def strong_target(cfg):
    """The strong target's map cell (432, 153) on the tracker's axes."""
    return tracker_point(cfg, STRONG_CELL)


def confirmed_near(status, est, point):
    """(frame, slot) of every confirmed track within the confirmed gate
    (4 km, 20 Hz) of ``point``; status (F, N), est (F, N, 2)."""
    return [(int(f), int(i)) for f, i in zip(*np.where(status == 2))
            if abs(est[f, i, 0] - point[0]) < 4
            and abs(est[f, i, 1] - point[1]) < 20]


def kernel_counters():
    """The five kernels' launch counters by the kernels line's names (the
    ones a replayed graph adds to)."""
    from passiveradar_torch.ops.graphs import counters
    return counters()


def zero_counts():
    for c in kernel_counters().values():
        c.launches = 0


def read_counts() -> dict:
    return {name: c.launches for name, c in kernel_counters().items()}


def synced_ms(torch, fn):
    """fn() once, host clock with the card synchronised on both sides:
    (its result, milliseconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def kernel_device_ms(torch, fn, name: str, runs: int = 20,
                     attempts: int = 3) -> float:
    """Mean device milliseconds of the kernels whose name holds ``name``
    over ``runs`` calls of fn, from torch.profiler's device events (the
    host's share of each call left out). A trace in which the profiler
    recorded none of them (it drops events, ROADMAP §C) is taken again, up
    to ``attempts`` traces."""
    fn()
    for _ in range(attempts):
        t = trace(torch, lambda: [fn() for _ in range(runs)])
        rows = [r for r in t.get("by_name", []) if name in r["name"]]
        if rows:
            return sum(r["ms"] for r in rows) / sum(r["launches"]
                                                    for r in rows)
    raise AssertionError(f"the profiler recorded no {name} in {attempts} "
                         f"traces: {t}")


def tracker_scene(channels, frames, nf, nr, seed):
    """(channels, frames, nf, nr) maps: noise and, in each channel, three
    point targets drifting in Doppler, the last gone after half the frames
    (its track coasts and dies), away from the zeroed rows and columns."""
    rng = np.random.default_rng(seed)
    x = (rng.random((channels, frames, nf, nr)) * 0.2 + 1.0).astype(
        np.float32)
    for c in range(channels):
        for t in range(frames):
            for j, row in enumerate((0.1, 0.3, 0.75)[:3 if t < frames // 2
                                                     else 2]):
                x[c, t, int(row * nf) + 2 * c + t // 4,
                  nr // 5 + (nr // 5) * j + 5 * c] = 60.0 - 10 * j
    return x


def tracker_tables_agree(tt, got, want) -> dict:
    """The kernel's history against the plain version's (TRACKER_TOL):
    the discrete state equal, the float leaves' largest difference."""
    got, want = tt.to_host(got), tt.to_host(want)
    discrete = all(np.array_equal(got[k], want[k])
                   for k in ("status", "lifetime", "history"))
    consts = all(np.array_equal(got["kalman"][k], want["kalman"][k])
                 for k in ("F1", "F2", "Q", "H", "R"))
    errs, within = {}, True
    for k, (atol, rtol) in TRACKER_TOL.items():
        g = got[k] if k in got else got["kalman"][k]
        w = want[k] if k in want else want["kalman"][k]
        errs[k] = float(np.max(np.abs(g - w)))
        within &= bool(np.all(np.abs(g - w) <= atol + rtol * np.abs(w)))
    return dict(discrete_equal=discrete and consts, within_tol=within,
                max_abs_err=max(errs.values()), max_abs_err_by_leaf=errs,
                live_slots=int((want["status"] > 0).sum()),
                confirmed_slots=int((want["status"] == 2).sum()))


def tracker_inputs(torch, dev, cfg):
    """The tracker kernel's inputs at the FM stream's shape (C = 1, K =
    cfg.candidate_budget, the main path's 16-frame LS CFAR stack) and the
    wideband stream's (C = 8 channels, K = 384, tracker_scene): the CFAR
    frames, extent, K, the candidates of the 16 frames, TRACKER_SLOTS free
    tables, the tables that FRAMES - 4 plain frames left (live) and the
    next frame's candidates (one); and the FM CFAR stack."""
    from passiveradar_torch.cli.plot import cfar_stack
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.detect import trackers as tt
    from passiveradar_torch.detect.measurements import get_measurements
    from passiveradar_torch.io.writers import load_maps
    from passiveradar_torch.ops.cfar import cfar_2d

    n = TRACKER_SLOTS
    fm = torch.from_numpy(np.moveaxis(cfar_stack(load_maps(cfg), device=dev),
                                      2, 0).copy()).to(dev)[None]
    wcfg = derive_config(WIDE)
    scene = torch.from_numpy(tracker_scene(
        8, FRAMES, wcfg.num_doppler_cells, wcfg.num_range_cells + 1,
        seed=3)).to(dev)
    wide = cfar_2d(scene.flatten(0, 1), 18, 4).reshape(scene.shape)
    out = {}
    for name, c_cfg, frames in (("fm", cfg, fm), ("wideband", wcfg, wide)):
        extent = torch.tensor((c_cfg.max_doppler_actual,
                               c_cfg.max_range_actual), device=dev)
        k = c_cfg.candidate_budget
        cand, valid = get_measurements(frames, extent, k)
        free = tt.init_tracks(n, dev, cand.shape[0])
        lead = FRAMES - 4
        live = tt._map(lambda a: a[-1].contiguous(),
                       tt.multitarget_step_plain(free, cand[:, :lead],
                                                 valid[:, :lead], n))
        one = (cand[:, lead:lead + 1].contiguous(),
               valid[:, lead:lead + 1].contiguous())
        out[name] = dict(frames=frames, extent=extent, k=k, cand=cand,
                         valid=valid, free=free, live=live, one=one)
    return out, fm


def phase_tracker_kernel(torch, dev, cfg):
    """The tracker-step kernel (csrc/tracker.cu) against its plain version
    on the same card candidates, 10 tracks: at the FM stream's shape (C = 1,
    K = cfg.candidate_budget) on the main path's 16-frame LS CFAR stack,
    and at the wideband stream's (C = 8 channels, K = 384) on
    tracker_scene; each over the 16 frames from free tables (T = 16) and
    for one frame from the tables that 12 plain frames left (T = 1). Then
    the whole step (batched get_measurements and one launch) under
    torch.cuda.set_sync_debug_mode("error") at both shapes, its kernel
    launches from the profiler (at most TRACKER_MAX_LAUNCHES for the 8
    channels), and the times: the kernel's device time from the profiler
    (a step at T = 1; T = 16, and µs a slot over its frames), the same from
    CUDA events around one graph of 100 launches, the kernel call with its
    host side and the whole step by CUDA events, the plain step by the
    host clock; the bound; the shared-memory limits at the FM shape (the
    most tracks at its K, the most K at 10 tracks); and candidate
    extraction's peak working memory on long FM stacks
    (extraction_memory), which must not grow with the stack. Returns the
    kernels line's row."""
    from passiveradar_torch.detect import tracker_kernel as trk
    from passiveradar_torch.detect import trackers as tt

    n = TRACKER_SLOTS
    inputs, fm = tracker_inputs(torch, dev, cfg)
    shapes = {}
    for name, x in inputs.items():
        frames, extent, k = x["frames"], x["extent"], x["k"]
        cand, valid, free, live, one = (x["cand"], x["valid"], x["free"],
                                        x["live"], x["one"])
        c, lead = cand.shape[0], FRAMES - 4
        checks = dict(
            T16=tracker_tables_agree(
                tt, trk.multitarget_step_kernel(free, cand, valid, n),
                tt.multitarget_step_plain(free, cand, valid, n)),
            T1=tracker_tables_agree(
                tt, trk.multitarget_step_kernel(live, *one, n),
                tt.multitarget_step_plain(live, *one, n)))
        frame = frames[:, lead].contiguous()

        def step(table=live, frame=frame, extent=extent, k=k):
            return tt.multitarget_step(table, frame, extent, n, k)

        step()                                    # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches = trace(torch, step)["kernels"]
        ms = dict(
            kernel=kernel_device_ms(
                torch, lambda: trk.multitarget_step_kernel(live, *one, n),
                "tracker_kernel"),
            kernel_T16=kernel_device_ms(
                torch, lambda: trk.multitarget_step_kernel(free, cand, valid,
                                                           n),
                "tracker_kernel"),
            kernel_graph=graph_launch_ms(
                torch, lambda: trk.multitarget_step_kernel(live, *one, n)),
            kernel_T16_graph=graph_launch_ms(
                torch, lambda: trk.multitarget_step_kernel(free, cand, valid,
                                                           n)),
            kernel_call=cuda_ms(torch, lambda: trk.multitarget_step_kernel(
                live, *one, n), 50),
            step=cuda_ms(torch, step, 20),
            plain=float(np.median([synced_ms(
                torch, lambda: tt.multitarget_step_plain(live, *one, n))[1]
                for _ in range(3)])))
        table_bytes = c * n * 110 * 4
        # the kernel reads each candidate's range and Doppler and its valid
        # byte (not its strength), and the table in and out
        nbytes = 2 * table_bytes + c * (2 * k * 4 + k)
        # a slot's gates over every candidate, ~16 float operations a
        # candidate, and its Kalman algebra, ~400
        ops = c * n * (16.0 * k + 400.0)
        bound_ms, bound_by = flops_bound(nbytes, ops)
        shapes[name] = dict(
            C=c, T=FRAMES, K=k, n_tracks=n, checks=checks,
            step_launches=launches, ms=ms,
            us_per_slot_T16=ms["kernel_T16"] * 1e3 / (FRAMES * n),
            us_per_slot_T16_graph=ms["kernel_T16_graph"] * 1e3 / (FRAMES * n),
            bytes=nbytes, ops=ops, bound_ms=bound_ms, bound_by=bound_by,
            bound_share=bound_ms / ms["kernel"])
    memory = extraction_memory(torch, fm[0], cfg)
    emit(dict(phase="tracker_kernel", tol=TRACKER_TOL,
              max_launches=TRACKER_MAX_LAUNCHES, sync_debug="error",
              extraction_memory=memory,
              shared_memory=trk.shared_memory_limits(shapes["fm"]["K"], n,
                                                     dev.index),
              **shapes))
    if memory["chunked"]["8"]["working_bytes"] > \
            1.05 * memory["chunked"]["2"]["working_bytes"]:
        raise AssertionError(f"candidate extraction's working memory grows "
                             f"with the stack: {memory}")
    for name, r in shapes.items():
        for label, chk in r["checks"].items():
            if not (chk["discrete_equal"] and chk["within_tol"]
                    and chk["live_slots"] > 0):
                raise AssertionError(f"tracker kernel {name} {label}: {chk}")
    if shapes["wideband"]["step_launches"] > TRACKER_MAX_LAUNCHES:
        raise AssertionError(f"tracker step: "
                             f"{shapes['wideband']['step_launches']} "
                             f"launches for 8 channels")
    r = shapes["fm"]
    return dict(name="multitarget_step", route="cuda",
                source="passiveradar_torch/csrc/tracker.cu",
                replaces="passiveradar_tpu/detect/trackers.py:189",
                launches=None,
                max_abs_err=max(c["max_abs_err"] for s in shapes.values()
                                for c in s["checks"].values()),
                ms=r["ms"]["kernel"], plain_ms=r["ms"]["plain"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=None)


def extraction_memory(torch, frames, cfg):
    """Peak device memory of get_measurements on long FM stacks made by
    repeating ``frames``: stacks of 2 and 8 chunks of
    measurements.CHUNK_BYTES, and the 2-chunk stack in one pass (the chunk
    size lifted above it). ``working_bytes`` is the peak above what was
    allocated before the call, less the outputs: what the extraction needs
    on top of the stack, which chunks keep from growing with its length."""
    from passiveradar_torch.detect import measurements as tm

    chunk = tm.CHUNK_BYTES
    per_frame = frames[0].numel() * 4
    extent = torch.tensor((cfg.max_doppler_actual, cfg.max_range_actual),
                          device=frames.device)
    k = cfg.candidate_budget

    def peak(n_chunks):
        t = n_chunks * chunk // per_frame
        stack = frames.repeat(-(-t // len(frames)), 1, 1)[:t].contiguous()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = tm.get_measurements(stack, extent, k)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        out_bytes = sum(o.numel() * o.element_size() for o in out)
        return dict(frames=t, stack_bytes=t * per_frame, peak_bytes=extra,
                    working_bytes=extra - out_bytes,
                    working_over_stack=(extra - out_bytes) / (t * per_frame))

    chunked = {str(n): peak(n) for n in (2, 8)}
    try:
        tm.CHUNK_BYTES = 1 << 62
        one_pass = peak(2)
    finally:
        tm.CHUNK_BYTES = chunk
    return dict(chunk_bytes=chunk, chunked=chunked, one_pass_2=one_pass)


def phase_postprocess(torch, dev, cfg):
    """The 16-frame FM maps that cli.process wrote (phase_main_path) through
    the post-processing chain on the card, each step timed per frame (host
    clock, card synchronised; the loops' kernel launches per frame from a
    traced run): load_maps, cfar_stack, multitarget_tracker (N_TRACKS
    tracks, cfg.candidate_budget), simple_target_tracker (strict per
    cfg.strict_frame_parity) and the display frames of iter_display_frames
    over LazyCFAR(AbsMapStack). A confirmed multitarget track must sit at
    the strong target by frame 9 and the simple tracker must hold it, locked
    and within SIMPLE_CELLS cells, over the last SIMPLE_LAST frames. The
    card's CFAR stack is held against the CPU's, and both trackers on the
    card's CFAR stack against the CPU's. Then, where matplotlib imports,
    cli.plot --mode frames, cli.track_multi --mode plot and
    cli.track_simple --mode plot run on the card in a work directory;
    where it does not, the two track CLIs' ``track`` (all but the drawing)
    runs on the card and must give the same tracks. Returns the kernels'
    launch counts over the phase's card work (set to 0 just before it)."""
    from passiveradar_torch.cli.plot import LazyCFAR, cfar_stack
    from passiveradar_torch.cli.track_multi import N_TRACKS
    from passiveradar_torch.detect.trackers import (multitarget_tracker,
                                                    simple_target_tracker,
                                                    to_host)
    from passiveradar_torch.io.writers import AbsMapStack, load_maps
    from passiveradar_torch.viz.render import iter_display_frames

    zero_counts()
    xambg, load_ms = synced_ms(torch, lambda: load_maps(cfg))
    f = xambg.shape[2]
    cfar_stack(xambg, device=dev)            # the first call sets cuDNN up
    cf, cfar_ms = synced_ms(torch, lambda: cfar_stack(xambg, device=dev))
    extent = (cfg.max_doppler_actual, cfg.max_range_actual)

    def multi(device):
        return to_host(multitarget_tracker(
            cf, extent, N_TRACKS, k_max=cfg.candidate_budget,
            frames_last=True, device=device))

    def simple(device):
        return to_host(simple_target_tracker(
            cf, cfg.max_range_actual, cfg.max_doppler_actual,
            frames_last=True, strict=cfg.strict_frame_parity, device=device))

    def display():
        with AbsMapStack(cfg) as stack:
            return sum(1 for _ in iter_display_frames(
                LazyCFAR(stack, device=dev), device=dev))

    ms, launches = {}, {}
    for name, fn in (("multitarget_tracker", lambda: multi(dev)),
                     ("simple_target_tracker", lambda: simple(dev)),
                     ("display", display)):
        fn()                                  # warm
        out, t = synced_ms(torch, fn)
        ms[name] = t / f
        launches[name] = trace(torch, fn)["kernels"] / f
        if name == "multitarget_tracker":
            hist = out
        elif name == "simple_target_tracker":
            shist = out
        else:
            shown = out

    strong = strong_target(cfg)
    weak = tracker_point(cfg, WEAK_CELL)
    hits = confirmed_near(hist["status"], hist["estimate"], strong)
    weak_hits = confirmed_near(hist["status"], hist["estimate"], weak)
    first = min(fr for fr, _ in hits) if hits else None
    cell = (STRONG_CELL[1], cfg.num_doppler_cells - 1 - STRONG_CELL[0])
    lock = shist["lock_mode"][:, 2] == 1
    idx = shist["meas_idx"]
    last = [dict(frame=i, locked=bool(lock[i]), meas_idx=idx[i].tolist(),
                 estimate=shist["estimate"][i].tolist())
            for i in range(f - SIMPLE_LAST, f)]
    simple_held = all(r["locked"] and abs(r["meas_idx"][0] - cell[0])
                      <= SIMPLE_CELLS and abs(r["meas_idx"][1] - cell[1])
                      <= SIMPLE_CELLS for r in last)

    # card against the CPU: CFAR on the same maps, trackers on the same CFAR
    cf_cpu = cfar_stack(xambg, device="cpu")
    cfar_rel = float(np.max(np.abs(cf - cf_cpu) / (np.abs(cf_cpu) + 1e-30)))
    hist_cpu, shist_cpu = multi("cpu"), simple("cpu")
    parity = dict(
        cfar_max_rel=cfar_rel,
        multi_status_equal=bool(np.array_equal(hist["status"],
                                               hist_cpu["status"])),
        multi_estimate_max_abs=float(np.max(np.abs(
            hist["estimate"] - hist_cpu["estimate"]))),
        simple_lock_equal=bool(np.array_equal(shist["lock_mode"],
                                              shist_cpu["lock_mode"])),
        simple_estimate_max_abs=float(np.max(np.abs(
            shist["estimate"] - shist_cpu["estimate"]))))

    rendered = None
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        # the CLIs' own tracking (their split from the drawing) on the card
        from passiveradar_torch.cli import track_multi, track_simple
        same = dict(
            track_multi=bool(np.array_equal(
                track_multi.track(cfg, device=dev)[1]["status"],
                hist["status"])),
            track_simple=bool(np.array_equal(
                track_simple.track(cfg, device=dev)[1]["lock_mode"],
                shist["lock_mode"])))
        parity["cli_track_equal"] = same
        if not all(same.values()):
            raise AssertionError(f"postprocess: the CLIs' track() {same}")
    else:
        rendered = render_clis(os.path.join(WORK, "fm.yaml"))
    launches_run = read_counts()

    emit(dict(phase="postprocess", frames=f, maps_shape=list(xambg.shape),
              n_tracks=N_TRACKS, candidate_budget=cfg.candidate_budget,
              strict=cfg.strict_frame_parity,
              ms_per_frame=dict(load_maps=load_ms / f,
                                cfar_stack=cfar_ms / f, **ms),
              launches_per_frame=launches, display_frames=shown,
              strong_target_km_hz=strong,
              first_confirmed_frame_at_strong=first,
              weak_target_km_hz=weak,
              confirmed_near_weak=sorted({fr for fr, _ in weak_hits}),
              confirmed_tracks_last_frame=[
                  [int(i), float(hist["estimate"][-1, i, 0]),
                   float(hist["estimate"][-1, i, 1])]
                  for i in np.where(hist["status"][-1] == 2)[0]],
              simple_strong_cell=list(cell), simple_last_frames=last,
              card_vs_cpu=parity, matplotlib=rendered is not None,
              rendered=rendered, kernel_launches=launches_run))
    if first is None or first > 9:
        raise AssertionError(f"postprocess: no confirmed track at {strong} "
                             f"by frame 9 (first: {first})")
    if not simple_held:
        raise AssertionError(f"postprocess: the simple tracker does not "
                             f"hold {cell}: {last}")
    if shown != f:
        raise AssertionError(f"postprocess: {shown} display frames of {f}")
    if not (cfar_rel <= 1e-5 and parity["multi_status_equal"]
            and parity["simple_lock_equal"]
            and parity["multi_estimate_max_abs"] <= 1e-3
            and parity["simple_estimate_max_abs"] <= 1e-3):
        raise AssertionError(f"postprocess: card vs CPU {parity}")
    return launches_run


def render_clis(cfg_path) -> dict:
    """cli.plot --mode frames, cli.track_multi --mode plot and
    cli.track_simple --mode plot on the card, in a work directory of their
    own (they write into the working directory): what each wrote."""
    from passiveradar_torch.cli.plot import main as plot_main
    from passiveradar_torch.cli.track_multi import main as multi_main
    from passiveradar_torch.cli.track_simple import main as simple_main

    out_dir = os.path.join(WORK, "render")
    os.makedirs(out_dir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        t0 = time.perf_counter()
        plot_main(["--config", cfg_path, "--mode", "frames"])
        plot_s = time.perf_counter() - t0
        multi_main(["--config", cfg_path, "--mode", "plot"])
        simple_main(["--config", cfg_path, "--mode", "plot"])
        done = dict(plot_pngs=len([n for n in os.listdir("IMG")
                                   if n.endswith(".png")]),
                    plot_s=plot_s,
                    multitarget_plot=os.path.exists("MULTITARGET_PLOT.png"),
                    tracker_plot=os.path.exists("TRACKER_PLOT.png"))
    finally:
        os.chdir(cwd)
    if not (done["plot_pngs"] == FRAMES and done["multitarget_plot"]
            and done["tracker_plot"]):
        raise AssertionError(f"postprocess CLIs wrote {done}")
    return done


def wideband_breakdown(torch, dev, cfg, ref, srv, route):
    """Where one wideband push's time goes, on a processor warmed by three
    pushes: channelize, clean (the LS canceller of every channel), CAF,
    CFAR and the trackers' steps, each timed alone by CUDA events (host
    launch gaps included), the whole push, and the trackers' kernel
    launches under torch.profiler."""
    from passiveradar_torch.ops.cfar import cfar_2d
    from passiveradar_torch.wideband import (WidebandStreamingProcessor,
                                             channel_caf, channel_clean,
                                             channel_inputs)
    sp = WidebandStreamingProcessor(cfg, device=dev)
    with route():
        for _ in range(3):
            sp.push(ref, srv)
        rc, sc = channel_inputs(ref[None], srv[None], cfg)
        clean = channel_clean(rc, sc, cfg)
        maps = channel_caf(rc, clean, cfg)
        mag = maps.abs()
        cf = cfar_2d(mag, *sp.cfar_kernel)
        ms = dict(
            channelize=cuda_ms(torch, lambda: channel_inputs(
                ref[None], srv[None], cfg), 5, warmup=1),
            clean=cuda_ms(torch, lambda: channel_clean(rc, sc, cfg), 5,
                          warmup=1),
            caf=cuda_ms(torch, lambda: channel_caf(rc, clean, cfg), 5,
                        warmup=1),
            cfar=cuda_ms(torch, lambda: cfar_2d(mag, *sp.cfar_kernel), 5,
                         warmup=1),
            tracker=cuda_ms(torch, lambda: sp.track(cf), 5, warmup=1),
            push=cuda_ms(torch, lambda: sp.push(ref, srv), 5, warmup=1))
        launches = trace(torch, lambda: sp.track(cf))["kernels"]
    return dict(stage_ms=ms, tracker_kernel_launches=launches)


@contextlib.contextmanager
def recorded_pushes(cls):
    """Context: every result that ``cls.push`` returns, in order, appended
    to the list it yields (the call itself unchanged)."""
    pushes, push = [], cls.push

    def recording(self, *a, **kw):
        res = push(self, *a, **kw)
        pushes.append(res)
        return res

    cls.push = recording
    try:
        yield pushes
    finally:
        cls.push = push


def replay_tracks(cfg, pushes) -> dict:
    """Each channel's streamed track tables (full-detail pushes) against
    multitarget_tracker on the CPU over the CFAR frames the same pushes
    returned: statuses and lifetimes equal in every frame, estimates
    within 1e-3 of the CPU's."""
    from passiveradar_torch.detect.trackers import (multitarget_tracker,
                                                    to_host)
    out = {}
    for k in cfg.wideband_channel_select:
        streamed = {key: np.stack([r[k].tracks[key] for r in pushes])
                    for key in ("status", "lifetime", "estimate")}
        cpu = to_host(multitarget_tracker(
            np.stack([r[k].cfar for r in pushes]),
            (cfg.max_doppler_actual, cfg.max_range_actual),
            streamed["status"].shape[1], k_max=cfg.candidate_budget,
            frames_last=False, device="cpu"))
        out[k] = dict(
            status_equal=bool(np.array_equal(streamed["status"],
                                             cpu["status"])),
            lifetime_equal=bool(np.array_equal(streamed["lifetime"],
                                               cpu["lifetime"])),
            estimate_max_abs=float(np.max(np.abs(streamed["estimate"]
                                                 - cpu["estimate"]))))
    return out


def near_echo(status, est, point, cells) -> list:
    """Slots of the confirmed tracks whose estimate lies within
    ECHO_GATE_CELLS of ``cells`` (the tracker's range and Doppler cell)
    of ``point``; status (N,), est (N, 2)."""
    return [int(i) for i in np.where(status == 2)[0]
            if abs(est[i, 0] - point[0]) <= ECHO_GATE_CELLS * cells[0]
            and abs(est[i, 1] - point[1]) <= ECHO_GATE_CELLS * cells[1]]


def wide_capture(tag="WB"):
    """The wideband scene's WIDE_CPIS-CPI zarr capture in WORK (written
    the first time): its params (maps to <tag>), config and the seconds
    its writing took (0 when it was there)."""
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io.synthetic import write_wideband_capture

    params = dict(WIDE, input_file=os.path.join(WORK, "wb_capture.zarr"),
                  output_fname=os.path.join(WORK, tag),
                  range_doppler_map_ftype="zarr", num_frames=WIDE_CPIS)
    cfg = derive_config(params)
    t0 = time.perf_counter()
    if not os.path.exists(params["input_file"]):
        write_wideband_capture(
            params["input_file"], cfg, WIDE_CPIS, seed=11,
            delay_samples=WIDE_DELAY * cfg.wideband_channels,
            doppler_hz=WIDE_DOPPLER_CELLS * cfg.doppler_cell_width)
    return params, cfg, time.perf_counter() - t0


def phase_wideband(torch, dev):
    """bench_wideband.py's DVB-T-class band (8 MS/s in K = 8 channels of
    1 MHz, 0.25 s CPI: 262,144 samples a channel, 2^21 a CPI; 60 km,
    256 Hz; every channel selected), WIDE_CPIS CPIs written as a zarr store
    with a station in each channel and one echo: cli.wideband --integrate
    (the echo's cell the argmax of every CPI of every channel stack and of
    the integrated stack; CPI/s), then cli.stream on cuFFT and under
    PASSIVERADAR_PALLAS_FFT=1 (in every channel a confirmed track within
    ECHO_GATE_CELLS of the echo's cell, and every channel's streamed track
    tables equal to the tracker replayed on the CPU over the same CFAR
    frames; push latency; each run's launch counts, set to 0 just before
    it), each push broken down by stage, and one CPI of wideband_frames on
    the card, on cuFFT and on the fused FFT, against the CPU and against
    each other. Returns the launch counts of the three runs."""
    import yaml

    from passiveradar_torch.cli.stream import main as stream_main
    from passiveradar_torch.cli.wideband import main as wideband_main
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io import zarr_min
    from passiveradar_torch.io.hdf5 import CaptureReader
    from passiveradar_torch.wideband import (WidebandStreamingProcessor,
                                             channel_path, integrated_path,
                                             wideband_frames)

    params, cfg, gen_s = wide_capture()
    k = cfg.wideband_channels
    cfg_path = os.path.join(WORK, "wb.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(params, fh)
    nf, r = cfg.num_doppler_cells, cfg.num_range_cells
    cell = (nf // 2 - WIDE_DOPPLER_CELLS, r - WIDE_DELAY)

    def argmax_misses(stack):
        return [fr for fr in range(stack.shape[2])
                if np.unravel_index(np.argmax(np.abs(stack[:, :, fr])),
                                    stack.shape[:2]) != cell]

    zero_counts()
    t0 = time.perf_counter()
    n = wideband_main(["--config", cfg_path, "--integrate",
                       "--batch-frames", str(WIDE_BATCH)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    process_launches = read_counts()
    misses = {}
    for ch in cfg.wideband_channel_select:
        bad = argmax_misses(np.asarray(zarr_min.open(channel_path(cfg, ch),
                                                     mode="r")))
        if bad:
            misses[ch] = bad
    bad = argmax_misses(np.asarray(zarr_min.open(integrated_path(cfg),
                                                 mode="r")))
    if bad:
        misses["integrated"] = bad

    reader = CaptureReader(cfg, estimate_offset=False, device=dev)
    ref_np, srv_np = reader.read_iq_frames(0, WIDE_BATCH)
    reader.close()
    ref = torch.from_numpy(ref_np).to(dev)
    srv = torch.from_numpy(srv_np).to(dev)
    batch_ms = cuda_ms(torch, lambda: wideband_frames(ref, srv, cfg), 3,
                       warmup=1)
    emit(dict(phase="wideband_process", cpis=n, channels=k,
              samples_per_channel=cfg.cpi_samples,
              maps_shape=[nf, r + 1], echo_cell=list(cell),
              capture_gen_s=gen_s, wall_s=wall, cpi_per_s=n / wall,
              batch_frames=WIDE_BATCH,
              batch_ms=batch_ms, batch_cpi_per_s=WIDE_BATCH / batch_ms * 1e3,
              realtime_cpi_per_s=1 / cfg.frame_interval,
              launches=process_launches, argmax_misses=misses))
    # one clutter stage a batch, the Levinson kernel its only launch
    if n != WIDE_CPIS or misses or process_launches != dict(
            mix_regroup_matmul=0, nlms_filter_pallas=0, fft_fused=0,
            multitarget_step=0,
            levinson_first_col=-(-WIDE_CPIS // WIDE_BATCH)):
        raise AssertionError(f"cli.wideband: {n} CPIs, argmax misses "
                             f"{misses}, launches {process_launches}")

    target = tracker_point(cfg, cell)
    # the tracker's cell sizes at the echo: one range column, one Doppler row
    cells = (abs(tracker_point(cfg, (cell[0], cell[1] + 1))[0] - target[0]),
             abs(tracker_point(cfg, (cell[0] + 1, cell[1]))[1] - target[1]))
    launches_by_run = dict(wideband_process=process_launches)
    for fused in (False, True):
        route = fused_fft if fused else contextlib.nullcontext
        with route(), recorded_pushes(WidebandStreamingProcessor) as pushes:
            zero_counts()
            res = stream_main(["--config", cfg_path])
            torch.cuda.synchronize()
            launches = read_counts()
        lat = np.asarray(res["push_ms"])
        hits, last = {}, {}
        for ch, table in res["tracks"].items():
            status = np.asarray(table["status"])
            est = np.asarray(table["estimate"])
            hits[ch] = near_echo(status, est, target, cells)
            last[ch] = [[int(i), float(est[i, 0]), float(est[i, 1])]
                        for i in np.where(status == 2)[0]]
        replay = replay_tracks(cfg, pushes)
        split = wideband_breakdown(torch, dev, cfg, ref[0], srv[0], route)
        emit(dict(phase="wideband_stream", fused_fft=fused,
                  frames=res["frames"], launches=launches,
                  wall_s=res["seconds"],
                  push_ms_median=float(np.median(lat)),
                  push_ms_max=float(lat.max()),
                  push_ms_steady_median=float(np.median(lat[1:])),
                  push_ms=lat.tolist(),
                  budget_ms=1e3 * cfg.frame_interval,
                  realtime=bool(np.median(lat[1:]) < 1e3 * cfg.frame_interval),
                  echo_km_hz=target, echo_gate_km_hz=[
                      ECHO_GATE_CELLS * c for c in cells],
                  confirmed_at_echo=hits, confirmed_last_frame=last,
                  card_vs_cpu_replay=replay, **split))
        want = dict(mix_regroup_matmul=0, nlms_filter_pallas=0,
                    fft_fused=2 * WIDE_CPIS if fused else 0,
                    multitarget_step=WIDE_CPIS + 1,
                    levinson_first_col=WIDE_CPIS)
        if res["frames"] != WIDE_CPIS or launches != want or \
                len(pushes) != WIDE_CPIS:
            raise AssertionError(f"wideband stream (fused {fused}): frames "
                                 f"{res['frames']}, pushes {len(pushes)}, "
                                 f"launches {launches}")
        if sorted(hits) != list(cfg.wideband_channel_select) or \
                not all(hits.values()):
            raise AssertionError(f"wideband stream (fused {fused}): "
                                 f"confirmed tracks at {target}: {hits}")
        if not all(v["status_equal"] and v["lifetime_equal"]
                   and v["estimate_max_abs"] <= 1e-3
                   for v in replay.values()):
            raise AssertionError(f"wideband stream (fused {fused}): card "
                                 f"vs the CPU's replay {replay}")
        launches_by_run["wideband_stream_fused" if fused
                        else "wideband_stream"] = launches
        del pushes

    # one CPI on the card, on cuFFT and on the fused FFT, against the CPU
    # and against each other
    got = wideband_frames(ref[:1], srv[:1], cfg).cpu().numpy()[0]
    with fused_fft():
        got_fused = wideband_frames(ref[:1], srv[:1], cfg).cpu().numpy()[0]
    want = wideband_frames(ref_np[:1], srv_np[:1], cfg,
                           device="cpu").numpy()[0]

    def against(a, b):
        errs, same = [], []
        for i in range(len(cfg.wideband_channel_select)):
            peak = np.max(np.abs(b[i]))
            errs.append(float(np.max(np.abs(a[i] - b[i])) / peak))
            same.append(bool(np.argmax(np.abs(a[i])) ==
                             np.argmax(np.abs(b[i]))))
        return dict(max_rel_err=max(errs), rel_err_by_channel=errs,
                    argmax_equal=same)

    pairs = dict(cufft_vs_cpu=against(got, want),
                 fused_vs_cpu=against(got_fused, want),
                 fused_vs_cufft=against(got_fused, got))
    emit(dict(phase="wideband_parity", cpis=1, tol=WIDE_TOL, **pairs))
    if not all(all(v["argmax_equal"]) and v["max_rel_err"] <= WIDE_TOL
               for v in pairs.values()):
        raise AssertionError(f"wideband CPI card vs CPU: {pairs}")
    return launches_by_run


def compare_maps(got, want, nan_frames=None):
    """Card vs CPU maps: equal NaN masks; every finite frame within
    CHAIN_TOL of the map peak with its argmax cell equal. Returns (rel err,
    finite frames)."""
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError("card and CPU maps differ in their NaN masks")
    finite = [i for i in range(want.shape[0]) if np.isfinite(want[i]).all()]
    expect = [i for i in range(want.shape[0]) if i not in (nan_frames or ())]
    if finite != expect:
        raise AssertionError(f"finite frames {finite}, expected {expect}")
    g, w = got[finite], want[finite]
    rel = float(np.max(np.abs(g - w)) / np.max(np.abs(w)))
    same = all(np.argmax(np.abs(g[i])) == np.argmax(np.abs(w[i]))
               for i in range(len(finite)))
    if not (rel < CHAIN_TOL and same):
        raise AssertionError(f"card vs CPU maps: rel {rel}, argmax {same}")
    return rel, finite


def phase_nlms_chain_parity(torch, dev):
    """Both NLMS methods, card vs CPU, at the small geometry, with zero
    frames at the batch edges: under 'nlms' the zero frames and their halo
    neighbours are NaN maps on both, under 'nlms_pallas' none is."""
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io.synthetic import Target, synth_capture_arrays
    from passiveradar_torch.ops import nlms_kernel as nk
    from passiveradar_torch.pipeline import frame_phases, process_frames

    nfr = 6
    for method, nan_frames in (("nlms", [0, 1, 4, 5]), ("nlms_pallas", [])):
        cfg = derive_config(dict(TINY, clutter_method=method))
        ref, srv = synth_capture_arrays(cfg, nfr,
                                        targets=(Target(40, 20.0, 0.1),))
        length = cfg.input_chunk_length
        ref = ref[:nfr * length].reshape(nfr, length // 2, 2)
        srv = srv[:nfr * length].reshape(nfr, length // 2, 2)
        ref[[0, -1]] = 0
        srv[[0, -1]] = 0
        ph = frame_phases(cfg, list(range(nfr)))
        before = nk.nlms_filter_batch.launches
        got = process_frames(ref, srv, ph, cfg, device=dev).cpu().numpy()
        if nk.nlms_filter_batch.launches != before + 1:
            raise AssertionError("the small chain did not run the NLMS "
                                 "kernel")
        want = process_frames(ref, srv, ph, cfg, device="cpu").numpy()
        rel, finite = compare_maps(got, want, nan_frames)
        emit(dict(phase="chain_parity", geometry="tiny", frames=nfr,
                  clutter_method=method, zero_frames=[0, nfr - 1],
                  finite_frames=finite, rel_err=rel, argmax_equal=True))


def phase_nlms_fm_parity(torch, dev, params):
    """One FM batch of 3 frames at full width with 'nlms_pallas', card vs
    CPU (the CPU's plain NLMS loop runs all 261,959 steps)."""
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io.hdf5 import CaptureReader
    from passiveradar_torch.pipeline import frame_phases, process_frames

    cfg = derive_config(dict(params, clutter_method="nlms_pallas"))
    nfr = 3
    reader = CaptureReader(cfg, estimate_offset=False, device=dev)
    ref, srv = reader.read_pair_frames(0, nfr)
    reader.close()
    ph = frame_phases(cfg, list(range(nfr)))
    got = process_frames(ref, srv, ph, cfg, device=dev).cpu().numpy()
    t0 = time.perf_counter()
    want = process_frames(ref, srv, ph, cfg, device="cpu").numpy()
    cpu_s = time.perf_counter() - t0
    rel, _ = compare_maps(got, want)
    emit(dict(phase="chain_parity", geometry="fm", frames=nfr,
              clutter_method="nlms_pallas", rel_err=rel, argmax_equal=True,
              cpu_seconds=cpu_s))


def ground_truth_peaks(stack):
    """The strong and the weak target's cells in the mean map of frames
    2..5 (zero-Doppler ridge and then the strong target masked), and the
    mean magnitudes of the weak target's Doppler row at range cells
    118..122."""
    x = np.abs(stack[:, :, 2:6]).mean(2)
    x[504:520, :] = 0                         # the zero-Doppler ridge
    strong = tuple(int(v) for v in np.unravel_index(np.argmax(x), x.shape))
    x[424:440, :] = 0
    weak = tuple(int(v) for v in np.unravel_index(np.argmax(x), x.shape))
    return strong, weak, [float(v) for v in x[672, 118:123]]


def phase_nlms_main_path(torch, params):
    """The FM capture through cli.process with each NLMS method, to its own
    output store; the kernel counts are set to 0 just before each run."""
    import yaml

    from passiveradar_torch.cli.process import main as process_main
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io import zarr_min
    from passiveradar_torch.ops import nlms_kernel as nk
    from passiveradar_torch.ops import resample_kernel as rk

    batches = -(-FRAMES // BATCH)
    stacks, launches = {}, {}
    for method in ("nlms_pallas", "nlms"):
        p = dict(params, clutter_method=method,
                 output_fname=os.path.join(WORK, f"XAMBG_{method}"))
        cfg = derive_config(p)
        cfg_path = os.path.join(WORK, f"{method}.yaml")
        with open(cfg_path, "w") as fh:
            yaml.safe_dump(p, fh)
        rk.mix_regroup_matmul.launches = 0
        nk.nlms_filter_batch.launches = 0
        t0 = time.perf_counter()
        n = process_main(["--config", cfg_path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[method] = dict(
            nlms_filter_batch=nk.nlms_filter_batch.launches,
            mix_regroup_matmul=rk.mix_regroup_matmul.launches)
        if n != FRAMES:
            raise AssertionError(f"{method}: processed {n} of {FRAMES}")
        if launches[method] != dict(nlms_filter_batch=batches,
                                    mix_regroup_matmul=2 * batches):
            raise AssertionError(f"{method}: launches {launches[method]} for "
                                 f"{batches} batches")
        stack = np.asarray(zarr_min.open(cfg.range_doppler_map_fname,
                                         mode="r"))
        if stack.shape != (cfg.num_doppler_cells, cfg.num_range_cells + 1,
                           FRAMES):
            raise AssertionError(f"{method}: bad map stack {stack.shape}")
        nan_frames = [i for i in range(FRAMES)
                      if np.isnan(stack[:, :, i]).any()]
        strong, weak, weak_row = ground_truth_peaks(stack)
        emit(dict(phase="main_path", clutter_method=method, frames=n,
                  batches=batches, wall_s=wall, wall_frames_per_s=n / wall,
                  launches=launches[method], nan_frames=nan_frames,
                  strong_peak=strong, weak_peak=weak,
                  weak_row_cells_118_122=weak_row))
        # 'nlms' divides by uᴴu = 0 in the zero margin before frame 0
        expect_nan = [0] if method == "nlms" else []
        if nan_frames[:1] != expect_nan or (method == "nlms_pallas"
                                            and nan_frames):
            raise AssertionError(f"{method}: NaN map frames {nan_frames}")
        # NLMS leaves the weak echo one range cell later than LS does
        # (PERF.md, PR 2): its residual there is larger at cell 121
        if strong != (432, 153) or weak != (672, 121):
            raise AssertionError(f"{method}: peaks {strong}, {weak} != "
                                 "(432, 153), (672, 121)")
        stacks[method] = stack
    # frames without a zero window: the two methods run the same arithmetic
    fin = [i for i in range(FRAMES) if np.isfinite(stacks["nlms"][:, :, i]).all()]
    a, b = stacks["nlms"][:, :, fin], stacks["nlms_pallas"][:, :, fin]
    same = float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
    emit(dict(phase="main_path_methods", finite_frames_nlms=len(fin),
              rel_diff_nlms_vs_nlms_pallas=same))
    if same > 1e-6:
        raise AssertionError(f"'nlms' and 'nlms_pallas' differ by {same} "
                             "where no window is zero")
    return launches["nlms_pallas"]["nlms_filter_batch"]


def phase_main_path(torch):
    import yaml

    from passiveradar_torch.cli.process import main as process_main
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io import zarr_min
    from passiveradar_torch.io.synthetic import Target, write_synth_capture

    os.makedirs(WORK, exist_ok=True)
    # zarr directory stores for the capture and the maps: they need no
    # package beyond numpy (the card's host may lack h5py)
    params = dict(FM, input_file=os.path.join(WORK, "fm_capture.zarr"),
                  output_fname=os.path.join(WORK, "XAMBG_T"),
                  range_doppler_map_ftype="zarr",
                  num_frames=FRAMES, frame_batch=BATCH)
    cfg = derive_config(params)
    t0 = time.perf_counter()
    write_synth_capture(params["input_file"], cfg, FRAMES,
                        targets=(Target(200, 40.0, 0.05),
                                 Target(500, -80.0, 0.03)), seed=7)
    gen_s = time.perf_counter() - t0
    cfg_path = os.path.join(WORK, "fm.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(params, fh)

    batches = -(-FRAMES // BATCH)
    zero_counts()
    t0 = time.perf_counter()
    n = process_main(["--config", cfg_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["mix_regroup_matmul"]
    if n != FRAMES:
        raise AssertionError(f"processed {n} of {FRAMES} frames")
    # the clutter stage's Levinson kernel: once a batch, whether the batch
    # ran eager (the graph's warm-up) or as a replay
    if launches < 2 * batches or counts["nlms_filter_pallas"] or \
            counts["fft_fused"] or counts["levinson_first_col"] != batches:
        raise AssertionError(f"launches {counts} for {batches} batches")

    stack = np.asarray(zarr_min.open(cfg.range_doppler_map_fname, mode="r"))
    if stack.shape != (cfg.num_doppler_cells, cfg.num_range_cells + 1,
                       FRAMES) or not np.all(np.isfinite(stack)):
        raise AssertionError(f"bad map stack {stack.shape}")
    strong, weak, weak_row = ground_truth_peaks(stack)
    emit(dict(phase="main_path", clutter_method="ls_multiple", frames=n,
              batches=batches, weak_row_cells_118_122=weak_row,
              capture_gen_s=gen_s, wall_s=wall, wall_frames_per_s=n / wall,
              launches=counts, strong_peak=strong, weak_peak=weak))
    if strong != (432, 153) or weak != (672, 120):
        raise AssertionError(f"ground truth peaks {strong}, {weak} != "
                             "(432, 153), (672, 120)")
    return params, cfg, counts


H5_FIXTURE = os.path.join("tests", "data", "make_h5py_fixture.py")
H5_READ_TURNS = 2        # AbsMapStack passes over the 16 frames, each format


@contextlib.contextmanager
def subset_only():
    """The port's HDF5 backend is io/hdf5_min.py inside the block, whether
    or not h5py is installed (only the one sys.modules entry changes)."""
    from passiveradar_torch.io import hdf5_min, writers
    saved = sys.modules.get("h5py", mock.sentinel.absent)
    sys.modules["h5py"] = None
    try:
        if writers.hdf5_backend() is not hdf5_min:
            raise AssertionError("the HDF5 backend is not hdf5_min")
        yield
    finally:
        if saved is mock.sentinel.absent:
            del sys.modules["h5py"]
        else:
            sys.modules["h5py"] = saved


def h5py_fixture_check() -> dict:
    """tests/data/h5py_fixture.h5, written by h5py, read by hdf5_min: every
    dataset equal to what its seed regenerates in numpy (deflate + shuffle
    and a partly written chunked stack included)."""
    from passiveradar_torch.io import hdf5_min
    spec = importlib.util.spec_from_file_location(
        "make_h5py_fixture", os.path.join(ROOT, H5_FIXTURE))
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    want = fx.fixture_arrays()
    with hdf5_min.File(fx.PATH) as f:
        equal = {key: bool(np.array_equal(f[key][...], arr)
                           and f[key].dtype == arr.dtype)
                 for key, arr in want.items()}
        done = int(f["/xambg"].attrs["frames_done"])
    out = dict(datasets=equal, frames_done=done,
               bytes=os.path.getsize(fx.PATH))
    if not all(equal.values()) or done != fx.FRAMES_DONE:
        raise AssertionError(f"h5py fixture read wrong: {out}")
    return out


def same_tree(got, want) -> bool:
    """Nested dicts of arrays equal leaf by leaf (NaN equal to NaN)."""
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            same_tree(got[k], want[k]) for k in want)
    got, want = np.asarray(got), np.asarray(want)
    return bool(np.array_equal(got, want,
                               equal_nan=want.dtype.kind in "fc"))


def phase_hdf5(torch, params, cfg):
    """The main path with the default HDF5 maps on an HDF5 capture, through
    io/hdf5_min.py (the card's host has no h5py; blocked here if it has):
    the main path's capture (read back from its zarr store) written as .h5
    by io/synthetic._write_capture (s); cli.process with
    range_doppler_map_ftype hdf5, its launches (set to 0 just before it),
    the ground-truth peaks and the stack against the main path's zarr stack
    (bit-equal: the same card and kernels); wall frames/s against the zarr
    capture's in turns (zarr, hdf5, hdf5, zarr); --resume from
    frames_done = 4 and a two-part cli.concat, each bit-equal to the
    uninterrupted stack; AbsMapStack ms a stored frame, HDF5 against zarr
    in turns; the committed h5py fixture; cli.track_multi's tracker on the
    merged HDF5 stack, equal to its tracks on the zarr stack. Returns the
    launches of the first HDF5 cli.process run."""
    import yaml

    from passiveradar_torch.cli import concat, track_multi
    from passiveradar_torch.cli.process import main as process_main
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io import hdf5_min, zarr_min
    from passiveradar_torch.io.synthetic import _write_capture
    from passiveradar_torch.io.writers import AbsMapStack, MapWriter

    t_phase = time.perf_counter()
    h5py_installed = importlib.util.find_spec("h5py") is not None
    zarr_stack = np.asarray(zarr_min.open(cfg.range_doppler_map_fname,
                                          mode="r"))
    batches = -(-FRAMES // BATCH)
    p = {k: v for k, v in params.items() if k != "range_doppler_map_ftype"}
    p.update(input_file=os.path.join(WORK, "fm_capture.h5"),
             output_fname=os.path.join(WORK, "XAMBG_H"))
    hcfg = derive_config(p)
    if hcfg.range_doppler_map_ftype != "hdf5":
        raise AssertionError("the default map format is not hdf5")
    h5_yaml = os.path.join(WORK, "fm_h5.yaml")
    with open(h5_yaml, "w") as fh:
        yaml.safe_dump(p, fh)
    z_yaml = os.path.join(WORK, "fm_zarr_turns.yaml")
    with open(z_yaml, "w") as fh:
        yaml.safe_dump(dict(params, output_fname=os.path.join(WORK,
                                                              "XAMBG_ZT")),
                       fh)

    def read_h5(path):
        with hdf5_min.File(path) as f:
            d = f["/xambg"]
            return d[...], int(d.attrs["frames_done"]), d.chunks

    with subset_only():
        ref, srv = (np.asarray(zarr_min.open(os.path.join(
            params["input_file"], key.strip("/")), mode="r"))
            for key in (cfg.input_ref_path, cfg.input_srv_path))
        t0 = time.perf_counter()
        _write_capture(p["input_file"], hcfg, ref, srv, None, np.float32)
        write_s = time.perf_counter() - t0
        del ref, srv
        wall, launches = dict(zarr=[], hdf5=[]), None
        for fmt in ("zarr", "hdf5", "hdf5", "zarr"):
            zero_counts()
            t0 = time.perf_counter()
            n = process_main(["--config", h5_yaml if fmt == "hdf5"
                              else z_yaml])
            torch.cuda.synchronize()
            wall[fmt].append(n / (time.perf_counter() - t0))
            if n != FRAMES:
                raise AssertionError(f"{fmt}: processed {n} of {FRAMES}")
            if fmt == "hdf5" and launches is None:
                launches = read_counts()
                stack, done, chunks = read_h5(hcfg.range_doppler_map_fname)
        strong, weak, _ = ground_truth_peaks(stack)
        bit_equal = bool(np.array_equal(stack, zarr_stack))
        max_diff = float(np.max(np.abs(stack - zarr_stack)))

        with hdf5_min.File(hcfg.range_doppler_map_fname, "a") as f:
            f["/xambg"][:, :, 4:] = 0
            f["/xambg"].attrs["frames_done"] = 4
        zero_counts()
        t0 = time.perf_counter()
        n_resume = process_main(["--config", h5_yaml, "--resume"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        resume_launches = read_counts()
        resumed, resumed_done, _ = read_h5(hcfg.range_doppler_map_fname)
        resume_equal = bool(np.array_equal(resumed, stack))

        t0 = time.perf_counter()
        for pid, (s, n) in enumerate(((0, BATCH), (BATCH, FRAMES - BATCH))):
            w = MapWriter(hcfg, n, f"{hcfg.output_fname}.part{pid}.hdf5")
            w.write(np.moveaxis(stack[:, :, s:s + n], 2, 0), 0)
            w.close()
        parts_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        merged_n = concat.main(["--config", h5_yaml])
        concat_s = time.perf_counter() - t0
        merged, merged_done, _ = read_h5(hcfg.range_doppler_map_fname)
        concat_equal = bool(np.array_equal(merged, stack))

        read_ms = dict(zarr=[], hdf5=[])
        for fmt in ("zarr", "hdf5") * H5_READ_TURNS:
            with AbsMapStack(cfg if fmt == "zarr" else hcfg) as st:
                for f in range(FRAMES):
                    t0 = time.perf_counter()
                    frame = st[:, :, f:f + 1]
                    read_ms[fmt].append((time.perf_counter() - t0) * 1e3)
                    if frame.shape != stack.shape[:2] + (1,):
                        raise AssertionError(f"{fmt} frame {frame.shape}")
        fixture = h5py_fixture_check()
        t0 = time.perf_counter()
        _, h5_tracks = track_multi.track(hcfg)
        track_s = time.perf_counter() - t0
    _, zarr_tracks = track_multi.track(cfg)
    tracks_equal = same_tree(h5_tracks, zarr_tracks)
    med = {k: float(np.median(v)) for k, v in read_ms.items()}
    out = dict(
        phase="hdf5", h5py_installed=h5py_installed, backend="hdf5_min",
        frames=FRAMES, batches=batches, capture_write_s=write_s,
        capture_bytes=os.path.getsize(p["input_file"]),
        wall_frames_per_s=wall,
        wall_frames_per_s_median={k: float(np.median(v))
                                  for k, v in wall.items()},
        launches=launches, strong_peak=strong, weak_peak=weak,
        frames_done=done, chunks=list(chunks),
        bit_equal_to_zarr_stack=bit_equal, max_abs_diff_to_zarr=max_diff,
        resume=dict(frames=n_resume, s=resume_s, launches=resume_launches,
                    frames_done=resumed_done, bit_equal=resume_equal),
        concat=dict(frames=merged_n, parts_write_s=parts_s, s=concat_s,
                    frames_done=merged_done, bit_equal=concat_equal),
        read_ms_per_frame_median=med,
        read_ms_per_frame=read_ms, fixture=fixture,
        track_multi=dict(s=track_s, tracks_equal_to_zarr=tracks_equal),
        phase_s=time.perf_counter() - t_phase)
    emit(out)
    if launches["mix_regroup_matmul"] < 2 * batches or \
            launches["nlms_filter_pallas"] or launches["fft_fused"]:
        raise AssertionError(f"hdf5 cli.process launches {launches}")
    if (strong, weak) != (STRONG_CELL, WEAK_CELL):
        raise AssertionError(f"hdf5 ground truth peaks {strong}, {weak}")
    if not bit_equal or done != FRAMES or \
            chunks != (cfg.num_doppler_cells, cfg.num_range_cells + 1, 1):
        raise AssertionError(f"hdf5 stack: bit-equal {bit_equal} (largest "
                             f"difference {max_diff}), frames_done {done}, "
                             f"chunks {chunks}")
    if not (resume_equal and resumed_done == FRAMES == n_resume
            and resume_launches["mix_regroup_matmul"] > 0):
        raise AssertionError(f"hdf5 --resume: {out['resume']}")
    if not (concat_equal and merged_done == FRAMES == merged_n):
        raise AssertionError(f"hdf5 cli.concat: {out['concat']}")
    if not tracks_equal:
        raise AssertionError("cli.track_multi on the HDF5 stack differs "
                             "from the zarr stack's tracks")
    return launches


def phase_steady(torch, dev, cfg):
    """The steady-state FM batch (BATCH + 2 frames, device-resident): what
    run_capture runs now, the batch graph (pipeline.process_frames), and
    beside it the eager chain by stage (the LS stage its own graph, as in
    the eager chain of process_frames' warm-up), in turns (stages, graph,
    graph, stages), STEADY_RUNS each, CUDA events; peak memory of the
    eager chain; the graph pools kept; then one traced eager batch and the
    preprocess stage alone."""
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.ops import graphs

    f = BATCH + 2
    ref, srv, ph, _, _ = fm_batch(torch, dev, cfg)
    for _ in range(2):
        pl._process_frames_impl(ref, srv, ph, cfg)
        pl.process_frames(ref, srv, ph, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stages = dict(preprocess=[], clutter=[], caf=[], total=[])
    graph = []

    def by_stage():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        r = pl._preprocess_impl(ref, ph, cfg)
        s = pl._preprocess_impl(srv, ph, cfg)
        ev[1].record()
        s_clean = pl._clutter_impl(r, s, cfg)
        ev[2].record()
        maps = pl._caf_batch_impl(r, s_clean, cfg)
        ev[3].record()
        torch.cuda.synchronize()
        stages["preprocess"].append(ev[0].elapsed_time(ev[1]))
        stages["clutter"].append(ev[1].elapsed_time(ev[2]))
        stages["caf"].append(ev[2].elapsed_time(ev[3]))
        stages["total"].append(ev[0].elapsed_time(ev[3]))
        return maps

    def graphed():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        maps = pl.process_frames(ref, srv, ph, cfg)
        ev[1].record()
        torch.cuda.synchronize()
        graph.append(ev[0].elapsed_time(ev[1]))
        return maps

    for i in range(STEADY_RUNS):
        for fn in ((by_stage, graphed) if i % 2 == 0 else
                   (graphed, by_stage)):
            maps = fn()
    if tuple(maps.shape) != (f, cfg.num_doppler_cells,
                             cfg.num_range_cells + 1):
        raise AssertionError(f"steady-state maps {tuple(maps.shape)}")
    ms = float(np.median(graph))
    emit(dict(phase="steady_state", clutter_method=cfg.clutter_method,
              buffer_frames=f, valid_frames=BATCH,
              runs=STEADY_RUNS, order="stages, graph, graph, stages",
              ms_per_batch_median=ms, frames_per_s=BATCH / ms * 1e3,
              ms_per_batch_runs=graph,
              eager_ms_per_batch_median=float(np.median(stages["total"])),
              stage_ms_median={k: float(np.median(v))
                               for k, v in stages.items()},
              stage_ms_runs=stages,
              max_memory_allocated=torch.cuda.max_memory_allocated(),
              # a replay allocates only its output: the graphs' private
              # pools are reserved memory
              memory_reserved=torch.cuda.memory_reserved(),
              graph_pools={f"{g['kind']} {g['key']}": g["pool_bytes"]
                           for g in graphs.cache_info()}))
    profile_batch(torch, pl, ref, srv, ph, cfg)


def trace(torch, fn) -> dict:
    """fn() once under torch.profiler: the host wall time to its end, the
    device kernels launched, their busy time over the span from the first
    kernel's start to the last one's end (the idle share is the rest), and
    the kernels by name, heaviest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return dict(traced_wall_ms=wall_ms, kernels=0,
                    note="the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy = sum(b - a for a, b in merged(spans))
    span = spans[-1][1] - spans[0][0]
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    out = dict(traced_wall_ms=wall_ms, kernels=len(kernels),
               device_busy_ms=busy / 1e3, device_span_ms=span / 1e3,
               idle_share=1.0 - busy / span,
               by_name=[dict(name=k[:80], ms=t / 1e3, launches=c)
                        for k, (t, c) in sorted(by_name.items(),
                                                key=lambda kv: -kv[1][0])])
    stages = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name == "capture.stage")
    if stages:
        # kernels only: a stage's own chunk copies and memsets are not the
        # previous batch running
        runs = sorted((e.time_range.start, e.time_range.end) for e in kernels
                      if not e.name.startswith(("Memcpy", "Memset")))
        out["kernel_ms_in_stage"] = [
            sum(max(0, min(b, s1) - max(a, s0)) for a, b in merged(runs))
            / 1e3 for s0, s1 in stages]
    return out


def merged(spans) -> list:
    """Sorted (start, end) spans with the overlapping ones joined."""
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_batch(torch, pl, ref, srv, ph, cfg):
    """One traced batch (the heaviest kernels), then the preprocess stage
    alone (both channels, every kernel)."""
    t = trace(torch, lambda: pl._process_frames_impl(ref, srv, ph, cfg))
    if "by_name" in t:
        t["top"] = t.pop("by_name")[:8]
    emit(dict(phase="profile", clutter_method=cfg.clutter_method,
              fused_fft=bool(os.environ.get(FUSED_FFT_ENV)), **t))
    from passiveradar_torch.ops import resample_kernel as rk
    before = rk.mix_regroup_matmul.launches
    t = trace(torch, lambda: (pl._preprocess_impl(ref, ph, cfg),
                              pl._preprocess_impl(srv, ph, cfg)))
    # the wrapper's count: the trace may record fewer of the ctypes launches
    emit(dict(phase="profile_preprocess", clutter_method=cfg.clutter_method,
              input_dtype=str(ref.dtype), shape=list(ref.shape),
              mix_regroup_launches=rk.mix_regroup_matmul.launches - before,
              **t))


def alt_params(params, impl, solver, short_filt, tag):
    """The FM parameters with another canceller and CAF, writing to their
    own map store."""
    return dict(params, clutter_impl=impl, clutter_solver=solver,
                caf_short_filt=short_filt,
                output_fname=os.path.join(WORK, f"XAMBG_{tag}"))


def compare_to(got, want):
    """(max |got − want| over the peak |want|, argmax equal in every
    frame) for (F, doppler, range) map stacks."""
    rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    same = all(np.argmax(np.abs(got[i])) == np.argmax(np.abs(want[i]))
               for i in range(want.shape[0]))
    return rel, same


def phase_cancellers(torch, dev, params):
    """One device-resident FM batch (BATCH + 2 halo frames) through every
    clutter_impl × clutter_solver: the clutter stage as the pipeline runs
    it (a replayed CUDA graph) against the eager stage (eager_vs_graph: ms
    in turns, the replay bit-equal to eager, peak memory, the graph's pool
    and capture seconds), and each map stack (the boxcar CAF) against
    carry/levinson's on the card (ALT_TOL of the peak, argmax equal in
    every frame); then one 3-frame FM batch with coupled + gs_dense + the
    flattop CAF, the card against the CPU under the same bound."""
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io.hdf5 import CaptureReader
    from passiveradar_torch.ops import clutter
    from passiveradar_torch.ops.clutter import IMPLS, SOLVERS

    base = derive_config(params)
    reader = CaptureReader(base, estimate_offset=False, device=dev)
    f = BATCH + 2
    ref_np, srv_np = reader.read_pair_frames(0, f)
    reader.close()
    ph = torch.from_numpy(pl.frame_phases(base, list(range(f)))).to(dev)
    r = pl._preprocess_impl(torch.from_numpy(ref_np).to(dev), ph, base)
    s = pl._preprocess_impl(torch.from_numpy(srv_np).to(dev), ph, base)
    rows, base_maps, bad = [], None, []
    for impl in IMPLS:
        for solver in SOLVERS:
            cfg = derive_config(alt_params(params, impl, solver, True, "x"))
            args = (r, s, cfg.num_range_cells, cfg.IF_sample_rate,
                    cfg.clutter_doppler_bins)
            g = eager_vs_graph(
                torch, lambda args=args, impl=impl, solver=solver:
                clutter.ls_filter_multiple(*args, impl=impl, solver=solver),
                lambda cfg=cfg: pl._clutter_impl(r, s, cfg),
                clutter_key(*args, solver=solver, impl=impl))
            clean = pl._clutter_impl(r, s, cfg)
            maps = pl._caf_batch_impl(r, clean, cfg).cpu().numpy()
            del clean
            if base_maps is None:       # IMPLS[0], SOLVERS[0]: carry, levinson
                base_maps = maps
            rel, same = compare_to(maps, base_maps)
            ok = bool(np.all(np.isfinite(maps)) and rel < ALT_TOL and same
                      and g["bit_equal"])
            row = dict(impl=impl, solver=solver,
                       clutter_ms_median=g["ms_median"]["graph"],
                       eager_ms_median=g["ms_median"]["eager"],
                       clutter_ms_runs=g["ms_runs"]["graph"],
                       eager_ms_runs=g["ms_runs"]["eager"],
                       graph_bit_equal=g["bit_equal"],
                       graph_rel_diff=g["rel_diff_over_peak"],
                       peak_bytes_eager=g["peak_bytes_eager"],
                       peak_bytes_replay=g["peak_bytes_replay"],
                       pool_bytes=g["pool_bytes"], warmup_s=g["warmup_s"],
                       capture_s=g["capture_s"],
                       launches_a_replay=g["launches_a_replay"],
                       rel_err_vs_carry_levinson=rel, argmax_equal=same)
            rows.append(row)
            emit(dict(phase="cancellers", buffer_frames=f, **row))
            if not ok:
                bad.append(row)
    if bad:
        raise AssertionError(f"cancellers against carry/levinson: {bad}")

    # one 3-frame FM batch, coupled + gs_dense + flattop, card vs CPU
    cfg = derive_config(alt_params(params, "coupled", "gs_dense", False, "x"))
    nfr = 3
    ph3 = pl.frame_phases(cfg, list(range(nfr)))
    got = pl.process_frames(ref_np[:nfr], srv_np[:nfr], ph3, cfg,
                            device=dev).cpu().numpy()
    t0 = time.perf_counter()
    want = pl.process_frames(ref_np[:nfr], srv_np[:nfr], ph3, cfg,
                             device="cpu").numpy()
    cpu_s = time.perf_counter() - t0
    rel, same = compare_to(got, want)
    emit(dict(phase="cancellers_parity", geometry="fm", frames=nfr,
              clutter_impl="coupled", clutter_solver="gs_dense",
              caf_short_filt=False, rel_err=rel, argmax_equal=same,
              tol=ALT_TOL, cpu_seconds=cpu_s))
    if not (np.all(np.isfinite(got)) and rel < ALT_TOL and same):
        raise AssertionError(f"coupled/gs_dense/flattop card vs CPU: rel "
                             f"{rel}, argmax {same}")
    return rows


def phase_main_path_alt(torch, dev, params):
    """The FM capture through cli.process with clutter_impl: coupled,
    clutter_solver: gs_dense and caf_short_filt: false, on the card: every
    kernel's launches (counted from 0 just before the run), the
    ground-truth peaks, then the flattop CAF stage of one device-resident
    batch against the boxcar's (median ms, peak memory)."""
    import yaml

    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.cli.process import main as process_main
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io import zarr_min
    from passiveradar_torch.io.hdf5 import CaptureReader

    p = alt_params(params, "coupled", "gs_dense", False, "alt")
    cfg = derive_config(p)
    cfg_path = os.path.join(WORK, "alt.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(p, fh)
    batches = -(-FRAMES // BATCH)
    zero_counts()
    t0 = time.perf_counter()
    n = process_main(["--config", cfg_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    stack = np.asarray(zarr_min.open(cfg.range_doppler_map_fname, mode="r"))
    finite = bool(np.all(np.isfinite(stack)))
    strong, weak, weak_row = ground_truth_peaks(stack)

    # the CAF stage of one batch: flattop against boxcar, in turns
    reader = CaptureReader(cfg, estimate_offset=False, device=dev)
    f = BATCH + 2
    ref_np, srv_np = reader.read_pair_frames(0, f)
    reader.close()
    ph = torch.from_numpy(pl.frame_phases(cfg, list(range(f)))).to(dev)
    r = pl._preprocess_impl(torch.from_numpy(ref_np).to(dev), ph, cfg)
    s = pl._clutter_impl(r, pl._preprocess_impl(
        torch.from_numpy(srv_np).to(dev), ph, cfg), cfg)
    box = derive_config(dict(p, caf_short_filt=True))
    caf = {}
    for c, name in ((cfg, "flattop"), (box, "boxcar"), (box, "boxcar"),
                    (cfg, "flattop")):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        ms = cuda_ms(torch, lambda: pl._caf_batch_impl(r, s, c), 5, warmup=1)
        caf.setdefault(name, dict(ms=[], peak_bytes=0))
        caf[name]["ms"].append(ms)
        caf[name]["peak_bytes"] = max(
            caf[name]["peak_bytes"],
            torch.cuda.max_memory_allocated() - base_mem)
    emit(dict(phase="main_path_alt", clutter_impl="coupled",
              clutter_solver="gs_dense", caf_short_filt=False, frames=n,
              batches=batches, wall_s=wall, wall_frames_per_s=n / wall,
              launches=launches, finite=finite, strong_peak=strong,
              weak_peak=weak, weak_row_cells_118_122=weak_row,
              caf_stage_ms_per_batch=caf, buffer_frames=f))
    if n != FRAMES or not finite:
        raise AssertionError(f"alt cli.process: {n} frames, finite {finite}")
    if launches != dict(mix_regroup_matmul=2 * batches, nlms_filter_pallas=0,
                        fft_fused=0, multitarget_step=0,
                        levinson_first_col=batches):
        raise AssertionError(f"alt cli.process launches {launches}")
    if strong != STRONG_CELL:
        raise AssertionError(f"alt cli.process strong peak {strong}")
    return launches


def phase_stream_alt(torch, dev, params):
    """The FM capture through cli.stream with clutter_impl: segment and
    caf_short_filt: false: launch counts from 0, push latency, a confirmed
    track at the strong target; every streamed CAF against process_frames
    over the same frames (STREAM_TOL); then one wideband CPI (WIDE) with
    the flattop CAF, the card against the CPU (WIDE_TOL)."""
    import yaml

    from passiveradar_torch.cli.stream import main as stream_main
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io.hdf5 import CaptureReader
    from passiveradar_torch.io.synthetic import wideband_capture_arrays
    from passiveradar_torch.pipeline import frame_phases, process_frames
    from passiveradar_torch.streaming import StreamingProcessor
    from passiveradar_torch.wideband import wideband_frames

    p = alt_params(params, "segment", "levinson", False, "stream_alt")
    cfg = derive_config(p)
    cfg_path = os.path.join(WORK, "stream_alt.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(p, fh)
    target = strong_target(cfg)
    zero_counts()
    res = stream_main(["--config", cfg_path, "--detail", "full"])
    torch.cuda.synchronize()
    launches = read_counts()
    status = np.asarray(res["tracks"]["status"])
    est = np.asarray(res["tracks"]["estimate"])
    hits = [int(i) for i in np.where(status == 2)[0]
            if abs(est[i, 0] - target[0]) < 4
            and abs(est[i, 1] - target[1]) < 20]
    lat = np.asarray(res["push_ms"])

    reader = CaptureReader(cfg, estimate_offset=False, device=dev)
    ref_c, srv_c = reader.read_iq_frames(0, FRAMES)
    ref_p, srv_p = reader.read_pair_frames(0, FRAMES)
    reader.close()
    batch = process_frames(ref_p, srv_p, frame_phases(cfg, list(range(FRAMES))),
                           cfg, device=dev).abs().cpu().numpy()
    sp = StreamingProcessor(cfg, device=dev)
    rc = torch.from_numpy(ref_c).to(dev)
    sc = torch.from_numpy(srv_c).to(dev)
    streamed = [sp.push(rc[i], sc[i]) for i in range(FRAMES)]
    streamed = [x for x in streamed if x is not None] + [sp.flush()]
    errs = [float(np.max(np.abs(np.abs(x.caf) - batch[x.frame_index]))
                  / np.max(batch[x.frame_index])) for x in streamed]
    del batch, streamed

    # one wideband CPI with the flattop CAF, card vs CPU
    wcfg = derive_config(dict(WIDE, input_file="", output_fname="wb",
                              caf_short_filt=False))
    wref, wsrv = wideband_capture_arrays(
        wcfg, 1, delay_samples=WIDE_DELAY * wcfg.wideband_channels,
        doppler_hz=WIDE_DOPPLER_CELLS * wcfg.doppler_cell_width, seed=11)
    wref = wref.view(np.complex64)[None]
    wsrv = wsrv.view(np.complex64)[None]
    wgot = wideband_frames(wref, wsrv, wcfg, device=dev).cpu().numpy()[0]
    wwant = wideband_frames(wref, wsrv, wcfg, device="cpu").numpy()[0]
    wide = [compare_to(wgot[i][None], wwant[i][None])
            for i in range(wgot.shape[0])]
    emit(dict(phase="stream_alt", clutter_impl="segment",
              clutter_solver="levinson", caf_short_filt=False,
              frames=res["frames"], launches=launches,
              push_ms_median=float(np.median(lat)),
              push_ms_max=float(lat.max()),
              push_ms_steady_median=float(np.median(lat[1:-1])),
              push_ms=lat.tolist(),
              realtime=bool(lat.max() < 1e3 * cfg.frame_interval),
              strong_target_km_hz=target, confirmed_at_strong_target=hits,
              stream_vs_process_frames_max_rel=max(errs),
              stream_tol=STREAM_TOL,
              wideband_cpi_flattop_rel_by_channel=[w[0] for w in wide],
              wideband_cpi_flattop_argmax_equal=[w[1] for w in wide],
              wide_tol=WIDE_TOL))
    if res["frames"] != FRAMES or launches != dict(
            mix_regroup_matmul=2 * FRAMES, nlms_filter_pallas=0,
            fft_fused=0, multitarget_step=FRAMES + 1,
            levinson_first_col=FRAMES):
        raise AssertionError(f"alt stream: frames {res['frames']}, "
                             f"launches {launches}")
    if not hits:
        raise AssertionError(f"alt stream: no confirmed track at {target}")
    if not max(errs) < STREAM_TOL:
        raise AssertionError(f"alt stream vs process_frames: {errs}")
    if not all(w[1] and w[0] <= WIDE_TOL for w in wide):
        raise AssertionError(f"wideband flattop CPI card vs CPU: {wide}")
    return launches


def phase_ops_rest(torch, dev):
    """The remaining ops at small sizes, each on the card against the port
    on the CPU (OPS_TOL of the peak), with the card's ms per call; gal_jpe
    also per sample."""
    from passiveradar_torch import ops
    from scipy import signal as sps

    rng = np.random.default_rng(9)

    def cn(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    n = 16384
    ref = cn(n)
    srv = (0.8 * np.roll(ref, 3) + 0.1 * cn(n)).astype(np.complex64)
    raw = (1000 * rng.standard_normal(2 * 65536)).astype(np.int16)
    flattop = sps.firwin(10 * 512 + 1, 1.0 / 512, window="flattop")
    x_dec = cn(1 << 18)
    gal_n = 400
    cases = [
        ("ls_filter", dict(n=n, filter_len=32),
         lambda a, b, d: ops.ls_filter(a, b, 32, device=d), (ref, srv)),
        ("ls_filter_svd", dict(n=n, filter_len=32),
         lambda a, b, d: ops.ls_filter_svd(a, b, 32, device=d), (ref, srv)),
        ("ls_filter_toeplitz", dict(n=n, filter_len=32),
         lambda a, b, d: ops.ls_filter_toeplitz(a, b, 32, device=d),
         (ref, srv)),
        ("gal_jpe", dict(n=gal_n, lattice_len=6, delay_line_len=6),
         lambda a, b, d: ops.gal_jpe(a, b, 6, 6, 1e-3, 1e-2, device=d),
         (ref[:gal_n], srv[:gal_n])),
        ("direct_xambg", dict(n=n, range_bins=40, freq_bins=64),
         lambda a, b, d: ops.direct_xambg(a, b, 40, 64, float(n), device=d),
         (ref, srv)),
        ("decimate_taps", dict(n=1 << 18, q=512, taps=len(flattop)),
         lambda a, b, d: ops.decimate_taps(a, flattop, 512, device=d),
         (x_dec, None)),
        ("offset_compensation", dict(n=n, ndec=1, nlag=64),
         lambda a, b, d: ops.offset_compensation(a, b, n, 1, 64, device=d),
         (ref, np.roll(ref, 17))),
        ("channel_preprocessing", dict(n=65536, dec=4),
         lambda a, b, d: ops.channel_preprocessing(a, 4, 5000.0, 262144.0,
                                                   device=d), (raw, None)),
    ]
    bad = []
    for name, shape, fn, (a, b) in cases:
        got = fn(a, b, dev)
        want = fn(a, b, "cpu").numpy()
        ad = torch.from_numpy(a).to(dev)
        bd = None if b is None else torch.from_numpy(b).to(dev)
        iters = 2 if name == "gal_jpe" else 10
        ms = cuda_ms(torch, lambda: fn(ad, bd, None), iters, warmup=1)
        got = got.cpu().numpy()
        rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        row = dict(phase="ops_rest", op=name, shape=shape, ms=ms,
                   rel_err_card_vs_cpu=rel, tol=OPS_TOL)
        if name == "gal_jpe":
            row["us_per_sample"] = ms * 1e3 / (gal_n - 10 - 1)
        emit(row)
        if not (np.all(np.isfinite(got)) and rel < OPS_TOL):
            bad.append(row)
    if bad:
        raise AssertionError(f"ops card vs CPU: {bad}")


def phase_sharded(torch, dev, params):
    """The FM batch (8 + 2 frames, zero-padded to a multiple of the shard
    count) through process_frames_shmap on a mesh of [cuda:0], of [cuda:0,
    cuda:0] and, with more than one card, of every card, for the LS
    canceller and for nlms_pallas: the maps against process_frames on
    cuda:0, the halo exchanges and the kernels' launches of one call
    (counts set to 0 just before it; each shard's two graphs captured on
    its first call), and ms a batch against one device (its batch graph),
    median of SHARD_RUNS, the two run in turns. Returns the launches of the
    two-shard call of each method."""
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io.hdf5 import CaptureReader
    from passiveradar_torch.parallel.halo import local_overlap
    from passiveradar_torch.parallel.mesh import make_mesh

    meshes = [("1x cuda:0", make_mesh(devices=[dev])),
              ("2x cuda:0", make_mesh(devices=[dev, dev]))]
    if torch.cuda.device_count() > 1:
        meshes.append((f"{torch.cuda.device_count()} cards", make_mesh()))
    f = BATCH + 2
    launches = {}
    for method in ("ls_multiple", "nlms_pallas"):
        cfg = derive_config(dict(params, clutter_method=method))
        reader = CaptureReader(cfg, estimate_offset=False, device=dev)
        ref_np, srv_np = reader.read_pair_frames(0, f)
        reader.close()
        ph_np = pl.frame_phases(cfg, list(range(f))).astype(np.float32)
        for label, mesh in meshes:
            n = len(mesh)
            fp = -(-f // n) * n                # frames padded with zeros
            ref = torch.zeros((fp,) + ref_np.shape[1:],
                              dtype=torch.from_numpy(ref_np).dtype)
            srv = torch.zeros_like(ref)
            ph = torch.zeros(fp, dtype=torch.float32)
            ref[:f], srv[:f] = torch.from_numpy(ref_np), \
                torch.from_numpy(srv_np)
            ph[:f] = torch.from_numpy(ph_np)
            ref, srv, ph = ref.to(dev), srv.to(dev), ph.to(dev)
            want = pl._process_frames_impl(ref, srv, ph, cfg)
            zero_counts()
            ex = local_overlap.exchanges
            blocks = pl.process_frames_shmap(ref, srv, ph, cfg, mesh)
            torch.cuda.synchronize()
            counts = read_counts()
            exchanges = local_overlap.exchanges - ex
            got = torch.cat([b.to(dev) for b in blocks])
            rel, same = compare_to(got[:f].cpu().numpy(),
                                   want[:f].cpu().numpy())
            del got, want, blocks
            times = dict(one_device=[], sharded=[])
            for which in ("one_device", "sharded", "sharded", "one_device") \
                    * ((SHARD_RUNS + 1) // 2):
                fn = (lambda: pl.process_frames(ref, srv, ph, cfg)) \
                    if which == "one_device" else \
                    (lambda: pl.process_frames_shmap(ref, srv, ph, cfg, mesh))
                if len(times[which]) < SHARD_RUNS:
                    times[which].append(synced_ms(torch, fn)[1])
            ms = {k: float(np.median(v)) for k, v in times.items()}
            emit(dict(phase="sharded", clutter_method=method, mesh=label,
                      shards=n, buffer_frames=fp, valid_frames=f,
                      rel_err_vs_process_frames=rel, argmax_equal=same,
                      halo_exchanges=exchanges, launches=counts,
                      ms_median=ms, ms_runs=times,
                      sharded_over_one_device=ms["sharded"]
                      / ms["one_device"]))
            want_b2 = n if method == "nlms_pallas" else 0
            if rel > SHARD_TOL or not same or exchanges != 4 or counts != dict(
                    mix_regroup_matmul=2 * n, nlms_filter_pallas=want_b2,
                    fft_fused=0, multitarget_step=0,
                    levinson_first_col=n - want_b2):
                raise AssertionError(
                    f"sharded {method} on {label}: rel {rel}, argmax "
                    f"equal {same}, exchanges {exchanges}, launches "
                    f"{counts}")
            if n == 2:
                launches[method] = counts
            del ref, srv, ph
    return launches


def phase_dispatch_groups(torch, dev, params, want_stack):
    """cli.process --dispatch-groups 2 on the FM capture against the G = 1
    run, in turns (G = 1, 2, 2, 1): the port takes the flag and runs one
    batch a call whatever G is, so each run's maps equal the main path's
    (the largest difference, expected 0; a failure above SHARD_TOL of the
    peak or an argmax that moves), with wall frames/s and every kernel's
    launches of each run (set to 0 just before it, 2 a batch). Then
    pipeline.process_frames_groups on two stacked FM batches against one
    process_frames call each (difference 0) and its launches. Returns the
    launches of the first G = 2 run."""
    import yaml

    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.cli.process import main as process_main
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io import zarr_min
    from passiveradar_torch.io.hdf5 import CaptureReader

    runs, launches = [], None
    batches = -(-FRAMES // BATCH)
    for g in (1, 2, 2, 1):
        p = dict(params, output_fname=os.path.join(WORK, f"XAMBG_G{g}"))
        cfg = derive_config(p)
        cfg_path = os.path.join(WORK, f"groups{g}.yaml")
        with open(cfg_path, "w") as fh:
            yaml.safe_dump(p, fh)
        zero_counts()
        t0 = time.perf_counter()
        n = process_main(["--config", cfg_path, "--dispatch-groups", str(g)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        stack = np.asarray(zarr_min.open(cfg.range_doppler_map_fname,
                                         mode="r"))
        diff = float(np.max(np.abs(stack - want_stack)))
        rel, same = compare_to(np.moveaxis(stack, 2, 0),
                               np.moveaxis(want_stack, 2, 0))
        runs.append(dict(groups=g, frames=n, wall_s=wall,
                         wall_frames_per_s=n / wall, launches=counts,
                         max_abs_diff_vs_main_path=diff, argmax_equal=same))
        if g == 2 and launches is None:
            launches = counts
        if n != FRAMES or rel > SHARD_TOL or not same or counts != dict(
                mix_regroup_matmul=2 * batches, nlms_filter_pallas=0,
                fft_fused=0, multitarget_step=0, levinson_first_col=batches):
            emit(dict(phase="dispatch_groups", runs=runs))
            raise AssertionError(f"--dispatch-groups {g}: {n} frames, max "
                                 f"difference {diff}, launches {counts}")
    # the library's grouped call: frames [0, f) and [FRAMES - f, FRAMES)
    cfg = derive_config(params)
    f = BATCH + 2
    reader = CaptureReader(cfg, estimate_offset=False, device=dev)
    pairs = [reader.read_pair_frames(s0, f) for s0 in (0, FRAMES - f)]
    reader.close()
    refs = torch.from_numpy(np.stack([r for r, _ in pairs])).to(dev)
    srvs = torch.from_numpy(np.stack([s for _, s in pairs])).to(dev)
    phs = torch.from_numpy(np.stack(
        [pl.frame_phases(cfg, list(range(s0, s0 + f)))
         for s0 in (0, FRAMES - f)]).astype(np.float32)).to(dev)
    zero_counts()
    got = pl.process_frames_groups(refs, srvs, phs, cfg, device=dev)
    torch.cuda.synchronize()
    group_counts = read_counts()
    group_diff = max(float(torch.max(torch.abs(
        got[g] - pl._process_frames_impl(refs[g], srvs[g], phs[g], cfg))))
        for g in range(2))
    # one graph of G = 2 batches against two G = 1 replays, in turns: the
    # calls (inputs copied in, maps cloned out) and the bare replays
    from passiveradar_torch.ops import graphs
    singles = [(refs[g], srvs[g], phs[g]) for g in range(2)]
    for x in singles:
        pl.process_frames(*x, cfg)
    pl.process_frames_groups(refs, srvs, phs, cfg, device=dev)
    one_entry = graph_entry(graphs.graph_key("frames", singles[0], cfg, dev))
    two_entry = graph_entry(graphs.graph_key("groups", (refs, srvs, phs), cfg,
                                             dev))
    fns = dict(
        g1_calls_twice=lambda: [pl.process_frames(*x, cfg) for x in singles],
        g2_call=lambda: pl.process_frames_groups(refs, srvs, phs, cfg,
                                                 device=dev),
        g1_replays_twice=lambda: [graphs.replay(one_entry) for _ in range(2)],
        g2_replay=lambda: graphs.replay(two_entry))
    group_ms = {k: [] for k in fns}
    for _ in range(GRAPH_TURNS):
        for pair in (("g1_calls_twice", "g2_call"),
                     ("g1_replays_twice", "g2_replay")):
            for which in pair + pair[::-1]:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                torch.cuda.synchronize()
                ev[0].record()
                fns[which]()
                ev[1].record()
                torch.cuda.synchronize()
                group_ms[which].append(ev[0].elapsed_time(ev[1]))
    del got, refs, srvs, phs, singles, fns
    emit(dict(phase="dispatch_groups", frames=FRAMES, batch_frames=BATCH,
              runs=runs,
              wall_frames_per_s_median={
                  g: float(np.median([r["wall_frames_per_s"] for r in runs
                                      if r["groups"] == g])) for g in (1, 2)},
              process_frames_groups=dict(
                  groups=2, frames=f, max_abs_diff_vs_process_frames=group_diff,
                  launches=group_counts,
                  order="G = 1 twice, G = 2, G = 2, G = 1 twice; x5",
                  ms_median={k: float(np.median(v))
                             for k, v in group_ms.items()},
                  ms_runs=group_ms)))
    if group_diff != 0 or group_counts != dict(
            mix_regroup_matmul=4, nlms_filter_pallas=0, fft_fused=0,
            multitarget_step=0, levinson_first_col=2):
        raise AssertionError(f"process_frames_groups: difference "
                             f"{group_diff}, launches {group_counts}")
    return launches


def phase_profile(torch, params):
    """cli.process --profile DIR on the FM capture: the Chrome trace it
    writes, its size, and whether it names the resampler kernel (it must);
    every kernel's launches of the run (set to 0 just before it)."""
    import yaml

    from passiveradar_torch.cli.process import main as process_main

    p = dict(params, output_fname=os.path.join(WORK, "XAMBG_PROF"))
    cfg_path = os.path.join(WORK, "prof.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(p, fh)
    trace_dir = os.path.join(WORK, "trace")
    zero_counts()
    t0 = time.perf_counter()
    n = process_main(["--config", cfg_path, "--profile", trace_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    traces = sorted(f for f in os.listdir(trace_dir)
                    if f.endswith(".pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"--profile wrote {traces}")
    with open(os.path.join(trace_dir, traces[0])) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    b1 = [e for e in kernels if "mix_regroup_kernel" in e.get("name", "")]
    emit(dict(phase="profile_cli", frames=n, wall_s=wall,
              trace=traces[0],
              trace_bytes=os.path.getsize(os.path.join(trace_dir,
                                                       traces[0])),
              trace_events=len(events), trace_kernels=len(kernels),
              trace_mix_regroup_kernels=len(b1),
              names_mix_regroup_kernel=bool(b1), launches=counts))
    if n != FRAMES or not b1:
        raise AssertionError(f"--profile: {n} frames, the trace names "
                             f"mix_regroup_kernel {len(b1)} times")
    return counts


# one cli.process run in a child process: its kernels' launch counts on
# the last line of its output
CHILD = """
import json, sys
from passiveradar_torch.cli.process import main
from passiveradar_torch.detect import tracker_kernel
from passiveradar_torch.ops import fft_kernel, levinson_kernel, \
    nlms_kernel, resample_kernel
main(sys.argv[1:])
print(json.dumps(dict(
    mix_regroup_matmul=resample_kernel.mix_regroup_matmul.launches,
    nlms_filter_pallas=nlms_kernel.nlms_filter_batch.launches,
    fft_fused=fft_kernel.fft_fused.launches,
    multitarget_step=tracker_kernel.multitarget_step_kernel.launches,
    levinson_first_col=levinson_kernel.levinson_first_col_kernel.launches)))
"""


# STEADY_RUNS device-resident FM batches of process_frames timed in a child
# process of a gloo group (argv: config, rank, count, coordinator), on card
# rank % cards, between two barriers so that the children's timed runs
# overlap: milliseconds of each run on the last line of its output
STEADY_CHILD = """
import json, sys, time, torch
from passiveradar_torch import pipeline as pl
from passiveradar_torch.config import load_config
from passiveradar_torch.io.hdf5 import CaptureReader
from passiveradar_torch.parallel import distributed as dd
cfg, rank, count = load_config(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
dd.init_distributed(sys.argv[4], count, rank)
dev = dd.process_device()
reader = CaptureReader(cfg, estimate_offset=False, device=dev)
f = cfg.frame_batch + 2
ref, srv = (torch.from_numpy(a).to(dev) for a in reader.read_pair_frames(0, f))
ph = torch.from_numpy(pl.frame_phases(cfg, list(range(f)))).to(dev)
for _ in range(2):
    pl._process_frames_impl(ref, srv, ph, cfg)
torch.cuda.synchronize(dev)
if count > 1:
    torch.distributed.barrier()
ms = []
for _ in range(%d):
    t0 = time.perf_counter()
    pl._process_frames_impl(ref, srv, ph, cfg)
    torch.cuda.synchronize(dev)
    ms.append((time.perf_counter() - t0) * 1e3)
if count > 1:
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
print(json.dumps(dict(card=str(dev), ms=ms)))
"""


def run_children(argvs, timeout, code=CHILD):
    """One child process running ``code`` per argv, all started together;
    (wall seconds until the last ends, outputs, the JSON object each
    printed last). Every child is ended before this returns."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code] + argv, cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"child {p.args[3:]} exited "
                                 f"{p.returncode}:\n{out[-4000:]}")
    return wall, outs, [json.loads(o.strip().splitlines()[-1]) for o in outs]


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_multiprocess(torch, params, want_stack):
    """P = max(2, cards) cli.process processes (--num-processes P; on one
    card they share it, else each takes its own) over a gloo group on a
    free local port, MP_FRAMES frames (MP_FRAMES // P each, the remainder
    on the last), then cli.concat; then one process alone on the same
    frames. The part sizes, the merged stack against the first MP_FRAMES
    frames of the main path's, the ground-truth peaks, the wall seconds of
    the group against one process, and the kernels' launches summed over
    the group; then the steady state: STEADY_RUNS device-resident LS
    batches timed in each of P processes at once (STEADY_CHILD) against
    one process alone, as aggregate frames/s. Returns the CLI group's
    launches."""
    import yaml

    from passiveradar_torch.cli.concat import main as concat_main
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io import zarr_min

    p = dict(params, num_frames=MP_FRAMES,
             output_fname=os.path.join(WORK, "XAMBG_MP"))
    cfg = derive_config(p)
    cfg_path = os.path.join(WORK, "mp.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(p, fh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    procs = max(2, torch.cuda.device_count())
    coordinator = f"127.0.0.1:{free_port()}"
    group_wall, outs, counts = run_children(
        [["--config", cfg_path, "--num-processes", str(procs),
          "--process-id", str(i), "--coordinator", coordinator]
         for i in range(procs)], 600)
    parts = [zarr_min.open(f"{cfg.output_fname}.part{i}.zarr",
                           mode="r").shape[2] for i in range(procs)]
    launches = {k: sum(c[k] for c in counts) for k in counts[0]}
    merged_n = concat_main(["--config", cfg_path])
    merged = np.asarray(zarr_min.open(cfg.range_doppler_map_fname, mode="r"))
    rel, same = compare_to(np.moveaxis(merged, 2, 0),
                           np.moveaxis(want_stack[:, :, :MP_FRAMES], 2, 0))
    strong, weak, _ = ground_truth_peaks(merged)
    one = dict(p, output_fname=os.path.join(WORK, "XAMBG_MP1"))
    one_path = os.path.join(WORK, "mp1.yaml")
    with open(one_path, "w") as fh:
        yaml.safe_dump(one, fh)
    one_wall, _, one_counts = run_children([["--config", one_path]], 600)
    # the steady state: an LS batch timed in each of the P processes at
    # once, against one process alone (aggregate frames/s)
    steady = {}
    for n_procs in (1, procs):
        port = f"127.0.0.1:{free_port()}"
        _, _, rows = run_children(
            [[cfg_path, str(i), str(n_procs), port] for i in range(n_procs)],
            600, STEADY_CHILD % STEADY_RUNS)
        med = [float(np.median(r["ms"])) for r in rows]
        steady[n_procs] = dict(
            cards=[r["card"] for r in rows], ms_median=med,
            frames_per_s=float(sum(BATCH / m * 1e3 for m in med)))
    emit(dict(phase="multiprocess", processes=procs,
              cards=torch.cuda.device_count(), frames=MP_FRAMES,
              part_frames=parts, merged_frames=merged_n,
              rel_err_vs_single_process=rel, argmax_equal=same,
              strong_peak=strong, weak_peak=weak,
              group_wall_s=group_wall, one_process_wall_s=one_wall,
              group_over_one=group_wall / one_wall, launches=launches,
              one_process_launches=one_counts[0],
              steady_ls_batch={f"{k} process(es)": v
                               for k, v in steady.items()},
              steady_speedup=steady[procs]["frames_per_s"]
              / steady[1]["frames_per_s"],
              process_lines=[ln for o in outs for ln in o.splitlines()
                             if ln.startswith("[process")]))
    per = MP_FRAMES // procs
    if parts != [per] * (procs - 1) + [MP_FRAMES - per * (procs - 1)] or \
            merged_n != MP_FRAMES or rel > MP_TOL or not same or \
            (strong, weak) != (STRONG_CELL, WEAK_CELL):
        raise AssertionError(f"multiprocess: parts {parts}, merged "
                             f"{merged_n}, rel {rel}, argmax equal {same}, "
                             f"peaks {strong}, {weak}")
    batches = sum(-(-n // BATCH) for n in parts)
    if launches != dict(mix_regroup_matmul=2 * batches, nlms_filter_pallas=0,
                        fft_fused=0, multitarget_step=0,
                        levinson_first_col=batches):
        raise AssertionError(f"multiprocess launches {launches}")
    return launches


def phase_tp_caf(torch, dev):
    """One FM CPI (524,288 samples, 1024 Doppler × 176 range cells, Kaiser
    window; an echo 40 samples late at +20 Hz) through fast_xambg_tp on 2
    and 4 shards of cuda:0 against fast_xambg (TP_TOL of the peak, the
    target's cell), ms each, in turns. No kernel runs on this path."""
    from passiveradar_torch.ops.caf import fast_xambg, fast_xambg_tp, \
        resolve_window
    from passiveradar_torch.parallel.mesh import make_mesh

    n, nf, r = 524288, 1024, 175
    fs = float(n) / 2.0
    gen = torch.Generator(device=dev).manual_seed(5)
    ref = torch.randn(n, dtype=torch.complex64, generator=gen, device=dev)
    t = torch.arange(n, device=dev, dtype=torch.float64) / fs
    rot = torch.exp(2j * math.pi * 20.0 * t).to(torch.complex64)
    srv = 0.05 * torch.roll(ref, 40) * rot + 0.01 * torch.randn(
        n, dtype=torch.complex64, generator=gen, device=dev)
    # the window on the card once, as the pipeline keeps it
    # (pipeline._window_tensor): a window given by name is computed on the
    # host at every call
    win = torch.from_numpy(resolve_window(("kaiser", 5.0), n)).to(dev)
    want = fast_xambg(ref, srv, r, nf, window=win)
    zero_counts()
    rows = []
    for shards in (2, 4):
        mesh = make_mesh(devices=[dev] * shards, axis_name="tp")
        got = torch.cat(fast_xambg_tp(ref, srv, r, nf, mesh, window=win),
                        dim=1)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        fbin, rbin = np.unravel_index(int(got.abs().argmax()), (nf, r + 1))
        ms = dict(tp=[], single=[])
        for which in ("single", "tp", "tp", "single"):
            fn = (lambda: fast_xambg(ref, srv, r, nf, window=win)) \
                if which == "single" else \
                (lambda: fast_xambg_tp(ref, srv, r, nf, mesh, window=win))
            ms[which].append(cuda_ms(torch, fn, 3, warmup=1))
        rows.append(dict(shards=shards, rel_err=rel,
                         cell=[int(fbin), int(rbin)], ms=ms))
        if rel > TP_TOL or rbin != r - 40 or abs(fbin - (nf // 2 - 40)) > 1:
            emit(dict(phase="tp_caf", rows=rows))
            raise AssertionError(f"fast_xambg_tp on {shards} shards: rel "
                                 f"{rel}, cell ({fbin}, {rbin})")
    counts = read_counts()
    emit(dict(phase="tp_caf", samples=n, doppler_cells=nf,
              range_cells=r + 1, tol=TP_TOL, rows=rows, launches=counts))
    return counts


def phase_wideband_shard(torch, dev):
    """wideband_frames_shmap on 2 shards of cuda:0 on phase_wideband's
    batch of WIDE_BATCH CPIs against wideband_frames (WIDE_SHARD_TOL of the
    peak, argmax equal in every channel of every CPI), ms each in turns;
    then cli.wideband --shard on its WIDE_CPIS-CPI capture, the echo the
    argmax of every CPI of every channel; the kernels' launches of both
    (set to 0 just before the first)."""
    import yaml

    from passiveradar_torch.cli.wideband import main as wideband_main
    from passiveradar_torch.io import zarr_min
    from passiveradar_torch.io.hdf5 import CaptureReader
    from passiveradar_torch.parallel.mesh import make_mesh
    from passiveradar_torch.wideband import channel_path, wideband_frames, \
        wideband_frames_shmap

    params, cfg, _ = wide_capture("WB_SHARD")
    reader = CaptureReader(cfg, estimate_offset=False, device=dev)
    ref_np, srv_np = reader.read_iq_frames(0, WIDE_BATCH)
    reader.close()
    ref = torch.from_numpy(ref_np).to(dev)
    srv = torch.from_numpy(srv_np).to(dev)
    mesh = make_mesh(devices=[dev, dev], axis_name="channels")
    zero_counts()
    want = wideband_frames(ref, srv, cfg)
    got = torch.cat(wideband_frames_shmap(ref, srv, cfg, mesh), dim=1)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    g = got.abs().flatten(2).argmax(-1)
    w = want.abs().flatten(2).argmax(-1)
    bad = int((g != w).sum())
    del got, want
    ms = dict(one_device=[], sharded=[])
    for which in ("one_device", "sharded", "sharded", "one_device"):
        fn = (lambda: wideband_frames(ref, srv, cfg)) \
            if which == "one_device" else \
            (lambda: wideband_frames_shmap(ref, srv, cfg, mesh))
        ms[which].append(cuda_ms(torch, fn, 2, warmup=1))
    cfg_path = os.path.join(WORK, "wb_shard.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(params, fh)
    t0 = time.perf_counter()
    n = wideband_main(["--config", cfg_path, "--shard",
                       "--batch-frames", str(WIDE_BATCH)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    nf, r = cfg.num_doppler_cells, cfg.num_range_cells
    cell = (nf // 2 - WIDE_DOPPLER_CELLS, r - WIDE_DELAY)
    misses = {}
    for ch in cfg.wideband_channel_select:
        stack = np.abs(np.asarray(zarr_min.open(channel_path(cfg, ch),
                                                mode="r")))
        bad_cpis = [fr for fr in range(stack.shape[2])
                    if np.unravel_index(np.argmax(stack[:, :, fr]),
                                        (nf, r + 1)) != cell]
        if bad_cpis:
            misses[ch] = bad_cpis
    emit(dict(phase="wideband_shard", shards=2, cpis=WIDE_BATCH,
              channels=cfg.wideband_channels, rel_err=rel, tol=WIDE_SHARD_TOL,
              argmax_diff=bad, ms=ms, cli_cpis=n,
              cli_devices=torch.cuda.device_count(),
              cli_wall_s=wall, cli_cpi_per_s=n / wall, echo_cell=list(cell),
              argmax_misses=misses, launches=counts))
    if rel > WIDE_SHARD_TOL or bad or n != WIDE_CPIS or misses:
        raise AssertionError(f"wideband_shard: rel {rel}, argmax {bad}, "
                             f"{n} CPIs, misses {misses}")
    return counts


def synth_targets():
    from passiveradar_torch.io.synthetic import Target
    return tuple(Target(*t) for t in SYNTH_TARGETS)


def phase_synth_device(torch, dev, cfg):
    """synth_capture_device on the card at the FM geometry, SYNTH_FRAMES
    frames of the main path's scene from seed 7, in both output forms
    (seconds, peak memory; the two forms one stream), the scene's levels,
    and its first BATCH + 2 frames through process_frames (launch counts
    set to 0 just before it): the strong target at STRONG_CELL, the weak
    one reported. Returns (ref, srv, phases, maps, counts)."""
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.io.synthetic import synth_capture_device

    out, secs, peak = {}, {}, {}
    for form in ("interleaved", "complex"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out[form], ms = synced_ms(torch, lambda: synth_capture_device(
            cfg, SYNTH_FRAMES, targets=synth_targets(), seed=7,
            complex_output=form == "complex", device=dev))
        secs[form] = ms / 1e3
        peak[form] = torch.cuda.max_memory_allocated() - base
    ref, srv = out["complex"]
    half = cfg.input_chunk_length // 2
    same = all(torch.equal(torch.view_as_real(c).reshape(i.shape), i)
               for c, i in zip(out["complex"], out["interleaved"]))
    del out
    mean_abs_ref = float(ref.abs().mean())
    srv_power = float((srv.abs() ** 2).mean())
    want_power = 0.5 ** 2 + sum(t[2] ** 2 for t in SYNTH_TARGETS)
    f = BATCH + 2
    ph = torch.from_numpy(pl.frame_phases(cfg, list(range(f)))).to(dev)
    zero_counts()
    maps = pl.process_frames(ref[:f], srv[:f], ph, cfg, device=dev)
    torch.cuda.synchronize()
    counts = read_counts()
    stack = maps.permute(1, 2, 0).cpu().numpy()
    finite = bool(np.isfinite(stack).all())
    strong, weak, _ = ground_truth_peaks(stack)
    emit(dict(phase="synth_device", frames=SYNTH_FRAMES,
              shape=list(ref.shape), seconds=secs,
              peak_memory_bytes=peak, forms_one_stream=same,
              mean_abs_ref=mean_abs_ref, srv_power=srv_power,
              srv_power_expected=want_power, batch_frames=f,
              launches=counts, finite=finite, strong_peak=strong,
              weak_peak=weak, weak_within_1_cell_of=WEAK_CELL,
              weak_within_1_cell=all(abs(a - b) <= 1
                                     for a, b in zip(weak, WEAK_CELL))))
    if (tuple(ref.shape) != (SYNTH_FRAMES, half) or not same
            or abs(mean_abs_ref - 1) > 1e-2
            or abs(srv_power / want_power - 1) > 0.05 or not finite
            or strong != STRONG_CELL
            or counts["mix_regroup_matmul"] != 2):
        raise AssertionError(f"synth_device: shape {tuple(ref.shape)}, one "
                             f"stream {same}, |ref| {mean_abs_ref}, power "
                             f"{srv_power} / {want_power}, finite {finite}, "
                             f"strong {strong}, launches {counts}")
    return ref[:f], srv[:f], ph, maps, counts


def phase_caf_batch(torch, dev, cfg, ref, srv, ph, want):
    """caf_batch on the synth_device batch's preprocessed, cancelled frames
    equals process_frames' maps (difference 0); its ms (CUDA events)."""
    from passiveradar_torch import pipeline as pl
    r_if = pl.preprocess_batch(ref, ph, cfg, device=dev)
    clean = pl.clutter_batch(r_if, pl.preprocess_batch(srv, ph, cfg,
                                                       device=dev),
                             cfg, device=dev)
    zero_counts()
    got = pl.caf_batch(r_if, clean, cfg, device=dev)
    torch.cuda.synchronize()
    counts = read_counts()
    diff = float((got - want).abs().max())
    ms = cuda_ms(torch, lambda: pl.caf_batch(r_if, clean, cfg, device=dev),
                 iters=10)
    emit(dict(phase="caf_batch", frames=int(got.shape[0]),
              max_abs_diff_vs_process_frames=diff, ms=ms, launches=counts))
    if diff != 0 or tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"caf_batch differs from process_frames by "
                             f"{diff}")
    return counts


def phase_preview(torch, dev, cfg):
    """cli.preview's numeric core (preview_arrays) on the main path's FM
    capture, on the card and on the CPU: the offset equal, the PSDs within
    PREVIEW_TOL of the peak in linear power, |xcorr| within PREVIEW_TOL of
    its peak with the argmax equal; the offset search's ms and the core's
    (warm on the card)."""
    from passiveradar_torch.cli.preview import preview_arrays
    from passiveradar_torch.io.hdf5 import CaptureReader

    res, ms, counts = {}, {}, None
    for tag, where in (("card", dev), ("cpu", torch.device("cpu"))):
        reader, off_ms = synced_ms(torch, lambda: CaptureReader(
            cfg, estimate_offset=True, max_offset_lags=50_000,
            device=where))
        if tag == "card":
            preview_arrays(cfg, reader, where)
            zero_counts()
        res[tag], core_ms = synced_ms(
            torch, lambda: preview_arrays(cfg, reader, where))
        if tag == "card":
            counts = read_counts()
        reader.close()
        ms[tag] = dict(offset_search=off_ms, preview_arrays=core_ms)
    got, want = res["card"], res["cpu"]
    rel = {}
    for key in ("raw_psd_ref", "raw_psd_srv", "ch_psd_ref", "ch_psd_srv"):
        g, w = 10 ** (got[key] / 10), 10 ** (want[key] / 10)
        rel[key] = float(np.max(np.abs(g - w)) / np.max(w))
    rel["xcorr"] = float(np.max(np.abs(got["xcorr"] - want["xcorr"]))
                         / np.max(want["xcorr"]))
    argmax = int(np.argmax(got["xcorr"])) - len(got["xcorr"]) // 2
    same = argmax == int(np.argmax(want["xcorr"])) - len(want["xcorr"]) // 2
    emit(dict(phase="preview", offset=dict(card=got["offset"],
                                           cpu=want["offset"]),
              rel_err_card_vs_cpu=rel, xcorr_peak_lag=argmax,
              xcorr_argmax_equal=same, ms=ms, launches=counts,
              shapes={k: list(np.shape(v)) for k, v in got.items()
                      if k != "offset"}))
    if got["offset"] != want["offset"] or not same or \
            max(rel.values()) > PREVIEW_TOL:
        raise AssertionError(f"preview card vs CPU: offsets "
                             f"{got['offset']}, {want['offset']}, rel {rel}, "
                             f"argmax equal {same}")
    return counts


def phase_native():
    """The native ingest helper: built by g++ into the port's csrc/build/
    (the JAX package's native/libpr_io.so untouched), loaded, and its
    int16 conversion and de-multiplexing (int16 and float32) bit-equal to
    numpy at NATIVE_N samples; ms each against numpy's (median of 3)."""
    from passiveradar_torch.io import native

    jax_lib = os.path.join(ROOT, "native", "libpr_io.so")

    def stamp():
        return os.path.getmtime(jax_lib) if os.path.exists(jax_lib) else None

    before = stamp()
    path = native.build_library(force=True)
    loaded = native.library()
    build_dir = os.path.join(ROOT, "passiveradar_torch", "csrc", "build")
    rng = np.random.default_rng(5)
    x16 = rng.integers(-32768, 32767, NATIVE_N, dtype=np.int16)
    x32 = rng.standard_normal(NATIVE_N, dtype=np.float32)
    scale = np.float32(1 / 3)

    def np_demux(x):
        q = (x * scale if x.dtype == np.int16 else x).reshape(-1, 4)
        return (q[:, :2].reshape(-1).view(np.complex64),
                q[:, 2:].reshape(-1).view(np.complex64))

    def median_ms(fn):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            runs.append((time.perf_counter() - t0) * 1e3)
        return out, float(np.median(runs))

    cases = dict(
        i16_to_f32=(lambda: native.i16_to_f32(x16, scale),
                    lambda: x16 * scale),
        demux2_int16=(lambda: native.demux2(x16, scale),
                      lambda: np_demux(x16)),
        demux2_float32=(lambda: native.demux2(x32), lambda: np_demux(x32)))
    rows, equal = {}, True
    for name, (fn, ref_fn) in cases.items():
        got, ms = median_ms(fn)
        want, np_ms = median_ms(ref_fn)
        if name == "i16_to_f32":
            got, want = (got,), (want,)
        same = all(np.array_equal(g, w) for g, w in zip(got, want))
        equal &= same
        rows[name] = dict(bit_equal=same, native_ms=ms, numpy_ms=np_ms)
    after = stamp()
    emit(dict(phase="native", library=path, loaded=loaded, samples=NATIVE_N,
              jax_library_mtime=dict(before=before, after=after), **rows))
    if (path is None or loaded != path
            or os.path.dirname(path) != build_dir or not equal
            or before != after):
        raise AssertionError(f"native: built {path}, loaded {loaded}, "
                             f"bit-equal {equal}, JAX library mtime "
                             f"{before} -> {after}")


def phase_batch_sweep(torch, dev, params):
    """process_frames at SWEEP_WIDTHS frames a batch (+ 2 halo frames) for
    ls_multiple and nlms_pallas, on two device-resident FM captures from
    synth_capture_device (seeds 7 and 8, taken in alternate runs), each
    width its batch graph: each width's maps of the frames it shares with
    the BATCH-frame batch (frames 1..BATCH) within SWEEP_TOL of the peak,
    argmax equal; peak memory of the width's first call (its eager warm-up
    and its capture) and the launches of a replay (counts set to 0 just
    before it); then
    SWEEP_RUNS timed runs of every width (CUDA events), the widths in
    turns. The largest width's footprint is reckoned from the BATCH run's
    and printed before it runs. Returns each method and width's counts."""
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io.synthetic import synth_capture_device

    cfg = derive_config(params)
    n = max(SWEEP_WIDTHS) + 2
    caps = []
    for seed in (7, 8):
        caps.append(synth_capture_device(cfg, n, targets=synth_targets(),
                                         seed=seed, complex_output=True,
                                         device=dev))
    ph = torch.from_numpy(pl.frame_phases(cfg, list(range(n)))).to(dev)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    total = torch.cuda.get_device_properties(dev).total_memory
    launches, rows = {}, []
    for method in ("ls_multiple", "nlms_pallas"):
        mcfg = derive_config(dict(params, clutter_method=method))

        def run(f, cap=0):
            ref, srv = caps[cap]
            return pl.process_frames(ref[:f + 2], srv[:f + 2], ph[:f + 2],
                                     mcfg)

        maps0, peaks, counts = None, {}, {}
        for f in sorted(SWEEP_WIDTHS):
            if f == max(SWEEP_WIDTHS):
                per_frame = (peaks[BATCH] - resident) / (BATCH + 2)
                emit(dict(phase="batch_sweep_reckoning",
                          clutter_method=method, frames=f + 2,
                          resident_bytes=resident,
                          working_bytes_per_frame=per_frame,
                          reckoned_peak_bytes=resident + per_frame * (f + 2),
                          device_bytes=total))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            run(f)                  # this width's graph: warm-up, capture
            torch.cuda.synchronize()
            peaks[f] = torch.cuda.max_memory_allocated()
            zero_counts()
            maps = run(f)
            torch.cuda.synchronize()
            counts[f] = read_counts()
            shared = maps[1:BATCH + 1].cpu().numpy()
            if f == BATCH:
                maps0 = shared
            rel, same = compare_to(shared, maps0)
            want_b2 = 1 if method == "nlms_pallas" else 0
            ok = (rel <= SWEEP_TOL and same and counts[f] == dict(
                mix_regroup_matmul=2, nlms_filter_pallas=want_b2,
                fft_fused=0, multitarget_step=0,
                levinson_first_col=1 - want_b2)
                and bool(torch.isfinite(maps).all()))
            rows.append(dict(clutter_method=method, frames=f,
                             rel_err_vs_batch8=rel, argmax_equal=same,
                             launches=counts[f], peak_memory_bytes=peaks[f],
                             memory_reserved_bytes=torch.cuda.memory_reserved()))
            if not ok:
                raise AssertionError(f"batch_sweep {method} F={f}: rel {rel},"
                                     f" argmax equal {same}, launches "
                                     f"{counts[f]}")
            del maps
        launches[method] = counts
        times = {f: [] for f in SWEEP_WIDTHS}
        for r in range(SWEEP_RUNS):
            order = SWEEP_WIDTHS if r % 2 == 0 else SWEEP_WIDTHS[::-1]
            for f in order:
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                run(f, cap=r % 2)
                ev[1].record()
                torch.cuda.synchronize()
                times[f].append(ev[0].elapsed_time(ev[1]))
        for row in rows:
            if row["clutter_method"] == method:
                ms = float(np.median(times[row["frames"]]))
                row.update(ms_median=ms, ms_runs=times[row["frames"]],
                           frames_per_s=row["frames"] / ms * 1e3)
                emit(dict(phase="batch_sweep", **row))
    del caps
    return launches


def step13(torch, dev, params, cfg) -> dict:
    """The last modules (step 13): synth_capture_device, caf_batch,
    cli.preview's core, the native helper and the batch-width sweep; each
    path's launch counts by name."""
    ref, srv, ph, maps, synth = phase_synth_device(torch, dev, cfg)
    caf = phase_caf_batch(torch, dev, cfg, ref, srv, ph, maps)
    del ref, srv, ph, maps
    preview = phase_preview(torch, dev, cfg)
    phase_native()
    sweep = phase_batch_sweep(torch, dev, params)
    paths = dict(synth_device=synth, caf_batch=caf, preview=preview)
    for method, counts in sweep.items():
        for f, c in counts.items():
            paths[f"batch_sweep_{method}_F{f}"] = c
    return paths


def parallel_phases(torch, dev, params, cfg) -> dict:
    """The sharded, grouped, profiled and multi-process phases (step 12),
    after the main path; each path's launch counts by name."""
    from passiveradar_torch.io import zarr_min
    main_stack = np.asarray(zarr_min.open(cfg.range_doppler_map_fname,
                                          mode="r"))
    sharded = phase_sharded(torch, dev, params)
    return dict(sharded_ls=sharded["ls_multiple"],
                sharded_nlms_pallas=sharded["nlms_pallas"],
                dispatch_groups=phase_dispatch_groups(torch, dev, params,
                                                      main_stack),
                profile_cli=phase_profile(torch, params),
                multiprocess=phase_multiprocess(torch, params, main_stack),
                tp_caf=phase_tp_caf(torch, dev),
                wideband_shard=phase_wideband_shard(torch, dev))


def main_parallel(torch, dev, card, cuda_build) -> int:
    """``--parallel``: the build, the main path and step 12 alone, for a
    run on several cards (the sharded phase then adds a mesh of every
    card, the multi-process phase runs a process a card)."""
    t_start = time.perf_counter()
    for name, b in cuda_build.build(force=True).items():
        emit(dict(phase="build", library=name, seconds=b["seconds"]))
    try:
        params, cfg, _ = phase_main_path(torch)
        parallel = parallel_phases(torch, dev, params, cfg)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    emit(dict(phase="script", seconds=time.perf_counter() - t_start,
              launches_by_path=parallel))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import passiveradar_torch  # noqa: F401
        from passiveradar_torch.config import derive_config
        from passiveradar_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: passiveradar_torch is not importable here: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = smi()
    emit(dict(phase="environment", torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0],
              device=torch.cuda.get_device_name(0),
              device_count=torch.cuda.device_count(), nvidia_smi=card))

    if sys.argv[1:] == ["--parallel"]:
        return main_parallel(torch, dev, card, cuda_build)
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2

    built = cuda_build.build(force=True, variants=tuple(
        ("mix_regroup", v) for v in MR_VARIANTS))
    for name, b in built.items():
        emit(dict(phase="build", library=name,
                  source=f"passiveradar_torch/csrc/{name.split('-')[0]}.cu",
                  seconds=b["seconds"], ptxas=ptxas_summary(b["log"])))

    from passiveradar_torch.ops import resample_kernel as rk
    variant_libs = [(MR_DEFAULTS, rk._library())] + [
        (dict(MR_DEFAULTS, **v), rk.bind(ctypes.CDLL(
            cuda_build.library_path("mix_regroup", v)))) for v in MR_VARIANTS]

    row = phase_kernels(torch, dev, variant_libs)
    row_nlms = phase_nlms_kernels(torch, dev)
    row_fft = phase_fft_kernels(torch, dev)
    phase_chain_parity(torch, dev)
    phase_nlms_chain_parity(torch, dev)
    try:
        params, cfg, main_counts = phase_main_path(torch)
        hdf5 = phase_hdf5(torch, params, cfg)
        row_nlms["launches"] = phase_nlms_main_path(torch, params)
        phase_nlms_fm_parity(torch, dev, params)
        phase_ls_fused(torch, dev, cfg)
        row_lev = phase_levinson_kernel(torch, dev, cfg)
        stream = phase_stream(torch, dev, params)
        row_fft["launches"] = stream["ls_multiple"]["fft_fused"]
        post = phase_postprocess(torch, dev, cfg)
        row_trk = phase_tracker_kernel(torch, dev, cfg)
        wide = phase_wideband(torch, dev)
        phase_steady(torch, dev, cfg)
        phase_ls_route_ab(torch, dev, cfg)
        phase_clutter_graph(torch, dev, cfg)
        phase_batch_graph(torch, dev, params)
        phase_run_capture_trace(torch, dev, params)
        phase_steady(torch, dev,
                     derive_config(dict(params, clutter_method="nlms_pallas")))
        phase_cancellers(torch, dev, params)
        process_alt = phase_main_path_alt(torch, dev, params)
        stream_alt = phase_stream_alt(torch, dev, params)
        phase_ops_rest(torch, dev)
        parallel = parallel_phases(torch, dev, params, cfg)
        last = step13(torch, dev, params, cfg)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    row["launches"] = main_counts["mix_regroup_matmul"]
    row_lev["launches"] = main_counts["levinson_first_col"]
    # every path's own count (set to 0 just before it): the maps that the
    # postprocess phase reads come from the LS cli.process run
    later = dict(process_hdf5=hdf5, postprocess=post, **wide,
                 process_alt=process_alt,
                 stream_alt=stream_alt, **parallel, **last)
    row["launches_by_path"] = dict(process_ls=row["launches"],
                                   stream_ls_fused=stream["ls_multiple"]
                                   ["mix_regroup_matmul"],
                                   stream_nlms_pallas=stream["nlms_pallas"]
                                   ["mix_regroup_matmul"])
    row_nlms["launches_by_path"] = dict(
        process_nlms_pallas=row_nlms["launches"],
        stream_nlms_pallas=stream["nlms_pallas"]["nlms_filter_pallas"])
    row_fft["launches_by_path"] = dict(stream_ls_fused=row_fft["launches"])
    row_trk["launches"] = stream["ls_multiple"]["multitarget_step"]
    row_trk["launches_by_path"] = dict(
        stream_ls_fused=row_trk["launches"],
        stream_nlms_pallas=stream["nlms_pallas"]["multitarget_step"])
    row_lev["launches_by_path"] = dict(
        process_ls=row_lev["launches"],
        stream_ls_fused=stream["ls_multiple"]["levinson_first_col"],
        stream_nlms_pallas=stream["nlms_pallas"]["levinson_first_col"])
    rows = (row, row_nlms, row_fft, row_trk, row_lev)
    for r in rows:
        r["launches_by_path"].update(
            {path: counts[r["name"]] for path, counts in later.items()})
    emit(dict(phase="script", seconds=time.perf_counter() - t_start))
    emit({"kernels": list(rows)})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
