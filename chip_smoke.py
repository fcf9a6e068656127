#!/usr/bin/env python3
"""Build, check and drive the PyTorch port on one CUDA card.

    python3 chip_smoke.py          (from the repository root)

Phases, one JSON line each; any failure exits non-zero:

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: every csrc/*.cu for sm_90a, one nvcc each, all started at once,
   from the checkout, with ptxas' registers and spills;
3. kernels: every CUDA kernel against its plain torch version on the card,
   at the FM shapes and at ragged small ones (the NLMS kernel in both
   zero-window semantics, with a zero run, a ragged tap count and a warm
   start), with times (kernel, plain version, one library call where there
   is one) and the reckoned bound; the NLMS kernel also at the shape of
   bench_nlms.py; then the whole chain on the card against the CPU at a
   small geometry, for the LS and both NLMS clutter methods;
4. main path: an FM broadcast capture (2.4 MS/s, 200 kHz channel, 2 s CPI,
   16 frames, two targets) through ``passiveradar_torch.cli.process`` on
   the card with the LS canceller, then the same capture with
   ``clutter_method: nlms_pallas`` and ``nlms``, each with the kernel
   launch counts of its run (counts set to 0 just before it) and the
   ground-truth peaks of the range-Doppler maps; then one FM batch of 3
   frames with ``nlms_pallas``, card against CPU, at full width;
5. steady state, for the LS and the ``nlms_pallas`` canceller:
   ``process_frames`` on one device-resident FM batch, per stage, with peak
   device memory; then one batch under torch.profiler (kernel launches,
   device busy and idle share, the heaviest kernels).

Then the ``{"kernels": [...]}`` line, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time

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
NLMS_BENCH = dict(B=128, N=262144, filter_len=175, peek=10)  # bench_nlms.py


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def ptxas_summary(log: str) -> list:
    """ptxas -v output → one line per kernel: registers and spills."""
    import re
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        # mangled names are length-prefixed: ...11nlms_kernelILi6E...
        m = re.search(r"Compiling entry function .*?\d([a-z_]+_kernel)ILi(\d+)E",
                      ln)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
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


def phase_kernels(torch, dev):
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
    w = bank.shape[0]
    # complex taps the function needs: the nonzero entries of the bank
    taps = int(np.count_nonzero((bank_ri[:up] != 0) | (bank_ri[up:] != 0)))
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((f, n, 2), generator=gen, device=dev)
    err, peak = check_regroup(torch, rk, x, bank, down, groups, up, pad)

    # ragged small geometry: groups no multiple of the 64-group tile
    up2, down2, n2, f2 = 3, 17, 17 * 140 + 5, 3
    bank2 = rk.pack_bank(torch.randn((2 * up2, 3 * down2), generator=gen,
                                     device=dev), up2)
    x2 = torch.randn((f2, n2, 2), generator=gen, device=dev)
    groups2 = (n2 + 9 - 3 * down2) // down2 + 2
    err2, peak2 = check_regroup(torch, rk, x2, bank2, down2, groups2, up2, 9)

    # the same function as one library call: unfold + complex einsum
    bank_c = torch.view_as_complex(bank)[:, :up]

    def library():
        xc = torch.view_as_complex(x)
        total = (groups - 1) * down + w
        xp = torch.nn.functional.pad(xc, (pad, max(0, total - n - pad)))
        win = xp[:, :total].unfold(-1, w, down)
        return torch.einsum("fgc,cp->fgp", win, bank_c)

    lib_out = library()
    plain = rk.mix_regroup_matmul_plain(x, bank, down, groups, up, pad)
    lib_err = (lib_out - plain).abs().max().item()
    del lib_out, plain

    ms = cuda_ms(torch, lambda: rk.mix_regroup_matmul(x, bank, down, groups,
                                                      up, pad), 20)
    plain_ms = cuda_ms(torch, lambda: rk.mix_regroup_matmul_plain(
        x, bank, down, groups, up, pad), 5)
    library_ms = cuda_ms(torch, library, 5)
    # the same kernel with the bank at the TPU's slab-rounded width, the
    # trailing zero columns kept: what the cut in pack_bank saves
    full = torch.zeros((bank_ri.shape[1],) + tuple(bank.shape[1:]),
                       device=dev)
    full[:w] = bank
    full_ms = cuda_ms(torch, lambda: rk.mix_regroup_matmul(
        x, full, down, groups, up, pad), 20)
    del full
    nbytes = x.numel() * 4 + bank.numel() * 4 + f * groups * up * 8
    flops = 8.0 * f * groups * taps             # 4 FMAs per complex MAC
    flops_run = 8.0 * f * groups * up * w       # zero taps included
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    row = dict(name="mix_regroup_matmul", route="cuda",
               source="passiveradar_torch/csrc/mix_regroup.cu",
               replaces="passiveradar_tpu/ops/resample_pallas.py:162",
               launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=library_ms)
    emit(dict(phase="kernels", shape=dict(F=f, n=n, up=up, down=down, W=w,
                                          W_bank=bank_ri.shape[1],
                                          groups=groups, pad_left=pad),
              max_abs_err=err, peak=peak, rel_err=err / peak,
              ragged=dict(F=f2, n=n2, up=up2, down=down2, groups=groups2,
                          max_abs_err=err2, rel_err=err2 / peak2),
              library_max_abs_err=lib_err, kernel_ms=ms,
              kernel_ms_full_width=full_ms, plain_ms=plain_ms,
              library_ms=library_ms, bytes=nbytes, taps=taps, flops=flops,
              flops_run=flops_run, bound_bytes_ms=t_bytes,
              bound_ops_ms=t_ops, bound_share=max(t_bytes, t_ops) / ms,
              achieved_gbytes_per_s=nbytes / ms / 1e6,
              run_tflops=flops_run / ms / 1e9))
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
        e = (g[~mask] - w[~mask]).abs().max().item()
        p = w[~mask].abs().max().item()
        if not (math.isfinite(e) and e <= NLMS_TOL * p):
            raise AssertionError(f"NLMS kernel disagrees with its plain "
                                 f"version ({kw}): err {e} peak {p}")
        err, peak, nans = max(err, e), max(peak, p), nans + int(mask.sum())
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
    max_err = max(c["max_abs_err"] for c in checks.values())
    check_ms = cuda_ms(torch, lambda: nk.nlms_filter_batch(
        ref, srv, flen, mu), 3, warmup=1)
    plain_ms = cuda_ms(torch, lambda: nk.nlms_filter_batch_plain(
        ref, srv, flen, mu), 1, warmup=0)
    del ref, srv, taps

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

    row = dict(name="nlms_filter_batch", route="cuda",
               source="passiveradar_torch/csrc/nlms.cu",
               replaces="passiveradar_tpu/ops/nlms_pallas.py:157",
               launches=None, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    emit(dict(phase="kernels_nlms", checks=dict(F=f, n=n, m=m, tol=NLMS_TOL,
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
                                    / 1e6)))
    return row


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
    from passiveradar_torch.ops import nlms_kernel as nk
    from passiveradar_torch.ops import resample_kernel as rk

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
    rk.mix_regroup_matmul.launches = 0
    nk.nlms_filter_batch.launches = 0
    t0 = time.perf_counter()
    n = process_main(["--config", cfg_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rk.mix_regroup_matmul.launches
    if n != FRAMES:
        raise AssertionError(f"processed {n} of {FRAMES} frames")
    if launches < 2 * batches or nk.nlms_filter_batch.launches:
        raise AssertionError(f"mix_regroup_matmul launched {launches} times "
                             f"for {batches} batches, nlms "
                             f"{nk.nlms_filter_batch.launches}")

    stack = np.asarray(zarr_min.open(cfg.range_doppler_map_fname, mode="r"))
    if stack.shape != (cfg.num_doppler_cells, cfg.num_range_cells + 1,
                       FRAMES) or not np.all(np.isfinite(stack)):
        raise AssertionError(f"bad map stack {stack.shape}")
    strong, weak, weak_row = ground_truth_peaks(stack)
    emit(dict(phase="main_path", clutter_method="ls_multiple", frames=n,
              batches=batches, weak_row_cells_118_122=weak_row,
              capture_gen_s=gen_s, wall_s=wall, wall_frames_per_s=n / wall,
              launches=dict(mix_regroup_matmul=launches),
              strong_peak=strong, weak_peak=weak))
    if strong != (432, 153) or weak != (672, 120):
        raise AssertionError(f"ground truth peaks {strong}, {weak} != "
                             "(432, 153), (672, 120)")
    return params, cfg, launches


def phase_steady(torch, dev, cfg):
    from passiveradar_torch import pipeline as pl
    from passiveradar_torch.io.hdf5 import CaptureReader

    reader = CaptureReader(cfg, estimate_offset=False, device=dev)
    f = BATCH + 2
    ref_np, srv_np = reader.read_pair_frames(0, f)
    reader.close()
    ref = torch.from_numpy(ref_np).to(dev)
    srv = torch.from_numpy(srv_np).to(dev)
    ph = torch.from_numpy(pl.frame_phases(cfg, list(range(f)))).to(dev)
    for _ in range(2):
        pl._process_frames_impl(ref, srv, ph, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stages = dict(preprocess=[], clutter=[], caf=[], total=[])
    for _ in range(STEADY_RUNS):
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
    if tuple(maps.shape) != (f, cfg.num_doppler_cells,
                             cfg.num_range_cells + 1):
        raise AssertionError(f"steady-state maps {tuple(maps.shape)}")
    ms = float(np.median(stages["total"]))
    emit(dict(phase="steady_state", clutter_method=cfg.clutter_method,
              buffer_frames=f, valid_frames=BATCH,
              runs=STEADY_RUNS, ms_per_batch_median=ms,
              frames_per_s=BATCH / ms * 1e3,
              stage_ms_median={k: float(np.median(v))
                               for k, v in stages.items()},
              stage_ms_runs=stages,
              max_memory_allocated=torch.cuda.max_memory_allocated()))
    profile_batch(torch, pl, ref, srv, ph, cfg)


def profile_batch(torch, pl, ref, srv, ph, cfg):
    """One traced batch: device kernels launched, their busy time over the
    span from the first kernel's start to the last one's end (the idle
    share is the rest), and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pl._process_frames_impl(ref, srv, ph, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        emit(dict(phase="profile", clutter_method=cfg.clutter_method,
                  traced_wall_ms=wall_ms, kernels=0,
                  note="the profiler recorded no device activity"))
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    emit(dict(phase="profile", clutter_method=cfg.clutter_method,
              traced_wall_ms=wall_ms, kernels=len(kernels),
              device_busy_ms=busy / 1e3, device_span_ms=span / 1e3,
              idle_share=1.0 - busy / span,
              top=[dict(name=k[:80], ms=t / 1e3, launches=c)
                   for k, (t, c) in top]))


def main() -> int:
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

    built = cuda_build.build(force=True)
    for name, b in built.items():
        emit(dict(phase="build", source=f"passiveradar_torch/csrc/{name}.cu",
                  seconds=b["seconds"], ptxas=ptxas_summary(b["log"])))

    row = phase_kernels(torch, dev)
    row_nlms = phase_nlms_kernels(torch, dev)
    phase_chain_parity(torch, dev)
    phase_nlms_chain_parity(torch, dev)
    try:
        params, cfg, launches = phase_main_path(torch)
        row_nlms["launches"] = phase_nlms_main_path(torch, params)
        phase_nlms_fm_parity(torch, dev, params)
        phase_steady(torch, dev, cfg)
        phase_steady(torch, dev,
                     derive_config(dict(params, clutter_method="nlms_pallas")))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    row["launches"] = launches
    emit({"kernels": [row, row_nlms]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
