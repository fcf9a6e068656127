#!/usr/bin/env python3
"""Build, check and drive the PyTorch port on one CUDA card.

    python3 chip_smoke.py          (from the repository root)

Phases, one JSON line each; any failure exits non-zero:

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: csrc/mix_regroup.cu for sm_90a with nvcc, from the checkout;
3. kernels: every CUDA kernel of the main path against its plain torch
   version on the card, at the FM main-path shapes and at a ragged small
   geometry, with times (kernel, plain version, one library call) and the
   reckoned bound; then the whole chain on the card against the CPU at a
   small geometry;
4. main path: an FM broadcast capture (2.4 MS/s, 200 kHz channel, 2 s CPI,
   16 frames, two targets) through ``passiveradar_torch.cli.process`` on
   the card, with the kernel launch counts of that run and the ground-truth
   peaks of the range-Doppler maps;
5. steady state: ``process_frames`` on one device-resident FM batch, per
   stage, with peak device memory; then one batch under torch.profiler
   (kernel launches, device busy and idle share, the heaviest kernels).

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


def phase_main_path(torch):
    import yaml

    from passiveradar_torch.cli.process import main as process_main
    from passiveradar_torch.config import derive_config
    from passiveradar_torch.io import zarr_min
    from passiveradar_torch.io.synthetic import Target, write_synth_capture
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
    t0 = time.perf_counter()
    n = process_main(["--config", cfg_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rk.mix_regroup_matmul.launches
    if n != FRAMES:
        raise AssertionError(f"processed {n} of {FRAMES} frames")
    if launches < 2 * batches:
        raise AssertionError(f"mix_regroup_matmul launched {launches} times "
                             f"for {batches} batches")

    stack = np.asarray(zarr_min.open(cfg.range_doppler_map_fname, mode="r"))
    if stack.shape != (cfg.num_doppler_cells, cfg.num_range_cells + 1,
                       FRAMES) or not np.all(np.isfinite(stack)):
        raise AssertionError(f"bad map stack {stack.shape}")
    x = np.abs(stack[:, :, 2:6]).mean(2)
    x[504:520, :] = 0                         # the zero-Doppler ridge
    strong = tuple(int(v) for v in np.unravel_index(np.argmax(x), x.shape))
    x[424:440, :] = 0
    weak = tuple(int(v) for v in np.unravel_index(np.argmax(x), x.shape))
    emit(dict(phase="main_path", frames=n, batches=batches,
              capture_gen_s=gen_s, wall_s=wall, wall_frames_per_s=n / wall,
              launches=dict(mix_regroup_matmul=launches),
              strong_peak=strong, weak_peak=weak))
    if strong != (432, 153) or weak != (672, 120):
        raise AssertionError(f"ground truth peaks {strong}, {weak} != "
                             "(432, 153), (672, 120)")
    return cfg, launches


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
    emit(dict(phase="steady_state", buffer_frames=f, valid_frames=BATCH,
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
        emit(dict(phase="profile", traced_wall_ms=wall_ms, kernels=0,
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
    emit(dict(phase="profile", traced_wall_ms=wall_ms, kernels=len(kernels),
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
        from passiveradar_torch.ops import resample_kernel as rk
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

    built = rk.build_library(force=True)
    emit(dict(phase="build", source="passiveradar_torch/csrc/mix_regroup.cu",
              seconds=built["seconds"],
              ptxas=[ln.strip() for ln in built["log"].splitlines()
                     if "registers" in ln or "mix_regroup_kernelILi13" in ln]))

    row = phase_kernels(torch, dev)
    phase_chain_parity(torch, dev)
    try:
        cfg, launches = phase_main_path(torch)
        phase_steady(torch, dev, cfg)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    row["launches"] = launches
    emit({"kernels": [row]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
