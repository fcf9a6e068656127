"""A copy of the benchmark with one small cell for each real cell, for the
CPU tests: each cell's configuration at the small geometry of
tests/test_torch_pipeline.py (FM) or a 4-channel band (wideband), its mix
with a short ring, added as new files and entries only."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

FM = dict(input_sample_rate=49152, input_center_freq=1_000_000,
          channel_freq=990_170, channel_bandwidth=12800,
          cpi_seconds_nominal=1.0, max_doppler_nominal=128.0,
          max_range_nominal=400.0, frame_batch=4)
WIDEBAND = dict(input_sample_rate=64000, wideband_channels=4,
                channel_bandwidth=64000, max_doppler_nominal=128.0,
                max_range_nominal=400.0, frame_batch=3)
# tiny cell → (the cell it stands for, config overrides, mix overrides)
CELLS = {
    "tiny_fm_ring": ("fm_ring", FM, dict(ring_frames=6, call_frames=12,
                                         keep_positions=[0, 4, 11],
                                         seeded_positions=2)),
    "tiny_fm_stream": ("fm_stream", FM, dict(ring_frames=6)),
    "tiny_wideband_stream": ("wideband_stream", WIDEBAND,
                             dict(ring_frames=5)),
    "tiny_wideband_ring": ("wideband_ring", WIDEBAND,
                           dict(ring_frames=5, call_frames=7,
                                keep_positions=[0, 3, 6],
                                seeded_positions=1)),
}


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_copy(dst: str) -> str:
    """The benchmark and BENCHMARK.json copied under ``dst``, with the tiny
    cells added as files and entries. Returns the copy's benchmark
    directory."""
    bench = os.path.join(dst, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        ".out", ".cache", "__pycache__", "tests"))
    spec = _load(os.path.join(REPO, "BENCHMARK.json"))
    entries = {w["name"]: w for w in spec["workloads"]}
    configs = {c["name"]: c for c in spec["configs"]}
    for name, (like, cfg_over, mix_over) in CELLS.items():
        real = entries[like]
        cfg = dict(_load(os.path.join(REPO, configs[real["config"]]["file"])),
                   **cfg_over)
        mix = dict(_load(os.path.join(BENCH, "traffic",
                                      real["traffic"] + ".json")), **mix_over)
        for t in mix["scene"]["targets"]:
            t["delay_samples"] = max(1, t["delay_samples"] // 50)
        _dump(cfg, os.path.join(bench, "configs", name + ".json"))
        _dump(mix, os.path.join(bench, "traffic", name + ".json"))
        shutil.copy(os.path.join(BENCH, "workloads", like + ".json"),
                    os.path.join(bench, "workloads", name + ".json"))
        spec["configs"].append(dict(configs[real["config"]], name=name,
                                    file=f"benchmark/configs/{name}.json"))
        spec["workloads"].append(dict(real, name=name, config=name,
                                      traffic=name))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    _dump(spec, os.path.join(dst, "BENCHMARK.json"))
    return bench
