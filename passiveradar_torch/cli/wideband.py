"""Wideband multi-illuminator processing entry point (BASELINE config 4).

    python -m passiveradar_torch.cli.wideband --config cfg.yaml \
        [--batch-frames N] [--integrate] [--shard] [--device cpu]

Port of the JAX package's cli/wideband.py: channelizes a wideband capture
into K critically sampled channels and runs the per-channel clutter + CAF
chain, writing one range-Doppler stack per selected channel
(``<output>.chK.<ftype>``), with ``--integrate`` also their noncoherent sum
(``<output>.integrated.<ftype>``), plus shared metadata. Enable it with
``wideband_channels: K`` (and optionally ``wideband_channel_select``) in
the YAML. ``--shard`` splits the selected channels over every local CUDA
card (over the one device with ``--device cpu``).
"""

from __future__ import annotations

import time

from passiveradar_torch._device import resolve_device
from passiveradar_torch.cli.common import add_device, banner, \
    fail_on_missing_capture, load, parser, shard_mesh
from passiveradar_torch.io.hdf5 import CaptureReader
from passiveradar_torch.io.writers import write_metadata
from passiveradar_torch.wideband import channel_path, integrated_path, \
    run_wideband_capture


@fail_on_missing_capture
def main(argv=None):
    """Returns the number of CPIs processed."""
    p = parser("PASSIVE RADAR - WIDEBAND MULTI-ILLUMINATOR PROCESSING "
               "(PyTorch)")
    p.add_argument("--batch-frames", type=int, default=None,
                   help="CPIs per device batch (default: cfg.frame_batch)")
    p.add_argument("--shard", action="store_true",
                   help="Split the selected channels over every local CUDA "
                        "card (over the one device with --device cpu)")
    p.add_argument("--integrate", action="store_true",
                   help="Also write the noncoherently integrated "
                        "multi-illuminator stack (sum of |CAF| over the "
                        "selected channels) to <output>.integrated.<ftype>")
    add_device(p)
    args = p.parse_args(argv)
    cfg = load(args)
    if cfg.wideband_channels < 2:
        raise SystemExit("error: set wideband_channels: K (K >= 2) in the "
                         "configuration to enable wideband mode")
    dev = resolve_device(args.device)
    banner(cfg, dev)
    print(f"Wideband: {cfg.wideband_channels} channels of "
          f"{cfg.IF_sample_rate / 1e3:.1f} kHz; processing channels "
          f"{list(cfg.wideband_channel_select)}")

    mesh = shard_mesh(dev, "channels") if args.shard else None
    if mesh is not None:
        print(f"Sharding the channels over {len(mesh)} device(s)")

    reader = CaptureReader(cfg, device=dev)
    t0 = time.time()
    try:
        n = run_wideband_capture(reader, cfg, batch_frames=args.batch_frames,
                                 integrate=args.integrate, device=dev,
                                 mesh=mesh)
    finally:
        reader.close()
    write_metadata(cfg, n)
    dt = time.time() - t0
    paths = ", ".join(channel_path(cfg, k)
                      for k in cfg.wideband_channel_select)
    if args.integrate:
        paths += f", {integrated_path(cfg)} (integrated)"
    print(f"Saved {n} CPIs x {len(cfg.wideband_channel_select)} channels "
          f"({n / dt:.1f} CPI/s) to {paths}; metadata in {cfg.meta_fname}")
    return n


if __name__ == "__main__":
    main()
