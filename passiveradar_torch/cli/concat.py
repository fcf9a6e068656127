"""Reassemble multi-process ``.partN`` map stacks into one frame stack.

    python -m passiveradar_torch.cli.concat --config cfg.yaml [--keep-parts]

Port of the JAX package's cli/concat.py, the counterpart of the
multi-process runtime (parallel/distributed.py): each process writes a
contiguous frame range to ``<output>.partN.<ftype>``; this tool streams
them into the single ``<output>.<ftype>`` stack the plotting and tracking
tools read (the reference's single-file contract, main.py:200-227), writes
the metadata and removes the parts. It runs on the host only.
"""

from __future__ import annotations

import glob
import os
import re
import shutil

from passiveradar_torch.cli.common import banner, load, parser
from passiveradar_torch.io.writers import concat_parts, write_metadata


def find_parts(cfg) -> list[str]:
    """The part stacks of cfg's output, in process order; exits when they
    are not a contiguous part0..partN sequence."""
    pat = f"{cfg.output_fname}.part*.{cfg.range_doppler_map_ftype}"

    def idx(p):
        m = re.search(r"\.part(\d+)\.", os.path.basename(p))
        return int(m.group(1)) if m else -1

    parts = sorted(glob.glob(pat), key=idx)
    if [idx(p) for p in parts] != list(range(len(parts))):
        raise SystemExit(f"error: part stacks are not a contiguous "
                         f"part0..partN sequence: {parts}")
    return parts


def main(argv=None):
    """Returns the number of frames merged."""
    p = parser("PASSIVE RADAR - MERGE MULTI-PROCESS PART STACKS (PyTorch)")
    p.add_argument("--keep-parts", action="store_true",
                   help="Keep the .partN stacks after merging")
    args = p.parse_args(argv)
    cfg = load(args)
    banner(cfg)
    parts = find_parts(cfg)
    if not parts:
        raise SystemExit(f"error: no {cfg.output_fname}.part*."
                         f"{cfg.range_doppler_map_ftype} part stacks found")
    out = cfg.range_doppler_map_fname
    total = concat_parts(parts, out, cfg.range_doppler_map_ftype)
    write_metadata(cfg, total)
    print(f"Merged {len(parts)} parts ({total} frames) into {out}; "
          f"metadata in {cfg.meta_fname}")
    if not args.keep_parts:
        for part in parts:
            # a zarr store is a directory
            if os.path.isdir(part):
                shutil.rmtree(part)
            else:
                os.remove(part)
    return total


if __name__ == "__main__":
    main()
