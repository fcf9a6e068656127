"""Device policy of the port: the CUDA card unless the caller asks for the CPU.

There is no silent fallback. ``device=None`` means ``"cuda"`` and raises when
CUDA is absent; ``device="cpu"`` is the only way onto the CPU (the tests use
it). No global device state is kept: every entry point passes its device on.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Turn a ``device=`` argument into a torch.device, enforcing the policy."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "passiveradar_torch runs on a CUDA device by default and CUDA is "
            "not available here; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
