"""Device policy of the port: the CUDA card unless the caller asks for the CPU.

There is no silent fallback. ``device=None`` means ``"cuda"`` and raises when
CUDA is absent; ``device="cpu"`` is the only way onto the CPU (the tests use
it). No global device state is kept: every entry point passes its device on.
"""

from __future__ import annotations

import numpy as np
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


def on_device(x, device=None) -> torch.Tensor:
    """``x`` as a tensor for an op that follows its input's device: a
    tensor stays where it lies unless ``device`` is given; anything else
    (numpy) goes to ``resolve_device(device)``, the card by default."""
    if torch.is_tensor(x) and device is None:
        return x
    dev = resolve_device(device)
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev)
