"""2-D cell-averaging CFAR normalisation (counterpart of the JAX package's
ops/cfar.py).

Reference semantics (target_detection.py:683-703): the frame is divided by
the wrap-padded 2-D convolution of itself with an fw×fw averaging kernel
that has a (gw+1)-wide guard hole (the reference's weight 1/(fw²−gw²) and
hole width are kept as they are). A whole stack of frames runs as one
float32 ``conv2d``, with cuDNN's TF32 off for the call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def cfar_kernel(fw: int, gw: int) -> np.ndarray:
    """The reference's CFAR averaging kernel (target_detection.py:694-697)."""
    t = np.ones((fw, fw)) / (fw ** 2 - gw ** 2)
    e1 = (fw - gw) // 2
    e2 = fw - e1 + 1
    t[e1:e2, e1:e2] = 0
    return t


@functools.lru_cache(maxsize=8)
def _weight(fw: int, gw: int, device: torch.device) -> torch.Tensor:
    t = cfar_kernel(fw, gw)[::-1, ::-1].astype(np.float32)
    return torch.from_numpy(t.copy()).to(device)[None, None]


def _cfar_core(x: torch.Tensor, fw: int, gw: int) -> torch.Tensor:
    """x: (F, H, W) float32 stack of frames → CFAR ratio, same shape."""
    c = (fw - 1) // 2
    # scipy 'same'+'wrap' convolution: y[i,j] = Σ_{a,b} T[a,b]·X[(i+c-a)%H, ...]
    pl, pr = fw - 1 - c, c
    xp = torch.nn.functional.pad(x[:, None], (pl, pr, pl, pr),
                                 mode="circular")
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        background = torch.nn.functional.conv2d(
            xp, _weight(fw, gw, x.device))[:, 0]
    norm = x / x.abs().mean(dim=(1, 2), keepdim=True)
    return norm / (background + 1e-10)


def cfar_2d(x, fw: int, gw: int, thresh: float | None = None):
    """CFAR-normalise one frame (H, W) or a stack (F, H, W).

    With ``thresh`` set, returns the boolean detection map instead
    (reference target_detection.py:700-703).
    """
    x = torch.as_tensor(x).float()
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    cr = _cfar_core(x, int(fw), int(gw))
    if squeeze:
        cr = cr[0]
    if thresh is None:
        return cr
    return cr > thresh
