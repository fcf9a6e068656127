"""passiveradar_torch — the passive bistatic radar processor on PyTorch + CUDA.

The PyTorch port of the JAX/TPU package of this repository, for one
NVIDIA Hopper card (H100).
Module names mirror the JAX package one for one, so every function here has
an obvious counterpart there. The port imports neither JAX nor anything of
the JAX package; the JAX package stays the reference it is tested against.

Device policy (``passiveradar_torch._device``): public entry points take
``device=None``, meaning the CUDA card, and raise when CUDA is absent;
``device="cpu"`` is the only way onto the CPU. Work is complex64 throughout.
Hand-written CUDA kernels: the polyphase regroup+matmul of the resampler
(``ops/resample_kernel.py``, ``csrc/mix_regroup.cu``) on the main path,
the NLMS clutter canceller (``ops/nlms_kernel.py``, ``csrc/nlms.cu``)
for ``clutter_method`` 'nlms' and 'nlms_pallas', and the fused four-step
FFT (``ops/fft_kernel.py``, ``csrc/fft_fused.cu``) for the LS canceller's
full-length transforms under ``PASSIVERADAR_PALLAS_FFT=1``;
``ops/cuda_build.py`` builds all three.
"""

import torch

from passiveradar_torch.config import RadarConfig, derive_config, load_config

# Full-f32 contractions, as the JAX package pins Precision.HIGHEST
# (its ops/fir.py): TF32 keeps only ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = [
    "RadarConfig",
    "load_config",
    "derive_config",
]
