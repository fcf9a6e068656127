"""DSP operations of the port: torch functions over complex64 tensors, plus
the hand-written CUDA kernels of the resampler (ops/resample_kernel.py), of
the NLMS canceller (ops/nlms_kernel.py) and of the fused FFT
(ops/fft_kernel.py). Every name of the JAX package's ``ops`` is here;
its Pallas ``nlms_filter_pallas`` is ``nlms_filter_batch``."""

from passiveradar_torch.ops.caf import direct_xambg, fast_xambg
from passiveradar_torch.ops.cfar import cfar_2d
from passiveradar_torch.ops.clutter import (
    gal_jpe,
    ls_filter,
    ls_filter_multiple,
    ls_filter_svd,
    ls_filter_toeplitz,
    nlms_filter,
    toeplitz_solve,
)
from passiveradar_torch.ops.fir import (
    decimate_taps,
    design_lowpass,
    fir_decimate,
    mix_resample_poly,
    mix_resample_poly_batch,
    resample_poly,
    upfirdn,
)
from passiveradar_torch.ops.iir import iir_decimate
from passiveradar_torch.ops.mixer import block_phase_offsets, frequency_shift
from passiveradar_torch.ops.nlms_kernel import nlms_filter_batch
from passiveradar_torch.ops.resample_kernel import mix_regroup_matmul
from passiveradar_torch.ops.util import deinterleave_iq, normalize, shift
from passiveradar_torch.ops.xcorr import (
    apply_offset,
    channel_preprocessing,
    find_channel_offset,
    offset_compensation,
    xcorr,
)

__all__ = [
    "design_lowpass",
    "upfirdn",
    "resample_poly",
    "fir_decimate",
    "decimate_taps",
    "mix_resample_poly",
    "mix_resample_poly_batch",
    "mix_regroup_matmul",
    "frequency_shift",
    "block_phase_offsets",
    "deinterleave_iq",
    "normalize",
    "shift",
    "iir_decimate",
    "xcorr",
    "find_channel_offset",
    "apply_offset",
    "offset_compensation",
    "channel_preprocessing",
    "fast_xambg",
    "direct_xambg",
    "cfar_2d",
    "ls_filter",
    "ls_filter_svd",
    "ls_filter_toeplitz",
    "ls_filter_multiple",
    "nlms_filter",
    "nlms_filter_batch",
    "gal_jpe",
    "toeplitz_solve",
]
