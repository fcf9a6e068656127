"""DSP operations of the port: torch functions over complex64 tensors, plus
the hand-written CUDA kernels of the resampler (ops/resample_kernel.py), of
the NLMS canceller (ops/nlms_kernel.py) and of the fused FFT
(ops/fft_kernel.py)."""

from passiveradar_torch.ops.caf import fast_xambg
from passiveradar_torch.ops.clutter import ls_filter_multiple, nlms_filter
from passiveradar_torch.ops.fir import (
    design_lowpass,
    fir_decimate,
    mix_resample_poly_batch,
    resample_poly,
    upfirdn,
)
from passiveradar_torch.ops.iir import iir_decimate
from passiveradar_torch.ops.mixer import block_phase_offsets, frequency_shift
from passiveradar_torch.ops.nlms_kernel import nlms_filter_batch
from passiveradar_torch.ops.resample_kernel import mix_regroup_matmul
from passiveradar_torch.ops.xcorr import apply_offset, find_channel_offset, xcorr

__all__ = [
    "design_lowpass",
    "upfirdn",
    "resample_poly",
    "fir_decimate",
    "mix_resample_poly_batch",
    "mix_regroup_matmul",
    "frequency_shift",
    "block_phase_offsets",
    "iir_decimate",
    "xcorr",
    "find_channel_offset",
    "apply_offset",
    "ls_filter_multiple",
    "nlms_filter",
    "nlms_filter_batch",
    "fast_xambg",
]
