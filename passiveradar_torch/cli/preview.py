"""Capture diagnostics: PSDs + channel cross-correlation (reference
signal_preview.py:24-82).

    python -m passiveradar_torch.cli.preview --config cfg.yaml [--device cpu]

Port of the JAX package's cli/preview.py. ``preview_arrays`` computes what
the CLI plots on the device (Welch PSDs of frame 0, raw and channelized,
and |xcorr| of the channelized pair); ``main`` draws them into
SIGNAL_PREVIEW.png in the working directory. matplotlib is imported only
to draw.
"""

from __future__ import annotations

import numpy as np
import torch

from passiveradar_torch._device import on_device, resolve_device
from passiveradar_torch.cli.common import (add_device,
                                           fail_on_missing_capture, load,
                                           parser)
from passiveradar_torch.config import RadarConfig
from passiveradar_torch.io.hdf5 import CaptureReader
from passiveradar_torch.ops.fir import resample_poly
from passiveradar_torch.ops.mixer import frequency_shift
from passiveradar_torch.ops.xcorr import xcorr

NLAG = 2000               # lags each side of the cross-correlation


def welch_psd(x, nperseg: int = 4096, device=None) -> np.ndarray:
    """Mean-of-periodograms PSD in dB: whole segments of ``nperseg``, a
    symmetric Hann window, mean |FFT|², fftshift, 10·log10(· + 1e-12).
    ``x`` (complex, 1-D) is computed on where it lies (a tensor) or on
    ``device`` (default CUDA)."""
    x = on_device(x, device).to(torch.complex64)
    n = (x.shape[0] // nperseg) * nperseg
    segs = x[:n].reshape(-1, nperseg)
    win = torch.hann_window(nperseg, periodic=False, dtype=torch.float32,
                            device=x.device)
    spec = torch.fft.fftshift(torch.fft.fft(segs * win, dim=1), dim=1)
    psd = torch.mean(spec.abs() ** 2, dim=0)
    return (10 * torch.log10(psd + 1e-12)).cpu().numpy()


def _channelize(x: torch.Tensor, cfg: RadarConfig) -> torch.Tensor:
    """Tune the channel to baseband and resample to the IF rate."""
    return resample_poly(
        frequency_shift(x, cfg.offset_freq, cfg.input_sample_rate),
        cfg.resamp_up, cfg.resamp_dn, padtype="line")


def preview_arrays(cfg: RadarConfig, reader: CaptureReader,
                   device=None) -> dict:
    """What the preview plots, from frame 0 of ``reader`` on ``device``
    (default CUDA): the reader's channel offset; the raw PSDs (nperseg
    4096) and channelized PSDs (nperseg 1024) of ref and srv in dB; and
    |xcorr| of the channelized pair over lags -NLAG..NLAG."""
    dev = resolve_device(device)
    ref_h, srv_h = reader.read_iq_frames(0, 1)
    ref = torch.from_numpy(ref_h[0]).to(dev)
    srv = torch.from_numpy(srv_h[0]).to(dev)
    r_ch, s_ch = _channelize(ref, cfg), _channelize(srv, cfg)
    return dict(offset=reader.offset,
                raw_psd_ref=welch_psd(ref), raw_psd_srv=welch_psd(srv),
                ch_psd_ref=welch_psd(r_ch, 1024),
                ch_psd_srv=welch_psd(s_ch, 1024),
                xcorr=xcorr(r_ch, s_ch, NLAG, NLAG).abs().cpu().numpy())


@fail_on_missing_capture
def main(argv=None):
    p = parser("PASSIVE RADAR - SIGNAL PREVIEW (PyTorch)")
    add_device(p)
    args = p.parse_args(argv)
    cfg = load(args)
    dev = resolve_device(args.device)

    reader = CaptureReader(cfg, estimate_offset=True, max_offset_lags=50_000,
                           device=dev)
    try:
        print(f"Estimated channel offset: {reader.offset} samples")
        a = preview_arrays(cfg, reader, dev)
    finally:
        reader.close()

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(3, 1, figsize=(9, 10), dpi=110)
    f_in = np.linspace(-0.5, 0.5, len(a["raw_psd_ref"])) * \
        cfg.input_sample_rate
    axes[0].plot(f_in / 1e3, a["raw_psd_ref"], label="ref")
    axes[0].plot(f_in / 1e3, a["raw_psd_srv"], label="srv", alpha=0.7)
    axes[0].set_title("Raw capture PSD")
    axes[0].set_xlabel("kHz from centre")
    axes[0].legend()

    f_if = np.linspace(-0.5, 0.5, len(a["ch_psd_ref"])) * cfg.IF_sample_rate
    axes[1].plot(f_if / 1e3, a["ch_psd_ref"], label="ref")
    axes[1].plot(f_if / 1e3, a["ch_psd_srv"], label="srv", alpha=0.7)
    axes[1].set_title("Channelized PSD")
    axes[1].set_xlabel("kHz")
    axes[1].legend()

    axes[2].plot(np.arange(-NLAG, NLAG + 1), a["xcorr"])
    axes[2].set_title("Channel cross-correlation")
    axes[2].set_xlabel("lag (samples)")

    fig.tight_layout()
    fig.savefig("SIGNAL_PREVIEW.png")
    plt.close(fig)
    print("Wrote SIGNAL_PREVIEW.png")


if __name__ == "__main__":
    main()
