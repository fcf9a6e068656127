"""The two precisions the reference runs in.

``fp64``: every stage in float64 / complex128, the reference proper.
``fp32``: complex64 with no rounding, a witness of what float32 alone
reads (not a control: it is the configuration's own precision).
``tf32``: the control. The configuration states float32 with TF32 off, so
the control is the same chain in the precision below it: complex64, with
every stage's inputs, constant operands and outputs rounded to TF32's
10-bit mantissa (round to nearest), as a TF32 tensor-core route would take
them. A program that computed in TF32 would read like the control.
"""

from __future__ import annotations

import dataclasses

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32 or complex64) with every float rounded to a 10-bit
    mantissa, to nearest (ties away from zero)."""
    if x.is_complex():
        return torch.complex(round_tf32(x.real.contiguous()),
                             round_tf32(x.imag.contiguous()))
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str = "fp64"

    def __post_init__(self):
        if self.name not in ("fp64", "fp32", "tf32"):
            raise ValueError(f"unknown precision {self.name!r}")

    @property
    def real(self) -> torch.dtype:
        return torch.float64 if self.name == "fp64" else torch.float32

    @property
    def complex(self) -> torch.dtype:
        return torch.complex128 if self.name == "fp64" else torch.complex64

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A stage boundary: ``x`` in this precision's type, rounded to
        TF32 under the control."""
        x = x.to(self.complex if x.is_complex() else self.real)
        return x if self.name != "tf32" else round_tf32(x)


FP64 = Precision("fp64")
FP32 = Precision("fp32")
TF32 = Precision("tf32")
