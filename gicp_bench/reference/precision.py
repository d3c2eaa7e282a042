"""Arithmetic precision of a reference computation."""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32 rounded to nearest-even on TF32's 10 explicit
    mantissa bits (the low 13 bits of the float32 word cleared)."""
    f = x.to(torch.float32).contiguous()
    bits = f.view(torch.int32)
    bias = ((bits >> 13) & 1) + 0x0FFF
    rounded = ((bits + bias) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(f), rounded, f)


class Precision:
    """``name`` "f64": float64 throughout (the reference). "tf32": float32
    with ``q`` rounding each stage's values to TF32 (the control)."""

    def __init__(self, name: str = "f64"):
        if name not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "f64" else torch.float32

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in this precision."""
        if self.name == "f64":
            return x.to(torch.float64)
        return round_tf32(x)


F64 = Precision("f64")
TF32 = Precision("tf32")
