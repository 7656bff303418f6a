"""The control's precision: the reference with every product's operands
rounded to float8 e4m3, the step below the configurations' bfloat16, each
tensor scaled by its own largest magnitude onto e4m3's range (448), as an
fp8 path would scale it.  Values are rounded and computed on in float32;
the gradient passes the rounding unchanged."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    rounded = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (rounded - x.detach())
