"""Per-channel energy normalization (port of
``audio_training_tpu/ops/pcen.py:25-139``; parity target the reference
``tfpcen.py:33-110``).

The EMA smoother ``m_t = w*x_t + (1-w)*m_{t-1}`` is the reference's own
sequential recurrence, one step per frame.  The JAX package rewrites it as an
associative scan or a Toeplitz matmul for the TPU; here the recurrence is the
plain version that the CUDA PCEN kernel is held against.  The kernel
(``csrc/fused_featurizer.cu::pcen_kernel``) reassociates it as a chunked
scan: each lane of a warp runs the EMA over its own run of frames from a
zero seed, the runs' affine maps are composed across the lanes, and each
frame adds its decayed carry (tests/test_torch_pcen_plan.py models it).
"""

from __future__ import annotations

import torch

from audio_training_tpu_torch.ops.features import (
    normalize_minmax as normalize_minmax_global,  # tfpcen.py:105-110
)


def ema(
    x: torch.Tensor,
    w: torch.Tensor | float,
    init: torch.Tensor,
    axis: int = -1,
) -> torch.Tensor:
    """Exponential moving average along ``axis``, seeded with ``init``
    (the reference passes frame 0, tfpcen.py:33-39): the first output is
    ``w*x_0 + (1-w)*init``.  ``w`` is clipped to [0, 1]."""
    w = torch.as_tensor(w, dtype=x.dtype, device=x.device).clamp(0.0, 1.0)
    x = x.movedim(axis, 0)
    out = torch.empty_like(x)
    m = init
    for t in range(x.shape[0]):
        m = w * x[t] + (1.0 - w) * m
        out[t] = m
    return out.movedim(0, axis)


def pcen(
    x: torch.Tensor,
    gain: torch.Tensor | float = 0.98,
    bias: torch.Tensor | float = 2.0,
    root: torch.Tensor | float = 2.0,
    smooth: torch.Tensor | float = 0.04,
    eps: float = 1e-6,
    time_axis: int = -2,
    normalize: bool = True,
) -> torch.Tensor:
    """PCEN with trainable scalars (tfpcen.PCEN.call, tfpcen.py:89-99):

        out = (x / (eps + M)**gain + bias)**(1/root) - bias**(1/root)

    with gain clamped to <= 1 and root to >= 1, ``M`` the EMA over
    ``time_axis`` seeded with frame 0, then (``normalize``) a global min-max
    to [-1, 1] over the whole tensor — the whole batch.
    """
    gain = torch.as_tensor(gain, dtype=x.dtype, device=x.device).clamp(max=1.0)
    root = torch.as_tensor(root, dtype=x.dtype, device=x.device).clamp(min=1.0)
    bias = torch.as_tensor(bias, dtype=x.dtype, device=x.device)
    init = x.select(time_axis, 0)
    m = ema(x, smooth, init, axis=time_axis)
    one_over_root = 1.0 / root
    out = (x / (eps + m) ** gain + bias) ** one_over_root - bias**one_over_root
    if normalize:
        out = normalize_minmax_global(out)
    return out
