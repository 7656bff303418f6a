"""Per-channel energy normalization (port of
``audio_training_tpu/ops/pcen.py:25-139``; parity target the reference
``tfpcen.py:33-110``).

The EMA smoother ``m_t = w*x_t + (1-w)*m_{t-1}`` has two forms, as in the
JAX package.  :func:`ema_scan` is the reference's own sequential
recurrence, one step per frame: it is the plain version that the CUDA PCEN
kernel is held against, and what :func:`pcen` uses.
:func:`ema_toeplitz` is one product with a lower-triangular ``(T, T)``
operator built from ``w``.  The kernel
(``csrc/fused_featurizer.cu::pcen_kernel``) reassociates the recurrence as a
chunked scan: each lane of a warp runs the EMA over its own run of frames
from a zero seed, the runs' affine maps are composed across the lanes, and
each frame adds its decayed carry (tests/test_torch_pcen_plan.py models it).
"""

from __future__ import annotations

import torch

from audio_training_tpu_torch.ops.features import (
    normalize_minmax as normalize_minmax_global,  # tfpcen.py:105-110
)


def ema_scan(
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


def ema_toeplitz(
    x: torch.Tensor,
    w: torch.Tensor | float,
    init: torch.Tensor,
    axis: int = -1,
) -> torch.Tensor:
    """Same EMA as :func:`ema_scan`, as ONE product with a lower-triangular
    Toeplitz operator:

        m_t = sum_{j<=t} w*(1-w)^(t-j) * x_j + (1-w)^(t+1) * init

    The operator is built from ``w`` in the graph, so the result is
    differentiable through ``w``.  Its O(T^2) memory and work cap it to
    short time axes; :func:`ema` dispatches."""
    w = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    w = w.clamp(0.0, 1.0)
    t_len = x.shape[axis]
    logd = torch.log(torch.clamp(1.0 - w, min=1e-30))
    idx = torch.arange(t_len, device=x.device)
    dt = (idx[None, :] - idx[:, None]).to(torch.float32)  # [j, t]
    op = torch.where(dt >= 0, w * torch.exp(dt.clamp(min=0) * logd),
                     torch.zeros((), device=x.device))
    x32 = x.movedim(axis, -1).to(torch.float32)
    m = x32 @ op
    decay = torch.exp((idx.to(torch.float32) + 1.0) * logd)
    m = m + init.to(torch.float32)[..., None] * decay
    return m.to(x.dtype).movedim(-1, axis)


# O(T^2) operator memory stays trivial up to this length; beyond it the
# recurrence wins on memory (JAX ops/pcen.py:83-85).
_TOEPLITZ_MAX_T = 1024


def ema(
    x: torch.Tensor,
    w: torch.Tensor | float,
    init: torch.Tensor,
    axis: int = -1,
    method: str = "auto",
) -> torch.Tensor:
    """EMA dispatcher (JAX ops/pcen.py:88-96): ``toeplitz`` for time axes
    up to ``_TOEPLITZ_MAX_T``, ``scan`` beyond."""
    if method == "auto":
        method = "toeplitz" if x.shape[axis] <= _TOEPLITZ_MAX_T else "scan"
    if method == "toeplitz":
        return ema_toeplitz(x, w, init, axis=axis)
    return ema_scan(x, w, init, axis=axis)


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
    to [-1, 1] over the whole tensor — the whole batch.  The EMA is
    :func:`ema_scan`, the sequential recurrence that the CUDA PCEN kernel is
    held against.
    """
    gain = torch.as_tensor(gain, dtype=x.dtype, device=x.device).clamp(max=1.0)
    root = torch.as_tensor(root, dtype=x.dtype, device=x.device).clamp(min=1.0)
    bias = torch.as_tensor(bias, dtype=x.dtype, device=x.device)
    init = x.select(time_axis, 0)
    m = ema_scan(x, smooth, init, axis=time_axis)
    one_over_root = 1.0 / root
    out = (x / (eps + m) ** gain + bias) ** one_over_root - bias**one_over_root
    if normalize:
        out = normalize_minmax_global(out)
    return out
