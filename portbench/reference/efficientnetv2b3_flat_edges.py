"""EfficientNetV2-B3 classifier as ``reference/efficientnetv2b3.py`` (the
same tensors, the same forward), with the stem's kernel settled by the
benchmark's calibration so that the model's bf16 logits follow its clip.

Keras' ``(x / 255 - mean) / std`` puts the PCEN image's [-1, 1] in a band
0.034 wide at about -2.1, and the stem's SAME padding pads that with zeros.
With a kernel drawn at random, the stem's output along the image's edges
then differs from its inside by about 2.1 times the sum of the taps that
read the padding: a frame about 100 times the clip's signal.  Every
calibrated BatchNorm after it scales to that frame, the clip's signal is
left a few hundredths of each activation, and the rounding of bf16 (a
part in 512 of each) leaves the logits as far from the reference as
another clip's are (1.4 to 4.3 times the logits' spread across clips).
Nothing of the program is at fault there: the reference itself with its
products' operands in bf16 reads as far.

So :func:`forward`, when it collects the BatchNorms' moments (the one call
``weights.calibrate`` makes, before any program holds the weights),
first projects the stem's kernel, with the least change, onto the kernels
under which the flat image (Keras' shift, per channel) gives the same
output at every edge and corner of this image as inside it.  Five of the
kernel's 27 directions a filter go, for the image's sizes (160 x 513:
the last row and the first and last columns read the padding).  What it
gives up: the constant that the program's fold of the preprocessing adds
at the borders (``models/backbones.py::folded_stem``) is then the one
inside, so the cell's check no longer sees it;
``tests/test_torch_efficientnet_stem.py`` holds it on drawn kernels.
"""

from __future__ import annotations

import torch

from portbench.reference import efficientnetv2b3 as base
from portbench.reference.layers import Ctx, same_pads

spec = base.spec
SHIFT = tuple(-m / s for m, s in zip(base.MEAN, base.STD))  # Keras' shift


def _outside(size: int, kernel: int, stride: int) -> set[frozenset]:
    """The sets of taps that read the padding, over the outputs of a
    SAME-padded conv along one axis (the empty set for the inside)."""
    lo, _ = same_pads(size, kernel, stride)
    return {frozenset(k for k in range(kernel)
                      if not 0 <= i * stride + k - lo < size)
            for i in range(-(-size // stride))}


def flatten_edges(w: torch.Tensor, shift, image_hw: tuple[int, int],
                  stride: int = 2) -> None:
    """Project the SAME-padded stem kernel ``w`` (out, C, kh, kw) in place
    onto the kernels whose response to the flat image ``shift`` (one value
    an input channel) is the same where taps read the padding as inside.
    A projection: a second call changes nothing."""
    out, c, kh, kw = w.shape
    shift = torch.as_tensor(shift, dtype=torch.float64)
    rows = []
    for r in _outside(image_hw[0], kh, stride):
        for s in _outside(image_hw[1], kw, stride):
            if r or s:
                mask = torch.zeros(kh, kw, dtype=torch.float64)
                mask[sorted(r), :] = 1.0
                mask[:, sorted(s)] = 1.0
                rows.append((shift.view(-1, 1, 1) * mask).reshape(-1))
    if not rows:
        return
    a = torch.stack(rows).to(w.device)
    flat = w.reshape(out, -1).to(torch.float64)
    flat = flat - flat @ torch.linalg.pinv(a) @ a
    w.copy_(flat.view_as(w).to(w.dtype))


def forward(ctx: Ctx, p: dict, x: torch.Tensor) -> torch.Tensor:
    if ctx.moments is not None:
        flatten_edges(p["backbone.stem.weight"], SHIFT, tuple(x.shape[2:]))
    return base.forward(ctx, p, x)
