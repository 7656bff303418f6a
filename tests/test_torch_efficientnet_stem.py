"""The EfficientNet stems' folded preprocessing (``models/backbones.py``
``folded_stem``) on the CPU.

Keras' baked preprocessing maps the PCEN image's [-1, 1] onto a narrow
band (ImageNet's ``(x / 255 - mean) / std`` onto [-2.135, -2.101],
``x / 128 - 1`` onto [-1.008, -0.992]), where bf16 keeps 3 to 5 values; the
stem conv's output is then a constant about 123 times the image's signal
until its BatchNorm. The fold runs the conv on the image itself and adds
the constant in the parameters' dtype:

* in float32 it equals the unfolded stem in float64, at the borders (where
  SAME padding drops taps) and in the interior, in eval and in training,
  for every preprocessing the EfficientNets bake;
* with a bf16 model, the stem's output (block 0's input) keeps the image:
  its error is bf16's round-off, where the unfolded bf16 stem of before
  read 0.017-0.044 of the output's standard deviation;
* B3 in bf16 against the benchmark's plain reference
  (``portbench/reference/efficientnetv2b3_flat_edges.py``) on the
  benchmark's weights, and every preprocessing against the model's own
  float64 forward, hold their logits: 8 clips, each answer nearer its own
  clip's logits than any other clip's, and the root-mean-square gap under
  ``LOGIT_TOL`` of the logits' spread across the clips.  A zero, constant
  or swapped answer fails the first, the unfolded bf16 stem both.

The logits are held on kernels whose stem sees no frame: the zero SAME
padding of the flat image Keras' shift makes (about -2.1, or -1) makes the
stem's edges differ from its inside by about 100 times the image's signal
with a drawn kernel, every calibrated BatchNorm after it scales to that
frame, and bf16's round-off then leaves a random B3's logits as far from
the exact ones as another clip's (1.0-1.8 spreads here).  So the logit
checks project the stem's kernel as the benchmark does
(``flatten_edges``) before the BatchNorms' statistics are taken; the
stem's own checks and the fold's run on drawn kernels.
"""

import pytest
import torch
import torch.nn.functional as F

from audio_training_tpu_torch.models import build_model
from audio_training_tpu_torch.models.backbones import folded_stem
from audio_training_tpu_torch.models.layers import KerasBatchNorm, same_pads
from portbench import weights
from portbench.reference import efficientnetv2b3_flat_edges as reference
from portbench.reference.efficientnetv2b3_flat_edges import flatten_edges
from portbench.reference.layers import Ctx

torch.set_num_threads(2)

IMAGENET = (("norm_mean", (0.485, 0.456, 0.406)),
            ("norm_var", (0.229**2, 0.224**2, 0.225**2)))
CALIBRATION = 8  # clips whose moments set the BatchNorms' statistics
STEM_TOL = 0.008  # rms over std: the fold 0.0025-0.0034, unfolded >= 0.017
# rms over the spread across clips, 64 x 128: the fold 0.13-0.20, a
# swapped answer 1.28-1.56, the unfolded bf16 stem 23 and more
LOGIT_TOL = 0.5


def _image(seed, channels, shape, dtype=torch.float64):
    """``CALIBRATION`` PCEN-range images, NHWC in [-1, 1]."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(CALIBRATION, *shape, channels, generator=g,
                      dtype=dtype) * 2 - 1


def _calibrated(name, channels, seed, x, flat=False, **kw):
    """A float64 model whose BatchNorms hold their inputs' moments on ``x``
    (a train-mode pass), in eval mode; ``flat``: its stem's kernel
    projected as the benchmark's (``flatten_edges``) first."""
    model = build_model(name, 7, logits_only=True, external_frontend=True,
                        dropout=0.0, in_channels=channels,
                        generator=torch.Generator().manual_seed(seed),
                        **kw).module.double()
    if flat:
        bb = model.backbone
        shift = (bb.preprocessing(channels) if hasattr(bb, "variant")
                 else bb.preprocessing())[1]
        with torch.no_grad():
            flatten_edges(bb.stem.weight, shift, tuple(x.shape[1:3]))
    moments = {}

    def hook(mod, args):
        a = args[0]
        moments[mod] = (a.mean((0, 2, 3)), a.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, KerasBatchNorm)]
    with torch.no_grad():
        model.train()(x)
        for h in hooks:
            h.remove()
        for m, (mean, var) in moments.items():
            m.running_mean.copy_(mean)
            m.running_var.copy_(var)
    return model.eval()


def _bf16(name, channels, state, **kw):
    model = build_model(name, 7, logits_only=True, external_frontend=True,
                        in_channels=channels, dtype=torch.bfloat16,
                        **kw).module
    model.load_state_dict(state)
    return model.eval()


def _stem_out(model, x):
    """The model's logits on ``x`` and block 0's input (the stem's output,
    after its SiLU), in float64."""
    seen = []
    hook = model.backbone.blocks[0].register_forward_pre_hook(
        lambda m, a: seen.append(a[0].double()))
    with torch.no_grad():
        logits = model(x).double()
    hook.remove()
    return logits, seen[0]


def _holds(got, want):
    """Each answer nearest its own clip's logits, and the root-mean-square
    gap under ``LOGIT_TOL`` of the logits' spread across clips."""
    nearest = torch.cdist(got, want).argmin(1)
    assert (nearest == torch.arange(len(want))).all(), nearest
    spread = want.std(0).pow(2).mean().sqrt()
    gap = ((got - want).pow(2).mean().sqrt() / spread).item()
    assert gap < LOGIT_TOL, gap


def _stem_gap(got, want):
    return ((got - want).pow(2).mean().sqrt() / want.std()).item()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_b3_bf16_against_the_plain_reference(seed):
    """The benchmark's weights (``portbench/weights.py``), its stem
    projected and the BatchNorm statistics set from the reference's
    moments on 8 clips, loaded into the port's B3 in bf16; the 8 clips
    compared."""
    spec = reference.spec(7, {}, 3)
    tensors = weights.make(spec, seed, "cpu")
    x = _image(seed, 3, (64, 128), torch.float32).permute(0, 3, 1, 2)
    weights.calibrate(reference, tensors, x)
    with torch.no_grad():
        want = reference.forward(Ctx(), tensors, x).double()
    model = build_model("efficientnetv2b3", 7, logits_only=True,
                        external_frontend=True, dtype=torch.bfloat16).module
    model.load_state_dict(tensors)
    got, stem = _stem_out(model.eval(), x.permute(0, 2, 3, 1).bfloat16())
    _holds(got, want)
    _, exact = _stem_out(model.float(), x.permute(0, 2, 3, 1))
    assert _stem_gap(stem, exact) < STEM_TOL


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name,channels,kw", [
    ("efficientnetv2b3", 1, {}),  # x / 128 - 1
    ("efficientnetv2b3", 3, {}),  # ImageNet
    ("efficientnetb0", 3, {"backbone_args": IMAGENET}),
    ("efficientnetb0", 1, {"backbone_args": IMAGENET}),  # broadcast to 3
])
def test_bf16_stem_keeps_the_image(name, channels, kw, seed):
    """The bf16 model's stem output against its own float64 forward's, at
    32 x 64 (B=2); its logits at 64 x 128 (B=8, the stem projected)."""
    x = _image(seed, channels, (32, 64))
    exact = _calibrated(name, channels, seed, x, **kw)
    low = _bf16(name, channels, exact.state_dict(), **kw)
    _, want_stem = _stem_out(exact, x[:2])
    _, got_stem = _stem_out(low, x[:2].bfloat16())
    assert _stem_gap(got_stem, want_stem) < STEM_TOL
    x = _image(seed, channels, (64, 128))
    exact = _calibrated(name, channels, seed, x, flat=True, **kw)
    low = _bf16(name, channels, exact.state_dict(), **kw)
    _holds(_stem_out(low, x.bfloat16())[0], _stem_out(exact, x)[0])


def _unfolded(x, conv, scale, shift):
    """The stem's conv as Keras runs it, in float64: the affine, XLA's SAME
    padding with zeros, the conv."""
    scale, shift = (torch.tensor(v, dtype=x.dtype).view(1, -1, 1, 1)
                    for v in (scale, shift))
    (h0, h1), (w0, w1) = (same_pads(n, k, s) for n, k, s in
                          zip(x.shape[2:], conv.kernel, conv.stride))
    return F.conv2d(F.pad(x * scale + shift, (w0, w1, h0, h1)),
                    conv.weight.double(), conv.bias.double(),
                    stride=conv.stride)


def _norm(y, bn, train):
    """The BatchNorm in float64: batch moments in training, running
    statistics in eval."""
    if train:
        mean, var = y.mean((0, 2, 3)), y.var((0, 2, 3), unbiased=False)
    else:
        mean, var = bn.running_mean.double(), bn.running_var.double()
    shape = (1, -1, 1, 1)
    return ((y - mean.view(shape)) * torch.rsqrt(var.view(shape) + bn.eps)
            * bn.weight.double().view(shape) + bn.bias.double().view(shape))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("shape", [(32, 64), (33, 47)])
@pytest.mark.parametrize("name,channels,kw", [
    ("efficientnetv2b3", 3, {}),
    ("efficientnetv2b3", 1, {}),
    ("efficientnetv2bs", 3, {}),  # the S variant takes x / 128 - 1
    ("efficientnetb0", 1, {"backbone_args": IMAGENET}),
    ("efficientnetb0", 3, {}),  # rescale only
])
def test_fold_equals_the_unfolded_stem(name, channels, kw, shape, train):
    """The fold in float32 against the unfolded stem in float64: at the
    borders (first and last row and column of the output) and in the
    interior, within 1e-5 of the output's largest magnitude in eval.  In
    training the BatchNorm's f32 batch variance, Flax's ``E[x^2] -
    E[x]^2`` of the conv's output with its constant part, bounds the fold
    and the unfolded stem in float32 alike (1e-5 to 2e-4 here)."""
    model = build_model(name, 7, external_frontend=True, in_channels=channels,
                        generator=torch.Generator().manual_seed(5),
                        **kw).module
    bb = model.backbone
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        bb.stem.bias.normal_(generator=g)
        bn = bb.stem_bn
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(generator=g)
    x = _image(7, channels, shape).permute(0, 3, 1, 2)
    scale, shift = (bb.preprocessing(channels)
                    if hasattr(bb, "variant") else bb.preprocessing())
    y = _unfolded(x, bb.stem, scale, shift)
    with torch.no_grad():  # running statistics near the batch's
        bn.running_mean.copy_(y.mean((0, 2, 3)) + 0.1 * y.std((0, 2, 3)))
        bn.running_var.copy_(y.var((0, 2, 3)) * 1.2)
    want = _norm(y, bn, train)
    bn.train(train)
    with torch.no_grad():
        got = folded_stem(x.float(), bb.stem, bn, scale, shift).double()
    border = torch.zeros(want.shape[2:], dtype=torch.bool)
    border[[0, -1], :] = border[:, [0, -1]] = True
    top = want.abs().max()
    for part in (border, ~border):
        err = ((got - want)[..., part].abs().max() / top).item()
        assert err < (5e-4 if train else 1e-5), err
    # the borders differ from the interior: SAME padding drops taps there
    inner = want[..., ~border].mean((0, 2))
    assert (want[..., border].mean((0, 2)) - inner).abs().max() > 1e-3 * top
