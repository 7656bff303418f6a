"""Shared set-up of the model-family parity tests (imported by
tests/test_torch_efficientnet.py, test_torch_backbone_zoo.py and
test_torch_families.py; not collected itself).

The Flax variables are made without running Flax's init: ``jax.eval_shape``
gives the tree, numpy fills it from a seed (kernels N(0, 2/fan_in), which
keeps a ReLU net without BatchNorm such as VGG at unit scale; BN scales
U(0.3, 0.8), biases N(0, 0.05)), and ``models/convert.py`` carries it into
the port, strictly.  Then, on the port's model, each BatchNorm's
statistics become its own input's batch moments (in float64) on a
calibration batch that holds the evaluated inputs and six more, perturbed
from the seed (mean + 0.02 std, var x U(0.9, 1.1)), and are written back
into the Flax tree: no BatchNorm is the identity and every layer keeps its
input at unit scale, so the logits depend on the input (without this,
random statistics swamp the signal and two images' logits agree to 1e-4).
Residual branches end in a BN scale of U(0.05, 0.15): a deep random
EfficientNetV2 (or ResNet152) otherwise amplifies a relative change of its
statistics by 1e4 or more over its last stages, and with it the packages'
f32 rounding.
Both sides then run exact f32 convolutions on the CPU.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import torch

from audio_training_tpu.models import build_model as jax_build_model
from audio_training_tpu_torch.models import build_model
from audio_training_tpu_torch.models.convert import (
    flax_leaf_map,
    state_dict_from_flax,
)
from audio_training_tpu_torch.models.layers import (
    KerasBatchNorm,
    MagTransform,
    PCENLayer,
)

F32_REL = 1e-4
NUM_LABELS = 7
FEATURE_SHAPES = {"short_f": (68, 60), "mid_f": (136, 3),
                  "embedding": (1280,)}
PCEN_PARAMS = {"gain": 0.9, "bias": 1.5, "root": 2.5, "smooth": 0.1}


def _residual_branch_bn(m):
    """The BatchNorm that ends a residual block's branch, if ``m`` is one."""
    kind = getattr(m, "flax_kind", None)
    if kind in ("MBConv", "InvertedResidual") and m.residual:
        return m.project_bn if m.project_bn is not None else m.expand_bn
    if kind in ("BottleneckV1", "IdentityBlock", "ConvolutionalBlock"):
        return m.bn3
    return None


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _fill(node, rng, scope=""):
    out = {}
    for k, v in node.items():
        if hasattr(v, "items"):
            out[k] = _fill(v, rng, k)
            continue
        shape = v.shape
        if k == "kernel":
            a = rng.normal(0.0, np.sqrt(2.0 / np.prod(shape[:-1])), shape)
        elif k == "scale":
            a = rng.uniform(0.3, 0.8, shape)
        elif scope == "PCENLayer_0":
            a = np.full(shape, PCEN_PARAMS[k])
        elif k == "bias":
            a = rng.normal(0.0, 0.05, shape)
        elif k == "a_power":
            a = np.full(shape, -0.6)
        else:  # BatchNorm statistics, calibrated later
            a = np.zeros(shape) if k == "mean" else np.ones(shape)
        out[k] = a.astype(np.float32)
    return out


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def inputs_for(spec, mel_shape, seed, batch=None):
    """numpy inputs of ``spec.inputs``: mel images of ``mel_shape`` (mel
    power when the model has its own frontend, else a PCEN-like image in
    [-1, 1]) and feature / embedding vectors."""
    rng = np.random.default_rng(seed)
    b = batch or mel_shape[0]
    power = any(isinstance(m, (MagTransform, PCENLayer))
                for m in spec.port.modules())
    out = []
    for name in spec.inputs:
        if name.startswith("mel"):
            shape = (b,) + tuple(mel_shape[1:])
            x = rng.gamma(2.0, 50.0, shape) if power else rng.uniform(
                -1.0, 1.0, shape)
        else:
            x = rng.normal(0.0, 1.0, (b,) + FEATURE_SHAPES[name])
        out.append(x.astype(np.float32))
    return out


def calibrate(model, variables, batch, rng, seed=2):
    """Each BatchNorm of the port's ``model`` gets its own input's float64
    batch moments on ``batch`` (a train-mode pass), perturbed from ``rng``;
    every residual branch's last BN scale is set to U(0.05, 0.15); the
    BatchNorms' variables are then written into the Flax ``variables``."""
    moments = {}

    def hook(mod, args):
        x = args[0].double()
        dims = [d for d in range(x.ndim) if d != mod.feature_dim]
        moments[mod] = (x.mean(dims), x.var(dims, unbiased=False))

    with torch.no_grad():
        for m in model.modules():
            last = _residual_branch_bn(m)
            if last is not None:
                last.weight.copy_(torch.from_numpy(rng.uniform(
                    0.05, 0.15, last.weight.shape[0])))
        hooks = [m.register_forward_pre_hook(hook)
                 for m in model.modules() if isinstance(m, KerasBatchNorm)]
        model.train()
        kw = ({"generator": torch.Generator().manual_seed(seed)}
              if "generator" in inspect.signature(model.forward).parameters
              else {})
        model(*batch, **kw)
        for h in hooks:
            h.remove()
        for m, (mean, var) in moments.items():
            n = mean.shape[0]
            m.running_mean.copy_(mean + 0.02 * var.sqrt()
                                 * torch.from_numpy(rng.normal(0, 1, n)))
            m.running_var.copy_(var * torch.from_numpy(
                rng.uniform(0.9, 1.1, n)))
    sd = model.state_dict()
    for path, (key, _) in flax_leaf_map(model).items():
        if path[0] == "batch_stats" or path[-2] == "BatchNorm_0":
            _set(variables, path, sd[key].numpy().astype(np.float32))
    model.eval()


class Pair:
    """A JAX model and the port's of one name and options, with shared
    randomized weights; ``inputs`` are the module's input names."""

    def __init__(self, name, mel_shape, seed=0, jax_kw=None, port_kw=None,
                 num_labels=NUM_LABELS):
        jax_kw, port_kw = dict(jax_kw or {}), dict(port_kw or {})
        self.name, self.mel_shape = name, tuple(mel_shape)
        self.jax = jax_build_model(name, num_labels, logits_only=True,
                                   **jax_kw)
        self.inputs = self.jax.inputs
        geometry = dict(n_mels=mel_shape[1], mel_frames=mel_shape[2])
        if "mel" in self.inputs:
            port_kw.setdefault("in_channels", mel_shape[3])
        self.port = build_model(name, num_labels, logits_only=True,
                                **geometry, **jax_kw, **port_kw).module
        self.rng = np.random.default_rng(seed + 100)
        x = [jnp.asarray(a) for a in inputs_for(self, mel_shape, seed + 1)]
        shapes = jax.eval_shape(lambda: self.jax.module.init(
            {"params": jax.random.PRNGKey(0)}, *x, train=False))
        self.variables = _fill(jax.tree_util.tree_map(lambda a: a,
                                                      dict(shapes)), self.rng)
        self.port.load_state_dict(state_dict_from_flax(self.port,
                                                       self.variables))

    def calibrate(self, inputs, seed=2):
        """BN statistics from ``inputs`` plus six more (:func:`calibrate`),
        written into both models."""
        more = inputs_for(self, self.mel_shape, seed, batch=6)
        batch = [torch.from_numpy(np.concatenate([a, b]))
                 for a, b in zip(inputs, more)]
        calibrate(self.port, self.variables, batch, self.rng, seed)
        return self

    def logits(self, inputs):
        want = np.asarray(self.jax.module.apply(
            self.variables, *[jnp.asarray(a) for a in inputs], train=False))
        with torch.no_grad():
            got = self.port(*[torch.from_numpy(a) for a in inputs]).numpy()
        return got, want


def check_family(name, mel_shape, jax_kw=None, port_kw=None, seed=0):
    """f32 logits of the port within F32_REL of max |logit| of the Flax
    model's on converted weights, on two inputs whose logits differ by far
    more than that."""
    pair = Pair(name, mel_shape, seed, jax_kw, port_kw)
    inputs = inputs_for(pair, mel_shape, seed + 1)
    got, want = pair.calibrate(inputs).logits(inputs)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(want).all()
    err = rel(got, want)
    assert err < F32_REL, (name, err)
    assert rel(want[0], want[1]) > 100 * F32_REL, name
    return pair, err
