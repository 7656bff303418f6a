"""Model registry — the ``build_model`` dispatch (port of
``audio_training_tpu/models/registry.py``; audiomodel.py:660-876).

Every name of JAX's ``MODEL_NAMES`` builds: ``badwinner2``,
``badwinner2-res``, ``badwinner``, ``dual-badwinner2``, ``merge``,
``cnn-features``, ``embeddings``, ``wr-resnet``, ``wr-resnet-bird`` and
each backbone of :data:`models.backbones.BACKBONES` behind the
``BackboneClassifier`` adapter.  ``rf-features`` is not a neural model:
:func:`build_random_forest` returns the forest (scikit-learn, imported only
there).

A torch module must know its parameter shapes when it is built, where Flax
reads them off the first input: ``build_model`` takes the mel image's
geometry (``n_mels``, ``mel_frames``) and hands it to the models whose
shapes depend on it.  Module names map onto the Flax tree
(``models/convert.py``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
from torch import nn

from audio_training_tpu_torch.data.schema import (
    MID_FEATURES_SHAPE,
    SHORT_FEATURES_SHAPE,
)
from audio_training_tpu_torch.models.backbones import BACKBONES
from audio_training_tpu_torch.models.badwinner import BadWinner
from audio_training_tpu_torch.models.badwinner2 import BadWinner2, BadWinner2Res
from audio_training_tpu_torch.models.layers import (
    Dense,
    LMELayer,
    MagTransform,
    PCENLayer,
    dropout,
    global_avg_pool,
)
from audio_training_tpu_torch.models.wr_resnet import WRResNet
from audio_training_tpu_torch.models.wr_resnet_bird import WRResNetBird
from audio_training_tpu_torch.utils.profiling import setup_span

EMBEDDING_DIM = 1280  # Perch (tfdatasetembeddings.py:70)


def _head(x: torch.Tensor, logits_only: bool,
          multi_label: bool) -> torch.Tensor:
    if logits_only:
        return x
    return torch.sigmoid(x) if multi_label else torch.softmax(x, -1)


class FeatureCNN(nn.Module):
    """Dense tower over the short / mid audio features
    (audiomodel.feature_cnn, audiomodel.py:2770-2787): two Dense-128 + ReLU,
    dropout 0.1, mean over the first feature axis, Dense(num_labels) +
    sigmoid, per branch.  The layers are registered alternating the two
    towers per depth, Flax's creation order (short-d1, mid-d1, short-d2,
    mid-d2, short-out, mid-out)."""

    flax_kind = "FeatureCNN"

    def __init__(self, num_labels: int, dtype=None, generator=None):
        super().__init__()
        dense = lambda i, o, dt=dtype: Dense(  # noqa: E731
            i, o, dtype=dt, generator=generator)
        self.short1 = dense(SHORT_FEATURES_SHAPE[1], 128)
        self.mid1 = dense(MID_FEATURES_SHAPE[1], 128)
        self.short2, self.mid2 = dense(128, 128), dense(128, 128)
        self.short_out = dense(128, num_labels, None)
        self.mid_out = dense(128, num_labels, None)

    def forward(self, short_f: torch.Tensor, mid_f: torch.Tensor,
                generator: torch.Generator | None = None):
        s, m = short_f, mid_f
        for ds, dm in ((self.short1, self.mid1), (self.short2, self.mid2)):
            s, m = torch.relu(ds(s)), torch.relu(dm(m))
        s = dropout(s, 0.1, self.training, generator)
        m = dropout(m, 0.1, self.training, generator)
        s = torch.sigmoid(self.short_out(s.mean(1)))
        m = torch.sigmoid(self.mid_out(m.mean(1)))
        return s, m


class CNNFeaturesModel(nn.Module):
    """``cnn-features``: feature towers -> concat -> Dense -> activation
    (audiomodel.py:751-765)."""

    flax_kind = "CNNFeaturesModel"

    def __init__(self, num_labels: int, multi_label: bool = True,
                 logits_only: bool = False, dtype=None, generator=None):
        super().__init__()
        self.multi_label, self.logits_only = multi_label, logits_only
        self.features = FeatureCNN(num_labels, dtype=dtype,
                                   generator=generator)
        self.dense = Dense(2 * num_labels, num_labels, generator=generator)

    def forward(self, short_f, mid_f, generator=None):
        s, m = self.features(short_f, mid_f, generator)
        out = self.dense(torch.cat([s, m], -1))
        return _head(out, self.logits_only, self.multi_label)


class MergeModel(nn.Module):
    """``merge``: badwinner2's output ++ the feature towers -> Dense ->
    activation (audiomodel.py:674-708)."""

    flax_kind = "MergeModel"

    def __init__(self, num_labels: int, n_mels: int = 160,
                 in_channels: int = 1, multi_label: bool = True,
                 lme: bool = False, logits_only: bool = False, dtype=None,
                 generator=None):
        super().__init__()
        self.multi_label, self.logits_only = multi_label, logits_only
        self.badwinner2 = BadWinner2(
            num_labels, n_mels=n_mels, in_channels=in_channels,
            multi_label=multi_label, lme=lme, dtype=dtype,
            generator=generator)
        self.features = FeatureCNN(num_labels, dtype=dtype,
                                   generator=generator)
        self.dense = Dense(3 * num_labels, num_labels, generator=generator)

    def forward(self, mel, short_f, mid_f, generator=None):
        bw = self.badwinner2(mel, generator)
        s, m = self.features(short_f, mid_f, generator)
        out = self.dense(torch.cat([bw, s, m], -1))
        return _head(out, self.logits_only, self.multi_label)


class DualBadWinner2(nn.Module):
    """``dual-badwinner2``: two badwinner2 trunks on two mel views, concat,
    Dense, activation (audiomodel.py:709-740)."""

    flax_kind = "DualBadWinner2"

    def __init__(self, num_labels: int, n_mels: int = 160,
                 in_channels: int = 1, multi_label: bool = True,
                 lme: bool = False, logits_only: bool = False, dtype=None,
                 generator=None):
        super().__init__()
        self.multi_label, self.logits_only = multi_label, logits_only
        self.trunks = nn.ModuleList(
            BadWinner2(num_labels, n_mels=n_mels, in_channels=in_channels,
                       multi_label=multi_label, lme=lme, dtype=dtype,
                       generator=generator) for _ in range(2))
        self.dense = Dense(2 * num_labels, num_labels, generator=generator)

    def forward(self, mel_a, mel_b, generator=None):
        a = self.trunks[0](mel_a, generator)
        b = self.trunks[1](mel_b, generator)
        out = self.dense(torch.cat([a, b], -1))
        return _head(out, self.logits_only, self.multi_label)


class LinearEmbeddings(nn.Module):
    """``embeddings``: a linear probe over (Perch-style) embedding vectors
    (audiomodel.get_linear_model, audiomodel.py:2595-2603)."""

    flax_kind = "LinearEmbeddings"

    def __init__(self, num_labels: int, logits_only: bool = False,
                 generator=None):
        super().__init__()
        self.logits_only = logits_only
        self.dense = Dense(EMBEDDING_DIM, num_labels, generator=generator)

    def forward(self, x, generator=None):
        x = self.dense(x)
        return x if self.logits_only else torch.sigmoid(x)


@dataclass(frozen=True)
class ModelSpec:
    """What inputs a model takes; used by the train/infer harness."""

    module: nn.Module
    inputs: tuple[str, ...]  # e.g. ("mel",) or ("short_f", "mid_f")


class BackboneClassifier(nn.Module):
    """Pretrained-backbone adapter (JAX ``registry.py:151-194``,
    audiomodel.py:784-820): PCEN (or MagTransform) frontend -> backbone ->
    optional LME -> global average pool in the compute dtype, then f32 ->
    Dropout -> f32 Dense on the backbone's ``out_channels`` -> sigmoid /
    softmax / logits.

    The input is NHWC ``(B, mel, frames, C)`` as in the JAX package; the
    frontend runs on it (PCEN's time axis is 2), the backbone on its NCHW
    view.  ``external_frontend=True`` takes an image that is already
    PCEN'd (the fused featurizer's epilogue) and builds no frontend.
    ``backbone_args`` are the backbone's own constructor arguments as
    (name, value) pairs, e.g. EfficientNet's normalization constants or
    EfficientNetV2's ``preprocess``.  ``.train()`` is Flax's
    ``train=True``: BatchNorm on batch moments and dropout drawn from the
    ``generator`` given to ``forward``."""

    def __init__(
        self,
        backbone_name: str,
        num_labels: int,
        in_channels: int = 3,
        multi_label: bool = True,
        lme: bool = False,
        use_pcen: bool = True,
        dropout: float = 0.5,
        logits_only: bool = False,
        backbone_args: tuple = (),
        external_frontend: bool = False,
        dtype: torch.dtype | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.backbone_name = backbone_name
        self.backbone_args = tuple(backbone_args)
        self.multi_label = multi_label
        self.logits_only = logits_only
        self.dropout = dropout
        self.pcen = self.mag = None
        if not external_frontend:
            if use_pcen:
                self.pcen = PCENLayer(time_axis=2)
            else:
                self.mag = MagTransform()
        self.backbone = BACKBONES[backbone_name](
            in_channels, dtype=dtype, generator=generator,
            **dict(self.backbone_args))
        self.lme = (nn.Sequential(LMELayer(dim=2, sharpness=5),
                                  LMELayer(dim=3, sharpness=5))
                    if lme else None)
        self.dense = Dense(self.backbone.out_channels, num_labels,
                           generator=generator)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: (B, mel, frames, C) -> (B, num_labels) f32."""
        if self.pcen is not None:
            x = self.pcen(x)
        elif self.mag is not None:
            x = self.mag(x)
        x = self.backbone(x.permute(0, 3, 1, 2))
        if self.lme is not None:
            x = self.lme(x)
        x = global_avg_pool(x).float()
        x = self.dense(dropout(x, self.dropout, self.training, generator))
        return _head(x, self.logits_only, self.multi_label)


@setup_span("setup.build_model")
def build_model(
    model_name: str,
    num_labels: int,
    multi_label: bool = True,
    lme: bool = False,
    logits_only: bool = False,
    dtype: torch.dtype | None = None,
    n_mels: int = 160,
    mel_frames: int = 513,
    **kwargs,
) -> ModelSpec:
    """Build a model by reference CLI name (audiomodel.py:660-876).

    ``n_mels`` / ``mel_frames`` are the mel image's geometry; badwinner2,
    badwinner2-res, dual-badwinner2 and merge take ``n_mels`` (their
    per-mel-row BN and condense), wr-resnet-bird both (under
    ``keras_slip_compat`` its widths and Dense read them), the others
    ignore them.  ``kwargs`` go to the model: ``in_channels``,
    ``generator`` and the JAX module's own fields (``dropout``,
    ``external_frontend``, ``big_condense``, ``use_pcen``,
    ``backbone_args``, ``keras_slip_compat``, ...); ``embeddings`` takes
    ``generator`` only, as JAX's passes its probe none."""
    name = model_name.lower()
    common = dict(multi_label=multi_label, logits_only=logits_only,
                  dtype=dtype)
    mel = ("mel",)
    if name == "badwinner2":
        return ModelSpec(BadWinner2(num_labels, n_mels=n_mels, lme=lme,
                                    **common, **kwargs), mel)
    if name == "badwinner2-res":
        return ModelSpec(BadWinner2Res(num_labels, n_mels=n_mels, **common,
                                       **kwargs), mel)
    if name == "badwinner":
        return ModelSpec(BadWinner(num_labels, **common, **kwargs), mel)
    if name == "dual-badwinner2":
        return ModelSpec(DualBadWinner2(num_labels, n_mels=n_mels, lme=lme,
                                        **common, **kwargs), ("mel", "mel2"))
    if name == "merge":
        return ModelSpec(MergeModel(num_labels, n_mels=n_mels, lme=lme,
                                    **common, **kwargs),
                         ("mel", "short_f", "mid_f"))
    if name == "cnn-features":
        return ModelSpec(CNNFeaturesModel(num_labels, **common, **kwargs),
                         ("short_f", "mid_f"))
    if name == "embeddings":
        return ModelSpec(LinearEmbeddings(num_labels, logits_only=logits_only,
                                          generator=kwargs.get("generator")),
                         ("embedding",))
    if name == "wr-resnet":
        return ModelSpec(WRResNet(num_labels, logits_only=logits_only,
                                  dtype=dtype, **kwargs), mel)
    if name == "wr-resnet-bird":
        return ModelSpec(WRResNetBird(num_labels, n_mels=n_mels,
                                      mel_frames=mel_frames,
                                      logits_only=logits_only, dtype=dtype,
                                      **kwargs), mel)
    if name in BACKBONES:
        return ModelSpec(BackboneClassifier(name, num_labels, lme=lme,
                                            **common, **kwargs), mel)
    if name == "rf-features":
        raise ValueError(
            "rf-features is a random-forest model; use "
            "audio_training_tpu_torch.models.registry.build_random_forest"
        )
    raise ValueError(f"Unknown model name: {model_name}")


def fold_gray_stem(model: BackboneClassifier) -> BackboneClassifier:
    """Exact-math serving fold (JAX ``registry.py:272-330``): a copy of
    ``model`` whose one 3-input-channel conv kernel (the stem) is summed
    over its input channels, so that it takes the 1-channel mel image that
    the reference repeats to 3 channels (tfdataset.py:175-180):
    ``conv(repeat(x, 3), W) == conv(x, W.sum(1))``.  Everything ahead of
    the stem must treat the channels alike, so a backbone with per-channel
    normalization constants (``backbone_args``) or an EfficientNetV2 with
    ``preprocess`` (its B variants apply ImageNet constants to a 3-channel
    input) is refused, with JAX's messages."""
    if not isinstance(model, BackboneClassifier):
        raise ValueError("fold_gray_stem only applies to BackboneClassifier")
    args = dict(model.backbone_args)
    for key in ("norm_mean", "norm_var", "extra_rescale"):
        vals = args.get(key, ())
        if len(vals):
            raise ValueError(
                f"backbone applies per-channel {key}={vals}; the gray fold "
                "requires identity preprocessing (empty norm constants)"
            )
    if model.backbone_name.startswith("efficientnetv2") and args.get(
            "preprocess", True):
        raise ValueError(
            "EfficientNetV2 B-variants bake per-channel ImageNet "
            "normalization constants on 3-channel input "
            "(models/backbones.EfficientNetV2.preprocess); build with "
            "backbone_args=(('preprocess', False),) to fold"
        )
    folded = copy.deepcopy(model)
    stems = [m for m in folded.modules()
             if getattr(m, "weight", None) is not None
             and m.weight.ndim == 4 and m.weight.shape[1] == 3]
    if len(stems) != 1:
        raise ValueError(
            f"expected exactly one 3-input-channel conv kernel (the stem), "
            f"found {len(stems)}")
    stem = stems[0]
    stem.weight = nn.Parameter(stem.weight.detach().sum(1, keepdim=True))
    return folded


def rf_backends() -> list[str]:
    """Random-forest backends the port offers.  JAX prefers ydf's learner
    when ydf is installed; the port does not depend on ydf, so scikit-learn
    is its one backend."""
    return ["sklearn"]


def build_random_forest(backend: str | None = None, **kwargs):
    """Random forest for ``rf-features`` (the reference's learner,
    audiomodel.py:766-769): scikit-learn's RandomForestClassifier, imported
    here only, 300 trees unless told otherwise."""
    if backend not in (None, "sklearn"):
        raise ValueError(f"unknown rf backend {backend!r}")
    from sklearn.ensemble import RandomForestClassifier

    kwargs.setdefault("n_estimators", 300)
    return RandomForestClassifier(**kwargs)


MODEL_NAMES = (
    ["badwinner", "badwinner2", "badwinner2-res", "dual-badwinner2", "merge",
     "cnn-features", "rf-features", "embeddings", "wr-resnet",
     "wr-resnet-bird"]
    + sorted(BACKBONES.keys())
)
