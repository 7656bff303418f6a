"""Flax variables -> the port's ``state_dict``.

The Flax tree comes as a nested dict of arrays (numpy, or anything
``np.asarray`` takes); nothing of JAX is imported.  Conv kernels are HWIO in
Flax and OIHW in torch; Flax BN ``scale``/``bias``/``mean``/``var`` are
torch's ``weight``/``bias``/``running_mean``/``running_var``.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: dict, name: str, node) -> None:
    """Flax conv ``{kernel (HWIO), bias}`` -> ``name.weight`` (OIHW),
    ``name.bias``."""
    sd[f"{name}.weight"] = _t(node["kernel"]).permute(3, 2, 0, 1).contiguous()
    sd[f"{name}.bias"] = _t(node["bias"])


def _bn(sd: dict, name: str, params, stats) -> None:
    """Flax ``KerasBatchNorm_k`` params and batch stats -> ``name.*``."""
    p, s = params["BatchNorm_0"], stats["BatchNorm_0"]
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = _t(s["mean"])
    sd[f"{name}.running_var"] = _t(s["var"])


def badwinner2_state_dict_from_flax(variables) -> dict[str, torch.Tensor]:
    """State dict for ``models.badwinner2.BadWinner2`` from the Flax
    ``{"params": ..., "batch_stats": ...}`` of ``BadWinner2`` (big condense,
    dense head).  The tree is:

    * ``params/Conv_{0..7}/Conv_0/{kernel,bias}``, kernel HWIO;
    * ``params/KerasBatchNorm_{1..7}/BatchNorm_0/{scale,bias}``;
    * ``batch_stats/KerasBatchNorm_{0..7}/BatchNorm_0/{mean,var}``, ``_0``
      being the per-mel BN;
    * ``params/MagTransform_0/a_power``.
    """
    params, stats = variables["params"], variables["batch_stats"]
    expected = ({f"Conv_{i}" for i in range(8)}
                | {f"KerasBatchNorm_{i}" for i in range(1, 8)}
                | {"MagTransform_0"})
    if set(params) != expected or set(stats) != {
            f"KerasBatchNorm_{i}" for i in range(8)}:
        raise ValueError(
            "not a badwinner2 (big condense, dense head) variable tree: "
            f"params {sorted(params)}, batch_stats {sorted(stats)}"
        )
    sd = {"mag.a_power": _t(params["MagTransform_0"]["a_power"])}
    mel_bn = stats["KerasBatchNorm_0"]["BatchNorm_0"]
    sd["mel_bn.running_mean"] = _t(mel_bn["mean"])
    sd["mel_bn.running_var"] = _t(mel_bn["var"])
    for i in range(8):
        conv = params[f"Conv_{i}"]["Conv_0"]
        sd[f"convs.{i}.weight"] = _t(conv["kernel"]).permute(3, 2, 0, 1).contiguous()
        sd[f"convs.{i}.bias"] = _t(conv["bias"])
    for i in range(7):
        bn_p = params[f"KerasBatchNorm_{i + 1}"]["BatchNorm_0"]
        bn_s = stats[f"KerasBatchNorm_{i + 1}"]["BatchNorm_0"]
        sd[f"bns.{i}.weight"] = _t(bn_p["scale"])
        sd[f"bns.{i}.bias"] = _t(bn_p["bias"])
        sd[f"bns.{i}.running_mean"] = _t(bn_s["mean"])
        sd[f"bns.{i}.running_var"] = _t(bn_s["var"])
    return sd


MOBILENET_BLOCKS = 17


def backbone_classifier_state_dict_from_flax(
        variables) -> dict[str, torch.Tensor]:
    """State dict for ``models.registry.BackboneClassifier("mobilenet")``
    from the Flax ``{"params": ..., "batch_stats": ...}`` of the JAX
    ``BackboneClassifier`` around ``MobileNetV2``.  The tree is:

    * ``params/MobileNetV2_0``: the stem ``Conv_0/Conv_0/{kernel,bias}``
      and head ``Conv_1/Conv_0``, their ``KerasBatchNorm_{0,1}``, and
      ``InvertedResidual_{0..16}``;
    * in a block, the custom ``Conv``s (expand, project) are
      ``Conv_k/Conv_0/{kernel,bias}`` and the depthwise ``nn.Conv`` is
      ``Conv_k/{kernel,bias}`` itself, kernel ``(3, 3, 1, C)``; all share
      one ``Conv_`` counter, so block 0 (expand 1) has depthwise
      ``Conv_0`` and project ``Conv_1``, the others expand ``Conv_0``,
      depthwise ``Conv_1``, project ``Conv_2``, each followed by
      ``KerasBatchNorm_k`` of the same k;
    * ``batch_stats/MobileNetV2_0/...`` mirrors the BatchNorms;
    * ``params/Dense_0/{kernel (1280, L), bias}``, and the frontend
      ``PCENLayer_0/{gain,bias,root,smooth}`` or ``MagTransform_0/a_power``
      unless the model has an external frontend.

    Blocks are walked by number (``InvertedResidual_10`` sorts before
    ``_2``).
    """
    params, stats = variables["params"], variables["batch_stats"]
    frontends = ({"PCENLayer_0"}, {"MagTransform_0"}, set())
    ok = (set(stats) == {"MobileNetV2_0"}
          and any(set(params) == {"MobileNetV2_0", "Dense_0"} | f
                  for f in frontends))
    net, net_stats = params.get("MobileNetV2_0", {}), stats.get(
        "MobileNetV2_0", {})
    blocks = [f"InvertedResidual_{i}" for i in range(MOBILENET_BLOCKS)]
    ok = ok and set(net) == {"Conv_0", "Conv_1", "KerasBatchNorm_0",
                             "KerasBatchNorm_1", *blocks}
    ok = ok and set(net_stats) == {"KerasBatchNorm_0", "KerasBatchNorm_1",
                                   *blocks}
    if not ok:
        raise ValueError(
            "not a BackboneClassifier(mobilenet) variable tree: params "
            f"{sorted(params)}, batch_stats {sorted(stats)}"
            + (f", MobileNetV2_0 {sorted(net)}" if net else ""))
    sd = {}
    if "PCENLayer_0" in params:
        for name in ("gain", "bias", "root", "smooth"):
            sd[f"pcen.{name}"] = _t(params["PCENLayer_0"][name])
    if "MagTransform_0" in params:
        sd["mag.a_power"] = _t(params["MagTransform_0"]["a_power"])
    _conv(sd, "backbone.stem", net["Conv_0"]["Conv_0"])
    _bn(sd, "backbone.stem_bn", net["KerasBatchNorm_0"],
        net_stats["KerasBatchNorm_0"])
    for i, block in enumerate(blocks):
        p, s = net[block], net_stats[block]
        names = (["depthwise", "project"] if i == 0
                 else ["expand", "depthwise", "project"])
        if set(p) != ({f"Conv_{k}" for k in range(len(names))}
                      | {f"KerasBatchNorm_{k}" for k in range(len(names))}):
            raise ValueError(f"unexpected layers in {block}: {sorted(p)}")
        for k, name in enumerate(names):
            conv = p[f"Conv_{k}"]
            _conv(sd, f"backbone.blocks.{i}.{name}",
                  conv if name == "depthwise" else conv["Conv_0"])
            _bn(sd, f"backbone.blocks.{i}.{name}_bn",
                p[f"KerasBatchNorm_{k}"], s[f"KerasBatchNorm_{k}"])
    _conv(sd, "backbone.head", net["Conv_1"]["Conv_0"])
    _bn(sd, "backbone.head_bn", net["KerasBatchNorm_1"],
        net_stats["KerasBatchNorm_1"])
    sd["dense.weight"] = _t(params["Dense_0"]["kernel"]).T.contiguous()
    sd["dense.bias"] = _t(params["Dense_0"]["bias"])
    return sd
