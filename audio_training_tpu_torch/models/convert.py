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
