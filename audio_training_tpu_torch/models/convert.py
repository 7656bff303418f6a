"""Flax variables -> the port's ``state_dict``, for every model family.

The Flax tree comes as a nested dict of arrays (numpy, or anything
``np.asarray`` takes); nothing of JAX is imported.  One walker serves every
model: each port module that opens a Flax scope names its Flax class
(``flax_kind``), and Flax numbers a scope's children per class in creation
order (``Conv_0``, ``Conv_1``, ``KerasBatchNorm_0``, ...), which is the
order the port's modules register them in.  Modules without a
``flax_kind`` (``ModuleList``, ``Sequential``, the port's own grouping
modules) are transparent: their children number in the enclosing scope.
Each leaf layer lists its variables (``flax_leaves``: collection, path
below its scope, torch tensor, layout change; conv kernels are HWIO in Flax
and OIHW in torch, Dense kernels (in, out) and (out, in)).

The walk is strict: every Flax leaf (and every empty scope) must be
consumed and every torch parameter and buffer filled, each with its own
shape, or the tree is refused with a ``ValueError``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable

import numpy as np
import torch
from torch import nn

Leaf = tuple[str, Callable[[torch.Tensor], torch.Tensor]]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def flax_leaf_map(model: nn.Module) -> dict[tuple[str, ...], Leaf]:
    """``(collection, *Flax path)`` -> (torch ``state_dict`` key, layout
    change) for every Flax variable of ``model``."""
    out: dict[tuple[str, ...], Leaf] = {}

    def walk(module: nn.Module, prefix: str, path: tuple[str, ...],
             counts: dict[str, int]) -> None:
        for name, child in module.named_children():
            key = prefix + name
            kind = getattr(child, "flax_kind", None)
            if kind is None:  # transparent: numbered in this scope
                walk(child, key + ".", path, counts)
                continue
            scope = path + (f"{kind}_{counts.get(kind, 0)}",)
            counts[kind] = counts.get(kind, 0) + 1
            leaves = getattr(child, "flax_leaves", None)
            for coll, rel, tensor, change in (leaves() if leaves else ()):
                out[(coll, *scope, *rel)] = (f"{key}.{tensor}", change)
            walk(child, key + ".", scope, {})

    walk(model, "", (), {})
    return out


def _flatten(tree, path=()):
    """(path, leaf) pairs of a nested mapping; an empty mapping is a leaf
    of its own (``None``), so that a stray empty scope is seen."""
    if isinstance(tree, Mapping):
        if not tree:
            yield path, None
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, tree


def state_dict_from_flax(model: nn.Module, variables, what: str | None = None,
                         check_shapes: bool = True) -> dict[str, torch.Tensor]:
    """State dict for ``model`` from the Flax ``{"params": ...,
    "batch_stats": ...}`` of the same JAX model (built with the same
    options).  A tree of another model, option or frontend mode is refused
    with ``not a <what> variable tree``; ``check_shapes=False`` leaves the
    shapes to ``load_state_dict`` (a template model of the right names)."""
    what = what or type(model).__name__
    leaves = flax_leaf_map(model)
    flat = dict(_flatten({k: v for k, v in variables.items()
                          if k in ("params", "batch_stats")}))
    missing = sorted("/".join(k) for k in leaves.keys() - flat.keys())
    extra = sorted("/".join(k) for k in flat.keys() - leaves.keys())
    if missing or extra:
        raise ValueError(
            f"not a {what} variable tree: missing {missing[:8]}"
            f"{' ...' if len(missing) > 8 else ''}, unexpected "
            f"{extra[:8]}{' ...' if len(extra) > 8 else ''}")
    sd = {tensor: change(_t(flat[k])).contiguous()
          for k, (tensor, change) in leaves.items()}
    own = model.state_dict()
    if sd.keys() != own.keys():
        raise ValueError(
            f"not a {what} variable tree: torch tensors without a Flax "
            f"variable {sorted(own.keys() - sd.keys())[:8]}")
    if check_shapes:
        bad = [f"{k} {tuple(sd[k].shape)} != {tuple(own[k].shape)}"
               for k in own if sd[k].shape != own[k].shape]
        if bad:
            raise ValueError(f"not a {what} variable tree of these shapes: "
                             f"{bad[:8]}")
    return sd


def badwinner2_state_dict_from_flax(
        variables, external_frontend: bool = False) -> dict[str, torch.Tensor]:
    """State dict for ``models.badwinner2.BadWinner2`` (big condense, dense
    head) from the Flax variables of ``BadWinner2``, without building the
    model first: its layer names do not depend on the label count, the mel
    height or the channels.  With ``external_frontend=True`` Flax creates
    neither the MagTransform nor the per-mel BN; a tree of the other kind
    is refused."""
    from audio_training_tpu_torch.models.badwinner2 import BadWinner2

    kind = "external frontend" if external_frontend else "own frontend"
    return state_dict_from_flax(
        BadWinner2(1, external_frontend=external_frontend), variables,
        f"badwinner2 (big condense, dense head, {kind})", check_shapes=False)


def badwinner2_frontend_params_from_flax(
        variables) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``frontend_params = (a_power, bn_mean, bn_var)`` for the fused
    featurizer's frontend fold, from the variables of a badwinner2 with its
    own frontend: ``params/MagTransform_0/a_power`` and
    ``batch_stats/KerasBatchNorm_0/BatchNorm_0/{mean,var}``."""
    params, stats = variables["params"], variables["batch_stats"]
    if "MagTransform_0" not in params or "KerasBatchNorm_0" in params:
        raise ValueError(
            "not the variables of a badwinner2 with its own frontend "
            "(MagTransform_0 and a scale-free KerasBatchNorm_0): params "
            f"{sorted(params)}")
    bn = stats["KerasBatchNorm_0"]["BatchNorm_0"]
    return tuple(np.array(v, dtype=np.float32) for v in (
        params["MagTransform_0"]["a_power"], bn["mean"], bn["var"]))


def backbone_classifier_state_dict_from_flax(
        variables) -> dict[str, torch.Tensor]:
    """State dict for ``BackboneClassifier("mobilenet")`` from the Flax
    variables of the JAX ``BackboneClassifier`` around ``MobileNetV2``, in
    whichever frontend mode it was built (``PCENLayer_0``,
    ``MagTransform_0`` or none); the label count and the stem's channels
    are the tree's own."""
    from audio_training_tpu_torch.models.registry import BackboneClassifier

    params = variables["params"]
    template = BackboneClassifier(
        "mobilenet", 1, use_pcen="MagTransform_0" not in params,
        external_frontend=not ({"PCENLayer_0", "MagTransform_0"}
                               & set(params)))
    return state_dict_from_flax(template, variables,
                                "BackboneClassifier(mobilenet)",
                                check_shapes=False)
