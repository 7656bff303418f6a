"""Keras -> port weight transplantation (port of
``audio_training_tpu/models/transplant.py``).

Lets users of the TF reference (badwinner2.build_model, badwinner2.py:212-324;
resnet/wr_resnet.WRResNet, resnet/wr_resnet.py:5-33) carry trained weights
into the port, and imports keras.applications backbone weights
(``--backbone-weights``).

The mapping is positional, as in the JAX package: Keras functional models
enumerate layers in call order, and Flax creates its variables in call
order, so the k-th Conv2D/BatchNormalization/Dense/MagTransform on each side
correspond.  The port keeps one source of truth for Flax's order and
layout: ``models/convert.flax_leaf_map`` lays the module's tensors out as
the Flax variable tree (its modules number their layers per kind in
Flax's creation order), the JAX package's slot walk and setter run on
that numpy tree, and ``convert.state_dict_from_flax`` carries the tree
back (HWIO -> OIHW conv kernels, ``(in, out)`` -> ``(out, in)`` Dense
kernels).

The Keras walk is duck-typed: it reads class names, ``.layers``,
``.weights`` and the BatchNormalization attributes only, so it needs no
TensorFlow.  Only :func:`load_keras_backbone` imports TensorFlow, inside
the function, to build the keras.applications graph.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

from audio_training_tpu_torch.models.convert import (
    flax_leaf_map,
    state_dict_from_flax,
)

KINDS = ("conv", "bn", "dense", "mag", "pcen")
_PROBE = (2, 3, 5, 7)  # distinct sizes that reveal a layout permutation


def _walk(tree: dict, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """Depth-first leaf walk preserving dict insertion order (= Flax module
    creation order)."""
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def _set_leaf(tree: dict, path: tuple, value) -> None:
    node = tree
    for k in path[:-1]:
        node = node[k]
    old = node[path[-1]]
    if tuple(old.shape) != tuple(value.shape):
        raise ValueError(
            f"shape mismatch at {'/'.join(path)}: "
            f"flax {tuple(old.shape)} vs keras {tuple(value.shape)}"
        )
    node[path[-1]] = np.asarray(value, dtype=old.dtype)


def _flax_layout(tensor: torch.Tensor, change) -> np.ndarray:
    """The Flax-layout array whose layout change (a permutation of the
    axes: identity, HWIO -> OIHW or a transpose) gives ``tensor``."""
    probe = change(torch.empty(_PROBE[:tensor.ndim])).shape
    perm = [_PROBE.index(s) for s in probe]
    return tensor.detach().to("cpu", torch.float32).permute(
        *np.argsort(perm).tolist()).numpy().copy()


def flax_tree(module: nn.Module) -> dict:
    """The module's tensors as the Flax ``{"params": ..., "batch_stats":
    ...}`` tree of numpy arrays, scopes inserted in Flax's creation
    order."""
    sd = module.state_dict()
    tree: dict = {}
    for (coll, *path), (key, change) in flax_leaf_map(module).items():
        node = tree.setdefault(coll, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _flax_layout(sd[key], change)
    return tree


def _load_tree(module: nn.Module, tree: dict) -> nn.Module:
    module.load_state_dict(state_dict_from_flax(module, tree))
    return module


def _keras_layers_by_kind(model) -> dict[str, list]:
    """Group a Keras model's weight-bearing layers by kind, in layer order.

    Nested functional sub-models (e.g. a keras.applications backbone used as
    a layer inside the reference's classifier graph, audiomodel.py:798) are
    flattened in place.  ``DepthwiseConv2D`` rides in the ``conv`` kind —
    creation order pairs it with the grouped conv; its (k, k, C, 1) kernel
    is transposed at set time.  ``Normalization`` (the EfficientNet stem
    statistics layer) has weights but no slot: its constants are static
    module attributes (backbones.EfficientNet.norm_mean/var), read
    separately by :func:`normalization_constants`.
    """
    kinds: dict[str, list] = {k: [] for k in KINDS}
    for layer in model.layers:
        name = type(layer).__name__
        if hasattr(layer, "layers") and layer.layers:
            sub = _keras_layers_by_kind(layer)
            for k in kinds:
                kinds[k].extend(sub[k])
            continue
        if not layer.weights:
            continue
        if name in ("Conv2D", "DepthwiseConv2D"):
            kinds["conv"].append(layer)
        elif name == "BatchNormalization":
            kinds["bn"].append(layer)
        elif name == "Dense":
            kinds["dense"].append(layer)
        elif "MagTransform" in name:
            kinds["mag"].append(layer)
        elif name == "PCEN":
            kinds["pcen"].append(layer)
        elif name == "Normalization":
            continue  # static constants, not a transplant slot
        else:
            raise ValueError(f"unhandled Keras layer kind: {name}")
    return kinds


def normalization_constants(model):
    """Extract the (mean, variance) of a keras ``Normalization`` layer if the
    model (or a nested sub-model) has one — the EfficientNet stem stores the
    ImageNet statistics there when pretrained weights are loaded."""
    for layer in model.layers:
        if hasattr(layer, "layers") and layer.layers:
            found = normalization_constants(layer)
            if found is not None:
                return found
        if type(layer).__name__ == "Normalization" and layer.weights:
            mean = np.asarray(layer.mean).reshape(-1)
            var = np.asarray(layer.variance).reshape(-1)
            return tuple(float(v) for v in mean), tuple(
                float(v) for v in var
            )
    return None


def _flax_slots(variables) -> dict[str, list]:
    """Collect transplant slots from a Flax variables tree, in creation
    order.  Each slot is a dict of path tuples."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    slots: dict[str, list] = {k: [] for k in KINDS}
    bn_params: dict[tuple, dict] = {}
    pcen_paths: dict[tuple, dict] = {}
    for path, _leaf in _walk(params):
        owner, leaf = path[:-1], path[-1]
        owner_name = owner[-1] if owner else ""
        if owner_name.startswith("Conv_") and leaf == "kernel":
            slots["conv"].append({"kernel": path, "bias": owner + ("bias",)})
        elif owner_name.startswith("Dense_") and leaf == "kernel":
            slots["dense"].append({"kernel": path, "bias": owner + ("bias",)})
        elif owner_name.startswith("BatchNorm_"):
            bn_params.setdefault(owner, {})[leaf] = path
        elif leaf == "a_power":
            slots["mag"].append({"a": path})
        elif owner_name.startswith("PCENLayer_"):
            pcen_paths.setdefault(owner, {})[leaf] = path
    for path, _leaf in _walk(stats):
        owner, leaf = path[:-1], path[-1]
        if owner[-1].startswith("BatchNorm_"):
            bn_params.setdefault(owner, {})[leaf] = ("batch_stats",) + path
    # every BN has statistics: the walk over them gives the call order,
    # scale-free BNs included
    ordered_bn = []
    seen = set()
    for path, _leaf in _walk(stats):
        owner = path[:-1]
        if owner[-1].startswith("BatchNorm_") and owner not in seen:
            seen.add(owner)
            ordered_bn.append(bn_params[owner])
    slots["bn"] = ordered_bn
    slots["pcen"] = list(pcen_paths.values())
    return slots


def module_slots(module: nn.Module) -> dict[str, list]:
    """The module's transplant slots (Flax paths), in the order the Keras
    layers pair with them (JAX ``_flax_slots``)."""
    return _flax_slots(flax_tree(module))


def _transplant_tree(tree: dict, keras_model) -> dict:
    """Copy a Keras model's weights into a Flax-layout numpy ``tree``
    (``{"params": ..., "batch_stats": ...}``), in place; returns it.

    Raises if the two models don't pair up layer-for-layer."""
    kinds = _keras_layers_by_kind(keras_model)
    slots = _flax_slots(tree)

    def set_path(path, value):
        if path[0] == "batch_stats":
            _set_leaf(tree["batch_stats"], path[1:], value)
        else:
            _set_leaf(tree["params"], path, value)

    for kind in ("conv", "dense", "bn", "mag", "pcen"):
        if len(kinds[kind]) != len(slots[kind]):
            raise ValueError(
                f"{kind}: keras has {len(kinds[kind])} layers, "
                f"flax has {len(slots[kind])} slots"
            )

    for layer, slot in zip(kinds["conv"] + kinds["dense"],
                           slots["conv"] + slots["dense"]):
        kernel = layer.weights[0].numpy()
        if type(layer).__name__ == "DepthwiseConv2D":
            # keras depthwise (k, k, C, mult=1) -> grouped-conv (k, k, 1, C)
            kernel = kernel.transpose(0, 1, 3, 2)
        set_path(slot["kernel"], kernel)
        if getattr(layer, "use_bias", True) and layer.bias is not None:
            set_path(slot["bias"], layer.bias.numpy())

    for layer, slot in zip(kinds["bn"], slots["bn"]):
        if layer.gamma is not None and "scale" in slot:
            set_path(slot["scale"], layer.gamma.numpy())
        if layer.beta is not None and "bias" in slot:
            set_path(slot["bias"], layer.beta.numpy())
        set_path(slot["mean"], layer.moving_mean.numpy())
        set_path(slot["var"], layer.moving_variance.numpy())

    for layer, slot in zip(kinds["mag"], slots["mag"]):
        # badwinner v1's MagTransform stores a scalar (), v2 a (1,) vector
        # (badwinner.py:31-44 vs badwinner2.py:32-49); the port uses (1,)
        set_path(slot["a"], layer.weights[0].numpy().reshape(-1))

    for layer, slot in zip(kinds["pcen"], slots["pcen"]):
        by_name = {w.name.split("/")[-1].split(":")[0]: w for w in layer.weights}
        for tf_name, flax_name in (
            ("gain", "gain"), ("bias", "bias"), ("root", "root"),
            ("smooth", "smooth"),
        ):
            for key, w in by_name.items():
                if tf_name in key and flax_name in slot:
                    set_path(slot[flax_name], w.numpy().reshape(-1)[:1])
                    break
    return tree


def transplant_keras_weights(module: nn.Module, keras_model) -> nn.Module:
    """Copy a Keras model's weights into ``module`` (in place; returned).

    Raises if the two models don't pair up layer-for-layer; the module is
    then left as it was."""
    return _load_tree(module, _transplant_tree(flax_tree(module), keras_model))


# ---------------------------------------------------------------------------
# Pretrained-backbone weight import (audiomodel.get_base_model's
# weights="imagenet" path, audiomodel.py:972-1141) — gated on a locally
# available weight file, as the embedding models are (infer/embeddings.py).
# ---------------------------------------------------------------------------

# keras.applications constructor per registry backbone name
_KERAS_APP_BUILDERS = {
    "resnet": "ResNet50",
    "resnetv2": "ResNet50V2",
    "resnet152": "ResNet152",
    "vgg16": "VGG16",
    "vgg19": "VGG19",
    "mobilenet": "MobileNetV2",
    "densenet121": "DenseNet121",
    "efficientnetb0": "EfficientNetB0",
    "efficientnetb1": "EfficientNetB1",
    "efficientnetb5": "EfficientNetB5",
    "efficientnetv2b0": "EfficientNetV2B0",
    "efficientnetv2b3": "EfficientNetV2B3",
    "efficientnetv2bs": "EfficientNetV2S",
    "efficientnetv2bm": "EfficientNetV2M",
    "inceptionv3": "InceptionV3",
    "inceptionresnetv2": "InceptionResNetV2",
}

# keras.applications.efficientnet IMAGENET_STDDEV_RGB — the graph built with
# weights="imagenet" appends Rescaling(1/sqrt(std)), a keras quirk
IMAGENET_STDDEV_RGB = (0.229, 0.224, 0.225)


def load_keras_backbone(model_name: str, weights_path, input_shape,
                        imagenet_stats: bool = True):
    """Build the keras.applications graph for ``model_name`` and load a
    LOCAL weight file into it (TF required; no downloads).  Returns
    ``(keras_model, backbone_args)`` where ``backbone_args`` are the static
    constants (EfficientNet normalization statistics + imagenet rescale) to
    pass to the backbone constructor (``build_model(...,
    backbone_args=...)``).

    ``imagenet_stats`` controls the EfficientNet-v1 1/sqrt(std) rescale:
    keras adds that layer ONLY when building with ``weights="imagenet"``,
    so it belongs with the official ImageNet notop files (the documented
    use of --backbone-weights); pass False for a weight file saved from a
    ``weights=None`` graph (e.g. your own fine-tuned checkpoint)."""
    import os

    name = model_name.lower()
    if name not in _KERAS_APP_BUILDERS:
        raise ValueError(
            f"{model_name!r} is not a keras.applications backbone; "
            f"importable: {sorted(_KERAS_APP_BUILDERS)}"
        )
    if not os.path.exists(str(weights_path)):
        raise FileNotFoundError(
            f"backbone weight file not found: {weights_path} — download the "
            "keras.applications 'notop' weight file on a connected machine "
            "and point --backbone-weights at it"
        )
    try:
        import tensorflow as tf
    except Exception as e:
        raise RuntimeError(
            "importing backbone weights requires tensorflow/keras to build "
            "the source graph"
        ) from e
    tf.config.set_visible_devices([], "GPU")
    builder = getattr(tf.keras.applications, _KERAS_APP_BUILDERS[name])
    model = builder(weights=None, include_top=False, input_shape=input_shape)
    model.load_weights(str(weights_path))

    backbone_args = []
    norm = normalization_constants(model)
    if norm is not None:
        mean, var = norm
        backbone_args += [("norm_mean", mean), ("norm_var", var)]
    if imagenet_stats and name.startswith("efficientnet") and not (
        name.startswith("efficientnetv2")
    ):
        # official imagenet EfficientNet weights expect the extra
        # 1/sqrt(std) rescale keras adds for weights="imagenet"
        backbone_args.append(
            ("extra_rescale",
             tuple(1.0 / v**0.5 for v in IMAGENET_STDDEV_RGB))
        )
    return model, tuple(backbone_args)


def transplant_backbone_into_classifier(module: nn.Module,
                                        keras_model) -> nn.Module:
    """Copy a keras backbone's weights into the backbone of a
    ``BackboneClassifier`` (in place; returned).  The PCEN frontend and
    Dense head keep their fresh init, exactly like the reference which
    trains those from scratch on top of the pretrained trunk."""
    tree = flax_tree(module)
    params = tree["params"]
    skip = ("PCENLayer", "MagTransform", "Dense", "LMELayer")
    backbone_keys = [
        k for k in params
        if hasattr(params[k], "items") and not k.startswith(skip)
    ]
    if len(backbone_keys) != 1:
        raise ValueError(
            f"expected exactly one backbone submodule, found {backbone_keys}"
        )
    key = backbone_keys[0]
    sub = {"params": params[key]}
    stats = tree.get("batch_stats", {})
    if key in stats:
        sub["batch_stats"] = stats[key]
    _transplant_tree(sub, keras_model)  # the sub-trees are tree's own
    return _load_tree(module, tree)
