"""The backbone zoo of the port against the Flax models: ResNet v1 / v2 /
152, VGG16/19, DenseNet121, InceptionV3 and InceptionResNetV2 behind
``BackboneClassifier`` (external frontend), each at about the smallest
image it takes (32 px a side after its five halvings; 75 for the
Inceptions), with odd sizes where the family pads SAME, B=2.  f32 logits
agree to 1e-4 of max |logit| under weights carried by
``models/convert.state_dict_from_flax`` (set-up in tests/torch_parity.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio_training_tpu_torch.models.backbones import BACKBONES
from audio_training_tpu_torch.models.layers import avg_pool, same_avg_pool3

from torch_parity import check_family

torch.set_num_threads(2)

EXTERNAL = {"external_frontend": True}


@pytest.mark.parametrize("name,shape", [
    ("resnet", (2, 33, 47, 3)),
    ("resnetv2", (2, 33, 47, 3)),
    ("resnet152", (2, 32, 40, 3)),
    ("vgg16", (2, 32, 48, 3)),
    ("vgg19", (2, 32, 40, 3)),
    ("densenet121", (2, 33, 47, 3)),
    ("inceptionv3", (2, 75, 80, 3)),
    ("inceptionresnetv2", (2, 75, 79, 3)),
])
def test_backbone_logits_match_flax(name, shape):
    pair, _ = check_family(name, shape, EXTERNAL)
    assert pair.port.dense.weight.shape[1] == pair.port.backbone.out_channels


def test_backbone_widths():
    """The Dense takes each backbone's own width (JAX's Dense infers it)."""
    widths = {name: BACKBONES[name](3).out_channels for name in BACKBONES}
    assert widths == {
        "resnet": 2048, "resnetv2": 2048, "resnet152": 2048, "vgg16": 512,
        "vgg19": 512, "mobilenet": 1280, "densenet121": 1024,
        "efficientnetb0": 1280, "efficientnetb1": 1280,
        "efficientnetb5": 2048, "efficientnetv2b0": 1280,
        "efficientnetv2b3": 1536, "efficientnetv2bs": 1280,
        "efficientnetv2bm": 1280, "inceptionv3": 2048,
        "inceptionresnetv2": 1536}


def test_pools_are_tf_s():
    """TF's SAME 3x3 average pool divides by the valid cells (1.0 at every
    border of an all-ones map, where a zero-counting pool gives 4/9 at a
    corner); the SAME average pool of wr-resnet-bird's shortcut counts the
    pad (Flax's ``count_include_pad=True``), its pad split as XLA's."""
    ones = torch.ones(1, 2, 5, 6)
    assert torch.equal(same_avg_pool3(ones), ones)
    x = torch.arange(15.0).view(1, 1, 3, 5)
    want = F.avg_pool2d(F.pad(x, (0, 1, 0, 1)), 2, 2)
    assert torch.equal(avg_pool(x, (2, 2), padding="SAME"), want)
    assert avg_pool(x, (2, 2), padding="SAME")[0, 0, -1, -1] == 14.0 / 4
    np.testing.assert_array_equal(avg_pool(x, (2, 2)).shape, (1, 1, 1, 2))
