"""The EfficientNet's spans and counters (``models/backbones.py``,
``models/layers.py``) on the CPU.

Under a CPU ``torch.profiler`` an EfficientNetV2-B3 forward records its
folded stem as ``cnn.stem``, every grouped conv as ``cnn.depthwise`` (and
not ``cnn.conv``), every squeeze-excite as ``cnn.se`` (its two 1x1 convs
and SiLU inside) and every SiLU as ``cnn.act``; the ``efficientnet``
counters count 8 fused blocks, 24 depthwise ones and 24 SE gates.  In
training the stem's backward is a range of its own.  badwinner2, which
has no grouped conv and no SiLU, records none of them.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_training_tpu_torch.models import build_model
from audio_training_tpu_torch.utils import profiling

torch.set_num_threads(2)

NEW = ("cnn.stem", "cnn.depthwise", "cnn.se", "cnn.act")
# B3's convolutions: the stem; 8 fused kxk convs, 6 fused projections, 24
# expansions, 24 projections, 2 in each of 24 SE, the head; 24 depthwise
CONVS = {"cnn.stem": 1, "cnn.conv": 8 + 6 + 24 + 24 + 48 + 1,
         "cnn.depthwise": 24, "cnn.se": 48}
# SiLU: the stem, 8 fused blocks, 2 in each of 24 MBConv and 1 in its SE,
# the head
SILUS = 1 + 8 + 24 * 3 + 1


def _b3(**kw):
    return build_model("efficientnetv2b3", 7, logits_only=True,
                       external_frontend=True,
                       generator=torch.Generator().manual_seed(0),
                       **kw).module


def _image():
    g = torch.Generator().manual_seed(1)
    return torch.rand(2, 32, 64, 3, generator=g) * 2 - 1


def _ranges(events, name):
    return [(e.time_range.start, e.time_range.end) for e in events
            if e.name == name]


def _inside(t, ranges):
    return any(a <= t[0] and t[1] <= b for a, b in ranges)


def _profiled(model, x, backward=False):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = model(x)
        if backward:
            out.sum().backward()
    return list(prof.events())


def test_b3_forward_records_its_regions_and_counts_its_blocks():
    model = _b3().eval()
    profiling.reset_counts("efficientnet")
    with torch.no_grad():
        events = _profiled(model, _image())
    assert profiling.counts("efficientnet") == {"fused": 8, "mbconv": 24,
                                                "se": 24}
    spans = {n: _ranges(events, n) for n in (*NEW, "cnn.conv", "cnn.norm")}
    assert [len(spans[n]) for n in NEW] == [1, 24, 24, SILUS]
    convs = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "aten::conv2d"]
    assert len(convs) == 1 + CONVS["cnn.conv"] + CONVS["cnn.depthwise"]
    for name, n in CONVS.items():
        assert sum(_inside(c, spans[name]) for c in convs) == n, name
    # a grouped conv lies in cnn.depthwise alone, the stem's in cnn.stem
    # alone: no conv counts in two of the readers' spans
    for c in convs:
        assert sum(_inside(c, spans[n]) for n in (
            "cnn.stem", "cnn.conv", "cnn.depthwise")) == 1
    # the stem's BatchNorm is folded into cnn.stem in eval
    assert not [s for s in spans["cnn.norm"] if _inside(s, spans["cnn.stem"])]
    silus = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "aten::silu"]
    assert len(silus) == SILUS
    assert all(_inside(s, spans["cnn.act"]) for s in silus)


def test_b3_training_records_the_stems_backward():
    model = _b3(dropout=0.0).train()
    events = _profiled(model, _image(), backward=True)
    (stem,) = _ranges(events, "cnn.stem")
    (back,) = _ranges(events, "cnn.stem.backward")
    assert stem[1] <= back[0] < back[1]
    # in training the stem's BatchNorm runs as a module, inside cnn.stem
    assert [s for s in _ranges(events, "cnn.norm") if _inside(s, [stem])]
    assert len(_ranges(events, "cnn.depthwise.backward")) == 24
    assert len(_ranges(events, "cnn.se.backward")) == 24


def test_without_a_profiler_b3_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record_function was entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    with torch.no_grad():
        assert _b3().eval()(_image()).shape == (2, 7)


@pytest.mark.parametrize("train", [False, True])
def test_badwinner2_records_no_backbone_span(train):
    model = build_model("badwinner2", 7, logits_only=True, n_mels=96,
                        generator=torch.Generator().manual_seed(0)).module
    x = torch.rand(2, 96, 110, 1) * 100
    model.train(train)
    events = _profiled(model, x, backward=train)
    assert len(_ranges(events, "cnn.conv")) == 8
    assert len(_ranges(events, "cnn.norm")) == 8
    for name in NEW:
        assert not _ranges(events, name) and not _ranges(
            events, name + ".backward")
