"""The port's spans and counters (``utils/profiling.py``: ``span``,
``region``, ``setup_span``, the counter registry) on the CPU.

With no profiler recording, a span or a region enters no
``record_function`` and a train step's autograd graph has the nodes it has
without them.  Under a CPU ``torch.profiler`` a badwinner2 train step
records ``train.step`` around ``train.forward`` (the convolutions and
BatchNorms inside) and ``train.backward`` (their ``.backward`` ranges
inside), with remat too, and every backward node that the profiler ties
(by ``sequence_nr``) to a forward op of a region runs inside that region's
backward range.  An eval-mode fused inference records ``infer`` and no
backward.  Set-up calls leave spans on ``CLOCK_BOOTTIME``; the three
kernel modules' launch counters are views of one registry under their
names of before.
"""

import contextlib
import importlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_training_tpu_torch.config import FeaturizerConfig
from audio_training_tpu_torch.data.preprocess import make_preprocess_fn
from audio_training_tpu_torch.infer.fused import make_fused_infer_fn
from audio_training_tpu_torch.models import build_model, layers
from audio_training_tpu_torch.train import step as train_step
from audio_training_tpu_torch.train.losses import get_loss
from audio_training_tpu_torch.train.state import create_train_state
from audio_training_tpu_torch.utils import profiling

torch.set_num_threads(2)

SHAPE = (2, 96, 110, 1)  # the shortest time axis badwinner2's head takes
NUM_LABELS = 7
EVAL_SAMPLES = 36_000  # 125 frames at hop 281: badwinner2 at 160 mels
BACKWARD = "autograd::engine::evaluate_function: "
REGIONS = ("cnn.conv", "cnn.norm")
BOUNDARY = {BACKWARD + "_OutBackward", BACKWARD + "_InBackward"}


def _model():
    return build_model("badwinner2", NUM_LABELS, logits_only=True, n_mels=96,
                       generator=torch.Generator().manual_seed(0)).module


def _batch():
    rng = np.random.default_rng(3)
    mel = torch.from_numpy(rng.gamma(2.0, 50.0, SHAPE).astype(np.float32))
    return mel, torch.eye(NUM_LABELS)[[1, 4]]


def _train_step(remat=False, profiled=False):
    """One train step of a seeded badwinner2 (dropout drawn from a seeded
    generator): the model after it, the profiler's events (or None) and
    the calls of each region's layer."""
    model = _model()
    calls = {name: 0 for name in REGIONS}
    for m in model.modules():
        name = {layers.Conv: "cnn.conv",
                layers.KerasBatchNorm: "cnn.norm"}.get(type(m))
        if name:
            m.register_forward_pre_hook(
                lambda *_, n=name: calls.__setitem__(n, calls[n] + 1))
    state = create_train_state(model, learning_rate=1e-3, device="cpu")
    mel, y = _batch()
    fn = train_step.make_train_step(remat=remat)
    args = (state, train_step.fresh_metrics(), mel, y,
            torch.Generator().manual_seed(5))
    if not profiled:
        fn(*args)
        return model, None, calls
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    return model, list(prof.events()), calls


def _ranges(events, name):
    return [(e.time_range.start, e.time_range.end) for e in events
            if e.name == name]


def _inside(t, ranges):
    return any(a <= t[0] and t[1] <= b for a, b in ranges)


def _graph_nodes(loss):
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(f for f, _ in node.next_functions)
    return len(seen)


def _loss_nodes():
    model = _model().train()
    mel, y = _batch()
    logits = model(mel, generator=torch.Generator().manual_seed(5))
    return _graph_nodes(get_loss("bce")(logits, y, 0.0, None))


def _refuse(*args, **kwargs):
    raise AssertionError("a record_function was entered")


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_no_profiler_enters_no_record_function(monkeypatch, kind):
    monkeypatch.setattr(profiling, "record_function", _refuse)
    if kind == "train":
        model, _, calls = _train_step()
        assert calls == {"cnn.conv": 8, "cnn.norm": 8}
    else:
        infer = make_fused_infer_fn(
            build_model("badwinner2", NUM_LABELS, logits_only=True).module,
            FeaturizerConfig(), device="cpu")
        assert infer(torch.rand(1, EVAL_SAMPLES)).shape == (1, NUM_LABELS)
    with profiling.span("train.step"):
        pass
    assert profiling.span("a") is profiling.span("b")


def test_without_a_profiler_the_graph_has_its_nodes(monkeypatch):
    """The loss's autograd graph counts the same nodes with the regions as
    with the layers' plain calls; under a profiler each region that needs
    a gradient adds its two boundary nodes."""
    with_regions = _loss_nodes()
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = _loss_nodes()
    monkeypatch.setattr(layers, "region", lambda name, fn, *xs: fn(*xs))
    plain = _loss_nodes()
    assert with_regions == plain
    assert profiled == plain + 2 * 16


def test_a_profiled_step_equals_the_plain_step():
    want, _, _ = _train_step()
    got, events, _ = _train_step(profiled=True)
    assert _ranges(events, "cnn.norm.backward")
    for (k, a), b in zip(want.state_dict().items(),
                         got.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_spans_nest(remat):
    _, events, calls = _train_step(remat=remat, profiled=True)
    (step,) = _ranges(events, "train.step")
    (fwd,) = _ranges(events, "train.forward")
    (bwd,) = _ranges(events, "train.backward")
    assert _inside(fwd, [step]) and _inside(bwd, [step]) and fwd[1] <= bwd[0]
    for name in REGIONS:
        spans = _ranges(events, name)
        backward = _ranges(events, name + ".backward")
        in_fwd = [s for s in spans if _inside(s, [fwd])]
        assert len(in_fwd) == (8 if remat else calls[name])
        # the recompute's forward spans nest in the backward
        assert len(in_fwd) + sum(_inside(s, [bwd]) for s in spans) \
            == len(spans) == calls[name]
        assert (len(spans) > 8) == remat
        # every backward range closed, inside train.backward
        assert len(backward) == 8
        assert all(_inside(b, [bwd]) and b[1] > b[0] for b in backward)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", REGIONS)
def test_backward_nodes_run_in_their_regions_backward(name, remat):
    """Every backward node tied by ``sequence_nr`` to a forward op of the
    region's forward (not its recompute) lies in a ``.backward`` range,
    but the boundary's own nodes, which open and close it (a forward op
    that makes no node, as a cast to the dtype a tensor has, records the
    number of the next node made: the boundary's)."""
    _, events, _ = _train_step(remat=remat, profiled=True)
    (fwd,) = _ranges(events, "train.forward")
    spans = [s for s in _ranges(events, name) if _inside(s, [fwd])]
    seqs = {e.sequence_nr for e in events
            if e.sequence_nr >= 0 and not e.name.startswith(BACKWARD)
            and _inside((e.time_range.start, e.time_range.end), spans)}
    nodes = [(e.time_range.start, e.time_range.end) for e in events
             if e.name.startswith(BACKWARD) and e.sequence_nr in seqs
             and e.name not in BOUNDARY]
    assert len(nodes) >= 8
    backward = _ranges(events, name + ".backward")
    assert all(_inside(n, backward) for n in nodes)


def test_eval_infer_records_infer_and_no_backward():
    model = build_model("badwinner2", NUM_LABELS, logits_only=True).module
    infer = make_fused_infer_fn(model, FeaturizerConfig(), device="cpu")
    raw = torch.rand(2, EVAL_SAMPLES)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        infer(raw)
    events = list(prof.events())
    (outer,) = _ranges(events, "infer")
    for name in REGIONS:
        spans = _ranges(events, name)
        assert len(spans) == 8 and all(_inside(s, [outer]) for s in spans)
    assert not [e for e in events if e.name.endswith(".backward")]


def test_region_output_in_place_is_checked_as_without_it():
    """An in-place change of a region's output that autograd refuses
    without the region is refused with it (the boundary's aliases share
    the version counter), and one it takes is taken."""
    conv = layers.Conv(1, 2, (1, 1))
    x = torch.rand(1, 1, 3, 3)
    for recording in (contextlib.nullcontext(),
                      profile(activities=[ProfilerActivity.CPU])):
        with recording:
            out = torch.relu(conv(x))
            out.add_(1.0)  # relu saved its output
            with pytest.raises(RuntimeError, match="inplace"):
                out.sum().backward()
            y = conv(x)
            y.mul_(2.0)  # nothing saved y
            y.sum().backward()


def test_setup_spans_on_the_boot_clock():
    t0 = time.clock_gettime(time.CLOCK_BOOTTIME)
    build_model("badwinner2", NUM_LABELS, n_mels=96)
    make_preprocess_fn(FeaturizerConfig(), device="cpu")
    t1 = time.clock_gettime(time.CLOCK_BOOTTIME)
    got = [name for name, a, b in profiling.setup_spans()
           if t0 <= a <= b <= t1]
    assert got[:1] == ["setup.build_model"]
    assert "setup.make_preprocess_fn" in got


COUNTERS = {
    "fused_featurizer": [
        f"fused_featurizer_mel{tier}{mode}"
        for tier in ("", "_bf16", "_bf16x3")
        for mode in ("", "_centered", "_folded")]
    + ["fused_featurizer_pcen", "clip_minmax"],
    "melspec": ["power_mel"],
    "batch_norm": ["statistics", "statistics_finalize", "apply",
                   "backward_reduce", "backward_finalize", "backward_apply"],
    "probe_megakernel": [
        "probe_dot_store", "probe_dot_accum", "probe_dot_brot",
        "probe_shift_shift1", "probe_shift_roll", "probe_shift_pool3",
        "probe_shift_copyblk"],
}


@pytest.mark.parametrize("group", sorted(COUNTERS))
def test_launch_counters_are_views_of_the_registry(group):
    module = importlib.import_module({
        "fused_featurizer": "audio_training_tpu_torch.ops.cuda.fused_featurizer",
        "melspec": "audio_training_tpu_torch.ops.cuda.melspec",
        "batch_norm": "audio_training_tpu_torch.ops.cuda.batch_norm",
        "probe_megakernel": "audio_training_tpu_torch.probes.probe_megakernel",
    }[group])
    module.reset_launch_counts()
    assert module.launch_counts() == dict.fromkeys(COUNTERS[group], 0)
    name = COUNTERS[group][-1]
    profiling.count(group, name)
    profiling.count(group, name)
    assert module.launch_counts() == profiling.counts(group)
    assert module.launch_counts()[name] == 2
    module.reset_launch_counts()
    assert not any(profiling.counts(group).values())
