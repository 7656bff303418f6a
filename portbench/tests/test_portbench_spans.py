"""The readers of the program's spans (``metrics/forward_ms.train``,
``backward_ms.train``, ``conv_ms.*``, ``norm_ms.*``, ``host_idle_ms.*``,
``setup_program_s.*``) on hand-made windows, and the trace's device side:
a range's copy on the card is no device operation."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import readers
from portbench.run import reader
from portbench.trace import UNIT, Op, Span, TraceView, view_of

PROGRAM_SPANS = ("train.step", "train.forward", "train.backward",
                 "preprocess", "normalize", "infer", "cnn.conv",
                 "cnn.conv.backward", "cnn.norm", "cnn.norm.backward")


def train_view(kind="train"):
    """Two steps, 0-50 and 50-100 us on the host.  Step one: preprocess
    0-4 (normalize 1-2 inside), train.step 5-45 with the forward 6-20
    (a conv 7-9, a norm 10-12) and the backward 22-40 (on the autograd
    thread: norm.backward 23-26, conv.backward 27-30), Adam 41-44.  Step
    two is the same 50 us later.  On the card: K1 10-14 (launched in
    preprocess), the conv 15-25, the norm 25-30, a loss op 30-31, the
    norm's backward 33-40, the conv's 40-52, Adam 55-56, then step two's
    from 60 on: the conv 65-70, the norm 70-80 and the conv's backward
    90-98."""
    ops = [
        Op("void mel_bf16_kernel<false, false>(...)", 10, 14, 3),
        Op("cudnn conv", 15, 25, 8),
        Op("bn mul", 25, 30, 11),
        Op("bce", 30, 31, 21),
        Op("bn backward", 33, 40, 24),
        Op("cudnn dgrad", 40, 52, 28),
        Op("multi_tensor_apply_kernel", 55, 56, 42),
        Op("cudnn conv", 65, 70, 58),
        Op("bn mul", 70, 80, 61),
        Op("cudnn dgrad", 90, 98, 77),
    ]
    spans = [Span(UNIT, 0, 50), Span(UNIT, 50, 100),
             Span("cudaLaunchKernel", 3, 3.2)]
    for at in (0, 50):
        spans += [Span(n, at + a, at + b) for n, a, b in [
            ("portbench.preprocess", 0, 4), ("preprocess", 0, 4),
            ("normalize", 1, 2), ("portbench.step", 5, 45),
            ("train.step", 5, 45), ("train.forward", 6, 20),
            ("cnn.conv", 7, 9), ("cnn.norm", 10, 12),
            ("train.backward", 22, 40), ("cnn.norm.backward", 23, 26),
            ("cnn.conv.backward", 27, 30), (readers.OPTIMIZER, 41, 44)]]
    return TraceView(ops, spans, 2, kind, {})


def test_forward_and_backward_split_the_step():
    v = train_view()
    # forward: the conv and the norm of both steps, the loss op outside
    assert reader("forward_ms.train")(v) == pytest.approx(
        (10 + 5 + 5 + 10) * 1e-3 / 2)
    assert reader("backward_ms.train")(v) == pytest.approx(
        (7 + 12 + 8) * 1e-3 / 2)


def test_conv_and_norm_take_forward_and_backward_once():
    v = train_view()
    assert reader("conv_ms.train")(v) == pytest.approx(
        (10 + 12 + 5 + 8) * 1e-3 / 2)
    assert reader("norm_ms.train")(v) == pytest.approx(
        (5 + 7 + 10) * 1e-3 / 2)
    # a range inside another of the same metric counts its ops once
    v.spans.append(Span("cnn.conv.backward", 26, 31))
    assert reader("conv_ms.train")(v) == pytest.approx(
        (10 + 12 + 5 + 8) * 1e-3 / 2)


def test_the_split_stays_inside_the_cnn():
    v = train_view()
    conv, norm = reader("conv_ms.train")(v), reader("norm_ms.train")(v)
    fwd, bwd = reader("forward_ms.train")(v), reader("backward_ms.train")(v)
    cnn = readers.cnn_ms(v, "train")
    assert conv + norm <= cnn + 1e-12 and fwd + bwd <= cnn + 1e-12


def test_host_idle_is_the_idle_time_under_the_programs_spans():
    """Idle on the card: 0-10, 14-15, 31-33, 52-55, 56-65, 80-90, 98-100.
    The top spans' union: 0-4, 5-45, 50-54, 55-95 (normalize inside
    preprocess counts once).  Covered: 0-4, 5-10, 14-15, 31-33, 52-54,
    56-65, 80-90: 4 + 5 + 1 + 2 + 2 + 9 + 10 = 33 us over two steps."""
    v = train_view()
    assert reader("host_idle_ms.train")(v) == pytest.approx(33e-3 / 2)
    # an overlapping span adds only the idle time it uncovers
    v.spans.append(Span("infer", 3, 8))
    assert reader("host_idle_ms.train")(v) == pytest.approx(
        (33 + 1) * 1e-3 / 2)
    covered = reader("host_idle_ms.train")(v) * 2e-3
    assert covered <= reader("idle_share.train")(v) / 100 * v.window_s


def test_serving_spans():
    """A request: normalize 0-2 and infer 3-40 (a conv 5-8, a norm 9-12)
    inside the client's request 0-45; on the card the conv 10-20 and the
    norm 20-25, the logits' copy 41-42."""
    ops = [Op("cudnn conv", 10, 20, 6), Op("bn", 20, 25, 10),
           Op("Memcpy DtoH", 41, 42, 41)]
    spans = [Span(UNIT, 0, 50), Span("portbench.request", 0, 45),
             Span("normalize", 0, 2), Span("infer", 3, 40),
             Span("cnn.conv", 5, 8), Span("cnn.norm", 9, 12)]
    v = TraceView(ops, spans, 1, "serve", {})
    assert reader("conv_ms.serve")(v) == pytest.approx(10e-3)
    assert reader("norm_ms.serve")(v) == pytest.approx(5e-3)
    # idle: 0-10, 25-41, 42-50; under normalize or infer: 0-2, 3-10, 25-40
    assert reader("host_idle_ms.serve")(v) == pytest.approx(24e-3)
    for name in ("conv_ms.train", "norm_ms.train", "host_idle_ms.train",
                 "forward_ms.train"):
        assert reader(name)(v) is None


NEW = ("forward_ms.train", "backward_ms.train", "conv_ms.train",
       "norm_ms.train", "host_idle_ms.train")


@pytest.mark.parametrize("name", NEW)
def test_a_view_without_program_spans_reads_none(name):
    v = train_view()
    v.spans = [s for s in v.spans if s.name not in PROGRAM_SPANS]
    assert reader(name)(v) is None
    assert reader(name)(train_view(kind="serve")) is None


def test_setup_program_is_the_union_of_the_set_up_spans(monkeypatch):
    from audio_training_tpu_torch.utils import profiling

    v = train_view()
    spans = [("setup.build_model", 10.0, 10.5),
             ("setup.make_preprocess_fn", 11.0, 13.0),
             ("setup.FusedFeaturizer", 11.5, 12.0),
             ("setup.load_library", 20.0, 21.25)]
    monkeypatch.setattr(profiling, "setup_spans", lambda: spans)
    assert reader("setup_program_s.train")(v) == pytest.approx(3.75)
    assert reader("setup_program_s.serve")(v) is None
    monkeypatch.setattr(profiling, "setup_spans", lambda: [])
    assert reader("setup_program_s.train")(v) is None
    # a program without set-up spans (the parent of this reader)
    monkeypatch.delattr(profiling, "setup_spans")
    assert reader("setup_program_s.train")(v) is None


def _event(name, device, start, end, id_, annotation=False):
    return SimpleNamespace(
        name=name, device_type=device, is_user_annotation=annotation,
        id=id_, linked_correlation_id=None,
        time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("name", PROGRAM_SPANS)
def test_no_device_operation_carries_a_program_span(name):
    """The profiler copies each host range onto the card as a
    ``gpu_user_annotation`` over the kernels launched inside; the view
    keeps the range as a span and its copy as no operation."""
    events = [
        _event(UNIT, DeviceType.CPU, 0, 50, 1),
        _event(name, DeviceType.CPU, 1, 20, 2, annotation=True),
        _event("cudaLaunchKernel", DeviceType.CPU, 2, 3, 3),
        _event("kernel", DeviceType.CUDA, 10, 30, 3),
        _event(name, DeviceType.CUDA, 10, 30, 4, annotation=True),
    ]
    v = view_of(events, 1, "train", {})
    assert [o.name for o in v.ops] == ["kernel"]
    assert v.ops[0].launch == 2
    assert name in {s.name for s in v.spans}
