"""The cell ``efficientnetv2b3-pcen.serve-b512``: its readers on a
hand-made window, its loop's clip-by-clip number, its workload file's
limits, and, on a CPU-sized copy of the cell, the fp8 control, an answer
copied from its neighbour's, half the answers copied and the unfolded bf16
stem of before coming out not correct.

The window: one request, 0-100 us on the host.  Launched inside it: K1's
mel kernel and PCEN epilogue, the stem, a depthwise conv, an SE (its 1x1
conv and SiLU inside), a SiLU, a 1x1 conv and a BatchNorm, then the
logits' copy."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import compare, run
from portbench.calibrate import FAULTS, control_numbers
from portbench.cell import ROOT, load_cell
from portbench.counts import cnn, k1, peaks
from portbench.loops.serve_clips import clip_gap_ratio
from portbench.trace import UNIT, Op, Span, TraceView

CELL = "efficientnetv2b3-pcen.serve-b512"
# the cell's own readers, and the serving cells' that it is listed under
READERS = ("pcen_ms.b3-serve", "pcen_roofline.b3-serve", "stem_ms.b3-serve",
           "depthwise_ms.b3-serve", "se_ms.b3-serve", "act_ms.b3-serve",
           "conv_ms.b3-serve", "mfu.serve", "k1_ms.serve", "k1_roofline.serve",
           "norm_ms.serve", "cnn_ms.serve", "idle_share.serve",
           "peak_mem_gb.serve")


def serve_view(kind="serve", pcen_launches=1):
    cell = load_cell(CELL, 1, 1.0, False, "cpu")
    ops = [Op("void mel_bf16_kernel<false, false>(...)", 0, 3, 1),
           Op("void pcen_kernel<2>(...)", 3, 4, 2),
           Op("stem conv", 5, 10, 6), Op("stem add", 10, 11, 7),
           Op("dw conv", 12, 20, 13),
           Op("se mean", 20, 21, 21), Op("se conv", 21, 22, 22),
           Op("se silu", 22, 23, 23), Op("se mul", 23, 26, 24),
           Op("silu", 26, 30, 31), Op("conv", 30, 40, 41),
           Op("bn", 40, 45, 46), Op("Memcpy DtoH", 90, 91, 90)]
    spans = [Span(UNIT, 0, 100), Span("infer", 0, 80),
             Span("cnn.stem", 5, 8), Span("cnn.depthwise", 12, 14),
             Span("cnn.se", 20, 25), Span("cnn.conv", 21.5, 22.5),
             Span("cnn.act", 22.5, 23.5), Span("cnn.act", 30, 32),
             Span("cnn.conv", 40, 42), Span("cnn.norm", 45, 47)]
    launches = {"fused_featurizer_mel_bf16": 1,
                "fused_featurizer_pcen": pcen_launches}
    return TraceView(ops, spans, 1, kind, {
        "cell": cell, "launches": launches, "window_peak_bytes": 2.5e10})


def test_each_reader_reads_its_layer():
    v = serve_view()
    read = {n.split(".")[0]: run.reader(n)(v) for n in READERS}
    assert read["k1_ms"] == pytest.approx(4e-3)
    assert read["pcen_ms"] == pytest.approx(1e-3)
    cell = v.context["cell"]
    bound = k1.bound_s("pcen_kernel", cell.batch, cell.geometry,
                       cell.workload["k1"])
    assert read["pcen_roofline"] == pytest.approx(100 * bound / 1e-6)
    mel = k1.bound_s(k1.kernel_of(v.ops[0].name), cell.batch, cell.geometry,
                     cell.workload["k1"])
    assert read["k1_roofline"] == pytest.approx(100 * (mel + bound) / 4e-6)
    assert read["stem_ms"] == pytest.approx(6e-3)
    assert read["depthwise_ms"] == pytest.approx(8e-3)
    assert read["se_ms"] == pytest.approx(6e-3)  # mean, conv, silu, mul
    # the SE's conv and SiLU count in se_ms only
    assert read["act_ms"] == pytest.approx(4e-3)
    assert read["conv_ms"] == pytest.approx(10e-3)
    assert read["norm_ms"] == pytest.approx(5e-3)
    assert read["cnn_ms"] == pytest.approx((44 - 4) * 1e-3)
    assert read["idle_share"] == pytest.approx(100 * (1 - 44 / 100))
    assert read["peak_mem_gb"] == pytest.approx(25.0)
    ops = (cnn.flops_per_clip(cell.config, 3, train=False)
           + k1.ops_per_clip(cell.geometry, cell.workload["k1"]))
    assert read["mfu"] == pytest.approx(
        100 * ops * cell.batch / 1e-4 / peaks.PEAK_BF16_FLOPS)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_none_of_a_training_window(name):
    assert run.reader(name)(serve_view(kind="train")) is None


def test_pcen_is_read_only_where_the_trace_holds_every_launch():
    v = serve_view(pcen_launches=2)
    assert run.reader("pcen_ms.b3-serve")(v) is None
    assert run.reader("pcen_roofline.b3-serve")(v) is None


def test_the_parents_program_reads_none_of_the_new_spans():
    """A program without the backbone's spans (this cell's parent) leaves
    them out of the line rather than failing the traced run."""
    v = serve_view()
    v.spans = [s for s in v.spans if s.name in (UNIT, "infer", "cnn.conv",
                                                "cnn.norm")]
    for name in ("stem_ms", "depthwise_ms", "se_ms", "act_ms"):
        assert run.reader(f"{name}.b3-serve")(v) is None


def test_the_workload_sets_a_limit_for_every_serving_number():
    workload = json.loads((ROOT / "workloads" / f"{CELL}.json").read_text())
    assert workload["traffic"]["loop"] == "serve_clips"
    ref = {0: torch.randn(4, 3)}
    numbers = compare.serving_numbers([(0, ref[0] + 0.01)], ref)
    assert set(workload["limits"]) == {*numbers, "clip_gap_ratio"}
    assert all(isinstance(v, float) and v > 0
               for v in workload["limits"].values())


def test_clip_gap_ratio():
    ref = {0: torch.tensor([[0.0, 0.0], [3.0, 0.0], [0.0, 4.0]]),
           1: torch.tensor([[1.0, 1.0], [-1.0, 1.0]])}
    assert clip_gap_ratio([(0, ref[0]), (1, ref[1])], ref) == 0.0
    # clip 0 off by 1 towards clip 1: 1 from its own, 2 from clip 1's
    near = ref[0].clone()
    near[0, 0] = 1.0
    assert clip_gap_ratio([(0, near), (1, ref[1])], ref) == pytest.approx(0.5)
    # clip 2 answered with clip 1's logits: 5 from its own, 0 from clip 1's
    copied = ref[0].clone()
    copied[2] = copied[1]
    assert clip_gap_ratio([(0, copied)], ref) == float("inf")
    copied[2] += 0.1
    assert clip_gap_ratio([(0, copied)], ref) > 1.0
    assert clip_gap_ratio([(1, ref[0])], ref) == float("inf")  # other rows


@pytest.mark.parametrize("fault", ["swapped_answer", "half_batch_answers"])
def test_a_copied_answer_is_not_correct_at_the_tiny_size(tiny, fault):
    c = load_cell(CELL, 3000000029, 1.0, False, "cpu", tiny)
    c.hooks = FAULTS[fault]
    checks = c.loop().run(c)["checks"]
    assert not compare.passed(checks), checks
    assert dict((n, v) for n, v, _ in checks)["clip_gap_ratio"] > 1.0


def test_the_control_is_not_correct_at_the_tiny_size(tiny):
    c = load_cell(CELL, 3000000023, 1.0, False, "cpu", tiny)
    numbers, _ = control_numbers(c)
    assert not compare.passed(compare.with_limits(numbers,
                                                  c.workload["limits"]))


def _unfolded_bf16_stem(x, conv, bn, scale, shift):
    """The stem as the program ran it before the fold: the affine in the
    compute dtype, then the conv and the BatchNorm."""
    c = conv.weight.shape[1]
    x = x.to(conv.dtype)
    scale = torch.tensor(scale * (c // len(scale)), dtype=x.dtype)
    shift = torch.tensor(shift * (c // len(shift)), dtype=x.dtype)
    return bn(conv(x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)))


def test_the_unfolded_bf16_stem_is_not_correct_at_the_tiny_size(
        tiny, monkeypatch):
    from audio_training_tpu_torch.models import backbones

    monkeypatch.setattr(backbones, "folded_stem", _unfolded_bf16_stem)
    c = load_cell(CELL, 3000000023, 1.0, False, "cpu", tiny)
    out = c.loop().run(c)
    assert not compare.passed(out["checks"]), out["checks"]
