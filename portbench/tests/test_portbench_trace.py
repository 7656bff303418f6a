"""The trace arithmetic and the per-layer readers on synthetic windows."""

from __future__ import annotations

import pytest

from portbench import readers
from portbench.cell import load_cell
from portbench.counts import k1
from portbench.run import reader
from portbench.trace import UNIT, Op, Span, TraceView, gaps, union_length


@pytest.mark.parametrize("intervals, length", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(0, 1), (1, 2)], 2.0),
    ([(5, 6), (0, 1), (0.5, 0.7)], 2.0),
    ([(0, 10), (2, 3), (4, 5)], 10.0),
])
def test_union_length(intervals, length):
    assert union_length(intervals) == pytest.approx(length)


def test_gaps():
    assert gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [(0, 1), (3, 4), (5, 6)]
    assert gaps([(0, 6)], 0, 6) == []


def view(kind="train", launches=None):
    """Two units from 0 to 100 us on the host; on the card K1 10-20, a
    preprocess op 20-25, the CNN 30-60 and 61-90, Adam 90-95, each launched
    inside its span."""
    cell = load_cell("badwinner2.train-b128", 1, 1.0, False, "cpu")
    ops = [
        Op("void mel_bf16_kernel<false, false>(...)", 10, 20, 1),
        Op("elementwise (normalize)", 20, 25, 2),
        Op("cudnn conv", 30, 60, 5),
        Op("cudnn conv wgrad", 61, 90, 6),
        Op("multi_tensor_apply_kernel", 90, 95, 8),
    ]
    spans = [Span(UNIT, 0, 50), Span(UNIT, 50, 100),
             Span(readers.PREPROCESS, 0, 3), Span("portbench.step", 4, 9),
             Span(readers.OPTIMIZER, 7, 9), Span("cudaLaunchKernel", 1, 1.1)]
    return TraceView(ops, spans, 2, kind, {
        "cell": cell, "window_peak_bytes": 24e9,
        "launches": launches if launches is not None
        else {"fused_featurizer_mel_bf16": 1, "fused_featurizer_pcen": 0}})


def test_window_busy_and_idle_share():
    v = view()
    assert v.window == (0, 100) and v.window_s == pytest.approx(1e-4)
    assert v.busy_s() == pytest.approx((10 + 5 + 30 + 29 + 5) * 1e-6)
    assert reader("idle_share.train")(v) == pytest.approx(21.0)
    assert reader("idle_share.serve")(v) is None


def test_span_readers():
    v = view()
    assert reader("preprocess_ms.train")(v) == pytest.approx(15e-3 / 2)
    assert reader("optimizer_ms.train")(v) == pytest.approx(5e-3 / 2)
    assert reader("k1_ms.train")(v) == pytest.approx(10e-3 / 2)
    assert reader("cnn_ms.train")(v) == pytest.approx(59e-3 / 2)
    assert reader("peak_mem_gb.train")(v) == pytest.approx(24.0)


def test_k1_readers_need_the_counted_launches():
    assert reader("k1_ms.train")(view(launches={})) is None
    assert reader("k1_roofline.train")(
        view(launches={"fused_featurizer_mel_bf16": 2})) is None


def test_k1_roofline_is_bound_over_measured():
    v = view()
    cell = v.context["cell"]
    bound = k1.bound_s("mel_bf16_kernel", cell.batch, cell.geometry,
                       cell.workload["k1"])
    assert reader("k1_roofline.train")(v) == pytest.approx(
        100 * bound / 10e-6)


def test_mfu_counts_the_reference_and_k1():
    v = view()
    cell = v.context["cell"]
    from portbench.counts.cnn import flops_per_clip

    flops = (flops_per_clip(cell.config, 1, train=True)
             + k1.ops_per_clip(cell.geometry, cell.workload["k1"]))
    assert reader("mfu.train")(v) == pytest.approx(
        100 * flops * cell.batch * 2 / 1e-4 / 989e12)


def test_breakdown_names_gaps_by_the_host():
    b = view().breakdown()
    assert b["device_ops"][0] == ["cudnn conv", pytest.approx(30e-6)]
    assert len(b["idle_gaps"]) == 4
    assert b["idle_gaps"][0] == ["portbench.preprocess", pytest.approx(10e-6)]


def test_unlinked_trace_reads_no_span_metric():
    v = view()
    v.ops = [o._replace(launch=None) for o in v.ops]
    assert reader("preprocess_ms.train")(v) is None
    assert reader("cnn_ms.train")(v) is None
