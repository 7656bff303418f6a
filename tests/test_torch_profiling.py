"""The port's profiling helpers (``utils/profiling.py``) against the claims
of the JAX package's (tests/test_aux.py:358-400): ``time_fn``'s statistics
under the same keys, a train state's memory counted as JAX counts it on
the same architecture, a trace whose summary lists the operators it ran,
and the kernel-to-layer map.

There is no card here: the summaries of a CUDA trace are checked on a
hand-written Chrome trace in torch.profiler's layout (kernel events tied
to their launches by correlation id), and tests/test_torch_gpu.py checks
them on the card.
"""

import json
from types import SimpleNamespace

import pytest
import torch

from audio_training_tpu_torch.utils import profiling

torch.set_num_threads(2)


def test_time_fn_keys_match_jax():
    import jax.numpy as jnp

    from audio_training_tpu.utils.profiling import time_fn as jax_time_fn

    want = jax_time_fn(lambda x: (x * 2).sum(), jnp.ones((100,)), iters=3)
    got = profiling.time_fn(lambda x: (x * 2).sum(), torch.ones(100),
                            iters=3)
    assert got.keys() == want.keys() and got["iters"] == 3
    assert 0 < got["min_ms"] <= got["p50_ms"] <= got["p90_ms"]
    assert got["min_ms"] <= got["mean_ms"]


def test_time_fn_walks_nested_outputs():
    calls = []

    def fn(x):
        calls.append(1)
        return {"a": (x + 1, [x * 2]), "b": None}

    stats = profiling.time_fn(fn, torch.ones(3), iters=4, warmup=1)
    assert len(calls) == 5 and stats["iters"] == 4


def test_state_memory_matches_jax_on_badwinner2():
    """Parameters and BatchNorm statistics of badwinner2 count JAX's bytes
    (the Flax tree's shapes from ``jax.eval_shape``); Adam's moments appear
    at the first step."""
    import jax
    import jax.numpy as jnp

    from audio_training_tpu.models import build_model as jax_build_model
    from audio_training_tpu.utils.profiling import state_memory_bytes
    from audio_training_tpu_torch.models import build_model
    from audio_training_tpu_torch.train import create_train_state

    spec = jax_build_model("badwinner2", num_labels=6)
    variables = jax.eval_shape(lambda: spec.module.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 160, 513, 1)), train=False))
    want = state_memory_bytes(SimpleNamespace(
        params=variables["params"], opt_state={},
        batch_stats=variables["batch_stats"]), batch_shape=(2, 160, 513))
    state = create_train_state(build_model("badwinner2", 6).module,
                               device="cpu")
    got = profiling.state_memory_bytes(state, batch_shape=(2, 160, 513))
    assert got == want and got["batch_stats_bytes"] > 0

    model = build_model("embeddings", 4).module
    state = create_train_state(model, device="cpu")
    model(torch.ones(2, 1280)).sum().backward()
    state.optimizer.step()
    mem = profiling.state_memory_bytes(state)
    n_tensors = len(list(model.parameters()))
    assert mem["optimizer_bytes"] == 2 * mem["params_bytes"] + 4 * n_tensors
    assert mem["total_bytes"] == mem["params_bytes"] + mem["optimizer_bytes"]


def test_trace_summary_and_layer_map(tmp_path):
    """A trace of a small model: the host summary lists its operators, and
    the layer map ties each to the modules it ran under (without a card
    the operators stand in for kernels)."""
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                                torch.nn.Sequential(torch.nn.Linear(32, 4)))
    x = torch.ones(8, 16)
    with profiling.trace(tmp_path):
        model(x).sum()
    rows = profiling.device_event_summary(tmp_path, device="cpu")
    names = [name for name, _ in rows]
    assert "aten::addmm" in names and "aten::relu" in names
    assert all(ms >= 0 for _, ms in rows)
    assert [ms for _, ms in rows] == sorted((ms for _, ms in rows),
                                            reverse=True)
    assert profiling.device_event_summary(tmp_path, device=0) == []

    lmap = profiling.fusion_layer_map(model, x, model=model,
                                      trace_dir=tmp_path / "map")
    assert lmap["aten::addmm"] == ["Sequential.0", "Sequential.2.0"]
    assert lmap["aten::relu"] == ["Sequential.1"]
    assert not model._forward_hooks and not model[0]._forward_pre_hooks


def test_device_event_summary_raises_without_a_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.device_event_summary(tmp_path)


def _write_cuda_trace(d, name="1.trace.json"):
    """A Chrome trace as torch.profiler writes one on the card: module
    ranges and launches on the host thread, kernels on card 0 and 1."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "module::Net",
         "pid": 1, "tid": 7, "ts": 100.0, "dur": 500.0},
        {"ph": "X", "cat": "user_annotation", "name": "module::Net.conv",
         "pid": 1, "tid": 7, "ts": 150.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "module::Net.head",
         "pid": 1, "tid": 7, "ts": 300.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 1,
         "tid": 7, "ts": 160.0, "dur": 50.0},
    ]
    launches = [(50.0, 1), (170.0, 2), (180.0, 3), (320.0, 4), (450.0, 5),
                (330.0, 6)]
    for ts, corr in launches:
        ev.append({"ph": "X", "cat": "cuda_runtime", "name":
                   "cudaLaunchKernel", "pid": 1, "tid": 7, "ts": ts,
                   "dur": 5.0, "args": {"correlation": corr}})
    kernels = [("mel_power_kernel", 1, 0, 1300.0),
               ("sm90_xmma_fprop", 2, 0, 400.0),
               ("elementwise", 3, 0, 20.0), ("sm90_xmma_fprop", 4, 0, 80.0),
               ("elementwise", 5, 0, 10.0), ("other_card", 6, 1, 99.0)]
    for kname, corr, device, dur in kernels:
        ev.append({"ph": "X", "cat": "kernel", "name": kname, "pid": 0,
                   "tid": "stream 7", "ts": 1000.0 + corr, "dur": dur,
                   "args": {"correlation": corr, "device": device}})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
               "pid": 0, "tid": "stream 7", "ts": 900.0, "dur": 7.0,
               "args": {"device": 0}})
    ev.append({"ph": "M", "name": "process_name", "pid": 0,
               "args": {"name": "GPU 0"}})
    (d / name).write_text(json.dumps({"traceEvents": ev}))


def test_cuda_trace_summary_and_map(tmp_path):
    _write_cuda_trace(tmp_path, "1.trace.json")
    (tmp_path / "0.trace.json").write_text('{"traceEvents": []}')
    rows = profiling.device_event_summary(tmp_path, device=0)
    assert rows == [("mel_power_kernel", 1.3), ("sm90_xmma_fprop", 0.48),
                    ("elementwise", 0.03), ("Memcpy HtoD", 0.007)]
    assert profiling.device_event_summary(tmp_path, device=1) == [
        ("other_card", 0.099)]
    assert profiling.kernel_module_map(tmp_path) == {
        "sm90_xmma_fprop": ["Net.conv", "Net.head"],
        "elementwise": ["Net.conv", "Net"],
        "other_card": ["Net.head"],
    }


def test_cuda_trace_with_lost_kernels_warns(tmp_path):
    """A launch whose kernel the trace left out is listed by its position
    among the launches, and the card's summary warns that it is short."""
    _write_cuda_trace(tmp_path)
    assert profiling.unrecorded_launches(tmp_path) == []
    body = json.loads((tmp_path / "1.trace.json").read_text())
    body["traceEvents"] = [e for e in body["traceEvents"]
                           if e.get("args", {}).get("correlation") != 1
                           or e.get("cat") != "kernel"]
    (tmp_path / "2.trace.json").write_text(json.dumps(body))
    assert profiling.unrecorded_launches(tmp_path) == [
        (0, "cudaLaunchKernel")]
    with pytest.warns(RuntimeWarning, match="1 launches"):
        rows = profiling.device_event_summary(tmp_path, device=0)
    assert "mel_power_kernel" not in dict(rows)


def test_log_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_gpu.py checks it")
    assert profiling.log_memory_stats() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "p") as prof:
        torch.ones(4).add_(1)
    assert prof is not None
    (path,) = (tmp_path / "p").glob("*.trace.json")
    body = json.loads(path.read_text())
    assert any(e.get("cat") == "cpu_op" for e in body["traceEvents"])
