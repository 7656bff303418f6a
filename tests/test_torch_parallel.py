"""The port's data parallel (``audio_training_tpu_torch/parallel``) against
one process and against the JAX package's mesh, on the CPU.

The single-process helpers follow JAX's
``test_multihost_helpers_single_process``.  Everything else runs once, in
one group of two gloo ranks (``parallel.multihost.run_ranks``; the ranks'
side is tests/torch_dp_ranks.py), whose results the tests below read:

* ``KerasBatchNorm`` of both kinds over 2 ranks against one process on the
  concatenated batch: output, running statistics, and the input and
  parameter gradients of ``sum(out * w)`` (the ranks' parameter gradients
  summed), to 1e-6 of each tensor's max;
* the global min-max with its maximum on rank 1 and its minimum tied across
  the ranks, and ``PCENLayer``: forward and gradients, 1e-6;
* one badwinner2 step (dropout 0.0) at JAX's dry-run width (96 mels, B=4,
  2 rows a rank) against JAX's step on a 2-device mesh of the conftest's
  virtual devices, from the same weights and batch, at the rules of
  tests/test_torch_train_step.py: metrics to 1e-5 of the port's float64
  run (JAX's to 5e-5), running statistics 1e-5, Adam's update by the
  clear-gradient rule; gradients within 5e-3 of each tensor's max of the
  float64 run's (JAX's f32 gradient of this batch sits 2.6e-2 from it, so
  the two f32 gradients are not held to 5e-3 of each other); the same
  step in float64 equal to one process's to 1e-9; the soft-F1 losses
  (their counts summed over the ranks) equal to one process's to the f32
  rounding of the logits they are taken on; the two
  ranks' parameters after Adam identical; the remat step equal to the
  plain one to 1e-6;
* one step through the augmented preprocess (mixup at chance 1 and
  SpecAugment, drawn for the global batch; JAX's dry-run geometry: 8 kHz,
  n_fft 256, hop 100, 96 mels) against the port's own single-process
  step: the mixed and
  masked images row for row, the loss to 1e-5, gradients 5e-3, running
  statistics 1e-5;
* the audit's claims on the counted collectives of a later step (plain
  and remat) and of a forward;
* the sharded Predictor against the unsharded one (10 windows, and 3
  padded up), 2e-5 / 2e-6 as JAX's dry run holds it, the gather the only
  collective; a window cap that the ranks do not divide raises, as JAX's
  ``device_put`` does.

A second group checks that a run longer than the group's timeout
succeeds (``run_ranks`` has no deadline of its own, and
``on_rank_zero``'s waiting rank outlasts the collective timeout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu.parallel import make_mesh as jax_make_mesh
from audio_training_tpu.parallel import replicated as jax_replicated
from audio_training_tpu.parallel import shard_batch as jax_shard_batch
from audio_training_tpu.train import losses as jlosses
from audio_training_tpu.train import metrics as jmetrics
from audio_training_tpu.train import step as jstep
from audio_training_tpu.train.state import TrainState as JaxTrainState
from audio_training_tpu.train.state import make_optimizer as jax_optimizer
from audio_training_tpu_torch.config import FeaturizerConfig, InferenceConfig
from audio_training_tpu_torch.data.preprocess import make_preprocess_fn
from audio_training_tpu_torch.infer import Predictor
from audio_training_tpu_torch.models import build_model
from audio_training_tpu_torch.models.convert import (
    badwinner2_state_dict_from_flax,
)
from audio_training_tpu_torch.models.layers import KerasBatchNorm, PCENLayer
from audio_training_tpu_torch.ops.features import (
    normalize_minmax,
    sample_mix_weights,
)
from audio_training_tpu_torch.parallel import (
    batch_sharding,
    global_batch_from_local,
    initialize_distributed,
    make_mesh,
    process_shard,
    shard_batch,
)
from audio_training_tpu_torch.parallel.audit import (
    CollectiveInventory,
    audit_dp_inference,
    audit_dp_train_step,
)
from audio_training_tpu_torch.parallel.multihost import run_ranks
from audio_training_tpu_torch.train import losses, metrics, step
from audio_training_tpu_torch.train.state import param_count

import torch_dp_ranks as ranks
from test_torch_badwinner2 import flax_variables

torch.set_num_threads(2)

NUM_LABELS = 7
LR = 1e-3
STEP_SHAPE = (4, 96, 110, 1)  # 2 clips a rank
GEOMETRY = dict(sr=8000, n_fft=256, hop_length=100, n_mels=96, fmax=3800.0)
PREDICT_GEOMETRY = dict(sr=8000, n_fft=512, hop_length=100, n_mels=96,
                        fmax=3500.0)
SEED = 3


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _cat(results, *path):
    def get(r):
        for k in path:
            r = r[k]
        return r
    return np.concatenate([get(r) for r in results])


# ---------------------------------------------------------------------------
# single process
# ---------------------------------------------------------------------------


def test_multihost_helpers_single_process():
    """JAX's test_multihost_helpers_single_process: one process is a no-op,
    process_shard covers the list disjointly, and on a one-device mesh
    global_batch_from_local equals shard_batch."""
    assert initialize_distributed() is False
    items = [f"shard-{i}" for i in range(10)]
    parts = [process_shard(items, i, 4) for i in range(4)]
    assert sorted(x for p in parts for x in p) == sorted(items)
    assert process_shard(items) == items
    mesh = make_mesh(num_data=1, num_model=1, devices=["cpu"])
    assert mesh.shape == (1, 1) and mesh.group is None
    assert not mesh.distributed
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    np.testing.assert_array_equal(global_batch_from_local(mesh, x).numpy(),
                                  shard_batch(mesh, x).numpy())
    assert batch_sharding(mesh).rows(16) == slice(0, 16)


@pytest.mark.parametrize("num_data,num_model,devices,message", [
    (2, 1, ["cpu"], "mesh 2x1 needs 2 devices, have 1"),
    (2, 2, ["cpu"] * 2, "mesh 2x2 needs 4 devices, have 2"),
    (2, 1, ["cpu"] * 2, "mesh 2x1 needs 2 devices, have 1 (the process"),
])
def test_make_mesh_error_is_jaxs(num_data, num_model, devices, message):
    with pytest.raises(ValueError, match=message.replace("(", r"\(")):
        make_mesh(num_data=num_data, num_model=num_model, devices=devices)
    if "(" not in message:
        with pytest.raises(ValueError, match=message):
            jax_make_mesh(num_data=num_data, num_model=num_model,
                          devices=jax.devices()[:len(devices)])


@pytest.mark.parametrize("name", ["embeddings", "cnn-features", "merge"])
def test_seeded_init_draws_dense_layers_from_the_seed(name):
    """``create_train_state(seed=...)`` draws every layer from the seed,
    Dense layers too (they drew from torch's global generator before), so
    two processes, or two ranks, start from the same weights."""
    from audio_training_tpu_torch.train.state import init_weights

    states = []
    for global_seed in (1, 2):
        torch.manual_seed(global_seed)
        model = build_model(name, 4, logits_only=True).module
        states.append(init_weights(model, 0).state_dict())
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k


def test_audit_claims_on_hand_made_inventories():
    """The budgets of JAX's audit on inventories made by hand."""
    ok = CollectiveInventory({"all-reduce": [100, 20, 1]})
    assert audit_dp_train_step(ok, 100, 10) is ok
    for bad, match in ((CollectiveInventory({"all-reduce": [50]}),
                        "coverage"),
                       (CollectiveInventory({"all-reduce": [100, 5000]}),
                        "budget"),
                       (CollectiveInventory({"all-reduce": [100],
                                             "all-gather": [4]}),
                        "unexpected")):
        with pytest.raises(AssertionError, match=match):
            audit_dp_train_step(bad, 100, 10)
    audit_dp_inference(CollectiveInventory({"all-reduce": [2, 4]}))
    audit_dp_inference(CollectiveInventory({"all-gather": [24]}), 24)
    with pytest.raises(AssertionError, match="gathers"):
        audit_dp_inference(CollectiveInventory({"all-gather": [24]}))
    with pytest.raises(AssertionError, match="crossing"):
        audit_dp_inference(CollectiveInventory({"all-reduce": [65]}))


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------


def _bn_inputs(rng):
    chan = rng.normal(0.5, 2.0, (4, 6, 5, 3)).astype(np.float32)
    mel = rng.normal(0.0, 1.5, (4, 2, 6, 5)).astype(np.float32)
    out = {"bn_channels": (chan, rng.standard_normal(chan.shape).astype(
               np.float32)),
           "bn_per_mel": (mel, rng.standard_normal(mel.shape).astype(
               np.float32))}
    out["bn_channels_state"] = {
        "weight": torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)),
        "bias": torch.from_numpy(rng.normal(0, 0.1, 6).astype(np.float32)),
        "running_mean": torch.from_numpy(rng.normal(0, 0.2, 6).astype(
            np.float32)),
        "running_var": torch.from_numpy(rng.uniform(0.5, 2, 6).astype(
            np.float32))}
    out["bn_per_mel_state"] = {"running_mean": torch.zeros(6),
                               "running_var": torch.ones(6)}
    return out


def _minmax_inputs(rng):
    x = rng.uniform(-1.0, 1.0, (4, 5, 3)).astype(np.float32)
    x[3, 2, 1] = 4.0  # the maximum on rank 1
    x[0, 1, 1] = x[2, 4, 0] = -3.0  # the minimum, tied across the ranks
    w = rng.standard_normal(x.shape).astype(np.float32)
    # PCEN in float64: its scalar parameters' gradients sum thousands of
    # terms that nearly cancel, so f32 holds them to 1e-3 only
    pcen = rng.gamma(2.0, 3.0, (4, 9, 5))
    pcen[2, 4, 3] = 60.0
    return {"minmax": (x, w), "pcen": (pcen, rng.standard_normal(
        pcen.shape))}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(SEED)
    module, v = flax_variables(STEP_SHAPE, num_labels=NUM_LABELS)
    mel = rng.gamma(2.0, 50.0, STEP_SHAPE).astype(np.float32)
    y = np.eye(NUM_LABELS, dtype=np.float32)[[1, 4, 0, 6]]
    cfg = FeaturizerConfig(**GEOMETRY)
    samples = cfg.samples_per_clip
    raw, raw2 = (rng.standard_normal((4, samples)).astype(np.float32)
                 for _ in range(2))
    y_aug = np.eye(NUM_LABELS, dtype=np.float32)[[0, 1, 2, 3]]
    pcfg = FeaturizerConfig(**PREDICT_GEOMETRY)
    pmodel = build_model("badwinner2", 3, logits_only=True,
                         n_mels=pcfg.n_mels, mel_frames=pcfg.mel_frames).module
    from audio_training_tpu_torch.train.state import init_weights

    init_weights(pmodel, 0)
    payload = {
        "items": [f"shard-{i}" for i in range(10)],
        "helper_x": np.arange(16 * 3, dtype=np.float32).reshape(16, 3),
        **_bn_inputs(rng), **_minmax_inputs(rng),
        "num_labels": NUM_LABELS,
        "step_batch": (mel, y),
        "step_weights": badwinner2_state_dict_from_flax(v),
        "geometry": GEOMETRY, "seed": SEED,
        "augment_batch": (raw, y_aug, raw2, np.roll(y_aug, 1, 0)),
        "predict_geometry": PREDICT_GEOMETRY,
        "predict_weights": pmodel.state_dict(),
        "windows": rng.standard_normal((10, pcfg.samples_per_clip)).astype(
            np.float32),
    }
    return module, v, payload


@pytest.fixture(scope="module")
def results(setup):
    """Both ranks' results, from one group."""
    return run_ranks(ranks.parallel_checks, 2, args=(setup[2],),
                     timeout_s=120.0)


def test_helpers_on_two_ranks(results, setup):
    payload = setup[2]
    for rank, r in enumerate(results):
        h = r["helpers"]
        assert h["shape"] == (2, 1) and h["rank"] == rank
        assert h["backend"] == "gloo" and h["device"] == "cpu"
        assert h["initialized"] is True
        assert h["process_shard"] == payload["items"][rank::2]
        assert h["mesh_error"].startswith("mesh 4x1 needs 4 devices, have 2")
        np.testing.assert_array_equal(h["local"], h["sharded"])
        np.testing.assert_array_equal(
            h["sharded"], payload["helper_x"][8 * rank:8 * (rank + 1)])
        assert "does not divide" in h["indivisible"]


@pytest.mark.parametrize("kind", ["channels", "per_mel"])
def test_batchnorm_over_two_ranks_matches_one_process(results, setup, kind):
    """Output, running statistics, and the input and parameter gradients of
    the global-batch BatchNorm equal one process's on the whole batch."""
    p = setup[2]
    x, w = p[f"bn_{kind}"]
    kw = {} if kind == "channels" else dict(feature_dim=2, use_scale=False,
                                            use_bias=False)
    bn = KerasBatchNorm(6, **kw)
    bn.load_state_dict(p[f"bn_{kind}_state"])
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn.train()(xt)
    (y * torch.from_numpy(w)).sum().backward()
    got = [r["batchnorm"][kind] for r in results]
    assert _rel(np.concatenate([g["y"] for g in got]), y.detach()) < 1e-6
    assert _rel(np.concatenate([g["dx"] for g in got]), xt.grad) < 1e-6
    for n, q in bn.named_parameters():
        assert _rel(sum(g["params"][n] for g in got), q.grad) < 1e-6, n
    for n, b in bn.named_buffers():
        for g in got:
            assert _rel(g["stats"][n], b) < 1e-6, n
    assert len(dict(bn.named_parameters())) == (2 if kind == "channels" else 0)


def test_global_minmax_gradient_reaches_the_extremum(results, setup):
    """The maximum sits on rank 1 and the minimum on both ranks: each
    rank's gradient equals one process's rows, so rank 1's maximum gets the
    whole summed upstream gradient of the maximum and the tied minima split
    theirs."""
    x, w = setup[2]["minmax"]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = normalize_minmax(xt)
    (y * torch.from_numpy(w)).sum().backward()
    got = [r["minmax"]["minmax"] for r in results]
    assert _rel(np.concatenate([g["y"] for g in got]), y.detach()) < 1e-6
    dx = np.concatenate([g["dx"] for g in got])
    assert _rel(dx, xt.grad) < 1e-6
    # the extrema's own gradient, in float64: the summed sum(w * dy/dmax)
    # lands at rank 1's maximum alone, and sum(w * dy/dmin) splits in two
    # between the minima on ranks 0 and 1
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    lo, d = x64.min(), x64.max() - x64.min()
    g_hi = (w64 * -2.0 * (x64 - lo) / d**2).sum()
    g_lo = (w64 * (-2.0 / d + 2.0 * (x64 - lo) / d**2)).sum()
    r0, r1 = (g["dx"] for g in got)
    assert r1[1, 2, 1] == pytest.approx(w64[3, 2, 1] * 2 / d + g_hi,
                                        rel=1e-5)
    assert r0[0, 1, 1] == pytest.approx(w64[0, 1, 1] * 2 / d + g_lo / 2,
                                        rel=1e-5)
    assert r1[0, 4, 0] == pytest.approx(w64[2, 4, 0] * 2 / d + g_lo / 2,
                                        rel=1e-5)


def test_pcen_layer_over_two_ranks_matches_one_process(results, setup):
    x, w = setup[2]["pcen"]
    layer = PCENLayer(time_axis=1).double()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer(xt)
    (y * torch.from_numpy(w)).sum().backward()
    got = [r["minmax"]["pcen"] for r in results]
    assert _rel(np.concatenate([g["y"] for g in got]), y.detach()) < 1e-6
    assert _rel(np.concatenate([g["dx"] for g in got]), xt.grad) < 1e-6
    for n, q in layer.named_parameters():
        assert _rel(sum(g["params"][n] for g in got), q.grad) < 1e-6, n


@pytest.fixture(scope="module")
def jax_mesh_step(setup):
    """JAX's step on a 2-device mesh: (new state, metrics, gradients)."""
    module, v, p = setup
    module = module.clone(dropout=0.0)
    mel, y = p["step_batch"]
    mesh = jax_make_mesh(num_data=2)
    jstate = JaxTrainState.create(apply_fn=module.apply, params=v["params"],
                                  tx=jax_optimizer(LR),
                                  batch_stats=v["batch_stats"])
    jstate = jax.device_put(jstate, jax_replicated(mesh))
    mel_s, y_s = jax_shard_batch(mesh, mel, y)

    def loss_fn(params):
        out, _ = module.apply({"params": params,
                               "batch_stats": v["batch_stats"]},
                              mel_s, train=True,
                              rngs={"dropout": jax.random.PRNGKey(0)},
                              mutable=["batch_stats"])
        return jlosses.bce_from_logits(out, y_s)

    grads = jax.jit(jax.grad(loss_fn))(jstate.params)
    new, m = jstep.make_train_step(donate=False)(
        jstate, jstep.fresh_metrics(), mel_s, y_s, jax.random.PRNGKey(0))
    return new, m, grads


def _float64_step(p):
    """The port's model in float64, train mode, on the whole step batch:
    its metrics and gradients, the exact evaluation both f32 steps are held
    to."""
    mel, y = p["step_batch"]
    model = ranks.badwinner2(NUM_LABELS, 96, p["step_weights"]).model
    model = model.double().train()
    y64 = torch.from_numpy(y).double()
    logits = model(torch.from_numpy(mel).double())
    loss = losses.bce_from_logits(logits, y64)
    loss.backward()
    m = metrics.metrics_update(step.fresh_metrics(), loss.detach(),
                               torch.sigmoid(logits.detach()), y64, True)
    return (metrics.metrics_compute(m),
            {n: q.grad.numpy() for n, q in model.named_parameters()})


def test_dp_step_matches_jax_mesh_step(results, setup, jax_mesh_step):
    """Metrics, gradients, running statistics and Adam's update of the port's
    2-rank step against JAX's 2-device mesh step, both held to the port's
    model in float64 on the whole batch.  Metrics: the port's to 1e-5, JAX's
    jitted step's to 5e-5 (tests/test_torch_train_step.py).  Gradients: the
    port's within 5e-3 of each tensor's max of the float64 ones (measured
    3.4e-4); JAX's f32 gradient of this batch is itself 2.6e-2 away from
    them (measured; 2.3e-2 on one device), so it is held to 5e-2, which a
    per-rank BatchNorm (statistics of half the batch) would break.  Adam's first update is lr * g / (|g| + eps) of the port's
    own gradient, and equals JAX's update wherever the float64 gradient is
    clear of both f32 gradients' noise (above 5e-2 of its max)."""
    _, v, p = setup
    new, jm, grads = jax_mesh_step
    exact, g64 = _float64_step(p)
    want = jmetrics.metrics_compute(jm)
    for r in results:
        got = r["jax_step"]["plain"]["metrics"]
        for k, e in exact.items():
            assert abs(got[k] - e) / max(abs(e), 1.0) <= 1e-5, k
            assert abs(want[k] - e) / max(abs(e), 1.0) <= 5e-5, k
    g_jax = badwinner2_state_dict_from_flax(
        {"params": grads, "batch_stats": v["batch_stats"]})
    old = p["step_weights"]
    want_sd = badwinner2_state_dict_from_flax(
        {"params": new.params, "batch_stats": new.batch_stats})
    got = results[0]["jax_step"]["plain"]
    assert len(got["grads"]) == 1 + 2 * 8 + 2 * 7
    for name, g in got["grads"].items():
        assert _rel(g, g64[name]) < 5e-3, name
        assert _rel(g_jax[name], g64[name]) < 5e-2, name
    for k, after in got["after"].items():
        if "running" in k:
            assert _rel(after, want_sd[k]) < 1e-5, k
            continue
        g = got["grads"][k]
        update = (old[k].double().numpy() - after) / LR
        assert np.abs(update - g / (np.abs(g) + 1e-8)).max() < 1e-3, k
        update_jax = (old[k].double().numpy()
                      - want_sd[k].double().numpy()) / LR
        clear = np.abs(g64[k]) > 5e-2 * np.abs(g64[k]).max()
        assert clear.any(), k
        assert np.abs(update - update_jax)[clear].max() < 1e-3, k


def test_dp_step_in_float64_equals_one_process(results, setup):
    """In float64, where only summation order separates two runs, the 2-rank
    step is the single-process step on the whole batch: metrics, gradients,
    running statistics to 1e-9 of each tensor's max; the updated parameters
    to 1e-7 (Adam's first step, lr * g / (|g| + eps), turns a gradient
    element's 1e-13 difference into up to 1e-8 of lr where |g| is near
    eps)."""
    p = setup[2]
    mel, y = (torch.from_numpy(a).double() for a in p["step_batch"])
    state = ranks.badwinner2(NUM_LABELS, 96, p["step_weights"])
    state.model.double()
    state, m = step.make_train_step()(state, step.fresh_metrics(), mel, y,
                                      torch.Generator().manual_seed(0))
    want = metrics.metrics_compute(m)
    for r in results:
        got = r["jax_step"]["float64"]
        assert got["metrics"] == pytest.approx(want, rel=1e-9)
        for n, q in state.model.named_parameters():
            assert _rel(got["grads"][n], q.grad) < 1e-9, n
        for n, t in state.model.state_dict().items():
            assert _rel(got["after"][n], t) < (1e-9 if "running" in n
                                                else 1e-7), n


@pytest.mark.parametrize("loss", ["soft_f1", "double_soft_f1"])
def test_dp_soft_f1_step_in_float64_equals_one_process(results, setup, loss):
    """The soft-F1 losses are not means over rows: their per-label counts
    are summed over the ranks (with a gradient), so the 2-rank step is the
    single-process step on the whole batch.  The model casts its logits to
    f32, as JAX's does, so the counts are f32 sums over the rows, whose
    order differs between one process and two (1.4e-7 measured): metrics
    and gradients to 1e-6 of each tensor's max; the running statistics,
    taken before the cast, to 1e-9; Adam's update equal to one process's
    to 1e-5 of lr wherever the gradient is clear of that noise (above 1e-2
    of its max).  Counts taken over each rank's rows would give another
    loss altogether."""
    p = setup[2]
    mel, y = (torch.from_numpy(a).double() for a in p["step_batch"])
    state = ranks.badwinner2(NUM_LABELS, 96, p["step_weights"])
    state.model.double()
    state, m = step.make_train_step(loss_name=loss)(
        state, step.fresh_metrics(), mel, y, torch.Generator().manual_seed(0))
    want = metrics.metrics_compute(m)
    grads = {n: q.grad.numpy() for n, q in state.model.named_parameters()}
    old = p["step_weights"]
    for r in results:
        got = r["jax_step"][loss]
        assert got["metrics"] == pytest.approx(want, rel=1e-6)
        for n, g in grads.items():
            assert _rel(got["grads"][n], g) < 1e-6, n
        for n, t in state.model.state_dict().items():
            if "running" in n:
                assert _rel(got["after"][n], t) < 1e-9, n
                continue
            clear = np.abs(grads[n]) > 1e-2 * np.abs(grads[n]).max()
            update = old[n].double().numpy() - got["after"][n]
            update_one = (old[n].double() - t).numpy()
            assert np.abs(update - update_one)[clear].max() < 1e-5 * LR, n


def test_run_ranks_outlasts_the_group_timeout():
    """A run longer than the group's timeout (and than twice it) succeeds:
    ``run_ranks`` sets no deadline of its own, and ``on_rank_zero``'s
    waiting rank waits past the group's collective timeout."""
    assert run_ranks(ranks.slow_rank_zero, 2, args=(11.0,),
                     timeout_s=5.0) == ["done", "done"]


def test_dp_ranks_hold_identical_parameters_after_adam(results):
    a, b = (r["jax_step"]["plain"]["after"] for r in results)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ga, gb = (r["jax_step"]["plain"]["grads"] for r in results)
    for k in ga:
        np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)


def test_dp_remat_step_equals_the_plain_step(results):
    """``remat=True`` replays the BatchNorm all-reduces in the recompute:
    the step equals the plain one."""
    for r in results:
        plain, remat = r["jax_step"]["plain"], r["jax_step"]["remat"]
        assert remat["metrics"] == pytest.approx(plain["metrics"], rel=1e-6)
        for k, g in plain["grads"].items():
            assert _rel(remat["grads"][k], g) < 1e-6, k
        for k, a in plain["after"].items():
            assert _rel(remat["after"][k], a) < 1e-6, k


def test_dp_augmented_step_matches_one_process(results, setup):
    """Mixup and SpecAugment drawn for the global batch: the ranks' images
    are the single-device images' rows, and the step is its step."""
    p = setup[2]
    cfg = FeaturizerConfig(**GEOMETRY)
    raw, y, raw2, y2 = (torch.from_numpy(a) for a in p["augment_batch"])
    state = ranks.badwinner2(NUM_LABELS, cfg.n_mels, seed=SEED)
    pre = make_preprocess_fn(cfg, augment=True, use_spec_augment=True,
                             mixup_chance=1.0, device="cpu")
    mel, yy = pre(raw, y, raw2, y2, torch.Generator().manual_seed(SEED))
    # every row mixes (chance 1) at its own weight, and SpecAugment masks
    weights = sample_mix_weights(torch.Generator().manual_seed(SEED), 4,
                                 chance=1.0)
    assert (weights > 0).all() and len(set(weights.tolist())) == 4
    assert (mel == 0).any()
    state, m = step.make_train_step()(state, step.fresh_metrics(), mel, yy,
                                      torch.Generator().manual_seed(0))
    assert _rel(_cat(results, "augmented", "mel"), mel) < 1e-6
    np.testing.assert_array_equal(_cat(results, "augmented", "y"), yy)
    want = metrics.metrics_compute(m)
    got = results[0]["augmented"]
    for k, e in want.items():
        assert abs(got["metrics"][k] - e) / max(abs(e), 1.0) <= 1e-5, k
    for n, q in state.model.named_parameters():
        assert _rel(got["grads"][n], q.grad) < 5e-3, n
    for n, b in state.model.named_buffers():
        assert _rel(got["after"][n], b) < 1e-5, n


def test_audit_claims_hold_on_the_counted_collectives(results, setup):
    """A later step all-reduces every parameter and no more than the
    budget (plain and remat), with no other kind; the bare forward issues
    none."""
    model = ranks.badwinner2(NUM_LABELS, 96, setup[2]["step_weights"]).model
    n_params = sum(q.numel() for q in model.parameters())
    n_bn = sum(b.numel() for n, b in model.named_buffers()
               if n.endswith(("running_mean", "running_var")))
    for r in results:
        for key in ("inventory", "inventory_remat"):
            inv = CollectiveInventory(r["jax_step"][key])
            audit_dp_train_step(inv, n_params, n_bn)
        plain = CollectiveInventory(r["jax_step"]["inventory"])
        remat = CollectiveInventory(r["jax_step"]["inventory_remat"])
        # the BN sums forward and backward, and once more in the recompute
        bn_sums = plain.total_elements("all-reduce") - n_params
        # [sum x, sum x^2, rows] of 8 BatchNorms, forward and backward
        assert bn_sums == 2 * (n_bn + 8)
        assert remat.total_elements("all-reduce") - n_params == 3 * (n_bn + 8)
        assert r["jax_step"]["forward_inventory"] == {}
    assert n_params == param_count(ranks.badwinner2(NUM_LABELS, 96, None))


def test_sharded_predictor_matches_unsharded(results, setup):
    """JAX's test_predictor_sharded_over_mesh: 10 windows, and 3 padded up
    to the bucket and the ranks; probabilities equal to the unsharded
    Predictor's; the gather of the (8, 3) probabilities the only
    collective."""
    p = setup[2]
    cfg = FeaturizerConfig(**PREDICT_GEOMETRY)
    module = build_model("badwinner2", 3, logits_only=True, n_mels=cfg.n_mels,
                         mel_frames=cfg.mel_frames).module
    module.load_state_dict(p["predict_weights"])
    single = Predictor(module, ["a", "b", "c"], cfg,
                       InferenceConfig(max_window_batch=16,
                                       bucket_sizes=(8, 16)), device="cpu")
    want = single.predict_windows(p["windows"])
    for r in results:
        got = r["predictor"]
        assert got["probs"].shape == (10, 3) and np.isfinite(got["probs"]).all()
        np.testing.assert_allclose(got["probs"], want, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(got["small"], want[:3], rtol=2e-5,
                                   atol=2e-6)
        audit_dp_inference(CollectiveInventory(got["inventory"]), 8 * 3)


def test_window_cap_the_ranks_do_not_divide_raises_as_in_jax(results, setup):
    """max_window_batch=3 over 2 ranks: JAX's device_put of a 3-window chunk
    raises ValueError; so does the port's shard of it."""
    from audio_training_tpu.config import FeaturizerConfig as JCfg
    from audio_training_tpu.config import InferenceConfig as JInfer
    from audio_training_tpu.infer.predictor import Predictor as JPredictor
    from audio_training_tpu.models import build_model as jax_build_model

    cfg = JCfg(**PREDICT_GEOMETRY)
    spec = jax_build_model("badwinner2", 3, logits_only=True)
    variables = spec.module.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, cfg.n_mels, cfg.mel_frames, 1)), train=False)
    pred = JPredictor(spec.module, variables, ["a", "b", "c"], cfg,
                      JInfer(max_window_batch=3, bucket_sizes=(8,)),
                      mesh=jax_make_mesh(num_data=2))
    with pytest.raises(ValueError):
        pred.predict_windows(setup[2]["windows"][:8])
    for r in results:
        assert "does not divide" in r["predictor"]["odd_cap"]
