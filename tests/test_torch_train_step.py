"""One training step of the port against the JAX package's, on the CPU.

Both sides start from the same Flax variables (badwinner2 at 96 mels,
randomized BN statistics and affine, converted with
``models.convert.badwinner2_state_dict_from_flax``) and take the same f32
batch (2, 96, 110, 1) from a numpy seed, with ``dropout=0.0`` (JAX keys and
torch generators give different dropout bits) and fresh Adam moments.
Tolerances, all f32 on the CPU where only summation order differs:
the step's metrics 1e-5 relative of a float64 run of the port's model
(JAX's jitted step 5e-5 of it, see PORT_METRIC_TOL); each gradient tensor 5e-3 of its max |value|: through
eight train-mode BatchNorms (Flax's fast variance E[x^2] - E[x]^2) an f32
gradient of this model is itself only good to about 1e-3 of a float64 one
(test_f32_gradient_noise_sets_the_gradient_tolerance measures the port's),
so two f32 gradients agree only to that (max-pool ties would also route
gradients differently in bf16, so the comparison is f32); updated
parameters as in the test below; BN running statistics 1e-5 relative
after the step, 1e-3 after ``reestimate_batch_stats`` (its
(new - 0.99 old) / 0.01 multiplies the f32 rounding of ``new`` by 100).
The loss zoo and the metric accumulators agree to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu.models.layers import _condense_conv
from audio_training_tpu.train import losses as jlosses
from audio_training_tpu.train import metrics as jmetrics
from audio_training_tpu.train import step as jstep
from audio_training_tpu.train.state import TrainState as JaxTrainState
from audio_training_tpu.train.state import make_optimizer as jax_optimizer
from audio_training_tpu_torch.models import build_model
from audio_training_tpu_torch.models.convert import (
    badwinner2_state_dict_from_flax,
)
from audio_training_tpu_torch.models.layers import KerasBatchNorm
from audio_training_tpu_torch.train import losses, metrics, step
from audio_training_tpu_torch.train.state import (
    create_train_state,
    param_count,
)

from test_torch_badwinner2 import flax_variables

torch.set_num_threads(2)

SHAPE = (2, 96, 110, 1)  # the shortest time axis the 1x9 head conv takes
NUM_LABELS = 7
LR = 1e-3


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def setup():
    module, v = flax_variables(SHAPE, num_labels=NUM_LABELS)
    module = module.clone(dropout=0.0)
    rng = np.random.default_rng(7)
    mel = rng.gamma(2.0, 50.0, SHAPE).astype(np.float32)
    y = np.eye(NUM_LABELS, dtype=np.float32)[[1, 4]]
    return module, v, mel, y


def _port_state(v, dropout=0.0):
    model = build_model("badwinner2", NUM_LABELS, logits_only=True, n_mels=96,
                        dropout=dropout).module
    model.load_state_dict(badwinner2_state_dict_from_flax(v))
    return create_train_state(model, learning_rate=LR, device="cpu")


@pytest.fixture(scope="module")
def stepped(setup):
    """(JAX state after one step, JAX metrics, JAX grads, port state after
    one step, port metrics)."""
    module, v, mel, y = setup
    jstate = JaxTrainState.create(apply_fn=module.apply, params=v["params"],
                                  tx=jax_optimizer(LR),
                                  batch_stats=v["batch_stats"])

    def loss_fn(params):
        out, _ = module.apply({"params": params,
                               "batch_stats": v["batch_stats"]},
                              jnp.asarray(mel), train=True,
                              rngs={"dropout": jax.random.PRNGKey(0)},
                              mutable=["batch_stats"])
        return jlosses.bce_from_logits(out, jnp.asarray(y))

    grads = jax.grad(loss_fn)(jstate.params)
    jnew, jm = jstep.make_train_step(donate=False)(
        jstate, jstep.fresh_metrics(), jnp.asarray(mel), jnp.asarray(y),
        jax.random.PRNGKey(0))
    state = _port_state(v)
    state, m = step.make_train_step()(
        state, step.fresh_metrics(), torch.from_numpy(mel),
        torch.from_numpy(y), torch.Generator().manual_seed(0))
    return jnew, jm, grads, state, m


# Metric tolerances of the train step, each against the port's model run in
# float64 on the same batch and weights (relative, floor 1 in the divisor):
# the port's f32 step sits within 2.6e-6 of it; JAX's jitted value_and_grad
# step, whose fused XLA:CPU f32 reductions reorder the sums, was measured
# 1.7e-5 away on the loss (1.0143548 against 1.0143723; JAX's eager forward
# gives 1.0143766), so it is held to 5e-5, and the two f32 steps to the sum.
PORT_METRIC_TOL = 1e-5
JAX_JIT_METRIC_TOL = 5e-5


def _metric_err(got, want):
    return abs(got - want) / max(abs(want), 1.0)


@pytest.fixture(scope="module")
def float64_metrics(setup):
    """``metrics_compute`` of the port's model in float64, train mode, on
    the step's batch: the exact evaluation both f32 steps are held to."""
    _, v, mel, y = setup
    model = _port_state(v).model.double().train()
    y64 = torch.from_numpy(y).double()
    with torch.no_grad():
        logits = model(torch.from_numpy(mel).double())
        m = metrics.metrics_update(step.fresh_metrics(),
                                   losses.bce_from_logits(logits, y64),
                                   torch.sigmoid(logits), y64, True)
    return metrics.metrics_compute(m)


def test_train_step_loss_and_metrics_match_jax(stepped, float64_metrics):
    _, jm, _, state, m = stepped
    assert state.step == 1
    got, want = metrics.metrics_compute(m), jmetrics.metrics_compute(jm)
    assert got.keys() == want.keys() == float64_metrics.keys()
    for k, exact in float64_metrics.items():
        assert _metric_err(got[k], exact) <= PORT_METRIC_TOL, k
        assert _metric_err(want[k], exact) <= JAX_JIT_METRIC_TOL, k
        assert (_metric_err(got[k], want[k])
                <= PORT_METRIC_TOL + JAX_JIT_METRIC_TOL), k


def test_train_step_gradients_match_jax(stepped, setup):
    _, v, _, _ = setup
    _, _, grads, state, _ = stepped
    want = badwinner2_state_dict_from_flax(
        {"params": grads, "batch_stats": v["batch_stats"]})
    named = dict(state.model.named_parameters())
    assert len(named) == 1 + 2 * 8 + 2 * 7
    for name, p in named.items():
        assert _rel(p.grad, want[name]) < 5e-3, name


def test_f32_gradient_noise_sets_the_gradient_tolerance(stepped, setup):
    """The port's f32 gradient against its own float64 gradient on the same
    batch: the noise that the 5e-3 gradient tolerance above has to admit,
    and the JAX gradient sits as close to the float64 one."""
    _, v, mel, y = setup
    _, _, grads, state, _ = stepped
    model = _port_state(v).model.double().train()
    losses.bce_from_logits(model(torch.from_numpy(mel).double()),
                           torch.from_numpy(y).double()).backward()
    g64 = {n: p.grad for n, p in model.named_parameters()}
    want = badwinner2_state_dict_from_flax(
        {"params": grads, "batch_stats": v["batch_stats"]})
    port = max(_rel(p.grad, g64[n])
               for n, p in state.model.named_parameters())
    jax_ = max(_rel(want[n], g64[n]) for n in g64)
    assert 5e-4 < port < 5e-3
    assert jax_ < 5e-3


def test_train_step_updates_params_and_bn_stats_like_jax(stepped, setup):
    """Adam's first step from fresh moments is lr * g / (|g| + eps) of each
    side's own gradient (to 1e-3 of lr), and equals JAX's update wherever
    JAX's gradient element is above 1e-2 of its tensor's max, i.e. outside
    the f32 gradient noise (near zero the noise can flip a sign, and the
    update is then +-lr on either side)."""
    _, v, _, _ = setup
    jnew, _, grads, state, _ = stepped
    old = badwinner2_state_dict_from_flax(v)
    want = badwinner2_state_dict_from_flax(
        {"params": jnew.params, "batch_stats": jnew.batch_stats})
    g_jax = badwinner2_state_dict_from_flax(
        {"params": grads, "batch_stats": v["batch_stats"]})
    named = dict(state.model.named_parameters())
    got = state.model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        if "running" in k:
            assert _rel(got[k], want[k]) < 1e-5, k
            continue
        g = named[k].grad.double()
        update = (old[k].double() - got[k].double()) / LR
        assert (update - g / (g.abs() + 1e-8)).abs().max() < 1e-3, k
        update_jax = (old[k].double() - want[k].double()) / LR
        clear = g_jax[k].abs() > 1e-2 * g_jax[k].abs().max()
        assert clear.any(), k
        assert (update - update_jax)[clear].abs().max() < 1e-3, k


def test_batchnorm_train_mode_matches_flax():
    """Both BN kinds of badwinner2: channels (bf16 activations reduced in
    f32, output bf16) and per-mel (f32, no affine); output 1e-5 relative in
    f32, one bf16 step in bf16; running statistics 1e-6 relative."""
    from flax import linen as nn

    rng = np.random.default_rng(3)
    x = rng.normal(0.5, 2.0, (3, 6, 5, 4)).astype(np.float32)  # NHWC
    mean0 = rng.normal(0, 0.2, 4).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    bias = rng.normal(0, 0.1, 4).astype(np.float32)
    for dtype, tol in ((None, 1e-5), (jnp.bfloat16, 2 ** -7)):
        bn = nn.BatchNorm(use_running_average=False, momentum=0.99,
                          epsilon=1e-3, dtype=dtype)
        variables = {"params": {"scale": scale, "bias": bias},
                     "batch_stats": {"mean": mean0, "var": var0}}
        xj = jnp.asarray(x).astype(dtype or jnp.float32)
        want, mut = bn.apply(variables, xj, mutable=["batch_stats"])
        port = KerasBatchNorm(4).train()
        port.load_state_dict({"weight": torch.from_numpy(scale),
                              "bias": torch.from_numpy(bias),
                              "running_mean": torch.from_numpy(mean0),
                              "running_var": torch.from_numpy(var0)})
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        if dtype is not None:
            xt = xt.to(torch.bfloat16)
        got = port(xt)
        assert got.dtype == xt.dtype
        assert _rel(got.float().permute(0, 2, 3, 1).detach(),
                    np.asarray(want, np.float32)) < tol
        stats = mut["batch_stats"]
        assert _rel(port.running_mean, stats["mean"]) < 1e-6
        assert _rel(port.running_var, stats["var"]) < 1e-6
    # per-mel: Flax axis=1 of NHWC is the port's dim 2 of NCHW
    bn = nn.BatchNorm(use_running_average=False, axis=1, momentum=0.99,
                      epsilon=1e-3, use_scale=False, use_bias=False)
    stats0 = {"mean": np.zeros(6, np.float32), "var": np.ones(6, np.float32)}
    want, mut = bn.apply({"batch_stats": stats0}, jnp.asarray(x),
                         mutable=["batch_stats"])
    port = KerasBatchNorm(6, feature_dim=2, use_scale=False,
                          use_bias=False).train()
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert _rel(got.permute(0, 2, 3, 1).detach(), want) < 1e-5
    assert _rel(port.running_var, mut["batch_stats"]["var"]) < 1e-6


def test_condense_conv_backward_matches_jax_custom_vjp():
    """The 22x3 condense conv's dx and dw: the port leaves them to autograd
    (cuDNN on the card); JAX computes dx as oh-unfolded dots in a custom
    VJP.  f32, 1e-5 of max |value|."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 26, 12, 8)).astype(np.float32)  # NHWC
    w = (rng.standard_normal((22, 3, 8, 16)) * 0.05).astype(np.float32)
    g = rng.standard_normal((2, 5, 10, 16)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: _condense_conv(None, a, b),
                       jnp.asarray(x), jnp.asarray(w))
    dx_want, dw_want = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).requires_grad_()
    y = torch.nn.functional.conv2d(xt, wt)
    assert _rel(y.permute(0, 2, 3, 1).detach(), out) < 1e-5
    y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    assert _rel(xt.grad.permute(0, 2, 3, 1), dx_want) < 1e-5
    assert _rel(wt.grad.permute(2, 3, 1, 0), dw_want) < 1e-5


def test_reestimate_batch_stats_matches_jax(setup):
    module, v, mel, _ = setup
    batches = [mel, mel[::-1] * 0.5]
    want = jstep.reestimate_batch_stats(
        module, v["params"], v["batch_stats"],
        (jnp.asarray(b) for b in batches))
    want_sd = badwinner2_state_dict_from_flax(
        {"params": v["params"], "batch_stats": want})
    model = _port_state(v).model
    before = {k: t.clone() for k, t in model.state_dict().items()}
    got = step.reestimate_batch_stats(
        model, (torch.from_numpy(np.ascontiguousarray(b)) for b in batches))
    assert len(got) == 16
    for k, t in got.items():
        assert _rel(t, want_sd[k]) < 1e-3, k
    # the model's own buffers are left as they were
    assert all(torch.equal(before[k], t) for k, t in model.state_dict().items())


def test_eval_and_predict_match_jax(setup):
    module, v, mel, y = setup
    jstate = JaxTrainState.create(apply_fn=module.apply, params=v["params"],
                                  tx=jax_optimizer(LR),
                                  batch_stats=v["batch_stats"])
    jm = jstep.make_eval_step()(jstate, jstep.fresh_metrics(),
                                jnp.asarray(mel), jnp.asarray(y))
    jp = jstep.make_predict_fn()(jstate, jnp.asarray(mel))
    state = _port_state(v)
    m = step.make_eval_step()(state, step.fresh_metrics(),
                              torch.from_numpy(mel), torch.from_numpy(y))
    got, want = metrics.metrics_compute(m), jmetrics.metrics_compute(jm)
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1.0), k
    assert _rel(step.make_predict_fn()(state, torch.from_numpy(mel)), jp) < 1e-5


_LOGITS = np.random.default_rng(11).normal(0, 2, (5, 4)).astype(np.float32)
_LABELS = np.array([[1, 0, 0, 1], [0, 1, 0, 0], [0, 0, 0, 0], [1, 1, 0, 0],
                    [0, 0, 1, 0]], np.float32)


@pytest.mark.parametrize("name,extra", [
    ("bce", ()), ("bce", (0.1,)),
    ("bce", (0.0, np.array([0.5, 2.0, 1.0, 4.0], np.float32))),
    ("cce", ()), ("cce", (0.2,)),
    ("weighted_bce", (np.array([[1, 0, 1, 1]] * 5, np.float32),)),
    ("soft_f1", ()), ("double_soft_f1", ()), ("focal", ()),
])
def test_losses_match_jax(name, extra):
    want = jlosses.get_loss(name)(jnp.asarray(_LOGITS), jnp.asarray(_LABELS),
                                  *(jnp.asarray(e) for e in extra))
    got = losses.get_loss(name)(torch.from_numpy(_LOGITS),
                                torch.from_numpy(_LABELS),
                                *(e if isinstance(e, float)
                                  else torch.from_numpy(e) for e in extra))
    assert abs(float(got) - float(want)) <= 1e-5 * max(abs(float(want)), 1.0)


def test_metric_functions_match_jax():
    probs = 1.0 / (1.0 + np.exp(-_LOGITS))
    pt, yt = torch.from_numpy(probs), torch.from_numpy(_LABELS)
    pj, yj = jnp.asarray(probs), jnp.asarray(_LABELS)
    assert float(losses.huber(pt, yt)) == pytest.approx(
        float(jlosses.huber(pj, yj)), rel=1e-5)
    assert float(losses.macro_f1(pt, yt)) == pytest.approx(
        float(jlosses.macro_f1(pj, yj)), rel=1e-5)
    assert float(metrics.categorical_accuracy(pt, yt)) == pytest.approx(
        float(jmetrics.categorical_accuracy(pj, yj)))
    for bird_index, weighting in ((None, None), (2, np.arange(4.0))):
        w_t = None if weighting is None else torch.tensor(weighting)
        got = metrics.prec_at_k_compute(metrics.prec_at_k_update(
            metrics.prec_at_k_init(), pt, yt, 2, bird_index, w_t))
        want = jmetrics.prec_at_k_compute(jmetrics.prec_at_k_update(
            jmetrics.prec_at_k_init(), pj, yj, 2, bird_index,
            None if weighting is None else jnp.asarray(weighting)))
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    # two batches into the bundled accumulator, single- and multi-label
    for multi in (True, False):
        m, jm = step.fresh_metrics(), jstep.fresh_metrics()
        for sl in (slice(0, 3), slice(3, 5)):
            m = metrics.metrics_update(m, torch.tensor(0.3), pt[sl], yt[sl],
                                       multi)
            jm = jmetrics.metrics_update(jm, jnp.float32(0.3), pj[sl],
                                         yj[sl], multi)
        got, want = metrics.metrics_compute(m), jmetrics.metrics_compute(jm)
        for k in got:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k


def test_geo_and_possible_label_masks_match_jax():
    labels = ["bird", "kiwi", "rifleman", "noise", "tui"]
    birds = {"bird", "kiwi", "rifleman", "tui"}
    geo = step.build_geo_masks(labels, birds)
    jgeo = jstep.build_geo_masks(labels, birds)
    for a, b in zip(geo, jgeo):
        np.testing.assert_array_equal(a, b)
    assert step.build_geo_masks(["kiwi"], birds) is None
    y = np.array([[1, 0, 0, 0, 0], [1, 1, 0, 0, 0], [0, 0, 0, 1, 0],
                  [1, 0, 0, 0, 0]], np.float32)
    latlng = np.array([[-41.0, 174.0], [-41.0, 174.0], [0.0, 0.0],
                       [51.0, 0.1]], np.float32)
    np.testing.assert_array_equal(
        step.possible_from_geo(torch.from_numpy(y), torch.from_numpy(latlng),
                               geo).numpy(),
        np.asarray(jstep.possible_from_geo(jnp.asarray(y),
                                           jnp.asarray(latlng), jgeo)))
    np.testing.assert_array_equal(
        step.possible_labels_from_targets(torch.from_numpy(y), 0,
                                          geo.specific).numpy(),
        np.asarray(jstep.possible_labels_from_targets(jnp.asarray(y), 0,
                                                      jgeo.specific)))


def test_weighted_bce_step_with_geo_runs(setup):
    _, v, mel, _ = setup
    labels = ["bird", "kiwi", "rifleman", "noise", "tui", "a", "b"]
    geo = step.build_geo_masks(labels, {"bird", "kiwi", "rifleman", "tui"})
    train = step.make_train_step(loss_name="weighted_bce", geo_masks=geo)
    y = np.eye(NUM_LABELS, dtype=np.float32)[[0, 1]]
    state, m = train(_port_state(v), step.fresh_metrics(),
                     torch.from_numpy(mel), torch.from_numpy(y),
                     latlng=torch.tensor([[-41.0, 174.0], [51.0, 0.1]]))
    assert np.isfinite(metrics.metrics_compute(m)["loss"])


def test_state_seed_param_count_lr_and_remat(setup):
    module, v, mel, _ = setup
    model = build_model("badwinner2", NUM_LABELS, n_mels=96).module
    a = create_train_state(model, seed=3).model.state_dict()
    a = {k: t.clone() for k, t in a.items()}
    b = create_train_state(model, seed=3).model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = create_train_state(model, seed=4).model.state_dict()
    assert not torch.equal(a["convs.0.weight"], c["convs.0.weight"])
    state = create_train_state(model, learning_rate=0.01)
    jcount = sum(x.size for x in jax.tree_util.tree_leaves(v["params"]))
    assert param_count(state) == jcount
    assert state.current_lr() == pytest.approx(0.01)
    assert state.with_lr(0.005).current_lr() == pytest.approx(0.005)
    # remat builds a step (held to remat=False and to JAX's remat step in
    # tests/test_torch_remat.py)
    stepped, _ = step.make_train_step(remat=True)(
        _port_state(v), step.fresh_metrics(), torch.from_numpy(mel),
        torch.eye(NUM_LABELS)[[1, 4]])
    assert stepped.step == 1
