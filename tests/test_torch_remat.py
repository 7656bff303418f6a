"""``make_train_step(remat=True)`` on the CPU: the forward rematerialized in
the backward pass (``torch.utils.checkpoint``), against ``remat=False``
and against JAX's ``make_train_step(remat=True)``.

With dropout on (rate 0.5, masks from an explicit generator) one f32 step
with remat gives the step without it: loss, every parameter, every
BatchNorm running statistic and the generator's state after the step,
within 1e-6 relative (they are bitwise equal: the recompute replays the
forward's masks and restores the statistics it would update a second
time).  Against JAX, on the float64 yardstick of
tests/test_torch_train_step.py (dropout 0, where JAX keys and torch
generators draw alike): the port's remat step's metrics within 1e-5 of
its float64 run, JAX's jitted remat step within 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu.train import metrics as jmetrics
from audio_training_tpu.train import step as jstep
from audio_training_tpu.train.state import TrainState as JaxTrainState
from audio_training_tpu.train.state import make_optimizer as jax_optimizer
from audio_training_tpu_torch.models import build_model
from audio_training_tpu_torch.train import metrics, step
from audio_training_tpu_torch.train.state import create_train_state

from test_torch_train_step import (
    JAX_JIT_METRIC_TOL,
    LR,
    NUM_LABELS,
    PORT_METRIC_TOL,
    SHAPE,
    _metric_err,
    _port_state,
    float64_metrics,  # noqa: F401 (fixture)
    setup,  # noqa: F401 (fixture)
)

torch.set_num_threads(2)

REMAT_REL = 1e-6


def _inputs(name, seed=7):
    rng = np.random.default_rng(seed)
    mel = torch.from_numpy(rng.gamma(2.0, 50.0, SHAPE).astype(np.float32))
    y = torch.eye(NUM_LABELS)[[1, 4]]
    if name == "dual-badwinner2":
        return (mel, torch.from_numpy(
            rng.gamma(2.0, 50.0, SHAPE).astype(np.float32))), y
    return mel, y


def _step(name, remat):
    """One f32 train step, dropout 0.5, from seeded weights: (loss, state
    dict, generator state after, forward calls)."""
    model = build_model(name, NUM_LABELS, logits_only=True, n_mels=96,
                        generator=torch.Generator().manual_seed(0)).module
    calls = []
    model.register_forward_pre_hook(lambda *_: calls.append(1))
    state = create_train_state(model, learning_rate=LR, device="cpu")
    mel, y = _inputs(name)
    gen = torch.Generator().manual_seed(5)
    state, m = step.make_train_step(remat=remat)(
        state, step.fresh_metrics(), mel, y, gen)
    return (float(m["loss_sum"]), state.model.state_dict(), gen.get_state(),
            len(calls))


@pytest.mark.parametrize("name", ["badwinner2", "dual-badwinner2"])
def test_remat_step_equals_the_plain_step(name):
    loss, want, gen_state, calls = _step(name, remat=False)
    r_loss, got, r_gen_state, r_calls = _step(name, remat=True)
    assert (calls, r_calls) == (1, 2)  # the backward ran the forward again
    assert abs(r_loss - loss) <= REMAT_REL * abs(loss)
    assert got.keys() == want.keys()
    for k in want:
        scale = want[k].abs().max().clamp_min(1e-30)
        assert (got[k] - want[k]).abs().max() <= REMAT_REL * scale, k
    running = [k for k in want if "running" in k]
    assert running and any(not torch.equal(
        want[k], build_model(name, NUM_LABELS, n_mels=96).module.state_dict()[
            k]) for k in running)
    assert torch.equal(r_gen_state, gen_state)


def test_remat_step_matches_jax_remat_step(setup, float64_metrics):  # noqa: F811
    module, v, mel, y = setup
    jstate = JaxTrainState.create(apply_fn=module.apply, params=v["params"],
                                  tx=jax_optimizer(LR),
                                  batch_stats=v["batch_stats"])
    _, jm = jstep.make_train_step(donate=False, remat=True)(
        jstate, jstep.fresh_metrics(), jnp.asarray(mel), jnp.asarray(y),
        jax.random.PRNGKey(0))
    state, m = step.make_train_step(remat=True)(
        _port_state(v), step.fresh_metrics(), torch.from_numpy(mel),
        torch.from_numpy(y), torch.Generator().manual_seed(0))
    assert state.step == 1
    got, want = metrics.metrics_compute(m), jmetrics.metrics_compute(jm)
    assert got.keys() == want.keys() == float64_metrics.keys()
    for k, exact in float64_metrics.items():
        assert _metric_err(got[k], exact) <= PORT_METRIC_TOL, k
        assert _metric_err(want[k], exact) <= JAX_JIT_METRIC_TOL, k
