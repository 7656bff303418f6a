"""The ranks' side of tests/test_torch_parallel.py: one function that each
of two gloo CPU ranks runs, on its rows of the inputs that the test made
from a numpy seed, returning numpy results for the test to hold against
one process and against JAX.  It imports no JAX (the ranks are spawned
processes), and every rank issues the same collectives in the same order.
"""

import torch

from audio_training_tpu_torch.config import FeaturizerConfig, InferenceConfig
from audio_training_tpu_torch.data.preprocess import make_preprocess_fn
from audio_training_tpu_torch.infer import Predictor
from audio_training_tpu_torch.models import build_model
from audio_training_tpu_torch.models.layers import KerasBatchNorm, PCENLayer
from audio_training_tpu_torch.ops.features import normalize_minmax
from audio_training_tpu_torch.parallel import (
    batch_sharding,
    global_batch_from_local,
    initialize_distributed,
    make_mesh,
    process_shard,
    replicated,
    shard_batch,
)
from audio_training_tpu_torch.parallel.audit import counting
from audio_training_tpu_torch.train import step as port_step
from audio_training_tpu_torch.train.metrics import metrics_compute
from audio_training_tpu_torch.train.state import create_train_state

CPU = torch.device("cpu")


def numpy_of(tensors: dict) -> dict:
    return {k: v.detach().double().numpy() for k, v in tensors.items()}


def grad_of(model) -> dict:
    return {n: p.grad.detach().double().numpy()
            for n, p in model.named_parameters()}


def badwinner2(num_labels: int, n_mels: int, state_dict=None, seed=0,
               mel_frames=None):
    kw = {} if mel_frames is None else {"mel_frames": mel_frames}
    model = build_model("badwinner2", num_labels, logits_only=True,
                        n_mels=n_mels, dropout=0.0, **kw).module
    if state_dict is not None:
        model.load_state_dict(state_dict)
        return create_train_state(model, learning_rate=1e-3, device=CPU)
    return create_train_state(model, learning_rate=1e-3, seed=seed,
                              device=CPU)


def step_result(state, metrics) -> dict:
    return {"metrics": metrics_compute(metrics), "grads": grad_of(state.model),
            "after": numpy_of(state.model.state_dict())}


def check_helpers(mesh, p) -> dict:
    out = {"shape": mesh.shape, "rank": mesh.rank, "backend": mesh.backend,
           "device": str(mesh.device), "initialized": initialize_distributed(),
           "process_shard": process_shard(p["items"])}
    try:
        make_mesh(num_data=4, devices=[CPU] * 4)
    except ValueError as e:
        out["mesh_error"] = str(e)
    x = p["helper_x"]
    rows = slice(mesh.rank * len(x) // 2, (mesh.rank + 1) * len(x) // 2)
    out["local"] = global_batch_from_local(mesh, x[rows]).numpy()
    out["sharded"] = shard_batch(mesh, x).numpy()
    try:
        shard_batch(mesh, x[:3])
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def check_batchnorm(mesh, p) -> dict:
    """Both BN kinds on this rank's rows: output, input and parameter
    gradients of sum(out * w), running statistics."""
    out = {}
    for kind, kw in (("channels", {}), ("per_mel", dict(
            feature_dim=2, use_scale=False, use_bias=False))):
        x, w = p[f"bn_{kind}"]
        bn = KerasBatchNorm(x.shape[kw.get("feature_dim", 1)], **kw)
        bn.load_state_dict(p[f"bn_{kind}_state"])
        xl, wl = shard_batch(mesh, x, w)
        xl.requires_grad_(True)
        with mesh:
            y = bn.train()(xl)
            (y * wl).sum().backward()
        out[kind] = {"y": y.detach().numpy(), "dx": xl.grad.numpy(),
                     "params": {n: q.grad.numpy()
                                for n, q in bn.named_parameters()},
                     "stats": numpy_of(dict(bn.named_buffers()))}
    return out


def check_minmax(mesh, p) -> dict:
    """The global min-max and PCENLayer: forward and input gradients (and
    PCEN's parameter gradients) of sum(out * w)."""
    out = {}
    x, w = p["minmax"]
    xl, wl = shard_batch(mesh, x, w)
    xl.requires_grad_(True)
    with mesh:
        y = normalize_minmax(xl)
        (y * wl).sum().backward()
    out["minmax"] = {"y": y.detach().numpy(), "dx": xl.grad.numpy()}
    x, w = p["pcen"]
    layer = PCENLayer(time_axis=1).double()
    xl, wl = shard_batch(mesh, x, w)
    xl.requires_grad_(True)
    with mesh:
        y = layer(xl)
        (y * wl).sum().backward()
    out["pcen"] = {"y": y.detach().numpy(), "dx": xl.grad.numpy(),
                   "params": {n: q.grad.numpy()
                              for n, q in layer.named_parameters()}}
    return out


def check_jax_step(mesh, p) -> dict:
    """One DP step of badwinner2 from JAX's converted weights on this rank's
    rows; then, from the same start, the remat step; then a second step
    counted for the audit; and a bare forward counted too."""
    mel, y = p["step_batch"]
    out = {}
    for remat in (False, True):
        state = badwinner2(p["num_labels"], mel.shape[1], p["step_weights"])
        replicated(mesh)(state.model)
        step = port_step.make_train_step(remat=remat, mesh=mesh)
        ml, yl = shard_batch(mesh, mel, y)
        state, metrics = step(state, port_step.fresh_metrics(), ml, yl,
                              torch.Generator().manual_seed(mesh.rank))
        with mesh:
            out["remat" if remat else "plain"] = step_result(state, metrics)
        with counting() as inv:
            step(state, port_step.fresh_metrics(), ml, yl,
                 torch.Generator().manual_seed(mesh.rank))
        out["inventory_remat" if remat else "inventory"] = inv.ops
    with counting() as inv, mesh, torch.no_grad():
        state.model.eval()(ml)
    out["forward_inventory"] = inv.ops
    # float64, where only summation order separates two runs; the soft-F1
    # losses, whose counts are the global batch's
    for loss in ("bce", "soft_f1", "double_soft_f1"):
        state = badwinner2(p["num_labels"], mel.shape[1], p["step_weights"])
        state.model.double()
        step = port_step.make_train_step(loss_name=loss, mesh=mesh)
        state, metrics = step(state, port_step.fresh_metrics(), ml.double(),
                              yl.double(), torch.Generator().manual_seed(0))
        with mesh:
            out["float64" if loss == "bce" else loss] = step_result(
                state, metrics)
    return out


def check_augmented_step(mesh, p) -> dict:
    """One DP step through the augmented preprocess (mixup and SpecAugment,
    drawn for the global batch from the same generator on each rank)."""
    cfg = FeaturizerConfig(**p["geometry"])
    raw, y, raw2, y2 = p["augment_batch"]
    state = badwinner2(p["num_labels"], cfg.n_mels, seed=p["seed"])
    pre = make_preprocess_fn(cfg, augment=True, use_spec_augment=True,
                             mixup_chance=1.0, device=CPU)
    step = port_step.make_train_step(mesh=mesh)
    with mesh:
        mel, yy = pre(*shard_batch(mesh, raw, y, raw2, y2),
                      torch.Generator().manual_seed(p["seed"]))
    state, metrics = step(state, port_step.fresh_metrics(), mel, yy,
                          torch.Generator().manual_seed(mesh.rank))
    with mesh:
        out = step_result(state, metrics)
    out["mel"], out["y"] = mel.numpy(), yy.numpy()
    return out


def check_predictor(mesh, p) -> dict:
    """The sharded Predictor on 10 windows and on 3 (padded up to the
    bucket, then to a multiple of the ranks); a window batch cap that the
    ranks do not divide."""
    cfg = FeaturizerConfig(**p["predict_geometry"])
    module = build_model("badwinner2", 3, logits_only=True, n_mels=cfg.n_mels,
                         mel_frames=cfg.mel_frames).module
    module.load_state_dict(p["predict_weights"])
    windows = p["windows"]
    pred = Predictor(module, ["a", "b", "c"], cfg,
                     InferenceConfig(max_window_batch=16, bucket_sizes=(8, 16)),
                     device=CPU, mesh=mesh)
    out = {"probs": pred.predict_windows(windows)}
    with counting() as inv:
        out["small"] = pred.predict_windows(windows[:3])
    out["inventory"] = inv.ops
    odd = Predictor(module, ["a", "b", "c"], cfg,
                    InferenceConfig(max_window_batch=3, bucket_sizes=(8,)),
                    device=CPU, mesh=mesh)
    try:
        odd.predict_windows(windows[:8])
    except ValueError as e:
        out["odd_cap"] = str(e)
    return out


def parallel_checks(rank: int, p: dict) -> dict:
    torch.set_num_threads(1)
    mesh = make_mesh(num_data=2, devices=[CPU, CPU])
    return {"helpers": check_helpers(mesh, p),
            "batchnorm": check_batchnorm(mesh, p),
            "minmax": check_minmax(mesh, p),
            "jax_step": check_jax_step(mesh, p),
            "augmented": check_augmented_step(mesh, p),
            "predictor": check_predictor(mesh, p)}


def batch_norm_kernels_rank(rank: int, cases: list) -> list[dict]:
    """Train-mode BatchNorm's CUDA kernels under a mesh of two ranks on
    one card (gloo), for tests/test_torch_gpu.py: for each ``(state,
    feature_dim, use_scale, use_bias, x, dy)`` case of the whole batch, a
    KerasBatchNorm forward and backward on this rank's rows; returns y and
    dx of the rows, the parameter gradients (this rank's sums), the running
    statistics and the kernels' launches, on the host."""
    from audio_training_tpu_torch.ops.cuda import batch_norm as bn

    dev = torch.device("cuda", 0)
    mesh = make_mesh(num_data=2, devices=[dev, dev])
    out = []
    for state, feature_dim, scale, bias, x, dy in cases:
        m = KerasBatchNorm(x.shape[feature_dim], feature_dim, scale, bias)
        m.load_state_dict(state)
        m = m.to(dev).train()
        rows = batch_sharding(mesh).rows(x.shape[0])
        xl, dyl = (t[rows].to(dev) for t in (x, dy))
        xl.requires_grad_(True)
        params = [p for p in (m.weight, m.bias) if p is not None]
        bn.reset_launch_counts()
        with mesh:
            y = m(xl)
            dx, *dp = torch.autograd.grad(y, [xl, *params], dyl)
        torch.cuda.synchronize()
        out.append({"y": y.cpu(), "dx": dx.cpu(),
                    "grads": [g.cpu() for g in dp],
                    "stats": [m.running_mean.cpu(), m.running_var.cpu()],
                    "counts": bn.launch_counts()})
    return out


def train_run_rank(rank: int, data_dirs, root, train_kwargs: dict,
                   run_kwargs: dict) -> dict:
    """``train_run`` on this rank (CPU, gloo): its result and the files of
    the run directory as this rank sees them when it returns."""
    from pathlib import Path

    from audio_training_tpu_torch.config import TrainConfig
    from audio_training_tpu_torch.train import harness

    torch.set_num_threads(1)
    try:
        result = harness.train_run(
            data_dirs, "dp", checkpoint_root=root,
            train_cfg=TrainConfig(**train_kwargs), device="cpu", **run_kwargs)
    except ValueError as e:
        return {"error": str(e)}
    run_dir = Path(result.run_dir)
    return {"history": result.history, "labels": result.labels,
            "test_metrics": result.test_metrics,
            "files": sorted(str(p.relative_to(run_dir))
                            for p in run_dir.rglob("*") if p.is_file())}


def train_runs_rank(rank: int, runs: list[tuple]) -> list[dict]:
    """:func:`train_run_rank` for each ``(data_dirs, root, train_kwargs,
    run_kwargs)`` of ``runs`` in turn, in one group."""
    return [train_run_rank(rank, *run) for run in runs]


def slow_rank_zero(rank: int, seconds: float) -> str:
    """``on_rank_zero`` over a run of ``seconds``: rank 1 waits for it."""
    import time

    from audio_training_tpu_torch.parallel.multihost import on_rank_zero

    def run():
        time.sleep(seconds)
        return "done"

    return on_rank_zero(run)
