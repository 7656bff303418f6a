"""Train and eval steps (port of ``audio_training_tpu/train/step.py:27-289``).

One train step is forward, loss, backward and the Adam update, then the
metric accumulation; it replaces the reference's Keras ``model.fit`` inner
loop (audiomodel.py:550-562).  The JAX step is one jitted function; here
PyTorch runs it eagerly and updates the model, its BatchNorm running
statistics and the optimizer in place.

Under a data-parallel mesh (``make_train_step(mesh=...)``, the batch this
rank's rows) the model runs inside ``DistributedDataParallel``, whose
gradient buckets are all-reduced to their mean over the ranks and counted
(``parallel.collectives.counting_allreduce_hook``).  Its buffers are not
broadcast: the BatchNorm statistics are already the global batch's, and a
broadcast would add collectives that JAX's step does not have.  The loss
is taken inside the mesh: a loss that is a mean over rows is each rank's
mean over its rows, whose averaged gradient is the global batch's, and the
soft-F1 losses sum their counts over the ranks (``train/losses.py``).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel
from torch.utils.checkpoint import checkpoint

from audio_training_tpu_torch.parallel.collectives import (
    counting_allreduce_hook,
)
from audio_training_tpu_torch.parallel.mesh import Mesh

from audio_training_tpu_torch.train.losses import get_loss
from audio_training_tpu_torch.train.metrics import metrics_init, metrics_update
from audio_training_tpu_torch.train.state import TrainState
from audio_training_tpu_torch.utils.profiling import span

# NZ bounding box [lng_min, lat_max, lng_max, lat_min] (tfdataset.py:35)
NZ_BOX = (166.509144322, -34.4506617165, 178.517093541, -46.641235447)


class GeoMasks(NamedTuple):
    """Static per-label mask vectors for the geo-aware weighted_bce
    (tfdataset.py:229-248): which outputs count as specific birds, which is
    the generic ``bird`` output, and the two negative-term weightings used
    for generic-bird-only clips inside/outside the NZ bounding box."""

    specific: np.ndarray  # 1 where label is a specific (non-generic) bird
    generic: np.ndarray  # 1 at "bird"
    nz_weighting: np.ndarray  # NZ_BIRD_LOSS_WEIGHTING: 1 at bird (+rifleman)
    bird_weighting: np.ndarray  # BIRD_WEIGHTING: 1 at bird only


def build_geo_masks(labels: list[str], all_birds) -> GeoMasks | None:
    """The four mask vectors as get_a_dataset builds them
    (tfdataset.py:229-248); None when there is no generic ``bird`` output."""
    if "bird" not in labels:
        return None
    n = len(labels)
    specific, generic, nz_w, bird_w = (np.zeros(n, np.float32)
                                       for _ in range(4))
    bi = labels.index("bird")
    generic[bi] = bird_w[bi] = nz_w[bi] = 1.0
    if "rifleman" in labels:  # tfdataset.py:236-237
        nz_w[labels.index("rifleman")] = 1.0
    for i, l in enumerate(labels):
        if l in all_birds and l != "bird":
            specific[i] = 1.0
    return GeoMasks(specific, generic, nz_w, bird_w)


def possible_from_geo(y: torch.Tensor, latlng: torch.Tensor,
                      geo: GeoMasks) -> torch.Tensor:
    """Per-sample negative-term mask from targets + recording GPS
    (read_tfrecord, tfdataset.py:1188-1212): clips whose only bird tag is
    the generic ``bird`` get their negative loss restricted, inside the NZ
    box (or with unknown GPS) to ``NZ_BIRD_LOSS_WEIGHTING``, outside it to
    ``BIRD_WEIGHTING``."""
    as_t = lambda a: torch.as_tensor(a, dtype=y.dtype, device=y.device)
    latlng = torch.as_tensor(latlng, device=y.device)
    has_specific = (y * as_t(geo.specific)).sum(-1, keepdim=True) > 0
    has_generic = (y * as_t(geo.generic)).sum(-1, keepdim=True) > 0
    generic_only = has_generic & ~has_specific  # (B, 1)
    lat, lng = latlng[..., 0:1], latlng[..., 1:2]
    unknown = (lat == 0) | (lng == 0)  # tfdataset.py:1201-1203
    in_nz = ((lat <= NZ_BOX[1]) & (lat >= NZ_BOX[3])
             & (lng >= NZ_BOX[0]) & (lng <= NZ_BOX[2]))
    geo_possible = torch.where(unknown | in_nz, as_t(geo.nz_weighting),
                               as_t(geo.bird_weighting))  # (B, L)
    return torch.where(generic_only, geo_possible, torch.ones_like(y))


def possible_labels_from_targets(y: torch.Tensor, bird_index: int | None,
                                 specific_bird_mask) -> torch.Tensor:
    """The weighted_bce negative mask from the targets alone
    (WeightedCrossEntropy, audiomodel.py:2637-2643): on a clip whose only
    bird tag is the generic ``bird``, specific-bird negatives are masked."""
    if bird_index is None or specific_bird_mask is None:
        return torch.ones_like(y)
    specific = torch.as_tensor(specific_bird_mask, dtype=y.dtype,
                               device=y.device)
    has_specific = (y * specific).sum(-1, keepdim=True) > 0
    is_bird_clip = y[..., bird_index:bird_index + 1] > 0
    generic_only = is_bird_clip & ~has_specific  # (B, 1)
    return 1.0 - generic_only.to(y.dtype) * specific


def _make_loss(loss_name, label_smoothing, class_weights, bird_index,
               specific_bird_mask, geo_masks):
    """loss(logits, y, possible, latlng) with the JAX steps' dispatch."""
    loss_fn = get_loss(loss_name)

    def loss(logits, y, possible=None, latlng=None):
        if loss_name == "weighted_bce":
            if possible is None and latlng is not None and geo_masks is not None:
                possible = possible_from_geo(y, latlng, geo_masks)
            if possible is None:
                possible = possible_labels_from_targets(
                    y, bird_index, specific_bird_mask)
            return loss_fn(logits, y, possible)
        if loss_name == "cce":
            return loss_fn(logits, y, label_smoothing)
        if loss_name == "bce":
            return loss_fn(logits, y, label_smoothing, class_weights)
        return loss_fn(logits, y)

    return loss


def _probs(logits: torch.Tensor, multi_label: bool) -> torch.Tensor:
    return torch.sigmoid(logits) if multi_label else torch.softmax(logits, -1)


@contextlib.contextmanager
def _replaying(model: torch.nn.Module, generator: torch.Generator | None,
               forward_state: torch.Tensor | None):
    """The recompute of a checkpointed forward: the model's buffers (the
    BatchNorm running statistics, which train mode updates in place) and
    the dropout generator are set back on exit to what the forward left,
    and the generator starts from the state the forward started from, so
    that it draws the forward's masks again.  Non-reentrant checkpointing
    may stop the recompute early; the exit restores all the same."""
    buffers = [b.clone() for b in model.buffers()]
    after = generator.get_state() if generator is not None else None
    if generator is not None:
        generator.set_state(forward_state)
    try:
        yield
    finally:
        with torch.no_grad():
            for b, saved in zip(model.buffers(), buffers):
                b.copy_(saved)
        if generator is not None:
            generator.set_state(after)


def remat_forward(model: torch.nn.Module, inputs: tuple,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """``model(*inputs, generator=generator)`` with its activations
    rematerialized in the backward pass (JAX wraps the forward in
    ``jax.checkpoint``, train/step.py:146-147): the forward keeps only its
    inputs, and the backward runs it again.  The recompute updates no
    running statistic a second time and replays the forward's dropout
    masks (:func:`_replaying`)."""
    start = generator.get_state() if generator is not None else None
    return checkpoint(
        lambda *xs: model(*xs, generator=generator), *inputs,
        use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            _replaying(model, generator, start)))


class _Remat(nn.Module):
    """``model``'s forward through :func:`remat_forward`, as a module that
    DistributedDataParallel can wrap: the recompute runs inside the
    wrapper's forward, so it replays the BatchNorm all-reduces too."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *inputs, generator=None):
        return remat_forward(self.model, inputs, generator)


def data_parallel(model: nn.Module, mesh: Mesh,
                  remat: bool = False) -> DistributedDataParallel:
    """``model`` (or its rematerialized forward) in DistributedDataParallel
    over ``mesh``'s group, without buffer broadcasts, its gradient buckets
    all-reduced by :func:`counting_allreduce_hook`.  Building it checks the
    parameters' shapes across the ranks and broadcasts rank 0's."""
    device = next(model.parameters()).device
    with warnings.catch_warnings():
        # newer releases deprecate broadcast_buffers for forward_sync_buffers,
        # whose False still broadcasts the buffers once at build time
        warnings.filterwarnings("ignore", ".*broadcast_buffers",
                                FutureWarning)
        ddp = DistributedDataParallel(
            _Remat(model) if remat else model,
            device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False, process_group=mesh.group)
    ddp.register_comm_hook(mesh, counting_allreduce_hook)
    return ddp


def make_train_step(
    loss_name: str = "bce",
    multi_label: bool = True,
    label_smoothing: float = 0.0,
    class_weights=None,
    remat: bool = False,
    bird_index: int | None = None,
    specific_bird_mask=None,
    geo_masks: GeoMasks | None = None,
    mesh: Mesh | None = None,
) -> Callable:
    """Returns ``step(state, metrics, mel, y, generator=None, possible=None,
    latlng=None) -> (state, metrics)``; ``generator`` draws the dropout
    masks.  The model must return logits (``logits_only=True``).  ``remat``
    rematerializes the forward's activations in the backward pass
    (:func:`remat_forward`), trading its recompute for activation memory.

    With ``geo_masks`` set and a per-sample ``latlng`` batch given, the
    weighted_bce negative mask follows the reference's NZ-bounding-box rule
    (possible_from_geo); otherwise it falls back to the target-only
    approximation (possible_labels_from_targets).

    With a ``mesh`` of more than one rank, ``mel`` and ``y`` are this
    rank's rows of the global batch, the model runs in
    :func:`data_parallel` (built at the first step, once a model) and the
    step runs inside the mesh, so BatchNorm takes the global moments."""
    loss_of = _make_loss(loss_name, label_smoothing, class_weights,
                         bird_index, specific_bird_mask, geo_masks)
    parallel = mesh is not None and mesh.distributed
    wrapped: list[tuple[nn.Module, DistributedDataParallel]] = []

    def forward(model, inputs, generator):
        if parallel:
            if not wrapped or wrapped[0][0] is not model:
                wrapped[:] = [(model, data_parallel(model, mesh, remat))]
            return wrapped[0][1](*inputs, generator=generator)
        if remat:
            return remat_forward(model, inputs, generator)
        return model(*inputs, generator=generator)

    def step(state: TrainState, metrics, mel, y, generator=None,
             possible=None, latlng=None):
        with span("train.step"):
            model = state.model.train()
            inputs = mel if isinstance(mel, tuple) else (mel,)
            # the forward, the loss and the backward (whose remat recompute
            # replays the BatchNorm all-reduces) run inside the mesh
            with mesh if parallel else contextlib.nullcontext():
                with span("train.forward"):
                    logits = forward(model, inputs, generator)
                loss = loss_of(logits, y, possible, latlng)
                state.optimizer.zero_grad(set_to_none=True)
                with span("train.backward"):
                    loss.backward()
            state.optimizer.step()
            state.step += 1
            with torch.no_grad():
                metrics = metrics_update(metrics, loss.detach(),
                                         _probs(logits.detach(), multi_label),
                                         y, multi_label)
            return state, metrics

    return step


def make_eval_step(
    loss_name: str = "bce",
    multi_label: bool = True,
    label_smoothing: float = 0.0,
    bird_index: int | None = None,
    specific_bird_mask=None,
    geo_masks: GeoMasks | None = None,
) -> Callable:
    """``step(state, metrics, mel, y, possible=None, latlng=None) ->
    metrics``; as in the JAX eval step, bce takes no class weights."""
    loss_of = _make_loss(loss_name, label_smoothing, None, bird_index,
                         specific_bird_mask, geo_masks)

    @torch.no_grad()
    def step(state: TrainState, metrics, mel, y, possible=None, latlng=None):
        inputs = mel if isinstance(mel, tuple) else (mel,)
        logits = state.model.eval()(*inputs)
        loss = loss_of(logits, y, possible, latlng)
        return metrics_update(metrics, loss, _probs(logits, multi_label), y,
                              multi_label)

    return step


@torch.no_grad()
def reestimate_batch_stats(model: torch.nn.Module, batches,
                           momentum: float = 0.99,
                           dropout_seed: int = 0) -> dict[str, torch.Tensor]:
    """Exact one-pass BatchNorm running-statistics re-estimation (JAX
    ``step.py:217-269``).

    Each batch runs in train mode from the SAME starting statistics; the
    Flax update ``new = m*old + (1-m)*batch`` gives back each batch's own
    moments as ``(new - m*old) / (1-m)``, and those are averaged over the
    batches.  Returns the new ``running_mean``/``running_var`` buffers by
    ``state_dict`` name; the model's own buffers are left as they were.
    ``batches`` yields model input(s)."""
    names = [n for n, _ in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    buffers = dict(model.named_buffers())
    start = {n: buffers[n].clone() for n in names}
    sums, count = None, 0
    was_training = model.training
    model.train()
    device = next(model.parameters()).device
    for inputs in batches:
        gen = torch.Generator(device=device).manual_seed(dropout_seed)
        model(*(inputs if isinstance(inputs, tuple) else (inputs,)),
              generator=gen)
        vals = {n: (buffers[n] - momentum * start[n]) / (1.0 - momentum)
                for n in names}
        sums = vals if sums is None else {n: sums[n] + vals[n] for n in names}
        count += 1
        for n in names:
            buffers[n].copy_(start[n])
    model.train(was_training)
    if not count:
        return start
    return {n: sums[n] / count for n in names}


def make_predict_fn(multi_label: bool = True) -> Callable:
    """``predict(state, mel) -> probabilities`` (eval mode, no grad)."""

    @torch.no_grad()
    def predict(state: TrainState, mel):
        inputs = mel if isinstance(mel, tuple) else (mel,)
        return _probs(state.model.eval()(*inputs), multi_label)

    return predict


def fresh_metrics(device: str | torch.device = "cpu") -> dict:
    return metrics_init(device)
