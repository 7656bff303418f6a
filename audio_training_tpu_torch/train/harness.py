"""End-to-end training from a built corpus (port of
``audio_training_tpu/train/harness.py:50-1081``; audiomodel.AudioModel
.train_model, audiomodel.py:405-567): label init from training-meta (+
second/extra/human dataset dirs), count-based label admission, dataset
streams, model build, class weights, fit with the callback suite, BN
re-estimation, test-set confusion, metadata.

Every run kind of the JAX package: the mel families, the dual-badwinner2
views, the joint ``merge`` run (:func:`_train_merge_run`), the
vector-input ``cnn-features`` / ``embeddings`` runs
(:func:`_train_vector_run`) and the ``rf-features`` random forest
(:func:`train_random_forest`).  ``num_data_shards > 1`` trains the mel
families data-parallel over that many ranks of the process group, as JAX
does over its mesh: :func:`train_run` builds the mesh before it dispatches,
the merge run refuses it with JAX's message and the vector runs train on
one device.  ``backbone_weights`` starts a keras.applications backbone from
a local Keras weight file (``models/transplant``), which needs TensorFlow
where the run builds its model, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import logging
import pickle
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from audio_training_tpu_torch.config import FeaturizerConfig, TrainConfig
from audio_training_tpu_torch.data import (
    BatchLoader,
    EmbeddingStream,
    FeatureStream,
    RecordStream,
    build_training_stream,
    find_shards,
    get_weighting,
    load_meta,
    make_merge_preprocess_fn,
    make_preprocess_fn,
    weights_to_array,
)
from audio_training_tpu_torch.data.pipeline import interleave
from audio_training_tpu_torch.eval.confusion import (
    multi_label_confusion,
    save_confusion,
    save_raw_predictions,
    single_label_confusion,
)
from audio_training_tpu_torch.models import build_model
from audio_training_tpu_torch.models.registry import build_random_forest
from audio_training_tpu_torch.parallel import (
    batch_sharding,
    make_mesh,
    replicated,
)
from audio_training_tpu_torch.parallel.collectives import gather_rows
from audio_training_tpu_torch.parallel.multihost import (
    is_primary,
    on_rank_zero,
)
from audio_training_tpu_torch.taxonomy.ebird import get_ebird_id
from audio_training_tpu_torch.taxonomy.labels import (
    LabelSpace,
    admit_labels_by_count,
    build_label_space,
    get_excluded_labels,
)
from audio_training_tpu_torch.taxonomy.ontology import Ontology, load_ontology
from audio_training_tpu_torch.train.checkpoints import (
    SUFFIX,
    restore_into,
    restore_with_new_head,
    save_state,
)
from audio_training_tpu_torch.train.loop import fit
from audio_training_tpu_torch.train.metadata import save_metadata
from audio_training_tpu_torch.train.state import create_train_state, param_count
from audio_training_tpu_torch.train.step import (
    build_geo_masks,
    make_predict_fn,
    reestimate_batch_stats,
)

log = logging.getLogger(__name__)

# the run kinds whose models take stored vectors, not a mel image
_VECTOR_MODELS = ("embeddings", "cnn-features")


def trains_on_one_device(model_name: str) -> bool:
    """Whether a run kind trains on one device whatever ``num_data_shards``
    says, as in JAX: ``rf-features`` and the vector-input models."""
    return model_name.lower() in ("rf-features", *_VECTOR_MODELS)


def init_labels(
    data_dirs: list[Path],
    ontology: Ontology | None = None,
    use_generic_bird: bool = True,
    only_features: bool = False,
    morepork_model: bool = False,
) -> tuple[LabelSpace, Ontology, dict]:
    """Resolve the run's label space (audiomodel.init_labels,
    audiomodel.py:1647-1776): union of dataset labels -> eBird ids ->
    count-based admission -> exclusions (+merge-mode overrides)."""
    ontology = ontology or load_ontology()
    labels: set[str] = set()
    meta = None
    for d in data_dirs:
        m = load_meta(d)
        labels.update(m.get("labels", []))
        ontology, _ = admit_labels_by_count(ontology, m)
        if meta is None:
            meta = m

    labels = sorted({get_ebird_id(l) for l in labels})
    if use_generic_bird and "bird" not in labels:
        labels.append("bird")
    labels.sort()

    if only_features:
        # merge everything into bird/animal/noise (audiomodel.py:1708-1732)
        merge = {}
        if "animal" not in labels:
            labels.append("animal")
        for l in labels:
            if l == "bird":
                continue
            if l in ontology.all_birds:
                merge[l] = "bird"
            elif l in ontology.animal_labels:
                merge[l] = "animal"
            elif l == "insect" or l in ontology.noise_labels:
                merge[l] = "noise"
        ontology = ontology.with_relabel_map(merge)
        excluded = ["false-positive"]
    elif morepork_model:
        # everything except morepork folds to bird/noise/human
        # (audiomodel.py:1733-1767)
        merge = {}
        for l in labels:
            if l in ("morepo2", "bird"):
                continue
            if l in ontology.all_birds:
                merge[l] = "bird"
            elif l in ontology.animal_labels or l == "insect" or (
                l in ontology.insect_labels
            ):
                merge[l] = "noise"
            elif l in ontology.noise_labels:
                merge[l] = "noise"
            elif l in ontology.human_labels:
                merge[l] = "human"
        ontology = ontology.with_relabel_map(merge)
        excluded = ["false-positive"]
    else:
        excluded = get_excluded_labels(ontology, list(labels))
        if use_generic_bird and "bird" in excluded:
            excluded.remove("bird")
        if not use_generic_bird:
            excluded.append("bird")
        # default path also drops standalone human/noise outputs
        # (audiomodel.py:1768-1773)
        for extra in ("human", "noise"):
            if extra not in excluded:
                excluded.append(extra)

    space = build_label_space(
        ontology, sorted(labels), excluded_labels=excluded,
        use_generic_bird=use_generic_bird,
    )
    return space, ontology, meta or {}


def _maybe_restore(state, weights, weight_labels, labels):
    """Resume / fine-tune restore (audiomodel.py:835-857) from a port
    weights file: when the label sets differ the fresh head is kept
    (shape-mismatch merge)."""
    if weights is None:
        return state
    if weight_labels is None:
        # infer the source label set from metadata.txt beside the weights
        src_meta = Path(weights).parent / "metadata.txt"
        if src_meta.exists():
            try:
                weight_labels = json.loads(src_meta.read_text()).get(
                    "ebird_labels"
                )
            except (OSError, ValueError):
                pass
    if weight_labels is not None and list(weight_labels) != labels:
        log.info("Fine-tuning from %s with a new head", weights)
        return restore_with_new_head(state, weights)
    log.info("Resuming from %s", weights)
    return restore_into(state, weights)


@dataclass
class TrainRunResult:
    run_dir: Path
    labels: list[str]
    history: dict
    test_metrics: dict = field(default_factory=dict)


def _host(t) -> np.ndarray:
    return t.float().cpu().numpy()


def _split_shards(data_dirs, split_shards, split: str) -> list[Path]:
    """A split's shard files: ``split_shards``' list when given, else every
    data dir's ``<split>/`` shards."""
    if split_shards is not None:
        return list(split_shards.get(split) or [])
    return [p for d in data_dirs for p in find_shards(d, split)]


def _stack(items, i: int, device) -> torch.Tensor:
    return torch.as_tensor(np.stack([it[i] for it in items]), device=device)


def _train_counts(data_meta: dict) -> dict:
    return data_meta.get("counts", {}).get("train", {}).get(
        "sample_counts", {})


def _kept_meta(data_meta: dict) -> dict:
    return {k: v for k, v in data_meta.items() if k in ("counts", "type")}


def _train_vector_run(run_dir, data_dirs, split_shards, space, ontology,
                      labels, train_cfg, cfg, spec, epochs, steps_per_epoch,
                      data_meta, weights=None, weight_labels=None,
                      device="cuda") -> "TrainRunResult":
    """Training of the vector-input families (JAX ``harness.py:156-284``):
    the ``embeddings`` linear probe over stored Perch vectors
    (tfdatasetembeddings.py pipeline) and the ``cnn-features`` short / mid
    feature towers (tfdataset.py:1041-1111 feature parsing).  Batches come
    straight from the records onto ``device``: no featurizer, so no
    kernel."""
    embedding = spec.inputs == ("embedding",)

    def make_stream(split, loop):
        sh = _split_shards(data_dirs, split_shards, split)
        if not sh:
            return None
        if embedding:
            # tfdatasetembeddings.py has no decode-time sample filters
            return EmbeddingStream(sh, space, loop=loop, seed=train_cfg.seed)
        return FeatureStream(
            sh, space, loop=loop, seed=train_cfg.seed,
            exclude_low_samples=train_cfg.no_low_samples,
            drop_bird_only=train_cfg.multi_label
            and not train_cfg.use_bird_tags,
        )

    def batches(stream):
        it = iter(stream)
        while True:
            items = list(itertools.islice(it, train_cfg.batch_size))
            if len(items) < train_cfg.batch_size:
                return
            y = _stack(items, -1, device)
            if embedding:
                yield _stack(items, 0, device), y
            else:
                yield (_stack(items, 0, device), _stack(items, 1, device)), y

    train_stream = make_stream("train", loop=True)
    if train_stream is None:
        raise ValueError("no train shards found")
    if steps_per_epoch is None:
        # the builder's metadata counts, else one decode pass
        n = int(sum(_train_counts(data_meta).values()))
        if not n:
            n = sum(1 for _ in make_stream("train", loop=False))
        if n == 0:
            raise ValueError(
                "no usable vector records in the train split — rebuild with "
                "--embedding-model / --add-features"
            )
        steps_per_epoch = max(n // train_cfg.batch_size, 1)
    train_iter = iter(batches(train_stream))

    def train_batches(epoch):
        yield from itertools.islice(train_iter, steps_per_epoch)

    def val_batches():
        stream = make_stream("validation", loop=False)
        if stream is None:
            return
        yield from batches(stream)

    identity = lambda x, y: (x, y)  # noqa: E731
    state = create_train_state(spec.module,
                               learning_rate=train_cfg.learning_rate,
                               seed=train_cfg.seed, device=device)
    state = _maybe_restore(state, weights, weight_labels, labels)
    log.info("Model %s (vector inputs %s) has %s params",
             train_cfg.model_name, spec.inputs, param_count(state))
    save_metadata(
        run_dir, train_cfg.model_name, labels, cfg, ontology,
        loss_fn=train_cfg.loss, multi_label=train_cfg.multi_label,
        use_generic_bird=train_cfg.use_generic_bird,
        training_data_meta=_kept_meta(data_meta),
    )
    result = fit(
        state, train_batches, identity,
        epochs=epochs or train_cfg.epochs,
        steps_per_epoch=steps_per_epoch,
        val_batches=val_batches, val_preprocess=identity,
        loss_name=train_cfg.loss, multi_label=train_cfg.multi_label,
        run_dir=run_dir,
        early_stop_patience=train_cfg.early_stop_patience,
        reduce_lr_patience=train_cfg.reduce_lr_patience,
        reduce_lr_factor=train_cfg.reduce_lr_factor,
        seed=train_cfg.seed, augment=False,
    )
    return TrainRunResult(run_dir=run_dir, labels=labels,
                          history=result.history)


def _train_merge_run(run_dir, data_dirs, split_shards, space, ontology,
                     labels, train_cfg, cfg, spec, epochs, steps_per_epoch,
                     data_meta, weights=None, weight_labels=None,
                     confusion=True, device="cuda") -> "TrainRunResult":
    """Joint end-to-end training of the ``merge`` model (JAX
    ``harness.py:287-495``; audiomodel.py:674-708: badwinner2 mel tower +
    short_f (68, 60) + mid_f (136, 3) feature towers, concat -> Dense,
    trained as one model).

    Streams ``(raw, y, short_f, mid_f)`` straight from the feature-bearing
    records (tfdataset.py:1103-1119); the device preprocess mixes all three
    input tensors with one shared lambda and featurizes the waveform
    (:func:`make_merge_preprocess_fn`: K1 on the card).  As in the JAX
    package, no BN re-estimation; the test split's confusion is written."""
    if train_cfg.num_data_shards > 1:
        raise ValueError(
            "merge training does not implement mesh data-parallelism yet; "
            "run with num_data_shards=1 (--data-shards 1)"
        )

    def make_stream(split, loop, seed_offset=0):
        sh = _split_shards(data_dirs, split_shards, split)
        if not sh:
            return None
        return RecordStream(
            sh, space, cfg.samples_per_clip, loop=loop,
            seed=train_cfg.seed + seed_offset, with_features=True,
            cache=split != "train",
            exclude_low_samples=train_cfg.no_low_samples,
            drop_bird_only=train_cfg.multi_label
            and not train_cfg.use_bird_tags,
            filter_freq=train_cfg.filter_freq,
            random_butter=train_cfg.random_butter,
        )

    def batches(stream, mix_stream=None):
        """Yield ``((raw, short, mid), y[, (raw2, short2, mid2), y2])``.
        Eval streams (no mixup partner) emit the final partial batch, as
        ``BatchLoader`` does; the mixup zip keeps fixed shapes and drops
        remainders."""
        it = iter(stream)
        mix_it = iter(mix_stream) if mix_stream is not None else None

        def take(source, allow_partial):
            items = list(itertools.islice(source, train_cfg.batch_size))
            if not items or (
                len(items) < train_cfg.batch_size and not allow_partial
            ):
                return None
            return (tuple(_stack(items, i, device) for i in (0, 2, 3)),
                    _stack(items, 1, device))

        while True:
            main = take(it, allow_partial=mix_it is None)
            if main is None:
                return
            if mix_it is None:
                yield main
                continue
            partner = take(mix_it, allow_partial=False)
            if partner is None:
                return
            yield (*main, *partner)

    train_stream = make_stream("train", loop=True)
    if train_stream is None:
        raise ValueError("no train shards found")
    mix_stream = make_stream("train", loop=True, seed_offset=7919)
    if steps_per_epoch is None:
        n = int(sum(_train_counts(data_meta).values()))
        if not n:
            n = sum(1 for _ in make_stream("train", loop=False))
        if n == 0:
            raise ValueError(
                "no feature-bearing records in the train split — rebuild "
                "with --add-features"
            )
        steps_per_epoch = max(n // train_cfg.batch_size, 1)
    train_iter = iter(batches(train_stream, mix_stream))

    def train_batches(epoch):
        yield from itertools.islice(train_iter, steps_per_epoch)

    # built once, so that its RAM cache survives across epochs
    val_stream = make_stream("validation", loop=False)

    def val_batches():
        if val_stream is None:
            return
        yield from batches(val_stream)

    pre_train = make_merge_preprocess_fn(
        cfg, augment=True, mixup_alpha=train_cfg.mixup_alpha,
        mixup_chance=train_cfg.mixup_chance, device=device,
    )
    pre_eval = make_merge_preprocess_fn(cfg, augment=False, device=device)
    state = create_train_state(spec.module,
                               learning_rate=train_cfg.learning_rate,
                               seed=train_cfg.seed, device=device)
    state = _maybe_restore(state, weights, weight_labels, labels)
    log.info("Model %s (merge inputs) has %s params", train_cfg.model_name,
             param_count(state))

    def write_metadata(history=None, test_results=None):
        save_metadata(
            run_dir, train_cfg.model_name, labels, cfg, ontology,
            loss_fn=train_cfg.loss, multi_label=train_cfg.multi_label,
            use_generic_bird=train_cfg.use_generic_bird,
            history=history, test_results=test_results,
            training_data_meta=_kept_meta(data_meta),
        )

    write_metadata()
    result = fit(
        state, train_batches, pre_train,
        epochs=epochs or train_cfg.epochs,
        steps_per_epoch=steps_per_epoch,
        val_batches=val_batches, val_preprocess=pre_eval,
        loss_name=train_cfg.loss, multi_label=train_cfg.multi_label,
        label_smoothing=train_cfg.label_smoothing,
        run_dir=run_dir,
        early_stop_patience=train_cfg.early_stop_patience,
        reduce_lr_patience=train_cfg.reduce_lr_patience,
        reduce_lr_factor=train_cfg.reduce_lr_factor,
        seed=train_cfg.seed, augment=True,
        confusion_labels=labels if train_cfg.epoch_confusion else None,
    )

    test_metrics: dict = {}
    test_stream = make_stream("test", loop=False) if confusion else None
    if test_stream is not None:
        predict = make_predict_fn(multi_label=train_cfg.multi_label)
        y_true_all, y_pred_all = [], []
        for xs, y in batches(test_stream):
            inputs, yy = pre_eval(xs, y)
            y_pred_all.append(_host(predict(result.state, inputs)))
            y_true_all.append(_host(yy))
        if y_true_all:
            test_metrics = _save_test_confusion(
                run_dir, labels, np.concatenate(y_true_all),
                np.concatenate(y_pred_all), train_cfg.multi_label)

    write_metadata(result.history, test_metrics)
    return TrainRunResult(run_dir=run_dir, labels=labels,
                          history=result.history, test_metrics=test_metrics)


def train_run(
    data_dirs: list[str | Path],
    run_name: str,
    checkpoint_root: str | Path = "./checkpoints",
    train_cfg: TrainConfig | None = None,
    featurizer: FeaturizerConfig | None = None,
    epochs: int | None = None,
    steps_per_epoch: int | None = None,
    ontology: Ontology | None = None,
    confusion: bool = True,
    only_features: bool = False,
    morepork_model: bool = False,
    weights: str | Path | None = None,
    weight_labels: list[str] | None = None,
    split_shards: dict[str, list[Path]] | None = None,
    backbone_weights: str | Path | None = None,
    backbone_imagenet_stats: bool = True,
    device: str | torch.device | None = None,
    mesh_devices: list | None = None,
) -> TrainRunResult:
    """The full training pipeline on real shard data, on ``device`` (the
    CUDA card unless the caller names another).

    ``split_shards`` maps split name -> explicit shard-file list, overriding
    the train/validation/test subdirectory discovery — used by the k-fold CV
    path, which partitions the pooled shard files itself
    (audiomodel.py:227-233).  ``weights`` is a port weights file (``.pt``);
    ``backbone_weights`` a local keras.applications weight file whose
    weights the mel families' backbone starts from (JAX
    ``harness.py:725-770``: the model is rebuilt with the file's
    ``backbone_args``, created, transplanted, then ``weights`` restored;
    ``backbone_imagenet_stats`` as ``models/transplant.load_keras_backbone``
    takes it).  The JAX function's ``keep_excluded`` (unused there) is left
    out.

    The run kind follows the model's inputs, as in the JAX function:
    ``("mel", "mel2")`` (dual-badwinner2) takes the two-view preprocess,
    ``merge`` :func:`_train_merge_run`, the vector models
    :func:`_train_vector_run`.  ``rf-features``, which JAX's ``cli/train``
    sends to :func:`train_random_forest`, goes there from here too.

    ``train_cfg.num_data_shards > 1`` runs on that many ranks of the
    process group (``parallel.initialize_distributed``; ``cli/train
    --data-shards N`` starts them), each calling this function with its
    ``device`` (``"cpu"`` for CPU ranks, else rank r's card; or
    ``mesh_devices``, one device a rank, as ``parallel.make_mesh`` takes
    them, e.g. one card named twice for a rehearsal): the mesh is built
    before the dispatch, the train and validation batches are each
    rank's rows of the global batches (``batch_size``) with their tails
    dropped, as JAX shards them, the BatchNorm re-estimation and test
    passes keep their tails, as JAX's unsharded ones do
    (:func:`_eval_rows`), the state is broadcast from rank 0, and only rank
    0 writes the run directory.  Every rank returns the same result.  The
    vector-input runs and ``rf-features`` train on one device
    (:func:`trains_on_one_device`): rank 0 trains, the others wait.
    """
    train_cfg = train_cfg or TrainConfig()
    if train_cfg.model_name.lower() == "rf-features":
        return on_rank_zero(lambda: train_random_forest(
            data_dirs, run_name, checkpoint_root, train_cfg=train_cfg,
            ontology=ontology))
    device = torch.device(device or "cuda")
    cfg = featurizer or FeaturizerConfig()
    data_dirs = [Path(d) for d in data_dirs]
    run_dir = Path(checkpoint_root) / run_name
    primary = is_primary()  # rank 0 of a process group writes, and only it
    if primary:
        run_dir.mkdir(parents=True, exist_ok=True)

    space, ontology, data_meta = init_labels(
        data_dirs, ontology,
        use_generic_bird=train_cfg.use_generic_bird,
        only_features=only_features, morepork_model=morepork_model,
    )
    labels = list(space.labels)
    log.info("Training %s on %s labels: %s", run_name, len(labels), labels)

    # the mesh, before the dispatch (JAX harness.py:537-544), for the run
    # kinds that use it: CPU ranks name the CPU, card ranks take rank r's
    # card, unless the caller names the devices
    vector = train_cfg.model_name.lower() in _VECTOR_MODELS
    mesh = None
    if train_cfg.num_data_shards > 1 and not vector:
        if mesh_devices is None and device.type == "cpu":
            mesh_devices = [device] * train_cfg.num_data_shards
        mesh = make_mesh(num_data=train_cfg.num_data_shards,
                         devices=mesh_devices)
        device = mesh.device

    # the model: weights drawn from the run's seed (on the CPU, so they do
    # not depend on the device); its inputs pick the run kind
    channels = cfg.channels
    dtype = (torch.bfloat16 if train_cfg.compute_dtype == "bfloat16"
             else None)
    spec = build_model(
        train_cfg.model_name, num_labels=len(labels),
        multi_label=train_cfg.multi_label, logits_only=True, dtype=dtype,
        n_mels=cfg.n_mels, mel_frames=cfg.mel_frames,
        **({} if vector else {"in_channels": channels}),
    )
    run_args = (run_dir, data_dirs, split_shards, space, ontology, labels,
                train_cfg, cfg, spec, epochs, steps_per_epoch, data_meta)
    restore = dict(weights=weights, weight_labels=weight_labels,
                   device=device)
    if vector:
        # one device whatever num_data_shards says, as in JAX
        # (harness.py:553-570): under a process group rank 0 trains and
        # writes, and the others wait for its result
        return on_rank_zero(lambda: _train_vector_run(*run_args, **restore))
    if spec.inputs == ("mel", "short_f", "mid_f"):
        return _train_merge_run(*run_args, confusion=confusion, **restore)
    dual = spec.inputs == ("mel", "mel2")

    pre_train = make_preprocess_fn(
        cfg, augment=True, mixup_alpha=train_cfg.mixup_alpha,
        mixup_chance=train_cfg.mixup_chance, channels=channels, dual=dual,
        device=device,
    )
    pre_eval = make_preprocess_fn(cfg, augment=False, channels=channels,
                                  dual=dual, device=device)

    # the geo-aware weighted_bce needs per-sample GPS in every batch
    # (tfdataset.py:1188-1212)
    with_latlng = train_cfg.loss == "weighted_bce"

    # small train splits are cached in RAM after the first decode pass and
    # the stream is kept alive across epochs (re-decoding gzip shards every
    # epoch starves the device).  Big splits stream from disk each epoch
    # with per-epoch shard reshuffling.
    counts_for_cache = load_meta(data_dirs[0]).get("counts", {}).get(
        "train", {}
    ).get("sample_counts", {}) if data_dirs else {}
    est_bytes = (
        sum(counts_for_cache.values()) * cfg.samples_per_clip * 4 * 2
    )
    cache_train = bool(est_bytes) and est_bytes < 2 * 1024**3

    train_shard_groups = (
        [split_shards["train"]] if split_shards is not None else None
    )
    stream_filters = dict(
        exclude_low_samples=train_cfg.no_low_samples,
        drop_bird_only=train_cfg.multi_label and not train_cfg.use_bird_tags,
        filter_freq=train_cfg.filter_freq,
        random_butter=train_cfg.random_butter,
    )
    persistent_train = None
    if cache_train:
        persistent_train = iter(build_training_stream(
            data_dirs, "train", space, cfg.samples_per_clip,
            batch_size=train_cfg.batch_size, seed=train_cfg.seed,
            augment=True, device=device, with_latlng=with_latlng,
            shard_groups=train_shard_groups, cache=True, mesh=mesh,
            **stream_filters,
        ))

    def train_batches(epoch):
        if persistent_train is not None:
            # explicit next() (NOT yield from): closing this generator at the
            # steps_per_epoch bound must not close the persistent stream
            while True:
                try:
                    yield next(persistent_train)
                except StopIteration:
                    return
        loader = build_training_stream(
            data_dirs, "train", space, cfg.samples_per_clip,
            batch_size=train_cfg.batch_size, seed=train_cfg.seed + epoch,
            augment=True, device=device, with_latlng=with_latlng,
            shard_groups=train_shard_groups,
            workers=train_cfg.loader_workers, mesh=mesh,
            **stream_filters,
        )
        yield from loader

    # the validation streams are built ONCE so their RAM cache (non-train
    # splits cache decoded samples) survives across epochs
    if split_shards is not None:
        val_shard_groups = (
            [split_shards["validation"]] if split_shards.get("validation")
            else []
        )
    else:
        val_shard_groups = [
            s for s in (find_shards(d, "validation") for d in data_dirs) if s
        ]
    val_streams = [
        RecordStream(v_shards, space, cfg.samples_per_clip,
                     seed=train_cfg.seed + i * 97, loop=False, cache=True,
                     with_latlng=with_latlng,
                     **stream_filters)
        for i, v_shards in enumerate(val_shard_groups)
    ]

    def val_batches():
        if not val_streams:
            return
        if len(val_streams) == 1:
            stream = iter(val_streams[0])
        else:
            stream = interleave([iter(s) for s in val_streams], None,
                                seed=train_cfg.seed)
        yield from BatchLoader(
            stream, batch_size=train_cfg.batch_size,
            num_labels=space.num_labels,
            samples_per_clip=cfg.samples_per_clip, device=device, mesh=mesh,
        )

    # remapped per-output-label distribution: fold source-tag counts through
    # the remap + generic-bird extra tables so outputs fed only via remapping
    # (e.g. "bird") get their true counts (the pre-remap counts would give
    # them 0 -> weight 0 -> zero gradient)
    counts = _train_counts(data_meta)
    dist = np.zeros(len(labels), np.float64)
    for i, src_label in enumerate(space.source_labels):
        c = counts.get(src_label, 0)
        if not c:
            continue
        tgt = int(space.remap[i])
        if tgt >= 0:
            dist[tgt] += c
        extra = int(space.extra[i])
        if extra >= 0:
            dist[extra] += c

    # epoch size for steps_per_epoch
    if steps_per_epoch is None:
        if split_shards is not None:
            # fold-specific file subset: the metadata counts cover the whole
            # dataset, so count the fold's usable samples directly
            total = RecordStream(
                split_shards["train"], space, cfg.samples_per_clip
            ).count()
        else:
            total = int(sum(counts.values()))
        if not total:
            # no counts in the metadata: count usable samples directly
            # (one decode-light pass) so the looping train stream is bounded
            total = sum(
                RecordStream(find_shards(d, "train"), space,
                             cfg.samples_per_clip).count()
                for d in data_dirs
            )
        steps_per_epoch = max(total // train_cfg.batch_size, 1)

    # class weights (audiomodel.py:524-526)
    class_weights = None
    if train_cfg.use_weighting:
        w = get_weighting(dist, labels, cap_max=train_cfg.weight_max,
                          cap_min=train_cfg.weight_min)
        class_weights = torch.as_tensor(weights_to_array(w, len(labels)),
                                        device=device)

    # weighted_bce derives its negative-mask from the generic-bird structure
    bird_index = labels.index("bird") if "bird" in labels else None
    specific_bird_mask = None
    geo_masks = None
    if train_cfg.loss == "weighted_bce" and bird_index is not None:
        specific_bird_mask = np.array(
            [1.0 if (l in ontology.all_birds and l != "bird") else 0.0
             for l in labels],
            np.float32,
        )
        geo_masks = build_geo_masks(labels, ontology.all_birds)

    keras_backbone = None
    if backbone_weights is not None:
        # pretrained-backbone import from a LOCAL keras weight file
        # (audiomodel.get_base_model weights="imagenet",
        # audiomodel.py:972-1141; TensorFlow builds the source graph)
        from audio_training_tpu_torch.models.transplant import (
            load_keras_backbone,
        )

        keras_backbone, backbone_args = load_keras_backbone(
            train_cfg.model_name, backbone_weights,
            input_shape=(cfg.n_mels, cfg.mel_frames, channels),
            imagenet_stats=backbone_imagenet_stats,
        )
        if backbone_args:
            spec = build_model(
                train_cfg.model_name, num_labels=len(labels),
                multi_label=train_cfg.multi_label, logits_only=True,
                dtype=dtype, n_mels=cfg.n_mels, mel_frames=cfg.mel_frames,
                in_channels=channels, backbone_args=backbone_args,
            )
    state = create_train_state(
        spec.module, learning_rate=train_cfg.learning_rate,
        seed=train_cfg.seed, device=device,
    )
    if keras_backbone is not None:
        from audio_training_tpu_torch.models.transplant import (
            transplant_backbone_into_classifier,
        )

        transplant_backbone_into_classifier(state.model, keras_backbone)
        log.info("Imported backbone weights from %s", backbone_weights)
    state = _maybe_restore(state, weights, weight_labels, labels)
    if mesh is not None:
        replicated(mesh)(state.model)
    log.info("Model %s has %s params", train_cfg.model_name,
             param_count(state))

    def write_metadata(history=None, test_results=None):
        if not primary:
            return
        save_metadata(
            run_dir, train_cfg.model_name, labels, cfg, ontology,
            loss_fn=train_cfg.loss, multi_label=train_cfg.multi_label,
            use_generic_bird=train_cfg.use_generic_bird,
            mean_sub=cfg.mean_sub,
            history=history, test_results=test_results,
            training_data_meta=_kept_meta(data_meta),
            extra={
                "remapped_labels": {
                    l: int(space.remap[i])
                    for i, l in enumerate(space.source_labels)
                },
            },
        )

    write_metadata()

    hist_path = run_dir / "weight-hists.jsonl"

    def hist_writer(epoch, logs, st, tb=None):
        # per-epoch weight-histogram artifacts for the trainable frontend
        # weights the reference streams to TensorBoard (MagTransform/PCEN
        # a-power, audiomodel.log_hist_weights, audiomodel.py:2583-2592):
        # scalar frontends record their values, larger weights a real
        # (counts, bin-edges) histogram.  Appended per epoch — watchable
        # mid-run, like run_dir/training-log.csv — and streamed into the
        # fit loop's TensorBoard event file too.
        entries = {}
        for name, param in st.model.named_parameters():
            if not any(k in name for k in ("a_power", "gain", "bias", "root",
                                           "smooth")):
                continue
            arr = param.detach().float().cpu().numpy().ravel()
            if arr.size <= 8:
                entries[name] = [float(v) for v in arr]
            else:
                counts_, edges = np.histogram(arr, bins=16)
                entries[name] = {
                    "counts": counts_.tolist(),
                    "edges": [float(e) for e in edges],
                    "mean": float(arr.mean()),
                    "std": float(arr.std()),
                }
        with hist_path.open("a") as f:
            f.write(json.dumps({"epoch": epoch, **entries}) + "\n")
        if tb is not None:
            for name, entry in entries.items():
                if isinstance(entry, dict):
                    tb.add_histogram_counts(
                        f"weights/{name}", entry["counts"], entry["edges"],
                        epoch,
                    )
                elif len(entry) == 1:
                    tb.add_scalar(f"weights/{name}", entry[0], epoch)
                else:
                    tb.add_histogram_values(f"weights/{name}", entry, epoch)

    result = fit(
        state,
        train_batches,
        pre_train,
        hist_writer=hist_writer,
        epochs=epochs or train_cfg.epochs,
        steps_per_epoch=steps_per_epoch,
        val_batches=val_batches,
        val_preprocess=pre_eval,
        loss_name=train_cfg.loss,
        multi_label=train_cfg.multi_label,
        label_smoothing=train_cfg.label_smoothing,
        class_weights=class_weights,
        run_dir=run_dir,
        early_stop_patience=train_cfg.early_stop_patience,
        reduce_lr_patience=train_cfg.reduce_lr_patience,
        reduce_lr_factor=train_cfg.reduce_lr_factor,
        seed=train_cfg.seed,
        remat=train_cfg.remat,
        bird_index=bird_index,
        specific_bird_mask=specific_bird_mask,
        geo_masks=geo_masks,
        confusion_labels=labels if train_cfg.epoch_confusion else None,
        mesh=mesh,
    )

    if persistent_train is not None:
        persistent_train.close()  # ends its prefetch thread
    if train_cfg.bn_reestimate:
        # exact one-pass BN running-stat re-estimation over eval-preprocessed
        # train batches (train/step.reestimate_batch_stats): short schedules
        # leave the momentum-0.99 EMA badly stale, collapsing eval-mode
        # quality while train-mode metrics look fine.  The refreshed final
        # state is re-saved as run_dir/chkpt.pt (per-metric best checkpoints
        # keep their own weights + stats pairs).
        def bn_batches():
            shards = []
            for d in data_dirs:
                shards.extend(find_shards(d, "train"))
            stream = iter(RecordStream(
                shards, space, cfg.samples_per_clip, seed=train_cfg.seed,
                loop=False,
            ))
            for batch in BatchLoader(
                stream, batch_size=train_cfg.batch_size,
                num_labels=space.num_labels,
                samples_per_clip=cfg.samples_per_clip, device=device,
            ):
                part, within, _ = _eval_rows(mesh, *batch[:2])
                # the model runs on the batch while the generator waits
                # here, still inside its mesh
                with within:
                    mel, _ = pre_eval(*part)
                    yield mel

        new_stats = reestimate_batch_stats(result.state.model, bn_batches())
        result.state.model.load_state_dict(new_stats, strict=False)
        if primary:
            save_state(run_dir / f"chkpt{SUFFIX}", result.state)
        log.info("BN running stats re-estimated over the train split")

    test_metrics: dict = {}
    if confusion:
        test_metrics = run_test_confusion(
            result.state, spec, pre_eval, data_dirs, space, cfg, train_cfg,
            run_dir,
            test_shards=(
                split_shards.get("test") if split_shards is not None else None
            ),
            device=device, mesh=mesh,
        )

    write_metadata(result.history, test_metrics)
    return TrainRunResult(run_dir=run_dir, labels=labels,
                          history=result.history, test_metrics=test_metrics)


def test_set_metrics(y_true: np.ndarray, y_pred: np.ndarray,
                     labels: list[str], threshold: float = 0.5) -> dict:
    """Confusion-derived test metrics (audiomodel.py:569-595, and the
    per-label tp/fp tables of cross_fold_train, audiomodel.py:320-383).

    Element-wise (pred>.5)==(true>.5) accuracy over the whole multi-label
    matrix is dominated by true negatives (~98 % for 62 labels), so instead:
    micro precision/recall/F1 over positive instances, plus the reference's
    ``%Correct`` (hit positives / total positives — its cross-fold metric).
    """
    pred_pos = y_pred > threshold
    true_pos = y_true > threshold
    tp = int((pred_pos & true_pos).sum())
    fp = int((pred_pos & ~true_pos).sum())
    fn = int((~pred_pos & true_pos).sum())
    positives = tp + fn
    precision = tp / (tp + fp) if (tp + fp) else 0.0
    recall = tp / positives if positives else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) else 0.0)
    per_label = {}
    for i, l in enumerate(labels):
        pos = true_pos[:, i]
        if not pos.any():
            continue
        ltp = int((pred_pos[:, i] & pos).sum())
        lfp = int((pred_pos[:, i] & ~pos).sum())
        per_label[l] = {
            "support": int(pos.sum()),
            "recall": ltp / int(pos.sum()),
            "precision": ltp / (ltp + lfp) if (ltp + lfp) else 0.0,
        }
    return {
        "test_precision": precision,
        "test_recall": recall,
        "test_f1": f1,
        # reference %Correct (audiomodel.py:383): hit positives over positives
        "test_acc": recall,
        "test_samples": int(len(y_true)),
        "per_label": per_label,
    }


def _eval_rows(mesh, *arrays):
    """How a rank runs a batch of an evaluation pass (BatchNorm
    re-estimation, the test confusion), which JAX runs unsharded with its
    tail: ``(arrays, context, sharded)``.  Under a data-parallel ``mesh``
    that divides the batch, this rank's rows and the mesh, so that the
    PCEN min-max and the BatchNorm moments are the whole batch's; else (no
    mesh, or a tail that the data axis does not divide) the whole batch and
    no context, each rank computing it alone."""
    if mesh is None or len(arrays[0]) % mesh.data_size:
        return arrays, contextlib.nullcontext(), False
    rows = batch_sharding(mesh).rows(len(arrays[0]))
    return tuple(a[rows] for a in arrays), mesh, True


def run_test_confusion(state, spec, pre_eval, data_dirs, space, cfg,
                       train_cfg, run_dir, test_shards=None,
                       device="cuda", mesh=None) -> dict:
    """Held-out test confusion (audiomodel.py:566-595); ``spec`` is unused,
    as in the JAX function.  Under a data-parallel ``mesh`` the test
    batches and their tail are the single-device run's, run as
    :func:`_eval_rows` says; the predictions are gathered, and rank 0
    writes the confusion."""
    predict = make_predict_fn(multi_label=train_cfg.multi_label)
    y_true_all, y_pred_all = [], []
    try:
        loader = build_training_stream(
            data_dirs, "test", space, cfg.samples_per_clip,
            batch_size=train_cfg.batch_size, augment=False, device=device,
            shard_groups=[test_shards] if test_shards is not None else None,
        )
        for batch in loader:
            part, within, sharded = _eval_rows(mesh, *batch[:2])
            with within:
                mel, yy = pre_eval(*part)
                probs = predict(state, mel)
            if sharded:
                probs, yy = gather_rows(mesh, probs), gather_rows(mesh, yy)
            y_pred_all.append(_host(probs))
            y_true_all.append(_host(yy))
    except (ValueError, FileNotFoundError):
        log.info("No test split found")
        return {}
    if not y_true_all:
        return {}
    y_true, y_pred = np.concatenate(y_true_all), np.concatenate(y_pred_all)
    if mesh is not None and mesh.rank != 0:
        return test_set_metrics(y_true, y_pred, list(space.labels))
    return _save_test_confusion(run_dir, list(space.labels), y_true, y_pred,
                                train_cfg.multi_label)


def _save_test_confusion(run_dir: Path, labels: list[str],
                         y_true: np.ndarray, y_pred: np.ndarray,
                         multi_label: bool) -> dict:
    """The test split's raw predictions and confusion(s) in ``run_dir``;
    returns :func:`test_set_metrics`."""
    save_raw_predictions(run_dir / "confusion", labels, y_pred, y_true)
    if multi_label:
        cm, none_cm, out_labels = multi_label_confusion(y_true, y_pred,
                                                        labels)
        save_confusion(cm, out_labels, run_dir / "confusion")
        save_confusion(none_cm, out_labels, run_dir / "confusion-none")
    else:
        cm, out_labels = single_label_confusion(y_true, y_pred, labels)
        save_confusion(cm, out_labels, run_dir / "confusion")
    return test_set_metrics(y_true, y_pred, labels)


def kfold_indices(n: int, folds: int, rng: np.random.Generator):
    """sklearn KFold(n_splits, shuffle=True) equivalent: a shuffled
    permutation split into ``folds`` contiguous validation chunks; yields
    (train_idx, val_idx) pairs."""
    perm = rng.permutation(n)
    chunks = np.array_split(perm, folds)
    for k in range(folds):
        val = chunks[k]
        train = np.concatenate([chunks[j] for j in range(folds) if j != k])
        yield train, val


def cross_fold_train(
    data_dirs, run_name, folds: int = 5, test_percent: float = 0.2, **kwargs
) -> list[TrainRunResult]:
    """K-fold cross validation (audiomodel.cross_fold_train,
    audiomodel.py:181-401): pool ALL shard files (train+validation+test),
    shuffle, hold out ``test_percent`` of the files as a fixed test set, then
    KFold the remainder — each fold trains on its train files and validates
    on its held-out fold files.  Folds are file-disjoint by construction; the
    per-fold file assignment is written to ``fold-files.json`` in each run
    dir."""
    cfg = kwargs.pop("train_cfg", None) or TrainConfig()
    data_dirs = [Path(d) for d in data_dirs]
    files: list[Path] = []
    for d in data_dirs:
        for split in ("train", "validation", "test"):
            files.extend(find_shards(d, split))
    if len(files) < folds + 1:
        raise ValueError(
            f"need more than {folds} shard files for {folds}-fold CV, "
            f"have {len(files)}"
        )
    rng = np.random.default_rng(cfg.seed)
    files = [files[i] for i in rng.permutation(len(files))]
    n_test = max(int(test_percent * len(files)), 1)
    test_files = files[:n_test]  # audiomodel.py:208-212
    pool = files[n_test:]

    results = []
    for fold, (train_idx, val_idx) in enumerate(
        kfold_indices(len(pool), folds, rng)
    ):
        split_shards = {
            "train": [pool[i] for i in train_idx],
            "validation": [pool[i] for i in val_idx],
            "test": list(test_files),
        }
        fold_cfg = dataclasses.replace(cfg, seed=cfg.seed + fold * 1000)
        result = train_run(
            data_dirs, f"{run_name}-fold{fold}", train_cfg=fold_cfg,
            split_shards=split_shards, **kwargs,
        )
        if is_primary():
            (result.run_dir / "fold-files.json").write_text(json.dumps(
                {k: [str(p) for p in v] for k, v in split_shards.items()},
                indent=2,
            ))
        results.append(result)
    return results


def train_random_forest(
    data_dirs: list[str | Path],
    run_name: str,
    checkpoint_root: str | Path = "./checkpoints",
    train_cfg: TrainConfig | None = None,
    ontology: Ontology | None = None,
    **rf_kwargs,
) -> TrainRunResult:
    """``rf-features`` (JAX ``harness.py:1084-1151``): a random forest on
    the flattened short + mid hand-crafted features (audiomodel.py:766-769
    builds a ydf RandomForestLearner; tf_to_ydf flattens the dataset,
    audiomodel.py:2790-2803), fitted on the host by scikit-learn
    (:func:`build_random_forest`; ``backend=`` in ``rf_kwargs`` as in JAX,
    where ``"sklearn"`` is the one the port offers).  The model pickles into
    the run dir with its accuracies in the metadata."""
    train_cfg = train_cfg or TrainConfig(model_name="rf-features")
    run_dir = Path(checkpoint_root) / run_name
    run_dir.mkdir(parents=True, exist_ok=True)
    data_dirs = [Path(d) for d in data_dirs]
    space, ontology, data_meta = init_labels(
        data_dirs, ontology, use_generic_bird=train_cfg.use_generic_bird,
    )
    labels = list(space.labels)

    def xy(split):
        xs, ys = [], []
        for short, mid, y in FeatureStream(
                _split_shards(data_dirs, None, split), space):
            xs.append(np.concatenate([short.ravel(), mid.ravel()]))
            ys.append(y)
        if not xs:
            return None, None
        return np.stack(xs), np.stack(ys)

    x_train, y_train = xy("train")
    if x_train is None:
        raise ValueError(
            "no feature records in the train split — rebuild with "
            "--add-features"
        )
    rf = build_random_forest(random_state=train_cfg.seed, **rf_kwargs)
    rf.fit(x_train, y_train)
    history: dict = {"train_accuracy": [float(rf.score(x_train, y_train))]}
    x_val, y_val = xy("validation")
    if x_val is not None:
        history["val_accuracy"] = [float(rf.score(x_val, y_val))]
    with (run_dir / "random_forest.pkl").open("wb") as f:
        pickle.dump({"model": rf, "labels": labels}, f)
    save_metadata(
        run_dir, "rf-features", labels, FeaturizerConfig(), ontology,
        multi_label=train_cfg.multi_label,
        training_data_meta=_kept_meta(data_meta),
        extra={"rf_history": history, "rf_backend": type(rf).__name__},
    )
    log.info("random forest trained: %s", history)
    return TrainRunResult(run_dir=run_dir, labels=labels, history=history)
