"""End-to-end training from a built corpus (port of
``audio_training_tpu/train/harness.py:50-1081``; audiomodel.AudioModel
.train_model, audiomodel.py:405-567): label init from training-meta (+
second/extra/human dataset dirs), count-based label admission, dataset
streams, model build, class weights, fit with the callback suite, BN
re-estimation, test-set confusion, metadata.

Ported: runs of every model family with ``("mel",)`` inputs on one
device.  What needs a module that is not ported yet (the dual and merge
preprocessing, the vector-input loaders, the random forest, the backbone
transplant) raises ``NotImplementedError`` naming its ROADMAP.md item
(:func:`unported_reason`); nothing is silently dropped.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from audio_training_tpu_torch.config import FeaturizerConfig, TrainConfig
from audio_training_tpu_torch.data import (
    BatchLoader,
    RecordStream,
    build_training_stream,
    find_shards,
    get_weighting,
    load_meta,
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

_TRAINING_ITEM = 'ROADMAP.md queue 1, "Training from a built corpus"'
_FAMILIES_ITEM = 'ROADMAP.md queue 1, "Model families"'
_DATA_PARALLEL_ITEM = 'ROADMAP.md queue 1, "Data parallel"'
_EVALUATION_ITEM = ('ROADMAP.md queue 1, "Evaluation, deployment and the '
                    'rest of long-recording inference"')
# the JAX package's run kinds that train other inputs than one mel image
_VECTOR_MODELS = ("embeddings", "cnn-features")


def unported_reason(train_cfg: TrainConfig,
                    backbone_weights=None) -> str | None:
    """Why :func:`train_run` cannot take this run yet, naming the ROADMAP.md
    item that ports it; None when it can."""
    name = train_cfg.model_name.lower()
    if train_cfg.num_data_shards > 1:
        return (f"num_data_shards > 1 (data-parallel training) comes with "
                f"{_DATA_PARALLEL_ITEM}")
    if name == "rf-features":
        return f"rf-features (train_random_forest) comes with {_TRAINING_ITEM}"
    if name == "dual-badwinner2":
        return (f"dual-input training (make_preprocess_fn(dual=True)) comes "
                f"with {_TRAINING_ITEM}")
    if name == "merge":
        return (f"merge runs (make_merge_preprocess_fn) come with "
                f"{_TRAINING_ITEM}")
    if name in _VECTOR_MODELS:
        return (f"vector-input runs ({name}) read data/embeddings.py, which "
                f"loads TensorFlow saved models; it comes with "
                f"{_EVALUATION_ITEM}")
    if backbone_weights is not None:
        return (f"backbone weights (models/transplant.py) load a Keras model, "
                f"and the port does not depend on TensorFlow; they come with "
                f"{_FAMILIES_ITEM}")
    return None


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
    device: str | torch.device | None = None,
) -> TrainRunResult:
    """The full training pipeline on real shard data, on ``device`` (the
    CUDA card unless the caller names another).

    ``split_shards`` maps split name -> explicit shard-file list, overriding
    the train/validation/test subdirectory discovery — used by the k-fold CV
    path, which partitions the pooled shard files itself
    (audiomodel.py:227-233).  ``weights`` is a port weights file (``.pt``);
    ``backbone_weights`` (the backbone transplant) is not ported and
    raises.  The JAX function's ``keep_excluded`` (unused there) and
    ``backbone_imagenet_stats`` (the transplant's) are left out.
    """
    train_cfg = train_cfg or TrainConfig()
    reason = unported_reason(train_cfg, backbone_weights)
    if reason is not None:
        raise NotImplementedError(reason)
    device = torch.device(device or "cuda")
    cfg = featurizer or FeaturizerConfig()
    data_dirs = [Path(d) for d in data_dirs]
    run_dir = Path(checkpoint_root) / run_name
    run_dir.mkdir(parents=True, exist_ok=True)

    space, ontology, data_meta = init_labels(
        data_dirs, ontology,
        use_generic_bird=train_cfg.use_generic_bird,
        only_features=only_features, morepork_model=morepork_model,
    )
    labels = list(space.labels)
    log.info("Training %s on %s labels: %s", run_name, len(labels), labels)

    channels = cfg.channels
    pre_train = make_preprocess_fn(
        cfg, augment=True, mixup_alpha=train_cfg.mixup_alpha,
        mixup_chance=train_cfg.mixup_chance, channels=channels,
        device=device,
    )
    pre_eval = make_preprocess_fn(cfg, augment=False, channels=channels,
                                  device=device)

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
            shard_groups=train_shard_groups, cache=True,
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
            workers=train_cfg.loader_workers,
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
            samples_per_clip=cfg.samples_per_clip, device=device,
        )

    # remapped per-output-label distribution: fold source-tag counts through
    # the remap + generic-bird extra tables so outputs fed only via remapping
    # (e.g. "bird") get their true counts (the pre-remap counts would give
    # them 0 -> weight 0 -> zero gradient)
    counts = data_meta.get("counts", {}).get("train", {}).get(
        "sample_counts", {}
    )
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

    # model: weights drawn from the run's seed (on the CPU, so they do not
    # depend on the device)
    dtype = (torch.bfloat16 if train_cfg.compute_dtype == "bfloat16"
             else None)
    spec = build_model(
        train_cfg.model_name, num_labels=len(labels),
        multi_label=train_cfg.multi_label, logits_only=True, dtype=dtype,
        n_mels=cfg.n_mels, mel_frames=cfg.mel_frames, in_channels=channels,
    )
    state = create_train_state(
        spec.module, learning_rate=train_cfg.learning_rate,
        seed=train_cfg.seed, device=device,
    )
    state = _maybe_restore(state, weights, weight_labels, labels)
    log.info("Model %s has %s params", train_cfg.model_name,
             param_count(state))

    def write_metadata(history=None, test_results=None):
        save_metadata(
            run_dir, train_cfg.model_name, labels, cfg, ontology,
            loss_fn=train_cfg.loss, multi_label=train_cfg.multi_label,
            use_generic_bird=train_cfg.use_generic_bird,
            mean_sub=cfg.mean_sub,
            history=history, test_results=test_results,
            training_data_meta={
                k: v for k, v in data_meta.items() if k in ("counts", "type")
            },
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
                mel, _ = pre_eval(*batch[:2])
                yield mel

        new_stats = reestimate_batch_stats(result.state.model, bn_batches())
        result.state.model.load_state_dict(new_stats, strict=False)
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
            device=device,
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


def run_test_confusion(state, spec, pre_eval, data_dirs, space, cfg,
                       train_cfg, run_dir, test_shards=None,
                       device="cuda") -> dict:
    """Held-out test confusion (audiomodel.py:566-595); ``spec`` is unused,
    as in the JAX function."""
    predict = make_predict_fn(multi_label=train_cfg.multi_label)
    y_true_all, y_pred_all = [], []
    try:
        loader = build_training_stream(
            data_dirs, "test", space, cfg.samples_per_clip,
            batch_size=train_cfg.batch_size, augment=False, device=device,
            shard_groups=[test_shards] if test_shards is not None else None,
        )
        for batch in loader:
            raw, y = batch[:2]
            mel, yy = pre_eval(raw, y)
            y_pred_all.append(_host(predict(state, mel)))
            y_true_all.append(_host(yy))
    except (ValueError, FileNotFoundError):
        log.info("No test split found")
        return {}
    if not y_true_all:
        return {}
    y_true = np.concatenate(y_true_all)
    y_pred = np.concatenate(y_pred_all)
    labels = list(space.labels)
    save_raw_predictions(run_dir / "confusion", labels, y_pred, y_true)
    if train_cfg.multi_label:
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
        (result.run_dir / "fold-files.json").write_text(json.dumps(
            {k: [str(p) for p in v] for k, v in split_shards.items()},
            indent=2,
        ))
        results.append(result)
    return results
