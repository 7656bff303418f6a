"""Deployment packaging (a port of ``audio_training_tpu/infer/freeze.py``;
reference: freezemodel.py).

Bundles a trained run into a deployment directory: the run's weights file
(``<checkpoint>.pt``, else ``chkpt.pt``) copied to ``audioModel.pt``, which
``cli/predict.load_predictor`` finds, and the metadata.txt rewritten with
API display names (via an optional ``label_paths.json``), per-label
``ebird_ids`` lists including the hard-coded kiwi sub-species
(freezemodel.format_metadata, freezemodel.py:27-100) and ``frozen: true``.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path

from audio_training_tpu_torch.taxonomy.ebird import get_ebird_ids_to_labels
from audio_training_tpu_torch.train.checkpoints import SUFFIX

log = logging.getLogger(__name__)

# kiwi sub-species folded in at the dataset stage; recorded explicitly so the
# API can mask/expand kiwi predictions (freezemodel.py:75-87)
EXTRA_KIWIS = sorted(
    [
        "grskiw1", "sobkiw2", "sobkiw1", "okiwoo1", "okbkiw1",
        "kiwi1", "nibkiw1", "liskiw1", "sobkiw3",
    ]
)


def format_metadata(metadata: dict, label_paths: dict | None = None) -> dict:
    """Rewrite metadata for the prediction API (freezemodel.py:27-100):
    ``labels`` become display names, ``ebird_ids[i]`` lists every eBird id
    folded into output i."""
    ebird_labels = metadata.get("ebird_labels", metadata.get("labels", []))
    ebird_map = dict(get_ebird_ids_to_labels())
    # "weta" is a helper row in classes.csv, not a real eBird id
    ebird_map.pop("weta", None)

    hyphenated = {}
    if label_paths:
        for lbl in label_paths.keys():
            hyphenated[lbl.replace(" ", "-")] = lbl

    text_labels = []
    for ebird_id in ebird_labels:
        candidates = ebird_map.get(ebird_id, [ebird_id])
        match = None
        for text_label in candidates:
            if text_label in hyphenated:
                match = hyphenated[text_label]
                break
        if match is None:
            match = ebird_id
        text_labels.append(match)
    metadata["labels"] = text_labels

    # every source label remapped into output i contributes its ebird id
    lbl_to_ebirds: dict[str, list[str]] = {}
    remapped = metadata.get("remapped_labels", {})
    for k, v in remapped.items():
        if v == -1 or k not in ebird_map:
            continue
        ebird_id = ebird_labels[v]
        lbl_to_ebirds.setdefault(ebird_id, []).append(k)
    lbl_to_ebirds["kiwi"] = list(EXTRA_KIWIS)

    ebird_ids = []
    for lbl in ebird_labels:
        ids = set()
        if lbl in ebird_map:
            ids.add(lbl)
        ids.update(lbl_to_ebirds.get(lbl, []))
        ebird_ids.append(sorted(ids))
    metadata["ebird_ids"] = ebird_ids
    return metadata


def freeze(
    run_dir: str | Path,
    out_dir: str | Path,
    checkpoint: str = "val-loss",
    label_paths_file: str | Path | None = None,
) -> Path:
    """Package a run directory for deployment (freezemodel.main,
    freezemodel.py:103-131)."""
    run_dir = Path(run_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    src_ckpt = run_dir / f"{checkpoint}{SUFFIX}"
    if not src_ckpt.exists():
        src_ckpt = run_dir / f"chkpt{SUFFIX}"
    dst_ckpt = out_dir / f"audioModel{SUFFIX}"
    shutil.copyfile(src_ckpt, dst_ckpt)
    log.info("Saved frozen weights %s to %s", src_ckpt.name, dst_ckpt)

    meta = json.loads((run_dir / "metadata.txt").read_text())
    label_paths = None
    if label_paths_file is not None and Path(label_paths_file).exists():
        label_paths = json.loads(Path(label_paths_file).read_text())
    meta = format_metadata(meta, label_paths)
    meta["frozen"] = True
    (out_dir / "metadata.txt").write_text(json.dumps(meta, indent=4))
    return out_dir
