"""Pipeline debug CLI (parity with the reference's tfdataset.main /
testdata.py manual harnesses): stream a built dataset through the full
preprocessing graph, validate every example (NaN/Inf, range, constant
windows), report label coverage, and optionally render mel batches to PNGs.

Port of ``audio_training_tpu/cli/debug.py``.  The preprocessing runs on
``--device`` (default ``cuda``): there ``make_preprocess_fn`` featurizes each
eval batch with K1's exact tier, one ``mel_power_kernel`` launch a batch.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from audio_training_tpu_torch.utils import init_logging


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", help="training-data directory")
    parser.add_argument("--split", default="train")
    parser.add_argument("--batches", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--show", default=None,
                        help="Directory to render mel-batch PNGs into "
                             "(show_batch parity, tfdataset.py:1588-1644)")
    parser.add_argument("--mels", type=int, default=160)
    parser.add_argument("--n-fft", type=int, default=4096)
    parser.add_argument("--hop-length", type=int, default=281)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the preprocessing (cuda or cpu)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    init_logging()
    res = debug_pipeline(parse_args(argv))
    return 0 if res.ok else 1


def debug_pipeline(args):
    """Everything :func:`main` does; returns the ``PipelineCheckResult``."""
    import numpy as np

    from audio_training_tpu_torch.config import FeaturizerConfig
    from audio_training_tpu_torch.data import (
        build_training_stream,
        load_meta,
        make_preprocess_fn,
    )
    from audio_training_tpu_torch.taxonomy.labels import build_label_space
    from audio_training_tpu_torch.taxonomy.ontology import load_ontology
    from audio_training_tpu_torch.utils.debug import check_pipeline, debug_labels

    meta = load_meta(args.data_dir)
    cfg = FeaturizerConfig(n_mels=args.mels, n_fft=args.n_fft,
                           hop_length=args.hop_length)
    ont = load_ontology()
    labels = sorted(set(meta["labels"]) | {"bird"})
    space = build_label_space(ont, labels)
    debug_labels(space)

    loader = build_training_stream(
        [args.data_dir], args.split, space, cfg.samples_per_clip,
        batch_size=args.batch_size, augment=False, device=args.device,
    )
    pre = make_preprocess_fn(cfg, device=args.device)

    def batches():
        for raw, y in loader:
            mel, yy = pre(raw, y)
            yield mel.cpu().numpy(), yy.cpu().numpy()

    # mel power is non-negative and unbounded above; range check is on the
    # waveform normalization contract only when inspecting raw streams, so
    # use a wide range here and rely on NaN/constant checks
    res = check_pipeline(batches(), list(space.labels),
                         value_range=(-1e9, 1e9),
                         max_batches=args.batches)
    if args.show:
        from audio_training_tpu_torch.eval.plots import plot_mel

        out = Path(args.show)
        out.mkdir(parents=True, exist_ok=True)
        shown = 0
        for raw, y in loader:
            mel, yy = pre(raw, y)
            mel, yy = mel.cpu().numpy(), yy.cpu().numpy()
            for i in range(mel.shape[0]):
                lbls = [space.labels[j] for j in np.flatnonzero(yy[i] > 0.5)]
                plot_mel(mel[i, ..., 0], out / f"mel-{shown:03d}.png",
                         title=",".join(lbls))
                shown += 1
                if shown >= 16:
                    break
            break
        logging.info("wrote %s mel images to %s", shown, out)
    logging.info(
        "checked=%s nan=%s constant=%s -> %s",
        res.checked, res.nan_count, res.constant,
        "OK" if res.ok else "PROBLEMS FOUND",
    )
    return res


if __name__ == "__main__":
    raise SystemExit(main())
