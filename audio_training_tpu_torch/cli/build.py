"""Dataset-build CLI — ``python -m audio_training_tpu_torch.cli.build <out>
-d <dir>`` (port of ``audio_training_tpu/cli/build.py``; reference:
``python build.py -d <raw_dir> <out_dir>``, build.py:679-814).

Pipeline: load sidecar-metadata corpus -> per-label bin-aware split ->
optional balancing -> leakage asserts -> GZIP TFRecord shards +
training-meta.json.  Host code throughout, as in the JAX package.  Every
flag of the JAX CLI is known; ``--embedding-model`` (a local Perch saved
model) needs TensorFlow where the build runs, as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from audio_training_tpu_torch.config import FeaturizerConfig, SamplingConfig
from audio_training_tpu_torch.corpus import (
    AudioDataset,
    create_tf_records,
    oversample_ds,
    split_by_file,
    split_randomly,
    undersample_ds,
    validate_datasets,
    write_training_meta,
)
from audio_training_tpu_torch.utils import init_logging


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("out_dir", help="Output directory for training-data")
    parser.add_argument("-d", "--dir", required=True, help="Raw corpus dir")
    parser.add_argument("--no-test", action="count", help="No test set")
    parser.add_argument("--split-file", default=None,
                        help="Pinned rec-id split JSON")
    parser.add_argument("--balance", action="count",
                        help="Under+oversample training split")
    parser.add_argument("-m", "--mels", default=160, type=int)
    parser.add_argument("-b", "--break-freq", default=1000, type=float)
    parser.add_argument("--sr", default=48000, type=int,
                        help="Target sample rate; recordings are resampled "
                             "(tfdataset.py:44 SR=48000)")
    parser.add_argument("--n-fft", default=4096, type=int)
    parser.add_argument("--hop-length", default=281, type=int)
    parser.add_argument("--fmin", default=100, type=float)
    parser.add_argument("--fmax", default=11000, type=float)
    parser.add_argument("--seg-length", default=3, type=float)
    parser.add_argument("--stride", default=1, type=float)
    parser.add_argument("--dont-tighten-tracks", action="count")
    parser.add_argument("--dont-filter-rms", action="count")
    parser.add_argument("--store-spectrogram", action="count",
                        help="Also store the magnitude STFT per record "
                             "(byte parity with the reference; ~8x bigger)")
    parser.add_argument("--workers", default=4, type=int)
    parser.add_argument("--add-features", action="count",
                        help="Store hand-crafted short/mid features per "
                             "sample (audiowriter add_features parity)")
    parser.add_argument("--plot-signal", action="count",
                        help="Per-label signal-percent histograms "
                             "(otherdata.plot_signal, otherdata.py:963-984)")
    parser.add_argument("--add-buttered", action="count",
                        help="Store a Butterworth band-passed variant per "
                             "sample with track freq bounds (feeds train "
                             "--filter-freq; audiodataset.py:1301 intent)")
    parser.add_argument("--embedding-model", default=None,
                        help="Local Perch saved-model path: store a "
                             "per-sample embedding in each record "
                             "(audiowriter DO_EMBEDDING parity)")
    parser.add_argument("--shards-per-worker", default=4, type=int)
    parser.add_argument("--signal", action="count",
                        help="Treat <dir> as a pre-split signal-WAV tree "
                             "({train,validation,test}/<label>-<n>.wav) and "
                             "build records from it "
                             "(build.dataset_from_signal)")
    parser.add_argument("--create-signal-wavs", default=None,
                        help="Instead of building records, export per-tag "
                             "signal-region audio chunks to this directory "
                             "(build.create_signal_data)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    init_logging()
    args = parse_args(argv)
    sampling = SamplingConfig(
        tighten_tracks=not args.dont_tighten_tracks,
        filter_rms=not args.dont_filter_rms,
    )
    featurizer = FeaturizerConfig(
        sr=args.sr, n_fft=args.n_fft,
        n_mels=args.mels, break_freq=args.break_freq,
        hop_length=args.hop_length, fmin=args.fmin, fmax=args.fmax,
        segment_length=args.seg_length, segment_stride=args.stride,
    )

    if args.signal:
        from audio_training_tpu_torch.corpus.signal_data import (
            build_signal_dataset,
        )

        # signal WAVs carry no RMS metadata and are already distilled to
        # vocalization audio — tightening/RMS-filtering would drop them all
        signal_sampling = SamplingConfig(tighten_tracks=False,
                                         filter_rms=False)
        out = build_signal_dataset(
            args.dir, args.out_dir, sampling=signal_sampling,
            featurizer=featurizer, num_workers=args.workers,
            shards_per_worker=args.shards_per_worker,
        )
        logging.info("Signal dataset build complete: %s", out)
        return 0

    dataset = AudioDataset("all", sampling,
                           segment_length=args.seg_length,
                           segment_stride=args.stride)
    dataset.load_meta(args.dir)
    logging.info("Loaded %s recordings, %s samples, labels %s",
                 len(dataset.recs), len(dataset.samples),
                 sorted(dataset.labels))

    if args.plot_signal:
        # plot-only invocation: the reference returns right after plotting
        # (build.py:699-704)
        from audio_training_tpu_torch.eval.plots import plot_signal_percent

        written = plot_signal_percent(dataset, Path(args.dir))
        logging.info("Wrote %s signal-percent plots", len(written))
        return 0

    if args.create_signal_wavs:
        from audio_training_tpu_torch.corpus.signal_data import (
            export_signal_data,
        )

        n = export_signal_data(dataset, args.create_signal_wavs,
                               sr=args.sr)
        logging.info("Wrote %s signal-audio chunks to %s", n,
                     args.create_signal_wavs)
        return 0

    if args.split_file:
        split = json.loads(Path(args.split_file).read_text())
        datasets = split_by_file(dataset, split)
    else:
        datasets = split_randomly(dataset, no_test=bool(args.no_test))

    if args.balance:
        undersample_ds(datasets[0])
        oversample_ds(dataset, datasets[0])

    validate_datasets(datasets)

    out = Path(args.out_dir) / "training-data"
    for ds in datasets:
        n = create_tf_records(
            ds, out / ds.name, num_workers=args.workers,
            shards_per_worker=args.shards_per_worker, cfg=featurizer,
            store_spectrogram=bool(args.store_spectrogram),
            embedding_model=args.embedding_model,
            add_features=bool(args.add_features),
            add_buttered=bool(args.add_buttered),
        )
        logging.info("Wrote %s: %s records", ds.name, n)
    write_training_meta(out, datasets, featurizer)
    logging.info("Dataset build complete: %s", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
