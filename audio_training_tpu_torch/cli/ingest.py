"""External-corpus ingestion & metadata-enrichment CLI — the reference's
``python otherdata.py`` surface (otherdata.main/parse_args,
otherdata.py:1832-1989), with the implicit layouts made explicit flags.

Examples::

    # enrich sidecars in-place
    python -m audio_training_tpu_torch.cli.ingest -d corpus/ --signal --rms
    python -m audio_training_tpu_torch.cli.ingest -d corpus/ --tracks

    # ingest external corpora into {audio + sidecar} form
    python -m audio_training_tpu_torch.cli.ingest -d esc50/audio --csv \\
        --csv-file esc50/meta.csv --out out/ --label-col category
    python -m audio_training_tpu_torch.cli.ingest -d tier1/audio --tier1 \\
        --csv-file tier1/annotations.csv --out out/
    python -m audio_training_tpu_torch.cli.ingest -d flickr_audio/ --flickr
    python -m audio_training_tpu_torch.cli.ingest -d folders/ --folder
    python -m audio_training_tpu_torch.cli.ingest -d chime/chunks --chime \\
        --csv-file chime/chunk_annotations.csv
    python -m audio_training_tpu_torch.cli.ingest -d corpus/ --noise-dir noise/ \\
        --out mixed/

A copy of ``audio_training_tpu/cli/ingest.py`` with the port's imports.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from audio_training_tpu_torch.utils import init_logging


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dir", required=True, help="Dir to load")
    parser.add_argument("--out", default=None,
                        help="Output dir for ingestors that copy audio")
    parser.add_argument("--csv-file", default=None,
                        help="Annotations CSV for --csv/--tier1/--chime")
    parser.add_argument("--file-col", default="filename")
    parser.add_argument("--label-col", default="category")
    parser.add_argument("--workers", type=int, default=1)
    # enrichment (otherdata.py:1846-1861)
    parser.add_argument("-s", "--signal", action="store_true",
                        help="Add detected signal spans to sidecars")
    parser.add_argument("--rms", action="store_true",
                        help="Add band-RMS arrays to sidecar tracks")
    parser.add_argument("-t", "--tracks", action="store_true",
                        help="Add best_track estimates (runs --signal first)")
    parser.add_argument("--gen-tracks", action="store_true",
                        help="Generate detection-based Tracks for untracked "
                             "recordings")
    # ingestion (otherdata.py:1836-1855)
    parser.add_argument("--csv", action="store_true",
                        help="(filename,label) CSV corpus (ESC-50 style)")
    parser.add_argument("--tier1", action="store_true",
                        help="Strong-label onset/offset CSV corpus")
    parser.add_argument("--flickr", action="store_true",
                        help="Speech corpus ingested as 'human'")
    parser.add_argument("--folder", action="store_true",
                        help="Folder-per-label weak corpus")
    parser.add_argument("--chime", action="store_true",
                        help="CHiME-home chunk annotations")
    parser.add_argument("--noise-dir", default=None,
                        help="Write noise-mixed copies using this noise dir")
    parser.add_argument("--per-file", type=int, default=1,
                        help="Mixed copies per file for --noise-dir")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    init_logging()
    args = parse_args(argv)
    d = Path(args.dir)

    from audio_training_tpu_torch.corpus import otherdata
    from audio_training_tpu_torch.corpus.enrich import enrich_folder

    def need(flag: str, value):
        if value is None:
            logging.error("%s is required for this mode", flag)
            raise SystemExit(1)
        return value

    if args.csv:
        n = otherdata.csv_dataset(
            need("--csv-file", args.csv_file), d,
            need("--out", args.out),
            file_col=args.file_col, label_col=args.label_col,
        )
    elif args.tier1:
        n = otherdata.tier1_data(
            need("--csv-file", args.csv_file), d, need("--out", args.out),
        )
    elif args.flickr:
        n = otherdata.flickr_data(d)
    elif args.folder:
        n = otherdata.folder_dataset(d)
    elif args.chime:
        n = otherdata.chime_data(need("--csv-file", args.csv_file), d)
    elif args.noise_dir:
        n = otherdata.make_noise_mixed_copies(
            d, args.noise_dir, need("--out", args.out),
            per_file=args.per_file,
        )
    elif args.signal or args.rms or args.tracks or args.gen_tracks:
        n = enrich_folder(
            d, rms=args.rms, signal=args.signal or args.tracks,
            gen_tracks=args.gen_tracks, best_track=args.tracks,
            workers=args.workers,
        )
    else:
        logging.error(
            "pick a mode: --csv/--tier1/--flickr/--folder/--chime/"
            "--noise-dir or --signal/--rms/--tracks/--gen-tracks"
        )
        return 1
    logging.info("processed %s items", n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
