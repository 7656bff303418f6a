"""eBird grid CLI — ``python -m audio_training_tpu_torch.cli.ebirdgrid
<observations.tsv> --kml <atlas.kml> [--out species_per_square.json]``
(a copy of ``audio_training_tpu/cli/ebirdgrid.py``; reference:
ebirdgrid.py:359-482): build species_per_square.json from the atlas KML +
eBird observations dump, or patch/query squares."""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from audio_training_tpu_torch.infer.ebirdgrid import (
    add_ebird,
    build_species_grid,
    species_at,
)
from audio_training_tpu_torch.utils import init_logging


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("csv", nargs="?", default=None,
                        help="eBird observations dump (TSV)")
    parser.add_argument("--kml", default=None,
                        help="Atlas grid squares KML")
    parser.add_argument("--regions", default=None,
                        help="ebird_species.json region metadata")
    parser.add_argument("--out", default="species_per_square.json")
    parser.add_argument("--ebird", default=None,
                        help="Manually add this species at --lat/--lng")
    parser.add_argument("--lat", type=float, default=None)
    parser.add_argument("--lng", type=float, default=None)
    parser.add_argument("--month", type=int, default=None)
    parser.add_argument("--query", action="count",
                        help="List species at --lat/--lng")
    parser.add_argument("--grid", default=None,
                        help="Existing species_per_square.json to patch/query")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    init_logging()
    args = parse_args(argv)
    if args.ebird is not None or args.query:
        meta = json.loads(Path(args.grid or args.out).read_text())
        if args.ebird is not None:
            ok = add_ebird(meta, args.lat, args.lng, args.ebird)
            if not ok:
                logging.error("No square at %s,%s", args.lat, args.lng)
                return 1
            Path(args.grid or args.out).write_text(json.dumps(meta))
            logging.info("Added %s at %s,%s", args.ebird, args.lat, args.lng)
        if args.query:
            sp = sorted(species_at(meta, args.lat, args.lng, args.month))
            for s in sp:
                print(s)
        return 0

    if args.csv is None or args.kml is None:
        logging.error("Need <csv> and --kml to build the grid")
        return 1
    region_meta = None
    if args.regions:
        region_meta = json.loads(Path(args.regions).read_text())
    meta = build_species_grid(
        args.csv, kml_path=args.kml, region_meta=region_meta,
        out_path=args.out,
    )
    logging.info("Wrote %s squares to %s", len(meta["grid_meta"]), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
