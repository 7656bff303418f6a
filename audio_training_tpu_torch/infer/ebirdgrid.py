"""eBird geo-grid metadata: build species_per_square.json and apply it as a
prediction-time species mask (a copy of
``audio_training_tpu/infer/ebirdgrid.py``; host code, numpy only).

Capability parity with the reference ``ebirdgrid.py``: the NZ atlas grid
(~10x10 km squares) is read from KML, the eBird observations dump is
streamed, per-square per-species monthly counts accumulate via a binary
search over longitude-sorted squares (ebirdgrid.py:92-136), neighbour lists
are attached, and the resulting JSON matches the README format
(README.md:10-44).

Differences: the KML is parsed with stdlib xml (no geopandas), and
:func:`apply_species_mask` makes the downstream masking — which the
reference leaves to an external prediction service — a first-class call that
zeroes probabilities of species never observed in the square (or its
neighbours) in the prediction month.
"""

from __future__ import annotations

import csv
import json
import logging
import xml.etree.ElementTree as ET
from datetime import datetime
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.taxonomy.ebird import get_label_to_ebird_map

log = logging.getLogger(__name__)

KML_NS = "{http://www.opengis.net/kml/2.2}"
# neighbour distance thresholds in degrees (ebirdgrid.set_neighbours:139-163)
NEIGHBOUR_MAX_LNG = 0.16
NEIGHBOUR_MAX_LAT = 0.11
# new-square size when an observation falls outside the atlas
# (ebirdgrid.add_new_square)
SQUARE_LNG = 0.15
SQUARE_LAT = 0.10


def read_kml_square_bounds(kml_path: str | Path) -> list[list[float]]:
    """Parse Placemark polygons into (min_lng, min_lat, max_lng, max_lat)
    bounds — geopandas-free equivalent of read_ebird_atlas_squares
    (ebirdgrid.py:28-48)."""
    tree = ET.parse(str(kml_path))
    bounds = []
    for coords in tree.iter(f"{KML_NS}coordinates"):
        pts = []
        for token in coords.text.split():
            parts = token.split(",")
            if len(parts) >= 2:
                pts.append((float(parts[0]), float(parts[1])))
        if not pts:
            continue
        lngs = [p[0] for p in pts]
        lats = [p[1] for p in pts]
        bounds.append([min(lngs), min(lats), max(lngs), max(lats)])
    return bounds


def binary_grid_search(squares: list[dict], lng: float, lat: float):
    """Find the square containing (lng, lat); squares sorted by min-lng.
    Binary search on longitude then scan both directions for the latitude
    match (ebirdgrid.py:92-136).

    Deviation from the reference: its ``high = mid - 1`` bisection can skip
    the leftmost candidate column (losing observations to synthetic
    duplicate squares); here the bisection finds the rightmost square with
    ``min_lng <= lng`` and both scans require full containment.
    """
    low, high = 0, len(squares)
    while low < high:
        mid = (low + high) // 2
        if squares[mid]["bounds"][0] <= lng:
            low = mid + 1
        else:
            high = mid
    found = low - 1
    if found < 0:
        return None
    for mid in range(found, -1, -1):
        b = squares[mid]["bounds"]
        if lng - b[0] > 4 * SQUARE_LNG:
            break  # far past any column that could still contain lng
        if b[0] <= lng <= b[2] and b[1] <= lat <= b[3]:
            return mid, squares[mid]
    for mid in range(found + 1, len(squares)):
        b = squares[mid]["bounds"]
        if b[0] > lng:
            break
        if b[0] <= lng <= b[2] and b[1] <= lat <= b[3]:
            return mid, squares[mid]
    return None


def set_neighbours(squares: list[dict]) -> None:
    """Attach ``neighbours_i`` index lists (ebirdgrid.py:139-163)."""
    centres = np.array(
        [
            [(s["bounds"][2] + s["bounds"][0]) / 2,
             (s["bounds"][1] + s["bounds"][3]) / 2]
            for s in squares
        ]
    )
    for i, square in enumerate(squares):
        d = np.abs(centres - centres[i])
        mask = (d[:, 0] < NEIGHBOUR_MAX_LNG) & (d[:, 1] < NEIGHBOUR_MAX_LAT)
        mask[i] = False
        square["neighbours_i"] = [int(j) for j in np.flatnonzero(mask)]


def _empty_months() -> dict:
    return {str(m): 0 for m in range(1, 13)}


def add_new_square(squares: list[dict], lng: float, lat: float) -> dict:
    """Insert a synthetic square for out-of-atlas observations, keeping the
    longitude sort."""
    bounds = [lng - SQUARE_LNG / 2, lat - SQUARE_LAT / 2,
              lng + SQUARE_LNG / 2, lat + SQUARE_LAT / 2]
    square = {"region_code": None, "bounds": bounds, "species_per_month": {}}
    idx = 0
    while idx < len(squares) and squares[idx]["bounds"][0] < bounds[0]:
        idx += 1
    squares.insert(idx, square)
    return square


def normalize_region_meta(region_meta) -> list[dict]:
    """Accept BOTH region-metadata formats and return the flat list form.

    Two formats exist: the reference's ebirdspecies.py output (shipped as
    ``assets/ebird_species.json``) is a dict keyed by region code with
    nested ``{"region": {"info": {"bounds": {minX..maxY}}}, "species"}``;
    ``corpus.downloaders.download_ebird_species_lists`` writes the
    flattened migration format — a list of
    ``{code, bounds: [minX, minY, maxX, maxY], species}``."""
    if isinstance(region_meta, dict):
        out = []
        for code, entry in region_meta.items():
            b = (entry.get("region", {}).get("info", {}) or {}).get("bounds")
            bounds = None
            if b:
                bounds = [b["minX"], b["minY"], b["maxX"], b["maxY"]]
            out.append({"code": code, "bounds": bounds,
                        "species": entry.get("species", [])})
        return out
    return list(region_meta)


def find_region_meta(region_meta, lng: float, lat: float):
    for region in normalize_region_meta(region_meta):
        b = region.get("bounds")
        if b and b[0] <= lng <= b[2] and b[1] <= lat <= b[3]:
            return region.get("code"), region
    return None, None


def build_species_grid(
    observations_csv: str | Path,
    kml_path: str | Path | None = None,
    square_bounds: list[list[float]] | None = None,
    region_meta: list[dict] | None = None,
    out_path: str | Path | None = None,
) -> dict:
    """Stream the eBird observations dump into per-square monthly species
    counts (ebirdgrid.main, ebirdgrid.py:359-456).

    The CSV is tab-separated with COMMON NAME / LATITUDE / LONGITUDE /
    OBSERVATION DATE headers.  Returns (and optionally writes) the
    species_per_square metadata dict.
    """
    if square_bounds is None:
        if kml_path is None:
            raise ValueError("need kml_path or square_bounds")
        square_bounds = read_kml_square_bounds(kml_path)
    square_bounds = sorted(square_bounds, key=lambda b: b[0])

    squares: list[dict] = []
    for b in square_bounds:
        code = None
        if region_meta:
            lng = (b[2] + b[0]) / 2
            lat = (b[1] + b[3]) / 2
            code, _ = find_region_meta(region_meta, lng, lat)
        squares.append(
            {"region_code": code, "bounds": list(b), "species_per_month": {}}
        )

    common_map = {
        k: v for k, v in get_label_to_ebird_map().items()
    }
    latest_date = None
    count = 0
    with open(observations_csv, "r") as f:
        reader = csv.reader(f, delimiter="\t", quotechar="|")
        headers = next(reader)
        name_i = headers.index("COMMON NAME")
        lat_i = headers.index("LATITUDE")
        lng_i = headers.index("LONGITUDE")
        date_i = headers.index("OBSERVATION DATE")
        for row in reader:
            count += 1
            lat = float(row[lat_i])
            lng = float(row[lng_i])
            res = binary_grid_search(squares, lng, lat)
            if res is None:
                square = add_new_square(squares, lng, lat)
            else:
                _, square = res
            common_name = row[name_i]
            ebird_id = common_map.get(
                common_name.lower().replace(" ", "-"), None
            )
            if ebird_id is None:
                log.warning("Unmatched bird %s", common_name)
                continue
            obs_date = datetime.fromisoformat(row[date_i])
            if latest_date is None or obs_date > latest_date:
                latest_date = obs_date
            months = square["species_per_month"].setdefault(
                ebird_id, _empty_months()
            )
            months[str(obs_date.month)] += 1

    set_neighbours(squares)
    metadata = {
        "latest_obs_date": latest_date.isoformat() if latest_date else None,
        "generated": datetime.now().isoformat(),
        "source": str(Path(observations_csv).name),
        "grid_meta": squares,
    }
    if out_path is not None:
        Path(out_path).write_text(json.dumps(metadata, indent=4))
    return metadata


def merge_neighbours(square: dict, grid_meta: list[dict]) -> dict:
    """Species counts of a square plus all its neighbours
    (ebirdgrid.merge_neighbours, ebirdgrid.py:267-281)."""
    merged = {
        k: dict(v) for k, v in square["species_per_month"].items()
    }
    for ni in square.get("neighbours_i", []):
        for species, months in grid_meta[ni]["species_per_month"].items():
            if species not in merged:
                merged[species] = dict(months)
            else:
                for m, c in months.items():
                    merged[species][m] = merged[species].get(m, 0) + c
    return merged


def add_ebird(metadata: dict, lat: float, lng: float, ebird: str,
              add_to_neighbours: bool = False) -> bool:
    """Manually mark a species as present year-round in the square at
    (lat, lng) (ebirdgrid.add_ebird, ebirdgrid.py:286-324)."""
    res = binary_grid_search(metadata["grid_meta"], lng, lat)
    if res is None:
        return False
    _, square = res
    targets = [square]
    if add_to_neighbours:
        targets += [metadata["grid_meta"][i]
                    for i in square.get("neighbours_i", [])]
    for sq in targets:
        months = sq["species_per_month"].setdefault(ebird, _empty_months())
        for m in list(months):
            months[m] = 1
    return True


def species_at(
    metadata: dict, lat: float, lng: float, month: int | None = None,
    include_neighbours: bool = True,
) -> set[str]:
    """eBird ids observed at a location (optionally restricted to a
    month)."""
    res = binary_grid_search(metadata["grid_meta"], lng, lat)
    if res is None:
        return set()
    _, square = res
    counts = (
        merge_neighbours(square, metadata["grid_meta"])
        if include_neighbours
        else square["species_per_month"]
    )
    out = set()
    for species, months in counts.items():
        if month is None:
            total = sum(months.values())
        else:
            total = months.get(str(month), months.get(month, 0))
        if total > 0:
            out.add(species)
    return out


def apply_species_mask(
    probs: np.ndarray,
    labels: list[str],
    metadata: dict,
    lat: float,
    lng: float,
    month: int | None = None,
    keep_labels: tuple[str, ...] = ("bird", "noise", "human", "insect",
                                    "frog", "rooster", "other"),
) -> np.ndarray:
    """Zero out species never observed in this grid square/month — the
    downstream filtering the Cacophony prediction service performs with
    species_per_square.json (README.md:10)."""
    present = species_at(metadata, lat, lng, month)
    mask = np.array(
        [1.0 if (l in present or l in keep_labels) else 0.0 for l in labels],
        probs.dtype if hasattr(probs, "dtype") else np.float32,
    )
    return probs * mask
