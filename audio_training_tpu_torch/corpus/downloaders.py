"""Network corpus acquisition (xenodownloader.py + ebirdspecies.py parity).

Both hit public APIs; in zero-egress environments the functions raise a
clear error from the requests layer — the download format/sidecar contract
is what matters for parity.

A copy of ``audio_training_tpu/corpus/downloaders.py`` with the port's imports.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

log = logging.getLogger(__name__)

XENO_API = "https://xeno-canto.org/api/2/recordings"
EBIRD_API = "https://api.ebird.org/v2"

# NZ + Norfolk region codes queried by the reference (ebirdspecies.py:6-69)
NZ_REGIONS = [
    "NZ-AUK", "NZ-BOP", "NZ-CAN", "NZ-GIS", "NZ-HKB", "NZ-MBH", "NZ-MWT",
    "NZ-NSN", "NZ-NTL", "NZ-OTA", "NZ-STL", "NZ-TAS", "NZ-TKI", "NZ-WGN",
    "NZ-WKO", "NZ-WTC", "NZ-CIT", "AU-NF",
]


def download_xeno_canto(
    query: str,
    out_dir: str | Path,
    max_recordings: int = 100,
    session=None,
) -> int:
    """Download xeno-canto recordings + sidecar metadata
    (xenodownloader.py:8-92).  Sidecars carry the weak label and xeno
    quality/location fields."""
    if session is None:
        import requests

        session = requests.Session()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    page = 1
    downloaded = 0
    while downloaded < max_recordings:
        resp = session.get(XENO_API, params={"query": query, "page": page},
                           timeout=60)
        resp.raise_for_status()
        data = resp.json()
        for rec in data.get("recordings", []):
            if downloaded >= max_recordings:
                break
            rec_id = f"xc{rec['id']}"
            audio_url = rec.get("file")
            if not audio_url:
                continue
            suffix = Path(rec.get("file-name", "a.mp3")).suffix or ".mp3"
            audio_path = out_dir / f"{rec_id}{suffix}"
            # Intentional divergence from xenodownloader.py:83-90: existing
            # files COUNT toward max_recordings and their sidecars are
            # refreshed from the current API response (the reference counts
            # only fresh downloads toward --limit and never rewrites a
            # sidecar).  Rationale: max_recordings here bounds the corpus
            # size, not network traffic, so reruns are idempotent instead of
            # growing the set; rewriting keeps sidecar metadata current.
            if not audio_path.exists():
                r = session.get(audio_url, timeout=300)
                r.raise_for_status()
                audio_path.write_bytes(r.content)
            meta = {
                "id": rec_id,
                "xeno_id": rec["id"],
                "label": rec.get("en"),
                "scientific": f"{rec.get('gen', '')} {rec.get('sp', '')}",
                "quality": rec.get("q"),
                "length": rec.get("length"),
                "location": {"lat": rec.get("lat"), "lng": rec.get("lng")},
                "Tracks": [],
            }
            audio_path.with_suffix(".txt").write_text(
                json.dumps(meta, indent=2)
            )
            downloaded += 1
        if page >= int(data.get("numPages", 1)):
            break
        page += 1
    return downloaded


def download_ebird_species_lists(
    api_key: str,
    out_file: str | Path = "ebird_species.json",
    regions: list[str] | None = None,
    session=None,
) -> dict:
    """Per-region species lists from the eBird API (ebirdspecies.py:6-69),
    written in the format ebirdgrid consumes."""
    if session is None:
        import requests

        session = requests.Session()
    regions = regions or NZ_REGIONS
    out = []
    for code in regions:
        resp = session.get(
            f"{EBIRD_API}/product/spplist/{code}",
            headers={"X-eBirdApiToken": api_key},
            timeout=60,
        )
        resp.raise_for_status()
        info = session.get(
            f"{EBIRD_API}/ref/region/info/{code}",
            headers={"X-eBirdApiToken": api_key},
            timeout=60,
        )
        bounds = None
        if info.ok:
            b = info.json().get("bounds")
            if b:
                bounds = [b["minX"], b["minY"], b["maxX"], b["maxY"]]
        out.append({"code": code, "bounds": bounds, "species": resp.json()})
    Path(out_file).write_text(json.dumps(out, indent=2))
    return {"regions": out}
