"""The corpus model's sidecar half: ``Recording`` and ``Track`` read from a
recording's JSON metadata, with tag handling, eBird relabeling and the
RMS-based track tightening and filtering (a copy of the part of
``audio_training_tpu/corpus/dataset.py`` that strong evaluation reads,
``:54-155``, ``:159-327``, ``:397-470``; reference: audiodataset.py).

Sampling is not here yet: ``AudioSample``, ``Recording.get_samples`` (so
``Recording(load_samples=True)``), ``Recording``'s ``signal_percent``,
``space_signals``, ``add_tracks`` and ``recalc_tags``, and ``AudioDataset``
come with ROADMAP.md queue 1, "Host corpus tooling".
"""

from __future__ import annotations

import json
import logging
from collections import namedtuple
from pathlib import Path

import numpy as np

from audio_training_tpu_torch.config import SamplingConfig
from audio_training_tpu_torch.taxonomy.ebird import (
    get_ebird_id,
    get_ebird_ids_to_labels,
)
from audio_training_tpu_torch.taxonomy.ontology import Ontology, load_ontology

log = logging.getLogger(__name__)

_QUEUED = 'ROADMAP.md queue 1, "Host corpus tooling"'

# tag handling constants (audiodataset.py:38-39,68-78,101-104)
REJECT_TAGS = ["unidentified", "other", "mammal"]
MIN_TRACK_LENGTH = 1.5
TOP_FREQ = 48000 / 2

# dataset-stage relabeling applied when tags are read
# (audiodataset.RELABEL, audiodataset.py:68-78)
RELABEL = {
    "mohoua novaeseelandiae": "pipipi1",
    "sackin1": "sackin3",
    "baicra1": "baicra4",
    "nibkiw1": "kiwi",
    "grskiw1": "kiwi",
    "norfolk morepork": "morepo2",
    "y01193": "y01193",
    "norfolk golden whistler": "y01193",
    "gobwhi1": "y01193",
}

Tag = namedtuple("Tag", "what ebird_id confidence automatic original")


def segment_overlap(first, second) -> float:
    return (
        (first[1] - first[0])
        + (second[1] - second[0])
        - (max(first[1], second[1]) - min(first[0], second[0]))
    )


def load_metadata(filename: str | Path) -> dict:
    with open(str(filename), "r") as f:
        return json.load(f)


def ensure_track_length(start, end, min_length, track_end=None,
                        rng: np.random.Generator | None = None):
    """Randomly pad a short span out to min_length
    (audiodataset.py:1406-1421)."""
    rng = rng or np.random.default_rng()
    extra = min_length - (end - start)
    if extra <= 0:
        return start, end
    begin_pad = round(float(rng.random()) * extra, 1)
    start = max(start - begin_pad, 0)
    end = start + min_length
    if track_end is not None:
        end = min(end, track_end)
    return start, end


def remove_rms_noise(rms, rms_peaks, rms_meta, noise_peaks, noise_meta,
                     upper_peaks, sr=48000, hop_length=281):
    """Zero out peaks present in bird+noise+upper bands (broadband noise),
    then replace zeros with the non-zero mean (audiodataset.py:1424-1481)."""
    percent_diff = 0.55
    max_time_diff = 0.1 * sr / hop_length
    for n_i, n_p in enumerate(noise_peaks):
        rms_index = None
        for i, b_p in enumerate(rms_peaks):
            if abs(b_p - n_p) < max_time_diff:
                rms_index = i
                break
        if rms_index is None:
            continue
        upper_found = any(abs(u_p - n_p) < max_time_diff for u_p in upper_peaks)
        if not upper_found:
            continue
        lower = int(rms_meta["left_ips"][rms_index])
        upper = int(rms_meta["right_ips"][rms_index])
        rms_width = upper - lower
        noise_width = int(noise_meta["right_ips"][n_i]) - int(
            noise_meta["left_ips"][n_i]
        )
        rms_h = rms_meta["peak_heights"][rms_index]
        noise_h = noise_meta["peak_heights"][n_i]
        width_pct = min(rms_width, noise_width) / max(rms_width, noise_width, 1)
        height_pct = min(rms_h, noise_h) / max(rms_h, noise_h)
        if width_pct < percent_diff or height_pct < percent_diff:
            continue
        rms[lower:upper] = 0
    nz = rms[rms != 0]
    if nz.size:
        rms[rms == 0] = np.mean(nz)


def best_rms(rms, segment_length=3, sr=48000, hop_length=281):
    """Rolling-window max-energy offset (audiodataset.py:1484-1495)."""
    window = int(sr * segment_length / hop_length)
    first = np.sum(rms[:window])
    rolling = first
    best = (0, first)
    for i in range(1, len(rms) - window):
        rolling = rolling - rms[i - 1] + rms[i + window]
        if rolling > best[1]:
            best = (i, rolling)
    return best


class Track:
    """One tagged region of a recording (audiodataset.Track,
    audiodataset.py:899-1032)."""

    def __init__(self, metadata: dict, filename, rec_id, rec,
                 ontology: Ontology | None = None, segment_length=3,
                 tighten=True, filter_rms=True):
        self.rec = rec
        self.filename = filename
        self.rec_id = rec_id
        self.start = metadata["start"]
        self.end = metadata["end"]
        self.og_start = self.start
        self.og_end = self.end
        self.id = metadata.get("id")
        self.min_freq = metadata.get("minFreq")
        self.max_freq = metadata.get("maxFreq")
        positions = metadata.get("positions", [])
        if positions:
            y = positions[0].get("y", 0)
            height = positions[0].get("height", 1)
            if height != 1:
                if self.min_freq is None:
                    self.min_freq = y * TOP_FREQ
                if self.max_freq is None:
                    self.max_freq = height * TOP_FREQ + self.min_freq

        self.automatic = metadata.get("automatic")
        self.automatic_tags: set[str] = set()
        self.human_tags: set[str] = set()
        self.human_text_tags: set[str] = set()
        self.original_tags: set[str] = set()
        self.signal_percent = None
        self.rms_filtered = False
        self.predictions: list = []

        ont = ontology or load_ontology()
        for tag in metadata.get("tags", []):
            self.add_tag(tag)

        self.bird_track = any(t in ont.all_birds for t in self.human_tags)
        self.animal_track = any(t in ont.animal_labels for t in self.human_tags)
        self.noise_track = any(t in ont.noise_labels for t in self.human_tags)

        if tighten or filter_rms:
            self.tighten_track(metadata, segment_length, tighten, filter_rms)

    def add_tag(self, tag: dict) -> None:
        """Resolve a raw tag to an eBird id with dataset-stage relabeling
        (audiodataset.Track.add_tag, audiodataset.py:1043-1062)."""
        text_label = tag.get("what")
        ebird_id = get_ebird_id(text_label)
        original = ebird_id
        if ebird_id in RELABEL:
            ebird_id = RELABEL[ebird_id]
            text_label = get_ebird_ids_to_labels().get(ebird_id, [ebird_id])[0]
        t = Tag(text_label, ebird_id, tag.get("confidence"),
                tag.get("automatic"), original)
        if t.automatic:
            self.automatic_tags.add(t.ebird_id)
        else:
            self.original_tags.add(t.original)
            self.human_tags.add(t.ebird_id)
            self.human_text_tags.add(text_label)

    def tighten_track(self, metadata, segment_length, tighten, filter_rms):
        """RMS-based "tighten to best 3 s" + low-variance filtering
        (audiodataset.py:964-1032)."""
        import scipy.signal

        if not self.bird_track:
            return
        if "upper_rms" not in metadata:
            self.rms_filtered = bool(filter_rms)
            return
        MIN_STDDEV_PERCENT = 0.01
        rms_thresh = 0.00001
        rms_height = 0.001
        upper_rms = metadata["upper_rms"]
        rms_hop = metadata.get("rms_hop_length", 281)
        rms_sr = metadata.get("rms_sr", 48000)
        upper_peaks, _ = scipy.signal.find_peaks(
            upper_rms, threshold=rms_thresh / 10, height=rms_height / 10,
            width=2,
        )
        if not self.human_tags:
            return
        rms = np.array(metadata["bird_rms"], np.float64)
        noise_rms = np.asarray(metadata["noise_rms"], np.float64)
        rms_peaks, rms_meta = scipy.signal.find_peaks(
            rms, threshold=rms_thresh, height=rms_height, width=2
        )
        noise_peaks, noise_meta = scipy.signal.find_peaks(
            noise_rms, threshold=rms_thresh, height=rms_height, width=2
        )
        remove_rms_noise(rms, rms_peaks, rms_meta, noise_peaks, noise_meta,
                         upper_peaks)
        best_offset, _ = best_rms(rms, segment_length, rms_sr, rms_hop)
        start = self.start + best_offset * rms_hop / rms_sr
        end = min(start + segment_length, self.end)
        if tighten:
            self.start = start
            self.end = end
        track_rms = rms[best_offset : int(end * rms_sr / rms_hop)]
        if track_rms.size == 0:
            return
        mean = np.mean(track_rms)
        if mean > 0 and filter_rms:
            if np.std(track_rms) / mean < MIN_STDDEV_PERCENT:
                log.warning(
                    "RMS variance too low for rec %s track %s", self.rec_id,
                    self.id,
                )
                self.rms_filtered = True

    def ensure_track_length(self, rec_duration):
        self.start, self.end = ensure_track_length(
            self.start, self.end, MIN_TRACK_LENGTH, track_end=rec_duration
        )

    def overlaps(self, other):
        return segment_overlap([self.start, self.end],
                               [other.start, other.end])

    @property
    def freq_start(self):
        return self.min_freq

    @property
    def freq_end(self):
        return self.max_freq

    @property
    def length(self):
        return self.end - self.start

    @property
    def tags(self):
        return self.human_tags

    @property
    def tag(self):
        return next(iter(self.human_tags), None)

    @property
    def tags_key(self):
        return "-".join(sorted(self.human_tags))

    @property
    def bin_id(self):
        return f"{self.rec_id}-{self.tag}"


def filter_track(track: Track) -> bool:
    """Reject multi-tag and reject-listed tracks (audiodataset.py:326-337)."""
    if len(track.tags) != 1:
        return True
    return track.tag in REJECT_TAGS


class Recording:
    """A recording with sidecar metadata (audiodataset.Recording,
    audiodataset.py:436-842), its tracks read and filtered.  Only
    ``load_samples=False`` is ported (see the module docstring)."""

    def __init__(self, metadata: dict, filename, config: SamplingConfig | None,
                 ontology: Ontology | None = None, load_samples=True,
                 segment_length=3.0, segment_stride=1.0,
                 rng: np.random.Generator | None = None):
        if load_samples:
            raise NotImplementedError(
                f"Recording(load_samples=True) comes with {_QUEUED}")
        self.filename = filename
        self.metadata = metadata
        self.id = metadata.get("id")
        self.device_id = metadata.get("deviceId")
        self.group_id = metadata.get("groupId")
        self.rec_date = metadata.get("recordingDateTime")
        self.signals = metadata.get("signal", [])
        self.noises = metadata.get("noise", [])
        self.duration = metadata.get("duration")
        self.rng = rng or np.random.default_rng()
        self.location = None
        location = metadata.get("location")
        if location is not None:
            try:
                if isinstance(location, list):
                    location = location[0]
                self.location = (location.get("lat"), location.get("lng"))
            except Exception:
                log.error("Could not parse lat lng", exc_info=True)

        cfg = config or SamplingConfig()
        self._segment_length = segment_length
        self._segment_stride = segment_stride
        ontology = ontology or load_ontology()
        self.tracks: list[Track] = []
        self.human_tags: set[str] = set()
        tracks_meta = metadata.get("Tracks") or metadata.get("tracks", [])
        for tm in tracks_meta:
            t = Track(
                tm, self.filename, self.id, self, ontology=ontology,
                segment_length=segment_length,
                tighten=cfg.tighten_tracks, filter_rms=cfg.filter_rms,
            )
            if filter_track(t):
                continue
            self.tracks.append(t)
            self.human_tags.update(t.human_tags)

        self.sample_rate = None
        self.rec_data = None
