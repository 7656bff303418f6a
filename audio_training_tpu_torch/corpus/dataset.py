"""In-memory corpus model: AudioDataset / Recording / Track / AudioSample
(a copy of ``audio_training_tpu/corpus/dataset.py`` with the port's imports).

Behavioral port of the reference ``audiodataset.py`` dataset model: sidecar
JSON metadata parsing, tag handling with eBird relabeling, RMS-based track
tightening/filtering, per-track signal-percent, and the jittered sampling
scheme producing used / small-stride / unused sample pools (the raw material
for balancing, build.py:472-676).
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

# tag handling constants (audiodataset.py:38-39,68-78,101-104)
REJECT_TAGS = ["unidentified", "other", "mammal"]
MAX_TRACK_SAMPLES = 4
MIN_TRACK_LENGTH = 1.5
SEG_LEEWAY = 0.5
TOP_FREQ = 48000 / 2
LOW_SAMPLES_LABELS: list[str] = []

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

_sample_group_id = 0
_audio_id = 0


def segment_overlap(first, second) -> float:
    return (
        (first[1] - first[0])
        + (second[1] - second[0])
        - (max(first[1], second[1]) - min(first[0], second[0]))
    )


def load_metadata(filename: str | Path) -> dict:
    with open(str(filename), "r") as f:
        return json.load(f)


def space_signals(signals, spacing: float = 0.1):
    """Merge signal spans closer than ``spacing``
    (audiodataset.space_signals, audiodataset.py:1380-1403)."""
    out = []
    prev = None
    for s in signals:
        if prev is None:
            prev = s
        elif s[0] < prev[1] + spacing:
            prev = (prev[0], s[1])
        else:
            out.append(prev)
            prev = s
    if prev is not None:
        out.append(prev)
    return out


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


# ---------------------------------------------------------------------------
# RMS helpers (audiodataset.py:1424-1495)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Track
# ---------------------------------------------------------------------------


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
        self.mixed_label = None
        self.short_features = None
        self.mid_features = None
        self.rms_filtered = False
        self.predictions: list = []

        self._ontology = ontology or load_ontology()
        for tag in metadata.get("tags", []):
            self.add_tag(tag)

        ont = self._ontology
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


# ---------------------------------------------------------------------------
# AudioSample
# ---------------------------------------------------------------------------


class AudioSample:
    """One 3 s training example (audiodataset.AudioSample,
    audiodataset.py:341-433)."""

    def __init__(self, rec, tags, text_tags, start, end, track_ids, group_id,
                 signal_percent, bin_id=None, min_freq=None, max_freq=None,
                 mixed_label=None, low_sample=False):
        global _audio_id
        self.id = _audio_id
        _audio_id += 1
        self.rec_id = rec.id if rec is not None else None
        self.location = rec.location if rec is not None else None
        self.low_sample = low_sample
        self.mixed_label = mixed_label
        self.tags = sorted(tags)
        self.text_tags = list(text_tags)
        non_bird = [t for t in tags if t not in ("noise", "bird")]
        self.first_tag = non_bird[0] if non_bird else self.tags[0]
        self.start = start
        self.end = end
        self.track_ids = track_ids
        self.spectogram_data = None
        self.sr = None
        self.logits = None
        self.embeddings = None
        self.signal_percent = signal_percent
        self.group = group_id
        self.predicted_labels = None
        self.min_freq = min_freq
        self.max_freq = max_freq
        self.bin_id = bin_id if bin_id is not None else f"{self.rec_id}"

    def clone(self) -> "AudioSample":
        c = AudioSample(
            rec=None, tags=self.tags, text_tags=self.text_tags,
            start=self.start, end=self.end, track_ids=self.track_ids,
            group_id=self.group, signal_percent=self.signal_percent,
            bin_id=self.bin_id, min_freq=self.min_freq,
            max_freq=self.max_freq, low_sample=self.low_sample,
        )
        c.rec_id = self.rec_id
        c.location = self.location
        return c

    @property
    def length(self):
        return self.end - self.start

    @property
    def tags_s(self):
        return "\n".join(self.tags)

    @property
    def text_tags_s(self):
        return "\n".join(self.text_tags)

    @property
    def track_id(self):
        return self.bin_id

    def __repr__(self):
        return f"{self.rec_id}:{self.tags} - {self.start}-{self.end}"


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------


class Recording:
    """A recording with sidecar metadata (audiodataset.Recording,
    audiodataset.py:436-842)."""

    def __init__(self, metadata: dict, filename, config: SamplingConfig | None,
                 ontology: Ontology | None = None, load_samples=True,
                 segment_length=3.0, segment_stride=1.0,
                 rng: np.random.Generator | None = None):
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
        self.samples: list[AudioSample] = []
        self.unused_samples: list[AudioSample] = []
        self.small_strides: list[AudioSample] = []
        if load_samples:
            self.signal_percent()
            self.samples, self.small_strides, self.unused_samples = (
                self.get_samples(segment_length, segment_stride)
            )

    def add_tracks(self, tracks):
        for t in tracks:
            if any(existing.id == t.id for existing in self.tracks):
                continue
            if filter_track(t):
                continue
            self.tracks.append(t)
            self.human_tags.update(t.human_tags)

    def recalc_tags(self):
        for track in self.tracks:
            self.human_tags.update(track.human_tags)

    def space_signals(self, spacing=0.1):
        self.signals = space_signals(self.signals, spacing)

    def signal_percent(self):
        """Fraction of each track covered by detected signal spans above
        1 kHz (audiodataset.py:515-544)."""
        freq_filter = 1000
        for t in self.tracks:
            signal_time = 0.0
            prev_e = None
            for s in self.signals:
                if s[2] < freq_filter:
                    continue
                if ((t.end - t.start) + (s[1] - s[0])) > max(t.end, s[1]) - min(
                    t.start, s[0]
                ):
                    start = max(s[0], t.start)
                    if prev_e is not None:
                        start = max(prev_e, start)
                    end = min(s[1], t.end)
                    if start > end:
                        continue
                    signal_time += end - start
                    prev_e = end
                    if t.end < s[1]:
                        break
                if t.end < s[0]:
                    break
            t.signal_percent = signal_time / t.length if t.length > 0 else 0

    def get_samples(self, segment_length, segment_stride, do_overlap=False,
                    for_label=None, extra_samples=True):
        """Jittered per-track sampling with used / small-stride / unused
        pools (audiodataset.Recording.get_samples, audiodataset.py:554-842).

        Per track: candidate starts at ``stride`` spacing (jittered +-0.25 s
        when more than one); at most MAX_TRACK_SAMPLES randomly selected as
        "used"; half-stride-offset starts become the small-stride pool and
        unselected starts the unused pool (both feed oversampling,
        build.py:539-676); noise tracks overlapping bird tracks are trimmed
        to the non-overlapping part.
        """
        global _sample_group_id
        _sample_group_id += 1
        samples: list[AudioSample] = []
        small_strides: list[AudioSample] = []
        unused: list[AudioSample] = []
        rng = self.rng

        min_sample_length = segment_length - SEG_LEEWAY
        tracks = [t for t in self.tracks if not t.rms_filtered]
        if for_label is not None:
            tracks = [t for t in tracks if for_label in t.human_tags]
        sorted_tracks = sorted(self.tracks, key=lambda t: t.start)
        bin_id = f"{self.id}-0"

        for track in tracks:
            if track.bird_track and (track.noise_track or track.animal_track):
                continue
            adjusted = False
            if not track.bird_track:
                # trim noise tracks overlapping bird tracks
                # (audiodataset.py:604-641)
                for other in tracks:
                    if other is track or not other.bird_track:
                        continue
                    overlap = segment_overlap(
                        [track.og_start, track.og_end],
                        [other.og_start, other.og_end],
                    )
                    if overlap > 0:
                        if track.og_start > other.og_start:
                            track.start = other.og_end
                            track.end = max(track.start, track.end)
                        elif other.og_end > track.end:
                            track.end = other.og_start
                        else:
                            start_sec = other.og_start - track.start
                            end_sec = track.end - other.og_end
                            if start_sec > end_sec:
                                track.end = other.og_start
                            else:
                                track.start = other.og_end
                        track.start = min(track.og_end, track.start)
                        track.end = min(track.end, track.og_end)
                        adjusted = True
            if adjusted and track.length < 1:
                continue

            track_samples = (track.length - segment_length) / segment_stride
            track_samples = max(round(track_samples), 0)
            left_over = track_samples - int(track_samples)
            track_samples = int(track_samples) + 1

            sample_starts = (
                np.arange(track.length, step=segment_stride, dtype=np.float32)
                + track.start
            )
            if track_samples > 1:
                sample_starts = (
                    sample_starts + rng.random(len(sample_starts)) / 2 - 0.25
                )
            if track_samples > MAX_TRACK_SAMPLES:
                selected = rng.choice(
                    sample_starts, MAX_TRACK_SAMPLES, replace=False
                )
                left_over = 0
            else:
                selected = sample_starts

            small_stride_starts = (
                np.arange(track_samples, step=segment_stride, dtype=np.float32)
                + track.start + segment_stride / 2
            )
            if track_samples > 1:
                small_stride_starts = (
                    small_stride_starts
                    + rng.random(len(small_stride_starts)) / 2 - 0.25
                )
            if left_over > 0 and track_samples == 1 and left_over < SEG_LEEWAY:
                sample_starts = sample_starts + float(rng.random()) * left_over

            low_sample_track = any(
                l in LOW_SAMPLES_LABELS for l in track.human_tags
            )
            all_starts = (
                [sample_starts, small_stride_starts]
                if extra_samples
                else [sample_starts]
            )
            selected_set = set(np.asarray(selected).tolist())
            sample_i = 1
            small_stride = False
            min_len = min_sample_length
            for starts in all_starts:
                for start in starts:
                    start = max(0.0, float(start))
                    used = start in selected_set and not small_stride
                    end = min(start + segment_length, track.end)
                    if sample_i > 1 and (
                        start > track.end or (end - start) < min_len
                    ):
                        break
                    if (
                        left_over > 0
                        and left_over < SEG_LEEWAY
                        and sample_i == track_samples
                    ):
                        end = track.end
                        start = end - segment_length
                    sample_i += 1

                    labels = set(track.human_tags)
                    text_labels = set(track.human_text_tags)
                    min_freq = track.min_freq
                    max_freq = track.max_freq
                    track_ids = [track.id]
                    if do_overlap:
                        for other in sorted_tracks:
                            if other is track:
                                continue
                            if other.start > end:
                                break
                            overlap = (
                                (end - start) + other.length
                                - (max(end, other.end) - min(start, other.start))
                            )
                            min_overlap = min(
                                0.9 * segment_length, other.length * 0.9
                            )
                            if overlap >= min_overlap:
                                track_ids.append(other.id)
                                labels |= other.human_tags
                                text_labels |= other.human_text_tags
                                if min_freq is not None:
                                    min_freq = (
                                        None if other.min_freq is None
                                        else min(other.min_freq, min_freq)
                                    )
                                if max_freq is not None:
                                    max_freq = (
                                        None if other.max_freq is None
                                        else max(other.max_freq, max_freq)
                                    )
                    sbin = (
                        f"{self.id}-{track.id}" if low_sample_track else bin_id
                    )
                    sample = AudioSample(
                        self, labels, text_labels, start, end, track_ids,
                        _sample_group_id, track.signal_percent, bin_id=sbin,
                        min_freq=min_freq, max_freq=max_freq,
                        mixed_label=track.mixed_label,
                        low_sample=low_sample_track,
                    )
                    if used:
                        samples.append(sample)
                    elif small_stride and extra_samples:
                        small_strides.append(sample)
                    elif extra_samples:
                        unused.append(sample)
                    if start > track.end or (end - start) < min_len:
                        break
                small_stride = True
                min_len = 1.5  # relaxed for the small-stride pass
        return samples, small_strides, unused

    def load_samples(self, segment_length, segment_stride):
        self.samples, self.small_strides, self.unused_samples = (
            self.get_samples(segment_length, segment_stride)
        )

    @property
    def bin_id(self):
        return self.id


# ---------------------------------------------------------------------------
# AudioDataset
# ---------------------------------------------------------------------------

AUDIO_SUFFIXES = (".m4a", ".wav", ".mp3", ".flac")


class AudioDataset:
    """A named collection of recordings (audiodataset.AudioDataset,
    audiodataset.py:122-327)."""

    def __init__(self, name: str, config: SamplingConfig | None = None,
                 ontology: Ontology | None = None,
                 segment_length: float = 3.0, segment_stride: float = 1.0):
        self.name = name
        self.config = config or SamplingConfig()
        self.ontology = ontology or load_ontology()
        self.segment_length = segment_length
        self.segment_stride = segment_stride
        self.recs: dict = {}
        self.labels: set[str] = set()
        self.samples: list[AudioSample] = []

    def load_meta(self, base_path: str | Path) -> None:
        for f in Path(base_path).glob("**/*.txt"):
            try:
                meta = load_metadata(f)
                audio_f = None
                for suffix in AUDIO_SUFFIXES:
                    cand = f.with_suffix(suffix)
                    if cand.exists():
                        audio_f = cand
                        break
                if audio_f is None:
                    audio_f = f.with_suffix(".wav")
                r = Recording(
                    meta, audio_f, self.config, ontology=self.ontology,
                    segment_length=self.segment_length,
                    segment_stride=self.segment_stride,
                )
                self.add_recording(r)
            except Exception:
                log.error("Error loading %s", f, exc_info=True)

    def add_recording(self, r: Recording) -> None:
        if r.id in self.recs:
            log.info("Already have rec %s; ignoring duplicate", r.id)
        self.recs[r.id] = r
        self.samples.extend(r.samples)
        self.labels.update(r.human_tags)

    def remove_rec(self, rec: Recording) -> None:
        for s in rec.samples:
            if s in self.samples:
                self.samples.remove(s)
        self.recs.pop(rec.id, None)

    def get_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for s in self.samples:
            for tag in s.tags:
                counts[tag] = counts.get(tag, 0) + 1
        return counts

    def get_rec_counts(self) -> dict[str, set]:
        counts: dict[str, set] = {}
        for s in self.samples:
            for tag in s.tags:
                counts.setdefault(tag, set()).add(s.rec_id)
        return counts

    def print_counts(self):
        for k, v in sorted(self.get_counts().items()):
            log.info("%s: %s %s", self.name, k, v)
