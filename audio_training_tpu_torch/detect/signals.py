"""Energy-based signal/track detection (host-side, numpy/scipy).

A copy of ``audio_training_tpu/detect/signals.py``, kept here so the port
imports nothing of the JAX package.  Behavioral port of the reference
``identifytracks.py``: median-threshold masking of the magnitude
spectrogram, morphological cleanup, connected components, then an
order-sensitive iterative merge of the resulting ``Signal`` boxes into
tracks.  This runs per recording on the host as inference prep
(predict.py:736-740); the per-window classification it feeds runs on the
card.

Morphology and connected components run on scipy.ndimage alone, with the
semantics of the OpenCV calls of the reference: all-ones rectangular kernels
anchored at their centre, image borders that neither erode nor dilate, and
8-connected components.  tests/test_torch_predictor.py holds them against
OpenCV where it is installed.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage

SIGNAL_WIDTH = 0.25  # seconds (identifytracks.py:9)
TOP_FREQ = 48000 / 2
DETECT_HOP = 281

_signal_id = 0


def _next_id() -> int:
    global _signal_id
    _signal_id += 1
    return _signal_id - 1


def mel_freq(f):
    """HTK mel (break 700) used for merge decisions (identifytracks.py:154)."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def segment_overlap(first, second) -> float:
    """Signed overlap of two intervals (identifytracks.py:146-151)."""
    return (
        (first[1] - first[0])
        + (second[1] - second[0])
        - (max(first[1], second[1]) - min(first[0], second[0]))
    )


def get_nfft(sr: int) -> int:
    """Nearest power of two to sr/10 (identifytracks.py:13-16)."""
    return int(2 ** round(math.log2(sr // 10)))


def _host_stft_mag(frames: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """|STFT| with librosa conventions (center=True, constant pad, hann) —
    pure numpy so per-file detection has no device round-trip."""
    half = n_fft // 2
    x = np.pad(frames.astype(np.float32), (half, half))
    n_frames = 1 + (len(x) - n_fft) // hop
    strides = (x.strides[0] * hop, x.strides[0])
    framed = np.lib.stride_tricks.as_strided(
        x, shape=(n_frames, n_fft), strides=strides, writeable=False
    )
    k = np.arange(n_fft)
    window = (0.5 - 0.5 * np.cos(2 * np.pi * k / n_fft)).astype(np.float32)
    spec = np.fft.rfft(framed * window, n=n_fft, axis=-1)
    return np.abs(spec).T.astype(np.float32)  # (freq, time)


def get_end(frames: np.ndarray, sr: int) -> float:
    """True recording end: scan ~1 s mel chunks for constant (silence-padded)
    data (identifytracks.py:21-48)."""
    from audio_training_tpu_torch.ops.mel import mel_filterbank

    hop = DETECT_HOP
    n_fft = get_nfft(sr)
    mag = _host_stft_mag(frames, n_fft, hop)
    weights = mel_filterbank(sr, 120, 50, 11000, n_fft, 1750.0)
    mel = weights @ mag  # power=1 (identifytracks.py:25-35)
    start = 0
    chunk = sr // hop
    end = start + chunk
    file_length = len(frames) / sr
    while end < mel.shape[1]:
        data = mel[:, start:end]
        if np.amax(data) == np.amin(data):
            return start * hop // sr
        start = end
        end = start + chunk
    return file_length


def _erode(mask: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.erode`` with an all-ones ``(height, width)`` kernel: a min
    filter that counts pixels past the border as set."""
    return ndimage.minimum_filter(mask, size=(height, width),
                                  mode="constant", cval=1)


def _dilate(mask: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.dilate`` with an all-ones ``(height, width)`` kernel: a max
    filter that counts pixels past the border as clear."""
    return ndimage.maximum_filter(mask, size=(height, width),
                                  mode="constant", cval=0)


def _connected_components(mask: np.ndarray) -> list[tuple]:
    """(x, y, w, h, area) of each 8-connected component, as the rows of
    ``cv2.connectedComponentsWithStats``, ordered by (x, y)."""
    labeled, _ = ndimage.label(mask, structure=np.ones((3, 3), bool))
    areas = np.bincount(labeled.ravel())
    stats = [
        (xs.start, ys.start, xs.stop - xs.start, ys.stop - ys.start,
         int(areas[i]))
        for i, (ys, xs) in enumerate(ndimage.find_objects(labeled), start=1)
    ]
    return sorted(stats, key=lambda s: (s[0], s[1]))


def signal_noise(
    frames: np.ndarray,
    sr: int,
    hop_length: int = DETECT_HOP,
    n_fft: int = 1024,
    min_width: float | None = None,
    min_height: float | None = None,
):
    """Detect candidate signal boxes in a recording
    (identifytracks.signal_noise, identifytracks.py:51-143).

    Mask rule: bin is signal if above 2x its column median AND 3x its row
    median; then open(4,4), dilate(height x width), erode(height//10 x width)
    with width = 0.25 s of frames and height = the ~100 Hz bin count.
    Returns (signals, magnitude spectrogram).

    The reference's quirks are kept: ``n_fft`` is overridden to 2048, and
    ``hop_length`` feeds the STFT while the boxes' times are still counted
    in ``DETECT_HOP`` frames.
    """
    n_fft = 2048  # hard override, identifytracks.py:55
    mag = _host_stft_mag(frames, n_fft, hop_length)
    freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)

    height = 0
    for i, f in enumerate(freqs):
        if f > 100 and height == 0:
            height = i + 1
            break

    og_spec = mag.copy()
    peak = np.amax(mag)
    if peak == 0:
        return [], og_spec  # all-silence recording
    mag = mag / peak
    row_medians = np.median(mag, axis=1)[:, np.newaxis]
    column_medians = np.median(mag, axis=0)[np.newaxis, :]

    signal = (mag > 2 * column_medians) & (mag > 3 * row_medians)
    signal = signal.astype(np.uint8)
    signal = _dilate(_erode(signal, 4, 4), 4, 4)  # opening

    width = int(SIGNAL_WIDTH * sr / hop_length)
    signal = _dilate(signal, height, width)
    # Reference quirk reproduced exactly (identifytracks.py:99): at 48 kHz
    # ``height // 10 == 0``, so the reference hands cv2.erode an EMPTY
    # (0, width) kernel — and cv2 silently substitutes its DEFAULT 3x3
    # structuring element (verified; a (1, width) "fix" erodes far more
    # aggressively along time and changes the detected boxes).
    erode_h = height // 10
    signal = (_erode(signal, erode_h, width) if erode_h > 0
              else _erode(signal, 3, 3))

    if min_height is None:
        min_height = height - height // 10
    if min_width is None:
        min_width = 0.65 * width
    stats = [s for s in _connected_components(signal)
             if s[2] > min_width and s[3] > min_height]

    signals = []
    for s in stats:
        max_freq_bin = min(len(freqs) - 1, s[1] + s[3])
        start = s[0] * DETECT_HOP / sr
        end = (s[0] + s[2]) * DETECT_HOP / sr
        signals.append(Signal(start, end, freqs[s[1]], freqs[max_freq_bin],
                              s[4]))
    return signals, og_spec


class Signal:
    """A time/frequency box with merge arithmetic
    (identifytracks.Signal, identifytracks.py:376-502)."""

    def __init__(self, start, end, freq_start, freq_end, mass=0):
        self.id = _next_id()
        self.start = float(start)
        self.end = float(end)
        self.freq_start = float(freq_start)
        self.freq_end = float(freq_end)
        self.mass = mass
        self.mel_freq_start = float(mel_freq(freq_start))
        self.mel_freq_end = float(mel_freq(freq_end))
        self.predictions: list = []
        self.track_id = None

    # -- geometry ----------------------------------------------------------
    @property
    def length(self):
        return self.end - self.start

    @property
    def mel_freq_range(self):
        return self.mel_freq_end - self.mel_freq_start

    @property
    def freq_range(self):
        return self.freq_end - self.freq_start

    def time_overlap(self, other):
        return segment_overlap((self.start, self.end), (other.start, other.end))

    def mel_freq_overlap(self, other):
        return segment_overlap(
            (self.mel_freq_start, self.mel_freq_end),
            (other.mel_freq_start, other.mel_freq_end),
        )

    def freq_overlap(self, other):
        return segment_overlap(
            (self.freq_start, self.freq_end),
            (other.freq_start, other.freq_end),
        )

    # -- operations --------------------------------------------------------
    def copy(self):
        return Signal(self.start, self.end, self.freq_start, self.freq_end,
                      self.mass)

    def merge(self, other):
        self.start = min(self.start, other.start)
        self.end = max(self.end, other.end)
        self.freq_start = min(self.freq_start, other.freq_start)
        self.freq_end = max(self.freq_end, other.freq_end)
        self.mel_freq_start = float(mel_freq(self.freq_start))
        self.mel_freq_end = float(mel_freq(self.freq_end))
        self.mass += other.mass

    def enlarge(self, scale, min_track_length, max_extra=1):
        """Grow 1.4x in time (bounded) and frequency
        (identifytracks.py:452-472)."""
        new_length = self.length * scale
        if new_length < min_track_length:
            new_length = min_track_length
        extra = min(max_extra, new_length - self.length)
        self.start = max(self.start - extra / 2, 0.0)
        self.end = self.end + extra / 2

        new_range = self.freq_range * scale
        ext = (new_range - self.freq_range) / 2
        self.freq_start = int(max(self.freq_start - ext, 0))
        self.freq_end = int(self.freq_end + ext)
        self.mel_freq_start = float(mel_freq(self.freq_start))
        self.mel_freq_end = float(mel_freq(self.freq_end))

    def to_array(self, decimals=1):
        a = [self.start, self.end, self.freq_start, self.freq_end]
        if decimals is not None:
            a = list(np.round(np.array(a), decimals))
        return a

    def to_features(self):
        return np.float32(
            [self.start, self.end, self.freq_start, self.freq_end,
             self.mel_freq_start, self.mel_freq_end]
        )

    def get_meta(self) -> dict:
        meta = {
            "id": self.id,
            "start": self.start,
            "end": self.end,
            "freq_start": self.freq_start,
            "freq_end": self.freq_end,
            "positions": [
                {
                    "y": self.freq_start / TOP_FREQ,
                    "height": (self.freq_end - self.freq_start) / TOP_FREQ,
                }
            ],
            "predictions": [r.get_meta() for r in self.predictions],
        }
        if self.track_id is not None:
            meta["track_id"] = self.track_id
        return meta

    def __repr__(self):
        return (
            f"Signal: {self.start}-{self.end} "
            f"f: {self.freq_start}-{self.freq_end} mass {self.mass}"
        )


def merge_signals(signals: list[Signal]) -> tuple[list[Signal], bool]:
    """One merge pass (identifytracks.merge_signals,
    identifytracks.py:162-233).  Order-sensitive: sorted by descending mel
    top then ascending start; each signal merges at most one partner per
    pass.  Merge rules:

    * large time overlap (75% of the partner, or >1.5 s absolute) with any
      frequency proximity;
    * any time overlap with strong mel-frequency overlap;
    * strong mel overlap with a gap <= 2 s and similar frequency ranges —
      but only when both boxes are on the same side of 1500 mel.
    """
    overlap_seconds = 1.5
    to_delete: list[Signal] = []
    something_merged = False
    signals = sorted(signals, key=lambda s: s.mel_freq_end, reverse=True)
    signals = sorted(signals, key=lambda s: s.start)
    for s in signals:
        if s in to_delete:
            continue
        merged = False
        u = None
        for u in signals:
            if u in to_delete or u is s:
                continue
            same_band = (u.mel_freq_end < 1500) == (s.mel_freq_end < 1500)
            if not same_band:
                continue
            overlap = s.time_overlap(u)
            if s.mel_freq_start > 1000 and u.mel_freq_start > 1000:
                freq_overlap_time = 0.5
            else:
                freq_overlap_time = 0.75
            time_diff = (
                s.start - u.end if s.start > u.end else u.start - s.end
            )
            mel_overlap = s.mel_freq_overlap(u)
            if (
                overlap > u.length * 0.75 and mel_overlap > -20
            ) or overlap > overlap_seconds:
                s.merge(u)
                merged = True
                break
            elif overlap > 0 and mel_overlap > u.mel_freq_range * freq_overlap_time:
                s.merge(u)
                merged = True
                break
            elif (
                mel_overlap > u.mel_freq_range * freq_overlap_time
                and time_diff <= 2
            ):
                if u.mel_freq_end > s.mel_freq_range:
                    range_overlap = s.mel_freq_range / u.mel_freq_range
                else:
                    range_overlap = u.mel_freq_range / s.mel_freq_range
                if range_overlap < 0.75:
                    continue
                s.merge(u)
                merged = True
                break
        if merged:
            something_merged = True
            to_delete.append(u)

    for s in to_delete:
        signals.remove(s)
    return signals, something_merged


def get_tracks_from_signals(signals: list[Signal], end: float,
                            filter_short: bool = True) -> list[Signal]:
    """Signals -> tracks (identifytracks.get_tracks_from_signals,
    identifytracks.py:236-301): merge to fixed point, drop <0.35 s, enlarge
    1.4x (min 0.7 s), re-merge heavy overlaps, drop <50 mel range, split
    tracks longer than 6 s.

    ``filter_short=False`` keeps sub-0.35 s signals — the weak-label
    best-track scorer wants them (otherdata.py:1486 calls with
    ``filter_short=False``; the reference's live identifytracks signature
    lost the parameter and would TypeError, restored here)."""
    max_length = 6
    min_mel_range = 50
    merged = True
    while merged:
        signals, merged = merge_signals(signals)

    to_delete: list[Signal] = []
    min_length_base = 0.35
    min_track_length = 0.7
    overlap_seconds = 1.5
    for s in signals:
        if s in to_delete:
            continue
        if filter_short and s.length < min_length_base:
            to_delete.append(s)
            continue
        s.enlarge(1.4, min_track_length=min_track_length)
        s.end = min(end, s.end)
        for s2 in signals:
            if s2 in to_delete or s2 is s:
                continue
            overlap = s.time_overlap(s2)
            min_length = min(s.length, s2.length)
            if overlap > 0.7 * min_length or overlap > overlap_seconds:
                s.merge(s2)
                to_delete.append(s2)
    for s in to_delete:
        signals.remove(s)

    signals = [s for s in signals if s.mel_freq_range >= min_mel_range]

    final: list[Signal] = []
    for s in signals:
        if s.length > max_length:
            splits = math.ceil(s.length / max_length)
            length = s.length / splits
            start = s.start
            for _ in range(splits):
                piece = s.copy()
                piece.start = start
                piece.end = start + length
                final.append(piece)
                start = piece.end
        else:
            final.append(s)
    return final


def merge_again(tracks: list[Signal]) -> list[Signal]:
    """Second-pass greedy track merge used by the weak-label corpus track
    generator (otherdata.merge_again, otherdata.py:193-229).

    Order-sensitive behavioral port, including the reference's quirks: when
    the current track is mostly (>50%) covered by the newcomer it is
    REPLACED in the output; a >50% time overlap (of the newcomer) or any
    time overlap with >50% mel-frequency overlap extends the current track
    end only in the frequency-overlap case.

    One documented fix: the reference's trailing ``if overlap <= 0`` block
    re-appends a newcomer its ``else`` branch already appended (overlap<=0
    implies both percent tests were false), so every gap-separated track
    appears TWICE in its output — the duplicate append is removed here.
    """
    post_filter: list[Signal] = []
    current = None
    for t in sorted(tracks, key=lambda track: track.start):
        if current is None:
            current = t
            post_filter.append(current)
            continue
        overlap = current.time_overlap(t)
        pct = overlap / t.length if t.length else 0.0
        pct2 = overlap / current.length if current.length else 0.0
        f_overlap = current.mel_freq_overlap(t)
        f_pct = f_overlap / t.mel_freq_range if t.mel_freq_range else 0.0

        if pct2 > 0.5:
            post_filter = post_filter[:-1]
            post_filter.append(t)
            current = t
        elif pct > 0.5 or (pct > 0 and f_pct > 0.5):
            if f_pct > 0.5:
                current.end = max(current.end, t.end)
        else:
            # also covers overlap <= 0 (both percent tests are then false);
            # the reference's extra `if overlap <= 0` block after this
            # appended the same newcomer a SECOND time — dropped here
            current = t
            post_filter.append(current)
    return post_filter
