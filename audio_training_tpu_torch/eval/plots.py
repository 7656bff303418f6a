"""Plotting helpers (a copy of ``audio_training_tpu/eval/plots.py``;
plot_utils.py parity): mel spectrograms with optional signal rectangles.

matplotlib is imported inside each plot, not with the module: without it,
a plot raises an ImportError that names it.  No path of the port's
entry points plots.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _plt():
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("plotting needs matplotlib, which is not "
                          "installed") from exc

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_mel(mel: np.ndarray, path: str | Path | None = None, title=""):
    """Log-mel image (plot_utils.plot_mel, plot_utils.py:116)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(12, 8))
    log_spec = np.log(np.asarray(mel) + np.finfo(float).eps)
    ax.pcolormesh(
        np.arange(log_spec.shape[1]), np.arange(log_spec.shape[0]), log_spec
    )
    ax.set_title(title or "Mel spectrogram")
    ax.set_xlabel("frame")
    ax.set_ylabel("mel bin")
    if path is not None:
        fig.savefig(str(path), format="png")
        plt.close(fig)
    return fig


def plot_mel_signals(
    mel: np.ndarray,
    signals,
    sr: int = 48000,
    hop_length: int = 281,
    path: str | Path | None = None,
):
    """Mel image with signal/track rectangles (plot_utils.plot_mel_signals,
    plot_utils.py:23)."""
    plt = _plt()
    from matplotlib.patches import Rectangle

    fig = plot_mel(mel)
    ax = fig.axes[0]
    n_mels = mel.shape[0]
    for s in signals:
        x0 = s.start * sr / hop_length
        x1 = s.end * sr / hop_length
        # crude mel-bin placement from frequency fractions of Nyquist
        y0 = (s.freq_start / (sr / 2)) * n_mels
        y1 = (s.freq_end / (sr / 2)) * n_mels
        ax.add_patch(
            Rectangle((x0, y0), x1 - x0, y1 - y0, fill=False,
                      edgecolor="red", linewidth=1.5)
        )
    if path is not None:
        fig.savefig(str(path), format="png")
        plt.close(fig)
    return fig


def plot_waveform(data: np.ndarray, sr: int, path: str | Path | None = None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(12, 4))
    t = np.arange(len(data)) / sr
    ax.plot(t, data, linewidth=0.3)
    ax.set_xlabel("seconds")
    if path is not None:
        fig.savefig(str(path), format="png")
        plt.close(fig)
    return fig


def plot_signal_percent(dataset, out_dir) -> list[Path]:
    """Per-label histogram of track signal-percent (build --plot-signal ->
    otherdata.plot_signal, otherdata.py:963-984): one PNG per label under
    ``out_dir/signal-graphs``, signal percent bucketed into tenths."""
    plt = _plt()
    scale = 10
    label_percents: dict[str, list[int]] = {}
    for rec in dataset.recs.values():
        for t in rec.tracks:
            pct = t.signal_percent
            if pct is None:
                continue
            for label in t.human_tags:
                buckets = label_percents.setdefault(label, [0] * (scale + 1))
                buckets[round(pct * scale)] += 1
    save_dir = Path(out_dir) / "signal-graphs"
    save_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for label, values in label_percents.items():
        plt.clf()
        plt.plot(np.arange(scale + 1), values, marker="o", linestyle="-")
        plt.xlabel("Signal percent")
        plt.ylabel("Tracks")
        plt.title(label)
        path = save_dir / f"{label}.png"
        plt.savefig(str(path))
        written.append(path)
    return written


def plot_track_rms(metadata_file, out_dir=None):
    """Render per-track bird/noise/upper band-RMS panels from an enriched
    sidecar (otherdata.load_rms_meta/graph_rms, otherdata.py:1560-1830
    debug plots).  Returns the written file paths (one per track with RMS
    arrays)."""
    import json
    from pathlib import Path

    plt = _plt()
    metadata_file = Path(metadata_file).with_suffix(".txt")
    meta = json.loads(metadata_file.read_text())
    out_dir = Path(out_dir) if out_dir is not None else metadata_file.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for i, t in enumerate(meta.get("Tracks", [])):
        bands = [(k, t[k]) for k in ("bird_rms", "noise_rms", "upper_rms")
                 if t.get(k)]
        if not bands:
            continue
        fig, axes = plt.subplots(nrows=len(bands), sharex=True,
                                 figsize=(10, 2.2 * len(bands)))
        if len(bands) == 1:
            axes = [axes]
        for ax, (name, rms) in zip(axes, bands):
            rms = np.asarray(rms, np.float64)
            ax.semilogy(np.maximum(rms, 1e-12), label="RMS Energy")
            ax.set_title(name)
            ax.legend()
        path = out_dir / f"{metadata_file.stem}-t{i}-rms.png"
        fig.savefig(str(path), format="png")
        plt.close(fig)
        written.append(path)
    return written
