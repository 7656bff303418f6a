"""Hand-crafted audio features for the ``cnn-features`` / ``merge`` models
(a copy of ``audio_training_tpu/corpus/features.py``).

The reference computes them with pyAudioAnalysis'
``MidTermFeatures.mid_feature_extraction`` (audiodataset.load_features,
audiodataset.py:879-896; stored by audiowriter.py:136-142, consumed at
(68, 60) short / (136, 3) mid shapes, tfdataset.py:1041-1045).

pyAudioAnalysis is not bundled in zero-egress builds, so
:func:`load_features` uses it when importable (exact parity) and otherwise
computes a NATIVE numpy implementation of the same 34-feature set — zcr,
energy, energy entropy, spectral centroid/spread/entropy/flux/rolloff,
13 MFCCs, 12 chroma + chroma std — with first-order deltas (68 rows) and
mid-term mean+std aggregation (136 rows), at the reference's window
defaults (50 ms short, 1 s mid, no overlap).  Shapes and feature ORDER
match pyAudioAnalysis; exact values differ slightly (different MFCC
filterbank constants), which only matters for transplanting models trained
on the original features — models trained in-framework are self-consistent.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-10


def _frame(signal: np.ndarray, win: int, step: int) -> np.ndarray:
    n = 1 + (len(signal) - win) // step if len(signal) >= win else 0
    if n <= 0:
        return np.zeros((0, win), np.float64)
    idx = np.arange(win)[None, :] + step * np.arange(n)[:, None]
    return signal[idx].astype(np.float64)


def _mfcc_filterbank(sr: float, n_fft: int, n_mel: int = 13 * 2 + 2):
    """Triangular mel filterbank (pyAudioAnalysis-style constants)."""
    low, lin_c, log_c = 133.33, 200 / 3, 1.0711703
    n_lin = 13
    freqs = np.zeros(n_mel + 2)
    freqs[:n_lin] = low + np.arange(n_lin) * lin_c
    freqs[n_lin:] = freqs[n_lin - 1] * log_c ** np.arange(1, n_mel + 3 - n_lin)
    fft_freqs = np.arange(n_fft) * sr / (2 * (n_fft - 1))
    fbank = np.zeros((n_mel, n_fft))
    for i in range(n_mel):
        lo, ce, hi = freqs[i], freqs[i + 1], freqs[i + 2]
        up = (fft_freqs >= lo) & (fft_freqs <= ce)
        down = (fft_freqs > ce) & (fft_freqs <= hi)
        fbank[i, up] = (fft_freqs[up] - lo) / max(ce - lo, EPS)
        fbank[i, down] = (hi - fft_freqs[down]) / max(hi - ce, EPS)
    return fbank


def _chroma_map(sr: float, n_fft: int) -> np.ndarray:
    freqs = np.arange(1, n_fft) * sr / (2 * (n_fft - 1))
    pitches = 12 * np.log2(freqs / 27.5)
    cls = np.round(pitches).astype(int) % 12
    m = np.zeros((12, n_fft))
    for k in range(12):
        m[k, 1:][cls == k] = 1.0
    return m


def _short_term(signal: np.ndarray, sr: int, win: int, step: int):
    frames = _frame(signal, win, step)
    n = frames.shape[0]
    n_fft = win // 2
    feats = np.zeros((34, n))
    fbank = _mfcc_filterbank(sr, n_fft)
    chroma_m = _chroma_map(sr, n_fft)
    prev_mag = None
    for t in range(n):
        x = frames[t]
        # 1 zcr, 2 energy
        feats[0, t] = np.mean(np.abs(np.diff(np.sign(x)))) / 2.0
        energy = np.mean(x**2)
        feats[1, t] = energy
        # 3 energy entropy over 10 sub-frames
        sub = x[: (len(x) // 10) * 10].reshape(10, -1)
        se = (sub**2).sum(axis=1) / (x.astype(np.float64) ** 2).sum() if (x**2).sum() > 0 else np.full(10, 0.1)
        se = np.clip(se, EPS, None)
        feats[2, t] = -np.sum(se * np.log2(se))
        mag = np.abs(np.fft.rfft(x))[:n_fft]
        mag = mag / max(len(mag), 1)
        p = mag / (mag.sum() + EPS)
        freqs_n = (np.arange(1, n_fft + 1)) / n_fft
        # 4 centroid, 5 spread (normalized by sr/2)
        c = (freqs_n * p).sum()
        feats[3, t] = c / 2.0
        feats[4, t] = np.sqrt(((freqs_n - c) ** 2 * p).sum()) / 2.0
        # 6 spectral entropy
        sub_p = p[: (len(p) // 10) * 10].reshape(10, -1).sum(axis=1)
        sub_p = np.clip(sub_p, EPS, None)
        feats[5, t] = -np.sum(sub_p * np.log2(sub_p))
        # 7 flux
        if prev_mag is None:
            feats[6, t] = 0.0
        else:
            a = mag / (mag.sum() + EPS)
            b = prev_mag / (prev_mag.sum() + EPS)
            feats[6, t] = np.sum((a - b) ** 2)
        prev_mag = mag
        # 8 rolloff (0.90)
        cum = np.cumsum(mag**2)
        thr = 0.90 * cum[-1] if cum[-1] > 0 else 0
        idx = np.searchsorted(cum, thr)
        feats[7, t] = idx / float(n_fft)
        # 9-21 mfcc
        mspec = np.log10(np.clip(fbank @ mag, EPS, None))
        from scipy.fftpack import dct

        feats[8:21, t] = dct(mspec, type=2, norm="ortho")[:13]
        # 22-33 chroma, 34 chroma std
        spec2 = mag**2
        chroma = chroma_m @ spec2
        chroma = chroma / (spec2.sum() + EPS)
        feats[21:33, t] = chroma
        feats[33, t] = chroma.std()
    # first-order deltas (pyAudioAnalysis deltas=True): 68 rows
    deltas = np.concatenate(
        [np.zeros((34, 1)), np.diff(feats, axis=1)], axis=1
    ) if n else np.zeros((34, 0))
    return np.concatenate([feats, deltas], axis=0)


def load_features(signal: np.ndarray, sr: int):
    """(short_features (68, T_s), mid_features (136, T_m)) — pyAudioAnalysis
    when installed, native implementation otherwise (audiodataset.py:879-896
    defaults: 50 ms short window/step, 1 s mid window/step)."""
    try:
        from pyAudioAnalysis import MidTermFeatures as aF

        mid, short, _ = aF.mid_feature_extraction(
            signal, sr, round(sr * 1.0), round(sr * 1.0),
            round(sr * 0.05), round(sr * 0.05),
        )
        return short, mid
    except ImportError:
        pass
    signal = np.asarray(signal, np.float64)
    denom = 2.0 ** 15 if np.abs(signal).max() > 1.5 else 1.0
    signal = signal / denom
    sw = round(sr * 0.05)
    short = _short_term(signal, sr, sw, sw)
    # mid-term: mean + std of each short feature over 1 s windows
    per_mid = max(int(round(sr * 1.0) / sw), 1)
    n_mid = max(short.shape[1] // per_mid, 1)
    mids = []
    for m in range(n_mid):
        seg = short[:, m * per_mid : (m + 1) * per_mid]
        if seg.shape[1] == 0:
            seg = np.zeros((short.shape[0], 1))
        mids.append(np.concatenate([seg.mean(axis=1), seg.std(axis=1)]))
    return short, np.stack(mids, axis=1)
