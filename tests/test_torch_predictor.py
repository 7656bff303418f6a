"""Long-recording inference of the port against the JAX package, on the CPU.

The same numpy inputs go through both packages:

* ``stft_centered``: complex spectra within 1e-5 of max |X| (fp32 FFTs of
  two libraries);
* the host code (band-pass filter, track detection, window extraction with
  one seeded ``rng`` per side, bucket padding, aggregation): equal outputs;
* ``Predictor.predict_windows`` / ``predict_recording`` on converted
  badwinner2 weights: probabilities at rtol 1e-4 / atol 1e-5, as in
  tests/test_infer.py::test_predictor_sharded_over_mesh.  At n_fft=4096 the
  JAX Predictor takes ``MatmulMelPlan(center=True)`` and the port K1's
  centered plain version; at the small n_fft=512 geometry of
  tests/test_infer.py::test_predictor_end_to_end the JAX Predictor takes
  K2 in interpret mode and the port ``stft_centered`` + K2's plain version.

Per-track results compare labels and tags exactly and confidences (rounded
percentages of those probabilities) to within 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_training_tpu import detect as jax_detect
from audio_training_tpu.config import FeaturizerConfig as JaxConfig
from audio_training_tpu.config import InferenceConfig as JaxInferenceConfig
from audio_training_tpu.infer import Predictor as JaxPredictor
from audio_training_tpu.infer import aggregate_tracks as jax_aggregate_tracks
from audio_training_tpu.infer import bucket_pad as jax_bucket_pad
from audio_training_tpu.infer import extract_track_windows as jax_extract
from audio_training_tpu.ops.features import (
    butter_bandpass_filter as jax_butter_bandpass_filter,
)
from audio_training_tpu.ops.stft import stft_centered as jax_stft_centered
from audio_training_tpu_torch import detect
from audio_training_tpu_torch.config import FeaturizerConfig, InferenceConfig
from audio_training_tpu_torch.infer import (
    Predictor,
    aggregate_tracks,
    bucket_pad,
    extract_track_windows,
)
from audio_training_tpu_torch.ops.features import butter_bandpass_filter
from audio_training_tpu_torch.ops.stft import stft_centered

from test_torch_badwinner2 import flax_variables, port_model

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
SMALL = dict(sr=8000, n_fft=512, hop_length=100, n_mels=96, fmax=3500.0)
LABELS = ["kiwi", "morepo2", "noise", "tui", "bellbird", "human", "other"]


def make_recording(events, total, sr, noise=0.005, seed=0):
    """Noise plus tone bursts: events are (start_s, duration_s, freq_hz)."""
    rng = np.random.default_rng(seed)
    x = (noise * rng.standard_normal(int(total * sr))).astype(np.float32)
    for start, dur, f in events:
        t = np.arange(int(dur * sr)) / sr
        i = int(start * sr)
        x[i : i + len(t)] += np.sin(2 * np.pi * f * t).astype(np.float32)
    return x


def box(signal):
    return (signal.start, signal.end, signal.freq_start, signal.freq_end,
            signal.mass)


def assert_results_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        g, w = g.get_meta(), w.get_meta()
        assert g["labels"] == w["labels"]
        assert g.get("raw_tag") == w.get("raw_tag")
        confs = zip(g["confidences"] + [g.get("raw_confidence") or 0],
                    w["confidences"] + [w.get("raw_confidence") or 0])
        assert all(abs(a - b) <= 1 for a, b in confs)


# ---------------------------------------------------------------------------
# DSP and host code
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft,hop,samples", [
    (4096, 281, 30000), (2048, 281, 28100), (512, 100, 8000)])
def test_stft_centered_matches_jax(n_fft, hop, samples):
    x = np.random.default_rng(n_fft).standard_normal((2, samples)).astype(
        np.float32)
    want = np.asarray(jax_stft_centered(jnp.asarray(x), n_fft, hop))
    got = stft_centered(torch.from_numpy(x), n_fft, hop).numpy()
    assert got.shape == want.shape == (2, n_fft // 2 + 1, 1 + samples // hop)
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("lo,hi", [(500, 8000), (0, 3000), (2000, 30000),
                                   (0, 0), (5000, 4000)])
def test_butter_bandpass_filter_matches_jax(lo, hi):
    x = np.random.default_rng(9).standard_normal(4800).astype(np.float32)
    np.testing.assert_array_equal(butter_bandpass_filter(x, lo, hi, 48000),
                                  jax_butter_bandpass_filter(x, lo, hi, 48000))


def test_detection_matches_jax():
    sr = 48000
    x = make_recording([(1.0, 1.2, 2000), (4.0, 0.8, 5000), (6.0, 1.0, 5200),
                        (8.5, 0.3, 9000)], total=10.0, sr=sr)
    x[int(9.2 * sr):] = 0.0  # a constant tail for get_end
    assert detect.get_end(x, sr) == jax_detect.get_end(x, sr)
    signals, spec = detect.signal_noise(x, sr)
    j_signals, j_spec = jax_detect.signal_noise(x, sr)
    np.testing.assert_array_equal(spec, j_spec)
    assert [box(s) for s in signals] == [box(s) for s in j_signals]
    assert len(signals) >= 3
    tracks = detect.get_tracks_from_signals(signals, 9.2)
    j_tracks = jax_detect.get_tracks_from_signals(j_signals, 9.2)
    assert [box(t) for t in tracks] == [box(t) for t in j_tracks]
    assert tracks


@pytest.mark.parametrize("density", [0.05, 0.3, 0.7])
@pytest.mark.parametrize("kernel", [(4, 4), (6, 42), (3, 3), (2, 5)])
def test_detection_morphology_matches_opencv(density, kernel):
    """The scipy morphology and components equal the OpenCV calls of the
    reference, borders included."""
    cv2 = pytest.importorskip("cv2")
    from audio_training_tpu_torch.detect import signals

    mask = (np.random.default_rng(7).random((257, 300)) < density).astype(
        np.uint8)
    k = np.ones(kernel, np.uint8)
    np.testing.assert_array_equal(signals._erode(mask, *kernel),
                                  cv2.erode(mask, k))
    np.testing.assert_array_equal(signals._dilate(mask, *kernel),
                                  cv2.dilate(mask, k))
    np.testing.assert_array_equal(
        signals._dilate(signals._erode(mask, *kernel), *kernel),
        cv2.morphologyEx(mask, cv2.MORPH_OPEN, k))
    stats = cv2.connectedComponentsWithStats(mask)[2][1:]
    want = sorted((tuple(int(v) for v in s) for s in stats),
                  key=lambda s: (s[0], s[1]))
    assert signals._connected_components(mask) == want


def _tracks(pkg, specs):
    return [pkg.Signal(*s, 1) for s in specs]


@pytest.mark.parametrize("total,specs,kw", [
    # long track, short centered track, track at the start, out of band
    (10.0, [(2.0, 7.0, 500, 3000), (4.0, 5.0, 500, 3000),
            (0.2, 1.0, 500, 3000), (1.0, 4.0, 12000, 20000)], {}),
    # a recording shorter than a window: random-offset zero padding
    (2.0, [(0.0, 2.0, 500, 3000), (0.5, 1.5, 200, 900)], {}),
    # a track near the end, band-passed below filter_below
    (6.0, [(5.0, 5.9, 300, 2500), (1.0, 4.5, 300, 6000)],
     {"filter_below": 3000.0}),
    (6.0, [(0.5, 4.5, 300, 2500)], {"filter_freqs": True}),
])
def test_extract_track_windows_matches_jax(total, specs, kw):
    sr = 8000
    frames = make_recording([(0.1, total - 0.2, 1500)], total, sr, seed=3)
    got = extract_track_windows(frames, sr, _tracks(detect, specs),
                                rng=np.random.default_rng(5), **kw)
    want = jax_extract(frames, sr, _tracks(jax_detect, specs),
                       rng=np.random.default_rng(5), **kw)
    np.testing.assert_array_equal(got.windows, want.windows)
    np.testing.assert_array_equal(got.track_index, want.track_index)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert got.skipped_tracks == want.skipped_tracks
    assert got.windows.shape[1] == 3 * sr


@pytest.mark.parametrize("n", [1, 3, 8, 20, 64, 65, 130])
def test_bucket_pad_matches_jax(n):
    for buckets in [(1, 2, 4, 8), InferenceConfig().bucket_sizes]:
        assert bucket_pad(n, buckets) == jax_bucket_pad(n, buckets)


@pytest.mark.parametrize("mode", ["mean", "max", "votes"])
@pytest.mark.parametrize("per_label", [False, True])
def test_aggregate_tracks_matches_jax(mode, per_label):
    rng = np.random.default_rng(11)
    probs = rng.random((12, len(LABELS))).astype(np.float32)
    probs[:4, 0] = 0.95  # a confident track
    track_index = np.repeat(np.arange(4, dtype=np.int32), 3)
    track_index[-3:] = 5  # tracks 3 and 4 get no windows
    thr = (rng.uniform(0.5, 0.9, len(LABELS)).astype(np.float32)
           if per_label else 0.7)
    args = (probs, track_index, 6, LABELS)
    got = aggregate_tracks(*args, threshold=thr, model_name="m", mode=mode)
    want = jax_aggregate_tracks(*args, threshold=thr, model_name="m",
                                mode=mode)
    assert [r.get_meta() if r else None for r in got] == \
        [r.get_meta() if r else None for r in want]
    assert got[3] is None and got[0].get_meta()["labels"]


# ---------------------------------------------------------------------------
# The Predictor
# ---------------------------------------------------------------------------


def _predictors(cfg_kw, channels=1, infer_kw=None, **kw):
    """(port, JAX) Predictors on the same converted badwinner2 weights."""
    jcfg = JaxConfig(**cfg_kw)
    module, v = flax_variables(
        (1, jcfg.n_mels, jcfg.mel_frames, channels),
        num_labels=len(LABELS))
    model = port_model(v, jcfg.n_mels, in_channels=channels)
    infer_kw = infer_kw or {}
    port = Predictor(model, LABELS, FeaturizerConfig(**cfg_kw),
                     InferenceConfig(**infer_kw), channels=channels,
                     device="cpu", **kw)
    jax_pred = JaxPredictor(module, v, LABELS, jcfg,
                            JaxInferenceConfig(**infer_kw), channels=channels,
                            **kw)
    return port, jax_pred


@pytest.fixture(scope="module")
def production():
    return _predictors({})


SMALL_INFER = {"max_window_batch": 2, "bucket_sizes": (1, 2)}


@pytest.fixture(scope="module")
def small():
    """One pair at the small geometry, shared so that JAX compiles its
    graph for one batch shape once."""
    return _predictors(SMALL, infer_kw=SMALL_INFER)


def test_production_geometry_takes_centered_k1(production):
    port, jax_pred = production
    assert port._fused is not None and port._fused.center
    assert jax_pred._mel_plan is not None  # JAX on the CPU: MatmulMelPlan


def test_predict_windows_production_geometry(production):
    port, jax_pred = production
    windows = np.random.default_rng(21).uniform(
        -0.5, 0.5, (2, 144000)).astype(np.float32)
    got = port.predict_windows(windows)
    want = jax_pred.predict_windows(windows)
    assert got.shape == (2, len(LABELS))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["mean", "max", "votes"])
def test_predict_recording_production_geometry(production, mode):
    port, jax_pred = production
    sr = 48000
    x = make_recording([(0.5, 1.0, 2500), (3.2, 1.0, 6000)], total=4.5,
                       sr=sr, seed=4)
    port.infer_cfg = InferenceConfig(aggregation=mode)
    jax_pred.infer_cfg = JaxInferenceConfig(aggregation=mode)
    tracks, results = port.predict_recording(x, sr, threshold=0.5)
    j_tracks, j_results = jax_pred.predict_recording(x, sr, threshold=0.5)
    assert [box(t) for t in tracks] == [box(t) for t in j_tracks]
    assert len(tracks) >= 1
    assert_results_match(results, j_results)
    assert tracks[0].get_meta()["predictions"]


@pytest.mark.parametrize("kw", [
    {}, {"db_scale": True}, {"mean_sub": True}, {"channels": 3},
    {"multi_label": False},
])
def test_predict_windows_small_geometry(small, kw):
    """n_fft=512: the JAX Predictor runs K2 in interpret mode, the port
    stft_centered + K2's plain version."""
    port, jax_pred = (_predictors(SMALL, infer_kw=SMALL_INFER, **kw) if kw
                      else small)
    assert port._fused is None and jax_pred._fused is None
    assert jax_pred._mel_plan is None
    windows = np.random.default_rng(22).uniform(
        -0.5, 0.5, (3, 24000)).astype(np.float32)
    got = port.predict_windows(windows)
    want = jax_pred.predict_windows(windows)
    assert got.shape == (3, len(LABELS))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if kw.get("multi_label") is False:
        np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("mode", ["mean", "max", "votes"])
def test_predict_recording_small_geometry(small, mode):
    port, jax_pred = small
    port.infer_cfg = InferenceConfig(aggregation=mode, **SMALL_INFER)
    jax_pred.infer_cfg = JaxInferenceConfig(aggregation=mode, **SMALL_INFER)
    sr = SMALL["sr"]
    t = np.arange(sr * 8) / sr
    x = (np.sin(2 * np.pi * 1500 * t) * (t % 4 < 1.2)).astype(np.float32)
    x += 0.01 * np.random.default_rng(0).standard_normal(len(x)).astype(
        np.float32)
    thr = np.linspace(0.3, 0.7, len(LABELS)).astype(np.float32)
    tracks, results = port.predict_recording(x, sr, threshold=thr)
    j_tracks, j_results = jax_pred.predict_recording(x, sr, threshold=thr)
    assert [box(t) for t in tracks] == [box(t) for t in j_tracks]
    assert any(r is not None for r in results)
    assert_results_match(results, j_results)


def test_predict_windows_of_nothing(small):
    port, _ = small
    assert port.predict_windows(np.zeros((0, 24000), np.float32)).shape == (
        0, len(LABELS))
