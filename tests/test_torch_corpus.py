"""The port's corpus tooling and ``cli/build`` against the JAX package's, on
the same inputs: the cases of tests/test_corpus.py, each run through both
packages, and ``cli/build`` end to end with each of its flags.

Randomness is fixed the same way on both sides: ``random.seed(k)`` before
each side, and ``numpy.random.default_rng`` patched so that each call
without a seed returns a fresh ``Generator(PCG64(k))``.  The module
counters ``_audio_id`` / ``_sample_group_id`` are reset before each side,
so sample ids and groups compare too; every sample and track field is
compared exactly.

GZIP writes the time into each shard's header, so shards are compared as
decompressed record streams: bitwise shard by shard with one worker, as a
multiset of records with two (the workers take recordings off one queue).
The one exception is the ``spectogram`` feature under
``--store-spectrogram``: the JAX package min-max normalizes the clip
through XLA, the port on a CPU tensor, so that feature is held at 1e-5 of
its largest magnitude.  ``training-meta.json`` is byte-identical.
"""

import contextlib
import gzip
import importlib
import json
import random
import shutil

import numpy as np
import pytest
import torch

from audio_training_tpu_torch.data._native import split_records
from audio_training_tpu_torch.data.example import decode_example

torch.set_num_threads(2)

PKGS = ("audio_training_tpu", "audio_training_tpu_torch")
SR = 8000
GEOMETRY = dict(sr=SR, n_fft=512, hop_length=100, n_mels=32, fmax=3500.0)
BUILD_GEOMETRY = ["--sr", str(SR), "--n-fft", "512", "--hop-length", "100",
                  "--mels", "32", "--fmax", "3500", "--seg-length", "3",
                  "--stride", "1"]
NO_RMS = ["--dont-tighten-tracks", "--dont-filter-rms"]
SPECTOGRAM = "audio/spectogram"
SPEC_REL = 1e-5

SAMPLE_KEYS = ("id", "group", "rec_id", "location", "start", "end", "tags",
               "text_tags", "first_tag", "track_ids", "signal_percent",
               "bin_id", "min_freq", "max_freq", "low_sample", "mixed_label",
               "length")
TRACK_KEYS = ("id", "start", "end", "og_start", "og_end", "min_freq",
              "max_freq", "human_tags", "automatic_tags", "original_tags",
              "human_text_tags", "bird_track", "noise_track", "animal_track",
              "rms_filtered", "signal_percent", "tag", "tags_key", "bin_id")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@contextlib.contextmanager
def fixed_randomness(k: int):
    """``random.seed(k)``, counters at 0, ``default_rng()`` -> PCG64(k)."""
    for pkg in PKGS:
        ds = mod(pkg, "corpus.dataset")
        ds._audio_id = 0
        ds._sample_group_id = 0
    random.seed(k)
    real = np.random.default_rng

    def default_rng(seed=None):
        if seed is None:
            return np.random.Generator(np.random.PCG64(k))
        return real(seed)

    np.random.default_rng = default_rng
    try:
        yield
    finally:
        np.random.default_rng = real


def both(fn, k: int = 0):
    """``fn(pkg)`` for the JAX package, then the port, under the same
    fixed randomness."""
    out = []
    for pkg in PKGS:
        with fixed_randomness(k):
            out.append(fn(pkg))
    return out


def cfgs(pkg: str, **kw):
    config = mod(pkg, "config")
    return (config.FeaturizerConfig(**GEOMETRY),
            config.SamplingConfig(**kw))


def sample_view(s) -> dict:
    return {k: getattr(s, k) for k in SAMPLE_KEYS}


def track_view(t) -> dict:
    return {k: getattr(t, k) for k in TRACK_KEYS}


def rec_view(r) -> dict:
    return {
        "id": r.id, "location": r.location, "human_tags": r.human_tags,
        "signals": r.signals, "bin_id": r.bin_id,
        "tracks": [track_view(t) for t in r.tracks],
        "samples": [sample_view(s) for s in r.samples],
        "small_strides": [sample_view(s) for s in r.small_strides],
        "unused": [sample_view(s) for s in r.unused_samples],
    }


def ds_view(d) -> dict:
    return {
        "name": d.name, "labels": d.labels,
        "recs": {k: rec_view(r) for k, r in d.recs.items()},
        "samples": [sample_view(s) for s in d.samples],
        "counts": d.get_counts(),
        "rec_counts": d.get_rec_counts(),
    }


# ---------------------------------------------------------------------------
# raw corpora (the layout of tests/test_corpus.py's write_rec / make_meta)
# ---------------------------------------------------------------------------


def make_meta(rec_id, tracks, duration=10.0, location=None, signal=None):
    return {
        "id": rec_id,
        "duration": duration,
        "location": location,
        "signal": signal or [],
        "Tracks": [
            {
                "id": f"t{rec_id}_{i}",
                "start": t["start"],
                "end": t["end"],
                "tags": [{"what": t["what"], "automatic": False}],
                **t.get("extra", {}),
            }
            for i, t in enumerate(tracks)
        ],
    }


def write_rec(root, rec_id, tracks, duration=10.0, seed=0, freq=1000.0,
              **kw):
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    audio = (0.1 * rng.standard_normal(int(duration * SR))).astype(np.float32)
    for t in tracks:
        i0, i1 = int(t["start"] * SR), int(t["end"] * SR)
        tt = np.arange(i1 - i0) / SR
        audio[i0:i1] += np.sin(2 * np.pi * freq * tt).astype(np.float32)
    wavfile.write(str(root / f"{rec_id}.wav"), SR, audio)
    meta = make_meta(rec_id, tracks, duration, **kw)
    (root / f"{rec_id}.txt").write_text(json.dumps(meta))
    return meta


def rms_extra(rng, start, end) -> dict:
    """Band-RMS arrays at the enrichment's defaults (48 kHz, hop 281), a
    bump in the bird band: tightening picks its best 3 s."""
    n = int((end - start) * 48000 / 281)
    bird = 0.005 + 0.002 * rng.random(n)
    peak = int(rng.integers(0, max(n - 60, 1)))
    bird[peak:peak + 40] += 0.05 * np.hanning(40)[: n - peak]
    return {"bird_rms": bird.tolist(),
            "noise_rms": (0.004 + 0.002 * rng.random(n)).tolist(),
            "upper_rms": (0.003 + 0.001 * rng.random(n)).tolist()}


LABELS3 = ("kiwi", "morepork", "rain")


def write_build_corpus(root, n=9):
    """Nine 8 s recordings over three labels: bird tracks with RMS arrays
    and a frequency band, every third recording with an overlapping rain
    track, and signal spans above and below 1 kHz."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(5)
    for i in range(n):
        what = LABELS3[i % 3]
        start = 0.5 + 0.25 * (i % 2)
        end = start + 5.0
        extra = {"minFreq": 400.0 + 50 * i, "maxFreq": 2600.0}
        if what != "rain":
            extra.update(rms_extra(rng, start, end))
        tracks = [{"start": start, "end": end, "what": what, "extra": extra}]
        if i % 3 == 0:
            tracks.append({"start": 4.0, "end": 7.5, "what": "rain"})
        write_rec(root, f"rec{i}", tracks, duration=8.0, seed=i,
                  freq=700.0 + 300 * (i % 3),
                  location={"lat": -43.5 + i, "lng": 172.6},
                  signal=[[start + 0.5, start + 1.5, 1500],
                          [start + 2.0, start + 2.5, 800],
                          [start + 3.0, start + 3.8, 2200]])


def write_signal_tree(root):
    from scipy.io import wavfile

    rng = np.random.default_rng(1)
    for split, labels in (("train", ["kiwi", "kiwi", "rain"]),
                          ("validation", ["kiwi", "rain"])):
        d = root / split
        d.mkdir(parents=True)
        for i, label in enumerate(labels):
            audio = (0.1 * rng.standard_normal(4 * SR)).astype(np.float32)
            wavfile.write(str(d / f"{label}-{i}.wav"), SR, audio)


@pytest.fixture(scope="module")
def raw_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus_raw")
    write_build_corpus(root / "raw")
    # one full segment a track: load_data draws nothing, so spawned
    # workers (which do not see this process's patched generator) write
    # the same records as forked ones
    exact = root / "exact"
    exact.mkdir()
    for i in range(9):
        write_rec(exact, f"ex{i}",
                  [{"start": 1.0, "end": 4.0, "what": LABELS3[i % 3]}],
                  duration=6.0, seed=50 + i)
    write_signal_tree(root / "signals")
    return root


@pytest.fixture(scope="module")
def corpus30(tmp_path_factory):
    """tests/test_corpus.py's ``corpus`` fixture's raw directory."""
    root = tmp_path_factory.mktemp("corpus30")
    for i in range(30):
        write_rec(root, f"rec{i}",
                  [{"start": 0.5, "end": 5.5, "what": LABELS3[i % 3]}],
                  duration=8.0, seed=i)
    return root


def load30(pkg, root):
    _, sampling = cfgs(pkg, tighten_tracks=False, filter_rms=False)
    ds = mod(pkg, "corpus").AudioDataset("all", sampling, segment_length=3.0,
                                         segment_stride=1.0)
    ds.load_meta(root)
    return ds


# ---------------------------------------------------------------------------
# Track / Recording / helpers
# ---------------------------------------------------------------------------

TRACK_METAS = {
    "relabel": {"id": "t1", "start": 0, "end": 3,
                "tags": [{"what": "Great Spotted Kiwi", "automatic": False}]},
    "positions": {"id": "t1", "start": 0, "end": 3,
                  "tags": [{"what": "morepork", "automatic": False}],
                  "positions": [{"y": 0.1, "height": 0.2}]},
    "multi_tag": {"id": "x", "start": 0, "end": 1,
                  "tags": [{"what": "kiwi", "automatic": False},
                           {"what": "morepork", "automatic": False}]},
    "reject_tag": {"id": "x", "start": 0, "end": 1,
                   "tags": [{"what": "unidentified", "automatic": False}]},
    "automatic": {"id": "a", "start": 1, "end": 4,
                  "tags": [{"what": "tui", "automatic": True},
                           {"what": "rain", "automatic": False}]},
}


@pytest.mark.parametrize("case", sorted(TRACK_METAS))
def test_track_matches_jax(case):
    """Tags, eBird relabeling, the band from positions and ``filter_track``
    (tests/test_corpus.py's track cases)."""
    def run(pkg):
        ds = mod(pkg, "corpus.dataset")
        t = ds.Track(TRACK_METAS[case], "f.wav", "r1", None, tighten=False,
                     filter_rms=False)
        return track_view(t), ds.filter_track(t)

    want, got = both(run)
    assert got == want
    if case == "relabel":
        assert got[0]["human_tags"] == {"kiwi"} and not got[1]
    if case in ("multi_tag", "reject_tag"):
        assert got[1]


def _rec_meta(case):
    if case == "signal_percent":
        return make_meta("r3", [{"start": 0.0, "end": 4.0, "what": "kiwi"}],
                         signal=[[0.0, 2.0, 2000], [2.5, 3.0, 500]])
    if case == "missing_rms":
        return {"id": "r4", "Tracks": [{
            "id": "t", "start": 0, "end": 3,
            "tags": [{"what": "kiwi", "automatic": False}]}]}
    if case == "short_track":
        return make_meta("r2", [{"start": 1.0, "end": 3.0, "what": "kiwi"}])
    if case in ("overlap", "noise_trim"):
        second = ({"start": 2.0, "end": 9.0, "what": "morepork"}
                  if case == "overlap"
                  else {"start": 3.0, "end": 11.0, "what": "rain"})
        return make_meta("r5", [{"start": 0.5, "end": 8.5, "what": "kiwi"},
                                second], duration=12.0,
                         location=[{"lat": -41.2, "lng": 174.7}])
    return make_meta("r1", [{"start": 0.5, "end": 8.5, "what": "morepork"}])


@pytest.mark.parametrize("case,rng", [
    ("sampling_pools", 0), ("sampling_pools", None), ("short_track", 0),
    ("signal_percent", 0), ("missing_rms", 0), ("overlap", None),
    ("noise_trim", None)])
def test_recording_matches_jax(case, rng):
    """Sampling pools (used / small-stride / unused), the one-sample short
    track, signal percent, the RMS filter without RMS metadata, a second
    track's overlap (``do_overlap``) and a noise track trimmed around a
    bird track: every sample and track field equal."""
    def run(pkg):
        _, sampling = cfgs(pkg, tighten_tracks=False,
                           filter_rms=case == "missing_rms")
        rec = mod(pkg, "corpus").Recording(
            _rec_meta(case), f"{case}.wav", sampling, segment_length=3.0,
            segment_stride=1.0,
            rng=None if rng is None else np.random.default_rng(rng))
        view = rec_view(rec)
        if case == "overlap":
            view["overlap"] = [
                [sample_view(s) for s in pool]
                for pool in rec.get_samples(3.0, 1.0, do_overlap=True)]
        return view

    want, got = both(run)
    assert got == want
    if case == "sampling_pools":
        assert 1 <= len(got["samples"]) <= 4 and got["unused"]
        assert got["small_strides"]
    if case == "signal_percent":
        assert got["tracks"][0]["signal_percent"] == pytest.approx(0.5)
    if case == "missing_rms":
        assert got["tracks"][0]["rms_filtered"] and not got["samples"]


def test_recording_methods_match_jax():
    """``add_tracks``, ``recalc_tags``, ``space_signals``, ``load_samples``
    and ``signal_percent`` called on their own."""
    def run(pkg):
        ds = mod(pkg, "corpus.dataset")
        _, sampling = cfgs(pkg, tighten_tracks=False, filter_rms=False)
        meta = make_meta("r6", [{"start": 0.5, "end": 6.5, "what": "kiwi"}],
                         signal=[[0.5, 1.0, 1500], [1.05, 2.0, 1500],
                                 [4.0, 5.0, 3000]])
        rec = ds.Recording(meta, "r6.wav", sampling, load_samples=False)
        extra = [ds.Track(m, "r6.wav", "r6", rec, tighten=False,
                          filter_rms=False) for m in (
            {"id": "n", "start": 2, "end": 7,
             "tags": [{"what": "tui", "automatic": False}]},
            TRACK_METAS["multi_tag"], {**TRACK_METAS["multi_tag"],
                                       "id": "t0"})]
        rec.add_tracks(extra)
        rec.recalc_tags()
        rec.signal_percent()
        # merged spans keep (start, end) only, as in JAX: no signal_percent
        # after space_signals
        rec.space_signals(0.1)
        rec.load_samples(3.0, 1.0)
        return rec_view(rec)

    want, got = both(run)
    assert got == want
    assert len(got["signals"]) == 2  # the first two spans merged


@pytest.mark.parametrize("case", ["best_rms", "space_signals",
                                  "ensure_track_length", "remove_rms_noise"])
def test_helpers_match_jax(case):
    def run(pkg):
        ds = mod(pkg, "corpus.dataset")
        if case == "best_rms":
            rms = np.zeros(100)
            rms[40:60] = 1.0
            return ds.best_rms(rms, segment_length=3, sr=1000, hop_length=100)
        if case == "space_signals":
            return ds.space_signals([(0, 1), (1.05, 2), (5, 6)], spacing=0.1)
        if case == "ensure_track_length":
            return [ds.ensure_track_length(s, e, 1.5, track_end=6.0)
                    for s, e in ((5.0, 5.5), (0.1, 0.4), (2.0, 6.0))]
        import scipy.signal

        rng = np.random.default_rng(3)
        rms = rng.random(400) * 0.002
        noise = rng.random(400) * 0.002
        for arr in (rms, noise):
            arr[100:110] += 0.05
        peaks = [scipy.signal.find_peaks(a, threshold=1e-5, height=1e-3,
                                         width=2) for a in (rms, noise)]
        ds.remove_rms_noise(rms, *peaks[0], *peaks[1], [104])
        return rms.tolist()

    want, got = both(run)
    assert got == want
    if case == "space_signals":
        assert got == [(0, 2), (5, 6)]


# ---------------------------------------------------------------------------
# AudioDataset, split, balance
# ---------------------------------------------------------------------------


def test_dataset_load_meta_matches_jax(corpus30):
    want, got = both(lambda pkg: ds_view(load30(pkg, corpus30)))
    assert got == want
    assert len(got["recs"]) == 30
    assert got["labels"] == {"kiwi", "morepo2", "rain"}


@pytest.mark.parametrize("seed,no_test", [(0, False), (None, False),
                                          (1, True)])
def test_split_randomly_matches_jax(corpus30, seed, no_test):
    """Per-label bin-aware split: with a seed its own ``random.Random``,
    without one the global ``random`` (seeded the same on both sides)."""
    def run(pkg):
        ds = load30(pkg, corpus30)
        sets = mod(pkg, "corpus").split_randomly(ds, seed=seed,
                                                 no_test=no_test)
        mod(pkg, "corpus").validate_datasets(sets)
        return [ds_view(d) for d in sets] + [ds_view(ds)]

    want, got = both(run)
    assert got == want
    train, val, test = got[:3]
    assert len(train["samples"]) > len(val["samples"])
    assert bool(test["samples"]) is not no_test


@pytest.mark.parametrize("case", ["oversample", "oversample_repeat",
                                  "undersample"])
def test_balance_matches_jax(corpus30, case):
    """``oversample_ds`` from the unused / small-stride pools, its repeat
    pass for a label far under target, and ``undersample_ds``."""
    def run(pkg):
        corpus = mod(pkg, "corpus")
        _, sampling = cfgs(pkg, tighten_tracks=False, filter_rms=False)
        if case == "undersample":
            ds = corpus.AudioDataset("t", sampling)
            for i in range(12):
                meta = make_meta(f"r{i}", [{
                    "start": 0.5, "end": 7.5,
                    "what": "kiwi" if i < 10 else "rain"}])
                ds.add_recording(corpus.Recording(
                    meta, f"r{i}.wav", sampling,
                    rng=np.random.default_rng(i)))
            corpus.undersample_ds(ds)
            return [ds_view(ds)]
        ds = load30(pkg, corpus30)
        train = corpus.split_randomly(ds, seed=0)[0]
        if case == "oversample_repeat":
            # keep one kiwi recording: kiwi falls far under the target
            kiwi = [r for r in train.recs.values() if "kiwi" in r.human_tags]
            for rec in kiwi[1:]:
                train.remove_rec(rec)
        corpus.oversample_ds(ds, train)
        return [ds_view(train), ds_view(ds)]

    want, got = both(run)
    assert got == want
    if case == "undersample":
        assert got[0]["counts"]["kiwi"] < 40


# ---------------------------------------------------------------------------
# load_data, features, process_recording
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["window", "pad_short", "recentred",
                                  "constant", "store_spectrogram"])
def test_load_data_matches_jax(case):
    """One 3 s window; a short recording padded at a random offset; a
    short window re-centred inside the recording; a constant window
    refused; the stored magnitude STFT of the normalized clip."""
    frames = np.random.default_rng(0).standard_normal(SR * 10).astype(
        np.float32)

    def run(pkg):
        cfg, _ = cfgs(pkg)
        load_data = mod(pkg, "corpus").load_data
        if case == "constant":
            with pytest.raises(ValueError):
                load_data(cfg, 0.0, np.zeros(SR * 5, np.float32), SR)
            return None
        kw = {"window": dict(start_s=2.0, frames=frames),
              "pad_short": dict(start_s=0.0, frames=frames[:SR * 2], end=2.0),
              "recentred": dict(start_s=4.2, frames=frames, end=6.0),
              "store_spectrogram": dict(start_s=1.5, frames=frames,
                                        store_spectrogram=True)}[case]
        d = load_data(cfg, sr=SR, **kw)
        return d.raw, d.raw_length, d.spectogram

    want, got = both(run)
    if case == "constant":
        return
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    if case == "window":
        np.testing.assert_array_equal(got[0], frames[SR * 2:SR * 5])
    if case == "store_spectrogram":
        assert got[2].shape == want[2].shape == (257, 241)
        err = np.abs(got[2] - want[2]).max()
        assert err <= SPEC_REL * np.abs(want[2]).max(), err
    else:
        assert got[2] is want[2] is None


@pytest.mark.parametrize("signal", ["noise", "tone"])
def test_load_features_matches_jax(signal):
    """The numpy short / mid features (pyAudioAnalysis is not installed):
    3 s at 48 kHz -> (68, 60) and (136, 3), equal to JAX's."""
    sr = 48000
    if signal == "noise":
        sig = np.random.default_rng(0).standard_normal(sr * 3)
    else:
        sig = np.sin(2 * np.pi * 880 * np.arange(sr * 3) / sr)
    sig = sig.astype(np.float32)
    want, got = both(lambda pkg: mod(pkg, "corpus.features").load_features(
        sig, sr))
    assert got[0].shape == (68, 60) and got[1].shape == (136, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def assert_records_equal(got: list[bytes], want: list[bytes]) -> None:
    """Encoded records equal, the spectogram feature at SPEC_REL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g == w:
            continue
        fg, fw = decode_example(g), decode_example(w)
        assert fg.keys() == fw.keys()
        for key in fg:
            if key == SPECTOGRAM:
                a, b = fg[key].float_array(), fw[key].float_array()
                assert a.shape == b.shape
                assert np.abs(a - b).max() <= SPEC_REL * np.abs(b).max()
            else:
                assert bytes(fg[key]._payload) == bytes(fw[key]._payload), key


@pytest.mark.parametrize("case", ["plain", "add_features", "add_buttered",
                                  "bad_bounds", "store_spectrogram"])
def test_process_recording_matches_jax(raw_dirs, case):
    """One recording's records, bytes equal: plain, with the hand-crafted
    features, with the Butterworth band-passed variant (and with malformed
    bounds, which store none), and with the stored spectrogram."""
    def run(pkg):
        cfg, sampling = cfgs(pkg, tighten_tracks=False, filter_rms=False)
        rec = mod(pkg, "corpus").Recording(
            json.loads((raw_dirs / "raw" / "rec1.txt").read_text()),
            raw_dirs / "raw" / "rec1.wav", sampling)
        if case == "bad_bounds":
            for s in rec.samples:
                s.min_freq, s.max_freq = 3000.0, 2000.0
        return mod(pkg, "corpus.writer").process_recording(
            rec, cfg, store_spectrogram=case == "store_spectrogram",
            add_features=case == "add_features",
            add_buttered=case in ("add_buttered", "bad_bounds"))

    want, got = both(run)
    assert got
    assert_records_equal(got, want)
    feats = decode_example(got[0])
    assert ("audio/buttered" in feats) is (case == "add_buttered")
    assert ("audio/short_f" in feats) is (case == "add_features")


@pytest.mark.parametrize("workers", [1, 2])
def test_create_tf_records_return_matches_jax(corpus30, tmp_path, workers):
    """JAX's return values, quirk kept: the records written in-process, the
    recordings queued with worker processes (JAX's side always runs
    in-process here: its workers would fork this multithreaded process)."""
    def run(pkg):
        cfg, _ = cfgs(pkg)
        test = mod(pkg, "corpus").split_randomly(load30(pkg, corpus30),
                                                 seed=0)[2]
        n = mod(pkg, "corpus").create_tf_records(
            test, tmp_path / pkg, num_workers=1 if pkg == PKGS[0] else workers,
            shards_per_worker=1, cfg=cfg)
        records = sorted(bytes(r) for body in shard_streams(
            tmp_path / pkg).values() for r in split_records(body))
        return n, len(test.recs), len(test.samples), records

    (n_jax, recs, samples, want), (n, _, _, got) = both(run)
    assert n_jax == samples == len(want) == len(got)
    assert n == (samples if workers == 1 else recs) and recs < samples
    if workers == 1:  # spawned workers draw their own padding offsets
        assert got == want


# ---------------------------------------------------------------------------
# cli/build end to end
# ---------------------------------------------------------------------------


def shard_streams(data_dir) -> dict[str, bytes]:
    """{shard path under training-data: its decompressed bytes}."""
    return {str(p.relative_to(data_dir)): gzip.decompress(p.read_bytes())
            for p in sorted(data_dir.rglob("*.tfrecord"))}


def split_multisets(data_dir) -> dict[str, list[bytes]]:
    out: dict[str, list[bytes]] = {}
    for name, body in shard_streams(data_dir).items():
        out.setdefault(name.split("/")[0], []).extend(
            bytes(r) for r in split_records(body))
    return {k: sorted(v) for k, v in out.items()}


def files(root) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


BUILD_CASES = {
    "default": [],
    "no_rms": NO_RMS,
    "no_test": ["--no-test"],
    "split_file": NO_RMS + ["--split-file"],
    "balance": NO_RMS + ["--balance"],
    "add_features": ["--add-features"],
    "add_buttered": NO_RMS + ["--add-buttered"],
    "store_spectrogram": ["--store-spectrogram"],
    "workers2": NO_RMS + ["--workers", "2", "--shards-per-worker", "2"],
    "signal": ["--signal"],
    "create_signal_wavs": NO_RMS,
    "plot_signal": ["--plot-signal"],
}


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_cli_matches_jax(raw_dirs, tmp_path, case):
    """``cli/build`` of the port against the JAX package's on one raw
    directory: ``training-meta.json`` byte-identical and the decompressed
    record streams bitwise equal, shard by shard (the port's two workers'
    multiset against JAX's one); the signal exporter's WAVs and indexes and the signal-percent
    plots equal file by file."""
    src = raw_dirs / {"signal": "signals", "workers2": "exact"}.get(
        case, "raw")
    flags = list(BUILD_CASES[case])
    if case == "split_file":
        split = tmp_path / "split.json"
        split.write_text(json.dumps({"recs": {
            "train": ["rec0", "rec1", "rec2", "rec3", "rec4", "rec5"],
            "validation": ["rec6", "rec7"], "test": ["rec8", "nope"]}}))
        flags.append(str(split))
    if "--workers" not in flags:
        flags += ["--workers", "1"]

    def run(pkg):
        out = tmp_path / pkg
        argv = [str(out), "-d", str(src), *BUILD_GEOMETRY, *flags]
        if case == "workers2" and pkg == PKGS[0]:
            # JAX's writers fork from this multithreaded process (XLA's
            # threads), which may deadlock: its records come from the
            # in-process writer, the same multiset
            argv[argv.index("--workers") + 1] = "1"
        if case == "create_signal_wavs":
            argv += ["--create-signal-wavs", str(out / "signal-wavs")]
        assert mod(pkg, "cli.build").main(argv) == 0
        if case == "plot_signal":
            graphs = src / "signal-graphs"
            written = files(graphs)
            shutil.rmtree(graphs)
            return written
        if case == "create_signal_wavs":
            return files(out / "signal-wavs")
        return out / "training-data"

    want, got = both(run)
    if case in ("plot_signal", "create_signal_wavs"):
        assert got.keys() == want.keys() and got
        assert got == want
        return
    meta = (got / "training-meta.json").read_bytes()
    assert meta == (want / "training-meta.json").read_bytes()
    meta = json.loads(meta)
    if case == "workers2":
        assert split_multisets(got) == split_multisets(want)
    else:
        got_s, want_s = shard_streams(got), shard_streams(want)
        assert got_s.keys() == want_s.keys()
        for name in got_s:
            assert_records_equal(list(map(bytes, split_records(got_s[name]))),
                                 list(map(bytes, split_records(want_s[name]))))
    # the port's own reader streams what its build wrote
    from audio_training_tpu_torch.data import find_shards, read_tfrecords
    from audio_training_tpu_torch.data.schema import decode_sample

    for name, c in meta["counts"].items():
        records = [decode_sample(r) for shard in find_shards(got, name)
                   for r in read_tfrecords(shard)]
        assert len(records) == sum(c["sample_counts"].values())
        assert all(r.raw.size == 3 * SR for r in records)
    assert meta["counts"]["train"]["sample_counts"]
    if case == "no_test":
        assert not meta["counts"]["test"]["sample_counts"]
    if case == "split_file":
        assert meta["recs"] == {"train": [f"rec{i}" for i in range(6)],
                                "validation": ["rec6", "rec7"],
                                "test": ["rec8"]}
