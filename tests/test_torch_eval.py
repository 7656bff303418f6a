"""The port's evaluation and deployment host code against the JAX package's,
on the CPU: the inverse STFT and the spectral-gating denoise (f32, 1e-5 of
max |x|), the precision-recall curve (equal to scikit-learn's on random and
tied scores, which the JAX package calls), per-class thresholds, the
pre-model gate and the confusion compare (equal), the freeze's metadata
(equal), the eBird grid (the JSON equal but for its ``generated`` stamp,
the mask equal), the sidecar reader (tracks equal) and the plots.  The
JAX tests mirrored: tests/test_eval.py, tests/test_infer.py:222-330.
"""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from audio_training_tpu.corpus.dataset import Recording as JaxRecording
from audio_training_tpu.eval import compare as jcompare
from audio_training_tpu.eval import thresholds as jthresholds
from audio_training_tpu.infer import ebirdgrid as jgrid
from audio_training_tpu.infer.freeze import format_metadata as jax_format
from audio_training_tpu.infer.freeze import freeze as jax_freeze
from audio_training_tpu.ops.denoise import spectral_gate as jax_spectral_gate
from audio_training_tpu.ops.stft import istft_centered as jax_istft
from audio_training_tpu.ops.stft import stft_centered as jax_stft
from audio_training_tpu_torch.cli import ebirdgrid as cli_ebirdgrid
from audio_training_tpu_torch.cli import freeze as cli_freeze
from audio_training_tpu_torch.config import SamplingConfig
from audio_training_tpu_torch.corpus.dataset import (
    Recording,
    ensure_track_length,
    segment_overlap,
)
from audio_training_tpu_torch.eval import compare, plots, thresholds
from audio_training_tpu_torch.infer import ebirdgrid, format_metadata
from audio_training_tpu_torch.ops.denoise import spectral_gate
from audio_training_tpu_torch.ops.stft import istft_centered

from test_torch_corpus import fixed_randomness, rec_view

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
F32_TOL = 1e-5  # of max |x|


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# istft_centered and spectral_gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft,hop,length", [
    (512, 128, 8000), (2048, 512, 8000), (400, 160, 7999), (256, 128, 3000),
])
def test_istft_centered_matches_jax(n_fft, hop, length):
    """Overlapping windows (hop at most n_fft/2, as the denoise's 512 of
    2048): without overlap the division by the window-square sum, 2e-8 next
    to a frame's edge, scales both packages' f32 rounding by 1/w^2."""
    rng = np.random.default_rng(n_fft + hop)
    x = rng.standard_normal((2, length)).astype(np.float32)
    spec = np.asarray(jax_stft(x, n_fft, hop))
    got = istft_centered(torch.from_numpy(spec.copy()), n_fft, hop,
                         length).numpy()
    assert _rel(got, jax_istft(spec, n_fft, hop, length)) < F32_TOL
    assert _rel(got, x) < F32_TOL  # and reconstruct the input


@pytest.mark.parametrize("shape,kwargs", [
    ((1, 16000), {}),
    ((2, 12000), {"n_fft": 512, "hop": 128, "noise_frames": 8}),
    ((3, 9000), {"n_std": 0.5, "length": 8000}),
])
def test_spectral_gate_matches_jax(shape, kwargs):
    """Tones in noise with quiet stretches: the quietest frames' profile,
    the soft mask and the resynthesis; ties in frame energy (the silent
    tail) take JAX's stable order."""
    rng = np.random.default_rng(shape[1])
    t = np.arange(shape[1]) / 8000
    x = 0.05 * rng.standard_normal(shape)
    x += np.sin(2 * np.pi * 1000 * t) * (t % 1.0 < 0.4)
    x[:, -2000:] = 0.0
    x = x.astype(np.float32)
    want = np.asarray(jax_spectral_gate(x, **kwargs))
    got = spectral_gate(torch.from_numpy(x), **kwargs).numpy()
    assert got.shape == want.shape == (shape[0],
                                       kwargs.get("length", shape[1]))
    assert _rel(got, want) < F32_TOL


# ---------------------------------------------------------------------------
# thresholds and compare
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,tied", [(0, False), (1, True), (2, True),
                                       (3, False)])
def test_precision_recall_curve_matches_sklearn(seed, tied):
    from sklearn.metrics import precision_recall_curve

    rng = np.random.default_rng(seed)
    for n in (1, 2, 7, 60):
        y = rng.integers(0, 2, n)
        y[0] = 1
        score = (rng.integers(0, 4, n) / 3 if tied
                 else rng.random(n)).astype(np.float32)
        want = precision_recall_curve(y, score)
        got = thresholds.precision_recall_curve(y, score)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_best_thresholds_match_jax():
    """tests/test_eval.py::test_best_thresholds's separable scores plus a
    tied, a noisy and an empty class: the same thresholds as JAX's, whose
    curve is scikit-learn's, and the same decisions."""
    rng = np.random.default_rng(0)
    n = 400
    y_true = np.zeros((n, 5))
    y_true[: n // 2, 0] = 1
    y_true[n // 2 :, 1] = 1
    y_true[::3, 2] = 1
    y_true[::5, 3] = 1
    y_pred = np.where(y_true == 1, 0.8, 0.2) + 0.05 * rng.standard_normal(
        (n, 5))
    y_pred[:, 2] = np.round(y_pred[:, 2], 1)
    y_pred[:, 3] = rng.random(n)
    labels = ["a", "b", "c", "d", "e"]
    want = jthresholds.best_thresholds(y_true, y_pred, labels)
    got = thresholds.best_thresholds(y_true, y_pred, labels)
    assert got == want
    assert got["e"] == 0.9 and all(0.5 <= v <= 0.9 for v in got.values())
    decisions = thresholds.apply_thresholds(y_pred, labels, got)
    np.testing.assert_array_equal(
        decisions, jthresholds.apply_thresholds(y_pred, labels, want))
    assert (decisions[:, :2] == y_true[:, :2]).mean() > 0.9


def test_shipped_thresholds_and_pre_model_match_jax():
    for a, b in zip(thresholds.reference_shipped_thresholds(),
                    jthresholds.reference_shipped_thresholds()):
        np.testing.assert_array_equal(a, b)
    labels = [f"sp{i}" for i in range(67)]
    pre = [f"pre{i}" for i in range(6)]
    assert (thresholds.reference_shipped_thresholds_dict(labels, pre)
            == jthresholds.reference_shipped_thresholds_dict(labels, pre))
    with pytest.raises(ValueError):
        thresholds.reference_shipped_thresholds_dict(labels[:-1])
    species = np.array([[0.9, 0.8, 0.3], [0.9, 0.8, 0.6], [0.2, 0.1, 0.9]])
    gate = np.array([[0.1, 0.0, 0.9], [0.9, 0.0, 0.05], [0.1, 0.8, 0.1]])
    args = (species, ["kiwi", "tui1", "noise"], gate,
            ["bird", "human", "noise"])
    got = thresholds.combine_pre_model(*args)
    np.testing.assert_array_equal(got, jthresholds.combine_pre_model(*args))
    np.testing.assert_array_equal(got[0], [0, 0, 0.3])  # noise-gated


@pytest.mark.parametrize("case", ["winner", "extra_pre_labels", "skip",
                                  "totals"])
def test_compare_confusions_matches_jax(case):
    labels = ["kiwi", "rain", "bird", "noise"]
    rng = np.random.default_rng(4)
    first = rng.integers(0, 9, (5, 5))
    second = rng.permuted(first, axis=1)
    second_labels = labels
    if case == "extra_pre_labels":  # a matrix with bird/human/noise rows
        first = rng.integers(0, 9, (8, 8))
        second = rng.permuted(first, axis=1)
        labels = second_labels = ["kiwi", "rain", "morepo2", "insect"]
    elif case == "skip":
        labels = second_labels = ["kiwi", "human", "morepo2", "noise"]
    elif case == "totals":
        second = second.copy()
        second[0, 0] += 1
        for mod in (compare, jcompare):
            with pytest.raises(ValueError):
                mod.compare_confusions(first, labels, second, labels)
        return
    got = compare.compare_confusions(first, labels, second, second_labels)
    want = jcompare.compare_confusions(first, labels, second, second_labels)
    assert got.__dict__ == want.__dict__
    assert got.accuracy_diff_percent == want.accuracy_diff_percent
    assert got.incorrect_score_percent == want.incorrect_score_percent


# ---------------------------------------------------------------------------
# freeze
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label_paths", [False, True])
def test_format_metadata_and_freeze_match_jax(tmp_path, label_paths):
    """tests/test_infer.py's kiwi expansion and packaging: the port's
    metadata.txt equals JAX's; the weights file is copied (named first,
    chkpt.pt when absent) to audioModel.pt."""
    meta = {"ebird_labels": ["kiwi", "morepo2", "tui1", "noise"],
            "labels": ["kiwi", "morepo2", "tui1", "noise"],
            "remapped_labels": {"litowl1": 1, "rain": 3, "junk": -1,
                                "kiwi": 0, "tui1": 2}}
    got = format_metadata(json.loads(json.dumps(meta)))
    want = jax_format(json.loads(json.dumps(meta)))
    assert got == want
    assert "grskiw1" in got["ebird_ids"][0]
    assert "litowl1" in got["ebird_ids"][1]
    run = tmp_path / "run"
    (run / "val-loss").mkdir(parents=True)  # the JAX run's orbax dir
    (run / "val-loss" / "w.bin").write_bytes(b"weights")
    (run / "chkpt.pt").write_bytes(b"port weights")
    (run / "metadata.txt").write_text(json.dumps(meta))
    paths = None
    if label_paths:
        paths = tmp_path / "label_paths.json"
        paths.write_text(json.dumps({"morepork": "a/b", "tui": "c"}))
    jax_freeze(run, tmp_path / "jax", label_paths_file=paths)
    argv = [str(run), str(tmp_path / "port")]
    argv += ["--label-paths", str(paths)] if paths else []
    assert cli_freeze.main(argv) == 0
    got = json.loads((tmp_path / "port" / "metadata.txt").read_text())
    assert got == json.loads((tmp_path / "jax" / "metadata.txt").read_text())
    assert got["frozen"] is True
    assert (tmp_path / "port" / "audioModel.pt").read_bytes() == (
        b"port weights")


# ---------------------------------------------------------------------------
# eBird grid
# ---------------------------------------------------------------------------


def _grid_fixture(tmp_path):
    """tests/test_infer.py's two adjacent squares and a far one, as KML
    polygons, and an observations dump with an out-of-atlas sighting and an
    unknown bird."""
    bounds = [
        [174.1, -41.1, 174.2, -41.0],
        [174.0, -41.1, 174.1, -41.0],
        [175.0, -40.1, 175.1, -40.0],
    ]
    marks = "".join(
        f"<Placemark><Polygon><outerBoundaryIs><LinearRing><coordinates>"
        f"{b[0]},{b[1]},0 {b[2]},{b[1]},0 {b[2]},{b[3]},0 {b[0]},{b[3]},0 "
        f"{b[0]},{b[1]},0</coordinates></LinearRing></outerBoundaryIs>"
        f"</Polygon></Placemark>" for b in bounds)
    kml = tmp_path / "atlas.kml"
    kml.write_text('<?xml version="1.0"?><kml xmlns="http://www.opengis.net/'
                   f'kml/2.2"><Document>{marks}</Document></kml>')
    csv = tmp_path / "obs.tsv"
    csv.write_text("\n".join([
        "COMMON NAME\tLATITUDE\tLONGITUDE\tOBSERVATION DATE\tTYPE",
        "Morepork\t-41.05\t174.05\t2024-06-15\tP",
        "Morepork\t-41.05\t174.05\t2024-06-20\tP",
        "Tui\t-41.05\t174.15\t2024-01-10\tP",
        "Tui\t-38.0\t176.0\t2023-03-01\tP",
        "Not A Bird\t-41.05\t174.05\t2024-02-01\tP",
    ]))
    return kml, csv


def _without_stamp(meta):
    return {k: v for k, v in meta.items() if k != "generated"}


def test_species_grid_and_mask_match_jax(tmp_path):
    kml, csv = _grid_fixture(tmp_path)
    assert (ebirdgrid.read_kml_square_bounds(kml)
            == jgrid.read_kml_square_bounds(kml))
    regions = json.loads((REPO / "audio_training_tpu_torch" / "assets"
                          / "ebird_species.json").read_text())
    got = ebirdgrid.build_species_grid(csv, kml_path=kml, region_meta=regions)
    want = jgrid.build_species_grid(csv, kml_path=kml, region_meta=regions)
    assert _without_stamp(got) == _without_stamp(want)
    grid = got["grid_meta"]
    assert len(grid) == 4  # the out-of-atlas sighting adds a square
    assert grid[0]["species_per_month"]["morepo2"]["6"] == 2
    labels = ["morepo2", "tui1", "kiwi", "bird", "noise"]
    probs = np.linspace(0.1, 0.9, 5).astype(np.float32)
    for lat, lng, month in ((-41.05, 174.05, 6), (-41.05, 174.05, None),
                            (-41.05, 174.15, 1), (-40.05, 175.05, 3),
                            (0.0, 10.0, None)):
        assert (ebirdgrid.species_at(got, lat, lng, month)
                == jgrid.species_at(want, lat, lng, month))
        np.testing.assert_array_equal(
            ebirdgrid.apply_species_mask(probs, labels, got, lat, lng, month),
            jgrid.apply_species_mask(probs, labels, want, lat, lng, month))
    np.testing.assert_array_equal(
        ebirdgrid.apply_species_mask(np.ones(5, np.float32), labels, got,
                                     -41.05, 174.05, 6), [1, 0, 0, 1, 1])
    assert ebirdgrid.add_ebird(got, -40.05, 175.05, "kiwi", True)
    assert jgrid.add_ebird(want, -40.05, 175.05, "kiwi", True)
    assert _without_stamp(got) == _without_stamp(want)
    assert ebirdgrid.binary_grid_search(grid, 10.0, 0.0) is None
    assert ebirdgrid.merge_neighbours(grid[0], grid) == jgrid.merge_neighbours(
        want["grid_meta"][0], want["grid_meta"])


def test_ebirdgrid_cli_matches_jax(tmp_path, capsys):
    """Build, patch and query through both CLIs."""
    from audio_training_tpu.cli import ebirdgrid as jax_cli

    kml, csv = _grid_fixture(tmp_path)
    outs = {}
    for name, cli in (("port", cli_ebirdgrid), ("jax", jax_cli)):
        out = tmp_path / f"{name}.json"
        assert cli.main([str(csv), "--kml", str(kml), "--out", str(out)]) == 0
        assert cli.main(["--grid", str(out), "--ebird", "kiwi", "--lat",
                         "-41.05", "--lng", "174.15"]) == 0
        capsys.readouterr()
        assert cli.main(["--grid", str(out), "--query", "--lat", "-41.05",
                         "--lng", "174.05"]) == 0
        outs[name] = (_without_stamp(json.loads(out.read_text())),
                      capsys.readouterr().out)
        assert cli.main(["--grid", str(out), "--ebird", "kiwi", "--lat",
                         "0", "--lng", "0"]) == 1
        assert cli.main([str(csv)]) == 1  # no --kml
    assert outs["port"] == outs["jax"]
    assert outs["port"][1].split() == ["kiwi", "morepo2", "tui1"]


# ---------------------------------------------------------------------------
# sidecars
# ---------------------------------------------------------------------------


def _sidecar():
    rng = np.random.default_rng(6)
    rms = rng.uniform(0.0, 0.02, 600)
    rms[200:260] += 0.3  # a call
    noise = rng.uniform(0.0, 0.01, 600)
    noise[202:258] += 0.3  # and broadband noise at the same time
    return {
        "id": 17, "deviceId": 3, "duration": 20.0,
        "location": [{"lat": -41.1, "lng": 174.8}],
        "Tracks": [
            {"id": 1, "start": 1.0, "end": 4.0, "tags": [{"what": "kiwi"}],
             "positions": [{"y": 0.1, "height": 0.3}]},
            {"id": 2, "start": 2.0, "end": 9.0,
             "tags": [{"what": "morepork"}], "minFreq": 300, "maxFreq": 900,
             "bird_rms": rms.tolist(), "noise_rms": noise.tolist(),
             "upper_rms": noise.tolist()},
            {"id": 3, "start": 5.0, "end": 6.0,
             "tags": [{"what": "kiwi"}, {"what": "tui"}]},  # multi-tag
            {"id": 4, "start": 7.0, "end": 8.0,
             "tags": [{"what": "unidentified"}]},  # reject-listed
            {"id": 5, "start": 9.0, "end": 12.0,
             "tags": [{"what": "rain"}, {"what": "rain", "automatic": True}]},
            {"id": 6, "start": 3.0, "end": 3.4,
             "tags": [{"what": "Grey Kiwi"}]},
        ],
    }


@pytest.mark.parametrize("tighten,filter_rms", [(False, True), (True, True),
                                                (True, False)])
def test_recording_tracks_match_jax(tighten, filter_rms):
    """Tags, eBird ids, relabeling, the frequency band from positions, the
    filters and the RMS tightening read as JAX's ``Recording`` reads them
    (``load_samples=False``, the strong evaluation's reader); with
    ``load_samples=True`` the samples too."""
    from audio_training_tpu.config import SamplingConfig as JaxSampling

    meta = _sidecar()
    got = Recording(meta, "r.wav", SamplingConfig(
        tighten_tracks=tighten, filter_rms=filter_rms), load_samples=False)
    want = JaxRecording(meta, "r.wav", JaxSampling(
        tighten_tracks=tighten, filter_rms=filter_rms), load_samples=False)
    assert (got.id, got.location, got.human_tags) == (
        want.id, want.location, want.human_tags)
    keys = ("id", "start", "end", "og_start", "og_end", "min_freq",
            "max_freq", "human_tags", "automatic_tags", "original_tags",
            "human_text_tags", "bird_track", "noise_track", "animal_track",
            "rms_filtered", "tag", "bin_id")
    assert len(got.tracks) == len(want.tracks) == 4
    for g, w in zip(got.tracks, want.tracks):
        assert {k: getattr(g, k) for k in keys} == {
            k: getattr(w, k) for k in keys}
    if tighten:
        assert got.tracks[1].start != 2.0  # moved to the best 3 s
    # with its samples (load_samples=True), under the same fixed randomness
    with fixed_randomness(0):
        got = Recording(meta, "r.wav", None)
    with fixed_randomness(0):
        want = JaxRecording(meta, "r.wav", None)
    assert rec_view(got) == rec_view(want)
    assert got.samples


def test_span_helpers_match_jax():
    from audio_training_tpu.corpus import dataset as jdataset

    for a, b in (((0, 3), (2, 5)), ((0, 1), (2, 3)), ((1, 4), (0, 9))):
        assert segment_overlap(a, b) == jdataset.segment_overlap(a, b)
    for span in ((1.0, 1.5), (0.1, 0.4), (2.0, 6.0)):
        assert ensure_track_length(
            *span, 1.5, 5.0, np.random.default_rng(1)) == (
            jdataset.ensure_track_length(
                *span, 1.5, 5.0, np.random.default_rng(1)))


# ---------------------------------------------------------------------------
# plots, and running without scikit-learn or matplotlib
# ---------------------------------------------------------------------------


def test_plot_helpers_write_files(tmp_path):
    """tests/test_eval.py's plot cases, through the port's module."""
    from audio_training_tpu_torch.detect import Signal

    rng = np.random.default_rng(0)
    mel = rng.uniform(0, 1, (40, 100)).astype(np.float32)
    written = [tmp_path / "mel.png", tmp_path / "sig.png",
               tmp_path / "wave.png"]
    plots.plot_mel(mel, written[0])
    plots.plot_mel_signals(mel, [Signal(0.5, 1.5, 800, 2000, 1)],
                           path=written[1])
    plots.plot_waveform(rng.standard_normal(8000).astype(np.float32), 8000,
                        written[2])
    tracks = [SimpleNamespace(signal_percent=0.8, human_tags={"kiwi"}),
              SimpleNamespace(signal_percent=0.3, human_tags={"kiwi", "rain"}),
              SimpleNamespace(signal_percent=None, human_tags={"rain"})]
    dataset = SimpleNamespace(recs={"r1": SimpleNamespace(tracks=tracks)})
    written += plots.plot_signal_percent(dataset, tmp_path)
    meta = tmp_path / "rec.txt"
    meta.write_text(json.dumps({"Tracks": [
        {"bird_rms": [0.1, 0.2, 0.05], "noise_rms": [0.0, 0.01, 0.02]},
        {"start": 1}]}))
    written += plots.plot_track_rms(meta)
    assert [p.name for p in written[3:]] == ["kiwi.png", "rain.png",
                                             "rec-t0-rms.png"]
    assert all(p.stat().st_size > 500 for p in written)


_BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("sklearn", "matplotlib"):
            raise ImportError(f"No module named {name!r}")
sys.meta_path.insert(0, Block())
"""


def test_thresholds_cli_runs_without_sklearn_or_matplotlib(tmp_path):
    """``cli/evaluate thresholds`` in an interpreter where neither package
    imports writes JAX's thresholds for the same raw dump; a plot there
    raises an ImportError naming matplotlib."""
    from audio_training_tpu_torch.eval.confusion import save_raw_predictions

    rng = np.random.default_rng(2)
    labels = ["kiwi", "tui1", "noise"]
    y_true = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 90)]
    y_pred = np.clip(y_true * 0.6 + 0.4 * rng.random((90, 3)), 0, 1).astype(
        np.float32)
    raw = save_raw_predictions(tmp_path / "conf", labels, y_pred, y_true)
    out = tmp_path / "thr.json"
    code = _BLOCK + (
        "from audio_training_tpu_torch.cli import evaluate\n"
        f"assert evaluate.main(['thresholds', {str(raw)!r}, '--out', "
        f"{str(out)!r}]) == 0\n"
        "from audio_training_tpu_torch.eval import plots\n"
        "try:\n    plots.plot_waveform([0.0], 1)\n"
        "except ImportError as e:\n    assert 'matplotlib' in str(e)\n"
        "else:\n    raise SystemExit('plotted without matplotlib')\n"
        "assert not {'sklearn', 'matplotlib'} & set(m.split('.')[0] for m "
        "in sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    want = jthresholds.best_thresholds(y_true, y_pred, labels)
    assert json.loads(out.read_text()) == want
