"""The port's corpus ingestion and acquisition (``corpus/otherdata.py``,
``corpus/tools.py``, ``corpus/downloaders.py`` and ``cli/ingest.py``)
against the JAX package's on the same inputs: the cases of
tests/test_aux.py:97-283, :485-570 and :643-749, each run through both
packages into a directory of its own.

Written files are compared byte for byte (sidecars with each package's
directory replaced by one token, where a field names a path).  Random
draws come from generators seeded alike on both sides.  The downloaders
run against a stand-in HTTP session: nothing is fetched.
"""

import csv
import importlib
import json

import numpy as np
import pytest

PKGS = ("audio_training_tpu", "audio_training_tpu_torch")
SR = 8000


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def tone_wav(path, freq=1000, dur=4.0, sr=SR, noise=0.02, seed=0):
    from audio_training_tpu_torch.corpus.audioio import save_wav

    rng = np.random.default_rng(seed)
    t = np.arange(int(dur * sr)) / sr
    x = np.sin(2 * np.pi * freq * t).astype(np.float32)
    x += noise * rng.standard_normal(len(x)).astype(np.float32)
    save_wav(path, x, sr)
    return x


def tree(d) -> dict[str, bytes]:
    """Every file under ``d``, its directory's path replaced by a token."""
    return {str(p.relative_to(d)): p.read_bytes().replace(
        str(d).encode(), b"<dir>")
        for p in sorted(d.rglob("*")) if p.is_file()}


def run_both(tmp_path, write, run):
    """``write(d)`` then ``run(pkg, d)`` in one directory a package;
    returns ``[(result, files)]`` for JAX, then the port."""
    out = []
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        write(d)
        out.append((run(pkg, d), tree(d)))
    return out


def assert_same(results):
    (want, want_files), (got, got_files) = results
    assert got == want
    assert got_files.keys() == want_files.keys()
    for name in got_files:
        assert got_files[name] == want_files[name], name
    return got, got_files


# ---------------------------------------------------------------------------
# external corpora
# ---------------------------------------------------------------------------


def test_csv_dataset_matches_jax(tmp_path):
    def write(d):
        (d / "audio").mkdir()
        tone_wav(d / "audio" / "a.wav")
        tone_wav(d / "audio" / "b.wav", freq=500, dur=2.5)
        (d / "audio" / "c.wav").write_bytes(b"not a wav")
        (d / "meta.csv").write_text(
            "filename,category\na.wav,rain\nb.wav,wind\nc.wav,x\nz.wav,y\n")

    def run(pkg, d):
        otherdata = mod(pkg, "corpus.otherdata")
        return (otherdata.csv_dataset(d / "meta.csv", d / "audio", d / "out"),
                otherdata.csv_dataset(d / "meta.csv", d / "audio", d / "out2",
                                      copy_audio=False, id_prefix="esc"))

    got, files = assert_same(run_both(tmp_path, write, run))
    assert got == (2, 2)
    meta = json.loads(files["out/a.txt"])
    assert meta["Tracks"][0]["tags"][0]["what"] == "rain"


def test_tier1_data_matches_jax(tmp_path):
    def write(d):
        (d / "audio").mkdir()
        tone_wav(d / "audio" / "x.wav", dur=6.0)
        tone_wav(d / "audio" / "y.wav", dur=3.0, seed=1)
        (d / "ann.csv").write_text(
            "Filename,Label,Starttime,Endtime\n"
            "x.wav,kiwi,1.0,2.5\nx.wav,kiwi,4.0,5.0\ny.wav,tui,0.5,1\n"
            "gone.wav,tui,0,1\n")

    def run(pkg, d):
        return mod(pkg, "corpus.otherdata").tier1_data(
            d / "ann.csv", d / "audio", d / "out")

    got, files = assert_same(run_both(tmp_path, write, run))
    assert got == 2
    meta = json.loads(files["out/x.txt"])
    assert len(meta["Tracks"]) == 2 and meta["Tracks"][0]["start"] == 1.0


def test_folder_dataset_matches_jax(tmp_path):
    def write(d):
        for label, n in (("kiwi", 2), ("rain", 1)):
            (d / label).mkdir()
            for i in range(n):
                tone_wav(d / label / f"a{i}.wav", dur=1.5 + i, seed=i)
        (d / "kiwi" / "notes.md").write_text("skip")
        (d / "stray.wav").write_bytes(b"")

    def run(pkg, d):
        return mod(pkg, "corpus.otherdata").folder_dataset(d)

    got, files = assert_same(run_both(tmp_path, write, run))
    assert got == 3
    assert json.loads(files["kiwi/a0.txt"])["Tracks"][0]["tags"][0][
        "what"] == "kiwi"


def test_flickr_data_matches_jax(tmp_path):
    def write(d):
        (d / "wavs").mkdir()
        tone_wav(d / "wavs" / "s1.wav", freq=300, dur=2.0)
        tone_wav(d / "wavs" / "s2.wav", freq=400, dur=3.0)
        (d / "wavs" / "notes.csv").write_text("not audio\n")

    def run(pkg, d):
        return mod(pkg, "corpus.otherdata").flickr_data(d)

    got, files = assert_same(run_both(tmp_path, write, run))
    assert got == 2
    meta = json.loads(files["wavs/s1.txt"])
    assert meta["id"] == "flickr-s1"
    assert meta["Tracks"][0]["tags"][0]["what"] == "human"


def test_chime_data_matches_jax(tmp_path):
    def write(d):
        (d / "chunks").mkdir()
        for i, f in enumerate((600, 700, 800)):
            tone_wav(d / "chunks" / f"chunk{i + 1}.wav", freq=f, seed=i)
        (d / "chunks.csv").write_text(
            "chunk1,cv\nchunk2,zz\nchunk3,m\nchunk4,c\nshort\n")

    def run(pkg, d):
        otherdata = mod(pkg, "corpus.otherdata")
        return (otherdata.chime_data(d / "chunks.csv", d / "chunks"),
                otherdata.chime_data(d / "chunks.csv", d / "chunks",
                                     id_prefix="c2", label_map={"z": "wind"}))

    got, files = assert_same(run_both(tmp_path, write, run))
    assert got == (2, 1)
    whats = sorted(t["tags"][0]["what"] for t in json.loads(
        files["chunks/chunk3.txt"])["Tracks"])
    assert "chunks/chunk2.txt" in files and whats == ["human"]


@pytest.mark.parametrize("snr", [10.0, (3.0, 30.0)])
@pytest.mark.parametrize("noise_len", [SR // 2, 3 * SR])
def test_mix_noise_matches_jax(snr, noise_len):
    """Bitwise with the same seeded generator on both sides, at a fixed
    SNR and a drawn one, with the noise tiled or cut; the mixed SNR as
    asked (test_aux.py:202-212)."""
    sig = np.sin(2 * np.pi * 440 * np.arange(SR) / SR).astype(np.float32)
    noise = np.random.default_rng(0).standard_normal(noise_len).astype(
        np.float32)
    want, got = (mod(pkg, "corpus.otherdata").mix_noise(
        sig, noise, snr_db=snr, rng=np.random.default_rng(5)) for pkg in PKGS)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.shape == sig.shape
    if snr == 10.0:
        added = got - sig
        assert 10 * np.log10((sig**2).mean() / (added**2).mean()) == \
            pytest.approx(10.0, abs=1.0)


def test_make_noise_mixed_copies_matches_jax(tmp_path):
    def write(d):
        for name in ("audio", "noise"):
            (d / name).mkdir()
        tone_wav(d / "audio" / "a.wav", dur=2.0)
        tone_wav(d / "audio" / "b.wav", dur=1.0, seed=2)
        (d / "audio" / "a.txt").write_text(json.dumps({"id": "ra"}))
        tone_wav(d / "noise" / "n0.wav", freq=3000, dur=0.5, noise=0.5, seed=3)
        tone_wav(d / "noise" / "n1.wav", freq=200, dur=3.0, noise=0.8, seed=4)

    def run(pkg, d):
        otherdata = mod(pkg, "corpus.otherdata")
        return (otherdata.make_noise_mixed_copies(
            d / "audio", d / "noise", d / "mixed", per_file=2,
            target_sr=SR, seed=7),
            otherdata.make_noise_mixed_copies(d / "audio", d / "none",
                                              d / "empty"))

    got, files = assert_same(run_both(tmp_path, write, run))
    assert got == (4, 0)
    assert json.loads(files["mixed/a-noise1.txt"])["id"] == "ra-noise1"


def test_redo_csv_matches_jax(tmp_path):
    def write(d):
        (d / "a").mkdir()
        tone_wav(d / "a" / "x.wav", dur=2.0)
        tone_wav(d / "a" / "y.wav", dur=1.25, seed=1)
        (d / "in.csv").write_text(
            "filename,label,quality\nx.wav,kiwi,good\ny.wav,tui,bad\n")
        (d / "bad.csv").write_text("filename,label\nmissing.wav,kiwi\n")

    def run(pkg, d):
        otherdata = mod(pkg, "corpus.otherdata")
        n = otherdata.redo_csv(d / "in.csv", d / "a", d / "out.csv")
        with pytest.raises(FileNotFoundError):
            otherdata.redo_csv(d / "bad.csv", d / "a", d / "out2.csv")
        return n

    got, files = assert_same(run_both(tmp_path, write, run))
    assert got == 2
    cols = files["out.csv"].decode().splitlines()[1].split(",")
    assert abs(float(cols[3]) - 2.0) < 0.01


# ---------------------------------------------------------------------------
# tools
# ---------------------------------------------------------------------------


def test_split_audio_files_matches_jax(tmp_path):
    def write(d):
        (d / "in").mkdir()
        tone_wav(d / "in" / "long.wav", dur=10.0)
        tone_wav(d / "in" / "tail.wav", dur=8.5, seed=1)
        (d / "in" / "long.txt").write_text(json.dumps({"id": "long"}))

    def run(pkg, d):
        return mod(pkg, "corpus.tools").split_audio_files(
            d / "in", d / "chunks", chunk_seconds=4.0)

    got, files = assert_same(run_both(tmp_path, write, run))
    assert got == 5  # 4+4+2 and 4+4 (the 0.5 s tail skipped)
    assert json.loads(files["chunks/long-001.txt"])["chunk_start"] == 4.0


def test_export_anonymized_metadata_matches_jax(tmp_path):
    metas = [
        {"id": "r1", "deviceId": 42, "groupId": 7, "duration": 10,
         "location": {"lat": -41.2865, "lng": 174.7762},
         "Tracks": [{"start": 0, "end": 2, "tags": [{"what": "kiwi"}]}]},
        {"id": "r2", "deviceId": 42, "location": [{"lat": -36.9, "lng": 1}],
         "tracks": [{"start": 1, "end": 3, "tags": []}]},
    ]

    def write(d):
        (d / "c").mkdir()
        for m in metas:
            (d / "c" / f"{m['id']}.txt").write_text(json.dumps(m))
        (d / "c" / "broken.txt").write_text("{")

    def run(pkg, d):
        return mod(pkg, "corpus.tools").export_anonymized_metadata(
            d / "c", d / "anon")

    got, files = assert_same(run_both(tmp_path, write, run))
    assert got == 2
    anon = json.loads(files["anon/r1.json"])
    assert anon["location"]["lat"] == pytest.approx(-41.3)
    assert len(anon["device_uid"]) == 12


def test_audio_database_reads_jax_writes(tmp_path):
    """One store written by each package and read by the other."""
    jtools, ttools = (mod(pkg, "corpus.tools") for pkg in PKGS)
    frames = np.arange(100, dtype=np.float32)
    path = tmp_path / "recs.h5"
    assert not ttools.AudioDatabase(path).has_rec("r1")
    ttools.AudioDatabase(path).add_rec("r1", frames, SR, {"label": "kiwi"})
    jtools.AudioDatabase(path).add_rec("r2", frames * 2, 16000)
    for tools in (jtools, ttools):
        db = tools.AudioDatabase(path)
        assert db.has_rec("r1") and db.has_rec("r2")
        got, sr, meta = db.get_rec("r1")
        np.testing.assert_array_equal(got, frames)
        assert sr == SR and meta == {"label": "kiwi"}
        got, sr, meta = db.get_rec("r2")
        np.testing.assert_array_equal(got, frames * 2)
        assert sr == 16000 and meta == {}


@pytest.mark.parametrize("package", ["h5py", "filelock"])
def test_audio_database_names_a_missing_package(tmp_path, monkeypatch,
                                                package):
    """The card's image has neither package: the store raises an
    ImportError that names it, and only when it is used."""
    import sys

    from audio_training_tpu_torch.corpus.tools import AudioDatabase

    monkeypatch.setitem(sys.modules, package, None)
    db = AudioDatabase(tmp_path / "x.h5")
    assert not db.has_rec("r")  # no file: nothing imported
    with pytest.raises(ImportError, match=package):
        db.add_rec("r", np.zeros(4, np.float32), SR)


def test_label_tools_match_jax():
    cm = np.array([[8, 2], [1, 9]])
    paths = {"North Island Brown Kiwi": 1, "morepork": 2}

    def run(pkg):
        tools = mod(pkg, "corpus.tools")
        return (tools.label_set_diff(["a", "b"], ["b", "c"]),
                tools.labels_to_api_names(["morepo2", "nibkiw1", "zzz"]),
                tools.labels_to_api_names(["nibkiw1"], paths),
                tools.counts_vs_accuracy(["x", "y", "z"], {"x": 100}, cm))

    want, got = (run(pkg) for pkg in PKGS)
    assert got == want
    assert got[0] == {"only_first": ["a"], "only_second": ["c"],
                      "common": ["b"]}
    assert got[3][0]["accuracy"] == 0.8 and got[3][2]["accuracy"] is None


# ---------------------------------------------------------------------------
# downloaders, with a stand-in session
# ---------------------------------------------------------------------------


class _FakeResp:
    def __init__(self, payload=None, content=b"", ok=True):
        self._payload = payload
        self.content = content
        self.ok = ok

    def json(self):
        return self._payload

    def raise_for_status(self):
        pass


class _FakeSession:
    """Minimal requests.Session stand-in: routes by URL prefix."""

    def __init__(self, routes):
        self.routes = routes
        self.calls = []

    def get(self, url, params=None, headers=None, timeout=None):
        self.calls.append((url, params, headers, timeout))
        for prefix, resp in self.routes:
            if url.startswith(prefix):
                return resp(url, params) if callable(resp) else resp
        raise AssertionError(f"unrouted URL {url}")


def _xeno_rec(i, with_file=True):
    r = {"id": str(i), "en": "Morepork", "gen": "Ninox",
         "sp": "novaeseelandiae", "q": "A", "length": "0:12",
         "lat": "-36.1", "lng": "174.2", "file-name": f"{i}.mp3"}
    if with_file:
        r["file"] = f"https://dl.test/{i}.mp3"
    return r


def _xeno_api(url, params):
    assert params["query"] == "morepork"
    if params["page"] == 1:
        return _FakeResp({"numPages": 2, "recordings": [
            _xeno_rec(11), _xeno_rec(12, False)]})
    return _FakeResp({"numPages": 2, "recordings": [_xeno_rec(13)]})


def test_download_xeno_canto_matches_jax(tmp_path):
    """test_aux.py:672-720: sidecars with the weak label, file-less
    entries skipped, pagination, the cutoff, existing files kept; the
    same requests in the same order."""
    def run(pkg, d):
        dl = mod(pkg, "corpus.downloaders")
        out = []
        for limit, content in ((5, b"MP3DATA"), (1, b"X")):
            session = _FakeSession([
                (dl.XENO_API, _xeno_api),
                ("https://dl.test/", _FakeResp(content=content))])
            out.append((dl.download_xeno_canto("morepork", d, limit,
                                               session=session),
                        session.calls))
        return out

    got, files = assert_same(run_both(tmp_path, lambda d: None, run))
    assert [n for n, _ in got] == [2, 1]
    assert files["xc11.mp3"] == b"MP3DATA"
    meta = json.loads(files["xc11.txt"])
    assert meta["scientific"] == "Ninox novaeseelandiae"
    assert meta["Tracks"] == [] and "xc13.mp3" in files


def test_download_ebird_species_lists_matches_jax(tmp_path):
    def api(url, params):
        if "/product/spplist/" in url:
            return _FakeResp(["kiwi1", "morepo2"])
        if url.endswith("NZ-CAN"):
            return _FakeResp(None, ok=False)
        return _FakeResp({"bounds": {"minX": 166.0, "minY": -47.5,
                                     "maxX": 179.0, "maxY": -34.0}})

    def run(pkg, d):
        dl = mod(pkg, "corpus.downloaders")
        session = _FakeSession([(dl.EBIRD_API, api)])
        out = dl.download_ebird_species_lists(
            "TESTKEY", d / "ebird_species.json",
            regions=["NZ-AUK", "NZ-CAN"], session=session)
        return out, session.calls, dl.NZ_REGIONS

    got, files = assert_same(run_both(tmp_path, lambda d: None, run))
    out, calls, _ = got
    assert all(h["X-eBirdApiToken"] == "TESTKEY" for _, _, h, _ in calls)
    data = json.loads(files["ebird_species.json"])
    assert data == out["regions"]
    assert data[0]["bounds"] == [166.0, -47.5, 179.0, -34.0]
    assert data[1]["bounds"] is None


def test_downloaders_import_requests_only_without_a_session():
    import ast
    from pathlib import Path

    src = Path(mod(PKGS[1], "corpus.downloaders").__file__).read_text()
    top = [n for n in ast.parse(src).body
           if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any("requests" in ast.dump(n) for n in top)


# ---------------------------------------------------------------------------
# cli/ingest
# ---------------------------------------------------------------------------


def _write_ingest_inputs(d):
    from audio_training_tpu_torch.corpus.audioio import save_wav

    (d / "audio").mkdir()
    tone_wav(d / "audio" / "a.wav", freq=700, dur=2.0)
    t = np.arange(5 * SR) / SR
    burst = (0.5 * np.sin(2 * np.pi * 1300 * t) * ((t % 2.5) < 1.2)
             + 0.005 * np.random.default_rng(1).standard_normal(len(t)))
    save_wav(d / "audio" / "b.wav", burst.astype(np.float32), SR)
    with open(d / "meta.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerows([["filename", "category"], ["a.wav", "rain"],
                      ["b.wav", "morepork"]])
    with open(d / "tier1.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerows([["Filename", "Label", "Starttime", "Endtime"],
                     ["a.wav", "kiwi", "0.2", "1.5"]])
    (d / "chime.csv").write_text("a,cv\nb,m\n")
    (d / "folders" / "kiwi").mkdir(parents=True)
    tone_wav(d / "folders" / "kiwi" / "k.wav", dur=1.5, seed=3)
    (d / "noise").mkdir()
    tone_wav(d / "noise" / "n.wav", freq=100, dur=1.0, noise=0.5, seed=4)


INGEST_RUNS = {
    "csv": (["--csv", "--csv-file", "{d}/meta.csv", "--out", "{d}/out"], 0),
    "csv_no_file": (["--csv", "--out", "{d}/out"], 1),
    "csv_no_out": (["--csv", "--csv-file", "{d}/meta.csv"], 1),
    "tier1": (["--tier1", "--csv-file", "{d}/tier1.csv", "--out",
               "{d}/t1"], 0),
    "tier1_no_out": (["--tier1", "--csv-file", "{d}/tier1.csv"], 1),
    "flickr": (["--flickr"], 0),
    "folder": (["--folder"], 0),
    "chime": (["--chime", "--csv-file", "{d}/chime.csv"], 0),
    "chime_no_file": (["--chime"], 1),
    "noise": (["--noise-dir", "{d}/noise", "--out", "{d}/mixed",
               "--per-file", "2"], 0),
    "noise_no_out": (["--noise-dir", "{d}/noise"], 1),
    "enrich": (["--signal", "--rms", "--tracks"], 0),
    "gen_tracks": (["--gen-tracks"], 0),
    "no_mode": ([], 1),
}


def _ingest_dir(case: str) -> str:
    if case == "folder":
        return "{d}/folders"
    return "{d}/out" if case in ("enrich", "gen_tracks") else "{d}/audio"


@pytest.mark.parametrize("case", sorted(INGEST_RUNS))
def test_ingest_cli_matches_jax(tmp_path, case):
    """Each mode and flag of ``cli/ingest`` through both packages: the exit
    code (1 for a missing mode or a missing required flag,
    cli/ingest.py:79-82 and :113-117) and every file written."""
    flags, code = INGEST_RUNS[case]

    def run(pkg, d):
        main = mod(pkg, "cli.ingest").main
        if case in ("enrich", "gen_tracks"):  # over an ingested corpus
            assert main(["-d", f"{d}/audio", "--csv", "--csv-file",
                         f"{d}/meta.csv", "--out", f"{d}/out"]) == 0
        argv = ["-d", _ingest_dir(case).format(d=d),
                *(f.format(d=d) for f in flags)]
        try:
            return main(argv)
        except SystemExit as exc:
            return ("exit", exc.code)

    got, files = assert_same(run_both(tmp_path, _write_ingest_inputs, run))
    assert got == (code if code == 0 or case == "no_mode" else ("exit", code))
    if case == "enrich":
        meta = json.loads(files["out/b.txt"])
        assert meta["signal"] and "best_track" in meta
        assert "bird_rms" in meta["Tracks"][0]


def test_ingest_parse_args_match_jax():
    argv = ["-d", "x", "--rms", "--workers", "3", "--label-col", "l"]
    want, got = (vars(mod(pkg, "cli.ingest").parse_args(argv))
                 for pkg in PKGS)
    assert got == want
    for pkg in PKGS:
        with pytest.raises(SystemExit) as exc:
            mod(pkg, "cli.ingest").parse_args(["--rms"])
        assert exc.value.code == 2
