"""The plain side against NumPy float64 and against the program's plain
CPU path, at small sizes.  The tests may import the program; the
reference may not."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.cell import load_cell, make_inputs, program_model
from portbench.reference import featurizer as rf
from portbench.reference import model as reference_model
from portbench.reference.layers import Ctx

GEOMETRY = {"sr": 48000, "n_fft": 4096, "hop_length": 281, "n_mels": 160,
            "fmin": 100.0, "fmax": 11000.0, "break_freq": 1000.0}


def numpy_mel(x: np.ndarray, g: dict) -> np.ndarray:
    """Loop-by-frame NumPy float64: pad the end, Hann, |rfft|^2, the bank."""
    n, hop = g["n_fft"], g["hop_length"]
    frames = -(-x.shape[-1] // hop)
    x = np.pad(x, [(0, 0), (0, (frames - 1) * hop + n - x.shape[-1])])
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
    bank = rf.mel_bank(g["sr"], g["n_mels"], g["fmin"], g["fmax"], n,
                       g["break_freq"])
    out = np.empty((x.shape[0], g["n_mels"], frames))
    for t in range(frames):
        spec = np.fft.rfft(x[:, t * hop:t * hop + n] * win, axis=-1)
        out[:, :, t] = (np.abs(spec) ** 2) @ bank.T
    return out


def test_mel_bank_is_the_break_frequency_slaney_bank():
    from audio_training_tpu_torch.ops.mel import mel_filterbank

    bank = rf.mel_bank(48000, 160, 100.0, 11000.0, 4096, 1000.0)
    assert np.allclose(bank, mel_filterbank(48000, 160, 100.0, 11000.0,
                                            4096, 1000.0), rtol=1e-5,
                       atol=1e-9)


def test_reference_featurizer_matches_numpy_float64():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (3, 20000))
    got = rf.MelReference(GEOMETRY, "cpu")(torch.as_tensor(x)).numpy()
    want = numpy_mel(x, GEOMETRY)
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


def test_reference_pcen_and_normalize_match_numpy():
    rng = np.random.default_rng(1)
    mel = rng.uniform(0, 5, (2, 4, 30))
    m = np.empty_like(mel)
    state = mel[..., 0]
    for t in range(mel.shape[-1]):
        state = 0.04 * mel[..., t] + 0.96 * state
        m[..., t] = state
    want = (mel / (1e-6 + m) ** 0.98 + 2.0) ** 0.5 - 2.0 ** 0.5
    got = rf.pcen(torch.as_tensor(mel)).numpy()
    assert np.allclose(got, want, rtol=1e-12)
    x = rng.uniform(-3, 2, (2, 50))
    shifted = x - x.min(-1, keepdims=True)
    want = (shifted / shifted.max(-1, keepdims=True) + 1e-6 - 0.5) * 2
    assert np.allclose(rf.normalize_rows(torch.as_tensor(x)).numpy(), want)


@pytest.mark.parametrize("workload", ["badwinner2.serve-b256",
                                      "efficientnetv2b3.serve-b512"])
def test_reference_model_matches_the_programs_plain_path(tiny_f32,
                                                         workload):
    """The program's model at float32 on the CPU, holding the benchmark's
    weights, against the reference on the reference's image."""
    cell = load_cell(workload, 5, 1.0, False, "cpu", tiny_f32)
    inputs = make_inputs(cell)
    clips, _ = inputs.batch(cell, 0)
    img = rf.image(clips, rf.MelReference(cell.geometry, "cpu"),
                   cell.traffic["front"])
    ref = reference_model(cell.config["reference"])
    with torch.no_grad():
        want = ref.forward(Ctx(), inputs.tensors, img)
        got = program_model(cell, inputs.tensors).eval()(
            img.permute(0, 2, 3, 1).contiguous())
    spread = want.std(dim=0).pow(2).mean().sqrt()
    assert (got - want).abs().max() <= 1e-3 * spread


def test_reference_training_step_matches_the_programs(tiny_f32):
    """One float32 step of the program's train step on the CPU and of the
    reference: the same mixup and dropout draws, loss and first gradient
    (f32 BatchNorm gradients carry about 1e-3 of noise on both sides)."""
    from portbench.compare import gap_of_norms
    from portbench.loops import train

    cell = load_cell("badwinner2.train-b128", 9, 1.0, False, "cpu", tiny_f32)
    inputs = make_inputs(cell)
    prog = train.Program(cell, inputs).checked_steps()
    ref = train.reference(cell, inputs)
    assert prog["loss"][0] == pytest.approx(ref["loss"][0], rel=1e-5)
    assert max(gap_of_norms(prog["grad"], ref["grad"], ref["grad"], n)
               for n in ref["grad"]) <= 1e-2


def test_weights_are_one_draw_of_the_seed():
    spec = reference_model("badwinner2").spec(62, GEOMETRY)
    a = weights.make(spec, 7, "cpu")
    b = weights.make(spec, 7, "cpu")
    c = weights.make(spec, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["convs.4.weight"], c["convs.4.weight"])
    w = a["convs.5.weight"]
    assert w.var().item() == pytest.approx(1.0 / w[0].numel(), rel=0.05)
