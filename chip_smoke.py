#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and nvcc.
Phases, each of which ends the run with a non-zero exit when it fails:

1. environment: torch/CUDA/nvcc versions, the card's name and power limit;
2. build every kernel from ``audio_training_tpu_torch/csrc`` (all nvcc
   processes at once) and print ptxas' registers / shared memory / spills;
3. each kernel against its plain PyTorch version on the card at the
   production geometry (160 mels x 513 frames, TF32 off), at B=8 and at
   each path's own batch: mel power f32 in tf framing (B=256) and centered
   framing (B=64, and a 28,100-sample clip where the two frame counts
   differ), global relative error < 1e-5; bf16 output bitwise the cast of
   the f32 output; PCEN (absolute error < 1e-4 after its global min-max;
   also at smooth 0, 0.04 and 1, at 1, 33, 513 and 7,300 frames on 15
   rows, its
   bf16 output bitwise the f32 cast); the power-mel kernel at
   the Predictor's n_fft=2048 shape (B=64 x 513 frames x 1025 bins x 160
   mels; a band walk over the bank's support), global relative error
   < 1e-5;
4. the paths, each with the launch counts zeroed just before and read just
   after: the badwinner2 serving chain at full width (normalize_rows ->
   fused featurizer, bf16 image -> BadWinner2 bf16, 62 labels, B=256,
   random weights from a torch seed) answering 3 requests;
   ``make_fused_infer_fn(use_pcen=True)`` once; and the long-recording
   ``Predictor.predict_recording`` on a 60 s synthetic 48 kHz recording
   (noise and chirps from a numpy seed) with the same bf16 badwinner2, once
   at n_fft=4096 (the centered fused featurizer) and once at n_fft=2048
   (centered STFT + the power-mel kernel).  Kernel-path logits agree with
   the plain-featurizer path in f32 at B=8, and the Predictor's f32
   probabilities with the plain featurizer's on the same windows;
5. timing with CUDA events after warm-up: each kernel at its path's batch,
   its plain version, one PyTorch library call computing the same
   function; the badwinner2 chain (ms per batch, audio-seconds per second)
   and peak memory; the centered STFT that feeds the power-mel kernel; the
   Predictor's host detection and windowing once, then per geometry its
   device ms per 64-window batch and the featurizer's part of it,
   recording-seconds per second end to end, and the host's share of that
   wall time from a profiled run);
6. the training path (badwinner2 bf16, 62 labels, B=128, production
   geometry): K1's "default" (bf16 tensor-core) tier against its plain
   version at B=8 and B=128 (see BF16_* below) and against the exact
   kernel; ``fit`` for 2 epochs x 4 steps on a learnable tone-band batch
   from a numpy seed with one validation batch, launch counts zeroed just
   before and read just after (one bf16 launch per train step, one exact
   launch per eval batch), a falling train loss; one f32 train step at B=8
   through the kernel path and through the plain-featurizer path from the
   same weights and generator seeds; timing of the bf16 kernel at B=128
   and B=256, its plain version and a library yardstick, the train step
   (ms, samples/s, peak memory), its split into preprocess / forward /
   backward / Adam, a profile with the idle share, and the 44x3 condense
   conv's forward, dgrad and wgrad alone;
7. the PCEN -> MobileNetV2 chain, bench.py's official line (waveform ->
   K1 with the PCEN epilogue, bf16 image -> 3-channel repeat ->
   ``BackboneClassifier(mobilenet, external_frontend=True)`` bf16, 62
   labels, B=512, random weights from a torch seed): K1's three-pass
   "bf16_3x" tier against its plain version (< 2e-5) and the exact kernel
   (< 5e-5) at B=8 and B=512, "bf16_3x_manual" bitwise equal to it, the
   PCEN epilogue on the "default" tier's own mel (< 1e-4); at B=512 the
   "default" tier against its plain version (phase 6's limits) and the
   exact kernel and PCEN against theirs (phase 3's limits); the chain
   through ``make_fused_infer_fn`` answering 3 requests at the "default"
   tier, then once each at "bf16_3x" and "highest", launch counts zeroed
   just before and read just after each; f32 logits at B=8 of the kernel
   path against the plain featurizer (1e-4), of "bf16_3x" against
   "highest" (1e-4) and of the folded 1-channel stem against the
   3-channel repeat (1e-5); timing of the bf16_3x kernel (plain, library,
   bound), of the PCEN kernel alone on the "default" tier's mel (plain,
   bound), of the chain per tier (ms, audio-s/s, peak memory), its split
   into featurizer and CNN, a profile with the idle share, and the CNN in
   channels-last and NCHW layouts;
8. the folded badwinner2 chain (waveform -> K1 with the normalize and
   frontend folds, bf16 image -> ``BadWinner2(external_frontend=True)``
   bf16, 62 labels, B=256, seeded weights whose frontend statistics are
   calibrated on the image) answering 3 requests at the "highest" tier, one
   min-max and one folded mel launch each and nothing else; once more at
   "default" and "bf16_3x", and the centered "default" / "bf16_3x"
   featurizer once at B=64, each with its counts; the per-clip min-max
   kernel bitwise its plain version, the folds at every tier against their
   plain versions at B=8 and B=256 (phase 3's, 6's and 7's limits; the
   "default" tier's flip-free impulse check with the frontend fold alone;
   the exact tier's normalize fold bitwise the unfolded kernel on
   normalize_rows' clips),
   the centered tensor-core tiers at B=64 and on the 28,100-sample clip;
   f32 logits at B=8 of the folded chain against the unfused chain
   (normalize_rows -> K1 -> BadWinner2 with its frontend, same weights,
   1e-4); timing of both chains and of each new kernel and mode;
9. the megakernel probe: K3 (``dot_probe_kernel``) in its three modes and
   K4 (``shift_probe_kernel``) in its four against their plain versions
   (K3 within ``DOT_REL`` of max |out|, in the output and in every element
   of its scratch, at small ndots, at the probe's first shape and at k past
   one fill; K4 bitwise at small nops, at the probe's shapes and at rows
   and lanes that split unevenly, m 8 and 72, lanes 513, 507 and 130, 1 and 3
   steps); the
   SASS of K3 (its HGMMA instructions and no HMMA, by ``cuobjdump -sass``;
   ptxas' wgmma remarks); the probe's
   ``main`` (the TPU probe's list) with launch counts, then ``pool3``; K4
   in each mode at nops 2048 and 8192 (3.6-4.4x the time: every iteration
   is issued), the card's clocks sampled around main and that check; per
   shape the rate, the wgmma count, the bound and ``torch.matmul`` of the
   same bf16
   products; per K4 mode its bound (adds and maxima at the FP32 pipe's
   rate, the region's stores at the SMs' shared-memory store rate) and one
   PyTorch call doing a launch's ops on views of the input
   (``torch.roll``, the slice copies, a 3-lane ``amax``);
10. training from a built corpus at full width: a synthetic corpus written
   by the port's own writer (GZIP TFRecord shards of
   ``schema.encode_sample`` records, 384 / 128 / 128 clips of the
   production geometry over 4 / 2 / 2 shards, tone bands over noise from a
   numpy seed, 12 species of the ontology's ``bird_train_labels``, and a
   ``training-meta.json``), then ``cli/train.main`` (badwinner2, B=128, 2
   epochs x 4 steps, ``bn_reestimate`` and ``epoch_confusion`` on, bf16)
   with the launch counts zeroed just before and read just after: one
   ``mel_bf16`` launch a train step, one exact launch a validation batch
   an epoch, a test batch and a BN re-estimation batch, no other K1
   launch; the run directory read back by the port's readers (metadata
   labels equal to ``init_labels``', history and test metrics, the weights
   files, the test confusion holding every test positive, the per-epoch
   confusions, training log, history, weight histograms, the event file's
   per-epoch scalars), finite losses; the run loaded by
   ``cli/predict.load_predictor`` and phase 4's recording predicted
   (finite window probabilities); timing: ``train_run``'s wall time, its
   steady-state ms a step (batch requests stamped after a synchronize)
   beside phase 6's step, the device's idle share over the last epoch from
   a profile, and the host loader alone (uncached
   ``build_training_stream`` with 0 and 4 workers, samples/s).

It prints one JSON line of kernel records, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and last
``{"ok": true, "device": {...}}``.  There is no CPU mode: without a CUDA
card it fails.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH = 256
CHECK_BATCH = 8
WINDOW_BATCH = 64  # the Predictor's max_window_batch
NUM_LABELS = 62
REQUESTS = 3
SEED = 0
RECORDING_S = 60.0
SHORT_CLIP = 28100  # 100 hops: 100 tf frames, 101 centered frames
TRAIN_BATCH = 128  # bench.py's TRAIN_BATCH
TRAIN_EPOCHS, TRAIN_STEPS = 2, 4
TRAIN_LR = 1e-3
BATCH_PCEN = 512  # bench.py's BATCH_PCEN
# phase 10's corpus: clips and GZIP shards a split, species, the run
CORPUS_SPLITS = {"train": (384, 4), "validation": (128, 2), "test": (128, 2)}
CORPUS_SPECIES = 12
CORPUS_EPOCHS, CORPUS_STEPS = 2, 4
MEL_REL_TOL = 1e-5
PCEN_ABS_TOL = 1e-4
# f32 logits of the kernel path vs the plain-featurizer path, relative to
# max |logit|: the featurizers differ at ~1e-6 of the mel scale and the CNN
# adds f32 rounding only (TF32 off); the same bound for the Predictor's
# probabilities, relative to max |p|
LOGIT_REL_TOL = 1e-4
# K1's "default" tier: kernel and plain version share six bf16 rounding
# points and differ in f32 summation order only, which now and then flips a
# rounding (one bf16 step of one plane value or power bin).  Where no flip
# can happen (at most one impulse per frame: every rounded sum has one
# term) the global relative error must be < 1e-4; on audio the relative RMS
# error < 1e-4 and no value off by more than one bf16 step of the max; and
# the tier stays in its class against the exact kernel (< 1e-2).
BF16_FLIP_FREE_REL = 1e-4
BF16_RMS_REL = 1e-4
BF16_STEP = 2.0 ** -7
BF16_VS_EXACT = 1e-2
# K1's "bf16_3x" tier: kernel and plain version share the split points and
# round nowhere between stages, so they differ by f32 summation order only
# (global relative error < 2e-5); against the exact kernel the tier's own
# class (the TPU read 8.7e-6, bench.py:337) is < 5e-5.  Through the f32
# MobileNetV2 its logits stay within 1e-4 of max |logit| of the exact
# tier's; the folded gray stem within 1e-5 (the same math, summed in
# another order).
X3_REL = 2e-5
X3_VS_EXACT = 5e-5
X3_LOGIT_REL = 1e-4
FOLD_REL = 1e-5
# One f32 train step, kernel path vs plain-featurizer path: the loss to
# 1e-4 relative.  Adam's first update is +-lr * g / (|g| + eps) per element,
# and the gradient of badwinner2 in train mode is not smooth in its input:
# a LeakyReLU pre-activation or a max-pool near-tie that the featurizers'
# 1e-6-level difference moves across changes some gradient elements'
# signs (the check prints, for reference, how many updates a 1e-6
# relative perturbation of the plain path's own features moves).  So the
# updated parameters are held as a function: both updated models give the
# same eval loss on the same batch to 1e-3 relative; elementwise, no
# parameter moves more than 2 lr apart (Adam's first step bounds each move
# by lr) and fewer than 5% move more than 1e-3 lr apart.
TRAIN_LOSS_REL = 1e-4
UPDATED_LOSS_REL = 1e-3
UPDATE_TOL = 1e-3
UPDATE_OFF_FRAC = 5e-2
# Published H100 SXM peaks (NVIDIA data sheet): fp32 on CUDA cores, dense
# bf16 on the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
# Per-SM rates (the CUDA C++ Programming Guide's throughput table for
# compute capability 9.0) at the clock that the fp32 peak implies: 132 SMs
# x 128 FP32 lanes x 2 flops an FMA.  FP32 adds and maxima issue at 128 a
# clock an SM, shared-memory stores move 128 bytes a clock an SM, the MUFU
# unit (ex2, lg2, rcp) returns 16 results a clock an SM.
SMS = 132
SM_CLOCK_HZ = PEAK_FP32_FLOPS / (2 * SMS * 128)
FP32_INSTR_S = SMS * 128 * SM_CLOCK_HZ
SMEM_STORE_BYTES_S = SMS * 128 * SM_CLOCK_HZ
MUFU_S = SMS * 16 * SM_CLOCK_HZ
# PCEN per element: 4 bytes in; four transcendentals (2 logf, 2 expf) at the
# MUFU rate; the EMA (3 flops) and the pointwise arithmetic around them
# (about 9) at the fp32 peak
PCEN_TRANSCENDENTALS = 4
PCEN_FLOPS = 12
KERNEL_SOURCE = "audio_training_tpu_torch/csrc/fused_featurizer.cu"
TPU_KERNEL = "audio_training_tpu/ops/pallas/fused_featurizer.py:286"
MELSPEC_SOURCE = "audio_training_tpu_torch/csrc/melspec.cu"
MELSPEC_TPU_KERNEL = "audio_training_tpu/ops/pallas/melspec.py:36"
PROBE_SOURCE = "audio_training_tpu_torch/csrc/probe_megakernel.cu"
PROBE_DOT_TPU = "docs/probes/probe_megakernel.py:81"
PROBE_SHIFT_TPU = "docs/probes/probe_megakernel.py:161"
# K3 against its plain version, relative to max |out|: bf16 products are
# exact in f32 and only the sums are reordered (16-deep wgmma steps against
# cuBLAS's f32 order); "accum" adds ndots products, whose units meet
# through atomics in a run-dependent order
DOT_REL = {"store": 1e-5, "brot": 1e-5, "accum": 5e-5}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def synthetic_recording(seconds: float, sr: int, seed: int):
    """Noise and intermittent chirps of at most 1.5 s, from a numpy seed (a
    constant tone raises its own row median and detects nothing)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = 0.005 * rng.standard_normal(int(seconds * sr))
    start = 0.5
    while start < seconds - 2.0:
        dur = rng.uniform(0.4, 1.5)
        f0, f1 = rng.uniform(1000.0, 8000.0, 2)
        t = np.arange(int(dur * sr)) / sr
        phase = 2 * np.pi * (f0 * t + (f1 - f0) * t**2 / (2 * dur))
        i = int(start * sr)
        x[i : i + len(t)] += (rng.uniform(0.2, 0.8) * np.sin(phase)
                              * np.hanning(len(t)))
        start += dur + rng.uniform(1.0, 4.0)
    return x.astype(np.float32)


def tone_band_batch(batch: int, num_labels: int, samples: int, sr: int,
                    seed: int):
    """A learnable batch from a numpy seed: clip i carries label l_i as a
    tone at that label's frequency (log-spaced, 200 Hz to 10 kHz) over
    noise.  Returns (clips (B, samples) f32, one-hot labels (B, L))."""
    import numpy as np

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_labels, batch)
    freqs = 200.0 * 50.0 ** (np.arange(num_labels) / (num_labels - 1))
    t = np.arange(samples) / sr
    x = np.empty((batch, samples), np.float32)
    for i, l in enumerate(labels):
        x[i] = (rng.uniform(0.3, 1.0)
                * np.sin(2 * np.pi * freqs[l] * t + rng.uniform(0, 6.3))
                + 0.3 * rng.standard_normal(samples))
    return x, np.eye(num_labels, dtype=np.float32)[labels]


def impulse_batch(batch: int, samples: int, seed: int):
    """At most one impulse in any 4096-sample frame (4099 apart): every sum
    that K1's bf16 tier rounds then has one non-zero term."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = np.zeros((batch, samples), np.float32)
    for row in x:
        pos = np.arange(rng.integers(0, 4099), samples, 4099)
        row[pos] = rng.uniform(0.3, 1.0, len(pos)) * rng.choice([-1, 1],
                                                                len(pos))
    return x


def ptxas_kernels(log: str) -> list[tuple[str, str]]:
    """(kernel, registers / shared memory / spills) of each entry in an
    ``nvcc -Xptxas -v`` log; a kernel is named with its fold template
    arguments, e.g. ``mel_bf16_kernel<1,0>``."""
    import re

    def name_of(mangled: str) -> str:
        # the length-prefixed identifier ending in _kernel
        for m in re.finditer("_kernel", mangled):
            for start in range(m.end() - 8, 0, -1):
                ident = mangled[start:m.end()]
                size = str(len(ident))
                if ident[0].isalpha() and mangled[:start].endswith(size):
                    args = re.match(r"I((?:Lb[01]E)+)E", mangled[m.end():])
                    return ident + (
                        "<" + ",".join(re.findall(r"Lb([01])E", args[1]))
                        + ">" if args else "")
        return mangled

    out, name, props = [], None, []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name, props = name_of(entry.group(1)), []
        elif name and ("spill" in line or "registers" in line):
            props.append(line.replace("ptxas info    :", "").strip())
            if "registers" in line:
                out.append((name, "; ".join(props)))
                name = None
    return out


def bound_ms(fp32_flops: float, nbytes: float,
             bf16_flops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take for the work: its operations (the
    bf16 tensor-core part at the bf16 peak, the rest at the f32 peak) or its
    bytes at the memory rate, whichever is larger; in ms, with which."""
    t_ops = bf16_flops / PEAK_BF16_FLOPS + fp32_flops / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def pcen_bound(elems: int, out_bytes: int) -> tuple[float, str, str]:
    """PCEN's least time on (rows x frames) = elems elements: the larger of
    its bytes (4 in, out_bytes out) at the memory rate and its operations
    (the transcendentals at the MUFU rate, the rest at the fp32 peak, on
    units that run side by side); in ms, with which, and the parts."""
    t_bytes = elems * (4 + out_bytes) / PEAK_BYTES_S * 1e3
    t_mufu = elems * PCEN_TRANSCENDENTALS / MUFU_S * 1e3
    t_fp32 = elems * PCEN_FLOPS / PEAK_FP32_FLOPS * 1e3
    parts = (f"bytes {t_bytes:.4f} ms, transcendentals {t_mufu:.4f} ms at "
             f"the MUFU rate, fp32 {t_fp32:.4f} ms")
    if t_bytes >= max(t_mufu, t_fp32):
        return t_bytes, "bytes", parts
    return max(t_mufu, t_fp32), "operations", parts


def kernel_record(name: str, source: str, replaces: str, launches: int,
                  err: float, ms: float, plain_ms: float,
                  bound: tuple[float, str], library_ms: float | None) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def folded_chain_phase(dev, cfg, mel_np, fz, clips, card) -> list[dict]:
    """Phase 8: the folded badwinner2 chain (K1 with the normalize and
    frontend folds -> BadWinner2(external_frontend=True)) and K1's new
    modes: the folds at each tier, the per-clip min-max kernel, the
    centered tensor-core tiers.  Returns their kernel records."""
    import numpy as np
    import torch

    from audio_training_tpu_torch.models import build_model
    from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
    from audio_training_tpu_torch.ops.features import normalize_rows

    torch.cuda.empty_cache()
    mel_w, hop, n_mels = fz.mel_weights, cfg.hop_length, cfg.n_mels
    tiers = ("highest", "default", "bf16_3x")
    fzs = {"highest": fz, **{t: ffz.FusedFeaturizer(
        mel_np, cfg.n_fft, hop, precision=t, device=dev) for t in tiers[1:]}}
    fzc = {t: ffz.FusedFeaturizer(mel_np, cfg.n_fft, hop, precision=t,
                                  center=True, device=dev)
           for t in tiers[1:]}

    # seeded weights; the frontend's statistics calibrated on the mel of
    # normalized clips, so that its BatchNorm neither vanishes nor centres
    a_power = np.float32(-0.7)
    g = 1.0 / (1.0 + np.exp(0.7))
    rows = (fz(normalize_rows(clips(CHECK_BATCH)), pcen=False) ** g
            ).transpose(0, 1).reshape(n_mels, -1)
    rng = np.random.default_rng(SEED)
    bn_mean = (rows.mean(1).cpu().numpy()
               * rng.uniform(0.8, 1.2, n_mels)).astype(np.float32)
    bn_var = (rows.var(1).cpu().numpy()
              * rng.uniform(0.5, 2.0, n_mels)).astype(np.float32)
    frontend_params = (a_power, bn_mean, bn_var)
    frontend = ffz.frontend_tables(frontend_params, n_mels, dev)

    def models(dtype):
        """(unfused, folded) badwinner2 with the same weights."""
        unfused = build_model(
            "badwinner2", NUM_LABELS, logits_only=True, dtype=dtype,
            generator=torch.Generator().manual_seed(SEED)).module
        with torch.no_grad():
            unfused.mag.a_power.fill_(float(a_power))
            unfused.mel_bn.running_mean.copy_(torch.from_numpy(bn_mean))
            unfused.mel_bn.running_var.copy_(torch.from_numpy(bn_var))
        folded = build_model("badwinner2", NUM_LABELS, logits_only=True,
                             dtype=dtype, external_frontend=True).module
        folded.load_state_dict({
            k: v for k, v in unfused.state_dict().items()
            if not k.startswith(("mag.", "mel_bn."))})
        return unfused.to(dev).eval(), folded.to(dev).eval()

    unfused16, folded16 = models(torch.bfloat16)

    @torch.no_grad()
    def folded_chain(raw, tier="highest", model=folded16,
                     out_dtype=torch.bfloat16):
        img = fzs[tier](raw, pcen=False, normalize_waveform=True,
                        frontend_params=frontend_params, out_dtype=out_dtype)
        return model(img[..., None])

    @torch.no_grad()
    def unfused_chain(raw, model=unfused16, out_dtype=torch.bfloat16):
        img = fz(normalize_rows(raw), pcen=False, out_dtype=out_dtype)
        return model(img[..., None])

    def expect(counts: dict, **want) -> bool:
        full = dict.fromkeys(counts, 0)
        full.update(want)
        return counts == full

    # the path: 3 requests through the folded chain at "highest"
    requests = [clips(BATCH) for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    ffz.reset_launch_counts()
    answers = [folded_chain(r) for r in requests]
    torch.cuda.synchronize()
    main_counts = ffz.launch_counts()
    log(f"path folded badwinner2 chain: {REQUESTS} requests of B={BATCH}, "
        f"launches {main_counts}")
    check(expect(main_counts, clip_minmax=REQUESTS,
                 fused_featurizer_mel_folded=REQUESTS),
          "the folded chain did not launch one min-max and one folded mel "
          "kernel per request, and nothing else")
    for logits in answers:
        check(tuple(logits.shape) == (BATCH, NUM_LABELS)
              and bool(torch.isfinite(logits).all()),
              f"folded-chain logits {tuple(logits.shape)} not finite")
    del answers
    # the same entry points at the other tiers: the folded chain once at
    # "default" and at "bf16_3x", the centered featurizer once at each
    raw64 = normalize_rows(clips(WINDOW_BATCH))
    path_counts = {}
    for tier in tiers[1:]:
        for mode, run in (("folded", lambda: folded_chain(requests[0], tier)),
                          ("centered", lambda: fzc[tier](raw64, pcen=False))):
            torch.cuda.synchronize()
            ffz.reset_launch_counts()
            out = run()
            torch.cuda.synchronize()
            counts = ffz.launch_counts()
            name = ffz.mel_counter(tier, center=mode == "centered",
                                   folded=mode == "folded")
            log(f"path {mode} {tier} tier: {tuple(out.shape)}, launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            want = {name: 1}
            if mode == "folded":
                want["clip_minmax"] = 1
            check(expect(counts, **want) and bool(torch.isfinite(out).all()),
                  f"the {mode} {tier} path did not launch {want} alone")
            path_counts[name] = counts[name]

    # ---- kernels against their plain versions --------------------------
    def rel_rms(got, want):
        err = (got - want).abs().max().item()
        rms = torch.linalg.norm(got - want) / torch.linalg.norm(want)
        return err, err / want.abs().max().item(), rms.item()

    def check_tier(got, want, tier, what) -> float:
        err, rel, rms = rel_rms(got, want)
        if tier == "default":
            log(f"check {what}: relative RMS {rms:.3e} (limit "
                f"{BF16_RMS_REL}), global rel err {rel:.3e} (limit "
                f"{BF16_STEP:.3e}), max abs "
                f"err {err:.3e}")
            check(rms < BF16_RMS_REL and rel < BF16_STEP, f"{what} disagrees")
        else:
            limit = MEL_REL_TOL if tier == "highest" else X3_REL
            log(f"check {what}: global rel err {rel:.3e} (limit {limit}), "
                f"max abs err {err:.3e}")
            check(rel < limit, f"{what} disagrees")
        return err

    fold_err = dict.fromkeys(tiers, 0.0)
    minmax_err = 0.0
    for b in (CHECK_BATCH, BATCH):
        raw = clips(b)
        mm = ffz.clip_minmax(raw)
        mm_plain = ffz.clip_minmax_plain(raw)
        same = torch.equal(mm, mm_plain)
        minmax_err = max(minmax_err, (mm - mm_plain).abs().max().item())
        log(f"check B={b} clip min-max: bitwise the plain version: {same}")
        check(same, "the min-max kernel disagrees with plain")
        for tier in tiers:
            got = fzs[tier](raw, pcen=False, normalize_waveform=True,
                            frontend_params=frontend_params)
            want = ffz.fused_featurizer_plain(
                raw, mel_w, hop, precision=tier, normalize_waveform=True,
                frontend=frontend)
            check(got.shape == (b, n_mels, cfg.mel_frames),
                  f"folded shape {tuple(got.shape)}")
            err = check_tier(got, want, tier, f"B={b} {tier} both folds")
            cast = torch.equal(
                fzs[tier](raw, pcen=False, normalize_waveform=True,
                          frontend_params=frontend_params,
                          out_dtype=torch.bfloat16), got.to(torch.bfloat16))
            check(cast, f"{tier} folded bf16 output is not the cast")
            del got, want
            got = fzs[tier](raw, pcen=False, normalize_waveform=True)
            want = ffz.fused_featurizer_plain(raw, mel_w, hop, precision=tier,
                                              normalize_waveform=True)
            err = max(err, check_tier(got, want, tier,
                                      f"B={b} {tier} normalize fold"))
            if tier == "highest":
                # the folded sample is normalize_rows' sample bitwise, so the
                # folded kernel's output is the unfolded one's on it
                same = torch.equal(got, fzs[tier](normalize_rows(raw),
                                                  pcen=False))
                log(f"check B={b} highest normalize fold: bitwise the "
                    f"unfolded kernel on normalize_rows' clips: {same}")
                check(same, "the folded sample is not normalize_rows' sample")
            del got, want
            torch.cuda.empty_cache()
            fold_err[tier] = max(fold_err[tier], err)
        # the "default" tier's flip-free check, with the frontend fold alone
        # (the normalize fold makes every in-clip sample non-zero)
        imp = torch.as_tensor(impulse_batch(b, cfg.samples_per_clip,
                                            SEED + b), device=dev)
        got = fzs["default"](imp, pcen=False, frontend_params=frontend_params)
        want = ffz.fused_featurizer_plain(imp, mel_w, hop,
                                          precision="default",
                                          frontend=frontend)
        err, rel, _ = rel_rms(got, want)
        log(f"check B={b} default frontend fold on impulses (no rounding can "
            f"flip): global rel err {rel:.3e} (limit {BF16_FLIP_FREE_REL})")
        check(rel < BF16_FLIP_FREE_REL, "default frontend fold disagrees")
        fold_err["default"] = max(fold_err["default"], err)

    # the tensor-core tiers where a cluster of TC_CLUSTER clips is padded
    # (B=7) and on the short clip (100 frames: a 4-frame last block), tf
    # framing, against their plain versions, one launch each
    for raw in (normalize_rows(clips(7)), normalize_rows(torch.randn(
            4, SHORT_CLIP, device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED + 1)))):
        for tier in tiers[1:]:
            torch.cuda.synchronize()
            ffz.reset_launch_counts()
            got = fzs[tier](raw, pcen=False)
            torch.cuda.synchronize()
            check(expect(ffz.launch_counts(), **{ffz.mel_counter(tier): 1}),
                  f"the {tier} tier did not launch its kernel alone")
            want = ffz.fused_featurizer_plain(raw, mel_w, hop, precision=tier)
            check(got.shape == (raw.shape[0], n_mels,
                                -(-raw.shape[1] // hop)),
                  f"{tier} shape {tuple(got.shape)}")
            check_tier(got, want, tier,
                       f"B={raw.shape[0]} x {raw.shape[1]} {tier}")
            cast = torch.equal(fzs[tier](raw, pcen=False,
                                         out_dtype=torch.bfloat16),
                               got.to(torch.bfloat16))
            check(cast, f"{tier} bf16 output is not the cast")
    imp = torch.as_tensor(impulse_batch(7, cfg.samples_per_clip, SEED + 7),
                          device=dev)
    _, rel, _ = rel_rms(fzs["default"](imp, pcen=False),
                          ffz.fused_featurizer_plain(imp, mel_w, hop,
                                                     precision="default"))
    log(f"check B=7 default tier on impulses (no rounding can flip): global "
        f"rel err {rel:.3e} (limit {BF16_FLIP_FREE_REL})")
    check(rel < BF16_FLIP_FREE_REL, "default tier disagrees on impulses")

    cen_err = dict.fromkeys(tiers[1:], 0.0)
    for raw in (raw64, normalize_rows(torch.randn(
            4, SHORT_CLIP, device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED)))):
        for tier in tiers[1:]:
            got = fzc[tier](raw, pcen=False)
            want = ffz.fused_featurizer_plain(raw, mel_w, hop, center=True,
                                              precision=tier)
            check(got.shape == (raw.shape[0], n_mels,
                                1 + raw.shape[1] // hop),
                  f"centered {tier} shape {tuple(got.shape)}")
            cen_err[tier] = max(cen_err[tier], check_tier(
                got, want, tier,
                f"B={raw.shape[0]} x {raw.shape[1]} centered {tier}"))

    # ---- f32 logits: the folded chain against the unfused chain ---------
    unfused32, folded32 = models(None)
    raw8 = clips(CHECK_BATCH)
    lg_f = folded_chain(raw8, model=folded32, out_dtype=torch.float32)
    lg_u = unfused_chain(raw8, model=unfused32, out_dtype=torch.float32)
    rel = ((lg_f - lg_u).abs().max() / lg_u.abs().max()).item()
    apart = ((lg_u[0] - lg_u[1]).abs().max() / lg_u.abs().max()).item()
    log(f"check folded chain f32 logits B={CHECK_BATCH} against the unfused "
        f"chain (normalize_rows -> K1 -> BadWinner2 with its frontend, same "
        f"weights): rel err {rel:.3e} (limit {LOGIT_REL_TOL}; max |logit| "
        f"{lg_u.abs().max().item():.4e}, two clips {apart:.3e} apart)")
    check(rel < LOGIT_REL_TOL, "folded-chain logits disagree")
    del unfused32, folded32

    # ---- timing ---------------------------------------------------------
    raw256 = requests[1]
    torch.cuda.reset_peak_memory_stats()
    fold_ms = time_ms(lambda: folded_chain(raw256), iters=5)
    fold_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    unf_ms = time_ms(lambda: unfused_chain(raw256), iters=5)
    unf_peak = torch.cuda.max_memory_allocated() / 1e9
    audio = BATCH * cfg.segment_length
    log(f"time folded badwinner2 chain B={BATCH}: {fold_ms:.3f} ms/batch, "
        f"{audio / (fold_ms / 1e3):.1f} audio-s/s, peak memory "
        f"{fold_peak:.2f} GB; the unfused chain (same weights) "
        f"{unf_ms:.3f} ms/batch, {audio / (unf_ms / 1e3):.1f} audio-s/s, "
        f"peak {unf_peak:.2f} GB {card}")

    frames, samples = cfg.mel_frames, cfg.samples_per_clip
    nnz = int((mel_np > 0).sum())
    hann = torch.hann_window(cfg.n_fft, periodic=True, device=dev)

    def library_mel(x, center=False):
        """pad + torch.stft + power + torch.matmul."""
        if not center:
            x = torch.nn.functional.pad(
                x, (0, (frames - 1) * hop + cfg.n_fft - x.shape[-1]))
        spec = torch.stft(x, cfg.n_fft, hop, window=hann, center=center,
                          pad_mode="constant", return_complex=True)
        return torch.matmul(mel_w, spec.real**2 + spec.imag**2)

    # per frame: the exact tier's register FFT, untangle, power and banded
    # mel; the tensor-core tiers' stage 1 and 2 MAC (three passes at
    # bf16_3x) and power and banded mel in f32
    tc_macs = 32 * 32 * 128 + 32 * 256 * 64

    def frame_flops(tier):
        if tier == "highest":
            return (cfg.n_fft + ffz.EXACT_FFT_FLOPS + 19 * fz.n_bins
                    + 2 * nnz), 0
        passes = 3 if tier == "bf16_3x" else 1
        return cfg.n_fft + 3 * 1024 + 2 * nnz, passes * 2 * tc_macs

    records = []
    mm_ms = time_ms(lambda: ffz.clip_minmax(raw256))
    mm_plain_ms = time_ms(lambda: ffz.clip_minmax_plain(raw256))
    mm_lib_ms = time_ms(lambda: torch.aminmax(raw256, dim=-1))
    mm_bound = bound_ms(2 * raw256.numel(), raw256.numel() * 4 + BATCH * 8)
    log(f"time clip min-max kernel B={BATCH}: {mm_ms:.4f} ms, plain "
        f"{mm_plain_ms:.4f} ms, library torch.aminmax {mm_lib_ms:.4f} ms, "
        f"bound {mm_bound[0]:.4f} ms ({mm_bound[1]}), roofline share "
        f"{mm_bound[0] / mm_ms:.3f} {card}")
    records.append(kernel_record(
        "clip_minmax", KERNEL_SOURCE, TPU_KERNEL, main_counts["clip_minmax"],
        minmax_err, mm_ms, mm_plain_ms, mm_bound, mm_lib_ms))

    for tier in tiers:
        f = fzs[tier]
        name = ffz.mel_counter(tier, folded=True)

        def folded(f=f):
            return f(raw256, pcen=False, normalize_waveform=True,
                     frontend_params=frontend_params,
                     out_dtype=torch.bfloat16)

        k_ms = time_ms(folded)
        p_ms = time_ms(lambda: ffz.fused_featurizer_plain(
            raw256, mel_w, hop, precision=tier, normalize_waveform=True,
            frontend=frontend, out_dtype=torch.bfloat16),
            iters=2 if tier == "bf16_3x" else 3, warmup=1)
        torch.cuda.empty_cache()
        l_ms = time_ms(lambda: ffz.frontend_plain(
            library_mel(normalize_rows(raw256)), *frontend), iters=3)
        f32_ops, tc_ops = frame_flops(tier)
        # the folds: the min-max (2 compares a sample), the normalize (5
        # operations a sample), the frontend (5 an output value)
        extra = 7 * raw256.numel() + 5 * BATCH * n_mels * frames
        bnd = bound_ms(BATCH * frames * f32_ops + extra,
                       raw256.numel() * 4 + BATCH * n_mels * frames * 2
                       + f.table_bytes() + n_mels * 8 + BATCH * 8,
                       BATCH * frames * tc_ops)
        log(f"time folded {tier} featurizer (min-max + mel with both folds, "
            f"bf16 out) B={BATCH}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"library normalize_rows + stft + matmul + frontend {l_ms:.4f} "
            f"ms, bound {bnd[0]:.4f} ms ({bnd[1]}), roofline share "
            f"{bnd[0] / k_ms:.3f} {card}")
        launches = (main_counts[name] if tier == "highest"
                    else path_counts[name])
        records.append(kernel_record(name, KERNEL_SOURCE, TPU_KERNEL,
                                     launches, fold_err[tier], k_ms, p_ms,
                                     bnd, l_ms))

    for tier in tiers[1:]:
        f = fzc[tier]
        name = ffz.mel_counter(tier, center=True)
        k_ms = time_ms(lambda: f(raw64, pcen=False))
        p_ms = time_ms(lambda: ffz.fused_featurizer_plain(
            raw64, mel_w, hop, center=True, precision=tier), iters=3,
            warmup=1)
        l_ms = time_ms(lambda: library_mel(raw64, center=True), iters=3)
        frames_c = 1 + samples // hop
        f32_ops, tc_ops = frame_flops(tier)
        bnd = bound_ms(WINDOW_BATCH * frames_c * f32_ops,
                       raw64.numel() * 4 + WINDOW_BATCH * n_mels * frames_c * 4
                       + f.table_bytes(), WINDOW_BATCH * frames_c * tc_ops)
        log(f"time centered {tier} mel kernel (f32 out) B={WINDOW_BATCH}: "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, library stft(center) + "
            f"matmul {l_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
            f"roofline share {bnd[0] / k_ms:.3f} {card}")
        records.append(kernel_record(name, KERNEL_SOURCE, TPU_KERNEL,
                                     path_counts[name], cen_err[tier], k_ms,
                                     p_ms, bnd, l_ms))
    return records


def cuobjdump_path() -> str:
    """cuobjdump of the CUDA toolkit, or the copy Triton carries."""
    import shutil

    from audio_training_tpu_torch.ops.cuda import build

    found = shutil.which("cuobjdump")
    candidates = [found] if found else []
    candidates.append(str(Path(build.nvcc_path()).parent / "cuobjdump"))
    try:
        import triton

        candidates.append(str(Path(triton.__file__).parent / "backends"
                              / "nvidia" / "bin" / "cuobjdump"))
    except ImportError:
        pass
    for c in candidates:
        if c and Path(c).exists():
            return c
    fail(f"no cuobjdump among {candidates}: K3's SASS cannot be checked")


def smi_clocks() -> str:
    """The card's SM and memory clocks, power draw and temperature."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def probe_phase(dev, card) -> list[dict]:
    """Phase 9: the megakernel probe (K3 dot_probe_kernel, K4
    shift_probe_kernel) against its plain versions, the SASS of K3, the
    probe's main list with rates, bounds and torch.matmul yardsticks, and
    pool3.  Returns the kernel records."""
    import re

    import torch

    from audio_training_tpu_torch.ops.cuda import build
    from audio_training_tpu_torch.probes import probe_megakernel as pm

    torch.cuda.empty_cache()
    dot_err = dict.fromkeys(pm.DOT_MODES, 0.0)
    for mode in pm.DOT_MODES:
        for m, k, n, ndots, grid in ((64, 640, 512, 9, 8),
                                     (64, 640, 512, 512, 8),
                                     (512, 512, 512, 9, 2),
                                     (64, 640, 128, 17, 8),
                                     (128, 768, 128, 13, 8),
                                     (512, 640, 128, 10, 1),
                                     (64, 1024, 128, 9, 2)):
            a, b = pm.dot_inputs(m, k, n, mode, dev)
            got, scratch = pm._dot_launch(0.5, a, b, ndots, grid, mode)
            want = pm.dot_probe_plain(0.5, a, b, ndots, grid, mode)
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            # every element the launch wrote: each slot's last d_i, or in
            # "accum" the sums (the scratch, the output block inside it)
            af, bf = a.float(), b.float()
            idx = torch.arange(ndots, device=dev) % 4
            prods = (torch.matmul(af[0], bf[idx]) if mode == "brot"
                     else torch.matmul(af[idx], bf))
            if mode == "accum":
                full = scratch.clone()
                full[:, :8, :128] += got.reshape(grid, 8, 128)
                acc = torch.full_like(prods[0], 0.5 * 1e-30)
                for d in prods:
                    acc = acc + d
                rel_all = ((full - acc).abs().max()
                           / acc.abs().max()).item()
            else:
                last = {i % pm.SLOTS: i for i in range(ndots)}
                rel_all = max(((scratch[:, r] - prods[i]).abs().max()
                               / prods[i].abs().max()).item()
                              for r, i in last.items())
            del prods, scratch
            log(f"check probe dot[{mode}] M={m} K={k} N={n} ndots={ndots} "
                f"grid={grid}: rel err {rel:.3e} of max |out| (limit "
                f"{DOT_REL[mode]}), max abs err {err:.3e}; whole scratch "
                f"rel err {rel_all:.3e}")
            check(rel < DOT_REL[mode] and rel_all < DOT_REL[mode],
                  f"dot probe ({mode}) disagrees")
            dot_err[mode] = max(dot_err[mode], err)
    shift_err = dict.fromkeys(pm.SHIFT_MODES, 0.0)
    for mode in pm.SHIFT_MODES:
        # the probe's shape, then rows and lanes that split unevenly over
        # warps and blocks (130 lanes: a partial last quad; pool3 takes 507
        # lanes as JAX does), at 1 and 3 steps
        wide = {"shift1": 513, "roll": 130, "pool3": 507, "copyblk": 130}[mode]
        main_shape = (256, 128, 8) if mode == "copyblk" else (64, 640, 8)
        shapes = [main_shape, (8, wide, 1), (72, wide, 3)]
        for m, lanes, grid in shapes + [(72, 513, 3)] * (wide != 513):
            x = pm.shift_input(m, lanes, dev)
            got = pm.shift_probe(0.25, x, 7, grid, mode)
            want = pm.shift_probe_plain(0.25, x, 7, grid, mode)
            same = torch.equal(got, want)
            log(f"check probe shift[{mode}] ({m}x{lanes}, 7 ops, grid "
                f"{grid}): bitwise the plain version: {same}")
            check(same, f"shift probe ({mode}) disagrees")
            shift_err[mode] = max(shift_err[mode],
                                  (got - want).abs().max().item())

    # the SASS: every product the rate counts is a wgmma (HGMMA) the kernel
    # issues, and none an mma.sync (HMMA), in both instantiations
    # (dot_probe_kernel<0> takes k <= 896 k-complete, <1> walks k in phases)
    library = build.library_path("probe_megakernel")
    sass = subprocess.run([cuobjdump_path(), "-sass", str(library)],
                          check=True, capture_output=True, text=True).stdout
    sections = {re.search(r"dot_probe_kernelILb([01])E", sec.split()[0])[1]:
                sec for sec in sass.split("Function : ")[1:]
                if "dot_probe_kernel" in sec.split()[0]}
    check(sorted(sections) == ["0", "1"],
          "dot_probe_kernel<0> and <1> are not both in the SASS")
    # ptxas adds one HGMMA.64x8x16.F16 with zero-register operands and a
    # false predicate (!UPT) where it injects warpgroup.arrive: a no-op;
    # any other HGMMA without bf16 operands fails the check
    noop = re.compile(r"HGMMA\.64x8x16\.F16 RZ, gdesc\[URZ\], RZ, !UPT")
    for inst, sec in sorted(sections.items()):
        lines = sec.splitlines()
        hgmma = [ln for ln in lines if "HGMMA" in ln]
        hmma = [ln for ln in lines if "HMMA" in ln]
        kinds = [ln.split("HGMMA")[1].split()[0] for ln in hgmma]
        products = [kd for kd in kinds if "BF16" in kd]
        log(f"sass dot_probe_kernel<{inst}>: {len(hmma)} HMMA; HGMMA "
            f"{ {kd: kinds.count(kd) for kd in sorted(set(kinds))} }; each "
            f".64x64x16.F32.BF16 is a 64x64x16 product of one warpgroup "
            f"(131,072 flops)")
        others = [ln for ln in hgmma if "BF16" not in ln]
        for ln in others:
            log(f"  sass (no bf16 operands): {ln.strip()}")
        check(products and not hmma
              and all(re.fullmatch(r"\.64x\d+x16\.F32\.BF16", kd)
                      for kd in products),
              f"dot_probe_kernel<{inst}>'s bf16 products in the SASS are not "
              f"all HGMMA .64xNx16.F32.BF16, or an HMMA remains")
        check(all(noop.search(ln) for ln in others),
              f"dot_probe_kernel<{inst}>'s SASS holds an HGMMA without bf16 "
              f"operands that is not the predicated-off no-op")
    # ptxas' wgmma remarks; a serialized wgmma (C7510 / C7520) fails the
    # check in the k-complete instantiation, the one every shape of the
    # probe's list runs
    remarks = [ln.strip() for ln in build.build_log(
        "probe_megakernel").splitlines()
        if re.search("GMMA|warpgroup|wgmma", ln)]
    for ln in remarks:
        log(f"  ptxas remark: {ln}")
    check(not any("serialized" in ln and "dot_probe_kernelILb0E" in ln
                  for ln in remarks),
          "ptxas serializes dot_probe_kernel<0>'s wgmma instructions")

    # the probe's own main, launch counts zeroed before and read after;
    # then pool3, which main leaves out as the TPU probe does
    log(f"clocks before the probe's main: {smi_clocks()}")
    torch.cuda.synchronize()
    pm.reset_launch_counts()
    results = pm.main()
    torch.cuda.synchronize()
    main_counts = pm.launch_counts()
    log(f"clocks after the probe's main: {smi_clocks()}")
    log(f"path probe main: launches {main_counts}")
    check(all(main_counts[f"probe_dot_{m}"] > 0 for m in pm.DOT_MODES)
          and all(main_counts[f"probe_shift_{m}"] > 0
                  for m in ("shift1", "roll", "copyblk"))
          and main_counts["probe_shift_pool3"] == 0,
          "the probe's main did not launch the kernels of its list")
    pm.reset_launch_counts()
    pool3 = pm.bench_shift("pool3")
    main_counts["probe_shift_pool3"] = pm.launch_counts()["probe_shift_pool3"]
    check(main_counts["probe_shift_pool3"] > 0, "pool3 did not launch")

    # every iteration is issued: K4's time grows with nops (4x the
    # iterations, 3.6-4.4x the time; at 2048 and 8192 launch overhead is
    # a few percent), each mode timed at both counts here, after the dots
    log(f"clocks before K4's nops scaling: {smi_clocks()}")
    for r in results["shifts"] + [pool3]:
        kw = {k: r[k] for k in ("mode", "m", "lanes", "grid")}
        t2 = pm.bench_shift(**kw, nops=2048)["ms"]
        t8 = pm.bench_shift(**kw, nops=8192)["ms"]
        log(f"check probe shift[{r['mode']}] nops 8192 / 2048: {t8:.4f} / "
            f"{t2:.4f} ms = {t8 / t2:.3f} (limits 3.6-4.4; the probe's main "
            f"timed {r['ms']:.4f} ms at 2048) {card}")
        check(3.6 <= t8 / t2 <= 4.4,
              f"shift probe ({r['mode']}) time does not scale with nops")
    log(f"clocks after K4's nops scaling: {smi_clocks()}")

    records, first = [], {}
    for r in results["dots"]:
        m, k, n, ndots, grid, mode = (r[key] for key in (
            "m", "k", "n", "ndots", "grid", "mode"))
        a, b = pm.dot_inputs(m, k, n, mode, dev)
        flops = 2.0 * m * k * n * ndots * grid
        bnd = bound_ms(0.0, (a.numel() + b.numel()) * 2 + 8 * grid * 128 * 4,
                       flops)
        idx = torch.arange(ndots * grid, device=dev) % 4
        if mode == "brot":
            a0, bx = a[0], b[idx]
            lib = lambda: torch.matmul(a0, bx)
        else:
            ax = a[idx]
            lib = lambda: torch.matmul(ax, b)
        lib_ms = time_ms(lib, iters=3, warmup=1)
        del lib
        torch.cuda.empty_cache()
        wgmma_n = pm.wgmma_count(m, k, n, ndots, grid)
        log(f"time probe dot[{mode}] M={m} K={k} N={n} ndots={ndots} grid="
            f"{grid}: {r['ms']:.4f} ms a launch, {r['tflops']:.1f} TFLOP/s, "
            f"{r['ns_per_dot']:.1f} ns/dot ({wgmma_n} wgmma a launch); bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}, {flops / 1e9:.1f} GFLOP at the bf16 "
            f"peak), roofline share {bnd[0] / r['ms']:.3f}; torch.matmul of "
            f"the same bf16 products {lib_ms:.4f} ms "
            f"({flops / lib_ms / 1e9:.1f} TFLOP/s) {card}")
        if mode not in first:
            plain_ms = time_ms(lambda: pm.dot_probe_plain(
                0.0, a, b, ndots, grid, mode), iters=1, warmup=1)
            first[mode] = (r["ms"], plain_ms, bnd, lib_ms)
    for mode in pm.DOT_MODES:
        ms, plain_ms, bnd, lib_ms = first[mode]
        records.append(kernel_record(
            f"probe_dot_{mode}", PROBE_SOURCE, PROBE_DOT_TPU,
            main_counts[f"probe_dot_{mode}"], dot_err[mode], ms, plain_ms,
            bnd, lib_ms))

    # K4's bound: the larger of its adds and maxima at the FP32 pipe's
    # instruction rate and its stores of the region to shared memory at the
    # SMs' store rate (device memory, x once and 4 KB a step out, takes
    # well under a microsecond).  Per op of a grid step: the region's
    # elements (shift1 m x 512, roll m x lanes, pool3 m x 169, copyblk
    # min(m, 192) x 128) and 1 / 1 / 5 / 2 operations an element
    region = {"shift1": lambda m, l: m * 512, "roll": lambda m, l: m * l,
              "pool3": lambda m, l: m * 169,
              "copyblk": lambda m, l: min(m, 192) * 128}
    ops_per = {"shift1": 1, "roll": 1, "pool3": 5, "copyblk": 2}
    for r in results["shifts"] + [pool3]:
        mode, m, lanes, nops, grid = (r[key] for key in (
            "mode", "m", "lanes", "nops", "grid"))
        elems = region[mode](m, lanes) * nops * grid
        t_ops = elems * ops_per[mode] / FP32_INSTR_S * 1e3
        t_st = elems * 4 / SMEM_STORE_BYTES_S * 1e3
        bnd = (max(t_ops, t_st), "operations" if t_ops >= t_st else "bytes")
        x = pm.shift_input(m, lanes, dev)
        plain_ms = time_ms(lambda: pm.shift_probe_plain(
            0.0, x, nops, grid, mode), iters=1, warmup=1)
        # one PyTorch call doing a launch's nops x grid ops on views of x:
        # torch.roll, the slice copies of shift1 and copyblk, pool3's
        # maximum of each 3 lanes
        xs = x.expand(nops * grid, m, lanes)
        library = {
            "roll": lambda: torch.roll(xs, -1, dims=-1),
            "shift1": lambda: xs[..., 1:513].clone(),
            "copyblk": lambda: xs[:, :192, :128].clone(),
            "pool3": lambda: xs[..., :507].unflatten(-1, (169, 3)).amax(-1),
        }[mode]
        lib_ms = time_ms(library, iters=3)
        torch.cuda.empty_cache()
        log(f"time probe shift[{mode}] ({m}x{lanes}, {nops} ops, grid "
            f"{grid}): {r['ms']:.4f} ms a launch, {r['ns_per_op']:.2f} ns/op; "
            f"bound {bnd[0]:.4f} ms ({bnd[1]}: adds and maxima {t_ops:.4f} "
            f"ms, stores to shared memory {t_st:.4f} ms), roofline share "
            f"{bnd[0] / r['ms']:.3f}; plain {plain_ms:.4f} ms; library (one "
            f"call over {nops * grid} views) {lib_ms:.4f} ms {card}")
        records.append(kernel_record(
            f"probe_shift_{mode}", PROBE_SOURCE, PROBE_SHIFT_TPU,
            main_counts[f"probe_shift_{mode}"], shift_err[mode], r["ms"],
            plain_ms, bnd, lib_ms))
    return records


def write_corpus(root: Path, cfg, species: list[str]) -> dict:
    """Phase 10's corpus, written by the port's own writer as the build
    writes it: GZIP TFRecord shards of ``schema.encode_sample`` records
    under train/, validation/ and test/, and a ``training-meta.json`` with
    the labels, the counts and the FeaturizerConfig.  Clip i of a split is
    tagged with species i mod len(species) and carries a tone at that
    species' frequency (log-spaced, 200 Hz to 10 kHz) over a noise floor,
    from a numpy seed per shard.  Shards are written by one thread each
    (zlib releases the interpreter lock).  Returns the per-split counts."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from audio_training_tpu_torch.config import config_to_dict
    from audio_training_tpu_torch.data import (
        SampleRecord, encode_sample, write_tfrecords)

    shutil.rmtree(root, ignore_errors=True)
    n = cfg.samples_per_clip
    t = np.arange(n) / cfg.sr
    freqs = 200.0 * 50.0 ** (np.arange(len(species)) / (len(species) - 1))

    def write_shard(split: str, shard: int, shards: int, total: int) -> int:
        rng = np.random.default_rng([SEED, shard, len(split)])
        recs = []
        for i in range(shard, total, shards):
            k = i % len(species)
            raw = (rng.uniform(0.3, 1.0)
                   * np.sin(2 * np.pi * freqs[k] * t + rng.uniform(0, 6.3))
                   + 0.3 * rng.standard_normal(n))
            recs.append(encode_sample(SampleRecord(
                raw=raw.astype(np.float32), tags=[species[k]],
                rec_id=f"{split}-{i}", track_ids=[str(i)], sr=cfg.sr)))
        return write_tfrecords(root / split / f"{split}-{shard:02d}.tfrecord",
                               recs)

    jobs = [(split, s, shards, total)
            for split, (total, shards) in CORPUS_SPLITS.items()
            for s in range(shards)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        written = list(pool.map(lambda j: write_shard(*j), jobs))
    check(sum(written) == sum(t for t, _ in CORPUS_SPLITS.values()),
          "the corpus writer lost records")
    counts = {}
    for split, (total, _) in CORPUS_SPLITS.items():
        per = {sp: len(range(j, total, len(species)))
               for j, sp in enumerate(species)}
        counts[split] = {"sample_counts": per, "rec_counts": per}
    meta = {"labels": list(species), "type": "audio", "counts": counts,
            **config_to_dict(cfg)}
    (root / "training-meta.json").write_text(json.dumps(meta, indent=4))
    return {split: total for split, (total, _) in CORPUS_SPLITS.items()}


def corpus_train_phase(dev, cfg, card, fit_step_ms: float,
                       fit_s: float) -> None:
    """Phase 10: training from a built corpus at full width, through the
    user's entry point ``cli/train.main``; the run directory's artifacts
    read back by the port's readers; the trained run loaded by
    ``cli/predict.load_predictor`` and a recording predicted; the host
    loader timed alone."""
    import itertools
    import math
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_training_tpu_torch.cli import predict as cli_predict
    from audio_training_tpu_torch.cli import train as cli_train
    from audio_training_tpu_torch.data import (
        RecordStream, build_training_stream, decode_sample, find_shards)
    from audio_training_tpu_torch.data._native import split_records
    from audio_training_tpu_torch.data.pipeline import DeviceCopier
    from audio_training_tpu_torch.data.tfrecord import _read_raw
    from audio_training_tpu_torch.eval.confusion import load_raw_predictions
    from audio_training_tpu_torch.infer import extract_track_windows
    from audio_training_tpu_torch.models import build_model
    from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
    from audio_training_tpu_torch.taxonomy import load_ontology
    from audio_training_tpu_torch.train import (
        harness, load_metadata, load_state_dict)
    from audio_training_tpu_torch.utils.tensorboard import read_events

    torch.cuda.empty_cache()
    species = list(load_ontology().bird_train_labels[:CORPUS_SPECIES])
    corpus = REPO / "build" / "chip_smoke_corpus"
    t0 = time.perf_counter()
    sizes = write_corpus(corpus, cfg, species)
    write_s = time.perf_counter() - t0
    space, _, _ = harness.init_labels([corpus])
    nbytes = sum(p.stat().st_size for p in corpus.rglob("*.tfrecord"))
    log(f"corpus: {sizes} clips of {cfg.samples_per_clip} samples at "
        f"{cfg.sr} Hz over {sum(s for _, s in CORPUS_SPLITS.values())} GZIP "
        f"shards ({nbytes / 1e6:.1f} MB), written in {write_s:.2f} s; "
        f"{len(species)} species from the ontology's bird_train_labels -> a "
        f"label space of {space.num_labels}: {list(space.labels)}")

    # the train loop's batch requests, stamped after a synchronize: the
    # interval between two is one step plus its wait for the loader; the
    # profile spans the last epoch (train steps, validation, checkpoints)
    stamps: list[tuple[int, float]] = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}
    real_fit = harness.fit

    def timed_fit(state, train_batches, *args, **kwargs):
        def timed(epoch):
            if epoch == CORPUS_EPOCHS - 1:
                torch.cuda.synchronize()
                prof.start()
                window["start"] = time.perf_counter()
            for batch in train_batches(epoch):
                torch.cuda.synchronize()
                stamps.append((epoch, time.perf_counter()))
                yield batch

        result = real_fit(state, timed, *args, **kwargs)
        torch.cuda.synchronize()
        window["end"] = time.perf_counter()
        prof.stop()
        return result

    ckpt = REPO / "build" / "chip_smoke_train"
    run_dir = ckpt / "corpus-run"
    conf = ckpt / "train-config.json"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    conf.write_text(json.dumps({"bn_reestimate": True,
                                "epoch_confusion": True}))
    argv = [run_dir.name, "-d", str(corpus), "--checkpoint-dir", str(ckpt),
            "--model-name", "badwinner2", "--batch-size", str(TRAIN_BATCH),
            "--epochs", str(CORPUS_EPOCHS), "--steps-per-epoch",
            str(CORPUS_STEPS), "-c", str(conf), "--device", str(dev)]
    harness.fit = timed_fit
    try:
        torch.cuda.synchronize()
        ffz.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_train.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = ffz.launch_counts()
    finally:
        harness.fit = real_fit
    check(rc == 0, f"cli/train exited {rc}")
    batches = lambda n: math.ceil(n / TRAIN_BATCH)  # noqa: E731
    exact = (CORPUS_EPOCHS * batches(sizes["validation"])
             + batches(sizes["test"]) + batches(sizes["train"]))
    want = {k: 0 for k in counts}
    want["fused_featurizer_mel_bf16"] = CORPUS_EPOCHS * CORPUS_STEPS
    want["fused_featurizer_mel"] = exact
    log(f"path cli/train {' '.join(argv)}: badwinner2 bf16, "
        f"{space.num_labels} labels, B={TRAIN_BATCH}, {CORPUS_EPOCHS} "
        f"epochs x {CORPUS_STEPS} steps, bn_reestimate and epoch_confusion "
        f"on; {run_s:.2f} s; launches {counts} (want {want}: one bf16 "
        f"launch a train step; one exact launch a validation batch an "
        f"epoch, a test batch and a BN re-estimation batch)")
    check(counts == want, "phase 10's K1 launch counts are not the path's")

    meta = load_metadata(run_dir)
    hist = json.loads((run_dir / "history.json").read_text())
    check(meta["labels"] == list(space.labels), "metadata labels differ "
          "from init_labels'")
    check(meta["history"]["loss"] == hist["loss"], "metadata history differs")
    check(all(np.isfinite(hist[k]).all() for k in ("loss", "val_loss")),
          "non-finite losses in train_run")
    check(meta["test_samples"] == sizes["test"],
          f"test metrics cover {meta.get('test_samples')} samples")
    model = build_model("badwinner2", space.num_labels, logits_only=True,
                        n_mels=cfg.n_mels).module
    for name in ("chkpt", "val-loss", "val-auc", "val-accuracy"):
        sd = load_state_dict(run_dir / f"{name}.pt")
        check(sd.keys() == model.state_dict().keys()
              and all(torch.isfinite(v.float()).all() for v in sd.values()),
              f"{name}.pt does not load as badwinner2 weights")
    raw = load_raw_predictions(run_dir / "confusion-raw.npy")
    cm = np.load(run_dir / "confusion.npy")
    positives = int(raw["y_true"].sum())
    check(raw["y_pred"].shape == (sizes["test"], space.num_labels),
          "the raw test predictions miss test samples")
    # the multi-label confusion puts each positive (sample, label) pair on
    # the diagonal or in the "nothing" column; false positives go elsewhere
    check(int(np.trace(cm) + cm[:-1, -1].sum()) == positives,
          "confusion.npy does not hold every test positive")
    for e in range(CORPUS_EPOCHS):
        check((run_dir / "epoch-confusion" / f"epoch_{e:03d}.npy").exists(),
              f"no epoch-confusion/epoch_{e:03d}.npy")
    rows = (run_dir / "training-log.csv").read_text().splitlines()
    hists = (run_dir / "weight-hists.jsonl").read_text().splitlines()
    check(len(rows) == CORPUS_EPOCHS + 1 and len(hists) == CORPUS_EPOCHS,
          "training-log.csv / weight-hists.jsonl miss epochs")
    (events,) = run_dir.glob("events.out.tfevents.*")
    scalars = [e for e in read_events(events)
               if "scalars" in e and "loss" in e["scalars"]]
    check([e["step"] for e in scalars] == list(range(CORPUS_EPOCHS))
          and all(abs(e["scalars"]["loss"] - l) <= 1e-6 * abs(l)
                  for e, l in zip(scalars, hist["loss"])),
          "the event file does not hold each epoch's scalars")
    log(f"check corpus run artifacts: metadata labels = init_labels', "
        f"history and test metrics (test_samples {meta['test_samples']}, "
        f"f1 {meta['test_f1']:.4f}); chkpt / val-loss / val-auc / "
        f"val-accuracy .pt load; confusion.npy holds the {positives} test "
        f"positives of {sizes['test']} samples (mass {int(cm.sum())}); "
        f"epoch-confusion, training-log.csv, history.json, "
        f"weight-hists.jsonl, {events.name} ({len(scalars)} epochs of "
        f"scalars); train loss {hist['loss']}, val loss {hist['val_loss']}")

    steps = [b - a for (e0, a), (e1, b) in zip(stamps, stamps[1:])
             if e0 == e1 == CORPUS_EPOCHS - 1]
    step_s = float(np.median(steps))
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    wall_ms = (window["end"] - window["start"]) * 1e3
    log(f"time train_run (cli/train) B={TRAIN_BATCH}: {run_s:.2f} s wall for "
        f"{CORPUS_EPOCHS} x {CORPUS_STEPS} steps (phase 6's fit on in-memory "
        f"batches: {fit_s:.2f} s); steady state {step_s * 1e3:.3f} ms a step "
        f"(median of epoch {CORPUS_EPOCHS - 1}'s {len(steps)} intervals, "
        f"loader included), {TRAIN_BATCH / step_s:.1f} samples/s (phase 6's "
        f"step on an in-memory batch: {fit_step_ms:.3f} ms, "
        f"{TRAIN_BATCH / (fit_step_ms / 1e3):.1f} samples/s); profile of the "
        f"last epoch (train, validation, checkpoints): device kernels "
        f"{busy_ms:.1f} ms of {wall_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f} {card}")

    # close the loop: the trained run serves phase 4's recording
    predictor, _ = cli_predict.load_predictor(run_dir, "chkpt", device=dev)
    recording = synthetic_recording(RECORDING_S, cfg.sr, SEED)
    t0 = time.perf_counter()
    tracks, results = predictor.predict_recording(recording, cfg.sr)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    windows = extract_track_windows(
        recording, cfg.sr, tracks, segment_length=cfg.segment_length,
        stride=cfg.segment_stride, fmin=cfg.fmin, fmax=cfg.fmax,
        rng=np.random.default_rng(SEED)).windows
    probs = predictor.predict_windows(windows)
    check(len(tracks) > 0
          and probs.shape == (len(windows), space.num_labels)
          and bool(np.isfinite(probs).all())
          and 0.0 <= probs.min() and probs.max() <= 1.0,
          "the trained run's predictions are not finite probabilities")
    log(f"path load_predictor(corpus run, 'chkpt') -> predict_recording "
        f"{RECORDING_S:.0f} s: {len(tracks)} tracks, {len(windows)} windows "
        f"in {pred_s:.2f} s; window probabilities finite in [0, 1], first "
        f"track {results[0].get_meta() if results[0] else None}")

    # the host loader alone: uncached train streams (each step decodes B
    # clips and B mixup partners), as many batches as two passes
    train_shards = find_shards(corpus, "train")
    n_batches = 2 * sizes["train"] // TRAIN_BATCH
    for workers in (0, 4):
        t0 = time.perf_counter()
        loader = build_training_stream(
            [corpus], "train", space, cfg.samples_per_clip, TRAIN_BATCH,
            seed=SEED, augment=True, cache=False, workers=workers, device=dev)
        it = iter(loader)
        try:
            next(it)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in itertools.islice(it, n_batches):
                pass
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        finally:
            it.close()
        rate = n_batches * TRAIN_BATCH / (t2 - t1)
        log(f"time host loader, uncached build_training_stream over "
            f"{len(train_shards)} train shards, workers {workers} "
            f"({type(loader).__name__}), B={TRAIN_BATCH} with mixup "
            f"partners, to the card: first batch {t1 - t0:.2f} s, then "
            f"{n_batches} batches in {t2 - t1:.2f} s: {rate:.1f} train "
            f"samples/s ({2 * rate:.1f} clips decoded/s, "
            f"{2 * rate * cfg.samples_per_clip * 4 / 1e6:.1f} MB/s of "
            f"clips); the step takes {TRAIN_BATCH / (fit_step_ms / 1e3):.1f} "
            f"samples/s {card}")

    # where one thread's time goes, per clip of one train shard: the file
    # read, zlib's inflate, the record split, the proto parse, the
    # stream's checks and one-hot, a batch's assembly, and its pinned copy
    # to the card
    shard = train_shards[0]
    split_ms = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        split_ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    stage("read", shard.read_bytes)
    body = stage("read + inflate", lambda: _read_raw(shard, "GZIP"))
    recs = stage("split", lambda: split_records(body, verify_crc=False))
    stage("parse", lambda: [decode_sample(r) for r in recs])
    stream = RecordStream([shard], space, cfg.samples_per_clip)
    items = stage("parse + checks + one-hot",
                  lambda: [stream._decode_one(r) for r in recs])
    raws = stage("assemble", lambda: (
        np.stack([it[0] for it in items]), np.stack([it[1] for it in items])))
    copier = DeviceCopier(dev)
    for name in ("pin + copy (first)", "pin + copy"):
        stage(name, lambda: (copier.ready(copier.put(raws)),
                             torch.cuda.synchronize()))
    log(f"time host loader split, one thread, per clip of {len(recs)} "
        f"({len(body)} bytes inflated from {shard.stat().st_size}): "
        + ", ".join(
            f"{k} {v / len(recs):.3f} ms" for k, v in split_ms.items())
        + f" {card}")


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke test runs only on the card")
    if not (REPO / "audio_training_tpu_torch" / "csrc").is_dir():
        fail(f"{REPO} is not a checkout of the repository")
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()

    # ---- 1. environment --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    from audio_training_tpu_torch.ops.cuda import build

    nvcc = subprocess.run([build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    card = f"[{smi}]"
    log(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}; nvcc {nvcc.strip().splitlines()[-1]}")
    log(f"card: {smi}")

    # ---- 2. build -------------------------------------------------------
    names = sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    build.build_libraries(names)
    log(f"build: {names} in {time.perf_counter() - t0:.1f} s")
    for name in names:
        for kernel, props in ptxas_kernels(build.build_log(name)):
            log(f"  ptxas {name} {kernel}: {props}")
    from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz

    for tier in ("default", "bf16_3x"):
        log(f"  launch {tier} tier: {ffz.tc_launch_config(tier)} "
            f"(clusters of (1, cluster) blocks along the clips)")

    from audio_training_tpu_torch.config import FeaturizerConfig
    from audio_training_tpu_torch.detect import (
        get_end, get_tracks_from_signals, signal_noise)
    from audio_training_tpu_torch.infer import Predictor, extract_track_windows
    from audio_training_tpu_torch.infer.fused import make_fused_infer_fn
    from audio_training_tpu_torch.models import build_model
    from audio_training_tpu_torch.ops.cuda import melspec
    from audio_training_tpu_torch.ops.featurizer_select import make_mel_fn
    from audio_training_tpu_torch.ops.features import (
        build_mel_weights, mel_power, normalize_rows)
    from audio_training_tpu_torch.ops.pcen import normalize_minmax_global, pcen
    from audio_training_tpu_torch.ops.stft import stft_centered

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = FeaturizerConfig()
    mel_np = build_mel_weights(cfg)
    mel_w = torch.as_tensor(mel_np, device=dev)
    fz = ffz.FusedFeaturizer(mel_np, cfg.n_fft, cfg.hop_length, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def clips(batch: int) -> torch.Tensor:
        return torch.randn(batch, cfg.samples_per_clip, generator=gen,
                           device=dev)

    # ---- 3. kernels vs plain versions -----------------------------------
    def check_kernels(raw: torch.Tensor) -> tuple[float, float]:
        """Max abs errors of the mel and PCEN kernels against plain."""
        b = raw.shape[0]
        mel_k = fz(raw, pcen=False)
        mel_p = ffz.fused_featurizer_plain(raw, mel_w, cfg.hop_length)
        check(mel_k.shape == (b, cfg.n_mels, cfg.mel_frames),
              f"mel shape {tuple(mel_k.shape)}")
        mel_err = (mel_k - mel_p).abs().max().item()
        mel_rel = mel_err / mel_p.abs().max().item()
        log(f"check B={b} mel f32: global rel err {mel_rel:.3e} (limit "
            f"{MEL_REL_TOL}), max abs err {mel_err:.3e}")
        check(mel_rel < MEL_REL_TOL, "mel f32 kernel disagrees with plain")
        same = torch.equal(fz(raw, pcen=False, out_dtype=torch.bfloat16),
                           mel_k.to(torch.bfloat16))
        log(f"check B={b} mel bf16: bitwise the cast of the f32 output: {same}")
        check(same, "bf16 mel output differs from the cast f32 output")
        pcen_k = fz(raw, pcen=True)
        pcen_p = normalize_minmax_global(ffz.fused_featurizer_plain(
            raw, mel_w, cfg.hop_length, fz.pcen_params))
        pcen_err = (pcen_k - pcen_p).abs().max().item()
        log(f"check B={b} pcen: max abs err {pcen_err:.3e} "
            f"(limit {PCEN_ABS_TOL})")
        check(pcen_err < PCEN_ABS_TOL, "pcen kernel disagrees with plain")
        pcen_f32 = fz(raw, pcen=True, normalize=False)
        same = torch.equal(
            fz(raw, pcen=True, normalize=False, out_dtype=torch.bfloat16),
            pcen_f32.to(torch.bfloat16))
        log(f"check B={b} pcen bf16: bitwise the cast of the f32 output: {same}")
        check(same, "bf16 pcen output differs from the cast f32 output")
        return mel_err, pcen_err

    # B=8, and the main path's own batch
    raw8 = normalize_rows(clips(CHECK_BATCH))
    errs = [check_kernels(raw8), check_kernels(normalize_rows(clips(BATCH)))]
    mel_err = max(e[0] for e in errs)
    pcen_err = max(e[1] for e in errs)

    # the PCEN kernel's edge cases on the B=8 mel: smooth 0 (d = 1), 0.04
    # and 1 (d = 0); 1, 33, 513 and 7,300 frames (a chunk of 32 runs of 17
    # holds 544; 7,300 frames, the clips' frames repeated, take 14); 15
    # rows, not a multiple of a block's 8.  Held after PCEN's global
    # min-max, as above; the bf16 output bitwise the f32 cast
    mel8 = fz(raw8, pcen=False)[:3, :5].repeat(1, 1, 15)
    for smooth in (0.0, 0.04, 1.0):
        params = (*fz.pcen_params[:3], smooth, fz.pcen_params[4])
        for n_t in (1, 33, 513, 7300):
            m15 = mel8[..., :n_t].contiguous()
            got = ffz.pcen_rows(m15, params)
            want = pcen(m15, *params, time_axis=2, normalize=False)
            err = (normalize_minmax_global(got)
                   - normalize_minmax_global(want)).abs().max().item()
            rel = (got - want).abs().max() / want.abs().max()
            same = torch.equal(ffz.pcen_rows(m15, params, torch.bfloat16),
                               got.to(torch.bfloat16))
            log(f"check pcen kernel smooth={smooth} T={n_t} rows=15: max "
                f"abs err {err:.3e} after the min-max (limit "
                f"{PCEN_ABS_TOL}), un-normalized global rel err "
                f"{rel.item():.3e}; bf16 bitwise the cast: {same}")
            check(err < PCEN_ABS_TOL, "pcen kernel disagrees at an edge")
            check(same, "bf16 pcen output differs from the cast f32 output")
            pcen_err = max(pcen_err, err)
    del mel8

    # centered framing: the Predictor's featurizer at n_fft=4096
    fzc = ffz.FusedFeaturizer(mel_np, cfg.n_fft, cfg.hop_length, center=True,
                              device=dev)

    def check_centered(raw: torch.Tensor) -> float:
        b, n = raw.shape
        mel_k = fzc(raw, pcen=False)
        mel_p = ffz.fused_featurizer_plain(raw, mel_w, cfg.hop_length,
                                           center=True)
        check(mel_k.shape == (b, cfg.n_mels, 1 + n // cfg.hop_length),
              f"centered mel shape {tuple(mel_k.shape)}")
        err = (mel_k - mel_p).abs().max().item()
        rel = err / mel_p.abs().max().item()
        log(f"check B={b} x {n} samples centered mel f32: global rel err "
            f"{rel:.3e} (limit {MEL_REL_TOL}), max abs err {err:.3e}")
        check(rel < MEL_REL_TOL, "centered mel kernel disagrees with plain")
        same = torch.equal(fzc(raw, pcen=False, out_dtype=torch.bfloat16),
                           mel_k.to(torch.bfloat16))
        log(f"check B={b} centered mel bf16: bitwise the cast of the f32 "
            f"output: {same}")
        check(same, "bf16 centered mel differs from the cast f32 output")
        return err

    centered_err = max(
        check_centered(normalize_rows(clips(CHECK_BATCH))),
        check_centered(normalize_rows(clips(WINDOW_BATCH))),
        check_centered(normalize_rows(torch.randn(
            4, SHORT_CLIP, generator=gen, device=dev))))

    # the power-mel kernel at the Predictor's n_fft=2048 geometry
    cfg2 = FeaturizerConfig(n_fft=2048)
    mel2_np = build_mel_weights(cfg2)
    w2_t = torch.as_tensor(np.ascontiguousarray(mel2_np.T), device=dev)

    def spectra(batch: int) -> torch.Tensor:
        """Time-major (B, T, F) complex STFT of normalized clips."""
        raw = normalize_rows(clips(batch))
        return stft_centered(raw, cfg2.n_fft, cfg2.hop_length).transpose(1, 2)

    def check_power_mel(spec: torch.Tensor) -> float:
        b, t, f = spec.shape
        out_k = melspec.fused_power_mel_complex(spec, w2_t)
        out_p = melspec.power_mel_plain(spec.real, spec.imag, w2_t)
        check(out_k.shape == (b, t, cfg2.n_mels),
              f"power mel shape {tuple(out_k.shape)}")
        err = (out_k - out_p).abs().max().item()
        rel = err / out_p.abs().max().item()
        log(f"check B={b} power mel ({t} frames x {f} bins x {cfg2.n_mels} "
            f"mels): global rel err {rel:.3e} (limit {MEL_REL_TOL}), max abs "
            f"err {err:.3e}")
        check(rel < MEL_REL_TOL, "power mel kernel disagrees with plain")
        same = torch.equal(melspec.fused_power_mel(
            spec.real.contiguous(), spec.imag.contiguous(), w2_t), out_k)
        log(f"check B={b} power mel: re/im entry equals the complex entry: "
            f"{same}")
        check(same, "the two power mel entries disagree")
        return err

    pm_err = max(check_power_mel(spectra(CHECK_BATCH)),
                 check_power_mel(spectra(WINDOW_BATCH)))

    # ---- 4. the paths -----------------------------------------------------
    cpu_gen = torch.Generator().manual_seed(SEED)
    model = build_model("badwinner2", NUM_LABELS, logits_only=True,
                        dtype=torch.bfloat16, generator=cpu_gen).module
    model = model.to(dev).eval()

    @torch.no_grad()
    def chain(raw: torch.Tensor) -> torch.Tensor:
        img = fz(normalize_rows(raw), pcen=False, out_dtype=torch.bfloat16)
        return model(img[..., None])

    requests = [clips(BATCH) for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    ffz.reset_launch_counts()
    answers = [chain(r) for r in requests]
    torch.cuda.synchronize()
    main_counts = ffz.launch_counts()
    log(f"path badwinner2 chain: {REQUESTS} requests of B={BATCH}, "
        f"launches {main_counts}")
    check(main_counts["fused_featurizer_mel"] == REQUESTS,
          "the chain did not go through the mel kernel once per request")
    for logits in answers:
        check(tuple(logits.shape) == (BATCH, NUM_LABELS),
              f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")

    model32 = build_model("badwinner2", NUM_LABELS, logits_only=True).module
    model32.load_state_dict(model.state_dict())
    model32 = model32.to(dev)
    logit_k = make_fused_infer_fn(model32, cfg, device=dev)(raw8)
    logit_p = make_fused_infer_fn(model32, cfg, use_kernel=False,
                                  device=dev)(raw8)
    logit_rel = ((logit_k - logit_p).abs().max()
                 / logit_p.abs().max()).item()
    log(f"check logits f32, kernel vs plain featurizer, B={CHECK_BATCH}: "
        f"rel err {logit_rel:.3e} (limit {LOGIT_REL_TOL})")
    check(logit_rel < LOGIT_REL_TOL, "kernel-path logits disagree")

    # The PCEN chain's model (MobileNetV2) is not ported yet; badwinner2
    # takes mel power, and on a PCEN image in [-1, 1] its MagTransform
    # raises negatives to a fractional power (NaN, in the JAX package
    # too).  So this path checks the PCEN image and the logits' shape.
    pcen_infer = make_fused_infer_fn(model, cfg, use_pcen=True, device=dev)
    pcen_raw = clips(BATCH)
    torch.cuda.synchronize()
    ffz.reset_launch_counts()
    pcen_logits = pcen_infer(pcen_raw)
    torch.cuda.synchronize()
    pcen_counts = ffz.launch_counts()
    log(f"path make_fused_infer_fn(use_pcen=True): B={BATCH}, "
        f"launches {pcen_counts}")
    check(pcen_counts["fused_featurizer_mel"] >= 1
          and pcen_counts["fused_featurizer_pcen"] >= 1,
          "the PCEN path did not launch both kernels")
    check(tuple(pcen_logits.shape) == (BATCH, NUM_LABELS),
          f"pcen-path logits shape {tuple(pcen_logits.shape)}")
    image = make_mel_fn(cfg, device=dev, pcen=True)(pcen_raw)
    check(bool(torch.isfinite(image).all())
          and image.min().item() == -1.0 and image.max().item() == 1.0,
          "PCEN image not finite in [-1, 1]")

    # The long-recording Predictor, at both featurizer geometries
    recording = synthetic_recording(RECORDING_S, cfg.sr, SEED)
    labels = [f"label{i}" for i in range(NUM_LABELS)]
    predictors, predictor_counts = {}, {}
    for n_fft in (4096, 2048):
        pcfg = FeaturizerConfig(n_fft=n_fft)
        pred = Predictor(model, labels, pcfg, device=dev)
        torch.cuda.synchronize()
        ffz.reset_launch_counts()
        melspec.reset_launch_counts()
        tracks, results = pred.predict_recording(recording, cfg.sr)
        torch.cuda.synchronize()
        counts = {
            "fused_featurizer_mel_centered":
                ffz.launch_counts()["fused_featurizer_mel_centered"],
            "power_mel": melspec.launch_counts()["power_mel"]}
        k1, k2 = counts.values()
        windows = extract_track_windows(
            recording, cfg.sr, tracks, segment_length=pcfg.segment_length,
            stride=pcfg.segment_stride, fmin=pcfg.fmin, fmax=pcfg.fmax,
            rng=np.random.default_rng(SEED)).windows
        named = sum(bool(r and r.labels) for r in results)
        log(f"path Predictor.predict_recording n_fft={n_fft}: "
            f"{RECORDING_S:.0f} s at {cfg.sr} Hz, {len(tracks)} tracks, "
            f"{len(windows)} windows, {named} tracks labelled, launches "
            f"{counts}")
        if n_fft == 4096:
            check(k1 >= 1 and k2 == 0,
                  "the n_fft=4096 Predictor did not run the centered mel "
                  "kernel alone")
        else:
            check(k2 >= 1 and k1 == 0,
                  "the n_fft=2048 Predictor did not run the power mel "
                  "kernel alone")
        check(len(tracks) >= 1 and any(r is not None for r in results),
              "the Predictor found no track to classify")
        probs = pred.predict_windows(windows)
        check(probs.shape == (len(windows), NUM_LABELS)
              and bool(np.isfinite(probs).all())
              and probs.min() >= 0.0 and probs.max() <= 1.0,
              "Predictor probabilities not finite in [0, 1]")

        # f32: the kernel path against the plain featurizer, same windows
        pred32 = Predictor(model32, labels, pcfg, device=dev)
        probs_k = pred32.predict_windows(windows)
        w_dev = torch.as_tensor(build_mel_weights(pcfg), device=dev)
        probs_p = []
        with torch.no_grad():
            for i in range(0, len(windows), WINDOW_BATCH):
                raw_w = torch.as_tensor(windows[i : i + WINDOW_BATCH],
                                        device=dev)
                mel = mel_power(normalize_rows(raw_w), w_dev, n_fft,
                                pcfg.hop_length, center=True)
                probs_p.append(pred32.classify(mel).cpu().numpy())
        probs_p = np.concatenate(probs_p)
        p_rel = np.abs(probs_k - probs_p).max() / np.abs(probs_p).max()
        log(f"check Predictor n_fft={n_fft} f32 probabilities, kernel vs "
            f"plain featurizer, {len(windows)} windows: rel err {p_rel:.3e} "
            f"(limit {LOGIT_REL_TOL})")
        check(p_rel < LOGIT_REL_TOL, "kernel-path probabilities disagree")
        predictors[n_fft], predictor_counts[n_fft] = pred, counts

    # ---- 4b. the training path: K1's bf16 tier, then fit ----------------
    from audio_training_tpu_torch.data.preprocess import make_preprocess_fn
    from audio_training_tpu_torch.ops.features import mix_up
    from audio_training_tpu_torch.train import (
        create_train_state, fit, fresh_metrics, make_train_step)
    from audio_training_tpu_torch.train.losses import bce_from_logits

    fz16 = ffz.FusedFeaturizer(mel_np, cfg.n_fft, cfg.hop_length,
                               precision="default", device=dev)
    x_np, y_np = tone_band_batch(TRAIN_BATCH, NUM_LABELS,
                                 cfg.samples_per_clip, cfg.sr, SEED)
    raw_t = torch.as_tensor(x_np, device=dev)
    y_t = torch.as_tensor(y_np, device=dev)
    partner = torch.roll(torch.arange(TRAIN_BATCH, device=dev), 1)
    train_batch = (raw_t, y_t, raw_t[partner].contiguous(), y_t[partner])
    train_pre = make_preprocess_fn(cfg, augment=True, device=dev)
    eval_pre = make_preprocess_fn(cfg, device=dev)
    # what the kernel sees on the path: the mixed, normalized clips
    train_clips = normalize_rows(mix_up(
        torch.Generator(device=dev).manual_seed(SEED), *train_batch)[0])

    def check_bf16(raw: torch.Tensor, kind: str) -> float:
        b = raw.shape[0]
        mel_k = fz16(raw, pcen=False)
        mel_p = ffz.fused_featurizer_plain(raw, mel_w, cfg.hop_length,
                                           precision="default")
        check(mel_k.shape == (b, cfg.n_mels, cfg.mel_frames),
              f"bf16 mel shape {tuple(mel_k.shape)}")
        err = (mel_k - mel_p).abs().max().item()
        rel = err / mel_p.abs().max().item()
        if kind == "impulses":
            log(f"check B={b} bf16 mel, {kind} (no rounding can flip): "
                f"global rel err {rel:.3e} (limit {BF16_FLIP_FREE_REL})")
            check(rel < BF16_FLIP_FREE_REL, "bf16 kernel disagrees with plain")
            return err
        rms = (torch.linalg.norm(mel_k - mel_p)
               / torch.linalg.norm(mel_p)).item()
        exact = fz(raw, pcen=False)
        vs_exact = ((mel_k - exact).abs().max() / exact.abs().max()).item()
        log(f"check B={b} bf16 mel, {kind}: vs plain relative RMS {rms:.3e} "
            f"(limit {BF16_RMS_REL}), global rel err {rel:.3e} (limit "
            f"{BF16_STEP:.3e}, one bf16 step), max abs err {err:.3e}; vs the "
            f"exact kernel global rel err {vs_exact:.3e} (limit "
            f"{BF16_VS_EXACT})")
        check(rms < BF16_RMS_REL and rel < BF16_STEP,
              "bf16 kernel disagrees with plain")
        check(vs_exact < BF16_VS_EXACT, "bf16 kernel outside its class")
        same = torch.equal(fz16(raw, pcen=False, out_dtype=torch.bfloat16),
                           mel_k.to(torch.bfloat16))
        check(same, "bf16-tier bf16 output differs from the cast f32 output")
        return err

    bf16_err = max(
        max(check_bf16(torch.as_tensor(impulse_batch(
                b, cfg.samples_per_clip, SEED + b), device=dev), "impulses"),
            check_bf16(train_clips[:b], "training clips"),
            check_bf16(normalize_rows(clips(b)), "noise"))
        for b in (CHECK_BATCH, TRAIN_BATCH))

    model16 = build_model("badwinner2", NUM_LABELS, logits_only=True,
                          dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(SEED)).module
    state = create_train_state(model16, learning_rate=TRAIN_LR, device=dev)
    run_dir = REPO / "build" / "chip_smoke_fit"
    torch.cuda.synchronize()
    ffz.reset_launch_counts()
    t0 = time.perf_counter()
    result = fit(state, lambda epoch: [train_batch] * TRAIN_STEPS, train_pre,
                 epochs=TRAIN_EPOCHS, steps_per_epoch=TRAIN_STEPS,
                 val_batches=lambda: [(raw_t, y_t)], val_preprocess=eval_pre,
                 run_dir=run_dir, seed=SEED)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_counts = ffz.launch_counts()
    hist = result.history
    log(f"path fit: badwinner2 bf16, {NUM_LABELS} labels, B={TRAIN_BATCH}, "
        f"{TRAIN_EPOCHS} epochs x {TRAIN_STEPS} steps + 1 val batch, "
        f"{fit_s:.1f} s; train loss {hist['loss']}, val loss "
        f"{hist['val_loss']}; launches {train_counts}")
    check(train_counts["fused_featurizer_mel_bf16"]
          == TRAIN_EPOCHS * TRAIN_STEPS,
          "not one bf16-tier launch per train step")
    check(train_counts["fused_featurizer_mel"] == TRAIN_EPOCHS,
          "not one exact mel launch per eval batch")
    check(all(np.isfinite(hist[k]).all() for k in ("loss", "val_loss")),
          "non-finite training losses")
    check(hist["loss"][-1] < hist["loss"][0], "the train loss did not fall")
    check(all((run_dir / n).exists() for n in (
        "val-loss.pt", "chkpt.pt", "best.json", "history.json")),
        "fit wrote no checkpoints")

    def plain_pre(raw, y, raw2, y2, gen):
        """The training preprocess with the bf16 tier's plain version."""
        mixed, y = mix_up(gen, raw, y, raw2, y2)
        return ffz.fused_featurizer_plain(
            normalize_rows(mixed), mel_w, cfg.hop_length,
            precision="default")[..., None], y

    def f32_step(preprocess):
        model = build_model("badwinner2", NUM_LABELS, logits_only=True,
                            generator=torch.Generator().manual_seed(SEED)
                            ).module
        st = create_train_state(model, learning_rate=TRAIN_LR, device=dev)
        mel, yy = preprocess(*(t[:CHECK_BATCH] for t in train_batch),
                             torch.Generator(device=dev).manual_seed(SEED))
        st, m = make_train_step()(
            st, fresh_metrics(dev), mel, yy,
            torch.Generator(device=dev).manual_seed(SEED + 1))
        return float(m["loss_sum"]) / CHECK_BATCH, st.model, mel, yy

    # cuDNN's deterministic algorithms, so that the two paths differ by
    # their features alone (its default backward algorithms sum in a
    # run-dependent order)
    torch.backends.cudnn.deterministic = True
    ffz.reset_launch_counts()
    loss_k, model_k, _, _ = f32_step(train_pre)
    check(ffz.launch_counts()["fused_featurizer_mel_bf16"] == 1,
          "the f32 kernel-path step did not launch the bf16 kernel")
    loss_p, model_p, mel_p, yy_p = f32_step(plain_pre)
    noise = torch.Generator(device=dev).manual_seed(SEED + 2)

    def perturbed_pre(*args):
        mel, y = plain_pre(*args)
        return mel * (1.0 + 1e-6 * torch.randn(
            mel.shape, generator=noise, device=dev)), y

    _, model_n, _, _ = f32_step(perturbed_pre)
    torch.backends.cudnn.deterministic = False
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    with torch.no_grad():
        after_k, after_p = (bce_from_logits(m.eval()(mel_p), yy_p).item()
                            for m in (model_k, model_p))
    after_rel = abs(after_k - after_p) / abs(after_p)
    params_k, params_p = model_k.state_dict(), model_p.state_dict()
    params_n = model_n.state_dict()
    off = off_n = total = 0
    upd_max = 0.0
    for name, _ in model_p.named_parameters():
        d = (params_k[name] - params_p[name]).abs() / TRAIN_LR
        off, total = off + int((d > UPDATE_TOL).sum()), total + d.numel()
        upd_max = max(upd_max, d.max().item())
        off_n += int(((params_n[name] - params_p[name]).abs() / TRAIN_LR
                      > UPDATE_TOL).sum())
    bn_rel = max(((params_k[k] - params_p[k]).abs().max()
                  / params_p[k].abs().max()).item()
                 for k in params_p if "running" in k)
    log(f"check f32 train step B={CHECK_BATCH}, kernel vs plain-featurizer "
        f"path: loss {loss_k:.6f} vs {loss_p:.6f}, rel {loss_rel:.3e} (limit "
        f"{TRAIN_LOSS_REL}); the updated models' eval loss on one batch "
        f"{after_k:.6f} vs {after_p:.6f}, rel {after_rel:.3e} (limit "
        f"{UPDATED_LOSS_REL}); {off} of {total} parameter elements "
        f"({off / total:.2e}, limit {UPDATE_OFF_FRAC}) more than "
        f"{UPDATE_TOL} lr apart, the most {upd_max:.3f} lr (limit 2); BN "
        f"running stats max rel err {bn_rel:.3e}; for reference, the plain "
        f"path against itself with its features perturbed by 1e-6 relative "
        f"noise: {off_n} elements ({off_n / total:.2e}) more than "
        f"{UPDATE_TOL} lr apart")
    check(loss_rel < TRAIN_LOSS_REL, "kernel-path train loss disagrees")
    check(after_rel < UPDATED_LOSS_REL,
          "the kernel path's updated model disagrees")
    check(off / total < UPDATE_OFF_FRAC and upd_max <= 2.0 + UPDATE_TOL,
          "kernel-path parameter update disagrees")
    del model_k, model_p, model_n, params_k, params_p, params_n, mel_p

    # ---- 5. timing -------------------------------------------------------
    raw = normalize_rows(requests[0])
    frames, n_mels = cfg.mel_frames, cfg.n_mels
    hann = torch.hann_window(cfg.n_fft, periodic=True, device=dev)

    def library_mel(x: torch.Tensor) -> torch.Tensor:
        pad = (frames - 1) * cfg.hop_length + cfg.n_fft - x.shape[-1]
        spec = torch.stft(torch.nn.functional.pad(x, (0, pad)), cfg.n_fft,
                          cfg.hop_length, window=hann, center=False,
                          return_complex=True)
        return torch.matmul(mel_w, spec.real**2 + spec.imag**2)

    lib_ref = ffz.fused_featurizer_plain(raw, mel_w, cfg.hop_length)
    lib_rel = ((library_mel(raw) - lib_ref).abs().max()
               / lib_ref.abs().max()).item()
    check(lib_rel < MEL_REL_TOL, f"library yardstick disagrees ({lib_rel})")
    del lib_ref

    n_frames_total = BATCH * frames
    nnz = int((mel_np > 0).sum())
    n_bins = fz.n_bins
    # per frame: window, the plan's 2048-point FFT (16 x 16 x 8 in
    # registers, ffz.EXACT_FFT_FLOPS), untangle + |X|^2 (19 flops a bin),
    # banded mel (2 flops a non-zero)
    mel_flops = n_frames_total * (cfg.n_fft + ffz.EXACT_FFT_FLOPS
                                  + 19 * n_bins + 2 * nnz)
    table_bytes = fz.table_bytes()
    mel_bytes = raw.numel() * 4 + BATCH * n_mels * frames * 2 + table_bytes

    mel_ms = time_ms(lambda: fz(raw, pcen=False, out_dtype=torch.bfloat16))
    mel32_ms = time_ms(lambda: fz(raw, pcen=False))
    mel_plain_ms = time_ms(lambda: ffz.fused_featurizer_plain(
        raw, mel_w, cfg.hop_length, out_dtype=torch.bfloat16), iters=5)
    mel_lib_ms = time_ms(lambda: library_mel(raw), iters=5)
    mel_bound_ms, mel_bound_by = bound_ms(mel_flops, mel_bytes)
    log(f"time mel kernel (bf16 out) B={BATCH}: {mel_ms:.4f} ms "
        f"(f32 out {mel32_ms:.4f} ms), plain {mel_plain_ms:.4f} ms, library "
        f"stft+matmul {mel_lib_ms:.4f} ms, bound {mel_bound_ms:.4f} ms "
        f"({mel_bound_by}; {mel_flops / 1e9:.2f} GFLOP, {mel_bytes / 1e6:.1f} "
        f"MB), roofline share {mel_bound_ms / mel_ms:.3f} {card}")

    mel_f32 = fz(raw, pcen=False)
    pcen_ms = time_ms(lambda: ffz.pcen_rows(mel_f32, fz.pcen_params,
                                            torch.bfloat16))
    pcen_plain_ms = time_ms(lambda: pcen(
        mel_f32, *fz.pcen_params, time_axis=2,
        normalize=False).to(torch.bfloat16), iters=3)
    pcen_bound_ms, pcen_bound_by, parts = pcen_bound(mel_f32.numel(), 2)
    log(f"time pcen kernel (bf16 out) B={BATCH}: {pcen_ms:.4f} ms, plain "
        f"{pcen_plain_ms:.4f} ms, bound {pcen_bound_ms:.4f} ms "
        f"({pcen_bound_by}; {parts}), roofline share "
        f"{pcen_bound_ms / pcen_ms:.3f} {card}")

    torch.cuda.reset_peak_memory_stats()
    chain_ms = time_ms(lambda: chain(requests[1]), iters=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    audio_s = BATCH * cfg.segment_length / (chain_ms / 1e3)
    log(f"time badwinner2 chain B={BATCH}: {chain_ms:.3f} ms/batch, "
        f"{audio_s:.1f} audio-s/s, peak memory {peak_gb:.2f} GB {card}")

    # where the chain's time goes: device time by kernel, one profiled call
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        chain(requests[2])
        torch.cuda.synchronize()
    kernel_events = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernel_events) / 1e3
    log(f"profile badwinner2 chain B={BATCH}: device kernels {busy_ms:.3f} ms "
        f"of {chain_ms:.3f} ms (idle share {1 - busy_ms / chain_ms:.3f}) {card}")
    for e in sorted(kernel_events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  kernel {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<3d} "
            f"{e.key[:80]}")
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key == "aten::cudnn_convolution":
            log(f"  conv {e.device_time_total / 1e3:9.3f} ms x{e.count:<3d} "
                f"in {e.input_shapes[:2]}")

    # ---- the Predictor's kernels at its batch of 64 windows --------------
    raw64 = normalize_rows(clips(WINDOW_BATCH))
    frames_c = 1 + cfg.samples_per_clip // cfg.hop_length

    def library_centered() -> torch.Tensor:
        spec = torch.stft(raw64, cfg.n_fft, cfg.hop_length, window=hann,
                          center=True, pad_mode="constant",
                          return_complex=True)
        return torch.matmul(mel_w, spec.real**2 + spec.imag**2)

    lib_ref = ffz.fused_featurizer_plain(raw64, mel_w, cfg.hop_length,
                                         center=True)
    lib_rel = ((library_centered() - lib_ref).abs().max()
               / lib_ref.abs().max()).item()
    check(lib_rel < MEL_REL_TOL,
          f"centered library yardstick disagrees ({lib_rel})")
    cen_ms = time_ms(lambda: fzc(raw64, pcen=False))
    cen_plain_ms = time_ms(lambda: ffz.fused_featurizer_plain(
        raw64, mel_w, cfg.hop_length, center=True), iters=5)
    cen_lib_ms = time_ms(library_centered, iters=5)
    cen_flops = WINDOW_BATCH * frames_c * (cfg.n_fft + ffz.EXACT_FFT_FLOPS
                                           + 19 * n_bins + 2 * nnz)
    cen_bytes = (raw64.numel() * 4 + WINDOW_BATCH * n_mels * frames_c * 4
                 + table_bytes)
    cen_bound_ms, cen_bound_by = bound_ms(cen_flops, cen_bytes)
    log(f"time centered mel kernel (f32 out) B={WINDOW_BATCH}: {cen_ms:.4f} "
        f"ms, plain {cen_plain_ms:.4f} ms, library stft(center)+matmul "
        f"{cen_lib_ms:.4f} ms, bound {cen_bound_ms:.4f} ms ({cen_bound_by}; "
        f"{cen_flops / 1e9:.2f} GFLOP, {cen_bytes / 1e6:.1f} MB), roofline "
        f"share {cen_bound_ms / cen_ms:.3f} {card}")

    spec64 = spectra(WINDOW_BATCH)
    pm_ms = time_ms(lambda: melspec.fused_power_mel_complex(spec64, w2_t))
    pm_plain_ms = time_ms(lambda: melspec.power_mel_plain(
        spec64.real, spec64.imag, w2_t), iters=5)
    pm_lib_ms = time_ms(lambda: torch.matmul(
        spec64.real**2 + spec64.imag**2, w2_t), iters=5)
    # the rest of the n_fft=2048 featurizer: the centered STFT (framing and
    # cuFFT) that feeds the power-mel kernel
    stft_ms = time_ms(lambda: stft_centered(raw64, cfg2.n_fft,
                                            cfg2.hop_length), iters=5)
    rows, n_freq = WINDOW_BATCH * spec64.shape[1], spec64.shape[2]
    # What this function needs: it reads only the bank's support bins of
    # the complex STFT (the kernel reads nothing else of it), writes the f32
    # mel and reads the band tables; |X|^2 (3 flops a support bin) and 2
    # flops for each non-zero of the band-sparse bank.  Counting the whole
    # spectrum's bytes would let the roofline share read over 1.
    plan = melspec.band_walk_plan(np.ascontiguousarray(mel2_np.T))
    nnz2 = len(plan.weights)
    pm_flops = rows * (3 * plan.support + 2 * nnz2)
    pm_bytes = (rows * plan.support * 8 + rows * cfg2.n_mels * 4
                + (3 * cfg2.n_mels + nnz2) * 4)
    pm_bound_ms, pm_bound_by = bound_ms(pm_flops, pm_bytes)
    log(f"time power mel kernel B={WINDOW_BATCH} ({rows} rows x {n_freq} bins, "
        f"support {plan.support} bins from bin {plan.lo}, {nnz2} non-zeros, "
        f"{cfg2.n_mels} mels): {pm_ms:.4f} ms, plain {pm_plain_ms:.4f} ms, "
        f"library matmul {pm_lib_ms:.4f} ms, bound {pm_bound_ms:.4f} ms "
        f"({pm_bound_by}; {pm_flops / 1e9:.3f} GFLOP, "
        f"{pm_bytes / 1e6:.1f} MB), roofline share {pm_bound_ms / pm_ms:.3f}; "
        f"the whole spectrum's bytes {spec64.numel() * 8 / 1e6:.1f} MB; "
        f"stft_centered feeding it {stft_ms:.4f} ms {card}")

    # ---- the Predictor end to end --------------------------------------
    # Host detection and windowing do not depend on the featurizer's
    # geometry: timed once.
    t0 = time.perf_counter()
    end = get_end(recording, cfg.sr)
    signals, _ = signal_noise(recording, cfg.sr)
    tracks = get_tracks_from_signals(signals, end)
    detect_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    windows = extract_track_windows(
        recording, cfg.sr, tracks, segment_length=cfg.segment_length,
        stride=cfg.segment_stride, fmin=cfg.fmin, fmax=cfg.fmax).windows
    windows_s = time.perf_counter() - t0
    log(f"time Predictor host stages on {RECORDING_S:.0f} s: detect "
        f"{detect_s * 1e3:.1f} ms (numpy/scipy), windows "
        f"{windows_s * 1e3:.1f} ms, {len(tracks)} tracks, {len(windows)} "
        f"windows")
    for n_fft, pred in predictors.items():

        @torch.no_grad()
        def one_batch():
            return pred.classify(pred.featurize(raw64))

        batch_ms = time_ms(one_batch, iters=5)
        feat_ms = time_ms(lambda: pred.featurize(raw64), iters=5)
        t0 = time.perf_counter()
        pred.predict_windows(windows)
        classify_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred.predict_recording(recording, cfg.sr)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        # device time does not depend on who detected the tracks
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pred.predict_recording(recording, cfg.sr, tracks=tracks)
            torch.cuda.synchronize()
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        log(f"time Predictor n_fft={n_fft}: {batch_ms:.3f} ms device per "
            f"{WINDOW_BATCH}-window batch (bf16 CNN), of which the "
            f"featurizer {feat_ms:.3f} ms; predict_recording of "
            f"{RECORDING_S:.0f} s with {len(windows)} windows: "
            f"{wall_s * 1e3:.1f} ms wall, {RECORDING_S / wall_s:.1f} "
            f"recording-s/s (classify {classify_s * 1e3:.1f} ms); device "
            f"busy {busy_ms:.1f} ms in a profiled run, host share "
            f"{1 - busy_ms / (wall_s * 1e3):.3f} {card}")

    # ---- the training path: K1's bf16 tier and the train step ------------
    raw256 = normalize_rows(clips(BATCH))
    mel_bf16_ms = time_ms(lambda: fz16(train_clips, pcen=False))
    mel_bf16_256_ms = time_ms(lambda: fz16(raw256, pcen=False))
    mel_bf16_plain_ms = time_ms(lambda: ffz.fused_featurizer_plain(
        train_clips, mel_w, cfg.hop_length, precision="default"), iters=3)
    mel_bf16_lib_ms = time_ms(lambda: library_mel(train_clips), iters=5)
    # per frame: stage 1 (32 planes x 32 n1 x 128 n2 MAC), stage 2 (32 k1
    # x 256 x 64 MAC), |X|^2 (3 flops a bin), banded mel (2 a non-zero)
    bf16_frame_flops = (2 * 32 * 32 * 128 + 2 * 32 * 256 * 64 + 3 * 1024
                        + 2 * nnz)
    bf16_tables = fz16.table_bytes()
    bf16_bound = {}
    for b in (TRAIN_BATCH, BATCH):
        flops = b * frames * bf16_frame_flops
        nbytes = (b * cfg.samples_per_clip * 4 + b * n_mels * frames * 4
                  + bf16_tables)
        bf16_bound[b] = (*bound_ms(0.0, nbytes, flops),
                         flops, nbytes)
    bf16_bound_ms, bf16_bound_by, bf16_flops, bf16_bytes = bf16_bound[
        TRAIN_BATCH]
    log(f"time bf16-tier mel kernel (f32 out) B={TRAIN_BATCH}: "
        f"{mel_bf16_ms:.4f} ms, B={BATCH}: {mel_bf16_256_ms:.4f} ms (bound "
        f"{bf16_bound[BATCH][0]:.4f}); plain {mel_bf16_plain_ms:.4f} ms, "
        f"library stft+matmul {mel_bf16_lib_ms:.4f} ms, bound "
        f"{bf16_bound_ms:.4f} ms ({bf16_bound_by}; {bf16_flops / 1e9:.2f} "
        f"GFLOP at the bf16 peak, {bf16_bytes / 1e6:.1f} MB), roofline share "
        f"{bf16_bound_ms / mel_bf16_ms:.3f} {card}")

    state = result.state
    step_fn = make_train_step()
    gen_pre = torch.Generator(device=dev).manual_seed(SEED)
    gen_drop = torch.Generator(device=dev).manual_seed(SEED + 1)

    def train_iter():
        mel, yy = train_pre(*train_batch, gen_pre)
        return step_fn(state, fresh_metrics(dev), mel, yy, gen_drop)

    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(train_iter, iters=5)
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"time train step (preprocess + fwd/bwd + Adam) B={TRAIN_BATCH}: "
        f"{step_ms:.3f} ms, {TRAIN_BATCH / (step_ms / 1e3):.1f} samples/s, "
        f"peak memory {train_peak_gb:.2f} GB {card}")

    # the step's phases, CUDA events around each (synchronized between)
    phases = {"preprocess (K1 bf16 tier)": 0.0, "forward": 0.0,
              "backward": 0.0, "Adam": 0.0}
    model = state.model.train()
    reps = 3
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        mel, yy = train_pre(*train_batch, gen_pre)
        ev[1].record()
        loss = bce_from_logits(model(mel, generator=gen_drop), yy)
        ev[2].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[3].record()
        state.optimizer.step()
        ev[4].record()
        ev[4].synchronize()
        if rep:  # the first pass warms up
            for i, name in enumerate(phases):
                phases[name] += ev[i].elapsed_time(ev[i + 1]) / reps
    log("time train step split: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in phases.items()) + f" {card}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        train_iter()
        torch.cuda.synchronize()
    kernel_events = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernel_events) / 1e3
    log(f"profile train step B={TRAIN_BATCH}: device kernels {busy_ms:.3f} ms "
        f"of {step_ms:.3f} ms (idle share {1 - busy_ms / step_ms:.3f}) {card}")
    for e in sorted(kernel_events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  kernel {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<3d} "
            f"{e.key[:80]}")
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key in ("aten::cudnn_convolution", "aten::convolution_backward"):
            log(f"  {e.key[6:]} {e.device_time_total / 1e3:9.3f} ms "
                f"x{e.count:<3d} in {e.input_shapes[:3]}")

    # the 44x3 condense conv alone (its input at 160 mels x 513 frames)
    x_c = torch.randn(TRAIN_BATCH, 128, 48, 165, device=dev,
                      dtype=torch.bfloat16).to(memory_format=torch.channels_last)
    w_c = (0.01 * torch.randn(128, 128, 44, 3, device=dev)).to(torch.bfloat16)
    g_c = torch.randn_like(torch.nn.functional.conv2d(x_c, w_c))

    def conv_bwd(mask):
        return torch.ops.aten.convolution_backward(
            g_c, x_c, w_c, None, (1, 1), (0, 0), (1, 1), False, (0, 0), 1,
            mask)

    cc_fwd_ms = time_ms(lambda: torch.nn.functional.conv2d(x_c, w_c))
    cc_dgrad_ms = time_ms(lambda: conv_bwd((True, False, False)))
    cc_wgrad_ms = time_ms(lambda: conv_bwd((False, True, False)))
    cc_tflop = 2 * g_c.numel() * 128 * 44 * 3 / 1e12
    log(f"time condense conv 44x3 bf16 alone, B={TRAIN_BATCH}, in "
        f"{tuple(x_c.shape)} channels_last ({cc_tflop:.3f} TFLOP a pass): "
        f"forward {cc_fwd_ms:.3f} ms, dgrad {cc_dgrad_ms:.3f} ms, wgrad "
        f"{cc_wgrad_ms:.3f} ms ({cc_tflop / (cc_fwd_ms / 1e3):.1f} / "
        f"{cc_tflop / (cc_dgrad_ms / 1e3):.1f} / "
        f"{cc_tflop / (cc_wgrad_ms / 1e3):.1f} TFLOP/s) {card}")

    # ---- 7. the PCEN -> MobileNetV2 chain (bench.py's official line) -----
    from audio_training_tpu_torch.models import fold_gray_stem

    torch.cuda.empty_cache()
    fz3 = ffz.FusedFeaturizer(mel_np, cfg.n_fft, cfg.hop_length,
                              precision="bf16_3x", device=dev)
    fz3m = ffz.FusedFeaturizer(mel_np, cfg.n_fft, cfg.hop_length,
                               precision="bf16_3x_manual", device=dev)

    def check_x3(raw: torch.Tensor) -> float:
        b = raw.shape[0]
        mel_k = fz3(raw, pcen=False)
        mel_p = ffz.fused_featurizer_plain(raw, mel_w, cfg.hop_length,
                                           precision="bf16_3x")
        check(mel_k.shape == (b, cfg.n_mels, cfg.mel_frames),
              f"bf16_3x mel shape {tuple(mel_k.shape)}")
        err = (mel_k - mel_p).abs().max().item()
        rel = err / mel_p.abs().max().item()
        del mel_p
        exact = fz(raw, pcen=False)
        vs_exact = ((mel_k - exact).abs().max() / exact.abs().max()).item()
        manual = torch.equal(fz3m(raw, pcen=False), mel_k)
        cast = torch.equal(fz3(raw, pcen=False, out_dtype=torch.bfloat16),
                           mel_k.to(torch.bfloat16))
        log(f"check B={b} bf16_3x mel: vs plain global rel err {rel:.3e} "
            f"(limit {X3_REL}), max abs err {err:.3e}; vs the exact kernel "
            f"{vs_exact:.3e} (limit {X3_VS_EXACT}); bf16_3x_manual bitwise "
            f"equal: {manual}; bf16 output the cast of f32: {cast}")
        check(rel < X3_REL, "bf16_3x kernel disagrees with plain")
        check(vs_exact < X3_VS_EXACT, "bf16_3x kernel outside its class")
        check(manual, "bf16_3x_manual differs from bf16_3x")
        check(cast, "bf16_3x bf16 output differs from the cast f32 output")
        # the PCEN epilogue on the "default" tier's own mel
        mel_d = fz16(raw, pcen=False)
        want = normalize_minmax_global(pcen(
            mel_d, *fz16.pcen_params, time_axis=2, normalize=False))
        p_err = (fz16(raw, pcen=True) - want).abs().max().item()
        log(f"check B={b} pcen on the default tier's mel: max abs err "
            f"{p_err:.3e} (limit {PCEN_ABS_TOL})")
        check(p_err < PCEN_ABS_TOL, "pcen kernel disagrees on the bf16 mel")
        return err

    x3_err = max(check_x3(normalize_rows(clips(CHECK_BATCH))),
                 check_x3(normalize_rows(clips(BATCH_PCEN))))
    # the path's other mel kernels against their plain versions at its own
    # batch: the "default" tier (the official line) and the exact kernel
    # with the PCEN epilogue (the "highest" rung)
    bf16_err = max(bf16_err, check_bf16(torch.as_tensor(impulse_batch(
        BATCH_PCEN, cfg.samples_per_clip, SEED + BATCH_PCEN), device=dev),
        "impulses"), check_bf16(normalize_rows(clips(BATCH_PCEN)), "noise"))
    torch.cuda.empty_cache()
    errs.append(check_kernels(normalize_rows(clips(BATCH_PCEN))))
    mel_err = max(e[0] for e in errs)
    pcen_err = max(pcen_err, max(e[1] for e in errs))
    torch.cuda.empty_cache()

    mn = build_model("mobilenet", NUM_LABELS, logits_only=True,
                     external_frontend=True, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(SEED)).module
    mn = mn.to(dev).eval()
    tiers = ("default", "bf16_3x", "highest")
    mn_infer = {t: make_fused_infer_fn(mn, cfg, use_pcen=True, channels=3,
                                       precision=t, device=dev,
                                       out_dtype=torch.bfloat16)
                for t in tiers}
    mn_requests = [clips(BATCH_PCEN) for _ in range(REQUESTS)]
    mn_counts = {}
    for tier, reqs in (("default", mn_requests), ("bf16_3x", mn_requests[:1]),
                       ("highest", mn_requests[:1])):
        torch.cuda.synchronize()
        ffz.reset_launch_counts()
        answers = [mn_infer[tier](r) for r in reqs]
        torch.cuda.synchronize()
        counts = mn_counts[tier] = ffz.launch_counts()
        log(f"path PCEN -> MobileNetV2 chain, {tier} tier: {len(reqs)} "
            f"request(s) of B={BATCH_PCEN}, launches {counts}")
        want = {k: 0 for k in counts}
        want[ffz.mel_counter(tier)] = want["fused_featurizer_pcen"] = len(reqs)
        check(counts == want,
              f"the {tier} chain did not launch its mel kernel and the PCEN "
              "kernel once per request, and nothing else")
        for logits in answers:
            check(tuple(logits.shape) == (BATCH_PCEN, NUM_LABELS)
                  and logits.dtype == torch.float32,
                  f"logits {tuple(logits.shape)} {logits.dtype}")
            check(bool(torch.isfinite(logits).all()), "non-finite logits")
    del answers

    # f32 at B=8: kernel path vs plain featurizer, bf16_3x vs highest, and
    # the folded gray stem vs the 3-channel repeat
    mn32 = build_model("mobilenet", NUM_LABELS, logits_only=True,
                       external_frontend=True).module
    mn32.load_state_dict(mn.state_dict())
    mn32 = mn32.to(dev)

    def mn32_logits(precision="highest", use_kernel=True, model=mn32,
                    channels=3):
        return make_fused_infer_fn(model, cfg, use_pcen=True,
                                   channels=channels, precision=precision,
                                   use_kernel=use_kernel, device=dev)(raw8)

    lg_hi = mn32_logits()
    lg_plain = mn32_logits(use_kernel=False)
    lg_x3 = mn32_logits("bf16_3x")
    lg_fold = mn32_logits(model=fold_gray_stem(mn32), channels=1)

    def logit_rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    rel_plain, rel_x3 = logit_rel(lg_hi, lg_plain), logit_rel(lg_x3, lg_hi)
    rel_fold = logit_rel(lg_fold, lg_hi)
    rows = logit_rel(lg_hi[0], lg_hi[1])
    log(f"check MobileNetV2 f32 logits B={CHECK_BATCH} (max |logit| "
        f"{lg_hi.abs().max().item():.4e}, two clips' logits {rows:.3e} "
        f"apart): kernel path vs plain featurizer rel err {rel_plain:.3e} "
        f"(limit {LOGIT_REL_TOL}); bf16_3x vs highest {rel_x3:.3e} (limit "
        f"{X3_LOGIT_REL}); folded 1-channel stem vs 3-channel repeat "
        f"{rel_fold:.3e} (limit {FOLD_REL})")
    check(rel_plain < LOGIT_REL_TOL, "MobileNetV2 kernel-path logits disagree")
    check(rel_x3 < X3_LOGIT_REL, "bf16_3x logits disagree with highest")
    check(rel_fold < FOLD_REL, "folded-stem logits disagree")
    del mn32

    # timing: the bf16_3x kernel at B=512
    raw512 = normalize_rows(mn_requests[1])
    x3_ms = time_ms(lambda: fz3(raw512, pcen=False))
    x3_plain_ms = time_ms(lambda: ffz.fused_featurizer_plain(
        raw512, mel_w, cfg.hop_length, precision="bf16_3x"), iters=2,
        warmup=1)
    torch.cuda.empty_cache()
    x3_lib_ms = time_ms(lambda: library_mel(raw512), iters=3)
    x3_exact_ms = time_ms(lambda: fz(raw512, pcen=False))
    x3_frames = BATCH_PCEN * frames
    # per frame: three passes of stage 1 (131k MAC, conjugate-folded) and
    # stage 2 (524k MAC) on the tensor cores; window, power and banded mel
    # in f32 on the CUDA cores
    x3_tc_flops = x3_frames * 3 * 2 * (32 * 32 * 128 + 32 * 256 * 64)
    x3_f32_flops = x3_frames * (cfg.n_fft + 3 * 1024 + 2 * nnz)
    x3_tables = fz3.table_bytes()
    x3_bytes = (raw512.numel() * 4 + BATCH_PCEN * n_mels * frames * 4
                + x3_tables)
    x3_bound_ms, x3_bound_by = bound_ms(x3_f32_flops, x3_bytes, x3_tc_flops)
    log(f"time bf16_3x mel kernel (f32 out) B={BATCH_PCEN}: {x3_ms:.4f} ms, "
        f"plain {x3_plain_ms:.4f} ms, library stft+matmul {x3_lib_ms:.4f} "
        f"ms, exact kernel {x3_exact_ms:.4f} ms, bound {x3_bound_ms:.4f} ms "
        f"({x3_bound_by}; {x3_tc_flops / 1e9:.2f} GFLOP at the bf16 peak + "
        f"{x3_f32_flops / 1e9:.2f} GFLOP f32, {x3_bytes / 1e6:.1f} MB), "
        f"roofline share {x3_bound_ms / x3_ms:.3f} {card}")

    # the "default" tier at the official line's batch (f32 out: the PCEN
    # epilogue's input); the library call is the one timed above
    d512_ms = time_ms(lambda: fz16(raw512, pcen=False))
    d512_plain_ms = time_ms(lambda: ffz.fused_featurizer_plain(
        raw512, mel_w, cfg.hop_length, precision="default"), iters=2,
        warmup=1)
    torch.cuda.empty_cache()
    d512_flops = BATCH_PCEN * frames * bf16_frame_flops
    d512_bound = bound_ms(0.0, raw512.numel() * 4
                          + BATCH_PCEN * n_mels * frames * 4
                          + fz16.table_bytes(), d512_flops)
    log(f"time bf16-tier mel kernel (f32 out) B={BATCH_PCEN}: {d512_ms:.4f} "
        f"ms, plain {d512_plain_ms:.4f} ms, library stft+matmul "
        f"{x3_lib_ms:.4f} ms, bound {d512_bound[0]:.4f} ms ({d512_bound[1]}"
        f"), roofline share {d512_bound[0] / d512_ms:.3f} {card}")

    # the PCEN epilogue alone at the official line's batch, on the
    # "default" tier's own mel (one launch a request there)
    mel512 = fz16(raw512, pcen=False)
    pcen512_ms = time_ms(lambda: ffz.pcen_rows(mel512, fz16.pcen_params,
                                               torch.bfloat16))
    pcen512_plain_ms = time_ms(lambda: pcen(
        mel512, *fz16.pcen_params, time_axis=2,
        normalize=False).to(torch.bfloat16), iters=2, warmup=1)
    pcen512_bound = pcen_bound(mel512.numel(), 2)
    log(f"time pcen kernel (bf16 out) B={BATCH_PCEN}: {pcen512_ms:.4f} ms, "
        f"plain {pcen512_plain_ms:.4f} ms, bound {pcen512_bound[0]:.4f} ms "
        f"({pcen512_bound[1]}; {pcen512_bound[2]}), roofline share "
        f"{pcen512_bound[0] / pcen512_ms:.3f} {card}")
    del mel512
    torch.cuda.empty_cache()

    # the chain per tier, and its split into featurizer and CNN
    mn_mel = {t: make_mel_fn(cfg, device=dev, pcen=True, precision=t,
                             out_dtype=torch.bfloat16) for t in tiers}
    img3 = mn_mel["default"](mn_requests[2])[..., None].repeat_interleave(
        3, dim=-1)
    with torch.no_grad():
        cnn_ms = time_ms(lambda: mn(img3), iters=5)
    mn_chain = {}
    for tier in tiers:
        torch.cuda.reset_peak_memory_stats()
        t_ms = time_ms(lambda: mn_infer[tier](mn_requests[1]), iters=5)
        peak = torch.cuda.max_memory_allocated() / 1e9
        feat_ms = time_ms(lambda: mn_mel[tier](mn_requests[1]), iters=5)
        mn_chain[tier] = t_ms
        log(f"time PCEN -> MobileNetV2 chain, {tier} tier, B={BATCH_PCEN}: "
            f"{t_ms:.3f} ms/batch, "
            f"{BATCH_PCEN * cfg.segment_length / (t_ms / 1e3):.1f} audio-s/s, "
            f"peak memory {peak:.2f} GB; featurizer (mel + PCEN + min-max, "
            f"bf16 image) {feat_ms:.3f} ms, MobileNetV2 bf16 on the 3-channel "
            f"image {cnn_ms:.3f} ms {card}")

    # layouts: the path hands the backbone an NCHW view of NHWC data
    # (channels-last); against it, NCHW-contiguous input and channels-last
    # weights
    nchw = img3.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with torch.no_grad():
        feat_out = mn.backbone(img3.permute(0, 3, 1, 2))
        cl_out = feat_out.is_contiguous(memory_format=torch.channels_last)
        nchw_ms = time_ms(lambda: mn(nchw), iters=5)
        mn_cl = copy.deepcopy(mn).to(memory_format=torch.channels_last)
        cl_w_ms = time_ms(lambda: mn_cl(img3), iters=5)
    del feat_out, mn_cl
    log(f"time MobileNetV2 bf16 B={BATCH_PCEN} by layout: NHWC input as the "
        f"path runs it {cnn_ms:.3f} ms (backbone output channels-last: "
        f"{cl_out}), NCHW-contiguous input {nchw_ms:.3f} ms, channels-last "
        f"weights too {cl_w_ms:.3f} ms {card}")

    # a warm-up step first, and a one-element fill ahead of the chain in
    # each step: the profiler can lose the first kernel of its window, and
    # this chain's first kernel is K1's.  A profile that still lost a
    # featurizer kernel is taken again, at most twice.
    def profile_chain():
        averages = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True,
                     schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                      active=1),
                     on_trace_ready=lambda p: averages.extend([
                         p.key_averages(),
                         p.key_averages(group_by_input_shape=True)])) as prof:
            for _ in range(2):
                torch.zeros(1, device=dev)
                mn_infer["default"](mn_requests[2])
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in averages[0]
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")]
        feat = [e for e in events
                if "mel_bf16_kernel" in e.key or "pcen_kernel" in e.key]
        return averages, events, feat

    for attempt in range(3):
        averages, kernel_events, feat_events = profile_chain()
        if len(feat_events) == 2:
            break
        log(f"profile attempt {attempt + 1} lost a featurizer kernel: it "
            f"holds {[e.key[:40] for e in feat_events]}")
    check(len(feat_events) == 2, "the profile misses a featurizer kernel")
    busy_ms = sum(e.self_device_time_total for e in kernel_events) / 1e3
    feat_busy = sum(e.self_device_time_total for e in feat_events) / 1e3
    conv_busy = sum(e.self_device_time_total for e in kernel_events
                    if "conv" in e.key.lower() or "xmma" in e.key
                    or "sm90" in e.key or "sm80" in e.key) / 1e3
    log(f"profile PCEN -> MobileNetV2 chain, default tier, B={BATCH_PCEN}: "
        f"device kernels {busy_ms:.3f} ms of {mn_chain['default']:.3f} ms "
        f"(idle share {1 - busy_ms / mn_chain['default']:.3f}); K1 bf16 + "
        f"PCEN kernels {feat_busy:.3f} ms, kernels named as convolutions "
        f"{conv_busy:.3f} ms, the rest {busy_ms - feat_busy - conv_busy:.3f} "
        f"ms {card}")
    for e in sorted(kernel_events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  kernel {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<3d} "
            f"{e.key[:80]}")
    for e in sorted(averages[1], key=lambda e: -e.device_time_total):
        if e.key == "aten::cudnn_convolution" and e.device_time_total > 500:
            log(f"  conv {e.device_time_total / 1e3:9.3f} ms x{e.count:<3d} "
                f"in {e.input_shapes[:2]}")

    kernels = [
        kernel_record("fused_featurizer_mel", KERNEL_SOURCE, TPU_KERNEL,
                      main_counts["fused_featurizer_mel"], mel_err, mel_ms,
                      mel_plain_ms, (mel_bound_ms, mel_bound_by), mel_lib_ms),
        kernel_record("fused_featurizer_pcen", KERNEL_SOURCE, TPU_KERNEL,
                      pcen_counts["fused_featurizer_pcen"], pcen_err, pcen_ms,
                      pcen_plain_ms, (pcen_bound_ms, pcen_bound_by), None),
        kernel_record("fused_featurizer_mel_centered", KERNEL_SOURCE,
                      TPU_KERNEL,
                      predictor_counts[4096]["fused_featurizer_mel_centered"],
                      centered_err, cen_ms, cen_plain_ms,
                      (cen_bound_ms, cen_bound_by), cen_lib_ms),
        kernel_record("power_mel", MELSPEC_SOURCE, MELSPEC_TPU_KERNEL,
                      predictor_counts[2048]["power_mel"], pm_err, pm_ms,
                      pm_plain_ms, (pm_bound_ms, pm_bound_by), pm_lib_ms),
        kernel_record("fused_featurizer_mel_bf16", KERNEL_SOURCE, TPU_KERNEL,
                      train_counts["fused_featurizer_mel_bf16"], bf16_err,
                      mel_bf16_ms, mel_bf16_plain_ms,
                      (bf16_bound_ms, bf16_bound_by), mel_bf16_lib_ms),
        kernel_record("fused_featurizer_mel_bf16x3", KERNEL_SOURCE,
                      TPU_KERNEL,
                      mn_counts["bf16_3x"]["fused_featurizer_mel_bf16x3"],
                      x3_err, x3_ms, x3_plain_ms, (x3_bound_ms, x3_bound_by),
                      x3_lib_ms),
        kernel_record("fused_featurizer_mel_bf16 at B=512", KERNEL_SOURCE,
                      TPU_KERNEL,
                      mn_counts["default"]["fused_featurizer_mel_bf16"],
                      bf16_err, d512_ms, d512_plain_ms, d512_bound,
                      x3_lib_ms),
        kernel_record("fused_featurizer_pcen at B=512", KERNEL_SOURCE,
                      TPU_KERNEL,
                      mn_counts["default"]["fused_featurizer_pcen"],
                      pcen_err, pcen512_ms, pcen512_plain_ms,
                      pcen512_bound[:2], None),
    ]
    # ---- 8. the folded badwinner2 chain; 9. the megakernel probe --------
    kernels += folded_chain_phase(dev, cfg, mel_np, fz, clips, card)
    kernels += probe_phase(dev, card)
    # ---- 10. training from a built corpus --------------------------------
    corpus_train_phase(dev, cfg, card, step_ms, fit_s)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
