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

11. evaluation and deployment of phase 10's run: ``cli/freeze`` (-w
   chkpt; the deployment's metadata ``frozen`` with display labels and
   ``ebird_ids``, its window probabilities on phase 4's recording bitwise
   the run's); 12 recordings of 20 s at 48 kHz (tone bursts of one
   species each over noise, one sidecar track each) through ``cli/evaluate
   strong`` and, as ``<label>/<audio>``, ``weak`` (8 spawned workers, host
   detection), each with the launch counts zeroed just before and read
   just after: one centered K1 ``mel_power`` launch a window batch (the
   batches counted where ``Predictor.predict_windows`` takes them), no
   other K1 or K2 launch; the strong mean confusion holding every track,
   and its three confusions equal to ``--device cpu``'s but for tracks
   with a probability within 1e-4 of the 0.7 threshold (counted); the weak
   mean confusion holding every file; ``cli/evaluate thresholds`` on phase
   10's test dump driving ``cli/predict --thresholds-json``;
   ``cli/ebirdgrid`` on a two-square KML and an observations file, then
   ``cli/predict --grid --lat --lng --month --threshold 0`` listing only the
   square's species and the kept non-species labels (all labels without
   the grid); ``cli/predict --denoise`` giving finite tracks; timing: each
   evaluation's recording-s/s and host share (the wall time outside
   ``predict_windows``), ``spectral_gate`` on the 60 s recording on the
   card and on the host CPU, the freeze's wall time;
12. the model families: the reference's default backbone on the PCEN chain
   at full width (waveform -> K1's "default" tier with its PCEN epilogue,
   bf16 image -> 3-channel repeat ->
   ``BackboneClassifier(efficientnetv2b3, external_frontend=True)`` bf16,
   62 labels, B=512, seeded weights) answering 3 requests through
   ``make_fused_infer_fn``, one "default" and one PCEN launch each and no
   other K1 or K2 launch; f32 logits at B=8 of the kernel path against the
   plain featurizer (1e-4); ``fold_gray_stem`` refusing the model with its
   baked preprocessing and, built with ``preprocess=False``, the folded
   1-channel stem against the 3-channel repeat (1e-5); timing of the chain
   (ms, audio-s/s, peak memory, featurizer / CNN split, a profile with the
   idle share) beside phase 7's MobileNetV2 chain; a sweep of every other
   backbone (behind K1's "default" tier and PCEN) and of badwinner2-res,
   badwinner, wr-resnet and wr-resnet-bird (behind K1's exact tier, their
   own frontends) once each at B=64 in bf16 with its launch counts, finite
   logits and ms a batch (two readings of ``SWEEP_ITERS`` calls, each with
   its host issue time); the sweep's K1 kernels at B=64 against their plain
   versions on its clips (the "default" tier and PCEN at phase 6's and 3's
   limits, the exact tier at phase 3's) and one mel family's f32 logits
   against the plain featurizer (1e-4); the training tiers at B=32 on
   normalized tone clips the same way; ``cli/train --model-name
   efficientnetv2b3`` on phase 10's corpus (1 epoch x 4 steps, B=32, its
   own PCEN layer; one bf16 launch a train step, one exact launch a
   validation and test batch; finite, falling step losses) and
   ``cli/predict.load_predictor`` on the run, predicting phase 4's
   recording.  The B3 chain's launches are added to phase 7's B=512 records
   of the two kernels, one record a kernel shape;
13. the rest of training: K2 at dual-badwinner2's two view shapes (B=8
   and 128: ``(B, 518, 1025)`` against the band-masked ``(1025, 160)``
   bank, ``(B, 515, 513)`` against ``(513, 160)``; global relative error
   < 1e-5) timed with its plain version, ``torch.matmul`` and the STFT
   that feeds it; ``cli/train --model-name dual-badwinner2`` on phase 10's
   corpus (bf16, B=128, 1 epoch x 4 steps; two K2 launches a train step
   and a validation / test batch, no K1; falling step losses), its step
   on an in-memory batch (ms, samples/s, peak memory, split into
   featurize / forward / backward / Adam) and one f32 step at B=8 through
   K2 against the plain views (loss 1e-5 relative, eval logits 1e-4); a
   corpus written with short / mid features and 1280-d embeddings
   (``build/chip_smoke_vectors/``) and on it ``cli/train`` of merge (one
   K1 "default" launch a train step, one exact launch a validation / test
   batch, falling losses, the test confusion; K1's two tiers held at
   B=128 first), cnn-features and embeddings (no kernel launch); the
   badwinner2 step with and without remat (f32 B=8: parameters and BN
   statistics within 1e-6, the dropout generator's state equal; bf16
   B=128: ms and peak memory of both); SpecAugment on an augmented batch
   (its draws inside JAX's limits, the masked image zero there and the
   unmasked image elsewhere, ms).  rf-features is host code (scikit-learn)
   and runs in the CPU tests.  K2's records gain the two view shapes.
14. building a corpus: a raw corpus of 96 float32 WAVs of 20 s at 48 kHz
   with sidecar ``.txt`` metadata (8 species x 12 recordings, a species
   tone track and a noise track of 8 s each, no RMS metadata; from a numpy
   seed), built by the port's ``cli/build`` (production geometry,
   ``--dont-tighten-tracks --dont-filter-rms``) with 1 and with 4 worker
   processes, each timed (wall s, recordings/s, clips/s) and checked: every
   record of ``training-meta.json``'s counts written, the port's
   ``RecordStream`` reading the meta's counts of the trained labels split
   by split, the two builds' meta byte-identical; ``cli/train`` of
   badwinner2 on the 4-worker build (bf16, B=128, 1 epoch x 4 steps; one
   ``mel_bf16`` launch a train step, one exact launch a validation and a
   test batch; finite losses; ms a step with the loader); ``cli/predict
   --test-split <meta> --data-dir <raw> --confusion-out`` on the run (one
   centered K1 launch a test recording with windows; the confusion holding
   every test sample the run maps, the build's sampling reproduced by the
   same seeded generators) and the same call on 2 test recordings on the
   card and with ``--device cpu``, the confusions equal.  K1's training
   and centered records gain phase 14's launches.
15. preparing a corpus: phase 14's raw corpus enriched in place by
   ``cli/ingest --signal --rms --tracks`` in its own interpreter, with one
   worker on the first 16 recordings and then with 4 on all 96 at the same
   path (each timed; a worker's start-up timed and checked torch-free;
   every sidecar with signal spans and a best track, every track with its
   three RMS arrays, the 16 sidecars byte-identical between the runs);
   ``--gen-tracks`` on 8 copies whose sidecars carry a ``label`` and no
   tracks (each gains tagged tracks); ``cli/build`` at its defaults
   (tracks tightened and filtered by RMS; records against
   ``training-meta.json`` and ``RecordStream``); ``cli/debug`` of the
   build on the card (one exact tf launch a batch, no NaN or constant
   sample; its check on 2 batches equal to ``--device cpu``'s);
   ``cli/augment`` of the build (every mixed record read back);
   ``utils/profiling`` around 3 requests of phase 4's chain (a trace that
   left out a launch taken again, at most twice; every launch recorded,
   ``mel_power_kernel`` in the summary within 25% of phase 5's time, the
   condense conv's kernels in the layer map, ``time_fn`` within 10% of
   phase 5's chain, the memory peak).  K1's exact tf record gains
   ``cli/debug``'s launches.
16. data parallel (``parallel/``): two ranks spawned on ``cuda:0`` over
   gloo (the port's form of JAX's forced virtual devices; the card is
   named twice, so ``make_mesh`` picks gloo), badwinner2 f32 at full width
   (62 labels, 160 mels x 513 frames) from seeded weights, B=128 global
   (64 a rank) with mixup: one ``train_step`` through K1's ``"default"``
   tier against the single-process step on the same weights and batch
   (TF32 off): |loss difference|, the largest relative gradient and
   running-statistic differences, the two ranks' parameters after Adam
   (identical), each rank's BatchNorm kernel launches (a statistics
   finalize before and one after the all-reduce of the sums); each of the
   step's BatchNorms alone (phase 5's layouts) at B=8, the ranks' rows on
   the kernels under the mesh against one process of the same kernels on
   the whole batch at the card tests' limits (y, dx, the summed parameter
   gradients, each rank's running statistics, its launches); the same
   step in float64 on CPU ranks against one CPU process; a later step's all-reduced elements (counted by
   ``parallel.audit``) against the audit's budget and JAX's 4,729,891
   (``MULTICHIP_r05.json``); each rank's step ms beside the single
   process's (two ranks share one card: no scaling is measured); the
   sharded Predictor on 67 windows (K1 centered, padded to 128) against the
   unsharded one, the gather its only collective; ``train_run`` over the
   mesh (``mesh_devices``: the card twice) on phase 10's corpus, one step
   of B=128 global at f32 and learning rate 0 with BN re-estimation and
   the confusions, against the single-device run: the train and
   validation losses, the test predictions, one run directory with its
   artifacts, the ranks' K1 launches (the sharded loaders, ``fit``'s
   mesh, the evaluation passes' tails).  The same over NCCL on ``cuda:0``
   / ``cuda:1`` where the machine has two cards.  ``cli/train
   --data-shards`` starts one rank a card and so needs two cards: not run
   on one.  The ranks' K1 launches join the training, exact and centered
   records;
17. the TensorFlow bridges (``models/transplant``, ``infer/embeddings``).
   The card's machine has no TensorFlow, so the Keras models are
   stand-ins built here (:func:`keras_stand_in`: plain objects whose class
   names are Keras's layer names, holding a seeded port model's tensors in
   Keras's layouts, in its call order): (a) badwinner2 at the production
   geometry transplanted into a model of other seeded weights, every
   tensor bitwise its source's, served through K1's folded exact chain
   (3 requests of B=256, one min-max and one folded mel launch each), the
   folded mel against its plain version on the CPU (phase 3's limit) and
   the f32 logits against the CPU's plain path of the same state (1e-4);
   (b) an EfficientNetV2-B3 trunk transplanted into the PCEN classifier at
   full width (its backbone bitwise the source's, PCEN and head kept), one
   train step at B=32 (one K1 "default" launch) and the chain at B=512
   (K1 "default" + PCEN, one launch each, held to their plain versions at
   phase 6's and 3's limits); (c) an ``EmbeddingPredictor`` with a numpy
   Perch stand-in (32 kHz, 5 s windows, 1280-d) and a seeded
   ``LinearEmbeddings`` head on the card over phase 4's recording: tracks
   equal to the CPU run's, probabilities within 1e-5, recording-s/s and
   the host's share; (d) without TensorFlow, ``load_keras_backbone``,
   ``PerchModel``, ``cli/predict --embedding-model`` and ``cli/train
   --backbone-weights`` fail as the JAX package's do (where TensorFlow
   imports, the real ``load_keras_backbone`` path runs instead).  Its K1
   launches join the exact-folded, "default" and PCEN records.
18. train-mode BatchNorm (``ops/cuda/batch_norm.py``, run after phase 9)
   at the training cell's BatchNorms as phase 5's step runs them
   (badwinner2 at B=128; shape, strides and dtype read by a hook on each
   ``KerasBatchNorm``): ``mel_bn`` (f32, per mel row), five conv
   BatchNorms (bf16 channels-last) and the head's two (bf16 NCHW), each
   forward and backward against ``KerasBatchNorm.train_plain`` on the same
   input (tests/test_torch_gpu.py's limits), each kernel's launches
   (counted around one pass, times the step's BatchNorms of that layout),
   its error (the running statistics of the statistics kernel, y of the
   apply, the parameter gradients of the backward reduce, dx of the
   backward apply) and its device time from a profile against its byte
   bound and against PyTorch's own kernel for the same work (the family
   SyncBatchNorm builds: ``torch.batch_norm_stats`` and its three
   siblings), the pass against the plain version's and the library's.
   Phase 5 checks a badwinner2 training step's launches: each kernel once
   a BatchNorm, 8 in all.
19. the eval conv epilogue (``ops/cuda/conv_epilogue.py``, run after phase
   12) at badwinner2's ``bns.0`` (256, 64, 158, 511), bf16 channels-last,
   and ``bns.5-6`` (256, 1024, 1, 46), bf16 NCHW as the training step
   writes them (the middle layout's kernel, which an NCHW eval input
   takes), with LeakyReLU before the BatchNorm; B3's expand (512, 160, 40, 129) and head (512, 1536, 5, 17)
   with SiLU after it and a B3 projection with its residual
   (512, 40, 40, 129), bf16 channels-last: the kernel against its plain
   version (tests/test_torch_gpu.py's limits) and its device time from a
   profile against its byte bound (one read of the conv output and the
   residual, one write) and against the PyTorch passes it replaces (the
   bias add, ``F.batch_norm``, the activation and the residual add).  A
   record's launches are its kernel's, counted where they launch in the
   serving chains that run its shape: phase 4's badwinner2 request through
   ``make_fused_infer_fn`` at B=256 (7 epilogues) and phase 12's three B3
   requests at B=512 (87 each).  Both chains write every conv's output
   channels-last, so the middle kernel's record counts no launch there.

It prints one JSON line of kernel records, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and last
``{"ok": true, "device": {...}}``.  There is no CPU mode: without a CUDA
card it fails.
"""

from __future__ import annotations

import contextlib
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
FAMILY_BATCH = 64  # phase 12's sweep of the other families
REST_STEPS = 4  # train steps of each phase 13 run (1 epoch)
SWEEP_ITERS = 10  # calls in each of the sweep's two timed readings
B3_TRAIN_BATCH = 32  # the JAX TrainConfig's default batch
B3_TRAIN_STEPS = 4
# phase 10's corpus: clips and GZIP shards a split, species, the run
CORPUS_SPLITS = {"train": (384, 4), "validation": (128, 2), "test": (128, 2)}
CORPUS_SPECIES = 12
# phase 11's annotated recordings: one a species of phase 10's corpus
EVAL_RECORDINGS = 12
EVAL_SECONDS = 20.0
CORPUS_EPOCHS, CORPUS_STEPS = 2, 4
# phase 14's raw corpus: species, recordings a species, seconds a
# recording, the two tracks' length; the builds' worker counts; the run
BUILD_SPECIES = 8
BUILD_RECORDINGS = 12
BUILD_SECONDS = 20.0
BUILD_TRACK_S = 8.0
BUILD_WORKERS = (1, 4)
BUILD_STEPS = 4
BUILD_CPU_RECORDINGS = 2  # test recordings predicted on the CPU too
# phase 15: enrichment's worker counts and the recordings of its 1-worker
# run, the untracked copies for --gen-tracks, cli/debug's most batches and
# the CPU comparison's, and the profile's limits against phase 5's times
TOOLS_WORKERS = 4
TOOLS_ONE_WORKER_RECORDINGS = 16
GEN_TRACKS_RECORDINGS = 8
DEBUG_BATCHES = 16
DEBUG_CPU_BATCHES = 2
PROFILE_KERNEL_REL = 0.25
PROFILE_CHAIN_REL = 0.10
# phase 16: ranks, the Predictor's windows, timed steps; the ranks' f32
# step against one process's on the same weights and batch (TF32 off): the
# loss to 1e-5 relative, running statistics to 1e-4 of each tensor's max,
# the gradients' largest relative difference printed: f32 train-mode
# BatchNorm gradients of the seeded badwinner2 are themselves up to 5.8e-2
# of a tensor's max from float64 ones (the CPU at B=4, one process or two
# alike), so the gradients are held in float64 at B=8 (4 a rank), on the
# CPU (the card's train-mode BatchNorm kernels take bf16 and f32), where
# only summation order and the f32 logits separate the two runs (the CPU
# rehearsal at B=4: 7.8e-7): gradients and statistics to 1e-5 of each
# tensor's max, and Adam's update to 1e-3 of lr wherever the gradient is
# clear of that (above 1e-3 of its tensor's max: Adam's first step, lr * g
# / (|g| + eps), turns a tiny difference near g = 0 into a full lr); the
# sharded probabilities as JAX's dry run holds them
# (__graft_entry__.py:223); the group's timeout
DP_RANKS = 2
DP_BATCH = TRAIN_BATCH
DP_WINDOWS = 67
DP_TIMED_STEPS = 5
DP_F64_BATCH = 8
DP_BN_BATCH = 8  # the BatchNorm kernels under the mesh: 4 rows a rank
DP_LOSS_REL = 1e-5
DP_STAT_REL = 1e-4
DP_F64_REL = 1e-5
DP_PROB_RTOL, DP_PROB_ATOL = 2e-5, 2e-6
DP_TIMEOUT_S = 300.0
DP_JAX_ALL_REDUCED = 4_729_891  # MULTICHIP_r05.json, params 4,720,767
# phase 16's train_run on phase 10's corpus: one step of B=128 global at
# f32 and learning rate 0 (its numbers then follow the data path alone),
# against the single-device run: the train and validation losses to
# DP_LOSS_REL, the test predictions (after BN re-estimation, whose
# statistics differ in f32 summation order) to 1e-4 / 1e-5
DP_RUN_STEPS = 1
DP_RUN_RTOL, DP_RUN_ATOL = 1e-4, 1e-5
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
# Phase 13: one f32 dual-badwinner2 step through K2 against the plain views
# (K2 is exact f32, off its plain version by summation order alone): the
# loss to 1e-5 relative, the eval logits to 1e-4 of max |logit|; the remat
# step against the plain step, every parameter and BN statistic to 1e-6
# relative of the tensor's max (the recompute replays the same kernels)
DUAL_LOSS_REL = 1e-5
DUAL_LOGIT_REL = 1e-4
REMAT_REL = 1e-6
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
BN_SOURCE = "audio_training_tpu_torch/csrc/batch_norm.cu"
PROFILE_PRE_ROLL = 128  # utils/profiling.trace's _PRE_ROLL
# phases 16 and 18 take the training step's BatchNorms as phase 5 finds
# them (shape, strides, dtype, feature dim, scale and bias); the limits are
# tests/test_torch_gpu.py's
BN_BF16_STEP = 2.0 ** -7
BN_BF16_OFF = 0.01
BN_F32_REL = 1e-5
BN_GRAD_REL = 1e-4
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


def profile_pcen_chain(run, dev):
    """A profile of one ``run()`` of a PCEN chain: (key averages, then
    grouped by input shape; its device kernels; the K1 "default" and PCEN
    kernels among them).  A warm-up step first, and a one-element fill
    ahead of the chain in each step: the profiler can lose the first kernel
    of its window, and the chain's first kernel is K1's.  A profile that
    still lost a featurizer kernel is taken again, at most twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
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
                run()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in averages[0]
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")]
        feat = [e for e in events
                if "mel_bf16_kernel" in e.key or "pcen_kernel" in e.key]
        if len(feat) == 2:
            break
        log(f"profile attempt {attempt + 1} lost a featurizer kernel: it "
            f"holds {[e.key[:40] for e in feat]}")
    check(len(feat) == 2, "the profile misses a featurizer kernel")
    return averages, events, feat


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


def bn_spec(name: str, module, x) -> dict:
    """What phases 16 and 18 need of one BatchNorm call of the training
    step: the module's name, its input's shape, strides and dtype, the
    feature dim, scale and bias."""
    return {"name": name, "shape": tuple(x.shape), "strides": x.stride(),
            "dtype": str(x.dtype).removeprefix("torch."),
            "feature_dim": module.feature_dim,
            "scale": module.weight is not None,
            "bias": module.bias is not None}


def bn_groups(specs: list[dict]) -> list[tuple[dict, list[str]]]:
    """The step's BatchNorm calls grouped by all but their names, in the
    step's order: ``(spec, names)``."""
    groups: dict[tuple, tuple[dict, list[str]]] = {}
    for spec in specs:
        key = tuple((k, v) for k, v in spec.items() if k != "name")
        groups.setdefault(key, (spec, []))[1].append(spec["name"])
    return list(groups.values())


def bn_case(spec: dict, batch: int, dev):
    """A train-mode KerasBatchNorm of ``spec`` on ``dev`` (seeded scale and
    bias), an input of ``batch`` rows (per-channel offsets and scales) and
    an output gradient, both laid out in memory as the step's input."""
    import torch

    from audio_training_tpu_torch.models.layers import KerasBatchNorm

    fdim, dtype = spec["feature_dim"], getattr(torch, spec["dtype"])
    shape = (batch, *spec["shape"][1:])
    c = shape[fdim]
    g = torch.Generator().manual_seed(SEED)
    m = KerasBatchNorm(c, fdim, spec["scale"], spec["bias"]).to(dev).train()
    with torch.no_grad():
        for t in (m.weight, m.bias):
            if t is not None:
                t.copy_(torch.rand(c, generator=g) + (0.5 if t is m.weight
                                                      else -0.5))
    view = [1] * len(shape)
    view[fdim] = c
    order = sorted(range(len(shape)), key=lambda d: -spec["strides"][d])
    back = [order.index(d) for d in range(len(shape))]

    def laid(t):
        return (t.to(dtype).permute(order).contiguous().permute(back)
                .to(dev))

    x = laid(torch.randn(shape, generator=g)
             * (torch.rand(c, generator=g) + 0.5).view(view)
             + (torch.rand(c, generator=g) - 0.5).view(view))
    return m, x, laid(torch.randn(shape, generator=g))


def bn_pass(m, x, dy, plain: bool = False) -> dict:
    """One forward and backward of a copy of ``m``: its kernels, or the
    ``plain`` version (``KerasBatchNorm.train_plain``).  Returns y, dx,
    the parameter gradients and the running statistics after it."""
    import torch

    m = copy.deepcopy(m)
    xr = x.detach().requires_grad_()
    params = [t for t in (m.weight, m.bias) if t is not None]
    y = m.train_plain(xr, m.weight, m.bias) if plain else m(xr)
    dx, *grads = torch.autograd.grad(y, [xr, *params], dy)
    return {"y": y, "dx": dx, "grads": grads,
            "stats": [m.running_mean, m.running_var]}


def bn_errors(got: dict, want: dict) -> dict:
    """Each output's largest error relative to the max of ``want``'s (the
    parameter gradients' and the running statistics' largest of their
    tensors; None without parameters), and the share of y and dx values
    that differ at all."""
    def rel(a, b):
        b = b.to(a.device).float()
        return ((a.float() - b).abs().max() / b.abs().max()).item()

    def off(a, b):
        return (a.float() != b.to(a.device).float()).float().mean().item()

    return {"y": rel(got["y"], want["y"]), "dx": rel(got["dx"], want["dx"]),
            "grads": max((rel(a, b) for a, b in zip(got["grads"],
                                                    want["grads"])),
                         default=None),
            "stats": max(rel(a, b) for a, b in zip(got["stats"],
                                                   want["stats"])),
            "y_off": off(got["y"], want["y"]),
            "dx_off": off(got["dx"], want["dx"])}


def bn_within(errs: dict, dtype: str) -> tuple[bool, str]:
    """Whether ``bn_errors``' numbers keep the card tests' limits, and the
    numbers beside their limits."""
    bf16 = dtype == "bfloat16"
    out_lim = BN_BF16_STEP if bf16 else BN_F32_REL
    ok = (errs["y"] <= out_lim and errs["dx"] <= out_lim
          and (errs["grads"] is None or errs["grads"] <= BN_GRAD_REL)
          and errs["stats"] <= BN_F32_REL
          and (not bf16 or max(errs["y_off"], errs["dx_off"]) <= BN_BF16_OFF))
    grads = "none" if errs["grads"] is None else f"{errs['grads']:.2e}"
    text = (f"y {errs['y']:.2e}, dx {errs['dx']:.2e} (limit {out_lim}), "
            f"parameter gradients {grads} (limit {BN_GRAD_REL}), running "
            f"statistics {errs['stats']:.2e} (limit {BN_F32_REL}) of the "
            f"max" + (f"; share of y and dx off {errs['y_off']:.2e} / "
                      f"{errs['dx_off']:.2e} (limit {BN_BF16_OFF})"
                      if bf16 else ""))
    return ok, text


# PyTorch's own kernels for each BatchNorm kernel's work (SyncBatchNorm's
# family), found by a substring of the kernel's name
BN_LIBRARY_KERNELS = {"statistics": "collect_statistics",
                      "apply": "transform_input",
                      "backward_reduce": "backward_reduce",
                      "backward_apply": "backward_elemt"}


def bn_library_run(m, x, dy):
    """The same forward and backward by PyTorch's own train-mode BatchNorm
    kernels, the family SyncBatchNorm builds (``torch.batch_norm_stats``,
    ``batch_norm_elemt``, ``batch_norm_backward_reduce``,
    ``batch_norm_backward_elemt``), with Flax's running update: a function
    of no arguments returning y and dx.  Their variance is Welford's, not
    Flax's fast one, so phase 18 times them beside the kernels."""
    import torch

    from audio_training_tpu_torch.models.layers import BN_MOMENTUM

    fdim = m.feature_dim
    xm, dym = x.movedim(fdim, 1), dy.movedim(fdim, 1)
    count = torch.full((1,), x.numel() // x.shape[fdim], dtype=torch.int32,
                       device=x.device)
    w, b = m.weight, m.bias
    rm, rv = m.running_mean.clone(), m.running_var.clone()

    def run():
        mean, invstd = torch.batch_norm_stats(xm, m.eps)
        rm.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
        rv.mul_(BN_MOMENTUM).add_(invstd.pow(-2) - m.eps,
                                  alpha=1.0 - BN_MOMENTUM)
        y = torch.batch_norm_elemt(xm, w, b, mean, invstd, m.eps)
        sum_dy, sum_dy_xmu, _, _ = torch.batch_norm_backward_reduce(
            dym, xm, mean, invstd, w, True, w is not None, b is not None)
        dx = torch.batch_norm_backward_elemt(dym, xm, mean, invstd, w,
                                             sum_dy, sum_dy_xmu, count)
        return y.movedim(1, fdim), dx.movedim(1, fdim)

    return run


def profile_device_ms(fn, reps: int) -> dict[str, float]:
    """Device ms a call of ``fn`` by kernel name, from a profile of
    ``reps`` calls after one warm-up (the profiler's own ``ProfilerStep*``
    range, which spans the kernels, left out).  The warm-up step starts
    with :data:`PROFILE_PRE_ROLL` one-element fills, past the kernels a
    profiler can lose after it is enabled (``utils/profiling.trace``
    does the same)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    events = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                  active=1),
                 on_trace_ready=lambda p: events.extend(
                     p.key_averages())) as prof:
        for fills in (PROFILE_PRE_ROLL, 1):
            for _ in range(fills):
                torch.zeros(1, device="cuda")
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    out: dict[str, float] = {}
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("ProfilerStep")):
            out[e.key] = (out.get(e.key, 0.0)
                          + e.self_device_time_total / 1e3 / reps)
    return out


def batch_norm_phase(dev, card, step_bns: list[dict]) -> list[dict]:
    """Phase 18: train-mode BatchNorm's kernels at the training cell's
    BatchNorms as phase 5's step ran them (``step_bns``, badwinner2 at
    B=128: the per-mel-row ``mel_bn`` in f32, five conv BatchNorms in bf16
    channels-last, the head's two in bf16 NCHW): each against its plain
    version (``KerasBatchNorm.train_plain``) at the card tests' limits,
    each kernel's launches (counted around one pass, times the step's
    BatchNorms of that layout) and device time (a profile of 3 forward and
    backward passes) against its byte bound and PyTorch's own kernel for
    the same work, and the whole forward and backward against the plain
    version's and the library's.  Returns a kernel record a kernel and
    layout."""
    import torch

    from audio_training_tpu_torch.ops.cuda import batch_norm as bn_ops

    records, total, total_plain, total_lib, total_bound = [], 0.0, 0.0, 0.0, 0.0
    for spec, names in bn_groups(step_bns):
        times, label = len(names), " / ".join(names)
        m, x, dy = bn_case(spec, spec["shape"][0], dev)
        check(bn_ops.layout(x.shape, x.stride(), spec["feature_dim"])
              == bn_ops.layout(spec["shape"], spec["strides"],
                               spec["feature_dim"]),
              f"phase 18's {label} is not laid out as the step's")
        bn_ops.reset_launch_counts()
        got = bn_pass(m, x, dy)
        torch.cuda.synchronize()
        per_pass = bn_ops.launch_counts()
        errs = bn_errors(got, bn_pass(m, x, dy, plain=True))
        ok, text = bn_within(errs, spec["dtype"])
        log(f"check BatchNorm {label} {spec['shape']} {spec['dtype']} "
            f"feature_dim {spec['feature_dim']}, (outer, C, inner) "
            f"{bn_ops.layout(x.shape, x.stride(), spec['feature_dim'])}: "
            f"{text}; launches a pass {per_pass}")
        check(ok, f"BatchNorm kernels disagree with plain at {label}")
        check(per_pass == dict.fromkeys(bn_ops.COUNTERS, 1),
              f"not one launch of each BatchNorm kernel a pass at {label}")
        # each kernel's error: the running statistics of the statistics
        # kernel and its finalize, y of the apply, the parameter gradients
        # of the backward reduce and finalize (dx where there are none:
        # the sums feed dx alone), dx of the backward apply
        kernel_err = {"statistics": errs["stats"], "apply": errs["y"],
                      "backward_reduce": (errs["dx"] if errs["grads"] is None
                                          else errs["grads"]),
                      "backward_apply": errs["dx"]}

        def run(plain=False):
            xr = x.detach().requires_grad_()
            params = [t for t in (m.weight, m.bias) if t is not None]
            y = (m.train_plain(xr, m.weight, m.bias) if plain else m(xr))
            return torch.autograd.grad(y, [xr, *params], dy)

        reps, dev_ms = 3, {}
        for key, ms in profile_device_ms(run, reps).items():
            key = key.replace(" ", "")
            bwd = key.split(">")[0].endswith("true")
            for stem, kname in (("reduce_", ("statistics", "backward_reduce")),
                                ("apply_", ("apply", "backward_apply")),
                                ("finalize", ("finalize", "finalize"))):
                if f"::{stem}" in key:
                    dev_ms[kname[bwd]] = dev_ms.get(kname[bwd], 0.0) + ms
        n, es = x.numel(), x.element_size()
        nbytes = {"statistics": n * es, "apply": 2 * n * es,
                  "backward_reduce": 2 * n * es, "backward_apply": 3 * n * es}
        check(all(k in dev_ms for k in nbytes),
              f"the profile of BatchNorm {label} misses a kernel: {dev_ms}")
        pass_ms = time_ms(run, iters=5)
        plain_ms = time_ms(lambda: run(plain=True), iters=3)
        # PyTorch's own kernels for the same work
        lib_ms, lib_pass_ms = {}, None
        try:
            lib = bn_library_run(m, x, dy)
            y_lib, dx_lib = lib()
            lib_err = [((a.float() - b.float()).abs().max()
                        / b.float().abs().max()).item()
                       for a, b in zip((y_lib, dx_lib), (got["y"], got["dx"]))]
            del y_lib, dx_lib
            lib_kernels = profile_device_ms(lib, reps)
            for key, ms in lib_kernels.items():
                for kname, stem in BN_LIBRARY_KERNELS.items():
                    if stem in key:
                        lib_ms[kname] = lib_ms.get(kname, 0.0) + ms
                lib_ms["all"] = lib_ms.get("all", 0.0) + ms
            for key, ms in sorted(lib_kernels.items(), key=lambda kv: -kv[1]):
                log(f"  library kernel {ms:9.4f} ms {key[:100]}")
            lib_pass_ms = time_ms(lib, iters=5)
            lib_text = (f"PyTorch's kernels (SyncBatchNorm's family) "
                        f"{lib_pass_ms:.4f} ms a pass, device "
                        f"{lib_ms['all']:.4f} ms: "
                        + ", ".join(f"{k} {lib_ms.get(k, 0.0):.4f}"
                                    for k in nbytes)
                        + f"; their y and dx {lib_err[0]:.2e} / "
                        f"{lib_err[1]:.2e} of the max from the kernels'")
        except RuntimeError as e:  # a dtype or layout the library refuses
            lib_text = (f"PyTorch's kernels refused it: "
                        f"{str(e).splitlines()[0]}")
        total += times * pass_ms
        total_plain += times * plain_ms
        total_lib += times * (lib_pass_ms or 0.0)
        total_bound += times * sum(nbytes.values()) / PEAK_BYTES_S * 1e3
        bound = sum(nbytes.values()) / PEAK_BYTES_S * 1e3
        log(f"time BatchNorm {label} {spec['shape']} ({times} in the step): "
            f"forward and backward {pass_ms:.4f} ms (bound {bound:.4f}, "
            f"share {bound / pass_ms:.3f}), plain {plain_ms:.4f} ms; by "
            f"kernel "
            + ", ".join(f"{k} {dev_ms[k]:.4f} ms (bound "
                        f"{nbytes[k] / PEAK_BYTES_S * 1e3:.4f})"
                        for k in nbytes)
            + f", finalizes {dev_ms.get('finalize', 0.0):.4f} ms; "
            f"{lib_text} {card}")
        for kname, nb in nbytes.items():
            records.append(kernel_record(
                f"batch_norm {kname} {label}", BN_SOURCE,
                "none (Flax's BatchNorm is left to XLA)",
                per_pass[kname] * times, kernel_err[kname], dev_ms[kname],
                plain_ms, (nb / PEAK_BYTES_S * 1e3, "bytes"),
                lib_ms.get(kname)))
        del x, dy, m, got
        torch.cuda.empty_cache()
    log(f"time BatchNorm, the step's {len(step_bns)} at B={TRAIN_BATCH}: "
        f"kernels {total:.3f} ms, bound {total_bound:.3f} ms, plain "
        f"{total_plain:.3f} ms, PyTorch's kernels {total_lib:.3f} ms {card}")
    return records


# phase 19's shapes: (name, conv output, channels-last, activation, slope,
# activation first, residual, the serving chain that runs the shape)
EPILOGUE_SHAPES = (
    ("badwinner2 bns.0", (256, 64, 158, 511), True, "leaky_relu", 0.01,
     True, False, "badwinner2"),
    ("badwinner2 bns.5-6", (256, 1024, 1, 46), False, "leaky_relu", 0.01,
     True, False, "badwinner2"),
    ("B3 expand", (512, 160, 40, 129), True, "silu", 0.0, False, False,
     "B3"),
    ("B3 head", (512, 1536, 5, 17), True, "silu", 0.0, False, False, "B3"),
    ("B3 project + residual", (512, 40, 40, 129), True, None, 0.0, False,
     True, "B3"),
)


def conv_epilogue_phase(dev, card,
                        launches: dict[str, dict[str, int]]) -> list[dict]:
    """Phase 19: the eval conv epilogue at :data:`EPILOGUE_SHAPES` (bf16):
    against its plain version at the card tests' limits, its device time
    (a profile of 3 calls) against its byte bound and the PyTorch passes
    it replaces.  ``launches`` holds the ``conv_epilogue`` counts of the
    serving chains (phases 4 and 12) by chain; a record's launches are
    its kernel's there.  Returns a kernel record a shape."""
    import torch
    import torch.nn.functional as F

    from audio_training_tpu_torch.ops.cuda import conv_epilogue as ce

    records = []
    g = torch.Generator(device=dev).manual_seed(SEED)
    for (name, shape, channels_last, act, slope, first, with_res,
         chain) in EPILOGUE_SHAPES:
        c = shape[1]
        fmt = torch.channels_last if channels_last else torch.contiguous_format
        x = torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16).contiguous(memory_format=fmt)
        res = (torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16).contiguous(memory_format=fmt)
            if with_res else None)
        b, mean, w, beta = (torch.randn(c, generator=g, device=dev) * 0.5
                            for _ in range(4))
        var = torch.rand(c, generator=g, device=dev) + 0.5
        w = w.abs() + 0.5
        args = (b, mean, var, w, beta, 1e-3, act, slope, first, res)
        got = ce.eval_epilogue(x, *args)
        want = ce.eval_epilogue_plain(x, *args)
        off = (got.float() - want.float()).abs()
        err = (off.max() / want.float().abs().max()).item()
        share = (off > 0).float().mean().item()
        del want
        log(f"check conv epilogue {name} {shape}: {err:.2e} of the max "
            f"(limit {BN_BF16_STEP}), {share:.2e} of the values off (limit "
            f"{BN_BF16_OFF})")
        check(err <= BN_BF16_STEP and share <= BN_BF16_OFF,
              f"the conv epilogue disagrees with plain at {name}")
        fn = {None: lambda t: t, "silu": F.silu,
              "leaky_relu": lambda t: F.leaky_relu(t, slope)}[act]
        b16 = b.to(torch.bfloat16).view(1, c, 1, 1)

        def library():
            y = x + b16  # the conv's bias, as F.conv2d adds it
            y = (F.batch_norm(fn(y), mean, var, w, beta, False, 0.0, 1e-3)
                 if first else
                 fn(F.batch_norm(y, mean, var, w, beta, False, 0.0, 1e-3)))
            return y if res is None else y + res

        lib_err = ((library().float() - got.float()).abs().max()
                   / got.float().abs().max()).item()
        reps = 3
        kernel_ms = sum(profile_device_ms(lambda: ce.eval_epilogue(x, *args),
                                          reps).values())
        lib_kernels = profile_device_ms(library, reps)
        lib_ms = sum(lib_kernels.values())
        for key, ms in sorted(lib_kernels.items(), key=lambda kv: -kv[1]):
            log(f"  library kernel {ms:9.4f} ms {key[:100]}")
        check(kernel_ms > 0 and lib_ms > 0,
              f"the profile at {name} recorded none of the launches")
        event_ms = time_ms(lambda: ce.eval_epilogue(x, *args), iters=10)
        plain_ms = time_ms(lambda: ce.eval_epilogue_plain(x, *args), iters=2)
        nbytes = x.numel() * x.element_size() * (3 if with_res else 2)
        bound = nbytes / PEAK_BYTES_S * 1e3
        kernel = "rows" if channels_last else "mid"
        log(f"time conv epilogue {name} {shape} ({kernel}): device "
            f"{kernel_ms:.4f} ms (events {event_ms:.4f}), bound "
            f"{bound:.4f} ms (bytes, share {bound / kernel_ms:.3f}); "
            f"PyTorch's {len(lib_kernels)} passes {lib_ms:.4f} ms "
            f"({lib_ms / kernel_ms:.2f}x), their output {lib_err:.2e} of the "
            f"max from the kernel's; plain {plain_ms:.4f} ms {card}")
        records.append(kernel_record(
            f"conv_epilogue {name}", BN_SOURCE,
            "none (XLA fuses the bias, BatchNorm and activation)",
            launches[chain][kernel], err,
            kernel_ms, plain_ms, (bound, "bytes"), lib_ms))
        del x, res, got
        torch.cuda.empty_cache()
    return records


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


def write_corpus(root: Path, cfg, species: list[str],
                 vectors: bool = False) -> dict:
    """Phase 10's corpus, written by a writer made here (phases 10-13 keep
    it, so that their numbers stay comparable; phase 14 goes through the
    port's real build, ``cli/build``, from audio and sidecars) as the build
    writes it: GZIP TFRecord shards of ``schema.encode_sample`` records
    under train/, validation/ and test/, and a ``training-meta.json`` with
    the labels, the counts and the FeaturizerConfig.  Clip i of a split is
    tagged with species i mod len(species) and carries a tone at that
    species' frequency (log-spaced, 200 Hz to 10 kHz) over a noise floor,
    from a numpy seed per shard.  With ``vectors`` each record also holds
    short (68, 60) / mid (136, 3) features and a 1280-d embedding, each
    noise with a species-k offset (columns 5k.. of short, rows 11k.. of
    mid, every len(species)-th element from k of the embedding).  Shards
    are written by one thread each (zlib releases the interpreter lock).
    Returns the per-split counts."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from audio_training_tpu_torch.config import config_to_dict
    from audio_training_tpu_torch.data import (
        EMBEDDING_DIM, MID_FEATURES_SHAPE, SHORT_FEATURES_SHAPE,
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
            extra = {}
            if vectors:
                short = 0.3 * rng.standard_normal(SHORT_FEATURES_SHAPE)
                short[:, 5 * k:5 * k + 5] += 1.0
                mid = np.abs(rng.standard_normal(MID_FEATURES_SHAPE))
                mid[11 * k:11 * k + 11] += 1.0
                emb = 0.3 * rng.standard_normal(EMBEDDING_DIM)
                emb[k::len(species)] += 1.0
                extra = dict(short_features=short.astype(np.float32),
                             mid_features=mid.astype(np.float32),
                             embeddings=emb.astype(np.float32))
            recs.append(encode_sample(SampleRecord(
                raw=raw.astype(np.float32), tags=[species[k]],
                rec_id=f"{split}-{i}", track_ids=[str(i)], sr=cfg.sr,
                **extra)))
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
                       fit_s: float) -> Path:
    """Phase 10: training from a built corpus at full width, through the
    user's entry point ``cli/train.main``; the run directory's artifacts
    read back by the port's readers; the trained run loaded by
    ``cli/predict.load_predictor`` and a recording predicted; the host
    loader timed alone.  Returns the run directory."""
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
    return run_dir


def write_eval_dirs(root: Path, sr: int, species: list[str],
                    labels: list[str]) -> tuple:
    """Phase 11's annotated recordings: EVAL_RECORDINGS of EVAL_SECONDS at
    ``sr``, recording k a noise floor with tone bursts (1.2 s on, 0.8 s
    off, from 0.5 s to the last 2 s) at species k's frequency of phase
    10's corpus (log-spaced, 200 Hz to 10 kHz), from a numpy seed.  Writes
    ``strong/<k>-rec.{wav,txt}`` (one track of species k, [1, end - 5) s,
    inside the bursts and clear of the recording's end) and
    ``weak/<labels[k]>/<k>-rec.wav``, species k's output label.  Returns
    (strong dir, weak dir)."""
    import shutil

    import numpy as np
    from scipy.io import wavfile

    shutil.rmtree(root, ignore_errors=True)
    strong, weak = root / "strong", root / "weak"
    strong.mkdir(parents=True)
    freqs = 200.0 * 50.0 ** (np.arange(len(species)) / (len(species) - 1))
    t = np.arange(int(EVAL_SECONDS * sr)) / sr
    bursts = (t % 2.0 < 1.2) & (t > 0.5) & (t < EVAL_SECONDS - 2.0)
    for k in range(EVAL_RECORDINGS):
        rng = np.random.default_rng([SEED, 11, k])
        sp = species[k % len(species)]
        x = (0.05 * rng.standard_normal(t.size)
             + 0.5 * bursts * np.sin(2 * np.pi * freqs[k % len(species)] * t
                                     + rng.uniform(0, 6.3))).astype(np.float32)
        wavfile.write(strong / f"{k}-rec.wav", sr, x)
        (strong / f"{k}-rec.txt").write_text(json.dumps({
            "id": k, "duration": EVAL_SECONDS, "Tracks": [{
                "id": 100 + k, "start": 1.0, "end": EVAL_SECONDS - 5.0,
                "tags": [{"what": sp}]}]}))
        label = weak / labels[k % len(species)]
        label.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(strong / f"{k}-rec.wav", label / f"{k}-rec.wav")
    return strong, weak


def evaluate_deploy_phase(dev, cfg, card, run_dir: Path) -> None:
    """Phase 11: evaluation and deployment of phase 10's trained run
    through the user's entry points: ``cli/freeze``, ``cli/evaluate
    strong`` / ``weak`` / ``thresholds``, ``cli/ebirdgrid`` and
    ``cli/predict`` with ``--thresholds-json``, ``--grid`` and
    ``--denoise``; each evaluation's K1 launches counted and its
    confusions held to the same evaluation on the CPU."""
    import math
    import pickle
    import shutil

    import numpy as np
    import torch
    from scipy.io import wavfile

    from audio_training_tpu_torch.cli import ebirdgrid as cli_ebirdgrid
    from audio_training_tpu_torch.cli import evaluate as cli_evaluate
    from audio_training_tpu_torch.cli import freeze as cli_freeze
    from audio_training_tpu_torch.cli import predict as cli_predict
    from audio_training_tpu_torch.config import InferenceConfig
    from audio_training_tpu_torch.infer import (
        Predictor, bucket_pad, extract_track_windows)
    from audio_training_tpu_torch.infer.ebirdgrid import species_at
    from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
    from audio_training_tpu_torch.ops.cuda import melspec
    from audio_training_tpu_torch.ops.denoise import spectral_gate
    from audio_training_tpu_torch.taxonomy import (
        get_ebird_ids_to_labels, load_ontology)
    from audio_training_tpu_torch.train import load_metadata

    torch.cuda.empty_cache()
    root = REPO / "build" / "chip_smoke_eval"
    ontology = load_ontology()
    species = list(ontology.bird_train_labels[:CORPUS_SPECIES])
    labels = load_metadata(run_dir)["labels"]

    # 1. freeze: the deployment predicts as the run does, bitwise
    deploy = root / "deploy"
    shutil.rmtree(deploy, ignore_errors=True)
    t0 = time.perf_counter()
    rc = cli_freeze.main([str(run_dir), str(deploy), "-w", "chkpt"])
    freeze_s = time.perf_counter() - t0
    check(rc == 0, f"cli/freeze exited {rc}")
    meta = json.loads((deploy / "metadata.txt").read_text())
    check(meta.get("frozen") is True and len(meta["labels"]) == len(labels)
          and len(meta["ebird_ids"]) == len(labels)
          and (deploy / "audioModel.pt").exists(),
          "the deployment's metadata.txt or audioModel.pt is wrong")
    recording = synthetic_recording(RECORDING_S, cfg.sr, SEED)
    run_pred, _ = cli_predict.load_predictor(run_dir, "chkpt", device=dev)
    deployed, _ = cli_predict.load_predictor(deploy, "audioModel",
                                             device=dev)
    tracks, _ = run_pred.predict_recording(recording, cfg.sr)
    windows = extract_track_windows(
        recording, cfg.sr, tracks, segment_length=cfg.segment_length,
        stride=cfg.segment_stride, fmin=cfg.fmin, fmax=cfg.fmax,
        rng=np.random.default_rng(SEED)).windows
    same = np.array_equal(deployed.predict_windows(windows),
                          run_pred.predict_windows(windows))
    log(f"path cli/freeze {run_dir.name} -> {deploy.name} -w chkpt: "
        f"{freeze_s * 1e3:.1f} ms; metadata frozen, {len(meta['labels'])} "
        f"display labels ({meta['labels'][:3]}...), ebird_ids "
        f"({sum(map(len, meta['ebird_ids']))} ids); the deployment's "
        f"probabilities on phase 4's {len(windows)} windows bitwise the "
        f"run's: {same}")
    check(same, "the frozen deployment's probabilities differ from the run's")
    del run_pred, deployed

    # the evaluations' window batches, counted where the Predictor takes
    # them: each batch is one centered K1 launch
    calls: list[tuple[int, float]] = []
    infer_cfg = InferenceConfig()
    real_predict = Predictor.predict_windows

    def counted(self, win):
        t0 = time.perf_counter()
        out = real_predict(self, win)
        calls.append((len(win), time.perf_counter() - t0))
        return out

    def evaluate(mode: str, out: Path, device: str, extra=()):
        calls.clear()
        argv = [mode, str(deploy), str(eval_dirs[mode]), "--out", str(out),
                "-w", "audioModel", "--device", device, *extra]
        Predictor.predict_windows = counted
        try:
            torch.cuda.synchronize()
            ffz.reset_launch_counts()
            melspec.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli_evaluate.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {**ffz.launch_counts(), **melspec.launch_counts()}
        finally:
            Predictor.predict_windows = real_predict
        check(rc == 0, f"cli/evaluate {mode} on {device} exited {rc}")
        batches = sum(math.ceil(bucket_pad(n, infer_cfg.bucket_sizes)
                                / infer_cfg.max_window_batch)
                      for n, _ in calls if n)
        return wall, counts, batches, sum(n for n, _ in calls), sum(
            s for _, s in calls)

    # the ontology merges some species into the output named by its
    # relabel map (redjun -> redjun1)
    eval_dirs = dict(zip(("strong", "weak"), write_eval_dirs(
        root / "data", cfg.sr, species,
        [ontology.relabel_map.get(sp, sp) for sp in species])))
    check(all(p.name in labels for p in eval_dirs["weak"].iterdir()),
          "a weak directory is not named by a label of the run")
    audio_s = EVAL_RECORDINGS * EVAL_SECONDS

    # 2. strong evaluation on the card, its launches, and on the CPU
    results = {}
    for mode in ("strong", "weak"):
        wall, counts, batches, n_win, pred_s = evaluate(
            mode, root / "card" / mode, str(dev))
        want = {k: 0 for k in counts}
        want["fused_featurizer_mel_centered"] = batches
        log(f"path cli/evaluate {mode} (deployment, {EVAL_RECORDINGS} "
            f"recordings of {EVAL_SECONDS:.0f} s at {cfg.sr} Hz): {n_win} "
            f"windows in {batches} batches, launches {counts} (want one "
            f"centered mel launch a window batch, nothing else)")
        check(counts == want, f"cli/evaluate {mode}'s K1 launch counts are "
              "not the path's")
        log(f"time cli/evaluate {mode}: {wall:.2f} s wall, "
            f"{audio_s / wall:.1f} recording-s/s; Predictor.predict_windows "
            f"{pred_s:.3f} s (featurize and classify on the card, copies "
            f"included), host share {1 - pred_s / wall:.3f} "
            f"(decode, get_end{', signal_noise' if mode == 'weak' else ''}, "
            f"windowing{', worker start-up' if mode == 'weak' else ''}) "
            f"{card}")
        results[mode] = (wall, pred_s)
    t0 = time.perf_counter()
    evaluate("strong", root / "cpu" / "strong", "cpu")
    cpu_s = time.perf_counter() - t0
    cms = {d: {n: np.load(root / d / f"strong-{n}.npy")
               for n in ("mean", "max", "counts")} for d in ("card", "cpu")}
    tracks_n = int(cms["card"]["mean"].sum())
    check(tracks_n == EVAL_RECORDINGS,
          f"the strong mean confusion holds {tracks_n} of "
          f"{EVAL_RECORDINGS} tracks")
    probs = {}
    for d in ("card", "cpu"):
        with (root / d / "strong-raw-confidences.pkl").open("rb") as f:
            probs[d] = pickle.load(f)
    # the three decisions threshold the per-track mean, the per-track max
    # and each window's top probability at 0.7: a probability within 1e-4
    # of it may fall either side on the two devices
    near = sum(
        bool(min(np.abs(p.mean(0) - 0.7).min(), np.abs(p.max(0) - 0.7).min(),
                 np.abs(p.max(1) - 0.7).min()) < 1e-4)
        for p in probs["card"])
    diff = sum(int(np.abs(cms["card"][n] - cms["cpu"][n]).sum()) // 2
               for n in cms["card"])
    err = max(float(np.abs(a - b).max())
              for a, b in zip(probs["card"], probs["cpu"]))
    card_cm = cms["card"]["mean"]
    log(f"check cli/evaluate strong, card vs --device cpu ({cpu_s:.1f} s): "
        f"mean / max / counts confusions equal: {diff == 0} ({diff} tracks "
        f"moved; {near} tracks with a probability within 1e-4 of the 0.7 "
        f"threshold); window probabilities max abs diff {err:.3e}; mean "
        f"confusion diagonal {int(np.trace(card_cm))} of {tracks_n} tracks")
    check(diff <= near, "the card's strong confusions differ from the CPU's "
          "beyond the tracks at the threshold")
    weak_cm = np.load(root / "card" / "weak-mean.npy")
    check(int(weak_cm.sum()) == EVAL_RECORDINGS,
          f"the weak mean confusion holds {int(weak_cm.sum())} of "
          f"{EVAL_RECORDINGS} files")
    log(f"check cli/evaluate weak: the mean confusion holds the "
        f"{EVAL_RECORDINGS} files (diagonal {int(np.trace(weak_cm))}), "
        f"votes diagonal "
        f"{int(np.trace(np.load(root / 'card' / 'weak-votes.npy')))}")

    # 3. thresholds from phase 10's test dump drive the deployment
    wav = root / "data" / "recording.wav"
    wavfile.write(wav, cfg.sr, recording)
    thr = root / "thresholds.json"
    check(cli_evaluate.main(["thresholds", str(run_dir / "confusion-raw.npy"),
                             "--out", str(thr)]) == 0,
          "cli/evaluate thresholds failed")
    table = json.loads(thr.read_text())
    check(sorted(table) == sorted(labels)
          and all(0.5 <= v <= 0.9 for v in table.values()),
          "the thresholds table is not one value in [0.5, 0.9] a label")

    def predict(*flags) -> list[dict]:
        out = root / "predict.json"
        check(cli_predict.main([str(deploy), "--file", str(wav),
                                "--json-out", str(out), "--device", str(dev),
                                *flags]) == 0,
              f"cli/predict {' '.join(flags)} failed")
        got = json.loads(out.read_text())[str(wav)]
        check(len(got) >= 1 and all(
            math.isfinite(t["start"]) and math.isfinite(t["end"])
            and len(t["predictions"]) == 1 for t in got),
            f"cli/predict {' '.join(flags)}: no finite tracks")
        return got

    tracked = predict("--thresholds-json", str(thr))
    log(f"path cli/evaluate thresholds (phase 10's test dump) -> "
        f"cli/predict --thresholds-json: {table}; {len(tracked)} tracks, "
        f"first {tracked[0]['predictions'][0]}")

    # 4. the eBird grid masks the deployment's labels
    kml, tsv, grid = root / "atlas.kml", root / "obs.tsv", root / "grid.json"
    squares = [[174.0, -41.1, 174.1, -41.0], [175.0, -40.1, 175.1, -40.0]]
    kml.write_text(
        '<?xml version="1.0"?><kml xmlns="http://www.opengis.net/kml/2.2">'
        "<Document>" + "".join(
            "<Placemark><Polygon><outerBoundaryIs><LinearRing><coordinates>"
            + " ".join(f"{x},{y},0" for x, y in ((b[0], b[1]), (b[2], b[1]),
                                                  (b[2], b[3]), (b[0], b[3])))
            + "</coordinates></LinearRing></outerBoundaryIs></Polygon>"
            "</Placemark>" for b in squares) + "</Document></kml>")
    names = get_ebird_ids_to_labels()
    seen = [sp for sp in species[::3] if sp in names]
    tsv.write_text("\n".join(
        ["COMMON NAME\tLATITUDE\tLONGITUDE\tOBSERVATION DATE"]
        + [f"{names[sp][0]}\t-41.05\t174.05\t2024-06-1{i}"
           for i, sp in enumerate(seen)]
        + [f"{names[sp][0]}\t-40.05\t175.05\t2024-06-01"
           for sp in species if sp in names and sp not in seen]))
    check(cli_ebirdgrid.main([str(tsv), "--kml", str(kml), "--out",
                              str(grid)]) == 0, "cli/ebirdgrid failed")
    present = species_at(json.loads(grid.read_text()), -41.05, 174.05, 6)
    allowed = present | {"bird", "noise", "human", "insect", "frog",
                         "rooster", "other"}
    unmasked = predict("--threshold", "0")
    masked = predict("--threshold", "0", "--grid", str(grid), "--lat",
                     "-41.05", "--lng", "174.05", "--month", "6")
    listed = [set(t["predictions"][0]["labels"]) for t in masked]
    check(present == set(seen) and all(s <= allowed for s in listed)
          and all(set(t["predictions"][0]["labels"]) == set(labels)
                  for t in unmasked),
          "cli/predict --grid kept a label the square lacks")
    log(f"path cli/ebirdgrid ({len(squares)} KML squares, "
        f"{len(species)} observations) -> cli/predict --grid --lat -41.05 "
        f"--lng 174.05 --month 6 --threshold 0: square's species "
        f"{sorted(present)}; {len(masked)} tracks list "
        f"{sorted(set().union(*listed))} (unmasked: all {len(labels)} "
        f"labels); every other label reads 0")

    # 5. denoise before detection
    denoised = predict("--denoise")
    log(f"path cli/predict --denoise ({RECORDING_S:.0f} s): "
        f"{len(denoised)} finite tracks (without: {len(tracked)})")
    x = torch.as_tensor(recording[None], device=dev)
    gate_ms = time_ms(lambda: spectral_gate(x))
    x_cpu = x.cpu()
    t0 = time.perf_counter()
    for _ in range(3):
        spectral_gate(x_cpu)
    gate_cpu_ms = (time.perf_counter() - t0) / 3 * 1e3
    check(bool(torch.isfinite(spectral_gate(x)).all()),
          "spectral_gate gave non-finite samples")
    log(f"time spectral_gate on a {RECORDING_S:.0f} s recording "
        f"({recording.size} samples, n_fft 2048, hop 512): {gate_ms:.3f} ms "
        f"on the card, {gate_cpu_ms:.1f} ms on the host CPU; freeze "
        f"{freeze_s * 1e3:.1f} ms wall {card}")


def model_families_phase(dev, cfg, card,
                         mn_ms: float) -> tuple[dict[str, int],
                                                dict[str, int]]:
    """Phase 12: the model families.  The reference's default backbone,
    EfficientNetV2-B3, on the PCEN chain at full width (K1's "default" tier
    with its PCEN epilogue, bf16 image, 3-channel repeat, B=512, three
    requests), its f32 checks and the gray-stem fold; a sweep of every
    other family at B=64, with K1 held against its plain versions at that
    batch; ``cli/train --model-name efficientnetv2b3`` on phase 10's corpus,
    with K1's training tiers held at its batch, and ``cli/predict`` on the
    run.  Returns the B3 chain's launch counts of K1's kernels and of the
    conv epilogue."""
    import math
    import shutil

    import numpy as np
    import torch

    from audio_training_tpu_torch.cli import predict as cli_predict
    from audio_training_tpu_torch.cli import train as cli_train
    from audio_training_tpu_torch.infer.fused import make_fused_infer_fn
    from audio_training_tpu_torch.models import (
        MODEL_NAMES, build_model, fold_gray_stem)
    from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
    from audio_training_tpu_torch.ops.cuda import melspec
    from audio_training_tpu_torch.ops.featurizer_select import make_mel_fn
    from audio_training_tpu_torch.ops.features import (
        build_mel_weights, normalize_rows)
    from audio_training_tpu_torch.ops.pcen import normalize_minmax_global, pcen
    from audio_training_tpu_torch.train import harness, load_metadata
    from audio_training_tpu_torch.train import loop
    from audio_training_tpu_torch.utils import profiling

    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)

    def clips(batch: int) -> torch.Tensor:
        return torch.randn(batch, cfg.samples_per_clip, generator=gen,
                           device=dev)

    def reset() -> None:
        torch.cuda.synchronize()
        ffz.reset_launch_counts()
        melspec.reset_launch_counts()

    def counts() -> dict[str, int]:
        torch.cuda.synchronize()
        return {**ffz.launch_counts(), **melspec.launch_counts()}

    def seeded(name: str, dtype=torch.bfloat16, **kw):
        return build_model(name, NUM_LABELS, logits_only=True, dtype=dtype,
                           n_mels=cfg.n_mels, mel_frames=cfg.mel_frames,
                           generator=torch.Generator().manual_seed(SEED),
                           **kw).module.to(dev).eval()

    def logit_rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    mel_np = build_mel_weights(cfg)
    mel_w = torch.as_tensor(mel_np, device=dev)
    fz_tier = {t: ffz.FusedFeaturizer(mel_np, cfg.n_fft, cfg.hop_length,
                                      precision=t, device=dev)
               for t in ("default", "highest")}

    def check_k1(raw: torch.Tensor, tier: str, what: str,
                 with_pcen: bool = False, impulses: bool = False) -> None:
        """K1's ``tier`` mel kernel at this path's batch against its plain
        version, at phase 3's (exact) and phase 6's ("default") limits;
        with ``with_pcen`` the PCEN epilogue on the kernel's own mel
        against plain PCEN (phase 3's limit)."""
        fzt, b = fz_tier[tier], raw.shape[0]
        mel_k = fzt(raw, pcen=False)
        mel_p = ffz.fused_featurizer_plain(raw, mel_w, cfg.hop_length,
                                           precision=tier)
        rel = logit_rel(mel_k, mel_p)
        if tier == "highest" or impulses:
            limit = MEL_REL_TOL if tier == "highest" else BF16_FLIP_FREE_REL
            log(f"check B={b} {what}, K1 {tier} tier vs plain: global rel "
                f"err {rel:.3e} (limit {limit})")
            check(rel < limit, f"K1 {tier} disagrees with plain on {what}")
        else:
            rms = (torch.linalg.norm(mel_k - mel_p)
                   / torch.linalg.norm(mel_p)).item()
            log(f"check B={b} {what}, K1 default tier vs plain: relative RMS "
                f"{rms:.3e} (limit {BF16_RMS_REL}), global rel err "
                f"{rel:.3e} (limit {BF16_STEP:.3e}, one bf16 step)")
            check(rms < BF16_RMS_REL and rel < BF16_STEP,
                  f"K1 default disagrees with plain on {what}")
        if with_pcen:
            want = normalize_minmax_global(pcen(
                mel_k, *fzt.pcen_params, time_axis=2, normalize=False))
            err = (fzt(raw, pcen=True) - want).abs().max().item()
            log(f"check B={b} {what}, PCEN on the {tier} tier's mel vs "
                f"plain: max abs err {err:.3e} (limit {PCEN_ABS_TOL})")
            check(err < PCEN_ABS_TOL, f"PCEN disagrees with plain on {what}")

    # ---- the EfficientNetV2-B3 chain, B=512 ------------------------------
    b3 = seeded("efficientnetv2b3", external_frontend=True)
    infer = make_fused_infer_fn(b3, cfg, use_pcen=True, channels=3,
                                precision="default", device=dev,
                                out_dtype=torch.bfloat16)
    requests = [clips(BATCH_PCEN) for _ in range(REQUESTS)]
    reset()
    profiling.reset_counts("conv_epilogue")
    answers = [infer(r) for r in requests]
    b3_counts = counts()
    b3_epilogues = profiling.counts("conv_epilogue")
    log(f"path PCEN -> EfficientNetV2-B3 chain: conv epilogues "
        f"{b3_epilogues}")
    check(b3_epilogues["rows"] + b3_epilogues["mid"] == 87 * REQUESTS
          and b3_epilogues["plain"] == 0,
          "the eval B3 forward did not run its 87 epilogues as the kernels")
    want = {k: 0 for k in b3_counts}
    want["fused_featurizer_mel_bf16"] = want["fused_featurizer_pcen"] = (
        REQUESTS)
    log(f"path PCEN -> EfficientNetV2-B3 chain (K1 default tier + PCEN, bf16 "
        f"image, 3-channel repeat, BackboneClassifier(efficientnetv2b3, "
        f"external_frontend=True) bf16, {NUM_LABELS} labels): {REQUESTS} "
        f"requests of B={BATCH_PCEN}, launches {b3_counts}")
    check(b3_counts == want, "the B3 chain did not launch K1's default tier "
          "and the PCEN kernel once per request, and nothing else")
    for logits in answers:
        check(tuple(logits.shape) == (BATCH_PCEN, NUM_LABELS)
              and logits.dtype == torch.float32
              and bool(torch.isfinite(logits).all()),
              f"B3 logits {tuple(logits.shape)} {logits.dtype} not finite")
    del answers

    # f32 at B=8: the kernel path against the plain featurizer; the fold
    b3_32 = seeded("efficientnetv2b3", dtype=None, external_frontend=True)
    b3_32.load_state_dict(b3.state_dict())
    raw8 = clips(CHECK_BATCH)

    def logits32(model, use_kernel=True, channels=3):
        return make_fused_infer_fn(model, cfg, use_pcen=True,
                                   channels=channels, use_kernel=use_kernel,
                                   device=dev)(raw8)

    lg_k, lg_p = logits32(b3_32), logits32(b3_32, use_kernel=False)
    rel_plain = logit_rel(lg_k, lg_p)
    try:
        fold_gray_stem(b3_32)
        refused = ""
    except ValueError as e:
        refused = str(e)
    check("EfficientNetV2" in refused,
          "fold_gray_stem took EfficientNetV2-B3 with its preprocessing")
    b3_np = seeded("efficientnetv2b3", dtype=None, external_frontend=True,
                   backbone_args=(("preprocess", False),))
    b3_np.load_state_dict(b3.state_dict())
    lg_3 = logits32(b3_np)
    rel_fold = logit_rel(logits32(fold_gray_stem(b3_np), channels=1), lg_3)
    log(f"check EfficientNetV2-B3 f32 logits B={CHECK_BATCH} (max |logit| "
        f"{lg_k.abs().max().item():.4e}, two clips' logits "
        f"{logit_rel(lg_k[0], lg_k[1]):.3e} apart): kernel path vs plain "
        f"featurizer rel err {rel_plain:.3e} (limit {LOGIT_REL_TOL}); "
        f"fold_gray_stem refuses preprocess=True ({refused[:60]}...); with "
        f"preprocess=False the folded 1-channel stem vs the 3-channel repeat "
        f"{rel_fold:.3e} (limit {FOLD_REL})")
    check(rel_plain < LOGIT_REL_TOL, "B3 kernel-path logits disagree")
    check(rel_fold < FOLD_REL, "B3 folded-stem logits disagree")
    del b3_32, b3_np

    # timing: the chain, its split, peak memory, a profile
    mel_fn = make_mel_fn(cfg, device=dev, pcen=True, precision="default",
                         out_dtype=torch.bfloat16)
    img3 = mel_fn(requests[2])[..., None].repeat_interleave(3, dim=-1)
    with torch.no_grad():
        cnn_ms = time_ms(lambda: b3(img3), iters=3)
    feat_ms = time_ms(lambda: mel_fn(requests[1]), iters=5)
    torch.cuda.reset_peak_memory_stats()
    chain_ms = time_ms(lambda: infer(requests[1]), iters=3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"time PCEN -> EfficientNetV2-B3 chain, default tier, B={BATCH_PCEN}: "
        f"{chain_ms:.3f} ms/batch, "
        f"{BATCH_PCEN * cfg.segment_length / (chain_ms / 1e3):.1f} audio-s/s, "
        f"peak memory {peak:.2f} GB; featurizer (mel + PCEN + min-max, bf16 "
        f"image) {feat_ms:.3f} ms, EfficientNetV2-B3 bf16 on the 3-channel "
        f"image {cnn_ms:.3f} ms; the PCEN -> MobileNetV2 chain of phase 7 "
        f"{mn_ms:.3f} ms {card}")
    _, events, feat = profile_pcen_chain(lambda: infer(requests[2]), dev)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    feat_busy = sum(e.self_device_time_total for e in feat) / 1e3
    conv_busy = sum(e.self_device_time_total for e in events
                    if "conv" in e.key.lower() or "xmma" in e.key
                    or "sm90" in e.key or "sm80" in e.key) / 1e3
    log(f"profile PCEN -> EfficientNetV2-B3 chain, B={BATCH_PCEN}: device "
        f"kernels {busy_ms:.3f} ms of {chain_ms:.3f} ms (idle share "
        f"{1 - busy_ms / chain_ms:.3f}); K1 bf16 + PCEN {feat_busy:.3f} ms, "
        f"kernels named as convolutions {conv_busy:.3f} ms, the rest "
        f"{busy_ms - feat_busy - conv_busy:.3f} ms {card}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  kernel {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<3d} "
            f"{e.key[:80]}")
    del b3, infer, requests, img3
    torch.cuda.empty_cache()

    # ---- the sweep: every other family once at B=64 ----------------------
    mel_models = ("badwinner2-res", "badwinner", "wr-resnet", "wr-resnet-bird")
    backbones = [n for n in MODEL_NAMES[10:] if n != "efficientnetv2b3"]
    raw64 = clips(FAMILY_BATCH)
    check_k1(raw64, "default", "the sweep's clips", with_pcen=True)
    check_k1(torch.as_tensor(impulse_batch(
        FAMILY_BATCH, cfg.samples_per_clip, SEED + FAMILY_BATCH),
        device=dev), "default", "impulses (no rounding can flip)",
        impulses=True)
    check_k1(raw64, "highest", "the sweep's clips")
    # one mel family's f32 logits on the sweep's path, kernel vs plain
    bw32 = seeded("badwinner", dtype=None)
    lg_k, lg_p = (make_fused_infer_fn(bw32, cfg, use_kernel=k,
                                      device=dev)(raw64)
                  for k in (True, False))
    rel = logit_rel(lg_k, lg_p)
    log(f"check badwinner f32 logits B={FAMILY_BATCH} (max |logit| "
        f"{lg_p.abs().max().item():.4e}): K1 exact path vs plain featurizer "
        f"rel err {rel:.3e} (limit {LOGIT_REL_TOL})")
    check(rel < LOGIT_REL_TOL, "badwinner kernel-path logits disagree")
    del bw32, lg_k, lg_p

    def readings(run) -> list[tuple[float, float]]:
        """Two readings of ``SWEEP_ITERS`` calls after two warm-up calls:
        (device ms a call by CUDA events, host ms a call to issue it)."""
        for _ in range(2):
            run(raw64)
        out = []
        for _ in range(2):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for _ in range(SWEEP_ITERS):
                run(raw64)
            issue = (time.perf_counter() - t0) * 1e3 / SWEEP_ITERS
            end.record()
            end.synchronize()
            out.append((start.elapsed_time(end) / SWEEP_ITERS, issue))
        return out

    for name in backbones + list(mel_models):
        mel = name in mel_models
        model = (seeded(name) if mel
                 else seeded(name, external_frontend=True))
        run = make_fused_infer_fn(
            model, cfg, use_pcen=not mel, channels=1 if mel else 3,
            precision="highest" if mel else "default", device=dev,
            out_dtype=torch.float32 if mel else torch.bfloat16)
        reset()
        out = run(raw64)
        got = counts()
        want = {k: 0 for k in got}
        if mel:
            want[ffz.mel_counter("highest")] = 1
        else:
            want["fused_featurizer_mel_bf16"] = 1
            want["fused_featurizer_pcen"] = 1
        (ms, issue), (ms2, issue2) = readings(run)
        params = sum(p.numel() for p in model.parameters()) / 1e6
        log(f"path sweep {name} ({params:.1f} M parameters) behind "
            f"{'K1 exact, its own frontend' if mel else 'K1 default + PCEN'}"
            f", bf16, B={FAMILY_BATCH}: {ms:.3f} / {ms2:.3f} ms/batch "
            f"(two readings of {SWEEP_ITERS}; host issue {issue:.3f} / "
            f"{issue2:.3f} ms a call), "
            f"{FAMILY_BATCH * cfg.segment_length / (ms / 1e3):.1f} audio-s/s, "
            f"logits finite {bool(torch.isfinite(out).all())}, launches "
            f"{ {k: v for k, v in got.items() if v} } {card}")
        check(got == want, f"the {name} sweep launched {got}, not {want}")
        check(tuple(out.shape) == (FAMILY_BATCH, NUM_LABELS)
              and bool(torch.isfinite(out).all()),
              f"{name} logits {tuple(out.shape)} not finite")
        del model, run, out
        torch.cuda.empty_cache()

    # ---- cli/train --model-name efficientnetv2b3 on phase 10's corpus ----
    # K1's two training tiers at the run's batch, on normalized tone clips
    # as the corpus holds them: "default" on the train steps, exact on the
    # validation and test batches
    x32, _ = tone_band_batch(B3_TRAIN_BATCH, NUM_LABELS, cfg.samples_per_clip,
                             cfg.sr, SEED + B3_TRAIN_BATCH)
    raw32 = normalize_rows(torch.as_tensor(x32, device=dev))
    check_k1(raw32, "default", "normalized tone clips")
    check_k1(torch.as_tensor(impulse_batch(
        B3_TRAIN_BATCH, cfg.samples_per_clip, SEED + B3_TRAIN_BATCH),
        device=dev), "default", "impulses (no rounding can flip)",
        impulses=True)
    check_k1(raw32, "highest", "normalized tone clips")
    del raw32, fz_tier
    corpus = REPO / "build" / "chip_smoke_corpus"
    ckpt = REPO / "build" / "chip_smoke_b3"
    shutil.rmtree(ckpt, ignore_errors=True)
    step_losses: list[float] = []
    real_step = loop.make_train_step

    def recording_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def run(state, metrics, *a, **kw):
            before = (metrics["loss_sum"].item(), metrics["count"].item())
            state, metrics = step(state, metrics, *a, **kw)
            step_losses.append((metrics["loss_sum"].item() - before[0])
                               / (metrics["count"].item() - before[1]))
            return state, metrics

        return run

    argv = ["b3-run", "-d", str(corpus), "--checkpoint-dir", str(ckpt),
            "--model-name", "efficientnetv2b3", "--batch-size",
            str(B3_TRAIN_BATCH), "--epochs", "1", "--steps-per-epoch",
            str(B3_TRAIN_STEPS), "--device", str(dev)]
    loop.make_train_step = recording_step
    try:
        reset()
        t0 = time.perf_counter()
        rc = cli_train.main(argv)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        got = counts()
    finally:
        loop.make_train_step = real_step
    check(rc == 0, f"cli/train of efficientnetv2b3 exited {rc}")
    space, _, _ = harness.init_labels([corpus])
    sizes = {s: n for s, (n, _) in CORPUS_SPLITS.items()}
    want = {k: 0 for k in got}
    want["fused_featurizer_mel_bf16"] = B3_TRAIN_STEPS
    want["fused_featurizer_mel"] = (
        math.ceil(sizes["validation"] / B3_TRAIN_BATCH)
        + math.ceil(sizes["test"] / B3_TRAIN_BATCH))
    meta = load_metadata(ckpt / "b3-run")
    log(f"path cli/train {' '.join(argv)}: EfficientNetV2-B3 bf16 with its "
        f"own PCEN layer, 1-channel mel (the x / 128 - 1 branch), "
        f"{space.num_labels} labels, B={B3_TRAIN_BATCH}; {train_s:.2f} s; "
        f"launches {got} (want {want}: one bf16 launch a train step, one "
        f"exact launch a validation and a test batch); step losses "
        f"{[round(l, 4) for l in step_losses]}, epoch loss "
        f"{meta['history']['loss']}, val loss {meta['history']['val_loss']}"
        f" {card}")
    check(got == want, "the B3 training run's K1 launches are not the path's")
    check(len(step_losses) == B3_TRAIN_STEPS
          and bool(np.isfinite(step_losses).all())
          and step_losses[-1] < step_losses[0],
          f"B3 train losses {step_losses} are not finite and falling")
    predictor, _ = cli_predict.load_predictor(ckpt / "b3-run", "chkpt",
                                              device=dev)
    recording = synthetic_recording(RECORDING_S, cfg.sr, SEED)
    tracks, _ = predictor.predict_recording(recording, cfg.sr)
    probs = predictor.predict_windows(
        recording[None, :cfg.samples_per_clip].astype(np.float32))
    check(predictor.module.backbone.out_channels == 1536
          and len(tracks) > 0 and bool(np.isfinite(probs).all()),
          "the B3 run does not serve phase 4's recording")
    log(f"path load_predictor(B3 run, 'chkpt') -> predict_recording "
        f"{RECORDING_S:.0f} s: {len(tracks)} tracks; first window's "
        f"probabilities finite in [{probs.min():.3f}, {probs.max():.3f}]")
    return b3_counts, b3_epilogues


def rest_of_training_phase(dev, cfg, card, fit_step_ms: float,
                           fit_peak_gb: float) -> list[dict]:
    """Phase 13: the rest of training.  K2 at dual-badwinner2's two view
    shapes against its plain version; ``cli/train`` of dual-badwinner2 on
    phase 10's corpus (two K2 launches a batch, no K1) with its step timed
    and split and one f32 step through K2 against the plain views; a
    corpus with stored features and embeddings, and ``cli/train`` of
    merge (K1 once a batch), cnn-features and embeddings (no kernel) on
    it; badwinner2's step with and without remat; SpecAugment on an
    augmented batch.  Returns K2's records at the two view shapes."""
    import importlib.util
    import math
    import shutil

    import numpy as np
    import torch

    from audio_training_tpu_torch.cli import train as cli_train
    from audio_training_tpu_torch.data.preprocess import (
        make_dual_mel, make_preprocess_fn)
    from audio_training_tpu_torch.models import build_model
    from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
    from audio_training_tpu_torch.ops.cuda import melspec
    from audio_training_tpu_torch.ops.features import (
        apply_spec_augment, build_mel_weights, mix_up, normalize_rows,
        sample_mix_weights, sample_spec_augment)
    from audio_training_tpu_torch.ops.stft import stft_tf_style
    from audio_training_tpu_torch.taxonomy import load_ontology
    from audio_training_tpu_torch.train import (
        create_train_state, fresh_metrics, load_metadata, loop,
        make_train_step)
    from audio_training_tpu_torch.train.losses import bce_from_logits

    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)

    def clips(batch: int) -> torch.Tensor:
        return normalize_rows(torch.randn(batch, cfg.samples_per_clip,
                                          generator=gen, device=dev))

    def reset() -> None:
        torch.cuda.synchronize()
        ffz.reset_launch_counts()
        melspec.reset_launch_counts()

    def counts() -> dict[str, int]:
        torch.cuda.synchronize()
        return {**ffz.launch_counts(), **melspec.launch_counts()}

    def seeded(name: str, dtype=torch.bfloat16):
        return build_model(name, NUM_LABELS, logits_only=True, dtype=dtype,
                           n_mels=cfg.n_mels,
                           generator=torch.Generator().manual_seed(SEED)
                           ).module

    # ---- K2 at the dual views' shapes -------------------------------------
    dual = make_dual_mel(cfg, device=dev)
    views = ("A", "B")
    k2_err = [0.0, 0.0]
    for b in (CHECK_BATCH, TRAIN_BATCH):
        raw = clips(b)
        for v, (bank_t, n_fft, hop) in enumerate(dual.views):
            spec = stft_tf_style(raw, n_fft, hop)
            out_k = melspec.fused_power_mel_complex(spec, bank_t)
            out_p = melspec.power_mel_plain(spec.real, spec.imag, bank_t)
            err = (out_k - out_p).abs().max().item()
            rel = err / out_p.abs().max().item()
            log(f"check B={b} power mel, dual view {views[v]} "
                f"({n_fft}/{hop}: {tuple(spec.shape)} against the masked "
                f"{tuple(bank_t.shape)} bank): global rel err {rel:.3e} "
                f"(limit {MEL_REL_TOL}), max abs err {err:.3e}")
            check(out_k.shape == (b, spec.shape[1], cfg.n_mels)
                  and rel < MEL_REL_TOL,
                  "the power mel kernel disagrees at a dual view")
            k2_err[v] = max(k2_err[v], err)
    raw = clips(TRAIN_BATCH)
    k2_times = []
    for v, (bank_t, n_fft, hop) in enumerate(dual.views):
        spec = stft_tf_style(raw, n_fft, hop)
        ms = time_ms(lambda: melspec.fused_power_mel_complex(spec, bank_t))
        plain_ms = time_ms(lambda: melspec.power_mel_plain(
            spec.real, spec.imag, bank_t), iters=5)
        lib_ms = time_ms(lambda: torch.matmul(
            spec.real**2 + spec.imag**2, bank_t), iters=5)
        stft_ms = time_ms(lambda: stft_tf_style(raw, n_fft, hop), iters=5)
        # as phase 5 counts K2: the support bins of the complex STFT read,
        # the f32 mel written, the band tables; |X|^2 and the band products
        plan = melspec.band_walk_plan(bank_t.cpu().numpy())
        rows, nnz = TRAIN_BATCH * spec.shape[1], len(plan.weights)
        flops = rows * (3 * plan.support + 2 * nnz)
        nbytes = (rows * plan.support * 8 + rows * cfg.n_mels * 4
                  + (3 * cfg.n_mels + nnz) * 4)
        bound = bound_ms(flops, nbytes)
        log(f"time power mel kernel, dual view {views[v]} B={TRAIN_BATCH} "
            f"({rows} rows x {spec.shape[2]} bins, support {plan.support} "
            f"bins from bin {plan.lo}, {nnz} non-zeros, {cfg.n_mels} mels): "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library matmul "
            f"{lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB), roofline "
            f"share {bound[0] / ms:.3f}; stft_tf_style feeding it "
            f"{stft_ms:.4f} ms {card}")
        k2_times.append((ms, plain_ms, lib_ms, bound))
    del raw, spec

    # ---- the runs through cli/train -----------------------------------------
    ckpt = REPO / "build" / "chip_smoke_rest"
    shutil.rmtree(ckpt, ignore_errors=True)
    sizes = {s: n for s, (n, _) in CORPUS_SPLITS.items()}
    eval_batches = (math.ceil(sizes["validation"] / TRAIN_BATCH)
                    + math.ceil(sizes["test"] / TRAIN_BATCH))

    def train_cli(name: str, corpus: Path):
        """``cli/train --model-name name`` (bf16, B=TRAIN_BATCH, 1 epoch x
        REST_STEPS steps) with the launch counts zeroed just before and
        read just after; each step's loss, and the wall time between step
        ends (loader, preprocess and step).  Returns (counts, seconds,
        step losses, median ms a step over the last steps, run dir)."""
        losses, ends = [], []
        real_step = loop.make_train_step

        def recording_step(*args, **kwargs):
            step = real_step(*args, **kwargs)

            def run(state, metrics, *a, **kw):
                before = (metrics["loss_sum"].item(), metrics["count"].item())
                state, metrics = step(state, metrics, *a, **kw)
                losses.append((metrics["loss_sum"].item() - before[0])
                              / (metrics["count"].item() - before[1]))
                ends.append(time.perf_counter())
                return state, metrics

            return run

        argv = [name, "-d", str(corpus), "--checkpoint-dir", str(ckpt),
                "--model-name", name, "--batch-size", str(TRAIN_BATCH),
                "--epochs", "1", "--steps-per-epoch", str(REST_STEPS),
                "--device", str(dev)]
        loop.make_train_step = recording_step
        try:
            reset()
            t0 = time.perf_counter()
            rc = cli_train.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = counts()
        finally:
            loop.make_train_step = real_step
        check(rc == 0, f"cli/train --model-name {name} exited {rc}")
        check(len(losses) == REST_STEPS
              and bool(np.isfinite(losses).all()),
              f"{name}: step losses {losses} not finite")
        step_ms = float(np.median(np.diff(ends))) * 1e3
        log(f"path cli/train {' '.join(argv)}: {secs:.2f} s; launches "
            f"{got}; step losses {[round(l, 4) for l in losses]}; "
            f"{step_ms:.3f} ms a step (median of the last "
            f"{REST_STEPS - 1} step-to-step intervals, loader included), "
            f"{TRAIN_BATCH / (step_ms / 1e3):.1f} samples/s {card}")
        return got, secs, losses, step_ms, ckpt / name

    def want_counts(got: dict, **nonzero) -> dict:
        return {**{k: 0 for k in got}, **nonzero}

    # ---- dual-badwinner2 on phase 10's corpus ---------------------------------
    corpus = REPO / "build" / "chip_smoke_corpus"
    dual_got, _, losses, dual_run_ms, run_dir = train_cli("dual-badwinner2",
                                                          corpus)
    want = want_counts(dual_got,
                       power_mel=2 * (REST_STEPS + eval_batches))
    log(f"check dual-badwinner2 launches: want {want} (two power mel "
        f"launches a train step and a validation / test batch, no K1)")
    check(dual_got == want, "the dual run's launches are not the path's")
    check(losses[-1] < losses[0], f"the dual train loss {losses} did not "
          "fall")
    check((run_dir / "chkpt.pt").exists()
          and load_metadata(run_dir)["test_samples"] == sizes["test"],
          "the dual run wrote no checkpoint or test metrics")

    # the dual step on an in-memory batch, as phase 6 times badwinner2's
    x_np, y_np = tone_band_batch(TRAIN_BATCH, NUM_LABELS,
                                 cfg.samples_per_clip, cfg.sr, SEED)
    raw_t = torch.as_tensor(x_np, device=dev)
    y_t = torch.as_tensor(y_np, device=dev)
    partner = torch.roll(torch.arange(TRAIN_BATCH, device=dev), 1)
    batch = (raw_t, y_t, raw_t[partner].contiguous(), y_t[partner])
    dual_pre = make_preprocess_fn(cfg, augment=True, dual=True, device=dev)
    state = create_train_state(seeded("dual-badwinner2"),
                               learning_rate=TRAIN_LR, device=dev)
    step_fn = make_train_step()
    gen_pre = torch.Generator(device=dev).manual_seed(SEED)
    gen_drop = torch.Generator(device=dev).manual_seed(SEED + 1)

    def dual_iter():
        mel, yy = dual_pre(*batch, gen_pre)
        return step_fn(state, fresh_metrics(dev), mel, yy, gen_drop)

    reset()
    dual_iter()
    check(counts()["power_mel"] == 2, "the dual step did not launch K2 twice")
    torch.cuda.reset_peak_memory_stats()
    dual_ms = time_ms(dual_iter, iters=5)
    dual_peak = torch.cuda.max_memory_allocated() / 1e9
    parts = {"featurize (2 x (STFT + K2))": 0.0, "forward": 0.0,
             "backward": 0.0, "Adam": 0.0}
    model = state.model.train()
    reps = 3
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        mel, yy = dual_pre(*batch, gen_pre)
        ev[1].record()
        loss = bce_from_logits(model(*mel, generator=gen_drop), yy)
        ev[2].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[3].record()
        state.optimizer.step()
        ev[4].record()
        ev[4].synchronize()
        if rep:  # the first pass warms up
            for i, k in enumerate(parts):
                parts[k] += ev[i].elapsed_time(ev[i + 1]) / reps
    log(f"time dual-badwinner2 train step (preprocess + fwd/bwd + Adam) "
        f"B={TRAIN_BATCH}: {dual_ms:.3f} ms, "
        f"{TRAIN_BATCH / (dual_ms / 1e3):.1f} samples/s, peak memory "
        f"{dual_peak:.2f} GB (phase 6's badwinner2 step {fit_step_ms:.3f} "
        f"ms, {fit_peak_gb:.2f} GB: {dual_ms / fit_step_ms:.2f}x, "
        f"{dual_peak / fit_peak_gb:.2f}x); split: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in parts.items()) + f"; the run's "
        f"{dual_run_ms:.3f} ms a step with its loader {card}")
    del state, model, mel, loss

    # one f32 step at B=8 through K2 and through the plain views
    def plain_pre(raw, y, raw2, y2, g):
        mixed, y = mix_up(g, raw, y, raw2, y2)
        mixed = normalize_rows(mixed)
        out = []
        for bank_t, n_fft, hop in dual.views:
            spec = stft_tf_style(mixed, n_fft, hop)
            out.append(melspec.power_mel_plain(
                spec.real, spec.imag, bank_t).transpose(1, 2)[..., None])
        return tuple(out), y

    def f32_dual_step(preprocess):
        st = create_train_state(seeded("dual-badwinner2", None),
                                learning_rate=TRAIN_LR, device=dev)
        mel, yy = preprocess(*(t[:CHECK_BATCH] for t in batch),
                             torch.Generator(device=dev).manual_seed(SEED))
        with torch.no_grad():
            logits = st.model.eval()(*mel)
        st, m = make_train_step()(
            st, fresh_metrics(dev), mel, yy,
            torch.Generator(device=dev).manual_seed(SEED + 1))
        return float(m["loss_sum"]) / CHECK_BATCH, logits

    torch.backends.cudnn.deterministic = True
    reset()
    loss_k, logit_k = f32_dual_step(dual_pre)
    check(counts()["power_mel"] == 2,
          "the f32 dual step did not launch K2 twice")
    loss_p, logit_p = f32_dual_step(plain_pre)
    torch.backends.cudnn.deterministic = False
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    logit_rel = ((logit_k - logit_p).abs().max()
                 / logit_p.abs().max()).item()
    log(f"check f32 dual-badwinner2 step B={CHECK_BATCH}, K2 vs the plain "
        f"views: loss {loss_k:.7f} vs {loss_p:.7f}, rel {loss_rel:.3e} "
        f"(limit {DUAL_LOSS_REL}); eval logits rel err {logit_rel:.3e} "
        f"(limit {DUAL_LOGIT_REL})")
    check(loss_rel < DUAL_LOSS_REL and logit_rel < DUAL_LOGIT_REL,
          "the dual K2 path disagrees with the plain views")

    # ---- merge, cnn-features and embeddings on a corpus with vectors ---------
    species = list(load_ontology().bird_train_labels[:CORPUS_SPECIES])
    vec_corpus = REPO / "build" / "chip_smoke_vectors"
    t0 = time.perf_counter()
    write_corpus(vec_corpus, cfg, species, vectors=True)
    log(f"corpus with vectors: {sizes} clips, each with short (68, 60) / "
        f"mid (136, 3) features and a 1280-d embedding, written in "
        f"{time.perf_counter() - t0:.2f} s")
    # K1's two training tiers at the merge run's batch, on normalized tone
    # clips as the corpus holds them
    mel_np = build_mel_weights(cfg)
    mel_w = torch.as_tensor(mel_np, device=dev)
    tone = normalize_rows(raw_t)
    for tier in ("default", "highest"):
        got = ffz.FusedFeaturizer(mel_np, cfg.n_fft, cfg.hop_length,
                                  precision=tier, device=dev)(tone,
                                                              pcen=False)
        want = ffz.fused_featurizer_plain(tone, mel_w, cfg.hop_length,
                                          precision=tier)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        rms = (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()
        limit = MEL_REL_TOL if tier == "highest" else BF16_STEP
        log(f"check B={TRAIN_BATCH} K1 {tier} tier, normalized tone clips: "
            f"global rel err {rel:.3e} (limit {limit:.3e}), relative RMS "
            f"{rms:.3e} (limit {BF16_RMS_REL})")
        check(rel < limit and rms < BF16_RMS_REL,
              f"K1's {tier} tier disagrees at the merge run's batch")
    del tone, got, want
    merge_got, _, losses, merge_ms, run_dir = train_cli("merge", vec_corpus)
    want = want_counts(merge_got, fused_featurizer_mel_bf16=REST_STEPS,
                       fused_featurizer_mel=eval_batches)
    log(f"check merge launches: want {want} (one K1 \"default\" launch a "
        f"train step, one exact launch a validation / test batch); "
        f"{merge_ms / fit_step_ms:.2f}x phase 6's in-memory step, which "
        f"has no loader")
    check(merge_got == want, "the merge run's K1 launches are not the path's")
    check(losses[-1] < losses[0], f"the merge train loss {losses} did not "
          "fall")
    check((run_dir / "confusion.npy").exists()
          and load_metadata(run_dir)["test_samples"] == sizes["test"],
          "the merge run wrote no test confusion")
    for name in ("cnn-features", "embeddings"):
        got, _, _, _, _ = train_cli(name, vec_corpus)
        check(not any(got.values()), f"the {name} run launched a kernel")
    log("path rf-features: not run here; it fits scikit-learn's random "
        "forest on the host (scikit-learn importable on this machine: "
        f"{importlib.util.find_spec('sklearn') is not None}); its tests "
        "run on the CPU")

    # ---- remat: badwinner2's step with and without it --------------------------
    pre = make_preprocess_fn(cfg, augment=True, device=dev)

    def remat_step(remat: bool, dtype, b: int):
        st = create_train_state(seeded("badwinner2", dtype),
                                learning_rate=TRAIN_LR, device=dev)
        mel, yy = pre(*(t[:b] for t in batch),
                      torch.Generator(device=dev).manual_seed(SEED))
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        fn = make_train_step(remat=remat)
        st, _ = fn(st, fresh_metrics(dev), mel, yy, g)
        return st, fn, mel, yy, g

    torch.backends.cudnn.deterministic = True
    plain_st, _, _, _, plain_g = remat_step(False, None, CHECK_BATCH)
    remat_st, _, _, _, remat_g = remat_step(True, None, CHECK_BATCH)
    torch.backends.cudnn.deterministic = False
    want_sd, got_sd = plain_st.model.state_dict(), remat_st.model.state_dict()
    worst = max(((got_sd[k] - want_sd[k]).abs().max()
                 / want_sd[k].abs().max().clamp_min(1e-30)).item()
                for k in want_sd)
    same_gen = torch.equal(plain_g.get_state(), remat_g.get_state())
    log(f"check f32 badwinner2 step B={CHECK_BATCH}, remat vs not: every "
        f"parameter and BN running statistic within {worst:.3e} relative "
        f"(limit {REMAT_REL}); dropout generator state equal: {same_gen}")
    check(worst <= REMAT_REL and same_gen,
          "the remat step disagrees with the plain step")
    del plain_st, remat_st
    remat_ms = {}
    for remat in (False, True):
        st, fn, mel, yy, g = remat_step(remat, torch.bfloat16, TRAIN_BATCH)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: fn(st, fresh_metrics(dev), mel, yy, g), iters=5)
        remat_ms[remat] = (ms, torch.cuda.max_memory_allocated() / 1e9)
        del st, fn, mel, yy
    log(f"time badwinner2 bf16 train step alone (fwd/bwd + Adam, features "
        f"made) B={TRAIN_BATCH}: remat=False {remat_ms[False][0]:.3f} ms, "
        f"peak {remat_ms[False][1]:.2f} GB; remat=True "
        f"{remat_ms[True][0]:.3f} ms, peak {remat_ms[True][1]:.2f} GB {card}")

    # ---- SpecAugment on the augmented path ----------------------------------
    sa_pre = make_preprocess_fn(cfg, augment=True, use_spec_augment=True,
                                device=dev)
    out, _ = sa_pre(*batch, torch.Generator(device=dev).manual_seed(SEED))
    ref, _ = pre(*batch, torch.Generator(device=dev).manual_seed(SEED))
    g = torch.Generator(device=dev).manual_seed(SEED)
    sample_mix_weights(g, TRAIN_BATCH)
    draw = sample_spec_augment(g, TRAIN_BATCH, cfg.n_mels, cfg.mel_frames)
    inside = all(
        int(st.min()) >= 0 and int(st.max()) < max(size - width, 1)
        and int(wd.min()) >= 0 and int(wd.max()) <= width
        for st, wd, size, width in (
            (draw.time_starts, draw.time_widths, cfg.mel_frames, 50),
            (draw.freq_starts, draw.freq_widths, cfg.n_mels, 20)))
    masked = apply_spec_augment(torch.ones_like(ref), draw) == 0
    kept_err = ((out[~masked] - ref[~masked]).abs().max()
                / ref.abs().max()).item()
    sa_ms = time_ms(lambda: sa_pre(*batch, gen_pre), iters=5)
    no_sa_ms = time_ms(lambda: pre(*batch, gen_pre), iters=5)
    log(f"check SpecAugment B={TRAIN_BATCH}: every start and width inside "
        f"JAX's limits (time [0, {cfg.mel_frames - 50}) x [0, 50], mel "
        f"[0, {cfg.n_mels - 20}) x [0, 20]): {inside}; "
        f"{masked.float().mean().item():.3f} of the image masked, zero "
        f"there: {bool((out[masked] == 0).all())}; elsewhere rel err "
        f"{kept_err:.3e} against the unmasked batch (limit {BF16_STEP:.3e});"
        f" time {sa_ms:.3f} ms a batch, without SpecAugment {no_sa_ms:.3f} "
        f"ms {card}")
    check(inside and bool((out[masked] == 0).all()) and kept_err < BF16_STEP,
          "SpecAugment's masks are off")

    per_view = dual_got["power_mel"] // 2
    return [kernel_record(f"power_mel at dual view {views[v]}",
                          MELSPEC_SOURCE, MELSPEC_TPU_KERNEL, per_view,
                          k2_err[v], ms, plain_ms, bound, lib_ms)
            for v, (ms, plain_ms, lib_ms, bound) in enumerate(k2_times)]


@contextlib.contextmanager
def seeded_default_rng(seed: int):
    """``random`` seeded, and ``numpy.random.default_rng()`` without a seed
    giving ``PCG64([seed, n])`` at its n-th call from entry on, so that a
    build and a later ``--test-split`` on the same raw directory draw the
    same samples (each recording's sampling generator is one such call, in
    the order ``load_meta`` finds the sidecars).  Spawned processes (the
    build's workers) draw their own."""
    import itertools
    import random

    import numpy as np

    real = np.random.default_rng
    calls = itertools.count()
    random.seed(seed)
    np.random.default_rng = lambda s=None: real(
        [seed, next(calls)] if s is None else s)
    try:
        yield
    finally:
        np.random.default_rng = real


def write_raw_corpus(root: Path, sr: int, species: list[str]) -> list[str]:
    """Phase 14's raw corpus in the layout of the JAX package's
    tests/test_corpus.py (``write_rec`` with ``make_meta``): for each
    species ``BUILD_RECORDINGS`` float32 WAVs of ``BUILD_SECONDS`` at
    ``sr``, each beside its sidecar ``.txt`` with two tracks of
    ``BUILD_TRACK_S``: the species' tone (bursts of 1.2 s every 2 s at a
    log-spaced frequency, 200 Hz to 10 kHz) from 0.5-1.6 s, and broadband
    noise (tagged ``noise``) from 11 s, over a noise floor, from a numpy
    seed per recording.  No RMS metadata: the build runs with
    ``--dont-tighten-tracks --dont-filter-rms``.  Written by threads.
    Returns the recording ids."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from audio_training_tpu_torch.corpus import save_wav

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    n = int(BUILD_SECONDS * sr)
    t = np.arange(n) / sr
    freqs = 200.0 * 50.0 ** (np.arange(len(species)) / (len(species) - 1))

    def write(k: int, r: int) -> str:
        rec_id = f"s{k}r{r:02d}"
        rng = np.random.default_rng([SEED, 14, k, r])
        audio = 0.05 * rng.standard_normal(n)
        start = 0.5 + 0.1 * r
        tone = (start <= t) & (t < start + BUILD_TRACK_S) & (t % 2 < 1.2)
        audio += tone * 0.5 * np.sin(2 * np.pi * freqs[k] * t
                                     + rng.uniform(0, 6.3))
        noise = (11.0 <= t) & (t < 11.0 + BUILD_TRACK_S)
        audio += noise * 0.3 * rng.standard_normal(n)
        save_wav(root / f"{rec_id}.wav", audio.astype(np.float32), sr)
        tracks = [(start, species[k]), (11.0, "noise")]
        meta = {
            "id": rec_id, "duration": BUILD_SECONDS,
            "location": {"lat": -43.5 + 0.1 * k, "lng": 172.6}, "signal": [],
            "Tracks": [{"id": f"t{rec_id}_{i}", "start": s0,
                        "end": s0 + BUILD_TRACK_S,
                        "tags": [{"what": what, "automatic": False}]}
                       for i, (s0, what) in enumerate(tracks)],
        }
        (root / f"{rec_id}.txt").write_text(json.dumps(meta))
        return rec_id

    jobs = [(k, r) for k in range(len(species))
            for r in range(BUILD_RECORDINGS)]
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(lambda j: write(*j), jobs))


def build_corpus_phase(dev, cfg, card, fit_step_ms: float) -> dict[str, int]:
    """Phase 14: building a corpus.  A raw corpus of WAVs and sidecars,
    the port's ``cli/build`` over it with 1 and with 4 worker processes
    (timed; the written ``training-meta.json`` against the records the
    port's ``RecordStream`` reads back), ``cli/train`` on the built corpus,
    and ``cli/predict --test-split`` on the run (its confusion against the
    build's test counts; the same call on ``BUILD_CPU_RECORDINGS`` test
    recordings on the card and with ``--device cpu``, confusions equal).
    Returns K1's launches on the path by kernel record."""
    import math
    import shutil

    import numpy as np
    import torch

    from audio_training_tpu_torch.cli import build as cli_build
    from audio_training_tpu_torch.cli import predict as cli_predict
    from audio_training_tpu_torch.cli import train as cli_train
    from audio_training_tpu_torch.config import SamplingConfig
    from audio_training_tpu_torch.corpus import AudioDataset, split_by_file
    from audio_training_tpu_torch.data import (
        RecordStream, find_shards, read_tfrecords)
    from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
    from audio_training_tpu_torch.ops.cuda import melspec
    from audio_training_tpu_torch.taxonomy import load_ontology
    from audio_training_tpu_torch.train import harness, load_metadata

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    root = REPO / "build" / "chip_smoke_build"
    species = list(load_ontology().bird_train_labels[:BUILD_SPECIES])
    t0 = time.perf_counter()
    rec_ids = write_raw_corpus(root / "raw", cfg.sr, species)
    raw = root / "raw"
    log(f"raw corpus: {len(rec_ids)} recordings of {BUILD_SECONDS:.0f} s at "
        f"{cfg.sr} Hz with sidecars ({len(species)} species x "
        f"{BUILD_RECORDINGS}, a {BUILD_TRACK_S:.0f} s species track and a "
        f"{BUILD_TRACK_S:.0f} s noise track each, no RMS metadata) in "
        f"{time.perf_counter() - t0:.2f} s: {species} + noise")

    def reset() -> None:
        torch.cuda.synchronize()
        ffz.reset_launch_counts()
        melspec.reset_launch_counts()

    def counts() -> dict[str, int]:
        torch.cuda.synchronize()
        return {**ffz.launch_counts(), **melspec.launch_counts()}

    # ---- the build, with 1 and 4 workers ----------------------------------
    # a worker process starts by importing the writer (and with it torch)
    # in a fresh interpreter; each split's writer call is timed
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c",
                    "import audio_training_tpu_torch.corpus.writer"],
                   cwd=REPO, check=True)
    log(f"time a fresh interpreter importing corpus/writer.py (a spawned "
        f"build worker's start-up): {time.perf_counter() - t0:.2f} s {card}")
    real_write = cli_build.create_tf_records
    split_s: dict[str, float] = {}

    def timed_write(ds, *args, **kwargs):
        t0 = time.perf_counter()
        n = real_write(ds, *args, **kwargs)
        split_s[ds.name] = round(time.perf_counter() - t0, 2)
        return n

    metas = {}
    for workers in BUILD_WORKERS:
        out = root / f"workers{workers}"
        shutil.rmtree(out, ignore_errors=True)
        argv = [str(out), "-d", str(raw), "--dont-tighten-tracks",
                "--dont-filter-rms", "--workers", str(workers)]
        cli_build.create_tf_records = timed_write
        try:
            with seeded_default_rng(SEED):
                t0 = time.perf_counter()
                rc = cli_build.main(argv)
                build_s = time.perf_counter() - t0
        finally:
            cli_build.create_tf_records = real_write
        check(rc == 0, f"cli/build exited {rc}")
        data = out / "training-data"
        meta_bytes = (data / "training-meta.json").read_bytes()
        metas[workers] = meta_bytes
        meta = json.loads(meta_bytes)
        # every record written, and RecordStream's read of them: it keeps
        # the samples whose labels the run's label space trains on (noise
        # is excluded), so its counts are the meta's over those labels
        space, _, _ = harness.init_labels([data])
        trained = {label for i, label in enumerate(space.source_labels)
                   if space.remap[i] >= 0 or space.extra[i] >= 0}
        written, read, want_written, want_read = {}, {}, {}, {}
        for split, c in meta["counts"].items():
            shards = find_shards(data, split)
            written[split] = sum(1 for shard in shards
                                 for _ in read_tfrecords(shard))
            read[split] = sum(1 for _ in RecordStream(
                shards, space, cfg.samples_per_clip, loop=False))
            want_written[split] = sum(c["sample_counts"].values())
            want_read[split] = sum(n for label, n in
                                   c["sample_counts"].items()
                                   if label in trained)
        clips = sum(written.values())
        nbytes = sum(p.stat().st_size for p in data.rglob("*.tfrecord"))
        log(f"path cli/build {' '.join(argv[2:])} (defaults: {cfg.sr} Hz, "
            f"n_fft {cfg.n_fft}, hop {cfg.hop_length}, {cfg.n_mels} mels, "
            f"{cfg.segment_length:.0f} s segments, {cfg.segment_stride:.0f} s "
            f"stride): {build_s:.2f} s wall with {workers} worker(s), "
            f"{len(rec_ids) / build_s:.1f} recordings/s, {clips / build_s:.1f} "
            f"clips/s; {clips} records ({nbytes / 1e6:.1f} MB in "
            f"{len(list(data.rglob('*.tfrecord')))} GZIP shards); the "
            f"writer's s by split {split_s} {card}")
        log(f"check cli/build with {workers} worker(s): records {written} "
            f"(training-meta.json's counts {want_written}); RecordStream "
            f"reads {read} (the meta's counts of the trained labels "
            f"{sorted(trained)}: {want_read}); labels {meta['labels']}")
        check(written == want_written and read == want_read
              and read["train"] > 0 and read["test"] > 0,
              "training-meta.json's counts are not the records written")
    check(metas[BUILD_WORKERS[0]] == metas[BUILD_WORKERS[-1]],
          "the builds' training-meta.json differ between worker counts")
    data = root / f"workers{BUILD_WORKERS[-1]}" / "training-data"
    meta = json.loads(metas[BUILD_WORKERS[-1]])
    sizes = read  # the samples the run streams, by split

    # ---- cli/train on the built corpus -------------------------------------
    stamps: list[float] = []
    real_fit = harness.fit

    def timed_fit(state, train_batches, *args, **kwargs):
        def timed(epoch):
            for batch in train_batches(epoch):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                yield batch
        return real_fit(state, timed, *args, **kwargs)

    ckpt = root / "runs"
    shutil.rmtree(ckpt, ignore_errors=True)
    run_dir = ckpt / "built-run"
    argv = [run_dir.name, "-d", str(data), "--checkpoint-dir", str(ckpt),
            "--model-name", "badwinner2", "--batch-size", str(TRAIN_BATCH),
            "--epochs", "1", "--steps-per-epoch", str(BUILD_STEPS),
            "--device", str(dev)]
    harness.fit = timed_fit
    try:
        reset()
        t0 = time.perf_counter()
        rc = cli_train.main(argv)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_counts = counts()
    finally:
        harness.fit = real_fit
    check(rc == 0, f"cli/train exited {rc}")
    want = {k: 0 for k in train_counts}
    want["fused_featurizer_mel_bf16"] = BUILD_STEPS
    want["fused_featurizer_mel"] = (math.ceil(sizes["validation"] / TRAIN_BATCH)
                                    + math.ceil(sizes["test"] / TRAIN_BATCH))
    hist = json.loads((run_dir / "history.json").read_text())
    steps = np.diff(stamps)
    step_ms = float(np.median(steps)) * 1e3 if len(steps) else float("nan")
    log(f"path cli/train {' '.join(argv)} on the built corpus ({sizes} "
        f"samples): {train_s:.2f} s; launches {train_counts} (want {want}: "
        f"one bf16 launch a train step, one exact launch a validation and a "
        f"test batch); loss {hist['loss']}, val loss {hist['val_loss']}")
    check(train_counts == want, "phase 14's training launches are not the "
          "path's")
    check(all(np.isfinite(hist[k]).all() for k in ("loss", "val_loss")),
          "non-finite losses on the built corpus")
    log(f"time cli/train on the built corpus B={TRAIN_BATCH}: "
        f"{step_ms:.3f} ms a step with the loader (median of "
        f"{len(steps)} intervals), "
        f"{TRAIN_BATCH / (step_ms / 1e3):.1f} samples/s (phase 6's step on "
        f"an in-memory batch: {fit_step_ms:.3f} ms) {card}")

    # ---- cli/predict --test-split on the run --------------------------------
    run_meta = load_metadata(run_dir)
    labels = run_meta.get("ebird_labels", run_meta["labels"])
    remapped = run_meta.get("remapped_labels", {})

    def mapped(label: str) -> bool:
        return (remapped[label] != -1 if label in remapped
                else label in labels)

    with seeded_default_rng(SEED):
        ds = AudioDataset("all", SamplingConfig(tighten_tracks=False,
                                                filter_rms=False))
        ds.load_meta(raw)
    _, _, test = split_by_file(ds, meta)
    windows = {rid: sum(1 for s in r.samples if s.tags and mapped(s.tags[0]))
               for rid, r in test.recs.items()}
    expected = sum(c for label, c in
                   meta["counts"]["test"]["sample_counts"].items()
                   if mapped(label))
    split_file = data / "training-meta.json"

    def test_split(device: str, split: Path, out: Path):
        argv = [str(run_dir), "-w", "chkpt", "--test-split", str(split),
                "--data-dir", str(raw), "--confusion-out", str(out),
                "--device", device]
        with seeded_default_rng(SEED):
            t0 = time.perf_counter()
            rc = cli_predict.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check(rc == 0, f"cli/predict --test-split exited {rc}")
        return np.load(out.with_suffix(".npy")), wall, argv

    reset()
    cm, wall, argv = test_split(str(dev), split_file, root / "cm" / "test")
    split_counts = counts()
    with_windows = sum(1 for n in windows.values() if n)
    want = {k: 0 for k in split_counts}
    want["fused_featurizer_mel_centered"] = with_windows
    log(f"path cli/predict {' '.join(argv)}: {len(test.recs)} test "
        f"recordings ({with_windows} with windows, {windows}), "
        f"{wall:.2f} s wall ({wall / max(len(test.recs), 1):.3f} s a "
        f"recording); confusion total {int(cm.sum())}, trace "
        f"{int(np.trace(cm))} (want the total {expected}: the test samples "
        f"whose label the run maps); launches {split_counts} (want {want}) "
        f"{card}")
    check(int(cm.sum()) == expected == sum(windows.values()),
          "the test split's confusion does not hold every test sample")
    check(split_counts == want, "--test-split's K1 launches are not one "
          "centered launch a test recording with windows")

    few = sorted(r for r, n in windows.items() if n)[:BUILD_CPU_RECORDINGS]
    few_split = root / "few-test.json"
    few_split.write_text(json.dumps({"recs": {"test": few}}))
    cm_card, card_s, _ = test_split(str(dev), few_split, root / "cm" / "few")
    cm_cpu, cpu_s, _ = test_split("cpu", few_split, root / "cm" / "few-cpu")
    log(f"check --test-split on {few}: the card's confusion (total "
        f"{int(cm_card.sum())}, {card_s:.2f} s) equals --device cpu's "
        f"({cpu_s:.2f} s): {bool(np.array_equal(cm_card, cm_cpu))}")
    check(np.array_equal(cm_card, cm_cpu) and cm_card.sum() > 0,
          "--test-split's confusion on the card differs from the CPU's")
    log(f"time phase 14: {time.perf_counter() - t_phase:.1f} s {card}")
    return {"fused_featurizer_mel_bf16":
            train_counts["fused_featurizer_mel_bf16"],
            "fused_featurizer_mel": train_counts["fused_featurizer_mel"],
            "fused_featurizer_mel_centered":
            split_counts["fused_featurizer_mel_centered"]}


def ingest(argv: list[str]) -> float:
    """``cli/ingest`` as a user runs it, in its own interpreter (its
    spawned workers then re-import the CLI, not this script); wall s."""
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "audio_training_tpu_torch.cli.ingest",
                    *argv], cwd=REPO, check=True)
    return time.perf_counter() - t0


def corpus_tools_phase(dev, cfg, card, model, chain, requests,
                       mel_ms: float, chain_ms: float) -> int:
    """Phase 15: preparing a corpus.  Phase 14's raw corpus enriched by
    ``cli/ingest --signal --rms --tracks`` (``TOOLS_WORKERS`` workers on all
    of it, one on its first ``TOOLS_ONE_WORKER_RECORDINGS``, at one path so
    that the sidecars compare byte for byte), ``--gen-tracks`` on untracked
    copies, ``cli/build`` at its defaults (tracks tightened and filtered by
    RMS), ``cli/debug`` of the build on the card (K1's exact tf tier, one
    launch a batch; the check equal to ``--device cpu``'s), ``cli/augment``
    of the build, and ``utils/profiling`` around phase 4's chain against
    phase 5's times.  Returns cli/debug's K1 launches."""
    import shutil
    import warnings

    import torch

    from audio_training_tpu_torch.cli import augment as cli_augment
    from audio_training_tpu_torch.cli import build as cli_build
    from audio_training_tpu_torch.cli import debug as cli_debug
    from audio_training_tpu_torch.config import FeaturizerConfig
    from audio_training_tpu_torch.data import (
        RecordStream, find_shards, load_meta, read_tfrecords)
    from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
    from audio_training_tpu_torch.taxonomy import load_ontology
    from audio_training_tpu_torch.taxonomy.labels import build_label_space
    from audio_training_tpu_torch.train import harness
    from audio_training_tpu_torch.utils import profiling

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    src = REPO / "build" / "chip_smoke_build" / "raw"
    root = REPO / "build" / "chip_smoke_tools"
    shutil.rmtree(root, ignore_errors=True)
    raw = root / "raw"
    stems = sorted(p.stem for p in src.glob("*.wav"))

    def copy_raw(dst: Path, names: list[str], keep_tracks: bool = True):
        """Copies of phase 14's WAVs and sidecars, without its empty
        ``signal`` list (enrichment adds none to a sidecar that has one)."""
        shutil.rmtree(dst, ignore_errors=True)
        dst.mkdir(parents=True)
        for name in names:
            shutil.copyfile(src / f"{name}.wav", dst / f"{name}.wav")
            meta = json.loads((src / f"{name}.txt").read_text())
            meta.pop("signal")
            if not keep_tracks:
                meta["label"] = meta.pop("Tracks")[0]["tags"][0]["what"]
            (dst / f"{name}.txt").write_text(json.dumps(meta))

    # ---- 1. enrichment, with 1 and with TOOLS_WORKERS workers -------------
    t0 = time.perf_counter()
    probe = subprocess.run(
        [sys.executable, "-c", "import sys, audio_training_tpu_torch.corpus"
         ".enrich; print('torch' in sys.modules)"],
        cwd=REPO, check=True, capture_output=True, text=True)
    startup_s = time.perf_counter() - t0
    worker_torch = probe.stdout.strip()
    log(f"time a fresh interpreter importing corpus/enrich.py (an "
        f"enrichment worker's start-up, spawned): {startup_s:.2f} s, torch "
        f"imported: {worker_torch} {card}")
    check(worker_torch == "False", "an enrichment worker imports torch")
    flags = ["--signal", "--rms", "--tracks"]
    first = stems[:TOOLS_ONE_WORKER_RECORDINGS]
    copy_raw(raw, first)
    one_s = ingest(["-d", str(raw), *flags, "--workers", "1"])
    one = {n: (raw / f"{n}.txt").read_bytes() for n in first}
    copy_raw(raw, stems)
    many_s = ingest(["-d", str(raw), *flags,
                     "--workers", str(TOOLS_WORKERS)])
    metas = {n: json.loads((raw / f"{n}.txt").read_text()) for n in stems}
    same = sum((raw / f"{n}.txt").read_bytes() == one[n] for n in first)
    n_signals = sum(len(m["signal"]) for m in metas.values())
    tracks = [t for m in metas.values() for t in m["Tracks"]]
    enriched = all("signal" in m and "best_track" in m
                   for m in metas.values()) and all(
        {"upper_rms", "noise_rms", "bird_rms"} <= t.keys() for t in tracks)
    for workers, n, wall in ((1, len(first), one_s),
                             (TOOLS_WORKERS, len(stems), many_s)):
        log(f"path cli/ingest -d <raw> {' '.join(flags)} --workers "
            f"{workers}: {n} recordings in {wall:.2f} s wall (its own "
            f"interpreter), {n / wall:.2f} recordings/s {card}")
    log(f"check enrichment: {len(stems)} sidecars with signal spans "
        f"({n_signals} in all) and a best_track, {len(tracks)} tracks with "
        f"upper / noise / bird RMS arrays: {enriched}; the first "
        f"{len(first)} sidecars byte-identical at 1 and {TOOLS_WORKERS} "
        f"workers: {same} of {len(first)}")
    check(enriched and n_signals > 0, "enrichment left a sidecar without "
          "signal spans or a track without RMS arrays")
    check(same == len(first), "the sidecars differ between worker counts")
    # one process's s a recording by stage, on the first 4 recordings
    from audio_training_tpu_torch.corpus import enrich
    from audio_training_tpu_torch.corpus.audioio import load_recording
    from audio_training_tpu_torch.detect.signals import (
        DETECT_HOP, _host_stft_mag, signal_noise)

    stages = dict.fromkeys(("decode", "band RMS", "detection STFT",
                            "detection", "best track"), 0.0)
    for name in first[:4]:
        t0 = time.perf_counter()
        y, sr = load_recording(src / f"{name}.wav", target_sr=cfg.sr)
        t1 = time.perf_counter()
        enrich.add_rms_data_to_tracks(
            y, sr, json.loads((src / f"{name}.txt").read_text())["Tracks"])
        t2 = time.perf_counter()
        _host_stft_mag(y, 2048, DETECT_HOP)
        t3 = time.perf_counter()
        signal_noise(y, sr)
        t4 = time.perf_counter()
        enrich.generate_best_track(raw / f"{name}.txt")
        t5 = time.perf_counter()
        for stage, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                      t5 - t4)):
            stages[stage] += dt / 4
    log(f"time enrichment by stage, one process, s a recording (detection "
        f"holds its STFT): { {k: round(v, 3) for k, v in stages.items()} } "
        f"{card}")

    # ---- 2. --gen-tracks on untracked copies -------------------------------
    untracked = root / "untracked"
    copy_raw(untracked, stems[::len(stems) // GEN_TRACKS_RECORDINGS]
             [:GEN_TRACKS_RECORDINGS], keep_tracks=False)
    gen_s = ingest(["-d", str(untracked), "--gen-tracks"])
    generated = {p.stem: json.loads(p.read_text()).get("Tracks", [])
                 for p in sorted(untracked.glob("*.txt"))}
    labelled = all(t["tags"] and t["tags"][0]["what"]
                   for ts in generated.values() for t in ts)
    log(f"path cli/ingest -d <untracked> --gen-tracks: "
        f"{len(generated)} recordings in {gen_s:.2f} s wall; tracks "
        f"{ {k: len(v) for k, v in generated.items()} }, each tagged with "
        f"its sidecar's label: {labelled} {card}")
    check(len(generated) == GEN_TRACKS_RECORDINGS
          and all(generated.values()) and labelled,
          "--gen-tracks left a recording without tracks")

    # ---- 3. cli/build at its defaults ---------------------------------------
    out = root / "build"
    argv = [str(out), "-d", str(raw), "--workers", "1"]
    with seeded_default_rng(SEED):
        t0 = time.perf_counter()
        rc = cli_build.main(argv)
        build_s = time.perf_counter() - t0
    check(rc == 0, f"cli/build exited {rc}")
    data = out / "training-data"
    meta = load_meta(data)
    space, _, _ = harness.init_labels([data])
    trained = {label for i, label in enumerate(space.source_labels)
               if space.remap[i] >= 0 or space.extra[i] >= 0}
    written, read, want_read = {}, {}, {}
    for split, c in meta["counts"].items():
        shards = find_shards(data, split)
        written[split] = sum(1 for shard in shards
                             for _ in read_tfrecords(shard))
        read[split] = sum(1 for _ in RecordStream(
            shards, space, cfg.samples_per_clip, loop=False))
        want_read[split] = sum(n for label, n in c["sample_counts"].items()
                               if label in trained)
    want_written = {split: sum(c["sample_counts"].values())
                    for split, c in meta["counts"].items()}
    untight = load_meta(REPO / "build" / "chip_smoke_build" / "workers1"
                        / "training-data")["counts"]
    untight = {split: sum(c["sample_counts"].values())
               for split, c in untight.items()}
    clips = sum(written.values())
    log(f"path cli/build {' '.join(argv[2:])} (the defaults: tracks "
        f"tightened and filtered by RMS) on the enriched corpus: "
        f"{build_s:.2f} s wall, {len(stems) / build_s:.1f} recordings/s, "
        f"{clips / build_s:.1f} clips/s; records by split {written} "
        f"(phase 14's untightened build: {untight}) {card}")
    log(f"check the default build: records {written} (training-meta.json's "
        f"counts {want_written}); RecordStream reads {read} (want "
        f"{want_read})")
    check(written == want_written and read == want_read
          and read["train"] > 0 and read["validation"] > 0,
          "the default build's records are not training-meta.json's")

    # ---- 4. cli/debug of the build on the card -----------------------------
    debug_cfg = FeaturizerConfig()
    debug_space = build_label_space(
        load_ontology(), sorted(set(meta["labels"]) | {"bird"}))
    debug_samples = sum(1 for _ in RecordStream(
        find_shards(data, "train"), debug_space, debug_cfg.samples_per_clip,
        loop=False))
    n_batches = min(DEBUG_BATCHES, debug_samples // 8)
    check(n_batches >= DEBUG_CPU_BATCHES, "the build's train split holds "
          "too few batches for cli/debug")
    def run_debug(batches: int, device: str):
        """``cli/debug``'s run (its exit code is 0 when the check is ok);
        the check's counts, launches, wall s."""
        argv = [str(data), "--batches", str(batches), "--device", device]
        torch.cuda.synchronize()
        ffz.reset_launch_counts()
        t0 = time.perf_counter()
        res = cli_debug.debug_pipeline(cli_debug.parse_args(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rc = 0 if res.ok else 1
        res = {k: getattr(res, k) for k in (
            "checked", "nan_count", "out_of_range", "constant",
            "label_counts")}
        return rc, res, ffz.launch_counts(), wall, argv

    rc, res, counts, wall, argv = run_debug(n_batches, str(dev))
    debug_launches = counts["fused_featurizer_mel"]
    want = {k: 0 for k in counts}
    want["fused_featurizer_mel"] = n_batches
    log(f"path cli/debug {' '.join(argv[1:])} (train split, "
        f"{debug_samples} samples at B=8): exit {rc}, {res}; launches "
        f"{counts} (want {want}: one exact tf launch a batch); {wall:.2f} s "
        f"wall, {n_batches / wall:.2f} batches/s {card}")
    check(rc == 0 and res["nan_count"] == 0 and res["constant"] == 0
          and res["checked"] == 8 * n_batches,
          "cli/debug found NaN or constant samples in the default build")
    check(counts == want, "cli/debug's launches are not one exact tf launch "
          "a batch")
    _, card_res, _, _, _ = run_debug(DEBUG_CPU_BATCHES, str(dev))
    _, cpu_res, cpu_counts, cpu_s, _ = run_debug(DEBUG_CPU_BATCHES, "cpu")
    log(f"check cli/debug --batches {DEBUG_CPU_BATCHES}: the card's check "
        f"{card_res} equals --device cpu's ({cpu_s:.2f} s, launches "
        f"{sum(cpu_counts.values())}): {card_res == cpu_res}")
    check(card_res == cpu_res and sum(cpu_counts.values()) == 0,
          "cli/debug on the card differs from --device cpu")

    # ---- 5. cli/augment of the build ---------------------------------------
    mixed = root / "mixed"
    t0 = time.perf_counter()
    rc = cli_augment.main([str(data), str(mixed)])
    augment_s = time.perf_counter() - t0
    check(rc == 0, f"cli/augment exited {rc}")
    mixed_shards = find_shards(mixed)
    n_mixed = sum(1 for shard in mixed_shards for _ in read_tfrecords(shard))
    streamed = sum(1 for _ in RecordStream(
        mixed_shards, space, cfg.samples_per_clip, loop=False,
        keep_unlabeled=True))
    log(f"path cli/augment <build> <out>: {n_mixed} mixed records in "
        f"{len(mixed_shards)} shards from {written['train']} train records, "
        f"{augment_s:.2f} s wall, {n_mixed / augment_s:.1f} records/s; "
        f"RecordStream reads {streamed} {card}")
    check(n_mixed > 0 and streamed == n_mixed,
          "the port's RecordStream does not read every mixed record")

    # ---- 6. utils/profiling around phase 4's chain -------------------------
    # the K1 counter says how many launches ran and the trace how many it
    # recorded; a trace that left out a launch (unrecorded_launches) is
    # taken again, at most twice, as phase 7 takes its profile again
    torch.cuda.reset_peak_memory_stats()
    for attempt in range(3):
        trace_dir = root / f"profile-{attempt}"
        torch.cuda.synchronize()
        ffz.reset_launch_counts()
        with profiling.trace(trace_dir):
            for r in requests:
                chain(r)
        launched = ffz.launch_counts()["fused_featurizer_mel"]
        lost = profiling.unrecorded_launches(trace_dir)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            rows = profiling.device_event_summary(trace_dir, device=0)
        mel_rows = [(n, ms) for n, ms in rows if "mel_power_kernel" in n]
        events = json.loads(sorted(trace_dir.glob("*.trace.json"))[-1]
                            .read_text())["traceEvents"]
        n_mel = sum(1 for e in events if e.get("cat") == "kernel"
                    and "mel_power_kernel" in e["name"])
        n_launches = sum(1 for e in events if e.get("ph") == "X"
                         and e.get("cat") in ("cuda_runtime", "cuda_driver")
                         and "Launch" in e["name"])
        if not lost and n_mel == launched:
            break
        log(f"profile attempt {attempt + 1} left out {len(lost)} of "
            f"{n_launches} launches, at positions {[i for i, _ in lost]}, "
            f"and {launched - n_mel} of {launched} mel_power_kernel launches")
    busy = sum(ms for _, ms in rows)
    prof_mel_ms = sum(ms for _, ms in mel_rows) / len(requests)
    log(f"profile utils/profiling.trace, {len(requests)} requests of the "
        f"badwinner2 chain B={BATCH} (attempt {attempt + 1}): "
        f"{busy / len(requests):.3f} ms of card events a request; "
        f"mel_power_kernel {prof_mel_ms:.4f} ms a request, {n_mel} of "
        f"{launched} launches recorded (phase 5's CUDA events: "
        f"{mel_ms:.4f} ms); {len(lost)} of {n_launches} launches left out "
        f"{card}")
    for name, ms in rows[:8]:
        log(f"  kernel {ms / len(requests):9.4f} ms a request {name[:90]}")
    check(launched == len(requests) and n_mel == launched and not lost,
          "the profile left out launches on each of 3 attempts")
    check(abs(prof_mel_ms - mel_ms) <= PROFILE_KERNEL_REL * mel_ms,
          "the profile's mel_power_kernel time is not phase 5's")
    lmap = profiling.fusion_layer_map(chain, requests[0], model=model,
                                      trace_dir=root / "layer-map")
    condense = "BadWinner2.convs.4"
    condense_kernels = sorted(k for k, paths in lmap.items()
                              if condense in paths)
    log(f"profile fusion_layer_map of the chain: {len(lmap)} kernels "
        f"under {len({p for ps in lmap.values() for p in ps})} module "
        f"paths; the condense conv ({condense}, 44 x 3) ran "
        f"{[k[:60] for k in condense_kernels]}")
    check(bool(condense_kernels), "the layer map attributes no kernel to "
          "the condense conv")
    stats = profiling.time_fn(chain, requests[1], iters=5)
    log(f"time utils/profiling.time_fn of the chain B={BATCH}: "
        f"{stats['mean_ms']:.3f} ms mean, p50 {stats['p50_ms']:.3f}, p90 "
        f"{stats['p90_ms']:.3f} (phase 5: {chain_ms:.3f} ms a batch) {card}")
    check(abs(stats["mean_ms"] - chain_ms) <= PROFILE_CHAIN_REL * chain_ms,
          "time_fn of the chain is not phase 5's time")
    memory = profiling.log_memory_stats()["cuda:0"]
    log(f"memory utils/profiling.log_memory_stats: peak "
        f"{memory['peak_bytes_in_use'] / 1e9:.2f} GB, in use "
        f"{memory['bytes_in_use'] / 1e9:.2f} GB of "
        f"{memory['bytes_limit'] / 1e9:.2f} GB {card}")
    log(f"time phase 15: {time.perf_counter() - t_phase:.1f} s {card}")
    return debug_launches



def dp_sizes(corpus: Path, run_root: Path, step_bns: list[dict]) -> dict:
    """Phase 16's sizes and paths, handed to the ranks (spawned processes
    import this script anew), and phase 5's BatchNorms."""
    return {"batch": DP_BATCH, "windows": DP_WINDOWS,
            "steps": DP_TIMED_STEPS, "window_batch": WINDOW_BATCH,
            "f64_batch": DP_F64_BATCH, "corpus": str(corpus),
            "run_root": str(run_root),
            "bn_specs": [spec for spec, _ in bn_groups(step_bns)]}


def dp_bn_rows(spec: dict, mesh, dev) -> dict:
    """The BatchNorm kernels of ``spec`` on this rank's rows of
    :func:`bn_case`'s batch of DP_BN_BATCH under ``mesh``: y and dx of the
    rows, this rank's parameter gradients and running statistics, on the
    host, and the kernels' launches."""
    import torch

    from audio_training_tpu_torch.ops.cuda import batch_norm as bn_ops
    from audio_training_tpu_torch.parallel import batch_sharding

    m, x, dy = bn_case(spec, DP_BN_BATCH, dev)
    rows = batch_sharding(mesh).rows(DP_BN_BATCH)
    bn_ops.reset_launch_counts()
    with mesh:
        got = bn_pass(m, x[rows], dy[rows])
    torch.cuda.synchronize()
    return {"y": got["y"].cpu(), "dx": got["dx"].cpu(),
            "grads": [g.cpu() for g in got["grads"]],
            "stats": [t.cpu() for t in got["stats"]],
            "counts": bn_ops.launch_counts()}


def dp_batch(cfg, n: int):
    """Phase 16's global batch of ``n`` from a numpy seed: ``(raw, y, raw2,
    y2)``, the mixup partner the batch rolled by one."""
    import numpy as np

    x, y = tone_band_batch(n, NUM_LABELS, cfg.samples_per_clip, cfg.sr,
                           SEED + 16)
    partner = np.roll(np.arange(n), 1)
    return x, y, x[partner], y[partner]


def dp_windows(cfg, n: int):
    import numpy as np

    rng = np.random.default_rng(SEED + 17)
    return rng.standard_normal((n, cfg.samples_per_clip)).astype(np.float32)


def dp_model(cfg, weights, dev):
    """badwinner2 f32 at full width with ``weights``, in a fresh train
    state on ``dev``."""
    from audio_training_tpu_torch.models import build_model
    from audio_training_tpu_torch.train import create_train_state

    model = build_model("badwinner2", NUM_LABELS, logits_only=True,
                        n_mels=cfg.n_mels, mel_frames=cfg.mel_frames).module
    model.load_state_dict(weights)
    return create_train_state(model, learning_rate=TRAIN_LR, device=dev)


def dp_stepper(cfg, state, batch, mesh, dev):
    """One call: preprocess (mixup, K1's ``"default"`` tier) and one train
    step of ``batch`` (this rank's rows under ``mesh``), from generators
    seeded alike on every rank."""
    import contextlib

    import torch

    from audio_training_tpu_torch.data import make_preprocess_fn
    from audio_training_tpu_torch.train import fresh_metrics, make_train_step

    pre = make_preprocess_fn(cfg, augment=True, device=dev)
    step = make_train_step(mesh=mesh)
    gen_pre = torch.Generator(device=dev).manual_seed(SEED)
    gen_drop = torch.Generator(device=dev).manual_seed(SEED + 1)

    def one():
        with mesh if mesh is not None else contextlib.nullcontext():
            mel, yy = pre(*batch, gen_pre)
        return step(state, fresh_metrics(dev), mel, yy, gen_drop)

    return one


def dp_f64_step(cfg, weights, dev, mesh, n: int) -> dict:
    """One float64 train step on a global batch of ``n`` (this rank's rows
    under ``mesh``): the whole batch's image is made first, on every rank
    alike, so that the two runs differ in the step's summation order
    alone.  Returns the loss, gradients and state after the step."""
    import contextlib

    import torch

    from audio_training_tpu_torch.data import make_preprocess_fn
    from audio_training_tpu_torch.parallel import batch_sharding
    from audio_training_tpu_torch.train import fresh_metrics, make_train_step
    from audio_training_tpu_torch.train.metrics import metrics_compute

    batch = tuple(torch.as_tensor(a, device=dev) for a in dp_batch(cfg, n))
    mel, y = make_preprocess_fn(cfg, augment=True, device=dev)(
        *batch, torch.Generator(device=dev).manual_seed(SEED))
    rows = slice(None) if mesh is None else batch_sharding(mesh).rows(n)
    state = dp_model(cfg, weights, dev)
    state.model.double()
    state, metrics = make_train_step(mesh=mesh)(
        state, fresh_metrics(dev), mel[rows].double(), y[rows].double(),
        torch.Generator(device=dev).manual_seed(SEED + 1))
    with mesh if mesh is not None else contextlib.nullcontext():
        return {"loss": metrics_compute(metrics)["loss"],
                **dp_tensors(state.model)}


def dp_tensors(model) -> dict:
    """A model's gradients and state after a step, copied to the host."""
    return {"grads": {n: p.grad.detach().cpu().clone()
                      for n, p in model.named_parameters()},
            "after": {n: t.detach().cpu().clone()
                      for n, t in model.state_dict().items()}}


def dp_train_run(cfg, dev, corpus: str, root: str,
                 devices: list | None) -> dict:
    """``train_run`` on phase 10's corpus (``DP_RUN_STEPS`` steps of
    B=``DP_BATCH`` global, f32, learning rate 0, BN re-estimation and the
    epoch and test confusions): over the mesh of ``devices`` in a rank (the
    sharded loaders, ``fit(mesh=)``, the evaluation passes' rows), or on
    ``dev`` alone where ``devices`` is None.  Returns its history, test
    predictions and metrics, the run directory's files (as this process
    sees them) and K1's launches."""
    from pathlib import Path

    import torch

    from audio_training_tpu_torch.config import TrainConfig
    from audio_training_tpu_torch.eval.confusion import load_raw_predictions
    from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
    from audio_training_tpu_torch.train import harness

    n = 1 if devices is None else len(devices)
    train_cfg = TrainConfig(
        model_name="badwinner2", batch_size=DP_BATCH, learning_rate=0.0,
        epochs=1, compute_dtype="float32", bn_reestimate=True,
        epoch_confusion=True, num_data_shards=n, seed=SEED)
    ffz.reset_launch_counts()
    t0 = time.perf_counter()
    result = harness.train_run(
        [corpus], "dp-run" if n > 1 else "one-run", checkpoint_root=root,
        train_cfg=train_cfg, featurizer=cfg, steps_per_epoch=DP_RUN_STEPS,
        device=dev, mesh_devices=devices)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_dir = Path(result.run_dir)
    raw = run_dir / "confusion-raw.npy"
    return {"history": result.history, "run_s": run_s,
            "test_metrics": {k: v for k, v in result.test_metrics.items()
                             if k != "per_label"},
            "y_pred": load_raw_predictions(raw)["y_pred"]
            if raw.exists() else None,
            "files": sorted(str(f.relative_to(run_dir))
                            for f in run_dir.rglob("*") if f.is_file()),
            "counts": ffz.launch_counts()}


def dp_rank(rank: int, repo: str, devices: list, weights_path: str,
            sizes: dict) -> dict:
    """One rank of phase 16: its rows of the batch through one DP step
    (compared by the parent), a later step counted for the audit, timed
    steps, the sharded Predictor over the windows, and ``train_run`` over
    the mesh (:func:`dp_train_run`)."""
    import contextlib

    sys.path.insert(0, repo)
    import torch

    from audio_training_tpu_torch.config import (
        FeaturizerConfig, InferenceConfig)
    from audio_training_tpu_torch.infer import Predictor
    from audio_training_tpu_torch.ops.cuda import batch_norm as bn_ops
    from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
    from audio_training_tpu_torch.parallel import (
        make_mesh, replicated, shard_batch)
    from audio_training_tpu_torch.parallel.audit import counting
    from audio_training_tpu_torch.train.metrics import metrics_compute

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = FeaturizerConfig()
    mesh = make_mesh(num_data=len(devices), devices=devices)
    dev = mesh.device
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else lambda: None)
    weights = torch.load(weights_path, map_location="cpu", weights_only=True)
    state = dp_model(cfg, weights, dev)
    replicated(mesh)(state.model)
    one = dp_stepper(cfg, state,
                     shard_batch(mesh, *dp_batch(cfg, sizes["batch"])), mesh,
                     dev)
    ffz.reset_launch_counts()
    bn_ops.reset_launch_counts()
    state, metrics = one()
    sync()
    step_counts = ffz.launch_counts()
    with mesh:
        loss = metrics_compute(metrics)["loss"]
    out = {"backend": mesh.backend, "device": str(dev), "loss": loss,
           "step_counts": step_counts, "bn_counts": bn_ops.launch_counts(),
           **dp_tensors(state.model)}
    with counting() as inv:
        one()
        sync()
    out["inventory"] = inv.ops
    # the timed steps (CUDA events on the card, the host clock off it)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    for _ in range(sizes["steps"]):
        one()
    if dev.type == "cuda":
        end.record()
        end.synchronize()
        out["step_ms"] = start.elapsed_time(end) / sizes["steps"]
    else:
        out["step_ms"] = (time.perf_counter() - t0) * 1e3 / sizes["steps"]
    del one, state
    # float64 on the CPU ranks: the card's train-mode BatchNorm kernels
    # take bf16 and f32 only
    cpu_mesh = make_mesh(num_data=len(devices),
                         devices=["cpu"] * len(devices))
    out["f64"] = dp_f64_step(cfg, weights, torch.device("cpu"), cpu_mesh,
                             sizes["f64_batch"])
    # the BatchNorm kernels alone under the card's mesh
    out["bn"] = [dp_bn_rows(spec, mesh, dev) for spec in sizes["bn_specs"]]
    # the sharded Predictor from the phase's starting weights
    module = dp_model(cfg, weights, dev).model
    pred = Predictor(module, [f"l{i}" for i in range(NUM_LABELS)], cfg,
                     InferenceConfig(max_window_batch=sizes["window_batch"]),
                     device=dev, mesh=mesh)
    windows = dp_windows(cfg, sizes["windows"])
    ffz.reset_launch_counts()
    with counting() as inv:
        out["probs"] = pred.predict_windows(windows)
        sync()
    out["predict_counts"] = ffz.launch_counts()
    out["predict_inventory"] = inv.ops
    del pred, module
    torch.cuda.empty_cache()
    out["run"] = dp_train_run(cfg, dev, sizes["corpus"],
                              f"{sizes['run_root']}/{mesh.backend}", devices)
    with contextlib.suppress(Exception):
        torch.cuda.empty_cache()
    return out


def data_parallel_phase(dev, cfg, card,
                        step_bns: list[dict]) -> dict[str, int]:
    """Phase 16: data parallel over two ranks on one card (gloo), and over
    two cards (NCCL) where the machine has them; see the module docstring.
    Returns the ranks' K1 launches by counter, for the kernel records."""
    import math
    import shutil

    import numpy as np
    import torch

    from audio_training_tpu_torch.config import InferenceConfig
    from audio_training_tpu_torch.infer import Predictor
    from audio_training_tpu_torch.parallel.audit import (
        CollectiveInventory, audit_dp_inference, audit_dp_train_step)
    from audio_training_tpu_torch.parallel.multihost import run_ranks
    from audio_training_tpu_torch.train import create_train_state
    from audio_training_tpu_torch.train.metrics import metrics_compute

    t_phase = time.perf_counter()
    out_dir = REPO / "build" / "chip_smoke_dp"
    out_dir.mkdir(parents=True, exist_ok=True)
    weights_path = out_dir / "weights.pt"
    from audio_training_tpu_torch.models import build_model

    seeded = create_train_state(
        build_model("badwinner2", NUM_LABELS, logits_only=True,
                    n_mels=cfg.n_mels, mel_frames=cfg.mel_frames).module,
        learning_rate=TRAIN_LR, seed=SEED, device="cpu")
    weights = seeded.model.state_dict()
    torch.save(weights, weights_path)
    n_params = sum(p.numel() for p in seeded.model.parameters())
    n_bn = sum(b.numel() for n, b in seeded.model.named_buffers()
               if n.endswith(("running_mean", "running_var")))
    del seeded

    # the single-process step on the whole batch
    state = dp_model(cfg, weights, dev)
    batch = tuple(torch.as_tensor(a, device=dev)
                  for a in dp_batch(cfg, DP_BATCH))
    one = dp_stepper(cfg, state, batch, None, dev)
    state, metrics = one()
    torch.cuda.synchronize()
    single = {"loss": metrics_compute(metrics)["loss"],
              **dp_tensors(state.model)}
    torch.cuda.reset_peak_memory_stats()
    single_ms = time_ms(one, iters=DP_TIMED_STEPS, warmup=1)
    single_peak = torch.cuda.max_memory_allocated() / 1e9
    del one, state, batch
    single64 = dp_f64_step(cfg, weights, torch.device("cpu"), None,
                           DP_F64_BATCH)
    module = dp_model(cfg, weights, dev).model
    probs_1 = Predictor(module, [f"l{i}" for i in range(NUM_LABELS)], cfg,
                        InferenceConfig(max_window_batch=WINDOW_BATCH),
                        device=dev).predict_windows(dp_windows(cfg,
                                                               DP_WINDOWS))
    del module
    torch.cuda.empty_cache()
    corpus = REPO / "build" / "chip_smoke_corpus"  # phase 10's
    run_root = out_dir / "runs"
    shutil.rmtree(run_root, ignore_errors=True)
    run_1 = dp_train_run(cfg, dev, str(corpus), str(run_root / "one"), None)
    torch.cuda.empty_cache()
    log(f"phase 16: badwinner2 f32 at {cfg.n_mels} x {cfg.mel_frames}, "
        f"{NUM_LABELS} labels, {n_params} parameters ({n_bn} BN statistics), "
        f"B={DP_BATCH} global; the single-process step {single_ms:.3f} ms, "
        f"peak {single_peak:.2f} GB {card}")

    from audio_training_tpu_torch.infer.windows import bucket_pad

    padded = -(-bucket_pad(DP_WINDOWS, InferenceConfig().bucket_sizes)
               // DP_RANKS) * DP_RANKS
    chunks = -(-padded // WINDOW_BATCH)

    sizes = {k: n for k, (n, _) in CORPUS_SPLITS.items()}
    run_want = {k: 0 for k in run_1["counts"]}
    run_want["fused_featurizer_mel_bf16"] = DP_RUN_STEPS
    # a validation batch an epoch (the mesh drops the tail), a BN
    # re-estimation and a test batch each (their tails kept)
    run_want["fused_featurizer_mel"] = (
        sizes["validation"] // DP_BATCH + math.ceil(sizes["train"] / DP_BATCH)
        + math.ceil(sizes["test"] / DP_BATCH))

    def compare_runs(runs, label: str) -> None:
        r0 = runs[0]
        rel = {k: abs(r0["history"][k][0] - run_1["history"][k][0])
               / abs(run_1["history"][k][0]) for k in ("loss", "val_loss")}
        err = np.abs(r0["y_pred"] - run_1["y_pred"])
        ok = bool((err <= DP_RUN_ATOL + DP_RUN_RTOL
                   * np.abs(run_1["y_pred"])).all())
        log(f"check DP train_run {label}: {DP_RUN_STEPS} step of "
            f"B={DP_BATCH} global over phase 10's corpus ({sizes}), f32, "
            f"lr 0, BN re-estimation and the confusions; train loss "
            f"{rel['loss']:.3e} and validation loss {rel['val_loss']:.3e} "
            f"relative to the single-device run's (limit {DP_LOSS_REL}); "
            f"test predictions {r0['y_pred'].shape} max abs difference "
            f"{err.max():.3e} (rtol {DP_RUN_RTOL}, atol {DP_RUN_ATOL}): "
            f"{ok}; test_samples {r0['test_metrics']['test_samples']}; "
            f"K1 launches a rank {[r['counts'] for r in runs]} (want "
            f"{run_want}); {[round(r['run_s'], 2) for r in runs]} s a rank, "
            f"the single-device run {run_1['run_s']:.2f} s {card}")
        check(max(rel.values()) <= DP_LOSS_REL and ok,
              f"the DP train_run ({label}) differs from the single-device "
              f"run")
        # the epoch metrics are summed over the ranks; only epoch_time,
        # each rank's own clock, differs
        same = lambda h: {k: v for k, v in h.items()  # noqa: E731
                          if k != "epoch_time"}
        check(all(same(r["history"]) == same(r0["history"])
                  and r["test_metrics"] == r0["test_metrics"] for r in runs),
              f"the ranks' train_run results ({label}) differ")
        check(r0["test_metrics"]["test_samples"] == sizes["test"]
              and r0["y_pred"].shape == run_1["y_pred"].shape,
              f"the DP train_run's test metrics ({label}) miss samples")
        for name in ("chkpt.pt", "history.json", "metadata.txt",
                     "confusion.npy", "epoch-confusion/epoch_000.npy"):
            check(name in r0["files"], f"the DP run ({label}) wrote no "
                  f"{name}")
        check(all(r["counts"] == run_want for r in runs),
              f"a rank's K1 launches in train_run ({label}) are not the "
              f"path's")

    def compare(results, label: str) -> dict[str, int]:
        r0, r1 = results[0], results[1]
        loss_diff = abs(r0["loss"] - single["loss"])
        grad_rel = max(
            float((r0["grads"][n] - g).abs().max() / g.abs().max())
            for n, g in single["grads"].items())
        stats = [n for n in single["after"] if "running" in n]
        stat_rel = max(
            float((r0["after"][n] - single["after"][n]).abs().max()
                  / single["after"][n].abs().max()) for n in stats)
        rank_diff = max(float((r0["after"][n] - r1["after"][n]).abs().max())
                        for n in r0["after"])
        log(f"check DP step {label}: |loss - single| {loss_diff:.3e} "
            f"(loss {single['loss']:.6f}, limit {DP_LOSS_REL} relative); "
            f"largest relative gradient difference {grad_rel:.3e} (f32 "
            f"noise; held in float64 below); largest running-statistic "
            f"difference {stat_rel:.3e} of the tensor's max (limit "
            f"{DP_STAT_REL}); the "
            f"two ranks' largest parameter difference after Adam "
            f"{rank_diff:.3e} (must be 0)")
        check(loss_diff <= DP_LOSS_REL * abs(single["loss"]),
              f"the DP loss ({label}) differs from one process's")
        check(stat_rel < DP_STAT_REL,
              f"the DP BatchNorm statistics ({label}) differ")
        f64 = r0["f64"]
        rel64 = {k: max(float((f64[k][n] - t).abs().max() / t.abs().max())
                        for n, t in single64[k].items()
                        if k == "grads" or "running" in n)
                 for k in ("grads", "after")}
        moved = 0.0
        for n, g in single64["grads"].items():
            clear = g.abs() > 1e-3 * g.abs().max()
            moved = max(moved, float(((f64["after"][n] - single64["after"][n])
                                      .abs() / TRAIN_LR)[clear].max()))
        loss64 = abs(f64["loss"] - single64["loss"]) / abs(single64["loss"])
        log(f"check DP step {label} in float64 on the CPU, B="
            f"{DP_F64_BATCH}: loss "
            f"{loss64:.3e} relative, gradients {rel64['grads']:.3e}, running "
            f"statistics {rel64['after']:.3e} of each tensor's max (limits "
            f"{DP_F64_REL}); Adam's update where the gradient is clear "
            f"{moved:.3e} of lr (limit 1e-3)")
        check(max(loss64, rel64["grads"], rel64["after"]) < DP_F64_REL
              and moved < 1e-3,
              f"the float64 DP step ({label}) differs from one process's")
        check(rank_diff == 0.0, f"the ranks' parameters ({label}) differ")
        for r in results:
            inv = CollectiveInventory(r["inventory"])
            audit_dp_train_step(inv, n_params, n_bn)
            total = inv.total_elements("all-reduce")
            pinv = CollectiveInventory(r["predict_inventory"])
            audit_dp_inference(pinv, padded * NUM_LABELS)
        budget = n_params + 4 * n_bn + 4096
        log(f"audit DP step {label}: {inv.summary()}: {total} elements "
            f"all-reduced a step (JAX's audit of badwinner2 at production "
            f"geometry: {DP_JAX_ALL_REDUCED}); budget {n_params} params to "
            f"{budget} (params + 4 x {n_bn} BN + 4096); the Predictor: "
            f"{pinv.summary()} (the ({padded}, {NUM_LABELS}) probabilities)")
        for r in results:
            err = np.abs(r["probs"] - probs_1)
            ok = bool((err <= DP_PROB_ATOL + DP_PROB_RTOL
                       * np.abs(probs_1)).all())
            log(f"check sharded Predictor {label}: {r['probs'].shape} on "
                f"{r['device']}, max abs difference from unsharded "
                f"{err.max():.3e} (rtol {DP_PROB_RTOL}, atol {DP_PROB_ATOL}): "
                f"{ok}")
            check(r["probs"].shape == (DP_WINDOWS, NUM_LABELS) and ok,
                  f"the sharded Predictor ({label}) differs from unsharded")
        compare_runs([r["run"] for r in results], label)
        # the BatchNorm kernels under the mesh: two statistics finalizes
        # a BatchNorm (the local sums, then the all-reduced ones)
        bn_want = {k: 8 for k in results[0]["bn_counts"]}
        bn_want["statistics_finalize"] = 16
        log(f"check DP step {label}: BatchNorm kernel launches a rank "
            f"{[r['bn_counts'] for r in results]} (want {bn_want})")
        check(all(r["bn_counts"] == bn_want for r in results),
              f"a rank's BatchNorm kernels ({label}) are not the mesh's")
        # each BatchNorm alone: the ranks' rows under the mesh against one
        # process of the same kernels on the whole batch
        pass_want = dict.fromkeys(bn_want, 1)
        pass_want["statistics_finalize"] = 2
        for i, (spec, names) in enumerate(bn_groups(step_bns)):
            m, x, dy = bn_case(spec, DP_BN_BATCH, dev)
            want = bn_pass(m, x, dy)
            rs = [r["bn"][i] for r in results]
            errs = [bn_errors(
                {"y": torch.cat([q["y"] for q in rs]).to(dev),
                 "dx": torch.cat([q["dx"] for q in rs]).to(dev),
                 "grads": [sum(gs).to(dev) for gs in
                           zip(*(q["grads"] for q in rs))],
                 "stats": [t.to(dev) for t in r["stats"]]}, want)
                for r in rs]
            worst = {k: (None if errs[0][k] is None
                         else max(e[k] for e in errs)) for k in errs[0]}
            ok, text = bn_within(worst, spec["dtype"])
            log(f"check DP BatchNorm kernels {label}, {' / '.join(names)} "
                f"at B={DP_BN_BATCH} global ({spec['dtype']}, strides as "
                f"the step's): the ranks' rows against one process of the "
                f"same kernels: {text}; launches a rank "
                f"{[q['counts'] for q in rs]}")
            check(ok and all(q["counts"] == pass_want for q in rs),
                  f"the DP BatchNorm kernels ({label}) at "
                  f"{' / '.join(names)} differ from one process's")
        counts: dict[str, int] = {}
        for r in results:
            check(r["step_counts"]["fused_featurizer_mel_bf16"] == 1
                  and r["predict_counts"]["fused_featurizer_mel_centered"]
                  == chunks, f"a rank's K1 launches ({label}) are not the "
                  f"path's: {r['step_counts']} {r['predict_counts']}")
            for c in (r["step_counts"], r["predict_counts"],
                      r["run"]["counts"]):
                for k, v in c.items():
                    counts[k] = counts.get(k, 0) + v
        log(f"time DP step {label}: rank ms {[round(r['step_ms'], 3) for r in results]} "
            f"a step of B={DP_BATCH // DP_RANKS} a rank, the single process "
            f"{single_ms:.3f} ms at B={DP_BATCH}; both ranks share one card "
            f"here, so these times say nothing about scaling {card}"
            if label.startswith("gloo") else
            f"time DP step {label}: rank ms "
            f"{[round(r['step_ms'], 3) for r in results]} a step of "
            f"B={DP_BATCH // DP_RANKS} a rank on its own card, the single "
            f"process {single_ms:.3f} ms at B={DP_BATCH} {card}")
        return counts

    t0 = time.perf_counter()
    results = run_ranks(dp_rank, DP_RANKS, args=(
        str(REPO), [str(dev)] * DP_RANKS, str(weights_path),
        dp_sizes(corpus, run_root, step_bns)), backend="gloo",
        timeout_s=DP_TIMEOUT_S)
    log(f"phase 16: {DP_RANKS} ranks on {dev} over {results[0]['backend']} "
        f"in {time.perf_counter() - t0:.1f} s")
    counts = compare(results, f"gloo, {DP_RANKS} ranks on one card")
    if dev.type == "cuda" and torch.cuda.device_count() >= DP_RANKS:
        results = run_ranks(dp_rank, DP_RANKS, args=(
            str(REPO), [f"cuda:{i}" for i in range(DP_RANKS)],
            str(weights_path), dp_sizes(corpus, run_root, step_bns)),
            backend="nccl",
            timeout_s=DP_TIMEOUT_S)
        check(results[0]["backend"] == "nccl", "the cards' mesh is not NCCL")
        for k, v in compare(results, f"nccl, {DP_RANKS} cards").items():
            counts[k] += v
    else:
        log(f"phase 16: NCCL across cards not run: "
            f"{torch.cuda.device_count()} card(s) visible")
    log(f"phase 16 in {time.perf_counter() - t_phase:.1f} s")
    return counts


class KerasWeight:
    """Stand-in of a Keras variable: ``.numpy()`` and ``.name``."""

    def __init__(self, value, name: str = "w"):
        self.value, self.name = value, name

    def numpy(self):
        return self.value


class KerasModel:
    """Stand-in of a Keras functional model: its ``.layers``."""

    def __init__(self, layers: list):
        self.layers = layers


def keras_layer(kind: str, weights: list, **attrs):
    """A stand-in Keras layer of class name ``kind`` (the transplant reads a
    layer's kind from its class name) holding ``weights``."""
    layer = type(kind, (), {})()
    layer.weights = weights
    layer.__dict__.update(attrs)
    return layer


def keras_stand_in(module, scalar_mag: bool = False) -> KerasModel:
    """The Keras model whose weights are ``module``'s: one stand-in layer a
    transplant slot, in the module's creation (Keras call) order, each in
    Keras's layout: Conv2D kernels HWIO, DepthwiseConv2D (k, k, C, 1),
    Dense (in, out), BatchNormalization's gamma / beta / moving_mean /
    moving_variance, MagTransform's exponent (a scalar with ``scalar_mag``,
    as badwinner v1 stores it), PCEN's gain / bias / root / smooth."""
    from audio_training_tpu_torch.models.convert import flax_leaf_map
    from audio_training_tpu_torch.models.transplant import (
        flax_tree, module_slots)

    tree, leaf_map = flax_tree(module), flax_leaf_map(module)
    order = {path: i for i, path in enumerate(leaf_map)}

    def full(path):
        return path if path[0] == "batch_stats" else ("params", *path)

    def value(path):
        node = tree
        for k in full(path):
            node = node[k]
        return node

    def weight(slot, key):
        return KerasWeight(value(slot[key])) if key in slot else None

    layers = []  # (slot, layer)
    slots = module_slots(module)
    for slot in slots["conv"] + slots["dense"]:
        kernel, bias = value(slot["kernel"]), weight(slot, "bias")
        owner = leaf_map[full(slot["kernel"])][0].rsplit(".", 1)[0]
        kind = "Dense" if slot in slots["dense"] else "Conv2D"
        if getattr(module.get_submodule(owner), "groups", 1) > 1:
            kind, kernel = "DepthwiseConv2D", kernel.transpose(0, 1, 3, 2)
        layers.append((slot, keras_layer(kind, [KerasWeight(kernel), bias],
                                         use_bias=True, bias=bias)))
    for slot in slots["bn"]:
        w = {k: weight(slot, k) for k in ("scale", "bias", "mean", "var")}
        layers.append((slot, keras_layer(
            "BatchNormalization", [v for v in w.values() if v is not None],
            gamma=w["scale"], beta=w["bias"], moving_mean=w["mean"],
            moving_variance=w["var"])))
    for slot in slots["mag"]:
        a = value(slot["a"])
        layers.append((slot, keras_layer(
            "MagTransform", [KerasWeight(a.reshape(()) if scalar_mag else a)])))
    for slot in slots["pcen"]:
        layers.append((slot, keras_layer("PCEN", [
            KerasWeight(value(path), f"pcen/{name}:0")
            for name, path in slot.items()])))
    layers.sort(key=lambda sl: min(order[full(p)] for p in sl[0].values()))
    return KerasModel([layer for _, layer in layers])


class StandInPerch:
    """A numpy Perch stand-in (``infer/embeddings.PerchModel``'s contract):
    5 s windows at 32 kHz -> 1280-d embeddings, the log-compressed RMS of
    each of 1280 equal pieces of the window, and 10 "logits"."""

    name = "perch"
    sample_rate = 32000
    WINDOW_S = 5.0
    available = True

    def __init__(self):
        self.host_s = 0.0  # time spent embedding

    def embed(self, frames):
        import numpy as np

        t0 = time.perf_counter()
        window = int(self.WINDOW_S * self.sample_rate)
        n = len(frames) // window
        pieces = frames[: n * window].reshape(n, 1280, -1).astype(np.float64)
        emb = np.log1p(10.0 * np.sqrt((pieces**2).mean(-1))).astype(
            np.float32)
        self.host_s += time.perf_counter() - t0
        return emb, emb[:, :10]

    def embed_window(self, window):
        import numpy as np

        need = int(self.WINDOW_S * self.sample_rate)
        if len(window) < need:
            window = np.pad(window, (0, need - len(window)))
        return self.embed(window[:need])[0][0]


def tf_bridges_phase(dev, cfg, card) -> dict[str, int]:
    """Phase 17: the TensorFlow bridges with stand-in Keras models; see the
    module docstring.  Returns its K1 launches by kernel record."""
    import importlib.util
    import shutil

    import numpy as np
    import torch

    from audio_training_tpu_torch.cli import predict as cli_predict
    from audio_training_tpu_torch.cli import train as cli_train
    from audio_training_tpu_torch.config import InferenceConfig
    from audio_training_tpu_torch.corpus.audioio import save_wav
    from audio_training_tpu_torch.data.preprocess import make_preprocess_fn
    from audio_training_tpu_torch.infer.embeddings import (
        EmbeddingPredictor, PerchModel)
    from audio_training_tpu_torch.infer.fused import make_fused_infer_fn
    from audio_training_tpu_torch.models import build_model
    from audio_training_tpu_torch.models.transplant import (
        load_keras_backbone, transplant_backbone_into_classifier,
        transplant_keras_weights)
    from audio_training_tpu_torch.ops.cuda import fused_featurizer as ffz
    from audio_training_tpu_torch.ops.features import (
        build_mel_weights, normalize_rows)
    from audio_training_tpu_torch.ops.pcen import normalize_minmax_global, pcen
    from audio_training_tpu_torch.taxonomy import load_ontology
    from audio_training_tpu_torch.train import (
        create_train_state, fresh_metrics, make_train_step, save_metadata)
    from audio_training_tpu_torch.train.checkpoints import save_state_dict

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out_dir = REPO / "build" / "chip_smoke_tf"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)

    def clips(batch: int) -> torch.Tensor:
        return torch.randn(batch, cfg.samples_per_clip, generator=gen,
                           device=dev)

    def reset() -> None:
        torch.cuda.synchronize()
        ffz.reset_launch_counts()

    def counts() -> dict[str, int]:
        torch.cuda.synchronize()
        return {k: v for k, v in ffz.launch_counts().items() if v}

    def rel(got, want) -> float:
        got, want = got.float().cpu(), want.float().cpu()
        return ((got - want).abs().max() / want.abs().max()).item()

    def bitwise(got: dict, want: dict) -> bool:
        return got.keys() == want.keys() and all(
            torch.equal(got[k].cpu(), want[k].cpu()) for k in want)

    def seeded(name: str, seed: int, dtype=None, **kw):
        return build_model(name, NUM_LABELS, logits_only=True, dtype=dtype,
                           n_mels=cfg.n_mels, mel_frames=cfg.mel_frames,
                           generator=torch.Generator().manual_seed(seed),
                           **kw).module

    mel_np = build_mel_weights(cfg)
    mel_w = torch.as_tensor(mel_np, device=dev)
    fz = {t: ffz.FusedFeaturizer(mel_np, cfg.n_fft, cfg.hop_length,
                                 precision=t, device=dev)
          for t in ("highest", "default")}
    fz_cpu = ffz.FusedFeaturizer(mel_np, cfg.n_fft, cfg.hop_length,
                                 device="cpu")
    launches: dict[str, int] = {}

    # ---- (a) badwinner2 at 160 x 513 through K1's folded exact chain -----
    source = seeded("badwinner2", SEED + 170)
    with torch.no_grad():  # a frontend whose BatchNorm neither vanishes
        source.mag.a_power.fill_(-0.7)  # nor centres, as phase 8's
        g = 1.0 / (1.0 + np.exp(0.7))
        rows = (fz["highest"](normalize_rows(clips(CHECK_BATCH)), pcen=False)
                ** g).transpose(0, 1).reshape(cfg.n_mels, -1)
        source.mel_bn.running_mean.copy_(rows.mean(1).cpu())
        source.mel_bn.running_var.copy_(rows.var(1).cpu())
    keras = keras_stand_in(source)
    t0 = time.perf_counter()
    model = transplant_keras_weights(seeded("badwinner2", SEED + 171), keras)
    transplant_s = time.perf_counter() - t0
    kinds = {}
    for layer in keras.layers:
        kinds[type(layer).__name__] = kinds.get(type(layer).__name__, 0) + 1
    log(f"path transplant badwinner2 ({cfg.n_mels} x {cfg.mel_frames}, "
        f"{NUM_LABELS} labels) from a stand-in Keras model {kinds}: "
        f"{transplant_s:.3f} s")
    check(bitwise(model.state_dict(), source.state_dict()),
          "a transplanted badwinner2 tensor differs from its source")
    frontend_params = (model.mag.a_power.item(),
                       model.mel_bn.running_mean.numpy().copy(),
                       model.mel_bn.running_var.numpy().copy())
    trunk = {k: v for k, v in model.state_dict().items()
             if not k.startswith(("mag.", "mel_bn."))}

    def folded(dtype):
        m = seeded("badwinner2", 0, dtype, external_frontend=True)
        m.load_state_dict(trunk)
        return m.to(dev).eval()

    folded16 = folded(torch.bfloat16)

    @torch.no_grad()
    def chain(raw, m=folded16, out_dtype=torch.bfloat16):
        img = fz["highest"](raw, pcen=False, normalize_waveform=True,
                            frontend_params=frontend_params,
                            out_dtype=out_dtype)
        return m(img[..., None])

    requests = [clips(BATCH) for _ in range(REQUESTS)]
    reset()
    answers = [chain(r) for r in requests]
    got = counts()
    log(f"path transplanted badwinner2 folded chain: {REQUESTS} requests "
        f"of B={BATCH}, launches {got}")
    check(got == {"clip_minmax": REQUESTS,
                  "fused_featurizer_mel_folded": REQUESTS},
          "the transplanted chain did not launch one min-max and one folded "
          "mel kernel per request, and nothing else")
    check(all(tuple(a.shape) == (BATCH, NUM_LABELS)
              and bool(torch.isfinite(a).all()) for a in answers),
          "transplanted badwinner2 logits not finite")
    launches.update(got)
    del answers
    raw8 = clips(CHECK_BATCH)
    img_k = fz["highest"](raw8, pcen=False, normalize_waveform=True,
                          frontend_params=frontend_params)
    img_p = fz_cpu(raw8.cpu(), pcen=False, normalize_waveform=True,
                   frontend_params=frontend_params)
    mel_rel = rel(img_k, img_p)
    with torch.no_grad():
        logits_k = folded(None)(img_k[..., None])
        logits_p = model.eval()(fz_cpu(normalize_rows(raw8.cpu()),
                                       pcen=False)[..., None])
    logit_rel = rel(logits_k, logits_p)
    log(f"check transplanted badwinner2 B={CHECK_BATCH}: folded exact mel "
        f"vs its plain version on the CPU, global rel err {mel_rel:.3e} "
        f"(limit {MEL_REL_TOL}); f32 logits of the card's folded chain vs "
        f"the CPU's plain path of the same state, rel {logit_rel:.3e} "
        f"(limit {LOGIT_REL_TOL})")
    check(mel_rel < MEL_REL_TOL, "the folded mel disagrees with plain")
    check(logit_rel < LOGIT_REL_TOL,
          "the transplanted chain's logits disagree with the CPU's")
    chain_ms = time_ms(lambda: chain(requests[0]))
    log(f"time transplanted badwinner2 folded chain B={BATCH}: "
        f"{chain_ms:.3f} ms, "
        f"{BATCH * cfg.segment_length / (chain_ms / 1e3):.0f} audio-s/s "
        f"{card}")
    del folded16, requests, model, source
    torch.cuda.empty_cache()

    # ---- (b) EfficientNetV2-B3 trunk into the PCEN classifier ------------
    src = seeded("efficientnetv2b3", SEED + 172).backbone
    keras = keras_stand_in(src)
    train_model = seeded("efficientnetv2b3", SEED + 173, torch.bfloat16)
    kept = {k: v.clone() for k, v in train_model.state_dict().items()
            if not k.startswith("backbone.")}
    t0 = time.perf_counter()
    transplant_backbone_into_classifier(train_model, keras)
    transplant_s = time.perf_counter() - t0
    sd = train_model.state_dict()
    log(f"path transplant EfficientNetV2-B3 trunk ({len(keras.layers)} "
        f"stand-in layers) into BackboneClassifier(efficientnetv2b3) with "
        f"its PCEN frontend: {transplant_s:.3f} s")
    check(bitwise({k[len("backbone."):]: v for k, v in sd.items()
                   if k.startswith("backbone.")}, src.state_dict()),
          "a transplanted B3 backbone tensor differs from its source")
    check(bitwise({k: v for k, v in sd.items()
                   if not k.startswith("backbone.")}, kept),
          "the transplant changed the classifier's PCEN frontend or head")
    serve = seeded("efficientnetv2b3", 0, torch.bfloat16,
                   external_frontend=True)
    serve.load_state_dict({k: v for k, v in sd.items()
                           if not k.startswith("pcen.")})
    serve = serve.to(dev).eval()
    # one train step at B=32 (K1's "default" training tier)
    x, y = tone_band_batch(B3_TRAIN_BATCH, NUM_LABELS, cfg.samples_per_clip,
                           cfg.sr, SEED + 17)
    x2, y2 = tone_band_batch(B3_TRAIN_BATCH, NUM_LABELS,
                             cfg.samples_per_clip, cfg.sr, SEED + 18)
    pre = make_preprocess_fn(cfg, augment=True, channels=3, device=dev)
    state = create_train_state(train_model, learning_rate=TRAIN_LR,
                               device=dev)
    reset()
    mel, yy = pre(x, y, x2, y2, torch.Generator(device=dev).manual_seed(SEED))
    state, metrics = make_train_step()(
        state, fresh_metrics(dev), mel, yy,
        torch.Generator(device=dev).manual_seed(SEED + 1))
    got = counts()
    loss = float(metrics["loss_sum"]) / B3_TRAIN_BATCH
    log(f"path transplanted B3 train step B={B3_TRAIN_BATCH}: loss "
        f"{loss:.6f}, launches {got}")
    check(got == {"fused_featurizer_mel_bf16": 1} and np.isfinite(loss),
          "the B3 train step did not launch K1's default tier once, or its "
          "loss is not finite")
    launches["fused_featurizer_mel_bf16"] = got.get(
        "fused_featurizer_mel_bf16", 0)
    del state, mel, train_model
    torch.cuda.empty_cache()
    # the serving chain at B=512
    infer = make_fused_infer_fn(serve, cfg, use_pcen=True, channels=3,
                                precision="default", device=dev,
                                out_dtype=torch.bfloat16)
    raw = clips(BATCH_PCEN)
    reset()
    logits = infer(raw)
    got = counts()
    log(f"path transplanted PCEN -> EfficientNetV2-B3 chain B={BATCH_PCEN}: "
        f"launches {got}")
    check(got == {"fused_featurizer_mel_bf16": 1, "fused_featurizer_pcen": 1}
          and tuple(logits.shape) == (BATCH_PCEN, NUM_LABELS)
          and bool(torch.isfinite(logits).all()),
          "the transplanted B3 chain did not launch K1's default tier and "
          "PCEN once each, or its logits are not finite")
    launches["fused_featurizer_mel_bf16 at B=512"] = got.get(
        "fused_featurizer_mel_bf16", 0)
    launches["fused_featurizer_pcen at B=512"] = got.get(
        "fused_featurizer_pcen", 0)
    fzd = fz["default"]
    mel_k = fzd(raw, pcen=False)
    mel_p = ffz.fused_featurizer_plain(raw, mel_w, cfg.hop_length,
                                       precision="default")
    rms = (torch.linalg.norm(mel_k - mel_p) / torch.linalg.norm(mel_p)).item()
    mel_rel = rel(mel_k, mel_p)
    want = normalize_minmax_global(pcen(mel_k, *fzd.pcen_params, time_axis=2,
                                        normalize=False))
    pcen_err = (fzd(raw, pcen=True) - want).abs().max().item()
    log(f"check B={BATCH_PCEN} transplanted B3 chain's kernels: K1 default "
        f"tier vs plain relative RMS {rms:.3e} (limit {BF16_RMS_REL}), "
        f"global rel err {mel_rel:.3e} (limit {BF16_STEP:.3e}); PCEN on its "
        f"mel vs plain max abs err {pcen_err:.3e} (limit {PCEN_ABS_TOL})")
    check(rms < BF16_RMS_REL and mel_rel < BF16_STEP,
          "K1 default disagrees with plain on the B3 chain")
    check(pcen_err < PCEN_ABS_TOL, "PCEN disagrees with plain on the B3 chain")
    b3_ms = time_ms(lambda: infer(raw), iters=3, warmup=1)
    log(f"time transplanted B3 chain B={BATCH_PCEN}: {b3_ms:.3f} ms, "
        f"{BATCH_PCEN * cfg.segment_length / (b3_ms / 1e3):.0f} audio-s/s "
        f"{card}")
    del serve, infer, raw, mel_k, mel_p, want, logits
    torch.cuda.empty_cache()

    # ---- (c) embedding-model inference ----------------------------------
    recording = synthetic_recording(RECORDING_S, cfg.sr, SEED)
    head = build_model("embeddings", NUM_LABELS, logits_only=True,
                       generator=torch.Generator().manual_seed(SEED + 174)
                       ).module
    labels = [f"l{i}" for i in range(NUM_LABELS)]

    class Recorded(EmbeddingPredictor):
        """Keeps each batch of embeddings and its probabilities."""

        def _probs(self, embs):
            out = super()._probs(embs)
            self.seen.append((embs, out))
            return out

    runs = {}
    for device in ("cpu", dev):
        embedder = StandInPerch()
        pred = Recorded(embedder, copy.deepcopy(head), labels, cfg,
                        InferenceConfig(threshold=0.0), device=device)
        pred.seen = []
        t0 = time.perf_counter()
        tracks, _ = pred.predict_recording(recording, cfg.sr)
        torch.cuda.synchronize()
        runs[str(device)] = (pred, [t.get_meta() for t in tracks],
                             time.perf_counter() - t0, embedder.host_s)
    cpu_tracks = runs["cpu"][1]
    pred, tracks, wall, embed_s = runs[str(dev)]
    probs = np.concatenate([p for _, p in pred.seen])
    err = float(np.abs(probs - np.concatenate(
        [p for _, p in runs["cpu"][0].seen])).max())
    log(f"path EmbeddingPredictor (numpy Perch stand-in, LinearEmbeddings on "
        f"{dev}) over a {RECORDING_S:.0f} s recording: {len(tracks)} tracks, "
        f"{len(probs)} windows; probabilities vs the CPU run max abs err "
        f"{err:.3e} (limit 1e-5)")
    def same_track(got: dict, want: dict) -> bool:
        """Equal but for the detection's running id, labels equal and
        rounded percentages within 1."""
        def rest(meta):
            return {k: v for k, v in meta.items()
                    if k not in ("id", "predictions")}

        gp, wp = got["predictions"], want["predictions"]
        return (rest(got) == rest(want) and len(gp) == len(wp)
                and all(g["labels"] == w["labels"]
                        and len(g["confidences"]) == len(w["confidences"])
                        and all(abs(a - b) <= 1 for a, b in zip(
                            g["confidences"], w["confidences"]))
                        for g, w in zip(gp, wp)))

    check(len(tracks) == len(cpu_tracks) > 0
          and all(map(same_track, tracks, cpu_tracks)),
          "the card's embedding tracks differ from the CPU run's")
    check(err < 1e-5, "the card's embedding probabilities disagree")
    embs = np.concatenate([e for e, _ in pred.seen])
    head_ms = time_ms(lambda: pred._probs(embs))
    pred.seen.clear()
    log(f"time EmbeddingPredictor: {wall:.3f} s wall, "
        f"{RECORDING_S / wall:.1f} recording-s/s; the stand-in's embedding "
        f"{embed_s:.3f} s; the head on {len(embs)} embeddings {head_ms:.3f} "
        f"ms (host copy in and out included); host share "
        f"{1.0 - head_ms / 1e3 / wall:.4f} {card}")

    # ---- (d) without TensorFlow ------------------------------------------
    notop = out_dir / "notop.weights.h5"
    notop.write_bytes(b"")
    if importlib.util.find_spec("tensorflow") is None:
        failures = {}
        try:
            load_keras_backbone("mobilenet", notop,
                                (cfg.n_mels, cfg.mel_frames, 3))
        except RuntimeError as e:
            failures["load_keras_backbone"] = str(e)
        perch = PerchModel(out_dir)
        if not perch.available:
            failures["PerchModel"] = f"{perch.name} not available"
        run = out_dir / "embeddings-run"
        save_metadata(run, "embeddings", labels, cfg, load_ontology())
        save_state_dict(run / "val-loss.pt", head.state_dict())
        wav = out_dir / "rec.wav"
        save_wav(wav, recording[: 10 * cfg.sr], cfg.sr)
        try:
            cli_predict.main([str(run), "--file", str(wav),
                              "--embedding-model", str(out_dir)])
        except RuntimeError as e:
            failures["cli/predict --embedding-model"] = str(e)
        try:
            cli_train.main([
                "tf", "-d", str(REPO / "build" / "chip_smoke_corpus"),
                "--checkpoint-dir", str(out_dir / "runs"), "--model-name",
                "mobilenet", "--backbone-weights", str(notop), "--device",
                str(dev)])
        except RuntimeError as e:
            failures["cli/train --backbone-weights"] = str(e)
        for what, msg in failures.items():
            log(f"check without TensorFlow, {what} fails: {msg}")
        want_msgs = {
            "load_keras_backbone": "requires tensorflow",
            "PerchModel": "not available",
            "cli/predict --embedding-model": "needs --embedding-model",
            "cli/train --backbone-weights": "requires tensorflow"}
        check(all(w in failures.get(k, "") for k, w in want_msgs.items()),
              f"the no-TensorFlow failures are not JAX's: {failures}")
    else:
        import tensorflow as tf

        shape = (96, 96, 3)
        km = tf.keras.applications.MobileNetV2(
            weights=None, include_top=False, input_shape=shape)
        km.save_weights(str(out_dir / "mobilenet.weights.h5"))
        km, args = load_keras_backbone("mobilenet",
                                       out_dir / "mobilenet.weights.h5",
                                       shape)
        trunk = seeded("mobilenet", 0, backbone_args=args).backbone
        transplant_keras_weights(trunk, km)
        x = np.random.default_rng(SEED).normal(size=(2, *shape)).astype(
            np.float32)
        with torch.no_grad():
            got = trunk.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
        err = float(np.abs(got.permute(0, 2, 3, 1).numpy()
                           - km.predict(x, verbose=0)).max())
        log(f"check load_keras_backbone(mobilenet) with TensorFlow: trunk vs "
            f"Keras max abs err {err:.3e} (limit 1e-3)")
        check(err < 1e-3, "the transplanted trunk disagrees with Keras")
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"phase 17 {time.perf_counter() - t_phase:.1f} s")
    return launches


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
    from audio_training_tpu_torch.utils import profiling

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
    # the chain keeps this model: main rebinds ``model`` to the train
    # step's before phase 15 profiles the chain again
    serving_model = model

    @torch.no_grad()
    def chain(raw: torch.Tensor) -> torch.Tensor:
        img = fz(normalize_rows(raw), pcen=False, out_dtype=torch.bfloat16)
        return serving_model(img[..., None])

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
    profiling.reset_counts("conv_epilogue")
    pcen_logits = pcen_infer(pcen_raw)
    torch.cuda.synchronize()
    pcen_counts = ffz.launch_counts()
    epilogues = {"badwinner2": profiling.counts("conv_epilogue")}
    log(f"path make_fused_infer_fn(use_pcen=True): B={BATCH}, "
        f"launches {pcen_counts}, conv epilogues {epilogues['badwinner2']}")
    check(epilogues["badwinner2"]["rows"] + epilogues["badwinner2"]["mid"]
          == 7 and epilogues["badwinner2"]["plain"] == 0,
          "the eval badwinner2 forward did not run its 7 epilogues as the "
          "kernels")
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
    from audio_training_tpu_torch.models.layers import KerasBatchNorm
    from audio_training_tpu_torch.ops.cuda import batch_norm as bn_ops

    # the step's BatchNorm calls as they run, for phases 16 and 18
    step_bns = []
    hooks = [mod.register_forward_pre_hook(
                 lambda mod, args, name=name: step_bns.append(
                     bn_spec(name, mod, args[0])))
             for name, mod in state.model.named_modules()
             if isinstance(mod, KerasBatchNorm)]
    bn_ops.reset_launch_counts()
    train_iter()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    bn_counts = bn_ops.launch_counts()
    log(f"path train step: BatchNorm kernel launches {bn_counts} (want 8 "
        f"each: the 7 conv BatchNorms and mel_bn); the BatchNorms' inputs "
        + "; ".join(f"{b['name']} {b['shape']} {b['dtype']} strides "
                    f"{b['strides']}" for b in step_bns))
    check(bn_counts == dict.fromkeys(bn_ops.COUNTERS, 8),
          "not one launch of each BatchNorm kernel a BatchNorm in the step")

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

    averages, kernel_events, feat_events = profile_pcen_chain(
        lambda: mn_infer["default"](mn_requests[2]), dev)
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
    # ---- 18. train-mode BatchNorm at the training cell's shapes ----------
    kernels += batch_norm_phase(dev, card, step_bns)
    # ---- 10. training from a built corpus --------------------------------
    run_dir = corpus_train_phase(dev, cfg, card, step_ms, fit_s)
    # ---- 11. evaluation and deployment of the trained run ---------------
    evaluate_deploy_phase(dev, cfg, card, run_dir)
    # ---- 12. the model families -------------------------------------------
    # the B3 chain runs phase 7's two kernels at the same shape: one record
    # a shape, its launches those of both chains
    b3_counts, epilogues["B3"] = model_families_phase(dev, cfg, card,
                                                      mn_chain["default"])
    for k in kernels:
        if k["name"].endswith(" at B=512"):
            k["launches"] += b3_counts[k["name"].split(" at ")[0]]
            log(f"record {k['name']}: {k['launches']} launches, the "
                f"MobileNetV2 and EfficientNetV2-B3 chains' 3 requests each")
    # ---- 19. the eval conv epilogue, its launches those of phases 4, 12 --
    kernels += conv_epilogue_phase(dev, card, epilogues)
    # ---- 13. the rest of training -----------------------------------------
    kernels += rest_of_training_phase(dev, cfg, card, step_ms, train_peak_gb)
    # ---- 14. building a corpus ----------------------------------------------
    # its K1 launches join the records of the same kernels' other paths
    for name, n in build_corpus_phase(dev, cfg, card, step_ms).items():
        record = next(k for k in kernels if k["name"] == name)
        record["launches"] += n
        log(f"record {name}: {record['launches']} launches with phase 14's "
            f"{n}")
    # ---- 15. preparing a corpus -----------------------------------------------
    # cli/debug's exact tf launches join the chain's record
    n = corpus_tools_phase(dev, cfg, card, serving_model, chain, requests,
                           mel_ms, chain_ms)
    record = next(k for k in kernels if k["name"] == "fused_featurizer_mel")
    record["launches"] += n
    log(f"record fused_featurizer_mel: {record['launches']} launches with "
        f"phase 15's {n}")
    # ---- 16. data parallel --------------------------------------------------
    # the ranks' K1 launches join the training, exact and centered records
    dp_counts = data_parallel_phase(dev, cfg, card, step_bns)
    for name in ("fused_featurizer_mel_bf16", "fused_featurizer_mel",
                 "fused_featurizer_mel_centered"):
        record = next(k for k in kernels if k["name"] == name)
        record["launches"] += dp_counts[name]
        log(f"record {name}: {record['launches']} launches with phase 16's "
            f"{dp_counts[name]}")
    # ---- 17. the TensorFlow bridges ------------------------------------------
    # the transplanted chains' K1 launches join the same kernels' records
    for name, n in tf_bridges_phase(dev, cfg, card).items():
        record = next(k for k in kernels if k["name"] == name)
        record["launches"] += n
        log(f"record {name}: {record['launches']} launches with phase 17's "
            f"{n}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
