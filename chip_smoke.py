#!/usr/bin/env python3
"""On-card smoke test of dcs_net_tpu_torch, the PyTorch/CUDA port.

Run from the repository root with one CUDA card: ``python3 chip_smoke.py``.

Phases (each prints one or more lines; any failure exits non-zero):
  1. device  -- requires CUDA; prints the card's name and power limit as
               ``nvidia-smi --query-gpu=name,power.limit`` gives them;
  2. build   -- compiles the three kernel sources of dcs_net_tpu_torch/csrc
               with nvcc for sm_90a (one process per source, in parallel):
               stft.cu (kernel 1: an FFT inside the kernel for every even
               n_fft up to 2048 whose half is 7-smooth, and the dense DFT on
               the tensor cores for the rest), conv_same.cu
               (kernel 2: the small-Cout conv, the spatial-attention pooling
               pass and the conv with the gate's sigmoid-and-product epilogue,
               and the real attention's pooling pass and gate)
               and tapconv.cu (kernel 3: a 3xTF32 wgmma implicit GEMM and the
               kernel that packs its weights);
  3. slice   -- full-width DCS ``enhance_full`` on 4 requests of 4 s at 16 kHz
               (seeded weights, BN statistics moved off their init): checks
               shape, finiteness and each kernel's launch count in that call,
               times the call, and holds a 1 s request on the card against
               the same weights on the CPU (atol 3e-4, rtol 1e-3); then the
               call as one CUDA graph (``models/graphed.py``, as the enhance
               CLI runs it; lines "graphed: ..."): graphed against eager bit
               for bit under cuDNN's deterministic algorithms (the largest
               difference under its defaults printed), a replay's launches
               counted at the capture (1 STFT, 13 + 13 gates, 7 + 7 tap
               convs), the 1 s request graphed against the CPU, ms a call
               graphed and eager, capture seconds and pool bytes; busy time
               and idle share of a graphed and an eager call, each from a
               profiler window that lost no kernel records (a warm-up step
               first; two windows agree on the call's kernel count), the
               port's kernels in each held to the eager call's launch
               counts; and the keep-alive
               check: a 1 s request captured, 20 other lengths captured in
               the same cache (the window-envelope cache holds 16), the
               replay equal to the eager output bit for bit;
  4. stream  -- full-width DCS ``enhance_streaming``: (a) one 30 s request,
               256-frame chunks overlapping by 64 in groups of 8: shape,
               finiteness, launch counts (1 STFT; 13 gates and 7 tap convs a
               group), time per call, and a 3 s request card vs CPU; (b) the
               streaming preset with the LSTM carry, no overlap, 5 s: with
               chunk-local ops (1x1 convs, no attention) chunked == full pass
               on the card within 1e-4; with the product's ops finite, its
               correlation with the full pass printed, and 2 s card vs CPU;
               (a) and (b) also graphed as in phase 3 (a group of 8 chunks,
               or a carried chunk with its LSTM state, one replay);
  5. kernels -- each kernel against its plain PyTorch version on the card at
               every shape the slice launched it with (error relative to
               max |plain| <= 1e-4, TF32 off), with its device time per
               call (CUDA graph replay), the plain version's, one PyTorch
               library call's and the card's bound for the function; kernel
               2's conv entry at the gate's shapes of the full-utterance call
               and of a streaming chunk group (rows ``<kernel>_stream``),
               beside the body it replaced and an empty launch; kernel 3's
               forward beside the route it replaced (one-row tiles, no
               split, on a padded copy of x: ``earlier_ms``; a shape slower
               than it fails), and at one 4 s request at batch 1 (``enhance_full``
               as the enhance CLI calls it: its launches, row
               ``tapconv_valid_request``); the same for what the slice does
               not launch: kernel 1 off the paths, rows of their own
               (``stft_1b_*``, the FFT entry at sizes that took the dense DFT
               before; ``stft_1c_*``, the dense entry at the sizes left to
               it; each launching the entry ``choose_entry`` names once a
               call, with ``torch.stft``'s time); then, against the plain
               version only, kernel 1's FFT entry at its other sizes (every
               codelet, one to four stages, 8, 16 and 32 frames a block), at
               odd hops and without centering, and its dense entry at odd
               and large n_fft, hop above n_fft and every cluster split,
               kernel 2's three entries at odd and tiny shapes and
               other (K, Cin, Cout), kernel 3 at ragged shapes and at windows
               up to 12x12 (also reading x in place through a padding), and
               kernel 3's packed weights bit for bit against the PyTorch
               layout helper; kernel 3's forward under every (flat, wgs, S)
               at dec0-dec2 at batch 1 and at a chunk group (the sweep:
               each time beside the plan's pick, ``F.conv2d`` and the
               one-row route); the two input-gradient entries at
               ragged shapes (kernel 3's under every tiling that fits, its
               flipped packing bit for bit), timed beside the routes they
               replaced and ``conv2d_input``;
  6. cli     -- a 48 kHz wav through ``python -m dcs_net_tpu_torch.cli.enhance``
               (``main``), full and with ``--stream``, read back and checked;
  7. train   -- the full-width DCS train step (faithful quirks, batch 32 x
               8160 samples) on synthetic pairs written by
               ``data/synthetic.py``: (a) launch counts of one step (kernel 1
               once, kernels 2 and 3 forward and input gradient, 13 and 7
               each, the fused gate never); (b) at every shape of the step,
               the three Functions' outputs and input and weight gradients
               (``torch.autograd.grad``) against their plain versions under
               autograd (<= 1e-4 of max |plain|; the tap conv as the decoder
               calls it, x and its padding), the two input-gradient
               launches timed as kernel rows beside the routes they replaced
               (``earlier_ms``; a slower shape is printed) and the weight-gradient
               contractions printed beside ``torch.nn.grad``'s; (c) one step
               at batch 4, dropout off, card vs CPU from the same weights:
               loss and gradient norm rtol 1e-3, every gradient leaf in the
               band of the JAX oracle test, the post-Adam parameters within
               its sensitivity bound; (d) ``python -m
               dcs_net_tpu_torch.cli.train --steps-per-dispatch 3`` for 8
               batch-32 steps (an eager dispatch, a CUDA graph captured and
               replayed, 2 single steps), a checkpoint, then ``--resume``
               for 8 more (captured anew after the restore) on the numpy
               front end, the native library's path set to a missing file
               (it must print ``loader=python (native front end
               unavailable``), each run with SWA
               active (its last epoch averaged, the BN statistics refreshed
               over 8 batches), then ``python -m
               dcs_net_tpu_torch.cli.enhance --ckpt-dir`` on the checkpoint,
               held against ``enhance_full`` of its weights on the CPU
               (atol 3e-4, rtol 1e-3); (e) 10 steps on one batch, dropout on:
               the loss falls; (f) the median step time over 20 steps and
               audio-s/s per GPU;
     graph   -- ``--steps-per-dispatch`` K = 8: the train steps as one CUDA
               graph of 8 steps replayed a dispatch (``train/steps.py``), on
               phase 7's batch (rotated and rolled into 24): (a) DCS at batch
               32: capture seconds, the private pool, one replay's launches
               (8 times a step's, the counts reset before the capture and read
               after; the profiler's count of the port's kernels in a replay
               equal to them), the median step over 5 replays and audio-s/s
               beside phase 7 (f)'s eager median, a replay's device busy time
               and idle share; two eager runs' drift under cuDNN's default
               algorithms; with cuDNN's deterministic algorithms: (b) dropout
               on, an eager dispatch and a replay against 16 eager steps
               (losses rtol 1e-4, the state in the oracle band) and a replay
               with the generator reseeded that must differ by over 1e-3;
               (c) NaN waves at one inner step: skipped there only, Adam's
               count up by 7, the state as 7 eager steps'; (d) the plateau
               halving the lr tensor in place between replays: the next
               replay's update as eager steps' at that lr; (e) DRS: capture,
               the first replayed step's loss against eager from the same
               state (rtol 1e-5), its timing as in (a); (f) ``cli.train`` at
               the card's default K = 8, two epochs of 16 steps: 3 replays,
               its steady audio-s/s;
     loader  -- the native audio front end (``data/native_loader.py``,
               ``csrc/audioio.cc``) on 960 synthetic pairs of 3 s at 48 kHz:
               (a) the library built with g++ from the checkout (its output
               printed if it fails) and the host's CPU count; (b) two native
               batches of 32 x 8160 against the numpy path's (ids and starts
               equal, samples within 1e-5) and the windowed fill against the
               faithful one (bit for bit); (c) the loader alone
               (``tools/profile_loader.py``): batches/s of the numpy path, the
               faithful fill and the windowed one at 2 workers (the
               trainer's) over 16 batches, and each part's ms per item; (d)
               ``cli.train`` at K = 8 with the default prefetch, 1 epoch of
               24 steps on the native front end (it must print
               ``loader=native``): the steady audio-s/s beside phase "graph"
               (a)'s step rate, and the dispatch cycle of each front end
               reckoned from (c) (the rates at the CPU count, the numpy
               front end's trainer run, now phase 7 (d)'s resumed run, and
               a quarter of the pairs were cut to keep the smoke in its
               limit);
     eval    -- the evaluation path on what phase 7 left (its checkpoint,
               8 synthetic test pairs, its trainer's events): (a) ``python
               -m dcs_net_tpu_torch.cli.test --composite``: one CSV row per
               test utterance under the JAX header, finite STOI, PESQ and
               composite means; (b) one test utterance's eval-mode forward
               (batch 1): launch counts (kernel 1 once, the gate 13 + 13,
               kernel 3 7 + 7, the conv entry never alone), every launch
               against its plain version (rows ``<kernel>_eval``), the audio
               against the CPU's, and the forward graphed as in phase 3 (one
               graph a batch shape, as the trainer runs it); (c) STOI, PESQ and SI-SDR of every test
               utterance, card vs CPU, within ``EVAL_METRIC_TOL``; (d) the
               trainer's two epochs logged finite ``val_stoi`` and
               ``val_pesq_est``, its sanity passes none; (e) ``python -m
               dcs_net_tpu_torch.cli.tune``, one 1-epoch trial at batch 4 on
               40 pairs of its own, a finite best value; (f) the time per
               test utterance of the forward and of the host metrics;
  8. real    -- the real family at full width (DRS, seeded weights, BN moved
               off its init): (a) ``enhance_full`` on 4 requests of 4 s:
               launch counts (kernel 2's real gate, pool and gate 13 times
               each, its conv entry never; kernel 3 7 times, dec6 at N = 4),
               the median of 10 calls, a 1 s request and a streamed 3 s one
               card vs CPU, the call graphed as in phase 3, every launch
               against its plain version (the gate
               beside the eager sequence it replaces and the sequence the
               module ran before, on the generic conv body); (b) DR on a 1 s
               request card vs CPU; (c) one batch-32 train step, dropout on:
               launch counts (kernel 2's conv entry at (K, Cin, Cout) = (7,
               2, 1) and its input gradient at (7, 1, 2) 13 times each, all
               on the register-tiled body; kernel 3's at N = 4 among them;
               the real gate never), every Function against plain autograd
               and every launch against its plain version (the tiled bodies
               beside the generic one), the median of 20 steps and the device
               busy time of one under the profiler; (d) the step at batch 4
               card vs CPU as in 7 (c); (e) the real gate and the tiled
               bodies off the path: C no multiple of 4, x one float off its
               alignment, H = 1, W below a tile, odd H and W, every R, and
               the generic body at those shapes. Its kernel rows are named
               ``<kernel>_drs``;
  bf16    -- DCS at ``--dtype bfloat16`` (``compute_dtype = dft_dtype =
               "bfloat16"``: bf16 operands, float32 sums; the weights phase
               3's, float32): (a) ``enhance_full`` on 4 requests of 4 s:
               launch counts (kernel 1's dense bf16 class once, on its span
               body; kernel 2's fused bf16 gate 13 times and PR 15's pool
               and gate pair never; kernel 3's bf16
               class 7 times, dec0-dec5 on its staged body and dec6 on its
               tap body, and its packing 7 times; no launch of a float32
               class), a 1 s
               request card vs CPU (within half of the CPU's own bf16 to
               float32 distance on it, and 0.1), the call graphed against
               eager bit for bit (as phase 3: a replay's launches, ms both
               ways, busy time and idle share); (b) the 30 s stream (groups
               of 8) and (c) a carried 10 s stream (the streaming preset),
               each graphed against eager, the carried 2 s card vs CPU; (d)
               one test utterance's eval forward at batch 1 (launches,
               graphed against eager, card vs CPU); (e) every bf16 class
               against its plain version at every shape each path launched
               it with (error relative to max |plain| <= 2^-7 where the
               output is bf16, 1e-4 for kernel 1's float32 output), rows
               ``stft_dense_bf16``, ``sa_fused_bf16``,
               ``tapconv_valid_bf16``, ``tapconv_valid_bf16_tap`` (suffixes
               ``_stream``, ``_carry``, ``_eval``), each with one bf16
               PyTorch call's time (``torch.matmul`` of the bf16 frames by
               the basis, ``F.conv2d`` in bf16, the gate as one bf16 eager
               sequence), a bound at 989 TFLOP/s and
               the other body of its class at the same shape (``earlier_ms``:
               the chunked or tap body or the pool and gate pair each
               redesigned body replaced, reported where slower at a shape;
               ``staged_ms`` beside the tap body at dec6); PR 15's pair's
               own rows ``sa_pool_bf16``, ``sa_gate_bf16`` at the enhance
               call's sites (off the path: 0 launches); the fused gate's
               tiles at those sites (``kernel sa_fused_bf16 sweep:``); the
               bodies off the path (kernel 2's fused gate at odd shapes and
               forced tiles, the pair where the fused entry refuses a shape;
               kernel 1's span body at odd
               n_fft, hop not dividing n_fft or above it, T below a tile, its
               chunked body where hop is no multiple of 16; kernel 3's staged
               body at ragged pixel runs and channel counts, both bodies
               where both take a shape, its tap body at Cin no multiple of
               8 and other windows; the packings bit for bit), the span
               body's sweep of (frames, groups) and the staged body's of
               (flat, wgs, S) at dec0-dec2 (lines ``kernel stft_dense_bf16
               sweep:``, ``kernel tapconv_valid_bf16 sweep:``, which
               ``tools/fit_tapconv_plan.py --bf16`` reads); (f) ms a
               call of the float32 model beside the bf16 one, graphed and
               eager, enhance and stream; (g) ``cli.enhance --dtype
               bfloat16`` (full, ``--stream``, ``--carry``) and ``cli.test
               --dtype bfloat16`` on a float32 checkpoint; (h) DC
               (``config_for_variant("dc")``, its own seeded weights) at
               bf16: one enhance call's launches (DCS's), graphed against
               eager bit for bit, a 1 s request card vs CPU in the bf16
               band; (i)-(m) DRS at bf16 (its own seeded weights): (i) one
               enhance call's launches (the real pool's and gate's bf16
               classes 13 times each, kernel 3's staged body 6 times and
               its tap body at dec6's N = 4 once, 7 packings, kernel 1
               once, nothing of a float32 class), a 1 s request card vs CPU
               in the bf16 band, the call graphed against eager bit for
               bit, rows ``sa_pool_real_bf16_drs``,
               ``sa_gate_real_bf16_drs`` (beside the bf16 eager sequence)
               and ``tapconv_valid_bf16[_tap]_drs``, the real bf16 classes
               off the path (odd shapes, x off its line, every R); (j) a
               streamed 3 s and a carried 2 s request card vs CPU; (k) DR:
               a call's launches and a 1 s request card vs CPU; (l) ms a
               DRS call at bf16 beside float32's; (m) ``cli.enhance drs``
               and ``dr --dtype bfloat16`` (full, ``--stream``,
               ``--carry``) and ``cli.test drs --dtype bfloat16`` on two
               utterances;
  bf16train -- DCS training at ``--dtype bfloat16`` on phase 7's batch (32
               x 8160) and weights, run after phase "graph": (a) one eager
               step's launches (kernel 2's conv entry at bf16 13 times and
               its input gradient's bf16 class 13 times, kernel 3's bf16
               forward 7 times and its input gradient's bf16 class 7 times,
               each with its packing, kernel 1's bf16 class once, nothing of
               a float32 class); (b) the step at batch 4, dropout off, card
               vs CPU at bf16, the card under cuDNN's deterministic
               algorithms: loss and gradient norm within half of the CPU's
               own bf16-to-float32 distance, every leaf within
               ``SUM_ORDER_LIMIT`` of the largest distance of 7 sum-order
               witnesses (CPU bf16 steps on the batch permuted), the
               witnesses' own spread and the float32 control printed
               beside it; (c) the K = 8 graph against eager at
               bf16 under cuDNN's deterministic algorithms (16 steps' losses
               rtol 1e-4, the state in band); (d) ms a step, the eager
               median of 5 and the graphed median of 5 replays, a replay's
               busy time and kernels, beside float32's from phases "train"
               and "graph"; (e) the three new classes against their plain
               versions at every shape of the step (<= 2^-7), rows
               ``conv_same_small_cout_bf16``,
               ``conv_same_small_cout_dgrad_bf16``,
               ``tapconv_valid_dgrad_bf16`` (bf16 ``F.conv2d`` and
               ``conv2d_input`` as the library calls, bounds at 989
               TFLOP/s), and kernel 2's conv entry at its four bf16
               classes off the path (odd shapes, forced tiles, x off its
               pixel); (f) DC at bf16 and at float32, card vs CPU; (g)
               ``cli.train dcs --dtype bfloat16 --synthetic`` for an epoch
               of 16 steps at K = 8, its checkpoint served by ``cli.enhance``
               at float32 and at bf16 against the CPU; (h) DRS at bf16 on
               the same batch: one step's launches (the conv entry's bf16
               class at (7, 2, 1) and its input gradient's at (7, 1, 2) 13
               times each, kernel 3's bf16 forward and input gradient 7
               times each, dec6's on the tap body), ms a step eager and
               graphed beside DRS float32's (phase "graph" (e)), the K = 8
               graph against eager at bf16, rows ``*_bf16_drs``, the step
               at batch 4 card vs CPU: loss, gradient norm and leaves as
               (b), a leaf outside the sum-order rule held by its float64
               witness (DRS's bf16 leaves move with their input's last bit
               by tens of batch-order distances): its layer's input and
               output gradient against the float64 step, and the leaf
               against the float64 leaf of the card's own terms; (i) the
               trainer at --dtype bfloat16 on DRS's streaming preset for an
               epoch of 8 steps at K = 4, its checkpoint served by ``cli.enhance drs
               --carry`` against the CPU, ``cli.tune drs --dtype bfloat16``
               for a trial.
A line ``phase <name>: S s`` follows every phase.
The last lines are the kernels JSON, the nvidia-smi line and
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --stft-only`` runs phases 1 and 2 and then kernel 1
alone: its off-path checks, row 1 at the enhance shape and rows 1b and 1c,
with the same last lines (the kernels JSON holding those rows).
``python3 chip_smoke.py --bf16-only`` runs phases 1, 2, "bf16" and
"bf16train" (on phase 7's batch made anew, float32's step measured in the
phase), with the same last lines (the kernels JSON holding the bf16 rows).
``python3 chip_smoke.py --sum-order-seeds N`` runs phases 1 and 2 and then
reads phase "bf16train" (b)'s ratios for DCS and DC over N weight seeds,
each on its own 4 waves of phase 7's batch: the card's, a witness's against
the others and the float32 control's (what ``SUM_ORDER_LIMIT`` is set
from), with an empty kernels JSON.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
SR = 16000
BATCH, SECONDS = 4, 4
REL_TOL = 1e-4                    # kernel vs plain, relative to max |plain|
# a bf16 output against its plain version: both sum the same exact products
# in float32 and round once, so they differ by one bf16 unit at most
BF16_REL_TOL = 2.0 ** -7
SLICE_RTOL, SLICE_ATOL = 1e-3, 3e-4
TRAIN_BATCH, TRAIN_CROP, CARD_CPU_BATCH = 32, 8160, 4
TRAIN_STEPS, TRAIN_N_SYNTHETIC = 8, 480       # 480 pairs: 384 train, 96 val
GRAPH_K = 8                  # train steps a CUDA graph replay, the CLI's card default
CARRY_SECONDS = 5            # phase "stream" (b)'s carried stream
GRAPH_TRAIN_N = 640          # the K = 8 trainer run's pairs: 512 train, 16 steps an epoch
# phase "loader": a tree of pairs of one length, 3 s at 48 kHz (VoiceBank's
# training utterances last several seconds, of many lengths), 768 train (an
# epoch of 24 steps at batch 32: three dispatches of K = 8) and 192 val; one
# epoch a trainer run (two until phase "bf16" took the time; its steady
# rate is read after the capture, over the epoch's last replay)
LOADER_SECONDS, LOADER_N_SYNTHETIC, LOADER_EPOCHS = 3.0, 960, 1
LOADER_RATE_BATCHES = 8      # batches a loader-alone rate is timed over
NATIVE_TOL = 1e-5            # native batches against the numpy path's
# the device kernels of the port's entry points, as the profiler names them
PORT_KERNEL_SYMBOLS = ("stft_fft_kernel", "stft_fft_mixed_kernel", "stft_dense_kernel",
                       "stft_span_kernel", "conv_same_kernel", "conv7_kernel",
                       "sa_pool_kernel", "sa_gate_kernel", "sa_gate_real_kernel",
                       "sa_fused_bf16_kernel", "conv7_mma_kernel",
                       "tapconv_kernel", "tapconv_staged_kernel", "pack_kernel",
                       "pack_bf16_kernel", "dgrad_narrow_kernel")
# one train step's launches of each kernel, forward and input gradient (DCS and DRS)
TRAIN_STEP_LAUNCHES = {"stft": 1, "conv_same_small_cout": 13, "conv_same_small_cout_dgrad": 13,
                       "tapconv_valid": 7, "tapconv_pack": 7, "tapconv_valid_dgrad": 7,
                       "tapconv_pack_dgrad": 7, "sa_pool": 0, "sa_gate": 0,
                       "sa_pool_real": 0, "sa_gate_real": 0}
# the launches of one eval-mode DCS forward (the gate counts as the conv
# entry too), and of DRS's: a replay of a graph that holds one forward
DCS_EVAL_FORWARD = {"sa_pool": 13, "sa_gate": 13, "conv_same_small_cout": 13,
                    "tapconv_valid": 7, "tapconv_pack": 7}
DRS_EVAL_FORWARD = {"sa_pool_real": 13, "sa_gate_real": 13, "tapconv_valid": 7,
                    "tapconv_pack": 7}
# and of one DCS (or DC) forward at bf16: the bf16 classes only (kernel 2's
# fused gate at every site, kernel 3's staged body at dec0-dec5, its tap
# body at dec6's N = 8)
DCS_EVAL_FORWARD_BF16 = {"sa_fused_bf16": 13, "tapconv_valid_bf16": 6,
                         "tapconv_valid_bf16_tap": 1, "tapconv_pack_bf16": 7}
# the bf16 classes a bf16 forward launches, rows of the kernels line
BF16_ROWS = ("stft_dense_bf16", "sa_fused_bf16", "tapconv_valid_bf16",
             "tapconv_valid_bf16_tap")
# the bf16 paths' calls profiled: the graphed one only, and not the streams'.
# The bf16 LSTM recurrence runs ~10 kernels a step: ~12.8k kernels a 4 x 4 s
# call, more in a 30 s stream (graphed or eager), windows of the size in
# which torch.profiler loses records (no two of six windows of the graphed
# bf16 30 s stream agreed on its kernel count on the H100)
BF16_PROFILED = ("graphed",)
EVAL_N_TEST = 8                               # test pairs beside them
TUNE_BATCH, TUNE_N_SYNTHETIC = 4, 40          # 40 pairs: 32 train, 8 val
# card vs CPU on the same weights and utterance, metrics of the two audios.
# The audio is held to atol 3e-4 / rtol 1e-3 (phase "slice"), about 1e-3 of
# a 0.3 peak; STOI (a mean of band-envelope correlations) and SI-SDR (an
# energy ratio) follow the audio smoothly: within 1e-3 and 0.05 dB at that
# band (SI-SDR's noise energy moves by ~2 x 1e-3 / 0.3 relative at the
# narrowest ratio here, 4.34 dB per unit of it). PESQ's time alignment and
# frame-activity choices are discrete, so a change within the band may move
# it by a step: held to 0.1 MOS.
EVAL_METRIC_TOL = {"stoi": 1e-3, "si_sdr": 0.05, "pesq_est": 0.1}
# H100 SXM data sheet: HBM3 rate, float32 (non-tensor-core) peak, dense TF32
# tensor-core peak. Kernel 3 runs float32-accurate products as three TF32
# passes (3xTF32), so the rate its operations are held against is TF32 / 3.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
TF32X3_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
# the dense bf16 tensor-core peak, against which every bf16 class's least
# operations are held
BF16_FLOPS_PER_S = 989e12

# kernel name -> (source, the TPU kernel it replaces, design, the rate its
# least operations are held against)
KERNEL_INFO = {
    "stft": ("dcs_net_tpu_torch/csrc/stft.cu", "dcs_net_tpu/dsp/stft_pallas.py:120",
             "fft", F32_FLOPS_PER_S),
    "stft_dense": ("dcs_net_tpu_torch/csrc/stft.cu", "dcs_net_tpu/dsp/stft_pallas.py:120",
                   "3xtf32-wgmma-dense-dft", F32_FLOPS_PER_S),
    "conv_same_small_cout": ("dcs_net_tpu_torch/csrc/conv_same.cu",
                             "dcs_net_tpu/ops/pallas_conv.py:138",
                             "simt-f32-register-tiled", F32_FLOPS_PER_S),
    "sa_pool": ("dcs_net_tpu_torch/csrc/conv_same.cu",
                "dcs_net_tpu/ops/pallas_conv.py:138", "channel-mean-max",
                F32_FLOPS_PER_S),
    "sa_gate": ("dcs_net_tpu_torch/csrc/conv_same.cu",
                "dcs_net_tpu/ops/pallas_conv.py:138",
                "conv-sigmoid-product-epilogue", F32_FLOPS_PER_S),
    # the real attention's gate (DR / DRS): one plane pooled, the (7, 2, 1)
    # body with a sigmoid-and-broadcast-product epilogue
    "sa_pool_real": ("dcs_net_tpu_torch/csrc/conv_same.cu",
                     "dcs_net_tpu/ops/pallas_conv.py:138", "channel-mean-max",
                     F32_FLOPS_PER_S),
    "sa_gate_real": ("dcs_net_tpu_torch/csrc/conv_same.cu",
                     "dcs_net_tpu/ops/pallas_conv.py:138",
                     "conv-sigmoid-broadcast-product-epilogue", F32_FLOPS_PER_S),
    "tapconv_valid": ("dcs_net_tpu_torch/csrc/tapconv.cu",
                      "dcs_net_tpu/ops/pallas_tapconv.py:91",
                      "3xtf32-wgmma-in-place-flat-split", TF32X3_FLOPS_PER_S),
    # input gradients, which the JAX package's custom_vjp backward rules
    # compute in XLA: the conv entry on the flipped, transposed kernel
    # (class (7, 2, 4): the register-tiled body over float2 pixels), and the
    # tap conv's input-gradient entry (multi-row tiles, g read unpadded, dx
    # of the kept pixels only) with its flipped packing
    "conv_same_small_cout_dgrad": ("dcs_net_tpu_torch/csrc/conv_same.cu",
                                   "dcs_net_tpu/ops/pallas_conv.py:210",
                                   "simt-f32-register-tiled-input-gradient",
                                   F32_FLOPS_PER_S),
    "tapconv_valid_dgrad": ("dcs_net_tpu_torch/csrc/tapconv.cu",
                            "dcs_net_tpu/ops/conv_engine.py:879",
                            "3xtf32-wgmma-input-gradient-multirow",
                            TF32X3_FLOPS_PER_S),
}
# the real family's classes, rows of their own: kernel 2's conv entry at
# (K, Cin, Cout) = (7, 2, 1) and its input gradient's (7, 1, 2) run the
# register-tiled body over float2 / float pixels, two weights a tap; kernel
# 3's shapes are DCS's but for dec6's N = 4
KERNEL_INFO.update({
    "conv_same_small_cout_drs": KERNEL_INFO["conv_same_small_cout"][:2]
    + ("simt-f32-register-tiled-real", F32_FLOPS_PER_S),
    "conv_same_small_cout_dgrad_drs": KERNEL_INFO["conv_same_small_cout_dgrad"][:2]
    + ("simt-f32-register-tiled-real-input-gradient", F32_FLOPS_PER_S),
})
# the bf16 classes of the serving path (phase "bf16"), and the error each is
# held to against its plain version (kernel 1's output is float32)
KERNEL_INFO.update({
    "stft_dense_bf16": (KERNEL_INFO["stft_dense"][0], KERNEL_INFO["stft_dense"][1],
                        "bf16-wgmma-span-resident-basis-warp-specialized",
                        BF16_FLOPS_PER_S),
    "stft_dense_bf16_chunked": (KERNEL_INFO["stft_dense"][0], KERNEL_INFO["stft_dense"][1],
                                "bf16-wgmma-dense-dft-chunked", BF16_FLOPS_PER_S),
    "sa_pool_bf16": (KERNEL_INFO["sa_pool"][0], KERNEL_INFO["sa_pool"][1],
                     "channel-mean-max-bf16", BF16_FLOPS_PER_S),
    "sa_gate_bf16": (KERNEL_INFO["sa_gate"][0], KERNEL_INFO["sa_gate"][1],
                     "conv-sigmoid-product-epilogue-bf16", BF16_FLOPS_PER_S),
    "sa_fused_bf16": (KERNEL_INFO["sa_gate"][0], KERNEL_INFO["sa_gate"][1],
                      "bf16-tma-box-pool-mma-conv-sigmoid-product-one-launch",
                      BF16_FLOPS_PER_S),
    "tapconv_valid_bf16": (KERNEL_INFO["tapconv_valid"][0], KERNEL_INFO["tapconv_valid"][1],
                           "bf16-wgmma-staged-tma-ring-halo-descriptors", BF16_FLOPS_PER_S),
    "tapconv_valid_bf16_tap": (KERNEL_INFO["tapconv_valid"][0],
                               KERNEL_INFO["tapconv_valid"][1],
                               "bf16-wgmma-in-place-flat-split", BF16_FLOPS_PER_S),
    # the real attention's pool and gate at bf16 (DR / DRS): bf16 loads,
    # float32 sums, rounded where the JAX module rounds
    "sa_pool_real_bf16": (KERNEL_INFO["sa_pool_real"][0], KERNEL_INFO["sa_pool_real"][1],
                          "channel-mean-max-bf16", BF16_FLOPS_PER_S),
    "sa_gate_real_bf16": (KERNEL_INFO["sa_gate_real"][0], KERNEL_INFO["sa_gate_real"][1],
                          "conv-sigmoid-broadcast-product-epilogue-bf16", BF16_FLOPS_PER_S),
})
# the bf16 classes of the training path (phase "bf16train"): kernel 2's conv
# entry (the un-fused gate's conv) and its input gradient, both the
# tensor-core body (mma.sync m16n8k16 on a tile staged by cp.async, output
# shifts in N, the B table built from w once a block); kernel 3's input
# gradient: the staged body on g reading the forward's packing of w MN-major,
# the tap body on g with the flipped, transposed weights packed from w (off
# the path), and the narrow-reduction body (dec6: taps folded into the
# reduction, mma.sync, w read as it is)
KERNEL_INFO.update({
    "conv_same_small_cout_bf16": KERNEL_INFO["conv_same_small_cout"][:2]
    + ("bf16-mma-sync-cp-async-tile-shifts-in-n", BF16_FLOPS_PER_S),
    "conv_same_small_cout_dgrad_bf16": KERNEL_INFO["conv_same_small_cout_dgrad"][:2]
    + ("bf16-mma-sync-cp-async-tile-shifts-in-n-input-gradient", BF16_FLOPS_PER_S),
    "conv_same_small_cout_bf16_drs": KERNEL_INFO["conv_same_small_cout"][:2]
    + ("bf16-mma-sync-cp-async-tile-shifts-in-n-real", BF16_FLOPS_PER_S),
    "conv_same_small_cout_dgrad_bf16_drs": KERNEL_INFO["conv_same_small_cout_dgrad"][:2]
    + ("bf16-mma-sync-cp-async-tile-shifts-in-n-real-input-gradient", BF16_FLOPS_PER_S),
    "tapconv_valid_dgrad_bf16": KERNEL_INFO["tapconv_valid_dgrad"][:2]
    + ("bf16-wgmma-staged-body-on-g-forward-packing-mn-major", BF16_FLOPS_PER_S),
    "tapconv_valid_dgrad_bf16_tap": KERNEL_INFO["tapconv_valid_dgrad"][:2]
    + ("bf16-wgmma-tap-body-on-g-flipped-packing", BF16_FLOPS_PER_S),
    "tapconv_valid_dgrad_narrow_bf16": KERNEL_INFO["tapconv_valid_dgrad"][:2]
    + ("bf16-mma-sync-narrow-reduction-folded-taps-halo-ring", BF16_FLOPS_PER_S),
})
KERNEL_TOL = {"sa_pool_bf16": BF16_REL_TOL, "sa_gate_bf16": BF16_REL_TOL,
              "sa_fused_bf16": BF16_REL_TOL, "sa_pool_real_bf16": BF16_REL_TOL,
              "sa_gate_real_bf16": BF16_REL_TOL,
              "tapconv_valid_bf16": BF16_REL_TOL, "tapconv_valid_bf16_tap": BF16_REL_TOL,
              "conv_same_small_cout_bf16": BF16_REL_TOL,
              "conv_same_small_cout_dgrad_bf16": BF16_REL_TOL,
              "tapconv_valid_dgrad_bf16": BF16_REL_TOL,
              "tapconv_valid_dgrad_bf16_tap": BF16_REL_TOL,
              "tapconv_valid_dgrad_narrow_bf16": BF16_REL_TOL}
# one bf16 train step's launches (DCS and DC; DRS and DR the same, their
# conv entry at the real classes (7, 2, 1) and (7, 1, 2)): kernel 1's bf16
# class; kernel 2's conv entry at bf16 at the 13 un-fused gates, both
# directions; kernel 3's bf16 forward (the staged body at dec0-dec5,
# the tap body at dec6) with its packing, and its input gradient's bf16
# class: the staged body at dec0-dec5 on the forward's packing (no packing
# of its own), the narrow body at dec6 (a reduction of the forward's N = 8,
# or 4 for DR/DRS, to Cin 32); nothing of a float32 class
BF16_TRAIN_STEP_LAUNCHES = {"stft_dense_bf16": 1, "conv_same_small_cout_bf16": 13,
                            "conv_same_small_cout_dgrad_bf16": 13,
                            "tapconv_valid_bf16": 6, "tapconv_valid_bf16_tap": 1,
                            "tapconv_pack_bf16": 7, "tapconv_valid_dgrad_bf16": 6,
                            "tapconv_valid_dgrad_narrow_bf16": 1}
# CPU bf16 steps on the batch permuted, the measure of how far a bf16 step's
# gradient leaves move with the order of their sums (phase "bf16train" (b)),
# and the most a leaf's card-vs-CPU distance may be of their largest: 1.4x
# the largest reading of ``--sum-order-seeds 6`` on the H100 (a witness
# against the other 6 at most 2.83, the card 2.88, DCS and DC), where the
# float32 control read above it in 9 of 12 (PERF.md section 6)
SUM_ORDER_WITNESSES = 7
SUM_ORDER_LIMIT = 4.0
# DRS's bf16 gradient leaves leave that rule: on the CPU they move with the
# waves' last float32 bit by tens of batch-order distances, as far as the
# float32 step lies from them (``python -m
# dcs_net_tpu_torch.tools.leaf_spread``; PERF.md section 6), because bf16's
# rounding spreads through every layer and a batch order there reorders
# only the sums over the batch. A leaf outside the rule
# is held by its float64 witness (``float64_leaf_witness``), as phase "real"
# holds DRS's input BN: the inputs and output gradients of the modules that
# own such leaves within this many times the CPU bf16 step's own distance
# from the float64 step's together, each within twice that (the tests' bands
# for a bf16 step's whole gradient and each leaf,
# ``tests/test_torch_bf16_train.py``), and each leaf within its rounding
# bound of the float64 leaf of the card's own terms
FLOAT64_WITNESS = 2.0
# the rows phase "bf16train" adds to the kernels line
BF16_TRAIN_ROWS = ("conv_same_small_cout_bf16", "conv_same_small_cout_dgrad_bf16",
                   "tapconv_valid_dgrad_bf16", "tapconv_valid_dgrad_bf16_tap",
                   "tapconv_valid_dgrad_narrow_bf16")
# one DRS (or DR) forward at bf16: the bf16 classes only (kernel 2's real
# pool and gate at every site, kernel 3's staged body at dec0-dec5, its tap
# body at dec6's N = 4); the rows it adds, named <kernel>_drs
DRS_EVAL_FORWARD_BF16 = {"sa_pool_real_bf16": 13, "sa_gate_real_bf16": 13,
                         "tapconv_valid_bf16": 6, "tapconv_valid_bf16_tap": 1,
                         "tapconv_pack_bf16": 7}
DRS_BF16_ROWS = ("sa_pool_real_bf16", "sa_gate_real_bf16", "tapconv_valid_bf16",
                 "tapconv_valid_bf16_tap")
# kernel 1 off the paths, rows of their own in the kernels line, each
# (B, n, n_fft, hop), centred with the DC bin dropped as the model's: row 1b,
# the FFT entry at sizes that took the dense DFT before (the first is that
# row's old case), and row 1c, the dense entry at sizes left to it
STFT_ROWS = {"1b": [(2, 12000, 400, 100), (4, 64000, 400, 100), (4, 64000, 320, 160),
                    (4, 64000, 1024, 256), (4, 192000, 960, 480)],
             "1c": [(2, 12000, 352, 32), (4, 64000, 352, 32), (4, 192000, 4096, 1024)]}


def stft_row_name(row, B, n, n_fft, hop):
    return f"stft_{row}_{n_fft}_{hop}_{B}x{n}"


for _row, _cases in STFT_ROWS.items():
    for _case in _cases:
        KERNEL_INFO[stft_row_name(_row, *_case)] = KERNEL_INFO[
            "stft" if _row == "1b" else "stft_dense"][:2] + (
            "mixed-radix-fft" if _row == "1b" else "3xtf32-wgmma-dense-dft", F32_FLOPS_PER_S)

# what the slice does not launch, against the plain version only: kernel 1's
# FFT entry at its other sizes (every codelet as a first and a later stage,
# one to four stages, 8, 16 and 32 frames a block), at odd hops and without
# centering; its dense entry at odd n_fft, n_fft above 2048, hop above n_fft
# and cluster splits of 1, 2, 4 and 8 ((B, n, n_fft, hop, center, drop_dc));
# and kernel 3 at ragged shapes and at windows whose halo tiles need the
# 64-pixel tile (5x5 over a long row) or a single halo-tile stage (7x7,
# 12x12) to fit shared memory ((B, Hp, Wp, Cin), (Dh, Dw), N)
FFT_STFT_EXTRA = [(2, 3000, 64, 16, True, True), (3, 5000, 128, 32, False, False),
                  (2, 9000, 256, 64, True, True), (2, 4100, 128, 31, True, True),
                  (1, 2000, 64, 7, False, False), (2, 7000, 512, 33, True, True),
                  (1, 6000, 256, 1, False, True), (2, 9000, 512, 512, True, False),
                  (1, 3000, 16, 5, True, True), (1, 3000, 28, 3, False, True),
                  (2, 3000, 36, 9, True, True), (1, 3000, 40, 11, True, False),
                  (1, 3000, 42, 7, False, True), (1, 5000, 98, 49, True, True),
                  (1, 5000, 162, 41, False, True), (1, 5000, 392, 97, True, True),
                  (1, 5000, 450, 151, True, True), (2, 9000, 320, 161, True, True),
                  (1, 7000, 400, 99, False, True), (2, 9000, 480, 97, True, False),
                  (1, 12000, 640, 160, False, False), (2, 20000, 960, 481, True, True),
                  (1, 20000, 1024, 255, False, True), (1, 30000, 2048, 511, True, True),
                  (1, 30000, 1250, 313, True, False), (1, 30000, 1750, 1750, False, True),
                  (16, 160000, 400, 100, True, True), (32, 64000, 1024, 256, True, True)]
DENSE_STFT_EXTRA = [(1, 4000, 352, 32, True, True), (1, 3000, 1100, 275, True, True),
                    (1, 2000, 401, 100, False, True), (2, 5000, 22, 5, True, False),
                    (1, 20000, 4096, 1024, False, True), (1, 3000, 512, 1024, True, True),
                    (3, 7000, 2050, 300, True, True)]
# kernel 2 where the slice does not take it. The tiled (7, 4, 2) body and the
# gate: odd H and W, W below one thread's run, batch 1 and 32, C = 1 and C no
# multiple of 4 ((B, H, W, C)); the generic body: K = 3 and 5, Cout = 8,
# other Cin ((B, H, W, Cin), K, Cout)
GATE_EXTRA = [(1, 5, 3, 1), (2, 7, 9, 6), (3, 17, 129, 12), (32, 4, 8, 16),
              (1, 3, 70, 20), (1, 1, 1, 4), (2, 33, 300, 8)]
CONV_EXTRA = [((2, 9, 40, 4), 3, 2), ((2, 16, 33, 4), 5, 8), ((1, 7, 5, 3), 7, 2),
              ((3, 20, 50, 6), 7, 16), ((32, 6, 10, 4), 7, 3)]
# the real gate and the tiled bodies at the real classes off the path: C = 1
# and C no multiple of 4, H = 1, W below a tile, odd H and W, batch 32
# ((B, H, W, C)); every R of the tiled body, forced ((R, TX, TY))
REAL_GATE_EXTRA = [(1, 5, 3, 1), (2, 7, 9, 6), (3, 17, 129, 12), (32, 4, 8, 16),
                   (1, 1, 70, 20), (1, 1, 1, 4), (2, 33, 301, 8), (1, 3, 2, 256)]
REAL_TILES = [(2, 4, 1), (4, 8, 16), (8, 4, 4), (8, 16, 8)]
# the input gradients off the path. Kernel 3's entry: H = 1, W = 1, 33, 65
# and 130, B = 1, Cin' (the forward's N) 5, 8, 12 and 33, N' (its Cin) 5, 32
# and 130, windows 2x2, 5x5 and 12x12, padding uneven
# ((B, H, W), N, Cin, (Dh, Dw), (top, bottom, left, right)); kernel 2's
# (7, 2, 4) body: odd H and W, W below a run ((B, H, W))
DGRAD_EXTRA = [((2, 1, 65), 8, 32, (3, 3), (1, 1, 1, 1)),
               ((3, 6, 1), 12, 5, (3, 3), (1, 1, 1, 1)),
               ((1, 5, 33), 33, 130, (3, 3), (1, 1, 1, 1)),
               ((2, 3, 130), 5, 32, (3, 3), (1, 1, 1, 1)),
               ((1, 7, 40), 8, 5, (2, 2), (0, 1, 1, 0)),
               ((2, 9, 65), 12, 130, (5, 5), (2, 2, 0, 4)),
               ((1, 14, 33), 33, 32, (12, 12), (5, 6, 6, 5)),
               ((32, 2, 32), 64, 128, (3, 3), (1, 1, 1, 1))]
# kernel 3's forward at the shapes where the plan splits the reduction:
# dec0-dec2 at batch 1 and at a streaming chunk group ((B, H, W, Cin, N))
FORWARD_SWEEP = [(1, 2, 32, 512, 512), (1, 4, 32, 512, 512), (1, 8, 32, 512, 256),
                 (8, 2, 32, 512, 512), (8, 4, 32, 512, 512), (8, 8, 32, 512, 256)]
CONV_DGRAD_EXTRA = [(1, 5, 3), (2, 7, 9), (3, 17, 129), (32, 4, 8), (1, 1, 1),
                    (2, 33, 300), (1, 3, 70)]
TAPCONV_EXTRA = [((2, 10, 9, 64), (3, 3), 32), ((2, 5, 7, 24), (2, 2), 12),
                 ((2, 5, 140, 7), (3, 3), 5), ((1, 4, 300, 36), (1, 1), 130),
                 ((2, 40, 150, 40), (5, 5), 128), ((1, 9, 100, 72), (7, 7), 100),
                 ((1, 12, 80, 68), (7, 7), 24), ((1, 14, 90, 36), (12, 12), 70),
                 ((2, 12, 200, 16), (5, 3), 6)]


# the bf16 classes off the path ((B, n, n_fft, hop, center, drop_dc)): kernel
# 1's span body at odd n_fft, hop not dividing n_fft or above it, T below a
# tile and a tile's edge, another hop; its chunked body where hop is no
# multiple of 16 or the basis does not fit shared memory. Kernel 3's
# ((B, H, W, Cin), N, (Dh, Dw), pad): the staged body at ragged pixel runs
# (flat and one-row tiles), channel counts that fill no chunk or N tile,
# uneven padding; the tap body at Cin no multiple of 8, N <= 8 and another
# window
DENSE_BF16_EXTRA = [(1, 3000, 352, 32, True, True), (2, 5000, 320, 160, True, False),
                    (1, 3000, 200, 48, False, True), (2, 700, 512, 32, True, True),
                    (1, 8160, 512, 32, False, True), (2, 3000, 96, 112, False, True),
                    (2, 2600, 81, 16, True, True), (1, 4000, 400, 100, True, True),
                    (1, 9000, 1024, 256, True, True), (1, 3000, 401, 100, False, True)]
# kernel 2's bf16 gate off the path ((B, H, W, C), tile): the fused entry
# at its plan (None) at one pixel, H and W under a tile, C no power of two,
# C = 256, W no multiple of the tile, batch 32, and at forced tiles (a tile
# row, tiles taller than the image, 64 columns); the pair where the fused
# entry refuses (None again): C % 8 != 0, C above 256, a spanning tile past
# shared memory, x off its alignment ("unaligned")
GATE_BF16_EXTRA = [((1, 1, 1, 8), None), ((2, 5, 3, 16), None), ((3, 17, 129, 24), None),
                   ((1, 3, 70, 256), None), ((2, 33, 300, 8), None), ((32, 4, 8, 16), None),
                   ((1, 7, 9, 40), None), ((2, 9, 260, 128), None),
                   ((2, 20, 40, 8), (1, 8)), ((1, 20, 90, 32), (32, 64)),
                   ((2, 4, 33, 128), (4, 24)), ((1, 64, 200, 16), (16, 64)),
                   ((2, 5, 7, 12), None), ((1, 3, 9, 264), None), ((1, 16, 20, 256), None),
                   ((2, 5, 7, 8), "unaligned")]
TAPCONV_BF16_EXTRA = [((2, 5, 7, 24), 12, (3, 3), (1, 1, 1, 1)),
                      ((1, 5, 9, 40), 70, (3, 3), (0, 2, 1, 1)),
                      ((1, 2, 130, 16), 12, (3, 3), (1, 1, 1, 1)),
                      ((1, 4, 300, 64), 130, (3, 3), (1, 1, 2, 0)),
                      ((3, 9, 33, 48), 64, (3, 3), (1, 1, 1, 1)),
                      ((2, 3, 40, 36), 130, (3, 3), (1, 1, 1, 1)),
                      ((2, 9, 33, 48), 8, (3, 3), (1, 1, 1, 1)),
                      ((2, 12, 60, 40), 64, (5, 5), (2, 2, 2, 2))]

# kernel 3's bf16 input gradient off the path ((B, H, W, Cin), N, pad): the
# narrow body at ragged tiles (H, W no multiple of 4 and 64), N = 1, 3, 4,
# 5 and 8 (a pixel copied whole at 4 and 8 only), Cin 8, 20 and 32, uneven
# padding; the staged body on the forward's packing where a box of Cin
# chunks runs past the tile (Cin 40 and 72), N over two N tiles (136), and
# on the forward tap body's 32-channel packing (Cin 36); the tap body at N
# <= 8 above Cin 32
DGRAD_BF16_EXTRA = [((2, 5, 70, 32), 4, (1, 1, 1, 1)), ((2, 5, 70, 32), 8, (0, 2, 2, 1)),
                    ((1, 9, 130, 20), 3, (2, 0, 1, 1)), ((3, 4, 16, 8), 5, (1, 1, 0, 2)),
                    ((2, 7, 33, 32), 1, (1, 1, 1, 1)), ((2, 5, 40, 72), 24, (1, 1, 1, 1)),
                    ((2, 6, 20, 40), 136, (1, 0, 1, 1)), ((2, 5, 12, 36), 16, (1, 1, 1, 1)),
                    ((2, 5, 40, 48), 8, (1, 1, 1, 1))]

# kernel 2's bf16 conv entry (the tensor-core body) off the path, at its
# four classes ((B, H, W)): one pixel, one row, one column, W = 33 (an odd
# pixel pair at Cin 1), H = 7, images narrower and shorter than a tile, W
# past several product spans, batch 32; and forced tiles a class ((TH, TW,
# RB): several row and column tasks a block, rows no multiple of RB, every
# RB the class takes)
CONV_BF16_EXTRA = [(1, 1, 1), (2, 1, 40), (1, 9, 1), (2, 7, 33), (1, 5, 3), (3, 3, 70),
                   (2, 33, 300), (32, 4, 8), (1, 130, 129)]
CONV_BF16_TILES = {(4, 2): [(3, 64, 2), (16, 32, 8), (8, 64, 4)],
                   (2, 4): [(5, 64, 4), (8, 96, 2), (16, 32, 8)],
                   (2, 1): [(6, 32, 4), (16, 64, 8), (3, 96, 4)],
                   (1, 2): [(3, 128, 2), (9, 64, 8), (16, 64, 4)]}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def rel_err(got, want) -> float:
    """max |got - want| / max |want| over one tensor or a tuple of them."""
    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    return (max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
            / max(max(float(b.float().abs().max()) for b in want), 1e-30))


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def speech_like(n_req: int, n: int, seed: int) -> np.ndarray:
    """Voiced harmonic tones with a syllable-rate envelope, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    out = np.zeros((n_req, n))
    for b in range(n_req):
        f0 = rng.uniform(100.0, 250.0) * (1 + 0.05 * np.sin(2 * np.pi * 0.7 * t))
        phase = 2 * np.pi * np.cumsum(f0) / SR
        voiced = sum(rng.uniform(0.2, 1.0) / k * np.sin(k * phase) for k in range(1, 9))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * t) ** 2
        out[b] = 0.3 * voiced * env / np.abs(voiced).max()
    out += 0.05 * rng.standard_normal(out.shape)
    return out.astype(np.float32)


def perturb_bn(model, seed: int) -> None:
    """Move every BN's affine parameters and running statistics off their
    init values so BN is not the identity (variances and covariances stay
    positive): the complex BN's gammas, betas, means and covariances, the
    real BN's scale, bias, mean and variance."""
    import torch

    from dcs_net_tpu_torch.ops.complex_layers import ComplexBatchNorm2d
    from dcs_net_tpu_torch.ops.real_layers import BatchNorm2d

    shifted = {ComplexBatchNorm2d: ("gamma_rr", "gamma_ii", "gamma_ri", "beta_r",
                                    "beta_i", "mean_r", "mean_i", "vri"),
               BatchNorm2d: ("scale", "bias", "mean")}
    scaled = {ComplexBatchNorm2d: ("vrr", "vii"), BatchNorm2d: ("var",)}
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            kind = type(mod)
            for name in shifted.get(kind, ()):
                t = getattr(mod, name)
                t.add_((torch.rand(t.shape, generator=g) * 0.2 - 0.1).to(t.device))
            for name in scaled.get(kind, ()):
                t = getattr(mod, name)
                t.mul_((torch.rand(t.shape, generator=g) * 0.8 + 0.8).to(t.device))


class ShapeLog:
    """Stands in for a CudaKernel during the shape-discovery pass: notes the
    integer arguments of every launch, then launches."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.calls = []

    def __call__(self, device, *args):
        self.calls.append(tuple(a for a in args if isinstance(a, int)))
        return self.kernel(device, *args)


def discover_shapes(run):
    """Run ``run()`` with every kernel wrapped in a ShapeLog; return
    {kernel name: [int-args per launch]}, kernel 1's launches as STFT cases
    (:func:`stft_launch_case`)."""
    from dcs_net_tpu_torch.dsp import stft_cuda
    from dcs_net_tpu_torch.ops import cuda_conv, cuda_tapconv

    slots = [(stft_cuda, "KERNEL"), (cuda_conv, "KERNEL"), (cuda_conv, "POOL"),
             (cuda_conv, "GATE"), (cuda_tapconv, "KERNEL"), (cuda_conv, "DGRAD"),
             (cuda_tapconv, "DGRAD"), (cuda_conv, "POOL_REAL"),
             (cuda_conv, "GATE_REAL"), (stft_cuda, "KERNEL_DENSE_BF16"),
             (stft_cuda, "KERNEL_DENSE_BF16_CHUNKED"), (cuda_conv, "POOL_BF16"),
             (cuda_conv, "GATE_BF16"), (cuda_conv, "FUSED_BF16"),
             (cuda_tapconv, "KERNEL_BF16"), (cuda_tapconv, "KERNEL_BF16_TAP"),
             (cuda_conv, "KERNEL_BF16"), (cuda_conv, "DGRAD_BF16"),
             (cuda_tapconv, "DGRAD_BF16"), (cuda_tapconv, "DGRAD_BF16_TAP"),
             (cuda_tapconv, "DGRAD_NARROW_BF16"),
             (cuda_conv, "POOL_REAL_BF16"), (cuda_conv, "GATE_REAL_BF16")]
    logs = [ShapeLog(getattr(mod, attr)) for mod, attr in slots]
    try:
        for (mod, attr), log in zip(slots, logs):
            setattr(mod, attr, log)
        run()
    finally:
        for (mod, attr), log in zip(slots, logs):
            setattr(mod, attr, log.kernel)
    shapes = {log.kernel.name: log.calls for log in logs}
    shapes["stft"] = [stft_launch_case(a) for a in shapes["stft"]]
    for name in ("stft_dense_bf16", "stft_dense_bf16_chunked"):
        shapes[name] = [dense_launch_case(a) for a in shapes[name]]
    return shapes


def stft_launch_case(args):
    """(B, n, n_fft, hop, center, drop_dc) of one recorded launch of kernel
    1's FFT entry, whose integer arguments are (B, n, n_fft, hop, first_bin,
    F, T, pad, r1, r2, r3, r4, ft)."""
    B, n, n_fft, hop, first_bin, _, _, pad = args[:8]
    return (B, n, n_fft, hop, pad > 0, first_bin == 1)


def dense_launch_case(args):
    """(B, n, n_fft, hop, center, drop_dc) of one recorded launch of kernel
    1's dense entries, whose integer arguments are (B, n, n_fft, hop, F, T,
    pad, ...) (then the split, or the span body's frames and groups); the
    DC bin is dropped where F is n_fft / 2."""
    B, n, n_fft, hop, F, _, pad = args[:7]
    return (B, n, n_fft, hop, pad > 0, F == n_fft // 2)


def kernel_cases(name, args, dev, cfg):
    """For one recorded launch: (kernel fn, plain fn, library fn or None,
    bytes, flops, design flops, extras), all on fresh seeded tensors of the
    recorded shapes. bytes and flops are the least the function needs; design
    flops, where not None, are what the kernel's own algorithm does; extras
    are further functions to time beside the kernel, by column name."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from dcs_net_tpu_torch.dsp import stft as dsp
    from dcs_net_tpu_torch.dsp import stft_cuda
    from dcs_net_tpu_torch.ops import cuda_conv, cuda_tapconv
    from dcs_net_tpu_torch.utils.cuda_lib import ptr

    g = torch.Generator(device=dev).manual_seed(SEED + 7)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    if name.startswith("stft") and not name.startswith("stft_dense_bf16"):
        # one case of kernel 1: its own STFT configuration
        B, n, n_fft, hop, center, drop_dc = args
        scfg = dataclasses.replace(cfg.stft, n_fft=n_fft, hop=hop, win_length=n_fft,
                                   center=center, drop_dc=drop_dc)
        dense = stft_cuda.choose_entry(n_fft, hop) == "dense"
        if dense != name.startswith(("stft_dense", "stft_1c")):
            fail(f"{name}: n_fft {n_fft}, hop {hop} names the "
                 f"{'dense' if dense else 'fft'} entry point")
        plan = dsp._analysis_plan(scfg, dev)
        cos_b, sin_b = dsp._on_device(dsp._dft_basis_eff, scfg, dev)
        x = randn(B, n, scale=0.3)
        win = torch.from_numpy(dsp.window_np(scfg).astype(np.float32)).to(dev)
        T, n_bins = scfg.num_frames(n), scfg.n_bins
        print(f"kernel {name} args={args}: {stft_launch_text(n_fft, hop, B, T, n_bins)}",
              flush=True)
        # least traffic: the signal, the window and the output (twiddle
        # tables and the dense entry's basis are the kernels' own choice)
        nbytes = 4 * (B * n + n_fft + 2 * B * n_bins * T)
        # least work: a real-input FFT per frame, 2.5 n log2 n flops; the
        # dense entry point does 2 dots of n_fft per bin and frame
        flops = int(B * T * 2.5 * n_fft * math.log2(n_fft))
        dft_flops = 2 * 2 * B * T * n_bins * n_fft if dense else None

        def kern():
            before = stft_cuda.KERNEL.launches, stft_cuda.KERNEL_DENSE.launches
            out = stft_cuda.stft_analysis(x, plan)
            got = (stft_cuda.KERNEL.launches - before[0],
                   stft_cuda.KERNEL_DENSE.launches - before[1])
            if got != ((0, 1) if dense else (1, 0)):
                fail(f"{name} at {args}: one call launched the FFT and the dense "
                     f"entry {got} times, expected once the "
                     f"{'dense' if dense else 'FFT'} entry")
            return out

        return (kern,
                lambda: stft_cuda.stft_dft_plain(x, cos_b, sin_b, hop, plan.pad),
                lambda: torch.stft(x, n_fft, hop, n_fft, win, center=center,
                                   pad_mode="reflect", normalized=True,
                                   return_complex=True),
                nbytes, flops, dft_flops, {})
    b16 = torch.bfloat16
    if name == "stft_dense_bf16":
        # kernel 1's bf16 class, its span body: the frames and the folded
        # basis rounded to bf16, float32 sums; the library call, the bf16
        # frames times the bf16 basis in one torch.matmul (the frames made
        # beforehand), which writes (B, T, 2F) where the kernel writes (B,
        # F, T) twice over; earlier_ms, the chunked body it replaced at this
        # shape
        B, n, n_fft, hop, center, drop_dc = args
        scfg = dataclasses.replace(cfg.stft, n_fft=n_fft, hop=hop, win_length=n_fft,
                                   center=center, drop_dc=drop_dc, dft_dtype="bfloat16")
        if stft_cuda.choose_entry(n_fft, hop, "bfloat16") != "dense_bf16":
            fail(f"{name}: n_fft {n_fft}, hop {hop} does not name the span body")
        plan = dsp._analysis_plan(scfg, dev)
        cos_b, sin_b = dsp._bf16_bases(dsp._dft_basis_eff, scfg, dev)
        x = randn(B, n, scale=0.3)
        T, n_bins = scfg.num_frames(n), scfg.n_bins
        xp = F.pad(x[:, None], (plan.pad, plan.pad), mode="reflect")[:, 0] if plan.pad else x
        frames = xp.unfold(-1, n_fft, hop).to(b16).contiguous()
        basis = torch.cat([cos_b, sin_b], dim=1).to(b16)
        chunked = plan._replace(dense=stft_cuda.dense_basis_bf16(
            *dsp._dft_basis_eff(scfg, np.float32)).to(dev))
        tiles = stft_cuda.span_plan(n_fft, hop, n_bins, B, T, cuda_tapconv._sm_count(dev))
        print(f"kernel {name} args={args}: span body, (frames, groups) {tiles}, "
              f"{stft_cuda.span_smem_bytes(n_fft, hop, tiles[0])} B", flush=True)
        kernels = (stft_cuda.KERNEL, stft_cuda.KERNEL_DENSE, stft_cuda.KERNEL_DENSE_BF16,
                   stft_cuda.KERNEL_DENSE_BF16_CHUNKED)

        def kern():
            before = [k.launches for k in kernels]
            out = stft_cuda.stft_analysis(x, plan)
            got = [k.launches - b for k, b in zip(kernels, before)]
            if got != [0, 0, 1, 0]:
                fail(f"{name} at {args}: one call launched the FFT, dense, span and "
                     f"chunked entries {got} times, expected the span body once")
            return out

        # least traffic: the signal read, the output written; least work:
        # the rounded basis's products, which are the function
        return (kern,
                lambda: stft_cuda.stft_dft_plain(x.to(b16).float(), cos_b, sin_b, hop,
                                                 plan.pad),
                lambda: torch.matmul(frames, basis),
                4 * (B * n + 2 * B * n_bins * T), 2 * 2 * B * T * n_bins * n_fft, None,
                {"earlier_ms": lambda: stft_cuda._launch_dense(x, chunked, T,
                                                               "dense_bf16_chunked"),
                 # the library call's (B, T, 2F) product in the kernel's (B,
                 # 2F, T) layout: the matmul and one transposing copy
                 "library_transposed_ms": lambda: torch.matmul(frames, basis).transpose(
                     -1, -2).contiguous()})
    if name == "sa_fused_bf16":
        # kernel 2's fused bf16 gate at a site the path gave it. Least
        # traffic: x read once, out written once, the weights; least work:
        # the conv, the pooling's sum and max and the product. The library
        # figure: the gate as one bf16 eager PyTorch sequence (mean, max,
        # cat, bf16 F.conv2d, sigmoid, product); earlier_ms: PR 15's pair,
        # dcs_sa_pool_bf16 + dcs_sa_gate_bf16, at the same shape
        B, H, W, C, th, tw = args[:6]
        if (th, tw) != cuda_conv.fused_tile(B, H, W, C):
            fail(f"{name} at {args}: launched at a tile other than fused_tile's")
        re, im = randn(B, H, W, C).to(b16), randn(B, H, W, C).to(b16)
        w = randn(7, 7, 4, 2, scale=0.3).to(b16)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        geo = cuda_conv.fused_geometry(B, H, W, C)
        print(f"kernel {name} args={args}: tile {(th, tw)}, box {(geo.br, geo.bc)}, "
              f"grid {geo.grid}, {geo.smem} B of shared memory", flush=True)
        P = B * H * W

        def eager_sequence():
            cat = torch.cat([re.mean(dim=-1, keepdim=True), re.amax(dim=-1, keepdim=True),
                             im.mean(dim=-1, keepdim=True), im.amax(dim=-1, keepdim=True)],
                            dim=-1)
            a = torch.sigmoid(F.conv2d(cat.permute(0, 3, 1, 2), w_oihw, padding=3))
            a_re, a_im = a[:, 0, :, :, None], a[:, 1, :, :, None]
            return re * a_re - im * a_im, re * a_im + im * a_re

        return (lambda: cuda_conv.sa_fused_bf16(re, im, w),
                lambda: cuda_conv.sa_gate_bf16_plain(cuda_conv.sa_pool_bf16_plain(re, im),
                                                     w, re, im),
                eager_sequence,
                2 * (4 * P * C + w.numel()), 2 * P * 7 * 7 * 4 * 2 + 4 * P * C + 8 * P * C,
                None,
                {"earlier_ms": lambda: cuda_conv.sa_gate(cuda_conv.sa_pool(re, im), w, re,
                                                         im)})
    if name in ("sa_pool_real_bf16", "sa_gate_real_bf16"):
        # kernel 2's real pool and gate at bf16 at a site the path gave them.
        # The gate's library figure: its function in bf16 PyTorch (one bf16
        # F.conv2d of the pooled map, sigmoid, product), as row 2rb's; beside
        # it the whole real attention as one bf16 eager sequence (mean, max,
        # cat, F.conv2d, sigmoid, product), which pool + gate replace
        B, H, W, C = args[:4]
        x = randn(B, H, W, C).to(b16)
        w = randn(7, 7, 2, 1, scale=0.3).to(b16)
        pooled = cuda_conv.sa_pool_real_bf16_plain(x)
        P = B * H * W
        if name == "sa_pool_real_bf16":
            return (lambda: cuda_conv.sa_pool_real(x),
                    lambda: cuda_conv.sa_pool_real_bf16_plain(x), None,
                    2 * (P * C + 2 * P), 2 * P * C, None, {})
        if tuple(args[4:7]) != cuda_conv.gate_tile(B, H, W, 2, 1):
            fail(f"{name} at {args}: launched at a tile other than gate_tile's")
        w_oihw = w.permute(3, 2, 0, 1).contiguous()

        def library():
            return x * torch.sigmoid(F.conv2d(pooled.permute(0, 3, 1, 2), w_oihw,
                                              padding=3)).permute(0, 2, 3, 1)

        def eager_sequence():
            cat = torch.cat([x.mean(dim=-1, keepdim=True),
                             x.amax(dim=-1, keepdim=True)], dim=-1)
            a = torch.sigmoid(F.conv2d(cat.permute(0, 3, 1, 2), w_oihw, padding=3))
            return x * a.permute(0, 2, 3, 1)

        # pooled map and weights read, x read once and written once; the
        # conv, a sigmoid a pixel, a product a value
        return (lambda: cuda_conv.sa_gate_real(pooled, w, x),
                lambda: cuda_conv.sa_gate_real_bf16_plain(pooled, w, x),
                library,
                2 * (2 * P + w.numel() + 2 * P * C),
                2 * P * 7 * 7 * 2 + 4 * P + P * C, None,
                {"eager_pool_and_gate_ms": eager_sequence})
    if name in ("sa_pool_bf16", "sa_gate_bf16"):
        B, H, W, C = args[:4]
        re, im = randn(B, H, W, C).to(b16), randn(B, H, W, C).to(b16)
        w = randn(7, 7, 4, 2, scale=0.3).to(b16)
        pooled = cuda_conv.sa_pool_bf16_plain(re, im)
        P = B * H * W
        if name == "sa_pool_bf16":
            return (lambda: cuda_conv.sa_pool(re, im),
                    lambda: cuda_conv.sa_pool_bf16_plain(re, im), None,
                    2 * (2 * P * C + 4 * P), 4 * P * C, None, {})
        w_oihw = w.permute(3, 2, 0, 1).contiguous()

        def library():
            # the gate in bf16 PyTorch: one bf16 F.conv2d, sigmoid, product
            a = torch.sigmoid(F.conv2d(pooled.permute(0, 3, 1, 2), w_oihw, padding=3))
            a_re, a_im = a[:, 0, :, :, None], a[:, 1, :, :, None]
            return re * a_re - im * a_im, re * a_im + im * a_re

        return (lambda: cuda_conv.sa_gate(pooled, w, re, im),
                lambda: cuda_conv.sa_gate_bf16_plain(pooled, w, re, im), library,
                2 * (4 * P + w.numel() + 4 * P * C), 2 * P * 7 * 7 * 4 * 2 + 8 * P * C,
                None, {})
    if name in ("tapconv_valid_bf16", "tapconv_valid_bf16_tap"):
        # kernel 3's bf16 class at a shape the path gave the body ``name``
        # names; beside it the class's other body at the same shape: the
        # tap body it replaced (earlier_ms), or at dec6 the staged body
        # (staged_ms)
        B, H, W, cin, ho, wo, n, dh, dw, top, left = args[:11]
        pad = tapconv_pad(args)
        body = "staged" if name == "tapconv_valid_bf16" else "tap"
        if cuda_tapconv.bf16_body(B, H, W, cin, n, dh, dw, pad) != body:
            fail(f"{name} at {args}: the shape routes to the other body")
        x = randn(B, H, W, cin).to(b16)
        w = randn(dh * dw, cin, n, scale=1.0 / math.sqrt(dh * dw * cin)).to(b16)
        other = "tap" if body == "staged" else "staged"
        other_plan = cuda_tapconv.forward_plan(B, H, W, cin, n, dh, dw, pad, dev, bf16=True,
                                               body=other)
        print(f"kernel {name} args={args}: plan (bn, flat, wgs, S) "
              f"{cuda_tapconv.forward_plan(B, H, W, cin, n, dh, dw, pad, dev, bf16=True)}, "
              f"the {other} body's {other_plan}", flush=True)
        # pack_ms: the weights' packing alone, which every call (and every
        # replay) runs before the body; its share of ms
        kb = cuda_tapconv.STAGED_KB if body == "staged" else cuda_tapconv.BK
        bn = args[-2]
        packed = torch.empty((-(-n // bn), -(-cin // kb), dh * dw, kb // 8, bn, 8),
                             device=dev, dtype=b16)
        return (lambda: cuda_tapconv.tapconv_valid(x, w, dh, dw, pad),
                lambda: cuda_tapconv.tapconv_valid_bf16_plain(cuda_tapconv._pad(x, pad), w,
                                                              dh, dw),
                tapconv_library(x, w, dh, dw, pad),
                2 * (x.numel() + w.numel() + B * ho * wo * n),
                2 * B * ho * wo * dh * dw * cin * n, None,
                {("earlier_ms" if body == "staged" else "staged_ms"): lambda:
                 cuda_tapconv._launch(x, w, dh, dw, pad, other_plan, body=other),
                 "pack_ms": lambda: cuda_tapconv.PACK_BF16(dev, ptr(w), ptr(packed), dh * dw,
                                                           cin, n, bn, kb)})
    if name == "conv_same_small_cout":
        B, H, W, cin, K, cout = args[:6]
        x = randn(B, H, W, cin)
        w = randn(K, K, cin, cout, scale=0.1)
        bias = randn(cout)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        nbytes = 4 * (x.numel() + w.numel() + cout + B * H * W * cout)
        flops = 2 * B * H * W * K * K * cin * cout
        # earlier_ms: the body a tiled shape class ran before the tiled one
        # (the generic body, which every other class still runs)
        return (lambda: cuda_conv.conv2d_same_small_cout(x, w, bias),
                lambda: cuda_conv.conv2d_same_small_cout_plain(x, w, bias),
                lambda: F.conv2d(x_nchw, w_oihw, bias, padding=K // 2),
                nbytes, flops, None,
                {"earlier_ms": lambda: cuda_conv.launch_conv(
                    x, w, bias, cuda_conv.GENERIC_TILE)}
                if (K, cin, cout) in cuda_conv.TILED_CLASSES else {})
    if name in ("sa_pool", "sa_gate"):
        B, H, W, C = args[:4]
        re, im = randn(B, H, W, C), randn(B, H, W, C)
        w = randn(7, 7, 4, 2, scale=0.3)
        zero = torch.zeros(2, device=dev)
        pooled = cuda_conv.sa_pool_plain(re, im)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        P = B * H * W
        if name == "sa_pool":
            # x read once, the pooled map written; a sum and a max per value
            return (lambda: cuda_conv.sa_pool(re, im),
                    lambda: cuda_conv.sa_pool_plain(re, im), None,
                    4 * (2 * P * C + 4 * P), 4 * P * C, None, {})

        def eager_library():
            a = torch.sigmoid(F.conv2d(pooled.permute(0, 3, 1, 2), w_oihw, padding=3))
            a_re, a_im = a[:, 0, :, :, None], a[:, 1, :, :, None]
            return re * a_re - im * a_im, re * a_im + im * a_re

        def replaced_sequence():
            # what the module ran before the fused gate, pooling included:
            # 4 reductions, a concatenation, the conv's earlier body on the
            # card, a sigmoid, the complex product as 6 elementwise passes
            a = torch.sigmoid(cuda_conv.launch_conv(
                cuda_conv.sa_pool_plain(re, im), w, zero, cuda_conv.GENERIC_TILE))
            a_re, a_im = a[..., :1], a[..., 1:]
            return re * a_re - im * a_im, re * a_im + im * a_re

        # pooled map and weights read, x read once and written once
        return (lambda: cuda_conv.sa_gate(pooled, w, re, im),
                lambda: cuda_conv.sa_gate_plain(pooled, w, re, im),
                eager_library,
                4 * (4 * P + w.numel() + 4 * P * C),
                2 * P * 7 * 7 * 4 * 2 + 8 * P * C, None,
                {"replaced_pool_and_gate_ms": replaced_sequence})
    if name in ("sa_pool_real", "sa_gate_real"):
        B, H, W, C = args[:4]
        x = randn(B, H, W, C)
        w = randn(7, 7, 2, 1, scale=0.3)
        zero = torch.zeros(1, device=dev)
        pooled = cuda_conv.sa_pool_real_plain(x)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        P = B * H * W
        if name == "sa_pool_real":
            # x read once, the pooled map written; a sum and a max per value
            return (lambda: cuda_conv.sa_pool_real(x),
                    lambda: cuda_conv.sa_pool_real_plain(x), None,
                    4 * (P * C + 2 * P), 2 * P * C, None, {})

        def library():
            # the gate's function in one PyTorch conv call and two passes
            return x * torch.sigmoid(F.conv2d(pooled.permute(0, 3, 1, 2), w_oihw,
                                              padding=3)).permute(0, 2, 3, 1)

        def eager_sequence():
            # the whole real attention in eager PyTorch: mean, max,
            # concatenation, F.conv2d, sigmoid, product
            cat = torch.cat([x.mean(dim=-1, keepdim=True),
                             x.amax(dim=-1, keepdim=True)], dim=-1)
            a = torch.sigmoid(F.conv2d(cat.permute(0, 3, 1, 2), w_oihw, padding=3))
            return x * a.permute(0, 2, 3, 1)

        def replaced_sequence():
            # what the module ran before the real gate: the same sequence
            # with the conv on kernel 2's generic body
            a = torch.sigmoid(cuda_conv.launch_conv(
                cuda_conv.sa_pool_real_plain(x), w, zero, cuda_conv.GENERIC_TILE))
            return x * a

        # pooled map and weights read, x read once and written once; the
        # conv, a sigmoid a pixel, a product a value
        return (lambda: cuda_conv.sa_gate_real(pooled, w, x),
                lambda: cuda_conv.sa_gate_real_plain(pooled, w, x),
                library,
                4 * (2 * P + w.numel() + 2 * P * C),
                2 * P * 7 * 7 * 2 + 4 * P + P * C, None,
                {"eager_pool_and_gate_ms": eager_sequence,
                 "replaced_pool_and_gate_ms": replaced_sequence})
    if name == "tapconv_valid":
        # x (B, H, W, Cin) read in place as zero-padded by pad. earlier_ms:
        # the route it replaced, one-row tiles without a split on a padded
        # copy of x
        B, H, W, cin, ho, wo, n, dh, dw, top, left = args[:11]
        pad = tapconv_pad(args)
        x = randn(B, H, W, cin)
        w = randn(dh * dw, cin, n, scale=1.0 / math.sqrt(dh * dw * cin))
        earlier = one_row_plan(B, ho, wo, cin, n, dh, dw, cuda_tapconv._sm_count(dev))
        nbytes = 4 * (x.numel() + w.numel() + B * ho * wo * n)
        flops = 2 * B * ho * wo * dh * dw * cin * n
        return (lambda: cuda_tapconv.tapconv_valid(x, w, dh, dw, pad),
                lambda: cuda_tapconv.tapconv_valid_plain(cuda_tapconv._pad(x, pad), w, dh, dw),
                tapconv_library(x, w, dh, dw, pad),
                nbytes, flops, None,
                {"earlier_ms": lambda: cuda_tapconv._launch(
                    cuda_tapconv._pad(x, pad), w, dh, dw, plan=earlier)})
    if name == "conv_same_small_cout_dgrad":
        # launched with x = the upstream gradient g (B, H, W, Cout of the
        # forward) and the dgrad kernel; the least work is the forward's.
        # earlier_ms: the generic body, which ran this class before
        B, H, W, cout, K, cin = args[:6]
        gy = randn(B, H, W, cout)
        w = randn(K, K, cin, cout, scale=0.1)
        wt, zero = cuda_conv.dgrad_kernel(w), torch.zeros(cin, device=dev)
        g_nchw = gy.permute(0, 3, 1, 2).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        return (lambda: cuda_conv._same_conv(gy, wt, zero, dgrad=True),
                lambda: cuda_conv.conv2d_same_small_cout_plain(gy, wt, zero),
                lambda: torch.nn.grad.conv2d_input((B, cin, H, W), w_oihw, g_nchw,
                                                   padding=K // 2),
                4 * (gy.numel() + w.numel() + B * H * W * cin),
                2 * B * H * W * K * K * cin * cout, None,
                {"earlier_ms": lambda: cuda_conv.launch_conv(
                    gy, wt, zero, cuda_conv.GENERIC_TILE)}
                if (K, cout, cin) in cuda_conv.TILED_CLASSES else {})
    if name == "tapconv_valid_dgrad":
        # g (B, HO, WO, N) -> dx (B, H, W, Cin) of an input padded by pad.
        # The least work is the forward's: g read, w read, dx written.
        # earlier_ms: the route it replaced, the forward entry on g padded
        # by (Dh - 1, Dw - 1) with the flipped, transposed weights (both
        # copies), which wrote the padded input's gradient
        B, ho, wo, n, H, W, cin, dh, dw, top, left = args[:11]
        pad = (top, ho - H - top + dh - 1, left, wo - W - left + dw - 1)
        gy = randn(B, ho, wo, n)
        w = randn(dh * dw, cin, n, scale=1.0 / math.sqrt(dh * dw * cin))
        return (lambda: cuda_tapconv._launch_dgrad(gy, w, dh, dw, pad, (H, W)),
                lambda: cuda_tapconv.tapconv_dgrad_plain(gy, w, dh, dw, pad, (H, W)),
                tapconv_input_grad_library(gy, w, dh, dw, pad, (H, W)),
                4 * (gy.numel() + w.numel() + B * H * W * cin),
                2 * B * ho * wo * dh * dw * cin * n, None,
                {"earlier_ms": lambda: cuda_tapconv._launch(
                    cuda_tapconv.dgrad_input(gy, dh, dw), cuda_tapconv.dgrad_weights(w),
                    dh, dw)})
    if name == "conv_same_small_cout_bf16":
        # kernel 2's conv entry at bf16 (the un-fused gate's conv in a bf16
        # train step): x and w bf16, the float32 bias, y bf16. The library
        # call: one bf16 F.conv2d (cuDNN, float32 sums)
        B, H, W, cin, K, cout = args[:6]
        mma_launch_text(name, args)
        x = randn(B, H, W, cin).to(b16)
        w = randn(K, K, cin, cout, scale=0.1).to(b16)
        bias = randn(cout)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        return (lambda: cuda_conv.conv2d_same_small_cout(x, w, bias),
                lambda: cuda_conv.conv2d_same_small_cout_bf16_plain(x, w, bias),
                lambda: F.conv2d(x_nchw, w_oihw, bias.to(b16), padding=K // 2),
                2 * (x.numel() + w.numel() + B * H * W * cout) + 4 * cout,
                2 * B * H * W * K * K * cin * cout, None, {})
    if name == "conv_same_small_cout_dgrad_bf16":
        # its input gradient at bf16, class (7, 2, 4): launched with x = the
        # bf16 upstream gradient and the dgrad kernel; the library call one
        # bf16 torch.nn.grad.conv2d_input
        B, H, W, cout, K, cin = args[:6]
        mma_launch_text(name, args)
        gy = randn(B, H, W, cout).to(b16)
        w = randn(K, K, cin, cout, scale=0.1).to(b16)
        wt = cuda_conv.dgrad_kernel(w)
        zero = torch.zeros(cin, device=dev)
        g_nchw = gy.permute(0, 3, 1, 2).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        return (lambda: cuda_conv._same_conv(gy, wt, zero, dgrad=True),
                lambda: cuda_conv.conv2d_same_small_cout_dgrad_bf16_plain(gy, w),
                lambda: torch.nn.grad.conv2d_input((B, cin, H, W), w_oihw, g_nchw,
                                                   padding=K // 2),
                2 * (gy.numel() + w.numel() + B * H * W * cin),
                2 * B * H * W * K * K * cin * cout, None, {})
    if name in ("tapconv_valid_dgrad_bf16", "tapconv_valid_dgrad_bf16_tap"):
        # kernel 3's input gradient at bf16: the staged body on g (B, HO, WO,
        # N) read in place, padded by Dh - 1 - top rows before it (the
        # recorded launch's padding), on the forward's packing of w made
        # beforehand as the forward makes it (recorded: its N tile and
        # chunk); the tap body on the flipped, transposed weights, whose
        # packing every call runs (pack_ms) -> dx (B, H, W, Cin). The least
        # work is the forward's. The library call: one bf16
        # torch.nn.grad.conv2d_input
        B, ho, wo, n, H, W, cin, dh, dw = args[:9]
        gtop, gbottom, gleft, gright = tapconv_pad(args)
        pad = (dh - 1 - gtop, dh - 1 - gbottom, dw - 1 - gleft, dw - 1 - gright)
        body = "staged" if name == "tapconv_valid_dgrad_bf16" else "tap"
        if cuda_tapconv.dgrad_body_bf16(B, ho, wo, n, cin, dh, dw,
                                        (gtop, gbottom, gleft, gright)) != body:
            fail(f"{name} at {args}: the shape routes to another body")
        gy = randn(B, ho, wo, n).to(b16)
        w = randn(dh * dw, cin, n, scale=1.0 / math.sqrt(dh * dw * cin)).to(b16)
        extras, packing = {}, None
        if body == "staged":
            packing = cuda_tapconv.pack_bf16(w, *args[15:17])
        else:
            bn = args[13]
            packed = torch.empty((-(-cin // bn), -(-n // cuda_tapconv.BK), dh * dw,
                                  cuda_tapconv.BK // 8, bn, 8), device=dev, dtype=b16)
            extras["pack_ms"] = lambda: cuda_tapconv.DGRAD_PACK_BF16(
                dev, ptr(w), ptr(packed), dh * dw, cin, n, bn, cuda_tapconv.BK)
        print(f"kernel {name} args={args}: the {body} body on g padded by "
              f"{(gtop, gbottom, gleft, gright)}, plan (bn, flat, wgs, S) {args[11:15]}",
              flush=True)
        return (lambda: cuda_tapconv._launch_dgrad(gy, w, dh, dw, pad, (H, W), packing),
                lambda: cuda_tapconv.tapconv_dgrad_bf16_plain(gy, w, dh, dw, pad, (H, W)),
                tapconv_input_grad_library(gy, w, dh, dw, pad, (H, W)),
                2 * (gy.numel() + w.numel() + B * H * W * cin),
                2 * B * ho * wo * dh * dw * cin * n, None, extras)
    if name == "tapconv_valid_dgrad_narrow_bf16":
        # kernel 3's input gradient at bf16 where the reduction is narrow
        # (dec6): g (B, HO, WO, N <= 8) and w (9, Cin <= 32, N) as they are,
        # the forward's padding recorded -> dx (B, H, W, Cin). Bound: bytes
        B, ho, wo, n, H, W, cin, dh, dw, top, left = args[:11]
        pad = (top, ho - H - top + dh - 1, left, wo - W - left + dw - 1)
        gy = randn(B, ho, wo, n).to(b16)
        w = randn(dh * dw, cin, n, scale=1.0 / math.sqrt(dh * dw * cin)).to(b16)
        c, steps = cuda_tapconv.narrow_fold(n)
        print(f"kernel {name} args={args}: the narrow body, {c} channels a tap slot, "
              f"{steps} k16 steps, tiles of {cuda_tapconv.NARROW_ROWS} x "
              f"{cuda_tapconv.NARROW_COLS} pixels, forward padding {pad}", flush=True)
        return (lambda: cuda_tapconv._launch_dgrad(gy, w, dh, dw, pad, (H, W)),
                lambda: cuda_tapconv.tapconv_dgrad_bf16_plain(gy, w, dh, dw, pad, (H, W)),
                tapconv_input_grad_library(gy, w, dh, dw, pad, (H, W)),
                2 * (gy.numel() + w.numel() + B * H * W * cin),
                2 * B * ho * wo * dh * dw * cin * n, None, {})
    raise KeyError(name)


def mma_launch_text(name, args) -> None:
    """Print how kernel 2's bf16 conv entry ran a recorded launch (B, H, W,
    Cin, K, Cout, TH, TW, RB): its class, tile, grid and shared memory; fail
    where the tile is not the rule's (``cuda_conv.mma_tile``)."""
    from dcs_net_tpu_torch.ops import cuda_conv

    B, H, W, cin, _, cout = args[:6]
    tile = tuple(args[6:9])
    if tile != cuda_conv.mma_tile(B, H, W, cin, cout):
        fail(f"{name} at {args}: tile {tile} is not mma_tile's")
    geo = cuda_conv.mma_geometry(B, H, W, cin, cout, tile)
    print(f"kernel {name} args={args}: the tensor-core body at class (7, {cin}, {cout}), "
          f"tile (TH, TW, RB) {tile}, grid {geo.grid}, {geo.smem} bytes of shared memory",
          flush=True)


def tapconv_pad(args):
    """(top, bottom, left, right) of a recorded forward launch of kernel 3,
    (B, H, W, Cin, HO, WO, N, Dh, Dw, top, left, ...)."""
    _, H, W, _, ho, wo, _, dh, dw, top, left = args[:11]
    return top, ho + dh - 1 - H - top, left, wo + dw - 1 - W - left


def one_row_plan(B, ho, wo, cin, n, dh, dw, sms):
    """The forward route the entry took before ``forward_plan``, as a plan
    (bn, flat, wgs, split): one-row tiles, the full N tile, no split;
    64-pixel tiles where the row is that short, where 128-pixel tiles would
    leave half of the card's SMs without a block, or where two 128-pixel
    halo tiles do not fit shared memory."""
    from dcs_net_tpu_torch.ops import cuda_tapconv as ct

    bn = ct.tile_n(n)
    blocks128 = B * ho * -(-wo // 128) * -(-n // bn)
    _, arows, apw = ct.tiling(0, 2, ho, wo, dh, dw)
    narrow = (wo <= 64 or 2 * blocks128 <= sms
              or ct.smem_bytes(ct.BK, bn, 2, cin, dh * dw, arows, apw) > ct.SMEM_LIMIT)
    return bn, 0, 1 if narrow else 2, 1


def tapconv_library(x, w, dh, dw, pad):
    """One ``F.conv2d`` call for kernel 3's forward: the conv's own padding
    where it is symmetric, else on a padded copy."""
    import torch.nn.functional as F

    cin, n = w.shape[1:]
    top, bottom, left, right = pad
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    w_oihw = w.reshape(dh, dw, cin, n).permute(3, 2, 0, 1).contiguous()
    if top == bottom and left == right:
        return lambda: F.conv2d(x_nchw, w_oihw, padding=(top, left))
    return lambda: F.conv2d(F.pad(x_nchw, (left, right, top, bottom)), w_oihw)


def tapconv_input_grad_library(gy, w, dh, dw, pad, hw):
    """One ``torch.nn.grad.conv2d_input`` call for kernel 3's input
    gradient: symmetric padding as the conv's own; otherwise the gradient of
    the padded input, of which x's pixels are a view."""
    import torch

    B, _, _, n = gy.shape
    cin = w.shape[1]
    top, bottom, left, right = pad
    H, W = hw
    g_nchw = gy.permute(0, 3, 1, 2).contiguous()
    w_oihw = w.reshape(dh, dw, cin, n).permute(3, 2, 0, 1).contiguous()
    if top == bottom and left == right:
        return lambda: torch.nn.grad.conv2d_input((B, cin, H, W), w_oihw, g_nchw,
                                                  padding=(top, left))
    shape = (B, cin, H + top + bottom, W + left + right)
    return lambda: torch.nn.grad.conv2d_input(shape, w_oihw, g_nchw)[
        :, :, top:top + H, left:left + W]


def check_kernels(shapes, launches, dev, cfg, card, where, suffix=""):
    """Every recorded shape, kernel vs plain on the card, each timed as
    device time per call (``graph_ms``). ``where`` names the call whose
    launches ``shapes`` lists; returns one row per kernel, summed over them,
    named ``<kernel><suffix>`` (the real family's shape classes are rows of
    their own)."""
    import torch

    from dcs_net_tpu_torch.utils.timing import graph_ms

    rows = []
    for name, calls in shapes.items():
        src, repl, design_name, ops_rate = KERNEL_INFO.get(name + suffix, KERNEL_INFO[name])
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0)
        max_abs = max_rel = 0.0
        timed = {}
        for args in calls:
            kern, plain, lib, nbytes, flops, design_flops, extras = kernel_cases(
                name, args, dev, cfg)
            if args not in timed:
                got, want = kern(), plain()
                torch.cuda.synchronize()
                if isinstance(got, tuple):
                    err = max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(got, want))
                    ref = max(float(b.float().abs().max()) for b in want)
                else:
                    err = float((got.float() - want.float()).abs().max())
                    ref = float(want.float().abs().max())
                rel = err / max(ref, 1e-30)
                tol = KERNEL_TOL.get(name, REL_TOL)
                bound = max(nbytes / HBM_BYTES_PER_S, flops / ops_rate) * 1e3
                iters = max(3, min(50, int(1.0 / max(bound, 1e-3))))
                t = {"ms": graph_ms(kern, iters), "plain_ms": graph_ms(plain, iters),
                     "library_ms": None if lib is None else graph_ms(lib, iters)}
                t.update({k: graph_ms(fn, iters) for k, fn in extras.items()})
                timed[args] = t
                # only the dense STFT entry reports its own operations: 3xTF32
                design = ("" if design_flops is None else
                          f" design_ceiling_ms={design_flops / TF32X3_FLOPS_PER_S * 1e3:.4f}"
                          f" (its own {design_flops / 1e9:.2f} GFLOP at the 3xTF32 rate, "
                          f"{TF32X3_FLOPS_PER_S / 1e12:.0f} TFLOP/s)")
                times = " ".join(f"{k}={'null' if v is None else format(v, '.4f')}"
                                 for k, v in t.items())
                print(f"kernel {name} args={args} max_abs_err={err:.3e} "
                      f"rel_err={rel:.3e} {times} bound_ms={bound:.4f}{design} "
                      f"[{card}]", flush=True)
                if not math.isfinite(rel) or rel > tol:
                    fail(f"{name} at {args}: error {rel:.3e} relative to max "
                         f"|plain| exceeds {tol:.3e}")
                if "earlier_ms" in t and t["ms"] > t["earlier_ms"]:
                    # the input gradients and the bf16 classes' redesigned
                    # bodies are reported, not failed, where the body they
                    # replaced is faster at a shape
                    if not name.endswith(("_dgrad", "_bf16")):
                        fail(f"{name} at {args}: {t['ms']:.4f} ms, slower than the "
                             f"body it replaced ({t['earlier_ms']:.4f} ms)")
                    print(f"SLOW: {name} at {args}: {t['ms']:.4f} ms, slower than "
                          f"the route it replaced ({t['earlier_ms']:.4f} ms)", flush=True)
                max_abs, max_rel = max(max_abs, err), max(max_rel, rel)
            for k, v in timed[args].items():
                tot[k] = None if v is None else tot.get(k, 0.0) + v
            tot["bytes"] += nbytes
            tot["flops"] += flops
        t_bytes = tot.pop("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = tot.pop("flops") / ops_rate * 1e3
        rows.append({
            "name": name + suffix, "route": "cuda", "source": src, "replaces": repl,
            "design": design_name, "launches": launches.get(name, 0),
            "max_abs_err": max_abs, "max_rel_err": max_rel, **tot,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_rate": {"bytes_per_s": HBM_BYTES_PER_S, "flops_per_s": ops_rate},
            "shapes": len(set(calls)),
        })
        on_path = (f"{len(calls)} launches per {where}" if launches.get(name, 0)
                   else "not on the slice's path")
        times = " ".join(f"{k}={'null' if v is None else format(v, '.4f')}"
                         for k, v in tot.items())
        print(f"kernel {name}{suffix} ({design_name}): {on_path}, summed {times} "
              f"bound_ms={rows[-1]['bound_ms']:.4f} ({rows[-1]['bound_by']}) "
              f"[{card}]", flush=True)
    return rows


def empty_launch_ms() -> float:
    """Device time of a kernel that does nothing (conv_same.cu's
    ``dcs_empty_launch``), timed like every other row: the floor under a
    small launch."""
    import ctypes

    import torch

    from dcs_net_tpu_torch.ops import cuda_conv
    from dcs_net_tpu_torch.utils.timing import graph_ms

    cuda_conv.KERNEL._load()
    fn = cuda_conv.KERNEL._lib.dcs_empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        if fn(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)) != 0:
            fail("the empty kernel did not launch")

    return graph_ms(launch, 50)


def check_conv_off_path(dev) -> None:
    """Kernel 2 where the slice does not take it: the pooling pass, the gate
    and the tiled conv body at odd and tiny shapes, at channel counts that
    are 1 or no multiple of 4, on a view that is not 16-byte aligned, at
    batch 1 and 32; the generic body at other (K, Cin, Cout)."""
    import torch

    from dcs_net_tpu_torch.ops import cuda_conv as cc

    g = torch.Generator(device=dev).manual_seed(SEED + 10)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    w = randn(7, 7, 4, 2, scale=0.3)
    bias = randn(2)
    for B, H, W, C in GATE_EXTRA:
        re, im = randn(B, H, W, C), randn(B, H, W, C)
        pooled = cc.sa_pool_plain(re, im)
        before = cc.KERNEL.launches, cc.POOL.launches, cc.GATE.launches
        errs = {"pool": rel_err(cc.sa_pool(re, im), pooled),
                "gate": rel_err(cc.sa_gate(pooled, w, re, im),
                                cc.sa_gate_plain(pooled, w, re, im)),
                "pool+gate": rel_err(cc.spatial_gate(re, im, w),
                                     cc.spatial_gate_plain(re, im, w)),
                "conv": rel_err(cc.conv2d_same_small_cout(pooled, w, bias),
                                cc.conv2d_same_small_cout_plain(pooled, w, bias))}
        # the same values behind a pointer that is 4 bytes off a 16-byte line
        off = randn(re.numel() + 1)[1:].view(re.shape).copy_(re)
        errs["gate, unaligned x"] = rel_err(cc.spatial_gate(off, im, w),
                                            cc.spatial_gate_plain(re, im, w))
        off4 = randn(pooled.numel() + 1)[1:].view(pooled.shape).copy_(pooled)
        errs["conv, unaligned x"] = rel_err(cc.conv2d_same_small_cout(off4, w, bias),
                                            cc.conv2d_same_small_cout_plain(pooled, w, bias))
        torch.cuda.synchronize()
        after = cc.KERNEL.launches, cc.POOL.launches, cc.GATE.launches
        if tuple(a - b for a, b in zip(after, before)) != (5, 3, 3):
            fail(f"kernel 2 at {(B, H, W, C)}: launches {before} -> {after}")
        print(f"kernel 2 off the path: x ({B}, {H}, {W}, {C}) tile "
              f"{cc.choose_tile(B, H, W, 4, 2)}: " + ", ".join(
                  f"{k} rel_err={v:.3e}" for k, v in errs.items()), flush=True)
        for k, v in errs.items():
            if not math.isfinite(v) or v > REL_TOL:
                fail(f"kernel 2 ({k}) at {(B, H, W, C)}: error {v:.3e} exceeds {REL_TOL}")
    for shape, K, cout in CONV_EXTRA:
        x = randn(*shape)
        wk, bk = randn(K, K, shape[-1], cout, scale=0.1), randn(cout)
        v = rel_err(cc.conv2d_same_small_cout(x, wk, bk),
                    cc.conv2d_same_small_cout_plain(x, wk, bk))
        print(f"kernel conv_same_small_cout off the path (generic body): x {shape} "
              f"K {K} -> {cout}: rel_err={v:.3e}", flush=True)
        if not math.isfinite(v) or v > REL_TOL:
            fail(f"conv_same_small_cout at {shape}, K {K}, Cout {cout}: error "
                 f"{v:.3e} exceeds {REL_TOL}")


def stft_launch_text(n_fft, hop, B, T, n_bins) -> str:
    """How kernel 1 runs one shape on this card: the FFT entry's radices and
    frames a block, or the dense entry's cluster split; with the shared
    memory a block and the blocks an SM (the occupancy calculator), but for
    the compiled n_fft 512."""
    from dcs_net_tpu_torch.dsp import stft_cuda

    if stft_cuda.choose_entry(n_fft, hop) == "fft":
        ft = stft_cuda.fft_tile_frames(n_fft, hop, B, T)
        how = f"radices {stft_cuda.fft_radices(n_fft)}, {ft} frames a block"
        if n_fft == stft_cuda.FFT_COMPILED:
            return how + ", the compiled kernel"
        entry, smem = "fft", stft_cuda.fft_smem_bytes(n_fft, hop, ft)
    else:
        entry, smem = "dense", stft_cuda.DENSE_SMEM
        split = stft_cuda.dense_split(n_fft, n_bins, B, T,
                                      stft_cuda.blocks_per_sm(entry, smem))
        how = f"split {split}"
    return (how + f", {smem} B of shared memory, "
            f"{stft_cuda.blocks_per_sm(entry, smem)} blocks an SM")


def check_stft_off_path(dev, cfg) -> None:
    """Kernel 1 where the slice does not take it, against the plain version:
    the FFT entry at every size of ``FFT_STFT_EXTRA`` (odd hops put a lane's
    sample pair at an odd word of the skewed span; no centering; the DC bin
    kept), the dense entry at ``DENSE_STFT_EXTRA``; each call launching the
    entry ``choose_entry`` names once. Row 1's size keeps its (16, 16)."""
    import dataclasses

    import torch

    from dcs_net_tpu_torch.dsp import stft as dsp
    from dcs_net_tpu_torch.dsp import stft_cuda

    if stft_cuda.fft_radices(cfg.stft.n_fft) != (16, 16):
        fail(f"n_fft {cfg.stft.n_fft} plans {stft_cuda.fft_radices(cfg.stft.n_fft)}, "
             f"not the compiled (16, 16)")
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    for entry, cases in (("fft", FFT_STFT_EXTRA), ("dense", DENSE_STFT_EXTRA)):
        for B, n, n_fft, hop, center, drop_dc in cases:
            scfg = dataclasses.replace(cfg.stft, n_fft=n_fft, hop=hop, win_length=n_fft,
                                       center=center, drop_dc=drop_dc)
            if stft_cuda.choose_entry(n_fft, hop) != entry:
                fail(f"n_fft {n_fft}, hop {hop} does not name the {entry} entry point")
            plan = dsp._analysis_plan(scfg, dev)
            cos_b, sin_b = dsp._on_device(dsp._dft_basis_eff, scfg, dev)
            x = torch.randn((B, n), generator=g, device=dev) * 0.3
            before = stft_cuda.KERNEL.launches, stft_cuda.KERNEL_DENSE.launches
            got = stft_cuda.stft_analysis(x, plan)
            want = stft_cuda.stft_dft_plain(x, cos_b, sin_b, hop, plan.pad)
            torch.cuda.synchronize()
            launched = (stft_cuda.KERNEL.launches - before[0],
                        stft_cuda.KERNEL_DENSE.launches - before[1])
            if launched != ((1, 0) if entry == "fft" else (0, 1)):
                fail(f"stft at n_fft {n_fft}, hop {hop} launched the FFT and the dense "
                     f"entry {launched} times, expected once the {entry} entry")
            rel = (max(float((a - b).abs().max()) for a, b in zip(got, want))
                   / max(float(b.abs().max()) for b in want))
            how = stft_launch_text(n_fft, hop, B, got[0].shape[-1], scfg.n_bins)
            print(f"kernel stft ({entry}) off the path: x ({B}, {n}) n_fft {n_fft} "
                  f"hop {hop} center {center} drop_dc {drop_dc} -> "
                  f"{tuple(got[0].shape)}, {how}: rel_err={rel:.3e}", flush=True)
            if got[0].shape != want[0].shape or not math.isfinite(rel) or rel > REL_TOL:
                fail(f"stft ({entry}) at n_fft {n_fft}, hop {hop}: error {rel:.3e} "
                     f"exceeds {REL_TOL}")


def check_tapconv_off_path(dev) -> None:
    """Kernel 3 where the slice does not take it: ragged pixel runs, channel
    counts that fill no chunk or tile, other windows, each also read in
    place through a padding; and the weights its packing kernel writes, bit
    for bit against ``pack_weights``."""
    import torch

    from dcs_net_tpu_torch.ops import cuda_tapconv as ct
    from dcs_net_tpu_torch.utils.cuda_lib import ptr

    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    for shape, (dh, dw), n in TAPCONV_EXTRA:
        x = torch.randn(shape, generator=g, device=dev)
        w = torch.randn((dh * dw, shape[-1], n), generator=g, device=dev) * 0.1
        want = ct.tapconv_valid_plain(x, w, dh, dw)
        # the same values with their outer rows and columns zero: x's
        # interior read in place, padded by them
        pad = (min(1, shape[1] - 1), 0, min(2, shape[2] - 1), 0)
        inner = x[:, pad[0]:, pad[2]:].contiguous()
        rel = max(rel_err(ct.tapconv_valid(x, w, dh, dw), want),
                  rel_err(ct.tapconv_valid(inner, w, dh, dw, pad), ct.tapconv_valid_plain(
                      ct._pad(inner, pad), w, dh, dw)))
        want_packed = ct.pack_weights(w, ct.tile_n(n))
        packed = torch.empty_like(want_packed)
        ct.PACK(dev, ptr(w), ptr(packed), dh * dw, shape[-1], n, ct.tile_n(n))
        torch.cuda.synchronize()
        same = bool((packed.view(torch.int32) == want_packed.view(torch.int32)).all())
        print(f"kernel tapconv_valid off the path: x {shape} {dh}x{dw} -> {n}: "
              f"rel_err={rel:.3e}, packed weights equal pack_weights: {same}", flush=True)
        if not math.isfinite(rel) or rel > REL_TOL:
            fail(f"tapconv_valid at {shape}: error {rel:.3e} exceeds {REL_TOL}")
        if not same:
            fail(f"tapconv_pack at {shape}: layout differs from pack_weights")


def check_forward_sweep(dev, card, bf16=False) -> None:
    """Kernel 3's forward where the plan splits the reduction: dec0-dec2 at
    batch 1 (a test utterance) and at a streaming chunk group (batch 8),
    under every (flat, wgs, S) that fits, each against the plain version and
    timed beside ``F.conv2d`` and the route it replaced (the one-row route;
    at ``bf16`` the bf16 class's staged body beside its tap body at the tap
    body's plan), so that the plan's pick reads against the sweep's best."""
    import torch

    from dcs_net_tpu_torch.ops import cuda_tapconv as ct
    from dcs_net_tpu_torch.utils.timing import graph_ms

    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    pad, sms = (1, 1, 1, 1), ct._sm_count(dev)
    name, tol = ("tapconv_valid_bf16", BF16_REL_TOL) if bf16 else ("tapconv_valid", REL_TOL)
    for B, H, W, cin, n in FORWARD_SWEEP:
        x = torch.randn((B, H, W, cin), generator=g, device=dev)
        w = torch.randn((9, cin, n), generator=g, device=dev) / math.sqrt(9 * cin)
        if bf16:
            x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
            want = ct.tapconv_valid_bf16_plain(ct._pad(x, pad), w, 3, 3).float()
        else:
            want = ct.tapconv_valid_plain(ct._pad(x, pad), w, 3, 3)
        chosen = ct.forward_plan(B, H, W, cin, n, 3, 3, pad, dev, bf16=bf16)
        times, bn = {}, ct.tile_n(n)
        for flat, wgs, split in itertools.product((0, 1), (1, 2), (1, 2, 4, 8)):
            if bf16:
                npix = ct.staged_tiling(flat, wgs, H, W, 3, 3)[3]
                fits = (split <= -(-cin // ct.STAGED_KB)
                        and ct.staged_stages(bn, wgs, 9, npix, cin, split) > 0)
            else:
                _, arows, apw = ct.tiling(flat, wgs, H, W, 3, 3)
                fits = (split <= -(-cin // ct.BK) and ct.launch_smem(
                    bn, wgs, cin, 9, arows, apw, split) <= ct.SMEM_LIMIT)
            if not fits or (flat and W >= 128):
                continue
            plan = (bn, flat, wgs, split)
            rel = rel_err(ct._launch(x, w, 3, 3, pad, plan).float(), want)
            if not math.isfinite(rel) or rel > tol:
                fail(f"{name} at {(B, H, W, cin, n)} under {plan}: error "
                     f"{rel:.3e} exceeds {tol}")
            times[plan] = graph_ms(lambda: ct._launch(x, w, 3, 3, pad, plan), 10)
        library = graph_ms(tapconv_library(x, w, 3, 3, pad), 10)
        if bf16:
            earlier = ct.forward_plan(B, H, W, cin, n, 3, 3, pad, dev, bf16=True, body="tap")
            what = "the tap body"
            earlier_ms = graph_ms(lambda: ct._launch(x, w, 3, 3, pad, earlier, body="tap"), 10)
        else:
            earlier = one_row_plan(B, H, W, cin, n, 3, 3, sms)
            what = "the one-row route"
            earlier_ms = graph_ms(lambda: ct._launch(ct._pad(x, pad), w, 3, 3, plan=earlier),
                                  10)
        best = min(times, key=times.get)
        print(f"kernel {name} sweep: x ({B}, {H}, {W}, {cin}) -> N {n}, 3x3, "
              f"pad {pad}; (bn, flat, wgs, S) ms: "
              + ", ".join(f"{p}={t:.4f}" for p, t in times.items())
              + f"; the plan {chosen} {times[chosen]:.4f} ms, the sweep's best {best} "
              f"{times[best]:.4f}, {what} {earlier_ms:.4f}, library_ms="
              f"{library:.4f} (F.conv2d) [{card}]", flush=True)


def check_dgrad_off_path(dev, card) -> None:
    """The two input-gradient entries where the train step does not take
    them, each against its plain version, timed beside the route it
    replaced, the bound and ``conv2d_input``; kernel 3's entry under every
    tiling that fits (flat or one row, 64 or 128 pixels), its flipped
    packing bit for bit against ``pack_weights(dgrad_weights(w))``."""
    import torch

    from dcs_net_tpu_torch.ops import cuda_conv as cc
    from dcs_net_tpu_torch.ops import cuda_tapconv as ct
    from dcs_net_tpu_torch.utils.cuda_lib import ptr
    from dcs_net_tpu_torch.utils.timing import graph_ms

    g = torch.Generator(device=dev).manual_seed(SEED + 16)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def forced(gy, w, dh, dw, pad, hw, flat, wgs):
        B, ho, wo, n = gy.shape
        cin = w.shape[1]
        kb, bn = ct.dgrad_tiles(n, cin)
        packed = torch.empty((-(-cin // bn), -(-n // kb), dh * dw, 2, kb // 4, bn, 4),
                             device=dev)
        dx = torch.empty((B,) + tuple(hw) + (cin,), device=dev)
        ct.DGRAD_PACK(dev, ptr(w), ptr(packed), dh * dw, cin, n, kb, bn)
        ct.DGRAD(dev, ptr(gy), ptr(packed), ptr(dx), B, ho, wo, n, hw[0], hw[1], cin,
                 dh, dw, pad[0], pad[2], flat, wgs, kb, bn)
        return dx, packed

    for (B, H, W), n, cin, (dh, dw), pad in DGRAD_EXTRA:
        ho, wo = H + pad[0] + pad[1] - dh + 1, W + pad[2] + pad[3] - dw + 1
        gy = randn(B, ho, wo, n)
        w = randn(dh * dw, cin, n, scale=1.0 / math.sqrt(dh * dw * cin))
        want = ct.tapconv_dgrad_plain(gy, w, dh, dw, pad, (H, W))
        errs = {"chosen": rel_err(ct._launch_dgrad(gy, w, dh, dw, pad, (H, W)), want)}
        kb, bn = ct.dgrad_tiles(n, cin)
        want_packed = ct.pack_weights(ct.dgrad_weights(w), bn, kb)
        same = True
        for flat in (0, 1):
            for wgs in (1, 2):
                _, arows, apw = ct.tiling(flat, wgs, H, W, dh, dw)
                # 128-pixel tiles need two halo stages, 64-pixel tiles one
                nsa = wgs
                if ct.smem_bytes(kb, bn, nsa, n, dh * dw, arows, apw) > ct.SMEM_LIMIT:
                    continue
                dx, packed = forced(gy, w, dh, dw, pad, (H, W), flat, wgs)
                errs[f"flat={flat} wgs={wgs}"] = rel_err(dx, want)
                same &= bool((packed.view(torch.int32)
                              == want_packed.view(torch.int32)).all())
        torch.cuda.synchronize()
        t = {"ms": graph_ms(lambda: ct._launch_dgrad(gy, w, dh, dw, pad, (H, W)), 5),
             "earlier_ms": graph_ms(lambda: ct._launch(
                 ct.dgrad_input(gy, dh, dw), ct.dgrad_weights(w), dh, dw), 5),
             "library_ms": graph_ms(tapconv_input_grad_library(
                 gy, w, dh, dw, pad, (H, W)), 5)}
        nbytes = 4 * (gy.numel() + w.numel() + B * H * W * cin)
        bound = max(nbytes / HBM_BYTES_PER_S,
                    2 * B * ho * wo * dh * dw * cin * n / TF32X3_FLOPS_PER_S) * 1e3
        print(f"kernel tapconv_valid_dgrad off the path: dx ({B}, {H}, {W}, {cin}) "
              f"from N {n}, {dh}x{dw}, pad {pad}, plan "
              f"{ct.dgrad_plan(B, H, W, n, cin, dh, dw, ct._sm_count(dev))}: "
              + ", ".join(f"{k} rel_err={v:.3e}" for k, v in errs.items())
              + f"; packing equals pack_weights(dgrad_weights(w)): {same}; "
              + " ".join(f"{k}={v:.4f}" for k, v in t.items())
              + f" bound_ms={bound:.4f} [{card}]", flush=True)
        for k, v in errs.items():
            if not math.isfinite(v) or v > REL_TOL:
                fail(f"tapconv_valid_dgrad ({k}) at dx ({B}, {H}, {W}, {cin}), "
                     f"{dh}x{dw}: error {v:.3e} exceeds {REL_TOL}")
        if not same:
            fail(f"tapconv_pack_dgrad at {dh}x{dw}, Cin {cin}, N {n}: layout "
                 f"differs from pack_weights(dgrad_weights(w))")

    w = randn(7, 7, 4, 2, scale=0.1)
    wt, zero = cc.dgrad_kernel(w), torch.zeros(4, device=dev)
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    for B, H, W in CONV_DGRAD_EXTRA:
        gy = randn(B, H, W, 2)
        want = cc.conv2d_same_small_cout_plain(gy, wt, zero)
        # the same values 8 bytes off a 16-byte line (the tiled body still),
        # and 4 bytes off (the generic body)
        off8 = randn(gy.numel() + 2)[2:].view(gy.shape).copy_(gy)
        off4 = randn(gy.numel() + 1)[1:].view(gy.shape).copy_(gy)
        before = cc.DGRAD.launches
        errs = {"tiled": rel_err(cc._same_conv(gy, wt, zero, dgrad=True), want),
                "8-byte aligned": rel_err(cc._same_conv(off8, wt, zero, dgrad=True), want),
                "4-byte aligned": rel_err(cc._same_conv(off4, wt, zero, dgrad=True), want)}
        torch.cuda.synchronize()
        if cc.DGRAD.launches != before + 3:
            fail(f"conv_same_small_cout_dgrad at {(B, H, W)} did not launch 3 times")
        g_nchw = gy.permute(0, 3, 1, 2).contiguous()
        t = {"ms": graph_ms(lambda: cc._same_conv(gy, wt, zero, dgrad=True), 5),
             "earlier_ms": graph_ms(lambda: cc.launch_conv(gy, wt, zero, cc.GENERIC_TILE), 5),
             "library_ms": graph_ms(lambda: torch.nn.grad.conv2d_input(
                 (B, 4, H, W), w_oihw, g_nchw, padding=3), 5)}
        nbytes = 4 * (gy.numel() + w.numel() + B * H * W * 4)
        bound = max(nbytes / HBM_BYTES_PER_S, 2 * B * H * W * 392 / F32_FLOPS_PER_S) * 1e3
        print(f"kernel conv_same_small_cout_dgrad off the path: g ({B}, {H}, {W}, 2) "
              f"tile {cc.choose_tile(B, H, W, 2, 4)}: "
              + ", ".join(f"{k} rel_err={v:.3e}" for k, v in errs.items()) + "; "
              + " ".join(f"{k}={v:.4f}" for k, v in t.items())
              + f" bound_ms={bound:.4f} [{card}]", flush=True)
        for k, v in errs.items():
            if not math.isfinite(v) or v > REL_TOL:
                fail(f"conv_same_small_cout_dgrad ({k}) at {(B, H, W)}: error "
                     f"{v:.3e} exceeds {REL_TOL}")


def check_real_off_path(dev, bf16=False) -> None:
    """Kernel 2 at the real classes (``bf16``: their bf16 classes) where the
    DR / DRS paths do not take it, against their plain versions (``REL_TOL``;
    at bf16 ``BF16_REL_TOL``, 2^-7 of max |plain|): the real pool and gate
    at ``REAL_GATE_EXTRA``'s shapes (C = 1 and C no multiple of 4 or 8,
    H = 1, W below a tile, odd H and W, batch 32), on x one element off its
    16-byte line, the gate at every R of ``REAL_TILES``; the conv entry at
    (7, 2, 1) and (7, 1, 2) routed, and at float32 forced onto every R (the
    bf16 class's tensor-core body has tiles of its own, which
    ``check_conv_bf16_off_path`` forces). At float32 also on an input one
    float off (the generic body at (7, 2, 1)) and on the generic body
    itself; at bf16 a pooled map one element off its 4-byte pixel, which the
    bf16 class refuses. Every call launches its own class and nothing
    else."""
    import torch

    from dcs_net_tpu_torch.ops import cuda_conv as cc

    dt, tol = (torch.bfloat16, BF16_REL_TOL) if bf16 else (torch.float32, REL_TOL)
    pool_plain = cc.sa_pool_real_bf16_plain if bf16 else cc.sa_pool_real_plain
    gate_plain = cc.sa_gate_real_bf16_plain if bf16 else cc.sa_gate_real_plain
    conv_plain = (cc.conv2d_same_small_cout_bf16_plain if bf16
                  else cc.conv2d_same_small_cout_plain)
    sfx = "_bf16" if bf16 else ""
    label = "real bf16 classes" if bf16 else "real classes"
    g = torch.Generator(device=dev).manual_seed(SEED + (15 if bf16 else 11))

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    w = randn(7, 7, 2, 1, scale=0.3)
    w12 = cc.dgrad_kernel(randn(7, 7, 2, 1, scale=0.3))
    b1 = torch.randn(1, generator=g, device=dev)
    b2 = torch.randn(2, generator=g, device=dev)
    n_conv = 2 * (1 if bf16 else len(REAL_TILES) + 3)
    want_launches = {f"sa_pool_real{sfx}": 3, f"sa_gate_real{sfx}": 3 + len(REAL_TILES),
                     f"conv_same_small_cout{sfx}": n_conv}
    for B, H, W, C in REAL_GATE_EXTRA:
        x = randn(B, H, W, C)
        pooled = pool_plain(x)
        want_gate = gate_plain(pooled, w, x)
        torch.cuda.synchronize()
        before = launch_counts()
        errs = {"pool": rel_err(cc.sa_pool_real(x), pooled),
                "gate": rel_err(cc.sa_gate_real(pooled, w, x), want_gate),
                "pool+gate": rel_err(cc.spatial_gate_real(x, w),
                                     cc.spatial_gate_real_plain(x, w))}
        off = randn(x.numel() + 1)[1:].view(x.shape).copy_(x)
        errs["pool+gate, x one element off"] = rel_err(cc.spatial_gate_real(off, w),
                                                       cc.spatial_gate_real_plain(x, w))
        for tile in REAL_TILES:
            errs[f"gate {tile}"] = rel_err(cc.sa_gate_real(pooled, w, x, tile), want_gate)
        for cls, xin, wk, bk in (((7, 2, 1), pooled, w, b1),
                                 ((7, 1, 2), pooled[..., :1].contiguous(), w12, b2)):
            want = conv_plain(xin, wk, bk)
            errs[f"conv {cls} routed"] = rel_err(cc.conv2d_same_small_cout(xin, wk, bk), want)
            if not bf16:
                for tile in REAL_TILES:
                    errs[f"conv {cls} {tile}"] = rel_err(cc.launch_conv(xin, wk, bk, tile),
                                                         want)
                offx = randn(xin.numel() + 1)[1:].view(xin.shape).copy_(xin)
                errs[f"conv {cls} x one float off"] = rel_err(
                    cc.conv2d_same_small_cout(offx, wk, bk), want)
                errs[f"conv {cls} generic"] = rel_err(
                    cc.launch_conv(xin, wk, bk, cc.GENERIC_TILE), want)
        if bf16:
            offp = randn(pooled.numel() + 1)[1:].view(pooled.shape).copy_(pooled)
            try:
                cc.conv2d_same_small_cout(offp, w, b1)
                fail(f"the conv entry's bf16 class took a pooled map off its 4-byte pixel "
                     f"at {(B, H, W)}")
            except ValueError:
                pass
        torch.cuda.synchronize()
        after = launch_counts()
        got = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
        if got != want_launches:
            fail(f"kernel 2's {label} at {(B, H, W, C)}: launches {got}, expected "
                 f"{want_launches}")
        worst = max(errs, key=errs.get)
        print(f"kernel 2 {label} off the path: x ({B}, {H}, {W}, {C}), gate tile "
              f"{cc.gate_tile(B, H, W, 2, 1)}, conv tiles {cc.choose_tile(B, H, W, 2, 1)} / "
              f"{cc.choose_tile(B, H, W, 1, 2)}: {len(errs)} checks, worst {worst} "
              f"rel_err={errs[worst]:.3e}; pool {errs['pool']:.3e}, gate "
              f"{errs['gate']:.3e}, pool+gate {errs['pool+gate']:.3e}", flush=True)
        for k, v in errs.items():
            if not math.isfinite(v) or v > tol:
                fail(f"kernel 2 {label} ({k}) at {(B, H, W, C)}: error {v:.3e} exceeds "
                     f"{tol}")


def compare_card_cpu(what: str, on_card, on_cpu) -> None:
    diff = (on_card - on_cpu).abs()
    bad = int((diff > SLICE_ATOL + SLICE_RTOL * on_cpu.abs()).sum())
    print(f"{what} card vs CPU: max |diff| {float(diff.max()):.3e}, "
          f"{bad} samples outside atol {SLICE_ATOL} rtol {SLICE_RTOL}", flush=True)
    if bad:
        fail(f"card and CPU disagree on {what}")


def launch_counts():
    from dcs_net_tpu_torch.utils import cuda_lib

    return {k.name: k.launches for k in cuda_lib.KERNELS.values() if k.launches}


def counted(launches) -> int:
    """Launches of distinct kernels: an entry point counted with another
    (the gate, counted as the conv entry too) once."""
    from dcs_net_tpu_torch.utils import cuda_lib

    return sum(n for name, n in launches.items()
               if cuda_lib.KERNELS[name].counted_with is None)


def median_ms(fn, reps):
    """The median of ``reps`` calls of ``fn``, host clock, each ended by a
    synchronize."""
    import torch

    walls = []
    for _ in range(reps):
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    walls.sort()
    return walls[reps // 2]


def check_graphed(what, run, replay_launches, card, cpu_case=None, reps=5,
                  compare=compare_card_cpu, profile=("graphed", "eager")):
    """One path through ``models/graphed.py`` against its eager version on
    the card. ``run(graphs)`` returns a tensor on the card (eager where
    ``graphs`` is None); ``replay_launches`` are the launches a replay of its
    one graph must make, counted at the capture. With cuDNN's deterministic
    algorithms on both sides: three graphed calls (the warm-up, the capture,
    replays) equal to eager bit for bit; under cuDNN's defaults the largest
    graphed-eager difference, printed. ``cpu_case`` = (run_short, want):
    ``run_short(graphs)`` after its capture against the CPU's ``want`` by
    ``compare`` (the slice's band). Prints ms a call graphed and eager (median of ``reps``), a
    replay's launches, capture seconds and the pool; then, each from a
    profiler window that lost no kernel records (``profiled_whole``), a
    graphed and an eager call's busy time and idle share (those of
    ``profile``), the port's kernels in each held to the eager call's launch
    counts."""
    import torch

    from dcs_net_tpu_torch.models.graphed import GraphCache
    from dcs_net_tpu_torch.utils import cuda_lib
    from dcs_net_tpu_torch.utils.timing import profiled_whole

    loose = GraphCache()
    eager = run(None)
    for _ in range(3):
        graphed = run(loose)
    d_default = float((graphed - eager).abs().max())
    del loose, graphed
    torch.backends.cudnn.deterministic = True
    try:
        run(None)
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        eager = run(None)
        torch.cuda.synchronize()
        eager_launches = launch_counts()
        graphs = GraphCache()
        outs = [run(graphs) for _ in range(3)]
        (entry,) = graphs.entries.values()
        same = [bool(torch.equal(o, eager)) for o in outs]
        d_det = max(float((o - eager).abs().max()) for o in outs)
        if entry.launches != replay_launches:
            fail(f"{what}: a replay's launches {entry.launches} (counted at the "
                 f"capture), expected {replay_launches}")
        eager_ms = median_ms(lambda: run(None), reps)
        graph_ms = median_ms(lambda: run(graphs), reps)
        if cpu_case is not None:
            run_short, want = cpu_case
            short = GraphCache()
            for _ in range(3):
                got = run_short(short)
            compare(f"{what}, graphed", got.cpu(), want)
        # up to 12 windows: a window of the eager carried stream (28k
        # launches) loses the records of some of its first launches, by how
        # many varies (``tools/profile_windows.py --carried``), and once in a
        # few calls no two of 6 windows agreed; a call whose count holds
        # stops at the second window with it
        windows = {how: profiled_whole(lambda: run(g), tries=12) for how, g in
                   (("graphed", graphs), ("eager", None)) if how in profile}
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"graphed: {what}: graphed == eager bit for bit {same} (max |diff| "
          f"{d_det:.3e}; under cuDNN's default algorithms {d_default:.3e}); "
          f"{graph_ms:.2f} ms a call graphed against {eager_ms:.2f} eager (median of "
          f"{reps}); a replay's launches {entry.launches} ({counted(entry.launches)} "
          f"kernels), the eager call's {counted(eager_launches)}; capture "
          f"{entry.capture_s:.3f} s, pool {entry.pool_bytes} bytes [{card}]", flush=True)
    if not all(same):
        fail(f"{what}: graphed and eager differ by {d_det:.3e} under cuDNN's "
             "deterministic algorithms")
    medians = {"graphed": graph_ms, "eager": eager_ms}
    for how, (window, taken) in windows.items():
        if window is None:
            fail(f"{what}: no two of {taken} profiler windows of a {how} call agreed "
                 "on its kernel count")
        wall, busy, n, kernels = window
        ours = port_launches(kernels)
        print(f"graphed: {what}: {how} busy {busy:.2f} ms, idle share "
              f"{1 - busy / medians[how]:.3f} of the median {medians[how]:.2f} ms "
              f"({1 - busy / wall:.3f} under the profiler, wall {wall:.2f} ms); "
              f"{n} device kernels, {ours} of the port's, in the first of {taken} "
              f"windows with the call's count [{card}]", flush=True)
        if ours != counted(eager_launches):
            fail(f"{what}: the profiler saw {ours} launches of the port's kernels in a "
                 f"{how} call, the eager call counted {counted(eager_launches)}")


def check_keep_alive(model, cfg, dev, card, others=20):
    """A graph's device constants outlive the caches that made them: a DCS
    request at batch 1 captured at length A, then ``others`` other lengths
    (more than ``_inv_window_envelope``'s 16) each warmed up and captured
    through the same cache, then A replayed: equal to A's eager output bit
    for bit (cuDNN's deterministic algorithms)."""
    import torch

    from dcs_net_tpu_torch.dsp import stft as dsp
    from dcs_net_tpu_torch.models.enhance import _enhance_full, enhance_full
    from dcs_net_tpu_torch.models.graphed import GraphCache

    lengths = [SR + 160 * i for i in range(others + 1)]
    waves = {n: torch.from_numpy(speech_like(1, n, SEED + 40 + i)).to(dev)
             for i, n in enumerate(lengths)}
    torch.backends.cudnn.deterministic = True
    try:
        graphs = GraphCache()
        a = lengths[0]
        want = enhance_full(model, waves[a], cfg)
        for _ in range(2):
            enhance_full(model, waves[a], cfg, graphs=graphs)
        for n in lengths[1:]:
            for _ in range(2):
                enhance_full(model, waves[n], cfg, graphs=graphs)
        got = enhance_full(model, waves[a], cfg, graphs=graphs)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    entry = graphs.entry(_enhance_full, waves[a], model=model, cfg=cfg)
    env = dsp._inv_window_envelope.cache_info()
    d = float((got - want).abs().max())
    print(f"graphed: keep-alive: a 1 s request captured, then {others} other lengths "
          f"captured in the same cache ({len(graphs)} entries; the envelope cache "
          f"{env.currsize} of {env.maxsize} held, {env.misses} misses), then replayed: "
          f"max |replay - eager| {d:.3e}, {entry.replays} replays [{card}]", flush=True)
    if not bool(torch.equal(got, want)) or entry.replays != 2:
        fail("keep-alive: the replay after other lengths is not the eager output")


def check_streaming(model, cpu_model, cfg, dev, card):
    """Phase "stream". Returns the kernel shapes and launch counts of the
    30 s streaming call."""
    import dataclasses

    import torch

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.models.enhance import enhance_full, enhance_streaming
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.utils import cuda_lib

    # (a) one 30 s request through the default (bidirectional) model
    seconds, chunk, overlap, group = 30, 256, 64, 8
    x = torch.from_numpy(speech_like(1, seconds * SR, SEED + 5)).to(dev)
    frames = 1 + seconds * SR // cfg.stft.hop
    n_chunks = max(1, math.ceil(max(frames - overlap, 1) / (chunk - overlap)))
    n_groups = -(-n_chunks // group)
    shapes = discover_shapes(lambda: enhance_streaming(model, x, cfg))
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t1 = time.perf_counter()
    out = enhance_streaming(model, x, cfg, chunk_frames=chunk, overlap=overlap,
                            chunk_batch=group)
    torch.cuda.synchronize()
    t_call = time.perf_counter() - t1
    launches = {k.name: k.launches for k in cuda_lib.KERNELS.values()}
    print(f"stream: enhance_streaming, {seconds} s, {n_chunks} chunks of {chunk} "
          f"frames in {n_groups} groups: launches {launches}", flush=True)
    if tuple(out.shape) != (1, seconds * SR) or not bool(torch.isfinite(out).all()):
        fail(f"enhance_streaming returned {tuple(out.shape)} or non-finite samples")
    want = {"stft": 1, "sa_pool": 13 * n_groups, "sa_gate": 13 * n_groups,
            "conv_same_small_cout": 13 * n_groups, "tapconv_valid": 7 * n_groups,
            "tapconv_pack": 7 * n_groups}
    for name, n in want.items():
        if launches.get(name, 0) != n:
            fail(f"kernel {name} launched {launches.get(name, 0)} times in the "
                 f"streaming call, expected {n}")
    reps = 3
    t1 = time.perf_counter()
    for _ in range(reps):
        enhance_streaming(model, x, cfg, chunk_frames=chunk, overlap=overlap,
                          chunk_batch=group)
    torch.cuda.synchronize()
    t_steady = (time.perf_counter() - t1) / reps
    print(f"stream: 1 request x {seconds} s: counted call {t_call * 1e3:.1f} ms, "
          f"steady {t_steady * 1e3:.1f} ms per call, {seconds / t_steady:.1f} "
          f"audio-s/s [{card}]", flush=True)
    short = torch.from_numpy(speech_like(1, 3 * SR, SEED + 6))
    cpu_short = enhance_streaming(cpu_model, short, cfg)
    compare_card_cpu("stream: 3 s request (8 chunks of 256, overlap 64: one group)",
                     enhance_streaming(model, short.to(dev), cfg).cpu(), cpu_short)
    # every group of G * B = 8 chunks one replay of one graph
    check_graphed(f"stream: DCS enhance_streaming, {seconds} s, {n_groups} groups of "
                  f"{group}", lambda g, model=model, x=x, cfg=cfg: enhance_streaming(
                      model, x, cfg, chunk_frames=chunk, overlap=overlap,
                      chunk_batch=group, graphs=g), DCS_EVAL_FORWARD, card,
                  (lambda g: enhance_streaming(model, short.to(dev), cfg, graphs=g),
                   cpu_short))

    # (b) the LSTM carry. Chunked == full pass only where every other op is
    # chunk-local, so exactness is held on a full-width model with 1x1 convs
    # and no attention; the streaming preset itself is held to finiteness, to
    # its closeness to the full pass (printed) and to the CPU.
    scfg = config_for_variant("dcs", streaming=True)
    local = scfg.replace(model=dataclasses.replace(
        scfg.model, kernel_e=(1,) * 7, kernel_d=(1,) * 7, sa_kernel=1,
        attention=False))
    secs = CARRY_SECONDS
    xc = torch.from_numpy(speech_like(1, secs * SR, SEED + 7)).to(dev)
    exact = DCSNet(local.model, local.quirks, device=dev, seed=SEED + 1).eval()
    perturb_bn(exact, SEED + 2)
    full = enhance_full(exact, xc, local)
    carried = enhance_streaming(exact, xc, local, chunk_frames=chunk, overlap=0,
                                carry_lstm_state=True)
    restart = enhance_streaming(exact, xc, local, chunk_frames=chunk, overlap=0,
                                chunk_batch=1)
    d_carry = float((carried - full).abs().max())
    d_restart = float((restart - full).abs().max())
    print(f"stream: carry, {secs} s in {math.ceil((1 + secs * SR // 32) / chunk)} chunks, "
          f"chunk-local ops (1x1 convs, no attention): max |chunked - full| "
          f"{d_carry:.3e} (limit 1e-4; without the carry {d_restart:.3e}), "
          f"max |full| {float(full.abs().max()):.3f}", flush=True)
    if not d_carry <= 1e-4:
        fail("chunks that carry the LSTM state do not reproduce the full pass")
    del exact

    smodel = DCSNet(scfg.model, scfg.quirks, device=dev, seed=SEED).eval()
    perturb_bn(smodel, SEED + 1)
    cuda_lib.reset_launch_counts()
    full = enhance_full(smodel, xc, scfg)
    carried = enhance_streaming(smodel, xc, scfg, chunk_frames=chunk, overlap=0,
                                carry_lstm_state=True)
    torch.cuda.synchronize()
    if tuple(carried.shape) != (1, secs * SR) or not bool(torch.isfinite(carried).all()):
        fail("the carried stream of the streaming preset is not finite")
    corr = float(torch.corrcoef(torch.stack([full[0], carried[0]]))[0, 1])
    print(f"stream: carry, streaming preset (attention on, 3x3 to 7x7 convs), "
          f"{secs} s: finite, correlation with the full pass {corr:.4f}, max "
          f"|chunked - full| {float((carried - full).abs().max()):.3e}", flush=True)
    scpu = DCSNet(scfg.model, scfg.quirks, device="cpu", seed=SEED)
    scpu.load_state_dict({k: v.cpu() for k, v in smodel.state_dict().items()})
    short = torch.from_numpy(speech_like(1, 2 * SR, SEED + 8))
    kw = dict(chunk_frames=64, overlap=0, carry_lstm_state=True)
    cpu_short = enhance_streaming(scpu, short, scfg, **kw)
    compare_card_cpu("stream: carry, 2 s request (16 chunks of 64)",
                     enhance_streaming(smodel, short.to(dev), scfg, **kw).cpu(), cpu_short)
    # every chunk one replay of one graph, its LSTM state in and out
    check_graphed(f"stream: carry, streaming preset, {secs} s in chunks of 256",
                  lambda g, m=smodel, x=xc, c=scfg: enhance_streaming(
                      m, x, c, chunk_frames=chunk, overlap=0, carry_lstm_state=True,
                      graphs=g),
                  DCS_EVAL_FORWARD, card,
                  (lambda g: enhance_streaming(smodel, short.to(dev), scfg, **kw, graphs=g),
                   cpu_short))
    return shapes, launches


def check_request(model, cfg, dev, card):
    """One request of 4 s at batch 1, ``enhance_full`` as ``cli/enhance.py``
    calls it: its launches (kernel 3 7 + 7, the counts reset just before and
    read just after) and kernel 3's row ``tapconv_valid_request`` at its
    shapes."""
    import torch

    from dcs_net_tpu_torch.models.enhance import enhance_full
    from dcs_net_tpu_torch.utils import cuda_lib

    x = torch.from_numpy(speech_like(1, SECONDS * SR, SEED + 19)).to(dev)
    shapes = discover_shapes(lambda: enhance_full(model, x, cfg))
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    out = enhance_full(model, x, cfg)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in cuda_lib.KERNELS.values()}
    print(f"request: enhance_full, 1 request x {SECONDS} s: launches {launches}", flush=True)
    if tuple(out.shape) != (1, SECONDS * SR) or not bool(torch.isfinite(out).all()):
        fail(f"enhance_full at batch 1 returned {tuple(out.shape)} or non-finite samples")
    for name in ("tapconv_valid", "tapconv_pack"):
        if launches.get(name, 0) != 7:
            fail(f"kernel {name} launched {launches.get(name, 0)} times in one "
                 f"request, expected 7")
    return check_kernels({"tapconv_valid": shapes["tapconv_valid"]}, launches, dev, cfg,
                         card, f"{SECONDS} s request", "_request")


def check_function_grads(shapes, dev, cfg) -> None:
    """The three Functions at every shape of the train step, forward output
    and input and weight gradients (``torch.autograd.grad``), against their
    plain versions under autograd on the card."""
    import torch
    import torch.nn.functional as F

    from dcs_net_tpu_torch.dsp import stft as dsp
    from dcs_net_tpu_torch.dsp import stft_cuda
    from dcs_net_tpu_torch.ops import cuda_conv, cuda_tapconv

    g = torch.Generator(device=dev).manual_seed(SEED + 12)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).requires_grad_()

    def check(name, args, fn, plain, inputs):
        ys = fn(*inputs)
        ys = ys if isinstance(ys, tuple) else (ys,)
        gys = [torch.randn(t.shape, generator=g, device=dev) for t in ys]
        got = torch.autograd.grad(ys, inputs, gys)
        yps = plain(*inputs)
        yps = yps if isinstance(yps, tuple) else (yps,)
        want = torch.autograd.grad(yps, inputs, gys)
        torch.cuda.synchronize()
        errs = [rel_err([y.detach() for y in ys], [y.detach() for y in yps])]
        errs += [rel_err(a, b) for a, b in zip(got, want)]
        print(f"train: {name} args={args} forward rel_err={errs[0]:.3e}, gradients "
              f"rel_err=" + ", ".join(f"{e:.3e}" for e in errs[1:]), flush=True)
        if not all(math.isfinite(e) and e <= REL_TOL for e in errs):
            fail(f"{name} at {args}: forward or gradient error {max(errs):.3e} "
                 f"relative to max |plain| exceeds {REL_TOL}")

    for args in sorted(set(shapes["conv_same_small_cout"])):
        B, H, W, cin, K, cout = args[:6]
        check("conv_same_small_cout", args, cuda_conv.conv2d_same_small_cout,
              cuda_conv.conv2d_same_small_cout_plain,
              (randn(B, H, W, cin), randn(K, K, cin, cout, scale=0.1), randn(cout)))
    # the tap conv as the decoder calls it, x and its padding, at the shapes
    # of the step's input-gradient launches
    for args in sorted(set(shapes["tapconv_valid_dgrad"])):
        B, ho, wo, n, H, W, cin, dh, dw, top, left = args[:11]
        pad = (top, ho - H - top + dh - 1, left, wo - W - left + dw - 1)
        check("tapconv_valid", args,
              lambda x, w: cuda_tapconv.tapconv_valid(x, w, dh, dw, pad),
              lambda x, w: cuda_tapconv.tapconv_valid_plain(
                  F.pad(x, (0, 0, pad[2], pad[3], pad[0], pad[1])), w, dh, dw),
              (randn(B, H, W, cin), randn(dh * dw, cin, n, scale=1 / math.sqrt(dh * dw * cin))))
    for args in sorted(set(shapes["stft"])):
        B, n, n_fft, hop, center = args[:5]
        cos_b, sin_b = dsp._on_device(dsp._dft_basis_eff, cfg.stft, dev)
        pad = n_fft // 2 if center else 0
        check("stft", args, lambda x: dsp.STFT.apply(x, cfg.stft),
              lambda x: stft_cuda.stft_dft_plain(x, cos_b, sin_b, hop, pad),
              (randn(B, n, scale=0.3),))


def time_weight_grads(shapes, dev, card) -> None:
    """The weight-gradient contractions of kernels 2 and 3 at the train
    step's shapes (PyTorch matmuls, as the JAX package leaves them to XLA),
    summed over one step, beside ``torch.nn.grad.conv2d_weight`` and the
    card's bound for the same work (x and g read, dw written; the forward's
    operations at the float32 rate)."""
    import torch

    from dcs_net_tpu_torch.ops import cuda_conv, cuda_tapconv
    from dcs_net_tpu_torch.utils.timing import graph_ms

    g = torch.Generator(device=dev).manual_seed(SEED + 14)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    for name, calls in (("conv_same_small_cout", shapes["conv_same_small_cout"]),
                        ("tapconv_valid", shapes["tapconv_valid"])):
        tot = {"ms": 0.0, "library_ms": 0.0, "bytes": 0, "flops": 0}
        for args in calls:
            if name == "conv_same_small_cout":
                B, H, W, cin, K, cout = args[:6]
                x, gy = randn(B, H, W, cin), randn(B, H, W, cout)
                ours = lambda: cuda_conv.weight_grad(x, gy, K)  # noqa: E731
                wshape, pad, (dh, dw) = (cout, cin, K, K), K // 2, (K, K)
                ho, wo = H, W
            else:
                B, H, W, cin, ho, wo, cout, dh, dw = args[:9]
                top, bottom, left, right = tapconv_pad(args)
                x = randn(B, H + top + bottom, W + left + right, cin)
                gy = randn(B, ho, wo, cout)
                ours = lambda: cuda_tapconv.weight_grad(x, gy, dh, dw)  # noqa: E731
                wshape, pad = (cout, cin, dh, dw), 0
            x_nchw = x.permute(0, 3, 1, 2).contiguous()
            g_nchw = gy.permute(0, 3, 1, 2).contiguous()
            lib = lambda: torch.nn.grad.conv2d_weight(  # noqa: E731
                x_nchw, wshape, g_nchw, padding=pad)
            tot["ms"] += graph_ms(ours, 10)
            tot["library_ms"] += graph_ms(lib, 10)
            tot["bytes"] += 4 * (x.numel() + gy.numel() + dh * dw * cin * cout)
            tot["flops"] += 2 * B * ho * wo * dh * dw * cin * cout
        bound = max(tot["bytes"] / HBM_BYTES_PER_S, tot["flops"] / F32_FLOPS_PER_S) * 1e3
        print(f"train: weight gradient of {name} (the patch matrix's "
              f"product): {len(calls)} per train step, summed ms={tot['ms']:.4f} library_ms="
              f"{tot['library_ms']:.4f} (torch.nn.grad.conv2d_weight) bound_ms="
              f"{bound:.4f} [{card}]", flush=True)


def outside_band(got, want):
    """(outside, excess, mean drift, max |diff|) of ``got`` against the
    oracle band of ``want``, all relative to max |want|."""
    scale = float(want.abs().max())
    a, b = got / scale, want / scale
    excess = float(((a - b).abs() - (2.5e-3 + 5e-3 * b.abs())).max())
    drift = float((a - b).abs().mean())
    return excess > 0 or drift >= 3e-4, excess, drift, float((a - b).abs().max())


def _leaf_checks(what, card_model, cpu_model, card_grads, cpu_grads,
                 witness=None) -> None:
    """Every gradient leaf in the band of the JAX oracle test (rtol 5e-3 /
    atol 2.5e-3 of the leaf max, mean drift < 3e-4; a leaf under 1e-5 of the
    largest gradient is rounding residue of an exact zero and is held under
    it on both sides); the post-Adam parameters within that test's
    sensitivity bound; the BN running statistics in the band. ``witness``
    (leaf name -> check) names the leaves that no float32 run resolves to
    the band, each held by its own check instead (``bn_witness``)."""
    import torch

    witness = witness or {}
    floor = 1e-5 * max(float(g.abs().max()) for g in cpu_grads.values())
    lr, eps = 1e-4, 1e-6
    worst_band = worst_drift = worst_param = 0.0
    for name, want in cpu_grads.items():
        got = card_grads[name].cpu()
        if name in witness:
            witness[name](got, want)
            continue
        if float(want.abs().max()) < floor:
            if float(got.abs().max()) >= floor:
                fail(f"{what}: gradient {name} is not zero up to rounding on the card")
            continue
        bad, excess, drift, rel = outside_band(got, want)
        if bad:
            fail(f"{what}: gradient {name} outside the band (excess {excess:.3e}, "
                 f"mean drift {drift:.3e})")
        worst_band, worst_drift = max(worst_band, rel), max(worst_drift, drift)
    card_state, cpu_state = card_model.state_dict(), cpu_model.state_dict()
    for name, want in cpu_state.items():
        got = card_state[name].cpu()
        if name in cpu_grads:
            gabs = cpu_grads[name].abs()
            if float(gabs.max()) < floor:
                allowed = torch.full_like(gabs, 3e-5 + 2 * lr)
            else:
                delta = 5e-3 * gabs + 2.5e-3 * float(gabs.max())
                allowed = 3e-5 + lr * torch.clamp(delta / (gabs + eps), max=2.0)
            excess = float(((got - want).abs() - allowed).max())
            worst_param = max(worst_param, float((got - want).abs().max()))
        else:
            scale = max(float(want.abs().max()), 1e-12)
            excess = float(((got - want).abs() / scale
                            - (2.5e-3 + 5e-3 * want.abs() / scale)).max())
        if excess > 0:
            fail(f"{what}: post-step {name} differs by {excess:.3e} beyond its bound")
    print(f"{what}: {len(cpu_grads) - len(witness)} gradient leaves within the band "
          f"(max |diff| / leaf max {worst_band:.3e}, mean drift {worst_drift:.3e}), "
          f"{len(witness)} held by their float64 witness ({', '.join(witness) or 'none'}), "
          f"post-Adam parameters within the sensitivity bound (max |diff| "
          f"{worst_param:.3e}), BN statistics within the band", flush=True)


def capture_bn(model, bn):
    """A hook on ``model.<bn>``: the dict it returns gets the module's input
    ``x`` and the gradient ``dy`` at its output, and counts its calls."""
    got = {"calls": 0}

    def hook(mod, inputs, out):
        got["calls"] += 1
        got["x"] = inputs[0].detach()
        out.register_hook(lambda g: got.__setitem__("dy", g.detach()))

    getattr(model, bn).register_forward_hook(hook)
    return got


def bn_witness(what, bn, eps, io_card, clip_card, float64_step):
    """Checks for the two gradient leaves of the one-channel real BN ``bn``,
    which no float32 run resolves to the oracle band.

    With y = (x - mean) r scale + bias and r = 1 / sqrt(var + eps) the
    leaves are sums over every pixel, d bias = sum dy and d scale =
    sum dy (x - mean) r, that cancel to a small part of their terms (the
    next BN normalises the scale away but for its eps). So each is held in
    two parts against ``float64_step()``, the same step on the CPU in
    float64, which returns its clipped gradients, its ``capture_bn`` and its
    clip factor: (1) the card's dy, the gradient arriving at the BN's
    output, lies element by element in the oracle band of the float64 dy;
    (2) the card's leaf equals the same sum of its own dy and x taken in
    float64, within the rounding of a float32 sum, ceil(log2 n) units of
    2^-24 of the magnitudes it adds (the pairwise-summation bound; for the
    scale r (sum |dy x| + |mean| sum |dy|), the two sums autograd forms).
    The float64 leaf, the card's, the float32 CPU's and the leaf's
    condition (sum of |terms| over |sum|) print."""
    import torch

    state = {}

    def parts():
        if not state:
            grads64, io64, clip64 = float64_step()
            if io_card["calls"] != 1 or io64["calls"] != 1:
                fail(f"{what}: {bn} ran {io_card['calls']} / {io64['calls']} times "
                     f"in one step")
            dy = io_card["dy"].cpu().double() * clip_card
            dy64 = io64["dy"] * clip64
            bad, excess, drift, rel = outside_band(dy, dy64)
            print(f"{what}: the gradient at {bn}'s output {tuple(dy.shape)}, card vs "
                  f"float64 CPU: max |diff| / max {rel:.3e}, mean drift {drift:.3e}",
                  flush=True)
            if bad:
                fail(f"{what}: the gradient at {bn}'s output is outside the band of "
                     f"the float64 step (excess {excess:.3e}, mean drift {drift:.3e})")
            state.update(grads64=grads64, card=(dy, io_card["x"].cpu().double()),
                         cpu64=(dy64, io64["x"]))
        return state

    def sums(dy, x, leaf):
        """(the leaf, the magnitudes its float32 backward adds)"""
        if leaf == "bias":
            return float(dy.sum()), float(dy.abs().sum())
        var, mean = torch.var_mean(x, correction=0)
        r = 1.0 / torch.sqrt(var + eps)
        return (float((dy * (x - mean)).sum() * r),
                float(r * ((dy * x).abs().sum() + mean.abs() * dy.abs().sum())))

    def check(leaf):
        name = f"{bn}.{leaf}"

        def held(got, want):
            st = parts()
            ref, mag = sums(*st["card"], leaf)
            ref64, mag64 = sums(*st["cpu64"], leaf)
            n = st["card"][0].numel()
            tol = math.ceil(math.log2(n)) * 2.0 ** -24 * mag
            card = float(got)
            print(f"{what}: gradient {name}: float64 CPU "
                  f"{float(st['grads64'][name]):.9e}, card {card:.9e}, float32 CPU "
                  f"{float(want):.9e}; the card's dy and x summed in float64 "
                  f"{ref:.9e}, |card - that| {abs(card - ref):.3e} = "
                  f"{abs(card - ref) / (2.0 ** -24 * mag):.2f} units of 2^-24 of the "
                  f"magnitudes ({n} terms, allowed {tol:.3e}); condition "
                  f"{mag64 / max(abs(ref64), 1e-300):.3e}", flush=True)
            if not abs(card - ref) <= tol:
                fail(f"{what}: gradient {name} on the card is not the sum of its own "
                     f"terms ({card:.9e} vs {ref:.9e}, allowed {tol:.3e})")
        return held

    return {f"{bn}.scale": check("scale"), f"{bn}.bias": check("bias")}


def run_cli(module, args, timeout=600, env=None):
    """``python -m dcs_net_tpu_torch.cli.<module> <args>`` in a subprocess
    from the repository root, ``env`` added to its environment; returns its
    stdout and wall seconds, fails on a non-zero exit."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **(env or {}), PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", f"dcs_net_tpu_torch.cli.{module}", *args]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        print(r.stdout[-3000:], r.stderr[-3000:], flush=True)
        fail(f"cli.{module} exited {r.returncode}: {' '.join(cmd[2:])}")
    return r.stdout, time.perf_counter() - t0


def run_trainer(tmp, epochs, resume, card, flags=(), n_pairs=TRAIN_N_SYNTHETIC,
                steps=TRAIN_STEPS, data_root=None, env=None, variant="dcs"):
    """``python -m dcs_net_tpu_torch.cli.train <variant>`` in a subprocess, on
    ``n_pairs`` synthetic pairs of its own or the tree at ``data_root``:
    returns its stdout and final metrics. A run whose steps per dispatch K >
    1 must capture its CUDA graph and replay it (``graph_replays`` in its
    final metrics)."""
    import ast

    data = (["--data-root", data_root] if data_root
            else ["--synthetic", "--synthetic-n", str(n_pairs)])
    args = [variant, *data, "--batch-size", str(TRAIN_BATCH), "--limit-train-batches",
            str(steps), "--epochs", str(epochs), "--log-dir", tmp, *flags] + (
        ["--resume"] if resume else [])
    stdout, wall = run_cli("train", args, env=env)
    final = [ln for ln in stdout.splitlines() if ln.startswith("final: ")]
    if not final:
        fail("the trainer printed no final metrics")
    metrics = ast.literal_eval(final[-1][len("final: "):])
    # the epoch line ends with the epoch's seconds: train steps, validation
    epoch_s = [ln.rsplit("(", 1)[-1].rstrip("s)") for ln in stdout.splitlines()
               if ln.startswith("epoch ") and ln.endswith("s)")]
    print(f"train: cli {' '.join(args)}: exit 0 in {wall:.1f} s (last epoch "
          f"{epoch_s[-1] if epoch_s else '?'} s), {metrics} [{card}]", flush=True)
    k = int(next(ln for ln in stdout.splitlines() if ln.startswith("variant="))
            .rsplit("steps_per_dispatch=", 1)[1])
    captures = [ln for ln in stdout.splitlines() if ln.startswith("graph: captured")]
    for ln in captures:
        print(f"train: {ln}", flush=True)
    if k > 1 and not (captures and metrics.get("graph_replays", 0) >= 1):
        fail(f"the trainer at {k} steps a dispatch never replayed a graph: {metrics}")
    return stdout, metrics


def card_vs_cpu_step(what, cfg, noisy, clean, dev, seed, witness_bn=None) -> None:
    """One train step at batch ``CARD_CPU_BATCH``, dropout off, on the card
    and on the CPU from the same weights: loss and gradient norm rtol 1e-3,
    every gradient leaf and the post-Adam parameters as ``_leaf_checks``;
    the real BN ``witness_bn``'s two leaves as ``bn_witness``, against the
    same step in float64 on the CPU."""
    import dataclasses

    import torch

    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.train import steps
    from dcs_net_tpu_torch.train.optim import make_optimizer

    ncfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout_conv=0.0,
                                                 dropout_fc=0.0))
    on_card = DCSNet(ncfg.model, ncfg.quirks, device=dev, seed=seed)
    on_cpu = DCSNet(ncfg.model, ncfg.quirks, device="cpu", seed=seed)
    weights = {k: v.cpu().clone() for k, v in on_card.state_dict().items()}
    on_cpu.load_state_dict(weights)
    io_card = capture_bn(on_card, witness_bn) if witness_bn else None

    def clip(norm):
        return min(1.0, ncfg.optim.clip_norm / (norm + 1e-6))

    def float64_step():
        """The CPU's gradients in float64 from the same weights and waves,
        clipped as ``train_step`` clips them, its capture and clip factor."""
        m = DCSNet(ncfg.model, ncfg.quirks, device="cpu", seed=seed).double()
        m.load_state_dict(weights)
        io = capture_bn(m, witness_bn)
        names = [n for n, p in m.named_parameters() if p.requires_grad]
        batch = steps.batch_from_waves(noisy[:CARD_CPU_BATCH].cpu().double(),
                                       clean[:CARD_CPU_BATCH].cpu().double(), ncfg)
        t1 = time.perf_counter()
        grads = steps.loss_and_grads(m, batch, ncfg)[1]
        norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(t) for t in grads])))
        print(f"{what}: the float64 CPU step took {time.perf_counter() - t1:.1f} s, "
              f"grad norm {norm:.6f}", flush=True)
        return {n: t * clip(norm) for n, t in zip(names, grads)}, io, clip(norm)

    results = []
    for m, d in ((on_card, dev), (on_cpu, torch.device("cpu"))):
        o = make_optimizer(m.parameters(), ncfg.optim)
        t1 = time.perf_counter()
        r = steps.train_step(m, o, steps.batch_from_waves(
            noisy[:CARD_CPU_BATCH].to(d), clean[:CARD_CPU_BATCH].to(d), ncfg), ncfg)
        results.append(({k: float(v) for k, v in r.items()},
                        {n: p.grad.detach().clone() for n, p in m.named_parameters()},
                        time.perf_counter() - t1))
    (card_out, card_grads, _), (cpu_out, cpu_grads, cpu_s) = results
    print(f"{what}: batch {CARD_CPU_BATCH}, dropout off, card vs CPU: loss "
          f"{card_out['loss']:.6f} vs {cpu_out['loss']:.6f}, grad norm "
          f"{card_out['grad_norm']:.6f} vs {cpu_out['grad_norm']:.6f} (CPU step "
          f"{cpu_s:.1f} s)", flush=True)
    for k in ("loss", "grad_norm"):
        if not abs(card_out[k] - cpu_out[k]) <= 1e-3 * abs(cpu_out[k]):
            fail(f"{what} step card vs CPU: {k} {card_out[k]} vs {cpu_out[k]}")
    witness = None if witness_bn is None else bn_witness(
        f"{what}: card vs CPU", witness_bn, getattr(on_card, witness_bn).eps, io_card,
        clip(card_out["grad_norm"]), float64_step)
    _leaf_checks(f"{what}: card vs CPU", on_card, on_cpu, card_grads, cpu_grads,
                 witness)


def serve_checkpoint(ckpt_dir, card) -> None:
    """``python -m dcs_net_tpu_torch.cli.enhance dcs --ckpt-dir`` on a 1 s
    wav at 16 kHz, on the card, against ``enhance_full`` of the checkpoint's
    weights on the CPU (the PCM16 wav's rounding is inside the band)."""
    import torch

    from dcs_net_tpu_torch.core.config import Config
    from dcs_net_tpu_torch.data.audio_io import read_wav, write_wav
    from dcs_net_tpu_torch.models.enhance import enhance_full
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.train.checkpoint import load_model

    src, dst = os.path.join(ckpt_dir, "noisy.wav"), os.path.join(ckpt_dir, "served.wav")
    write_wav(src, speech_like(1, SR, SEED + 16)[0], SR)
    stdout, wall = run_cli("enhance", ["dcs", "--in", src, "--out", dst, "--ckpt-dir",
                                       ckpt_dir], timeout=300)
    if "using config saved with checkpoint (dcs)" not in stdout:
        print(stdout[-3000:], flush=True)
        fail("cli.enhance --ckpt-dir did not use the checkpoint's config")
    served, sr = read_wav(dst)
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    cpu_model = DCSNet(cfg.model, cfg.quirks, device="cpu")
    step = load_model(ckpt_dir, cpu_model)
    x, _ = read_wav(src)
    want = enhance_full(cpu_model, torch.from_numpy(x)[None], cfg)[0]
    print(f"train: cli.enhance --ckpt-dir (step {step}) exit 0 in {wall:.1f} s: "
          + next(ln for ln in stdout.splitlines() if ln.startswith("restored"))
          + f" [{card}]", flush=True)
    if sr != SR or served.shape != tuple(want.shape):
        fail(f"cli.enhance --ckpt-dir wrote {served.shape} at {sr} Hz")
    compare_card_cpu("train: the served checkpoint, 1 s", torch.from_numpy(served), want)


def train_batch(dev, tmp):
    """Phase "train"'s data under ``tmp`` and its batch: (the DCS config with
    that data, noisy, clean) on ``dev``."""
    import dataclasses

    import torch

    from dcs_net_tpu_torch.data.dataset import Loader, VoiceBankDataset
    from dcs_net_tpu_torch.data.partition import make_partition
    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.data import synthetic

    root = os.path.join(tmp, "synthetic_data")     # where the CLI's --synthetic looks
    t0 = time.perf_counter()
    # pairs of 0.6 s: the crop is 0.51 s, and shorter files are quicker for
    # the trainer's loader threads to decode and resample
    dcfg = synthetic.generate(root, n_train=TRAIN_N_SYNTHETIC, n_test=EVAL_N_TEST,
                              seconds=0.6)
    cfg = config_for_variant("dcs")
    cfg = cfg.replace(data=dataclasses.replace(dcfg, batch_size=TRAIN_BATCH))
    # the first train batch as the CLI's loader draws it, from the numpy path
    # as before the native front end became the default: the card-vs-CPU
    # step (c) holds DCS's input-BN gradients to a band that float32 does not
    # resolve at every input (the native batch, within 6e-8 of this one,
    # puts initial_bn.gamma_rr outside it; PERF.md section 7)
    loader = Loader(VoiceBankDataset(make_partition(cfg.data, seed=cfg.run.seed)["train"],
                                     cfg.data, "train"), TRAIN_BATCH, drop_last=True,
                    seed=cfg.run.seed, use_native=False)
    host = next(iter(loader.epoch(0)))
    loader.close()
    noisy = torch.from_numpy(host["noisy"]).to(dev)
    clean = torch.from_numpy(host["clean"]).to(dev)
    print(f"train: {TRAIN_N_SYNTHETIC} synthetic pairs written and one batch "
          f"{tuple(noisy.shape)} loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, noisy, clean


def check_train(dev, card, tmp):
    """Phase "train", with its data, logs and checkpoints under ``tmp``.
    Returns the kernel rows of one train step's launches (forward and input
    gradient) and its launch counts."""
    import torch

    from dcs_net_tpu_torch.data import native_loader
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.train import steps
    from dcs_net_tpu_torch.train.checkpoint import CheckpointManager
    from dcs_net_tpu_torch.train.optim import make_optimizer
    from dcs_net_tpu_torch.utils import cuda_lib

    cfg, noisy, clean = train_batch(dev, tmp)

    # (a) one step's launches, on a model with faithful quirks, dropout on
    torch.manual_seed(SEED)
    model = DCSNet(cfg.model, cfg.quirks, device=dev, seed=SEED + 11)
    opt = make_optimizer(model.parameters(), cfg.optim)

    def step():
        return steps.train_step(model, opt, steps.batch_from_waves(noisy, clean, cfg), cfg)

    shapes = discover_shapes(step)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    out = step()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in cuda_lib.KERNELS.values()}
    print(f"train: train_step launches {launches}, loss {float(out['loss']):.4f}",
          flush=True)
    for name, n in TRAIN_STEP_LAUNCHES.items():
        if launches.get(name, 0) != n:
            fail(f"kernel {name} launched {launches.get(name, 0)} times in one "
                 f"train step, expected {n}")
    if not math.isfinite(float(out["loss"])) or float(out["skipped"]) != 0.0:
        fail("the train step's loss is not finite")

    # (b) both directions at the step's shapes; the input gradients' rows
    check_function_grads(shapes, dev, cfg)
    rows = check_kernels({name: shapes[name] for name in (
        "stft", "conv_same_small_cout", "tapconv_valid", "conv_same_small_cout_dgrad",
        "tapconv_valid_dgrad")}, launches, dev, cfg, card, "train step")
    time_weight_grads(shapes, dev, card)

    # (c) card vs CPU, one step at batch 4 from the same weights, dropout off
    card_vs_cpu_step("train", cfg, noisy, clean, dev, SEED + 13)

    # (d) the trainer: 8 steps and a checkpoint, then --resume for 8 more;
    # SWA starts at epoch int(0.8 * epochs), so each run averages its last
    # epoch and refreshes the BN statistics over the next epoch's batches
    # at 3 steps a dispatch: an eager dispatch, a capture and replay, 2 single
    # steps; the resumed run captures anew after its restore
    _, first = run_trainer(tmp, 1, False, card, ["--steps-per-dispatch", "3"])
    ckpt = CheckpointManager(os.path.join(tmp, "dcs", "checkpoints"))
    if (first.get("steps") != TRAIN_STEPS or first.get("nonfinite_loss_steps") != 0
            or ckpt.latest_step() != TRAIN_STEPS):
        fail(f"the trainer's first run: {first}, checkpoints {ckpt.steps()}")
    # the resumed run on the numpy front end: the native library's path set
    # to a missing file
    stdout, second = run_trainer(tmp, 2, True, card, ["--steps-per-dispatch", "3"], env={
        native_loader.ENV_SO: os.path.join(tmp, "no_such_dir", "libaudioio.so")})
    line = next((ln for ln in stdout.splitlines() if ln.startswith("loader=")), "")
    print(f"train: the resumed run's front end: {line}", flush=True)
    if not line.startswith("loader=python (native front end unavailable"):
        fail(f"train (d): the trainer with the library missing printed {line!r}")
    if (f"resumed from step {TRAIN_STEPS} (epoch 1)" not in stdout
            or second.get("epoch") != 1 or second.get("nonfinite_loss_steps") != 0
            or ckpt.latest_step() != 2 * TRAIN_STEPS):
        fail(f"the trainer did not resume: {second}, checkpoints {ckpt.steps()}")
    for run, metrics in (("first", first), ("resumed", second)):
        print(f"train: SWA in the {run} run: swa_n_averaged "
              f"{metrics.get('swa_n_averaged')}, BN refresh over "
              f"{metrics.get('bn_refresh_batches')} batches", flush=True)
        if metrics.get("swa_n_averaged") != 1 or \
                metrics.get("bn_refresh_batches") != TRAIN_STEPS:
            fail(f"the {run} trainer run did not average and refresh: {metrics}")
    serve_checkpoint(ckpt.directory, card)

    # (e) one fixed batch, dropout on, 10 steps: the loss falls
    torch.manual_seed(SEED + 1)
    model = DCSNet(cfg.model, cfg.quirks, device=dev, seed=SEED + 15)
    opt = make_optimizer(model.parameters(), cfg.optim)
    losses = torch.stack([step()["loss"] for _ in range(10)]).cpu().tolist()
    first3, last3 = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    print(f"train: 10 steps on one batch, dropout on: losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; mean of the first 3 "
          f"{first3:.4f}, of the last 3 {last3:.4f}", flush=True)
    if not (all(map(math.isfinite, losses)) and last3 < first3):
        fail("the loss did not fall over 10 steps on one batch")

    # (f) the step's time at batch 32
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(20):
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    walls.sort()
    med = walls[len(walls) // 2]
    audio_s = TRAIN_BATCH * TRAIN_CROP / cfg.data.sr
    print(f"train: step at batch {TRAIN_BATCH} x {TRAIN_CROP} samples ({audio_s:.2f} "
          f"audio-s): median {med:.2f} ms over 20 steps (min {walls[0]:.2f}, max "
          f"{walls[-1]:.2f}), {audio_s / med * 1e3:.1f} audio-s/s per GPU, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]",
          flush=True)
    return rows, launches, (noisy, clean, med)


def graph_waves(noisy, clean, n):
    """``n`` host batches (n, B, crop) made from one device batch: batch i is
    it with its utterances rotated by i and each rolled by 509 i samples."""
    import torch

    return tuple(torch.from_numpy(np.stack([
        np.roll(np.roll(a, i, axis=0), 509 * i, axis=1) for i in range(n)]))
        for a in (noisy.cpu().numpy(), clean.cpu().numpy()))


def port_launches(kernels) -> int:
    """The port's kernel launches among a profile's device kernels."""
    import re

    pattern = re.compile(r"\b(?:" + "|".join(PORT_KERNEL_SYMBOLS) + r")\b")
    return sum(e.count for e in kernels if pattern.search(e.key))


def time_graph(what, scanned, launches, x, y, eager_ms, card):
    """A captured step's time: the median over 5 replays (each dispatch,
    its waves' copy included, ended by a synchronize) per train step and the
    audio-s/s per GPU, beside ``eager_ms``; one replay under the profiler,
    in a window that lost no kernel records (``profiled_whole``): device
    kernels (the port's among them, held to ``launches``, the capture's
    counts), busy time and idle share; up to 12 windows, as
    ``check_graphed`` takes. Returns (the per-step median, a replay's busy
    ms, its device kernels)."""
    import torch

    from dcs_net_tpu_torch.utils import cuda_lib
    from dcs_net_tpu_torch.utils.timing import profiled_whole

    k = scanned.k
    counted = sum(launches[kn.name] for kn in cuda_lib.KERNELS.values()
                  if kn.counted_with is None)
    walls = []
    for _ in range(5):
        t1 = time.perf_counter()
        scanned(x, y)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3 / k)
    walls.sort()
    med = walls[2]
    window, taken = profiled_whole(lambda: scanned(x, y), tries=12)
    if window is None:
        fail(f"{what}: no two of {taken} profiler windows of a replay agreed on its "
             "kernel count")
    wall, busy, n_launch, kernels = window
    ours = port_launches(kernels)
    audio_s = TRAIN_BATCH * TRAIN_CROP / SR
    print(f"graph: {what}: {k} steps a replay at batch {TRAIN_BATCH} x {TRAIN_CROP}: "
          f"median {med:.2f} ms a step over 5 replays (min {walls[0]:.2f}, max "
          f"{walls[-1]:.2f}), {audio_s / med * 1e3:.1f} audio-s/s per GPU, against "
          f"{eager_ms:.2f} ms a step eager ({audio_s / eager_ms * 1e3:.1f} audio-s/s); "
          f"one replay under the profiler (the first of {taken} windows with its "
          f"count): wall {wall:.2f} ms, {n_launch} device "
          f"kernels ({ours} of the port's), busy {busy:.2f} ms ({busy / k:.2f} a step), "
          f"idle share {1 - busy / wall:.3f} ({1 - busy / (k * med):.3f} of the "
          f"median) [{card}]", flush=True)
    if ours != counted:
        fail(f"{what}: the profiler saw {ours} launches of the port's kernels in one "
             f"replay, the capture counted {counted}")
    return med, busy, n_launch


def capture_graph(what, model, opt, cfg, x, y, between=None):
    """An eager dispatch of ``GRAPH_K`` steps (waves 0..K-1), ``between()``
    if given, then the capture and first replay (waves K..2K-1), the launch
    counts set to 0 just before it and read just after: one replay's
    launches, ``GRAPH_K`` times a step's. Returns the scanned step, both
    dispatches' losses and the counts."""
    import torch

    from dcs_net_tpu_torch.train import steps
    from dcs_net_tpu_torch.utils import cuda_lib

    k = GRAPH_K
    scanned = steps.make_scanned_train_step(model, opt, cfg, k)
    first = scanned(x[:k], y[:k])["loss"].clone()
    if between is not None:
        between()
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    second = scanned(x[k:2 * k], y[k:2 * k])["loss"].clone()
    torch.cuda.synchronize()
    launches = {kn.name: kn.launches for kn in cuda_lib.KERNELS.values()}
    print(f"graph: {what}: captured {k} train steps in {scanned.capture_s:.2f} s, "
          f"private pool {scanned.pool_bytes / 2**30:.2f} GiB, one replay's launches "
          f"{ {n: c for n, c in launches.items() if c} }", flush=True)
    for name, n in TRAIN_STEP_LAUNCHES.items():
        if launches.get(name, 0) != k * n:
            fail(f"{what}: kernel {name} launched {launches.get(name, 0)} times in one "
                 f"replay of {k} steps, expected {k * n}")
    losses = torch.cat([first, second]).tolist()
    if not all(map(math.isfinite, losses)):
        fail(f"{what}: a non-finite loss in the graphed steps: {losses}")
    return scanned, losses, launches


def state_band(what, got_model, want_model) -> None:
    """Every parameter and BN statistic of ``got_model`` in the oracle band
    of ``want_model``'s."""
    worst = 0.0
    want_state = want_model.state_dict()
    for name, got in got_model.state_dict().items():
        want = want_state[name]
        if not want.is_floating_point():
            continue
        bad, excess, drift, rel = outside_band(got.double().cpu(), want.double().cpu())
        if bad:
            fail(f"{what}: {name} outside the band (excess {excess:.3e}, mean drift "
                 f"{drift:.3e})")
        worst = max(worst, float((got - want).abs().max()))
    print(f"{what}: every parameter and BN statistic within the band, max |diff| "
          f"{worst:.3e}", flush=True)


def check_graph(dev, card, tmp, noisy, clean, eager_ms):
    """Phase "graph": ``--steps-per-dispatch`` K > 1 on the card, one CUDA
    graph of K train steps replayed a dispatch, on phase "train"'s batch.
    Returns one replay's launch counts, DCS's and DRS's, (a)'s median DCS
    step in ms, a replay's busy ms and kernels, and DRS's (e) (eager ms, then
    the same three)."""
    import dataclasses

    import torch

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.train import steps
    from dcs_net_tpu_torch.train.optim import (get_lr, make_optimizer, make_plateau,
                                               optimizer_tensors, step_count)

    t_phase = time.perf_counter()
    k = GRAPH_K
    cfg = config_for_variant("dcs")
    x, y = graph_waves(noisy, clean, 3 * k)

    def model_pair(c, seed, gen_seed=None):
        """Two models (and optimizers) of the same weights, each with its own
        dropout generator seeded ``gen_seed``."""
        out = []
        for _ in range(2):
            m = DCSNet(c.model, c.quirks, device=dev, seed=seed)
            if gen_seed is not None:
                m.set_dropout_generator(torch.Generator(device=dev).manual_seed(gen_seed))
            out += [m, make_optimizer(m.parameters(), c.optim)]
        return out

    def eager(m, o, c, idx):
        return [float(steps.train_step(m, o, steps.batch_from_waves(
            x[i].to(dev), y[i].to(dev), c), c)["loss"]) for i in idx]

    # (a) DCS at batch 32 with K = 8: capture, launches, replay time
    model = DCSNet(cfg.model, cfg.quirks, device=dev, seed=SEED + 40)
    model.set_dropout_generator(torch.Generator(device=dev).manual_seed(SEED + 41))
    scanned, _, launches = capture_graph("DCS", model, make_optimizer(
        model.parameters(), cfg.optim), cfg, x, y)
    step_ms, busy_ms, n_kernels = time_graph("DCS", scanned, launches, x[:k], y[:k],
                                             eager_ms, card)
    del model, scanned
    torch.cuda.empty_cache()

    # (b)-(d) are held against eager steps with cuDNN's deterministic
    # algorithms on both sides: its default backward ones sum with atomics,
    # so two eager runs from one state part after a few steps, as this shows
    a, oa, b, ob = model_pair(cfg, SEED + 42, SEED + 43)
    la, lb = eager(a, oa, cfg, range(k + 1)), eager(b, ob, cfg, range(k + 1))
    print(f"graph: two eager runs of {k + 1} steps from one state, cuDNN's default "
          f"algorithms: relative loss difference {abs(la[k] - lb[k]) / abs(lb[k]):.3e} "
          f"at step {k + 1}, {max(abs(x - w) / abs(w) for x, w in zip(la, lb)):.3e} at "
          f"most", flush=True)
    del a, oa, b, ob
    torch.backends.cudnn.deterministic = True
    try:
        # (b) dropout on: 16 steps, an eager dispatch and a replay, against 16
        # eager steps; a witness replay with the generator reseeded
        a, oa, b, ob = model_pair(cfg, SEED + 42, SEED + 43)
        sa = steps.make_scanned_train_step(a, oa, cfg, k)
        got = sa(x[:k], y[:k])["loss"].tolist()
        kept = [t.detach().clone() for t in
                list(a.parameters()) + list(a.buffers()) + optimizer_tensors(oa)]
        got += sa(x[k:2 * k], y[k:2 * k])["loss"].tolist()
        want = eager(b, ob, cfg, range(2 * k))
        err = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        print(f"graph: (b) dropout on, {2 * k} steps (an eager dispatch and a replay) "
              f"against {2 * k} eager steps: max relative loss difference {err:.3e} "
              f"(limit 1e-4)", flush=True)
        if not err <= 1e-4:
            fail(f"graph (b): the graphed steps' losses {got} are not eager's {want}")
        state_band("graph: (b) after 16 steps", a, b)
        for t, v in zip(list(a.parameters()) + list(a.buffers()) + optimizer_tensors(oa),
                        kept):
            with torch.no_grad():
                t.copy_(v)
        a.dropout_generator.manual_seed(SEED + 44)
        witness = sa(x[k:2 * k], y[k:2 * k])["loss"].tolist()
        werr = max(abs(g - w) / abs(w) for g, w in zip(witness, want[k:]))
        print(f"graph: (b) witness: the replay with the generator reseeded differs "
              f"by {werr:.3e} (must exceed 1e-3)", flush=True)
        if not werr > 1e-3:
            fail("graph (b): a replay with other dropout masks agreed with eager")
        del a, oa, b, ob, sa
        torch.cuda.empty_cache()

        # (c) dropout off, inner step j's waves NaN: the gate inside the graph
        ncfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout_conv=0.0,
                                                     dropout_fc=0.0))
        c, oc, d, od = model_pair(ncfg, SEED + 45)
        sc = steps.make_scanned_train_step(c, oc, ncfg, k)
        sc(x[:k], y[:k])
        j = 3
        xn, yn = x[k:2 * k].clone(), y[k:2 * k].clone()
        xn[j], yn[j] = float("nan"), float("nan")
        before = step_count(oc)
        out = sc(xn, yn)
        skipped = out["skipped"].tolist()
        applied = step_count(oc) - before
        eager(d, od, ncfg, list(range(k)) + [k + i for i in range(k) if i != j])
        print(f"graph: (c) NaN waves at inner step {j}: skipped {skipped}, Adam's "
              f"step count rose by {applied}", flush=True)
        if skipped != [1.0 if i == j else 0.0 for i in range(k)] or applied != k - 1:
            fail("graph (c): the NaN gate inside the graph did not skip exactly "
                 f"step {j}")
        state_band("graph: (c) the NaN dispatch against 7 eager steps", c, d)

        # (d) the plateau halves the lr in place between replays
        lr_t = oc.param_groups[0]["lr"]
        lr0 = get_lr(oc)
        for o in (oc, od):
            plateau = make_plateau(o, dataclasses.replace(
                ncfg.optim, plateau_factor=0.5, plateau_patience=0))
            plateau.step(1.0)
            plateau.step(2.0)
        p_c = torch.cat([p.detach().reshape(-1) for p in c.parameters()])
        p_d = torch.cat([p.detach().reshape(-1) for p in d.parameters()])
        sc(x[2 * k:], y[2 * k:])
        eager(d, od, ncfg, range(2 * k, 3 * k))
        up_c = torch.cat([p.detach().reshape(-1) for p in c.parameters()]) - p_c
        up_d = torch.cat([p.detach().reshape(-1) for p in d.parameters()]) - p_d
        uerr = float((up_c - up_d).abs().max() / up_d.abs().max())
        print(f"graph: (d) lr {lr0:.3e} -> {get_lr(oc):.3e} in place (the same tensor: "
              f"{oc.param_groups[0]['lr'] is lr_t}); the next replay's update against "
              f"eager steps at that lr: max |diff| / max |update| {uerr:.3e} (limit "
              f"1e-3; at the old lr it would be about 1)", flush=True)
        if oc.param_groups[0]["lr"] is not lr_t or get_lr(oc) != lr0 / 2 or uerr > 1e-3:
            fail("graph (d): the replay did not take the plateau's lr")
        state_band("graph: (d) after the replay at half the lr", c, d)
        del c, oc, d, od, sc
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False

    # (e) DRS: capture, the first inner step's loss against eager from the same
    # state (no update between), and its time beside eager steps
    rcfg = config_for_variant("drs")
    e, oe, f, of = model_pair(rcfg, SEED + 46, SEED + 47)
    eager_first = []

    def first_step_on_f():
        """f takes e's state after its eager dispatch; its loss on the next
        waves is the replay's first step's."""
        f.load_state_dict(e.state_dict())
        f.dropout_generator.set_state(e.dropout_generator.get_state())
        eager_first.append(float(steps.loss_and_grads(f, steps.batch_from_waves(
            x[k].to(dev), y[k].to(dev), rcfg), rcfg)[0]))

    se, losses, rlaunches = capture_graph("DRS", e, oe, rcfg, x, y, first_step_on_f)
    want = eager_first[0]
    print(f"graph: (e) DRS first replayed step's loss {losses[k]:.7f}, eager from the "
          f"same state {want:.7f}", flush=True)
    if not abs(losses[k] - want) <= 1e-5 * abs(want):
        fail("graph (e): the DRS replay's first step is not eager's")
    walls = []
    for i in range(6):
        t1 = time.perf_counter()
        eager(f, of, rcfg, [i])
        walls.append((time.perf_counter() - t1) * 1e3)
    drs_f32 = (sorted(walls[1:])[2],) + time_graph("DRS", se, rlaunches, x[:k], y[:k],
                                                   sorted(walls[1:])[2], card)
    del e, oe, f, of, se
    torch.cuda.empty_cache()

    # (f) the trainer at the CLI's card default, 8 steps a dispatch: two
    # epochs of 16 steps, an eager dispatch, then three replays
    _, metrics = run_trainer(os.path.join(tmp, "k8"), 2, False, card, (),
                             GRAPH_TRAIN_N, 2 * k)
    print(f"graph: (f) the trainer at {k} steps a dispatch: {metrics.get('graph_replays')} "
          f"replays, steady {metrics.get('steady_audio_seconds_per_s')} audio-s/s "
          f"per GPU, {metrics.get('audio_seconds_per_s')} over its last epoch [{card}]",
          flush=True)
    if (metrics.get("graph_replays", 0) < 2 or metrics.get("steps") != 2 * k
            or metrics.get("nonfinite_loss_steps") != 0):
        fail(f"graph (f): the trainer at {k} steps a dispatch: {metrics}")
    print(f"graph: phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, rlaunches, (step_ms, busy_ms, n_kernels), drs_f32


def check_loader(card, tmp, graph_step_ms):
    """Phase "loader": the native audio front end on the card's host, and the
    K = 8 trainer fed by it and by the numpy path, on 3 s pairs."""
    import re

    from dcs_net_tpu_torch.core.config import DataConfig
    from dcs_net_tpu_torch.data import native_loader, synthetic
    from dcs_net_tpu_torch.data.dataset import Loader, VoiceBankDataset
    from dcs_net_tpu_torch.data.partition import make_partition
    from dcs_net_tpu_torch.tools import profile_loader

    t_phase = time.perf_counter()
    cpus = os.cpu_count()
    host = f"{card}; host CPUs {cpus}"

    # (a) the library, built here from the checkout's source
    t0 = time.perf_counter()
    try:
        so = native_loader.build_library()
    except RuntimeError as e:
        print(e, flush=True)
        fail("loader (a): the native front end did not build")
    if not native_loader.native_available():
        fail(f"loader (a): the native front end does not load: {native_loader.load_error()}")
    print(f"loader: (a) {so} built or found in {time.perf_counter() - t0:.2f} s "
          f"(g++ {' '.join(native_loader.GXX_FLAGS)}); host CPUs {cpus}", flush=True)
    root = os.path.join(tmp, "loader_data")
    t0 = time.perf_counter()
    synthetic.generate(root, n_train=LOADER_N_SYNTHETIC, n_test=2, seconds=LOADER_SECONDS)
    print(f"loader: wrote {LOADER_N_SYNTHETIC} pairs of {LOADER_SECONDS} s at 48 kHz "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    # (b) native batches against the numpy path's on this host
    cfg = DataConfig(root=root, batch_size=TRAIN_BATCH, crop_samples=TRAIN_CROP)
    ds = VoiceBankDataset(make_partition(cfg, seed=SEED)["train"], cfg, "train")
    nat = Loader(ds, TRAIN_BATCH, drop_last=True, seed=SEED, use_native=True)
    py = Loader(ds, TRAIN_BATCH, drop_last=True, seed=SEED, use_native=False)
    worst = 0.0
    try:
        for a, b in itertools.islice(zip(nat.epoch(0), py.epoch(0)), 2):
            if a["id"] != b["id"] or not np.array_equal(a["start"], b["start"]):
                fail("loader (b): the native and numpy batches differ in ids or starts")
            worst = max(worst, float(np.abs(a["clean"] - b["clean"]).max()),
                        float(np.abs(a["noisy"] - b["noisy"]).max()))
            full = native_loader.fill_batch_full(
                [os.path.join(ds.clean_dir, u + ".wav") for u in a["id"]],
                [os.path.join(ds.noisy_dir, u + ".wav") for u in a["id"]], a["start"],
                TRAIN_CROP)
            if not (np.array_equal(full[0], a["clean"]) and np.array_equal(full[1], a["noisy"])):
                fail("loader (b): the windowed fill differs from the faithful one")
    finally:
        nat.close()
        py.close()
    print(f"loader: (b) 2 batches of {TRAIN_BATCH} x {TRAIN_CROP}, native against numpy: "
          f"ids and starts equal, max |diff| {worst:.3e} (limit {NATIVE_TOL}); the "
          f"windowed fill equal to the faithful one bit for bit", flush=True)
    if not worst <= NATIVE_TOL:
        fail("loader (b): the native batches are not the numpy path's")

    # (c) the loader alone, at the trainer's 2 workers
    workers = 2
    prof = profile_loader.profile(root, TRAIN_BATCH, TRAIN_CROP, [workers], 32,
                                  LOADER_RATE_BATCHES)
    print(f"loader: (c) [{host}]", flush=True)

    # (d) the trainer at K = 8, default prefetch, on the native front end (phase
    # 7 (d) runs it on the numpy one)
    audio_s = TRAIN_BATCH * TRAIN_CROP / SR
    graph_rate = audio_s / graph_step_ms * 1e3
    steps = len(ds) // TRAIN_BATCH
    stdout, metrics = run_trainer(os.path.join(tmp, "loader_native"), LOADER_EPOCHS,
                                  False, card, (), steps=steps, data_root=root)
    line = next((ln for ln in stdout.splitlines() if ln.startswith("loader=")), "")
    steady = [float(v) for v in re.findall(r"\bsteady_audio_seconds_per_s=(\S+)", stdout)]
    print(f"loader: (d) the trainer at K = {GRAPH_K} on the native front end "
          f"({line}): {LOADER_EPOCHS} epochs of {steps} steps, steady "
          f"{', '.join(f'{v:.1f}' for v in steady)} audio-s/s per GPU by epoch, "
          f"{metrics.get('audio_seconds_per_s')} over its last epoch, "
          f"{metrics.get('graph_replays')} replays since the capture; the graphed step "
          f"alone (graph (a)) {graph_rate:.1f} audio-s/s [{host}]", flush=True)
    if line != "loader=native":
        fail(f"loader (d): the trainer did not take the native front end: {line!r}")
    if (metrics.get("steps") != steps or metrics.get("nonfinite_loss_steps") != 0
            or len(steady) != LOADER_EPOCHS):
        fail(f"loader (d): the trainer on the native front end: {metrics}")
    for label, fe in (("native", "native-windowed"), ("numpy", "numpy")):
        # the steady cycle of a dispatch reckoned from the loader alone: the
        # producer runs at most prefetch + 1 = 3 batches ahead of a replay R
        # that takes K = 8, so about max(R, 3L) + 5L with L its time a batch
        L = 1.0 / prof["rate"][fe][workers]
        R = GRAPH_K * graph_step_ms / 1e3
        cycle = max(R, 3 * L) + 5 * L
        print(f"loader: (d) reckoning for the {label} front end: L {L * 1e3:.1f} ms a "
              f"batch at {workers} workers, R {R * 1e3:.1f} ms a replay: max(R, 3L) + 5L "
              f"= {cycle * 1e3:.1f} ms a dispatch, {GRAPH_K * audio_s / cycle:.1f} "
              f"audio-s/s; with a prefetch of K or more max(R, 8L) = "
              f"{max(R, 8 * L) * 1e3:.1f} ms, {GRAPH_K * audio_s / max(R, 8 * L):.1f} "
              f"audio-s/s", flush=True)
    print(f"loader: phase took {time.perf_counter() - t_phase:.1f} s", flush=True)


def read_events(path):
    """{tag: [values]} of a trainer's events.jsonl."""
    events = {}
    with open(path) as f:
        for line in f:
            e = json.loads(line)
            events.setdefault(e["tag"], []).append(e["value"])
    return events


def check_eval(dev, card, tmp):
    """Phase "eval", on what phase "train" left under ``tmp``: its
    checkpoint, its synthetic test pairs, its trainer's events. Returns the
    kernel rows of one test utterance's eval-mode forward, named
    ``<kernel>_eval``."""
    import csv

    import torch

    from dcs_net_tpu_torch.cli.common import make_test_loader
    from dcs_net_tpu_torch.core.config import Config
    from dcs_net_tpu_torch.metrics import composite as C
    from dcs_net_tpu_torch.metrics import harness as H
    from dcs_net_tpu_torch.metrics import pesq as P
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.train import steps
    from dcs_net_tpu_torch.train.checkpoint import load_model
    from dcs_net_tpu_torch.train.loop import COMPOSITE_KEYS
    from dcs_net_tpu_torch.utils import cuda_lib

    t_phase = time.perf_counter()
    ckpt_dir = os.path.join(tmp, "dcs", "checkpoints")
    # the PESQ library must build: the trainer would only warn
    so = P.build_library()
    print(f"eval: PESQ library {so} (g++ {' '.join(P.GXX_FLAGS)}), key "
          f"{'pesq_est' if P.is_estimate() else 'pesq'}", flush=True)

    # (a) cli.test on the checkpoint, composite measures on
    args = ["dcs", "--ckpt-dir", ckpt_dir, "--synthetic", "--log-dir", tmp, "--composite"]
    _, wall = run_cli("test", args)
    print(f"eval: cli.test {' '.join(args)}: exit 0 in {wall:.1f} s [{card}]", flush=True)
    with open(os.path.join(tmp, "dcs-test", "per_utterance.csv")) as f:
        rows = list(csv.reader(f))
    header = ["id", "start", "stoi", "pesq_est", "si_sdr", *COMPOSITE_KEYS]
    if rows[0] != header or len(rows) != 1 + EVAL_N_TEST:
        fail(f"cli.test wrote {len(rows) - 1} rows under {rows[0]}, expected "
             f"{EVAL_N_TEST} under {header}")
    test = {k: v[-1] for k, v in read_events(
        os.path.join(tmp, "dcs-test", "events.jsonl")).items()}
    want = [f"test_{k}" for k in ("stoi", "pesq_est", *COMPOSITE_KEYS)]
    print("eval: cli.test means " + " ".join(f"{k}={test.get(k)}" for k in want), flush=True)
    if not all(math.isfinite(test.get(k, float("nan"))) for k in want):
        fail(f"cli.test's means are missing or not finite: {test}")

    # (b) one test utterance's eval-mode forward: launches, every launch
    # against its plain version, the audio against the CPU's
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    model = DCSNet(cfg.model, cfg.quirks, device=dev)
    cpu_model = DCSNet(cfg.model, cfg.quirks, device="cpu")
    load_model(ckpt_dir, model)
    load_model(ckpt_dir, cpu_model)
    loader = make_test_loader(cfg, batch_size=1)
    try:
        utterances = list(loader.epoch(0))
    finally:
        loader.close()

    def forward(m, host, d):
        noisy = torch.from_numpy(host["noisy"]).to(d)
        clean = torch.from_numpy(host["clean"]).to(d)
        return steps.eval_step(m, steps.batch_from_waves(noisy, clean, cfg), cfg)

    shapes = discover_shapes(lambda: forward(model, utterances[0], dev))
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    forward(model, utterances[0], dev)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in cuda_lib.KERNELS.values()}
    print(f"eval: one test utterance {utterances[0]['noisy'].shape}, eval_step launches "
          f"{launches}", flush=True)
    # the gate runs the conv entry's body and counts there as well: the conv
    # entry alone is never launched when the two counts are equal
    want = {"stft": 1, "sa_pool": 13, "sa_gate": 13, "conv_same_small_cout": 13,
            "tapconv_valid": 7, "tapconv_pack": 7}
    for name, n in launches.items():
        if n != want.get(name, 0):
            fail(f"kernel {name} launched {n} times in one test utterance's "
                 f"forward, expected {want.get(name, 0)}")
    rows = check_kernels({name: shapes[name] for name in (
        "stft", "sa_pool", "sa_gate", "tapconv_valid")}, launches, dev, cfg, card,
        "test utterance", suffix="_eval")
    # the same forward as one CUDA graph a batch shape, as the trainer runs it
    waves = [torch.from_numpy(utterances[0][k]) for k in ("noisy", "clean")]

    def flat(out, losses=True):
        return torch.cat(([torch.stack(list(out[0].values())).reshape(-1)] if losses else [])
                         + [v.reshape(-1) for v in out[1].values()])

    check_graphed("eval: one test utterance's eval forward, batch 1",
                  lambda g, model=model, waves=waves, cfg=cfg: flat(
                      steps.eval_waves(model, *(w.to(dev) for w in waves), cfg, g)),
                  {"stft": 1, **DCS_EVAL_FORWARD}, card,
                  (lambda g: flat(steps.eval_waves(model, *(w.to(dev) for w in waves), cfg, g),
                                  losses=False),
                   flat(steps.eval_waves(cpu_model, *waves, cfg), losses=False)))

    # (c) every test utterance on the card and on the CPU: the audio, then
    # STOI, PESQ and SI-SDR of each against the other's; (f) the time of
    # the card's forward (audio on the host) and of the host's metrics
    sr = cfg.data.sr
    worst = dict.fromkeys(EVAL_METRIC_TOL, 0.0)
    t_dev, t_host = [], []
    for i, host in enumerate(utterances):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, card_audio = forward(model, host, dev)
        card_audio = {k: v.cpu() for k, v in card_audio.items()}
        t_dev.append(time.perf_counter() - t1)
        _, cpu_audio = forward(cpu_model, host, "cpu")
        compare_card_cpu(f"eval: {host['id'][0]}, streams {', '.join(cpu_audio)},",
                         torch.stack(list(card_audio.values())),
                         torch.stack(list(cpu_audio.values())))
        clean = card_audio["clean"][0].numpy()
        scores = []
        for audio in (card_audio, cpu_audio):
            pred = audio["predict_clean"][0].numpy()
            t1 = time.perf_counter()
            pq = H.pesq_metric(clean, pred, sr)
            scores.append({"stoi": H.stoi_metric(clean, pred, sr), "pesq_est": pq,
                           "si_sdr": H.si_sdr(clean, pred)})
            C.composite(clean, pred, sr, pesq_mos=pq)
            if audio is card_audio:
                t_host.append(time.perf_counter() - t1)
        print(f"eval: {host['id'][0]} card vs CPU: " + " ".join(
            f"{k} {scores[0][k]:.6f} vs {scores[1][k]:.6f}" for k in EVAL_METRIC_TOL),
            flush=True)
        for k in EVAL_METRIC_TOL:
            if not all(math.isfinite(s[k]) for s in scores):
                fail(f"eval: {k} of {host['id'][0]} is not finite: {scores}")
            worst[k] = max(worst[k], abs(scores[0][k] - scores[1][k]))
    print("eval: largest card vs CPU differences over "
          f"{len(utterances)} utterances: " + " ".join(
              f"{k} {worst[k]:.3e} (limit {EVAL_METRIC_TOL[k]})" for k in worst), flush=True)
    for k, tol in EVAL_METRIC_TOL.items():
        if worst[k] > tol:
            fail(f"eval: card and CPU {k} differ by {worst[k]:.3e} > {tol}")
    t_dev.sort()
    t_host.sort()
    n_utt = len(utterances)
    print(f"eval: per test utterance ({utterances[0]['noisy'].shape[1]} samples): device "
          f"forward with the audio copied to the host median {t_dev[n_utt // 2] * 1e3:.2f} "
          f"ms (max {t_dev[-1] * 1e3:.2f}), host metrics (STOI, PESQ, SI-SDR, "
          f"composite) median {t_host[n_utt // 2] * 1e3:.2f} ms; cli.test {wall / n_utt:.2f} "
          f"s per utterance with its start-up [{card}]", flush=True)

    # (d) phase "train" (d)'s runs validated with metrics, their sanity
    # passes without
    events = read_events(os.path.join(tmp, "dcs", "events.jsonl"))
    for tag in ("val_stoi", "val_pesq_est"):
        vals = events.get(tag, [])
        print(f"eval: the trainer's {tag} by epoch {vals}", flush=True)
        if len(vals) != 2 or not all(map(math.isfinite, vals)):
            fail(f"the trainer's 2 epochs logged {tag} {vals}")
    if "sanity_loss" not in events or any(
            t in events for t in ("sanity_stoi", "sanity_pesq_est")):
        fail(f"the sanity passes logged {sorted(t for t in events if t.startswith('sanity'))}")

    # (e) cli.tune, one trial of one epoch
    args = ["dcs", "--synthetic", "--synthetic-n", str(TUNE_N_SYNTHETIC), "--batch-size",
            str(TUNE_BATCH), "--trials", "1", "--trial-epochs", "1", "--log-dir",
            os.path.join(tmp, "tune")]
    out, wall = run_cli("tune", args)
    print(f"eval: cli.tune {' '.join(args)}: exit 0 in {wall:.1f} s [{card}]", flush=True)
    best = [ln for ln in out.splitlines() if ln.startswith("best:")]
    print("eval: cli.tune " + " | ".join(
        ln for ln in out.splitlines() if ln.startswith(("trial ", "best:"))), flush=True)
    if not best or not math.isfinite(json.loads(best[-1][len("best:"):])["value"]):
        fail(f"cli.tune printed no finite best value: {best}")
    print(f"eval: phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def check_real(dev, card):
    """Phase "real": the DRS U-Net at full width (the real family, whose
    spatial attention runs kernel 2's real gate in eval, and under autograd
    its conv entry at (K, Cin, Cout) = (7, 2, 1) and its input gradient at
    (7, 1, 2), and whose decoder ends at kernel 3's N = 4). Returns its
    kernel rows, named ``<kernel>_drs``."""
    import torch

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.models.enhance import enhance_full, enhance_streaming
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.train import steps
    from dcs_net_tpu_torch.train.optim import make_optimizer
    from dcs_net_tpu_torch.utils import cuda_lib
    from dcs_net_tpu_torch.utils.timing import profiled

    def counts():
        return {k.name: k.launches for k in cuda_lib.KERNELS.values()}

    def expect(what, launches, want):
        for name, n in want.items():
            if launches.get(name, 0) != n:
                fail(f"kernel {name} launched {launches.get(name, 0)} times in {what}, "
                     f"expected {n}")

    def on_cpu(model, cfg):
        cpu = DCSNet(cfg.model, cfg.quirks, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        return cpu

    # (a) enhance_full, batch 4 x 4 s
    cfg = config_for_variant("drs")
    model = DCSNet(cfg.model, cfg.quirks, device=dev, seed=SEED + 20).eval()
    perturb_bn(model, SEED + 21)
    x = torch.from_numpy(speech_like(BATCH, SECONDS * SR, SEED + 22)).to(dev)
    shapes = discover_shapes(lambda: enhance_full(model, x, cfg))
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    out = enhance_full(model, x, cfg)
    torch.cuda.synchronize()
    launches = counts()
    print(f"real: DRS enhance_full launches {launches}", flush=True)
    if tuple(out.shape) != (BATCH, SECONDS * SR) or not bool(torch.isfinite(out).all()):
        fail(f"DRS enhance_full returned {tuple(out.shape)} or non-finite samples")
    expect("one DRS enhance call", launches, {
        "stft": 1, "conv_same_small_cout": 0, "sa_pool": 0, "sa_gate": 0,
        "sa_pool_real": 13, "sa_gate_real": 13, "tapconv_valid": 7, "tapconv_pack": 7})
    walls = []
    for _ in range(10):
        t1 = time.perf_counter()
        enhance_full(model, x, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    walls.sort()
    print(f"real: DRS {BATCH} requests x {SECONDS} s: median {walls[5]:.2f} ms over "
          f"10 calls (min {walls[0]:.2f}, max {walls[-1]:.2f}), "
          f"{BATCH * SECONDS / walls[5] * 1e3:.1f} audio-s/s [{card}]", flush=True)
    cpu_model = on_cpu(model, cfg)
    short = torch.from_numpy(speech_like(1, SR, SEED + 23))
    cpu_short = enhance_full(cpu_model, short, cfg)
    compare_card_cpu("real: DRS 1 s request", enhance_full(model, short.to(dev), cfg).cpu(),
                     cpu_short)
    check_graphed(f"real: DRS enhance_full, {BATCH} requests x {SECONDS} s",
                  lambda g, model=model, x=x, cfg=cfg: enhance_full(model, x, cfg, graphs=g),
                  {"stft": 1, **DRS_EVAL_FORWARD}, card,
                  (lambda g: enhance_full(model, short.to(dev), cfg, graphs=g), cpu_short))
    three = torch.from_numpy(speech_like(1, 3 * SR, SEED + 24))
    compare_card_cpu("real: DRS streamed 3 s request (2 chunks of 256, overlap 64)",
                     enhance_streaming(model, three.to(dev), cfg).cpu(),
                     enhance_streaming(cpu_model, three, cfg))
    rows = check_kernels({name: shapes[name] for name in (
        "sa_pool_real", "sa_gate_real", "tapconv_valid")},
        launches, dev, cfg, card, "DRS enhance call", "_drs")
    pool, gate = rows[0], rows[1]
    print(f"real: the real gate over the 13 sites of a DRS enhance call: pool + gate "
          f"{pool['ms'] + gate['ms']:.4f} ms (bound {pool['bound_ms'] + gate['bound_ms']:.4f}) "
          f"against the eager sequence's {gate['eager_pool_and_gate_ms']:.4f} and the "
          f"sequence on the generic body's {gate['replaced_pool_and_gate_ms']:.4f} "
          f"[{card}]", flush=True)
    if pool["ms"] + gate["ms"] >= gate["eager_pool_and_gate_ms"]:
        fail("the real gate is no faster than the eager sequence it replaces")
    del cpu_model

    # (b) DR, card vs CPU
    dcfg = config_for_variant("dr")
    dr = DCSNet(dcfg.model, dcfg.quirks, device=dev, seed=SEED + 25).eval()
    perturb_bn(dr, SEED + 26)
    compare_card_cpu("real: DR 1 s request", enhance_full(dr, short.to(dev), dcfg).cpu(),
                     enhance_full(on_cpu(dr, dcfg), short, dcfg))
    del dr

    # (c) the train step at batch 32 x 8160, dropout on
    clean = torch.from_numpy(speech_like(TRAIN_BATCH, TRAIN_CROP, SEED + 27))
    noisy = clean + 0.05 * torch.randn(clean.shape, generator=torch.Generator().manual_seed(
        SEED + 28))
    clean, noisy = clean.to(dev), noisy.to(dev)
    tmodel = DCSNet(cfg.model, cfg.quirks, device=dev, seed=SEED + 29)
    tmodel.set_dropout_generator(torch.Generator(device=dev).manual_seed(SEED + 30))
    opt = make_optimizer(tmodel.parameters(), cfg.optim)

    def step():
        return steps.train_step(tmodel, opt, steps.batch_from_waves(noisy, clean, cfg), cfg)

    tshapes = discover_shapes(step)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    r = step()
    torch.cuda.synchronize()
    tlaunches = counts()
    print(f"real: DRS train_step launches {tlaunches}, loss {float(r['loss']):.4f}",
          flush=True)
    expect("one DRS train step", tlaunches, TRAIN_STEP_LAUNCHES)
    # (B, H, W, Cin, K, Cout, R, TX, TY): R = 0 names the generic body
    for name in ("conv_same_small_cout", "conv_same_small_cout_dgrad"):
        generic = [a for a in tshapes[name] if a[6] == 0]
        if generic:
            fail(f"{name} ran the generic body in the DRS train step at {generic}")
    print("real: the DRS train step's 13 + 13 kernel 2 launches all on the "
          "register-tiled body, tiles "
          + ", ".join(f"{a[1]}x{a[2]} {a[6:]}" for a in tshapes["conv_same_small_cout"]),
          flush=True)
    if not math.isfinite(float(r["loss"])) or float(r["skipped"]) != 0.0:
        fail("the DRS train step's loss is not finite")
    check_function_grads(tshapes, dev, cfg)
    train_rows = check_kernels({name: tshapes[name] for name in (
        "conv_same_small_cout", "tapconv_valid", "conv_same_small_cout_dgrad",
        "tapconv_valid_dgrad")}, tlaunches, dev, cfg, card, "DRS train step", "_drs")
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(20):
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    walls.sort()
    wall, busy, n_launch, _ = profiled(step)
    audio_s = TRAIN_BATCH * TRAIN_CROP / cfg.data.sr
    print(f"real: DRS step at batch {TRAIN_BATCH} x {TRAIN_CROP} samples: median "
          f"{walls[10]:.2f} ms over 20 steps (min {walls[0]:.2f}, max {walls[-1]:.2f}), "
          f"{audio_s / walls[10] * 1e3:.1f} audio-s/s per GPU; under the profiler "
          f"{wall:.2f} ms, {n_launch} launches, device busy {busy:.2f} ms, idle "
          f"share {1 - busy / walls[10]:.3f} of the median [{card}]", flush=True)
    del tmodel, opt

    # (d) card vs CPU, batch 4, dropout off; the initial BN's two leaves, sums
    # that cancel to a small part of their terms, held by their float64 witness
    card_vs_cpu_step("real: DRS train", cfg, noisy, clean, dev, SEED + 31,
                     witness_bn="initial_bn")

    # (e) kernel 2 at the real classes off the path
    check_real_off_path(dev)

    # a row of the enhance call carries the train step's numbers under
    # "train_step"; a kernel the enhance call does not launch (the conv entry
    # and the input gradients) is a row of the train step's
    for row in rows:
        row["launches_train"] = tlaunches.get(row["name"][:-len("_drs")], 0)
    enhance_rows = {r["name"]: r for r in rows}
    for row in train_rows:
        if row["name"] in enhance_rows:
            enhance_rows[row["name"]]["train_step"] = {
                k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                    "bound_by", "max_abs_err", "shapes")}
        else:
            row["launches_train"] = row["launches"]
            row["launches_enhance"] = launches.get(row["name"][:-len("_drs")], 0)
            rows.append(row)
    return rows


def bf16_config(cfg):
    """``cfg`` at ``--dtype bfloat16``: both operand types bf16."""
    import dataclasses

    return cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"),
                       stft=dataclasses.replace(cfg.stft, dft_dtype="bfloat16"))


def bf16_band(want32):
    """``compare(what, on_card, on_cpu)`` for a bf16 result: card against CPU
    within half of the CPU's own bf16 to float32 distance on that input
    (``want32``, the float32 model's output there) and within 0.1 absolute,
    the JAX package's bound on its bf16 path."""
    def compare(what, on_card, on_cpu):
        d = float((on_card - on_cpu).abs().max())
        ref = float((on_cpu - want32).abs().max())
        print(f"{what} card vs CPU at bf16: max |diff| {d:.3e}; the CPU's bf16 against "
              f"its float32 {ref:.3e} (limit half of it, and 0.1)", flush=True)
        if not (d <= 0.5 * ref and d <= 0.1):
            fail(f"card and CPU disagree on {what} at bf16")
    return compare


def expect_launches(what, launches, want):
    """Every kernel launched exactly as ``want`` says, and nothing else."""
    got = {k: n for k, n in launches.items() if n}
    if got != want:
        fail(f"{what}: launches {got}, expected {want} (a float32 class in a bf16 "
             "path, or a count off)")


def check_bf16_off_path(dev, cfg) -> None:
    """The bf16 classes of kernels 1 and 3 where the paths do not take them,
    against their plain versions: each call launches the body the shape
    routes to once; where both of kernel 3's bodies take a shape, both; the
    bf16 packing kernel at both chunk widths bit for bit against
    ``pack_weights_bf16``."""
    import dataclasses

    import torch

    from dcs_net_tpu_torch.dsp import stft as dsp
    from dcs_net_tpu_torch.dsp import stft_cuda
    from dcs_net_tpu_torch.ops import cuda_conv as cc
    from dcs_net_tpu_torch.ops import cuda_tapconv as ct
    from dcs_net_tpu_torch.utils.cuda_lib import ptr

    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    b16 = torch.bfloat16
    for B, n, n_fft, hop, center, drop_dc in DENSE_BF16_EXTRA:
        scfg = dataclasses.replace(cfg.stft, n_fft=n_fft, hop=hop, win_length=n_fft,
                                   center=center, drop_dc=drop_dc, dft_dtype="bfloat16")
        body = stft_cuda.choose_entry(n_fft, hop, "bfloat16")
        plan = dsp._analysis_plan(scfg, dev)
        cos_b, sin_b = dsp._bf16_bases(dsp._dft_basis_eff, scfg, dev)
        x = torch.randn((B, n), generator=g, device=dev) * 0.3
        kern = {"dense_bf16": stft_cuda.KERNEL_DENSE_BF16,
                "dense_bf16_chunked": stft_cuda.KERNEL_DENSE_BF16_CHUNKED}[body]
        before = kern.launches
        got = stft_cuda.stft_analysis(x, plan)
        want = stft_cuda.stft_dft_plain(x.to(b16).float(), cos_b, sin_b, hop, plan.pad)
        torch.cuda.synchronize()
        rel = rel_err(got, want)
        print(f"kernel stft ({body}) off the path: x ({B}, {n}) n_fft {n_fft} hop {hop} "
              f"center {center} -> {tuple(got[0].shape)}: rel_err={rel:.3e}", flush=True)
        if kern.launches - before != 1 or not math.isfinite(rel) or rel > REL_TOL:
            fail(f"stft ({body}) at n_fft {n_fft}, hop {hop}: error {rel:.3e}, "
                 f"{kern.launches - before} launches")
    for shape, tile in GATE_BF16_EXTRA:
        re, im = (torch.randn(shape, generator=g, device=dev).to(b16) for _ in range(2))
        w = (torch.randn((7, 7, 4, 2), generator=g, device=dev) * 0.3).to(b16)
        if tile == "unaligned":
            # x one bf16 off its 16-byte alignment: the pair serves it
            re = torch.randn(re.numel() + 1, generator=g, device=dev).to(b16)[1:].view(shape)
        want = cc.sa_gate_bf16_plain(cc.sa_pool_bf16_plain(re, im), w, re, im)
        fused = cc.fused_takes(re, im)
        before = (cc.FUSED_BF16.launches, cc.POOL_BF16.launches, cc.GATE_BF16.launches)
        got = (cc.sa_fused_bf16(re, im, w, tile=tile) if isinstance(tile, tuple)
               else cc.spatial_gate(re, im, w))
        torch.cuda.synchronize()
        n = tuple(k.launches - b for k, b in zip((cc.FUSED_BF16, cc.POOL_BF16, cc.GATE_BF16),
                                                 before))
        rel = max(rel_err(a.float(), b.float()) for a, b in zip(got, want))
        route = "fused" if isinstance(tile, tuple) or fused else "pair"
        print(f"kernel sa_fused_bf16 off the path: x {shape} tile {tile}: {route}, "
              f"launches (fused, pool, gate) {n}, rel_err={rel:.3e}", flush=True)
        if (n != ((1, 0, 0) if route == "fused" else (0, 1, 1)) or not math.isfinite(rel)
                or rel > BF16_REL_TOL):
            fail(f"the bf16 gate at {shape}, tile {tile}: error {rel:.3e}, launches {n}")
    for shape, n, (dh, dw), pad in TAPCONV_BF16_EXTRA:
        x = torch.randn(shape, generator=g, device=dev).to(b16)
        w = (torch.randn((dh * dw, shape[-1], n), generator=g, device=dev) * 0.1).to(b16)
        want = ct.tapconv_valid_bf16_plain(ct._pad(x, pad), w, dh, dw)
        route = ct.bf16_body(*shape, n, dh, dw, pad)
        bodies = ["staged", "tap"] if route == "staged" else ["tap"]
        errs = []
        for body in bodies:
            kern = ct.KERNEL_BF16 if body == "staged" else ct.KERNEL_BF16_TAP
            before = kern.launches
            got = (ct.tapconv_valid(x, w, dh, dw, pad) if body == route else
                   ct._launch(x, w, dh, dw, pad, body=body))
            torch.cuda.synchronize()
            rel = rel_err(got.float(), want.float())
            errs.append(f"{body} {rel:.3e}")
            if kern.launches - before != 1 or not math.isfinite(rel) or rel > BF16_REL_TOL:
                fail(f"tapconv_valid_bf16 ({body}) at {shape} -> {n}, {dh}x{dw}: error "
                     f"{rel:.3e}, {kern.launches - before} launches")
        print(f"kernel tapconv_valid_bf16 off the path: x {shape} {dh}x{dw} pad {pad} -> {n}: "
              f"routed to the {route} body; rel_err " + ", ".join(errs), flush=True)
        for kb in (ct.STAGED_KB, ct.BK):
            bn = ct.tile_n(n)
            want_packed = ct.pack_weights_bf16(w, bn, kb)
            packed = torch.empty_like(want_packed)
            ct.PACK_BF16(dev, ptr(w), ptr(packed), dh * dw, shape[-1], n, bn, kb)
            torch.cuda.synchronize()
            if not torch.equal(packed.view(torch.int16), want_packed.view(torch.int16)):
                fail(f"tapconv_pack_bf16 at {shape} -> {n}, kb {kb}: layout differs from "
                     f"pack_weights_bf16")



def check_conv_bf16_off_path(dev) -> None:
    """Kernel 2's bf16 conv entry (the tensor-core body) where the train
    path does not take it, at its four classes, against the plain versions
    (``BF16_REL_TOL``): ``CONV_BF16_EXTRA``'s shapes routed (the forward
    classes with a bias, the input gradients' on ``dgrad_kernel`` of the
    forward's w) and forced onto ``CONV_BF16_TILES`` where they fit; at Cin 1
    x one bf16 off its 4-byte line (its pixel pairs staged by two loads),
    at Cin 2 and 4 such an x refused. Each call launches the class's
    counter once, and nothing else."""
    import torch

    from dcs_net_tpu_torch.ops import cuda_conv as cc

    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    b16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(b16)

    for (cin, cout), tiles in CONV_BF16_TILES.items():
        dgrad = (cin, cout) in ((2, 4), (1, 2))
        kern = cc.DGRAD_BF16 if dgrad else cc.KERNEL_BF16
        wf = randn(7, 7, cout, cin, scale=0.2) if dgrad else randn(7, 7, cin, cout, scale=0.2)
        wk = cc.dgrad_kernel(wf) if dgrad else wf
        bk = (torch.zeros(cout, device=dev) if dgrad
              else torch.randn(cout, generator=g, device=dev))
        for B, H, W in CONV_BF16_EXTRA:
            x = randn(B, H, W, cin)
            want = (cc.conv2d_same_small_cout_dgrad_bf16_plain(x, wf) if dgrad
                    else cc.conv2d_same_small_cout_bf16_plain(x, wk, bk))
            torch.cuda.synchronize()
            before = launch_counts()
            errs = {"routed": rel_err(cc._same_conv(x, wk, bk, dgrad), want)}
            for tile in tiles:
                if cc.mma_fits(B, H, W, cin, cout, tile):
                    errs[f"tile {tile}"] = rel_err(cc.launch_conv(x, wk, bk, tile, dgrad), want)
            off = torch.empty(x.numel() + 1, device=dev, dtype=b16)[1:].view(x.shape).copy_(x)
            if cin == 1:
                errs["x one bf16 off"] = rel_err(cc._same_conv(off, wk, bk, dgrad), want)
            else:
                try:
                    cc._same_conv(off, wk, bk, dgrad)
                    fail(f"the bf16 conv entry took x off its {2 * cin}-byte pixel at "
                         f"{(B, H, W, cin)}")
                except ValueError:
                    pass
            torch.cuda.synchronize()
            after = launch_counts()
            got = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
            worst = max(errs, key=errs.get)
            print(f"kernel {kern.name} off the path: x ({B}, {H}, {W}, {cin}) -> {cout}, tile "
                  f"{cc.mma_tile(B, H, W, cin, cout)}: {len(errs)} checks, worst {worst} "
                  f"rel_err={errs[worst]:.3e}", flush=True)
            if got != {kern.name: len(errs)}:
                fail(f"{kern.name} at {(B, H, W, cin)}: launches {got}, expected "
                     f"{ {kern.name: len(errs)} }")
            for k, v in errs.items():
                if not math.isfinite(v) or v > BF16_REL_TOL:
                    fail(f"{kern.name} ({k}) at {(B, H, W, cin)}: error {v:.3e} exceeds "
                         f"{BF16_REL_TOL}")


def check_dgrad_bf16_off_path(dev) -> None:
    """Kernel 3's bf16 input gradient where the paths do not take it
    (``DGRAD_BF16_EXTRA``), on the forward's packing of w made as the
    forward makes it, against its plain version: one launch of the body the
    shape routes to, none of the flipped packing but for the tap body."""
    import torch

    from dcs_net_tpu_torch.ops import cuda_tapconv as ct

    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    b16 = torch.bfloat16
    kernels = {"narrow": ct.DGRAD_NARROW_BF16, "staged": ct.DGRAD_BF16,
               "tap": ct.DGRAD_BF16_TAP}
    for shape, n, pad in DGRAD_BF16_EXTRA:
        B, H, W, cin = shape
        ho, wo = H + pad[0] + pad[1] - 2, W + pad[2] + pad[3] - 2
        w = (torch.randn((9, cin, n), generator=g, device=dev) * 0.1).to(b16)
        gy = torch.randn((B, ho, wo, n), generator=g, device=dev).to(b16)
        fbody = ct.bf16_body(B, H, W, cin, n, 3, 3, pad)
        packing = ct.pack_bf16(w, ct.tile_n(n), ct.STAGED_KB if fbody == "staged" else ct.BK)
        body = ct.dgrad_body_bf16(B, ho, wo, n, cin, 3, 3, ct.dgrad_pad_bf16(pad, 3, 3))
        counts = {k: kn.launches for k, kn in kernels.items()}
        packs = ct.DGRAD_PACK_BF16.launches
        got = ct._launch_dgrad(gy, w, 3, 3, pad, (H, W), packing)
        want = ct.tapconv_dgrad_bf16_plain(gy, w, 3, 3, pad, (H, W))
        torch.cuda.synchronize()
        rel = rel_err(got.float(), want.float())
        n_body = kernels[body].launches - counts[body]
        n_pack = ct.DGRAD_PACK_BF16.launches - packs
        print(f"kernel tapconv_valid_dgrad_bf16 off the path: dx {shape} from g "
              f"{tuple(gy.shape)} pad {pad}: the {body} body (forward {fbody}, packing "
              f"kb {packing[2]}), launches {n_body} + {n_pack} packings, "
              f"rel_err={rel:.3e}", flush=True)
        if (n_body != 1 or n_pack != (body == "tap") or not math.isfinite(rel)
                or rel > BF16_REL_TOL):
            fail(f"tapconv_valid_dgrad_bf16 ({body}) at {shape}, N {n}, pad {pad}: error "
                 f"{rel:.3e}, {n_body} launches, {n_pack} packings")

def fused_sweep_tiles(B, H, W, C):
    """The plan's tile for the fused gate at (B, H, W, C) and its
    neighbours: twice and half as wide, twice and half as tall, spanning the
    height at 8 columns; those the entry takes."""
    from dcs_net_tpu_torch.ops import cuda_conv

    th, tw = cuda_conv.fused_tile(B, H, W, C)
    tiles = [(th, tw), (th, 2 * tw), (th, tw // 2), (min(H, 2 * th), tw),
             (max(1, th // 2), tw), (max(1, th // 2), 2 * tw), (min(H, 32), 8)]
    out = []
    for t in tiles:
        if t not in out and t[1] >= 8 and cuda_conv.fused_fits(B, H, W, C, t):
            out.append(t)
    return out


def check_fused_sweep(dev, card, sites) -> None:
    """Kernel 2's fused bf16 gate at each site shape of the enhance call
    under the tiles of :func:`fused_sweep_tiles`, each against the plain
    version, so that ``fused_tile``'s pick reads against the sweep's best."""
    import torch

    from dcs_net_tpu_torch.ops import cuda_conv
    from dcs_net_tpu_torch.utils.timing import graph_ms

    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    b16 = torch.bfloat16
    for shape in sorted(set(sites)):
        re, im = (torch.randn(shape, generator=g, device=dev).to(b16) for _ in range(2))
        w = (torch.randn((7, 7, 4, 2), generator=g, device=dev) * 0.3).to(b16)
        want = cuda_conv.sa_gate_bf16_plain(cuda_conv.sa_pool_bf16_plain(re, im), w, re, im)
        times = {}
        for tile in fused_sweep_tiles(*shape):
            run = lambda t=tile: cuda_conv.sa_fused_bf16(re, im, w, tile=t)  # noqa: E731
            got = run()
            rel = max(rel_err(a.float(), b.float()) for a, b in zip(got, want))
            if not math.isfinite(rel) or rel > BF16_REL_TOL:
                fail(f"sa_fused_bf16 at {shape} under tile {tile}: error {rel:.3e}")
            times[tile] = graph_ms(run, 20)
        plan = cuda_conv.fused_tile(*shape)
        best = min(times, key=times.get)
        print(f"kernel sa_fused_bf16 sweep: x {shape}; (th, tw) ms: "
              + ", ".join(f"{k}={v:.4f}" for k, v in times.items())
              + f"; the plan {plan} {times[plan]:.4f} ms, the sweep's best {best} "
              f"{times[best]:.4f} [{card}]", flush=True)


def check_span_sweep(dev, cfg, card) -> None:
    """Kernel 1's span body at the serving paths' shapes (the enhance call,
    a test utterance, the 30 s stream) under every (frames, groups) worth
    timing, each against the plain version, so that ``span_plan``'s pick
    reads against the sweep's best."""
    import dataclasses

    import torch

    from dcs_net_tpu_torch.dsp import stft as dsp
    from dcs_net_tpu_torch.dsp import stft_cuda
    from dcs_net_tpu_torch.ops import cuda_tapconv
    from dcs_net_tpu_torch.utils.timing import graph_ms

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    scfg = dataclasses.replace(cfg.stft, dft_dtype="bfloat16")
    plan = dsp._analysis_plan(scfg, dev)
    cos_b, sin_b = dsp._bf16_bases(dsp._dft_basis_eff, scfg, dev)
    sms = cuda_tapconv._sm_count(dev)
    for B, n in ((BATCH, SECONDS * SR), (3, TRAIN_CROP), (1, 30 * SR)):
        x = torch.randn((B, n), generator=g, device=dev) * 0.3
        T = scfg.num_frames(n)
        want = stft_cuda.stft_dft_plain(x.to(torch.bfloat16).float(), cos_b, sin_b,
                                        scfg.hop, plan.pad)
        chosen = stft_cuda.span_plan(scfg.n_fft, scfg.hop, scfg.n_bins, B, T, sms)
        times = {}
        for frames in stft_cuda.SPAN_FRAMES:
            tiles = -(-T // frames)
            for groups in sorted({1, 2, 4, 8, 16, 32, tiles} & set(range(1, tiles + 1))):
                if B * 8 * groups < 16 or (frames, groups) in times:
                    continue
                run = (lambda fg=(frames, groups):
                       stft_cuda._launch_span(x, plan, T, fg))
                rel = rel_err(run(), want)
                if not math.isfinite(rel) or rel > REL_TOL:
                    fail(f"stft_dense_bf16 at ({B}, {n}) under {(frames, groups)}: error "
                         f"{rel:.3e}")
                times[(frames, groups)] = graph_ms(run, 10)
        if chosen not in times:
            times[chosen] = graph_ms(lambda: stft_cuda._launch_span(x, plan, T, chosen), 10)
        best = min(times, key=times.get)
        print(f"kernel stft_dense_bf16 sweep: x ({B}, {n}) n_fft {scfg.n_fft} hop {scfg.hop}; "
              f"(frames, groups) ms: " + ", ".join(f"{k}={v:.4f}" for k, v in times.items())
              + f"; the plan {chosen} {times[chosen]:.4f} ms, the sweep's best {best} "
              f"{times[best]:.4f} [{card}]", flush=True)


def check_bf16(dev, card):
    """Phase "bf16" (see the module's docstring). Returns its kernel rows."""
    import dataclasses

    import torch

    from dcs_net_tpu_torch.cli import enhance as cli_enhance
    from dcs_net_tpu_torch.cli import test as cli_test
    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.data.audio_io import read_wav, write_wav
    from dcs_net_tpu_torch.models.enhance import enhance_full, enhance_streaming
    from dcs_net_tpu_torch.models.graphed import GraphCache
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.ops import cuda_conv
    from dcs_net_tpu_torch.train import steps
    from dcs_net_tpu_torch.train.checkpoint import CheckpointManager
    from dcs_net_tpu_torch.train.loop import Trainer
    from dcs_net_tpu_torch.utils import cuda_lib

    t0 = time.perf_counter()
    cfg = config_for_variant("dcs")
    c16 = bf16_config(cfg)
    model32 = DCSNet(cfg.model, cfg.quirks, device=dev, seed=SEED).eval()
    perturb_bn(model32, SEED + 1)
    weights = model32.state_dict()

    def pair(config, device):
        """The float32 and the bf16 model of ``config`` on ``device`` with
        ``weights`` loaded (the same float32 tensors serve both)."""
        out = []
        for c in (config, bf16_config(config)):
            m = DCSNet(c.model, c.quirks, device=device, seed=SEED).eval()
            m.load_state_dict({k: v.to(device) for k, v in weights.items()})
            out.append(m)
        return out

    model = pair(cfg, dev)[1]
    cpu32, cpu16 = pair(cfg, "cpu")
    x = torch.from_numpy(speech_like(BATCH, SECONDS * SR, SEED + 2)).to(dev)
    rows = []

    # (a) enhance_full, 4 x 4 s
    shapes = discover_shapes(lambda: enhance_full(model, x, c16))
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    out = enhance_full(model, x, c16)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"bf16: enhance_full launches {launches}", flush=True)
    expect_launches("bf16: one enhance call", launches,
                    {"stft_dense_bf16": 1, **DCS_EVAL_FORWARD_BF16})
    if tuple(out.shape) != (BATCH, SECONDS * SR) or not bool(torch.isfinite(out).all()):
        fail(f"bf16 enhance_full returned {tuple(out.shape)} or non-finite samples")
    short = torch.from_numpy(speech_like(1, SR, SEED + 3))
    on_cpu, on_cpu32 = enhance_full(cpu16, short, c16), enhance_full(cpu32, short, cfg)
    bf16_band(on_cpu32)("bf16: 1 s request", enhance_full(model, short.to(dev), c16).cpu(),
                        on_cpu)
    check_graphed(f"bf16: DCS enhance_full at bf16, {BATCH} requests x {SECONDS} s",
                  lambda g: enhance_full(model, x, c16, graphs=g),
                  {"stft_dense_bf16": 1, **DCS_EVAL_FORWARD_BF16}, card,
                  (lambda g: enhance_full(model, short.to(dev), c16, graphs=g), on_cpu),
                  compare=bf16_band(on_cpu32), profile=BF16_PROFILED)
    rows += check_kernels({k: shapes[k] for k in BF16_ROWS}, launches, dev, c16, card,
                          "bf16 enhance call")
    # PR 15's pair at the same sites, off the path
    sites = [a[:4] for a in shapes["sa_fused_bf16"]]
    rows += check_kernels({"sa_pool_bf16": sites,
                           "sa_gate_bf16": [a + cuda_conv.gate_tile(*a[:3], 4, 2)
                                            for a in sites]},
                          launches, dev, c16, card, "bf16 enhance call")
    check_fused_sweep(dev, card, sites)
    check_bf16_off_path(dev, cfg)
    check_span_sweep(dev, cfg, card)
    check_forward_sweep(dev, card, bf16=True)

    # (b) the 30 s stream in groups of 8
    seconds, chunk, overlap, group = 30, 256, 64, 8
    x30 = torch.from_numpy(speech_like(1, seconds * SR, SEED + 5)).to(dev)
    frames = 1 + seconds * SR // cfg.stft.hop
    n_groups = -(-max(1, math.ceil(max(frames - overlap, 1) / (chunk - overlap))) // group)
    stream_shapes = discover_shapes(lambda: enhance_streaming(model, x30, c16))
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    out = enhance_streaming(model, x30, c16)
    torch.cuda.synchronize()
    stream_launches = launch_counts()
    expect_launches(f"bf16: the {seconds} s stream", stream_launches,
                    {"stft_dense_bf16": 1, **{k: n * n_groups for k, n in
                                              DCS_EVAL_FORWARD_BF16.items()}})
    if tuple(out.shape) != (1, seconds * SR) or not bool(torch.isfinite(out).all()):
        fail("the bf16 stream returned non-finite samples")
    short3 = torch.from_numpy(speech_like(1, 3 * SR, SEED + 6))
    cpu_short3 = enhance_streaming(cpu16, short3, c16)
    check_graphed(f"bf16: DCS enhance_streaming at bf16, {seconds} s, {n_groups} groups "
                  f"of {group}", lambda g: enhance_streaming(model, x30, c16, graphs=g),
                  DCS_EVAL_FORWARD_BF16, card,
                  (lambda g: enhance_streaming(model, short3.to(dev), c16, graphs=g),
                   cpu_short3), compare=bf16_band(enhance_streaming(cpu32, short3, cfg)),
                  profile=())
    rows += check_kernels({k: stream_shapes[k][:n] for k, n in (
        ("sa_fused_bf16", 13), ("tapconv_valid_bf16", 6), ("tapconv_valid_bf16_tap", 1))},
        stream_launches, dev, c16, card, "bf16 streaming chunk group", "_stream")

    # (c) the carried 10 s stream of the streaming preset
    scfg = config_for_variant("dcs", streaming=True)
    s16 = bf16_config(scfg)
    smodel32 = DCSNet(scfg.model, scfg.quirks, device=dev, seed=SEED).eval()
    perturb_bn(smodel32, SEED + 1)
    smodel = DCSNet(s16.model, s16.quirks, device=dev, seed=SEED).eval()
    smodel.load_state_dict(smodel32.state_dict())
    scpu16 = DCSNet(s16.model, s16.quirks, device="cpu", seed=SEED).eval()
    scpu16.load_state_dict({k: v.cpu() for k, v in smodel32.state_dict().items()})
    scpu32 = DCSNet(scfg.model, scfg.quirks, device="cpu", seed=SEED).eval()
    scpu32.load_state_dict(scpu16.state_dict())
    x10 = torch.from_numpy(speech_like(1, 10 * SR, SEED + 7)).to(dev)
    kw = dict(chunk_frames=chunk, overlap=0, carry_lstm_state=True)
    carry_shapes = discover_shapes(lambda: enhance_streaming(smodel, x10, s16, **kw))
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    carried = enhance_streaming(smodel, x10, s16, **kw)
    torch.cuda.synchronize()
    carry_launches = launch_counts()
    n_chunks = math.ceil((1 + 10 * SR // cfg.stft.hop) / chunk)
    expect_launches("bf16: the carried 10 s stream", carry_launches,
                    {"stft_dense_bf16": 1, **{k: n * n_chunks for k, n in
                                              DCS_EVAL_FORWARD_BF16.items()}})
    if not bool(torch.isfinite(carried).all()):
        fail("the carried bf16 stream is not finite")
    short2 = torch.from_numpy(speech_like(1, 2 * SR, SEED + 8))
    kw2 = dict(chunk_frames=64, overlap=0, carry_lstm_state=True)
    check_graphed("bf16: carry, streaming preset at bf16, 10 s in chunks of 256",
                  lambda g: enhance_streaming(smodel, x10, s16, **kw, graphs=g),
                  DCS_EVAL_FORWARD_BF16, card,
                  (lambda g: enhance_streaming(smodel, short2.to(dev), s16, **kw2, graphs=g),
                   enhance_streaming(scpu16, short2, s16, **kw2)),
                  compare=bf16_band(enhance_streaming(scpu32, short2, scfg, **kw2)),
                  profile=())
    rows += check_kernels({k: carry_shapes[k][:n] for k, n in (
        ("sa_fused_bf16", 13), ("tapconv_valid_bf16", 6), ("tapconv_valid_bf16_tap", 1))},
        carry_launches, dev, s16, card, "carried bf16 chunk", "_carry")
    del smodel, smodel32, scpu16, scpu32

    # (d) one test utterance's eval forward at batch 1
    rng = np.random.default_rng(SEED + 9)
    waves = [torch.from_numpy(speech_like(1, TRAIN_CROP, SEED + 10)),
             torch.from_numpy((0.2 * rng.standard_normal((1, TRAIN_CROP))).astype(np.float32))]
    waves[0] = waves[0] + waves[1]

    def flat(out, losses=True):
        return torch.cat(([torch.stack(list(out[0].values())).reshape(-1)] if losses else [])
                         + [v.reshape(-1) for v in out[1].values()])

    eval_shapes = discover_shapes(lambda: steps.eval_waves(model, *(w.to(dev) for w in waves),
                                                           c16))
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    steps.eval_waves(model, *(w.to(dev) for w in waves), c16)
    torch.cuda.synchronize()
    eval_launches = launch_counts()
    expect_launches("bf16: one test utterance's eval forward", eval_launches,
                    {"stft_dense_bf16": 1, **DCS_EVAL_FORWARD_BF16})
    check_graphed("bf16: one test utterance's eval forward at bf16, batch 1",
                  lambda g: flat(steps.eval_waves(model, *(w.to(dev) for w in waves), c16, g)),
                  {"stft_dense_bf16": 1, **DCS_EVAL_FORWARD_BF16}, card,
                  (lambda g: flat(steps.eval_waves(model, *(w.to(dev) for w in waves), c16, g),
                                  losses=False),
                   flat(steps.eval_waves(cpu16, *waves, c16), losses=False)),
                  compare=bf16_band(flat(steps.eval_waves(cpu32, *waves, cfg), losses=False)),
                  profile=BF16_PROFILED)
    rows += check_kernels({k: eval_shapes[k] for k in BF16_ROWS}, eval_launches, dev, c16,
                          card, "test utterance", "_eval")
    del cpu16, cpu32

    # (h) DC (DCS's complex attention, no subtractive mask) at bf16 through
    # the fused gate: its own seeded weights, BN off its init
    dcfg = config_for_variant("dc")
    d16 = bf16_config(dcfg)
    dc32 = DCSNet(dcfg.model, dcfg.quirks, device=dev, seed=SEED + 12).eval()
    perturb_bn(dc32, SEED + 13)
    dc16 = DCSNet(d16.model, d16.quirks, device=dev, seed=SEED).eval()
    dc16.load_state_dict(dc32.state_dict())
    dcpu16, dcpu32 = (DCSNet(c.model, c.quirks, device="cpu", seed=SEED).eval()
                      for c in (d16, dcfg))
    for m in (dcpu16, dcpu32):
        m.load_state_dict({k: v.cpu() for k, v in dc32.state_dict().items()})
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    out = enhance_full(dc16, x, d16)
    torch.cuda.synchronize()
    expect_launches("bf16: one DC enhance call", launch_counts(),
                    {"stft_dense_bf16": 1, **DCS_EVAL_FORWARD_BF16})
    if tuple(out.shape) != (BATCH, SECONDS * SR) or not bool(torch.isfinite(out).all()):
        fail(f"bf16 DC enhance_full returned {tuple(out.shape)} or non-finite samples")
    dc_cpu = enhance_full(dcpu16, short, d16)
    check_graphed(f"bf16: DC enhance_full at bf16, {BATCH} requests x {SECONDS} s",
                  lambda g: enhance_full(dc16, x, d16, graphs=g),
                  {"stft_dense_bf16": 1, **DCS_EVAL_FORWARD_BF16}, card,
                  (lambda g: enhance_full(dc16, short.to(dev), d16, graphs=g), dc_cpu),
                  compare=bf16_band(enhance_full(dcpu32, short, dcfg)), profile=())
    del dc32, dc16, dcpu16, dcpu32

    # (f) the float32 model's ms beside the bf16 one's, in this process
    model32 = pair(cfg, dev)[0]
    torch.backends.cudnn.deterministic = True
    try:
        for what, runs in (
                (f"enhance_full, {BATCH} x {SECONDS} s",
                 [(m, c, lambda g, m=m, c=c: enhance_full(m, x, c, graphs=g))
                  for m, c in ((model32, cfg), (model, c16))]),
                (f"stream, {seconds} s",
                 [(m, c, lambda g, m=m, c=c: enhance_streaming(m, x30, c, graphs=g))
                  for m, c in ((model32, cfg), (model, c16))])):
            ms = []
            for _, c, run in runs:
                graphs = GraphCache()
                for _ in range(3):
                    run(graphs)
                ms.append((median_ms(lambda: run(graphs), 5), median_ms(lambda: run(None), 3)))
            (g32, e32), (g16, e16) = ms
            print(f"bf16: {what}: bf16 {g16:.2f} ms graphed, {e16:.2f} eager; float32 "
                  f"{g32:.2f} graphed, {e32:.2f} eager (medians, this process) [{card}]",
                  flush=True)
    finally:
        torch.backends.cudnn.deterministic = False
    del model32

    # (g) the serving CLIs at --dtype bfloat16, on a float32 checkpoint
    with tempfile.TemporaryDirectory(prefix="dcs_bf16_") as tmp:
        src, dst = os.path.join(tmp, "noisy.wav"), os.path.join(tmp, "clean.wav")
        write_wav(src, speech_like(1, 2 * SR, SEED + 11)[0], SR)
        for flags in ([], ["--stream", "--chunk-frames", "128"],
                      ["--carry", "--chunk-frames", "128"]):
            cli_enhance.main(["dcs", "--in", src, "--out", dst, "--dtype", "bfloat16", *flags])
            audio, sr = read_wav(dst)
            if sr != SR or audio.shape != (2 * SR,) or not np.all(np.isfinite(audio)):
                fail(f"bf16 CLI output with {flags}: sr {sr}, shape {audio.shape}")
            print(f"bf16: cli.enhance --dtype bfloat16 {' '.join(flags) or '(full)'}: "
                  f"{audio.shape[0]} samples at {sr} Hz, finite", flush=True)
        ckpt = os.path.join(tmp, "ckpt")
        trainer = Trainer(cfg, device=dev, log_dir=os.path.join(tmp, "t32"),
                          pesq_fn=lambda *a: 0.0)
        trainer.init_state()
        trainer.model.load_state_dict(weights)
        trainer.save(CheckpointManager(ckpt), 0)
        metrics = cli_test.main(["dcs", "--synthetic", "--synthetic-n", "8", "--log-dir",
                                 tmp, "--ckpt-dir", ckpt, "--dtype", "bfloat16",
                                 "--no-tensorboard"])
        keys = ("test_stoi", "test_loss")
        if not all(np.isfinite(metrics.get(k, float("nan"))) for k in keys):
            fail(f"cli.test --dtype bfloat16: {metrics}")
        print(f"bf16: cli.test --dtype bfloat16 on a float32 checkpoint: "
              f"{ {k: round(v, 4) for k, v in metrics.items()} }", flush=True)
    rows += check_bf16_real(dev, card)
    print(f"bf16: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def check_bf16_real(dev, card):
    """Phase "bf16" (i)-(m): the real family at --dtype bfloat16, DRS at full
    width (its own seeded weights, BN off its init, float32; the bf16 model
    a model of its own, since a graph cache keys a module by its identity).
    Returns its kernel rows, named ``<kernel>_drs``."""
    import torch

    from dcs_net_tpu_torch.cli import enhance as cli_enhance
    from dcs_net_tpu_torch.cli import test as cli_test
    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.data.audio_io import read_wav, write_wav
    from dcs_net_tpu_torch.models.enhance import enhance_full, enhance_streaming
    from dcs_net_tpu_torch.models.graphed import GraphCache
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.train.checkpoint import CheckpointManager
    from dcs_net_tpu_torch.train.loop import Trainer
    from dcs_net_tpu_torch.utils import cuda_lib

    t0 = time.perf_counter()

    def models(cfg, seed, devices):
        """The float32 model of ``cfg`` on the CPU with seeded weights, BN off
        its init, and the bf16 model of the same weights on each device."""
        m32 = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=seed).eval()
        perturb_bn(m32, seed + 1)
        c16 = bf16_config(cfg)
        out = []
        for d in devices:
            m = DCSNet(c16.model, c16.quirks, device=d).eval()
            m.load_state_dict({k: v.to(d) for k, v in m32.state_dict().items()})
            out.append(m)
        return (m32, c16, *out)

    # (i) DRS enhance_full, 4 x 4 s
    cfg = config_for_variant("drs")
    cpu32, c16, model, cpu16 = models(cfg, SEED + 30, (dev, "cpu"))
    x = torch.from_numpy(speech_like(BATCH, SECONDS * SR, SEED + 32)).to(dev)
    shapes = discover_shapes(lambda: enhance_full(model, x, c16))
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    out = enhance_full(model, x, c16)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"bf16: DRS enhance_full launches {launches}", flush=True)
    expect_launches("bf16: one DRS enhance call", launches,
                    {"stft_dense_bf16": 1, **DRS_EVAL_FORWARD_BF16})
    if tuple(out.shape) != (BATCH, SECONDS * SR) or not bool(torch.isfinite(out).all()):
        fail(f"bf16 DRS enhance_full returned {tuple(out.shape)} or non-finite samples")
    short = torch.from_numpy(speech_like(1, SR, SEED + 33))
    on_cpu, on_cpu32 = enhance_full(cpu16, short, c16), enhance_full(cpu32, short, cfg)
    bf16_band(on_cpu32)("bf16: DRS 1 s request",
                        enhance_full(model, short.to(dev), c16).cpu(), on_cpu)
    check_graphed(f"bf16: DRS enhance_full at bf16, {BATCH} requests x {SECONDS} s",
                  lambda g: enhance_full(model, x, c16, graphs=g),
                  {"stft_dense_bf16": 1, **DRS_EVAL_FORWARD_BF16}, card,
                  (lambda g: enhance_full(model, short.to(dev), c16, graphs=g), on_cpu),
                  compare=bf16_band(on_cpu32), profile=BF16_PROFILED)
    rows = check_kernels({k: shapes[k] for k in DRS_BF16_ROWS}, launches, dev, c16, card,
                         "DRS bf16 enhance call", "_drs")
    pool, gate = rows[0], rows[1]
    print(f"bf16: the real gate at bf16 over the 13 sites of a DRS enhance call: pool + "
          f"gate {pool['ms'] + gate['ms']:.4f} ms (bound "
          f"{pool['bound_ms'] + gate['bound_ms']:.4f}) against the bf16 eager sequence's "
          f"{gate['eager_pool_and_gate_ms']:.4f} [{card}]", flush=True)
    check_real_off_path(dev, bf16=True)

    # (j) DRS streamed (3 s, groups of chunks) and carried (2 s, the
    # streaming preset) against the CPU
    three = torch.from_numpy(speech_like(1, 3 * SR, SEED + 34))
    bf16_band(enhance_streaming(cpu32, three, cfg))(
        "bf16: DRS streamed 3 s request", enhance_streaming(model, three.to(dev), c16).cpu(),
        enhance_streaming(cpu16, three, c16))
    scfg = config_for_variant("drs", streaming=True)
    s32, s16, smodel, scpu16 = models(scfg, SEED + 35, (dev, "cpu"))
    two = torch.from_numpy(speech_like(1, 2 * SR, SEED + 37))
    kw = dict(chunk_frames=64, overlap=0, carry_lstm_state=True)
    bf16_band(enhance_streaming(s32, two, scfg, **kw))(
        "bf16: DRS carried 2 s request (the streaming preset, chunks of 64)",
        enhance_streaming(smodel, two.to(dev), s16, **kw).cpu(),
        enhance_streaming(scpu16, two, s16, **kw))
    del s32, smodel, scpu16

    # (k) DR: one call's launches, a 1 s request card vs CPU
    dcfg = config_for_variant("dr")
    d32, d16, dr, dcpu16 = models(dcfg, SEED + 38, (dev, "cpu"))
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    got = enhance_full(dr, short.to(dev), d16)
    torch.cuda.synchronize()
    expect_launches("bf16: one DR enhance call", launch_counts(),
                    {"stft_dense_bf16": 1, **DRS_EVAL_FORWARD_BF16})
    bf16_band(enhance_full(d32, short, dcfg))("bf16: DR 1 s request", got.cpu(),
                                              enhance_full(dcpu16, short, d16))
    del d32, dr, dcpu16

    # (l) DRS's float32 model's ms a call beside the bf16 one's, in this process
    model32 = DCSNet(cfg.model, cfg.quirks, device=dev).eval()
    model32.load_state_dict({k: v.to(dev) for k, v in cpu32.state_dict().items()})
    torch.backends.cudnn.deterministic = True
    try:
        ms = []
        for m, c in ((model32, cfg), (model, c16)):
            graphs = GraphCache()
            for _ in range(3):
                enhance_full(m, x, c, graphs=graphs)
            ms.append((median_ms(lambda: enhance_full(m, x, c, graphs=graphs), 5),
                       median_ms(lambda: enhance_full(m, x, c), 3)))
        (g32, e32), (g16, e16) = ms
        print(f"bf16: DRS enhance_full, {BATCH} x {SECONDS} s: bf16 {g16:.2f} ms graphed, "
              f"{e16:.2f} eager; float32 {g32:.2f} graphed, {e32:.2f} eager (medians, this "
              f"process) [{card}]", flush=True)
    finally:
        torch.backends.cudnn.deterministic = False
    del model32, model, cpu16

    # (m) the serving CLIs at --dtype bfloat16 for DRS and DR: cli.enhance
    # (full, --stream and --carry) on seeded weights, cli.test on a float32
    # checkpoint, two test utterances
    with tempfile.TemporaryDirectory(prefix="dcs_bf16_drs_") as tmp:
        src, dst = os.path.join(tmp, "noisy.wav"), os.path.join(tmp, "clean.wav")
        write_wav(src, speech_like(1, 2 * SR, SEED + 39)[0], SR)
        for variant, flags in itertools.product(
                ("drs", "dr"), ([], ["--stream", "--chunk-frames", "128"],
                                ["--carry", "--chunk-frames", "128"])):
            cli_enhance.main([variant, "--in", src, "--out", dst, "--dtype", "bfloat16",
                              *flags])
            audio, sr = read_wav(dst)
            if sr != SR or audio.shape != (2 * SR,) or not np.all(np.isfinite(audio)):
                fail(f"bf16 {variant.upper()} CLI output with {flags}: sr {sr}, shape "
                     f"{audio.shape}")
            print(f"bf16: cli.enhance {variant} --dtype bfloat16 "
                  f"{' '.join(flags) or '(full)'}: {audio.shape[0]} samples at {sr} Hz, "
                  "finite", flush=True)
        ckpt = os.path.join(tmp, "ckpt")
        trainer = Trainer(cfg, device=dev, log_dir=os.path.join(tmp, "t32"),
                          pesq_fn=lambda *a: 0.0)
        trainer.init_state()
        trainer.model.load_state_dict({k: v.to(dev) for k, v in cpu32.state_dict().items()})
        trainer.save(CheckpointManager(ckpt), 0)
        metrics = cli_test.main(["drs", "--synthetic", "--synthetic-n", "8", "--log-dir",
                                 tmp, "--ckpt-dir", ckpt, "--dtype", "bfloat16",
                                 "--no-tensorboard"])
        keys = ("test_stoi", "test_loss")
        if not all(np.isfinite(metrics.get(k, float("nan"))) for k in keys):
            fail(f"cli.test drs --dtype bfloat16: {metrics}")
        print(f"bf16: cli.test drs --dtype bfloat16 on a float32 checkpoint: "
              f"{ {k: round(v, 4) for k, v in metrics.items()} }", flush=True)
    print(f"bf16: the real family's part {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def bf16_steps(cfg, noisy, clean, dev, seed, captures=None):
    """One train step at bf16 (``cfg`` at --dtype bfloat16) on the waves
    ``noisy``, ``clean`` (a batch of ``CARD_CPU_BATCH``), dropout off, from
    the same weights: on the card under cuDNN's deterministic algorithms
    ("card"), on the CPU ("cpu"), the CPU's float32 step ("cpu32"), and
    ``SUM_ORDER_WITNESSES`` CPU bf16 steps on the batch in other orders
    ("witness<i>"): the same function (the loss is the batch's mean, BN's
    statistics sum over the batch) with its sums in other orders. With a
    dict ``captures``, it gets ``capture_io`` of the card's and the CPU's
    bf16 steps ("card", "cpu") and of the same step in float64 on the CPU
    ("float64"; the float32 model in float64), and the weights ("weights").
    Returns {run: (metrics, gradients in float64, post-Adam parameters,
    seconds)}."""
    import dataclasses

    import torch

    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.train import steps
    from dcs_net_tpu_torch.train.optim import make_optimizer

    ncfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout_conv=0.0,
                                                 dropout_fc=0.0))
    c16 = bf16_config(ncfg)
    weights = {k: v.cpu().clone() for k, v in DCSNet(
        ncfg.model, ncfg.quirks, device="cpu", seed=seed).state_dict().items()}
    order = tuple(range(len(noisy)))
    others = [p for p in itertools.permutations(order) if p != order]
    picks = np.random.default_rng(seed).choice(len(others), SUM_ORDER_WITNESSES,
                                               replace=False)
    cpu = torch.device("cpu")
    runs = [("card", c16, dev, order, None), ("cpu", c16, cpu, order, None),
            ("cpu32", ncfg, cpu, order, None)]
    runs += [(f"witness{i}", c16, cpu, others[j], None) for i, j in enumerate(picks)]
    results = {}
    for key, c, d, perm, _ in runs:
        m = DCSNet(c.model, c.quirks, device=d, seed=seed)
        m.load_state_dict({k: v.to(d) for k, v in weights.items()})
        o = make_optimizer(m.parameters(), c.optim)
        perm = list(perm)
        if captures is not None and key in ("card", "cpu"):
            captures[key] = capture_io(m)
        torch.backends.cudnn.deterministic = True
        try:
            t1 = time.perf_counter()
            r = steps.train_step(m, o, steps.batch_from_waves(
                noisy[perm].to(d), clean[perm].to(d), c), c)
            metrics = {k: float(v) for k, v in r.items()}
        finally:
            torch.backends.cudnn.deterministic = False
        results[key] = (metrics,
                        {n: p.grad.detach().cpu().double() for n, p in m.named_parameters()},
                        {n: p.detach().cpu().clone() for n, p in m.named_parameters()},
                        time.perf_counter() - t1)
    if captures is not None:
        m = DCSNet(ncfg.model, ncfg.quirks, device="cpu", seed=seed).double()
        m.load_state_dict(weights)
        captures["float64"] = capture_io(m)
        captures["weights"] = weights
        t1 = time.perf_counter()
        steps.loss_and_grads(m, steps.batch_from_waves(noisy.cpu().double(),
                                                       clean.cpu().double(), ncfg), ncfg)
        print(f"bf16 steps: the float64 CPU step took {time.perf_counter() - t1:.1f} s",
              flush=True)
    return results


def capture_io(model):
    """Forward hooks on every module of ``model`` that holds a trainable
    parameter of its own. The dict returned gets, per module (by its dotted
    name), its calls, its positional inputs (``in``, detached) and the
    gradient that arrives at its output (``dy``; of a tuple output, at its
    first tensor)."""
    import torch

    got = {}

    def detach(v):
        if isinstance(v, (tuple, list)):
            return type(v)(detach(t) for t in v)
        return v.detach() if torch.is_tensor(v) else v

    def hook_for(name):
        def hook(mod, inputs, out):
            rec = got.setdefault(name, {"calls": 0})
            rec["calls"] += 1
            rec["in"] = detach(inputs)
            main = out[0] if isinstance(out, tuple) else out
            main.register_hook(lambda g: rec.__setitem__("dy", g.detach()))
        return hook

    for name, mod in model.named_modules():
        if any(p.requires_grad for p in mod.parameters(recurse=False)):
            mod.register_forward_hook(hook_for(name))
    return got


def float64_leaf_witness(what, names, captures, c16, c32, card_grads, control, clip):
    """The float64 witness of the bf16 gradient leaves ``names`` of a real
    net's step (``bf16_steps``'s ``captures``), as ``bn_witness`` holds a
    leaf that no run resolves to its band, in two parts for each module
    that owns one of them. (1) The card's input to the module and the
    gradient that arrives at its output have the CPU bf16 step's types; as
    the tests hold a bf16 step's gradient (the whole within twice, each leaf
    within four times its own distance), their L2 distances from the float64
    step's, each relative to its norm, lie together within
    ``FLOAT64_WITNESS`` times the CPU bf16 step's, each within twice that
    (the CPU's floored at 2^-23). (2) The
    leaf against the float64 leaf of the card's own input and output
    gradient there (the module run in float64 on them): a conv, transposed
    conv or linear leaf, sums of at most n exact bf16 products (n the
    output's pixels) rounded to bf16 r times (the transposed conv's twice:
    each folded tap's sum, then the weight's sum of them), element by
    element within (r 2^-8 + (n - 1) 2^-24) (1 + 2^-8)^r of the sum of its
    terms' magnitudes: r bf16 roundings of partial sums and the float32
    rounding of a sum in any order; a BN leaf within
    ceil(log2 n) units of 2^-24 of the magnitudes its float32 sums add
    (``bn_witness``); an LSTM leaf, whose terms are the recurrence's own,
    within ``FLOAT64_WITNESS`` times the CPU bf16 LSTM's L2 distance from
    it on the same input and output gradient. ``clip`` is the card's clip
    factor; ``control`` the CPU's float32 step's leaves, a step with other
    rounding throughout: read by (2), it must leave the witness somewhere
    (that (2) tells the card's leaf from another run's)."""
    import torch

    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.ops import real_layers as rl

    nets = {}
    for key, c in (("bf16", c16), ("float64", c32)):
        nets[key] = DCSNet(c.model, c.quirks, device="cpu")
        if key == "float64":
            nets[key] = nets[key].double()
        nets[key].load_state_dict(captures["weights"])

    def tensors(v):
        if isinstance(v, (tuple, list)):
            return [t for x in v for t in tensors(x)]
        return [v] if torch.is_tensor(v) else []

    def cast(v, fn):
        if isinstance(v, (tuple, list)):
            return type(v)(cast(t, fn) for t in v)
        return fn(v.cpu()) if torch.is_tensor(v) else v

    def local(net, owner, inputs, dy, fn):
        """The owner's gradients in float64 (times ``clip``) from ``inputs``
        and ``dy``, each first mapped by ``fn``, on ``nets[net]``."""
        mod = nets[net].get_submodule(owner)
        for q in mod.parameters(recurse=False):
            q.grad = None
        out = mod(*cast(inputs, fn))
        main = out[0] if isinstance(out, tuple) else out
        torch.autograd.backward(main, fn(dy.cpu()).to(main.dtype))
        return {n: q.grad.double() * clip for n, q in mod.named_parameters(recurse=False)
                if q.grad is not None}

    def dist(a, b):
        return float((a.double() - b.double()).norm())

    owners = sorted({n.rsplit(".", 1)[0] for n in names})
    worst_in, worst, controls, bad, whole = (0.0, ""), {}, [], [], [0.0, 0.0]
    for owner in owners:
        card, cpu, f64 = (captures[k][owner] for k in ("card", "cpu", "float64"))
        if not card["calls"] == cpu["calls"] == f64["calls"] == 1:
            fail(f"{what}: {owner} ran {card['calls']} / {cpu['calls']} / {f64['calls']} "
                 "times in one step")
        # (1) the card's input and output gradient against the float64 step
        parts = (list(zip(tensors(card["in"]), tensors(cpu["in"]), tensors(f64["in"])))
                 + [(card["dy"], cpu["dy"], f64["dy"])])
        for i, (tc, t16, t64) in enumerate(parts):
            label = f"{owner} {'output gradient' if i == len(parts) - 1 else f'input {i}'}"
            if tc.dtype != t16.dtype or tc.shape != t16.shape:
                fail(f"{what}: {label} on the card is {tc.dtype} {tuple(tc.shape)}, the CPU "
                     f"bf16 step's {t16.dtype} {tuple(t16.shape)}")
            t64 = t64.cpu()
            norm = max(float(t64.norm()), 1e-300)
            d16 = max(dist(t16.cpu(), t64), 2.0 ** -23 * norm) / norm
            r = dist(tc.cpu(), t64) / norm / d16
            whole[0], whole[1] = whole[0] + (r * d16) ** 2, whole[1] + d16 ** 2
            worst_in = max(worst_in, (r, label))
            if not r <= 2 * FLOAT64_WITNESS:
                bad.append(f"{label} {r:.2f} times the CPU's distance from float64")
        # (2) the leaves against the float64 leaf of the card's own terms
        mod = nets["bf16"].get_submodule(owner)
        want = local("float64", owner, card["in"], card["dy"], torch.Tensor.double)
        if isinstance(mod, rl.BatchNorm2d):
            kind = "BN"
            x = tensors(card["in"])[0].cpu().double()
            dy = card["dy"].cpu().double() * clip
            dims = tuple(range(x.dim() - 1))
            var, mean = torch.var_mean(x, dim=dims, correction=0)
            rs = 1.0 / torch.sqrt(var + mod.eps)
            units = math.ceil(math.log2(x.numel() // x.shape[-1])) * 2.0 ** -24
            tol = {"bias": units * dy.abs().sum(dims),
                   "scale": units * rs * ((dy * x).abs().sum(dims)
                                          + mean.abs() * dy.abs().sum(dims))}
        elif isinstance(mod, (rl.Conv2d, rl.ConvTranspose2d, rl.Linear)):
            kind = "sum"
            mags = local("float64", owner, card["in"], card["dy"],
                         lambda t: t.double().abs())
            n = card["dy"].numel() // card["dy"].shape[-1]
            # bf16 roundings on the way: the transposed conv rounds each
            # folded tap's sum, then the weight's sum of them
            r = 2 if isinstance(mod, rl.ConvTranspose2d) else 1
            tol = {k: (r * 2.0 ** -8 + (n - 1) * 2.0 ** -24) * (1 + 2.0 ** -8) ** r * m
                   for k, m in mags.items()}
        else:
            kind = "LSTM"
            g16 = local("bf16", owner, card["in"], card["dy"], lambda t: t)
            tol = {k: FLOAT64_WITNESS * max(dist(g16[k], w), 2.0 ** -23 * float(w.norm()))
                   for k, w in want.items()}
        for pname, w in want.items():
            name = f"{owner}.{pname}"
            if name not in names:
                continue
            if kind == "LSTM":
                r, rc = dist(card_grads[name], w) / tol[pname], dist(control[name], w) / tol[pname]
            else:
                t = tol[pname].reshape(w.shape) + 1e-300
                r = float(((card_grads[name] - w).abs() / t).max())
                rc = float(((control[name] - w).abs() / t).max())
            worst[kind] = max(worst.get(kind, (0.0, "")), (r, name))
            controls.append(rc)
            if not r <= 1.0:
                bad.append(f"{name} {r:.2f} of its limit from the float64 leaf")
    whole = math.sqrt(whole[0] / whole[1])
    if not whole <= FLOAT64_WITNESS:
        bad.append(f"the modules' inputs and output gradients together {whole:.2f} times "
                   "the CPU's distance from float64")
    print(f"{what}: {len(names)} leaves of {len(owners)} modules held by their float64 "
          f"witness: the modules' inputs and output gradients together {whole:.2f} times "
          f"the CPU bf16 step's relative distance from the float64 step (limit "
          f"{FLOAT64_WITNESS}), each at most {worst_in[0]:.2f} ({worst_in[1]}; limit "
          f"{2 * FLOAT64_WITNESS}); each leaf against the float64 leaf of the card's own "
          "terms, the largest share of its limit: "
          + ", ".join(f"{k} {v[0]:.3f} ({v[1]})" for k, v in sorted(worst.items()))
          + f"; the float32 control leaves it at {sum(r > 1.0 for r in controls)} of "
          f"{len(controls)} leaves (median {sorted(controls)[len(controls) // 2]:.2f} of the "
          "limit)", flush=True)
    if bad:
        fail(f"{what}: outside the float64 witness: " + "; ".join(bad))
    if not any(r > 1.0 for r in controls):
        fail(f"{what}: the float32 control stands inside the float64 witness at every leaf")


def sum_order_ratios(results, key, witnesses):
    """[(ratio, leaf)], largest first, over the gradient leaves above the
    residue floor (1e-5 of the float32 step's largest): the L2 distance of
    ``results[key]``'s leaf from the CPU's bf16 leaf over the largest of
    ``witnesses``' distances, floored at the oracle band's 2.5e-3 of the
    leaf."""
    cpu_g, cpu32_g = results["cpu"][1], results["cpu32"][1]
    floor = 1e-5 * max(float(g.abs().max()) for g in cpu32_g.values())
    out = []
    for name, want in cpu_g.items():
        if float(cpu32_g[name].abs().max()) < floor:
            continue
        noise = max([float((results[w][1][name] - want).norm()) for w in witnesses]
                    + [2.5e-3 * float(want.norm())])
        out.append((float((results[key][1][name] - want).norm()) / noise, name))
    return sorted(out, reverse=True)


def sum_order_readings(results):
    """``sum_order_ratios`` of the card against every witness, the largest
    of each witness against the others (ratio, leaf), and of the control,
    the CPU's float32 step (what a card that computed at float32 would
    read), against every witness."""
    ws = [k for k in results if k.startswith("witness")]
    spread = max(sum_order_ratios(results, w, [v for v in ws if v != w])[0] for w in ws)
    return (sum_order_ratios(results, "card", ws), spread,
            sum_order_ratios(results, "cpu32", ws))


def describe_ratios(ratios):
    """The largest three of ``sum_order_ratios`` and their median."""
    return (", ".join(f"{n} {r:.2f}" for r, n in ratios[:3])
            + f"; median {ratios[len(ratios) // 2][0]:.2f} over {len(ratios)} leaves")


def card_vs_cpu_step_bf16(what, cfg, noisy, clean, dev, seed, witness=False) -> None:
    """``bf16_steps`` on the first ``CARD_CPU_BATCH`` waves, held: the loss
    and the gradient norm card vs CPU within half of the CPU's own bf16 ->
    float32 distance on that step; every gradient leaf above the residue
    floor within ``SUM_ORDER_LIMIT`` of its sum-order witnesses
    (``sum_order_ratios``): at bf16 a leaf of the step moves with the order
    of its sums by more than the oracle band widened by its own bf16
    distance (on the CPU, at 28 of 214 DCS leaves: PERF.md section 6); the
    post-Adam parameters within 2 lr + 3e-5 (the most that Adam's first
    step moves a parameter, lr a step, apart in either direction, weight
    decay included). With ``witness`` (the real family) a leaf outside the
    sum-order rule is held by its float64 witness
    (``float64_leaf_witness``) instead."""
    import dataclasses

    import torch

    captures = {} if witness else None
    results = bf16_steps(cfg, noisy[:CARD_CPU_BATCH], clean[:CARD_CPU_BATCH], dev, seed,
                         captures)
    (card, card_g, card_p, _), (cpu, _, cpu_p, cpu_s), (cpu32, cpu32_g, _, _) = (
        results["card"], results["cpu"], results["cpu32"])
    for k in ("loss", "grad_norm"):
        d, ref = abs(card[k] - cpu[k]), abs(cpu[k] - cpu32[k])
        print(f"{what}: batch {CARD_CPU_BATCH}, dropout off, bf16 card vs CPU: {k} "
              f"{card[k]:.6f} vs {cpu[k]:.6f} (|diff| {d:.3e}); the CPU's bf16 against "
              f"its float32 {cpu32[k]:.6f} ({ref:.3e}; limit half of it) (CPU bf16 step "
              f"{cpu_s:.1f} s)", flush=True)
        if not d <= 0.5 * ref:
            fail(f"{what} bf16 step card vs CPU: {k} {card[k]} vs {cpu[k]}, beyond half "
                 f"of the CPU's bf16-to-float32 distance {ref:.3e}")
    for name, got in card_g.items():
        if not bool(torch.isfinite(got).all()):
            fail(f"{what}: bf16 gradient {name} is not finite on the card")
    ratios, spread, control = sum_order_readings(results)
    print(f"{what}: bf16 gradient leaves, card vs CPU in L2 against the largest of "
          f"{SUM_ORDER_WITNESSES} sum-order witnesses (limit {SUM_ORDER_LIMIT}): largest "
          f"{describe_ratios(ratios)}; a witness against the other "
          f"{SUM_ORDER_WITNESSES - 1} at most {spread[0]:.2f} ({spread[1]}); the float32 "
          f"control {describe_ratios(control)}; {sum(r > SUM_ORDER_LIMIT for r, _ in ratios)} "
          "leaves outside the rule", flush=True)
    outside = [n for r, n in ratios if r > SUM_ORDER_LIMIT]
    if outside and witness:
        ncfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout_conv=0.0,
                                                     dropout_fc=0.0))
        clip = min(1.0, cfg.optim.clip_norm / (card["grad_norm"] + 1e-6))
        float64_leaf_witness(what, outside, captures, bf16_config(ncfg), ncfg, card_g,
                             cpu32_g, clip)
    elif outside:
        fail(f"{what}: bf16 gradients beyond {SUM_ORDER_LIMIT} sum-order distances: "
             + ", ".join(f"{n} ({r:.2f})" for r, n in ratios if r > SUM_ORDER_LIMIT))
    lr = cfg.optim.lr
    moved = max(float((card_p[n] - cpu_p[n]).abs().max()) for n in cpu_p)
    if moved > 2 * lr + 3e-5:
        fail(f"{what}: post-Adam parameters at bf16 differ by {moved:.3e}, beyond 2 lr")
    print(f"{what}: post-Adam parameters within 2 lr (max |diff| {moved:.3e})", flush=True)


def check_sum_order(dev, card, noisy, clean, n_seeds):
    """The readings ``SUM_ORDER_LIMIT`` is set from: ``sum_order_readings``
    of DCS's and DC's step over ``n_seeds`` weight seeds, each on its own
    ``CARD_CPU_BATCH`` waves of phase 7's batch. Fails on nothing."""
    from dcs_net_tpu_torch.core.config import config_for_variant

    for variant in ("dcs", "dc"):
        top = [0.0, 0.0, 0.0]
        for s in range(n_seeds):
            part = slice(s * CARD_CPU_BATCH, (s + 1) * CARD_CPU_BATCH)
            ratios, spread, control = sum_order_readings(bf16_steps(
                config_for_variant(variant), noisy[part], clean[part], dev, SEED + 100 + s))
            top = [max(top[0], ratios[0][0]), max(top[1], spread[0]),
                   max(top[2], control[0][0])]
            print(f"sum order: {variant} seed {s}: the card against {SUM_ORDER_WITNESSES} "
                  f"witnesses {describe_ratios(ratios)}; a witness against the other "
                  f"{SUM_ORDER_WITNESSES - 1} at most {spread[0]:.2f} ({spread[1]}); the "
                  f"float32 control {describe_ratios(control)} [{card}]", flush=True)
        print(f"sum order: {variant} over {n_seeds} seeds: the card at most {top[0]:.2f}, a "
              f"witness against the others {top[1]:.2f}, the float32 control {top[2]:.2f}",
              flush=True)


def check_bf16_train(dev, card, tmp, noisy, clean, f32, drs_f32=None):
    """Phase "bf16train": training at --dtype bfloat16 on the card, on phase
    7's batch ``noisy``, ``clean`` (B 32 x 8160): DCS's step (``train_at_bf16``:
    (a) launches, (d) ms beside float32's ``f32`` from phases "train" and
    "graph" or measured here where None, (c) the K = 8 graph against eager,
    (e) the classes against their plain versions, (b) card vs CPU at batch
    4); (f) a DC step at bf16 and at float32, card vs CPU; (g) ``cli.train
    --dtype bfloat16`` for an epoch at K = 8 and its checkpoint served at
    both types; (h) DRS's step (``train_at_bf16`` beside ``drs_f32``, phase
    "graph" (e)'s, its rows ``<kernel>_drs``, a leaf outside the sum-order
    rule held by its float64 witness); (i) DRS through ``cli.train``,
    ``cli.enhance --carry`` and ``cli.tune`` at bf16. Returns its kernel
    rows."""
    import dataclasses

    import torch

    from dcs_net_tpu_torch.cli import enhance as cli_enhance
    from dcs_net_tpu_torch.cli import tune as cli_tune
    from dcs_net_tpu_torch.core.config import Config, config_for_variant
    from dcs_net_tpu_torch.data.audio_io import read_wav, write_wav
    from dcs_net_tpu_torch.models.enhance import enhance_full, enhance_streaming
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.train.checkpoint import load_model

    t_phase = time.perf_counter()
    k = GRAPH_K
    rows = train_at_bf16(dev, card, noisy, clean, "dcs", f32, BF16_TRAIN_STEP_LAUNCHES,
                         SEED + 11, SEED + 13)
    check_dgrad_bf16_off_path(dev)
    check_conv_bf16_off_path(dev)

    # (f) DC at bf16 and at float32, card vs CPU, batch 4, dropout off
    dcfg = config_for_variant("dc")
    card_vs_cpu_step_bf16("bf16train (f) DC", dcfg, noisy, clean, dev, SEED + 14)
    card_vs_cpu_step("bf16train (f) DC float32", dcfg, noisy, clean, dev, SEED + 14)

    # (g) the trainer at --dtype bfloat16: one epoch of 16 steps at K = 8 (an
    # eager dispatch, then the capture's replay), its checkpoint served
    root = os.path.join(tmp, "bf16train")
    _, metrics = run_trainer(root, 1, False, card, ("--dtype", "bfloat16"), GRAPH_TRAIN_N,
                             2 * k)
    if (metrics.get("steps") != 2 * k or metrics.get("nonfinite_loss_steps") != 0
            or not math.isfinite(metrics.get("loss", float("nan")))):
        fail(f"bf16train (g): the bf16 trainer: {metrics}")
    ckpt = os.path.join(root, "dcs", "checkpoints")
    with open(os.path.join(ckpt, "config.json")) as f:
        saved = Config.from_json(f.read())
    if saved.model.compute_dtype != "bfloat16":
        fail("bf16train (g): the checkpoint's config is not the bf16 one")
    src = os.path.join(root, "noisy.wav")
    write_wav(src, speech_like(1, SR, SEED + 17)[0], SR)
    x1, _ = read_wav(src)
    served = {}
    for dtype in ("bfloat16", "float32"):
        c = bf16_config(saved) if dtype == "bfloat16" else saved.replace(
            model=dataclasses.replace(saved.model, compute_dtype="float32"),
            stft=dataclasses.replace(saved.stft, dft_dtype="float32"))
        dst = os.path.join(root, f"served_{dtype}.wav")
        t1 = time.perf_counter()
        cli_enhance.main(["dcs", "--in", src, "--out", dst, "--ckpt-dir", ckpt, "--dtype",
                          dtype])
        wall = time.perf_counter() - t1
        audio, sr = read_wav(dst)
        cpu_model = DCSNet(c.model, c.quirks, device="cpu")
        step_n = load_model(ckpt, cpu_model)
        if not all(t.dtype == torch.float32 for t in cpu_model.state_dict().values()
                   if t.is_floating_point()):
            fail("bf16train (g): the bf16-trained checkpoint holds non-float32 tensors")
        want = enhance_full(cpu_model, torch.from_numpy(x1)[None], c)[0]
        print(f"bf16train: (g) cli.enhance --ckpt-dir (step {step_n}) --dtype {dtype}: "
              f"returned in {wall:.1f} s (in this process)", flush=True)
        if sr != SR or audio.shape != tuple(want.shape):
            fail(f"bf16train (g): cli.enhance --dtype {dtype} wrote {audio.shape} at {sr}")
        served[dtype] = (torch.from_numpy(audio), want)
    want32 = served["float32"][1]
    compare_card_cpu("bf16train: (g) the bf16-trained checkpoint served at float32, 1 s",
                     *served["float32"])
    bf16_band(want32)("bf16train: (g) the bf16-trained checkpoint served at bf16, 1 s",
                      *served["bfloat16"])
    # (h) DRS at bf16
    rows += train_at_bf16(dev, card, noisy, clean, "drs", drs_f32,
                          BF16_TRAIN_STEP_LAUNCHES, SEED + 50, SEED + 16, "_drs",
                          witness=True)

    # (i) DRS through the CLIs at --dtype bfloat16: the trainer on the
    # streaming preset for an epoch of 8 steps at K = 4 (an eager dispatch,
    # then the capture's replay), its checkpoint served by cli.enhance --carry
    # against the CPU's carried stream; cli.tune for one trial of one epoch
    # (both in this process)
    droot = os.path.join(tmp, "bf16train_drs")
    _, metrics = run_trainer(droot, 1, False, card, ("--dtype", "bfloat16", "--streaming",
                                                     "--steps-per-dispatch", "4"),
                             GRAPH_TRAIN_N // 2, k, variant="drs")
    if (metrics.get("steps") != k or metrics.get("nonfinite_loss_steps") != 0
            or not math.isfinite(metrics.get("loss", float("nan")))):
        fail(f"bf16train (i): the bf16 DRS trainer: {metrics}")
    ckpt = os.path.join(droot, "drs", "checkpoints")
    with open(os.path.join(ckpt, "config.json")) as f:
        saved = Config.from_json(f.read())
    if saved.model.compute_dtype != "bfloat16" or saved.model.lstm_bidir:
        fail("bf16train (i): the checkpoint's config is not DRS's bf16 streaming one")
    dst = os.path.join(droot, "served_carry.wav")
    t1 = time.perf_counter()
    cli_enhance.main(["drs", "--in", src, "--out", dst, "--ckpt-dir", ckpt, "--carry",
                      "--dtype", "bfloat16"])
    wall = time.perf_counter() - t1
    audio, sr = read_wav(dst)
    carried = {}
    for c in (saved, saved.replace(
            model=dataclasses.replace(saved.model, compute_dtype="float32"),
            stft=dataclasses.replace(saved.stft, dft_dtype="float32"))):
        cpu_model = DCSNet(c.model, c.quirks, device="cpu")
        step_n = load_model(ckpt, cpu_model)
        carried[c.model.compute_dtype] = enhance_streaming(
            cpu_model, torch.from_numpy(x1)[None], c, chunk_frames=256, overlap=0,
            carry_lstm_state=True)[0]
    print(f"bf16train: (i) cli.enhance drs --carry --ckpt-dir (step {step_n}) --dtype "
          f"bfloat16: returned in {wall:.1f} s (in this process)", flush=True)
    if sr != SR or audio.shape != tuple(carried["bfloat16"].shape):
        fail(f"bf16train (i): cli.enhance drs --carry wrote {audio.shape} at {sr}")
    bf16_band(carried["float32"])("bf16train: (i) the bf16-trained DRS checkpoint served "
                                  "carried at bf16, 1 s", torch.from_numpy(audio),
                                  carried["bfloat16"])
    args = ["drs", "--synthetic", "--synthetic-n", str(TUNE_N_SYNTHETIC), "--batch-size",
            str(TUNE_BATCH), "--trials", "1", "--trial-epochs", "1", "--dtype", "bfloat16",
            "--log-dir", os.path.join(tmp, "tune_drs_bf16")]
    t1 = time.perf_counter()
    best = cli_tune.main(args)
    print(f"bf16train: (i) cli.tune {' '.join(args[:-2])}: returned {best} in "
          f"{time.perf_counter() - t1:.1f} s (in this process) [{card}]", flush=True)
    if not math.isfinite(best.get("value", float("nan"))):
        fail(f"bf16train (i): cli.tune drs --dtype bfloat16 gave no finite best: {best}")
    print(f"bf16train: phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def train_at_bf16(dev, card, noisy, clean, variant, f32, want, seed, cpu_seed, suffix="",
                  witness=False):
    """One variant's train step at --dtype bfloat16 on phase 7's batch
    ``noisy``, ``clean`` (32 x 8160), labelled by ``variant``: (a) one eager
    step's launches, exactly ``want`` (dropout on, weights seeded ``seed``);
    (d) ms a step, the eager median of 5 and the graphed median of 5
    replays of K = 8, a replay's busy time and kernels, beside float32's
    ``f32`` = (eager ms, graphed ms, busy ms, kernels) from earlier phases,
    or None: then measured here; (c) the K = 8 graph against eager at bf16
    under cuDNN's deterministic algorithms (16 steps' losses rtol 1e-4, the
    state in band); (e) the training classes against their plain versions
    at the step's shapes (rows ``<kernel><suffix>``); (b) the step at batch
    4 card vs CPU (``card_vs_cpu_step_bf16``, seeded ``cpu_seed``, with the
    float64 ``witness`` for the real family). Returns its rows."""
    import torch

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.train import steps
    from dcs_net_tpu_torch.train.optim import make_optimizer
    from dcs_net_tpu_torch.utils import cuda_lib

    t0 = time.perf_counter()
    what = f"bf16train: {variant.upper()}"
    cfg = config_for_variant(variant)
    c16 = bf16_config(cfg)
    k = GRAPH_K

    def model_and_opt(c, s):
        m = DCSNet(c.model, c.quirks, device=dev, seed=s)
        m.set_dropout_generator(torch.Generator(device=dev).manual_seed(s + 1))
        return m, make_optimizer(m.parameters(), c.optim)

    def eager_ms(m, o, c):
        def one():
            return steps.train_step(m, o, steps.batch_from_waves(noisy, clean, c), c)
        for _ in range(2):
            one()
        return median_ms(one, 5)

    def graph(m, o, c, label):
        """The K = 8 capture of ``m``'s steps: one replay's launches, timed."""
        scanned = steps.make_scanned_train_step(m, o, c, k)
        scanned(x[:k], y[:k])
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        scanned(x[k:], y[k:])
        torch.cuda.synchronize()
        got = launch_counts()
        print(f"{what}: (d) captured {k} {label} train steps in {scanned.capture_s:.2f} s, "
              f"private pool {scanned.pool_bytes / 2**30:.2f} GiB, one replay's launches "
              f"{got}", flush=True)
        return scanned, {kn.name: kn.launches for kn in cuda_lib.KERNELS.values()}, got

    # (a) one eager step's launches
    torch.manual_seed(SEED)
    model, opt = model_and_opt(c16, seed)

    def step():
        return steps.train_step(model, opt, steps.batch_from_waves(noisy, clean, c16), c16)

    shapes = discover_shapes(step)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    out = step()
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"{what}: (a) train_step launches {launches}, loss {float(out['loss']):.4f}",
          flush=True)
    expect_launches(f"{what} (a): one bf16 train step", launches, want)
    if not math.isfinite(float(out["loss"])) or float(out["skipped"]) != 0.0:
        fail(f"{what} (a): the bf16 step's loss is not finite")
    if not all(p.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in model.parameters()):
        fail(f"{what} (a): a parameter or its gradient is not finite float32")

    # (d) ms a step, eager and graphed
    eager16 = eager_ms(model, opt, c16)
    x, y = graph_waves(noisy, clean, 2 * k)
    scanned, glaunches, got = graph(model, opt, c16, "bf16")
    expect_launches(f"{what} (d): one replay", got, {n: k * c for n, c in want.items()})
    graph16, busy16, kernels16 = time_graph(f"{variant.upper()} at bf16", scanned, glaunches,
                                            x[:k], y[:k], eager16, card)
    del model, opt, scanned
    torch.cuda.empty_cache()
    if f32 is None:
        m, o = model_and_opt(cfg, seed)
        e32 = eager_ms(m, o, cfg)
        scanned, flaunches, _ = graph(m, o, cfg, "float32")
        f32 = (e32,) + time_graph(variant.upper(), scanned, flaunches, x[:k], y[:k], e32, card)
        del m, o, scanned
        torch.cuda.empty_cache()
    eager32, graph32, busy32, kernels32 = f32
    print(f"{what}: (d) step at batch {TRAIN_BATCH} x {TRAIN_CROP}: bf16 eager "
          f"{eager16:.2f} ms (median of 5), graphed {graph16:.2f} ms (median of 5 "
          f"replays of {k}), a replay busy {busy16:.2f} ms, {kernels16} device kernels; "
          f"float32 eager {eager32:.2f}, graphed {graph32:.2f}, busy {busy32:.2f} ms, "
          f"{kernels32} kernels (this process) [{card}]", flush=True)

    # (c) the K = 8 graph against eager at bf16, cuDNN's deterministic
    # algorithms on both sides: 16 steps' losses rtol 1e-4, the state in band
    torch.backends.cudnn.deterministic = True
    try:
        a, oa = model_and_opt(c16, seed + 2)
        b, ob = model_and_opt(c16, seed + 2)
        sa = steps.make_scanned_train_step(a, oa, c16, k)
        got = sa(x[:k], y[:k])["loss"].tolist() + sa(x[k:], y[k:])["loss"].tolist()
        want_losses = [float(steps.train_step(b, ob, steps.batch_from_waves(
            x[i].to(dev), y[i].to(dev), c16), c16)["loss"]) for i in range(2 * k)]
        err = max(abs(g - w) / abs(w) for g, w in zip(got, want_losses))
        print(f"{what}: (c) dropout on, {2 * k} bf16 steps (an eager dispatch and a "
              f"replay) against {2 * k} eager steps: max relative loss difference "
              f"{err:.3e} (limit 1e-4)", flush=True)
        if not err <= 1e-4:
            fail(f"{what} (c): the graphed bf16 losses {got} are not eager's {want_losses}")
        state_band(f"{what}: (c) after {2 * k} bf16 steps", a, b)
        del a, oa, b, ob, sa
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False

    # (e) each training class against its plain version at the step's shapes
    rows = check_kernels({name: shapes[name] for name in BF16_TRAIN_ROWS if shapes[name]},
                         launches, dev, c16, card, f"{variant.upper()} bf16 train step", suffix)
    for row in rows:
        row["launches_graph_replay"] = glaunches.get(row["name"][:len(row["name"])
                                                                  - len(suffix)], 0)

    # (b) card vs CPU, batch 4, dropout off
    card_vs_cpu_step_bf16(f"{what} (b)", cfg, noisy, clean, dev, cpu_seed, witness)
    print(f"{what}: took {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stft-only", action="store_true",
                    help="after the build, check and time kernel 1 alone")
    ap.add_argument("--bf16-only", action="store_true",
                    help="after the build, run phase \"bf16\" alone")
    ap.add_argument("--sum-order-seeds", type=int, default=0, metavar="N",
                    help="after the build, read phase \"bf16train\" (b)'s sum-order "
                         "ratios over N seeds (at most 8)")
    args = ap.parse_args(argv)

    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.data.audio_io import read_wav, write_wav
    from dcs_net_tpu_torch.dsp import stft_cuda  # noqa: F401  (registers kernel 1)
    from dcs_net_tpu_torch.models.enhance import enhance_full
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.ops import cuda_conv, cuda_tapconv  # noqa: F401
    from dcs_net_tpu_torch.utils import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    card = f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} [{card}]",
          flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    marks = [t0]

    def phase_done(name):
        """Print the seconds since the last phase ended, and the total."""
        marks.append(time.perf_counter())
        print(f"phase {name}: {marks[-1] - marks[-2]:.1f} s ({marks[-1] - t0:.1f} s after "
              "the device check)", flush=True)

    build_s = cuda_lib.build_all()
    print(f"build: {len(cuda_lib.KERNELS)} kernels ({', '.join(cuda_lib.KERNELS)}) "
          f"built in {build_s:.1f} s (nvcc {cuda_lib.find_nvcc()}; each source's "
          + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(cuda_lib.BUILD_SECONDS.items()))
          + f"), into {cuda_lib.BUILD_DIR}", flush=True)

    phase_done("build")
    if args.stft_only:
        cfg = config_for_variant("dcs")
        t1 = time.perf_counter()
        check_stft_off_path(dev, cfg)
        rows = check_kernels({"stft": [(BATCH, SECONDS * SR, cfg.stft.n_fft, cfg.stft.hop,
                                        True, True)]}, {}, dev, cfg, card, "call")
        rows += check_kernels({stft_row_name(row, *case): [case + (True, True)]
                               for row, cases in STFT_ROWS.items() for case in cases},
                              {}, dev, cfg, card, "call")
        print(f"kernel 1 alone: {time.perf_counter() - t1:.1f} s", flush=True)
        return finish(rows, smi)
    if args.sum_order_seeds:
        with tempfile.TemporaryDirectory(prefix="dcs_sum_order_") as tmp:
            _, noisy, clean = train_batch(dev, tmp)
            check_sum_order(dev, card, noisy, clean, args.sum_order_seeds)
        return finish([], smi)
    if args.bf16_only:
        rows = check_bf16(dev, card)
        phase_done("bf16")
        with tempfile.TemporaryDirectory(prefix="dcs_bf16train_") as tmp:
            _, noisy, clean = train_batch(dev, tmp)
            rows += check_bf16_train(dev, card, tmp, noisy, clean, None)
        phase_done("bf16train")
        print(f"total: {time.perf_counter() - t0:.1f} s after the device check", flush=True)
        return finish(rows, smi)

    # phase 3: the slice at full width
    cfg = config_for_variant("dcs")
    model = DCSNet(cfg.model, cfg.quirks, device=dev, seed=SEED).eval()
    perturb_bn(model, SEED + 1)
    x = torch.from_numpy(speech_like(BATCH, SECONDS * SR, SEED + 2)).to(dev)

    shapes = discover_shapes(lambda: enhance_full(model, x, cfg))
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t1 = time.perf_counter()
    out = enhance_full(model, x, cfg)
    torch.cuda.synchronize()
    t_call = time.perf_counter() - t1
    launches = {k.name: k.launches for k in cuda_lib.KERNELS.values()}
    print(f"slice: enhance_full launches {launches}", flush=True)
    if tuple(out.shape) != (BATCH, SECONDS * SR):
        fail(f"enhance_full returned {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        fail("enhance_full returned non-finite samples")
    want = {"stft": (1, None), "conv_same_small_cout": (13, 13),
            "sa_pool": (13, 13), "sa_gate": (13, 13), "sa_pool_real": (0, 0),
            "sa_gate_real": (0, 0), "tapconv_valid": (7, 7), "tapconv_pack": (7, 7)}
    for name, (lo, hi) in want.items():
        n = launches.get(name, 0)
        if n < lo or (hi is not None and n > hi):
            fail(f"kernel {name} launched {n} times in one enhance call, "
                 f"expected {lo if hi is None else hi}{'+' if hi is None else ''}")
    reps = 3
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        enhance_full(model, x, cfg)
    torch.cuda.synchronize()
    t_steady = (time.perf_counter() - t1) / reps
    print(f"slice: {BATCH} requests x {SECONDS} s: counted call {t_call * 1e3:.1f} ms, "
          f"steady {t_steady * 1e3:.1f} ms per call (latency per request), "
          f"{BATCH * SECONDS / t_steady:.1f} audio-s/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]",
          flush=True)

    short = torch.from_numpy(speech_like(1, SR, SEED + 3))
    on_card = enhance_full(model, short.to(dev), cfg).cpu()
    cpu_model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=SEED)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    on_cpu = enhance_full(cpu_model, short, cfg)
    compare_card_cpu("slice: 1 s request", on_card, on_cpu)
    # the same call as one CUDA graph a (B, n), as cli/enhance.py runs it
    check_graphed(f"slice: DCS enhance_full, {BATCH} requests x {SECONDS} s",
                  lambda g, model=model, x=x, cfg=cfg: enhance_full(model, x, cfg, graphs=g),
                  {"stft": 1, **DCS_EVAL_FORWARD}, card,
                  (lambda g: enhance_full(model, short.to(dev), cfg, graphs=g), on_cpu))
    check_keep_alive(model, cfg, dev, card)
    phase_done("slice")

    # phase 4: streaming
    stream_shapes, stream_launches = check_streaming(model, cpu_model, cfg, dev, card)
    phase_done("stream")

    # phase 5: kernels against their plain versions, at the slice's shapes.
    # Kernel 2's conv entry is held at the shapes the gate entry ran its body
    # at: the 13 of the full-utterance call and those of one chunk group.
    floor = empty_launch_ms()
    print(f"kernel floor: an empty launch takes {floor:.4f} ms of device time "
          f"[{card}]", flush=True)

    def conv_shapes(gate_calls):
        return [a[:3] + (4, 7, 2) for a in gate_calls]

    shapes = {"stft": shapes["stft"],
              "conv_same_small_cout": conv_shapes(shapes["sa_gate"]),
              "sa_pool": shapes["sa_pool"], "sa_gate": shapes["sa_gate"],
              "tapconv_valid": shapes["tapconv_valid"]}
    rows = check_kernels(shapes, launches, dev, cfg, card, "enhance call")
    for row in rows:
        if row["name"] == "conv_same_small_cout":
            row["empty_launch_ms"] = floor
    # kernel 1 off the paths: row 1b on the FFT entry, row 1c on the dense one
    t1 = time.perf_counter()
    rows += check_kernels({stft_row_name(row, *case): [case + (True, True)]
                           for row, cases in STFT_ROWS.items() for case in cases},
                          launches, dev, cfg, card, "enhance call")
    print(f"kernel 1 off the paths: {sum(map(len, STFT_ROWS.values()))} rows in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    # one streaming chunk group's launches, rows <kernel>_stream; their
    # launch counts are the 30 s streaming call's
    group = {"stft": stream_shapes["stft"],
             "conv_same_small_cout": conv_shapes(stream_shapes["sa_gate"][:13]),
             "sa_pool": stream_shapes["sa_pool"][:13],
             "sa_gate": stream_shapes["sa_gate"][:13],
             "tapconv_valid": stream_shapes["tapconv_valid"][:7]}
    rows += check_kernels(group, stream_launches, dev, cfg, card, "streaming chunk group",
                          "_stream")
    rows += check_request(model, cfg, dev, card)
    check_stft_off_path(dev, cfg)
    check_conv_off_path(dev)
    check_tapconv_off_path(dev)
    check_forward_sweep(dev, card)
    check_dgrad_off_path(dev, card)
    phase_done("kernels")

    # phase 6: CLI on a 48 kHz wav, full and streamed
    from dcs_net_tpu_torch.cli import enhance as cli

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "noisy48k.wav"), os.path.join(tmp, "clean.wav")
        n48 = 2 * 48000
        t = np.arange(n48) / 48000.0
        rng = np.random.default_rng(SEED + 4)
        write_wav(src, (0.3 * np.sin(2 * np.pi * 330.0 * t)
                        + 0.05 * rng.standard_normal(n48)).astype(np.float32), 48000)
        for flags in ([], ["--stream", "--chunk-frames", "128"],
                      ["--carry", "--chunk-frames", "128"]):
            cli.main(["dcs", "--in", src, "--out", dst, *flags])
            audio, sr = read_wav(dst)
            if sr != SR or audio.shape != (n48 // 3,) or not np.all(np.isfinite(audio)):
                fail(f"CLI output with {flags}: sr {sr}, shape {audio.shape}")
            print(f"cli {' '.join(flags) or '(full)'}: 2 s at 48 kHz -> "
                  f"{audio.shape[0]} samples at {sr} Hz, finite", flush=True)
    phase_done("cli")

    # phase 7: the train step and the trainer
    # phase "graph": the train steps as one CUDA graph replay a dispatch
    # phase "loader": the native audio front end and the K = 8 trainer on it
    # phase "eval": the evaluation path on what phase 7 left
    with tempfile.TemporaryDirectory(prefix="dcs_train_") as tmp:
        train_rows, train_launches, (noisy, clean, eager_ms) = check_train(dev, card, tmp)
        phase_done("train")
        graph_launches, drs_graph_launches, graph_f32, drs_f32 = check_graph(
            dev, card, tmp, noisy, clean, eager_ms)
        phase_done("graph")
        # phase "bf16train" on phase 7's batch, beside phase "graph"'s float32
        bf16_train_rows = check_bf16_train(dev, card, tmp, noisy, clean,
                                           (eager_ms,) + graph_f32, drs_f32)
        phase_done("bf16train")
        del noisy, clean
        check_loader(card, tmp, graph_f32[0])
        phase_done("loader")
        eval_rows = check_eval(dev, card, tmp)
        phase_done("eval")
    del model, cpu_model
    for row in rows:
        row["launches_train"] = train_launches.get(row["name"], 0)
    for row in train_rows:
        if row["name"].endswith("_dgrad"):
            row["launches_train"] = row["launches"]
            rows.append(row)
        else:
            # the forward's numbers at the train step's shapes
            next(r for r in rows if r["name"] == row["name"])["train_step"] = {
                k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                    "bound_by", "max_abs_err", "shapes")}
    for row in rows:
        row["launches_graph_replay"] = graph_launches.get(row["name"], 0)

    rows += eval_rows

    # phase 8: the real family (DR/DRS) at full width
    real_rows = check_real(dev, card)
    for row in real_rows:
        row["launches_graph_replay"] = drs_graph_launches.get(row["name"][:-len("_drs")], 0)
    rows += real_rows
    phase_done("real")

    # phase "bf16": the serving paths at --dtype bfloat16
    rows += check_bf16(dev, card)
    phase_done("bf16")
    rows += bf16_train_rows
    print(f"total: {time.perf_counter() - t0:.1f} s after the device check", flush=True)
    return finish(rows, smi)


def finish(rows, smi) -> int:
    """The last lines: the kernels JSON, the nvidia-smi line, the verdict."""
    import torch

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
