#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``umetrack_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without a result line:

1. the device (``nvidia-smi`` name and power limit, torch and CUDA versions,
   and whether cuDNN and matmuls may use TF32: PyTorch lets cuDNN, so every
   "f32" convolution below runs in TF32 unless a phase says TF32 off);
2. the build of ``umetrack_torch/csrc/warp_pool.cu`` and ``warp_image.cu``
   with their shared header and of ``bn_act.cu``, of the native idx/bin reader
   ``umetrack_io.cpp`` and of the zstd decoder ``zstd_decode.cpp`` (the
   ``nvcc`` and ``g++`` runs started together, ``-Xptxas -v`` condensed to
   a line per kernel) and its time;
3. the image-pool warp kernel against its plain PyTorch version on the card,
   at the tracker's bench shape (64 sequences x 16 frames: 4096 pool images
   of 480 x 640, 4096 warps of 96 x 96, coordinates from the port's own
   crop geometry) and on edge cases (crops that take the scalar path, pools
   that cannot be staged, misaligned coordinate views), the path taken
   checked each time; the time of a call of the wrapper (median of single
   calls) and of the kernel alone (launches back to back), the byte bound
   (``portbench/yardstick.py``'s, the benchmark's ``warp_pool_roofline``)
   and the streaming floor (``stream_ms``);
   ``[bn_act]``: the one-pass eval-mode BatchNorm kernel (``csrc/bn_act.cu``)
   against its plain version in f32 and bf16 at every shape and form a
   track_sequences_batched call at S=64 x T=16 gives it (4096 crops: the
   stem's 32 x 96 x 96 with its conv bias and the max-pool; 32 x 48 x 48,
   64 x 24 x 24, 128 x 12 x 12 and 256 x 6 x 6 with and without the
   identity residual, and the BN'd residual where a stage downsamples;
   2048 rows at 6 x 6: the fusion's conv bias + BN + ReLU at 108 and 72
   channels, the regressors' blocks at 76 and 72; the skeleton encoder's
   128 x 4 x 6 x 6) and on edge cases (the scalar path, planes smaller
   than a vector, a conv bias without the pool, channel slices, misaligned
   pointers, NaN and inf), each in NCHW and in channels-last (NHWC, the
   layout of an eval-mode forward on the card with TF32 or bf16): the path
   taken, the max abs error, ms a call, the kernel's device time, its byte
   bound and share, the plain version's ms (the unfused PyTorch sequence
   the model ran before); its launches are counted over the main paths'
   entry-point calls alone, each call checked against the model's sites
   (32 a known-skeleton forward, 31 a scale head's), by path and layout,
   and the backbone's forwards by layout (``batch_norm_act.formats``: one a
   pool launch); ``[layout]``: cuDNN's NCHW<->NHWC transposes and the
   device time by kind in one replay of a track_sequences_batched call at
   S=64 x T=16, channels-last and with NCHW forced;
4. ``track_sequences_batched`` at the full width of ``ModelConfig()`` (f32),
   S=64, T=16, seeded random weights: one kernel launch per call, finite
   outputs, wall time per call and frames/s; then one call under
   torch.profiler (device time by kernel, the device's busy share); then
   the same call with ``ModelConfig(compute_dtype="bfloat16")`` and the
   same seeded weights, in turns with f32 with TF32 on and off: ms per call,
   frames/s, peak memory, each under the profiler with its device time by
   kind of kernel (``portbench/trace.py::kind_of``, the kinds of the
   benchmark's breakdown), bf16 against f32 (TF32 off) at
   ``tests/test_bf16.py``'s bounds, and ``eval_sequences_batched`` in bf16;
5. the two single-image warp kernels (``warp_image_full``,
   ``warp_image_windowed``) against their plain version: the torch_data
   shape (512 images of 480 x 640, uint8 and f32, coordinate fields from
   the port's preprocess geometry), 120 x 160 images (dispatch to the full
   kernel), a flat list, the edge cases, scattered / empty / mixed blocks,
   images whose row pitch cannot be staged, misaligned coordinate views;
   windowed == full bit for bit everywhere and == the pool kernel per slot;
   times as in phase 3, byte bounds, and the tiled kernel's staged form
   against its unstaged form on the same data;
6. the torch_data inference app ``run`` over a synthetic on-disk tree (32
   sequences x 16 frames x 2 views of 480 x 640, the hand rendered) at full
   width: one windowed-kernel launch per batch, finite error, sequences/s
   and frames/s with the native idx/bin reader (checked to be the one
   taken) and in turns with the Python reader, the label decode both ways,
   where a batch's time goes, one batch under torch.profiler; the app's
   ``main`` with ``--dtype bfloat16`` (one windowed launch a batch) and
   ``run()`` in bf16 in turns with f32; then a 120 x 160 tree (one
   full-kernel launch per batch);
7. card against CPU, TF32 off: the tracker at S=2, T=4 (1e-3 rad, 0.1 mm),
   the torch_data ``_run_batch`` on 2 sequences of T=4 (0.1 mm, crops within
   2e-3), and on the card the tracker with ``sampler="kernel_win"`` and
   ``"kernel_full"`` against the pool sampler (one launch of that kernel a
   call and none of the other two warp kernels);
8. the raw_data evaluation path with the trained checkpoint
   (``checkpoints/synthetic.msgpack`` through the port's own loader), full
   width, f32: the loaded model's two heads on the card against the CPU;
   ``track_frame`` looped over a capsule-rendered 64-frame sequence with a
   confidence dropout against ``track_sequence`` (both heads, one
   ``warp_pool`` launch per frame), its frames/s and what a streaming frame
   costs; the pool kernel against its plain version, its times and its
   byte bound at the three shapes this path gives it (one streamed frame,
   a chunk of 16 frames, a sequence of 64); ``calibrate_sequences_batched`` at S=64 x T=16 (one launch)
   against ``calibrate_sequence`` per sequence; ``[orbax]``: the zstd
   decoder's build time, the embedded zstd frames (``ZSTD_FRAMES``, made
   where a compressor exists) decoded to the content their seeds give,
   the checkpoint written by the port as an orbax directory and read back
   bit for bit (bytes on disk, write and read ms and MB/s, the ``.msgpack``
   load ms beside them), and ``load_model_cli`` on that directory: its
   parameters equal the ``.msgpack`` model's and the S=64 x T=16 tracker
   gives the same poses with either (the gap printed); the two eval apps' ``main``
   on 4 generated sequences of 64 frames and ``load_eval``'s aggregate
   (MPJPE, PCK-AUC, MPJPA, calibrated against GT scales; findings, not
   gates: the checkpoint was trained on the stroke style, which needs
   OpenCV); the streaming eval (chunk 16) against the whole-sequence eval
   with its ``PhaseTimers`` report; one sequence under torch.profiler; and
   ``eval_sequence_known`` / ``eval_sequence_unknown`` on the card against
   the CPU; then in bf16: ``track_frame`` against ``track_sequence`` on the
   rendered sequence (seeded weights at ``tests/test_tracker.py``'s bf16
   bounds, the checkpoint with ``TRAINED``'s slack added), the card's bf16
   tracker against the CPU's, and the known app's ``main --dtype
   bfloat16`` (its MPJPE beside f32's, a finding).  Every comparison of two differently batched calls runs twice:
   with seeded random weights at the JAX tests' bounds (1e-3 rad, 0.1 mm,
   scale 2e-3, chunked keypoints 2e-3 mm) and with the checkpoint at wider
   ones, for the reason given at ``TRAINED`` below; on the same crops the
   checkpoint too is held to the strict bounds.  The pool kernel's counter
   is set to 0 just before each entry-point call and read just after it.
   Before the streaming checks, ``[graph]``: the three serving entry points
   as captured CUDA graphs (``umetrack_torch/tracker/compiled.py``, the
   counterpart of their ``jax.jit``), ``track_frame`` (both heads) over a
   capsule-rendered 64-frame sequence, ``track_sequence`` in chunks of 16
   and ``track_sequences_batched`` at S=64 x T=16, in f32 (TF32) and bf16,
   with seeded weights and with the checkpoint: captured on inputs A,
   replayed on inputs B and held against the eager call on B bit for bit
   (the max abs difference printed; were it not, the JAX tests' bounds,
   with the cause printed); the same for the calibrations
   (``calibrate_sequences_batched`` S=64 x T=16, ``predict_scales_sequence``
   in chunks of 16, ``calibrate_sequence`` on 64 frames) and the batched
   evals graphed whole (``eval_sequences_batched``,
   ``eval_sequences_unknown_batched`` S=64 x T=16), held bit for bit
   (seeded weights, f32: the calls and their times); TF32 off recaptures and replays TF32-off
   results; an in-place ``load_state_dict`` between replays is followed by
   the same graph; an ``src_idx`` outside the pool, eager and replayed, in
   a subprocess each, returns without a host wait and fails the next
   synchronisation with a device-side assert; ms a frame or a call eager and
   graphed, the host's ms a replay, the batched call four deep, the device's
   busy share under each, capture ms and graph pool per key; one
   ``warp_pool`` launch a call and a frame, each counted from 0;
9. the batched and sharded evaluation (``parallel/eval.py``) at S=64 x
   T=16, full width, f32, with seeded weights and with the checkpoint:
   ``eval_sequences_batched`` (one ``warp_pool`` launch a call) and
   ``eval_sequences_unknown_batched`` (two) against per-sequence tracking
   and calibration of the first ``CALIBRATE_CHECKED`` sequences (the
   strict bounds for seeded weights, ``TRAINED`` for the checkpoint), their
   wall ms per call, frames/s and peak memory; then a process group of one
   rank over NCCL: the sharded eval equals the unsharded one bit for bit,
   ``train_step`` and ``temporal_train_step`` with the synchronised
   BatchNorm equal the same steps without a group, and the group is left
   (one card: no multi-GPU number); then ``[tp]``, the tensor-parallel
   model axis: this script started as ``--tp-worker`` in groups of 2 (data
   1 x model 2) and 4 (data 2 x model 2) processes that share the card over
   gloo (CUDA tensors; their times are no tensor-parallel speed), each rank
   running both batched protocols at S=4 x T=8 with seeded weights and the
   checkpoint (one + two ``warp_pool`` launches), ``train_step`` and
   ``temporal_train_step`` at full width (B=4) and at the small config of
   ``tests/test_torch_tp.py``, the checkpoint's ``_model_scan`` on its rows
   of crops prepared once with no group (held at the sharded-eval bounds:
   the same crops take the crop fit out of the data split's gap), and the
   train app's ``main`` with ``{"mesh":
   {"model_axis": 2}}`` (one ``warp_image_full`` launch a batch; its orbax
   ``final`` reloads unsharded to the same forward); all against the same
   calls with no group, the replicated parameters equal bit for bit across
   the model ranks, and ``model_axis`` 0 giving model 2 in a world of 2;
   the full-width gradients leaf by leaf against the same steps in a
   process group of one, at TP_FLOOR_FACTOR x floors measured beside them
   (a nudge of the images in that group, cuDNN on against off there, and a
   data-only group of 2), in a world of 2 with cuDNN off on both sides;
10. the training path at the full width of ``ModelConfig()`` (f32): one
   ``train_step`` and one ``temporal_train_step`` (K=4) on the card against
   the CPU at the CPU tests' small config and bounds (loss, metrics, every
   gradient leaf, the BatchNorm running stats after the step, TF32 off);
   the three kernels against their plain versions at the training shapes,
   and one train-app step under the profiler; ``prepare_tracker_sequences`` (32 capsule-rendered sequences x 16
   frames, one ``warp_pool`` launch a sequence), the device-resident corpus
   and ``run_resident_training`` at 32 hand rows x K=8 for 40 steps, each
   step a replay of one captured graph whatever its window start (loss
   falls, eval MPJPE finite, steps/s, peak memory, one capture a key, one
   step under the profiler), then ``run_resident_training`` with a bf16
   model (loss finite and falling, ms per step beside f32's); then
   ``[train-graph]``: ``train_step`` (B=32), ``temporal_train_step`` (8
   rows x K=4) and ``resident_train_step`` (32 rows x K=8, augment off and
   on) at full width in f32 and bf16, graphed against eager from identical
   copies of the model, optimizer and generator, 6 steps each: bit for bit
   with ``cudnn.deterministic``, within 2 x the eager-vs-eager gap with the
   defaults; ms a step both ways, busy share and kernels a step under the
   profiler (the eager step's for the augmented resident step only),
   capture ms, pool MiB and an eager run's own peak memory; ``apps/train.py::main`` on
   synthetic 120 x 160 batches of 32 x 8 frames (one ``warp_image_full``
   launch a batch; the orbax directory ``final`` it writes reloads to the
   same forward),
   again with a JSON config whose ``model.compute_dtype`` is bfloat16, and
   on a 480 x 640 training tree (one
   ``warp_image_windowed`` launch a batch); ``run_distillation`` with the
   checkpoint as a ``.torch`` teacher (finite gaps and metric set, its
   ``ckpt_step_*`` orbax directories);
11. ``[accuracy]``: the initial draw of ``init_train_model(ModelConfig())``
   held to flax's default (the JAX package's: std * sqrt(fan_in) near 1,
   the truncation, zero biases, BN 1 / 0 / 0 / 1), then the accuracy
   workflow's scripts (``umetrack_torch/
   scripts/``) at the full width of ``ModelConfig()`` in a temporary
   folder: ``resident_train gen`` (16 + 4 capsule-rendered sequences x 16
   frames, one ``warp_pool`` launch a sequence; the npz cache read back
   equals the entries' corpus at float16 rounding), ``probe`` in bf16 on 4
   sequences and ``train`` for 40 steps (loss and eval MPJPE fall, the
   history keys of ``checkpoints/history_train.json``, the checkpoint
   reloads, the inline diagnosis), ``diagnose_ckpt`` against the inline
   diagnosis, ``accuracy_loop eval`` with ``checkpoints/synthetic_r5.msgpack``
   (the round-5 capsule-domain checkpoint) over the four cells at 2
   sequences x 64 frames (the table printed; finite metrics and a success
   rate above 0 are the gates) and one cell with the port-trained
   checkpoint, and ``accuracy_loop corpus`` -> ``train`` (one
   ``warp_image_full`` launch a batch, the kernel held against its plain
   version at that shape) -> ``train-tracker``;
12. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It needs CUDA and the repository around it; without either it exits
non-zero.
"""
import argparse
import collections
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

S_BENCH, T_BENCH = 64, 16
S_SMALL, T_SMALL = 2, 4
TRACK_CALLS = 3
TD_SEQS, TD_BATCH, TD_T, TD_V = 32, 16, 16, 2  # the torch_data slice
TD_H, TD_W = 480, 640
EVAL_SEQS, EVAL_FRAMES, EVAL_CHUNK = 4, 64, 16  # the raw_data evaluation slice
CALIBRATE_CHECKED = 8  # sequences of the batched calibration also calibrated alone
CHECKPOINT = os.path.join(HERE, "checkpoints", "synthetic.msgpack")
ANGLE_TOL, WRIST_TOL_MM, SCALE_TOL = 1e-3, 0.1, 2e-3  # the JAX tests' parity bounds
CHUNKED_TOL_MM = 2e-3  # chunked against whole-sequence keypoints, the JAX tests' bound


class Bounds(NamedTuple):
    angle: float  # rad
    mm: float  # wrist translations or keypoints
    scale: float
    chunked_mm: float  # keypoints, chunked against whole-sequence evaluation


# Two calls that batch the crop geometry differently (a frame alone or inside
# its sequence, a chunk or the whole, the card or the CPU) round it
# differently: a crop camera's eye sits within 1e-4 mm (f32 at 430 mm) of its
# source camera's, crop pixels are unprojected at a depth of 1 mm, so source
# coordinates move by up to 0.02 pixels.  Seeded random weights do not feel
# that and are held to the JAX tests' bounds; the trained checkpoint turns it
# into a few 1e-3 rad and tenths of a mm on rendered edges.  That the crop
# fit alone is the cause is checked, not assumed: on the SAME crops the
# checkpoint's per-frame steps and its hoisted scan are held to the strict
# bounds (``same_crops_gap``), as are the two packages on the CPU
# (tests/test_torch_sequence_eval.py), and tests/test_torch_crops.py holds
# both packages' coordinates against a float64 run of the geometry.  With
# its own crop fit per call the checkpoint is held to twice the gaps
# measured on an H100 80GB HBM3 (the same in three runs): 3.5e-3 rad,
# 0.45 mm and 3.3e-4 in scale between ``track_frame`` and ``track_sequence``,
# 2.3e-3 rad and 0.43 mm between chunked and whole, 2.4e-3 rad, 0.18 mm and
# 4.6e-5 in scale between card and CPU; the scale keeps the strict bound.
STRICT = Bounds(ANGLE_TOL, WRIST_TOL_MM, SCALE_TOL, CHUNKED_TOL_MM)
TRAINED = Bounds(7e-3, 0.9, SCALE_TOL, 0.9)  # a frame alone or a chunk against the whole
TRAINED_CPU = Bounds(5e-3, 0.4, SCALE_TOL, 0.4)  # card against CPU
KERNEL_ATOL = 2e-2  # on the 0-255 scale, the JAX tests' bound
# the training slice: card against CPU at tests/test_torch_train.py's small
# config and bounds (the reasons for the first layers' and the zero-gradient
# biases' bounds are given there)
TRAIN_SMALL = dict(start_planes=8, backbone_blocks=(1, 1, 1, 1), n_image_feature_channels=12,
                   n_memory_channels=6)
TRAIN_B, TRAIN_K = 3, 4
# The gates that hold seeded weights to fixed bounds (the tracker's card
# against CPU, chunked against whole and bf16 against f32 at STRICT /
# BF16_LOOP; the train step's card against CPU and NCCL against no group;
# ``[tp]``'s evaluations and steps) need weights that do not magnify
# rounding.  flax's draw (the port's initial weights, with BN
# running stats 0 / 1, so eval-mode BN is the identity) magnifies it as a
# trained model does (ROADMAP Queue 3 item 5): the chunked eval moved
# 0.060 mm (bound 2e-3), the NCCL group's temporal step 9.4 x its bound
# (at batch seed 2; noise of 1e-6 on the images moves the CPU's own
# gradients 0.79-58 x the bounds at every batch seed 0-19), the model
# axis's full-width scale loss 1.3e-05 relative (bound 1e-05).  So these
# gates keep the weights they were measured on before the port took it
# (``gate_weights``, equal bit for bit to that draw) and their batch seeds
# (0; the model axis's 3).  The training phases and ``[accuracy]`` draw
# flax's, and its init line holds the rule.
GATE_WEIGHTS_SEED = 0
LOSS_RTOL, STATS_TOL = 1e-5, 1e-5
GRAD_REL_L2, FIRST_LAYERS_REL_L2, ZERO_GRAD_NOISE = 1e-3, 1e-2, 1e-5
FIRST_LAYERS = ("backbone.stem_", "backbone.stage0_block0.")
ZERO_GRAD_LEAVES = ("backbone.stem_conv.bias", "fusion.conv0.bias", "fusion.conv1.bias")
RES_SEQS, RES_T, RES_STEPS = 32, 16, 40  # the resident trainer: 32 hand rows x K=8
APP_STEPS = 4  # train app on synthetic batches of 32 x 8 frames
TREE_SEQS, TREE_BATCH = 32, 16  # train app on a 480 x 640 tree, one epoch
DISTILL_STEPS, DISTILL_EVAL_SEQS = 20, 2
# the bfloat16 compute dtype: bf16 against f32 at tests/test_bf16.py's bounds
# (measured on an H100 80GB HBM3: 7.1e-4 rad, orthonormal within 8.3e-7);
# track_frame against track_sequence in bf16 at tests/test_tracker.py:269-270's
# (seeded weights; measured 9.8e-4 rad, 0.15 mm), and with the checkpoint
# those plus TRAINED's crop-fit slack (the reason is given at TRAINED: the
# crops of a frame fitted alone differ from the sequence's by f32 rounding,
# which trained weights amplify whatever the compute dtype; measured 1.6e-2
# rad, 1.6 mm); the card's bf16 against the CPU's bf16 at the same bf16
# bounds, the two rounding each layer's output after their own orders of
# accumulation (measured 9.8e-4 rad, 0.16 mm)
BF16 = "bfloat16"
BF16_F32_ANGLE_TOL, BF16_ORTHO_TOL = 0.08, 1e-3
BF16_LOOP = Bounds(2e-2, 2.0, SCALE_TOL, CHUNKED_TOL_MM)
BF16_LOOP_TRAINED = Bounds(2e-2 + TRAINED.angle, 2.0 + TRAINED.mm, SCALE_TOL, TRAINED.chunked_mm)
BF16_CPU = Bounds(2e-2, 2.0, SCALE_TOL, CHUNKED_TOL_MM)
RES_BF16_STEPS = 16  # run_resident_training in bf16
APP_BF16_STEPS = 2  # the train app in bf16
# the accuracy workflow's drivers (umetrack_torch/scripts/): the resident
# cache, probe and full run at full width, the four-cell eval with the
# round-5 capsule checkpoint, and the torch_data loop at a tiny size
ACC_TRAIN, ACC_EVAL, ACC_T = 16, 4, 16
ACC_PROBE_SEQS, ACC_PROBE_STEPS, ACC_PROBE_EVAL = 4, 50, 25
ACC_STEPS, ACC_EVAL_EVERY = 40, 20
ACC_EVAL_SEQS, ACC_EVAL_FRAMES = 2, 64
R5_CHECKPOINT = os.path.join(HERE, "checkpoints", "synthetic_r5.msgpack")
# diagnose_ckpt (a fresh model loading the saved checkpoint) against the
# inline diagnosis (the trained model) on the same card: the same weights
# and inputs, so only a different choice of cuDNN algorithm could part them
DIAGNOSE_RTOL = 1e-4
LOOP_SEQS, LOOP_T, LOOP_STEPS, LOOP_BATCH = 4, 8, 2, 4
# [tp]: groups of processes sharing card 0 over gloo, a (world / 2, 2) mesh;
# the eval bounds are tests/test_parallel.py's sharded-eval ones (TRAINED's
# for the checkpoint on a data split, where each rank fits the crops of its
# own sequences: on the SAME crops, prepared once with no group, the
# checkpoint's scan on each rank's rows holds the strict bounds, 1.3e-5 mm
# on an H100 80GB HBM3, so the crop fit is the cause), the train bounds
# phase 9's; TP_FORWARD_TOL holds the reloaded checkpoint's forward
# against the sharded model's (cuDNN may pick other algorithms for the
# halved output widths)
TP_WORLDS, TP_MODEL = (2, 4), 2
TP_S, TP_T, TP_SEED = 4, 8, 100
TP_B = 4
TP_APP_STEPS, TP_APP_BATCH, TP_APP_WINDOW = 2, 4, 2
TP_EVAL_MM, TP_EVAL_RTOL, TP_NORM_RTOL = 1e-3, 1e-4, 1e-5
# At the full width with B=4 rows a step's gradient is ill-conditioned: a
# relative nudge of 1e-7 to the images (below f32 rounding) moves some leaves
# by ~1e-2 relative L2, and splitting the rows over data ranks (the
# synchronised BatchNorm's partial sums) by as much, past phase 9's bounds.
# Under any process group BatchNorm normalises with flax's one-pass variance
# E[x^2] - E[x]^2 (models/backbone.py::BatchNorm._synchronised), with none
# with the two-pass one, and at full width that alone moves leaves by ~1e-2
# (printed).  So there each gradient leaf and the global norm are held
# against the same step in a process group of ONE (data 1 x model 1, the
# same BatchNorm), at TP_FLOOR_FACTOR x its own floor: the larger of the
# gaps that TP_GATES names for the split, each measured here against that
# step with the same cuDNN setting (the images nudged in the group of one;
# the data split by a data-only group of 2, data 2 x model 1).  The
# gradients and the norm are gated at phase 9's bounds on
# tests/test_torch_tp.py's small config and B=6 batches, from
# ``gate_weights`` (see GATE_WEIGHTS_SEED).
TP_SMALL = dict(start_planes=16, backbone_blocks=(1, 1, 1, 1), n_image_feature_channels=12,
                n_memory_channels=6)
TP_SMALL_B, TP_SMALL_SEED, TP_SMALL_VALID = 6, 3, (True, True, True, True, False, False)
# measured (H100 80GB HBM3, 700 W): at most 1.00 and 1.00 x the floor in a
# world of 4 (train_step, temporal_train_step), 1.06 and 0.53 in a world of
# 2 with cuDNN off; with copy_to_model's backward leaving the gradient
# unsummed (a planted fault) every leaf is past it, the worst at 19,841 x
TP_FLOOR_FACTOR = 2.0
# (world, cuDNN on) -> the floors of its full-width gradients, or None:
# printed, not gated.  In a world of 2 (all B=4 rows on each rank) cuDNN
# runs the half-width convolutions through other FFT tilings than the
# whole-width ones (the kernel names are printed), which move nearly every
# leaf past its floor; with cuDNN off on both sides (PyTorch's own
# convolutions) the same split, the same model-axis code, is gated leaf by
# leaf.  There the model axis computes every sharded convolution in
# another order, which the nudge does not perturb: "another order" is the
# group of one with cuDNN on against the same with it off, and the leaves
# that pass only under it are printed by name.
TP_GATES = {(2, True): None, (2, False): ("images nudged", "another order"),
            (4, True): ("images nudged", "data split")}
TP_FORWARD_TOL = 1e-4
TP_TIMEOUT_S = 300
NEAREST_LIBRARY = "torch.nn.functional.grid_sample on an f32 copy: NOT the same function"
# the one-pass BatchNorm kernel: the backbone's crops in a track_sequences_batched
# call at the bench shape (S x T frames x 2 hands x 2 view slots), the rows
# of its fusion and regressor (S x T frames x 2 hands) and of its skeleton
# encoder (2 S hand models)
BN_CROPS = S_BENCH * T_BENCH * 2 * 2
BN_ROWS = S_BENCH * T_BENCH * 2
BN_SKELETONS = S_BENCH * 2
# the kernel against the plain version: max abs error over the output's
# largest magnitude (at least 1).  The two compute BN's affine in other
# orders: f32 a few ulp; bf16 a result rounded the other way, one ulp of
# bf16 (2^-7 relative), perhaps carried through the residual add: two.
BN_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
NO_LIBRARY = ("no single PyTorch call computes this function (grid_sample zero-pads "
              "per tap, not per floor cell, and takes float images and normalised grids)")


def zstd_frame_content(seed, n):
    """``n`` bytes from ``seed`` for the embedded zstd frames, the same with
    any numpy (splitmix64 over uint64 arrays): 4 KiB of small f32 values
    (Huffman-coded literals) and 700 words of a small vocabulary (matches),
    repeated with six byte edits and a run of one byte per copy (repeat
    offsets, literals between long matches, several blocks)."""
    import numpy as np

    z = (np.arange(n // 2 + 64, dtype=np.uint64) + np.uint64(seed) * np.uint64(1 << 32)) \
        * np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    uniform = (z >> np.uint64(40)).astype(np.float64) / float(1 << 24)
    weights = ((uniform[:1024] - 0.5) * 0.1).astype("<f4").tobytes()
    words = (b"hand ", b"tracking ", b"crop ", b"warp ", b"pose ", b"frame ", b"umetrack ")
    base = bytearray(weights + b"".join(words[int(v)] for v in z[1024:1724] % np.uint64(len(words))))
    out, k = bytearray(), 2000
    while len(out) < n:
        for _ in range(6):
            base[int(z[k] % np.uint64(len(base)))] = int(z[k + 1] & np.uint64(255))
            k += 2
        out += base + bytes([int(z[k] & np.uint64(3))]) * int(z[k + 1] % np.uint64(300))
        k += 2
    return bytes(out[:n])


# zstd frames for the [orbax] phase: the card's machine has no compressor, so
# these were made with zstandard 0.25.0 (libzstd 1.5.7) from
# zstd_frame_content(seed, size), at levels 1 and 19, with and without the
# XXH64 checksum, and without a content size from the streaming writer:
#     c = zstandard.ZstdCompressor(level=level, write_checksum=checksum)
#     frame = c.compress(data) if content_size else \
#         (lambda s: s.compress(data) + s.flush())(c.compressobj())
# They take raw and Huffman-coded literals (four streams, FSE-coded weights),
# predefined and FSE sequence tables and all three repeat offsets.
ZSTD_FRAMES = {  # name -> (seed, size, level, checksum, content size, base64 frame)
    "level 1, checksum": (1, 200000, 1, True, True, (
        "KLUv/aRADQMAbKEAmhRtQEkQEGUxdZ1dl/Pgm+kjiCYwgDSw/xbWdEEK3TkiwELCwHP18pKjf3Dzab95jTx9LYSPoGqu0pob"
        "cFlmAQuhgy8oZS5o0emxHR0S7AP0A+wDJqRVPzT21kKe6LzUVFUWylkRR1qw7R8UVBvukDLvYKHJGhAozDo+fp8iCBE4jV60"
        "2Zh85aI5nsail5d1omb+Q4i7PAJQK/+wpXkhOan4x9p1PxC+D888BlZRANvNokPvC4CcM0BtbMadOu9Sd+jbPsX+YhWZqeYk"
        "qR7ImHFcJ20NrphepQyf+8ji5k4qtQ5CDq2/keCD05Axl0U0udIpQDDbDKjRy/TYyldWwMA2T2z28IP7TRnUvRSyK/t0UboN"
        "qpJAH5nrdV+SjtdW10+RUE8bgNTD1EBrMnJ3WeqBqW67sBcLOTK7hwRQF5whfag9ZjYBpvEL8Gv0RUYn12JCPebmPdZUqvII"
        "gz/vA/rzwOld17hEe6bAoZ+2rYiHHClsK288GgCQ3vZwWfgReB5hLl/K+IpX4W/Z9XSYCd4ViQSf6cIrOJSCKzhFy8xARA4z"
        "FJai66CCttwW1ittDL1QmO+P4AbpbxwmvyDJ3EejY56IKQBfo9T9p6I3zgPN9rOS1PVe3/sgEPWNwGTlJ2UDgg8YMuMzr+1K"
        "rG3eAXN2nGTPpTiCvI7J8HUsYAFXgSDP5wj1nvlIHhgV6U0IHV+pzkx2elLnPwCf3EYSJ2y1whXHqQDrVvzxK8T5xlBmSF2C"
        "MmgLzYi22JC5BvujIej43LzTtXQhKii7DamwkYxFNhwZwf8QgYInakCMIzD8arYKtj/EduKnrGJ4EIiZs443b4qA6yvY2TWQ"
        "kVsz5sRRQ/BhArZVmVlKwmKzsdpmJR80/nCSzkGTslNI8cpTM3hkJyujlxKixJeY+YHPIODmvnvTOUW0b6QCSGZycKITy7bi"
        "I7Fu9tDm7BgzGnsQrysTxeH9iClpF2n8+p0iWR7aROmdEsEaVnJrKVO+efq25RkcFv5S2JyHiVG+FBBLKpcW06M4E/A7HHhd"
        "tlf93qIk7utuv6eqLlZi+dXeK9ScQa8Zh4DU+El1fn+UIZuFJkjwFgVQfKgtzc+ZBOJeRR7/6IuoSdB1O20L62yovNkHjqj7"
        "sFC7KbDZSy4w+50gCjkHjtcXS+g8jxvGPsCnsSkwistVHTPuhwXPn5WU7qSFV0uIQPtTOKS89OHKTzmA6F8sIHoHcao//eo9"
        "tYRkvnrB81iKZDqICUqYSSRXk9Gy6CjyuL2Y9dNBwBRjw8dufNkn9chJC91mJgju04tmpn9qDIGH8JoZW6/gy1NMpi3aV1gM"
        "NY2pw/bJXy4I+OgT6Ao/J6tDM11lwV4siDbY32Oc4ufrWhfVHIQ19DwhuLwVA298rgNcO0a5zElPjm6ATtx76AAMfmLnhJHI"
        "vl8UadZJbLJyVMzOA3E4WwsCfAE+HhuJMPoUlgBmDBRs9SQHPl+8keMpHDHTQAoPc/Wb5kvoef0HFH4ed1SN8Zowf0QLCT4B"
        "k5nzQe3lrQLS/M+36aaJwqyiARp5gl1W5jB18tUPsHKPkRw5Z8hk/pFy5xYMaTtOQvutNsS/8tvifgC488pHw0wCadEP6PF8"
        "Hg2Y/Fbc43GLk/GYqEJ/YQD1l4ws/4KOkzcw+O0tGLceRHRmDhycZasVTuImZlx5Q9hlnIaK1jdMnxnDF/sjbBDJ0bE0DSWj"
        "+TtYxy5AFVfG4v7FiGe6cZTBxlyizImOfxh24htBF1EV5D6aTF2BJ6bbCUV7DWOziVB5pHah836IqhQV4aT3k9Bceg8QXbeS"
        "pRevKfP9KoegPBTGIU8VARI7+5mxnkpuAKVi3ATZ/aKhHA4nxt2L8A+dXfJ0M3Z12SjKXiPpPR9quQJ+G5K60QGCMlKQz88v"
        "MBySLehTWNDRVbzwspTaIQ7Lws1PK20sA4TuR5Hx4i+kqE0lzUZW8QMsM1FIUqUCgBX88vB6pJZFWMkE0phuj9KdT425qsmz"
        "u2ImH0VUm3ziypKOmSqz09JkjhBCYrxY5O1CBS7zkgNmpiqN7/Sm0S+zFOacny8n86NzhEdmm4F0eGElPrjiJshvhkpQys2s"
        "CmA2Bjzbzywyb/Bq80IKPH1LJK/juBZ6SLTZSmRZ7gEOQ5gvCCv49+PNfcXI1Y6+nBDp6qlBbv/jxi/vnJn+VBCqcfA9YzdY"
        "aYPpU9I7vmgtBaMZ7+TwZgxYyLjiDUEnUmLrjd4v1YgR1kHkPB/DkQT8rgZTPCXkm4uadLgNJJZxGaJqJ26QQItF87yByG0O"
        "IWTtpxjyMoYLRbLWGpnGbnnBXSo4YyhcqTez3D4LkcsxODIZg/nhcm1U9ylAa8BIpjzbSZg267jBCqT7InUubLDegq+at0Bs"
        "iXlsaeMoSducYYaYc8Ad6gcqSOarKDf6RXR5kjwdp8tzPcTjfkIO1p144TaeGCIcw43ZgwvwiMsYRnuIB5zbYfhzqybBhrIY"
        "7bIOCt2MAvc1BFGSlUxQfvWBPJhNhTjnWzH0ndRFpXXA612ePL1NGBg+RkTpVDxos1ULnpbQQ7IPIOLqHhqgTsLLXith4VoJ"
        "iMje4uXae1CmsIzEbpZqAsel9JxuxULTm4pfv3R9pLJdYPoRFG7+kCYptx2GeAAWsA3HaTLua+HMKUxw36hHYq6gJPFDrOF6"
        "lxxdLwWRI3tgwpgpAP5NNdV4YRhhuKhuZPBmFVWmueiHy8NBeL9h0flNHdHcYcmWTxEWZiYt5BdZ+X0Tga23atYF1vggbTdJ"
        "OtQqR7gNIiqZrSypfaGZ52vUrrpSUTEH3X/q6OpFExa6yt+ka/gJ+hBDXBwBJo2tYoSie0lU9BhUpO7AGAyHckiZj/wsc3ah"
        "n4bheQ1VnRhLBvtMXh789AmjD0bgBWPgQfsiolj2I3T6O15YvAkWgM0H1vQLJiz6nVIeDPWj+zAl0f8oXXm1B/WjmHTBXbJP"
        "d2PG/CoqVRmrTNXnSFnxUiOgfAyWNo7HvL3HvPYOPK5sNQGaS/yw4M0st65CE5c9tLnsLJDSuA2INNYBP2Pu5FfuiTlknSbY"
        "TvPG51y0fF/qfOUOdD+vFQMwL7ERyztVr9j6fXbfAjb8yIafvBOn533UIrSKoi+f8CbYUWGYecqtMpOgkiY7EQDYW75Cr9yg"
        "mENkGNFFMmhsyTR71KgkUudiw/s8hN8/0YHLU+/MdJ7Z0zsZvz/kIrGjkgqbiFJWnhBt8r8cPHKW4JCDQfL6D0OEUAGBI83P"
        "MdpfcWEam8n7gls0u66IBK+PrlzUnC1MGOv8/oZLFvlozvGrkVM8bMj2tYAMwml8sL4GQ50ADXNNN8XlR5zSp/AtfrTH1jso"
        "UfRZYNBMwZNKX6r39CsGTDpd9yoWEju/yceax09JR8teeEcXSr/bKswZsJTAGahxNh+OqUOOddubxMm5KnhbCuf5ExR9vNYG"
        "ch7V2voXM1v+QRK4TJThp7eM+fBCXtHMAQTGjnyh80Q9ax2jm6+BsIEYxpcu/IMu6kegpk8Exa8zWELpWAbRslabm0NBlGwi"
        "PxZiOjddp1Hp5Fa0mPlOdxsFY9Od5qJd6ICT72By/CpGLh022O0LAgjKKzKwyyQYMHwK1kPfAIzZBuR9vzqAaPsTydzzZXoQ"
        "MrxxkA3drCIC9ZWEiATLkMF6X/78o+X7nbTGHEXI42gnpL0DspqtpgRju0RpppoF+cyt9B1tsvxR6c+LeGnAt0gUduOfI4wG"
        "yOwgWShbgy7JvtyJbDM3jYJBZl5Y8QwbB8DL9K3cYddpAHU/H4deZIiFGEkC2Nbiw/GnAMG8CwVXH6IX+0eNZIYKghWUgAI3"
        "BkyizE0yrX8OFnHEMjrtas8X8oLzEgRwIzPpKOBanNTlEVz0PA4zBwzZXHnoa9FhRDrFQhqfbRYV1222aD7EB97XqXxrqjho"
        "e8Ck2UCqhuC4GlxPtMXJJxiixMtUcX7Qog64AG/MbtPEbQl5W6oilthW3OCr2yvuRbjJxR/oSQGXmljYiw/3n2ARvhrE6YdV"
        "8p4AEoPfxBfEoV5svYsPs3lAYJQJMKPGKOS4bYGcnItpXIS93pg5hZG5tkKY10wjTMeiOM0lcuwF7kyxGQXj1BU9kPuoKqM7"
        "QVMZSzBV+EsXsGimi7nP8KXDCRALhPAgtkLJgRFQKgugrqfsQwMgfJFU6N6ifNjghCpYJOAFBmmkiNTcEEOBacEKqhpGEs+S"
        "yEmdFrg0RISw6FMkwhIFdUgxdkygncIWJS5niEsLjAg3nRuIJ3psQGQuoJa9JpGFpVnJstY2Ma3aGlozi9WqrYWlWcnC0qxk"
        "WWvbWtbaplVbW8ta29bUslet2ppWbS0szUqmlr2KadXWoGFpVrK1rLUNuqaWvULD0qxkYmjWLBY6llZ2drVm2aBjaWVnV2uW"
        "Dbqmlr1CxdCsWSx0TS17hZ5drVk2MbQa0LWstQ26ppa9QsfSys6u1iwbVAzNmsVCw9KsZNCwNCsZdCyt7OxqzbJBz67WLJsY"
        "Wg3oWFrZ2dWaZYOKoVmzWOhYWtnZ1Zplg4qhWbNY6Fha2dnVmmWDiqFZs1joWFrZ2dWaZfupK17mAZJzHCB4swhADJ8EpXTJ"
        "K8XXqoD1PVzEOAjt6SFQmnVPYZbPod19TuI1XhzT6FsCI/srQfd5vCzxyiE4d4MGDl6DRtocSngFm5x5O0sbZS5KEtQEfJDl"
        "hEjYVwEV4VWQPXWMVdpMl4+fJGSJb8V8aMt8dSmIOeJEKtuMIsVhjIXr+xEI0ONeETipmOCwLYUJLT/RDcEGSKD6PFuQGUXV"
        "TF4SkaUzuKn6HQavMznj1WKgcT5XxpuPxOSMhaMr76Bt6RFbxSZ0GvblAdw+yQuRSq2MC0NRw7ZhoKNHxl4xUhisu2mdPGbg"
        "x/XOvo7kADlYxBLTb3TouqOXD/69YvTUM69c4QrWe4QUGwQDGH6R4V8u+lKIfYqwzmON2n4+0VxU9SJrKdagPnnD+tuNxpaR"
        "881BXshczRmnbyE4r6VX5XPZbwZiPPE6PVlegwdiGoHJbU7qcfQeGXN+BcioLyd/GooLqjdW0MsVkBIzENbRBXOkrYeojVk4"
        "mVQdF3ibyJZqJjISl6Ny2ThxAyXcAoKuq9kzy0tRJ/qJATgqJk6YvgEXGm+ypttrOtjIOlBOGWgr5xUhkFqKji6fEpGMXah1"
        "M1A1rd880OVx1J46Mjr0T1Ed56uClq9gVMEXbD0dRF+WZ2lcay8rXjlIyOmJYw4/qcztt6LActSVSk9yDfoLbnzkpi2WD0IS"
        "DJ4kgc0T7Cpzk9u3hyppPx1VM4cDuhxRRTU2FGP2HxBsXiIS8tOsGP3jy9ULmVFAMD7y+hPKu+YAMporECb19wtThmZzbxkK"
        "vhELyMZCx/S0t8aYS/fZgTP+CyAAkFbjYvpPI38/AjIx8wzpeROWYt5lLkf7MMB3nFf0MzMqPZ5iUgF1pf+EotBqLHR5YuVi"
        "S/5WDAcDtn8I6XIxEdDwEBi4el2LnIukiN9MkHiEEk5nAyWB+qgBs6TGxv5n0QQEMQghhFOYDhJowBgEi4UIwkOGGESIkAiJ"
        "8I8IiDEKWXq4hQMDDHqLIy+ol6apGpRXokW6EiMomkR8BdnhMkbzgdlzskhQb08ludhCSayHtJWITNwpld+pP2VVLp9t9BoL"
        "KQ2ZcD5DRBUSasmgJkKSTVUlRvgIC2X0IgNFSwRoZngfppOTQzhoy7So7hXIxeiu7JBeistDqHIpkF1SNbNKMok3QgEbUyAO"
        "CNlUDEPHQbccpUBXEtQ8MRw8qSE9IpROHZ79zoXYqQpSy0sUMB15WPxbQaTjRGSPefj/PK9Ljom/UlNHWr6Y0a43RCp8hEHb"
        "hvNx/R1boh+opSnUOSG+M8rgbUirI3z3e6zyuWKiiFU9iIeEsNmyGyjNEphnysAUj8J1yFUq7jA5ZBMVFiINQ6EY1tCMRBLe"
        "a3BheahcMmwcWAQlNgM2+UeM9FgV9U+rKDBQWoB7sRwodwFO7KOgPZfEK3iMmanGuxe9uF5jsyyC2UcPiYKyLq3KkB1w/L+h"
        "WECUBbuy3nJOl1qT5gKeKYIG8k5gCdAZtxM4xPVhPMfeZBqtB8UslivxtrCme5uiwZcDfOFiQSuyhuiEOmvPdyZ20DbRy5cZ"
        "K+QxiC/D2WQ1QD6tphr0EtxTgfMhurF4PEkKlr3BhXC1SFmZJYz6pwZ4A5g+eEE4h1U/3M8DZnt6gMOzn/gFZ3izEISVH1aU"
        "XyegytkmdpN4C0ompQm3cefD8tK+74oiMiw46xYq2VKibWBL2nguat/GvOJrU+kwht+cksJI7xAy+3oYwcesi8xTSHSqNVMy"
        "Ud2oi1+w7GS+bo9kf+/LZSwQBCqtA9yDu5w08pnwAJSfW11rLRu5MgL0bFNBUMyOOFGyxmiJsjCilmykxc4xAwLGdd63FXDP"
        "9IAYEUvMB6o0wMk5Ckqstt+2Vq44T5p0Xee1qaY1Clv8cUOTTcd2AWZt3uAXJv1ijW6jIF6Hmax1IyvG6OUw1UlmOI8jW5ma"
        "MAnWhXgpO3IWnbWeOj73IUuD0GLEXDRqpHHM6g8mM90yBfErGN5nTjP3ixNNsEvbJgCrl2chZA4veAsmTQ9NLb7Z8D6lu4DI"
        "fwW9DC2jKYJkkUcgXd7G38qbc2LLcVlLwEbE3JSkSBtCN44C5d4PGJcFw0XsEvuHg4hrWKTdNe8sFCfqCE3lAkS7AQdRrudr"
        "RrGeg4/pHunGAWD5BhCwGp7lcFRsbk3QJ39Hqn08U7VDFkY/jy1Ohk40UHAhS9UxFr4Q2lTK+U2o4ChDPn1M8yLxn/i5I6Gc"
        "PLNJXJY4dRdPH4Bhb9DGzKI4aeK5mDA4bIH8+iigh7c8Ck/qvWDNwGG6EqGYxM93Q+u6WH2AAiP/mzd1E8zEqwL9BwAUA7xh"
        "zQDU+8l2fqOyCRnMyXdKvIKK0Fn2IudSXUmEoFnrTF1xmuNwVWpJVlgZxbPks1pFIAEHlp+jDuESIRQMgihQd9QJ7tTRUox/"
        "vjCqf2+KUYBf3E+JFWBCeP5DVbE08IWmJ6FY28iXUlDE/CCMApduZ3qGhV8C+g9PsSBUdI6FqQI6ICNo7L8DxXKt5JX/fukz"
        "LFUJwb4wFYDKJEFO773KVvtFlLo7+MwN8EVxG9E/cOUEkuEHBO35qZjv+FIr/179MwmrAn/EpVApKBCdpRTkpL9Zio2q5Obq"
        "svmZKFSi0hFNgahCAQiWE8Dxvw4VY6gSDv+z62dj/kVbXa6Sot7V")),
    "level 19, checksum": (2, 200000, 19, True, True, (
        "KLUv/aRADQMA1IIAmgAlOzQQkDsdCSwKqFSSwiMH0bmU9QNDuPBjbmiwYQJLxAeJFwTwo3VRL3Np4U5xSCvX8eMllkULpAOh"
        "A6YDfLTNaAdjPhDV9Rm+9hqbeOV+fKyOBlLJL+2I6c0Tgf6B3a+6/P4DSYiPZmZATqMKbO6CMX968nRHRwyygT9Y7+FnLDbD"
        "m4KYp3YSvMqH9SVO7TsJNv6YoTMXtHjmj9qg+rHb2WkodJ1OBvUtQKA+mGGgL7Ni6DqM/p4AlITH4LbNb2fy3DByi2sJd5tK"
        "wFR+87ty8SC65mnXM0dB8vM4k9h4EI7vm8EJNpoxhi/3hs+xQGF2pLaz/EDrS/94hOiOdX4dAmvT9dh0YwMwppmLyqVHySbG"
        "X2pZ+LDMVbwI0hU8NSP7UDao/ICq6cdwPHUg5DeO2sj2ZdxmtgrS4TPw2Ps1yBcdh0mSz+w8/YQdXflp8fKjkUg0nhuIXMkU"
        "z5zlg8/hgF3jGhrm3g1vkMyWaeoPAnlmCo/+3JHdP9OGHJmq689beWBrKcXEZO5An6yIE8/AyC2T9UVjQ8a+ThyjlNc2r99g"
        "xmB+CmPgiCjN4EeHzFAXqDprIbP38HXG7+jqp2h1fWfFs7k//nrRiDkP/IO+GqIdXKZI61lRrHAUPYOZSmhtQkEMcwSrP4f0"
        "KPMN0GGAzxhtnUkV9r/IzGWpOah/s4TkTarQ7pAiM09wMdVrjEveYom0DdEl6S42Xi4LNFD3xJNmCZDdeEdjFh5kVY17nIHG"
        "Wx3QXwMRxg0xrIF5xN9MAQKP3I7W10Am6YGJlHkKR+G3bzdDbYC5KnpM3ezR+1FThhnLjWRDxYz5DjPoy3HCriUrMk+YEJel"
        "fmhhI5LVF8PDyxeOPD6Tt4bPYGTtMYG0OUo14JU4yzQZPtP+WnEXE4lw7SeFJF+Bm+g91c+uJirmM7wrDkYAVYvQnPqimC47"
        "zdj7LDqLqBlsaH8KQQ5m+gBtK6/M5jZygdu42/gygTTnAlvPUqnoUtgkxk9bV8+AwvpcUcccveLGmtvOj0DghsfhVXNWGGte"
        "wPU+UzcLlzny7QNxFBuOCsYm0oeLa8Wp9Dpqf/CcNsjXSqP4FBA1cMYXlfkqj1VvCHL1F770+QVWROI9cVBw4RJIHxOh+ls7"
        "Ih1QlewDoDrrRZJUZKg3sK5RQ+o84EJ3tHLpRwSIP+HvvkKhIB3pIYlHcYzjAtpBfQuMqV9OUWxOK5+toRDbmI978KG5Lczm"
        "T5rbLGG4GQyJHoVx5ZRjuF4IC7MbDYl8KSokf4H115yD1JiQUJup6rayEvdHXhNUzdWyQmfC0gcj7tjGZgqv3eaQIbfOrRti"
        "iSR5Y5rPjCBtsOc4iuky6lSmQjrxDy6q7QbqBj8Zof0Bn9WHIOOyBS9q/I+386V5TmDKIVP4EkBndxO59aJdpG8dQDoZI4gy"
        "2gwpH5YBMK/ZCZDJHsCuiMGnG4LC/AQyuD4ly9arVVj7KA+ATvVE/QgBMLwVExkce9HGHyq1cRapNBO4A9lHmhjbj0/RK/H8"
        "cpNiXwaw4Euf3biCGanp9Bi6puMQ1Ec01+uzXdvEXHO2PqeGITVP7sKfT+YcLtLdX0BbguFkq24lwCDuFbEpXEjqdRpKd02n"
        "hOOj3YB6lgFm//gC+V1Qd+2NUn/pk8UHKDP7sgRlnDNKBXzEUNs1opnZS0/Kf0GhjsZzMxMI5Ppno6SPPU6b8O2as7bbb5DG"
        "6DSYuK2FQpnNnB5/K8VXT0YJgQ9rQK61FBUyZ/BC1oZUxwyfycULoqD9vWPwYosqOtD36oSyKuMpkqqtJcGm9yiTZgVEormA"
        "jMB/YMb5SmbcXFPS240/HL0wRNa1grRtKExE8znScaHEgXYDazVf3anSeYIMiiHr+p4Nb7JFpKj0D5N0+UIWsKv0qYzV8mwf"
        "zcoPzyuT/QBePHiNImkjLsp8CNasLnxjjNvUQfMVIJlTsBOSpyAh5jCuAZ4VhcSfXp25aoxEJ56JcyXNKc/clOouO2eonsUg"
        "fbkum+6j26GzPJ61F26DA22lrucFVB8x/GsiEhIzlhQ8T5OjmL1oeLMCeOozpKjmxJx2Gu+dn8EjxgX3sN1oA9gDeAvRfgTU"
        "deAE7gNYkuJ0bXPtGafoTE0GHUkRR4/qFTaiBi4/he2CoZBVYb417ZNdpX2V7y6zSdjsPrhpztrEth40jA0nj2dLInKYG/y9"
        "V1UtdSSeORgNEa3L0LHNB+r4Gg5uqVf80Xoc9229K9Tuo6jDL4Gh4CC+0lfa8ua4bpW2Ehn7zvvMJof6B8x2/II8FX4YPXNC"
        "FH1P5gFNSzKwupTM2FcBkvJeDVh4LOTTxeJQ/RoJ2YdVKY8T9wfbIdD5Yi6UfA8alCfiubYPP2Z9iInSMUkM9qYkJrWaB30s"
        "a5QbYfJ2oS8q8pbaWuxgMduDNACb68gW3vTT50MA1XUQE5VN+AaRw/Hi4otac04jawqGIjjnkfnafDG03ubb9hnMtHyFNKkk"
        "DhRJeAeDWHwCJ0aYjpRijnqtwVaM00+D8ZTH7DJf7ZOsvTG6uU0rq6WwUeW4GGLSwlROP4zPhGfpxD2cCQodIXEcw7n2gMXT"
        "hzw5/ABuZ3EhV5+D8XlzNQVeLKTp+gXkouAlhqZcQUyoF6oT0YMMZL2LHsesJckoprJY7UexJs6yw9oemmzGdW9XfQJBZYb/"
        "bHMV04Q7+EL3VH4KYbAD349y0ZMXVB1l6p22XL3E+wqbfX9mRkeFUgXlItGcPoEyjjGaDoq/JCjogZIkyQ8EJfMWgASwW+U3"
        "Z0n66uuMpX7CYpB7dRZmLA1gLWaAF55kUm1IRZCt2Cb7TIMdfgL16qUaYcTdJ98M98Ksx2h+/lQRBf+UY+w2b7knN5zFHxxl"
        "MyyIzxsJ6NBsFhXdzlObR/KSfbCpbH7qlHoNYbR5ghMlDKdEm8X8SMWECud8RWU3d9NgvrCdyld0L2A4Ot02sWj6UWNrcRcM"
        "8uHBH76Bz1jMAsn31eh8emegZuaqY/BOjhrzhDRfnAxm4r91aPMuVizbsMs3LqJCSh1CqOtplnxhKQX6/I+CpQ8bASdX6+bE"
        "jYh9PRmH9T2QdvSYY7vIdds5+rB5/Lg/X3pC9K4F10BmOakXbpUlzVmLMPtLVrF5VNn6kkDYn454z3oifKVz0BlrdPNYELne"
        "00HNb4CTHSYv8aMmjcVnDHTzFRIMDUlsLD4E5ZrL3OzFbHm0cDRs+grgfPoCykLfY8QxQ+l5+RHvAO9C4tstGKt+1VpqvTDe"
        "fsPEMudJkLLUjhRfM5XmqQAo7oiBlPNBIm3HRpuZQaMUGS9s11hJJMUXYKbu+0GhJ0qDtpMXiJ1jjKJnFUB22B1iz9jS91V6"
        "NGPGtGmOgqKZv9C++TzwjP+mX7+zRtWFCFH9gS3OJ+Mz7DdJ1cxF6X0EFrr+zHHyKyzCtpeQ4jPhGYs//cy1n7dMNxM16GOA"
        "tD4VcfdyMT5jzsM55xDJ7ageLHwow2B/+3hmKOvUqX2uXFF17AGEfchRPZ2NZXCv2RB6tmIYNotFSWojg5Rcrc5pjiom6DuR"
        "xrJak+pntdmQy+rADYSS7rPASJuCjrH/ahKgucT8NQ83QtwGnG0/9ljqzDhxTbnnzWJ/uclQbn2I2tdTJFpjIgWsnVZ492Uz"
        "rF0J4u8j0OBmrARhmipr07VVR3j7SOplQbLeRE+EY1FaeqtERL9FAzEuc6jTAy1QOfXHlMtWBZqrJKu94UpmV3bwbCo7dzla"
        "ZZcRRPKEuWpsu2ytm9PKBnAZebXutXDYVPZwYULAb0Zzsms5e1N/pqTPDSf/XPNzgDeuQVhrqBJW/zBmKQc8pnh5LLA19vhS"
        "2GghwwUMFSn4aLDo09vbYoFNwXfdWiEjRd7Wnh6fCs/Tc/NFrsjP4OGar2I1/oJT2pYOqBzOrxIuFDD1SMnOHOELxlcg8tiT"
        "nnVZQvbGiw26M5QvcA35Gq13K5OoWovVlIdJw/REOB18LJHnN9E56TyPUy4nTPKpjYFu5k6bwQSTfFTKycVDBe05crY8a8L6"
        "0ibLrwAIMKNtXfFKbORHVTcfjcqOz5GTrqeLNH7M2o9G8X51skzbWYS6ZlXJ53TBPI9R0RdtMMpkieY8Asc2GQ7wzL2LvO6m"
        "bykX4MrltyBSvkyFX76AhewTEBLCjUJwfTUjWTmCICgP5YQvFpEk280SnAIdiyZYU4r9NQ22O6oTHKhnPjYZaihMrn7tjBAn"
        "9HKDBahdO4qhXxOKYpvRzuuAzAI9yuRdPL3S9URywPrMxp2rAWH5UT0MvaYD2lSBCp36B6rjHHbCVp5A/teT2NO4eR9NiFt3"
        "cbL+mmaYY+bNLIFyqhPV6XsxHlsf1WYDjOXm+gwgsHgooGEHqpPsPYxjTYZPCebLdv8tin2lLUv5rfsjw2kdeQIgJHXjnWmv"
        "OWTUFyz0dZoCa5z7xrI//SyfAJoe1suIiXQk2q2DwFL1Ki7V+K+v23M01FH/WOh2JG81YyUK1Fx5KgOINshrKwgbxpZttqDB"
        "kUqF7vpRr7gMc6FZS1BNaynX9OUmYue1pwuewD6W2eNf8GORu/YKqYSKtNkBDcBstjgIZmQdzFU3LF+D41ke8GBAFsDB7FvS"
        "GrebpG3HGFO/wtYVu+X5NgVMrE/Jaf8JiV2bgLufL6V8AQff9+rq8m6ktvz1F+iFRsR5oUZUcaCCrVurd/kLxaIr6IM646Hf"
        "N2H9aKstmdkCj6WfVjHbCQVEnqLpyoXY0XkCJW0+UCXwrQbpOi/tmp2aDvgcQlOegM9gJrDF8lhP9wOUaHu2PEC77NVZoyc9"
        "JcnTPjg/DJz7AhoufYKaa8bwAiu+nNH9phww3BGVuNgTT9+vmYiz2GP92Zg1k0PDOAbrfAZ0JGUuR2UeHtP3EWYMflgdzfZT"
        "pTAHcJtywqUp2HtVbctAzKzWgct3b2UlCHK9AsvF24yx/CZFbbhcTa1PkdDNuXPPR+gNNhcCm04lEvOfttpiM4auLdlom7PC"
        "eMaNzFzlDGkWuaYWOjJTDd3mbMKNJz1oW8+Stl58cu0vWmvaaqXrP04isheUxkbArfwrIHjwlztrgMqocUtSVP7USAcgRGAQ"
        "Q2W2AVEEEBEiK0ACKiDBBCtdkGRZAyZJG5GYocM652/6jK+0zfqgoczIyi0kGjXLTShv4l56SvTTCCRP3XLM39XoewM5rKpj"
        "zOhDMHnxeZ/6PrH7WDhXaUg0RgGXKVn8yuXT3YRWkboSjSgtc+x549wuGZOVVSFniGaBC51GqkFnjBl/Tum1tuXo5FitX0z1"
        "QX3seWUu0OY4+kU/U1+xjV0lmw5ZpNFDDONMwii7JpWOCM+PBSN8UEZW6QIOWmr2ZZRQ9bNOA//qkEiUWWh7B3/yPdR/IEft"
        "QCFS0ctUMb3AZ4PZa8beBxaL1yhNIe84siRkw+2+fdsC/mdmcj95YsVlV7TZRBSoEyDaUuK0AzaEReOk2ljcUtDUiHST7SoR"
        "o7GNBXm/ABFR2lC3LCZutoOcXBg8XQIyU6NOrIhXMZkYJXZQ20ei+ABUZgvQxHqheYhg0VzMDFPBd7f9zDEjBc4s+EWWA9RG"
        "80MF5YqhGhsCUJ/jw69ipqCy/QGiCqwSAPQFAPoRH1Nl8gIOvpSXWIUBWNLgoiR8ZALFYpAdA/ljpxLcxOJMFzVMegIa4pCk"
        "cXtx77veIQCCLst03wl9Alceq3WvA7azXZhNSQBs4PNnNrJyHe3JueWEIGmHjYFypISAy6gwH9BERGREaIs5EogQSCBIBAwB"
        "RcARIARIQUmAIAhEMMIgBAlBQoAgEAgDpw8g/c0lHTMw17hOKa933kc9bdL2v/VGuIkgGMKl9FvSh+LaaHG0GnrhV5CFkKZp"
        "SqZOPEuwrOjj+gyE4DA3ha2o7kUbIvHnlx0obMT+icDmJh1ANpliyREGg2f1NEWEQYaAeWa5Mk71aVgMRo0M2YcYdgLYOpSR"
        "pyBuPdV9KhUVyBTrYUiSNX8K8LdDVqOEO/RZN2G+j+Ueg0HQIDm/ZFA3fDNx0Zysi48rq0Fs1YkrLXic3gIPbAnOt4m0sCsZ"
        "9uVld7oLCJ1g3Rpo/1V0FWCH7/8gBkvVAA+q0UsCRyEEUW2Mz8stqhkcymqsmJtUWQ3bI+BzJRviFwBbtpzb3jLJQmEfWLSh"
        "bQjK6odwtfchPilPJrhhvdrFIo8gE9NOrMrEA69qFJ6PJn5/ZWMVoBUZRgSJWcfBXx4Y9Kmpi5hAiEm+amkNVQ3VL/yOioEm"
        "MTTbMyizYryVsTEh4Bb6rHK+oKjNTRSNNapqy//S+DBRHAfCEIDd3LJOwVYdrhmv0zE0eInDs8G9VYgxOJ6aqmQjqNGh87j7"
        "9Wu4P1Pgqai9egFmcVz9eBvMOtyFNTI1gXjdkB+CQoNpkpPgLYE8ZYkzmWFCFV0HAOQDQoBTJWBBM0bAWJIBp+5/NTWeAuQA"
        "lECG3gBlq0SuI8h46FIa+iiyjAvIzsYAt+R6pkD5A6qQUd4uJrPoO0NFqID8cKX81AMSaBD4//8bDIaAIVOF1weMdr04H0Tj"
        "BJXt9Eqe+0//DQX2SVmncURjLLfl9go2mExLCTbpnFUE4xcbbBJpKlGlIRp9qsCZuaCc1AF9hrUs104tZ5bkSZB7kWSdA+qq"
        "Jr3sxnLEmYY6CkLsNUh+CoRsOxOgtG3IXfeY/vAsCw9bG7hBEqV8YiWZuyOYzg12t12w07qGV6V9wbmoDkToBPZQyDxZiNO4")),
    "level 19, no content size": (3, 200000, 19, False, False, (
        "KLUv/QBozIIASv/UOjQQkDsdY0gmTldxSv9QIUvJ7L4n8PGDhRD1SmRINvgGMEYidxE/Uq6Y3pKYzEsRIpRC5kILmQOhA5sD"
        "ZRpQYzJFMvsBIMnMJpfpAgY9OZiPLg8VZduDKnE9Fzl9+QGmnVPLfOEu1jSGNAgb9w/vbxVA+w0hyxzF4c6rjJJPx1YXn4GE"
        "9QOUjRqS0rerqYH6khppvbbL7/m+Widgo9OdzuQcakcXc6q4vpkbYxkKSsYz8j36BRpkzlTF79dYhDWZBoPZgQoZrXhG6vME"
        "eWa3Kk13gnP0C7/ZTkuMveeDXWdw7LaZE5Vb3f1ltARY8WWM6QORUvseJLRgRiSicQjOr7MFAXy0wky4hx81Q/vI6EVIBO7l"
        "Kp7wzFOuSju/rlPaSyoYXQGR3HqcnLGjSdt+4mSbyw7zYjWDvj/YgzD2g7T2ZGXjb2VZnQGdmj9DpQUfOmphDgKsGQrx6vvU"
        "WdL6CVzuus6Uql1UMcJ45tRiK2CszkRXBl+SedtrSrJNC0DUtvqz2ZdjnN4hos+oA7BrKMwzlrSG9bdN6C9WEJOd3h61mwK3"
        "t5zj/E04ir6G6M9o1+RYiAB5FoMhMKI71u5TdXMJcC/87LIqluvyfDWa2+bOwcxQxw/56Zu6e4bUmFGhbG+yqPOn4d9DyE+n"
        "kMbFo2iU+TL0TLxZ9LEFyLnClCewucAJMa3HavtSCx77SAdtBmOk8glb0tfjSKpHSED8mIvGb5v4ZSctKnwKdYV9WPi+kMnn"
        "g7m3x0BoZbcAbjIERTVasIrU05qwcGUlNvYtN6bknDZnxvaQE1bfGhP2UpBYxHlWhv5gRzUXsKTMbWpkHYn4fUqKXI616O4n"
        "VJ/t5q/wO3jV3AIcFQzFJfULP/JaTN/T2WDI/RWv7EuA3gyXeBljeV5bhhq3x8Isvk3dnWMo5BevAdQ2d8rES7kg5t9EuMYA"
        "kmh9jUudfxDXn1TJ0KNUEDsFE61Y7wnb+YSlpxmJegQwKd4Imq/3GesLInnMFupAHW3wMSuQcOdoBvziSSy9LFX5wadRAfrN"
        "X5jDCQg1F+r1vk5mMKw+zeVDlAwFtujdMLCE42A9dqA4qjbkJskEutEvOKiRCeRB4yl70/9r7NPhS4FV+rtmyCdqEJS75tby"
        "V9tXHIv5vpUP2/9iFfZZE5mOdYFHji54fEYv0XdQKUmLcSTsQDZBjtaE1hmN25UQox9nBWILINv6mFyi3jIt8i80k/pxD2KO"
        "ylLZVq6oPo9sDPaQl/0CnN+HUGGzizyia2AQwA1Mofu9DXiNyIOUS/NCwF2A1LZiXWtGKZpf50wbY9wM7UZz1pMQDoAFXpeD"
        "17MfVUH8Ro2iMeQfbX7T8+hPPwgbjp03ljJ2D+nFLptR4Oy2Fdl24yfbF5wyfUtFljgq7Po+JqlixxWZGSuIo4uViPrTUWbX"
        "B4Ln51UR8VUom/wAJ9vYq/j8s0VY+MdUtgn3mvReFutNbPL4ATwschVMmEflsclRRUpfgtvqIg6eMWKEa1VSWRYZmcmDDrgP"
        "VKZ3GVlrSijK4jBnhn3YGNfVorhmtsa3WEilNiPgsmozq2k/KZu2ICTc2AtRNoddxcF+eNMutAQIc4KZ+lTwQe/AkelgUVLe"
        "a0pm5znD2DKgos/IDzZGdCKamf443ZlMvmMPbVwmKduVb4xPhIybBwgs9DMHf20mTF9msO38Fn4k85ReVTxoB9t8djTbCafU"
        "B3Lx/csKeJ/7OOMih1qv4rKhFTB1/QtsjMsZadSEthjCjlvcHAESiqNFHmkFOwAdAorFrpTGhJtxaHM3xPSsSASfiAv0yVSf"
        "rYfOYyZs1KaM0vdQaFNfVkmzBq2fM1hs7DZBUa8isctplapkAnO5tV1zsJgsvTZsMPUz/aTwMTVeZ+MC/D6Giu7VYAr3TfJ2"
        "GdvrZALKvi3qC2syur4QDdocgE8yt32kL+To22fKnnEUhTXWIqhtwQmbT0ZSmEeYk9hZGtr8VHLoUMrFtspiwjvUvM40tZi9"
        "HN3IXZWwp7X40IC+HV5PpTh/B8cifyYo/Ep0RMA2GL1viaTbXHJusRFBrGc1fshUSkS0XAO1DGao7WwOzl6sAQj/IbY5YHHz"
        "FxfNP5Nk9faSp7PY5Sxhzl1u4Hj5U4os+kV6gC3DSesvvXB76untejWpH7kIjQPtsH7lhc3/IZnzsQNPMJ0gj/nZXfxII4kN"
        "SHrN0UhqOS6RlxvokG0jeFz5KlAMhrTMnjHhUrMUHCLDXnDfkVBrb6JN+E2WmqeexnqRmTixBU1rXmBVxjNwrzQXy2vzaQJs"
        "x7u7HpOWH9FZ4aeQZOzINZbuNCZ9mw9ah4ORqAFkMNGLR6K0oSt6fsXIMY/JyNKCcQrbiZ+4p5TICS8IQoWv/LQZAAkR2Usw"
        "E76r/MKQ1e/TuVzLXdG27uuA+dwlUm0ngrdBOAjLBKx4dGQdosNjKLNTN3kAhdpuQQHwlTgo8zZDnR9HkvfMaYI2V6gQ4kyP"
        "xDNPEbCQvRKv3mokCUxn0+oBrlBWo5wQdCen8T2Cz5DhxmqwTN9Qy1NOIAnBW/1IAgfOhtWlZxxq+h1EuLnL0qunl2FwJEBq"
        "2WurL6f9sfos0jJHE0TjtYnG/m27+XxkCGM9Ckx0F6THfmSZCdf508J8MLKutuZKHKcz6gC0GH4Bgadz5TG5gCKBGQpQpxtg"
        "0gnYUmG2DaZFX08mMMwXmCzpDE7u4hBfrJlAzPVooWuussoOQdDYI5jbfiKjJL84Q8xHCaTpUC1LPkxW1s0YSN1sjNNfxtP3"
        "e9s+Fb1vM0jUBx+Bvw1lip6XKZjjYlPG+IPIF252+ehiLsRkC2h5robn0MV05GkjKaBjqnlh3s5sa5lKA5ozzMB8rTqMXp2S"
        "+HgmRTuKJfRXIEH0J5+/zEXo6wN0HLq0jZWzXZloRWx9LkAG2hsOKOtvjS68N/XoS965JgSprCkVdMgGurb5jQ9hDqDgQS89"
        "qTFlHmoTDkKdzfFOFmus0Vc0lEgBx2mk9p8lTy3IZPiOfNWWM8j6U8ho/JnDJo61QPJH2LHCdEmkuapoLQt4A/nwHmNuzqrm"
        "UttW3UzxPhoA1k5by3QoKV0yXJfHY2FKu+uj6f2+FLvFgu5/EfllNDsE+QvRsb+H4v4QCNVDJ1z/sFDgG7oQGMtdZttCCcz/"
        "4iSOty0QkRH0eOwfGLDvMDbfzIDGX1NJfUQpXjdKDvrUnT7uxbeYq4mwovzTJBdmIJVtLi6wHoAKw1zlg4QZ/zzGnWW032OJ"
        "CiuJ6rkanUZeJsb4PBRp8wVCNVrOBAmDGe0a+EzmbL+QTPMtsPW1GTGuVmFI6wXUwA/lBdULGDrSf20As1ihtQk1uEfpgjwd"
        "F5rNxyH7WAilPMILakNLhX8p95UDwHHyZE20PrDrrY51uGYzpkYPKc4znzlBxlgMYXOCPD8eyATG9lFpIg7DRPuHbYb8FTaA"
        "MZJBaq3FkWKMODXhbXJSbyDVy7Bl1aF6CDqSTmEuk6Hju1xtK+qx/gYvfZ8YmRuMGiqPE3Ii3szCthszap/VurkBgz9Pq2Dn"
        "ZtzYzargfYol10eTlfaYSohOBeOBv2WvzzMXpeU4acwKIpNkOKemz0Lp+n0ImNNStLnVk12WO1BHs93Y6qoePGi9KmLtt4RI"
        "Otokmy6RJJq9s9r6ZhtfRXl7MYv6WAQxe6+5vKoadbJKkeJCR6Z/uFfFNYCF5avMsYdjJfwtUK0MXYrianFPMdxndbIQHRxd"
        "y4rY++GV5QQh2Lwl4bWf3exL0TAzBTM2Z0E2XJuvzrBHXB9jrXEGwcS4MQPGjRYy7HDoeGGno4UPuroWOq5adFgcdlo1XrTQ"
        "sYOujsfvUXP3WshU340eQTmqCzanARnjX90ecAdJ1izBcMsPGIJe+U4yPY9KAyVTmUBhQtLMp5InjSMLcB3K1Kc7F3FjwTw9"
        "d/MgCN57Y/0fnFuXk0K+lCfgA+jCjeucUOFKYaa5QA1qfpLMcrEcirntLfpVXARmuahbQ2Ea+ttgYNOZovF0eEDhreK0CXWx"
        "jcib6E5PNf7ED+nbKdEBRgKr5TKx7NfoEvZ8mFDFaHy4L3eYJDeFsGzu1PcJbAHdgGJutigtHClB26V68naeBV4f40r6Aw+a"
        "Hn2Als3CtnCXHFd/4k3mKlcfTGmGm8UevcgOnqD1nMm5bpx8kdU4dL4lhLiPAF89igdTjAFOCvdplPlL7gY9giEKPgZFKn6b"
        "wP2nSuuTARPjXQmgMaAKenEHtud/gSTxDkP3i5uB2SvS/0iOJh1h0g0GNETaIqqw3bod3pbc0MMxTFG61A3LHdS9dRuVXfsL"
        "cH6aLa6+oi1sX8zsKVFN3lk+9Jcm0a/anPqARA6DgPDNa4cffjPKkJxGRuXx3jR61yOrNnP6meEAtWIYilYHgAerp2hz3wnk"
        "2m17VBmAIeRziDDNE+YEO8MRw/7bcmDb3U69/sMJfQmIvr70gUjXKdSkC/U8tZsHVL8Htuwebj0/DAnsz2g0+JAe9ehEqK+O"
        "1ImXpVKcyGh7BhuWk/4cuml3o7a9RyxJS8hzbZjqPDuqZS4jwIrz2ErYHLcIKh6DZtqJEIU92Q2qP6U8asc1U/jOlNpnIqTo"
        "PkqSbamG1aaTU/twRObe7Yz2wTSRymRhouJEjNQyVEj1P2heu5COssxEBetbbGVdQ1RtfjpSzfDd9QndqXbnCmiGg8xW90Ro"
        "nawBZvcZnFL96wW9hzvqfxFGm4uNakM6YulQZFhkDFDmnhPP2xxKDMJXKm3vyYVlMTrYf0Sl4WhLHl+Sls2/PgLMT2B1coNB"
        "inAWoqcvbSh8OhHRF3ShjdvccXOBukXPyRSlK3EkZgM2IBuwyDRTgIrrQS5xWe4umh9ssATMFaociRPBuG6GF/dde9HYUU/7"
        "OJ6P3RVp2udLG9J/sibeERP1zbTwxkiYaFsKHUQPS4AhV03d8Ca4Z5dw0NUhZImfERWuLGDBiczgr9Df/sb+kaEYf6JAmTuq"
        "h8fBWbzNzIZfYjikmqfljVF0eOaqpR589bV+pByYXWZYDYDKqGErSMr/SnUgRGCMUma2AaIYFgFEAJUEFAEDG5XKMKFWCtNu"
        "MpXcBp+E19lar/SabrXlREYnaVAPUUtpZA0fSXRvw8IW1i6yb/J7qnURNdOEvWFx44TAYV0ECy92pSdOqA1+j05XwSEElCTH"
        "WvwEniybXkRsuDCPjT5sVi/eQMEq/+fBc+N9e4RxSl3Aas4BvoqnY8Jpe5uyUA9eknRIDGwJhUhWGyLI2qHoA9keG774hHwc"
        "JFiI1fIF0i3j8cgdSFm2DE1vgnTluPOdOQQK6u4Tp8/LpBbSqgG8aUp74o4TVvJ1yzvqFYM8BYAojBUq2GaImzZeIGLCwvNl"
        "OtROQF0FEA9Y5J/IXLmTIUV1vSHwZBhv1OmNv/ngGKLu8Q+C3Fs+gDPgPa42noYV03cEe0wkuEcTilMloIfW9Q6Ock0nvWTa"
        "jEwVK5wVmxtSraBSlZP1AWsPmj0K27vqPiVUYnYAb878Z3pNq7p/jEnQvWQf/rZEKvwg/P1QJF43lhwK71NNFsfRVHBiQR+N"
        "a0H1/GlSYZ3oqB4aUiUa0/wDTBIABAY+AnWjqoCcHANXA/9L3JUBOb2QQ3flAHZb1YREEQNqBfeswlUA/Ef4I11b8UU+xXcH"
        "AsN362ORW3ogLDSb6QMcnolmy6YABDX9juc32j/gO3a89UQpCEwAsHDQ7NYOA/eAyqggP4ERIcQg5ZRRMB0S2AEhQAjaCAGE"
        "cAhDwCEEEQFEkCAECIGCECAQBZLW9AE/OGJ2Ie2pJye1xrAfyNhenwgN45CvW3EAKwJc5J+Y1wM17mIWhVXoKKCL4usUI3fP"
        "tNcZZEu7PpsTIgMKAXDO/Ik+ttiTl9h8qVNIlGOLs1i5X6EnyjH1MVT5CWnvgyt7wb3du/Sf2C+jWovQqPgXopQpdgsXvuUi"
        "ELoD2u1i5LeTvZL5XGQhIatU8zc0gjS0GMEllOfWy16wLdGAiKyIzG43Lp7TYZuCcf4CqgO+xz8MOLD/amJjzhKnWIdyPUdI"
        "SqA1HQ/SF+8W9oxVqDJnpZA4xWS/4PTiXcT5x/i1qs8hlS9+vh9SkJxeeGkafUVBxUPq5bjBDxg3ENBgUEpETbEKYow6zUnR"
        "cDx8BdhD4wvyFsAWv06WzwAV4tmbhEZWPYugwCSdcDHhnyVpFuuXD7Pm5WjpvgX81MdplLEVkpv4xaGr1jn/oW8zmOzXRgZu"
        "8m82sawDMNrCdoo+KHQTAkRxeeLh66gRUyeb3WhQoNsoRzP0RoOI+b6eaRmJKkZd3FeRJc81heN8Lrw4FJAlGeKSW8VbHfUq"
        "3uFgRfkc4ET8A721+0EI/SZ89IHiBmevOxhLOSMC9QYAhANnZ8pDdc6p2UBz/kHhamD+KBZonxlVRBZAAaw9fXQBGE3+OhUl"
        "WtR3k5jeAh/BW9o72AE03C4SpUSocPyQpfzUARJwEPh/B8E/g2E4FMvcPoSwoq9Xh8P+QKpBu7ZNt0JFCisb0kepgj0IA8Qp"
        "JxTZTzLswlognO4aad/cktwoa9AQSRBlt7C9Lvp08krHRDIEh37nB5B6DFEgH+9H2vLpowBKmH4xAiB4nWEneUE+WpSafQS1"
        "biUP4J0d6I7qw96UvYGn5raiDQZGfvRy4ySGMGDuROEaOfWhma8u")),
    "level 1, no content size": (4, 120000, 1, False, False, (
        "KLUv/QBIHa0A2jgFSEsQEKYldY84zJ5nncOAzst3uzGb0SlOZsWOxecR/Jgm3eXys/VwqeJLKHFryxLesm02dgQZ6kLjfauN"
        "zCqIcd2+gUjuhhUFtfS+0CR8BIsEhwSvRGSL3yVV3TQEXK2AUPWH5HM3xXP0hbyoN2mD8xiwqDusfHGbVHwIvFqfQIDqqyAS"
        "Pw0BO/YKlDo7gVA3CWDoaNYQeDylO99Gh9ovKfHD+5IEuqAcnGZCyuEhPGW5YKGvbRT01F9b5PYVMQDaBI6q8QiuqA2AInMo"
        "GRR9gRXUdhaOE7oFn8G4SqGv/dRiyMv1OO6tPoFeBY+TvvAjb2dAHJyQBj7d9GSIjyHn9pXWkG/Tk9obFjDhI2yg2yTUYDge"
        "2N6Ugyx9MR3GfVSEhh6KaWkTGkB5FHmU8RciUhpFij+jh+rR2ASw6IGBmroqasiuGlLbrqVkG/248bonjLuMCTcJFiV2jAuc"
        "NBJUz7dh237kstsicFwxAsoi3TAYKP5bFenBOCh3iC1r8Z5uTuEzUj0k8ha3xZm5hwOM6xkBou4Eqfp/SdVn0hp6FCx7WBaq"
        "Bz7Qpq2IlLzbk9I/sBKyXlFWnwWPuL2FFbapdGzHo9SubMz86RYl0GgoqBiPDrl5Lkr+fMeTcXtAIYwe8eXLh4mx86M4bj6Y"
        "JMvXfDX1UAuNTRR4RE+VEZZZEkFRj8VQ2lNUgDvrmaBlYPDxZWCp15lR535pjh+3QN4b/K5oGDyIfAQ8xa0x2HMIptxtFVWU"
        "vwak1XkDGG8mZ7o28SD1flqOPqhKGNPpQEoXiY54lhDm9GrM8CRM1T3bFeHe0KVHi5VJ2Vwf/PRQBR/+iVJ7immP5hKj20gW"
        "hOkSVdbopA7kPJ0XV9prDd1vUTn5ECInp3JSNxWEQhr7cYt+CVrmHoWp6QaRBM3OEB2yRQjq21yAtDiSnZpRhT1H9/Fib4ON"
        "6X2gBPQ0sU5MNxmtedTYcBcDqXqrBpZ9xNZuH2R6wUB28VrS8b8IGZ1PXfvK4tG3ckhdCNeeCxHAkn7RVWRP3UGJh2CRPhJS"
        "cSuhBcZmbVUXgcvM97Tok2xsGuzNla3BzMW/bc2XEkL0HVgO91Ayx8vhwHsT/sx5lOmKxZrl0fFgUOQfpLmtVpBIvfFHnN6A"
        "JW+biLPGnzwgZw+rSx/HwfRzCroH5MRMowA04U+GhtrFGsAPEyLoI7jB25pE8tn0pLqAIG6MaRaQTp/MscwFhaSbBAQ2dlQR"
        "It001bVyAISoWxT5rXVoqP8byD0eQFHPNKJPZ5GZ43NWqO6rCFroJxCO/gaf4U7ysecenDA6y0Rqaw5Hv1U39CdUCm2jFG+c"
        "olqnm87EODVLfxcF1fcwKO71WrD7OUSE7oCd22+YUedHkET31AUiNgHFvc+i1cALpviz9q1fTtVNz/VVj2IV6GHIqM/BGPdL"
        "nPStTMSqcQVKsv/Dxy2OXaJRORV6EZO4LQKp5YH08WkVTrZLmAlboZxU9wisEm/ig6sd4izJTtFW53GQbaswKvRBXMY8kxSk"
        "9Prm7aoorLVgYPGuuzqHO5a5350Qr3IV5WSKR2/KuVoF0ZpbCGi5tyyA2kovhPqAr6HHY4q8A6STDqH21EV3huynEz4cTgM9"
        "j8MH5UguUJwCC5Q21gbUUNQ1AU+BlqxXgoz+0JPqOyHyRxeHIK1hY4oP5yvwkSqg0+uZOO7CoPh4zz1OhePrt6QwpczyFbrX"
        "Nr6UIHJ2ByeodQQNhDpE0l3MgomqvsDk6PkgTfm3p6yZxORY6zilZGpUj98GUBG9VgDChtqg56VC7MVtMnB6EAajvyZo7cGA"
        "ePs/ZGuPxu+2jDK6WA3067N83TqHh2+HxXbaAKkTGovInXUJ8svvmCn6mTly78dD1a4igIYmkQCd86gx51BIZL0VQXQbRZE9"
        "u2qEKJ0V93QuHtEfNMC4V5iw9yqM7H10isxJoCO4q4I8xVRzZHELLNi50RhRbyGgFc9gQ6ZNKBnTTjP+3skGPT7Pl7bX4/Xq"
        "rKmwH2NG34/LTYMoK+KDZHJ0jDiBm0UAZvhWfq0XvAh1VR0wfmzhpL3g1jgXOWPeyo243wCH50H6jsYTSoR7bM+P3UFFVRP/"
        "/MVTOLvpi+foTrasuZ1VWezlSHEFs9Zpoh/bGpp0vZQ7TV+AFRQP7IrzoyQbn2eFvt2ERy6mMkb2X+z8KZN3p+gmPqDqCxvI"
        "fRwQJ11FNNwyjNh5GKHeKZQGXxAB4mYqoFCcJYST/iCijdZhdjaIriotQKCNDaKBrG9h2PCVS6ib4gi0UZo/J+EBMWOeJsff"
        "75qWOnJkxdOl6sJq3k8cTOwqvBLcgy5t7xcmr2oaFGMpSP6cSp/UQ5giR4cYvLM/XEDzTfiG34VIUMMwxo8EUKCTicBbVWg4"
        "7rEjpK0CurQWcRPqISkrOuxrh58wdeV7opqrnRShL1Fgyvohqs7Z2PTYGjRc+Q4K6KGxuNiJm+jxfQoTBP3IXAO7qCoXz+nj"
        "tgf4c2Mbz1w43okePmbOdiwTGD/GD7UvIqNPy7CyWwkBVtc5XqraKIYCawYpCHUWjR1OKEbxuZ7IvoKnUjM5cdMczpQcDge3"
        "f4tiXKk4cNIDtGBnY4FR4Lf4udlOZ2EchKp2Hx5U9xDQB50BTh7t4WqMbtH0875hnIaxlcTfqhC97Ktud2ByeisnzR/EYvYX"
        "AAFj5EBN6km+7LRXhjyPzIL6xR7Y2iaF3Xr1RV1NMPp6OVmWfk4buL2iz9/KJ0z0B9Wq9Aou4qtZq4uVYBE1lQVJVixFc78G"
        "hTddS0H4FSAVWofMUXfXlZo+SiG2jRSI7SUtL2+1LK5KsBzfA1W5u5AM8idbmisSDeEW62Aa12HhtIkoxFuoBeO/3FB6KoFQ"
        "0ylVUWtYkR0I4JJLqdQVyAYy7ztidBJQfX8FzN/+WiHq9Y5KT1ya7a6tJ0dB6uq7jKC2B2gD5yrO8PnVGhufV4hvY2Xg8U2O"
        "yNFJb962UxQ9vxak3SsRGk1Akj7eByTrtzDx4nVc5F+gD93OeGAP2KTh0jkl3wPH5oUGiY9CoN5Xic25k00Xj+Am9YQS+NNg"
        "SrLGcETzu6KcZ4neidniCHUMKyp/wpqX3RWP0CGmTL/sBDvdYbjneHz4fE0bIc5F+eYWDMM2iBbeZ2Nl99SHMo3ggqJXKaDu"
        "+Z5VHcMMmQ0Fh22vKp7cCRIYXZVDz6Fw4NsYbPgFX8XMlzYOQM3/+bIUU5+K/sU9OpKquPd7AvcrMmRNBARrexVzbKg1MR7H"
        "QtG/GPeeBNjS1vDa6SEsbbTegMvrYTN8K7nunWUENZGTkV2AF5YGS+pzIMe6j3vi5jJO6OF4zj0dIy/MTyEhcK2RR3WoGzbP"
        "A/z6Nk97pi0GUHQqrx6vwrIBn/ap0cQUZvwTCJqcuafPQ0wsdjIi3VKAfVpFlNMzDc12Bgx2sdgS9QEAm+knva1/E3V0P0F4"
        "xg2aQh9Th7ihBk94l6LqzwnUajADruIuEdE9pAPplc/il6099IUa+R/wc3QWDtknoUxdhR1zzsdvSS8NQrkADPC5oBA7vabA"
        "tPMFqobBR47reVP1CdiBoo+iTfaV1lvJ8oS7GAeB/8CPmtc54E5PqcFfQBC6nQHJaQ17MjgIOqDWOD9UTcJPyk+gdPoTMBw1"
        "i7EBnAoIcY6GTc1e4Yz4BwKgsaLBia59bPjW57O6q5AM2i2U+DkShPQ7KBP4QzjRNcoamZc12f7LhT9nw1bkXTBQ9SzZzbk8"
        "ScVxB3Y7qoU2XUSjsaeCRO0VHgSfDhRiDIgGn/Gq6egu2AS105oVPqOLnS4CG3QToLRGunBma6FwY4wjglCPuCq0j8Zo8UEK"
        "eHnkM05/mIDIA88cjTiShD8nqV9KaPw0PLJ0iT55tFGcGxvDCVpPhTnGQ3SRuY86Os0hiwo6y8caRyGM0s8EkhP/UcFtLyXl"
        "eC4eRE1s0fUvwv58CRQb30el6ZfGii7DiNkfeXNc2Wwdn04C05eRZml6wY5iLGjsiwUcHmpM5q+4i0hG7xIX9a4f1J0JhdFE"
        "Py+vgwPpHrsKgG5xZ5AWFpHpERFgaSI+M75KCX0sorBSJ9KabRRp4lxGDepTBWIzHilU3Bjwiv5PBHEb/WD9hwvSpxLnS285"
        "ENVVamI3CrvSRxIA/pwHuXfL29MlOFzRU087r6UGlPcFGr4WPnO+o8jcEwJAmfaCIebBBPOTobvSGYnxoxTx7SMx6Xsh0txJ"
        "eljQRRLDGABoiq9XB07rMr4PQe7OKKVIUeqE2dMmgEjfRmCsxwvWVW2kPW70E/TNkUCF+JG5uH2Amp0nQYzGdqFH7KkhrGfL"
        "c6e7chQ1CxfcHV6woMdwTIljLKktvODtbwzZeZQfRS+kp9VEQWVaAA0+7BVZdzSGoaGOgUCfVspoxik7jrGaLXWegA6jNqDK"
        "n+mbP6lXad002BgUf0vh5ZuUFf0bCbZex7T0lgp39AkxbbYKD38fJWLOiOWu+FR3qtppBR5TDliQ7igdYJpozIQeG7TiWbRy"
        "UzF5xCTujo4FgTb3AMnmf2o0oMeGYPkU4shpo2EJjifc+zo4PZebo7efyvxYNcAJ9QCb+Ea6qPrDEz4tQBCxXcRCn7kUVdKf"
        "kyY7mTbQYzR03yVQD3fgTHYJ8pwW4EWLf4DL+Cj07b9b0nA4b5VWoaVqi7nAsu6BHv+LRJ/NQomML5WYbRVOxicLJF3RBqAa"
        "N9CiriSYoToRITeNdELu2UF7/mZLUT8diWkQY39x3lvzQ2AAKbsEsb0nzyvCDUfWLUl7OjjBYESng0sjDBgcQjz+ABnRoQH2"
        "B2hLEF36GLEEhNYaizMqOLyiYgCXGVj5GfMmZNNnjhJIWwQGaAhdDK2hFYAH1GEDxo3uxB6XGyL2BrTJfGEWCrNQJtwy4VbJ"
        "wkclCx+bzBdmoUy4bTLf7CpZ+Hi2ZNHcJvN9YRbKhNsm820yXybc5hdmoS8TbvPZkkVLtizsdJXPnGxZ2Okqn/lsyaLlZMvC"
        "Tlf5zGdLFi27TeabXSULH3OyZWGnq3zmlwm3+WzJomVXycLHfLZk0fILs9CMXKYlWxZ25hdmoTnZsrDTVT6zq2ThY3aVLHzM"
        "L8xCc7JlYaerfGa3yXwzcpmWbFnYmZHLtGTLws6MXKYlWxZ2ZuQyLdmysDO/MAvNZ0sWLb8wC80vE26z22S++WzJomVXycLH"
        "jFymJVsWdma3yXwzcpmWbFnYmZHLtGTLws7sNplvfplwm10lO3TML8xCM3KZlmzZPs78wiw0vzALzS8TbrPbZL75hVloPluy"
        "aNltMt/sKln4mM+WLFp2m8w3u03mm90m883JloWdrvKZX5iFZrfJfDNymZZsWdiZXybcZuQyLdmysDOfLVm0/DLhNrtN5ptd"
        "JQsf88uE25xsWdjpKp/5hVlodpvMNyOXacmWhZ3ZbTLf7DaZb36ZcJtdJQsfc7JlYaerfGa3yXyzq2ThY062LOx0lc+cbFnY"
        "6SqfGblMS7Ys7MwvzEIzcpmWbFnYmZMtCztd5TO/TLjNbpP55hdmoRm5TEu2LOzML8xCs9tkvhm5TEu2LOzMLxNuc7JlYaer"
        "fGbkMi3ZsrAzJ1sWdrrKZ3abzDefLVm07CpZ+JjPlixaPluyaBm5TEu2LOzML8xCM3KZlmxZ2JmTLQs7XeUzvzALzchlWrJl"
        "YWd+YRaaX5iFZrfJfHOyZWGnq3xmV8nCx4xcpiVbFnbmF2ah+WzJouWzJYuWXSULH/PZkkXLZ0sWLbtN5utGruo2h/xnewDB"
        "BJ2vuHkrVb52B7IsbzKAsv+TQF+M9pS6EzEbjxR1tQ3IO/NFZogO54XURpFV5I20Ua/Azp6VSo7mLnHnwolTjr7kxw+NgciK"
        "N+Khtt7go3qeCFmTaDJkTQqM/muG+ARInVYmUYRfCMPbnnKpbC68pj/iI+sOUIGu5ABBFsQlUh8MoqdfQBl1BzcZtIkx46+A"
        "0/hO7Et7cSFtEx5ccQ8cycdAtf0SND8GTju9hCdvX7nJWZnQIWovNSVoJDwsqxJkdRtFyfFUStVHEiLHRJYI9YUadm8l2kMz"
        "MfnpEiLs6Q1FuWnc8uhtUk3aalCfNirxFrchib5VktGHyA031HDHfzFz02EgxIxWRtLYztjU6wQinlmDupmqvnaGGm0ezoW/"
        "PJu6nDx/+4hvjUOxAEyBrqjhNk2p/b8D0QQEIQallFSYDhJoIBgIlExDBDhFCDGEEEKIgBAiKMIjhBCCnFsP0xhtZSDgMnlO"
        "Mr+eZNp2e0gJEc0+Nzwb+pGjm25RUymJrmZmobpqSNEYFNNMInmgIsc4XRmZXhEEn+mBGoEIdhiEqD8R1tKxzaSYSF91SWVi"
        "PKlGwifaVp4mybIEuRD/LLpCXPgZsZab1lHLbMPTqCXLCH8PKRDAf6hkSgk+suaadi0yMaUCsdcgKCjWNELimOGTNi8AC1vJ"
        "vJZrtE0TCvZ4QwypKmm4vs5f5K68GbqphaBvbww1DteQHkBruD2pRcMcoUiWYpBI4OmKpZlCQypcAHttFp5YD0rbJCl1uhch"
        "SPYbqN0AOXouZYhTZphnT4GYShKEVCqCEt6BzLerJiWVsyK6SzS+H8EDniTBjYJptxpBkKN/YPNYUVSrFRQKimUBwdbqGc6t"
        "7uSpCMGJ0xxgC0il4xfpMxAFGkRLx7EbQAcltGMhpgHP80ksMeYHCjcyJA7Ul3JZcTbkBWUCwGq1bZ/aLNFaYzDBmgE1Dow+"
        "zlwFB0rxSgUvGeEiAkaVo8m57TcE68sk3uovtIUiU/EK4MusuEFmt6SnONCtQgUZHHKxGGQ4HnyCGU7jClcozer9CVk7Hnbt"
        "Vu9GMmRNURrxmjYl9bBosrJhBbX21aGbmt6a+KQZG3oKS/NJdXBQKVSw+2XwMD0BJ4kwhSBxa7jO8or+wZe9yB+edH888ZsH"
        "hkYfBWHW8ZPJfQFNI1G/GXjf8RUQaAcCILO1oCYOG4T1ZgxWgRYKEFFDUjaq3V3GwJADgekRKSjP2b/EMB/50wsCJ1CTxc+j"
        "Vkq52QgtYUNKZmxAGMYO8FQ3NwJzXuq6KHy4GaYUWHpvLTKhJBNkGWYCi7imQHqUzUV8KVHYAk5goLxGcS06QtaJASiYqchn"
        "mkXpWCmlKOs1UP4mLZQjo56JLlTCehf11SRi7lwTBHl8XiMWY+6Qz9smqOFkEiGbQURoGAsWEIuZ1PGJIV+h5k8dSI0QBSuY"
        "GAA7ZAXIEHslLYLbmZ25cG3TG6MZNfqAGXm+6OjDvoMgDcxcZoaP4O8a1k/CTpL1Hj5tWACT5k8aSqdbKNQf8nAkHt6dPPGa"
        "weHL2oGk5uUPdJg9RdwkkivOxLcN1F7Zs6Wj6LKZ5cRvkgMpd0InRBQ2VCIM5c08fYZL/TO02cg90GTWBzT2W527eWCdDkHI"
        "JdLMVQ==")),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def log(*args):
    print(*args, flush=True)


def median_ms(fn, reps, warmup=2):
    """Median over ``reps`` launches, each timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def wall_ms(fn):
    """Host-clock milliseconds of ``fn()``, device work included."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"[device] torch.backends.cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
        f"torch.backends.cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32} (PyTorch's "
        f"defaults; every \"f32\" number below ran so unless it says TF32 off)")
    return card


def phase_build():
    """The three CUDA sources and the two host libraries' C++ sources (the
    native reader, the zstd decoder) at once (one nvcc or g++ each), then
    the libraries loaded.  Returns the kernel modules and the seconds the zstd
    decoder's build took."""
    import importlib
    from concurrent.futures import ThreadPoolExecutor

    from umetrack_torch.data import native
    from umetrack_torch.ops import _build
    from umetrack_torch.utils import _zstd

    def timed(build, name):
        t = time.perf_counter()
        return build(name), time.perf_counter() - t

    wp_mod = importlib.import_module("umetrack_torch.ops.warp_pool")
    wi_mod = importlib.import_module("umetrack_torch.ops.warp_image")
    bn_mod = importlib.import_module("umetrack_torch.ops.bn_act")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=5) as pool:
        hosts = [pool.submit(timed, _build.build_host, name) for name in (native.NAME, _zstd.NAME)]
        paths = list(pool.map(lambda name: _build.build(name, verbose=True),
                              (wp_mod.NAME, wi_mod.NAME, bn_mod.NAME)))
        hosts = [h.result() for h in hosts]
    paths += [path for path, _ in hosts]
    wp_mod._library()
    wi_mod._library()
    bn_mod._library()
    native.load_library()
    _zstd.load_library()
    log(f"[build] {', '.join(os.path.relpath(p, HERE) for p in paths)} "
        f"in {time.perf_counter() - t0:.2f} s")
    return wp_mod, wi_mod, hosts[1][1]


def byte_bound(pool, coords, src_idx):
    """(bound_ms, bound_by, text): ``portbench/yardstick.py::pool_warp_bound_s``,
    the benchmark's pool-warp bound (coordinates read once, output written
    once, and the distinct source bytes touched, at the card's memory rate;
    against the sample arithmetic at the card's f32 rate), and its terms."""
    from portbench import yardstick

    bound_ms = yardstick.pool_warp_bound_s(pool, coords, src_idx) * 1e3
    taps = yardstick.touched_source_bytes(pool, coords, src_idx)
    n_pix = coords.numel() // 2
    ops_ms = n_pix * yardstick.OPS_PER_SAMPLE / yardstick.F32_OPS_PER_S * 1e3
    bound_by = "bytes" if bound_ms > ops_ms else "operations"
    text = (f"{bound_by}: coords {coords.numel() * 4 / 1e6:.1f} MB + out {n_pix * 4 / 1e6:.1f} MB "
            f"+ touched taps {taps / 1e6:.1f} MB at {yardstick.HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    return bound_ms, bound_by, text


def grid_sample_ms(images, coords, src_idx=None, reps=5):
    """The time of the nearest PyTorch call, which is NOT the same function
    (NO_LIBRARY): ``grid_sample`` (bilinear, zero padding, align_corners) on
    an f32 copy of the images at the same source pixels, normalised outside
    the timed call; with ``src_idx`` a 5-D sample whose depth coordinate
    picks each warp's pool image, exactly, so each warp reads its own."""
    import torch
    import torch.nn.functional as F

    h, w = images.shape[-2:]
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=coords.device)
    grid = coords * scale - 1.0
    if src_idx is not None:  # [1, 1, M, H, W] sampled at [1, Wn, h, w, 3]
        m = images.shape[0]
        z = (2.0 * src_idx.float() / max(m - 1, 1) - 1.0).view(-1, 1, 1, 1).expand(*grid.shape[:-1], 1)
        src, grid = images.float()[None, None], torch.cat([grid, z], dim=-1)[None]
    elif images.dim() == 2:  # one image, any coordinate list
        src, grid = images.float()[None, None], grid.reshape(1, -1, 1, 2)
    else:  # [N, H, W], coords [N, ..., 2]
        src, grid = images.float()[:, None], grid.reshape(images.shape[0], -1, 1, 2)
    ms = median_ms(lambda: F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                                         align_corners=True), reps=reps, warmup=1)
    del src, grid
    return ms


def edge_cases(device):
    """(pool, coords, src_idx) cases: duplicated sources, out of bounds,
    -1, NaN, inf, W-1 and H-1 exactly, the last valid cell, and shapes that
    are no multiple of the block."""
    import torch

    g = torch.Generator().manual_seed(7)
    cases = []
    for dtype in (torch.uint8, torch.float32):
        pool = (torch.rand((3, 37, 53), generator=g) * 255).to(dtype)
        coords = torch.rand((5, 7, 11, 2), generator=g) * torch.tensor([60.0, 44.0]) - 3.0
        special = torch.tensor([
            [-1.0, -1.0], [float("nan"), 5.0], [5.0, float("nan")], [52.0, 10.0],
            [10.0, 36.0], [51.999, 35.999], [51.5, 35.5], [0.0, 0.0],
            [float("inf"), 3.0], [-0.001, 3.0], [1e9, -1e9],
        ])
        coords[0, 0, : len(special)] = special
        src = torch.tensor([2, 0, 2, 1, 2], dtype=torch.int32)
        cases.append((pool.to(device), coords.to(device), src.to(device)))
    pool = (torch.rand((2, 480, 640), generator=g) * 255).to(torch.uint8)
    coords = torch.rand((3, 97, 95, 2), generator=g) * torch.tensor([660.0, 500.0]) - 10.0
    cases.append((pool.to(device), coords.to(device), torch.tensor([1, 1, 0], dtype=torch.int32, device=device)))
    return cases


BURST = 40  # calls made back to back by ``burst_ms``


def burst_ms(fn, n):
    """Mean over ``n`` calls made back to back between one pair of CUDA
    events: free of the per-call event and host jitter that a median of
    single calls carries."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, reps=20, name="warp_"):
    """Mean device time of the port's own kernels (names holding ``name``)
    over ``reps`` calls of ``fn`` under torch.profiler: the kernel alone,
    whatever the host takes to make a launch (at the smaller shapes a call
    from Python takes as long as the kernel runs, so launches made back to
    back would time the host).  The profiler drops some launches at the
    ends of its window, more of a kernel of microseconds, and late in a
    long run after a profile of tens of thousands of launches (6 of 20
    seen, every time): a window that saw fewer than half is profiled again,
    twice; if it still did, the time is that of ``BURST`` launches back to
    back between CUDA events (an upper bound: host gaps included), and the
    log says so.  The mean is over the launches seen, and a window that
    lost more than two is printed.  ``device_ms.seen`` keeps the count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and name in e.key:
                dev = getattr(e, "self_device_time_total", None)
                total_us += e.self_cuda_time_total if dev is None else dev
                count += e.count
        if count >= reps // 2:
            break
        log(f"[device_ms] the profiler saw {count} of {reps} launches; profiling again")
    device_ms.seen = count
    if count < reps // 2:
        ms = burst_ms(fn, BURST)
        log(f"[device_ms] the profiler kept losing launches: {ms:.4f} ms from CUDA events over "
            f"{BURST} launches back to back instead")
        return ms
    check(count <= reps and total_us > 0, f"the profiler saw {count} kernel launches in {reps} calls")
    if count < reps - 2:
        log(f"[device_ms] the profiler saw {count} of {reps} launches; the mean is over those")
    return total_us / count / 1e3


def stream_floor_ms(coords):
    """(sum_ms, cast_ms): two single PyTorch passes that read the coordinates
    and write an output-sized 4-byte tensor, touching no image: what streaming
    the kernel's two big operands costs on this card.  ``coords.sum(-1)`` is
    a reduction kernel; the cast of each (x, y) pair, viewed as one 8-byte
    integer, to 4 bytes is a plain elementwise pass over the same bytes."""
    import torch

    pairs = coords.view(torch.int64)
    return (burst_ms(lambda: coords.sum(-1), BURST),
            burst_ms(lambda: pairs.to(torch.int32), BURST))


def misaligned_view(coords, offset_floats):
    """A contiguous copy of ``coords`` that starts ``offset_floats`` floats
    past an aligned allocation."""
    import torch

    buf = torch.empty(coords.numel() + offset_floats, dtype=coords.dtype, device=coords.device)
    view = buf[offset_floats:].view(coords.shape)
    view.copy_(coords)
    return view


def phase_kernel(wp_mod, rigs, seqs, hands, card):
    import torch
    from umetrack_torch.ops.resample import bilinear_sample_pool_plain
    from umetrack_torch.tracker import TrackerConfig
    from umetrack_torch.tracker.tracker import pool_warp_operands

    warp_pool = wp_mod.warp_pool

    def run(p, c, s, want_path, label):
        """The kernel against its plain version; the path taken, checked."""
        before = warp_pool.paths[want_path]
        ok = warp_pool(p, c, s)
        pl = bilinear_sample_pool_plain(p, c, s)
        torch.cuda.synchronize()
        check(warp_pool.paths[want_path] == before + 1,
              f"{label}: expected path {want_path}, counts {dict(warp_pool.paths)}")
        check(bool(torch.isfinite(ok).all()), f"{label}: non-finite output")
        e = float((ok - pl).abs().max())
        check(e <= KERNEL_ATOL, f"{label}: kernel vs plain {e}")
        log(f"[kernel] {label}: pool {tuple(p.shape)} {str(p.dtype)[6:]}, crops {tuple(c.shape[:3])}, "
            f"path {want_path}, max_abs_err {e:.3e}, bit for bit {bool(torch.equal(ok, pl))}")
        return e, ok

    pool, coords, src = pool_warp_operands(TrackerConfig(), rigs, seqs, hands)
    err, out_k = run(pool, coords, src, "vector", "bench shape")
    log(f"[kernel] bench shape nonzero samples {float((out_k != 0).float().mean()):.3f}")

    g = torch.Generator().manual_seed(23)
    edge_err = 0.0
    for i, (p, c, s) in enumerate(edge_cases("cuda")):
        # 7 x 11 and 97 x 95 crops: the scalar path
        e, ok = run(p, c, s, "scalar", f"edge case {i}")
        if i < 2:
            invalid = ok[0, 0, [0, 1, 2, 3, 4, 8, 9, 10]]
            check(bool((invalid == 0).all()), f"edge case {i}: invalid samples not 0")
        edge_err = max(edge_err, e)
    # a pool whose row pitch is no multiple of 16 bytes: vector I/O all the same
    odd = (torch.rand((3, 200, 650), generator=g) * 255).to(torch.uint8).cuda()
    odd_coords = (torch.rand((4, 96, 96, 2), generator=g) * torch.tensor([670.0, 220.0]) - 10.0).cuda()
    odd_src = torch.tensor([2, 0, 1, 2], dtype=torch.int32, device="cuda")
    edge_err = max(edge_err, run(odd, odd_coords, odd_src, "vector", "650-wide pool")[0])
    # an f32 pool, crops of 64 x 32
    f32_pool = (torch.rand((2, 100, 164), generator=g) * 255).cuda()
    f32_coords = (torch.rand((3, 64, 32, 2), generator=g) * torch.tensor([170.0, 104.0]) - 3.0).cuda()
    f32_src = torch.tensor([1, 0, 1], dtype=torch.int32, device="cuda")
    edge_err = max(edge_err, run(f32_pool, f32_coords, f32_src, "vector", "164-wide f32 pool")[0])
    # a coordinate view 8 bytes past a 16-byte boundary: the scalar path; 4 bytes past: refused
    shifted = misaligned_view(odd_coords, 2)
    check(shifted.data_ptr() % 16 == 8 and shifted.is_contiguous(), "misaligned view")
    edge_err = max(edge_err, run(odd, shifted, odd_src, "scalar", "coords 8 bytes off")[0])
    refused = False
    try:
        warp_pool(odd, misaligned_view(odd_coords, 1), odd_src)
    except ValueError:
        refused = True
    check(refused, "coords 4 bytes off a boundary were not refused")
    log(f"[kernel] coords 4 bytes off an 8-byte boundary: refused; edge cases max_abs_err {edge_err:.3e}")
    del odd, odd_coords, shifted, f32_pool, f32_coords

    # `ms`: one call of the wrapper, the median of single calls (its checks
    # wait for the card once), as every earlier run of this script timed it;
    # `kernel_ms`: the kernel alone, its device time in the profiler
    ms = median_ms(lambda: warp_pool(pool, coords, src), reps=20)
    kernel_ms = device_ms(lambda: wp_mod._launch(pool, coords, src))
    check_ms = burst_ms(lambda: wp_mod._check(pool, coords, src), BURST)
    plain_ms = median_ms(lambda: bilinear_sample_pool_plain(pool, coords, src), reps=5, warmup=1)
    stream_ms, cast_ms = stream_floor_ms(coords)
    bound_ms, bound_by, text = byte_bound(pool, coords, src)
    log(f"[kernel] warp_pool {ms:.4f} ms a call of the wrapper (median of 20 single calls; its "
        f"checks alone {check_ms:.4f} ms), kernel alone {kernel_ms:.4f} ms (device time, mean of 20 "
        f"launches), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({text}), roofline share "
        f"{bound_ms / ms:.3f} of a call, {bound_ms / kernel_ms:.3f} of the kernel alone [{card}]")
    log(f"[kernel] stream_ms {stream_ms:.4f} (the streaming floor: coords.sum(-1), "
        f"{coords.numel() * 4 / 1e6:.1f} MB in, {coords.numel() * 2 / 1e6:.1f} MB out, no taps; back to back); "
        f"the same bytes as an elementwise cast {cast_ms:.4f} ms [{card}]")
    nearest_ms = grid_sample_ms(pool, coords, src)
    log(f"[kernel] library_ms null: {NO_LIBRARY}; the nearest call, a 5-D grid_sample on an f32 copy "
        f"of the pool (NOT the same function): {nearest_ms:.4f} ms [{card}]")
    kern = dict(max_abs_err=max(err, edge_err), ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, grid_sample_ms=nearest_ms)
    return kern, (pool, coords, src)


# ---- the one-pass eval-mode BatchNorm kernel --------------------------------


def bn_shapes():
    """Every shape and form the one-pass BatchNorm takes in a
    track_sequences_batched call at the bench shape and at the full width of
    ``ModelConfig()`` (the scale head's regressor: a calibration's), read
    off the model's modules: (label, rows, channels, side, forms).  Forms:
    "relu": BN + ReLU, "residual": + the identity, "bn_residual": + the BN'd
    downsample branch, "bias": the conv bias first (the fusion),
    "bias_pool": the conv bias first and the max-pool after (the stem)."""
    from umetrack_torch.models import ModelConfig
    from umetrack_torch.models.umetrack import UmeTrackNet

    cfg = ModelConfig()
    net = UmeTrackNet(cfg)
    side = cfg.input_size[0] // 2
    shapes = [("stem", BN_CROPS, net.backbone.stem_bn.num_features, cfg.input_size[0], ("bias_pool",))]
    for i, (planes, stride) in enumerate(zip(cfg.stage_out_planes, cfg.backbone_strides)):
        side //= stride
        first = getattr(net.backbone, net.backbone.blocks[sum(cfg.backbone_blocks[:i])])
        forms = ("relu", "residual") + (("bn_residual",) if first.use_downsample else ())
        shapes.append((f"stage{i}", BN_CROPS, planes, side, forms))
    side = cfg.feature_map_size[0]
    for i in range(cfg.n_fusion_blocks):
        bn = getattr(net.fusion, f"bn{i}")
        shapes.append((f"fusion.bn{i}", BN_ROWS, bn.num_features, side, ("bias",)))
    shapes.append(("skeleton_encoder", BN_SKELETONS, net.skeleton_encoder.bn.num_features, side, ("relu",)))
    for head in ("regressor_k", "regressor_u"):
        block = getattr(net, head).block0
        shapes.append((head, BN_ROWS, block.bn1.num_features, side, ("relu", "residual")))
    return shapes


def bn_sites(known=0, scale=0):
    """``batch_norm_act``'s launches in ``known`` forwards of the known-
    skeleton model and ``scale`` of the scale head at the full width of
    ``ModelConfig()``: each extracts features (the stem, two per backbone
    BasicBlock, one per fusion block) and runs a regressor (two per
    BasicBlock); the known head also encodes the skeleton (one).  32 and 31."""
    from umetrack_torch.models import ModelConfig

    cfg = ModelConfig()
    head = 1 + 2 * sum(cfg.backbone_blocks) + cfg.n_fusion_blocks + 2 * cfg.n_regression_blocks
    return known * (head + 1) + scale * head


def bn_norm(c, seed):
    """An eval-mode ``BatchNorm`` on the card with random statistics and an
    affine of both signs."""
    import torch
    from umetrack_torch.models.backbone import BatchNorm

    g = torch.Generator().manual_seed(seed)
    norm = BatchNorm(c).eval()
    with torch.no_grad():
        norm.running_mean.copy_(torch.randn(c, generator=g) * 0.3)
        norm.running_var.copy_(0.5 + torch.rand(c, generator=g) * 1.5)
        norm.weight.copy_(torch.randn(c, generator=g))
        norm.bias.copy_(torch.randn(c, generator=g) * 0.3)
    return norm.cuda()


def bn_operands(form, n, c, h, w, dtype, seed, fmt="nchw"):
    """``batch_norm_act``'s keyword arguments for ``form`` on random data,
    x and the residual in the layout ``fmt`` ("nchw" or "channels_last")."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, c, h, w), generator=g, device="cuda").to(dtype)
    kw = dict(x=x, norm=bn_norm(c, seed))
    if form in ("bias", "bias_pool"):
        kw.update(conv_bias=torch.randn(c, generator=g, device="cuda") * 0.3, pool=form == "bias_pool")
    elif form in ("residual", "bn_residual"):
        kw["residual"] = torch.randn((n, c, h, w), generator=g, device="cuda").to(dtype)
        if form == "bn_residual":
            kw["residual_norm"] = bn_norm(c, seed + 1)
    if fmt == "channels_last":
        for name in ("x", "residual"):
            if name in kw:
                kw[name] = kw[name].contiguous(memory_format=torch.channels_last)
    return kw


def bn_bytes(kw, out):
    """The least bytes the pass moves: each operand read once, the result
    written once, the per-channel constants read once."""
    operands = [kw["x"], kw.get("residual"), kw.get("conv_bias"), out]
    for norm in (kw["norm"], kw.get("residual_norm")):
        if norm is not None:
            operands += [norm.running_mean, norm.running_var, norm.weight, norm.bias]
    return sum(t.numel() * t.element_size() for t in operands if t is not None)


def bn_compare(bn_mod, kw, label, want_path):
    """The kernel against the plain version on ``kw``: the path taken
    (``vector/nchw``, ``scalar/channels_last``, ...), the output in x's
    layout, NaN where the plain version has NaN, and the max abs error over
    the output's largest magnitude within BN_TOL; returns (kernel's output,
    max abs error)."""
    import torch

    wrapper = bn_mod.batch_norm_act
    before = wrapper.paths[want_path]
    got = wrapper(**kw)
    want = bn_mod.batch_norm_act_plain(**kw)
    torch.cuda.synchronize()
    check(wrapper.paths[want_path] == before + 1,
          f"[bn_act] {label}: expected path {want_path}, counts {dict(wrapper.paths)}")
    check(got.shape == want.shape and got.dtype == want.dtype, f"[bn_act] {label}: shape or dtype")
    check(bn_mod.layout(got) == bn_mod.layout(kw["x"]),
          f"[bn_act] {label}: output {bn_mod.layout(got)}, x {bn_mod.layout(kw['x'])}")
    nan = torch.isnan(want)
    check(bool((torch.isnan(got) == nan).all()), f"[bn_act] {label}: NaN where the plain version has none")
    g, p = got.float()[~nan], want.float()[~nan]
    check(bool((torch.isinf(g) == torch.isinf(p)).all() & (g[torch.isinf(p)] == p[torch.isinf(p)]).all()),
          f"[bn_act] {label}: inf where the plain version has none")
    finite = torch.isfinite(p)
    err = float((g[finite] - p[finite]).abs().max()) if bool(finite.any()) else 0.0
    scale = max(1.0, float(p[finite].abs().max())) if bool(finite.any()) else 1.0
    tol = BN_TOL[str(kw["x"].dtype)[6:]]
    check(err / scale <= tol, f"[bn_act] {label}: max abs error {err:.3e} over {scale:.3g} above {tol:.3e}")
    same = float((got == want).float().mean()) if got.numel() else 1.0
    log(f"[bn_act] {label}: path {want_path}, max_abs_err {err:.3e} (output scale {scale:.3g}, "
        f"tolerance {tol:.2e} of it), {same:.4f} of the outputs bit for bit")
    return got, err


def bn_edge_cases(bn_mod):
    """Small shapes that take the scalar path, vectors that cross planes,
    channel slices, a misaligned residual, NaN and inf, in NCHW and in
    channels-last; returns the max abs error over them."""
    import torch

    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        v = 16 // torch.empty((), dtype=dtype).element_size()
        dt = str(dtype)[6:]
        cases = [
            # (label, form, n, c, h, w, NCHW path, channels-last path)
            ("odd pool 7 x 10", "bias_pool", 5, 3, 7, 10, "vector" if 10 % (2 * v) == 0 else "scalar",
             "scalar"),
            ("pool 6 x 16", "bias_pool", 5, 3, 6, 16, "vector", "scalar"),
            ("pool 7 x 9, 16 channels", "bias_pool", 3, 16, 7, 9, "scalar", "vector"),
            ("planes of 1 x 1", "relu", 7, 20, 1, 1, "vector" if 20 % v == 0 else "scalar", None),
            ("planes of 2 x 2", "residual", 7, 16, 2, 2, "vector", "vector"),
            ("3 planes of 6 x 6", "bn_residual", 9, 3, 6, 6, "vector" if 108 % v == 0 else "scalar",
             "scalar"),
            ("conv bias, 3 planes of 6 x 6", "bias", 9, 3, 6, 6, "vector" if 108 % v == 0 else "scalar",
             "scalar"),
            ("conv bias, planes of 5 x 7", "bias", 4, 6, 5, 7, "scalar", "scalar"),
            ("conv bias, planes of 2 x 2", "bias", 5, 16, 2, 2, "vector", "vector"),
            ("12 channels, planes of 5 x 7", "bn_residual", 4, 12, 5, 7,
             "vector" if 420 % v == 0 else "scalar", "vector" if 12 % v == 0 else "scalar"),
        ]
        for label, form, n, c, h, w, path, cl_path in cases:
            kw = bn_operands(form, n, c, h, w, dtype, len(label))
            err = max(err, bn_compare(bn_mod, kw, f"{label} {dt}", f"{path}/nchw")[1])
            if cl_path is not None:  # planes of one pixel are NCHW both ways
                kw = bn_operands(form, n, c, h, w, dtype, len(label), fmt="channels_last")
                err = max(err, bn_compare(bn_mod, kw, f"{label} {dt} channels-last",
                                          f"{cl_path}/channels_last")[1])
        for fmt in ("nchw", "channels_last"):
            mf = torch.channels_last if fmt == "channels_last" else torch.contiguous_format
            # a residual that is a slice of channels (the scale head's input), aligned
            kw = bn_operands("residual", 6, 16, 6, 6, dtype, 3, fmt=fmt)
            big = torch.randn((6, 40, 6, 6), device="cuda").to(dtype).contiguous(memory_format=mf)
            kw["residual"] = big[:, 8:24]
            check(not kw["residual"].is_contiguous(memory_format=mf), "a channel slice")
            err = max(err, bn_compare(bn_mod, kw, f"channel-slice residual {dt} {fmt}", f"vector/{fmt}")[1])
            if fmt == "channels_last":  # x a slice of channels, its pixels one element past a vector
                kw = bn_operands("relu", 6, 16, 6, 6, dtype, 4, fmt=fmt)
                kw["x"] = big[:, 9:25]
                err = max(err, bn_compare(bn_mod, kw, f"channel-slice x {dt} {fmt}", f"scalar/{fmt}")[1])
            # a residual one element past a 16-byte boundary
            kw = bn_operands("residual", 6, 16, 6, 6, dtype, 3, fmt=fmt)
            buf = torch.empty(kw["x"].numel() + 1, dtype=dtype, device="cuda")
            shifted = buf[1:].view(kw["x"].shape) if fmt == "nchw" else (
                buf[1:].view(6, 6, 6, 16).permute(0, 3, 1, 2))
            shifted.copy_(kw["x"] * 0.5)
            kw["residual"] = shifted
            err = max(err, bn_compare(bn_mod, kw, f"misaligned residual {dt} {fmt}", f"scalar/{fmt}")[1])
            # NaN and inf in, through BN + ReLU and through the pool
            for form in ("relu", "bias_pool"):
                kw = bn_operands(form, 4, 8, 6, 8 * v // 4, dtype, 11, fmt=fmt)
                # x's elements in memory order (a view of x in either layout)
                flat = (kw["x"].permute(0, 2, 3, 1) if fmt == "channels_last" else kw["x"]).view(-1)
                flat[[0, 5, 17, 40]] = torch.tensor([float("nan"), float("inf"), -float("inf"), float("nan")],
                                                    dtype=dtype, device="cuda")
                err = max(err, bn_compare(bn_mod, kw, f"NaN and inf, {form} {dt} {fmt}", f"vector/{fmt}")[1])
    return err


def phase_bn_act(card):
    """``[bn_act]``: the kernel against its plain version at every shape and
    form of the bench's tracker call (:func:`bn_shapes`) in f32 and bf16, in
    NCHW and in channels-last, then the edge cases;
    times, byte bounds and shares, under ``inference_mode`` as the model
    runs it.  Returns the rows of the kernel table and the edge cases' max
    abs error."""
    import torch
    import torch.nn.functional as F
    from umetrack_torch.ops import bn_act as bn_mod

    wrapper = bn_mod.batch_norm_act
    launches0 = wrapper.launches
    rows = []
    with torch.inference_mode():
        for fmt in ("nchw", "channels_last"):
            for dtype in (torch.float32, torch.bfloat16):
                for label, n, c, side, forms in bn_shapes():
                    for form in forms:
                        rows.append(bn_row(bn_mod, form, label, n, c, side, dtype, len(rows) + 1, card, fmt))
        edge_err = bn_edge_cases(bn_mod)
        log(f"[bn_act] edge cases max_abs_err {edge_err:.3e}; {wrapper.launches - launches0} launches "
            f"in the phase, by path {dict(wrapper.paths)}")
        # the form's pieces one by one, for context: what the unfused model ran
        kw = bn_operands("residual", BN_CROPS, 32, 48, 48, torch.float32, 99)
        x, norm, r = kw["x"], kw["norm"], kw["residual"]
        pieces = {"batch_norm": lambda: norm(x), "add": lambda: x + r, "relu": lambda: F.relu(x),
                  "max_pool2d": lambda: F.max_pool2d(x, 2, 2)}
        log("[bn_act] stage0 f32, one unfused op each (median of 5): " + ", ".join(
            f"{op} {median_ms(fn, reps=5, warmup=1):.4f} ms" for op, fn in pieces.items()) + f" [{card}]")
    del kw, x, norm, r, pieces
    torch.cuda.empty_cache()
    return rows, edge_err


def bn_row(bn_mod, form, label, n, c, side, dtype, seed, card, fmt="nchw"):
    """One shape of :func:`phase_bn_act` in the layout ``fmt``: checked, then
    timed.  Channels-last takes 16-byte vectors where they split the
    channels."""
    import torch
    from portbench import yardstick

    wrapper = bn_mod.batch_norm_act
    kw = bn_operands(form, n, c, side, side, dtype, seed, fmt=fmt)
    name = f"{label} {c} x {side} x {side} {form} {str(dtype)[6:]} {fmt}"
    vector = fmt == "nchw" or c % (16 // kw["x"].element_size()) == 0
    out, err = bn_compare(bn_mod, kw, name, f"{'vector' if vector else 'scalar'}/{fmt}")
    args = (kw["x"], kw["norm"], kw.get("conv_bias"), kw.get("residual"),
            kw.get("residual_norm"), kw.get("pool", False))
    ms = median_ms(lambda: wrapper(**kw), reps=20)
    kernel_ms = device_ms(lambda: bn_mod._launch(*args), name="batch_norm_act")
    plain_ms = median_ms(lambda: bn_mod.batch_norm_act_plain(**kw), reps=5, warmup=1)
    moved = bn_bytes(kw, out)
    bound_ms = moved / yardstick.HBM_BYTES_PER_S * 1e3
    log(f"[bn_act] {name}: N={n}, {ms:.4f} ms a call of the wrapper (median of 20), "
        f"kernel alone {kernel_ms:.4f} ms (device time, the profiler saw {device_ms.seen} "
        f"of 20), plain {plain_ms:.4f} ms (the unfused PyTorch sequence, library_ms), "
        f"bound {bound_ms:.4f} ms (bytes: {moved / 1e6:.1f} MB at "
        f"{yardstick.HBM_BYTES_PER_S / 1e12:.2f} TB/s), share "
        f"{bound_ms / kernel_ms:.3f} of the kernel alone, {bound_ms / ms:.3f} of a call [{card}]")
    del kw, out, args
    torch.cuda.empty_cache()
    return dict(shape=f"{name}, N={n}", layout=fmt, max_abs_err=err, ms=ms, kernel_ms=kernel_ms,
                plain_ms=plain_ms, library_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                share=bound_ms / kernel_ms)


# ---- the two single-image kernels ------------------------------------------


def block_stats(wi_mod, images, coords):
    """How the windowed kernel's blocks fall: (blocks, blocks with no valid
    sample, blocks whose box fits the window), reckoned from the coordinates
    the way the kernel does: its tile for this field, the box of each tile's
    valid floor cells, the cp.async window with its 16-byte column start."""
    import torch
    from umetrack_torch.ops.resample import _sample_prep

    h, w = images.shape[-2:]
    n = images.shape[0] if images.dim() == 3 else 1
    ch, cw = wi_mod._crop_shape(images, coords)
    plan = windowed_plan(wi_mod, images, coords)
    tile = plan.tiling
    valid, x0, y0, _, _ = _sample_prep(h, w, coords.reshape(n, ch, cw, 2))
    pad = (0, -cw % tile.tile_w, 0, -ch % tile.tile_h)
    big = torch.iinfo(torch.int64).max

    def blocks(a, fill):  # [n, ch, cw] -> [n, tiles, pixels of a tile]
        a = torch.nn.functional.pad(a, pad, value=fill)
        a = a.reshape(n, a.shape[1] // tile.tile_h, tile.tile_h, a.shape[2] // tile.tile_w, tile.tile_w)
        return a.permute(0, 1, 3, 2, 4).reshape(n, -1, tile.tile_h * tile.tile_w)

    v = blocks(valid, False)
    lo = lambda a: torch.where(v, blocks(a, 0), big).amin(dim=-1)
    hi = lambda a: torch.where(v, blocks(a, 0), -big).amax(dim=-1)
    any_valid = v.any(dim=-1)
    chunk = 16 // images.element_size()
    cols = (hi(x0) + 1 - lo(x0) // chunk * chunk) // chunk * chunk + chunk
    fits = any_valid & (cols <= wi_mod.WIN_COLS) & (hi(y0) - lo(y0) + 2 <= wi_mod.WIN_ROWS)
    fits &= plan.staged  # images that cannot be staged: every block reads in place
    return v.shape[0] * v.shape[1], int((~any_valid).sum()), int(fits.sum())


def windowed_plan(wi_mod, images, coords):
    """The launch the windowed wrapper's rules give these operands (the
    output of a launch is a fresh allocation, aligned)."""
    from umetrack_torch.ops import _tiles

    return _tiles.plan(
        images.shape[-1], images.element_size(), images.data_ptr(),
        wi_mod._crop_shape(images, coords), coords.data_ptr(), 0, staged=True)


def windowed_path(wi_mod, images, coords):
    return windowed_plan(wi_mod, images, coords).path


def compare_image_kernels(wi_mod, images, coords, label):
    """Both kernels against the plain version within KERNEL_ATOL, windowed
    == full bit for bit, launch counters and the windowed kernel's path as
    the dispatch rules say.  Returns the max abs error."""
    import torch
    from umetrack_torch.ops import _tiles
    from umetrack_torch.ops.resample import bilinear_sample_plain

    full_fn, win_fn = wi_mod.warp_image_full, wi_mod.warp_image_windowed
    h, w = images.shape[-2:]
    small = _tiles.small_image(h, w)
    check(small == (h < wi_mod.WIN_ROWS or w < wi_mod.WIN_COLS), f"{label}: small-image rule")
    want = "full kernel" if small else windowed_path(wi_mod, images, coords)
    before = (full_fn.launches, win_fn.launches, win_fn.paths[want])
    full = full_fn(images, coords)
    win = win_fn(images, coords)
    plain = bilinear_sample_plain(images, coords)
    torch.cuda.synchronize()
    got = (full_fn.launches - before[0], win_fn.launches - before[1])
    check(got == ((2, 0) if small else (1, 1)),
          f"{label}: launches (full, windowed) {got} for a {h} x {w} image")
    check(small or win_fn.paths[want] == before[2] + 1,
          f"{label}: expected path {want}, counts {dict(win_fn.paths)}")
    check(full.shape == coords.shape[:-1], f"{label}: output shape {tuple(full.shape)}")
    check(bool(torch.isfinite(full).all()), f"{label}: non-finite output")
    err = float((full - plain).abs().max())
    check(err <= KERNEL_ATOL, f"{label}: full kernel vs plain {err}")
    check(bool(torch.equal(win, full)), f"{label}: windowed != full bit for bit")
    n_blocks, n_empty, n_fit = block_stats(wi_mod, images, coords)
    log(f"[image-kernels] {label}: images {tuple(images.shape)} {str(images.dtype)[6:]}, "
        f"coords {tuple(coords.shape)}, max_abs_err {err:.3e}, windowed == full, windowed path {want}, "
        f"blocks {n_blocks} (empty {n_empty}, fit {n_fit}, direct {n_blocks - n_empty - n_fit}), "
        f"nonzero {float((plain != 0).float().mean()):.3f}, launches full+{got[0]} windowed+{got[1]}")
    return err, (n_blocks, n_empty, n_fit)


def time_image_kernels(wi_mod, images, coords, label, card, plain_reps=5):
    """Both kernels' times at one shape (`ms`: one call of the wrapper, the
    median of single calls, as every earlier run of this script timed it;
    `kernel_ms`: the kernel alone, its device time in the profiler), the
    plain version's time and the byte bound."""
    import torch
    from umetrack_torch.ops import _tiles
    from umetrack_torch.ops.resample import bilinear_sample_plain

    n = images.shape[0]
    bound_ms, bound_by, text = byte_bound(
        images, coords, torch.arange(n, dtype=torch.int32, device=images.device))
    plain_ms = median_ms(lambda: bilinear_sample_plain(images, coords), reps=plain_reps, warmup=1)
    nearest_ms = grid_sample_ms(images, coords, reps=plain_reps)
    pixels = coords.numel() // 2 // n
    full_alone = lambda: wi_mod._launch_full(images, coords, n, pixels)
    small = _tiles.small_image(*images.shape[-2:])  # the windowed wrapper runs the full kernel
    alone = {
        "warp_image_full": full_alone,
        "warp_image_windowed": full_alone if small else lambda: wi_mod._launch_windowed(images, coords, n),
    }
    out = {}
    for name, launch in alone.items():
        fn = getattr(wi_mod, name)
        ms = median_ms(lambda: fn(images, coords), reps=20)
        kernel_ms = device_ms(launch)
        out[name] = dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         grid_sample_ms=nearest_ms)
        log(f"[image-kernels] {label}: {name} {ms:.4f} ms a call of the wrapper (median of 20 single "
            f"calls), kernel alone {kernel_ms:.4f} ms (device time, mean of 20 launches), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({text}), roofline share "
            f"{bound_ms / ms:.3f} of a call, {bound_ms / kernel_ms:.3f} of the kernel alone; grid_sample on "
            f"an f32 copy (not the same function) {nearest_ms:.4f} ms [{card}]")
    return out


def time_forms(wi_mod, images, coords, label, card, rounds=3):
    """The tiled kernel's two forms on the same data, through the wrapper's
    own rules: the images as given (staged, 32 x 32 tile) and a copy that
    starts 8 bytes off a 16-byte boundary, which cannot be staged (every tap
    in place, 16 x 32 tile); the full kernel beside them.  Equal bit for
    bit; device time in interleaved rounds of 20 launches each."""
    import torch

    n = images.shape[0]
    shifted = misaligned_view(images, 8 // images.element_size())
    paths = windowed_path(wi_mod, images, coords), windowed_path(wi_mod, shifted, coords)
    check(paths == ("vector+cp_async", "vector"), f"{label}: paths of the two forms {paths}")
    reference = wi_mod._launch_windowed(images, coords, n)
    check(bool(torch.equal(wi_mod._launch_windowed(shifted, coords, n), reference)),
          f"{label}: unstaged form != staged form")
    del reference
    pixels = coords.numel() // 2 // n
    runs = {
        "staged (vector+cp_async, tile 32 x 32)": lambda: wi_mod._launch_windowed(images, coords, n),
        "taps in place (vector, tile 16 x 32)": lambda: wi_mod._launch_windowed(shifted, coords, n),
        "warp_image_full": lambda: wi_mod._launch_full(images, coords, n, pixels),
    }
    times = {name: [] for name in runs}
    for _ in range(rounds):
        for name, fn in runs.items():
            times[name].append(device_ms(fn))
    for name, ms in times.items():
        log(f"[forms] {label}: {name}: min {min(ms):.4f} ms, rounds "
            f"{' '.join(f'{m:.4f}' for m in ms)} [{card}]")


def torchdata_batch(n_seqs, t, h, w, seed0=0):
    """Parsed host sequences of the synthetic torch_data kind, the hand
    rendered on the card (as the corpora of phases 6 and 9 are)."""
    from umetrack_torch.data.transform import parse_raw_buffers
    from umetrack_torch.utils.synthetic import make_torchdata_sample

    return [
        parse_raw_buffers(*make_torchdata_sample(
            rng_seed=seed0 + i, t=t, v=TD_V, h=h, w=w, hand_idx=i % 2, render=True, device="cuda"))
        for i in range(n_seqs)
    ]


def torchdata_warp_operands(raws, device="cuda"):
    """(images [B*T*V, H, W] uint8, coords [B*T*V, 96, 96, 2]) as
    ``preprocess_sequence`` hands them to the sampler."""
    from umetrack_torch.data import bundles
    from umetrack_torch.data.transform import crop_homographies
    from umetrack_torch.ops.resample import homography_coords

    raw = bundles.to_device(bundles.collate(raws), device)
    _, _, xf = crop_homographies(raw)
    images = raw.images.reshape(-1, *raw.images.shape[-2:])
    return images, homography_coords(xf.reshape(-1, 4, 4), (96, 96))


def phase_image_kernels(wi_mod, wp_mod, pool_operands, card):
    import torch

    g = torch.Generator().manual_seed(11)
    errs = []
    run = lambda *a: errs.append(compare_image_kernels(wi_mod, *a)[0])

    # (a) the torch_data shape, coordinates from the preprocess geometry
    images, coords = torchdata_warp_operands(torchdata_batch(TD_BATCH, TD_T, TD_H, TD_W))
    check(images.shape == (TD_BATCH * TD_T * TD_V, TD_H, TD_W) and images.dtype == torch.uint8,
          f"torch_data images {tuple(images.shape)} {images.dtype}")
    run(images, coords, "torch_data uint8")
    images_f = images.to(torch.float32) + 0.25  # fractional content: f32 is sampled exactly
    run(images_f, coords, "torch_data f32")
    times = time_image_kernels(wi_mod, images, coords, "torch_data uint8", card)
    time_image_kernels(wi_mod, images_f, coords, "torch_data f32", card)

    time_forms(wi_mod, images, coords, "torch_data uint8", card)
    del images_f

    # (c) 120 x 160 frames: smaller than the window, the full kernel both
    # ways; the shape at which the main path runs the full kernel.  The
    # tiled kernel forced onto them, beside the full kernel the rule picks.
    small, small_coords = torchdata_warp_operands(torchdata_batch(TD_BATCH, TD_T, 120, 160, seed0=40))
    run(small, small_coords, "120 x 160 uint8")
    run(small.to(torch.float32), small_coords, "120 x 160 f32")
    times["warp_image_full"] = time_image_kernels(
        wi_mod, small, small_coords, "120 x 160 uint8", card)["warp_image_full"]
    forced = wi_mod._launch_windowed(small, small_coords, small.shape[0])
    check(bool(torch.equal(forced, wi_mod.warp_image_full(small, small_coords))),
          "120 x 160: the tiled kernel != the full kernel")
    forced_ms = device_ms(lambda: wi_mod._launch_windowed(small, small_coords, small.shape[0]))
    log(f"[image-kernels] 120 x 160 uint8: the tiled kernel ({windowed_path(wi_mod, small, small_coords)}) forced past the "
        f"small-image rule {forced_ms:.4f} ms, the full kernel "
        f"{times['warp_image_full']['kernel_ms']:.4f} ms [{card}]")
    del forced, small, small_coords

    # (d) one image, a flat list that fills no block
    flat = (torch.rand((1001, 2), generator=g) * torch.tensor([700.0, 540.0]) - 30.0).cuda()
    run(images[3], flat, "flat list [1001, 2]")

    # (e) the pool kernel's edge cases, per image
    for i, (p, c, s) in enumerate(edge_cases("cuda")):
        per_slot = p.index_select(0, s.to(torch.int64))
        run(per_slot, c, f"edge case {i}")
        if i < 2:
            out = wi_mod.warp_image_windowed(per_slot, c)
            check(bool((out[0, 0, [0, 1, 2, 3, 4, 8, 9, 10]] == 0).all()),
                  f"edge case {i}: invalid samples not 0")

    # (g) images whose row pitch is no multiple of 16 bytes (vector I/O, taps
    # in place), f32 images that can be staged, and coordinate views 8 bytes
    # past a 16-byte boundary (the scalar path) or 4 bytes past (refused)
    odd = (torch.rand((4, 200, 650), generator=g) * 255).to(torch.uint8).cuda()
    odd_coords = (torch.rand((4, 96, 96, 2), generator=g) * torch.tensor([670.0, 220.0]) - 10.0).cuda()
    check(windowed_path(wi_mod, odd, odd_coords) == "vector", "650-wide images: path rule")
    run(odd, odd_coords, "650-wide uint8")
    wide = (torch.rand((3, 150, 164), generator=g) * 255).cuda()
    wide_coords = (torch.rand((3, 64, 32, 2), generator=g) * torch.tensor([60.0, 50.0])
                   + torch.tensor([40.0, 30.0])).cuda()
    check(windowed_path(wi_mod, wide, wide_coords) == "vector+cp_async", "164-wide f32: path rule")
    run(wide, wide_coords, "164-wide f32")
    shifted = misaligned_view(coords[:4], 2)
    check(windowed_path(wi_mod, images[:4], shifted).startswith("scalar"), "shifted coords: path rule")
    run(images[:4], shifted, "coords 8 bytes off")
    for fn in (wi_mod.warp_image_full, wi_mod.warp_image_windowed):
        refused = False
        try:
            fn(images[:4], misaligned_view(coords[:4], 1))
        except ValueError:
            refused = True
        check(refused, f"{fn.__name__}: coords 4 bytes off a boundary were not refused")
    log("[image-kernels] coords 4 bytes off an 8-byte boundary: refused by both wrappers")
    del odd, odd_coords, wide, wide_coords, shifted

    # (f) blocks that cannot fit, blocks with no valid sample, and a mix
    sub = images[:8]
    scattered = (torch.rand((8, 96, 96, 2), generator=g) * torch.tensor([660.0, 500.0]) - 10.0).cuda()
    _, (nb, ne, nf) = compare_image_kernels(wi_mod, sub, scattered, "scattered")
    check(nf == 0 and ne == 0, f"scattered: {nf} blocks fit, {ne} empty")
    empty = coords[:8].clone()
    empty[0] = -1.0
    empty[1] = float("nan")
    empty[2, :48] = 1e9
    empty[3, 10:40] = float("-inf")
    _, (nb, ne, nf) = compare_image_kernels(wi_mod, sub, empty, "empty blocks")
    check(ne > 0 and nf > 0, f"empty blocks: {ne} empty, {nf} fit")
    mix = coords[:8].clone()
    mix[0, :32] = scattered[0, :32]  # these blocks take the direct path
    mix[1, 40:] = -1.0  # these stage nothing
    holes = torch.rand((8, 96, 96), generator=g).cuda() < 0.1
    mix[..., 0] = torch.where(holes, torch.full_like(mix[..., 0], float("nan")), mix[..., 0])
    mix[2, ::7, ::5] = -1.0
    _, (nb, ne, nf) = compare_image_kernels(wi_mod, sub, mix, "mixed blocks")
    check(ne > 0 and nf > 0 and nb - ne - nf > 0, f"mixed: {nb} blocks, {ne} empty, {nf} fit")
    del images, coords, sub

    # (b) the tracker's bench shape expressed per image: every slot samples
    # its own copy of its source view; also held against the pool kernel
    pool, pcoords, src = pool_operands
    per_slot = pool.index_select(0, src.to(torch.int64))
    run(per_slot, pcoords, "tracker bench per image")
    win_out = wi_mod.warp_image_windowed(per_slot, pcoords)
    check(bool(torch.equal(win_out, wp_mod.warp_pool(pool, pcoords, src))),
          "pool kernel != windowed kernel per slot bit for bit")
    check(bool(torch.equal(win_out, wi_mod.warp_image_full(per_slot, pcoords))),
          "pool kernel != full kernel per slot bit for bit")
    log("[image-kernels] tracker bench per image: pool kernel == windowed == full per slot, bit for bit")
    time_image_kernels(wi_mod, per_slot, pcoords, "tracker bench per image", card, plain_reps=3)
    del win_out
    time_forms(wi_mod, per_slot, pcoords, "tracker bench per image", card)
    log(f"[image-kernels] library_ms null: {NO_LIBRARY}")
    for v in times.values():
        v["max_abs_err"] = max(errs)
    return times


# ---- the tracker slice ------------------------------------------------------


def phase_slice(wp_mod, model, rigs, seqs, hands, card):
    import torch
    from umetrack_torch.tracker import HandTracker, TrackerConfig
    from umetrack_torch.tracker.tracker import pool_warp_operands

    from umetrack_torch.ops.bn_act import batch_norm_act

    tracker = HandTracker(model, TrackerConfig(), device="cuda")
    s, t = seqs.gt_confidences.shape[:2]
    wp_mod.warp_pool.launches = 0
    times, bn_calls = [], []
    for _ in range(1 + TRACK_CALLS):  # the first call warms cuDNN up
        before, bn_before = wp_mod.warp_pool.launches, batch_norm_act.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, state = tracker.track_sequences_batched(rigs, seqs, hands)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(wp_mod.warp_pool.launches == before + 1,
              f"warp_pool launches per call: {wp_mod.warp_pool.launches - before}")
        bn_calls.append(batch_norm_act.launches - bn_before)
    check(bn_calls == [bn_sites(known=1)] * len(bn_calls),
          f"batch_norm_act launches per call: {bn_calls}, expected {bn_sites(known=1)} each")
    log(f"[slice] batch_norm_act launches per track_sequences_batched call (eager, then replays): "
        f"{bn_calls}, the model's sites")
    n_launches = wp_mod.warp_pool.launches
    check(res.joint_angles.shape == (t, s, 2, 22), f"angles shape {tuple(res.joint_angles.shape)}")
    check(res.wrist_xfs.shape == (t, s, 2, 4, 4), f"wrist shape {tuple(res.wrist_xfs.shape)}")
    check(bool(torch.isfinite(res.joint_angles).all() & torch.isfinite(res.wrist_xfs).all()),
          "non-finite tracker output")
    check(bool(torch.isfinite(state.temporal.mem_features).all()), "non-finite memory")
    n_valid = int(res.valid.sum())
    check(0 < n_valid, "no valid hands")
    med = sorted(times[1:])[len(times[1:]) // 2]

    geom, _ = wall_ms(lambda: pool_warp_operands(TrackerConfig(), rigs, seqs, hands))
    log(f"[slice] track_sequences_batched S={s} T={t} full ModelConfig() f32 (cuDNN TF32 "
        f"{'on' if torch.backends.cudnn.allow_tf32 else 'off'}): "
        f"{med * 1e3:.1f} ms/call median of {TRACK_CALLS} (first call {times[0] * 1e3:.1f} ms), "
        f"{s * t / med:.1f} frames/s, crop geometry alone {geom:.1f} ms, "
        f"valid hands {n_valid}/{res.valid.numel()}, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    return n_launches, sum(bn_calls)


def profile_call(fn):
    """One call of ``fn`` traced by ``portbench/trace.py::device_trace``, as
    the benchmark traces a run: the traced window's wall ms, device ms (the
    operations' time; one stream, so they do not overlap), device launches
    and the rows (device us, count, name) by operation, largest first."""
    from portbench.trace import Spans, device_trace

    trace = device_trace(fn, Spans())
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for name, start, end in trace.ops:
        by_name[name][0] += (end - start) * 1e6
        by_name[name][1] += 1
    rows = sorted(((us, count, name) for name, (us, count) in by_name.items()), reverse=True)
    total = sum(r[0] for r in rows)
    check(total > 0, "the profiler saw no device time")
    return dict(wall_ms=trace.window_s * 1e3, device_ms=total / 1e3, launches=len(trace.ops), rows=rows)


def phase_profile(fn, label, kernel_name, card, top=15):
    """One warmed-up call of ``fn`` under torch.profiler (:func:`profile_call`):
    device time by kernel, the share of the kernels named ``kernel_name``
    (if given), and the device's busy share of the call's wall time."""
    prof = profile_call(fn)
    rows, total, wall_us, n_launches = prof["rows"], prof["device_ms"] * 1e3, prof["wall_ms"] * 1e3, prof["launches"]
    warp = sum(r[0] for r in rows if kernel_name and kernel_name in r[2])
    check(kernel_name is None or warp > 0, f"{label}: no {kernel_name} in the profile")
    share = f", {kernel_name} {warp / 1e3:.3f} ms ({warp / total:.4f} of device time)" if kernel_name else ""
    log(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms, device {total / 1e3:.1f} ms, "
        f"busy share {total / wall_us:.3f}, {n_launches} kernel launches{share} [{card}]")
    for dev, count, key in rows[:top]:
        log(f"[profile] {dev / 1e3:9.3f} ms {dev / total:6.3f} x{count:<5d} {key[:100]}")
    return prof


def kernel_shares(prof):
    """{kind: share of device time} of a :func:`profile_call` result, by
    the kinds of the benchmark's breakdown (``portbench/trace.py::kind_of``)."""
    from portbench.trace import KERNEL_KINDS, kind_of

    total = sum(r[0] for r in prof["rows"])
    shares = dict.fromkeys([kind for kind, _ in KERNEL_KINDS] + ["other"], 0.0)
    for dev, _, key in prof["rows"]:
        shares[kind_of(key)] += dev / total
    return shares


def phase_layout(model, rigs, seqs, hands, card):
    """``[layout]``: one replay of a track_sequences_batched call at S x T
    under torch.profiler, channels-last (the model's rule on this card) and
    with NCHW forced (the rule answering no, a fresh capture): cuDNN's
    NCHW<->NHWC transposes (``nchwToNhwc`` / ``nhwcToNchw``), the replay's
    kernels and device ms, the device time by kind, the backbone's forwards
    by layout; the two calls' angles against each other (both TF32, other
    cuDNN kernels)."""
    import torch
    from portbench.trace import kind_of
    from umetrack_torch.models import backbone
    from umetrack_torch.ops.bn_act import batch_norm_act
    from umetrack_torch.tracker import HandTracker

    tracker = HandTracker(model, device="cuda")
    rule, angles, counts = backbone.channels_last_rule, {}, {}
    for label, forced in (("channels-last", None), ("NCHW forced", lambda *args: False)):
        free_card()
        if forced is not None:
            backbone.channels_last_rule = forced
        try:
            before = collections.Counter(batch_norm_act.formats)
            tracker.track_sequences_batched(rigs, seqs, hands)  # the capture
            res, _ = tracker.track_sequences_batched(rigs, seqs, hands)
            prof = profile_call(lambda: tracker.track_sequences_batched(rigs, seqs, hands))
            forwards = dict(collections.Counter(batch_norm_act.formats) - before)
        finally:
            backbone.channels_last_rule = rule
        angles[label] = res.joint_angles
        counts[label] = sum(n for _, n, key in prof["rows"] if kind_of(key) == "layout")
        kinds = kernel_shares(prof)
        log(f"[layout] one track_sequences_batched replay S={S_BENCH} T={T_BENCH} f32 (TF32 "
            f"{'on' if torch.backends.cudnn.allow_tf32 else 'off'}), {label}: {counts[label]} "
            f"nchwToNhwc / nhwcToNchw kernels, {prof['launches']} kernels, device "
            f"{prof['device_ms']:.2f} ms of {prof['wall_ms']:.2f} ms; device ms by kind "
            + ", ".join(f"{k} {v * prof['device_ms']:.2f}" for k, v in kinds.items() if v)
            + f"; backbone forwards by layout over the three calls {forwards} [{card}]")
    gap = float((angles["channels-last"] - angles["NCHW forced"]).abs().nan_to_num().max())
    log(f"[layout] transposes in a replay: {counts['NCHW forced']} with NCHW forced -> "
        f"{counts['channels-last']} channels-last; angles channels-last against NCHW: max abs "
        f"{gap:.3e} rad")
    check(counts["channels-last"] == 0 or not torch.backends.cudnn.allow_tf32,
          f"[layout] channels-last left {counts['channels-last']} transposes of {counts['NCHW forced']}")
    free_card()
    return counts


# ---- the torch_data slice ---------------------------------------------------


def reset_launches(wp_mod, wi_mod):
    wp_mod.warp_pool.launches = 0
    wi_mod.warp_image_full.launches = 0
    wi_mod.warp_image_windowed.launches = 0


def launches(wp_mod, wi_mod):
    return (wp_mod.warp_pool.launches, wi_mod.warp_image_full.launches,
            wi_mod.warp_image_windowed.launches)


class ReaderLog:
    """Which reader ``FolderDataset`` took for each folder opened inside
    the block (``taken``: the distinct readers, from its log lines)."""

    def __enter__(self):
        import logging

        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if msg.startswith("reading ") and " with the " in msg:
                    outer.readers.append(msg.rsplit(" with the ", 1)[1].split()[0])

        self.readers, self.handler = [], Handler()
        self.logger = logging.getLogger("umetrack_torch.data.dataset")
        self.saved_level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.saved_level)

    @property
    def taken(self):
        return sorted(set(self.readers))


def batch_breakdown(model, root, card):
    """Where one batch's time goes, stage by stage on the host clock with a
    synchronise after each (the app itself overlaps read + parse with the
    device through its prefetch threads)."""
    import numpy as np
    import torch
    from umetrack_torch.apps import run_inference_torch_data as app
    from umetrack_torch.data import IdxBinFile, bundles, find_torchdata_folders
    from umetrack_torch.data.native import NativeIdxBin
    from umetrack_torch.data.transform import (
        crop_homographies, parse_raw_buffers, preprocess_sequence)
    from umetrack_torch.ops.resample import bilinear_sample, homography_coords

    folder = find_torchdata_folders(root, ["mono", "labels"])[0]
    files = {f: IdxBinFile.open(os.path.join(folder, f + ".torch.idx")) for f in ("mono", "labels")}
    native_labels = NativeIdxBin(os.path.join(folder, "labels.torch.idx"))
    t0 = time.perf_counter()
    monos = [files["mono"][i] for i in range(TD_BATCH)]  # zero-copy views of the mmap
    t_mono = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    labels = [files["labels"][i] for i in range(TD_BATCH)]  # msgpack decode
    t_labels = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    labels_native = [native_labels[i] for i in range(TD_BATCH)]
    t_labels_native = (time.perf_counter() - t0) * 1e3
    check(labels_native == labels, "the native reader's labels differ from the Python reader's")
    native_labels.close()
    label_kb = sum(len(files["labels"].frame_bytes(i)) for i in range(TD_BATCH)) / 1e3
    t0 = time.perf_counter()
    raws = [parse_raw_buffers(m, l) for m, l in zip(monos, labels)]
    t_parse = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batch = bundles.collate(raws)
    t_collate = (time.perf_counter() - t0) * 1e3
    t_upload, raw = wall_ms(lambda: bundles.to_device(batch, "cuda"))

    def geometry():
        _, _, xf = crop_homographies(raw)
        return homography_coords(xf.reshape(-1, 4, 4), (96, 96))

    geometry()
    t_geom, coords = wall_ms(geometry)
    images = raw.images.reshape(-1, TD_H, TD_W)
    t_warp = median_ms(lambda: bilinear_sample(images, coords), reps=10)
    preprocess_sequence(raw)
    t_pre, (model_input, target) = wall_ms(lambda: preprocess_sequence(raw))
    step_valid = torch.ones((TD_BATCH, TD_T), dtype=torch.bool, device="cuda")
    evaluate = lambda: app.eval_batch(
        model, model_input, target.gt_joint_angles, target.gt_wrist_xfs, 2, step_valid)
    evaluate()
    t_model, err = wall_ms(evaluate)
    check(bool(torch.isfinite(err).all()), "non-finite error in the breakdown batch")
    mb = sum(np.asarray(r.images).nbytes for r in raws) / 1e6
    log(f"[torch_data] one batch of {TD_BATCH} x {TD_T} x {TD_V} frames ({mb:.1f} MB uint8), by stage: "
        f"mono views {t_mono:.1f} ms, label decode (msgpack, {label_kb:.0f} KB) {t_labels:.1f} ms with "
        f"the Python reader, {t_labels_native:.1f} ms with the native reader, "
        f"parse to numpy {t_parse:.1f} ms, collate {t_collate:.1f} ms, "
        f"upload {t_upload:.1f} ms, preprocess {t_pre:.1f} ms (geometry {t_geom:.1f} ms, "
        f"warp kernel {t_warp:.4f} ms), model loop + error {t_model:.1f} ms [{card}]")
    return raws


def phase_torchdata_slice(wp_mod, wi_mod, model, card):
    import contextlib
    import io
    import math

    import torch
    from umetrack_torch.apps import run_inference_torch_data as app
    from umetrack_torch.apps.common import load_model_cli
    from umetrack_torch.data import Split
    from umetrack_torch.utils.synthetic import write_torchdata_corpus

    n_batches = TD_SEQS // TD_BATCH
    with tempfile.TemporaryDirectory(prefix="umetrack_torch_data_") as root:
        big, small = os.path.join(root, "big"), os.path.join(root, "small")
        t0 = time.perf_counter()
        for root_, h, w in ((big, TD_H, TD_W), (small, 120, 160)):
            write_torchdata_corpus(root_, n_train=0, n_test=TD_SEQS, t=TD_T, v=TD_V, h=h, w=w,
                                   device="cuda")
        log(f"[torch_data] wrote 2 x {TD_SEQS} sequences x {TD_T} frames x {TD_V} views "
            f"({TD_H} x {TD_W} and 120 x 160, the hand rendered on the card) in "
            f"{time.perf_counter() - t0:.1f} s")

        # the main path: counts to 0, the app's run, counts read
        torch.cuda.reset_peak_memory_stats()
        reset_launches(wp_mod, wi_mod)
        with ReaderLog() as readers:
            first_ms, res = wall_ms(lambda: app.run([big], model, batch_size=TD_BATCH))
        counts = launches(wp_mod, wi_mod)
        check(readers.taken == ["native"], f"the app read its folders with the {readers.taken} reader(s)")
        check(set(res) == {Split.TEST} and math.isfinite(res[Split.TEST]),
              f"run over the {TD_H} x {TD_W} tree: {res}")
        check(counts == (0, 0, n_batches),
              f"{TD_H} x {TD_W} tree: launches (pool, full, windowed) {counts} in {n_batches} batches")
        walls = {}
        for reader, flag in (("native", "1"), ("Python", "0")) * 3:
            os.environ["UMETRACK_NATIVE_IO"] = flag
            with ReaderLog() as readers:
                walls.setdefault(reader, []).append(
                    wall_ms(lambda: app.run([big], model, batch_size=TD_BATCH))[0])
            check(readers.taken == [reader], f"UMETRACK_NATIVE_IO={flag}: {readers.taken}")
        os.environ.pop("UMETRACK_NATIVE_IO")
        med = sorted(walls["native"])[1]
        log(f"[torch_data] run() over {TD_SEQS} sequences, {TD_H} x {TD_W}, batch {TD_BATCH}, full "
            f"ModelConfig() f32, native reader: {med:.1f} ms/run median of 3 "
            f"({', '.join(f'{w:.1f}' for w in walls['native'])}; first run {first_ms:.1f} ms), "
            f"{med / n_batches:.1f} ms/batch, {TD_SEQS / med * 1e3:.1f} sequences/s, "
            f"{TD_SEQS * TD_T / med * 1e3:.1f} frames/s, one warp_image_windowed launch per batch, mean "
            f"error {res[Split.TEST]:.1f} mm (random weights: finite, no more), peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; Python reader "
            f"(UMETRACK_NATIVE_IO=0, in turns with the native one): "
            f"{', '.join(f'{w:.1f}' for w in walls['Python'])} ms/run [{card}]")

        # the app in bf16 (``--dtype bfloat16``, the same seeded weights): its
        # ``main`` counted from 0, then ``run()`` in turns with the f32 model
        model16 = load_model_cli(None, BF16, "cuda")
        reset_launches(wp_mod, wi_mod)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            app.main(["--data", big, "--batch-size", str(TD_BATCH), "--dtype", BF16, "--json",
                      "--device", "cuda"])
        counts16 = launches(wp_mod, wi_mod)
        check(counts16 == (0, 0, n_batches),
              f"bf16 app: launches (pool, full, windowed) {counts16} in {n_batches} batches")
        err16 = list(json.loads(printed.getvalue().strip().splitlines()[-1]).values())
        check(len(err16) == 1 and math.isfinite(err16[0]), f"bf16 app: {err16}")
        turns = {}
        for label, m in (("f32", model), ("bf16", model16)) * 3:
            turns.setdefault(label, []).append(wall_ms(lambda: app.run([big], m, batch_size=TD_BATCH))[0])
        med16, med32 = sorted(turns["bf16"])[1], sorted(turns["f32"])[1]
        log(f"[bf16] run_inference_torch_data main --dtype bfloat16 over the {TD_H} x {TD_W} tree: one "
            f"warp_image_windowed launch per batch, mean error {err16[0]:.1f} mm (f32: "
            f"{res[Split.TEST]:.1f}); run() in turns with f32: bf16 {med16:.1f} ms/run median of 3 "
            f"({', '.join(f'{w:.1f}' for w in turns['bf16'])}), {TD_SEQS / med16 * 1e3:.1f} sequences/s; "
            f"f32 {med32:.1f} ms ({', '.join(f'{w:.1f}' for w in turns['f32'])}), "
            f"{TD_SEQS / med32 * 1e3:.1f} sequences/s [{card}]")
        del model16

        raws = batch_breakdown(model, big, card)
        phase_profile(lambda: app._run_batch(model, raws), "one torch_data batch (_run_batch)",
                      "warp_image_windowed_kernel", card, top=10)
        del raws

        reset_launches(wp_mod, wi_mod)
        small_ms, res_small = wall_ms(lambda: app.run([small], model, batch_size=TD_BATCH))
        counts_small = launches(wp_mod, wi_mod)
        check(math.isfinite(res_small[Split.TEST]), f"run over the 120 x 160 tree: {res_small}")
        check(counts_small == (0, n_batches, 0),
              f"120 x 160 tree: launches (pool, full, windowed) {counts_small}")
        log(f"[torch_data] run() over {TD_SEQS} sequences, 120 x 160: {small_ms:.1f} ms, "
            f"{TD_SEQS / small_ms * 1e3:.1f} sequences/s, one warp_image_full launch per batch [{card}]")
    return counts[2], counts_small[1], counts16[2]


# ---- card against CPU -------------------------------------------------------


class tf32_off:
    def __enter__(self):
        import torch

        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


class cudnn_enabled:
    """``torch.backends.cudnn.enabled`` set to ``flag`` inside, the earlier
    value restored after."""

    def __init__(self, flag):
        self.flag = flag

    def __enter__(self):
        import torch

        self.saved = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = self.flag

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.enabled = self.saved


def track_diff(a, b):
    check(bool((a.valid == b.valid).all()), "valid masks differ")
    v = a.valid
    check(bool(v.any()), "no valid hands")
    da = float((a.joint_angles[v] - b.joint_angles[v]).abs().max())
    dw = float((a.wrist_xfs[v][..., :3, 3] - b.wrist_xfs[v][..., :3, 3]).abs().max())
    return da, dw


def phase_cpu_vs_card(model_cpu, model_cuda, wp_mod, wi_mod):
    """The tracker at S_SMALL x T_SMALL, TF32 off: the card against the CPU;
    then on the card each per-slot sampler against the pool sampler, with
    one launch of its kernel a call and none of the other two warp kernels."""
    from umetrack_torch.tracker import HandTracker, TrackerConfig
    from umetrack_torch.utils.synthetic import make_sequences

    rigs, seqs, hands = make_sequences(S_SMALL, T_SMALL, seed=100, device="cpu")
    on_card = (rigs.to("cuda"), seqs.to("cuda"), hands.to("cuda"))
    kernels = (wp_mod.warp_pool, wi_mod.warp_image_windowed, wi_mod.warp_image_full)
    per_slot = {"kernel_win": wi_mod.warp_image_windowed, "kernel_full": wi_mod.warp_image_full}
    with tf32_off():
        res_cpu, _ = HandTracker(model_cpu, device="cpu").track_sequences_batched(rigs, seqs, hands)
        res_gpu, _ = HandTracker(model_cuda, device="cuda").track_sequences_batched(*on_card)
        res_slot = {}
        for sampler, kernel in per_slot.items():
            before = [k.launches for k in kernels]
            res_slot[sampler], _ = HandTracker(
                model_cuda, TrackerConfig(sampler=sampler), device="cuda"
            ).track_sequences_batched(*on_card)
            made = {k.__name__: k.launches - n for k, n in zip(kernels, before)}
            want = {k.__name__: int(k is kernel) for k in kernels}
            check(made == want, f"sampler={sampler!r}: warp launches {made} in one call, expected {want}")
    da, dw = track_diff(res_cpu, res_gpu.to("cpu"))
    log(f"[cpu-vs-card] S={S_SMALL} T={T_SMALL} TF32 off: valid equal, "
        f"max angle diff {da:.3e} rad (<= 1e-3), max wrist diff {dw:.3e} mm (<= 0.1)")
    check(da <= 1e-3, f"angles differ by {da} rad")
    check(dw <= 0.1, f"wrist translations differ by {dw} mm")
    for sampler, kernel in per_slot.items():
        da, dw = track_diff(res_gpu, res_slot[sampler])
        log(f"[cpu-vs-card] on the card, sampler={sampler!r} against the pool sampler: one "
            f"{kernel.__name__} launch a call, no other warp kernel; max angle diff {da:.3e} rad "
            f"(<= 1e-3), max wrist diff {dw:.3e} mm (<= 0.1)")
        check(da <= 1e-3 and dw <= 0.1, f"{sampler} vs pool: {da} rad, {dw} mm")


def phase_torchdata_cpu_vs_card(model_cpu, model_cuda):
    import numpy as np
    from umetrack_torch.apps.run_inference_torch_data import _run_batch
    from umetrack_torch.data import bundles
    from umetrack_torch.data.transform import preprocess_sequence

    raws = torchdata_batch(S_SMALL, T_SMALL, TD_H, TD_W, seed0=200)
    with tf32_off():
        err_cpu = _run_batch(model_cpu, raws)
        err_gpu = _run_batch(model_cuda, raws)
    batch = bundles.collate(raws)
    crops_cpu = preprocess_sequence(bundles.to_device(batch, "cpu"))[0].left_images
    crops_gpu = preprocess_sequence(bundles.to_device(batch, "cuda"))[0].left_images.cpu()
    d_err = float(np.abs(err_cpu - err_gpu).max())
    d_img = float((crops_cpu - crops_gpu).abs().max())
    log(f"[cpu-vs-card] torch_data _run_batch, {S_SMALL} sequences x T={T_SMALL}, TF32 off: "
        f"per-sample errors differ by {d_err:.3e} mm (<= 0.1), left_images by {d_img:.3e} (<= 2e-3)")
    check(np.isfinite(err_gpu).all(), "non-finite error on the card")
    check(d_err <= 0.1, f"per-sample errors differ by {d_err} mm")
    check(d_img <= 2e-3, f"left_images differ by {d_img}")


# ---- the raw_data evaluation slice -------------------------------------------


def result_diff(a, b, label, bounds):
    """Two FrameResults within ``bounds``: equal masks, angles, wrist
    translations, scales where both have them.  Returns the three gaps."""
    import torch

    da, dw = track_diff(a, b)
    ds = 0.0
    if a.predicted_scales is not None:
        v = a.valid
        ds = float((a.predicted_scales[v] - b.predicted_scales[v]).abs().max())
    check(da <= bounds.angle and dw <= bounds.mm and ds <= bounds.scale,
          f"{label}: {da} rad, {dw} mm, scale {ds}")
    check(bool(torch.isfinite(a.joint_angles).all() & torch.isfinite(a.wrist_xfs).all()),
          f"{label}: non-finite output")
    return da, dw, ds


def rendered_sequence(t, seed, device, hand_scale=1.07):
    """A capsule-rendered synthetic sequence as (labels, images) and as the
    tracker's (rig, observation, hand model) on ``device``."""
    from umetrack_torch.utils.synthetic import make_labels_dict, our_sequence

    labels, images = make_labels_dict(t, rng_seed=seed, hand_scale=hand_scale, device=device)
    return labels, images, our_sequence(labels, images, device)


class LaunchTally:
    """The launches of the pool kernel and of the one-pass BatchNorm over a
    path's entry-point calls alone: both counters are set to 0 just before
    each such call and read just after it, and ``total`` (the pool's) and
    ``bn_total`` are the sums of those readings.  Each pool launch feeds one
    forward of the model, ``scale`` of a call's the scale head's and the
    rest the known skeleton's, so a call makes :func:`bn_sites` BatchNorm
    launches, and one backbone forward a pool launch: ``bn_paths`` and
    ``formats`` sum the BatchNorm's launches by path and layout and the
    forwards by layout (``batch_norm_act.paths`` / ``.formats``).
    Comparisons, timings and profiles run outside it."""

    def __init__(self, pool, bn):
        self.pool, self.bn, self.total, self.bn_total = pool, bn, 0, 0
        self.bn_paths, self.formats = collections.Counter(), collections.Counter()

    def __call__(self, fn, want, label, scale=0):
        self.pool.launches = self.bn.launches = 0
        paths, formats = collections.Counter(self.bn.paths), collections.Counter(self.bn.formats)
        out = fn()
        made, bn_made, bn_want = self.pool.launches, self.bn.launches, bn_sites(want - scale, scale)
        forwards = collections.Counter(self.bn.formats) - formats
        check(sum(forwards.values()) == want,
              f"{label}: backbone forwards by layout {dict(forwards)}, expected {want} in all")
        self.formats.update(forwards)
        self.bn_paths.update(collections.Counter(self.bn.paths) - paths)
        check(made == want, f"{label}: {made} warp_pool launches, expected {want}")
        check(bn_made == bn_want, f"{label}: {bn_made} batch_norm_act launches, expected {bn_want} "
                                  f"({want - scale} known-skeleton and {scale} scale-head forwards)")
        self.total += made
        self.bn_total += bn_made
        return out


def eval_shape_checks(wp_mod, config, rig, seq, hand, card):
    """The pool kernel against its plain version at the three shapes the
    evaluation path gives it: one streamed frame, a chunk of the streaming
    eval, a whole padded sequence.  A row of numbers for each."""
    from umetrack_torch.tracker.tracker import pool_warp_operands

    one = lambda tree: tree.map(lambda a: a[None])
    return [
        pool_shape_row(wp_mod, f"eval shape, {label}", *pool_warp_operands(
            config, one(rig), one(seq.map(lambda a: a[:frames])), one(hand)), card)
        for label, frames in (("one streamed frame", 1), (f"a chunk of {EVAL_CHUNK} frames", EVAL_CHUNK),
                              (f"a sequence of {EVAL_FRAMES} frames", EVAL_FRAMES))
    ]


def pool_shape_row(wp_mod, label, pool, coords, src, card):
    """The pool kernel against its plain version on the vector path at one
    shape a path gives it; its times and byte bound as a row of numbers."""
    import torch
    from umetrack_torch.ops.resample import bilinear_sample_pool_plain

    warp_pool = wp_mod.warp_pool
    before = warp_pool.paths["vector"]
    out_k = warp_pool(pool, coords, src)
    out_p = bilinear_sample_pool_plain(pool, coords, src)
    torch.cuda.synchronize()
    check(warp_pool.paths["vector"] == before + 1, f"{label}: not the vector path")
    check(bool(torch.isfinite(out_k).all()), f"{label}: non-finite output")
    err = float((out_k - out_p).abs().max())
    check(err <= KERNEL_ATOL, f"{label}: kernel vs plain {err}")
    ms = median_ms(lambda: warp_pool(pool, coords, src), reps=20)
    kernel_ms = device_ms(lambda: wp_mod._launch(pool, coords, src), reps=40)
    seen = device_ms.seen
    check_ms = burst_ms(lambda: wp_mod._check(pool, coords, src), BURST)
    plain_ms = median_ms(lambda: bilinear_sample_pool_plain(pool, coords, src), reps=10)
    nearest_ms = grid_sample_ms(pool, coords, src, reps=10)
    bound_ms, bound_by, text = byte_bound(pool, coords, src)
    log(f"[kernel] {label}: pool {tuple(pool.shape)} uint8, {coords.shape[0]} warps of "
        f"{tuple(coords.shape[1:3])}, path vector, max_abs_err {err:.3e}, bit for bit "
        f"{bool(torch.equal(out_k, out_p))}, nonzero samples {float((out_k != 0).float().mean()):.3f}; "
        f"{ms:.4f} ms a call of the wrapper (its src_idx range check alone {check_ms:.4f} ms), kernel "
        f"alone {kernel_ms:.4f} ms (device time, the profiler saw {seen} of 40 launches), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({text}), share {bound_ms / kernel_ms:.3f} of "
        f"the kernel alone; grid_sample on an f32 copy (not the same function) {nearest_ms:.4f} ms [{card}]")
    return dict(shape=label, pool=list(pool.shape), warps=coords.shape[0], max_abs_err=err,
                ms=ms, kernel_ms=kernel_ms, check_ms=check_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, grid_sample_ms=nearest_ms)


def same_crops_gap(model, config, rig, seq, hand):
    """(angle rad, wrist mm, carried memory) between per-frame model steps
    and the hoisted scan when both are given the SAME crops, those of the
    sequence prepared whole: what is left of the gap between ``track_frame``
    and ``track_sequence`` once the crop fit is taken out of it."""
    import torch
    from umetrack_torch.tracker import tracker as T
    from umetrack_torch.tracker.types import FrameResult, TrackState

    device = seq.images.device
    hand_idx = torch.arange(2, device=device)
    skeleton = T._skeleton_inputs(hand)
    with torch.inference_mode():
        crop_sets, crop_images = T._prepare_frames(
            config, rig, seq, hand, 1, config.resolved_sampler(device))
        state = TrackState.init(model.config, 2, device=device)
        ref, ref_state = T._model_scan(model, config, crop_sets, crop_images, state, skeleton, hand_idx)
        angles, wrists = [], []
        for i in range(crop_images.shape[0]):
            crop_set = crop_sets.map(lambda a: a[i])
            frame = T._frame_inputs_from_crops(
                crop_set, crop_images[i], hand_idx, state.valid_history & crop_set.hand_valid)
            out, temporal = model.known_skeleton(frame, skeleton, state.temporal)
            state = TrackState(temporal=temporal, valid_history=crop_set.hand_valid)
            angles.append(out.joint_angles)
            wrist = out.wrist_xfs.clone()
            wrist[..., :3, 3] *= 1e3
            wrists.append(wrist)
    stepped = FrameResult(torch.stack(angles), torch.stack(wrists), ref.valid, ref.n_views)
    da, dw = track_diff(stepped, ref)
    dm = float((state.temporal.mem_features - ref_state.temporal.mem_features).abs().max())
    return da, dw, dm


def phase_checkpoint(card):
    """The trained checkpoint through the port's loader; both heads of the
    loaded model on the card against the CPU on one rendered frame's crops."""
    import torch
    from umetrack_torch.apps.common import load_model_cli
    from umetrack_torch.models import TemporalState
    from umetrack_torch.tracker import TrackerConfig
    from umetrack_torch.tracker import tracker as T

    t0 = time.perf_counter()
    model_cpu = load_model_cli(CHECKPOINT, device="cpu")
    load_s = time.perf_counter() - t0
    model_cuda = load_model_cli(CHECKPOINT, device="cuda")
    sd = model_cpu.state_dict()
    leaves = [k for k in sd if not k.endswith("num_batches_tracked")]
    n_bytes = sum(sd[k].numel() * sd[k].element_size() for k in leaves)
    check(len(leaves) == 213, f"checkpoint leaves: {len(leaves)}")
    log(f"[checkpoint] {os.path.relpath(CHECKPOINT, HERE)}: {os.path.getsize(CHECKPOINT)} bytes on disk, "
        f"{len(leaves)} f32 leaves, {n_bytes} bytes of weights, loaded in {load_s:.2f} s")

    _, _, (rig, seq, hand) = rendered_sequence(8, 2_000_000, "cuda")
    config = TrackerConfig()
    obs = seq.map(lambda a: a[0])
    crop_set, crop_images = T._prepare_frames(
        config, rig, obs, hand, 1, config.resolved_sampler(torch.device("cuda")))
    check(bool(crop_set.hand_valid.all()), "checkpoint frame: a hand is not in view")
    frame = T._frame_inputs_from_crops(crop_set, crop_images, torch.arange(2, device="cuda"))
    skeleton = T._skeleton_inputs(hand)
    with tf32_off(), torch.inference_mode():
        outs = {}
        for name, model, dev in (("card", model_cuda, "cuda"), ("cpu", model_cpu, "cpu")):
            state = TemporalState.zeros(2, model.config, device=dev)
            known, _ = model.known_skeleton(frame.to(dev), skeleton.to(dev), state)
            scale, _ = model.predict_scale(frame.to(dev), state)
            outs[name] = (known.to("cpu"), scale.to("cpu"))
    gaps = []
    for head, (a, b) in zip(("known_skeleton", "predict_scale"), zip(outs["card"], outs["cpu"])):
        da = float((a.joint_angles - b.joint_angles).abs().max())
        dw = float((a.wrist_xfs[..., :3, 3] - b.wrist_xfs[..., :3, 3]).abs().max()) * 1e3
        check(da <= ANGLE_TOL and dw <= WRIST_TOL_MM, f"{head}: card vs CPU {da} rad, {dw} mm")
        gaps.append(f"{head} {da:.3e} rad, {dw:.3e} mm")
    sa, sb = outs["card"][1].skel_scales, outs["cpu"][1].skel_scales
    ds = float((sa - sb).abs().max())
    check(ds <= SCALE_TOL, f"predict_scale: scales differ by {ds}")
    log(f"[checkpoint] loaded model, card against CPU (TF32 off) on one rendered frame: "
        f"{'; '.join(gaps)}; scales {[round(float(x), 4) for x in sa]} differ by {ds:.3e} "
        f"(<= {ANGLE_TOL} rad, {WRIST_TOL_MM} mm, {SCALE_TOL})")
    return model_cpu, model_cuda


def phase_orbax(ckpt_cuda, tally, rigs, seqs, hands, build_s, card):
    """Orbax-format checkpoints: the zstd decoder's build; the embedded
    frames (``ZSTD_FRAMES``) decoded to their content, alone and
    concatenated, and a damaged checksum refused; the trained checkpoint
    written as an orbax directory by the port and read back bit for bit
    (bytes on disk, write and read times beside the ``.msgpack`` load);
    ``load_model_cli`` on that directory, whose parameters equal the
    ``.msgpack`` model's, and the batched tracker at the bench shape with
    each (one ``warp_pool`` launch a call, counted by ``tally``): the same
    poses."""
    import base64

    import torch
    from umetrack_torch.apps.common import load_model_cli
    from umetrack_torch.tracker import HandTracker
    from umetrack_torch.utils import _zstd
    from umetrack_torch.utils.checkpoints import load_checkpoint, save_checkpoint

    t_phase = time.perf_counter()
    log(f"[orbax] csrc/zstd_decode.cpp built by g++ in {build_s:.2f} s (beside the nvcc builds)")
    frames, contents = [], []
    for name, (seed, size, level, checksum, sized, b64) in ZSTD_FRAMES.items():
        frame, want = base64.b64decode("".join(b64)), zstd_frame_content(seed, size)
        flags = frame[4]
        check(bool(flags & 0x04) == checksum and bool(flags >> 6 or flags & 0x20) == sized,
              f"zstd frame {name}: header flags {flags:#x}")
        t0 = time.perf_counter()
        got = _zstd.decompress(frame)
        ms = (time.perf_counter() - t0) * 1e3
        check(got == want, f"zstd frame {name}: {len(got)} bytes decoded, not the {size} of its content")
        log(f"[orbax] zstd frame ({name}, seed {seed}): {len(frame)} -> {size} bytes, equal to "
            f"zstd_frame_content; {ms:.2f} ms")
        frames.append(frame)
        contents.append(want)
    check(_zstd.decompress(b"".join(frames)) == b"".join(contents), "concatenated zstd frames")
    damaged = bytearray(frames[0])
    damaged[-1] ^= 0xFF  # the XXH64 checksum
    try:
        _zstd.decompress(bytes(damaged))
        refused = False
    except _zstd.ZstdError:
        refused = True
    check(refused, "a frame with a damaged checksum decoded")
    log(f"[orbax] the {len(frames)} frames concatenated decode to their contents in order; a damaged "
        f"checksum raises")

    t0 = time.perf_counter()
    sd = load_checkpoint(CHECKPOINT)
    msgpack_ms = (time.perf_counter() - t0) * 1e3
    leaves = [k for k in sd if not k.endswith("num_batches_tracked")]
    n_bytes = sum(sd[k].numel() * sd[k].element_size() for k in leaves)
    with tempfile.TemporaryDirectory(prefix="umetrack_orbax_") as tmp:
        path = os.path.join(tmp, "final")
        t0 = time.perf_counter()
        save_checkpoint(path, sd)
        write_ms = (time.perf_counter() - t0) * 1e3
        disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
        t0 = time.perf_counter()
        back = load_checkpoint(path)
        read_ms = (time.perf_counter() - t0) * 1e3
        check(len(leaves) == 213 and set(back) == set(sd), f"orbax round trip: keys {len(back)}")
        unequal = [k for k in sd if not torch.equal(back[k], sd[k])]
        check(not unequal, f"orbax round trip: leaves differ: {unequal[:5]}")
        log(f"[orbax] {os.path.relpath(CHECKPOINT, HERE)} ({len(leaves)} leaves, {n_bytes} bytes of "
            f"f32) written by the port as an orbax directory: {disk} bytes on disk in "
            f"{sorted(os.listdir(path))}, write {write_ms:.1f} ms, read back {read_ms:.1f} ms "
            f"({disk / read_ms / 1e3:.1f} MB/s, stored zstd blocks), all {len(leaves)} leaves bit for "
            f"bit; the .msgpack load {msgpack_ms:.1f} ms [{card}]")
        model_dir = load_model_cli(path, device="cuda")
    ours, ref = model_dir.state_dict(), ckpt_cuda.state_dict()
    check(set(ours) == set(ref) and all(torch.equal(ours[k], ref[k]) for k in ref),
          "load_model_cli(directory) parameters differ from the .msgpack model's")
    results = []
    for label, model in (("directory", model_dir), (".msgpack", ckpt_cuda)):
        tracker = HandTracker(model, device="cuda")
        res, _ = tally(lambda: tracker.track_sequences_batched(rigs, seqs, hands), 1,
                       f"orbax: track_sequences_batched, {label} weights")
        results.append(res)
    a, b = results
    check(bool(torch.isfinite(a.joint_angles).all()) and bool(a.valid.any()), "orbax tracker output")
    da = float((a.joint_angles - b.joint_angles).abs().max())
    dw = float((a.wrist_xfs[..., :3, 3] - b.wrist_xfs[..., :3, 3]).abs().max()) * 1e3
    check(torch.equal(a.valid, b.valid) and da <= ANGLE_TOL and dw <= WRIST_TOL_MM,
          f"orbax tracker: directory against .msgpack weights {da} rad, {dw} mm")
    s, t = seqs.gt_confidences.shape[:2]
    log(f"[orbax] load_model_cli(<directory>, device='cuda'): parameters equal the .msgpack model's bit "
        f"for bit; track_sequences_batched S={s} T={t} with each: gap {da} rad, {dw} mm "
        + ("(bit for bit)" if da == 0.0 and dw == 0.0 else
           f"(nonzero: cuDNN's algorithm choice; held at {ANGLE_TOL} rad, {WRIST_TOL_MM} mm)")
        + f", one warp_pool launch a call; the phase took {time.perf_counter() - t_phase:.1f} s [{card}]")


def phase_streaming(wp_mod, models, tally, card):
    """``track_frame`` looped over a rendered sequence with a confidence
    dropout against ``track_sequence``, both heads, for each of ``models``
    (name, model, bounds); the pool kernel against its plain version at the
    evaluation path's shapes; then the loop's speed with the last model.
    Returns the rows of :func:`eval_shape_checks`."""
    import torch
    from umetrack_torch.tracker import HandTracker
    from umetrack_torch.tracker.tracker import pool_warp_operands
    from umetrack_torch.tracker.types import FrameResult

    _, _, (rig, seq, hand) = rendered_sequence(EVAL_FRAMES, 2_000_001, "cuda")
    conf = seq.gt_confidences
    check(bool((conf == 0).any() and (conf[0] > 0).all()), "the sequence has no confidence dropout")
    frames = [seq.map(lambda a, i=i: a[i]) for i in range(EVAL_FRAMES)]
    one = lambda tree: tree.map(lambda a: a[None])

    def loop(tracker, step):
        state, outs = tracker.init_state(), []
        for obs in frames:
            res, state = step(rig, obs, state, hand)
            outs.append(res)
        stacked = FrameResult(**{
            k: torch.stack([getattr(o, k) for o in outs])
            for k in ("joint_angles", "wrist_xfs", "valid", "n_views", "predicted_scales")
            if getattr(outs[0], k) is not None})
        return stacked, state

    # what the two forms feed the sampler: a frame's source coordinates
    # computed alone against the same frame inside its sequence
    config = HandTracker(models[0][1], device="cuda").config
    _, coords_seq, _ = pool_warp_operands(config, one(rig), one(seq), one(hand))
    slots = coords_seq.shape[0] // EVAL_FRAMES
    coord_gap = max(
        float((pool_warp_operands(config, one(rig), one(one(frames[i])), one(hand))[1]
               - coords_seq[i * slots:(i + 1) * slots]).abs().max())
        for i in (0, EVAL_FRAMES // 2, EVAL_FRAMES - 1))
    log(f"[streaming] source coordinates of a frame computed alone against the same frame inside "
        f"its sequence: up to {coord_gap:.3e} pixels apart")
    del coords_seq

    with tf32_off():
        for name, model, bounds in models:
            tracker = HandTracker(model, device="cuda")
            da, dw, dm = same_crops_gap(model, config, rig, seq, hand)
            check(da <= STRICT.angle and dw <= STRICT.mm,
                  f"{name}: per-frame steps against the scan on the same crops: {da} rad, {dw} mm")
            log(f"[streaming] {name}: per-frame model steps against the hoisted scan on the SAME crops "
                f"(the sequence's, TF32 off): angles {da:.3e} rad (<= {STRICT.angle}), wrist {dw:.3e} mm "
                f"(<= {STRICT.mm}), carried memory {dm:.3e}")
            for head, step, whole in (
                ("known skeleton", tracker.track_frame,
                 lambda: tracker.track_sequence(rig, seq, hand)),
                ("scale head", tracker.track_frame_and_calibrate_scale,
                 lambda: tracker.predict_scales(rig, seq, hand)),
            ):
                before = wp_mod.warp_pool.paths["vector"]
                scale = head == "scale head"
                streamed, state = tally(lambda: loop(tracker, step), EVAL_FRAMES,
                                        f"{head}: {EVAL_FRAMES} track_frame calls", scale=scale * EVAL_FRAMES)
                check(wp_mod.warp_pool.paths["vector"] == before + EVAL_FRAMES,
                      f"{head}: a track_frame call left the vector path")
                ref = tally(whole, 1, f"{head}: the whole-sequence call", scale=int(scale))
                if head == "scale head":
                    scales, valid, ref_state = ref
                    ref_res = FrameResult(streamed.joint_angles, streamed.wrist_xfs, valid,
                                          streamed.n_views, scales)
                else:
                    ref_res, ref_state = ref
                da, dw, ds = result_diff(streamed, ref_res, f"track_frame loop, {name}, {head}", bounds)
                dm = float((state.temporal.mem_features - ref_state.temporal.mem_features).abs().max())
                n_valid = int(streamed.valid.sum())
                check(0 < n_valid < streamed.valid.numel(), f"{head}: valid {n_valid}")
                gaps = (f"scale {ds:.3e} (<= {bounds.scale})" if head == "scale head" else
                        f"angles {da:.3e} rad (<= {bounds.angle}), wrist {dw:.3e} mm (<= {bounds.mm})")
                log(f"[streaming] {name}, {head}: {EVAL_FRAMES} x track_frame against one "
                    f"whole-sequence call (TF32 off): masks equal ({n_valid}/{streamed.valid.numel()} "
                    f"valid), {gaps}, carried memory {dm:.3e}; {EVAL_FRAMES} warp_pool launches, "
                    f"all on the vector path")

    shapes = eval_shape_checks(wp_mod, config, rig, seq, hand, card)

    # speed, default settings: the streaming loop against the hoisted call
    loop(tracker, tracker.track_frame)
    loop_ms, _ = wall_ms(lambda: loop(tracker, tracker.track_frame))
    tracker.track_sequence(rig, seq, hand)
    seq_ms, _ = wall_ms(lambda: tracker.track_sequence(rig, seq, hand))
    geom_ms = min(wall_ms(lambda: pool_warp_operands(
        config, one(rig), one(one(frames[0])), one(hand)))[0] for _ in range(3))
    log(f"[streaming] track_frame loop {loop_ms:.1f} ms for {EVAL_FRAMES} frames: "
        f"{loop_ms / EVAL_FRAMES:.3f} ms/frame, {EVAL_FRAMES / loop_ms * 1e3:.1f} frames/s; "
        f"track_sequence on the same frames {seq_ms:.1f} ms: {seq_ms / EVAL_FRAMES:.3f} ms/frame, "
        f"{EVAL_FRAMES / seq_ms * 1e3:.1f} frames/s; a streaming frame costs "
        f"{loop_ms / seq_ms:.1f} x a hoisted one; of a frame, the crop geometry alone takes "
        f"{geom_ms:.3f} ms; at its shape (pool {tuple(shapes[0]['pool'])}, {shapes[0]['warps']} warps) "
        f"the pool kernel runs {shapes[0]['kernel_ms']:.4f} ms and the wrapper's checks (the src_idx "
        f"range as a device-side assert) take {shapes[0]['check_ms']:.4f} ms a frame [{card}]")
    phase_profile(lambda: loop(tracker, tracker.track_frame), f"{EVAL_FRAMES} track_frame calls",
                  "warp_pool_kernel", card, top=8)
    phase_profile(lambda: pool_warp_operands(config, one(rig), one(one(frames[0])), one(hand)),
                  "one frame's crop geometry alone", "elementwise", card, top=3)
    return shapes


def phase_unknown(models, tally, rigs, seqs, hands, card):
    """``calibrate_sequences_batched`` at the bench shape: one launch; its
    scales against ``calibrate_sequence`` per sequence."""
    import torch
    from umetrack_torch.tracker import HandTracker
    from umetrack_torch.tracker.tracker import calibrate_sequences_batched

    s, t = seqs.gt_confidences.shape[:2]
    for name, model, bounds in models:
        tracker = HandTracker(model, device="cuda")
        batched = lambda: calibrate_sequences_batched(
            model, tracker.config, rigs, seqs, tracker.init_state(2 * s), hands, device="cuda")
        with tf32_off():
            scales = tally(batched, 1, "calibrate_sequences_batched", scale=1)
            check(scales.shape == (s,) and bool(torch.isfinite(scales).all() & (scales > 0).all()),
                  f"batched scales {tuple(scales.shape)}")
            alone = torch.stack([
                tally(lambda i=i: tracker.calibrate_sequence(
                    rigs.map(lambda a: a[i]), seqs.map(lambda a: a[i]), hands.map(lambda a: a[i])),
                    1, "calibrate_sequence", scale=1)
                for i in range(CALIBRATE_CHECKED)])
        gap = float((scales[:CALIBRATE_CHECKED] - alone).abs().max())
        check(gap <= bounds.scale, f"{name}: batched against per-sequence calibration: {gap}")
        batched()
        ms, _ = wall_ms(batched)
        log(f"[unknown] {name}: calibrate_sequences_batched S={s} T={t} (30 samples, 2-view frames): "
            f"one warp_pool launch, scales {float(scales.min()):.4f}..{float(scales.max()):.4f} "
            f"(noise frames: finite, no more); the first {CALIBRATE_CHECKED} sequences through "
            f"calibrate_sequence differ by {gap:.3e} (<= {bounds.scale}, TF32 off); {ms:.1f} ms/call, "
            f"{s * t / ms * 1e3:.1f} frames/s [{card}]")


def phase_eval_apps(models, tally, card):
    """The two eval apps' ``main`` on generated sequences with the
    checkpoint, ``load_eval``'s aggregate, the streaming eval against the
    whole-sequence eval, and one sequence under the profiler.  Returns the
    known-skeleton app's ``load_eval`` summary."""
    import contextlib
    import io
    import pickle

    import numpy as np
    import torch
    from umetrack_torch.apps import load_eval, run_eval_known_skeleton, run_eval_unknown_skeleton
    from umetrack_torch.apps import sequence_eval
    from umetrack_torch.metrics import MPJPA_CAVEAT
    from umetrack_torch.tracker import HandTracker
    from umetrack_torch.tracker.video import stream_from_data
    from umetrack_torch.utils.profiling import PhaseTimers

    with tempfile.TemporaryDirectory(prefix="umetrack_eval_") as root:
        common = ["--synthetic", str(EVAL_SEQS), "--synthetic-frames", str(EVAL_FRAMES),
                  "--checkpoint", CHECKPOINT, "--device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        for mode, app, per_seq in (("known_skeleton", run_eval_known_skeleton, 1),
                                   ("unknown_skeleton", run_eval_unknown_skeleton, 2)):
            out_dir = os.path.join(root, f"eval_results_{mode}", "real", "separate_hand")
            ms, errors = tally(
                lambda: wall_ms(lambda: app.main(["--output-dir", out_dir] + common)),
                per_seq * EVAL_SEQS, f"run_eval_{mode}.main on {EVAL_SEQS} sequences",
                scale=(per_seq - 1) * EVAL_SEQS)  # unknown: a calibration, then the known retrack
            check(len(errors) == EVAL_SEQS and bool(np.isfinite(errors).all()), f"{mode}: {errors}")
            log(f"[eval] run_eval_{mode}.main --synthetic {EVAL_SEQS} --synthetic-frames "
                f"{EVAL_FRAMES} with the checkpoint: {ms / 1e3:.2f} s in all (model load, rendering, "
                f"tracking, artifacts), {EVAL_SEQS * EVAL_FRAMES / ms * 1e3:.1f} frames/s, "
                f"{per_seq} warp_pool launch(es) a sequence, per-sequence mean error "
                f"{', '.join(f'{e:.2f}' for e in errors)} mm [{card}]")
        peak = torch.cuda.max_memory_allocated() / 2**30
        with contextlib.redirect_stdout(io.StringIO()):
            summaries = load_eval.main(["--results-root", root])
        check(set(summaries) == {"known_skeleton/separate_hand", "unknown_skeleton/separate_hand"},
              f"load_eval found {sorted(summaries)}")
        for name, summ in summaries.items():
            check(summ["n_total_frames"] == 2 * EVAL_SEQS * EVAL_FRAMES, f"{name}: {summ}")
            check(all(np.isfinite(summ[k]) for k in ("mpjpe_mm", "pck_auc", "mpjpa_deg")), f"{name}: {summ}")
            check(summ["mpjpa_caveat"] == MPJPA_CAVEAT, "the MPJPA caveat is missing")
            log(f"[eval] load_eval {name}: tracked {summ['n_tracked_frames']}/{summ['n_total_frames']}, "
                f"MPJPE {summ['mpjpe_mm']:.3f} mm, PCK-AUC {summ['pck_auc']:.4f}, MPJPA "
                f"{summ['mpjpa_deg']:.3f} deg, acceleration {summ['mean_keypoint_acceleration']:.3f} "
                f"(GT {summ['gt_mean_keypoint_acceleration']:.3f})")
        f32_known = summaries["known_skeleton/separate_hand"]
        log(f"[eval] ({MPJPA_CAVEAT})")
        log("[eval] capsule-rendered frames; the checkpoint was trained on the stroke style, which "
            "needs OpenCV: these accuracies are findings, not gates")
        scales = []
        for i in range(EVAL_SEQS):
            path = os.path.join(root, "eval_results_unknown_skeleton", "real", "separate_hand",
                                "synthetic", f"seq_{i:04d}.npy")
            with open(path, "rb") as fp:
                art = pickle.load(fp)
            gt = run_eval_known_skeleton.synthetic_scale(1_000_000 + i, 0.15)
            scales.append(f"{float(art['calibrated_scale']):.4f} (GT {gt:.4f})")
        log(f"[eval] calibrated scales: {', '.join(scales)}; peak mem of the two apps {peak:.2f} GiB")

    # what an app's time is made of: one generated sequence, stage by stage
    args = argparse.Namespace(
        synthetic_frames=EVAL_FRAMES, seed_base=1_000_000, synthetic_mode="separate",
        synthetic_scale_jitter=0.15)
    gen_ms, seq = wall_ms(lambda: run_eval_known_skeleton.synthetic_sequence(args, 0, "cuda"))
    tracker = HandTracker(models[-1][1], device="cuda")
    sequence_eval.eval_sequence_known(tracker, seq)
    ms, _ = wall_ms(lambda: sequence_eval.eval_sequence_known(tracker, seq))
    log(f"[eval] one sequence of {EVAL_FRAMES} frames: generated (motion, landmarks, capsule "
        f"rendering on the card, label lists) in {gen_ms:.1f} ms; eval_sequence_known (staging, "
        f"tracking, landmarks, artifact) {ms:.1f} ms, {EVAL_FRAMES / ms * 1e3:.1f} frames/s [{card}]")

    # the streaming eval (state carried across chunks) against the whole sequence
    n_chunks = EVAL_FRAMES // EVAL_CHUNK
    for name, model, bounds in models:
        tracker = HandTracker(model, device="cuda")
        with tf32_off():
            whole = sequence_eval.eval_sequence_known(tracker, seq)
            chunked = tally(lambda: sequence_eval.eval_sequence_known_streaming(
                tracker, stream_from_data(seq), chunk=EVAL_CHUNK), n_chunks, "streaming eval")
        check(list(whole) == list(chunked), "artifact keys differ")
        check(bool((whole["valid_tracking"] == chunked["valid_tracking"]).all()), "chunked: masks differ")
        gaps = {k: float(np.abs(whole[k] - chunked[k]).max()) for k in whole if k != "valid_tracking"}
        check(gaps["tracked_keypoints"] <= bounds.chunked_mm and gaps["gt_keypoints"] <= 1e-5
              and gaps["tracked_joint_angles"] <= bounds.angle and gaps["gt_joint_angles"] == 0.0,
              f"{name}: chunked against whole: {gaps}")
        log(f"[eval] {name}: eval_sequence_known_streaming (chunk {EVAL_CHUNK}, {n_chunks} warp_pool "
            f"launches) against eval_sequence_known, TF32 off: masks equal, tracked keypoints "
            f"{gaps['tracked_keypoints']:.3e} mm (<= {bounds.chunked_mm}), angles "
            f"{gaps['tracked_joint_angles']:.3e} rad (<= {bounds.angle})")
    timers = PhaseTimers()
    sequence_eval.eval_sequence_known_streaming(
        tracker, stream_from_data(seq), chunk=EVAL_CHUNK, timers=timers)
    for line in timers.report().splitlines():
        log(f"[eval] PhaseTimers (chunk {EVAL_CHUNK}, default settings) {line} [{card}]")
    phase_profile(lambda: sequence_eval.eval_sequence_known(tracker, seq),
                  "one eval_sequence_known call", "warp_pool_kernel", card, top=8)
    return f32_known


def phase_eval_cpu_vs_card(models):
    """``eval_sequence_known`` and ``eval_sequence_unknown`` on one short
    rendered sequence, card against CPU, for each of ``models`` (name, the
    model on the CPU, the model on the card, bounds)."""
    import numpy as np
    from umetrack_torch.apps import sequence_eval
    from umetrack_torch.kinematics.hand import from_dict, load_generic_hand_dict
    from umetrack_torch.tracker import HandTracker
    from umetrack_torch.tracker.video import SequenceData

    labels, images, (rig, seq, hand) = rendered_sequence(8, 2_000_002, "cuda")
    seq = seq.to("cpu")
    data = SequenceData(
        images=images, T_world_from_camera=seq.T_world_from_camera.numpy(),
        gt_joint_angles=seq.gt_joint_angles.numpy(), gt_wrist_xfs=seq.gt_wrist_xfs.numpy(),
        gt_confidences=seq.gt_confidences.numpy(), rig=rig.to("cpu"), hand_model_mm=hand.to("cpu"),
        n_frames=len(images))
    generic = from_dict(load_generic_hand_dict())
    for name, model_cpu, model_card, bounds in models:
        arts = {}
        with tf32_off():
            for where, model, dev in (("card", model_card, "cuda"), ("cpu", model_cpu, "cpu")):
                tracker = HandTracker(model, device=dev)
                arts[where] = (sequence_eval.eval_sequence_known(tracker, data),
                               sequence_eval.eval_sequence_unknown(tracker, data, generic, 5))
        for head, a, b in zip(("eval_sequence_known", "eval_sequence_unknown"), arts["card"], arts["cpu"]):
            check(bool((a["valid_tracking"] == b["valid_tracking"]).all()), f"{head}: masks differ")
            v = a["valid_tracking"]
            check(bool(v.any() and not v.all()), f"{head}: valid {v.sum()}/{v.size}")
            da = float(np.abs(a["tracked_joint_angles"] - b["tracked_joint_angles"])[v].max())
            dk = float(np.abs(a["tracked_keypoints"] - b["tracked_keypoints"]).max())
            ds = float(abs(a["calibrated_scale"] - b["calibrated_scale"])) if "calibrated_scale" in a else 0.0
            check(da <= bounds.angle and dk <= bounds.mm and ds <= bounds.scale,
                  f"{name}, {head}: card vs CPU {da} rad, {dk} mm, scale {ds}")
            log(f"[cpu-vs-card] {name}, {head}, 8 rendered frames, TF32 off: masks equal, angles "
                f"{da:.3e} rad (<= {bounds.angle}), keypoints {dk:.3e} mm (<= {bounds.mm}), scale "
                f"{ds:.3e} (<= {bounds.scale})")


# ---- batched and sharded evaluation ------------------------------------------


def sequence_error_mm(lm_hand, hand, res, seq):
    """A tracked sequence's mean landmark error (mm) over its valid (frame,
    hand) slots, as ``eval_sequences_batched`` computes it per sequence:
    the tracked landmarks skinned with ``lm_hand``, GT with ``hand``."""
    import torch
    from umetrack_torch.tracker import sequence_landmarks

    tracked = sequence_landmarks(lm_hand, res.joint_angles, res.wrist_xfs)
    gt = sequence_landmarks(hand, seq.gt_joint_angles, seq.gt_wrist_xfs)
    err = torch.linalg.vector_norm(tracked - gt, dim=-1).mean(dim=-1)
    v = res.valid.to(err.dtype)
    return float((err * v).sum() / torch.clamp(v.sum(), min=1.0))


def phase_batched_eval(models, tally, rigs, seqs, hands, card):
    """``eval_sequences_batched`` (one ``warp_pool`` launch) and
    ``eval_sequences_unknown_batched`` (two: the calibration, the retrack)
    at S=64 x T=16 for each of ``models`` (name, model, bounds): their
    per-sequence errors and scales against per-sequence tracking of the
    first ``CALIBRATE_CHECKED`` sequences (TF32 off), then wall ms per call
    (median of 3 warmed calls), frames/s and peak memory.  Returns the
    seeded model's known-skeleton results."""
    import torch
    from umetrack_torch.kinematics.hand import from_dict, load_generic_hand_dict, scaled_hand_model
    from umetrack_torch.parallel.eval import (
        eval_sequences_batched, eval_sequences_unknown_batched, make_batched_state)
    from umetrack_torch.tracker import HandTracker
    from umetrack_torch.tracker.tracker import track_sequences_batched

    s, t = seqs.gt_confidences.shape[:2]
    generic = from_dict(load_generic_hand_dict(), device="cuda")
    first = None
    for name, model, bounds in models:
        tracker = HandTracker(model, device="cuda")
        config = tracker.config
        known = lambda: eval_sequences_batched(
            model, config, rigs, seqs, make_batched_state(model, s), hands)
        unknown = lambda: eval_sequences_unknown_batched(model, config, rigs, seqs, hands, generic)
        with tf32_off():
            per_seq, n_valid, mean = tally(known, 1, "eval_sequences_batched")
            per_u, n_valid_u, mean_u, scales = tally(unknown, 2, "eval_sequences_unknown_batched", scale=1)
            batched, _ = track_sequences_batched(model, config, rigs, seqs, make_batched_state(model, s), hands)
            gaps = [0.0] * 4  # rad, known mm, unknown mm, scale
            for i in range(CALIBRATE_CHECKED):
                rig, seq, hand = (tr.map(lambda a: a[i]) for tr in (rigs, seqs, hands))
                res, _ = tracker.track_sequence(rig, seq, hand)
                check(bool((res.valid == batched.valid[:, i]).all()), f"{name}: sequence {i}: valid masks")
                v = res.valid
                gaps[0] = max(gaps[0], float((res.joint_angles[v] - batched.joint_angles[:, i][v]).abs().max()))
                gaps[1] = max(gaps[1], abs(sequence_error_mm(hand, hand, res, seq) - float(per_seq[i])))
                calibrated = scaled_hand_model(generic, scales[i])
                res_u, _ = tracker.track_sequence(rig, seq, hand, skel_hand_model_mm=calibrated)
                err_u = sequence_error_mm(calibrated, hand, res_u, seq)
                gaps[2] = max(gaps[2], abs(err_u - float(per_u[i])))
                gaps[3] = max(gaps[3], abs(float(tracker.calibrate_sequence(rig, seq, hand)) - float(scales[i])))
        check(per_seq.shape == n_valid.shape == per_u.shape == scales.shape == (s,), "result shapes")
        check(bool(torch.isfinite(per_seq).all() & torch.isfinite(per_u).all() & (n_valid > 0).all()),
              f"{name}: non-finite errors or a sequence without a valid slot")
        check(bool(torch.equal(n_valid, n_valid_u)), f"{name}: valid slots differ between the protocols")
        check(gaps[0] <= bounds.angle and max(gaps[1], gaps[2]) <= bounds.mm and gaps[3] <= bounds.scale,
              f"{name}: batched against per-sequence: {gaps}")
        times = {}
        torch.cuda.reset_peak_memory_stats()
        for label, fn in (("known", known), ("unknown", unknown)):
            fn()
            times[label] = sorted(wall_ms(fn)[0] for _ in range(3))
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[batched-eval] {name}: eval_sequences_batched S={s} T={t} full ModelConfig() f32: one "
            f"warp_pool launch, global mean {float(mean):.2f} mm, {int((n_valid > 0).sum())}/{s} sequences "
            f"with a valid slot; eval_sequences_unknown_batched: two launches, scales "
            f"{float(scales.min()):.4f}..{float(scales.max()):.4f}, global mean {float(mean_u):.2f} mm; "
            f"the first {CALIBRATE_CHECKED} sequences tracked alone (TF32 off): angles {gaps[0]:.3e} rad "
            f"(<= {bounds.angle}), per-sequence error {gaps[1]:.3e} mm known, {gaps[2]:.3e} mm unknown "
            f"(<= {bounds.mm}), scales {gaps[3]:.3e} (<= {bounds.scale}) [{card}]")
        for label, ms in times.items():
            log(f"[batched-eval] {name}, {label} skeleton: {ms[1]:.1f} ms/call median of 3 "
                f"({', '.join(f'{m:.1f}' for m in ms)}), {s * t / ms[1] * 1e3:.1f} frames/s; peak mem of "
                f"both {peak:.2f} GiB [{card}]")
        if first is None:
            first = (per_seq, n_valid, mean)
    return first


def phase_process_group(model, tally, rigs, seqs, hands, unsharded, card):
    """A process group of one rank over NCCL (a localhost TCP store): the
    sharded eval equals the unsharded one bit for bit; one ``train_step``
    and one ``temporal_train_step`` with the synchronised BatchNorm branch
    equal the same steps without a group at tests/test_torch_train.py's
    bounds (TF32 off); then the group is left.  One card: no multi-GPU
    number is measured."""
    import socket

    import torch
    import torch.distributed as dist
    from umetrack_torch.models import ModelConfig, make_model
    from umetrack_torch.parallel import ClippedAdamW, create_train_state, distributed
    from umetrack_torch.parallel import make_mesh, shard_variables, temporal_train_step, train_step
    from umetrack_torch.parallel.eval import eval_sequences_batched, make_batched_state, shard_eval_inputs
    from umetrack_torch.tracker import TrackerConfig

    frame, window = small_train_batches("cuda")
    steps = (("train_step", train_step, frame), (f"temporal_train_step K={TRAIN_K}", temporal_train_step, window))

    def run_steps():
        out = {}
        with tf32_off():
            for label, step_fn, batch in steps:
                m = gate_weights(make_model(ModelConfig(**TRAIN_SMALL), device="cuda"))
                shard_variables(m, make_mesh())
                state = create_train_state(m, ClippedAdamW(m.parameters(), 1e-3, 1e-5))
                metrics = step_fn(state, batch)
                out[label] = ({k: float(v) for k, v in metrics.items()},
                              {n: p.grad.cpu() for n, p in m.named_parameters()},
                              {n: b.cpu() for n, b in m.named_buffers() if "running" in n})
        return out

    alone = run_steps()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    check(distributed.initialize(f"localhost:{port}", 1, 0) == (0, 1), "initialize")
    try:
        init_s = time.perf_counter() - t0
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        s = rigs.fx.shape[0]
        with tf32_off():
            sharded = tally(lambda: eval_sequences_batched(
                model, TrackerConfig(), *shard_eval_inputs(0, 1, rigs, seqs, make_batched_state(model, s),
                                                           hands)), 1, "sharded eval_sequences_batched")
        for a, b, what in zip(sharded, unsharded, ("per-sequence errors", "valid slots", "global mean")):
            check(bool(torch.equal(a, b)), f"sharded eval: {what} differ")
        grouped = run_steps()
    finally:
        distributed.finalize()
    check(not dist.is_initialized(), "the process group is still up")
    log(f"[process-group] one rank over NCCL (tcp://localhost store joined in {init_s:.2f} s; the "
        f"communicator is made at the first collective): the sharded "
        f"eval_sequences_batched S={s} equals the unsharded call bit for bit (one warp_pool launch) [{card}]")
    for label, *_ in steps:
        (m_g, g_g, s_g), (m_a, g_a, s_a) = grouped[label], alone[label]
        check(all(abs(m_g[k] - m_a[k]) <= LOSS_RTOL * abs(m_a[k]) + 1e-7 for k in m_a),
              f"{label}: metrics {m_g} against {m_a}")
        d_metric = max(abs(m_g[k] - m_a[k]) / abs(m_a[k]) for k in m_a if m_a[k])
        ordinary, first, noise = grad_gaps(g_g, g_a)
        d_stats = max(float(((s_g[k] - s_a[k]).abs() / (1 + s_a[k].abs())).max()) for k in s_a)
        check(d_stats <= STATS_TOL, f"{label}: running stats differ by {d_stats}")
        log(f"[process-group] {label}, small config (B={TRAIN_B}), synchronised BatchNorm against no group, "
            f"TF32 off: metrics within {d_metric:.3e} relative (<= {LOSS_RTOL}); gradient leaves within "
            f"{ordinary:.3e} relative L2 (<= {GRAD_REL_L2}), the first layers {first:.3e} "
            f"(<= {FIRST_LAYERS_REL_L2}), zero-gradient biases {noise:.3e} (<= {ZERO_GRAD_NOISE}); "
            f"running stats within {d_stats:.3e} (<= {STATS_TOL})")
    log(f"[process-group] the machine has {torch.cuda.device_count()} card(s): world size 1 only, no "
        f"multi-GPU number is measured [{card}]")


# ---- the tensor-parallel model axis ----------------------------------------


def tp_eval(model, mesh, rigs, seqs, hands, generic):
    """The two batched protocols of ``parallel/eval.py`` on this data
    index's block of the sequences, TF32 off: (known results, unknown
    results, warp_pool launches of each call, each counted from 0)."""
    from umetrack_torch.ops.warp_pool import warp_pool
    from umetrack_torch.parallel.eval import (
        eval_sequences_batched, eval_sequences_unknown_batched, make_batched_state, shard_eval_inputs)
    from umetrack_torch.tracker import TrackerConfig

    config = TrackerConfig()
    rigs, seqs, state, hands = shard_eval_inputs(mesh, rigs, seqs, make_batched_state(model, TP_S), hands)
    with tf32_off():
        warp_pool.launches = 0
        known = eval_sequences_batched(model, config, rigs, seqs, state, hands)
        known_launches = warp_pool.launches
        warp_pool.launches = 0
        unknown = eval_sequences_unknown_batched(model, config, rigs, seqs, hands, generic)
        unknown_launches = warp_pool.launches
    return ([x.cpu() for x in known], [x.cpu() for x in unknown], (known_launches, unknown_launches))


def tp_small_batches():
    """Batches built as tests/test_torch_tp.py builds them: TP_SMALL_B rows
    from seed TP_SMALL_SEED with its valid masks (the data indices hold
    different numbers of valid rows), on the card."""
    import dataclasses

    import numpy as np
    import torch

    frame, window = small_train_batches("cpu", TP_SMALL_B, TP_SMALL_SEED)
    valid_t = np.ones((TP_SMALL_B, TRAIN_K), bool)
    valid_t[1, 3] = valid_t[4] = valid_t[5, 2:] = False
    frame = dataclasses.replace(frame, valid=torch.tensor(TP_SMALL_VALID))
    window = dataclasses.replace(window, valid=torch.from_numpy(valid_t))
    return frame.to("cuda"), window.to("cuda")


def tp_steps(mesh, noise=None, configs=("full", "small"), cudnn=True, profile=False):
    """One ``train_step`` and one ``temporal_train_step`` at the full width
    of ``ModelConfig()`` on TP_B rows (``"full"``) and at TP_SMALL on
    :func:`tp_small_batches` (``"small"``), each on this data index's block,
    TF32 off: {(config, label): (metrics, gradients gathered whole, running
    stats, replicated parameters after the step, global norm, ms of a second
    step)}.  ``noise`` seeds a relative nudge of the images by 1e-7 (below
    f32 rounding): how far rounding alone moves the results.  ``cudnn=False``
    runs every convolution with PyTorch's own kernels instead of cuDNN's;
    ``profile`` adds the names of the device kernels of a third full-width
    ``train_step`` (torch.profiler)."""
    import dataclasses

    import torch
    from umetrack_torch.models import ModelConfig, make_model
    from umetrack_torch.parallel import ClippedAdamW, create_train_state, temporal_train_step, train_step
    from umetrack_torch.parallel.collectives import gather_blocks
    from umetrack_torch.parallel.mesh import shard_batch, shard_variables

    out = {}
    for config_label, config, make_batches in (("full", ModelConfig(), lambda: small_train_batches("cuda", TP_B)),
                                               ("small", ModelConfig(**TP_SMALL), tp_small_batches)):
        if config_label not in configs:
            continue
        frame, window = make_batches()
        if noise is not None:
            gen = torch.Generator(device="cuda").manual_seed(noise)

            def nudge(f):
                return dataclasses.replace(f, images=f.images * (1 + 1e-7 * torch.randn(
                    f.images.shape, generator=gen, device="cuda")))

            frame = dataclasses.replace(frame, frame=nudge(frame.frame))
            window = dataclasses.replace(window, frames=nudge(window.frames))
        for label, step_fn, batch in (("train_step", train_step, frame),
                                      (f"temporal_train_step K={TRAIN_K}", temporal_train_step, window)):
            model = gate_weights(make_model(config, device="cuda"))
            if mesh is not None:
                shard_variables(model, mesh)
                batch = shard_batch(batch, mesh)
            opt = ClippedAdamW(model.parameters(), 1e-3, 1e-5, mesh=mesh)
            state = create_train_state(model, opt)
            with tf32_off(), cudnn_enabled(cudnn):
                metrics = step_fn(state, batch)
                grads, replicated = {}, {}  # copies: the timed second step below moves the originals
                for name, p in model.named_parameters():
                    if getattr(p, "partition_dim", None) is not None:
                        grads[name] = gather_blocks(p.grad, 0, mesh.model_group).to("cpu", copy=True)
                    else:
                        grads[name] = p.grad.to("cpu", copy=True)
                        replicated[name] = p.detach().to("cpu", copy=True)
                stats = {n: b.to("cpu", copy=True) for n, b in model.named_buffers() if "running" in n}
                out[config_label, label] = dict(
                    metrics={k: float(v) for k, v in metrics.items()}, grads=grads, stats=stats,
                    replicated=replicated, norm=float(opt.global_norm),
                    ms=wall_ms(lambda: step_fn(state, batch))[0])
                if profile and (config_label, label) == ("full", "train_step"):
                    out[config_label, label]["kernels"] = {
                        name for _, _, name in profile_call(lambda: step_fn(state, batch))["rows"]}
    return out


def tp_app(mesh, out_dir):
    """``apps/train.py::main`` in this process group with ``{"mesh":
    {"model_axis": 2}}``, TP_APP_STEPS steps on synthetic 120 x 160 batches
    (``warp_image_full`` counted from 0 around the call); then the trained
    model's eval-mode forward (TF32 off), which rank 0 holds against the
    orbax directory ``final`` reloaded into one unsharded model, and the
    gathered weights against the reloaded ones."""
    import torch
    import torch.distributed as dist
    from umetrack_torch.apps import train as app
    from umetrack_torch.config import Config, MeshConfig, to_json
    from umetrack_torch.models import ModelConfig, TemporalState, UmeTrackNet
    from umetrack_torch.ops.warp_image import warp_image_full
    from umetrack_torch.parallel.mesh import full_state_dict
    from umetrack_torch.utils.checkpoints import load_checkpoint

    cfg_path, ckpts = os.path.join(out_dir, "tp_app.json"), os.path.join(out_dir, "ckpts")
    if mesh.rank == 0:
        to_json(Config(mesh=MeshConfig(model_axis=TP_MODEL)), cfg_path)
    dist.barrier()
    warp_image_full.launches = 0
    t_app, (state, hist) = wall_ms(lambda: app.main([
        "--config", cfg_path, "--synthetic", "--steps", str(TP_APP_STEPS), "--batch-size", str(TP_APP_BATCH),
        "--window", str(TP_APP_WINDOW), "--checkpoint-dir", ckpts]))
    full_launches = warp_image_full.launches
    check(full_launches == TP_APP_STEPS,
          f"tp train app: {full_launches} warp_image_full launches in {TP_APP_STEPS} batches")
    check(all(math.isfinite(v) for v in hist), f"tp train app: loss {hist}")
    trained = state.model.eval()
    batch = next(app.synthetic_batches(4, (96, 96), device="cuda"))
    keys = ("joint_angles", "wrist_xfs", "landmark_uncertainty_sigmas")

    def forward(model):
        with tf32_off(), torch.no_grad():
            zero = TemporalState.zeros(4, model.config, device="cuda")
            out, _ = model.known_skeleton(batch.frame, batch.skeleton, zero)
        return [getattr(out, k) for k in keys]

    sharded = forward(trained)
    gathered = full_state_dict(trained, trained.mesh)
    result = dict(hist=hist, ms=t_app, full_launches=full_launches, mesh=trained.mesh.shape)
    if mesh.rank == 0:
        check(os.listdir(ckpts) == ["final"], f"tp train app: checkpoints {os.listdir(ckpts)}")
        loaded = load_checkpoint(os.path.join(ckpts, "final"))
        check(all(torch.equal(v.cuda(), gathered[k].to(v.dtype)) for k, v in loaded.items()),
              "tp train app: the orbax directory differs from the gathered weights")
        alone = UmeTrackNet(ModelConfig())
        alone.load_state_dict(loaded)
        result["forward_gap"] = max(float((a - b).abs().max()) for a, b in zip(sharded, forward(alone.cuda().eval())))
    return result


def tp_crops():
    """The checkpoint's same-crops inputs, prepared once here with no
    group: the crop sets and crop images of the ``[tp]`` sequences
    (``_prepare_sequences_merged``, leaves ``[T, 2S, ...]``), their skeleton
    rows and hand indices, on the CPU for the workers.  Returns (those
    crops, the sequences, their hand models)."""
    import torch
    from umetrack_torch.tracker import TrackerConfig
    from umetrack_torch.tracker import tracker as T
    from umetrack_torch.utils.synthetic import make_sequences

    rigs, seqs, hands = make_sequences(TP_S, TP_T, seed=TP_SEED, device="cuda")
    with torch.inference_mode():
        crop_sets, crop_images = T._prepare_sequences_merged(TrackerConfig(), rigs, seqs, hands, 1, "kernel")
    cpu = lambda a: a.to("cpu", copy=True)  # noqa: E731
    crops = dict(crop_sets=crop_sets.map(cpu), crop_images=cpu(crop_images),
                 skeleton=T._skeleton_inputs(hands, repeat=2).map(cpu), hand_idx=torch.arange(2).repeat(TP_S))
    return crops, seqs, hands


def tp_scan(model, crops, rows=slice(None)):
    """``_model_scan`` of ``model`` on the hand rows ``rows`` of the crops
    :func:`tp_crops` saved, from a zero state, TF32 off: (angles, wrists
    mm, valid), leaves ``[T, rows, ...]`` on the CPU."""
    import torch
    from umetrack_torch.tracker import TrackerConfig
    from umetrack_torch.tracker import tracker as T
    from umetrack_torch.tracker.types import TrackState

    crop_sets = crops["crop_sets"].map(lambda a: a[:, rows].cuda())
    images = crops["crop_images"][:, rows].cuda()
    skeleton = crops["skeleton"].map(lambda a: a[rows].cuda())
    state = TrackState.init(model.config, images.shape[1], device="cuda")
    with tf32_off(), torch.inference_mode():
        res, _ = T._model_scan(model, TrackerConfig(), crop_sets, images, state, skeleton,
                               crops["hand_idx"][rows].cuda())
    return [res.joint_angles.cpu(), res.wrist_xfs.cpu(), res.valid.cpu()]


def scan_sequence_errors(scan, first, seqs, hands):
    """Per-sequence mean landmark errors (mm, as ``eval_sequences_batched``
    computes them) and tracked landmarks of a :func:`tp_scan` result whose
    rows start at sequence ``first``."""
    import types

    import torch
    from umetrack_torch.tracker import sequence_landmarks

    angles, wrists, valid = scan
    errors, landmarks = [], []
    for j in range(angles.shape[1] // 2):
        i, rows = first + j, slice(2 * j, 2 * j + 2)
        hand, seq = hands.map(lambda a: a[i]), seqs.map(lambda a: a[i])
        res = types.SimpleNamespace(joint_angles=angles[:, rows].cuda(), wrist_xfs=wrists[:, rows].cuda(),
                                    valid=valid[:, rows].cuda())
        errors.append(sequence_error_mm(hand, hand, res, seq))
        landmarks.append(sequence_landmarks(hand, res.joint_angles, res.wrist_xfs).cpu())
    return torch.tensor(errors, dtype=torch.float64), torch.stack(landmarks)


def tp_worker(rank, world, port, out_dir, model_axis=TP_MODEL, crops_path=""):
    """One rank of a ``[tp]`` group: ``world`` processes on card 0 joined
    over gloo (CUDA tensors), a (world / model_axis, model_axis) mesh.  With
    the model axis: runs ``tp_eval`` with seeded weights and the checkpoint,
    the checkpoint's ``_model_scan`` on its data block of the crops at
    ``crops_path`` (:func:`tp_scan`), ``tp_steps``, ``tp_app`` (and in a
    world of 2, the full-width steps again with cuDNN off, and
    ``model_axis`` 0).  With ``model_axis`` 1 (data only): the
    full-width ``tp_steps`` alone, in a world of 1 also with the images
    nudged, and both again with cuDNN off.  Writes its results to
    ``out_dir/rank{rank}.pt``."""
    import torch
    import torch.distributed as dist
    from umetrack_torch.kinematics.hand import from_dict, load_generic_hand_dict
    from umetrack_torch.models import ModelConfig, make_model
    from umetrack_torch.parallel import distributed
    from umetrack_torch.parallel.mesh import block, make_mesh, shard_variables
    from umetrack_torch.utils.checkpoints import load_checkpoint
    from umetrack_torch.utils.synthetic import make_sequences

    rank, world, port, model_axis = int(rank), int(world), int(port), int(model_axis)
    torch.cuda.set_device(0)
    distributed.initialize(f"localhost:{port}", world, rank, backend="gloo", device="cuda")
    try:
        check(dist.get_backend() == "gloo", f"backend {dist.get_backend()}")
        mesh = make_mesh(model_axis=model_axis)
        res = {"mesh": (mesh.shape, mesh.data_index, mesh.model_index)}
        if model_axis == 1:
            res["steps"] = tp_steps(mesh, configs=("full",), profile=world == 1)
            if world == 1:
                res["nudged"] = tp_steps(mesh, noise=1, configs=("full",))
                res["steps_cudnn_off"] = tp_steps(mesh, configs=("full",), cudnn=False)
                res["nudged_cudnn_off"] = tp_steps(mesh, noise=1, configs=("full",), cudnn=False)
            torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
            return 0
        if world == 2:
            res["auto"] = make_mesh(model_axis=0).shape
        rigs, seqs, hands = make_sequences(TP_S, TP_T, seed=TP_SEED, device="cuda")
        generic = from_dict(load_generic_hand_dict(), device="cuda")
        res["eval"] = {}
        for label, weights in (("seeded weights", None), ("checkpoint", load_checkpoint(CHECKPOINT))):
            model = gate_weights(make_model(ModelConfig(), device="cuda"))
            if weights is not None:
                model.load_state_dict(weights)
            shard_variables(model, mesh)
            res["eval"][label] = tp_eval(model, mesh, rigs, seqs, hands, generic)
            if weights is None:  # the times: PyTorch's defaults (TF32), as every f32 number
                from umetrack_torch.parallel.eval import eval_sequences_batched, make_batched_state
                from umetrack_torch.parallel.eval import shard_eval_inputs
                from umetrack_torch.tracker import TrackerConfig

                parts = shard_eval_inputs(mesh, rigs, seqs, make_batched_state(model, TP_S), hands)
                call = lambda: eval_sequences_batched(model, TrackerConfig(), *parts)  # noqa: E731
                res["eval_ms"] = median_ms(call, 3, warmup=1)
                res["eval_profile"] = {k: v for k, v in profile_call(call).items() if k != "rows"}
            else:  # the same crops for every rank: this data index's rows
                rows = block(2 * TP_S, mesh)
                res["same_crops"] = (rows.start // 2, tp_scan(model, torch.load(crops_path, weights_only=False),
                                                              rows))
            del model
        res["steps"] = tp_steps(mesh, profile=world == 2)
        if world == 2:
            res["steps_cudnn_off"] = tp_steps(mesh, configs=("full",), cudnn=False)
        res["app"] = tp_app(mesh, out_dir)
    finally:
        distributed.finalize()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    return 0


def tp_references(ckpt_cuda):
    """The same calls with no process group on the card: the two protocols
    with each model, and the two train steps."""
    from umetrack_torch.kinematics.hand import from_dict, load_generic_hand_dict
    from umetrack_torch.models import ModelConfig, make_model
    from umetrack_torch.parallel.eval import eval_sequences_batched, make_batched_state
    from umetrack_torch.parallel.mesh import make_mesh
    from umetrack_torch.tracker import TrackerConfig
    from umetrack_torch.utils.synthetic import make_sequences

    rigs, seqs, hands = make_sequences(TP_S, TP_T, seed=TP_SEED, device="cuda")
    generic = from_dict(load_generic_hand_dict(), device="cuda")
    evals = {label: tp_eval(model, make_mesh(), rigs, seqs, hands, generic)
             for label, model in (("seeded weights", gate_weights(make_model(ModelConfig(), device="cuda"))),
                                  ("checkpoint", ckpt_cuda))}
    seeded = gate_weights(make_model(ModelConfig(), device="cuda"))
    call = lambda: eval_sequences_batched(  # noqa: E731
        seeded, TrackerConfig(), rigs, seqs, make_batched_state(seeded, TP_S), hands)
    return dict(eval=evals, steps=tp_steps(None), eval_ms=median_ms(call, 3, warmup=1),
                eval_profile=profile_call(call))


def run_tp_group(world, model_axis=TP_MODEL, crops=None):
    """``world`` worker processes of this script on card 0 (``--tp-worker``)
    in a temporary folder, each given TP_TIMEOUT_S, with ``crops`` (from
    :func:`tp_crops`) saved there for them; any failure or time-out stops
    them all and fails the phase.  Returns the ranks' results and the wall
    seconds."""
    import socket

    import torch

    with tempfile.TemporaryDirectory(prefix=f"umetrack_tp{world}_") as out:
        crops_path = ""
        if crops is not None:
            crops_path = os.path.join(out, "crops.pt")
            torch.save(crops, crops_path)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        logs = [open(os.path.join(out, f"rank{r}.log"), "w+") for r in range(world)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-worker", str(r), str(world),
                                   str(port), out, str(model_axis), crops_path], cwd=HERE, stdout=logs[r],
                                  stderr=subprocess.STDOUT)
                 for r in range(world)]
        try:
            deadline = time.monotonic() + TP_TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall_s = time.perf_counter() - t0
        for r, (p, fp) in enumerate(zip(procs, logs)):
            fp.seek(0)
            tail = fp.read()[-3000:]
            fp.close()
            check(p.returncode == 0, f"[tp] world {world}: rank {r} exited {p.returncode}:\n{tail}")
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(world)], wall_s


def relative_l2(got, want):
    return float((got - want).norm() / want.norm())


def phase_tp(ckpt_cuda, card):
    """``[tp]``: the tensor-parallel model axis on the card.  Groups of 2
    (data 1 x model 2) and 4 (data 2 x model 2) processes share card 0 over
    gloo; each rank runs the batched eval at S x T = TP_S x TP_T (seeded
    weights and the checkpoint), the checkpoint's ``_model_scan`` on its
    rows of crops prepared once here (the same crops), the two train steps
    at TP_B rows and the train app with ``{"mesh": {"model_axis": 2}}``; all
    held against the same calls here with no group, except the full-width
    gradients: those are held leaf by leaf against the same steps in a
    group of one (the same BatchNorm), at TP_FLOOR_FACTOR x the floors that
    TP_GATES names, each measured against that step with the same cuDNN
    setting: what a nudge of the images moves in the group of one, and what
    a data-only group of 2 (data 2 x model 1) moves.  Returns the launches
    by path."""
    refs = tp_references(ckpt_cuda)
    crops, crop_seqs, crop_hands = tp_crops()
    same_ref = tp_scan(ckpt_cuda, crops)
    ref_errors, ref_landmarks = scan_sequence_errors(same_ref, 0, crop_seqs, crop_hands)

    # the reference of the full-width gradients and their floors, leaf by
    # leaf: the steps in a group of one, with the images nudged by 1e-7 there,
    # and with the rows split over two data ranks with no model axis
    (one,), one_s = run_tp_group(1, model_axis=1)
    data_only, data_only_s = run_tp_group(2, model_axis=1)
    check(one["mesh"] == ({"data": 1, "model": 1}, 0, 0), f"[tp] group of one: mesh {one['mesh']}")
    for r, res in enumerate(data_only):
        check(res["mesh"] == ({"data": 2, "model": 1}, r, 0), f"[tp] data-only rank {r}: mesh {res['mesh']}")

    def gaps_from(runs, key, want):  # leaf -> relative L2 gap (the worst over ``runs``), and the norm's
        out = {k: max(relative_l2(run[key]["grads"][k], g) for run in runs)
               for k, g in want["grads"].items() if k not in ZERO_GRAD_LEAVES}
        out["norm"] = max(abs(run[key]["norm"] - want["norm"]) for run in runs) / want["norm"]
        return out

    def worst(gaps):
        return f"{max(v for k, v in gaps.items() if k != 'norm'):.3e} / {gaps['norm']:.3e}"

    full_keys = [key for key in refs["steps"] if key[0] == "full"]
    reference = {True: one["steps"], False: one["steps_cudnn_off"]}  # by cuDNN on
    floors = {(name, cudnn): {key: gaps_from(runs, key, reference[cudnn][key]) for key in full_keys}
              for name, cudnn, runs in (("images nudged", True, [one["nudged"]]),
                                        ("images nudged", False, [one["nudged_cudnn_off"]]),
                                        ("another order", False, [one["steps"]]),
                                        ("data split", True, [res["steps"] for res in data_only]))}
    log(f"[tp] the full-width gradients' reference: the same steps in a group of one (data 1 x model 1, "
        f"{one_s:.1f} s with start-up), TF32 off; against no group (the two-pass variance in BatchNorm "
        f"against the group's one-pass one; worst gradient leaf / global norm): " + "; ".join(
            f"{key[1]} {worst(gaps_from([one['steps']], key, refs['steps'][key]))}" for key in full_keys)
        + "; the floors against the group of one with the same cuDNN setting (the data split from a data-only "
        f"group of 2, data 2 x model 1, {data_only_s:.1f} s with start-up): " + "; ".join(
            f"{key[1]}: " + ", ".join(f"{name} (cuDNN {'on' if cudnn else 'off'}) {worst(floor[key])}"
                                      for (name, cudnn), floor in floors.items()) for key in full_keys)
        + f" [{card}]")

    by_path = {}

    def gate_full(world, r, label, key, steps, cudnn):
        """One rank's full-width gradients against the group of one with the
        same cuDNN setting: every leaf and the norm within TP_FLOOR_FACTOR x
        the larger of the floors TP_GATES names for this split, else the
        phase fails; printed only where TP_GATES names none."""
        names = TP_GATES[world, cudnn]
        leaf_gaps = gaps_from([steps], key, reference[cudnn][key])
        ratios = {k: v / max(max(floors[n, cudnn][key][k] for n in names or ("images nudged",)), 1e-30)
                  for k, v in leaf_gaps.items()}
        over = dict(sorted(((k, v) for k, v in ratios.items() if v > TP_FLOOR_FACTOR), key=lambda kv: -kv[1]))
        check(names is None or not over,
              f"[tp] world {world} rank {r} full {label}, cuDNN {'on' if cudnn else 'off'}: {len(over)} of "
              f"{len(ratios)} gradient leaves and norm past {TP_FLOOR_FACTOR} x their floor "
              f"({' and '.join(names or ())}), the worst {dict(list(over.items())[:5])}")
        top = sorted(ratios.items(), key=lambda kv: -kv[1])[:3]
        nudge = floors["images nudged", cudnn][key]
        alone = sorted((k for k, v in leaf_gaps.items() if v > TP_FLOOR_FACTOR * nudge[k]),
                       key=lambda k: -leaf_gaps[k] / nudge[k])
        bound = (f"<= {TP_FLOOR_FACTOR} x the larger of {' and '.join(names)}" if names else
                 f"NOT GATED (TP_GATES), {len(over)} of {len(ratios)} past {TP_FLOOR_FACTOR} x images nudged")
        if names and len(names) > 1:
            bound += (f"; past {TP_FLOOR_FACTOR} x images nudged alone: {len(alone)} "
                      f"({', '.join(f'{k} {leaf_gaps[k] / nudge[k]:.2f}' for k in alone[:8])})")
        return (f"cuDNN {'on' if cudnn else 'off'}: gradient leaves and the global norm within "
                f"{max(ratios.values()):.2f} x their floor ({bound}), the highest "
                f"{', '.join(f'{k} {v:.2f}' for k, v in top)}, the worst leaf / norm {worst(leaf_gaps)}")

    for world in TP_WORLDS:
        ranks, wall_s = run_tp_group(world, crops=crops)
        data = world // TP_MODEL
        for r, res in enumerate(ranks):
            check(res["mesh"] == ({"data": data, "model": TP_MODEL}, r // TP_MODEL, r % TP_MODEL),
                  f"[tp] world {world} rank {r}: mesh {res['mesh']}")
            check(res["app"]["mesh"] == {"data": data, "model": TP_MODEL}, f"app mesh {res['app']['mesh']}")
        if world == 2:
            check(all(res["auto"] == {"data": 1, "model": 2} for res in ranks), "model_axis 0: not model 2")
        gaps = {}
        for label, (known, unknown, _) in refs["eval"].items():
            # the checkpoint on a data split: each rank fits the crops of half the sequences, and
            # trained weights amplify the crop fit's f32 rounding between differently batched calls
            # (TRAINED); on the same crops it is held to the strict bounds below
            mm, rtol = (TRAINED.mm, 0.0) if label == "checkpoint" and data > 1 else (TP_EVAL_MM, TP_EVAL_RTOL)
            gap = [0.0, 0.0, 0.0, mm, rtol]  # known mm, unknown mm, scale, the bounds
            for res in ranks:
                k, u, launches = res["eval"][label]
                check(launches == (1, 2), f"[tp] {label}: warp_pool launches {launches}, expected (1, 2)")
                for got, want, slot, what in ((k, known, 0, "known"), (u, unknown, 1, "unknown")):
                    check(bool((got[1] == want[1]).all()), f"[tp] {label}: valid slots differ")
                    d = float((got[0] - want[0]).abs().max())
                    check(bool(((got[0] - want[0]).abs() <= mm + rtol * want[0].abs()).all())
                          and abs(float(got[2]) - float(want[2])) <= mm + rtol * abs(float(want[2])),
                          f"[tp] world {world} {label} {what}: per-sequence error {got[0]} against {want[0]}")
                    gap[slot] = max(gap[slot], d)
                d_scale = float((u[3] - unknown[3]).abs().max())
                check(d_scale <= SCALE_TOL, f"[tp] world {world} {label}: scales differ by {d_scale}")
                gap[2] = max(gap[2], d_scale)
            gaps[label] = gap
        # the checkpoint's scan on the SAME crops: each rank its data block's rows
        same_err = same_lm = 0.0
        for r, res in enumerate(ranks):
            first, scan = res["same_crops"]
            errors, landmarks = scan_sequence_errors(scan, first, crop_seqs, crop_hands)
            want = ref_errors[first:first + len(errors)]
            rows = slice(2 * first, 2 * first + scan[0].shape[1])
            check(bool((scan[2] == same_ref[2][:, rows]).all()), f"[tp] world {world} same crops: valid differs")
            d = (errors - want).abs()
            same_err = max(same_err, float(d.max()))
            same_lm = max(same_lm, float((landmarks - ref_landmarks[first:first + len(errors)]).abs().max()))
            check(bool((d <= TP_EVAL_MM + TP_EVAL_RTOL * want.abs()).all()),
                  f"[tp] world {world} rank {r} checkpoint on the same crops: per-sequence error {errors} "
                  f"against {want}")
        pool = sum(sum(res["eval"][label][2]) for res in ranks for label in refs["eval"])
        by_path[f"tp world {world} batched eval"] = pool
        step_text = []
        for (config_label, label), want in refs["steps"].items():
            for r, res in enumerate(ranks):
                got = res["steps"][config_label, label]
                check(all(abs(got["metrics"][k] - want["metrics"][k]) <= LOSS_RTOL * abs(want["metrics"][k]) + 1e-7
                          for k in want["metrics"]), f"[tp] {config_label} {label}: metrics {got['metrics']} "
                                                     f"against {want['metrics']}")
                d_stats = max(float(((got["stats"][k] - want["stats"][k]).abs() / (1 + want["stats"][k].abs())).max())
                              for k in want["stats"])
                check(d_stats <= STATS_TOL, f"[tp] {config_label} {label}: running stats differ by {d_stats}")
                partner = ranks[r ^ 1]["steps"][config_label, label]["replicated"]  # same data index
                check(all(bool((v == partner[k]).all()) for k, v in got["replicated"].items()),
                      f"[tp] {config_label} {label}: replicated parameters differ across the model ranks")
                d_norm = abs(got["norm"] - want["norm"]) / want["norm"]
                if config_label == "small":
                    ordinary, first, noise = grad_gaps(got["grads"], want["grads"])
                    check(d_norm <= TP_NORM_RTOL, f"[tp] {label}: global norm {got['norm']} against {want['norm']}")
                    gap = (f"gradient leaves within {ordinary:.3e} relative L2 (<= {GRAD_REL_L2}), the first layers "
                           f"{first:.3e} (<= {FIRST_LAYERS_REL_L2}), zero-gradient biases {noise:.3e} "
                           f"(<= {ZERO_GRAD_NOISE}), global norm {d_norm:.3e} (<= {TP_NORM_RTOL})")
                    continue
                # ill-conditioned at full width: each leaf and the norm against the group of one,
                # at TP_FLOOR_FACTOR x the larger of the floors TP_GATES names for this split
                gap = "; ".join(gate_full(world, r, label, (config_label, label), res[steps], cudnn)
                                for steps, cudnn in (("steps", True), ("steps_cudnn_off", False)) if steps in res)
            step_text.append(
                f"{config_label} {label}: metrics and running stats ({d_stats:.3e}) within phase 9's bounds, {gap}, "
                f"{max(res['steps'][config_label, label]['ms'] for res in ranks):.1f} ms a step (no group: "
                f"{want['ms']:.1f})")
        app_res = ranks[0]["app"]
        check(app_res["forward_gap"] <= TP_FORWARD_TOL, f"[tp] the reloaded checkpoint's forward: {app_res['forward_gap']}")
        by_path[f"tp world {world} train app"] = sum(res["app"]["full_launches"] for res in ranks)
        host = max(res["eval_ms"] for res in ranks)
        device = max(res["eval_profile"]["device_ms"] for res in ranks)
        log(f"[tp] world {world} = data {data} x model {TP_MODEL}: {world} processes sharing one H100 over gloo "
            f"(TIMES ARE NOT A TENSOR-PARALLEL SPEED), the group's run {wall_s:.1f} s with start-up; "
            f"eval_sequences_batched S={TP_S} x T={TP_T}, full ModelConfig() f32 (TF32): wall {host:.1f} ms a "
            f"call (slowest rank, CUDA events, median of 3), device {device:.1f} ms (slowest rank, "
            f"torch.profiler), {max(res['eval_profile']['launches'] for res in ranks)} kernel launches a rank; "
            f"no group: wall {refs['eval_ms']:.1f} ms, device {refs['eval_profile']['device_ms']:.1f} ms [{card}]")
        for label, (dk, du, ds, mm, rtol) in gaps.items():
            log(f"[tp] world {world} {label}, TF32 off: eval_sequences_batched per-sequence error within "
                f"{dk:.3e} mm of the call with no group, eval_sequences_unknown_batched {du:.3e} mm, scales "
                f"{ds:.3e} (bounds {rtol} relative + {mm} mm, scale {SCALE_TOL}); warp_pool 1 + 2 launches on "
                f"each rank")
        log(f"[tp] world {world} checkpoint on the SAME crops (prepared once with no group; each rank's "
            f"_model_scan on its data block's rows), TF32 off: per-sequence error within {same_err:.3e} mm of "
            f"the scan with no group (bounds {TP_EVAL_RTOL} relative + {TP_EVAL_MM} mm), landmarks within "
            f"{same_lm:.3e} mm")
        log(f"[tp] world {world}, TF32 off, against no group (full: ModelConfig() on B={TP_B} rows; small: "
            f"TP_SMALL on tests/test_torch_tp.py's B={TP_SMALL_B} rows): " + "; ".join(step_text)
            + "; replicated parameters equal bit for bit across the model ranks")
        if world == 2:  # what TP_GATES leaves ungated: the kernels of one full-width train_step
            mine = ranks[0]["steps"]["full", "train_step"]["kernels"]
            base = one["steps"]["full", "train_step"]["kernels"]
            log(f"[tp] world 2 rank 0 full train_step, TF32 off, cuDNN on (torch.profiler): {len(mine)} device "
                f"kernels, the group of one {len(base)}; only in world 2: {sorted(k[:110] for k in mine - base)}; "
                f"only in the group of one: {sorted(k[:110] for k in base - mine)}")
        log(f"[tp] world {world} train app main {{\"mesh\": {{\"model_axis\": 2}}}} --synthetic --steps "
            f"{TP_APP_STEPS} --batch-size {TP_APP_BATCH} --window {TP_APP_WINDOW}: "
            f"{max(res['app']['ms'] for res in ranks) / 1e3:.1f} s with start-up, loss {app_res['hist']}, "
            f"one warp_image_full launch a batch on each rank; the orbax final equals the gathered weights "
            f"and reloads unsharded to the forward within {app_res['forward_gap']:.3e} (TF32 off) [{card}]")
    return by_path


# ---- the training slice ------------------------------------------------------


def gate_weights(model):
    """``model`` with the weights the seeded-weights gates were measured
    on (see GATE_WEIGHTS_SEED): drawn on the CPU from a generator
    seeded GATE_WEIGHTS_SEED, U(+-1/sqrt(fan_in)) conv and dense weights and
    biases, BN scale 1 and bias 0, running mean N(0, 0.1^2) and var 1 +
    U(0, 1).  Test data, not an initialisation: the port draws flax's."""
    import torch

    g = torch.Generator().manual_seed(GATE_WEIGHTS_SEED)

    def uniform(shape, bound):
        return (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                bound = m.weight[0].numel() ** -0.5
                m.weight.copy_(uniform(m.weight.shape, bound))
                if m.bias is not None:
                    m.bias.copy_(uniform(m.bias.shape, bound))
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(1.0 + torch.rand(m.running_var.shape, generator=g))
    return model


def small_train_batches(device, b=TRAIN_B, seed=0):
    """The CPU tests' batches at their small config: one single-frame
    batch and one K-frame window made from K single-frame draws (the rows
    keep their hand, the crop cameras drift by 1 cm a frame), built on the
    CPU and moved to ``device``; ``b`` rows, drawn from ``seed`` (the
    window from ``seed + 10 + k``)."""
    import torch
    from umetrack_torch.kinematics.hand import from_dict, load_generic_hand_dict
    from umetrack_torch.models import FrameInputs
    from umetrack_torch.parallel.train import TemporalTrainBatch, synthetic_train_batch

    hand = from_dict(load_generic_hand_dict())
    frame = synthetic_train_batch(seed, b, hand, device="cpu")
    draws = [synthetic_train_batch(seed + 10 + k, b, hand, device="cpu") for k in range(TRAIN_K)]
    f0 = draws[0].frame
    extr = f0.extrinsics[:, None].repeat(1, TRAIN_K, 1, 1, 1)
    extr[..., :3, 3] += 0.01 * torch.arange(TRAIN_K, dtype=torch.float32)[None, :, None, None]
    window = TemporalTrainBatch(
        frames=FrameInputs(
            images=torch.stack([d.frame.images for d in draws], dim=1),
            intrinsics=f0.intrinsics[:, None].repeat(1, TRAIN_K, 1, 1, 1),
            extrinsics=extr,
            n_views=f0.n_views[:, None].repeat(1, TRAIN_K),
            hand_idx=f0.hand_idx[:, None].repeat(1, TRAIN_K),
            use_memory=(torch.arange(TRAIN_K) > 0).expand(b, TRAIN_K).contiguous(),
        ),
        skeleton=draws[0].skeleton,
        gt_joint_angles=torch.stack([d.gt_joint_angles for d in draws], dim=1),
        gt_wrist_world=torch.stack([d.gt_wrist_world for d in draws], dim=1),
        hand=draws[0].hand, gt_scales=draws[0].gt_scales,
    )
    return frame.to(device), window.to(device)


def grad_gaps(grads, want):
    """(worst relative L2 gap over the ordinary leaves, over the first
    layers, worst zero-gradient leaf's norm over the whole gradient's) of
    ``grads`` against ``want``, both {name: tensor} on the CPU; each held to
    the bounds of tests/test_torch_train.py."""
    import torch

    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in want.values())))
    ordinary = first = noise = 0.0
    for name, g in grads.items():
        w = want[name]
        if name in ZERO_GRAD_LEAVES:
            noise = max(noise, float(max(g.norm(), w.norm())) / total)
            continue
        rel = float((g - w).norm() / w.norm())
        if name.startswith(FIRST_LAYERS):
            first = max(first, rel)
        else:
            ordinary = max(ordinary, rel)
    check(ordinary <= GRAD_REL_L2 and first <= FIRST_LAYERS_REL_L2 and noise <= ZERO_GRAD_NOISE,
          f"gradient gaps {ordinary}, first layers {first}, zero-gradient leaves {noise}")
    return ordinary, first, noise


def phase_train_cpu_vs_card():
    """One ``train_step`` and one ``temporal_train_step`` (K=4) on the card
    against the CPU from the same seeded weights and batch, TF32 off: the
    loss, every metric, every gradient leaf and the BatchNorm running stats
    after the step, at the CPU tests' small config and bounds."""
    import torch
    from umetrack_torch.models import ModelConfig, make_model
    from umetrack_torch.parallel import ClippedAdamW, create_train_state, temporal_train_step, train_step

    frame, window = small_train_batches("cpu")
    for label, step_fn, batch in (("train_step", train_step, frame),
                                  (f"temporal_train_step K={TRAIN_K}", temporal_train_step, window)):
        out = {}
        with tf32_off():
            for dev in ("cpu", "cuda"):
                model = gate_weights(make_model(ModelConfig(**TRAIN_SMALL), device=dev))
                state = create_train_state(model, ClippedAdamW(model.parameters(), 1e-3, 1e-5))
                metrics = step_fn(state, batch.to(dev))
                out[dev] = ({k: float(v) for k, v in metrics.items()},
                            {n: p.grad.cpu() for n, p in model.named_parameters()},
                            {n: b.cpu() for n, b in model.named_buffers() if "running" in n})
        (m_gpu, g_gpu, s_gpu), (m_cpu, g_cpu, s_cpu) = out["cuda"], out["cpu"]
        check(all(math.isfinite(v) for v in m_gpu.values()), f"{label}: non-finite metrics {m_gpu}")
        check(all(abs(m_gpu[k] - m_cpu[k]) <= LOSS_RTOL * abs(m_cpu[k]) + 1e-7 for k in m_cpu),
              f"{label}: metrics {m_gpu} against {m_cpu}")
        d_metric = max(abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu if m_cpu[k])
        ordinary, first, noise = grad_gaps(g_gpu, g_cpu)
        d_stats = max(float(((s_gpu[k] - s_cpu[k]).abs() / (1 + s_cpu[k].abs())).max()) for k in s_cpu)
        check(d_stats <= STATS_TOL, f"{label}: running stats differ by {d_stats}")
        log(f"[train-cpu-vs-card] {label}, small config (B={TRAIN_B}), TF32 off: loss {m_gpu['loss']:.6f}, "
            f"metrics within {d_metric:.3e} relative (<= {LOSS_RTOL}); gradient leaves within "
            f"{ordinary:.3e} relative L2 (<= {GRAD_REL_L2}), the first layers within {first:.3e} "
            f"(<= {FIRST_LAYERS_REL_L2}), the zero-gradient biases' noise {noise:.3e} of the gradient's "
            f"norm (<= {ZERO_GRAD_NOISE}); BatchNorm running stats within {d_stats:.3e} (<= {STATS_TOL})")


def resident_captures(since=None):
    """The compiled steps' captures so far, or (``since`` given) those made
    since then, checked to be one training and one eval graph: the window
    start is a device input, so every step of a loop replays one graph."""
    from umetrack_torch.tracker import compiled

    now = dict(compiled.CAPTURES)
    if since is None:
        return now
    made = {k: n - since.get(k, 0) for k, n in now.items() if n != since.get(k, 0)}
    check(made == {"_resident_update": 1, "_eval_mpjpe": 1}, f"captures over the resident loop: {made}")
    return made


def resident_window_checks(model, corpus, card):
    """``resident_eval_mpjpe`` and ``resident_diagnose`` (both BatchNorm
    modes) at two window starts each: one graph a key (the eval's made by
    the training loop), the replays equal to the eager calls bit for bit."""
    import torch
    from umetrack_torch.parallel import resident
    from umetrack_torch.tracker import compiled

    idx = torch.arange(16, device="cuda") % RES_SEQS
    before = dict(compiled.CAPTURES)
    starts = (0, RES_T - 8)
    for t0 in starts:
        got = resident.resident_eval_mpjpe(model, corpus, idx, t0, 8)
    want = resident._window_call(resident._EVAL_MPJPE.eager, model, corpus, idx, starts[-1], window=8)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    for bn_train in (False, True):
        for t0 in starts:
            diag = resident.resident_diagnose(model, corpus, idx, t0, 8, bn_train)
        model.train(bn_train)
        eager = resident._window_call(resident._DIAGNOSE.eager, model, corpus, idx, starts[-1], window=8)
        model.eval()
        same = same and all(diag[k] == float(v) for k, v in eager.items())
    made = {k: n - before.get(k, 0) for k, n in compiled.CAPTURES.items() if n != before.get(k, 0)}
    check(made == {"_diagnose": 2}, f"[resident] eval and diagnosis captures {made}")
    check(same, "[resident] an eval or diagnosis replay differs from its eager call")
    log(f"[resident] resident_eval_mpjpe and resident_diagnose (BatchNorm eval and train) at window starts "
        f"{starts}: captures {made} (the eval's graph made by the loop), replays equal to the eager calls bit "
        f"for bit; MPJPE {float(got[0]):.1f} mm, diagnosis {diag} [{card}]")


def phase_resident(wp_mod, wi_mod, card):
    """The device-resident trainer at the JAX package's defaults: tracker
    crops prepared on the card (one ``warp_pool`` launch a sequence), the
    corpus built, then ``run_resident_training`` at full width; its steps/s,
    loss, eval MPJPE, peak memory and one step under the profiler.  Returns
    the pool launches, the corpus and the median step's ms."""
    import torch
    from umetrack_torch.apps.train import prepare_tracker_sequences
    from umetrack_torch.models import ModelConfig
    from umetrack_torch.parallel import LossWeights, init_train_model, resident
    from umetrack_torch.tracker import compiled

    reset_launches(wp_mod, wi_mod)
    t0 = time.perf_counter()
    entries = prepare_tracker_sequences(RES_SEQS, RES_T, scale_jitter=0.15, device="cuda")
    prep_s = time.perf_counter() - t0
    counts = launches(wp_mod, wi_mod)
    check(counts == (RES_SEQS, 0, 0), f"prepare_tracker_sequences: launches (pool, full, windowed) {counts}")
    check(all(math.isfinite(float(e["images"].sum())) for e in entries), "non-finite crops")
    n_valid = sum(int(e["hand_valid"].sum()) for e in entries)
    log(f"[resident] prepare_tracker_sequences {RES_SEQS} sequences x {RES_T} frames (capsule-rendered, "
        f"hand scale jitter 0.15) on the card in {prep_s:.1f} s: one warp_pool launch a sequence, crops "
        f"finite, {n_valid}/{RES_SEQS * RES_T * 2} valid hands [{card}]")

    corpus = resident.build_resident_corpus(entries, device="cuda")
    del entries
    model = init_train_model(ModelConfig(), seed=0, device="cuda")
    captures = resident_captures()
    marks = [time.perf_counter()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wp_mod, wi_mod)
    t0 = time.perf_counter()
    state, hist = resident.run_resident_training(
        model, corpus, num_steps=RES_STEPS, seqs_per_batch=16, window=8, learning_rate=3e-4,
        log_every=1, eval_every=RES_STEPS, augment=True, seed=0,
        log_fn=lambda m: marks.append(time.perf_counter()),
    )
    wall_s = time.perf_counter() - t0
    check(launches(wp_mod, wi_mod) == (0, 0, 0), "the resident loop launched a warp kernel")
    captures = resident_captures(captures)
    train_graph = compiled.last_capture("_resident_update")
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = sorted(b - a for a, b in zip(marks[6:-2], marks[7:-1]))  # steps 6 .. RES_STEPS-2
    step_ms = steps[len(steps) // 2] * 1e3
    first, last = hist[0], hist[-1]
    check(len(hist) == RES_STEPS and all(math.isfinite(h["loss"]) for h in hist), "non-finite loss")
    check(last["loss"] < first["loss"], f"loss did not fall: {first['loss']} -> {last['loss']}")
    check(math.isfinite(last["eval_mpjpe_mm"]) and math.isfinite(last["eval_mpjpa_deg"]),
          f"eval MPJPE {last.get('eval_mpjpe_mm')}")
    rows = 2 * 16
    log(f"[resident] run_resident_training full ModelConfig() f32, {rows} hand rows x K=8, AdamW 3e-4, "
        f"clip 1.0, warmup-cosine, augment on, {RES_STEPS} steps in {wall_s:.1f} s: loss "
        f"{first['loss']:.4f} -> {last['loss']:.4f}, eval MPJPE {first['eval_mpjpe_mm']:.1f} -> "
        f"{last['eval_mpjpe_mm']:.1f} mm, MPJPA {last['eval_mpjpa_deg']:.2f} deg; "
        f"{step_ms:.1f} ms/step median of steps 6-{RES_STEPS - 2} ({1e3 / step_ms:.2f} steps/s, "
        f"{rows * 8 * 1e3 / step_ms:.1f} training frames/s; fastest {steps[0] * 1e3:.1f}, slowest "
        f"{steps[-1] * 1e3:.1f} ms), peak mem {peak:.2f} GiB; {captures} over the loop, one a key "
        f"whatever the window start (the step's graph captured in {train_graph.capture_ms:.1f} ms, pool "
        f"{train_graph.pool_bytes / 2**20:.1f} MiB) [{card}]")
    resident_window_checks(state.model, corpus, card)
    gen = torch.Generator(device="cuda").manual_seed(1)
    idx = torch.arange(16, device="cuda") % RES_SEQS
    step = lambda: resident.resident_train_step(state, corpus, idx, 0, LossWeights(), min(8, RES_T), gen)
    step()
    prof = phase_profile(step, f"one resident train step ({rows} rows x K=8, full width)", None, card,
                         top=15)
    log(f"[resident] one step (a graph replay): {prof['launches']} kernel launches, device {prof['device_ms']:.1f} ms: "
        f"{prof['device_ms'] / step_ms:.3f} of the median step unprofiled ({step_ms:.1f} ms; the "
        f"profiler stretched the step to {prof['wall_ms']:.1f} ms); the warp kernels' share 0 (the "
        f"corpus is already cropped) [{card}]")
    return counts[0], corpus, step_ms


# ---- the train steps as captured graphs ----------------------------------------


TRAIN_GRAPH_STEPS = 5  # steps of each run: the capturing call and 4 replays
TRAIN_GRAPH_B = 32  # rows of train_step's single-frame batch (the train app's)
TRAIN_GRAPH_ROWS = 8  # rows of temporal_train_step's K=TRAIN_K window
TRAIN_GRAPH_SEQS = 16  # sequences of a resident step: 32 hand rows x K=8
TRAIN_GRAPH_FACTOR = 2.0  # the replay's gap to eager, in eager-vs-eager floors (as [tp])
TRAIN_GRAPH_PROFILED = 1  # steps of a run under torch.profiler (a step: 4,500-22,700 kernels)


class cudnn_deterministic:
    """``torch.backends.cudnn.deterministic`` on inside, the earlier value
    restored after."""

    def __enter__(self):
        import torch

        self.saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.deterministic = self.saved


def train_state_tensors(state):
    """The tensors a train step writes: parameters, BatchNorm running
    stats, Adam's moments and the update count."""
    model, opt = state.model, state.optimizer
    out = list(model.parameters()) + [b for n, b in model.named_buffers() if "running" in n]
    return out + [t for p in model.parameters() for t in opt.state[p].values()] + [opt.step_count]


def train_gap(a, b):
    """(bit for bit, largest relative L2 gap over the tensors, relative L2
    gap of the parameters taken together) of two runs' results: their
    metrics at every step and the state tensors after the last."""
    import torch

    pairs = [(x, y) for ma, mb in zip(a[0], b[0]) for x, y in zip(ma.values(), mb.values())]
    pairs += list(zip(a[1], b[1]))
    same = all(torch.equal(x, y) for x, y in pairs)
    gap = max(relative_l2(x.double(), y.double()) if y.norm() else float(x.norm()) for x, y in pairs)
    n_params = sum(1 for _ in a[2].model.parameters())
    whole = relative_l2(*(torch.cat([t.double().reshape(-1) for t in r[1][:n_params]]) for r in (a, b)))
    return same, gap, whole


def train_graph_cases(corpus):
    """(label, compiled step, per-step (inputs, resident, static), needs a
    generator) of the three train steps at full width."""
    import numpy as np
    import torch
    from umetrack_torch.kinematics.hand import from_dict, load_generic_hand_dict
    from umetrack_torch.parallel import LossWeights, resident, synthetic_train_batch
    from umetrack_torch.parallel import train as T

    hand = from_dict(load_generic_hand_dict())
    n = TRAIN_GRAPH_STEPS
    frames = [dict(batch=synthetic_train_batch(100 + i, TRAIN_GRAPH_B, hand, device="cuda")) for i in range(n)]
    windows = [dict(batch=small_train_batches("cuda", TRAIN_GRAPH_ROWS, seed=200 + 20 * i)[1]) for i in range(n)]
    rng = np.random.default_rng(0)
    k = min(8, corpus.n_frames)
    draws = [resident.draw_window(rng, corpus.n_sequences, TRAIN_GRAPH_SEQS, corpus.n_frames - k + 1,
                                  torch.device("cuda")) for _ in range(n)]
    res = [(dict(seq_idx=i, t0=t0), dict(corpus=corpus), dict(weights=LossWeights(), window=k)) for i, t0 in draws]
    return [
        (f"train_step B={TRAIN_GRAPH_B}", T._TRAIN, [(x, None, dict(weights=LossWeights())) for x in frames], False),
        (f"temporal_train_step {TRAIN_GRAPH_ROWS} rows x K={TRAIN_K}", T._TEMPORAL,
         [(x, None, dict(weights=LossWeights(accel=100.0))) for x in windows], False),
        (f"resident_train_step {2 * TRAIN_GRAPH_SEQS} rows x K={k}, augment off", resident._RESIDENT, res, False),
        (f"resident_train_step {2 * TRAIN_GRAPH_SEQS} rows x K={k}, augment on", resident._RESIDENT, res, True),
    ]


def profiled_text(row, form):
    """``form``'s busy share, kernels and device ms a step from a
    :func:`phase_train_graph` row, or that it was not profiled."""
    if f"{form}_busy" not in row:
        return f"{form} not profiled"
    return (f"{form} busy {row[form + '_busy']:.3f}, {row[form + '_kernels']:.0f} kernels and "
            f"{row[form + '_device_ms']:.1f} ms of device work a step")


def train_run(base, step, calls, needs_gen, eager):
    """``calls`` through ``step`` (graphed, or eagerly) from a copy of
    ``base`` with a fresh optimizer (warmup-cosine, so that every update
    reads the device count) and generator: (metrics of each step, state
    tensors after the last, the state, ms a step over steps 2.., a function
    running TRAIN_GRAPH_PROFILED more steps)."""
    import copy

    import torch
    from umetrack_torch.parallel import ClippedAdamW, create_train_state, warmup_cosine_decay_schedule
    from umetrack_torch.parallel.train import run_step

    model = copy.deepcopy(base)
    schedule = warmup_cosine_decay_schedule(0.0, 3e-4, 2, 100, 3e-6)
    state = create_train_state(model, ClippedAdamW(model.parameters(), schedule, 1e-5, max_grad_norm=1.0))
    extra = dict(generator=torch.Generator(device="cuda").manual_seed(5)) if needs_gen else {}
    metrics = []
    torch.cuda.synchronize()
    for i, (inputs, res, static) in enumerate(calls):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        metrics.append(run_step(step, state, inputs, res, eager=eager, **static, **extra))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(calls) - 1)
    again = lambda: [run_step(step, state, *c[:2], eager=eager, **c[2], **extra)  # noqa: E731
                     for c in calls[:TRAIN_GRAPH_PROFILED]]
    return metrics, [t.detach().clone() for t in train_state_tensors(state)], state, ms, again


def phase_train_graph(corpus, card):
    """``[train-graph]``: ``train_step``, ``temporal_train_step`` and
    ``resident_train_step`` (augment off and on) at full width, f32 (TF32)
    and bf16, as captured CUDA graphs against eager steps from identical
    copies of the model, optimizer and generator: with
    ``cudnn.deterministic`` on both sides bit for bit (metrics at every
    step, parameters, running stats, Adam's moments and the count after the
    last); with the defaults within TRAIN_GRAPH_FACTOR x the gap between
    two eager runs.  ms a step eager and graphed, the busy share and kernels
    a step under the profiler, capture ms and pool MiB, one capture a run.
    Returns the rows for PERF.md."""
    import torch
    from umetrack_torch.models import ModelConfig
    from umetrack_torch.parallel import init_train_model
    from umetrack_torch.tracker import compiled

    check(hasattr(torch.cuda.CUDAGraph, "register_generator_state"),
          f"torch {torch.__version__}: CUDAGraph.register_generator_state is missing")
    free_card()
    cases = train_graph_cases(corpus)
    rows = {}
    for dname, dtype in (("f32 (TF32)", "float32"), ("bf16", BF16)):
        base = init_train_model(ModelConfig(compute_dtype=dtype), seed=0, device="cuda")
        for label, step, calls, needs_gen in cases:
            full = f"{label}, {dname}"
            t_case = time.perf_counter()
            with cudnn_deterministic():
                before = compiled.CAPTURES[step.name]
                det_g = train_run(base, step, calls, needs_gen, eager=False)
                check(compiled.CAPTURES[step.name] == before + 1, f"[train-graph] {full}: "
                      f"{compiled.CAPTURES[step.name] - before} captures in one run")
                det_e = train_run(base, step, calls, needs_gen, eager=True)
            det_same, det_gap, _ = train_gap(det_g, det_e)
            check(det_same, f"[train-graph] {full}, cudnn.deterministic: replay against eager differs "
                  f"(largest relative L2 {det_gap:.3e})")
            del det_g, det_e
            compiled.release()
            before = compiled.CAPTURES[step.name]
            graphed = train_run(base, step, calls, needs_gen, eager=False)
            check(compiled.CAPTURES[step.name] == before + 1, f"[train-graph] {full}: more than one capture")
            captured = compiled.last_capture(step.name)
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            eager = train_run(base, step, calls, needs_gen, eager=True)
            eager_mib = (torch.cuda.max_memory_allocated() - held) / 2**20  # the eager run's own peak
            eager2 = train_run(base, step, calls, needs_gen, eager=True)
            same, gap, whole = train_gap(graphed, eager)
            floor_same, floor, whole_floor = train_gap(eager2, eager)
            check(all(math.isfinite(float(v)) for m in graphed[0] for v in m.values()),
                  f"[train-graph] {full}: non-finite metrics")
            check(same or (gap <= TRAIN_GRAPH_FACTOR * floor and whole <= TRAIN_GRAPH_FACTOR * whole_floor),
                  f"[train-graph] {full}: replay against eager {gap:.3e} (parameters {whole:.3e}), eager "
                  f"against eager {floor:.3e} ({whole_floor:.3e})")
            # the eager step under the profiler for the headline case only (20,000 launches to record)
            profiled = [("graphed", graphed)] + [("eager", eager)] * (label == cases[-1][0])
            prof = {form: profile_call(run[4]) for form, run in profiled}
            row = dict(eager_ms=eager[3], graphed_ms=graphed[3], capture_ms=captured.capture_ms,
                       pool_mib=captured.pool_bytes / 2**20, eager_mib=eager_mib, gap=gap, floor=floor, whole=whole,
                       whole_floor=whole_floor,
                       **{f"{f}_busy": p["device_ms"] / p["wall_ms"] for f, p in prof.items()},
                       **{f"{f}_kernels": p["launches"] / TRAIN_GRAPH_PROFILED for f, p in prof.items()},
                       **{f"{f}_device_ms": p["device_ms"] / TRAIN_GRAPH_PROFILED for f, p in prof.items()})
            rows[full] = row
            log(f"[train-graph] {full}: {TRAIN_GRAPH_STEPS} steps graphed (one capture, "
                f"{captured.capture_ms:.1f} ms, pool {row['pool_mib']:.1f} MiB; an eager run's own peak "
                f"{eager_mib:.1f} MiB) against eager from identical "
                f"copies: cudnn.deterministic bit for bit {det_same}; defaults bit for bit {same}, largest "
                f"relative L2 {gap:.3e} (the parameters together {whole:.3e}) against the eager-vs-eager "
                f"floor {floor:.3e} ({whole_floor:.3e}; bit for bit {floor_same}; gate {TRAIN_GRAPH_FACTOR:g} x); "
                f"{eager[3]:.2f} ms a step eager, {graphed[3]:.2f} graphed ({eager[3] / graphed[3]:.2f} x); "
                f"under the profiler {' -> '.join(profiled_text(row, f) for f in ('eager', 'graphed'))}; "
                f"{time.perf_counter() - t_case:.1f} s [{card}]")
            del graphed, eager, eager2
            compiled.release()
        del base
    free_card()
    return rows


def phase_train_app(wp_mod, wi_mod, card):
    """``apps/train.py::main`` on synthetic 120 x 160 batches (one
    ``warp_image_full`` launch a batch) and on a 480 x 640 idx/bin training
    tree (one ``warp_image_windowed`` launch a batch); the final orbax
    directory loads back and its forward equals the trained model's; then
    the synthetic run in bf16 (the JSON config's ``model.compute_dtype``).
    Returns the launches."""
    import torch
    from umetrack_torch.apps import train as app
    from umetrack_torch.config import Config, to_json
    from umetrack_torch.models import ModelConfig, TemporalState, UmeTrackNet
    from umetrack_torch.utils.checkpoints import load_checkpoint
    from umetrack_torch.utils.synthetic import write_torchdata_corpus

    with tempfile.TemporaryDirectory(prefix="umetrack_train_") as tmp:
        ckpts = os.path.join(tmp, "ckpts")
        reset_launches(wp_mod, wi_mod)
        t_syn, (state, hist) = wall_ms(lambda: app.main([
            "--synthetic", "--steps", str(APP_STEPS), "--batch-size", "32", "--window", "8",
            "--checkpoint-dir", ckpts]))
        counts_syn = launches(wp_mod, wi_mod)
        check(counts_syn == (0, APP_STEPS, 0),
              f"train app, synthetic: launches (pool, full, windowed) {counts_syn} in {APP_STEPS} batches")
        check(all(math.isfinite(v) for v in hist), f"train app, synthetic: loss {hist}")
        check(os.listdir(ckpts) == ["final"] and os.path.isfile(os.path.join(ckpts, "final", "_METADATA")),
              f"checkpoints {os.listdir(ckpts)}: the orbax directory final expected")
        loaded = UmeTrackNet(ModelConfig())
        loaded.load_state_dict(load_checkpoint(os.path.join(ckpts, "final")))
        loaded = loaded.cuda().eval()
        trained = state.model.eval()
        batch = next(app.synthetic_batches(4, (96, 96), device="cuda"))
        with torch.no_grad():
            zero = TemporalState.zeros(4, trained.config, device="cuda")
            a, _ = trained.known_skeleton(batch.frame, batch.skeleton, zero)
            b, _ = loaded.known_skeleton(batch.frame, batch.skeleton, zero)
        gap = max(float((x - y).abs().max()) for x, y in (
            (a.joint_angles, b.joint_angles), (a.wrist_xfs, b.wrist_xfs),
            (a.landmark_uncertainty_sigmas, b.landmark_uncertainty_sigmas)))
        check(gap == 0.0, f"the reloaded checkpoint's forward differs by {gap}")
        log(f"[train-app] main --synthetic --steps {APP_STEPS} --batch-size 32 --window 8, full "
            f"ModelConfig() f32: {t_syn / 1e3:.1f} s ({APP_STEPS / t_syn * 1e3:.2f} steps/s with start-up), "
            f"loss {hist[0]:.4f} -> {hist[-1]:.4f}, one warp_image_full launch per batch; the orbax "
            f"directory final reloaded: eval-mode forward equal bit for bit (gap {gap}) [{card}]")

        # the same in bf16: the JSON config's model.compute_dtype says so
        cfg16 = os.path.join(tmp, "bf16.json")
        to_json(Config(model=ModelConfig(compute_dtype=BF16)), cfg16)
        reset_launches(wp_mod, wi_mod)
        t16, (state16, hist16) = wall_ms(lambda: app.main([
            "--config", cfg16, "--synthetic", "--steps", str(APP_BF16_STEPS), "--batch-size", "32",
            "--window", "8"]))
        counts16 = launches(wp_mod, wi_mod)
        check(counts16 == (0, APP_BF16_STEPS, 0),
              f"train app, bf16: launches (pool, full, windowed) {counts16} in {APP_BF16_STEPS} batches")
        check(state16.model.config.compute_dtype == BF16 and all(math.isfinite(v) for v in hist16)
              and all(p.dtype == torch.float32 for p in state16.model.parameters()),
              f"train app, bf16: {state16.model.config.compute_dtype}, loss {hist16}")
        log(f"[bf16] train app main --config <model.compute_dtype bfloat16> --synthetic --steps "
            f"{APP_BF16_STEPS} --batch-size 32 --window 8: {t16 / 1e3:.1f} s with start-up, loss "
            f"{hist16[0]:.4f} -> {hist16[-1]:.4f}, parameters f32, one warp_image_full launch per batch [{card}]")
        del state16

        root = os.path.join(tmp, "tree")
        t0 = time.perf_counter()
        write_torchdata_corpus(root, n_train=TREE_SEQS, n_test=0, t=8, v=TD_V, h=TD_H, w=TD_W,
                               device="cuda")
        write_s = time.perf_counter() - t0
        tree_steps = TREE_SEQS // TREE_BATCH
        reset_launches(wp_mod, wi_mod)
        t_tree, (_, hist_tree) = wall_ms(lambda: app.main([
            "--data", root, "--steps", str(tree_steps), "--batch-size", str(TREE_BATCH), "--window", "8"]))
        counts_tree = launches(wp_mod, wi_mod)
        check(counts_tree == (0, 0, tree_steps),
              f"train app, 480 x 640 tree: launches (pool, full, windowed) {counts_tree} in {tree_steps} batches")
        check(all(math.isfinite(v) for v in hist_tree), f"train app, tree: loss {hist_tree}")
        log(f"[train-app] main --data <{TREE_SEQS} training sequences x 8 frames x {TD_V} views of "
            f"{TD_H} x {TD_W}, written in {write_s:.1f} s> --steps {tree_steps} --batch-size {TREE_BATCH} "
            f"--window 8: {t_tree / 1e3:.1f} s, one warp_image_windowed launch per batch [{card}]")
    return counts_syn[1], counts_tree[2], counts16[1]


def phase_train_kernels(wp_mod, wi_mod, card):
    """The three kernels against their plain version at the shapes the
    training path gives them (a prepared sequence of 16 frames for the pool,
    a 480 x 640 training batch for the windowed warp, a 120 x 160 synthetic
    batch for the full warp), their times and byte bounds; then one step of
    the train app (batch build + TBPTT step) under the profiler.  Returns a
    row per kernel."""
    import numpy as np
    import torch
    from umetrack_torch.apps import train as app
    from umetrack_torch.models import ModelConfig
    from umetrack_torch.parallel import ClippedAdamW, create_train_state, init_train_model
    from umetrack_torch.parallel import temporal_train_step
    from umetrack_torch.tracker import TrackerConfig
    from umetrack_torch.tracker.tracker import pool_warp_operands
    from umetrack_torch.utils.synthetic import make_labels_dict, make_torchdata_sample, our_sequence

    one = lambda tree: tree.map(lambda a: a[None])
    scale = float(np.random.default_rng(5000).uniform(0.85, 1.15))
    labels, images = make_labels_dict(RES_T, rng_seed=5000, with_dropout=False, hand_scale=scale,
                                      device="cuda")
    rig, seq, hand = our_sequence(labels, images, "cuda")
    rows = {"warp_pool": pool_shape_row(
        wp_mod, f"training shape, a prepared sequence of {RES_T} frames",
        *pool_warp_operands(TrackerConfig(), one(rig), one(seq), one(hand)), card)}

    for name, (n, h, w) in (("warp_image_windowed", (TREE_BATCH, TD_H, TD_W)),
                            ("warp_image_full", (32, 120, 160))):
        label = f"training shape, a batch of {n} x 8 x {TD_V} frames of {h} x {w}"
        images, coords = torchdata_warp_operands(torchdata_batch(n, 8, h, w, seed0=60))
        err = compare_image_kernels(wi_mod, images, coords, label)[0]
        rows[name] = dict(shape=label, max_abs_err=err,
                          **time_image_kernels(wi_mod, images, coords, label, card)[name])
        del images, coords

    items = [dict(zip(("mono", "labels"), make_torchdata_sample(
        rng_seed=i, t=8, hand_idx=i % 2, render=True, device="cuda"))) for i in range(32)]
    model = init_train_model(ModelConfig(), seed=0, device="cuda")
    state = create_train_state(model, ClippedAdamW(model.parameters(), 1e-4, 1e-5))
    step = lambda: temporal_train_step(state, app._batch_from_sequences(items, (96, 96), 8, device="cuda"))
    step()
    phase_profile(step, "one train-app step (32 sequences x 8 frames of 120 x 160: batch build + "
                  "TBPTT step)", "warp_image_full_kernel", card, top=10)
    return rows


def phase_distill(wp_mod, wi_mod, card):
    """``run_distillation`` with a ``.torch`` teacher written from the
    trained checkpoint under the original model's names: finite gaps, the
    evaluation metric set and the JAX app's ``ckpt_step_*`` orbax
    directories.  Returns the launches of the two kernels."""
    import torch
    from umetrack_torch.apps import distill
    from umetrack_torch.models.convert import reference_module_names
    from umetrack_torch.utils.checkpoints import load_checkpoint

    names = {ours: ref for ref, ours in reference_module_names().items()}
    with tempfile.TemporaryDirectory(prefix="umetrack_distill_") as tmp:
        path = os.path.join(tmp, "teacher.torch")
        torch.save({f"{names[k.rsplit('.', 1)[0]]}.{k.rsplit('.', 1)[1]}": v
                    for k, v in load_checkpoint(CHECKPOINT).items()}, path)
        out = os.path.join(tmp, "out")
        reset_launches(wp_mod, wi_mod)
        t_ms, (gaps, final) = wall_ms(lambda: distill.run_distillation(
            steps=DISTILL_STEPS, batch_size=8, eval_every=5, teacher_checkpoint=path, out_dir=out,
            n_eval_sequences=DISTILL_EVAL_SEQS, device="cuda"))
        counts = launches(wp_mod, wi_mod)
        want = [f"ckpt_step_{step:07d}" for step in list(range(0, DISTILL_STEPS, 5)) + [DISTILL_STEPS - 1]]
        check(sorted(os.listdir(out)) == want, f"distillation checkpoints {sorted(os.listdir(out))}")
        student = load_checkpoint(os.path.join(out, want[-1]))
    check(counts == (2 * DISTILL_EVAL_SEQS, DISTILL_STEPS + 1, 0),
          f"distillation: launches (pool, full, windowed) {counts}")
    check(len(gaps) == DISTILL_STEPS // 5 + 1 and all(math.isfinite(g) for g in gaps), f"gaps {gaps}")
    check(all(bool(torch.isfinite(v).all()) for v in student.values()), "the last student checkpoint")
    keys = ("mpjpe_mm", "mpjpa_deg", "pck_auc", "success_rate", "mean_keypoint_acceleration")
    check(all(k in final and math.isfinite(final[k]) for k in keys), f"metric set {final}")
    log(f"[distill] run_distillation steps={DISTILL_STEPS} batch 8, teacher = the checkpoint as a .torch "
        f"file under the original names: {t_ms / 1e3:.1f} s, gaps {', '.join(f'{g:.1f}' for g in gaps)} mm; "
        f"tracked against the teacher on {DISTILL_EVAL_SEQS} rendered sequences: "
        f"{', '.join(f'{k} {final[k]:.4f}' for k in keys)}; launches: warp_image_full {counts[1]} "
        f"(one a batch), warp_pool {counts[0]} (one a tracked sequence); {len(want)} orbax directories "
        f"ckpt_step_*, the last reloaded [{card}]")
    return counts


# ---- the bfloat16 compute dtype -----------------------------------------------


def shares_text(prof):
    return ", ".join(f"{k} {v:.3f}" for k, v in kernel_shares(prof).items())


def phase_bf16_tracker(wp_mod, model32, model16, tally, rigs, seqs, hands, card):
    """``track_sequences_batched`` at S=64 x T=16 in bf16 beside f32 with
    cuDNN's TF32 on (PyTorch's default) and off, the same seeded weights:
    one warp_pool launch a bf16 call (``tally``), finite outputs, ms per call
    (median of 3, the three variants in turns), frames/s, peak memory, one
    call of each under the profiler with its device time split by kind of
    kernel; bf16 against f32 (TF32 off) at ``tests/test_bf16.py``'s bounds;
    then ``eval_sequences_batched`` in bf16 (one launch a call)."""
    import contextlib

    import torch
    from umetrack_torch.parallel.eval import eval_sequences_batched, make_batched_state
    from umetrack_torch.tracker import HandTracker

    from umetrack_torch.models.backbone import BatchNorm

    # the model's BatchNorm on the card in bf16 (cuDNN's or PyTorch's kernel
    # for a bf16 input against f32 parameters) is flax's rule written out:
    # normalise x.float(), round once, within one bf16 ulp of the value
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn((256, 32, 48, 48), generator=gen, device="cuda") * 3 + 1).to(torch.bfloat16)
    bn = BatchNorm(32, torch.bfloat16).cuda().eval()
    with torch.no_grad():
        bn.running_mean.uniform_(-0.2, 0.2, generator=gen)
        bn.running_var.uniform_(1.0, 2.0, generator=gen)
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        y = bn(x)
    scale = torch.rsqrt(bn.running_var + 1e-5) * bn.weight
    want = ((x.float() - bn.running_mean[:, None, None]) * scale[:, None, None] + bn.bias[:, None, None])
    # in bf16 ulps of the value (rounding once is within half of one), with a
    # floor of 1e-5 where the f32 arithmetic's own order (x * a + b against
    # (x - mean) * a + bias) cancels to near zero
    ulp = torch.exp2(torch.floor(torch.log2(want.abs())) - 7)
    ulps = float(((y.float() - want).abs() / (ulp + 1e-5)).max())
    check(y.dtype == torch.bfloat16 and ulps <= 1.0, f"bf16 BatchNorm: {ulps} ulps off flax's rule")
    log(f"[bf16] BatchNorm eval on the card, a bf16 input [256, 32, 48, 48] against f32 stats: within "
        f"{ulps:.3f} bf16 ulps (or 1e-5) of normalising x.float() and rounding once (<= 1)")

    s, t = seqs.gt_confidences.shape[:2]
    t32, t16 = HandTracker(model32, device="cuda"), HandTracker(model16, device="cuda")
    variants = (("f32, TF32 on", lambda: t32.track_sequences_batched(rigs, seqs, hands), True),
                ("bf16", lambda: tally(lambda: t16.track_sequences_batched(rigs, seqs, hands), 1,
                                       "bf16 track_sequences_batched"), True),
                ("f32, TF32 off", lambda: t32.track_sequences_batched(rigs, seqs, hands), False))
    results, times, peaks = {}, {}, {}
    for label, fn, tf32 in variants:
        with contextlib.nullcontext() if tf32 else tf32_off():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            results[label] = fn()  # warms cuDNN up for this dtype and setting
            torch.cuda.synchronize()
            peaks[label] = torch.cuda.max_memory_allocated() / 2**30
    for _ in range(TRACK_CALLS):
        for label, fn, tf32 in variants:
            with contextlib.nullcontext() if tf32 else tf32_off():
                times.setdefault(label, []).append(wall_ms(fn)[0])
    res16, state16 = results["bf16"]
    check(res16.joint_angles.dtype == res16.wrist_xfs.dtype == torch.float32, "bf16: outputs not f32")
    check(state16.temporal.mem_features.dtype == torch.bfloat16, "bf16: the carry is not bf16")
    check(bool(torch.isfinite(res16.joint_angles).all() & torch.isfinite(res16.wrist_xfs).all()
               & torch.isfinite(state16.temporal.mem_features.float()).all()), "bf16: non-finite output")
    for label in times:
        ms = sorted(times[label])[len(times[label]) // 2]
        log(f"[bf16] track_sequences_batched S={s} T={t} full ModelConfig() {label}: {ms:.1f} ms/call "
            f"median of {TRACK_CALLS} ({', '.join(f'{m:.1f}' for m in times[label])}; in turns with the "
            f"other two), {s * t / ms * 1e3:.1f} frames/s, peak mem {peaks[label]:.2f} GiB [{card}]")

    # bf16 against f32 with TF32 off, the same weights: tests/test_bf16.py's bounds
    ref = results["f32, TF32 off"][0]
    v = ref.valid
    check(bool((res16.valid == v).all()), "bf16 against f32: valid masks differ")
    da = float((res16.joint_angles[v] - ref.joint_angles[v]).abs().max())
    dw = float((res16.wrist_xfs[v][..., :3, 3] - ref.wrist_xfs[v][..., :3, 3]).abs().max())
    r = res16.wrist_xfs[v][..., :3, :3]
    ortho = float((r @ r.transpose(-1, -2) - torch.eye(3, device="cuda")).abs().max())
    check(da <= BF16_F32_ANGLE_TOL and ortho <= BF16_ORTHO_TOL,
          f"bf16 against f32: {da} rad, orthonormality {ortho}")
    log(f"[bf16] bf16 against f32 (TF32 off), same seeded weights, {int(v.sum())} valid hands: angles "
        f"{da:.3e} rad (<= {BF16_F32_ANGLE_TOL}), wrist {dw:.3e} mm, rotations orthonormal within "
        f"{ortho:.3e} (<= {BF16_ORTHO_TOL})")

    for label, fn, tf32 in variants:
        with contextlib.nullcontext() if tf32 else tf32_off():
            prof = phase_profile(fn, f"one track_sequences_batched call, {label}", "warp_pool_kernel",
                                 card, top=8)
        log(f"[bf16] {label}: device time by kind: {shares_text(prof)}")

    # the batched eval in bf16
    known = lambda: eval_sequences_batched(model16, t16.config, rigs, seqs,
                                           make_batched_state(model16, s, "cuda"), hands, device="cuda")
    per_seq, n_valid, mean = tally(known, 1, "bf16 eval_sequences_batched")
    check(bool(torch.isfinite(per_seq).all() & (n_valid > 0).all()), "bf16 eval: non-finite errors")
    ms = sorted(wall_ms(lambda: tally(known, 1, "bf16 eval_sequences_batched"))[0]
                for _ in range(3))
    log(f"[bf16] eval_sequences_batched S={s} T={t} bf16: one warp_pool launch a call, global mean "
        f"{float(mean):.2f} mm, {ms[1]:.1f} ms/call median of 3 ({', '.join(f'{m:.1f}' for m in ms)}), "
        f"{s * t / ms[1] * 1e3:.1f} frames/s [{card}]")


def phase_bf16_streaming(wp_mod, models, tally, card):
    """bf16 ``track_frame`` looped over the rendered 64-frame sequence
    against ``track_sequence`` for each of ``models`` (name, bf16 model,
    bounds); then the card's bf16 tracker against the CPU's at S=2 x T=4."""
    import torch
    from umetrack_torch.models import ModelConfig, make_model
    from umetrack_torch.tracker import HandTracker
    from umetrack_torch.tracker.types import FrameResult
    from umetrack_torch.utils.synthetic import make_sequences

    _, _, (rig, seq, hand) = rendered_sequence(EVAL_FRAMES, 2_000_001, "cuda")
    frames = [seq.map(lambda a, i=i: a[i]) for i in range(EVAL_FRAMES)]
    for name, model, bounds in models:
        tracker = HandTracker(model, device="cuda")

        def loop():
            state, outs = tracker.init_state(), []
            for obs in frames:
                res, state = tracker.track_frame(rig, obs, state, hand)
                outs.append(res)
            check(state.temporal.mem_features.dtype == torch.bfloat16, "track_frame: the carry is not bf16")
            return FrameResult(**{k: torch.stack([getattr(o, k) for o in outs])
                                  for k in ("joint_angles", "wrist_xfs", "valid", "n_views")})

        with tf32_off():
            streamed = tally(loop, EVAL_FRAMES, f"bf16, {name}: {EVAL_FRAMES} track_frame calls")
            ref, _ = tally(lambda: tracker.track_sequence(rig, seq, hand), 1,
                           f"bf16, {name}: track_sequence")
        da, dw, _ = result_diff(streamed, ref, f"bf16 track_frame loop, {name}", bounds)
        loop_ms, _ = wall_ms(lambda: tally(loop, EVAL_FRAMES, "bf16 track_frame loop"))
        log(f"[bf16] {name}: {EVAL_FRAMES} x track_frame against one track_sequence call in bf16 "
            f"(TF32 off): masks equal ({int(ref.valid.sum())}/{ref.valid.numel()} valid), angles {da:.3e} "
            f"rad (<= {bounds.angle}), wrist {dw:.3e} mm (<= {bounds.mm}); the loop {loop_ms:.1f} ms, "
            f"{EVAL_FRAMES / loop_ms * 1e3:.1f} frames/s [{card}]")

    rigs, seqs, hands = make_sequences(S_SMALL, T_SMALL, seed=100, device="cpu")
    cfg16 = ModelConfig(compute_dtype=BF16)
    with tf32_off():
        res_cpu, _ = HandTracker(gate_weights(make_model(cfg16, device="cpu")), device="cpu") \
            .track_sequences_batched(rigs, seqs, hands)
        res_gpu, _ = tally(lambda: HandTracker(models[0][1], device="cuda").track_sequences_batched(
            rigs.to("cuda"), seqs.to("cuda"), hands.to("cuda")), 1, "bf16 card against CPU")
    da, dw = track_diff(res_cpu, res_gpu.to("cpu"))
    check(da <= BF16_CPU.angle and dw <= BF16_CPU.mm, f"bf16 card against CPU: {da} rad, {dw} mm")
    log(f"[bf16] card against CPU, both bf16, S={S_SMALL} T={T_SMALL}, seeded weights, TF32 off: valid "
        f"equal, angles {da:.3e} rad (<= {BF16_CPU.angle}), wrist {dw:.3e} mm (<= {BF16_CPU.mm})")


def phase_bf16_eval_app(tally, f32_summary, card):
    """The known-skeleton eval app's ``main`` with ``--dtype bfloat16`` and
    the checkpoint on the generated sequences: its MPJPE beside f32's (a
    finding, not a gate)."""
    import contextlib
    import io

    import numpy as np
    from umetrack_torch.apps import load_eval, run_eval_known_skeleton

    with tempfile.TemporaryDirectory(prefix="umetrack_eval_bf16_") as root:
        out_dir = os.path.join(root, "eval_results_known_skeleton", "real", "separate_hand")
        ms, errors = tally(lambda: wall_ms(lambda: run_eval_known_skeleton.main([
            "--output-dir", out_dir, "--synthetic", str(EVAL_SEQS), "--synthetic-frames", str(EVAL_FRAMES),
            "--checkpoint", CHECKPOINT, "--device", "cuda", "--dtype", BF16])),
            EVAL_SEQS, "bf16 run_eval_known_skeleton.main")
        check(len(errors) == EVAL_SEQS and bool(np.isfinite(errors).all()), f"bf16 known app: {errors}")
        with contextlib.redirect_stdout(io.StringIO()):
            summ = load_eval.main(["--results-root", root])["known_skeleton/separate_hand"]
    log(f"[bf16] run_eval_known_skeleton.main --dtype bfloat16 with the checkpoint on {EVAL_SEQS} "
        f"generated sequences: {ms / 1e3:.2f} s, MPJPE {summ['mpjpe_mm']:.3f} mm (f32: "
        f"{f32_summary['mpjpe_mm']:.3f}), PCK-AUC {summ['pck_auc']:.4f} (f32: {f32_summary['pck_auc']:.4f}), "
        f"per-sequence errors {', '.join(f'{e:.2f}' for e in errors)} mm; one warp_pool launch a "
        f"sequence (a finding, not a gate) [{card}]")


def phase_bf16_resident(corpus, f32_step_ms, card):
    """``run_resident_training`` with a bf16 model on the resident corpus,
    32 hand rows x K=8: loss finite and falling, ms per step beside f32's."""
    import torch
    from umetrack_torch.models import ModelConfig
    from umetrack_torch.parallel import init_train_model, resident

    model = init_train_model(ModelConfig(compute_dtype=BF16), seed=0, device="cuda")
    captures = resident_captures()
    marks = [time.perf_counter()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, hist = resident.run_resident_training(
        model, corpus, num_steps=RES_BF16_STEPS, seqs_per_batch=16, window=8, learning_rate=3e-4,
        log_every=1, eval_every=RES_BF16_STEPS, augment=True, seed=0,
        log_fn=lambda m: marks.append(time.perf_counter()),
    )
    peak = torch.cuda.max_memory_allocated() / 2**30
    captures = resident_captures(captures)
    check(len(hist) == RES_BF16_STEPS and all(math.isfinite(h["loss"]) for h in hist), "bf16: non-finite loss")
    check(hist[-1]["loss"] < hist[0]["loss"], f"bf16: loss did not fall: {hist[0]['loss']} -> {hist[-1]['loss']}")
    check(all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in model.parameters()),
          "bf16 training: parameters not f32 or not finite")
    steps = sorted(b - a for a, b in zip(marks[4:-2], marks[5:-1]))
    step_ms = steps[len(steps) // 2] * 1e3
    log(f"[bf16] run_resident_training bf16, 32 hand rows x K=8, {RES_BF16_STEPS} steps: loss "
        f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, eval MPJPE {hist[-1]['eval_mpjpe_mm']:.1f} mm; "
        f"{step_ms:.1f} ms/step median of steps 4-{RES_BF16_STEPS - 2} (f32, TF32 on, above: "
        f"{f32_step_ms:.1f}), peak mem {peak:.2f} GiB; parameters f32; {captures} over the loop [{card}]")


def init_rule_line(card):
    """The initial draw of every training entry (``init_train_model(
    ModelConfig())``) is flax's default, the JAX package's: std *
    sqrt(fan_in) within 5 % of 1 for every conv / dense kernel of at least
    1,024 elements, |w| * sqrt(fan_in) <= 2 / 0.8796 (the truncation), zero
    biases, BN 1 / 0 / 0 / 1.  Raises if the rule breaks."""
    import numpy as np
    import torch
    from umetrack_torch.models import ModelConfig
    from umetrack_torch.parallel import init_train_model

    model = init_train_model(ModelConfig(), seed=0, device="cuda")
    scaled_std, peak, nonzero, n_bias = [], 0.0, 0, 0
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            w = m.weight.detach().double()
            root = w[0].numel() ** 0.5
            scaled_std.append((float(w.std()) * root, w.numel()))
            peak = max(peak, float(w.abs().max()) * root)
            if m.bias is not None:
                n_bias += 1
                nonzero += int(bool(m.bias.any()))
        elif isinstance(m, torch.nn.BatchNorm2d):
            check(bool((m.weight == 1).all() and (m.bias == 0).all() and (m.running_mean == 0).all()
                       and (m.running_var == 1).all()), "init: a BatchNorm is not 1 / 0 / 0 / 1")
    stds = np.asarray([r for r, _ in scaled_std])
    held = [r for r, n in scaled_std if n >= 1024]
    log(f"[accuracy] init_train_model(ModelConfig()): std * sqrt(fan_in) over the {len(stds)} conv / "
        f"dense kernels min {stds.min():.4f} median {np.median(stds):.4f} max {stds.max():.4f} "
        f"({len(held)} of >= 1,024 elements within {max(abs(r - 1) for r in held):.4f} of 1), largest "
        f"|w| * sqrt(fan_in) {peak:.5f} (truncation {2 / 0.8796:.5f}), nonzero biases {nonzero} of "
        f"{n_bias}, BN 1 / 0 / 0 / 1: flax's default draw [{card}]")
    check(all(abs(r - 1) <= 0.05 for r in held), "init: a kernel's std * sqrt(fan_in) is off 1 by > 5 %")
    check(peak <= 2 / 0.8796, f"init: |w| * sqrt(fan_in) {peak} beyond the truncation")
    check(nonzero == 0, f"init: {nonzero} nonzero conv / dense biases")


def phase_accuracy(wp_mod, wi_mod, card):
    """The accuracy workflow's drivers (``umetrack_torch/scripts/``) at the
    full width of ``ModelConfig()``, in a temporary folder: ``resident_train
    gen`` (one ``warp_pool`` launch a sequence; the cache read back equals
    the corpus of the entries in memory at float16 rounding), ``probe`` in
    bf16 and ``train`` (loss and eval MPJPE fall, the JAX history keys, the
    checkpoint reloads, the inline diagnosis), ``diagnose_ckpt`` against
    the inline diagnosis, ``accuracy_loop eval`` over the four cells with
    the round-5 capsule checkpoint and one cell with the port-trained one,
    and ``accuracy_loop corpus`` -> ``train`` (one ``warp_image_full``
    launch a batch) -> ``train-tracker``, each checkpoint loading in the
    next.  Every driver call is counted from 0.  Returns the launches by
    path and the full kernel's row at the loop's training shape."""
    import contextlib
    import io

    import numpy as np
    import torch
    from umetrack_torch.apps import load_eval, run_eval_known_skeleton
    from umetrack_torch.models import ModelConfig, UmeTrackNet
    from umetrack_torch.parallel import resident
    from umetrack_torch.scripts import accuracy_loop, diagnose_ckpt, resident_train
    from umetrack_torch.utils.checkpoints import load_checkpoint

    t_phase = time.perf_counter()
    init_rule_line(card)
    by_path = {}

    def driven(fn, want, label):
        """``fn()`` with the launch counters set to 0 just before and read
        just after; (pool, full, windowed) must equal ``want``.  What the
        driver prints (its JSON) is dropped: the phase logs its own lines."""
        reset_launches(wp_mod, wi_mod)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        got = launches(wp_mod, wi_mod)
        check(got == want, f"{label}: launches (pool, full, windowed) {got}, expected {want}")
        by_path[label] = got
        return out, s

    def summaries_of(root):
        with contextlib.redirect_stdout(io.StringIO()):
            return load_eval.main(["--results-root", root])

    cache_before = resident_train.CACHE
    with tempfile.TemporaryDirectory(prefix="umetrack_accuracy_") as root:
        resident_train.CACHE = os.path.join(root, "resident")
        out = os.path.join(root, "out")
        ckpt = os.path.join(out, "resident.msgpack")
        dims = ["--n-train", str(ACC_TRAIN), "--n-eval", str(ACC_EVAL), "--t", str(ACC_T)]
        try:
            # (a) the corpus cache
            (entries, entries_e), s = driven(
                lambda: resident_train.main(["gen"] + dims + ["--device", "cuda"]),
                (ACC_TRAIN + ACC_EVAL, 0, 0), "resident_train gen")
            gaps = []
            for tag, ents in ((f"train_{ACC_TRAIN}_{ACC_T}", entries), (f"eval_{ACC_EVAL}_{ACC_T}", entries_e)):
                rounded = [dict(e, images=e["images"].astype(np.float16).astype(np.float32)) for e in ents]
                want = resident.build_resident_corpus(rounded, device="cuda")
                got = resident_train.load_corpus(tag, device="cuda")
                pairs = [(name, a, getattr(got, name)) for name, a in want.__dict__.items()
                         if torch.is_tensor(a)]
                pairs += [(f"hand.{name}", a, getattr(got.hand, name))
                          for name, a in want.hand.__dict__.items() if a is not None]
                for name, a, b in pairs:
                    check(a.dtype == b.dtype and torch.equal(a, b),
                          f"{tag}: load_corpus's {name} differs from the entries'")
                gaps.append(max(float(np.abs(e["images"].astype(np.float16).astype(np.float32)
                                             - e["images"]).max()) for e in ents))
            log(f"[accuracy] resident_train gen --n-train {ACC_TRAIN} --n-eval {ACC_EVAL} --t {ACC_T}: "
                f"{s:.1f} s, one warp_pool launch a sequence; load_corpus of the npz cache equals the "
                f"corpus of the entries in memory with the images at float16 rounding (that rounding "
                f"moved a crop pixel by at most {max(gaps):.2e}) [{card}]")
            del entries, entries_e

            # (b) the overfit probe in bf16
            probe, s = driven(lambda: resident_train.main(
                ["probe"] + dims + ["--probe-seqs", str(ACC_PROBE_SEQS), "--steps", str(ACC_PROBE_STEPS),
                                    "--log-every", "5", "--eval-every", str(ACC_PROBE_EVAL),
                                    "--device", "cuda", "--out-dir", out]),
                (0, 0, 0), "resident_train probe")
            evals = [h for h in probe if "eval_mpjpe_mm" in h]
            check(all(math.isfinite(h["loss"]) for h in probe), "probe: non-finite loss")
            check(probe[-1]["loss"] < probe[0]["loss"],
                  f"probe: loss did not fall: {probe[0]['loss']} -> {probe[-1]['loss']}")
            check(evals[-1]["eval_mpjpe_mm"] < evals[0]["eval_mpjpe_mm"],
                  f"probe: eval MPJPE did not fall: {[h['eval_mpjpe_mm'] for h in evals]}")
            log(f"[accuracy] resident_train probe bf16, {ACC_PROBE_SEQS} sequences, 16 a batch, window 8, "
                f"{ACC_PROBE_STEPS} steps in {s:.1f} s ({probe[-1]['steps_per_s']:.2f} steps/s): loss "
                f"{probe[0]['loss']:.4f} -> {probe[-1]['loss']:.4f}, eval MPJPE on the probe sequences "
                f"{mpjpe_trail(evals)} mm, MPJPA {evals[-1]['eval_mpjpa_deg']:.2f} deg [{card}]")

            # (c) the full run
            history, s = driven(lambda: resident_train.main(
                ["train"] + dims + ["--steps", str(ACC_STEPS), "--log-every", "5",
                                    "--eval-every", str(ACC_EVAL_EVERY), "--device", "cuda",
                                    "--out-dir", out, "--ckpt", ckpt]),
                (0, 0, 0), "resident_train train")
            with open(os.path.join(HERE, "checkpoints", "history_train.json")) as fp:
                jax_rows = json.load(fp)
            with open(os.path.join(out, "history_train.json")) as fp:
                check(json.load(fp) == history, "the history JSON is not the run's history")
            jax_keys = {frozenset(h) for h in jax_rows}
            check(set(history[0]) == set(jax_rows[0]) and {frozenset(h) for h in history} <= jax_keys,
                  f"history keys {sorted(history[0])} against the JAX run's {sorted(jax_rows[0])}")
            evals = [h for h in history if "eval_mpjpe_mm" in h]
            check(all(math.isfinite(v) for h in history for v in h.values()), "train: non-finite history")
            check(history[-1]["loss"] < history[0]["loss"],
                  f"train: loss did not fall: {history[0]['loss']} -> {history[-1]['loss']}")
            model = UmeTrackNet(ModelConfig(compute_dtype=BF16))
            model.load_state_dict(load_checkpoint(ckpt))
            check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "checkpoint: non-finite")
            with open(os.path.join(out, "diagnose_train.json")) as fp:
                inline = json.load(fp)
            log(f"[accuracy] resident_train train bf16, {ACC_TRAIN} sequences, 16 a batch, window 8, "
                f"augmented, {ACC_STEPS} steps in {s:.1f} s ({history[-1]['steps_per_s']:.2f} steps/s, "
                f"eval included): loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}, held-out "
                f"eval MPJPE {mpjpe_trail(evals)} mm, MPJPA "
                f"{evals[-1]['eval_mpjpa_deg']:.2f} deg; history keys those of "
                f"checkpoints/history_train.json; the checkpoint reloads [{card}]")
            for split, d in inline.items():
                log(f"[accuracy] inline diagnose[{split}]: "
                    + ", ".join(f"{k} {v:.2f}" for k, v in d.items()))

            # (d) diagnose_ckpt on the saved checkpoint
            got, s = driven(lambda: diagnose_ckpt.main(
                ["--ckpt", ckpt] + dims + ["--split", "eval", "--seqs", str(ACC_EVAL), "--device", "cuda"]),
                (0, 0, 0), "diagnose_ckpt")
            check(set(got) == set(inline["eval"]), f"diagnose_ckpt keys {sorted(got)}")
            rel = max(abs(got[k] - inline["eval"][k]) / max(abs(inline["eval"][k]), 1e-6) for k in got)
            check(rel <= DIAGNOSE_RTOL, f"diagnose_ckpt against the inline diagnosis: {rel:.2e} relative")
            log(f"[accuracy] diagnose_ckpt --split eval on the saved checkpoint in {s:.1f} s: equals the "
                f"inline diagnosis within {rel:.2e} relative (<= {DIAGNOSE_RTOL}) [{card}]")

            # (e) the four cells with the round-5 capsule checkpoint, one with the port's
            eval_root, r5_out = os.path.join(root, "eval_r5"), os.path.join(root, "out_r5")
            n_pool = sum((1 if mode == "known_skeleton" else 2) * ACC_EVAL_SEQS
                         for mode, _ in accuracy_loop.CELLS)
            _, s = driven(lambda: accuracy_loop.main(
                ["eval", "--ckpt", R5_CHECKPOINT, "--eval-seqs", str(ACC_EVAL_SEQS),
                 "--eval-frames", str(ACC_EVAL_FRAMES), "--device", "cuda", "--eval-root", eval_root,
                 "--out-dir", r5_out]),
                (n_pool, 0, 0), "accuracy_loop eval, round-5 checkpoint")
            summaries = summaries_of(eval_root)
            check(list(summaries) == [f"{m}/{p}" for m, p in accuracy_loop.CELLS],
                  f"load_eval found {sorted(summaries)}")
            for name, summ in summaries.items():
                check(summ["n_total_frames"] == 2 * ACC_EVAL_SEQS * ACC_EVAL_FRAMES, f"{name}: {summ}")
                check(all(math.isfinite(summ[k]) for k in ("mpjpe_mm", "mpjpa_deg", "pck_auc")),
                      f"{name}: {summ}")
                check(summ["success_rate"] > 0, f"{name}: success rate {summ['success_rate']}")
            with open(os.path.join(r5_out, "RESULTS.md"), encoding="utf-8") as fp:
                rows = [line for line in fp.read().splitlines() if line.startswith("|")]
            check(len(rows) == 2 + len(accuracy_loop.CELLS), f"RESULTS.md table: {rows}")
            log(f"[accuracy] accuracy_loop eval --ckpt checkpoints/synthetic_r5.msgpack (round 5, "
                f"capsule domain), {ACC_EVAL_SEQS} sequences x {ACC_EVAL_FRAMES} frames a cell, f32: "
                f"{s:.1f} s, {n_pool} warp_pool launches (one a sequence known, two unknown) [{card}]")
            for line in rows:
                log(f"[accuracy] r5 {line}")
            cell = os.path.join(root, "eval_port", "eval_results_known_skeleton", "real", "separate_hand")
            errors, s = driven(lambda: run_eval_known_skeleton.main(
                ["--output-dir", cell, "--checkpoint", ckpt, "--synthetic", str(ACC_EVAL_SEQS),
                 "--synthetic-frames", str(ACC_EVAL_FRAMES), "--device", "cuda"]),
                (ACC_EVAL_SEQS, 0, 0), "known-skeleton eval, port-trained checkpoint")
            port = summaries_of(os.path.join(root, "eval_port"))["known_skeleton/separate_hand"]
            check(len(errors) == ACC_EVAL_SEQS and math.isfinite(port["mpjpe_mm"]), f"port cell: {port}")
            log(f"[accuracy] run_eval_known_skeleton with the checkpoint of (c) ({ACC_STEPS} steps), "
                f"separate_hand, {ACC_EVAL_SEQS} x {ACC_EVAL_FRAMES} frames: {s:.1f} s, MPJPE "
                f"{port['mpjpe_mm']:.2f} mm, MPJPA {port['mpjpa_deg']:.2f} deg, PCK-AUC "
                f"{port['pck_auc']:.4f}, success {port['success_rate']:.3f} (findings) [{card}]")

            # (f) the torch_data corpus -> train -> tracker fine-tune chain
            loop = ["--device", "cuda", "--corpus-root", os.path.join(root, "corpus"), "--out-dir", out,
                    "--n-train", str(LOOP_SEQS), "--n-test", "1", "--corpus-t", str(LOOP_T),
                    "--steps", str(LOOP_STEPS), "--batch-size", str(LOOP_BATCH), "--window", str(LOOP_T // 2),
                    "--tracker-seqs", str(LOOP_BATCH // 2)]
            _, s_corpus = driven(lambda: accuracy_loop.main(["corpus"] + loop), (0, 0, 0),
                                 "accuracy_loop corpus")
            loop_ckpt = os.path.join(out, accuracy_loop.CHECKPOINT_NAME)
            _, s_train = driven(lambda: accuracy_loop.main(["train"] + loop), (0, LOOP_STEPS, 0),
                                "accuracy_loop train")
            tracker_ckpt = os.path.join(out, "tracker")
            _, s_tracker = driven(lambda: accuracy_loop.main(
                ["train-tracker", "--init-ckpt", loop_ckpt, "--ckpt", tracker_ckpt] + loop),
                (LOOP_BATCH // 2, 0, 0), "accuracy_loop train-tracker")
            first, second = load_checkpoint(loop_ckpt), load_checkpoint(tracker_ckpt)
            check(set(first) == set(second) and any(
                not torch.equal(first[k], second[k]) for k in first if first[k].is_floating_point()),
                "train-tracker did not start from the train phase's checkpoint and move it")
            log(f"[accuracy] accuracy_loop corpus ({LOOP_SEQS} + 1 sequences x {LOOP_T} frames of 120 x "
                f"160) {s_corpus:.1f} s -> train ({LOOP_STEPS} steps of {LOOP_BATCH} sequences, window "
                f"{LOOP_T // 2}, one warp_image_full launch a batch) {s_train:.1f} s -> train-tracker "
                f"({LOOP_BATCH // 2} prepared sequences, one warp_pool launch each, {LOOP_STEPS} steps, "
                f"from the train phase's .msgpack, saved as an orbax directory) {s_tracker:.1f} s; each "
                f"checkpoint loads [{card}]")

            # the full kernel at the loop's training shape, outside the counted runs
            # the batch is preprocessed whole (every frame of its sequences), then windowed
            label = f"accuracy_loop train shape, a batch of {LOOP_BATCH} x {LOOP_T} x {TD_V} frames of 120 x 160"
            images, coords = torchdata_warp_operands(torchdata_batch(LOOP_BATCH, LOOP_T, 120, 160, seed0=70))
            err = compare_image_kernels(wi_mod, images, coords, label)[0]
            full_row = dict(shape=label, max_abs_err=err,
                            **time_image_kernels(wi_mod, images, coords, label, card)["warp_image_full"])
        finally:
            resident_train.CACHE = cache_before
    log(f"[accuracy] the phase took {time.perf_counter() - t_phase:.1f} s [{card}]")
    return by_path, full_row


def mpjpe_trail(rows):
    """``a -> b -> c`` of the eval MPJPE (mm) of a history's evaluated rows."""
    return " -> ".join(f"{h['eval_mpjpe_mm']:.1f}" for h in rows)


# ---- the compiled steps: captured CUDA graphs ---------------------------------


GRAPH_SEEDS = (3_000_001, 3_000_002)  # the rendered sequences A (capture) and B (replay)
GRAPH_PIPELINE = 4  # track_sequences_batched calls submitted back to back
GRAPH_PROFILED = 16  # frames or chunks of a run under torch.profiler (its busy share)


def tree_gap(a, b):
    """(bit for bit, max abs difference) over every tensor of two results."""
    import torch
    from umetrack_torch.tracker.compiled import _leaves

    la, lb = _leaves(a), _leaves(b)
    check(len(la) == len(lb) and all(x.shape == y.shape and x.dtype == y.dtype for x, y in zip(la, lb)),
          "results of another structure")
    same = all(torch.equal(x, y) for x, y in zip(la, lb))
    gap = max([float((x.double() - y.double()).abs().max()) for x, y in zip(la, lb)
               if x.is_floating_point() and x.numel()] + [0.0])
    return same, gap


def hold_graph(graphed, eager, label):
    """A replay against the eager call on the same inputs: bit for bit, or,
    printed with its cause, within the JAX tests' bounds."""
    same, gap = tree_gap(graphed, eager)
    if not same:
        res_g, res_e = (x[0] if isinstance(x, tuple) else x for x in (graphed, eager))
        result_diff(res_g, res_e, f"[graph] {label}: replay against eager", STRICT)
        log(f"[graph] {label}: NOT bit for bit, max abs difference {gap:.3e} (held at the JAX "
            f"tests' bounds)")
    return same, gap


def oor_worker(mode):
    """An ``src_idx`` outside the pool on the card, in a process of its own
    (a device-side assert leaves its CUDA context unusable): ``eager`` calls
    the wrapper, ``graph`` replays a captured step with the bad index copied
    in.  Prints what it got to before the error; exits non-zero when the
    error surfaces, 0 if it never does."""
    import torch
    from umetrack_torch.ops.warp_pool import warp_pool
    from umetrack_torch.tracker.compiled import CompiledStep

    pool = torch.zeros((2, 20, 32), dtype=torch.uint8, device="cuda")
    coords = torch.full((3, 4, 8, 2), 3.0, device="cuda")
    good = torch.tensor([0, 1, 1], dtype=torch.int32, device="cuda")
    bad = torch.tensor([0, 2, 1], dtype=torch.int32, device="cuda")

    def step(model, src_idx):
        return warp_pool(pool, coords, src_idx)

    model, compiled = torch.nn.Module(), CompiledStep(step)
    call = (lambda idx: warp_pool(pool, coords, idx)) if mode == "eager" else (
        lambda idx: compiled(model, torch.device("cuda"), dict(src_idx=idx)))
    call(good)  # under "graph": eager, then the capture
    call(good)  # under "graph": a replay, as is the bad call below
    torch.cuda.synchronize()
    print(f"{mode}: valid calls done", flush=True)
    call(bad)
    print(f"{mode}: the bad call returned without waiting", flush=True)
    torch.cuda.synchronize()
    print(f"{mode}: NOT CAUGHT", flush=True)
    return 0


def phase_graph_oor():
    """``[graph]``: the out-of-range ``src_idx`` in its subprocesses, both
    started together."""
    procs = {mode: subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"), "--oor-worker", mode],
                                    cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for mode in ("eager", "graph")}
    for mode, proc in procs.items():
        try:
            out, err_text = proc.communicate(timeout=180)
        finally:
            if proc.poll() is None:
                proc.kill()
        err = [ln for ln in err_text.splitlines() if "CUDA error" in ln or "assert" in ln.lower()]
        check(proc.returncode != 0 and f"{mode}: the bad call returned without waiting" in out
              and "NOT CAUGHT" not in out and err,
              f"[graph] src_idx outside the pool, {mode}: exit {proc.returncode}, stdout {out!r}, "
              f"stderr {err_text[-2000:]}")
        log(f"[graph] src_idx outside the pool ({mode}): the call returned without a host wait, the next "
            f"synchronisation failed, exit {proc.returncode}: {err[0].strip()[:160]}")


def phase_graph(wp_mod, models, tally, card):
    """``[graph]``: the three entry points as captured CUDA graphs (see the
    module's docstring).  ``models``: (name, f32 model, bf16 model).
    Returns the rows of numbers for PERF.md by label."""
    import torch
    from umetrack_torch.kinematics.hand import from_dict, load_generic_hand_dict
    from umetrack_torch.models import ModelConfig, make_model
    from umetrack_torch.parallel import eval as PE
    from umetrack_torch.tracker import HandTracker, compiled
    from umetrack_torch.tracker import tracker as T
    from umetrack_torch.utils.synthetic import make_sequences

    free_card()
    _, _, (rig_a, seq_a, hand_a) = rendered_sequence(EVAL_FRAMES, GRAPH_SEEDS[0], "cuda")
    _, _, (rig_b, seq_b, hand_b) = rendered_sequence(EVAL_FRAMES, GRAPH_SEEDS[1], "cuda")
    frames_a = [seq_a.map(lambda a, i=i: a[i]) for i in range(EVAL_FRAMES)]
    frames_b = [seq_b.map(lambda a, i=i: a[i]) for i in range(EVAL_FRAMES)]
    chunks_a = [seq_a.map(lambda a, i=i: a[i:i + EVAL_CHUNK]) for i in range(0, EVAL_FRAMES, EVAL_CHUNK)]
    chunks_b = [seq_b.map(lambda a, i=i: a[i:i + EVAL_CHUNK]) for i in range(0, EVAL_FRAMES, EVAL_CHUNK)]
    batch_a = make_sequences(S_BENCH, T_BENCH, seed=0, device="cuda")
    batch_b = make_sequences(S_BENCH, T_BENCH, seed=S_BENCH, device="cuda")
    cuda = torch.device("cuda")

    def entries(tracker):
        """(label, graphed, eager, capture input, replay inputs, init state,
        the scale head's forwards a call): graphed / eager map (input,
        state) to (result, state)."""
        model, config = tracker.model, tracker.config

        def frame(known, crops):
            def run(step_of):
                def go(obs_rig_hand, state):
                    rig, obs, hand = obs_rig_hand
                    return T._entry(step_of, model, cuda, dict(rig=rig, obs=obs, state=state, hand_model_mm=hand),
                                    config=config, min_num_crops=crops, known=known)
                return go
            return run(T._FRAME), run(T._FRAME.eager)

        def sequence(step_of):
            def go(rig_seq_hand, state):
                rig, seq, hand = rig_seq_hand
                return T._entry(step_of, model, cuda, dict(rig=rig, seq=seq, init_state=state, hand_model_mm=hand,
                                                          skel_hand_model_mm=None),
                                config=config, min_num_crops=1)
            return go

        def batched(step_of):
            def go(inputs, state):
                rigs, seqs, hands = inputs
                return T._entry(step_of, model, cuda, dict(rigs=rigs, seqs=seqs, init_state=state,
                                                          hand_models_mm=hands, skel_hand_models_mm=None),
                                config=config, min_num_crops=1)
            return go

        known = frame(True, 1)
        scale = frame(False, 2)
        return [
            ("track_frame, known skeleton", *known, (rig_a, frames_a[0], hand_a),
             [(rig_b, f, hand_b) for f in frames_b], tracker.init_state, 0),
            ("track_frame, scale head", *scale, (rig_a, frames_a[0], hand_a),
             [(rig_b, f, hand_b) for f in frames_b], tracker.init_state, 1),
            (f"track_sequence, chunks of {EVAL_CHUNK}", sequence(T._SEQUENCE), sequence(T._SEQUENCE.eager),
             (rig_a, chunks_a[0], hand_a), [(rig_b, c, hand_b) for c in chunks_b], tracker.init_state, 0),
            (f"track_sequences_batched S={S_BENCH} T={T_BENCH}", batched(T._SEQUENCES_BATCHED),
             batched(T._SEQUENCES_BATCHED.eager), batch_a, [batch_b],
             lambda: tracker.init_state(2 * S_BENCH), 0),
        ]

    generic = from_dict(load_generic_hand_dict(), device="cuda")

    def more_entries(tracker):
        """The calibrations and the batched evals, as :func:`entries` with
        the pool launches of a call and True (held bit for bit) put before
        the scale head's forwards:
        ``(result, state)`` each, the state threaded through the chunks of
        ``predict_scales_sequence``."""
        model, config = tracker.model, tracker.config

        def entry(step_of, trees, result=lambda out, state: (out, state), **static):
            def go(x, state):
                return result(T._entry(step_of, model, cuda, trees(x, state), config=config, **static), state)
            return go

        def pair(step, *args, **kw):
            return entry(step, *args, **kw), entry(step.eager, *args, **kw)

        def one(x, state):
            return dict(rig=x[0], seq=x[1], init_state=state, hand_model_mm=x[2])

        def many(x, state):
            return dict(rigs=x[0], seqs=x[1], init_state=state, hand_models_mm=x[2])

        batched_state = lambda: tracker.init_state(2 * S_BENCH)  # noqa: E731
        return [
            (f"calibrate_sequences_batched S={S_BENCH} T={T_BENCH}",
             *pair(T._CALIBRATE_BATCHED, many, n_calibration_samples=30, min_num_crops=2),
             batch_a, [batch_b], batched_state, 1, True, 1),
            (f"predict_scales_sequence, chunks of {EVAL_CHUNK}",
             *pair(T._PREDICT_SCALES, one, result=lambda out, _: (out[:2], out[2]), min_num_crops=2),
             (rig_a, chunks_a[0], hand_a), [(rig_b, c, hand_b) for c in chunks_b], tracker.init_state, 1, True,
             1),
            (f"calibrate_sequence, {EVAL_FRAMES} frames",
             *pair(T._CALIBRATE, one, n_calibration_samples=30),
             (rig_a, seq_a, hand_a), [(rig_b, seq_b, hand_b)], tracker.init_state, 1, True, 1),
            (f"eval_sequences_batched S={S_BENCH} T={T_BENCH}",
             *pair(PE._EVAL_BATCHED, lambda x, state: dict(many(x, state), skel_hand_models_mm=None,
                                                             lm_hand_models_mm=None), min_num_crops=1),
             batch_a, [batch_b], batched_state, 1, True, 0),
            (f"eval_sequences_unknown_batched S={S_BENCH} T={T_BENCH}",
             *pair(PE._EVAL_UNKNOWN, lambda x, _: dict(rigs=x[0], seqs=x[1], hand_models_mm=x[2],
                                                        generic_hand_model_mm=generic),
                   n_calibration_samples=30, min_num_crops=1),
             batch_a, [batch_b], batched_state, 2, True, 1),
        ]

    def run_all(fn, inputs, init, counted=None, n_pool=1, n_scale=0):
        """``fn`` over ``inputs`` with the state threaded; results of each."""
        state, outs = init(), []
        for x in inputs:
            out = (counted(lambda: fn(x, state), n_pool, "a compiled call", scale=n_scale) if counted
                   else fn(x, state))
            state = out[1]
            outs.append(out)
        return outs

    rows = {}
    for wname, m32, m16 in models:
        for dname, model in (("f32 (TF32)", m32), ("bf16", m16)):
            tracker = HandTracker(model, device="cuda")
            served = [e[:6] + (1, False, e[6]) for e in entries(tracker)]
            more = more_entries(tracker) if model is models[0][1] else []  # seeded weights, f32
            for label, graphed, eager, capture_in, replay_in, init, n_pool, strict, n_scale in served + more:
                full = f"{label}, {dname}, {wname}"
                n_before = len(compiled.cached())
                tally(lambda: graphed(capture_in, init()), n_pool, f"[graph] {full}: the capturing call",
                      scale=n_scale)
                captured = compiled.last_capture()
                check(captured is not None and captured.launched[0][0] == n_pool,
                      f"[graph] {full}: the capture recorded {captured and captured.launched[0]} pool launches")
                outs_g = run_all(graphed, replay_in, init, tally, n_pool, n_scale)
                outs_e = run_all(eager, replay_in, init, tally, n_pool, n_scale)
                same, gap = True, 0.0
                for g, e in zip(outs_g, outs_e):
                    s, d = tree_gap(g, e) if strict else hold_graph(g, e, full)
                    same, gap = same and s, max(gap, d)
                check(same or not strict, f"[graph] {full}: the replay differs from the eager call (max {gap:.3e})")
                check(compiled.last_capture() is captured, f"[graph] {full}: a replay recaptured")
                # the replays ran on B, not on the capture's A (where A and B give different results)
                first_a = eager(capture_in, init())
                check(tree_gap(outs_e[0], first_a)[0] or not tree_gap(outs_g[0], first_a)[0],
                      f"[graph] {full}: the replay on B equals the eager call on A")
                log(f"[graph] {full}: captured on A in {captured.capture_ms:.1f} ms, graph pool "
                    f"{captured.pool_bytes / 2**20:.1f} MiB; {len(replay_in)} replays on B against the eager "
                    f"calls on B: bit for bit {same}, max abs difference {gap:.3e}; {n_pool} warp_pool "
                    f"launch(es) a call (graphs cached {n_before} -> {len(compiled.cached())}) [{card}]")
                rows[full] = dict(capture_ms=captured.capture_ms, pool_mib=captured.pool_bytes / 2**20,
                                  bit_for_bit=same, max_abs=gap)
                if strict:
                    free_card()  # the S=64 graphs' pools are 10-13 GiB each

    # a TF32 toggle recaptures and replays without TF32; an in-place load is followed
    model = gate_weights(make_model(ModelConfig(), device="cuda"))
    ckpt = models[-1][1]
    tracker = HandTracker(model, device="cuda")
    for label, graphed, eager, capture_in, replay_in, init, _ in entries(tracker):
        x = replay_in[0]
        graphed(capture_in, init())
        captured_on = compiled.last_capture()
        on = graphed(x, init())
        with tf32_off():
            graphed(capture_in, init())
            captured_off = compiled.last_capture()
            off = graphed(x, init())
            eager_off = eager(x, init())
        check(captured_off is not captured_on, f"[graph] {label}: TF32 off did not recapture")
        same_off, gap_off = hold_graph(off, eager_off, f"{label}, TF32 off")
        tf32_moves = not tree_gap(on, off)[0]
        check(tf32_moves, f"[graph] {label}: the TF32-off replay equals the TF32-on one")
        graphed(x, init())  # TF32 on again: the first graph, still cached
        check(compiled.last_capture() is captured_on, f"[graph] {label}: TF32 on again recaptured")
        before = compiled.last_capture()
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(ckpt.state_dict())
        loaded = graphed(x, init())
        check(compiled.last_capture() is before, f"[graph] {label}: an in-place load recaptured")
        same_ld, gap_ld = hold_graph(loaded, eager(x, init()), f"{label}, after an in-place load")
        check(not tree_gap(loaded, on)[0], f"[graph] {label}: the replay did not follow the load")
        model.load_state_dict(saved)
        log(f"[graph] {label}, f32: TF32 off recaptured (key {len(compiled.cached())} cached), its replay "
            f"against eager TF32 off bit for bit {same_off} (max {gap_off:.3e}), moved from the TF32 replay; "
            f"after an in-place load_state_dict of the checkpoint the same graph replays the new weights: "
            f"bit for bit with eager {same_ld} (max {gap_ld:.3e})")
    del model, tracker

    phase_graph_oor()
    rows.update(graph_times(models[0], lambda tr: [e[:6] + (1, False, e[6]) for e in entries(tr)] + (
        more_entries(tr) if tr.model is models[0][1] else []), run_all, card))
    free_card()
    return rows


def graph_times(seeded, entries, run_all, card):
    """``[graph]`` times of every entry (the served steps, the calibrations
    and the batched evals), seeded weights, f32 (TF32) and bf16: ms a call or
    frame eager and graphed (host clock around the run, synchronised), the
    host's ms a call (until it returns, before the device is done), the
    batched call four deep, and the first GRAPH_PROFILED frames or chunks
    under torch.profiler for the device's busy share.  The eager forms are
    warm from :func:`phase_graph`'s comparisons."""
    import dataclasses

    import torch
    from umetrack_torch.tracker import HandTracker

    rows = {}
    _, m32, m16 = seeded
    for dname, model in (("f32 (TF32)", m32), ("bf16", m16)):
        tracker = HandTracker(model, device="cuda")
        for label, graphed, eager, capture_in, replay_in, init, _, strict, _ in entries(tracker):
            if label.startswith("track_frame, scale"):
                continue
            row = {}
            for form, fn in (("eager", eager), ("graphed", graphed)):
                if form == "graphed" or strict:
                    fn(capture_in, init())  # captured again if the cache dropped it; eager: the allocator warm
                host, state = [], init()
                torch.cuda.synchronize()
                start = time.perf_counter()
                for x in replay_in:
                    t0 = time.perf_counter()
                    _, state = fn(x, state)
                    host.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - start) * 1e3
                prof = profile_call(lambda: run_all(fn, replay_in[:GRAPH_PROFILED], init))
                profiled = min(len(replay_in), GRAPH_PROFILED)
                row[form] = dict(ms=wall / len(replay_in), host_ms=sum(host) / len(host),
                                 busy=prof["device_ms"] / prof["wall_ms"],
                                 device_ms=prof["device_ms"] / profiled, launches=prof["launches"] / profiled)
                if label.startswith("track_sequences_batched"):
                    (rigs, seqs, hands), = replay_in
                    variants = [dataclasses.replace(seqs, images=seqs.images + (i + 1)) for i in range(GRAPH_PIPELINE)]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for v in variants:
                        fn((rigs, v, hands), init())
                    torch.cuda.synchronize()
                    row[form]["pipelined_ms"] = (time.perf_counter() - t0) * 1e3 / GRAPH_PIPELINE
            unit = "frame" if label.startswith("track_frame") else "call"
            piped = {f: (f", {GRAPH_PIPELINE} deep {row[f]['pipelined_ms']:.1f} ms a call"
                         if "pipelined_ms" in row[f] else "") for f in row}
            text = {f: (f"{row[f]['ms']:.3f} ms a {unit} (host {row[f]['host_ms']:.3f} ms a "
                        f"{'replay' if f == 'graphed' else 'call'}, under the profiler device "
                        f"{row[f]['device_ms']:.3f} ms and {row[f]['launches']:.0f} kernels a {unit}, busy "
                        f"{row[f]['busy']:.3f}{piped[f]})") for f in row}
            log(f"[graph] {label}, {dname}, seeded weights, {len(replay_in)} {unit}s: eager {text['eager']}; "
                f"graphed {text['graphed']}: {row['eager']['ms'] / row['graphed']['ms']:.2f} x [{card}]")
            rows[f"{label}, {dname} times"] = row
            if strict:
                free_card()
    return rows


def kernel_entry(name, source, replaces, by_path, numbers, shapes=()):
    """``launches``: the kernel's launches over the main paths' runs, each
    path counted from 0 (``launches_by_path`` says which path made how many).
    The times are those at the first path's shape; ``shapes`` holds the same
    numbers at the other shapes a path gives the kernel, and ``max_abs_err``
    is the largest over all of them."""
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max([numbers["max_abs_err"]] + [row["max_abs_err"] for row in shapes]),
        "shapes": list(shapes),
        "ms": numbers["ms"], "kernel_ms": numbers["kernel_ms"], "plain_ms": numbers["plain_ms"],
        "bound_ms": numbers["bound_ms"], "bound_by": numbers["bound_by"],
        "library_ms": None, "nearest_library": NEAREST_LIBRARY, "nearest_library_ms": numbers["grid_sample_ms"],
    }


def bn_entry(rows, edge_err, by_path, by_layout):
    """The one-pass BatchNorm's line of the kernel table: its times at the
    stem's f32 shape, every shape in ``shapes``; ``by_layout``: each tallied
    path's launches by the kernel's path and layout, and its backbone
    forwards by layout."""
    stem = rows[0]
    return {
        "name": "batch_norm_act", "route": "cuda", "source": "umetrack_torch/csrc/bn_act.cu",
        "replaces": None, "launches": sum(by_path.values()), "launches_by_path": by_path,
        "launches_and_forwards_by_layout": by_layout,
        "max_abs_err": max([edge_err] + [row["max_abs_err"] for row in rows]), "shapes": rows,
        "ms": stem["ms"], "kernel_ms": stem["kernel_ms"], "plain_ms": stem["plain_ms"],
        "bound_ms": stem["bound_ms"], "bound_by": stem["bound_by"], "library_ms": stem["library_ms"],
        "library": "the unfused PyTorch sequence (the plain version), which the port no longer calls "
                   "on the card",
    }


def free_card():
    """Drop the compiled steps' graphs and the allocator's cached blocks
    between phases."""
    import torch
    from umetrack_torch.tracker import compiled

    compiled.release()
    torch.cuda.empty_cache()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = phase_device()
    wp_mod, wi_mod, zstd_build_s = phase_build()

    from umetrack_torch.models import ModelConfig, make_model
    from umetrack_torch.tracker import HandTracker
    from umetrack_torch.utils.synthetic import make_sequences

    t0 = time.perf_counter()
    rigs, seqs, hands = make_sequences(S_BENCH, T_BENCH, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[inputs] {S_BENCH} sequences x {T_BENCH} frames, images {tuple(seqs.images.shape)} "
        f"{seqs.images.dtype}, made in {time.perf_counter() - t0:.1f} s")

    pool_kern, pool_operands = phase_kernel(wp_mod, rigs, seqs, hands, card)
    image_kern = phase_image_kernels(wi_mod, wp_mod, pool_operands, card)
    del pool_operands
    free_card()
    bn_rows, bn_edge_err = phase_bn_act(card)
    free_card()
    from umetrack_torch.ops.bn_act import batch_norm_act

    model_cuda = gate_weights(make_model(ModelConfig(), device="cuda"))
    pool_launches, bn_slice = phase_slice(wp_mod, model_cuda, rigs, seqs, hands, card)
    phase_layout(model_cuda, rigs, seqs, hands, card)
    tracker = HandTracker(model_cuda, device="cuda")
    phase_profile(lambda: tracker.track_sequences_batched(rigs, seqs, hands),
                  "one track_sequences_batched call", "warp_pool_kernel", card)

    # the bf16 paths: ``bf16_tally`` sets the pool kernel's counter to 0 just
    # before each of their entry-point calls and reads it just after
    model16 = gate_weights(make_model(ModelConfig(compute_dtype=BF16), device="cuda"))
    bf16_tally = LaunchTally(wp_mod.warp_pool, batch_norm_act)
    phase_bf16_tracker(wp_mod, model_cuda, model16, bf16_tally, rigs, seqs, hands, card)
    bf16_tracker_launches = bf16_tally.total
    del rigs, seqs, hands
    free_card()

    win_launches, full_launches, win_bf16 = phase_torchdata_slice(wp_mod, wi_mod, model_cuda, card)

    model_cpu = gate_weights(make_model(ModelConfig(), device="cpu"))
    phase_cpu_vs_card(model_cpu, model_cuda, wp_mod, wi_mod)
    phase_torchdata_cpu_vs_card(model_cpu, model_cuda)

    # the raw_data evaluation slice: ``tally`` sets the pool kernel's counter
    # to 0 just before each entry-point call of the path and reads it just
    # after; what the comparisons, timings and profiles launch stays out
    ckpt_cpu, ckpt_cuda = phase_checkpoint(card)
    models = [("seeded weights", model_cuda, STRICT), ("checkpoint", ckpt_cuda, TRAINED)]
    ckpt16 = make_model(ModelConfig(compute_dtype=BF16), device="cuda")
    ckpt16.load_state_dict(ckpt_cuda.state_dict())

    # the compiled steps: each capturing, replayed and eager call counted from 0
    t_graph = time.perf_counter()
    graph_tally = LaunchTally(wp_mod.warp_pool, batch_norm_act)
    phase_graph(wp_mod, [("seeded weights", model_cuda, model16), ("checkpoint", ckpt_cuda, ckpt16)],
                graph_tally, card)
    log(f"[graph] the phase took {time.perf_counter() - t_graph:.1f} s, {graph_tally.total} warp_pool "
        f"launches over its tracker calls")
    tally = LaunchTally(wp_mod.warp_pool, batch_norm_act)
    eval_shapes = phase_streaming(wp_mod, models, tally, card)
    rigs, seqs, hands = make_sequences(S_BENCH, T_BENCH, seed=0, device="cuda")
    phase_unknown(models, tally, rigs, seqs, hands, card)
    orbax_tally = LaunchTally(wp_mod.warp_pool, batch_norm_act)
    phase_orbax(ckpt_cuda, orbax_tally, rigs, seqs, hands, zstd_build_s, card)

    # the batched and sharded evaluation, each entry-point call counted from 0
    batch_tally = LaunchTally(wp_mod.warp_pool, batch_norm_act)
    unsharded = phase_batched_eval(models, batch_tally, rigs, seqs, hands, card)
    phase_process_group(model_cuda, batch_tally, rigs, seqs, hands, unsharded, card)
    log(f"[batched-eval] warp_pool launches over the batched evaluation's entry-point calls: "
        f"{batch_tally.total}")
    del rigs, seqs, hands, unsharded
    free_card()

    # the tensor-parallel model axis: worker processes sharing this card
    t_tp = time.perf_counter()
    tp_launches = phase_tp(ckpt_cuda, card)
    log(f"[tp] the phase took {time.perf_counter() - t_tp:.1f} s")
    free_card()
    f32_known = phase_eval_apps(models, tally, card)
    log(f"[eval] warp_pool launches over the evaluation path's entry-point calls: {tally.total}")
    phase_eval_cpu_vs_card([("seeded weights", model_cpu, model_cuda, STRICT),
                            ("checkpoint", ckpt_cpu, ckpt_cuda, TRAINED_CPU)])

    # the raw_data evaluation in bf16: the checkpoint's weights in a bf16 model
    eval16_tally = LaunchTally(wp_mod.warp_pool, batch_norm_act)
    phase_bf16_streaming(wp_mod, [("seeded weights", model16, BF16_LOOP),
                                  ("checkpoint", ckpt16, BF16_LOOP_TRAINED)], eval16_tally, card)
    phase_bf16_eval_app(eval16_tally, f32_known, card)
    log(f"[bf16] warp_pool launches over the bf16 paths' entry-point calls: tracker and batched eval "
        f"{bf16_tracker_launches}, raw_data eval {eval16_tally.total}")

    del ckpt_cpu, ckpt_cuda, ckpt16, models, model_cpu, model_cuda, model16, tracker
    free_card()

    # the training slice: each entry-point call counted from 0 (the
    # comparisons with the plain versions, phase_train_kernels, come before
    # the resident step's profile, after which the profiler loses launches)
    t_train = time.perf_counter()
    phase_train_cpu_vs_card()
    train_rows = phase_train_kernels(wp_mod, wi_mod, card)
    prep_launches, corpus, f32_step_ms = phase_resident(wp_mod, wi_mod, card)
    phase_bf16_resident(corpus, f32_step_ms, card)
    t_tg = time.perf_counter()
    formats = collections.Counter(batch_norm_act.formats)
    phase_train_graph(corpus, card)
    formats = dict(collections.Counter(batch_norm_act.formats) - formats)
    check("channels_last" not in formats, f"[train-graph] channels-last forwards in training: {formats}")
    log(f"[train-graph] the phase took {time.perf_counter() - t_tg:.1f} s; backbone forwards by "
        f"layout {formats} (train mode: NCHW)")
    del corpus
    free_card()
    syn_launches, tree_launches, syn_bf16 = phase_train_app(wp_mod, wi_mod, card)
    distill_pool, distill_full, _ = phase_distill(wp_mod, wi_mod, card)
    log(f"[train] the training phases took {time.perf_counter() - t_train:.1f} s")
    free_card()

    # the accuracy workflow: each driver call counted from 0
    acc, acc_full_row = phase_accuracy(wp_mod, wi_mod, card)

    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": [
        kernel_entry("warp_pool", "umetrack_torch/csrc/warp_pool.cu",
                     "umetrack_tpu/ops/pallas_resample.py:243",
                     {"tracker": pool_launches, "compiled steps": graph_tally.total,
                      "raw_data eval": tally.total,
                      "batched eval": batch_tally.total, "orbax checkpoint tracker": orbax_tally.total,
                      "train prepare_tracker_sequences": prep_launches, "distill eval": distill_pool,
                      "bf16 tracker and batched eval": bf16_tracker_launches,
                      "bf16 raw_data eval": eval16_tally.total,
                      **{path: n for path, n in tp_launches.items() if "eval" in path},
                      **{f"accuracy: {label}": got[0] for label, got in acc.items() if got[0]}},
                     pool_kern, eval_shapes + [train_rows["warp_pool"]]),
        kernel_entry("warp_image_windowed", "umetrack_torch/csrc/warp_image.cu",
                     "umetrack_tpu/ops/pallas_resample.py:174",
                     {"torch_data": win_launches, "train app 480 x 640 tree": tree_launches,
                      "bf16 torch_data": win_bf16},
                     image_kern["warp_image_windowed"], [train_rows["warp_image_windowed"]]),
        kernel_entry("warp_image_full", "umetrack_torch/csrc/warp_image.cu",
                     "umetrack_tpu/ops/pallas_resample.py:68",
                     {"torch_data 120 x 160": full_launches, "train app synthetic": syn_launches,
                      "distill": distill_full, "bf16 train app synthetic": syn_bf16,
                      **{path: n for path, n in tp_launches.items() if "train app" in path},
                      **{f"accuracy: {label}": got[1] for label, got in acc.items() if got[1]}},
                     image_kern["warp_image_full"], [train_rows["warp_image_full"], acc_full_row]),
        bn_entry(bn_rows, bn_edge_err,
                 {"tracker": bn_slice, "compiled steps": graph_tally.bn_total, "raw_data eval": tally.bn_total,
                  "batched eval": batch_tally.bn_total, "orbax checkpoint tracker": orbax_tally.bn_total,
                  "bf16 tracker and batched eval": bf16_tally.bn_total,
                  "bf16 raw_data eval": eval16_tally.bn_total},
                 {label: (dict(t.bn_paths), dict(t.formats)) for label, t in (
                     ("compiled steps", graph_tally), ("raw_data eval", tally),
                     ("batched eval", batch_tally), ("orbax checkpoint tracker", orbax_tally),
                     ("bf16 tracker and batched eval", bf16_tally), ("bf16 raw_data eval", eval16_tally))}),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(*sys.argv[2:]))
    if sys.argv[1:2] == ["--oor-worker"]:
        sys.exit(oor_worker(*sys.argv[2:]))
    sys.exit(main())
