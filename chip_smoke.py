#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vn_pointcloudcompletion_tpu_torch``)
on one NVIDIA GPU:

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, the TF32 settings and cuBLAS's bf16 reduced-precision switch.
2. Builds every kernel under ``vn_pointcloudcompletion_tpu_torch/csrc/``
   (one ``nvcc`` per source, all at once) and prints the build time.
3. Holds each of the fourteen kernels (A, A', S, S', B, B', C, C', D, K1,
   K2, K3, F, E), and the bf16 modes of A, A', S, S', B, B', C, C' and K3,
   against its plain
   PyTorch version on the card at the shapes of
   the main paths (batch 8), with the tolerance stated beside it (K1, K2,
   K3 and F: indices equal; K1 and K2 on VN DGCNN conv1's own input, whose
   repeated points tie), times both with CUDA events, runs the
   backward-slice and DGCNN kernels twice to show that they give the same
   bits, and holds the backward of K2 and K3
   against autograd of their plain chains.  Every row prints its share of
   its bound, and its time a call in a run of calls back to back
   (``stream_ms``: the wrapper's host time hidden behind the card's).  Each B, C, S, S', C' and B' row names the design it took (C,
   S, S', C' wide at C_in, C_out >= 16; at C_in <= 2 B the store stream, S
   the channel walk "stream", S' and B' the fused walk; else narrow), its
   TFLOP/s, GB/s and share of its bound, and, for a wide, fused or stream
   row, the narrow design's time at the same shape in the same call (S and
   S' at C_in <= 2: a call, back to back and on the device, each with its
   share of the bound, ``walk_vs_narrow``); B's and S's stream designs must
   give the narrow design's bits (float32 and bf16, groups 0 and 64); bf16 C
   (fwd_bf16_design "wgmma": p and d on wgmma fed by TMA, persistent blocks
   over x tiles resident in shared memory, no second pass) at 256 -> 256
   (N 16384), at vn_pointr_448's 256 -> 128 (N 14336) and at 256 -> 128
   with group 64 biases (on no path) is held to BF16_C_RMS, its mutant at
   least 4x beyond, and to the parent "wide" design's bits (proj_wide_mma
   and proj_sum), timed beside it (a call, back to back, on the device,
   kernel by kernel) with torch.bmm of its two products (proj_vs_parent); D
   (one sweep for both directions) is also timed at the training loss's
   coarse pair (1024 x 16384) and at 448 x 14336, twice for equal bits;
   S is timed at final_conv.0's 2 -> 256 (stream, both types) and at 256 ->
   128 (wide, both types), and its wide design's bits are compared with the
   narrow one's; S' at final_conv.0's 2 -> 256 (fused, both types); F at the
   paths' 2048 -> 512, 512 -> 128 and 2048 -> 224 with its dependency floor
   (the same launch without the per-point arithmetic), K3 in both modes at
   the five path shapes (EDGE_SHAPES: "coords" over coordinates, "tiled"
   over vn_pointr's features) beside the parent "warp" design, both by
   device time too (graph_ms; K3 split into its selection and its gather);
   K2 at every path shape (KNN_SHAPES: D 3, "coords") on the scans and on
   the lane-tie cloud against its plain version, twice and against the
   parent "warp" design for equal bits, and A in bf16 at every path shape
   (A_BF16_SHAPES, "run8") against its plain version and the parent
   "vector" design, equal to the bit; both timed beside their parent
   design (versus_parent: a call, back to back, on the device), K2 also
   against cdist + topk, and at D 64, k 40 (the warp design); K1 in its
   "stream" design (topk_design) over the (8, 2048, M) distance matrices of
   the rotated scans (K1_SHAPES: M 2048 at k 16, 40 and 64, M 4096 at k 16),
   each equal to its plain version, a second launch and the parent "warp"
   design, timed beside the parent design and torch.topk.  The bf16 S, S'
   and C' at 256 -> 256 (N 16384) and 256 -> 128 (N 14336) take their
   pass-1 designs (ops/vn_layer_fused.py::pass1_bf16_design: "wgmma_p",
   p (C': p and d) on wgmma fed by TMA; S' and C' then passes 2 and 3 on
   wgmma), each timed beside the parent design (S "wide", S' and C'
   "wgmma": pass 1 on mma.sync; versus_parent: a call, back to back, on
   the device) and pass by pass in both designs (wgmma_vs_parent: the W^T
   transpose, pass 1, the sums' reduction, pass 2, pass 3 and the split-K
   reduction, from torch.profiler's kernel durations over whole calls),
   with torch.matmul of each pass's bf16 products (float32 out) beside them
   as a yardstick; C' held to its plain version summing p, d in the
   tensor cores' k16 order (``launch_order``).  Before them the tensor
   cores' k16 step against its plain model on tools/probe_k16.py's crafted
   operands, every float32 accumulator in bits (k16_probe); S's p equal in
   bits to S''s and to the model's (same_p); C''s p, d (pd_out) equal in
   bits to the forward C's, the model's and S's p (S run with W, and with
   Wd for d), its outputs to the mma.sync design's (C' "wgmma": pass 1
   pd_wide_mma, the same k16 steps; a design of this tree, not the
   in-order one it replaced), on the row's inputs and on adversarial ones
   (every p, d a few float32 ulps from a bf16 midpoint), the fault (the
   p, d elements and leaky sides that part from the forward C's) 0
   (c_bwd_checks).
3b. K1's path: ``knn()`` at (8, 2048 vs 2048, D 768, k 16) (features past
   K2's D 512), counted: K1 once in its stream design and nothing else; the
   indices equal to the plain selection's over the same matrix (one batched
   product in full float32, checked against float64 and unchanged with TF32
   allowed); the call's time.
   Phases 4-13 check that every counted B took the stream design, every C
   the wide one, every B' the fused pass, every F its one design, every K2
   the coords design, every A in bf16 the run8 design and every K3 its
   path's (check_designs); phase 11 that the classic DGCNN's K2 took coords
   over its coordinates and warp over its 64 features; and phases 5, 7, 9
   and 13 that kernel S took its design at every layer of every step
   (check_stats_designs).
4. Serving the flagship at full width (encoder latent 1024 -> 2048-channel
   global feature, 2048 input points, 1024 coarse, 16384 dense points,
   random weights from a seed) through the port's command line: ``predict``
   on 8 partial PLYs and ``test`` on 2 batches of the synthetic set, with
   every launch counter set to 0 just before and read just after; then the
   whole forward through the kernels against the port's plain path.
5. Training the flagship at the same width through the command line:
   ``overfit`` at batch 8 for a few epochs (one step and one validation
   batch each), with the counters set to 0 just before and read just after
   (exactly FLAGSHIP_EPOCH_LAUNCHES an epoch, phase 17c), the losses
   checked finite and falling, the checkpoints checked, and ``train
   --resume`` for one more epoch.
5b. The decoder's backward through the kernels against float64; one train
   step through the kernels against the same step through the plain path
   on the same model and batch (losses, every gradient, the running
   statistics), with the designs of its S, S' and C' launches asserted
   (FLAGSHIP_STEP_DESIGNS); the median step time of both; and
   torch.profiler's device time by kernel over three steps through the
   kernels.
6, 7. Phases 4 and 5 for ``vn_dgcnn_fps`` + ``vn_foldingnet`` (1024
   coarse, 16384 dense), the launches of each forward asserted (K2 2, K3 2,
   F 2, A 3, B 2, C 1); 7b: the gradients of the encoder alone and of one
   train step through the kernels, through the plain path and through the
   plain path in float64, the three on one set of discrete decisions
   (``DecisionTape``), each tensor held to a bound; both step times, peak
   memory, and a profile.
8. Phases 4 and 5 for ``dgcnn_fps`` + ``foldingnet`` at ``num_coarse``
   448 (224 predicted + 224 FPS points, 14336 dense; K2 4 and F 3 per
   forward); 8b: one train step through the kernels against the plain
   path, equal, and both paths' step and eval forward times.
9. Phases 4 and 5 for ``vn_pointr`` + ``attention_vn_foldingnet`` at
   ``num_coarse`` 448, the root ``config.json``'s pipeline in the float32
   policy (K2 2, K3 3, F 3, A 3, B 1 and B with group=S 2, C 2 per
   forward), the forward through the kernels against the plain path on one
   set of discrete decisions; 9b: the gradients of the grouper alone and
   of the decoder alone (the parts that run kernels) through the kernels,
   through the plain path and in float64 on one set of decisions, each
   held to a bound; one whole train step, each run deciding alone, printed
   as information beside the plain path from inputs one ulp away; both
   step times, peak memory, a profile.
   Phase 3 checks B, C, S and their backwards in group=S mode at the pair
   folds' shape, and K2 at k = 8 on the grouper's own 128 centres; and
   kernel E (the approximate EMD's annealing rounds) at (8, 16384) vs
   (8, 16384) on synthetic scans (timed, twice for equal bits) and Gaussian
   clouds, at 14336 (timed) and 4096 vs 16384, against float64 at
   (2, 4096), and the gradient of the trainable EMD from its moments.
10. ``--emd test`` through the command line on the flagship and on
   ``vn_pointr_448`` (14336 points), counted (E once per batch), one batch's
   EMD column through E against the plain version; 10b: ``overfit`` +
   ``--resume`` of the flagship with ``coarse_loss`` ``emd`` and ``dcd``
   (dense matching at 1024 points: no E launch, as in JAX).
11. The standalone ``PCN``, ``VNPCN`` and classic ``DGCNN`` (k 40) at batch
   8, 2048 points: each forward through the kernels against the plain path,
   the launches of one forward asserted (DGCNN: K2 4, two coords and two
   warp), K2 at k 40 on the synthetic partials against its plain version.
12. The bfloat16 policy's serving path (``nn/precision.py``): the eval
   forwards of the flagship, ``vn_dgcnn`` and ``vn_pointr_448`` at full
   width, batch 8, under ``compute_dtype_scope(torch.bfloat16)``, each
   counted (A, B, C and K3 in their bf16 modes only, counted under
   ``<symbol>[bf16]`` and ``[group,bf16]``; D, K2 and F in float32), each on
   one DecisionTape against the plain path in bf16 and in float32, a mutant
   of kernel C caught; the flagship metric step counted; median times of
   each in float32 and bf16.  Phase 3 holds the bf16 modes (A, B at group 0
   and 64, C, K3) against their plain bf16 versions, bounds with the
   products at the bf16 tensor-core rate and the float32 elementwise work
   at the FP32 rate (A's and K3's all float32).
13. The bfloat16 policy's training path: ``train`` + ``train --resume``
   on the root ``config.json`` (vn_pointr + attention_vn_foldingnet at
   448, dtype bfloat16, batch 8; synthetic data at full width), the
   launches of the run and of one train step asserted exactly (only the
   bf16 modes of A, A', B, B', C, C', S, S' and K3); the flagship's bf16
   train step on one DecisionTape through the kernels, through their plain
   versions in the kernels' place and through the plain path in bf16 and
   float32, each gradient held to two bounds, and a mutant of C''s bf16
   backward caught; the designs of both steps' S, S' and C' launches asserted
   (BF16_STEP_DESIGNS); float32/bf16 step times and peaks of the flagship
   and vn_pointr_448.  Phase 3 holds the bf16 modes of the training kernels
   (A'; S, S', B' at group 0 and 64; C') against their plain bf16 versions,
   twice for equal bits.
14. The trainer's options.  (a) ``remat`` on the flagship in float32 at
   full width, batch 8: one train step through the kernels with ``remat``
   between two without, from the same weights on the same batch: losses,
   gradients, parameters after the update and running statistics equal in
   bits to the plain step's (or, where the plain step does not repeat its
   own bits, within STEP_TOL of each tensor's max), the forward kernels
   launched twice and every other kernel once (REMAT_FORWARD; the designs
   FLAGSHIP_STEP_DESIGNS with the forward's doubled); peak device memory
   and CUDA-event step time with and without ``remat`` at batch 8 and 16
   (``utils/profiling.py``).  (b) The same on the root ``config.json``
   (vn_pointr_448) under the bf16 policy: the launches BF16_STEP_LAUNCHES
   with the forward's doubled, no float32-mode launch.  (c) ``--ckpt_path``
   through the command line: ``overfit`` of the flagship with phase 5's
   ``model_best.pth`` as a pretrained encoder, which stays equal to the
   file's bits while its BatchNorm statistics and the decoder move; the
   nine training kernels launched.  (d) ``-from``: a source run with
   ``checkpoint_every 1``, then a run branched from its epoch 1, which
   holds a byte copy of the pair, logs ``[BRANCH INFO]``, starts at epoch 2
   from the pair's weights; ``-from`` a missing epoch raises.
15. vn_pointr's decoder stack (``pointr_decoder``: the root ``config.json``'s
   pipeline, PATHS ``vn_pointr_448_dec``) at full width: embed 384,
   enc_depth 6, dec_depth 8, 224 queries, 448 coarse and 14336 dense
   points, batch 8, random weights from seed 0, synthetic data.  (a) Phase
   4 on it: ``predict`` + ``test`` counted (FORWARD_LAUNCHES: vn_pointr_448's
   with K2 4, every K2 in the coords design), the forward through the
   kernels against the plain path on one DecisionTape within
   POINTR_FWD_TOL, the refined queries included.  (b) ``overfit`` + ``train
   --resume`` + ``--resume test``, counted; one train step counted
   (STEP_LAUNCHES); the stack alone (``VNPCTransformer.refine``) and the
   attention decoder with its ``query_proj`` alone, each through the
   kernels, the plain path and float64 on one tape (POINTR_STEP_TOL and
   POINTR_QUERY_DEC_TOL);
   the eval forward and the step of vn_pointr_448 with and without the
   stack in turns, with peak memory (``step_cost``), and a profile.  (c)
   The same forward and a train step under the bf16 policy, as phases 12
   and 13 check the root config (launches and designs exact), with float32
   and bf16 times of both models.  (d) The scalar ``VNPCTransformer``
   (``dgcnn="dgcnn"``, ``trans="trans"``, ``only_coarse=False``) at the same
   width, which the composer never builds: one forward counted (K2 7, F 3)
   against the plain path on one tape.  Phase 3 holds K2 at the stack's two
   graphs too (KNN_SHAPES: 224 vs 224 and 224 vs 128, k 8), timed beside
   the parent design and cdist + topk.
16. ``--mesh``, the flagship at full width.  (a) ``train --mesh 1`` over
   NCCL (one rank: no BatchNorm collective, the gradient all-reduce) through
   the CLI, counted as phase 5 (every flagship kernel, B, C, B', S by
   design a step), then ``--resume test``; the same run without ``--mesh``
   ends with the same bits in every parameter and buffer; the step at
   world size 1 against the step without a mesh in turns, and the gradient
   all-reduce alone.  (b) Two ranks sharing the card over gloo with CUDA
   tensors (NCCL refuses two ranks on one GPU), global batch 16: the first
   step, each rank replaying its rows of the one-process step's
   DecisionTape, against the one-process step within MESH_STEP_TOL and,
   with float64 on that tape, each tensor no further from float64 than
   DGCNN_F64_RATIO x the one process; parameters, buffers and Adam's state
   equal in bits on both ranks; each rank's step time and the time in its
   all-reduces.  The kernels line's ``mesh_launches``: phase 16a's counts.
17. The JAX package's last modules.  (a) The partial-scan renderer
   (``data/render.py``) on the card: ``generate_partials`` of a 16384-point
   synthetic complete cloud at 8 views, image 160, equal point for point
   and in order to the port's CPU version, its time (median of CUDA-event
   timings after warm-up) beside the CPU version's (host clock); then the
   render entry (``render_root``) over a synthetic 32-model PCN root, on
   the card and on the CPU, every file equal in bytes, models/s of both.
   (b) ``voxel2obj`` (``utils/obj_io.py``) of the flagship's dense
   prediction voxelised at 64^3 on the card, byte-identical to the CPU
   path's file.  (c) In phase 5: the trainer draws each epoch's figure
   (JAX's per-epoch PNG): where matplotlib imports, ``epoch_NNN.png`` of
   every epoch exists, else each run's log holds the one warning naming
   it; phase 5's launches are exactly FLAGSHIP_EPOCH_LAUNCHES a epoch, as
   before the figure.  (d) bf16 convergence: OVERFIT_STEPS guarded train
   steps of the flagship on one synthetic batch of 8 (``overfit``'s
   data), float32 and bf16 from the same weights, both loss curves printed
   every 20 steps; fails on a non-finite loss or a final loss (the mean of
   the last 10 steps) not below half the first step's.  The ``.ckpt``
   reader (``training/flax_msgpack.py``) runs on the host before any card
   work and needs JAX's files, which this machine cannot write: its checks
   are the CPU tests.

Every phase prints its wall time.  Any failure exits non-zero.  The line
before the last is a JSON object with one record per kernel (its launches
are those of the training run of its path: phase 5 for the flagship's nine,
phase 7 for K2, K3 and F, phase 9 for the group=S rows, phase 10's two
``--emd test`` runs for E, phase 12 for the bf16 rows of A, B, C and K3,
phase 13 for those of the training kernels, phase 3b's ``knn()`` call for
K1, which no model reaches; C and C' in group=S mode are on no model's
path); the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM, NVIDIA's data sheet: FP32 outside the tensor cores, dense bf16
# on the tensor cores (the bound of the bf16 rows), HBM3 rate.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
BATCH = 8
NS = 0.2  # the VN leaky slope of every layer on the path
TRAIN_EPOCHS = 16  # phase 5: epochs 0..15, then one more with --resume
# Phase 5b, each gradient's max|dg| / max|g|: the whole step through the
# kernels against the plain path (measured 1.70e-4 at full width, batch 8),
# and the decoder's backward through the kernels against float64 (measured
# 2.86e-3; the plain path 2.90e-3).  Both stem from float32 sums in the
# BatchNorm-on-norms variance (PERF.md, PR 2 finding).
STEP_TOL = 3e-4
# Phase 7b, the VN DGCNN model's gradients, the three paths on one set of
# discrete decisions (DecisionTape), each max|dg| / max|g|: the kernels
# against the plain path (measured 1.66e-3 for the train step), and each
# tensor's distance from float64 through the kernels against the plain
# path's, at most DGCNN_F64_RATIO times it or its floor (measured 3.97x).
# The reflections inside B and C (conv1, decoder) cannot be replayed, and
# the norm-BatchNorm's float32 conditioning puts the plain path itself up
# to 9.1e-4 from float64 (PERF.md, section 6).
DGCNN_STEP_TOL = 4e-3
DGCNN_F64_RATIO, DGCNN_F64_FLOOR = 8.0, 1e-4
DEC_F64_TOL = 4e-3
# Phases 9 and 9b, vn_pointr (NVIDIA H100 80GB HBM3, 700 W; PERF.md, PR 4):
# the eval forward through the kernels against the plain path on one set of
# discrete decisions, each output's max|d| / max (measured 3.5e-7: kernel C
# rounds otherwise than cuBLAS); the grouper alone and the decoder alone,
# each for a fixed cotangent on one set of decisions, each gradient against
# the plain path within POINTR_STEP_TOL (measured 2.71e-4 and 1.11e-3) and
# its distance from float64 within POINTR_F64_RATIO x the plain path's
# (measured 1.01x and 1.03x).
POINTR_FWD_TOL = 2e-6
POINTR_STEP_TOL = 4e-3
POINTR_F64_RATIO = 2.0
# Phase 15b, the attention decoder with ``query_proj`` alone on one tape, fed
# the decoder stack's refined queries: kernels vs plain, each gradient's
# max|dg| / max|g| (measured 7.38e-3 at vn_folding2.0's direction map,
# NVIDIA H100 80GB HBM3, 700 W).  The reflections inside kernels B and C
# decide by themselves (DecisionTape), and with the queries added to the
# centres' features more of them lie near their boundary than in phase
# 9b's decoder (1.11e-3); the plain path itself lies 2.8e-2 from float64
# there, and POINTR_F64_RATIO holds each tensor of the kernel path to the
# plain path's distance from float64 (measured 1.16x at most).
POINTR_QUERY_DEC_TOL = 2e-2
FORWARD_KERNELS = ("vn_bn_leaky_fwd", "vn_layer_fused_fwd",
                   "vn_layer_fused_project_fwd", "chamfer_nn_bidir")
# The pipelines each driven at full width (batch 8, 2048 input points) by
# its own serve (and train) phase, and the launches of one eval forward of
# the DGCNN ones, as the JAX package's TPU dispatch gives them: VN DGCNN
# conv1 K2 + B, two F, conv4/conv5 K3 + A each, conv6 K2 (its C3 of 3072
# fails K3's gate) + gather + A, conv7 plain, decoder B + C; DGCNN layer1-4
# K2 each, two F and a third for the 224 FPS points of num_coarse 448.
PATHS = {
    "flagship": {"enc_type": "vn_pointnet", "dec_type": "vn_foldingnet", "num_coarse": 1024},
    "vn_dgcnn": {"enc_type": "vn_dgcnn_fps", "dec_type": "vn_foldingnet", "num_coarse": 1024},
    "dgcnn_448": {"enc_type": "dgcnn_fps", "dec_type": "foldingnet", "num_coarse": 448},
    "vn_pointr_448": {"enc_type": "vn_pointr", "dec_type": "attention_vn_foldingnet",
                      "num_coarse": 448},
}
# phase 15: the root config.json's pipeline with vn_pointr's decoder stack
PATHS["vn_pointr_448_dec"] = {**PATHS["vn_pointr_448"], "pointr_decoder": True}
# vn_pointr: grouper conv1 K2 + B, two F, conv4-6 K3 + A each (conv6's C3 of
# 768 passes K3's gate), the proxy graph K2 (k 8), the FPS tail F; the
# decoder's pair folds B with group=S, vn_folding{1,2}.1 + .2 C.
FORWARD_LAUNCHES = {
    "vn_dgcnn": {"knn_min": 2, "edge_knn_gather": 2, "furthest_point_sample": 2,
                 "vn_bn_leaky_fwd": 3, "vn_layer_fused_fwd": 2,
                 "vn_layer_fused_project_fwd": 1},
    "dgcnn_448": {"knn_min": 4, "furthest_point_sample": 3},
    "vn_pointr_448": {"knn_min": 2, "edge_knn_gather": 3, "furthest_point_sample": 3,
                      "vn_bn_leaky_fwd": 3, "vn_layer_fused_fwd": 1,
                      "vn_layer_fused_fwd[group]": 2, "vn_layer_fused_project_fwd": 2},
}
# with the decoder stack, K2 also for its self (224 vs 224) and cross (224
# vs 128) graphs, k 8; the stack's VN layers are vec layout: no kernel
FORWARD_LAUNCHES["vn_pointr_448_dec"] = {**FORWARD_LAUNCHES["vn_pointr_448"], "knn_min": 4}
# phase 15d, the scalar VNPCTransformer (dgcnn="dgcnn", trans="trans",
# only_coarse=False): its trunk's four k 16 graphs, the proxy graph and the
# decoder's two; the trunk's two FPS and the 224 of the tail
SCALAR_PTR_LAUNCHES = {"knn_min": 7, "furthest_point_sample": 3}
# Phase 12, the bf16 policy's eval forwards: one forward's launches, A, B,
# C and K3 in their bf16 modes only (D, K2 and F stay float32: their
# wrappers upcast bf16 coordinates exactly), as the JAX package's TPU
# dispatch gives them; the flagship: A at first_conv.0 and second_conv.0,
# B at final_conv.0, C at final_conv.1 + .2.
BF16_NAMES = {"vn_bn_leaky_fwd": "vn_bn_leaky_fwd[bf16]",
              "vn_layer_fused_fwd": "vn_layer_fused_fwd[bf16]",
              "vn_layer_fused_fwd[group]": "vn_layer_fused_fwd[group,bf16]",
              "vn_layer_fused_project_fwd": "vn_layer_fused_project_fwd[bf16]",
              "edge_knn_gather": "edge_knn_gather[bf16]"}
BF16_FORWARD_LAUNCHES = {
    "flagship": {"vn_bn_leaky_fwd[bf16]": 2, "vn_layer_fused_fwd[bf16]": 1,
                 "vn_layer_fused_project_fwd[bf16]": 1},
    **{path: {BF16_NAMES.get(k, k): v for k, v in FORWARD_LAUNCHES[path].items()}
       for path in ("vn_dgcnn", "vn_pointr_448", "vn_pointr_448_dec")},
}
# Phase 12, on one tape of discrete decisions, the coarse cloud and the
# decoder's last fold output (kernel C's on the kernel path; the dense
# cloud is the coarse points plus it, rounded to bf16 at the coarse points'
# scale), each as max|d| / max of the float32 forward's: the bf16 kernel
# path no further
# from the float32 forward than BF16_F32_RATIO x the plain bf16 path, and
# within BF16_FWD_TOL of the plain bf16 path (the fold layers round p and d
# once in kernel B where the plain chain rounds each of its three products,
# and kernel C projects its epilogue unrounded: a few bf16 ulps, 2^-8 each).
BF16_F32_RATIO = 2.0
BF16_FWD_TOL = 1e-2
BF16_MUTANT = 1 + 2.0 ** -6  # kernel C's bf16 output scaled: must fail the checks
# bf16 C in the wide design (the tensor cores) against its plain version:
# the root-mean-square distance over the plain output's norm (bf16_rms).
# The tensor cores sum p and d in their own order, so a p or d at a bf16
# rounding boundary rounds one ulp away from the plain version's at rare
# points, and moves its point's projected output by up to several ulps of a
# small, cancelling result: no per-element ulp bound holds, and one relative
# to the largest output lets one flip at the largest element read 2^-7,
# only 2x under the mutant.  In root mean square the mutant reads 2^-6
# (every element scaled) and the bound is 2^-9, 8x under it.
BF16_C_RMS = 2.0 ** -9
# Phase 13, the bf16 policy's training path.  One train step of the root
# config.json's pipeline (vn_pointr_448, batch 8) launches its eval
# forward's kernels (BF16_FORWARD_LAUNCHES), kernel S before each of its
# five whole-layer kernels (grouper conv1's B, the pair folds' two B in
# group=S mode, the two C), and the backward of every VN kernel: A' for the
# three A, S' for each S, B' and C' -- each in its bf16 mode, none in float32.
BF16_STEP_LAUNCHES = {
    "vn_pointr_448": {**BF16_FORWARD_LAUNCHES["vn_pointr_448"],
                      "vn_layer_stats_fwd[bf16]": 3, "vn_layer_stats_fwd[group,bf16]": 2,
                      "vn_bn_leaky_bwd[bf16]": 3, "vn_layer_stats_bwd[bf16]": 3,
                      "vn_layer_stats_bwd[group,bf16]": 2, "vn_layer_fused_bwd[bf16]": 1,
                      "vn_layer_fused_bwd[group,bf16]": 2,
                      "vn_layer_fused_project_bwd[bf16]": 2},
}
BF16_STEP_LAUNCHES["vn_pointr_448_dec"] = {**BF16_STEP_LAUNCHES["vn_pointr_448"], "knn_min": 4}
# the float32 step's: the same kernels in their float32 modes (phase 15b)
STEP_LAUNCHES = {path: {k.replace("[bf16]", "").replace(",bf16]", "]"): v
                        for k, v in launches.items()}
                 for path, launches in BF16_STEP_LAUNCHES.items()}
BF16_TRAIN_EPOCHS = 2  # phase 13's train epochs before --resume
# The design of every B, C, S, S', C' and B' launch of one train step
# (cuda_lib.variant_counts(); ops/vn_layer_fused.py::forward_design,
# backward_design, layer_fwd_design, layer_bwd_design, stats_design,
# stats_bwd_design): C, S, S' and C' wide at C_in, C_out >= 16
# (final_conv.1's 256 -> 256, vn_folding{1,2}.1's 256 -> 128); at C_in <= 2
# (final_conv.0's 2 -> 256, conv1's 2 -> 32, the pair folds' 1 -> 256 at
# group 64) B the store stream, S the channel walk ("stream"), S' and B'
# the fused walk: no S or S' launch takes the narrow design; vn_pointr's
# F, K2 (coords) and K3 (on its features: tiled) too, and A in bf16 (run8;
# float32 A has one design and counts none).  In bf16, S, S' and C' at
# those wide widths take pass1_bf16_design's: "wgmma_p" (256 and 128 are
# multiples of 64, N 16384 and 14336 of 8, no bias columns narrower than a
# tile; C' where C takes "wgmma").
# Phase 5b (float32) and phase 13 (bf16) assert them.
# Kernel S (ops/vn_layer_fused.py::stats_design) takes the wide design
# where S' does and walks its channels where S' fuses: STATS_STEP_DESIGNS,
# asserted for each counted training run of phases 5, 7, 9 and 13
# (check_stats_designs) and inside the per-step tables below.
STATS_STEP_DESIGNS = {
    "flagship": {"vn_layer_stats_fwd/stream": 1, "vn_layer_stats_fwd/wide": 1},
    "vn_dgcnn": {"vn_layer_stats_fwd/stream": 2, "vn_layer_stats_fwd/wide": 1},
    "vn_pointr_448": {"vn_layer_stats_fwd/stream": 1, "vn_layer_stats_fwd/wide": 2,
                      "vn_layer_stats_fwd[group]/stream": 2},
}
STATS_STEP_DESIGNS["vn_pointr_448_dec"] = STATS_STEP_DESIGNS["vn_pointr_448"]


def bf16_designs(designs: dict) -> dict:
    """The same design counts under the bf16 modes' names, S's wide design
    as its bf16 mode takes it there ("wgmma_p")."""
    named = {k.replace("[group]", "[group,bf16]") if "[group]" in k
             else k.replace("/", "[bf16]/"): v for k, v in designs.items()}
    return {k.replace("stats_fwd[bf16]/wide", "stats_fwd[bf16]/wgmma_p"): v
            for k, v in named.items()}


FLAGSHIP_STEP_DESIGNS = {"vn_layer_stats_bwd/fused": 1, "vn_layer_stats_bwd/wide": 1,
                         "vn_layer_fused_fwd/stream": 1, "vn_layer_fused_project_bwd/wide": 1,
                         "vn_layer_fused_project_fwd/wide": 1, "vn_layer_fused_bwd/fused": 1,
                         **STATS_STEP_DESIGNS["flagship"]}
BF16_STEP_DESIGNS = {
    "flagship": {"vn_bn_leaky_fwd[bf16]/run8": 2,
                 "vn_layer_stats_bwd[bf16]/fused": 1, "vn_layer_stats_bwd[bf16]/wgmma_p": 1,
                 "vn_layer_fused_fwd[bf16]/stream": 1,
                 "vn_layer_fused_project_bwd[bf16]/wgmma_p": 1,
                 "vn_layer_fused_project_fwd[bf16]/wgmma": 1, "vn_layer_fused_bwd[bf16]/fused": 1,
                 **bf16_designs(STATS_STEP_DESIGNS["flagship"])},
    "vn_pointr_448": {"vn_layer_stats_bwd[bf16]/fused": 1, "vn_layer_stats_bwd[bf16]/wgmma_p": 2,
                      "vn_layer_stats_bwd[group,bf16]/fused": 2,
                      "vn_layer_fused_fwd[bf16]/stream": 1,
                      "vn_layer_fused_fwd[group,bf16]/stream": 2,
                      "vn_layer_fused_project_bwd[bf16]/wgmma_p": 2,
                      "vn_layer_fused_project_fwd[bf16]/wgmma": 2,
                      "vn_layer_fused_bwd[bf16]/fused": 1,
                      "vn_layer_fused_bwd[group,bf16]/fused": 2,
                      "edge_knn_gather[bf16]/tiled": 3,
                      "furthest_point_sample/single_barrier": 3,
                      "knn_min/coords": 2, "vn_bn_leaky_fwd[bf16]/run8": 3,
                      **bf16_designs(STATS_STEP_DESIGNS["vn_pointr_448"])},
}
BF16_STEP_DESIGNS["vn_pointr_448_dec"] = {**BF16_STEP_DESIGNS["vn_pointr_448"],
                                          "knn_min/coords": 4}
# Every launch of B on a main path (phases 4-13) takes the store stream
# (every main-path B has C_in <= 2), every launch of C the wide design (in
# bf16 the "wgmma" design: every main-path C is 256 -> 256 or 256 -> 128 at
# N a multiple of 8, group 0) and every launch of B' the fused pass, every
# K2 launch (all over coordinates, D 3) the "coords" design and every A
# launch in bf16 the "run8" design (every main-path A has N a multiple of
# 8): checked on each counted run (check_designs).  A name with its mode
# ("[bf16]") is held to its own entry, B, B', F and K2 in either mode to
# their base name's.
MAIN_DESIGNS = {"vn_layer_fused_fwd": "stream", "vn_layer_fused_project_fwd": "wide",
                "vn_layer_fused_project_fwd[bf16]": "wgmma",
                "vn_layer_fused_bwd": "fused", "furthest_point_sample": "single_barrier",
                "knn_min": "coords", "vn_bn_leaky_fwd[bf16]": "run8"}
# Every K3 launch of a path takes the design of the path's shapes
# (ops/knn_pallas.py::edge_design): "coords" over the VN DGCNN's coordinates
# (D 3, N 512), "tiled" over vn_pointr's features (D 96 and 192 at N 512, D
# 192 at N 128); every F launch its one design (MAIN_DESIGNS): checked with
# the others on each counted run of phases 6-13.
EDGE_PATH_DESIGNS = {"vn_dgcnn": "coords", "vn_pointr_448": "tiled",
                     "vn_pointr_448_dec": "tiled"}
# Phase 13, the flagship's bf16 train step on one DecisionTape, each
# gradient as its root-mean-square distance over the tensor's norm: the
# kernels no further from the plain float32 path than BF16_F32_RATIO x the
# plain bf16 path (use_kernels off: it rounds at other points, and train-
# mode BatchNorm on nearly constant norms turns bf16 rounding into O(1)
# gradient changes, JAX's as much), and within BF16_STEP_TOL of their own
# plain versions run in the kernels' place (``kernels_as_plain``: the same
# rounding points, other summation orders; measured 1.52e-2 at most, at
# encoder.first_conv.0, the layer furthest from the loss, whose gradient
# passes back through every train-mode BatchNorm on norms: NVIDIA H100 80GB
# HBM3, 700 W), the decoder's gradients, which the backward kernels compute
# directly, within BF16_DECODER_TOL (measured 1.85e-3 at most).  The mutant
# (C''s bf16 dW x BF16_MUTANT) must fail: it reads 1.66e-2.
BF16_STEP_TOL = 2e-2
BF16_DECODER_TOL = 5e-3
# Kernel E (phase 3) against its plain version, each max|d| / max: the cost
# within EMD_COST_TOL, the moments within EMD_MOMENT_TOL (the level -4^7
# amplifies the rounding of sums taken in another order on near ties; the
# bounds of tests/test_ops.py::TestEMDOracle for JAX's kernel against its
# streamed path); against float64, no further than EMD_F64_RATIO x the
# float32 plain version plus a floor of 2e-4 of the scale (3e-3 for t); the
# gradient from E's moments within EMD_GRAD_TOL of the plain one's max.
EMD_COST_TOL, EMD_MOMENT_TOL, EMD_F64_RATIO, EMD_GRAD_TOL = 2e-4, 1e-2, 3.0, 5e-3
# FP32 operations per pair of kernel E's schedule (csrc/emd.cu), each exp
# counted as one: d = 3 sub + 3 mul + 2 add, then level * d and exp; round 0's
# supply pass adds one fma (2); each round's column pass four fmas (8); each
# row pass four fmas, w * d and an fma (11), and in rounds 0-8 the next
# round's supply, level * d, exp and an fma (4).
EMD_D_OPS = 8 + 1 + 1
EMD_OPS_PER_PAIR = (EMD_D_OPS + 2) + 10 * (EMD_D_OPS + 8) + 10 * (EMD_D_OPS + 11) + 9 * 4
# overfit epochs before --resume
DGCNN_EPOCHS = {"vn_dgcnn": 4, "dgcnn_448": 2, "vn_pointr_448": 8, "vn_pointr_448_dec": 4}
SYMBOL = {"A": "vn_bn_leaky_fwd", "A'": "vn_bn_leaky_bwd",
          "S": "vn_layer_stats_fwd", "S'": "vn_layer_stats_bwd",
          "B": "vn_layer_fused_fwd", "B'": "vn_layer_fused_bwd",
          "C": "vn_layer_fused_project_fwd", "C'": "vn_layer_fused_project_bwd",
          "D": "chamfer_nn_bidir", "K1": "topk_min", "K2": "knn_min",
          "K3": "edge_knn_gather", "F": "furthest_point_sample", "E": "emd_rounds"}
FLAGSHIP_KERNELS = tuple(SYMBOL[k] for k in ("A", "A'", "S", "S'", "B", "B'", "C", "C'", "D"))
# Phase 14, remat: the kernels of the forward, which the recomputation in
# the backward launches a second time; the chamfer loss (D) stays outside
# the checkpointed segment and every backward kernel runs once.
REMAT_FORWARD = tuple(SYMBOL[k] for k in ("A", "S", "B", "C", "K1", "K2", "K3", "F"))
# Phase 5's launches each overfit epoch of the flagship: one train step
# (A 2, A' 2, S 2, S' 2, B 1, B' 1, C 1, C' 1, D 2: the dense and coarse
# losses) and one validation batch (A 2, B 1, C 1, D 2: the two l1_cd).
FLAGSHIP_EPOCH_LAUNCHES = {"vn_bn_leaky_fwd": 4, "vn_bn_leaky_bwd": 2, "vn_layer_stats_fwd": 2,
                           "vn_layer_stats_bwd": 2, "vn_layer_fused_fwd": 2,
                           "vn_layer_fused_bwd": 1, "vn_layer_fused_project_fwd": 2,
                           "vn_layer_fused_project_bwd": 1, "chamfer_nn_bidir": 4}
FIGURE_WARNING = "matplotlib is not installed"  # the trainer's, once a run (phase 17c)
RENDER_MODELS = 32  # phase 17a's synthetic PCN root
OVERFIT_STEPS = 200  # phase 17d, each dtype
# Phase 5's flagship model_best.pth, kept for phase 14c's pretrained encoder.
PRETRAINED = os.path.join(ROOT, "build", "chip_smoke_pretrained.pth")


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` on the current stream (CUDA events)."""
    import torch

    for _ in range(2):
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
    return statistics.median(times)


def step_cost(model, config, partial, complete, policy=None, reps: int = 5, mesh=None):
    """A fresh train state's guarded train steps, timed through
    ``utils/profiling.py``: (CUDA-event median ms, host-clock median ms,
    the allocator's peak GiB, the peak above the weights and optimiser
    state in GiB) over ``reps`` steps after 2 warm-up steps, each step
    ending in its one host read, under the compute policy ``policy`` (and
    over ``mesh``'s ranks, phase 16a)."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.nn.precision import compute_dtype_scope
    from vn_pointcloudcompletion_tpu_torch.training import steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state
    from vn_pointcloudcompletion_tpu_torch.utils.profiling import StepTimer, device_memory_stats

    state = create_train_state(model, config, 1)
    gen = torch.Generator().manual_seed(0)
    timer = StepTimer(warmup=2)
    torch.cuda.synchronize()
    base = device_memory_stats()[0]["bytes_in_use"]
    torch.cuda.reset_peak_memory_stats()
    with compute_dtype_scope(policy or torch.float32):
        for _ in range(2 + reps):
            with timer:
                steps.train_step(state, partial, complete, gen, mesh)
    peak = device_memory_stats()[0]["peak_bytes_in_use"]
    return (timer.device_summary()["p50_s"] * 1e3, timer.summary()["p50_s"] * 1e3,
            peak / 2**30, (peak - base) / 2**30)


def stream_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn`` in a run of ``reps`` calls back to back
    between two CUDA events: the host enqueues ahead of the card, so a
    call's host time (the wrapper's checks, allocations, the launch) hides
    wherever the card is the slower.  ``cuda_ms`` synchronises around each
    call and so counts the host time before the first launch."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 10) -> float:
    """Device milliseconds a call of ``fn``: ``reps`` calls captured in one
    CUDA graph, the median replay of five over ``reps``.  No host time (the
    wrapper's checks, allocations and launches) is left in it, as
    ``cuda_ms`` and ``stream_ms`` leave it for a call shorter than the
    host's part."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm the allocator off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_FP32, fp32_ops: float = 0.0):
    """Least time for the work on the card: (ms, what bounds it).  ``ops``
    at ``peak_ops`` (a bf16 kernel's products: the bf16 tensor-core rate),
    plus ``fp32_ops`` (its elementwise float32 work) at the FP32 rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (ops / peak_ops + fp32_ops / PEAK_FP32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def narrow_designs():
    """B, C, S, S', C' and B' held to their narrow designs (the parent
    designs: B's, C's and S's one-block FMA loop, the FMA passes over a
    dp/dd scratch) inside the block."""
    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused

    chooser = ("backward_design", "forward_design", "layer_bwd_design", "layer_fwd_design",
               "stats_design", "stats_bwd_design")
    saved = [getattr(vn_layer_fused, name) for name in chooser]
    for name in chooser:
        setattr(vn_layer_fused, name, lambda *widths: "narrow")
    try:
        yield
    finally:
        for name, fn_ in zip(chooser, saved):
            setattr(vn_layer_fused, name, fn_)


@contextlib.contextmanager
def parent_designs():
    """K1, K2 and K3 held to their "warp" designs (the parent designs: one
    warp a row or query; K3 then the block's gather), A's bf16 mode to its
    "vector" design (one thread a vector), the wide bf16 S, S' and C' to
    their pass 1 on mma.sync (S "wide", S' and C' "wgmma" where
    ``wide_bf16_design`` gives it: not "wgmma_p") and the
    wide bf16 C to its "wide" design (proj_wide_mma and proj_sum, not
    "wgmma") inside the block."""
    from vn_pointcloudcompletion_tpu_torch.ops import knn_pallas, vn_fused, vn_layer_fused

    def pass1(kernel, c_in, c_out, n, aligned=True, group=0):
        return "wide" if kernel == "S" else vn_layer_fused.wide_bf16_design(c_in, c_out, n,
                                                                            aligned)

    choosers = ((knn_pallas, "edge_design", "warp"), (knn_pallas, "knn_design", "warp"),
                (knn_pallas, "topk_design", "warp"), (vn_fused, "fwd_design", "vector"),
                (vn_layer_fused, "fwd_bf16_design", "wide"))
    saved = [getattr(mod, name) for mod, name, _ in choosers]
    saved_pass1 = vn_layer_fused.pass1_bf16_design
    for mod, name, design in choosers:
        setattr(mod, name, lambda *shape, design=design: design)
    vn_layer_fused.pass1_bf16_design = pass1
    try:
        yield
    finally:
        for (mod, name, _), fn_ in zip(choosers, saved):
            setattr(mod, name, fn_)
        vn_layer_fused.pass1_bf16_design = saved_pass1


def knn_scan_sass(sass: str) -> tuple:
    """(instructions, references a lane) of one trip of K2's coords scan
    when no lane flushes, read from ``cuobjdump -sass`` text of the knn
    library: in knn_select_coords<16, false>, the innermost loop around the
    flush vote (VOTE.ANY) less the span that the vote's branch skips (the
    flush); a trip's references a lane are its 16-byte shared loads (one
    float4 a reference).  Raises ValueError where the code has no such
    loop."""
    import re

    head = re.search(r"Function : \S*knn_select_coordsILi16ELb0E\S*", sass)
    if head is None:
        raise ValueError("no knn_select_coords<16, false> in the SASS")
    body = sass[head.end():].split("Function :", 1)[0]
    ins = [(int(a, 16), op.strip())
           for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]

    def target(op):
        hit = re.search(r"\bBRA (0x[0-9a-f]+)", op)
        return None if hit is None else int(hit.group(1), 16)

    votes = [a for a, op in ins if op.startswith("VOTE.ANY")]
    if len(votes) != 1:
        raise ValueError(f"{len(votes)} warp votes in knn_select_coords<16, false>")
    vote = votes[0]
    loops = [(target(op), a) for a, op in ins
             if target(op) is not None and target(op) <= vote < a]
    if not loops:
        raise ValueError("no loop around the flush vote")
    top, end = max(loops)  # the innermost
    skips = [(a, target(op)) for a, op in ins
             if vote < a < end and target(op) is not None and target(op) > a]
    if not skips or skips[0][1] > end:
        raise ValueError("no branch past the flush inside the loop")
    skip, back = skips[0]
    trip = [op for a, op in ins if top <= a <= skip or back <= a <= end]
    return len(trip), sum(op.startswith("LDS.128") for op in trip)


def knn_scan_issue() -> tuple:
    """``knn_scan_sass`` of the knn library built in this run (cuobjdump
    -sass of the CUDA toolkit that built it)."""
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib

    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    tool = os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
        if tool is None:
            raise ValueError("no cuobjdump")
    sass = subprocess.run([tool, "-sass", str(cuda_lib.library_path(cuda_lib.CSRC / "knn.cu"))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    return knn_scan_sass(sass)


def chamfer_sweep_sass(sass: str, pairs_a_trip: int) -> tuple:
    """(instructions, pairs a lane) of one trip of kernel D's chunk loop on
    its common path, read from ``cuobjdump -sass`` text of the
    chamfer_bidir library: in nn_sweep, the innermost loop holding the most
    FMNMX (the minima of the sweep), less the instructions of the longest
    span that a forward branch skips and that holds no FMNMX (the block's
    flush of column keys, one chunk in kFlush; the branch over the sweep,
    taken by a warp past the rows, holds them all and stays); a trip folds
    ``pairs_a_trip`` (kChunk x kR) pairs a lane.  Raises ValueError where
    the code has no such loop."""
    import re

    head = re.search(r"Function : \S*nn_sweep\S*", sass)
    if head is None:
        raise ValueError("no nn_sweep in the SASS")
    body = sass[head.end():].split("Function :", 1)[0]
    ins = [(int(a, 16), op.strip())
           for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]

    def target(op):
        hit = re.search(r"\bBRA (0x[0-9a-f]+)", op)
        return None if hit is None else int(hit.group(1), 16)

    loops = [(target(op), a) for a, op in ins if target(op) is not None and target(op) < a]
    if not loops:
        raise ValueError("no loop in nn_sweep")
    mins = {lp: sum(1 for a, op in ins if lp[0] <= a <= lp[1] and op.split()[0].startswith("FMNMX"))
            for lp in loops}
    most = max(mins.values())
    top, end = min((lp for lp in loops if mins[lp] == most), key=lambda lp: lp[1] - lp[0])
    spans = [[op for b, op in ins if a < b < target(br)] for a, br in ins
             if top <= a < end and target(br) is not None and a < target(br) <= end]
    skip = max((len(span) for span in spans
                if not any(op.split()[0].startswith("FMNMX") for op in span)), default=0)
    return sum(1 for a, _ in ins if top <= a <= end) - skip, pairs_a_trip


def chamfer_sweep_issue() -> tuple:
    """``chamfer_sweep_sass`` of the chamfer_bidir library built in this run,
    with the pairs a lane folds a trip from its source (kChunk x kR)."""
    import re

    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib

    src = (cuda_lib.CSRC / "chamfer_bidir.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (kR|kChunk) = (\d+);", src)}
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    tool = os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
        if tool is None:
            raise ValueError("no cuobjdump")
    lib = cuda_lib.library_path(cuda_lib.CSRC / "chamfer_bidir.cu")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return chamfer_sweep_sass(sass, consts["kR"] * consts["kChunk"])


def issue_floor_ms(dev, pairs: int, trip: int, per_trip: int) -> tuple:
    """(ms, SMs, MHz): ``pairs`` at ``trip`` warp instructions for each
    ``per_trip`` pairs a lane (32 lanes a warp instruction), 4 warp
    instructions issued a clock on each SM at the card's top SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    return pairs * trip / per_trip / 32 / (sms * 4 * mhz * 1e6) * 1e3, sms, mhz


def launched_designs(fn):
    """``fn()`` and the designs its launches took, sorted (the names whose
    count in cuda_lib.variant_counts() moved in the call)."""
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib

    before = cuda_lib.variant_counts()
    out = fn()
    return out, sorted(k.split("/")[1] for k, v in cuda_lib.variant_counts().items()
                       if v != before.get(k, 0))


def versus_parent(rec: dict, fn, reps: int = 20, parent: str = "parent") -> None:
    """A redesigned kernel's row (K1, K2 and A bf16; ``parent`` "narrow": S
    and S' at C_in <= 2) against its parent design (``parent_designs``;
    ``narrow_designs``) at the same shape in the same call: the parent's
    time a call (``cuda_ms``), back to back (``stream_ms``) and on the
    device alone (``graph_ms``), printed first, then the new design's, each
    with its share of the row's bound; kept in the row under
    ``<parent>_ms``, ``<parent>_stream_ms`` and ``<parent>_graph_ms``."""
    with (parent_designs() if parent == "parent" else narrow_designs()):
        old = cuda_ms(fn, reps), stream_ms(fn, reps), graph_ms(fn)
    new = rec["ms"], stream_ms(fn, reps), graph_ms(fn)
    bound_ms = rec["bound_ms"]
    for who, (ms, b2b, dev_ms) in ((f"{parent} design", old), (f"{rec['design']} design", new)):
        print(f"[kernel {rec['name']}] {who}: {ms:.4f} ms a call ({bound_ms / ms:.1%} of the "
              f"bound), {b2b:.4f} back to back ({bound_ms / b2b:.1%}), {dev_ms:.4f} on the "
              f"device ({bound_ms / dev_ms:.1%})", flush=True)
    rec.update({"stream_ms": new[1], "graph_ms": new[2], f"{parent}_ms": old[0],
                f"{parent}_stream_ms": old[1], f"{parent}_graph_ms": old[2]})


def walk_vs_narrow(rec: dict, fn, same_bits: bool, reps: int = 10) -> None:
    """Kernel S's or S''s row at C_in <= 2 (the channel walk) beside the
    narrow design (``versus_parent``), and, for S (``same_bits``), the
    walk's (s1, s2) equal to the narrow design's on the same inputs (fails
    otherwise)."""
    import torch

    versus_parent(rec, fn, reps, "narrow")
    if same_bits:
        walk = fn()
        with narrow_designs():
            narrow = fn()
        same = all(torch.equal(a, b) for a, b in zip(walk, narrow))
        print(f"[kernel {rec['name']}] the {rec['design']} design's (s1, s2) bitwise equal to "
              f"the narrow design's: {same}", flush=True)
        if not same:
            raise AssertionError(f"kernel {rec['name']}: the stream design differs from the "
                                 "narrow one")


WIDE_PASSES = ("transpose", "pass1", "sums", "pass2", "pass3", "reduce")
# The kernels of a wide or wgmma bf16 S' or C' launch by the pass they run
# (a substring of the name torch.profiler gives each); the reductions
# (vnk_reduce_*, reduce_bias) are the sums' after pass 1, the split-K's
# after pass 3
PASS_KERNELS = (("transpose", "transpose"), ("pass1", "pd_"), ("pass2", "dx_"),
                ("pass3", "dw_"))


def pass_ms(fn, calls: int = 5) -> dict:
    """Device ms a call of each pass (WIDE_PASSES, and ``other`` for any
    kernel that none names) of a wide bf16 S' or C' call ``fn``: the
    durations of its kernels under torch.profiler over ``calls`` calls, each
    kernel put to its pass by its name (PASS_KERNELS) and a reduction to
    the pass it follows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
    out = dict.fromkeys(WIDE_PASSES + ("other",), 0.0)
    last = None
    for e in kernels:
        name = next((p for p, key in PASS_KERNELS if key in e.name), None)
        if name is None and "reduce" in e.name and last in ("pass1", "pass3"):
            name = "sums" if last == "pass1" else "reduce"
        else:
            last = name or last
        out[name or "other"] += e.time_range.elapsed_us() / 1e3 / calls
    return out


def wgmma_vs_parent(rec: dict, fn, x, w, wd=None, reps: int = 10, kind: str = "S'") -> None:
    """A wide bf16 S, S' (``wd`` None) or C' row (``kind``) in its
    pass1_bf16_design: beside the parent design (S "wide", S' and C'
    "wgmma": ``versus_parent``), each pass's device time in both designs on
    the same inputs (``pass_ms``: torch.profiler's kernel durations over
    whole calls, by pass), and, beside each pass, torch.matmul of the same
    bf16 products at the same shapes with float32 output (``torch.bmm`` /
    ``torch.mm`` with ``out_dtype``; pass 1: W, and Wd, times x; the
    yardstick in ``library_ms``'s sense, never on the port's path), timed
    back to back on the current stream (``stream_ms``: a graph's fresh side
    stream would keep a cuBLAS workspace of its own allocated for the rest
    of the run, which every later phase's peak memory would count).  Kept
    in the row under ``passes`` (``<design>/<pass>`` -> ms) and
    ``matmul_ms``."""
    import torch

    versus_parent(rec, fn, reps)
    passes = {}
    for design, ctx in (("parent", parent_designs), (rec["design"], contextlib.nullcontext)):
        with ctx():
            split = pass_ms(fn)
            whole = graph_ms(fn, reps)
        passes.update({f"{design}/{name}": ms for name, ms in split.items()})
        print(f"[kernel {rec['name']}] {design} design by pass (device ms, torch.profiler): "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in split.items())
              + f"; sum {sum(split.values()):.4f}, the whole call by graph replay {whole:.4f}",
              flush=True)
    bf = torch.bfloat16
    planes, c_in, c_out, n = x.shape[0] * 3, x.shape[2], w.shape[0], x.shape[3]
    mats = [w] if wd is None else [w, wd]
    x1 = x.reshape(planes, c_in, n)
    w1 = torch.cat(mats, 0).to(bf).expand(planes, -1, -1).contiguous()  # pass 1's A
    mms = {"pass1": (w1, x1)}
    if kind != "S":
        g = [torch.randn(planes, c_out, n, device=x.device).to(bf) for _ in mats]
        wt = torch.cat([m.t() for m in mats], 1).to(bf).expand(planes, c_in, -1).contiguous()
        g3 = torch.cat([t.transpose(0, 1).reshape(c_out, planes * n) for t in g], 0)
        x3 = x1.transpose(0, 1).reshape(c_in, planes * n)
        mms.update(pass2=(wt, torch.cat(g, 1)), pass3=(g3, x3.t()))
    mm = lambda a_, b_, **kw: (torch.bmm if a_.dim() == 3 else torch.mm)(a_, b_, **kw)  # noqa: E731
    out = "float32"
    try:
        for a_, b_ in mms.values():
            mm(a_, b_, out_dtype=torch.float32)
    except (TypeError, RuntimeError):  # no bf16 -> float32 product in this torch: bf16 out
        out = "bf16"
    kw = {"out_dtype": torch.float32} if out == "float32" else {}
    mat = {k: stream_ms(lambda a_=a_, b_=b_: mm(a_, b_, **kw), reps)
           for k, (a_, b_) in mms.items()}
    print(f"[kernel {rec['name']}] torch.matmul yardstick ({out} out, ms a call back to back): "
          + ", ".join(f"{k} {v:.4f} (the {rec['design']} pass "
                      f"{passes[rec['design'] + '/' + k]:.4f}, the parent's "
                      f"{passes['parent/' + k]:.4f})" for k, v in mat.items()),
          flush=True)
    rec.update({"passes": passes, "matmul_ms": mat, "matmul_out": out})
    del mms, w1


# The kernels of a wide bf16 C call by what they do (a substring of the
# name torch.profiler gives each): the W^T transpose, the product kernel
# (proj_wide_mma or proj_wgmma) and proj_sum (the parent design's second pass)
PROJ_KERNELS = (("transpose", "transpose_weights"), ("products", "proj_w"),
                ("sum", "proj_sum"))


def kernel_ms(fn, keys, calls: int = 5) -> dict:
    """Device ms a call of each kernel of ``fn`` named in ``keys`` ((name,
    substring of the kernel's name) pairs; ``other`` for the rest):
    torch.profiler's kernel durations over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys([name for name, _ in keys] + ["other"], 0.0)
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            name = next((n for n, key in keys if key in e.name), "other")
            out[name] += e.time_range.elapsed_us() / 1e3 / calls
    return out


def proj_vs_parent(rec: dict, fn, x, w, wd, reps: int = 10) -> None:
    """A wide bf16 C row in its fwd_bf16_design ("wgmma") beside the parent
    design ("wide": proj_wide_mma and proj_sum; ``versus_parent``: a call,
    back to back, on the device), each kernel's device time in both designs
    (``kernel_ms`` over PROJ_KERNELS), ``torch.bmm`` of the call's two
    products (W x and Wd x, bf16 operands, float32 out, back to back on the
    current stream: the yardstick in ``library_ms``'s sense, never on the
    port's path), and the output equal in bits to the parent design's on
    the same inputs (fails otherwise).  Kept in the row under ``kernels``
    (``<design>/<kernel>`` -> ms), ``matmul_ms`` and ``equal_to_parent``."""
    import torch

    versus_parent(rec, fn, reps)
    got, designs = launched_designs(fn)
    with parent_designs():
        want, parent = launched_designs(fn)
    same = torch.equal(got, want)
    print(f"[kernel {rec['name']}] the {designs} design's output bitwise equal to the "
          f"{parent} design's: {same}", flush=True)
    if not same or designs != [rec["design"]] or parent != ["wide"]:
        raise AssertionError(f"{rec['name']}: the {designs} design differs from the parent's")
    split = {}
    for design, ctx in (("parent", parent_designs), (rec["design"], contextlib.nullcontext)):
        with ctx():
            parts = kernel_ms(fn, PROJ_KERNELS)
        split.update({f"{design}/{name}": ms for name, ms in parts.items()})
        print(f"[kernel {rec['name']}] {design} design by kernel (device ms, torch.profiler): "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in parts.items()), flush=True)
    bf = torch.bfloat16
    planes, c_in, n = x.shape[0] * 3, x.shape[2], x.shape[3]
    x1 = x.reshape(planes, c_in, n)
    w1 = torch.cat([w, wd], 0).to(bf).expand(planes, -1, -1).contiguous()
    try:
        kw = {"out_dtype": torch.float32}
        torch.bmm(w1, x1, **kw)
    except (TypeError, RuntimeError):  # no bf16 -> float32 product in this torch: bf16 out
        kw = {}
    mat = stream_ms(lambda: torch.bmm(w1, x1, **kw), reps)
    print(f"[kernel {rec['name']}] torch.bmm yardstick of W x and Wd x "
          f"({'float32' if kw else 'bf16'} out, ms a call back to back): {mat:.4f} (the "
          f"{rec['design']} design's product kernel {split[rec['design'] + '/products']:.4f}, "
          f"the parent's {split['parent/products']:.4f})", flush=True)
    rec.update({"kernels": split, "matmul_ms": mat, "equal_to_parent": same})
    del got, want, x1, w1


def same_p(rec: dict, x, w, c1, c2) -> None:
    """S's p equal in bits to S''s recomputed p on the same inputs (the
    wgmma pass 1 of both fills ``p_out``; fails otherwise or if either
    launch took another design) and to the plain k16 model's
    (``_products(order="k16")``), within one bf16 ulp of the plain
    version's in-order p plus 2^-13 of sum |w_k x_k| (two float32 orders of
    one sum), and S's and S''s outputs equal in bits to their parent
    designs' (pd_wide_mma takes the same k16 steps in the same order and
    sums in the order pd_wgmma repeats)."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused

    p_s, p_b = (torch.zeros(x.shape[0], 3, w.shape[0], x.shape[3], device=x.device,
                            dtype=torch.bfloat16) for _ in range(2))
    _, d_s = launched_designs(lambda: vn_layer_fused.stats_fwd(x, w, None, p_out=p_s))
    _, d_b = launched_designs(lambda: vn_layer_fused.stats_bwd(x, w, None, c1, c2, p_out=p_b))
    same = torch.equal(p_s, p_b)
    t0 = time.time()
    model = vn_layer_fused._products(w, x, None, order="k16")
    model_s = time.time() - t0
    model_differ = int((model.view(torch.int16) != p_s.view(torch.int16)).sum())
    plain = vn_layer_fused._products(w, x, None)
    diff = (p_s.float() - plain.float()).abs()
    ulp = torch.exp2(torch.floor(torch.log2(plain.float().abs().clamp_min(2.0 ** -126))) - 7)
    mag = torch.matmul(w.to(torch.bfloat16).float().abs(), x.float().abs())
    within = bool((diff <= ulp + 2.0 ** -13 * mag).all())  # two orders of the float32 sum
    share = float((p_s != plain).float().mean())
    print(f"[kernel {rec['name']}] S's p ({d_s}) bitwise equal to S''s ({d_b}): {same}; "
          f"the k16 model's p against S's: {model_differ} of {model.numel()} elements differ "
          f"in bits (the model {model_s:.2f} s); against the in-order p: {share:.4%} of "
          f"elements differ, all within one bf16 ulp + 2^-13 sum |w x|: {within}", flush=True)
    if not same or d_s != ["wgmma_p"] or d_b != ["wgmma_p"] or not within or model_differ:
        raise AssertionError(f"{rec['name']}: S's p is not S''s, or not the k16 model's")
    # the same products in the same order and the sums in the same order as
    # the parent design (pd_wide_mma): S's and S''s outputs equal its bits
    for tag, fn in (("S", lambda: vn_layer_fused.stats_fwd(x, w, None)),
                    ("S'", lambda: vn_layer_fused.stats_bwd(x, w, None, c1, c2))):
        got = fn()
        with parent_designs():
            want = fn()
        equal = all(torch.equal(a, b) for a, b in zip(got, want) if a is not None)
        print(f"[kernel {rec['name']}] {tag} in the wgmma_p design bitwise equal to the parent "
              f"design's: {equal}", flush=True)
        if not equal:
            raise AssertionError(f"{rec['name']}: {tag}'s wgmma pass 1 differs from the parent's")
    rec.update({"p_equal_to_s_bwd": same, "p_differs_from_in_order": share,
                "model_differs": model_differ})
    del p_s, p_b, plain, diff, ulp, mag, model


def forward_planes(x, w, wd, pbias, dbias, a, b, w_out, group: int = 0):
    """The p, d (2, B, 3, C_out, N) that kernel C's forward forms on these
    inputs (its ``pd_out``), in x's dtype."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused

    pd = torch.empty((2, x.shape[0], 3, w.shape[0], x.shape[3]), device=x.device,
                     dtype=x.dtype)
    vn_layer_fused.project_fwd(x, w, wd, pbias, dbias, a, b, w_out, NS, group, pd_out=pd)
    return pd


def leaky_side(p, d, a, b):
    """Which side of the leaky ReLU each (sample, channel, point) vector of
    the planes (B, 3, C, N) takes: ``<q, d> >= 0``, q the BatchNorm on the
    norms (vn_fused.reference_bn_leaky_planes's order), in float32."""
    from vn_pointcloudcompletion_tpu_torch.ops.vn_fused import EPS, plane_dot, safe_sqrt

    p, d = p.float(), d.float()
    s = (a[None, :, None] + b[None, :, None] / (safe_sqrt(plane_dot(p, p)) + EPS))[:, None]
    return plane_dot(p * s, d) >= 0


def pd_fault(fwd, got, a, b) -> dict:
    """How far a C' pass 1's p, d (``got``, its ``pd_out``) lie from the
    forward C's (``fwd``): the share of elements that differ, and the share
    and number of (sample, channel, point) vectors whose leaky side differs."""
    flips = leaky_side(fwd[0], fwd[1], a, b) != leaky_side(got[0], got[1], a, b)
    return {"pd_differs": float((fwd != got).float().mean()),
            "side_flips": int(flips.sum()), "side_flip_share": float(flips.float().mean())}


def c_bwd_checks(rec: dict, inputs, adversarial) -> None:
    """C' in its bf16 design on the row's inputs and on ``adversarial``
    ones (every p, d a few float32 ulps from a bf16 midpoint): its p, d
    (``pd_out``) equal in bits to the forward C's (C's ``pd_out``), to the
    plain k16 model's and to S's p (S run with W, and with Wd for d); its
    outputs equal in bits to the mma.sync design's (``parent_designs``: C'
    "wgmma", pass 1 pd_wide_mma on ``mma.sync``, the same k16 steps; two
    k16 designs of this tree, not the in-order design they replaced); the
    fault (``pd_fault`` against the
    forward C's) 0 elements and 0 leaky-side flips.  Fails where a bit
    differs.  Kept in the row under ``fault`` (``adversarial_fault``)."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused

    for tag, args in (("row", inputs), ("adversarial", adversarial)):
        x, w, wd, pb, db, a, b, w_out, _ = args
        pd = torch.empty((2, x.shape[0], 3, w.shape[0], x.shape[3]), device=x.device,
                         dtype=x.dtype)
        got, designs = launched_designs(
            lambda: vn_layer_fused.layer_project_bwd(*args, NS, pd_out=pd))
        with parent_designs():
            want, parent = launched_designs(lambda: vn_layer_fused.layer_project_bwd(*args, NS))
        same = all(torch.equal(a_, b_) for a_, b_ in zip(got, want) if a_ is not None)
        fwd = forward_planes(x, w, wd, pb, db, a, b, w_out)
        t0 = time.time()
        model = torch.stack([vn_layer_fused._products(w, x, pb, order="k16"),
                             vn_layer_fused._products(wd, x, db, order="k16")])
        model_s = time.time() - t0
        model_differ = int((model.view(torch.int16) != pd.view(torch.int16)).sum())
        s_p = [torch.empty_like(fwd[0]) for _ in range(2)]
        vn_layer_fused.stats_fwd(x, w, pb, p_out=s_p[0])
        vn_layer_fused.stats_fwd(x, wd, db, p_out=s_p[1])
        one_p = torch.equal(s_p[0], fwd[0]) and torch.equal(s_p[1], fwd[1])
        fault = pd_fault(fwd, pd, a, b)
        print(f"[kernel {rec['name']}] {tag} inputs: the {designs} design's p, d bitwise "
              f"equal to the forward C's: {torch.equal(pd, fwd)}; the k16 model's: "
              f"{model_differ} of {model.numel()} elements differ (the model {model_s:.2f} s); "
              f"C's p, d equal to S's p (W; Wd): {one_p}; outputs bitwise equal to the "
              f"mma.sync design's ({parent}): {same}; the fault: {fault['pd_differs']:.4%} of "
              f"p, d differ from the forward C's, {fault['side_flips']} vectors take the "
              f"other leaky side", flush=True)
        if (not (same and one_p and torch.equal(pd, fwd)) or model_differ or fault["side_flips"]
                or designs != ["wgmma_p"]):
            raise AssertionError(f"{rec['name']}: C''s p, d are not the forward C's, S's or the "
                                 f"k16 model's, or its outputs not the mma.sync design's, on the "
                                 f"{tag} inputs")
        rec.update({("" if tag == "row" else "adversarial_") + "fault": fault})
        del got, want, pd, fwd, s_p, model


def k16_probe() -> None:
    """The tensor cores' k16 step against its plain model: the crafted
    operand sets of ``tools/probe_k16.py`` through ``mma.sync`` (k16 and
    k8 steps) and ``wgmma`` (grouped and alone), the float32 accumulators
    read back and compared in bits with ``vn_layer_fused.k16_sum``.  Fails
    if the model and the card part on any accumulator, or the k16 ways on
    each other."""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location(
        "probe_k16", os.path.join(ROOT, "tools", "probe_k16.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    t0 = time.time()
    bad = 0
    for name, res in probe.run(probe.problem_sets(), torch.device("cuda")).items():
        model = probe.model_of(res)
        line = {"model_vs_wgmma": probe.differ(model, res["wgmma"]),
                "model_vs_mma16": probe.differ(model, res["mma16"]),
                "wgmma_vs_alone": probe.differ(res["wgmma"], res["wgmma_alone"]),
                "mma16_vs_mma8": probe.differ(res["mma16"], res["mma8"])}
        bad += line["model_vs_wgmma"] + line["model_vs_mma16"] + line["wgmma_vs_alone"]
        print(f"[k16 probe] {name} (K {res['a'].shape[1]}, {res['c'].size} accumulators): "
              f"{json.dumps(line)}", flush=True)
    print(f"[k16 probe] {'the model gives every accumulator of the card' if bad == 0 else bad}"
          f" ({time.time() - t0:.1f} s)", flush=True)
    if bad:
        raise AssertionError("the k16 model parts from the tensor cores")


def adversarial_c_inputs(dev, b, c_in, c_out, n, seed):
    """(x, w, wd, pbias, dbias, a, b, w_out, g) of C' in bf16 whose every p
    and d lies within a few float32 ulps of a bf16 rounding midpoint:
    channel 0's product a power of two t0, channel 1's t0 2^-8, the rest
    ~2^-25 t0 with random signs (tests/test_torch_port_kernels.py's
    _adversarial_layer at the row's width)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sign = lambda *shape: rng.choice([-1.0, 1.0], shape)  # noqa: E731
    small = lambda *shape: sign(*shape) * np.ldexp(rng.uniform(1, 2, shape), -13)  # noqa: E731
    lead_x = np.ldexp(sign(b, 3, 1, n), rng.integers(-2, 3, (b, 3, 1, n)))
    x = np.concatenate([lead_x, lead_x, lead_x * small(b, 3, c_in - 2, n)], 2)

    def weights():
        lead = np.ldexp(sign(c_out, 1), rng.integers(-2, 3, (c_out, 1)))
        return np.concatenate([lead, lead * 2.0 ** -8, lead * small(c_out, c_in - 2)], 1)

    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    w, wd = (t(m).to(torch.bfloat16).float() for m in (weights(), weights()))
    return (t(x).to(torch.bfloat16), w, wd, None, None, t(rng.uniform(0.5, 1.5, c_out)),
            t(rng.normal(0.0, 0.3, c_out)), t(rng.uniform(-0.3, 0.3, c_out)),
            t(rng.standard_normal((b, 3, 1, n)) * 1e-4).to(torch.bfloat16))


def narrow_ms(fn, reps: int) -> float:
    """``cuda_ms`` of ``fn`` in the narrow designs (``narrow_designs``):
    the same work the wide, fused and stream designs replace, timed in the
    same call."""
    with narrow_designs():
        return cuda_ms(fn, reps)


def check_designs(what: str, counts: dict, variants: dict, path: str = "") -> None:
    """Each launch of B, C, B', F and K2 in ``counts`` (any mode) and of A
    in bf16 took its MAIN_DESIGNS design, and each of K3 the design of
    ``path``'s shapes (EDGE_PATH_DESIGNS): ``variants``
    (cuda_lib.variant_counts() of the same run) counts them all there."""
    designs = dict(MAIN_DESIGNS)
    if path in EDGE_PATH_DESIGNS:
        designs["edge_knn_gather"] = EDGE_PATH_DESIGNS[path]

    def design_of(key):  # the design the launches counted under ``key`` must take
        name = key.split("/")[0]
        return designs.get(name, designs.get(name.split("[")[0]))

    want = {f"{k}/{design_of(k)}": v for k, v in counts.items()
            if v and "/" not in k and design_of(k)}
    got = {k: v for k, v in variants.items() if v and design_of(k)}
    print(f"{what} B, C, B', F, K2, K3 and bf16 A launches by design: {json.dumps(got)}")
    if got != want:
        raise AssertionError(f"{what}: B, C, B', F, K2, K3 and bf16 A designs {got}, "
                             f"expected {want}")


def stats_wide_vs_narrow(x, w, shape: str) -> None:
    """Print whether kernel S's wide design gives the narrow design's
    bits on the same inputs (float32: the same products in the same order
    and the same partials, so it should; bf16: the tensor cores sum p in
    their own order)."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused

    wide = vn_layer_fused.stats_fwd(x, w, None)
    with narrow_designs():
        narrow = vn_layer_fused.stats_fwd(x, w, None)
    diff = max((a - b).abs().max().item() for a, b in zip(wide, narrow))
    same = all(torch.equal(a, b) for a, b in zip(wide, narrow))
    print(f"[kernel S] {shape} {str(x.dtype).split('.')[-1]}: the wide design's (s1, s2) "
          f"bitwise equal to the narrow design's: {same} (max |d| {diff:.3e})", flush=True)


def check_stats_designs(what: str, variants: dict, per_step: dict, steps: int) -> None:
    """Kernel S's launches of a run of ``steps`` train steps by design
    (``variants``: cuda_lib.variant_counts() of the run) are ``per_step``
    (a STATS_STEP_DESIGNS entry) times ``steps``."""
    want = {k: v * steps for k, v in per_step.items()}
    got = {k: v for k, v in variants.items() if v and k.startswith("vn_layer_stats_fwd")}
    print(f"{what} S launches by design: {json.dumps(got)}")
    if got != want:
        raise AssertionError(f"{what}: S designs {got}, expected {want}")


def layer_stream_vs_narrow(tag: str, x, w, wd, pbias, dbias, a, b, group: int = 0) -> None:
    """Kernel B's stream design against its narrow design on the same
    inputs: the same operations in the same order, so equal bits (fails
    otherwise)."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused

    stream = vn_layer_fused.vn_layer_fused(x, w, wd, pbias, dbias, a, b, NS, group)
    with narrow_designs():
        narrow = vn_layer_fused.vn_layer_fused(x, w, wd, pbias, dbias, a, b, NS, group)
    same = torch.equal(stream, narrow)
    diff = (stream.float() - narrow.float()).abs().max().item()
    print(f"[kernel B] {tag}: the stream design's output bitwise equal to the narrow "
          f"design's: {same} (max |d| {diff:.3e})", flush=True)
    if not same:
        raise AssertionError(f"kernel B {tag}: the stream design differs from the narrow one")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def check_kernels(dev):
    """Phase 3: each kernel against its plain version at main-path shapes."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import chamfer_pallas_bidir as chamfer
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib, vn_fused, vn_layer_fused

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def uniform(lo, hi, *shape):
        return torch.rand(*shape, generator=g, device=dev) * (hi - lo) + lo

    records = []

    def record(name, source, replaces, kernel_fn, plain_fn, compare, tol,
               work_bytes, work_ops, reps=20, plain_reps=5, repro=False,
               library_fn=None, peak_ops=PEAK_FP32, versus=False, fp32_ops=0.0):
        """One row of the kernels line; ``versus``: the caller goes on to
        ``versus_parent``, which times the parent design; ``work_ops`` at
        ``peak_ops`` and ``fp32_ops`` at the FP32 rate (``bound``)."""
        got, designs = launched_designs(kernel_fn)
        want = plain_fn()
        torch.cuda.synchronize()
        err, ok = compare(got, want)
        if repro:  # the same inputs again must give the same bits
            again = kernel_fn()
            pairs = zip(got, again) if isinstance(got, tuple) else [(got, again)]
            same = all(torch.equal(a, b) for a, b in pairs if a is not None)
            print(f"[kernel {name}] second launch bitwise equal: {same}")
            ok = ok and same
            del again
        b_ms, b_by = bound(work_bytes, work_ops, peak_ops, fp32_ops)
        rec = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": cuda_ms(kernel_fn, reps), "plain_ms": cuda_ms(plain_fn, plain_reps),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if library_fn is None else cuda_ms(library_fn, reps),
        }
        lib = "none" if library_fn is None else f"{rec['library_ms']:.4f} ms"
        b2b = stream_ms(kernel_fn, reps)
        print(f"[kernel {name}] max_abs_err {err:.3e} (tolerance {tol}) "
              f"{'PASS' if ok else 'FAIL'}; kernel {rec['ms']:.4f} ms ({b2b:.4f} ms a call "
              f"back to back), plain {rec['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{b_ms / rec['ms']:.1%} of it; {b_ms / b2b:.1%} back to back), library: {lib}",
              flush=True)
        if designs:  # B, C, S, S', C', B', F, K3: the design taken, the rates (the parent's time)
            narrow = ""
            if designs in (["wide"], ["fused"], ["stream"]) and not versus:
                narrow = ("; the narrow design at the same shape: "
                          f"{narrow_ms(kernel_fn, max(3, reps // 2)):.4f} ms")
            elif designs in (["coords"], ["tiled"], ["run8"]) and not versus:
                with parent_designs():
                    narrow = ("; the parent design at the same shape: "
                              f"{cuda_ms(kernel_fn, max(3, reps // 2)):.4f} ms, "
                              f"{stream_ms(kernel_fn, max(3, reps // 2)):.4f} back to back")
            rec["design"] = "/".join(designs)
            print(f"[kernel {name}] {'/'.join(designs)} design: "
                  f"{(work_ops + fp32_ops) / rec['ms'] / 1e9:.2f} TFLOP/s, "
                  f"{work_bytes / rec['ms'] / 1e6:.1f} "
                  f"GB/s, {b_ms / rec['ms']:.1%} of the bound{narrow}", flush=True)
        if not ok:
            raise AssertionError(f"kernel {name} disagrees with its plain version")
        records.append(rec)
        return rec

    def close(atol, rtol):
        def cmp(got, want):
            diff = (got - want).abs()
            return diff.max().item(), bool((diff <= atol + rtol * want.abs()).all())
        return cmp

    def rel_close(rel, exact=()):
        """Each output within rel x its max |plain|; outputs in ``exact``
        equal to the bit.  Returns the largest absolute error."""
        def cmp(got, want):
            err, ok = 0.0, True
            for k, (g, w) in enumerate(zip(got, want)):
                if w is None:
                    continue
                e = (g - w).abs().max().item()
                err = max(err, e)
                ok = ok and (e == 0.0 if k in exact else e <= rel * w.abs().max().item())
            return err, ok
        return cmp

    # A: encoder first_conv.0 (C=128) and second_conv.0 (C=1024) at N=2048
    for c in (128, 1024):
        p = randn(BATCH, 3, c, 2048)
        p[:, :, :8, :16] = 0.0  # exact zero vectors
        d = randn(BATCH, 3, c, 2048)
        a, b = uniform(0.5, 1.5, c), randn(c, scale=0.3)
        if c == 128:
            got = vn_fused.fused_bn_leaky(p, d, a, b, NS)
            want = vn_fused.reference_bn_leaky_planes(p, d, a, b, NS)
            err = (got - want).abs().max().item()
            g_ = randn(BATCH, 3, c, 2048)
            err_b, ok_b = rel_close(1e-5, exact=(0, 1))(
                vn_fused.bn_leaky_bwd(p, d, a, b, g_, NS),
                vn_fused.reference_bn_leaky_bwd(p, d, a, b, g_, NS))
            print(f"[kernel A, A'] C=128 max_abs_err {err:.3e} (tolerance 1e-6), "
                  f"{err_b:.3e} (dp, dd exact; dA, dB 1e-5 x max)")
            if err > 1e-6 or not ok_b:
                raise AssertionError("kernel A or A' disagrees at C=128")
            continue
        vecs = BATCH * c * 2048
        record("A fused_bn_leaky", "vn_pointcloudcompletion_tpu_torch/csrc/vn_fused.cu",
               "vn_pointcloudcompletion_tpu/ops/vn_fused.py:189",
               lambda: vn_fused.fused_bn_leaky(p, d, a, b, NS),
               lambda: vn_fused.reference_bn_leaky_planes(p, d, a, b, NS),
               close(1e-6, 0.0), "atol 1e-6",
               nbytes(p, d, a, b) + nbytes(p), 32 * vecs)
    # A': the backward of A at second_conv.0 (C=1024), cotangent g
    g_ = randn(BATCH, 3, 1024, 2048)
    vecs = BATCH * 1024 * 2048
    record("A' fused_bn_leaky backward", "vn_pointcloudcompletion_tpu_torch/csrc/vn_fused.cu",
           "vn_pointcloudcompletion_tpu/ops/vn_fused.py:214",
           lambda: vn_fused.bn_leaky_bwd(p, d, a, b, g_, NS),
           lambda: vn_fused.reference_bn_leaky_bwd(p, d, a, b, g_, NS),
           rel_close(1e-5, exact=(0, 1)), "dp, dd exact; dA, dB 1e-5 x max",
           nbytes(p, d, a, b, g_) + 2 * nbytes(p) + 2 * 4 * 1024, 80 * vecs,
           repro=True)
    del p, d, g_

    # S, S': the train-mode statistics of decoder final_conv.1 (256 -> 256,
    # wide) and final_conv.0 (2 -> 256, per-sample bias: the channel walk,
    # S's stream and S''s fused design, each beside the narrow design and S
    # equal to its bits)
    n = 16384
    src_b = "vn_pointcloudcompletion_tpu_torch/csrc/vn_layer_bwd.cu"
    x2 = randn(BATCH, 3, 2, n, scale=0.3)
    w2 = uniform(-0.02, 0.02, 256, 2)
    pb2 = randn(BATCH, 3, 256, 1)
    vecs = BATCH * 256 * n
    fn = lambda: vn_layer_fused.stats_fwd(x2, w2, pb2)  # noqa: E731
    rec = record("S vn_layer_stats 2 -> 256", src_b,
                 "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:278", fn,
                 lambda: vn_layer_fused.reference_stats(x2, w2, pb2),
                 rel_close(1e-5), "1e-5 x max", nbytes(x2, w2, pb2) + 2 * 4 * 256,
                 2 * 3 * vecs * 2 + 12 * vecs, reps=10, repro=True, versus=True)
    walk_vs_narrow(rec, fn, same_bits=True)
    c1, c2 = randn(256, scale=1e-4), randn(256, scale=1e-5)
    # S' at final_conv.0 (fused): p, dx and dW, each a 2-deep product
    fn = lambda: vn_layer_fused.stats_bwd(x2, w2, pb2, c1, c2)  # noqa: E731
    rec = record("S' vn_layer_stats backward 2 -> 256", src_b,
                 "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:325", fn,
                 lambda: vn_layer_fused.reference_stats_bwd(x2, w2, pb2, c1, c2),
                 rel_close(1e-4), "1e-4 x max", 2 * nbytes(x2, w2, pb2) + nbytes(c1, c2),
                 3 * 2 * 3 * vecs * 2 + 18 * vecs, reps=10, plain_reps=3, repro=True,
                 versus=True)
    walk_vs_narrow(rec, fn, same_bits=False)
    x = randn(BATCH, 3, 256, n)
    w = uniform(-1 / 16, 1 / 16, 256, 256)
    prod = 2 * 3 * vecs * 256  # one (256 x 256) map over all planes and points
    record("S vn_layer_stats", src_b, "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:278",
           lambda: vn_layer_fused.stats_fwd(x, w, None),
           lambda: vn_layer_fused.reference_stats(x, w, None),
           rel_close(1e-5), "1e-5 x max", nbytes(x, w) + 2 * 4 * 256,
           prod + 9 * vecs, reps=10, repro=True)
    stats_wide_vs_narrow(x, w, "256 -> 256")
    # S at vn_folding{1,2}.1 (256 -> 128, 14336 points), wide, timed
    xf = randn(BATCH, 3, 256, 14336)
    wf = uniform(-1 / 16, 1 / 16, 128, 256)
    vecs_f = BATCH * 128 * 14336
    record("S vn_layer_stats 256 -> 128", src_b,
           "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:278",
           lambda: vn_layer_fused.stats_fwd(xf, wf, None),
           lambda: vn_layer_fused.reference_stats(xf, wf, None),
           rel_close(1e-5), "1e-5 x max", nbytes(xf, wf) + 2 * 4 * 128,
           2 * 3 * vecs_f * 256 + 9 * vecs_f, reps=10, repro=True)
    stats_wide_vs_narrow(xf, wf, "256 -> 128")
    del xf
    record("S' vn_layer_stats backward",
           "vn_pointcloudcompletion_tpu_torch/csrc/vn_layer_bwd.cu",
           "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:325",
           lambda: vn_layer_fused.stats_bwd(x, w, None, c1, c2),
           lambda: vn_layer_fused.reference_stats_bwd(x, w, None, c1, c2),
           rel_close(1e-4), "1e-4 x max", 2 * nbytes(x) + 2 * nbytes(w) + 2 * 4 * 256,
           3 * prod + 15 * vecs, reps=10, plain_reps=3, repro=True)
    del x

    # B: decoder final_conv.0, C_in=2 (seed, point), C_out=256, per-sample bias
    n, c_out = 16384, 256
    x = randn(BATCH, 3, 2, n, scale=0.3)
    w, wd = uniform(-0.02, 0.02, c_out, 2), uniform(-0.02, 0.02, c_out, 2)
    pb, db = randn(BATCH, 3, c_out, 1), randn(BATCH, 3, c_out, 1)
    a, b = uniform(0.5, 1.5, c_out), randn(c_out, scale=0.3)
    vecs = BATCH * c_out * n
    record("B vn_layer_fused", "vn_pointcloudcompletion_tpu_torch/csrc/vn_layer_fused.cu",
           "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:541",
           lambda: vn_layer_fused.vn_layer_fused(x, w, wd, pb, db, a, b, NS),
           lambda: vn_layer_fused.reference_layer_fused(x, w, wd, pb, db, a, b, NS),
           close(1e-5, 1e-5), "atol 1e-5 + rtol 1e-5",
           nbytes(x, w, wd, pb, db, a, b) + 4 * 3 * vecs,
           2 * 3 * vecs * 2 * 2 + 38 * vecs, repro=True)
    layer_stream_vs_narrow("2 -> 256, N 16384, per-sample bias, float32", x, w, wd, pb, db, a, b)

    # C: decoder final_conv.1 + final_conv.2, C_in = C_out = 256
    x = randn(BATCH, 3, 256, n)
    w, wd = uniform(-1 / 16, 1 / 16, 256, 256), uniform(-1 / 16, 1 / 16, 256, 256)
    w_out = uniform(-1 / 16, 1 / 16, 256)
    record("C vn_layer_fused_project",
           "vn_pointcloudcompletion_tpu_torch/csrc/vn_layer_fused.cu",
           "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:821",
           lambda: vn_layer_fused.vn_layer_fused_project(x, w, wd, None, None, a, b, w_out, NS),
           lambda: vn_layer_fused.reference_layer_fused_project(
               x, w, wd, None, None, a, b, w_out, NS),
           close(1e-4, 1e-4), "atol 1e-4 + rtol 1e-4",
           nbytes(x, w, wd, a, b, w_out) + 4 * 3 * BATCH * n,
           2 * 3 * vecs * 2 * 256 + (32 + 6) * vecs, reps=10, repro=True)

    # B': the backward of B at final_conv.0 (Cin 2, Cout 256, per-sample bias)
    x = randn(BATCH, 3, 2, n, scale=0.3)
    w, wd = uniform(-0.02, 0.02, c_out, 2), uniform(-0.02, 0.02, c_out, 2)
    g_ = randn(BATCH, 3, c_out, n, scale=1e-4)
    record("B' vn_layer_fused backward",
           "vn_pointcloudcompletion_tpu_torch/csrc/vn_layer_bwd.cu",
           "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:594",
           lambda: vn_layer_fused.layer_bwd(x, w, wd, pb, db, a, b, g_, NS),
           lambda: vn_layer_fused.reference_layer_bwd(x, w, wd, pb, db, a, b, g_, NS),
           rel_close(1e-4), "1e-4 x max",
           2 * nbytes(x, w, wd, pb, db, a, b) + nbytes(g_),
           6 * 2 * 3 * vecs * 2 + (80 + 6) * vecs, repro=True)
    del g_

    # C': the backward of C at final_conv.1 + final_conv.2 (256 -> 256 -> 1)
    x = randn(BATCH, 3, 256, n)
    w, wd = uniform(-1 / 16, 1 / 16, 256, 256), uniform(-1 / 16, 1 / 16, 256, 256)
    g_ = randn(BATCH, 3, 1, n, scale=1e-4)
    record("C' vn_layer_fused_project backward",
           "vn_pointcloudcompletion_tpu_torch/csrc/vn_layer_bwd.cu",
           "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:878",
           lambda: vn_layer_fused.layer_project_bwd(x, w, wd, None, None, a, b, w_out, g_, NS),
           lambda: vn_layer_fused.reference_layer_project_bwd(
               x, w, wd, None, None, a, b, w_out, g_, NS),
           rel_close(1e-4), "1e-4 x max",
           2 * nbytes(x, w, wd, a, b, w_out) + nbytes(g_),
           6 * prod + 90 * vecs, reps=5, plain_reps=3, repro=True)
    del x, g_
    check_group_kernels(dev, record, randn, uniform, close, rel_close)

    # D: test-time chamfer, dense prediction (16384) against complete (16384)
    px = uniform(-0.3, 0.3, BATCH, n, 3)
    py = uniform(-0.3, 0.3, BATCH, n, 3)

    def exact(got, want):
        dmax = max((got[k] - want[k]).abs().max().item() for k in (0, 2))
        same = all(torch.equal(got[k], want[k]) for k in range(4))
        return dmax, same

    def cdist_min(a, b):  # the library yardstick: torch.cdist and its two minima
        d = torch.cdist(a, b)
        return d.min(2), d.min(1)

    # each pair's distance (8 operations) and both minima, once
    rec = record("D nn_bidirectional",
                 "vn_pointcloudcompletion_tpu_torch/csrc/chamfer_bidir.cu",
                 "vn_pointcloudcompletion_tpu/ops/chamfer_pallas_bidir.py:159",
                 lambda: chamfer.nn_bidirectional(px, py),
                 lambda: chamfer.nn_bidirectional_reference(px, py),
                 exact, "distances and indices exact",
                 nbytes(px, py) + 2 * 4 * 2 * BATCH * n,
                 BATCH * n * n * (8 + 2), reps=10, plain_reps=3, repro=True,
                 library_fn=lambda: cdist_min(px, py))
    torch.cuda.empty_cache()
    # D's issue floor beside its row (the file is built --fmad=false, so its
    # ten operations a pair issue as ten instructions, not five FMA slots):
    # a trip of its chunk loop's warp instructions (chamfer_sweep_issue:
    # the SASS of the library built in this run) over the pairs a lane
    # folds in it, 4 issued a clock on each SM at the card's top clock
    try:
        trip, per_trip = chamfer_sweep_issue()
    except (OSError, ValueError, KeyError, subprocess.SubprocessError) as exc:
        print(f"[kernel D nn_bidirectional] the sweep's issue floor: not measured ({exc})",
              flush=True)
    else:
        floor_ms, sms, mhz = issue_floor_ms(dev, BATCH * n * n, trip, per_trip)
        dev_ms = graph_ms(lambda: chamfer.nn_bidirectional(px, py))
        rec.update({"issue_floor_ms": floor_ms, "graph_ms": dev_ms})
        print(f"[kernel D nn_bidirectional] the sweep's issue floor: {BATCH * n * n} pairs x "
              f"{trip} instructions a trip / {per_trip} pairs a lane a trip (SASS of this build) "
              f"/ 32 lanes / ({sms} SMs x 4 a clock x {mhz:.0f} MHz) = {floor_ms:.4f} ms; the "
              f"device time {dev_ms:.4f} ms ({floor_ms / dev_ms:.1%} of it; the FP32 bound, 10 "
              f"operations a pair at 67 TFLOP/s, {rec['bound_ms']:.4f} ms)", flush=True)
    # D at the training loss's coarse pair (1024 predicted against the 16384
    # complete points; half of D's launches in a train step) and at
    # num_coarse 448's (448 against 14336)
    for nc, nd in ((1024, n), (448, 14336)):
        pc = uniform(-0.3, 0.3, BATCH, nc, 3)
        pd = py if nd == n else uniform(-0.3, 0.3, BATCH, nd, 3)
        record(f"D nn_bidirectional {nc} x {nd}",
               "vn_pointcloudcompletion_tpu_torch/csrc/chamfer_bidir.cu",
               "vn_pointcloudcompletion_tpu/ops/chamfer_pallas_bidir.py:159",
               lambda: chamfer.nn_bidirectional(pc, pd),
               lambda: chamfer.nn_bidirectional_reference(pc, pd),
               exact, "distances and indices exact",
               nbytes(pc, pd) + 2 * 4 * (nc + nd) * BATCH,
               BATCH * nc * nd * (8 + 2), reps=20, plain_reps=3, repro=True,
               library_fn=lambda: cdist_min(pc, pd))
    del px, py, pc, pd
    records += check_knn_fps_kernels(dev, record, randn, uniform)
    check_emd_kernel(dev, record)
    check_bf16_kernels(dev, record, randn, uniform)
    return records


def bf16_ulps(got, want):
    """(largest |got - want| in bf16 ulps of the larger magnitude, count of
    elements that differ) of two bf16 tensors."""
    import torch

    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((g - w).abs() / ulp).max().item(), int((g != w).sum())


def bf16_rms(got, want) -> float:
    """||got - want|| / ||want||, in float64."""
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm().clamp_min(1e-300)).item()


def check_bf16_kernels(dev, record, randn, uniform):
    """Phase 3, the bf16 modes (the bfloat16 policy's serving path) at
    the main paths' shapes, each against its plain bf16 version: A at the
    flagship's second_conv.0 (C 1024, N 2048), B at its final_conv.0 (C_in
    2, C_out 256, N 16384, per-sample bias) and at the attention decoder's
    pair folds (C_in 1 -> 256, N 14336, group 64), K3 at every path shape
    (EDGE_SHAPES, k 16): equal to the bit; C (the wide design, on the tensor cores)
    at final_conv.1 + .2 (256 -> 256 -> 1, N 16384) and in group mode at 256
    -> 128 -> 1 (N 14336, group 64): within BF16_C_RMS in root mean square,
    the mutant (x BF16_MUTANT) at least 4x beyond, the differing count
    printed; twice for equal bits.  Bounds: bytes at 2 per activation
    element; the products' operations at the dense bf16 tensor-core rate
    plus the elementwise float32 operations at the FP32 rate (``bound``;
    A, with no products, all at the FP32 rate)."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import knn_pallas, vn_fused, vn_layer_fused

    bf = torch.bfloat16
    src = "vn_pointcloudcompletion_tpu_torch/csrc/"
    at = "vn_pointcloudcompletion_tpu/ops/"

    def equal(got, want):
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        same = all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want)
                  if torch.is_floating_point(w))
        return err, same and got[0].dtype == bf

    def within_rms(got, want):
        """BF16_C_RMS, and the mutant (the output x BF16_MUTANT) at least 4x
        beyond it."""
        worst_ulp, differ = bf16_ulps(got, want)
        rms, mutant = bf16_rms(got, want), bf16_rms(got * BF16_MUTANT, want)
        print(f"[kernel C bf16] RMS distance {rms:.3e} (bound {BF16_C_RMS:.3e}); the mutant "
              f"(x {BF16_MUTANT}) {mutant:.3e} = {mutant / BF16_C_RMS:.1f}x the bound (at least "
              f"4x); {differ} of {got.numel()} elements differ, the largest by "
              f"{worst_ulp:.2f} bf16 ulp")
        ok = got.dtype == bf and rms <= BF16_C_RMS and mutant >= 4 * BF16_C_RMS
        return (got.float() - want.float()).abs().max().item(), ok

    check_a_bf16(record, randn, uniform)

    n, c_out = 16384, 256
    x = randn(BATCH, 3, 2, n, scale=0.3).to(bf)
    w, wd = uniform(-0.02, 0.02, c_out, 2), uniform(-0.02, 0.02, c_out, 2)
    pb, db = randn(BATCH, 3, c_out, 1).to(bf), randn(BATCH, 3, c_out, 1).to(bf)
    a, b = uniform(0.5, 1.5, c_out), randn(c_out, scale=0.3)
    vecs = BATCH * c_out * n
    record("B vn_layer_fused bf16", src + "vn_layer_fused.cu", at + "vn_layer_fused.py:541",
           lambda: vn_layer_fused.vn_layer_fused(x, w, wd, pb, db, a, b, NS),
           lambda: vn_layer_fused.reference_layer_fused(x, w, wd, pb, db, a, b, NS),
           equal, "equal to the bit", nbytes(x, w, wd, pb, db, a, b) + 2 * 3 * vecs,
           2 * 3 * vecs * 2 * 2, repro=True, peak_ops=PEAK_BF16, fp32_ops=38 * vecs)
    layer_stream_vs_narrow("2 -> 256, N 16384, per-sample bias, bf16", x, w, wd, pb, db, a, b)

    n, s = 14336, 64
    bw = 1 / 385 ** 0.5
    x = randn(BATCH, 3, 1, n).to(bf)
    w, wd = uniform(-bw, bw, 256, 1), uniform(-bw, bw, 256, 1)
    pb = randn(BATCH, 3, 256, n // s, scale=0.5).to(bf)
    db = randn(BATCH, 3, 256, n // s, scale=0.5).to(bf)
    vecs = BATCH * 256 * n
    record("B vn_layer_fused group=64 bf16", src + "vn_layer_fused.cu",
           at + "vn_layer_fused.py:541",
           lambda: vn_layer_fused.vn_layer_fused(x, w, wd, pb, db, a, b, NS, group=s),
           lambda: vn_layer_fused.reference_layer_fused(x, w, wd, pb, db, a, b, NS, s),
           equal, "equal to the bit", nbytes(x, w, wd, pb, db, a, b) + 2 * 3 * vecs,
           2 * 3 * vecs * 2, repro=True, peak_ops=PEAK_BF16, fp32_ops=44 * vecs)
    layer_stream_vs_narrow("1 -> 256, N 14336, group 64, bf16", x, w, wd, pb, db, a, b, s)

    n = 16384
    x = randn(BATCH, 3, 256, n).to(bf)
    w, wd = uniform(-1 / 16, 1 / 16, 256, 256), uniform(-1 / 16, 1 / 16, 256, 256)
    w_out = uniform(-1 / 16, 1 / 16, 256)
    vecs = BATCH * 256 * n
    c_fn = functools.partial(vn_layer_fused.vn_layer_fused_project, x, w, wd, None, None, a, b,
                             w_out, NS)
    rec = record("C vn_layer_fused_project bf16", src + "vn_layer_fused.cu",
                 at + "vn_layer_fused.py:821", c_fn,
                 lambda: vn_layer_fused.reference_layer_fused_project(
                     x, w, wd, None, None, a, b, w_out, NS),
                 within_rms, f"RMS {BF16_C_RMS:.3e} of the norm",
                 nbytes(x, w, wd, a, b, w_out) + 2 * 3 * BATCH * n,
                 2 * 3 * vecs * 2 * 256, reps=10, repro=True, peak_ops=PEAK_BF16,
                 fp32_ops=(32 + 6) * vecs, versus=True)
    proj_vs_parent(rec, c_fn, x, w, wd)
    # C at vn_folding{1,2}.1 + .2 as vn_pointr_448 runs them (256 -> 128 -> 1,
    # N 14336, group 0, no bias); inputs from a generator of their own, so
    # that the later rows' inputs stay as they were
    g2 = torch.Generator(device=x.device).manual_seed(22)

    def u(lo, hi, *shape):
        return torch.rand(*shape, generator=g2, device=x.device) * (hi - lo) + lo

    n = 14336
    x = torch.randn(BATCH, 3, 256, n, generator=g2, device=x.device).to(bf)
    w2, wd2 = u(-1 / 16, 1 / 16, 128, 256), u(-1 / 16, 1 / 16, 128, 256)
    a2, b2 = u(0.5, 1.5, 128), torch.randn(128, generator=g2, device=x.device) * 0.3
    wo2 = u(-1 / 11, 1 / 11, 128)
    vecs = BATCH * 128 * n
    c_fn = functools.partial(vn_layer_fused.vn_layer_fused_project, x, w2, wd2, None, None, a2,
                             b2, wo2, NS)
    rec = record("C vn_layer_fused_project 256->128 bf16", src + "vn_layer_fused.cu",
                 at + "vn_layer_fused.py:821", c_fn,
                 lambda: vn_layer_fused.reference_layer_fused_project(
                     x, w2, wd2, None, None, a2, b2, wo2, NS),
                 within_rms, f"RMS {BF16_C_RMS:.3e} of the norm",
                 nbytes(x, w2, wd2, a2, b2, wo2) + 2 * 3 * BATCH * n,
                 2 * 3 * vecs * 2 * 256, reps=10, repro=True, peak_ops=PEAK_BF16,
                 fp32_ops=(32 + 6) * vecs, versus=True)
    proj_vs_parent(rec, c_fn, x, w2, wd2)
    del w2, wd2, a2, b2, wo2
    # C in group mode at vn_folding{1,2}.1 + .2's width (on no model's path)
    n, s = 14336, 64
    x = randn(BATCH, 3, 256, n).to(bf)
    w, wd = uniform(-1 / 16, 1 / 16, 128, 256), uniform(-1 / 16, 1 / 16, 128, 256)
    pb = randn(BATCH, 3, 128, n // s, scale=0.5).to(bf)
    db = randn(BATCH, 3, 128, n // s, scale=0.5).to(bf)
    a, b, w_out = uniform(0.5, 1.5, 128), randn(128, scale=0.3), uniform(-1 / 11, 1 / 11, 128)
    vecs = BATCH * 128 * n
    c_fn = functools.partial(vn_layer_fused.vn_layer_fused_project, x, w, wd, pb, db, a, b,
                             w_out, NS, group=s)
    rec = record("C vn_layer_fused_project group=64 bf16", src + "vn_layer_fused.cu",
                 at + "vn_layer_fused.py:821", c_fn,
                 lambda: vn_layer_fused.reference_layer_fused_project(
                     x, w, wd, pb, db, a, b, w_out, NS, s),
                 within_rms, f"RMS {BF16_C_RMS:.3e} of the norm (on no path)",
                 nbytes(x, w, wd, pb, db, a, b, w_out) + 2 * 3 * BATCH * n,
                 2 * 3 * vecs * 2 * 256, reps=10, repro=True, peak_ops=PEAK_BF16,
                 fp32_ops=(32 + 12) * vecs, versus=True)
    proj_vs_parent(rec, c_fn, x, w, wd)
    del x

    # K3 at every path shape (EDGE_SHAPES) on bf16 coordinates or features
    for n, dim, c3 in EDGE_SHAPES:
        xf = (uniform(-0.5, 0.5, BATCH, dim, n) if dim == 3 else randn(BATCH, dim, n)).to(bf)
        u, v = randn(BATCH, c3, n).to(bf), randn(BATCH, c3, n).to(bf)
        edge_record(record, "K3 edge_knn_gather", src + "knn.cu", xf, u, v, 16)
    check_bf16_train_kernels(dev, record, randn, uniform)


def check_a_bf16(record, randn, uniform):
    """Phase 3, kernel A in bf16 at every shape of the paths
    (A_BF16_SHAPES): the run8 design against its plain version and its
    parent (vector) design, equal to the bit, and timed beside the parent
    design; the flagship's second_conv.0 (C 1024, N 2048) is the row of
    the kernels line."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import vn_fused

    bf = torch.bfloat16

    def equal(got, want):
        same = got.dtype == bf and torch.equal(got, want)
        return (got.float() - want.float()).abs().max().item(), same

    # A at every shape of the paths (A_BF16_SHAPES), the run8 design against
    # its plain version and its parent design, equal to the bit; the
    # flagship's second_conv.0 (C 1024, N 2048) is the timed row, the
    # others are timed beside the parent design
    for c, n in A_BF16_SHAPES:
        p, d = randn(BATCH, 3, c, n).to(bf), randn(BATCH, 3, c, n).to(bf)
        p[:, :, :8, :16] = 0.0
        a, b = uniform(0.5, 1.5, c), randn(c, scale=0.3)
        fn = lambda: vn_fused.fused_bn_leaky(p, d, a, b, NS)  # noqa: E731
        work = nbytes(p, d, a, b) + nbytes(p), 32 * BATCH * c * n  # float32 work: FP32 rate
        if (c, n) == A_BF16_SHAPES[0]:
            rec = record("A fused_bn_leaky bf16", "vn_pointcloudcompletion_tpu_torch/csrc/vn_fused.cu",
                         "vn_pointcloudcompletion_tpu/ops/vn_fused.py:189", fn,
                         lambda: vn_fused.reference_bn_leaky_planes(p, d, a, b, NS),
                         equal, "equal to the bit", *work, repro=True, versus=True)
        else:
            got, designs = launched_designs(fn)
            _, ok = equal(got, vn_fused.reference_bn_leaky_planes(p, d, a, b, NS))
            rec = {"name": f"A fused_bn_leaky bf16 C {c} N {n}", "ms": cuda_ms(fn, 20),
                   "bound_ms": bound(*work)[0], "design": "/".join(designs)}
            print(f"[kernel {rec['name']}] equal to the plain version: {ok}; bound "
                  f"{rec['bound_ms']:.4f} ms (bytes)", flush=True)
            if not ok:
                raise AssertionError(f"kernel A bf16 disagrees with its plain version at C {c}, "
                                     f"N {n}")
        got = fn()
        with parent_designs():
            parent, parent_design = launched_designs(fn)
        same = torch.equal(got, parent)
        print(f"[kernel {rec['name']}] the {rec.get('design')} design's output bitwise equal to "
              f"the parent ({'/'.join(parent_design)}) design's: {same}", flush=True)
        if not same or rec.get("design") != "run8" or parent_design != ["vector"]:
            raise AssertionError(f"kernel A bf16 at C {c}, N {n}: the run8 and vector designs "
                                 "were not taken or differ")
        versus_parent(rec, fn)
        del p, d, got, parent


def bf16_bwd_close(rel, exact=()):
    """Compare the outputs of a bf16 training kernel with its plain bf16
    version's: those in ``exact`` equal to the bit, the other bf16 ones
    within one bf16 ulp of their largest magnitude (float32 sums taken in
    another order, then one rounding), the float32 ones within ``rel`` of
    their max.  Returns the largest absolute error."""
    import torch

    def cmp(got, want):
        err, ok = 0.0, True
        for k, (g, w) in enumerate(zip(got, want)):
            if w is None:
                continue
            e = (g.float() - w.float()).abs().max().item()
            err = max(err, e)
            scale = max(w.float().abs().max().item(), 2.0 ** -126)
            if k in exact:
                ok = ok and torch.equal(g, w)
            elif w.dtype == torch.bfloat16:
                ok = ok and g.dtype == w.dtype and e <= 2.0 ** (math.floor(math.log2(scale)) - 7)
            else:
                ok = ok and e <= rel * scale
        return err, ok
    return cmp


def check_bf16_train_kernels(dev, record, randn, uniform):
    """Phase 3, the bf16 modes of the training kernels (the bfloat16
    policy's training path) at the main paths' shapes, each against its
    plain bf16 version (``bf16_bwd_close``) and twice for equal bits: A' at
    the flagship's second_conv.0 (C 1024, N 2048; dp and dd equal to the
    bit), S and S' at final_conv.1 (256 -> 256, N 16384) and at
    final_conv.0 (2 -> 256, per-sample bias, beside the narrow design:
    ``walk_vs_narrow``), S, S' and B' at
    the attention decoder's pair folds (1 -> 256, N 14336, group 64), B' at
    final_conv.0 (2 -> 256, per-sample bias), C' at final_conv.1 + .2 (256
    -> 256 -> 1).  Bounds: bytes at 2 per activation element (4 per
    parameter and float32 gradient); the products' operations (bf16
    operands) at the dense bf16 tensor-core rate plus the elementwise
    float32 operations at the FP32 rate (``bound``), whichever design runs
    them; A' (no products) at the FP32 rate."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import vn_fused, vn_layer_fused

    bf = torch.bfloat16
    src = "vn_pointcloudcompletion_tpu_torch/csrc/"
    at = "vn_pointcloudcompletion_tpu/ops/"
    close = bf16_bwd_close(1e-4)

    c, n = 1024, 2048
    p, d, g_ = (randn(BATCH, 3, c, n).to(bf) for _ in range(3))
    p[:, :, :8, :16] = 0.0
    a, b = uniform(0.5, 1.5, c), randn(c, scale=0.3)
    vecs = BATCH * c * n
    record("A' fused_bn_leaky backward bf16", src + "vn_fused.cu", at + "vn_fused.py:214",
           lambda: vn_fused.bn_leaky_bwd(p, d, a, b, g_, NS),
           lambda: vn_fused.reference_bn_leaky_bwd(p, d, a, b, g_, NS),
           bf16_bwd_close(1e-5, exact=(0, 1)), "dp, dd equal to the bit; dA, dB 1e-5 x max",
           nbytes(p, d, g_, a, b) + 2 * nbytes(p) + 2 * 4 * c, 80 * vecs, repro=True)
    del p, d, g_

    n = 16384
    x = randn(BATCH, 3, 256, n).to(bf)
    w = uniform(-1 / 16, 1 / 16, 256, 256)
    c1, c2 = randn(256, scale=1e-4), randn(256, scale=1e-5)
    vecs = BATCH * 256 * n
    prod = 2 * 3 * vecs * 256
    stats_wide_vs_narrow(x, w, "256 -> 256")
    k16_probe()
    # S, S' and C' at final_conv.1 (256 -> 256, N 16384) and
    # vn_folding{1,2}.1 (256 -> 128, N 14336): pass1_bf16_design's designs
    # (wgmma_p), beside the parent designs, pass by pass, with torch.matmul
    # as the yardstick of each pass; S's p against S''s and the k16 model;
    # C''s p, d against the forward C's, S's and the model, its bits against
    # the parent's
    for c_out, npts in ((256, n), (128, 14336)):
        shape = "" if c_out == 256 else " 256 -> 128"
        xs = x if npts == n else randn(BATCH, 3, 256, npts).to(bf)
        ws = w if c_out == 256 else uniform(-1 / 16, 1 / 16, c_out, 256)
        vecs_s = BATCH * c_out * npts
        prod_s = 2 * 3 * vecs_s * 256
        fn = lambda: vn_layer_fused.stats_fwd(xs, ws, None)  # noqa: E731
        rec = record(f"S vn_layer_stats{shape} bf16", src + "vn_layer_bwd.cu",
                     at + "vn_layer_fused.py:278", fn,
                     lambda: vn_layer_fused.reference_stats(xs, ws, None),
                     close, "1e-4 x max", nbytes(xs, ws) + 2 * 4 * c_out, prod_s, reps=10,
                     repro=True, peak_ops=PEAK_BF16, fp32_ops=9 * vecs_s, versus=True)
        wgmma_vs_parent(rec, fn, xs, ws, kind="S")
        same_p(rec, xs, ws, c1[:c_out], c2[:c_out])
        fn = lambda: vn_layer_fused.stats_bwd(xs, ws, None, c1[:c_out], c2[:c_out])  # noqa: E731
        rec = record(f"S' vn_layer_stats backward{shape} bf16", src + "vn_layer_bwd.cu",
                     at + "vn_layer_fused.py:325", fn,
                     lambda: vn_layer_fused.reference_stats_bwd(xs, ws, None, c1[:c_out],
                                                                c2[:c_out]),
                     close, "dx 1 bf16 ulp of max; dW 1e-4 x max",
                     2 * nbytes(xs) + 2 * nbytes(ws) + 2 * 4 * c_out, 3 * prod_s, reps=10,
                     plain_reps=3, repro=True, peak_ops=PEAK_BF16, fp32_ops=15 * vecs_s,
                     versus=True)
        wgmma_vs_parent(rec, fn, xs, ws, kind="S'")
        wc, wdc = uniform(-1 / 16, 1 / 16, c_out, 256), uniform(-1 / 16, 1 / 16, c_out, 256)
        a, b = uniform(0.5, 1.5, c_out), randn(c_out, scale=0.3)
        w_out = uniform(-1 / 16, 1 / 16, c_out)
        g_ = randn(BATCH, 3, 1, npts, scale=1e-4).to(bf)
        fn = lambda: vn_layer_fused.layer_project_bwd(  # noqa: E731
            xs, wc, wdc, None, None, a, b, w_out, g_, NS)
        order = vn_layer_fused.launch_order("C'", xs, c_out)
        rec = record(f"C' vn_layer_fused_project backward{shape} bf16", src + "vn_layer_bwd.cu",
                     at + "vn_layer_fused.py:878", fn,
                     lambda: vn_layer_fused.reference_layer_project_bwd(
                         xs, wc, wdc, None, None, a, b, w_out, g_, NS, order=order),
                     close, f"dx 1 bf16 ulp of max; dW, dWd, dA, dB, dw_out 1e-4 x max (the "
                     f"plain C' summing p, d in {order} order)",
                     2 * nbytes(xs, wc, wdc, a, b, w_out) + nbytes(g_), 6 * prod_s, reps=5,
                     plain_reps=1, repro=True, peak_ops=PEAK_BF16, fp32_ops=90 * vecs_s,
                     versus=True)
        wgmma_vs_parent(rec, fn, xs, wc, wdc, kind="C'")
        c_bwd_checks(rec, (xs, wc, wdc, None, None, a, b, w_out, g_),
                     adversarial_c_inputs(xs.device, BATCH, 256, c_out, npts, 9))
        del g_, xs
    del x
    a, b = uniform(0.5, 1.5, 256), randn(256, scale=0.3)

    x = randn(BATCH, 3, 2, n, scale=0.3).to(bf)
    w, wd = uniform(-0.02, 0.02, 256, 2), uniform(-0.02, 0.02, 256, 2)
    pb, db = randn(BATCH, 3, 256, 1).to(bf), randn(BATCH, 3, 256, 1).to(bf)
    g_ = randn(BATCH, 3, 256, n, scale=1e-4).to(bf)
    fn = lambda: vn_layer_fused.stats_fwd(x, w, pb)  # noqa: E731
    rec = record("S vn_layer_stats 2 -> 256 bf16", src + "vn_layer_bwd.cu",
                 at + "vn_layer_fused.py:278", fn,
                 lambda: vn_layer_fused.reference_stats(x, w, pb),
                 close, "1e-4 x max", nbytes(x, w, pb) + 2 * 4 * 256, 2 * 3 * vecs * 2,
                 reps=10, repro=True, peak_ops=PEAK_BF16, fp32_ops=12 * vecs, versus=True)
    walk_vs_narrow(rec, fn, same_bits=True)
    fn = lambda: vn_layer_fused.stats_bwd(x, w, pb, c1, c2)  # noqa: E731
    rec = record("S' vn_layer_stats backward 2 -> 256 bf16", src + "vn_layer_bwd.cu",
                 at + "vn_layer_fused.py:325", fn,
                 lambda: vn_layer_fused.reference_stats_bwd(x, w, pb, c1, c2),
                 close, "dx, bias grads 1 bf16 ulp of max; dW 1e-4 x max",
                 2 * nbytes(x, w, pb) + nbytes(c1, c2), 3 * 2 * 3 * vecs * 2, reps=10,
                 plain_reps=3, repro=True, peak_ops=PEAK_BF16, fp32_ops=18 * vecs, versus=True)
    walk_vs_narrow(rec, fn, same_bits=False)
    record("B' vn_layer_fused backward bf16", src + "vn_layer_bwd.cu",
           at + "vn_layer_fused.py:594",
           lambda: vn_layer_fused.layer_bwd(x, w, wd, pb, db, a, b, g_, NS),
           lambda: vn_layer_fused.reference_layer_bwd(x, w, wd, pb, db, a, b, g_, NS),
           close, "dx, bias grads 1 bf16 ulp of max; dW, dWd, dA, dB 1e-4 x max",
           2 * nbytes(x, w, wd, pb, db, a, b) + nbytes(g_), 6 * 2 * 3 * vecs * 2,
           repro=True, peak_ops=PEAK_BF16, fp32_ops=86 * vecs)
    del g_

    n, s = 14336, 64
    bw = 1 / 385 ** 0.5
    x = randn(BATCH, 3, 1, n).to(bf)
    w, wd = uniform(-bw, bw, 256, 1), uniform(-bw, bw, 256, 1)
    pb = randn(BATCH, 3, 256, n // s, scale=0.5).to(bf)
    db = randn(BATCH, 3, 256, n // s, scale=0.5).to(bf)
    g_ = randn(BATCH, 3, 256, n, scale=1e-4).to(bf)
    vecs = BATCH * 256 * n
    io = nbytes(x, w, wd, pb, db, a, b)
    fn = lambda: vn_layer_fused.stats_fwd(x, w, pb, s)  # noqa: E731
    rec = record("S vn_layer_stats group=64 bf16", src + "vn_layer_bwd.cu",
                 at + "vn_layer_fused.py:278", fn,
                 lambda: vn_layer_fused.reference_stats(x, w, pb, s),
                 close, "1e-4 x max", nbytes(x, w, pb) + 2 * 4 * 256, 2 * 3 * vecs,
                 reps=10, repro=True, peak_ops=PEAK_BF16, fp32_ops=12 * vecs, versus=True)
    walk_vs_narrow(rec, fn, same_bits=True)
    fn = lambda: vn_layer_fused.stats_bwd(x, w, pb, c1, c2, s)  # noqa: E731
    rec = record("S' vn_layer_stats backward group=64 bf16", src + "vn_layer_bwd.cu",
                 at + "vn_layer_fused.py:325", fn,
                 lambda: vn_layer_fused.reference_stats_bwd(x, w, pb, c1, c2, s),
                 close, "dx, bias grads 1 bf16 ulp of max; dW 1e-4 x max",
                 2 * nbytes(x, w, pb) + nbytes(c1, c2), 3 * 2 * 3 * vecs, reps=10,
                 plain_reps=3, repro=True, peak_ops=PEAK_BF16, fp32_ops=18 * vecs, versus=True)
    walk_vs_narrow(rec, fn, same_bits=False)
    record("B' vn_layer_fused backward group=64 bf16", src + "vn_layer_bwd.cu",
           at + "vn_layer_fused.py:594",
           lambda: vn_layer_fused.layer_bwd(x, w, wd, pb, db, a, b, g_, NS, s),
           lambda: vn_layer_fused.reference_layer_bwd(x, w, wd, pb, db, a, b, g_, NS, s),
           close, "dx, bias grads 1 bf16 ulp of max; dW, dWd, dA, dB 1e-4 x max",
           2 * io + nbytes(g_), 6 * 2 * 3 * vecs, reps=10, plain_reps=3,
           repro=True, peak_ops=PEAK_BF16, fp32_ops=86 * vecs)


def check_group_kernels(dev, record, randn, uniform, close, rel_close):
    """Phase 3, group=S mode: B, S, S' and B' at the attention decoder's
    pair folds ``vn_folding{1,2}.0`` (C_in 1 -> 256, 224 centres x 64 grid
    points = 14336, the centre feature's contraction as one bias column per
    centre, group 64); C and C' (in group mode on no model's path) at
    ``vn_folding{1,2}.1`` + ``.2``'s width, 256 -> 128 -> 1, with the same
    bias layout.  Each twice, for equal bits."""
    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused

    n, s = 14336, 64
    src_f = "vn_pointcloudcompletion_tpu_torch/csrc/vn_layer_fused.cu"
    src_b = "vn_pointcloudcompletion_tpu_torch/csrc/vn_layer_bwd.cu"
    at = "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:"
    bound_w = 1 / 385 ** 0.5  # the fold layer's concat fan-in, 1 + 384
    x = randn(BATCH, 3, 1, n)
    w, wd = uniform(-bound_w, bound_w, 256, 1), uniform(-bound_w, bound_w, 256, 1)
    pb, db = randn(BATCH, 3, 256, n // s, scale=0.5), randn(BATCH, 3, 256, n // s, scale=0.5)
    a, b = uniform(0.5, 1.5, 256), randn(256, scale=0.3)
    c1, c2 = randn(256, scale=1e-4), randn(256, scale=1e-5)
    vecs = BATCH * 256 * n
    io = nbytes(x, w, wd, pb, db, a, b)
    # B: two 1-term products, the two bias adds and the epilogue per vector
    record("B vn_layer_fused group=64", src_f, at + "541",
           lambda: vn_layer_fused.vn_layer_fused(x, w, wd, pb, db, a, b, NS, group=s),
           lambda: vn_layer_fused.reference_layer_fused(x, w, wd, pb, db, a, b, NS, s),
           close(0.0, 0.0), "equal to the bit", io + 4 * 3 * vecs,
           2 * 3 * vecs * 2 + 44 * vecs, repro=True)
    layer_stream_vs_narrow("1 -> 256, N 14336, group 64, float32", x, w, wd, pb, db, a, b, s)
    fn = lambda: vn_layer_fused.stats_fwd(x, w, pb, s)  # noqa: E731
    rec = record("S vn_layer_stats group=64", src_b, at + "278", fn,
                 lambda: vn_layer_fused.reference_stats(x, w, pb, s),
                 rel_close(1e-5), "1e-5 x max", nbytes(x, w, pb) + 2 * 4 * 256,
                 2 * 3 * vecs + 12 * vecs, reps=10, repro=True, versus=True)
    walk_vs_narrow(rec, fn, same_bits=True)
    fn = lambda: vn_layer_fused.stats_bwd(x, w, pb, c1, c2, s)  # noqa: E731
    rec = record("S' vn_layer_stats backward group=64", src_b, at + "325", fn,
                 lambda: vn_layer_fused.reference_stats_bwd(x, w, pb, c1, c2, s),
                 rel_close(1e-4), "1e-4 x max", 2 * nbytes(x, w, pb) + nbytes(c1, c2),
                 3 * 2 * 3 * vecs + 18 * vecs, reps=10, plain_reps=3, repro=True, versus=True)
    walk_vs_narrow(rec, fn, same_bits=False)
    g_ = randn(BATCH, 3, 256, n, scale=1e-4)
    record("B' vn_layer_fused backward group=64", src_b, at + "594",
           lambda: vn_layer_fused.layer_bwd(x, w, wd, pb, db, a, b, g_, NS, s),
           lambda: vn_layer_fused.reference_layer_bwd(x, w, wd, pb, db, a, b, g_, NS, s),
           rel_close(1e-4), "1e-4 x max", 2 * io + nbytes(g_),
           6 * 2 * 3 * vecs + (80 + 6) * vecs, reps=10, plain_reps=3, repro=True)
    del g_

    x = randn(BATCH, 3, 256, n)
    w, wd = uniform(-1 / 16, 1 / 16, 128, 256), uniform(-1 / 16, 1 / 16, 128, 256)
    pb, db = randn(BATCH, 3, 128, n // s, scale=0.5), randn(BATCH, 3, 128, n // s, scale=0.5)
    a, b, w_out = uniform(0.5, 1.5, 128), randn(128, scale=0.3), uniform(-1 / 11, 1 / 11, 128)
    vecs = BATCH * 128 * n
    prod = 2 * 3 * vecs * 256
    io = nbytes(x, w, wd, pb, db, a, b, w_out)
    record("C vn_layer_fused_project group=64", src_f, at + "821",
           lambda: vn_layer_fused.vn_layer_fused_project(x, w, wd, pb, db, a, b, w_out, NS,
                                                         group=s),
           lambda: vn_layer_fused.reference_layer_fused_project(
               x, w, wd, pb, db, a, b, w_out, NS, s),
           close(1e-4, 1e-4), "atol 1e-4 + rtol 1e-4", io + 4 * 3 * BATCH * n,
           2 * prod + (32 + 12) * vecs, reps=10, repro=True)
    g_ = randn(BATCH, 3, 1, n, scale=1e-4)
    record("C' vn_layer_fused_project backward group=64", src_b, at + "878",
           lambda: vn_layer_fused.layer_project_bwd(x, w, wd, pb, db, a, b, w_out, g_, NS, s),
           lambda: vn_layer_fused.reference_layer_project_bwd(
               x, w, wd, pb, db, a, b, w_out, g_, NS, s),
           rel_close(1e-4), "1e-4 x max", 2 * io + nbytes(g_),
           6 * prod + 96 * vecs, reps=5, plain_reps=3, repro=True)


def same_indices(rel):
    """Compare (values, indices, ...): the indices (int tensors) equal, the
    float tensors within rel x their max |plain|; returns the largest
    absolute error of the floats."""
    import torch

    def cmp(got, want):
        err, ok = 0.0, True
        for g, w in zip(got, want):
            if not torch.is_floating_point(w):
                ok = ok and torch.equal(g, w)
                continue
            e = (g - w).abs().max().item()
            err = max(err, e)
            ok = ok and e <= rel * w.abs().max().item()
        return err, ok
    return cmp


# Kernel A's bf16 shapes on the paths (C, N) at batch 8: the flagship's
# second_conv.0 and first_conv.0, the VN DGCNN's conv4 and conv5 (the
# EdgeConv's k 16 x 512 points; vn_pointr's conv4 and conv5 as well), its
# conv6 (k 16 x 128 points) and vn_pointr's conv6
A_BF16_SHAPES = ((1024, 2048), (128, 2048), (64, 8192), (128, 8192), (512, 2048))
# K2's shapes on the paths (N, M, k), all over coordinates (D 3): the VN
# DGCNN's conv1 and vn_pointr's grouper (2048 vs 2048), the VN DGCNN's
# conv6 (128 vs 128), dgcnn_448's grouper layers (2048/2048, 512/2048,
# 512/512, 128/512), vn_pointr's proxy graph (128 vs 128 at k 8), the
# classic DGCNN's first two graphs (2048 vs 2048 at k 40), and vn_pointr's
# decoder stack (phase 15): its self graph over the 224 coarse points and
# its cross graph of those over the 128 centres, k 8
KNN_SHAPES = ((2048, 2048, 16), (128, 128, 16), (512, 2048, 16), (512, 512, 16),
              (128, 512, 16), (128, 128, 8), (2048, 2048, 40), (224, 224, 8), (224, 128, 8))
# K1's rows (M, k) over (8, 2048, M) matrices: knn()'s D > 512 branch at
# 2048 points (k 16), the row cap 4096, and the larger lists (k 40, 64)
K1_SHAPES = ((2048, 16), (4096, 16), (2048, 40), (2048, 64))
# K3's shapes on the paths (N, D, C3), k 16: the VN DGCNN's conv5 and conv4

# over the coordinates, vn_pointr's conv4, conv5 and conv6 over its features
EDGE_SHAPES = ((512, 3, 768), (512, 3, 384), (512, 96, 384), (512, 192, 384), (128, 192, 768))
# F's (N, S) on the paths: the trunks' 2048 -> 512 -> 128, num_coarse 448's tail
FPS_SHAPES = ((2048, 512), (512, 128), (2048, 224))


def lane_tie_cloud(dev, b: int, m: int, period: int = 32):
    """(b, m, 3) points whose distances from the origin (the last point) tie
    as duplicate points do inside one lane's list: P_j (radius 1 + j/100) at
    columns j and j + period, Q_j (radius 0.5) at j + 2 period for j < 8,
    the rest at radius 3 (``tests/test_torch_port_kernels.py::_lane_tie_cloud``).
    A period of 32 puts each pair in one lane of a warp that deals columns
    one a lane (the warp designs; K2's and K3's few-lane designs too), 16 in
    one lane of K1's stream design (4 lanes, 16-byte vectors)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(b * m)
    dirs = rng.standard_normal((b, m, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    radius = np.full(m, 3.0)
    radius[:period] = 1.0 + np.arange(period) / 100
    radius[2 * period:2 * period + 8] = 0.5
    pts = dirs * radius[None, :, None]
    pts[:, period:2 * period] = pts[:, :period]
    pts[:, m - 1] = 0.0
    return torch.from_numpy(pts.astype(np.float32)).to(dev)


def edge_record(record, name, source, x, u, v, k):
    """One phase-3 row of K3 at x's shape (its name gains the shape, but
    the VN DGCNN conv5's): indices and values equal to the plain version's,
    twice; then its device time split into the selection (the same call at
    C3 0) and the gather, and the gather's rate.  Its operations bound is
    at the FP32 rate in both modes: bf16 values are widened exactly and the
    distances formed in float32."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import knn_pallas

    b, dim, n = x.shape
    c3 = u.shape[1]
    bf16 = u.dtype == torch.bfloat16
    if (n, dim, c3) != EDGE_SHAPES[0]:
        name += f" N {n} D {dim} C3 {c3}"
    name += " bf16" if bf16 else ""
    out_bytes = u.element_size() * b * c3 * k * n
    fn = lambda: knn_pallas.edge_knn_gather_fwd(x, u, v, k)  # noqa: E731
    rec = record(name, source, "vn_pointcloudcompletion_tpu/ops/knn_pallas.py:350", fn,
                 lambda: knn_pallas.reference_edge_knn_gather(x, u, v, k),
                 same_indices(0.0), "indices and values exact",
                 nbytes(x, u, v) + out_bytes + 4 * b * n * k,
                 b * n * n * (2 * dim + 4) + b * c3 * k * n, repro=True)
    u0 = u[:, :0]
    device, select = graph_ms(fn), graph_ms(lambda: knn_pallas.edge_knn_gather_fwd(x, u0, u0, k))
    print(f"[kernel {name}] device {device:.4f} ms: selection {select:.4f} ms, gather "
          f"{device - select:.4f} ms ({out_bytes / (device - select) / 1e6:.0f} GB/s of output)",
          flush=True)
    return rec


def check_knn_kernel(dev, record, randn, uniform, q):
    """Phase 3, kernel K2 at every shape of the paths (KNN_SHAPES) against
    its plain version and its parent (warp) design, the (8, 2048 vs 2048,
    k 16) row timed beside the parent design and two PyTorch calls; ``q``:
    VN DGCNN conv1's input (B, 2048, 3)."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import fps_pallas, knn_pallas

    k = 16
    src_knn = "vn_pointcloudcompletion_tpu_torch/csrc/knn.cu"

    def pair_ops(n, m, dim):  # distance (2D + 3) and one compare per pair
        return BATCH * n * m * (2 * dim + 4)

    # K2 at every shape of the paths (KNN_SHAPES), queries and references
    # taken as the paths take them: FPS 2048 -> 512 -> 128 over VN DGCNN
    # conv1's own input (the rotated partial scans, whose resampling repeats
    # points, so repeated centres and equal distances occur), on the
    # lane-tie cloud (ties to the lowest index inside one lane's list and
    # across a query's lanes) and on uniform random clouds; at each:
    # indices equal to the plain version's, values within 1e-6 of its max,
    # a second launch and the parent (warp) design equal to the bit
    # (the decoder's 224 queries: FPS 2048 -> 224 of the scans, as the tail)
    levels = {2048: q}
    for m, prev in ((512, 2048), (128, 512), (224, 2048)):
        pick = fps_pallas.reference_furthest_point_sample(levels[prev], m).long()
        levels[m] = torch.gather(levels[prev], 1, pick[..., None].expand(-1, -1, 3))
    for n, m, kk in KNN_SHAPES:
        tie = lane_tie_cloud(dev, BATCH, m)
        # the last n points of the cloud repeated: the origin among the queries
        tie_q = torch.cat([tie] * -(-n // m), dim=1)[:, -n:]
        for what, qq, rr in (("scans", levels[n], levels[m]),
                             ("lane-tie cloud", tie_q, tie),
                             ("random clouds", uniform(-0.5, 0.5, BATCH, n, 3),
                              uniform(-0.5, 0.5, BATCH, m, 3))):
            (got, design), again = (launched_designs(lambda: knn_pallas.knn_min_fwd(qq, rr, kk)),
                                    knn_pallas.knn_min_fwd(qq, rr, kk))
            with parent_designs():
                parent, parent_design = launched_designs(
                    lambda: knn_pallas.knn_min_fwd(qq, rr, kk))
            err, ok = same_indices(1e-6)(got, knn_pallas.reference_knn_min(qq, rr, kk))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            same_parent = all(torch.equal(a, b) for a, b in zip(got, parent))
            design = "/".join(design)
            ok = ok and same and same_parent and design == "coords" and parent_design == ["warp"]
            print(f"[kernel K2] {n} vs {m}, k {kk}, {what} ({design}): max_abs_err {err:.3e} "
                  f"(indices equal, values 1e-6 x max), equal bits again {same}, the parent "
                  f"(warp) design's bits {same_parent} {'PASS' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel K2 disagrees at {n} vs {m}, k {kk} on the {what}")
    # timed at VN DGCNN conv1's shape (2048 vs 2048 on its own input, k 16);
    # the yardstick is two PyTorch calls, cdist and topk (nearest by
    # Euclidean distance, not squared: the same order, other values)
    fn = lambda: knn_pallas.knn_min_fwd(q, q, k)  # noqa: E731
    rec = record("K2 knn_min", src_knn, "vn_pointcloudcompletion_tpu/ops/knn_pallas.py:201", fn,
                 lambda: knn_pallas.reference_knn_min(q, q, k),
                 same_indices(1e-6), "indices equal, values 1e-6 x max",
                 2 * nbytes(q) + 8 * BATCH * 2048 * k, pair_ops(2048, 2048, 3),
                 reps=10, plain_reps=3, repro=True, versus=True,
                 library_fn=lambda: torch.topk(torch.cdist(q, q), k, dim=-1, largest=False))
    versus_parent(rec, fn)
    # the issue floor of the coords design's scan, beside the row, not in
    # it: a trip's warp instructions (knn_scan_issue: the SASS of the
    # library built in this run) over its references a lane, 32 pairs a
    # warp instruction, 4 issued a clock on each SM at the card's top clock
    try:
        trip, per_lane = knn_scan_issue()
    except (OSError, ValueError, subprocess.SubprocessError) as exc:
        print(f"[kernel K2 knn_min] the scan's issue floor: not measured ({exc})", flush=True)
    else:
        pairs = BATCH * 2048 * 2048
        floor_ms, sms, mhz = issue_floor_ms(dev, pairs, trip, per_lane)
        print(f"[kernel K2 knn_min] the scan's issue floor: {pairs} pairs x {trip} "
              f"instructions a trip / {per_lane} references a lane a trip (SASS of this build) "
              f"/ 32 lanes / ({sms} SMs x 4 a clock x {mhz:.0f} MHz) = {floor_ms:.4f} ms "
              f"({floor_ms / rec['graph_ms']:.1%} of the device time; the FP32 bound, 10 "
              f"operations a pair at 67 TFLOP/s, {rec['bound_ms']:.4f} ms)", flush=True)
    # the other path shapes' times beside the parent design; D 64 at k 40
    # (the classic DGCNN's last two graphs) takes the warp design itself;
    # the decoder stack's two graphs (k 8) also beside cdist + topk
    feats = randn(BATCH, 2048, 64)
    for n, m, dim, kk in ((512, 2048, 3, 16), (128, 128, 3, 16), (2048, 2048, 3, 40),
                          (2048, 2048, 64, 40), (224, 224, 3, 8), (224, 128, 3, 8)):
        qq, rr = (levels[n], levels[m]) if dim == 3 else (feats, feats)
        fn = lambda: knn_pallas.knn_min_fwd(qq, rr, kk)  # noqa: E731
        got, design = launched_designs(fn)
        err, ok = same_indices(1e-6)(got, knn_pallas.reference_knn_min(qq, rr, kk))
        ok = ok and all(torch.equal(a, b) for a, b in zip(got, fn()))
        b_ms = bound(2 * nbytes(qq) + 8 * BATCH * n * kk, pair_ops(n, m, dim))[0]
        row = {"name": f"K2 knn_min {n} vs {m} D {dim} k {kk}", "ms": cuda_ms(fn, 10),
               "bound_ms": b_ms, "design": "/".join(design)}
        print(f"[kernel {row['name']}] {row['design']} design: max_abs_err {err:.3e} (indices "
              f"equal, values 1e-6 x max, equal bits again) {'PASS' if ok else 'FAIL'}; bound "
              f"{b_ms:.4f} ms (operations)", flush=True)
        if not ok:
            raise AssertionError(f"kernel K2 disagrees at {n} vs {m}, D {dim}, k {kk}")
        if row["design"] == "warp":
            dev_ms = graph_ms(fn)
            print(f"[kernel {row['name']}] warp (parent) design: {row['ms']:.4f} ms a call, "
                  f"{stream_ms(fn, 10):.4f} back to back, {dev_ms:.4f} on the device; "
                  f"{b_ms / dev_ms:.1%} of the bound on the device", flush=True)
        else:
            versus_parent(row, fn, reps=10)
        if kk == 8:
            lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(qq, rr), kk, dim=-1,
                                                largest=False), 10)
            print(f"[kernel {row['name']}] library (cdist + topk, two calls): {lib_ms:.4f} ms; "
                  f"plain {cuda_ms(lambda: knn_pallas.reference_knn_min(qq, rr, kk), 5):.4f} "
                  f"ms", flush=True)
    del feats, tie, got, again, parent


def check_knn_fps_kernels(dev, record, randn, uniform):
    """Phase 3, DGCNN family: K1, K2, K3 and F against their plain versions
    at the shapes of the VN DGCNN and DGCNN paths (batch 8, k 16), the
    indices equal; the backward of K2 and K3 on the card against the plain
    chain's autograd."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import fps_pallas, knn_pallas
    from vn_pointcloudcompletion_tpu_torch.ops.rotations import rotate_points

    k = 16
    src_knn = "vn_pointcloudcompletion_tpu_torch/csrc/knn.cu"
    records = []

    def cloud(n):  # a partial scan's scale, 2048 -> 512 -> 128 FPS levels
        return uniform(-0.5, 0.5, BATCH, n, 3)

    # K1 over the (8, 2048, 2048) distance matrix of VN DGCNN conv1's input:
    # the rotated partial scans of the training batch, whose resampling
    # repeats points, so that equal distances occur; and over the (8, 2048,
    # 4096) matrix of those scans against the first 4096 points of the
    # complete scans; at k 16, 40 and 64.  Each row: indices and values
    # equal to the plain version's, to a second launch's and to the parent
    # (warp) design's, then timed beside the parent design (versus_parent);
    # torch.topk as library.  Bound: one read of the matrix, the outputs
    # written once (one compare an element, far below the FP32 rate)
    partial, complete, rot = main_path_batch(dev)
    q = rotate_points(partial, rot)
    mats = {2048: knn_pallas.pairwise_sqdist(q, q),
            4096: knn_pallas.pairwise_sqdist(q, rotate_points(complete[:, :4096], rot))}
    for m, kk in K1_SHAPES:
        d = mats[m]
        name = "K1 topk_min" + ("" if (m, kk) == K1_SHAPES[0] else f" 2048 x {m} k {kk}")
        fn = lambda: knn_pallas.topk_min_fwd(d, kk)  # noqa: E731
        with parent_designs():
            parent = fn()
        rec = record(name, src_knn, "vn_pointcloudcompletion_tpu/ops/knn_pallas.py:110", fn,
                     lambda: knn_pallas.reference_topk_min(d, kk),
                     same_indices(0.0), "indices equal, values exact",
                     nbytes(d) + 8 * BATCH * 2048 * kk, BATCH * 2048 * m,
                     reps=10, plain_reps=3, repro=True, versus=True,
                     library_fn=lambda: torch.topk(d, kk, dim=-1, largest=False))
        same = all(torch.equal(a, b) for a, b in zip(fn(), parent))
        print(f"[kernel {name}] the parent (warp) design's bits: {same}", flush=True)
        if not same or rec["design"] != "stream":
            raise AssertionError(f"kernel {name}: design {rec['design']}, the warp design's "
                                 f"bits {same}")
        versus_parent(rec, fn, reps=10)
    del mats, d, parent

    check_knn_kernel(dev, record, randn, uniform, q)

    # K3 at every shape of the paths: the VN DGCNN's conv5 (C3 768) and
    # conv4 (C3 384) over the coordinates (D 3, N 512: "coords"), vn_pointr's
    # conv4 (D 96), conv5 (D 192, N 512, C3 384) and conv6 (D 192, N 128, C3
    # 768) over its features ("tiled"); each against its plain version, twice
    # for equal bits, beside the warp (parent) design at the same shape, and
    # split into its selection (C3 0) and its gather by device time (CUDA
    # graph replay, no host time)
    for n, dim, c3 in EDGE_SHAPES:
        x = cloud(n).transpose(1, 2).contiguous() if dim == 3 else randn(BATCH, dim, n)
        u, v = randn(BATCH, c3, n), randn(BATCH, c3, n)
        edge_record(record, "K3 edge_knn_gather", src_knn, x, u, v, k)
    # the lane-tie cloud's coordinates (ties to the lowest index inside one
    # lane's list, and across the lanes of a query)
    xt = lane_tie_cloud(dev, BATCH, 512).transpose(1, 2).contiguous()
    ut, vt = randn(BATCH, 384, 512), randn(BATCH, 384, 512)
    got, again = (knn_pallas.edge_knn_gather_fwd(xt, ut, vt, k) for _ in range(2))
    err, ok = same_indices(0.0)(got, knn_pallas.reference_edge_knn_gather(xt, ut, vt, k))
    ok = ok and all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"[kernel K3] lane-tie cloud, N 512, C3 384 ({knn_pallas.edge_design(512, 3, k, False)}): "
          f"indices and values exact, equal bits again {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("kernel K3 disagrees on the lane-tie cloud")
    del got, again, xt, ut, vt
    x = cloud(512).transpose(1, 2).contiguous()
    u, v = randn(BATCH, 768, 512), randn(BATCH, 768, 512)

    # the backward of K3 (du scatter, dv sum) and K2 (dq, dr) through their
    # autograd.Functions against autograd of the plain chain
    def grads(fn, *inputs):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        out = out[0] if isinstance(out, tuple) else out
        cot = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(5),
                          device=dev)
        (out * cot).sum().backward()
        return [t.grad for t in leaves]

    # (K3: the same sums in the same order, 1e-6; K2: the Function forms
    # 2 g (q - r) where autograd of the distance forms 2 g q - 2 g r, which
    # cancels for near neighbours, 1e-4)
    checks = (
        ("K3 backward", lambda a, b: knn_pallas.edge_knn_gather(x, a, b, k),
         lambda a, b: knn_pallas.reference_edge_knn_gather(x, a, b, k)[0], (u, v), 1e-6),
        ("K2 backward", lambda a, b: knn_pallas.knn_min(a, b, k),
         lambda a, b: knn_pallas.reference_knn_min(a, b, k), (q, cloud(2048)), 1e-4),
    )
    for name, fn, plain, inputs, tol in checks:
        got, want = grads(fn, *inputs), grads(plain, *inputs)
        errs = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
        print(f"[kernel {name}] max|dg| / max|g| {max(errs):.3e} (tolerance {tol})")
        if max(errs) > tol:
            raise AssertionError(f"{name} disagrees with the plain chain")

    # F at the paths' three shapes: 2048 -> 512 and 512 -> 128 (the trunks'
    # fps_downsample, which hands F the transposed view of (B, 3, N)
    # coordinates) and 2048 -> 224 (num_coarse 448's tail, a (B, N, 3)
    # cloud), duplicate points in each; its dependency floor, the same launch
    # with the per-point arithmetic taken out (fps_pallas.
    # furthest_point_sample_chain), beside the operations bound; then a cloud
    # of one repeated point, whose picks wrap to index 0
    idx_eq = lambda got, want: (0.0, torch.equal(got, want))  # noqa: E731
    for n, s in FPS_SHAPES:
        xyz = cloud(n)
        xyz[:, n // 2:n // 2 + 64] = xyz[:, :64]
        if s != 224:
            xyz = xyz.transpose(1, 2).contiguous().transpose(1, 2)
        name = "F furthest_point_sample" + ("" if (n, s) == FPS_SHAPES[0] else f" {n} -> {s}")
        fn = lambda: fps_pallas.furthest_point_sample_kernel(xyz, s)  # noqa: E731
        rec = record(name, "vn_pointcloudcompletion_tpu_torch/csrc/fps.cu",
                     "vn_pointcloudcompletion_tpu/ops/fps_pallas.py:85", fn,
                     lambda: fps_pallas.reference_furthest_point_sample(xyz, s),
                     idx_eq, "indices equal", nbytes(xyz) + 4 * BATCH * s,
                     BATCH * (s - 1) * n * 10, reps=10, plain_reps=2, repro=True)
        chain = lambda: fps_pallas.furthest_point_sample_chain(xyz, s)  # noqa: E731
        rec["dependency_floor_ms"] = floor = graph_ms(chain)
        device = graph_ms(fn)
        print(f"[kernel F] {n} -> {s}: device {device:.4f} ms; dependency floor {floor:.4f} ms "
              f"= {s - 1} steps x {floor / (s - 1) * 1e3:.3f} us (the step's chain alone: a "
              f"block barrier, two warp reductions either side of it, the new sample's "
              f"load), {floor / device:.1%} of the kernel; operations bound "
              f"{rec['bound_ms']:.4f} ms", flush=True)
    one = cloud(1)[:, :1].expand(BATCH, 2048, 3).contiguous()
    got = fps_pallas.furthest_point_sample_kernel(one, 512)
    ok = torch.equal(got, fps_pallas.reference_furthest_point_sample(one, 512))
    ok = ok and not got.any().item()
    print(f"[kernel F] 2048 copies of one point -> 512: every pick index 0 "
          f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("kernel F: a cloud of one repeated point must pick index 0")
    return records


def knn_wide_path(dev):
    """Phase 3b, K1's path: ``knn()`` at (8, 2048 vs 2048, D 768, k 16),
    the feature graph of a plane-layout VN EdgeConv whose 3C passes K2's
    512 (C 256; the JAX package then forms the matrix and takes K1).  The
    counts are set to 0 just before one call and read just after: K1 once,
    in its stream design, and nothing else.  The indices and values equal
    the plain selection's over the same matrix (``pairwise_sqdist_einsum``:
    one batched product in full float32, whatever the caller's TF32
    switch: the matrix formed with TF32 allowed is the same to the bit, and
    lies within a quarter of a TF32 product's distance from float64); then
    the call's time, its synchronisation inside, and the product's and
    K1's device times.  Returns the counts, by design too."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib, knn_pallas
    from vn_pointcloudcompletion_tpu_torch.ops.knn import knn, pairwise_sqdist_einsum

    feats = torch.randn(BATCH, 2048, 768, generator=torch.Generator(device=dev).manual_seed(7),
                        device=dev)
    cuda_lib.reset_launch_counts()
    vals, idx = knn(feats, feats, 16)
    torch.cuda.synchronize()
    counts = {**cuda_lib.launch_counts(), **cuda_lib.variant_counts()}
    launched = {k: v for k, v in counts.items() if v}
    d = pairwise_sqdist_einsum(feats, feats)
    want = knn_pallas.reference_topk_min(d, 16)
    equal = torch.equal(idx, want[1]) and torch.equal(vals, want[0])
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        same_tf32 = torch.equal(pairwise_sqdist_einsum(feats, feats), d)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    # the distance from float64 of the matrix and of the same product with
    # its inputs rounded to TF32's 10-bit mantissa (what a TF32 product reads)
    tf32 = (feats.view(torch.int32) + 0x1000 & -0x2000).view(torch.float32).double()
    d64 = pairwise_sqdist_einsum(feats.double(), feats.double())
    scale = d64.abs().max()
    err = ((d - d64).abs().max() / scale).item()
    sq = (feats.double() ** 2).sum(-1)
    err_tf32 = (((sq[:, :, None] + sq[:, None, :] - 2 * tf32 @ tf32.transpose(1, 2)) - d64)
                .abs().max() / scale).item()
    del d64, tf32, sq
    ok = (launched == {"topk_min": 1, "topk_min/stream": 1} and equal and same_tf32
          and err <= err_tf32 / 4)
    call_ms = cuda_ms(lambda: (knn(feats, feats, 16), torch.cuda.synchronize()), 10)
    product_ms = graph_ms(lambda: pairwise_sqdist_einsum(feats, feats))
    tflops = 2 * BATCH * 2048 * 2048 * 768 / product_ms / 1e9
    select_ms = graph_ms(lambda: knn_pallas.topk_min_fwd(d, 16))
    print(f"[knn D 768] launches {json.dumps(launched)}; indices and values equal to the plain "
          f"selection over the same matrix {equal}; the matrix with TF32 allowed the same "
          f"{same_tf32}; from float64 {err:.3e} of its max (a TF32 product's {err_tf32:.3e}, "
          f"at most a quarter of it); {'PASS' if ok else 'FAIL'}", flush=True)
    print(f"[knn D 768] (8, 2048 vs 2048, D 768, k 16): {call_ms:.4f} ms a call (synchronised); "
          f"on the device the product {product_ms:.4f} ms ({tflops:.1f} TFLOP/s), K1 "
          f"{select_ms:.4f} ms", flush=True)
    if not ok:
        raise AssertionError("knn() at D 768 did not go through K1's stream design on the "
                             "einsum-form matrix")
    return counts


def emd_clouds(dev, n: int, m: int, kind: str):
    """(x1 (8, n, 3), x2 (8, m, 3)): ``"scan"``, each sample's synthetic
    complete scan (its first n points) against another sample's (the first
    m), as ``test --emd`` compares a completion with a ground truth; or
    ``"gauss"``, Gaussian clouds x 0.3 as JAX's EMD tests take them."""
    import numpy as np
    import torch

    from vn_pointcloudcompletion_tpu_torch.data.synthetic import SyntheticCompletionDataset

    if kind == "gauss":
        g = torch.Generator(device=dev).manual_seed(n + m)
        return [torch.randn(BATCH, k, 3, generator=g, device=dev) * 0.3 for k in (n, m)]
    ds = SyntheticCompletionDataset(BATCH + 1, seed=5)
    scans = np.stack([ds[i][1] for i in range(BATCH + 1)])
    return (torch.from_numpy(scans[:BATCH, :n]).to(dev),
            torch.from_numpy(scans[1:, :m]).to(dev))


def emd_close(got, want):
    """Kernel E's five outputs against the plain version's: (largest
    max|d| / max, ok)."""
    worst_rel, ok = 0.0, True
    for k, (g, w) in enumerate(zip(got, want)):
        rel = ((g - w).abs().max() / w.abs().max()).item()
        worst_rel = max(worst_rel, rel)
        ok = ok and rel <= (EMD_COST_TOL if k == 0 else EMD_MOMENT_TOL)
    return worst_rel, ok


def check_emd_kernel(dev, record):
    """Phase 3, kernel E: at (8, 16384) vs (8, 16384), the ``test --emd``
    shape of the 1024-coarse pipelines, on synthetic scans (recorded and
    timed, twice for equal bits) and Gaussian clouds; at 14336 (``num_coarse``
    448; timed) and at 4096 vs 16384; against float64 at (2, 4096); the
    trainable form's gradient from E's moments against the plain one's."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import emd_pallas
    from vn_pointcloudcompletion_tpu_torch.ops.emd import earth_mover_distance_blocked

    n = 16384
    x1, x2 = emd_clouds(dev, n, n, "scan")
    pairs = BATCH * n * n
    record("E emd_rounds", "vn_pointcloudcompletion_tpu_torch/csrc/emd.cu",
           "vn_pointcloudcompletion_tpu/ops/emd_pallas.py:304",
           lambda: emd_pallas.emd_rounds_kernel(x1, x2),
           lambda: emd_pallas.reference_emd_rounds(x1, x2),
           emd_close, f"cost {EMD_COST_TOL}, moments {EMD_MOMENT_TOL} x max",
           nbytes(x1, x2) + 4 * BATCH * (1 + 4 * n + 4 * n), EMD_OPS_PER_PAIR * pairs,
           reps=5, plain_reps=1, repro=True)
    for (nn, mm, kind) in ((n, n, "gauss"), (14336, 14336, "scan"), (4096, n, "gauss")):
        a, b = emd_clouds(dev, nn, mm, kind)
        got, again = emd_pallas.emd_rounds_kernel(a, b), emd_pallas.emd_rounds_kernel(a, b)
        err, ok = emd_close(got, emd_pallas.reference_emd_rounds(a, b))
        same = all(torch.equal(u, v) for u, v in zip(got, again))
        timing = ""
        if nn == 14336:
            ms = cuda_ms(lambda: emd_pallas.emd_rounds_kernel(a, b), 5)
            b_ms, _ = bound(0, EMD_OPS_PER_PAIR * BATCH * nn * mm)
            timing = f"; kernel {ms:.4f} ms, bound {b_ms:.4f} ms (operations)"
        print(f"[kernel E] {nn} vs {mm} ({kind}): max|d| / max {err:.3e} (cost {EMD_COST_TOL}, "
              f"moments {EMD_MOMENT_TOL}); equal bits again: {same}{timing} "
              f"{'PASS' if ok and same else 'FAIL'}", flush=True)
        if not (ok and same):
            raise AssertionError(f"kernel E disagrees at {nn} vs {mm} ({kind})")

    # float64: each output no further than the float32 plain version
    a, b = emd_clouds(dev, 4096, 4096, "scan")
    a, b = a[:2].contiguous(), b[:2].contiguous()
    ref = emd_pallas.reference_emd_rounds(a.double(), b.double())
    got, plain = emd_pallas.emd_rounds_kernel(a, b), emd_pallas.reference_emd_rounds(a, b)
    ratios = []
    for k, (g, p, r) in enumerate(zip(got, plain, ref)):
        floor = (3e-3 if k in (2, 4) else 2e-4) * r.abs().max().item()
        dk, dp = (g.double() - r).abs().max().item(), (p.double() - r).abs().max().item()
        ratios.append((dk, dp, dk <= EMD_F64_RATIO * dp + floor))
    print("[kernel E] (2, 4096) against float64, max|d| kernel / plain: " + ", ".join(
        f"{name} {dk:.3e} / {dp:.3e}" for name, (dk, dp, _) in zip(
            ("cost", "s_n", "t_n", "s_m", "t_m"), ratios))
        + f" (kernel within {EMD_F64_RATIO} x plain + floor)", flush=True)
    if not all(ok for _, _, ok in ratios):
        raise AssertionError("kernel E is further from float64 than its plain version allows")

    # the gradient through the trainable form, E's moments against the plain ones
    grads = []
    for use_kernels in (True, False):
        p, q = x1.clone().requires_grad_(), x2.clone().requires_grad_()
        earth_mover_distance_blocked(p, q, use_kernels).sum().backward()
        grads.append((p.grad, q.grad))
    errs = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(*grads)]
    print(f"[kernel E] gradient at (8, 16384) from the moments, kernel vs plain: max|dg| / "
          f"max|g| {max(errs):.3e} (tolerance {EMD_GRAD_TOL})", flush=True)
    if max(errs) > EMD_GRAD_TOL:
        raise AssertionError("kernel E's gradient disagrees with the plain version's")


def synthetic_batch(dev, b: int):
    """``b`` synthetic samples at full width (seed 3): (partial, complete)."""
    import numpy as np
    import torch

    from vn_pointcloudcompletion_tpu_torch.data.synthetic import SyntheticCompletionDataset

    ds = SyntheticCompletionDataset(b, seed=3)
    return tuple(torch.from_numpy(np.stack([ds[i][k] for i in range(b)])).to(dev)
                 for k in (0, 1))


def main_path_batch(dev):
    """The batch of the train-step phases 5b and 7b (synthetic, seed 3) and
    the rotation of their step (seed 1): (partial, complete, rot)."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops.rotations import random_rotations

    partial, complete = synthetic_batch(dev, BATCH)
    return partial, complete, random_rotations(torch.Generator().manual_seed(1), BATCH).to(dev)


def _smoke_config(path: str = "flagship", **extra):
    """A pipeline of ``PATHS`` at full width, batch 8, synthetic data."""
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    return Config.from_dict({
        "name": "smoke", **PATHS[path], "latent_dim": 2048, "only_coarse": False,
        "batch_size": BATCH, "dataset": "synthetic", "num_workers": 4, "seed": 0,
        "synthetic_n_partial": 2048, "synthetic_n_complete": 16384, **extra,
    })


def check_launches(path: str, counts: dict, forwards: int, what: str) -> None:
    """The launches of ``forwards`` eval forwards of a DGCNN path, exactly,
    every other kernel but D (the metrics' chamfer) at 0."""
    want = {k: v * forwards for k, v in FORWARD_LAUNCHES[path].items()}
    got = {k: v for k, v in counts.items() if v and k != "chamfer_nn_bidir"}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def _make_experiment(work: str, path: str):
    """A fresh experiment ``smoke`` under ``work/experiments`` (the
    ``OUTPUT_DIR`` of the CLI calls after it) holding a ``PATHS[path]``
    model drawn from seed 0, saved as its best: (config, model)."""
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.training.checkpoint import save_model
    from vn_pointcloudcompletion_tpu_torch.utils.config import store_config

    shutil.rmtree(work, ignore_errors=True)
    exp_dir = os.path.join(work, "experiments", "smoke")
    os.makedirs(os.path.join(exp_dir, "models"))
    config = _smoke_config(path, test_rotation="so3", synthetic_test_samples=2 * BATCH)
    config.exp_dir = exp_dir
    store_config(config)
    model = build_model(config)
    save_model(exp_dir, model, "best")
    os.environ["OUTPUT_DIR"] = os.path.join(work, "experiments")
    return config, model


def serve_path(dev, path: str = "flagship"):
    """Phase 4: predict + test at full width through the CLI, counted; then
    the whole forward through the kernels against the plain path."""
    import numpy as np
    import torch

    from vn_pointcloudcompletion_tpu_torch import __main__ as cli
    from vn_pointcloudcompletion_tpu_torch.data.ply import read_ply_points, write_ply_points
    from vn_pointcloudcompletion_tpu_torch.data.synthetic import SyntheticCompletionDataset
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib

    tag = f"[serve {path}]"
    work = os.path.join(ROOT, "build", "chip_smoke")
    config, model = _make_experiment(work, path)

    in_dir = os.path.join(work, "partials")
    os.makedirs(in_dir)
    scans = SyntheticCompletionDataset(8, seed=11, n_partial=3000)
    for i in range(8):
        write_ply_points(os.path.join(in_dir, f"scan{i}.ply"), scans[i][0])
    out_dir = os.path.join(work, "completions")

    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    written = cli.main(["-n", "smoke", "--resume", "predict", "-i", in_dir,
                        "-o", out_dir, "--save"])
    t1 = time.perf_counter()
    table = cli.main(["-n", "smoke", "--resume", "test"])
    t2 = time.perf_counter()
    counts = cuda_lib.launch_counts()
    print(f"{tag} predict 8 clouds: {t1 - t0:.3f} s; test 2 batches of "
          f"{BATCH}: {t2 - t1:.3f} s (host clock, first call, build included "
          "if any)")
    print(f"{tag} launches: {json.dumps(counts)}")
    check_designs(f"{tag} predict + test", counts, cuda_lib.variant_counts(), path)
    if path == "flagship":
        missing = [k for k in FORWARD_KERNELS if counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the serving path: {missing}")
    else:  # predict: one batch of 8; test: two
        check_launches(path, counts, 3, f"{tag} predict + test")
        if counts["chamfer_nn_bidir"] == 0:
            raise AssertionError(f"{tag} the metrics' kernel D was not launched")

    n_coarse = config.num_coarse
    n_dense = 14336 if config.num_coarse == 448 else 16 * config.num_coarse
    if len(written) != 8:
        raise AssertionError(f"predict wrote {len(written)} files, not 8")
    for out in written:
        pts = read_ply_points(out)
        coarse = read_ply_points(out.replace("_completion", "_coarse"))
        if pts.shape != (n_dense, 3) or coarse.shape != (n_coarse, 3):
            raise AssertionError(f"{out}: shapes {pts.shape} {coarse.shape}")
        if not (np.isfinite(pts).all() and np.isfinite(coarse).all()):
            raise AssertionError(f"{out}: non-finite points")
    row = table["synthetic"]
    if not all(np.isfinite(v) for v in row.values()) or not 0 < row["iou"] <= 1:
        raise AssertionError(f"bad metric row {row}")

    # the whole forward through the kernels against the port's plain path
    model = model.to(dev).eval()
    ds = SyntheticCompletionDataset(BATCH, seed=3)
    xyz = torch.from_numpy(np.stack([ds[i][0] for i in range(BATCH)])).to(dev)
    from vn_pointcloudcompletion_tpu_torch.ops.rotations import random_rotations

    rot = random_rotations(torch.Generator().manual_seed(1), BATCH).to(dev)
    xyz = xyz @ rot
    # vn_pointr: the plain run takes the kernels' run's discrete decisions
    # (see the tolerances below); the other paths' runs decide by themselves.
    # With the decoder stack, the refined queries are compared too (a hook)
    taped = path.startswith("vn_pointr_448")
    queries = []
    hook = model.encoder.register_forward_hook(
        lambda m, i, out: queries.append(out[1][1]) if path == "vn_pointr_448_dec" else None)
    with torch.no_grad(), DecisionTape() if taped else contextlib.nullcontext() as tape:
        cuda_lib.reset_launch_counts()
        coarse_k, fine_k = model(xyz, rot)
        torch.cuda.synchronize()
        if path != "flagship":
            check_launches(path, cuda_lib.launch_counts(), 1, f"{tag} one forward")
        check_designs(f"{tag} one forward", cuda_lib.launch_counts(),
                      cuda_lib.variant_counts(), path)
        model.use_kernels_(False)
        if taped:
            tape.run(tape.rec)
        coarse_p, fine_p = model(xyz, rot)
        model.use_kernels_(True)
    hook.remove()
    torch.cuda.synchronize()
    if queries:
        q_k, q_p = queries
        err_q = ((q_k - q_p).abs().max() / q_p.abs().max()).item()
        print(f"{tag} refined queries {tuple(q_k.shape)} kernels vs plain: max|d| / max "
              f"{err_q:.3e} (tolerance {POINTR_FWD_TOL})")
        if err_q > POINTR_FWD_TOL or q_k.shape != (BATCH, 224, 384):
            raise AssertionError(f"{tag} refined queries: kernels disagree with the plain path")
    err_c = (coarse_k - coarse_p).abs().max().item()
    err_f = (fine_k - fine_p).abs().max().item()
    # Tolerances.  The flagship encoder's only kernel, A, is bit-exact, and
    # so are K2 and F: the DGCNN encoder's coarse output is equal too.  The
    # VN DGCNN encoder runs conv1 through kernel B, whose products round
    # otherwise than cuBLAS (within 1e-5 in phase 3), and B and C of the decoder
    # as well: 1e-4 of the output's max for both clouds there.  vn_pointr
    # carries conv1's rounding through eight VNLayerNorms, which rescale
    # every vector to O(1) (a small one's rounding with it), so a near tie
    # of its global pool or a feature-space kNN could pick otherwise: the
    # plain run replays the kernels' picks, and POINTR_FWD_TOL holds the rest.
    rel = {"flagship": 1e-4, "vn_dgcnn": 1e-4, "dgcnn_448": 0.0,
           "vn_pointr_448": POINTR_FWD_TOL, "vn_pointr_448_dec": POINTR_FWD_TOL}[path]
    tol_c = (0.0 if path == "flagship" else rel) * coarse_p.abs().max().item()
    tol_f = rel * fine_p.abs().max().item()
    print(f"{tag} forward kernels vs plain: coarse max_abs_err {err_c:.3e} (tolerance "
          f"{tol_c:.3e}), fine max_abs_err {err_f:.3e} (tolerance {tol_f:.3e})")
    if err_c > tol_c or err_f > tol_f or fine_k.shape != (BATCH, n_dense, 3):
        raise AssertionError("full forward: kernels disagree with the plain path")
    shutil.rmtree(work, ignore_errors=True)


def train_path(dev, path: str = "flagship", epochs: int = 0, keep_best: str = "",
               and_test: bool = False, **extra):
    """Phase 5: overfit + train --resume at full width through the CLI,
    counted; ``epochs`` and ``extra`` config fields (phase 10b: the coarse
    loss) override the path's; ``keep_best``: where to copy the run's
    ``model_best.pth`` (phase 14c reads it); ``and_test``: then ``--resume
    test`` on the run (phase 15b), its metric row finite."""
    import math

    import torch

    from vn_pointcloudcompletion_tpu_torch import __main__ as cli
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib

    tag = f"[train {path}{''.join(f' {k}={v}' for k, v in extra.items())}]"
    epochs = epochs or (TRAIN_EPOCHS if path == "flagship" else DGCNN_EPOCHS[path])
    work = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # The train-mode loss of one repeated batch jumps by +-30% from step to
    # step at any lr (the argmax pools switch points as the weights move);
    # at 3x the reference's lr its fall outruns that within 16 steps, and
    # the check is that the last epoch ends below the untrained first one
    # (the VN DGCNN's too, over 4 epochs; the DGCNN at 448 runs 2 epochs and
    # is checked for finite losses, its step against the plain path in 8b).
    config = _smoke_config(path, name="smoke_train", lr=3e-4, rotation="so3",
                           val_rotation="so3", log_frequency=1, **extra)
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump(config.to_dict(), f)
    os.environ["OUTPUT_DIR"] = os.path.join(work, "experiments")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        summary = cli.main(["-n", "smoke_train", "-epochs", str(epochs - 1), "overfit"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = cuda_lib.launch_counts()
        variants = cuda_lib.variant_counts()
        (run,) = os.listdir(os.environ["OUTPUT_DIR"])
        exp_dir = os.path.join(os.environ["OUTPUT_DIR"], run)
        resumed = cli.main(["-n", run, "--resume", "-epochs", str(epochs), "train"])
        t2 = time.perf_counter()
        tested = cli.main(["-n", run, "--resume", "test"]) if and_test else None
    finally:
        os.chdir(cwd)
    print(f"{tag} overfit {epochs} epochs of one step + one validation "
          f"batch: {t1 - t0:.3f} s; resume 1 epoch: {t2 - t1:.3f} s (host clock, "
          "checkpoint writes included)")
    print(f"{tag} launches: {json.dumps(counts)}")
    check_designs(f"{tag} overfit", counts, variants, path)
    if path in STATS_STEP_DESIGNS:  # one train step an epoch
        check_stats_designs(f"{tag} overfit", variants, STATS_STEP_DESIGNS[path], epochs)
    if path == "flagship" and not extra:  # phase 5, with the figures (17c)
        want = {k: v * epochs for k, v in FLAGSHIP_EPOCH_LAUNCHES.items()}
        if {k: v for k, v in counts.items() if v} != want:
            raise AssertionError(f"{tag} launches {counts}, expected {want}")
        check_epoch_figures(tag, exp_dir, epochs + 1)
    if path == "flagship":
        expected = FLAGSHIP_KERNELS
    else:
        expected = ["chamfer_nn_bidir", *FORWARD_LAUNCHES[path]]
        if "vn_bn_leaky_fwd" in expected:  # and the backward kernels of the VN layers
            expected += [SYMBOL[k] for k in ("A'", "S", "S'", "B'", "C'")]
        if "vn_layer_fused_fwd[group]" in expected:  # the pair folds' train-mode kernels
            expected += [f"{SYMBOL[k]}[group]" for k in ("S", "S'", "B'")]
    missing = [k for k in expected if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the training path: {missing}")
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train = [r["value"] for r in rows if r["split"] == "train" and r["tag"] == "Loss/Epoch/Total"]
    val = [r["value"] for r in rows if r["split"] == "val" and r["tag"] == "Loss/Epoch/Total"]
    print(f"{tag} train total loss per epoch (x1e3): {train}; validation: {val}")
    if not all(math.isfinite(v) for r in rows for v in [r["value"]]):
        raise AssertionError("non-finite logged loss")
    if len(train) != epochs + 1:
        raise AssertionError(f"epochs logged: {train}")
    # (the DGCNN at 448 and phase 15b's short run: finite losses only)
    if (path not in ("dgcnn_448", "vn_pointr_448_dec") and not extra
            and not train[epochs - 1] < train[0]):
        raise AssertionError(f"training loss did not fall: {train}")
    if tested is not None:
        row = tested["synthetic"]
        print(f"{tag} --resume test: {json.dumps(row)}")
        if not all(math.isfinite(v) for v in row.values()) or not 0 < row["iou"] <= 1:
            raise AssertionError(f"{tag} bad metric row {row}")
    if summary["epochs_run"] != epochs or resumed["epochs_run"] != 1:
        raise AssertionError(f"epochs run: {summary} then {resumed}")
    for sub, stem in (("models", "model"), ("optimizer", "optim")):
        for name in ("best", "last"):
            if not os.path.exists(os.path.join(exp_dir, sub, f"{stem}_{name}.pth")):
                raise AssertionError(f"missing {sub}/{stem}_{name}.pth")
    with open(os.path.join(exp_dir, "train.log")) as f:
        if "[RESUME INFO] resume ckpts @ %d epoch" % (epochs - 1) not in f.read():
            raise AssertionError("train --resume did not continue the run")
    if keep_best:
        shutil.copy(os.path.join(exp_dir, "models", "model_best.pth"), keep_best)
    shutil.rmtree(work, ignore_errors=True)
    return {**counts, **variants}  # launches, and by design (``<name>/<design>``)


def check_epoch_figures(tag: str, exp_dir: str, epochs: int) -> None:
    """Phase 17c: the figure of each of ``epochs`` epochs written where
    matplotlib imports, else the trainer's warning once in each run's log."""
    try:
        import matplotlib  # noqa: F401
    except ModuleNotFoundError:
        logs = {}
        for name in ("overfit.log", "train.log"):
            with open(os.path.join(exp_dir, name)) as f:
                logs[name] = f.read().count(FIGURE_WARNING)
        print(f"[17c] {tag} matplotlib is not installed: the trainer's warning "
              f"{FIGURE_WARNING!r} in the logs {logs} (once a run), no PNG")
        if list(logs.values()) != [1, 1]:
            raise AssertionError(f"[17c] {tag} figure warnings {logs}")
        return
    pngs = sorted(os.listdir(os.path.join(exp_dir, "visualizations")))
    print(f"[17c] {tag} figures: {pngs}")
    if pngs != [f"epoch_{e:03d}.png" for e in range(epochs)]:
        raise AssertionError(f"[17c] {tag} figures {pngs}")


def render_on_card(dev, smi: str):
    """Phase 17a: ``generate_partials`` at 16384 points x 8 views on the
    card against the CPU version, point for point and in order, both
    timed; then ``render_root`` over a synthetic 32-model root on the card
    and on the CPU, every file equal in bytes, models/s of both."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.data import render
    from vn_pointcloudcompletion_tpu_torch.data.ply import write_ply_points
    from vn_pointcloudcompletion_tpu_torch.data.synthetic import SyntheticCompletionDataset

    tag = "[17a render]"
    ds = SyntheticCompletionDataset(RENDER_MODELS, seed=5)
    cloud = ds[0][1]
    card = render.generate_partials(cloud, n_views=8, seed=3, device=dev)
    host = render.generate_partials(cloud, n_views=8, seed=3, device="cpu")
    sizes = [len(p) for p in host]
    equal = len(card) == len(host) and all(torch.equal(c.cpu(), h) for c, h in zip(card, host))
    card_ms = cuda_ms(lambda: render.generate_partials(cloud, n_views=8, seed=3, device=dev), 20)
    host_ms = []
    for _ in range(5):
        t = time.perf_counter()
        render.generate_partials(cloud, n_views=8, seed=3, device="cpu")
        host_ms.append((time.perf_counter() - t) * 1e3)
    print(f"{tag} {smi}: generate_partials, {cloud.shape[0]} points x 8 views, image 160: "
          f"card {card_ms:.3f} ms (median of 20, CUDA events, after 2 warm-up), CPU version "
          f"{statistics.median(host_ms):.3f} ms (median of 5, host clock, {torch.get_num_threads()} "
          f"threads); partial sizes {sizes}; card == CPU point for point and in order: {equal}",
          flush=True)
    if not equal or not all(100 < n < cloud.shape[0] for n in sizes):
        raise AssertionError(f"{tag} the card's partials differ from the CPU version's")

    work = os.path.join(ROOT, "build", "chip_smoke_render")
    shutil.rmtree(work, ignore_errors=True)
    roots = {d: os.path.join(work, d) for d in ("card", "cpu")}
    for i in range(RENDER_MODELS):
        cat = ("02691156", "03001627")[i % 2]
        for root in roots.values():
            os.makedirs(os.path.join(root, "train", "complete", cat), exist_ok=True)
            write_ply_points(os.path.join(root, "train", "complete", cat, f"m{i:03d}.ply"),
                             ds[i][1])
    rates = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        t = time.perf_counter()
        n = render.render_root(roots[name], "train", 8, 0, device)
        rates[name] = n / (time.perf_counter() - t)
    files = []
    for cat in sorted(os.listdir(os.path.join(roots["cpu"], "train", "partial"))):
        folder = os.path.join("train", "partial", cat)
        files += [os.path.join(folder, f) for f in sorted(os.listdir(os.path.join(roots["cpu"],
                                                                                   folder)))]
    differ = []
    for f in files:
        with open(os.path.join(roots["card"], f), "rb") as a, \
                open(os.path.join(roots["cpu"], f), "rb") as b:
            if a.read() != b.read():
                differ.append(f)
    print(f"{tag} {smi}: render entry over {RENDER_MODELS} synthetic models ({cloud.shape[0]} "
          f"points, 8 views each; PLY reads and writes included, host clock): card "
          f"{rates['card']:.2f} models/s, CPU {rates['cpu']:.2f} models/s; {len(files)} files, "
          f"{len(differ)} differ from the CPU run's", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    if len(files) != 8 * RENDER_MODELS or differ:
        raise AssertionError(f"{tag} {len(files)} files, differing {differ[:3]}")


def obj_on_card(dev):
    """Phase 17b: ``voxel2obj`` of the flagship's dense prediction (seed 0
    weights, a synthetic partial) at 64^3 on the card, byte-identical to
    the CPU path's file."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.metrics.metrics import points_to_voxels
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.utils.obj_io import voxel2obj

    tag = "[17b obj]"
    torch.manual_seed(0)
    model = build_model(_smoke_config()).to(dev).eval()
    partial, _ = synthetic_batch(dev, 1)
    with torch.no_grad():
        _, fine = model(partial, None)
    work = os.path.join(ROOT, "build", "chip_smoke_obj")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    paths = {d: os.path.join(work, f"{d}.obj") for d in ("card", "cpu")}
    grid = points_to_voxels(fine[0])
    t = time.perf_counter()
    voxel2obj(paths["card"], grid)
    card_s = time.perf_counter() - t
    voxel2obj(paths["cpu"], points_to_voxels(fine[0].cpu()))
    with open(paths["card"], "rb") as a, open(paths["cpu"], "rb") as b:
        data = a.read()
        same = data == b.read()
    shutil.rmtree(work, ignore_errors=True)
    faces = data.count(b"\nf ")
    print(f"{tag} dense prediction {tuple(fine.shape[1:])} -> {int(grid.sum())} of 64^3 voxels "
          f"-> {len(data)} bytes of OBJ ({faces} faces) in {card_s:.3f} s (host clock, the "
          f"file write included); card file == CPU file: {same}", flush=True)
    if not same or int(grid.sum()) == 0:
        raise AssertionError(f"{tag} the card's OBJ differs from the CPU path's")


def bf16_convergence(dev, smi: str):
    """Phase 17d: OVERFIT_STEPS guarded train steps of the flagship on one
    synthetic batch of 8 (``overfit``'s data: one batch again and again;
    the step of ``training/steps.py``, lr 3e-4, so3, StepLR by epochs of
    one step as ``overfit`` runs it) in float32 and under the bf16 policy,
    from the same seed-0 weights; both curves every 20 steps.  Fails on a
    non-finite loss, or where the final loss (the mean of the last 10
    steps: one step's loss moves by +-30%) is not below half the first."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.nn.precision import compute_dtype_scope
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state
    from vn_pointcloudcompletion_tpu_torch.training.steps import train_step

    tag = "[17d bf16 convergence]"
    config = _smoke_config(lr=3e-4, rotation="so3")
    partial, complete = synthetic_batch(dev, BATCH)
    curves, finals = {}, {}
    for name, dtype in (("float32", torch.float32), ("bf16", torch.bfloat16)):
        torch.manual_seed(0)
        state = create_train_state(build_model(config).to(dev), config, 1)
        gen = torch.Generator().manual_seed(1)
        losses, skipped = [], 0
        t = time.perf_counter()
        with compute_dtype_scope(dtype):
            for _ in range(OVERFIT_STEPS):
                m = train_step(state, partial, complete, gen)
                losses.append(m["total"])
                skipped += int(m["skipped"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        curves[name] = [float(v) for v in losses]
        finals[name] = statistics.mean(curves[name][-10:])
        shown = [f"{i}: {curves[name][i] * 1e3:.3f}" for i in range(0, OVERFIT_STEPS, 20)]
        print(f"{tag} {smi}: {name} total loss x1e3 by step {', '.join(shown)}, "
              f"{OVERFIT_STEPS - 1}: {curves[name][-1] * 1e3:.3f}; first {curves[name][0] * 1e3:.3f}, "
              f"final (mean of the last 10) {finals[name] * 1e3:.3f}; {skipped} steps skipped; "
              f"{wall:.1f} s wall", flush=True)
        if not all(math.isfinite(v) for v in curves[name]) or not finals[name] < curves[name][0] / 2:
            raise AssertionError(f"{tag} {name} did not converge: first {curves[name][0]}, "
                                 f"final {finals[name]}")
    print(f"{tag} final loss bf16 / float32: {finals['bf16'] / finals['float32']:.4f}", flush=True)


def emd_test_path(dev, path: str):
    """Phase 10: ``--emd test`` through the CLI on 2 batches of the
    synthetic test set, counted (kernel E once per batch); then one batch's
    EMD column through kernel E against the plain version, within
    EMD_COST_TOL relative.  Returns the run's launch counts."""
    import math

    import torch

    from vn_pointcloudcompletion_tpu_torch import __main__ as cli
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.ops.emd import earth_mover_distance_blocked
    from vn_pointcloudcompletion_tpu_torch.ops.rotations import rotate_points
    from vn_pointcloudcompletion_tpu_torch.training.evaluate import metric_step

    tag = f"[emd test {path}]"
    work = os.path.join(ROOT, "build", "chip_smoke_emd")
    _, model = _make_experiment(work, path)
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    table = cli.main(["-n", "smoke", "--resume", "--emd", "test"])
    torch.cuda.synchronize()
    counts = cuda_lib.launch_counts()
    row = table["synthetic"]
    print(f"{tag} test --emd, 2 batches of {BATCH}: {time.perf_counter() - t0:.3f} s (host "
          f"clock, first call); EMD(1e-3) {row['emd'] * 1e3:.4f}; kernel E launches "
          f"{counts['emd_rounds']}")
    if counts["emd_rounds"] != 2:
        raise AssertionError(f"{tag} kernel E launched {counts['emd_rounds']} times, not 2")
    if not (math.isfinite(row["emd"]) and row["emd"] > 0):
        raise AssertionError(f"{tag} bad EMD column {row}")

    partial, complete, rot = main_path_batch(dev)
    model = model.to(dev).eval()
    out_k, pred = metric_step(model, partial, complete, rot, with_emd=True)
    n = pred.shape[1]
    with torch.no_grad():
        plain = earth_mover_distance_blocked(pred, rotate_points(complete, rot)[:, :n], False) / n
    err = ((out_k["emd"] - plain).abs() / plain.abs()).max().item()
    print(f"{tag} one batch, {n} vs {n} points: EMD through kernel E vs plain, max rel err "
          f"{err:.3e} (tolerance {EMD_COST_TOL})")
    if err > EMD_COST_TOL:
        raise AssertionError(f"{tag} the EMD column disagrees with the plain path")
    shutil.rmtree(work, ignore_errors=True)
    return counts


def coarse_loss_train(dev):
    """Phase 10b: ``overfit`` then ``--resume`` on the flagship with the
    ``emd`` and the ``dcd`` coarse losses (the dense approx_match at 1024 vs
    1024 points: no launch of kernel E, as in JAX)."""
    for loss in ("emd", "dcd"):
        counts = train_path(dev, "flagship", 2, coarse_loss=loss)
        if counts["emd_rounds"] != 0:
            raise AssertionError(f"coarse_loss {loss}: kernel E launched {counts['emd_rounds']}")


def set_kernels(model, enabled: bool):
    """``use_kernels`` of every module of a standalone model."""
    for m in model.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = enabled
    return model


def standalone_models(dev):
    """Phase 11: ``PCN`` (16384 dense, latent 1024, grid 4), ``VNPCN`` (latent
    1024) and the classic ``DGCNN`` (num_coarse 448, k 40), weights from seed
    0, eval mode, batch 8, 2048 input points (the rotated synthetic
    partials): each forward through the kernels against the plain path, the
    launches of one forward asserted; K2 at k 40 on the partials, which
    repeat points, against its plain version (indices equal)."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.models.composer import init_weights_
    from vn_pointcloudcompletion_tpu_torch.models.dgcnn import DGCNN
    from vn_pointcloudcompletion_tpu_torch.models.pcn import PCN, VNPCN
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib, knn_pallas
    from vn_pointcloudcompletion_tpu_torch.ops.rotations import rotate_points

    partial, _, rot = main_path_batch(dev)
    xyz = rotate_points(partial, rot)
    err, ok = same_indices(0.0)(knn_pallas.knn_min_fwd(xyz, xyz, 40),
                                knn_pallas.reference_knn_min(xyz, xyz, 40))
    print(f"[standalone] K2 at k 40 on the partials: max_abs_err {err:.3e} (indices and values "
          f"equal) {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("kernel K2 disagrees at k 40")
    # launches of one forward: VNPCN's encoder kernel A at first_conv.0 and
    # second_conv.0; DGCNN's four graphs through K2, the first two over the
    # coordinates (D 3: coords), the last two over 64 features (warp); PCN
    # none
    cases = (("PCN", PCN(16384, 1024, 4), {}, {}),
             ("VNPCN", VNPCN(latent_dim=1024), {"vn_bn_leaky_fwd": 2}, {}),
             ("DGCNN", DGCNN(448, 40), {"knn_min": 4}, {"knn_min/coords": 2, "knn_min/warp": 2}))
    for name, model, launches, designs in cases:
        model = init_weights_(model, 0).to(dev).eval()
        with torch.no_grad():
            cuda_lib.reset_launch_counts()
            t0 = time.perf_counter()
            got = model(xyz)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = {k: v for k, v in cuda_lib.launch_counts().items() if v}
            variants = {k: v for k, v in cuda_lib.variant_counts().items() if v}
            want = set_kernels(model, False)(xyz)
        errs = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)
                if g is not None]
        finite = all(torch.isfinite(g).all() for g in got if g is not None)
        print(f"[standalone] {name}: output shapes {[tuple(g.shape) for g in got if g is not None]}, "
              f"kernels vs plain max|d| / max {max(errs):.3e} (tolerance 1e-6); launches "
              f"{counts} (expected {launches}), by design {variants} (expected {designs}); "
              f"first forward {ms:.3f} ms (host clock)")
        if counts != launches or variants != designs or max(errs) > 1e-6 or not finite:
            raise AssertionError(f"{name}: kernels disagree with the plain path")


def rel_errs(got, want):
    """max |got - want| / max |want| of each tensor of ``want``."""
    out = {}
    for name, w in want.items():
        scale = w.abs().max().item()
        e = (got[name].to(w.dtype) - w).abs().max().item()
        out[name] = e / scale if scale > 0 else (float("inf") if e > 0 else 0.0)
    return out


def worst(errs, k=3):
    """The ``k`` largest entries of ``{name: error}``, for printing."""
    return ", ".join(f"{n} {v:.3e}" for n, v in sorted(errs.items(), key=lambda kv: -kv[1])[:k])


def step_agreement(model, plain, config, partial, complete):
    """One guarded train step (the rotation from seed 1) of ``model``
    through the kernels and of ``plain``, the same weights through the
    plain path: the losses' and the running statistics' largest relative
    errors, and each gradient's max|dg| / max|g|."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.training import steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state

    out = []
    for m in (model, plain):
        metrics = steps.train_step(create_train_state(m, config, 1), partial, complete,
                                   torch.Generator().manual_seed(1))
        if metrics["skipped"].item():
            raise AssertionError("the train step was skipped")
        # the pools' direction maps feed only an argmax: they get no gradient
        out.append((torch.stack([metrics["coarse"], metrics["dense"]]),
                    {k: p.grad for k, p in m.named_parameters() if p.grad is not None},
                    dict(m.named_buffers())))
    (lk, gk, bk), (lp, gp, bp) = out
    if set(gk) != set(gp):
        raise AssertionError("the two paths gave gradients of different parameters")
    loss_err = ((lk - lp).abs() / lp.abs()).max().item()
    stat_err = max(((bk[k] - b).abs() / b.abs().clamp_min(1e-12)).max().item()
                   for k, b in bp.items())
    return loss_err, stat_err, rel_errs(gk, gp)


def small_step_case(dev, batch: int):
    """The card test's train step (tests/test_torch_port_kernels.py): the
    flagship at num_coarse 256 (dense 4096, all nine kernels on the path),
    through the kernels and, with the same weights, the plain path, on
    ``batch`` synthetic samples.  Returns (model, plain, config, partial,
    complete)."""
    import numpy as np
    import torch

    from vn_pointcloudcompletion_tpu_torch.data.synthetic import SyntheticCompletionDataset
    from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet, init_weights_
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    model = init_weights_(PCNNet(num_coarse=256), 0).to(dev)
    plain = init_weights_(PCNNet(num_coarse=256), 0).to(dev).use_kernels_(False)
    ds = SyntheticCompletionDataset(batch, seed=3, n_partial=2048, n_complete=4096)
    partial, complete = (torch.from_numpy(np.stack([ds[i][k] for i in range(batch)])).to(dev)
                         for k in (0, 1))
    config = Config.from_dict({"num_coarse": 256, "rotation": "so3"})
    return model, plain, config, partial, complete


def decoder_grads(decoder, coarse, feature_global, rot, cot, dtype, center_feats=None):
    """Gradients of ``sum(fine * cot)`` w.r.t. the decoder's parameters and
    inputs (``center_feats``: the attention decoder's refined queries, with
    the decoder stack), on a copy of the decoder in ``dtype`` (float64 takes
    the plain path: the kernels are float32)."""
    import copy

    dec = copy.deepcopy(decoder).to(dtype).train()
    if dtype != coarse.dtype:
        for m in dec.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = False
    c = coarse.detach().to(dtype).requires_grad_()
    f = feature_global.detach().to(dtype).requires_grad_()
    kw = {}
    if center_feats is not None:
        kw["center_feats"] = center_feats.detach().to(dtype).requires_grad_()
    fine = dec(c, f, rot.to(dtype), **kw)
    (fine * cot.to(dtype)).sum().backward()
    out = {f"decoder.{k}": p.grad for k, p in dec.named_parameters()}
    out.update(coarse=c.grad, feature_global=f.grad)
    if kw:
        out["center_feats"] = kw["center_feats"].grad
    return out


def train_step_kernels_vs_plain(dev, smi: str):
    """Phase 5b: the decoder's backward through the kernels and through the
    plain path against float64; one train step's losses, gradients and
    running statistics through both; both step times; a profile of the
    kernels'."""
    import copy

    import numpy as np
    import torch

    from vn_pointcloudcompletion_tpu_torch.data.synthetic import SyntheticCompletionDataset
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.ops.rotations import random_rotations, rotate_points

    config = _smoke_config(lr=1e-4, rotation="so3")
    model = build_model(config).to(dev)
    plain = copy.deepcopy(model).use_kernels_(False)
    ds = SyntheticCompletionDataset(BATCH, seed=3)
    partial, complete = (torch.from_numpy(np.stack([ds[i][k] for i in range(BATCH)])).to(dev)
                         for k in (0, 1))

    # The decoder alone (no argmax: float64 is a true reference) for a fixed
    # cotangent of the dense output, from the train-mode encoder output of
    # this batch (on a copy: the model's running statistics stay as built).
    rot = random_rotations(torch.Generator().manual_seed(1), BATCH).to(dev)
    with torch.no_grad():
        coarse, fg = copy.deepcopy(model.encoder).train()(rotate_points(partial, rot))
    cot = torch.randn(BATCH, coarse.shape[1] * 16, 3, generator=torch.Generator(
        device=dev).manual_seed(2), device=dev) * 1e-4
    ref = decoder_grads(model.decoder, coarse, fg, rot, cot, torch.float64)
    dec_k = rel_errs(decoder_grads(model.decoder, coarse, fg, rot, cot, torch.float32), ref)
    dec_p = rel_errs(decoder_grads(plain.decoder, coarse, fg, rot, cot, torch.float32), ref)
    print(f"[train step] decoder backward against float64, max|dg| / max|g|: kernels "
          f"{worst(dec_k)} (tolerance {DEC_F64_TOL}); plain, for comparison, {worst(dec_p)}")

    cuda_lib.reset_launch_counts()
    loss_err, stat_err, step_errs = step_agreement(model, plain, config, partial, complete)
    torch.cuda.synchronize()
    designs = cuda_lib.variant_counts()
    print(f"[train step] C, S, S', C' and B' launches by design in the kernels' step: {designs} "
          f"(expected {FLAGSHIP_STEP_DESIGNS})")
    if designs != FLAGSHIP_STEP_DESIGNS:
        raise AssertionError("train step: C, S, S', C' or B' took another design than expected")
    print(f"[train step] kernels vs plain at batch {BATCH}: losses rel err {loss_err:.3e} "
          f"(tolerance 1e-4); running statistics rel err {stat_err:.3e} (tolerance 1e-4); "
          f"gradients max|dg| / max|g|, largest: {worst(step_errs)} (tolerance {STEP_TOL})")
    if not (loss_err <= 1e-4 and stat_err <= 1e-4 and max(step_errs.values()) <= STEP_TOL
            and max(dec_k.values()) <= DEC_F64_TOL):
        raise AssertionError("train step: kernels disagree with the plain path")

    for b in (4, 8):  # the card test's shapes, for its bounds
        _, _, errs = step_agreement(*small_step_case(dev, b))
        print(f"[train step] num_coarse 256, batch {b}: gradients max|dg| / max|g|, "
              f"largest: {worst(errs, 1)}")

    k_ms, _, k_gib, _ = step_cost(model, config, partial, complete)
    p_ms, _, p_gib, _ = step_cost(plain, config, partial, complete)
    k2_ms = step_cost(model, config, partial, complete)[0]
    print(f"[train step] {smi}: median of 5 steps after 2 warm-up (CUDA events, one "
          f"host read per step): kernels {k_ms:.3f} ms then {k2_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms; peak memory kernels {k_gib:.2f} GiB, plain {p_gib:.2f} GiB")
    profile_steps(model, config, partial, complete)


class DecisionTape:
    """The discrete decisions of one run of a model, recorded there and
    replayed in another: the kNN picks (K2, K3 and their plain versions),
    the FPS picks, the VN pools' argmax (both layouts, and the flagship
    encoder's fused linear + pool), the side of the VN
    leaky reflection (kernel A or the plain chain on planes, by the layer's
    shape; the vec layout's, by the tensor's) and the chamfer's nearest
    neighbours.  Runs that replay one tape differ in arithmetic
    only.  The reflections inside the whole-layer kernels B and C cannot be
    read: where a run takes B or C, that layer decides by itself.  As a
    context manager it patches the port's dispatch points, and restores
    them on exit."""

    def __init__(self):
        self.rec, self.play, self.pos, self.inside = {}, {}, {}, False

    def run(self, play=None):
        """Start a run: replay ``play`` (recordings of earlier runs) and
        record every other decision."""
        self.rec, self.play, self.pos = {}, dict(play or {}), {}

    def take(self, key, fresh):
        """(decision, replayed): the next ``key`` of the tape being
        replayed, else ``fresh()``, recorded."""
        if self.inside:  # a dispatch point reached from another one
            return fresh(), False
        if key in self.play:
            i = self.pos.get(key, 0)
            self.pos[key] = i + 1
            return self.play[key][i], True
        self.inside = True
        try:
            value = fresh()
        finally:
            self.inside = False
        self.rec.setdefault(key, []).append(value)
        return value, False

    def __enter__(self):
        import torch

        from vn_pointcloudcompletion_tpu_torch.models import pcn
        from vn_pointcloudcompletion_tpu_torch.nn import precision, vn
        from vn_pointcloudcompletion_tpu_torch.ops import chamfer, fps_pallas, knn_pallas
        from vn_pointcloudcompletion_tpu_torch.ops.vn_fused import EPS, plane_dot, safe_sqrt

        tape = self
        weak = precision.weak
        self._saved = [(mod, name, getattr(mod, name)) for mod, name in (
            (vn, "bn_leaky"), (pcn, "bn_leaky"), (vn, "_leaky_reflect"), (vn.VNMaxPool, "forward"),
            (pcn, "linear_maxpool_planes"),
            (chamfer, "nn_bidirectional"),
            (chamfer, "nn_bidirectional_reference"), (knn_pallas, "knn_min"),
            (knn_pallas, "reference_knn_min"), (knn_pallas, "edge_knn_gather_fwd"),
            (fps_pallas, "furthest_point_sample_kernel"),
            (fps_pallas, "reference_furthest_point_sample"))]
        orig = {name: fn for _, name, fn in self._saved}

        def bn_leaky(p, d, a, b, ns, use_kernels):
            # the side from the plain version's operations, kernel A's to the bit
            ct = torch.promote_types(p.dtype, torch.float32)
            p32, d32 = p.to(ct), d.to(ct)
            s = a.to(ct)[None, :, None] + b.to(ct)[None, :, None] / (
                safe_sqrt(plane_dot(p32, p32)) + EPS)
            q = p32 * s[:, None]
            dot = plane_dot(q, d32)[:, None]
            keep, replayed = tape.take(("mask",) + tuple(p.shape[2:]), lambda: dot.detach() >= 0)
            if not replayed:
                return orig["bn_leaky"](p, d, a, b, ns, use_kernels)
            coef = torch.where(keep, 0.0, (1 - ns) * dot / (plane_dot(d32, d32)[:, None] + EPS))
            return (q - coef * d32).to(p.dtype)

        def leaky_reflect(p, d, negative_slope, dim):  # vn._leaky_reflect, its side taped
            dotprod = (p * d).sum(dim, keepdim=True)
            keep, _ = tape.take(("vmask",) + tuple(p.shape[1:]), lambda: dotprod.detach() >= 0)
            mask = keep.to(p.dtype)
            d_norm_sq = (d * d).sum(dim, keepdim=True)
            reflected = p - (dotprod / (d_norm_sq + weak(EPS, p))) * d
            return weak(negative_slope, p) * p + weak(1 - negative_slope, p) * (
                mask * p + (1 - mask) * reflected)

        def pool(module, x):
            if module.layout == "vec":  # VNMaxPool.forward's vec branch
                d = vn.channel_linear(module.map_to_dir.weight, x, "vec")
                dot = vn.vector_dot(x, d, 2)
                idx, _ = tape.take(("pool",), lambda: dot.argmax(dim=-1, keepdim=True)[:, :, None])
                return torch.gather(x, -1, idx.expand(x.shape[:-1] + (1,)))[..., 0]
            d = vn.channel_linear(module.map_to_dir.weight, x, "plane")
            idx, _ = tape.take(("pool",), lambda: vn.vector_dot(x, d, 1).argmax(
                dim=-1, keepdim=True))
            return torch.gather(x, 3, idx[:, None].expand(-1, 3, -1, -1))[..., 0]

        def linear_maxpool(w, wd, x):  # the flagship encoder's pools, taped
            f, score = pcn.linear_pool_scores(w, wd, x)
            idx, _ = tape.take(("lpool",), lambda: score.argmax(dim=-1, keepdim=True))
            return f, torch.gather(f, 3, idx[:, None].expand(-1, 3, -1, -1))[..., 0]

        def knn(fn):
            def run(q, r, k):
                out = []
                idx, replayed = tape.take(("knn",), lambda: out.append(fn(q, r, k)) or out[0][1])
                if not replayed:
                    return out[0]
                rows = torch.arange(q.shape[0], device=q.device)[:, None, None]
                return ((q[:, :, None] - r[rows, idx.long()]) ** 2).sum(-1), idx
            return run

        def edge_fwd(xflat, u, v, k):  # kernel K3's picks, recorded or replayed
            out, idx = orig["edge_knn_gather_fwd"](xflat, u, v, k)
            if xflat.is_cuda:  # (on the CPU the plain version takes them)
                picked, replayed = tape.take(("knn",), lambda: idx)
                if replayed:
                    idx = picked
                    out = knn_pallas.gather_columns(u, picked) + v[:, :, None, :]
            return out, idx

        def fps(fn):
            return lambda xyz, s: tape.take(("fps",), lambda: fn(xyz, s))[0]

        def nearest(fn):
            def run(x, y):
                out = []
                (i1, i2), replayed = tape.take(
                    ("nn",), lambda: out.append(fn(x, y)) or (out[0][1], out[0][3]))
                if not replayed:
                    return out[0]
                g1 = torch.gather(y, 1, i1.long()[..., None].expand(-1, -1, 3))
                g2 = torch.gather(x, 1, i2.long()[..., None].expand(-1, -1, 3))
                return ((x - g1) ** 2).sum(-1), i1, ((y - g2) ** 2).sum(-1), i2
            return run

        vn.bn_leaky = pcn.bn_leaky = bn_leaky  # the decoders' fold layers call it from pcn
        pcn.linear_maxpool_planes = linear_maxpool
        vn._leaky_reflect, vn.VNMaxPool.forward = leaky_reflect, pool
        chamfer.nn_bidirectional = nearest(orig["nn_bidirectional"])
        chamfer.nn_bidirectional_reference = nearest(orig["nn_bidirectional_reference"])
        knn_pallas.knn_min = knn(orig["knn_min"])
        knn_pallas.reference_knn_min = knn(orig["reference_knn_min"])
        knn_pallas.edge_knn_gather_fwd = edge_fwd
        fps_pallas.furthest_point_sample_kernel = fps(orig["furthest_point_sample_kernel"])
        fps_pallas.reference_furthest_point_sample = fps(orig["reference_furthest_point_sample"])
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def step_grads(model, config, partial, complete, dtype):
    """One train step's (coarse, dense) losses, the running statistics after
    it and every gradient, in float64, of a copy of ``model`` in ``dtype``
    (float64 takes the plain path), for the rotation from seed 1; no
    optimiser update."""
    import copy

    import torch

    from vn_pointcloudcompletion_tpu_torch.ops.rotations import random_rotations, rotate_points
    from vn_pointcloudcompletion_tpu_torch.training.steps import _losses

    m = copy.deepcopy(model).to(dtype).train()
    if dtype == torch.float64:
        m.use_kernels_(False)
    rot = random_rotations(torch.Generator().manual_seed(1), partial.shape[0]).to(
        partial.device, dtype)
    loss1, loss2, loss = _losses(m, config, rotate_points(partial.to(dtype), rot),
                                 rotate_points(complete.to(dtype), rot), rot)
    loss.backward()
    return (torch.stack([loss1, loss2]).detach().double(),
            {k: b.double() for k, b in m.named_buffers()},
            {k: p.grad.double() for k, p in m.named_parameters() if p.grad is not None})


def on_one_tape(model, plain, run):
    """``run(m, dtype) -> (losses, buffers, grads)`` through the kernels
    (``model``), through the plain path (``plain``) replaying the kernels'
    decisions and deciding alone only where those cannot be read (the
    reflections inside B and C), and through the plain path in float64
    replaying both: the three results, and the two runs' recordings."""
    import torch

    with DecisionTape() as tape:
        tape.run()
        kernels = run(model, torch.float32)
        kernel_rec = tape.rec
        tape.run(kernel_rec)
        plain32 = run(plain, torch.float32)
        own = tape.rec
        tape.run({**kernel_rec, **own})
        plain64 = run(plain, torch.float64)
    return kernels, plain32, plain64, kernel_rec, own


def check_on_one_tape(tag, grads_k, grads_p, grads_64, tol=DGCNN_STEP_TOL,
                      f64_ratio=DGCNN_F64_RATIO) -> bool:
    """Print and check each gradient: kernels vs plain within ``tol``, and
    the kernels' distance from float64 within ``f64_ratio`` x the plain
    path's (or the floor)."""
    gap, k64, p64 = (rel_errs(grads_k, grads_p), rel_errs(grads_k, grads_64),
                     rel_errs(grads_p, grads_64))
    ratio = {k: k64[k] / max(p64[k], DGCNN_F64_FLOOR) for k in k64}

    print(f"{tag} gradients max|dg| / max|g|, largest: kernels vs plain {worst(gap)} (tolerance "
          f"{tol}); kernels vs float64 {worst(k64)}; plain vs float64 {worst(p64)}")
    print(f"{tag} each tensor's distance from float64, kernels over plain (plain floored at "
          f"{DGCNN_F64_FLOOR}), largest: {worst(ratio)} (tolerance {f64_ratio})")
    return max(gap.values()) <= tol and max(ratio.values()) <= f64_ratio


def dgcnn_train_step(dev, smi: str):
    """Phase 7b: the full-width VN DGCNN's gradients through the kernels,
    through the plain path and, as the reference, through the plain path in
    float64, the three on one set of discrete decisions (``on_one_tape``):
    first of the encoder alone for a fixed cotangent, then of one train step
    (losses, running statistics and every gradient); then the median step
    time of both paths, their peak memory, and a profile of the kernels'
    step."""
    import copy

    import torch

    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.ops.rotations import rotate_points

    config = _smoke_config("vn_dgcnn", lr=1e-4, rotation="so3")
    model = build_model(config).to(dev)
    plain = copy.deepcopy(model).use_kernels_(False)
    partial, complete, rot = main_path_batch(dev)
    tag = "[vn_dgcnn step]"

    gen = torch.Generator(device=dev).manual_seed(2)
    cots = [torch.randn(BATCH, *shape, generator=gen, device=dev) * 1e-3
            for shape in ((model.encoder.nc, 3), (512, 3, 1))]

    def encoder_grads(m, dtype):
        m = copy.deepcopy(m).to(dtype).train()
        if dtype == torch.float64:
            m.use_kernels_(False)
        out = m.encoder(rotate_points(partial, rot).to(dtype))
        sum((t * c.to(dtype)).sum() for t, c in zip(out, cots)).backward()
        return None, None, {k: p.grad.double() for k, p in m.named_parameters()
                            if p.grad is not None}

    def train_grads(m, dtype):
        return step_grads(m, config, partial, complete, dtype)

    (_, _, gk), (_, _, gp), (_, _, g64), _, _ = on_one_tape(model, plain, encoder_grads)
    ok = check_on_one_tape(f"{tag} encoder alone, fixed cotangent:", gk, gp, g64)
    (lk, bk, gk), (lp, bp, gp), (_, _, g64), kernel_rec, own = on_one_tape(
        model, plain, train_grads)
    loss_err = ((lk - lp).abs() / lp.abs()).max().item()
    stat_err = max(((bk[k] - b).abs() / b.abs().clamp_min(1e-12)).max().item()
                   for k, b in bp.items())
    print(f"{tag} train step at batch {BATCH}: decisions of the kernels' run replayed "
          f"{ {'/'.join(map(str, k)): len(v) for k, v in kernel_rec.items()} }; the plain "
          f"run's own { {'/'.join(map(str, k)): len(v) for k, v in own.items()} }")
    print(f"{tag} losses rel err {loss_err:.3e} (tolerance 1e-4); running statistics rel err "
          f"{stat_err:.3e} (tolerance 1e-4)")
    ok = check_on_one_tape(f"{tag} train step:", gk, gp, g64) and ok
    if not (ok and loss_err <= 1e-4 and stat_err <= 1e-4):
        raise AssertionError("VN DGCNN train step: kernels disagree with the plain path")

    k_ms, _, k_gib, _ = step_cost(model, config, partial, complete)
    p_ms, _, p_gib, _ = step_cost(plain, config, partial, complete)
    k2_ms = step_cost(model, config, partial, complete)[0]
    print(f"[vn_dgcnn step] {smi}: median of 5 steps after 2 warm-up (CUDA events, one "
          f"host read per step): kernels {k_ms:.3f} ms then {k2_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms; peak memory kernels {k_gib:.2f} GiB, plain {p_gib:.2f} GiB")
    # the top 10, and the encoder's kNN, FPS and gather items below them
    profile_steps(model, config, partial, complete, top=10,
                  also=("knn_min", "edge_knn_gather", "edge_select", "edge_gather", "fps_kernel",
                        "indexing_backward",
                        "index_elementwise", "sort"))


def pointr_train_step(dev, smi: str):
    """Phase 9b, full width, batch 8, ``vn_pointr`` +
    ``attention_vn_foldingnet``.  The two parts of the model that run
    kernels, each for a fixed cotangent through the kernels, the plain path
    and the plain path in float64, on one set of discrete decisions
    (``on_one_tape``: kNN, FPS, the pools, every reflection outside kernels
    B and C), each gradient within POINTR_STEP_TOL of its max against the
    plain path and no further from float64 than a ratio of the plain path's
    distance: the grouper (conv1 through S, B and their backwards at group
    0; conv4-6 through K3, A and A'; F) and the decoder (S, B and their
    backwards at group 64, C, C').  Between them the VN transformer runs
    the same PyTorch on both paths.  Then one whole train step, each run
    deciding alone, printed as information (below); then the median step
    time of both paths, their peak memory, and a profile's top 10."""
    import copy

    import torch

    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.ops.rotations import rotate_points

    config = _smoke_config("vn_pointr_448", lr=1e-4, rotation="so3")
    model = build_model(config).to(dev)
    plain = copy.deepcopy(model).use_kernels_(False)
    partial, complete, rot = main_path_batch(dev)
    tag = "[vn_pointr step]"
    gen = torch.Generator(device=dev).manual_seed(2)

    # the grouper alone, for a fixed cotangent of its (B, 128, 3, 128) features
    gcot = torch.randn(BATCH, 128, 3, 128, generator=gen, device=dev) * 1e-3

    def grouper_grads(m, dtype):
        grouper = copy.deepcopy(m.encoder.grouper).to(dtype).train()
        if dtype == torch.float64:
            for mod in grouper.modules():
                if hasattr(mod, "use_kernels"):
                    mod.use_kernels = False
        _, f = grouper(rotate_points(partial, rot).to(dtype))
        (f * gcot.to(dtype)).sum().backward()
        return None, None, {f"encoder.grouper.{k}": p.grad.double()
                            for k, p in grouper.named_parameters() if p.grad is not None}

    (_, _, ek), (_, _, ep), (_, _, e64), _, _ = on_one_tape(model, plain, grouper_grads)
    ok = check_on_one_tape(f"{tag} grouper alone, fixed cotangent:", ek, ep, e64,
                           POINTR_STEP_TOL, POINTR_F64_RATIO)

    # the decoder alone for a fixed cotangent of the dense output, from the
    # train-mode encoder output of this batch (on a copy)
    with torch.no_grad():
        coarse, fg = copy.deepcopy(model.encoder).train()(rotate_points(partial, rot))
    cot = torch.randn(BATCH, 14336, 3, generator=gen, device=dev) * 1e-4
    (_, _, dk), (_, _, dp), (_, _, d64), _, _ = on_one_tape(
        model, plain, lambda m, dtype: (None, None, decoder_grads(
            m.decoder, coarse[0], fg, rot, cot, dtype)))
    ok = check_on_one_tape(f"{tag} decoder alone, fixed cotangent:", dk, dp, d64,
                           POINTR_STEP_TOL, POINTR_F64_RATIO) and ok
    if not ok:
        raise AssertionError("vn_pointr train step: kernels disagree with the plain path")

    # The whole step, information only.  Its float32 result moves by O(1)
    # for one ulp of input, in the port and in the JAX package alike
    # (tests/test_torch_port_pointr.py::test_float32_step_as_sensitive_as_jax):
    # the VN transformer's VNLayerNorms rescale every vector to O(1), so a
    # short vector's rounding grows with it.  Decisions replayed from
    # another run would pair the wrong points, so each run decides alone,
    # and the plain path from inputs one ulp away shows the spread.
    nudged = torch.nextafter(partial, torch.full_like(partial, float("inf")))
    (lp, bp, gp), (lk, bk, gk), (l64, _, g64), (lc, bc, gc) = (
        step_grads(m, config, x, complete, dtype) for m, x, dtype in (
            (plain, partial, torch.float32), (model, partial, torch.float32),
            (plain, partial, torch.float64), (plain, nudged, torch.float32)))

    print(f"{tag} whole train step at batch {BATCH}, each run deciding alone (information): "
          f"losses (coarse, dense) plain {lp.tolist()}, kernels {lk.tolist()}, one ulp away "
          f"{lc.tolist()}, float64 {l64.tolist()}; running statistics max|d| / max against "
          f"plain: kernels {max(rel_errs(bk, bp).values()):.3e}, one ulp away "
          f"{max(rel_errs(bc, bp).values()):.3e}; gradients max|dg| / max|g| against plain, "
          f"largest: kernels {worst(rel_errs(gk, gp))}; one ulp away {worst(rel_errs(gc, gp))}; "
          f"against float64: kernels {worst(rel_errs(gk, g64))}; plain {worst(rel_errs(gp, g64))}")
    if not all(torch.isfinite(t).all() for t in (lk, *bk.values(), *gk.values())):
        raise AssertionError("vn_pointr train step: non-finite losses, statistics or gradients")

    k_ms, _, k_gib, _ = step_cost(model, config, partial, complete)
    p_ms, _, p_gib, _ = step_cost(plain, config, partial, complete)
    k2_ms = step_cost(model, config, partial, complete)[0]
    print(f"{tag} {smi}: median of 5 steps after 2 warm-up (CUDA events, one host read per "
          f"step): kernels {k_ms:.3f} ms then {k2_ms:.3f} ms, plain {p_ms:.3f} ms; peak "
          f"memory kernels {k_gib:.2f} GiB, plain {p_gib:.2f} GiB")
    profile_steps(model, config, partial, complete, top=10)


def scalar_train_step(dev, smi: str):
    """Phase 8b: one train step of ``dgcnn_fps`` + ``foldingnet`` at
    ``num_coarse`` 448, full width, through the kernels (K2, F) against the
    plain path.  The kernels only pick indices, equal to their plain
    versions', and the rest is the same PyTorch on both paths (the chamfer's
    kernel D on both): losses, running statistics and every gradient within
    1e-6 of the tensor's max.  A bias followed by a normalisation has a
    gradient of 0 up to rounding; tensors whose gradient is below 1e-6 of
    the model's largest are listed, not compared.  Then the median step and
    eval forward times of both paths (CUDA events)."""
    import copy

    import torch

    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model

    config = _smoke_config("dgcnn_448", lr=1e-4, rotation="so3")
    model = build_model(config).to(dev)
    plain = copy.deepcopy(model).use_kernels_(False)
    partial, complete, _ = main_path_batch(dev)
    lk, bk, gk = step_grads(model, config, partial, complete, torch.float32)
    lp, bp, gp = step_grads(plain, config, partial, complete, torch.float32)
    loss_err = ((lk - lp).abs() / lp.abs()).max().item()
    stat_err = max(((bk[k] - b).abs() / b.abs().clamp_min(1e-12)).max().item()
                   for k, b in bp.items())
    top = max(g.abs().max().item() for g in gp.values())
    zero = sorted(k for k, g in gp.items() if g.abs().max().item() < 1e-6 * top)
    errs = rel_errs({k: gk[k] for k in gp if k not in zero}, {k: gp[k] for k in gp if k not in zero})
    print(f"[dgcnn_448 step] batch {BATCH}: losses rel err {loss_err:.3e}, running statistics "
          f"rel err {stat_err:.3e}, gradients max|dg| / max|g| largest "
          + ", ".join(f"{n} {v:.3e}" for n, v in sorted(errs.items(), key=lambda kv: -kv[1])[:3])
          + f" (tolerance 1e-6 for each); gradients of 0 up to rounding: {zero}")
    if loss_err > 1e-6 or stat_err > 1e-6 or max(errs.values()) > 1e-6:
        raise AssertionError("DGCNN train step: kernels disagree with the plain path")


    _, _, rot = main_path_batch(dev)

    def forward_ms(m):
        m.eval()
        with torch.no_grad():
            ms = cuda_ms(lambda: m(partial @ rot, rot), 5)
        m.train()
        return ms

    k_ms, p_ms, k2_ms = (step_cost(m, config, partial, complete)[0]
                         for m in (model, plain, model))
    kf, pf, kf2 = forward_ms(model), forward_ms(plain), forward_ms(model)
    print(f"[dgcnn_448 step] {smi}: median of 5 after 2 warm-up (CUDA events): train step "
          f"kernels {k_ms:.3f} ms then {k2_ms:.3f} ms, plain {p_ms:.3f} ms; eval forward "
          f"kernels {kf:.3f} ms then {kf2:.3f} ms, plain {pf:.3f} ms")


def pointr_decoder_step(dev, smi: str):
    """Phase 15b, after the counted training run: vn_pointr_448 with the
    decoder stack (``pointr_decoder``) at full width, batch 8.  One train
    step counted (STEP_LAUNCHES: vn_pointr_448's with K2 4, every kernel in
    its float32 mode and its design).  The parts of the model the stack
    adds, each for a fixed cotangent through the kernels, the plain path
    and the plain path in float64 on one set of discrete decisions
    (``on_one_tape``), each gradient no further from float64 than
    POINTR_F64_RATIO x the plain path's distance: the stack alone
    (``VNPCTransformer.refine``: the queries' VN layers and eight blocks,
    K2 for its two graphs) from this batch's train-mode tokens, centres,
    global feature and coarse points, within POINTR_STEP_TOL of the plain
    path's; the attention decoder with its ``query_proj`` (S, B, C and
    their backwards) from the same encoder output, within
    POINTR_QUERY_DEC_TOL (see there).  (The grouper is phase 9b's; between
    the parts the VN transformer runs the same PyTorch on both paths, and
    the whole float32 step moves by O(1) for one ulp of input: phase 9b.)  Then the eval
    forward and the train step of vn_pointr_448 with and without the stack
    in turns (CUDA events; ``step_cost``: the step's peak memory), and a
    profile of the stack's step."""
    import copy

    import torch

    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.ops.rotations import rotate_points
    from vn_pointcloudcompletion_tpu_torch.training import steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state

    path = "vn_pointr_448_dec"
    tag = f"[{path} step]"
    config = _smoke_config(path, lr=1e-4, rotation="so3")
    model = build_model(config).to(dev)
    plain = copy.deepcopy(model).use_kernels_(False)
    partial, complete, rot = main_path_batch(dev)

    state = create_train_state(copy.deepcopy(model), config, 1)
    steps.train_step(state, partial, complete, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    metrics = steps.train_step(state, partial, complete, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    counts = {k: v for k, v in cuda_lib.launch_counts().items()
              if v and k != "chamfer_nn_bidir"}
    print(f"{tag} one train step: launches {json.dumps(counts)}; skipped "
          f"{metrics['skipped'].item()}")
    check_designs(f"{tag} one train step", counts, cuda_lib.variant_counts(), path)
    check_stats_designs(f"{tag} one train step", cuda_lib.variant_counts(),
                        STATS_STEP_DESIGNS[path], 1)
    if counts != STEP_LAUNCHES[path] or metrics["skipped"].item():
        raise AssertionError(f"{tag} launches {counts}, expected {STEP_LAUNCHES[path]}")
    del state

    # the stack's inputs from this batch's train-mode encoder (on a copy)
    enc = copy.deepcopy(model.encoder).train()
    args = []
    refine = enc.refine
    enc.refine = lambda *a: args.extend(a) or refine(*a)
    with torch.no_grad():
        (coarse, _), (fg, queries) = enc(rotate_points(partial, rot))
    del enc
    gen = torch.Generator(device=dev).manual_seed(2)
    qcot = torch.randn(queries.shape, generator=gen, device=dev) * 1e-3

    def stack_grads(m, dtype):
        e = copy.deepcopy(m.encoder).to(dtype).train()
        q = e.refine(*(t.to(dtype) if t.is_floating_point() else t for t in args))
        (q * qcot.to(dtype)).sum().backward()
        return None, None, {f"encoder.{k}": p.grad.double() for k, p in e.named_parameters()
                            if p.grad is not None}

    (_, _, sk), (_, _, sp), (_, _, s64), _, _ = on_one_tape(model, plain, stack_grads)
    if not any(k.startswith("encoder.decoder.7.") for k in sk):
        raise AssertionError(f"{tag} no gradient reached the stack's last block")
    ok = check_on_one_tape(f"{tag} the decoder stack alone, fixed cotangent of the queries:",
                           sk, sp, s64, POINTR_STEP_TOL, POINTR_F64_RATIO)
    cot = torch.randn(BATCH, 14336, 3, generator=gen, device=dev) * 1e-4
    (_, _, dk), (_, _, dp), (_, _, d64), _, _ = on_one_tape(
        model, plain, lambda m, dtype: (None, None, decoder_grads(
            m.decoder, coarse, fg, rot, cot, dtype, queries)))
    ok = check_on_one_tape(f"{tag} the decoder with query_proj alone, fixed cotangent:", dk,
                           dp, d64, POINTR_QUERY_DEC_TOL, POINTR_F64_RATIO) and ok
    if not ok:
        raise AssertionError(f"{tag} kernels disagree with the plain path")
    del plain

    base_config = _smoke_config("vn_pointr_448", lr=1e-4, rotation="so3")
    base = build_model(base_config).to(dev)
    xyz = partial @ rot

    def forward_ms(m):
        m.eval()
        with torch.no_grad():
            ms = cuda_ms(lambda: m(xyz, rot), 5)
        m.train()
        return ms

    fwd, step, gib = {}, {}, {}
    for name, m, cfg in (("vn_pointr_448", base, base_config), (path, model, config),
                         (path, model, config), ("vn_pointr_448", base, base_config)):
        fwd.setdefault(name, []).append(forward_ms(m))
        t_ms, _, gib[name], _ = step_cost(m, cfg, partial, complete)
        step.setdefault(name, []).append(t_ms)
    for name in ("vn_pointr_448", path):
        print(f"{tag} {name}, batch {BATCH}, {smi}, in turns (448, stack, stack, 448): eval "
              f"forward float32 {' / '.join(f'{t:.3f}' for t in fwd[name])} ms (median of 5, "
              f"CUDA events); train step float32 {' / '.join(f'{t:.3f}' for t in step[name])} "
              f"ms (median of 5 after 2 warm-up); peak memory {gib[name]:.3f} GiB")
    del base
    profile_steps(model, config, partial, complete, top=10)


def pointr_decoder_bf16(dev, smi: str):
    """Phase 15c: vn_pointr_448 with the decoder stack under the bf16
    policy, as phases 12 and 13 hold the root config.json: one eval forward
    counted (BF16_FORWARD_LAUNCHES: no float32-mode launch of A, B, C or
    K3; K2 4), float32 outputs, on one DecisionTape against the plain path
    in bf16 and in float32 (``bf16_tape_check``); one bf16 train step
    counted (BF16_STEP_LAUNCHES and BF16_STEP_DESIGNS, K2 4); the eval
    forward in float32 and bf16 and the bf16 train step of vn_pointr_448
    with and without the stack (CUDA events, peak memory).  (The JAX
    package cannot run this model under bf16: its scanned blocks return
    float32 queries for a bf16 carry, which ``nn.scan`` refuses; the port's
    blocks widen the queries where JAX's dtypes do.)"""
    import copy

    import torch

    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.nn.precision import compute_dtype_scope
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.training import steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state

    path = "vn_pointr_448_dec"
    tag = f"[{path} bf16]"
    config = _smoke_config(path)
    model = build_model(config).to(dev).eval()
    partial, complete, rot = main_path_batch(dev)
    xyz = partial @ rot

    cuda_lib.reset_launch_counts()
    with torch.no_grad(), compute_dtype_scope(torch.bfloat16):
        coarse, fine = model(xyz, rot)
    torch.cuda.synchronize()
    counts = {k: v for k, v in cuda_lib.launch_counts().items()
              if v and k != "chamfer_nn_bidir"}
    print(f"{tag} one forward: launches {json.dumps(counts)}")
    check_designs(f"{tag} one forward", counts, cuda_lib.variant_counts(), path)
    if counts != BF16_FORWARD_LAUNCHES[path]:
        raise AssertionError(f"{tag} launches {counts}, expected {BF16_FORWARD_LAUNCHES[path]}")
    if (fine.dtype != torch.float32 or fine.shape != (BATCH, 14336, 3)
            or not (torch.isfinite(fine).all() and torch.isfinite(coarse).all())):
        raise AssertionError(f"{tag} bad outputs {fine.dtype} {tuple(fine.shape)}")
    kern, plain, f32, _ = bf16_on_one_tape(model, xyz, rot)
    if not bf16_tape_check(tag, kern, plain, f32):
        raise AssertionError(f"{tag} the bf16 kernel path disagrees with the plain path")

    state = create_train_state(copy.deepcopy(model).train(), config, 1)
    with compute_dtype_scope(torch.bfloat16):
        steps.train_step(state, partial, complete, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        metrics = steps.train_step(state, partial, complete, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
    counts = {k: v for k, v in cuda_lib.launch_counts().items()
              if v and k != "chamfer_nn_bidir"}
    designs = cuda_lib.variant_counts()
    print(f"{tag} one train step: launches {json.dumps(counts)}; by design "
          f"{json.dumps(designs)}; skipped {metrics['skipped'].item()}")
    if counts != BF16_STEP_LAUNCHES[path] or metrics["skipped"].item():
        raise AssertionError(f"{tag} launches {counts}, expected {BF16_STEP_LAUNCHES[path]}")
    if designs != BF16_STEP_DESIGNS[path]:
        raise AssertionError(f"{tag} designs {designs}, expected {BF16_STEP_DESIGNS[path]}")
    del state

    base_config = _smoke_config("vn_pointr_448")
    base = build_model(base_config).to(dev)
    fwd, step, gib = {}, {}, {}
    for name, m, cfg in (("vn_pointr_448", base, base_config), (path, model, config),
                         (path, model, config), ("vn_pointr_448", base, base_config)):
        m.eval()
        for dt in (torch.float32, torch.bfloat16):
            def run(m=m, dt=dt):
                with torch.no_grad(), compute_dtype_scope(dt):
                    return m(xyz, rot)
            fwd.setdefault((name, dt), []).append(cuda_ms(run, 5))
        m.train()
        t_ms, _, gib[name], _ = step_cost(m, cfg, partial, complete, torch.bfloat16)
        step.setdefault(name, []).append(t_ms)
    for name in ("vn_pointr_448", path):
        print(f"{tag} {name}, batch {BATCH}, {smi}, in turns (448, stack, stack, 448): eval "
              f"forward float32 {' / '.join(f'{t:.3f}' for t in fwd[name, torch.float32])} ms, "
              f"bf16 {' / '.join(f'{t:.3f}' for t in fwd[name, torch.bfloat16])} ms (medians "
              f"of 5, CUDA events); bf16 train step "
              f"{' / '.join(f'{t:.3f}' for t in step[name])} ms; peak memory {gib[name]:.3f} GiB")


def scalar_pointr(dev, smi: str):
    """Phase 15d: the scalar ``VNPCTransformer(dgcnn="dgcnn", trans="trans",
    only_coarse=False)`` at full width (embed 384, enc_depth 6, dec_depth 8,
    224 queries), batch 8, 2048 input points, weights drawn from seed 0
    (``init_weights_``): the composer never builds it, as in JAX.  One eval
    forward counted (SCALAR_PTR_LAUNCHES: K2 for the trunk's four graphs,
    the proxy graph and the decoder's two; F for the trunk's two samplings
    and the FPS tail; every launch in its design), then the plain path on
    the same DecisionTape: the coarse points, the global feature and the
    refined queries within POINTR_FWD_TOL of each one's max; both paths'
    forward times."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.models.composer import init_weights_
    from vn_pointcloudcompletion_tpu_torch.models.pointr import VNPCTransformer
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib

    tag = "[scalar VNPCTransformer]"
    enc = init_weights_(VNPCTransformer(dgcnn="dgcnn", trans="trans", only_coarse=False),
                        0).to(dev).eval()
    partial, _, rot = main_path_batch(dev)
    xyz = partial @ rot

    def use(flag):
        for m in enc.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = flag

    with torch.no_grad(), DecisionTape() as tape:
        cuda_lib.reset_launch_counts()
        (coarse, cat), (g, q) = enc(xyz)
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda_lib.launch_counts().items() if v}
        print(f"{tag} one forward: launches {json.dumps(counts)}")
        check_designs(f"{tag} one forward", counts, cuda_lib.variant_counts())
        if counts != SCALAR_PTR_LAUNCHES:
            raise AssertionError(f"{tag} launches {counts}, expected {SCALAR_PTR_LAUNCHES}")
        use(False)
        tape.run(tape.rec)
        (coarse_p, cat_p), (g_p, q_p) = enc(xyz)
        use(True)
    errs = {name: ((a - b).abs().max() / b.abs().max()).item() for name, a, b in (
        ("coarse", coarse, coarse_p), ("coarse with the FPS tail", cat, cat_p),
        ("global feature", g, g_p), ("refined queries", q, q_p))}
    print(f"{tag} kernels vs plain on one tape, max|d| / max: {json.dumps(errs)} (tolerance "
          f"{POINTR_FWD_TOL})")
    shapes = tuple(tuple(t.shape) for t in (coarse, cat, g, q))
    if shapes != ((BATCH, 224, 3), (BATCH, 448, 3), (BATCH, 1024), (BATCH, 224, 384)):
        raise AssertionError(f"{tag} output shapes {shapes}")
    if max(errs.values()) > POINTR_FWD_TOL or not torch.isfinite(q).all():
        raise AssertionError(f"{tag} kernels disagree with the plain path")
    ms = {}
    for flag in (True, False, True, False):
        use(flag)
        with torch.no_grad():
            ms.setdefault(flag, []).append(cuda_ms(lambda: enc(xyz), 5))
    use(True)
    print(f"{tag} eval forward, batch {BATCH}, {smi}: kernels "
          f"{' / '.join(f'{t:.3f}' for t in ms[True])} ms, plain "
          f"{' / '.join(f'{t:.3f}' for t in ms[False])} ms (medians of 5, CUDA events)")


def profile_steps(model, config, partial, complete, steps_n: int = 3, top: int = 20,
                  also: tuple = ()):
    """torch.profiler over a few train steps through the kernels: the device
    time by kernel (the ``top`` largest, and any other whose name holds a
    string of ``also``) and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vn_pointcloudcompletion_tpu_torch.training import steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state

    state = create_train_state(model, config, 1)
    gen = torch.Generator().manual_seed(0)
    steps.train_step(state, partial, complete, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps_n):
            steps.train_step(state, partial, complete, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the CPU-side ops above them carry the same time
    kernels = sorted((e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")),
                     key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[profile] {steps_n} train steps: wall {wall_ms:.3f} ms (host clock), device "
          f"kernel time {total:.3f} ms, busy share {total / wall_ms:.3f}")
    shown = kernels[:top] + [e for e in kernels[top:] if any(s in e.key.lower() for s in also)]
    for e in shown:
        print(f"[profile] {e.self_device_time_total / 1e3 / steps_n:10.3f} ms/step "
              f"{e.count // steps_n:5d} launches/step  {e.key[:90]}")


def last_fold(model):
    """The decoder's last fold layer (kernel C on the kernel path: the
    1-channel projection of the fold), whose output a forward hook reads."""
    dec = model.decoder
    return dec.final_conv[1] if hasattr(dec, "final_conv") else dec.vn_folding2[1]


def bf16_on_one_tape(model, xyz, rot, mutant_of=None):
    """The eval forward under the bf16 policy through the kernels, recorded
    on a DecisionTape, then through the plain path in bf16 and in float32,
    both replaying the kernels' decisions: three pairs (coarse cloud, the
    decoder's last fold output; ``last_fold``) and the recording.
    ``mutant_of``: a recording to replay in the kernel run (a mutant's run
    on the unchanged run's decisions)."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.nn.precision import compute_dtype_scope

    folds = []
    hook = last_fold(model).register_forward_hook(lambda m, i, out: folds.append(out))

    def run(dtype):
        with compute_dtype_scope(dtype):
            return model(xyz, rot)[0], folds[-1]

    try:
        with torch.no_grad(), DecisionTape() as tape:
            tape.run(mutant_of)
            kern = run(torch.bfloat16)
            rec = {**(mutant_of or {}), **tape.rec}
            model.use_kernels_(False)
            try:
                tape.run(rec)
                plain = run(torch.bfloat16)
                tape.run({**rec, **tape.rec})
                f32 = run(torch.float32)
            finally:
                model.use_kernels_(True)
    finally:
        hook.remove()
    return kern, plain, f32, rec


def bf16_tape_check(tag, kern, plain, f32) -> bool:
    """Print and check phase 12's two bounds for (coarse, fold), in root
    mean square: ||a - b|| / ||float32 forward||.  (A single element's bf16
    noise reaches ~2% of the fold's max: kernel C and the plain chain sum
    256 channels' epilogues, which cancel, and the plain chain rounds each
    to bf16 first; the mean square sees a bias of all elements, such as
    the mutant's, through that noise.)"""
    ok = True
    for name, k, p, f in zip(("coarse", "fold"), kern, plain, f32):
        f = f.double()
        scale = f.norm().item()
        d_kf, d_pf, d_kp = ((a.double() - b.double()).norm().item() / scale
                            for a, b in ((k, f), (p, f), (k, p)))
        good = d_kf <= BF16_F32_RATIO * d_pf and d_kp <= BF16_FWD_TOL
        print(f"{tag} {name}: kernels vs float32 {d_kf:.3e}, plain bf16 vs float32 "
              f"{d_pf:.3e} (ratio {d_kf / max(d_pf, 1e-30):.2f}, bound {BF16_F32_RATIO}); "
              f"kernels vs plain bf16 {d_kp:.3e} (bound {BF16_FWD_TOL:.3e}); max-abs: "
              f"{(k.double() - f).abs().max().item() / f.abs().max().item():.3e}, "
              f"{(p.double() - f).abs().max().item() / f.abs().max().item():.3e}, "
              f"{(k.double() - p.double()).abs().max().item() / f.abs().max().item():.3e} "
              f"{'PASS' if good else 'FAIL'}")
        ok = ok and good
    return ok


def bf16_launches_a_step(key: str) -> dict:
    """Launches of ``key`` (a kernel in its bf16 mode) in one eval forward
    of each path phase 12 serves (BF16_FORWARD_LAUNCHES), one vn_pointr_448
    train step of phase 13 (BF16_STEP_LAUNCHES, its validation forward
    apart) and one flagship bf16 train step (BF16_STEP_DESIGNS, by design):
    the counts those phases assert."""
    out = {f"serve {path}": BF16_FORWARD_LAUNCHES[path].get(key, 0)
           for path in ("flagship", "vn_dgcnn", "vn_pointr_448")}
    out["train vn_pointr_448"] = BF16_STEP_LAUNCHES["vn_pointr_448"].get(key, 0)
    out["train flagship"] = sum(v for k, v in BF16_STEP_DESIGNS["flagship"].items()
                                if k.split("/")[0] == key)
    return out


def bf16_serve(dev, smi: str):
    """Phase 12: the bf16 policy's serving path.  The eval forwards of the
    flagship, VN DGCNN and vn_pointr_448 at full width, batch 8, under
    ``compute_dtype_scope(torch.bfloat16)``, each with the counters set to
    0 just before and read just after (the launches of BF16_FORWARD_LAUNCHES
    exactly: no float32-mode launch of A, B, C or K3), float32 outputs;
    each on one DecisionTape against the plain path in bf16 and in float32
    (``bf16_tape_check``), and on the flagship a mutant (kernel C's bf16
    output scaled by BF16_MUTANT) that the check must catch; then the
    flagship metric step (JAX ``bench_eval_step``'s protocol: so3 rotation,
    forward, CD-L1/L2, F-score, IoU) counted.  Median times (CUDA events)
    of each forward and of the metric step in float32 and bf16.  Returns
    the summed launch counts of the counted runs, and by design."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.nn.precision import compute_dtype_scope
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib, vn_layer_fused
    from vn_pointcloudcompletion_tpu_torch.training.evaluate import metric_step

    partial, complete, rot = main_path_batch(dev)
    xyz = partial @ rot
    total: dict = {}

    def counted(what, fn, path):
        cuda_lib.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda_lib.launch_counts().items() if v}
        variants = cuda_lib.variant_counts()
        for key, v in {**counts, **variants}.items():
            total[key] = total.get(key, 0) + v
        print(f"[bf16 serve] {what} launches: {json.dumps(counts)}")
        check_designs(f"[bf16 serve] {what}", counts, variants, path)
        return out, counts

    def timed(fn, dtype, reps=5):
        def run():
            with torch.no_grad(), compute_dtype_scope(dtype):
                return fn()
        return cuda_ms(run, reps)

    for path in ("flagship", "vn_dgcnn", "vn_pointr_448"):
        tag = f"[bf16 serve {path}]"
        config = _smoke_config(path)
        model = build_model(config).to(dev).eval()

        def fwd():
            with torch.no_grad(), compute_dtype_scope(torch.bfloat16):
                return model(xyz, rot)

        (coarse, fine), counts = counted(f"{path} one forward", fwd, path)
        counts.pop("chamfer_nn_bidir", None)
        if counts != BF16_FORWARD_LAUNCHES[path]:
            raise AssertionError(f"{tag} launches {counts}, expected "
                                 f"{BF16_FORWARD_LAUNCHES[path]}")
        n_dense = 14336 if config.num_coarse == 448 else 16 * config.num_coarse
        if (fine.dtype != torch.float32 or fine.shape != (BATCH, n_dense, 3)
                or not (torch.isfinite(fine).all() and torch.isfinite(coarse).all())):
            raise AssertionError(f"{tag} bad outputs {fine.dtype} {tuple(fine.shape)}")
        kern, plain, f32, rec = bf16_on_one_tape(model, xyz, rot)
        if not bf16_tape_check(tag, kern, plain, f32):
            raise AssertionError(f"{tag} the bf16 kernel path disagrees with the plain path")
        if path == "flagship":
            orig = vn_layer_fused.vn_layer_fused_project
            vn_layer_fused.vn_layer_fused_project = lambda *a, **k: orig(*a, **k) * BF16_MUTANT
            try:
                mutant = bf16_on_one_tape(model, xyz, rot, rec)[0]
            finally:
                vn_layer_fused.vn_layer_fused_project = orig
            if bf16_tape_check(f"{tag} mutant (C x {BF16_MUTANT})", mutant, plain, f32):
                raise AssertionError(f"{tag} the check misses kernel C scaled by {BF16_MUTANT}")
            print(f"{tag} the mutant fails the check, as it must")
        ms = {dt: timed(lambda: model(xyz, rot), dt) for dt in (torch.float32, torch.bfloat16)}
        print(f"{tag} eval forward, batch {BATCH}: float32 {ms[torch.float32]:.2f} ms "
              f"({BATCH / ms[torch.float32] * 1e3:.1f} completions/s), bf16 "
              f"{ms[torch.bfloat16]:.2f} ms ({BATCH / ms[torch.bfloat16] * 1e3:.1f} "
              f"completions/s); {smi}")
        if path != "flagship":
            del model
            continue
        flagship = model

    def step():
        with torch.no_grad(), compute_dtype_scope(torch.bfloat16):
            return metric_step(flagship, partial, complete, rot)

    (out, pred), counts = counted("flagship metric step", step, "flagship")
    want = dict(BF16_FORWARD_LAUNCHES["flagship"], chamfer_nn_bidir=1)
    if counts != want or pred.dtype != torch.float32:
        raise AssertionError(f"[bf16 metric step] launches {counts}, expected {want}")
    row = {k: float(v.mean()) for k, v in out.items()}
    if not all(v == v and abs(v) < float("inf") for v in row.values()):
        raise AssertionError(f"[bf16 metric step] non-finite metrics {row}")
    ms = {dt: timed(lambda: metric_step(flagship, partial, complete, rot), dt)
          for dt in (torch.float32, torch.bfloat16)}
    print(f"[bf16 metric step] flagship, batch {BATCH}: {json.dumps(row)}; float32 "
          f"{ms[torch.float32]:.2f} ms ({BATCH / ms[torch.float32] * 1e3:.1f} completions/s), "
          f"bf16 {ms[torch.bfloat16]:.2f} ms ({BATCH / ms[torch.bfloat16] * 1e3:.1f} "
          f"completions/s); {smi}")
    return total


def bf16_step_grads(model, config, partial, complete, policy):
    """One train step's (coarse, dense) losses, running statistics and
    gradients (float64 copies) of a copy of ``model`` under the compute
    policy ``policy``, for the rotation from seed 1; no optimiser update."""
    import copy

    import torch

    from vn_pointcloudcompletion_tpu_torch.nn.precision import compute_dtype_scope
    from vn_pointcloudcompletion_tpu_torch.ops.rotations import random_rotations, rotate_points
    from vn_pointcloudcompletion_tpu_torch.training.steps import _losses

    m = copy.deepcopy(model).train()
    rot = random_rotations(torch.Generator().manual_seed(1), partial.shape[0]).to(partial.device)
    with compute_dtype_scope(policy):
        loss1, loss2, loss = _losses(m, config, rotate_points(partial, rot),
                                     rotate_points(complete, rot), rot)
        loss.backward()
    return (torch.stack([loss1, loss2]).detach().double(),
            {k: b.double() for k, b in m.named_buffers()},
            {k: p.grad.double() for k, p in m.named_parameters() if p.grad is not None})


def rms_errs(got, want):
    """||got - want|| / ||want|| of each tensor of ``want``."""
    return {k: ((got[k] - w).norm() / w.norm()).item() for k, w in want.items()
            if w.norm() > 0}


PLAIN_SWAPS = {"A": "bn_leaky_fwd", "A'": "bn_leaky_bwd", "S": "stats_fwd", "S'": "stats_bwd",
               "B": "_launch", "B'": "layer_bwd", "C": "project_fwd", "C'": "layer_project_bwd"}


@contextlib.contextmanager
def kernels_as_plain(only=None):
    """Inside: every VN kernel's wrapper (A, A', S, S', B, B', C, C'), or
    those named in ``only`` (keys of PLAIN_SWAPS), runs its plain version on
    CUDA tensors too, at the kernels' dispatch points and rounding points,
    S, S', C and C' summing p, d in the order of the kernel's launch at that
    call's shapes (``launch_order``: the tensor cores' k16 steps at the wide
    bf16 layers): the arithmetic of the kernel path in plain PyTorch, for
    holding the kernels to it inside a whole train step."""
    from vn_pointcloudcompletion_tpu_torch.ops import vn_fused, vn_layer_fused as vl

    launch = vl._launch

    def layer(kernel, x, w, wd, pbias, dbias, a, b, w_out, ns, group, pd_out=None):
        if w_out is not None:  # kernel C, where it is not swapped itself
            return launch(kernel, x, w, wd, pbias, dbias, a, b, w_out, ns, group, pd_out)
        return vl.reference_layer_fused(x, w, wd, pbias, dbias, a, b, ns, group)  # B

    def stats(x, w, pbias, group=0, p_out=None):
        return vl.reference_stats(x, w, pbias, group, order=vl.launch_order("S", x, w.shape[0],
                                                                            group))

    def stats_bwd(x, w, pbias, c1, c2, group=0, p_out=None):
        return vl.reference_stats_bwd(x, w, pbias, c1, c2, group,
                                      order=vl.launch_order("S'", x, w.shape[0], group))

    def project(x, w, wd, pbias, dbias, a, b, w_out, ns, group=0, pd_out=None):
        return vl.reference_layer_fused_project(x, w, wd, pbias, dbias, a, b, w_out, ns, group,
                                                order=vl.launch_order("C", x, w.shape[0], group))

    def project_bwd(x, w, wd, pbias, dbias, a, b, w_out, g, ns, group=0, pd_out=None):
        return vl.reference_layer_project_bwd(
            x, w, wd, pbias, dbias, a, b, w_out, g, ns, group,
            order=vl.launch_order("C'", x, w.shape[0], group))

    swaps = [(vn_fused, "bn_leaky_fwd", vn_fused.reference_bn_leaky_planes),
             (vn_fused, "bn_leaky_bwd", vn_fused.reference_bn_leaky_bwd),
             (vl, "stats_fwd", stats), (vl, "stats_bwd", stats_bwd),
             (vl, "layer_bwd", vl.reference_layer_bwd), (vl, "project_fwd", project),
             (vl, "layer_project_bwd", project_bwd), (vl, "_launch", layer)]
    if only is not None:
        swaps = [s for s in swaps if s[1] in {PLAIN_SWAPS[k] for k in only}]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def bf16_step_check(tag, kern, versions, plain16, plain32) -> bool:
    """Print and check phase 13's bounds on one step's gradients: the
    kernels within BF16_STEP_TOL of their plain versions (``versions``: the
    same dispatch and rounding in plain PyTorch), the decoder's (which the
    backward kernels compute directly) within BF16_DECODER_TOL, and no
    further from the plain float32 path than BF16_F32_RATIO x the plain
    bf16 path."""
    d_kv = rms_errs(kern, versions)
    dec = {k: v for k, v in d_kv.items() if k.startswith("decoder.")}
    d_kf, d_pf = rms_errs(kern, plain32), rms_errs(plain16, plain32)
    ratio = {k: d_kf[k] / max(d_pf[k], 1e-12) for k in d_kf}
    ok = (max(ratio.values()) <= BF16_F32_RATIO and max(d_kv.values()) <= BF16_STEP_TOL
          and max(dec.values()) <= BF16_DECODER_TOL)
    print(f"{tag} gradients, RMS distance over the norm, largest: kernels vs their plain "
          f"versions {worst(d_kv)} (bound {BF16_STEP_TOL}), in the decoder {worst(dec)} "
          f"(bound {BF16_DECODER_TOL}); kernels vs plain float32 {worst(d_kf)}; plain bf16 vs "
          f"plain float32 {worst(d_pf)}; the ratio of the two {worst(ratio)} (bound "
          f"{BF16_F32_RATIO}) {'PASS' if ok else 'FAIL'}")
    return ok


def bf16_flagship_step(dev, partial, complete):
    """Phase 13 (b): the flagship's bf16 train step on one DecisionTape,
    through the kernels, through their plain versions in the kernels' place
    (``kernels_as_plain``), through the plain path (use_kernels off) in
    bf16 and in float32: ``bf16_step_check``, and a mutant (C''s bf16 dW x
    BF16_MUTANT) that must fail it.  Returns (config, model)."""
    import copy

    import torch

    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib, vn_layer_fused

    config = _smoke_config(lr=1e-4, rotation="so3")
    model = build_model(config).to(dev)
    plain = copy.deepcopy(model).use_kernels_(False)
    btag = "[bf16 train flagship step]"

    def run(m, policy):
        return bf16_step_grads(m, config, partial, complete, policy)

    orig = vn_layer_fused.layer_project_bwd

    def mutant_bwd(*a, **k):
        out = list(orig(*a, **k))
        out[1] = out[1] * BF16_MUTANT
        return tuple(out)

    project = vn_layer_fused.vn_layer_fused_project
    seen = []  # kernel C's arguments in the kernels' step

    def capture(*a, **k):
        seen.append((a, k))
        return project(*a, **k)

    with DecisionTape() as tape:
        tape.run()
        cuda_lib.reset_launch_counts()
        vn_layer_fused.vn_layer_fused_project = capture
        try:
            lk, bk, gk = run(model, torch.bfloat16)
        finally:
            vn_layer_fused.vn_layer_fused_project = project
        designs = cuda_lib.variant_counts()
        rec = tape.rec
        # kernel A's reflections are not replayed into the runs through the
        # kernels or their plain versions (a replayed side takes the tape's
        # own chain, not A and A'): A's plain version decides as A, bit for bit
        picks = {k: v for k, v in rec.items() if k[0] != "mask"}
        tape.run(picks)
        with kernels_as_plain():
            lv, bv, gv = run(model, torch.bfloat16)
        tape.run(rec)
        lp, _, gp = run(plain, torch.bfloat16)
        rec = {**rec, **tape.rec}
        tape.run(rec)
        l32, _, g32 = run(plain, torch.float32)
        vn_layer_fused.layer_project_bwd = mutant_bwd
        try:
            tape.run(picks)
            _, _, gm = run(model, torch.bfloat16)
        finally:
            vn_layer_fused.layer_project_bwd = orig
    # Kernel C on this step's own input to final_conv.1 + .2 against its
    # plain version in the kernel's order (p, d in the tensor cores' k16
    # steps, the projection in the kernel's order), and its p, d against the
    # k16 model's, in bits
    (args, kwargs), = seen
    with torch.no_grad():
        args = tuple(t.detach() if torch.is_tensor(t) else t for t in args)
        x, w, wd, pb, db, a, b, w_out, ns = args[:9]
        group = args[9] if len(args) > 9 else kwargs.get("group", 0)
        got = project(*args, **kwargs)
        order = vn_layer_fused.launch_order("C", x, w.shape[0], group)
        want = vn_layer_fused.reference_layer_fused_project(*args, **kwargs, order=order)
        fwd = forward_planes(x, w, wd, pb, db, a, b, w_out, group)
        t0 = time.time()
        pd_model = torch.stack([vn_layer_fused._products(w, x, pb, group, order),
                                vn_layer_fused._products(wd, x, db, group, order)])
        model_s = time.time() - t0
        model_differ = int((pd_model.view(torch.int16) != fwd.view(torch.int16)).sum())
    worst_ulp, differ = bf16_ulps(got, want)
    c_rms = bf16_rms(got, want)
    print(f"{btag} final_conv.1 + .2 on the step's own input: kernel C against its plain "
          f"version (p, d in {order} order): {differ} of {got.numel()} outputs differ, the "
          f"largest by {worst_ulp:.2f} bf16 ulp; RMS distance {c_rms:.3e} (bound "
          f"{BF16_C_RMS:.3e}); C's p, d against the k16 model's: {model_differ} of "
          f"{pd_model.numel()} elements differ (the model {model_s:.2f} s)")
    if c_rms > BF16_C_RMS or model_differ:
        raise AssertionError(f"{btag} kernel C parts from its plain version or its p, d from "
                             "the k16 model's")
    del pd_model, fwd
    print(f"{btag} C, S, S', C' and B' launches by design: {designs} (expected "
          f"{BF16_STEP_DESIGNS['flagship']})")
    if designs != BF16_STEP_DESIGNS["flagship"]:
        raise AssertionError(f"{btag} C, S, S', C' or B' took another design than expected")
    finite = all(torch.isfinite(t).all() for t in (lk, *bk.values(), *gk.values()))
    print(f"{btag} batch {BATCH}, losses (coarse, dense): kernels {lk.tolist()}, their plain "
          f"versions {lv.tolist()}, plain bf16 {lp.tolist()}, plain float32 {l32.tolist()}; "
          f"running statistics max|d| / max, kernels vs their plain versions: "
          f"{max(rel_errs(bk, bv).values()):.3e}")
    if not (finite and bf16_step_check(btag, gk, gv, gp, g32)):
        raise AssertionError(f"{btag} the bf16 kernel step disagrees with the plain path")
    d_kv = rms_errs(gk, gv)
    top = max(d_kv, key=d_kv.get)
    print(f"{btag} kernels vs their plain versions in the kernels' summation order: largest "
          f"{d_kv[top]:.4e} at {top} (the former in-order C' against plain versions in "
          f"input-channel order read 1.242e-2 there, PERF.md)")
    mutated = "decoder.final_conv.1.map_to_feat.weight"
    print(f"{btag} mutant: {mutated} lies {rms_errs(gm, gv)[mutated]:.3e} from the plain "
          f"versions' (unmutated kernels: {rms_errs(gk, gv)[mutated]:.3e})")
    if bf16_step_check(f"{btag} mutant (C' dW x {BF16_MUTANT})", gm, gv, gp, g32):
        raise AssertionError(f"{btag} the check misses C''s dW scaled by {BF16_MUTANT}")
    print(f"{btag} the mutant fails the check, as it must")

    return config, model


def bf16_train(dev, smi: str):
    """Phase 13: the bf16 policy's training path.  (a) ``train`` for
    BF16_TRAIN_EPOCHS epochs, then ``train --resume`` for one, on the root
    ``config.json`` (vn_pointr + attention_vn_foldingnet at 448, dtype
    bfloat16, batch 8) with ``dataset: synthetic`` at full width, counted:
    the launches equal the epochs' train steps (BF16_STEP_LAUNCHES) and
    validation forwards (BF16_FORWARD_LAUNCHES) exactly, so no float32-mode
    launch of A, A', B, B', C, C', S, S' or K3; one train step counted
    alone.  (b) The flagship's bf16 train step through the kernels, the
    plain bf16 path and the plain float32 path on one DecisionTape
    (``bf16_step_check``), and a mutant of C''s bf16 backward (dW x
    BF16_MUTANT) that must fail.  (c) CUDA-event medians of the float32 and
    bf16 train steps of both models, with peak memory.  Returns the launch
    counts of (a)'s counted runs, and their launches by design."""
    import torch

    from vn_pointcloudcompletion_tpu_torch import __main__ as cli
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.nn.precision import compute_dtype, compute_dtype_scope
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.training import steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    tag = "[bf16 train]"
    with open(os.path.join(ROOT, "config.json")) as f:
        root = json.load(f)
    if root["dtype"] != "bfloat16" or root["enc_type"] != "vn_pointr" or root["num_coarse"] != 448:
        raise AssertionError(f"{tag} the root config.json changed: {root}")
    full = _smoke_config("vn_pointr_448").extra  # the other phases' synthetic widths
    # one batch of training and one of validation samples: each epoch is one
    # step and one validation forward, as overfit's
    root.update(name="smoke_bf16", dataset="synthetic", num_workers=4, log_frequency=1,
                batch_size=BATCH, synthetic_n_partial=full["synthetic_n_partial"],
                synthetic_n_complete=full["synthetic_n_complete"],
                synthetic_train_samples=BATCH, synthetic_val_samples=BATCH)
    work = os.path.join(ROOT, "build", "chip_smoke_bf16")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump(root, f)
    os.environ["OUTPUT_DIR"] = os.path.join(work, "experiments")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        summary = cli.main(["-n", "smoke_bf16", "-epochs", str(BF16_TRAIN_EPOCHS - 1), "train"])
        (run,) = os.listdir(os.environ["OUTPUT_DIR"])
        resumed = cli.main(["-n", run, "--resume", "-epochs", str(BF16_TRAIN_EPOCHS), "train"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = {k: v for k, v in cuda_lib.launch_counts().items() if v}
        run_designs = cuda_lib.variant_counts()
        check_designs(f"{tag} root config.json train + resume", counts, run_designs,
                      "vn_pointr_448")
        check_stats_designs(f"{tag} root config.json train + resume", cuda_lib.variant_counts(),
                            bf16_designs(STATS_STEP_DESIGNS["vn_pointr_448"]),
                            BF16_TRAIN_EPOCHS + 1)
    finally:
        os.chdir(cwd)
    exp_dir = os.path.join(os.environ["OUTPUT_DIR"], run)
    epochs = BF16_TRAIN_EPOCHS + 1
    want = {k: epochs * (BF16_STEP_LAUNCHES["vn_pointr_448"].get(k, 0)
                         + BF16_FORWARD_LAUNCHES["vn_pointr_448"].get(k, 0))
            for k in BF16_STEP_LAUNCHES["vn_pointr_448"]}
    got = {k: v for k, v in counts.items() if k != "chamfer_nn_bidir"}
    print(f"{tag} root config.json: train {BF16_TRAIN_EPOCHS} epochs + resume 1 of one step + "
          f"one validation batch: {t1 - t0:.3f} s (host clock); launches {json.dumps(counts)}")
    if got != want or compute_dtype() != torch.float32:
        raise AssertionError(f"{tag} launches {got}, expected {want}")
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train = [r["value"] for r in rows if r["split"] == "train" and r["tag"] == "Loss/Epoch/Total"]
    print(f"{tag} train total loss per epoch (x1e3): {train}")
    if (len(train) != epochs or not all(math.isfinite(r["value"]) for r in rows)
            or summary["epochs_run"] != BF16_TRAIN_EPOCHS or resumed["epochs_run"] != 1):
        raise AssertionError(f"{tag} bad run: {train}, {summary}, {resumed}")
    with open(os.path.join(exp_dir, "train.log")) as f:
        if "[RESUME INFO] resume ckpts @ %d epoch" % (BF16_TRAIN_EPOCHS - 1) not in f.read():
            raise AssertionError(f"{tag} train --resume did not continue the run")
    saved = torch.load(os.path.join(exp_dir, "models", "model_last.pth"), weights_only=True)
    if any(t.dtype not in (torch.float32, torch.int64) for t in saved.values()):
        raise AssertionError(f"{tag} the checkpoint is not float32")
    shutil.rmtree(work, ignore_errors=True)

    partial, complete, rot = main_path_batch(dev)
    pointr_config = Config.from_dict(dict(root, rotation="none"))
    pointr = build_model(pointr_config).to(dev)
    state = create_train_state(pointr, pointr_config, 1)
    with compute_dtype_scope(torch.bfloat16):
        steps.train_step(state, partial, complete, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        metrics = steps.train_step(state, partial, complete, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
    step_counts = {k: v for k, v in cuda_lib.launch_counts().items()
                   if v and k != "chamfer_nn_bidir"}
    designs = cuda_lib.variant_counts()
    print(f"{tag} one vn_pointr_448 train step: launches {json.dumps(step_counts)}; "
          f"C, S, S', C', B', F and K3 by design {json.dumps(designs)}; skipped "
          f"{metrics['skipped'].item()}")
    if step_counts != BF16_STEP_LAUNCHES["vn_pointr_448"] or metrics["skipped"].item():
        raise AssertionError(f"{tag} one step's launches {step_counts}, expected "
                             f"{BF16_STEP_LAUNCHES['vn_pointr_448']}")
    if designs != BF16_STEP_DESIGNS["vn_pointr_448"]:
        raise AssertionError(f"{tag} one step's designs {designs}, expected "
                             f"{BF16_STEP_DESIGNS['vn_pointr_448']}")
    total = {k: counts.get(k, 0) + step_counts.get(k, 0) for k in {*counts, *step_counts}}
    total.update({k: run_designs.get(k, 0) + designs.get(k, 0)  # by design: ``<name>/<design>``
                  for k in {*run_designs, *designs}})

    # (b) the flagship's bf16 step on one tape
    config, model = bf16_flagship_step(dev, partial, complete)

    # (c) float32 and bf16 step times of both models through the kernels
    for name, m, cfg in (("flagship", model, config), ("vn_pointr_448", pointr, pointr_config)):
        ms, gib = {}, {}
        for dt in (torch.float32, torch.bfloat16, torch.float32, torch.bfloat16):
            t_ms, _, gib[dt], _ = step_cost(m, cfg, partial, complete, dt)
            ms.setdefault(dt, []).append(t_ms)
        print(f"[bf16 train step] {name}, batch {BATCH}, {smi}: median of 5 steps after 2 "
              f"warm-up (CUDA events), float32 then bf16, twice: float32 "
              f"{' / '.join(f'{t:.3f}' for t in ms[torch.float32])} ms, bf16 "
              f"{' / '.join(f'{t:.3f}' for t in ms[torch.bfloat16])} ms; peak memory float32 "
              f"{gib[torch.float32]:.2f} GiB, bf16 {gib[torch.bfloat16]:.2f} GiB")
    return total


def remat_launches(counts: dict) -> dict:
    """A remat step's launches (or launches by design) from a plain step's:
    the REMAT_FORWARD kernels' twice, every other kernel's once."""
    return {k: v * (2 if k.split("/")[0].split("[")[0] in REMAT_FORWARD else 1)
            for k, v in counts.items() if v}


def remat_step_runs(model, config, partial, complete, policy=None):
    """One guarded train step (the rotation from seed 0) of a copy of
    ``model`` each: without ``remat``, with it, and without it again, under
    the compute policy ``policy`` (the step's backward, where the
    recomputation runs, inside it too).  Each run: (losses, gradients,
    state_dict after the update, launches, launches by design), every
    tensor a copy."""
    import copy

    import torch

    from vn_pointcloudcompletion_tpu_torch.nn.precision import compute_dtype_scope
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.training import steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state

    runs = []
    for remat in (False, True, False):
        m = copy.deepcopy(model)
        state = create_train_state(m, config.replace(remat=remat), 1)
        cuda_lib.reset_launch_counts()
        with compute_dtype_scope(policy or torch.float32):
            metrics = steps.train_step(state, partial, complete, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        if metrics["skipped"].item():
            raise AssertionError(f"the train step (remat {remat}) was skipped")
        runs.append((torch.stack([metrics["coarse"], metrics["dense"]]).detach().clone(),
                     {k: p.grad.clone() for k, p in m.named_parameters() if p.grad is not None},
                     {k: t.clone() for k, t in m.state_dict().items()},
                     {k: v for k, v in cuda_lib.launch_counts().items() if v},
                     {k: v for k, v in cuda_lib.variant_counts().items() if v}))
    return runs


def check_remat(tag: str, runs) -> dict:
    """Print and check the remat step against the plain step
    (``remat_step_runs``): every tensor (the losses, each gradient, each
    parameter after the update, each running statistic) equal in bits;
    only where the plain step does not repeat its own bits either (a kernel
    or library call that does not) is a tensor held to STEP_TOL of its max
    instead.  The launches and the designs: the plain step's with the
    forward's doubled.  Returns the unequal tensors' max|d| / max."""
    import torch

    (lp, gp, sp, cp, vp), (lr, gr, sr, cr, vr), (lp2, gp2, sp2, _, _) = runs
    if set(gp) != set(gr) or set(gp) != set(gp2):
        raise AssertionError(f"{tag} the remat and plain steps gave gradients of other parameters")
    tensors = {"losses": (lp, lr, lp2), **{f"grad {k}": (gp[k], gr[k], gp2[k]) for k in gp},
               **{k: (sp[k], sr[k], sp2[k]) for k in sp}}

    def rel(a, b):
        scale = b.abs().max().item()
        e = (a.double() - b.double()).abs().max().item()
        return e / scale if scale > 0 else float("inf")

    unequal = {k: rel(r, p) for k, (p, r, _) in tensors.items() if not torch.equal(p, r)}
    unrepeated = [k for k, (p, _, p2) in tensors.items() if not torch.equal(p, p2)]
    print(f"{tag} remat step against the plain step: {len(tensors) - len(unequal)} of "
          f"{len(tensors)} tensors (losses, gradients, parameters after the update, running "
          f"statistics) equal in bits; the plain step against itself: "
          f"{len(tensors) - len(unrepeated)} equal")
    if unequal:
        print(f"{tag} not equal in bits, max|d| / max: {worst(unequal, 5)}; not repeated by the "
              f"plain step: {unrepeated[:5]} (tolerance {STEP_TOL} where the plain step does not "
              "repeat its bits, else 0)")
        bits = [k for k in unequal if k not in unrepeated]
        loose = [k for k in unequal if k in unrepeated and unequal[k] > STEP_TOL]
        if bits or loose:
            raise AssertionError(f"{tag} the remat step disagrees with the plain step: not "
                                 f"equal in bits where the plain step repeats them: {bits}; "
                                 f"beyond {STEP_TOL} where it does not: {loose}")
    print(f"{tag} launches: plain {json.dumps(cp)}; remat {json.dumps(cr)}")
    if cr != remat_launches(cp) or vr != remat_launches(vp):
        raise AssertionError(f"{tag} remat launches {cr} / {vr}, expected the plain step's "
                             f"with the forward kernels' doubled: {remat_launches(cp)} / "
                             f"{remat_launches(vp)}")
    return unequal


def remat_cost(tag: str, smi: str, model, config, dev, policy=None) -> None:
    """Peak device memory and step time of the plain and the remat step at
    batch 8 and 16, in the order plain, remat, plain, remat at each batch
    (``utils/profiling.py``: the allocator's peak, reset before each
    reading; CUDA-event and host-clock medians of 5 steps after 2 warm-up
    steps, each step ending in its one host read)."""
    import torch

    for b in (BATCH, 2 * BATCH):
        partial, complete = synthetic_batch(dev, b)
        readings = {False: [], True: []}
        for remat in (False, True, False, True):
            readings[remat].append(step_cost(model, config.replace(remat=remat), partial,
                                             complete, policy))
        for remat, rs in readings.items():
            print(f"{tag} batch {b}, remat {remat}, {smi}: step (CUDA events, median of 5 "
                  f"after 2 warm-up) {' / '.join(f'{r[0]:.3f}' for r in rs)} ms, host clock "
                  f"{' / '.join(f'{r[1]:.3f}' for r in rs)} ms; peak device memory "
                  f"{' / '.join(f'{r[2]:.3f}' for r in rs)} GiB, of which above the weights "
                  f"and optimiser state {' / '.join(f'{r[3]:.3f}' for r in rs)} GiB")
        del partial, complete
        torch.cuda.empty_cache()


def remat_flagship(dev, smi: str):
    """Phase 14a: ``remat`` on the flagship in float32 at full width."""
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model

    tag = "[remat flagship]"
    config = _smoke_config(lr=1e-4, rotation="so3")
    model = build_model(config).to(dev)
    partial, complete = synthetic_batch(dev, BATCH)
    runs = remat_step_runs(model, config, partial, complete)
    plain_designs = runs[0][4]
    if plain_designs != FLAGSHIP_STEP_DESIGNS:
        raise AssertionError(f"{tag} the plain step's designs {plain_designs}, expected "
                             f"{FLAGSHIP_STEP_DESIGNS}")
    missing = [k for k in FLAGSHIP_KERNELS if not runs[1][3].get(k)]
    if missing:
        raise AssertionError(f"{tag} kernels not launched in the remat step: {missing}")
    check_remat(tag, runs)
    del runs
    remat_cost(tag, smi, model, config, dev)


def remat_root_config(dev, smi: str):
    """Phase 14b: ``remat`` on the root ``config.json`` (vn_pointr_448) under
    its bf16 policy, at full width: no float32-mode launch."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    tag = "[remat root config.json bf16]"
    with open(os.path.join(ROOT, "config.json")) as f:
        root = json.load(f)
    if root["dtype"] != "bfloat16" or root["enc_type"] != "vn_pointr":
        raise AssertionError(f"{tag} the root config.json changed: {root}")
    config = Config.from_dict(dict(root, batch_size=BATCH, dataset="synthetic"))
    model = build_model(config).to(dev)
    partial, complete = synthetic_batch(dev, BATCH)
    runs = remat_step_runs(model, config, partial, complete, torch.bfloat16)
    plain = {k: v for k, v in runs[0][3].items() if k != "chamfer_nn_bidir"}
    if plain != BF16_STEP_LAUNCHES["vn_pointr_448"]:
        raise AssertionError(f"{tag} the plain step's launches {plain}, expected "
                             f"{BF16_STEP_LAUNCHES['vn_pointr_448']}")
    check_remat(tag, runs)
    del runs
    remat_cost(tag, smi, model, config, dev, torch.bfloat16)


@contextlib.contextmanager
def cli_workdir(name: str, config):
    """A work dir under ``build/`` holding ``config`` as its config.json,
    the working directory and ``OUTPUT_DIR`` (its ``experiments/``) for
    the CLI calls inside; removed afterwards.  Yields the work dir."""
    work = os.path.join(ROOT, "build", name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump(config.to_dict(), f)
    os.environ["OUTPUT_DIR"] = os.path.join(work, "experiments")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        yield work
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


def pretrained_encoder_cli(dev):
    """Phase 14c: ``--ckpt_path <phase 5's model_best.pth> -epochs 2
    overfit`` on the flagship: the encoder equal to the file's bits
    afterwards, its running statistics and the decoder moved, the nine
    training kernels launched."""
    import torch

    from vn_pointcloudcompletion_tpu_torch import __main__ as cli
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    tag = "[pretrained encoder]"
    config = _smoke_config(name="smoke_pretrained", lr=3e-4, rotation="so3", log_frequency=1)
    with cli_workdir("chip_smoke_pretrained", config) as work:
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        summary = cli.main(["-n", "smoke_pretrained", "--ckpt_path", PRETRAINED, "-epochs", "2",
                            "overfit"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = cuda_lib.launch_counts()
        (run,) = os.listdir(os.path.join(work, "experiments"))
        exp_dir = os.path.join(work, "experiments", run)
        trained = torch.load(os.path.join(exp_dir, "models", "model_last.pth"), weights_only=True)
        with open(os.path.join(exp_dir, "config.json")) as f:
            stored = Config.from_dict(json.load(f))
        with open(os.path.join(exp_dir, "overfit.log")) as f:
            loaded = f"Loaded pretrained encoder from {PRETRAINED}" in f.read()
    pretrained = torch.load(PRETRAINED, weights_only=True)
    init = build_model(stored).state_dict()
    frozen = [k for k in trained if k.startswith("encoder.") and "running" not in k]
    stats = [k for k in trained if k.startswith("encoder.") and "running" in k]
    decoder = [k for k in trained if k.startswith("decoder.") and "running" not in k]
    unequal = [k for k in frozen if not torch.equal(trained[k], pretrained[k])]
    still = [k for k in stats if torch.equal(trained[k], pretrained[k])]
    unmoved = [k for k in decoder if torch.equal(trained[k], init[k])]
    print(f"{tag} overfit 3 epochs with phase 5's model_best.pth as the encoder: "
          f"{t1 - t0:.3f} s (host clock); {len(frozen) - len(unequal)} of {len(frozen)} encoder "
          f"parameters equal to the file's bits; {len(stats) - len(still)} of {len(stats)} "
          f"encoder running statistics moved; {len(decoder) - len(unmoved)} of {len(decoder)} "
          f"decoder parameters moved; launches {json.dumps({k: v for k, v in counts.items() if v})}")
    missing = [k for k in FLAGSHIP_KERNELS if counts[k] == 0]
    if (unequal or still or unmoved or missing or not loaded or summary["epochs_run"] != 3
            or stored.enc_pretrained != PRETRAINED):
        raise AssertionError(f"{tag} frozen encoder changed {unequal[:3]}, statistics unmoved "
                             f"{still[:3]}, decoder unmoved {unmoved[:3]}, kernels not "
                             f"launched {missing}, loaded {loaded}, {summary}")


def branch_cli(dev):
    """Phase 14d: a flagship source run with ``checkpoint_every 1`` (epochs
    0 and 1), then ``-n <source> -from 1 -epochs 3 train``: the branched
    run holds a byte copy of the pair ``model_1`` / ``optim_1`` at its
    first step, whose weights are the pair's, logs ``[BRANCH INFO]`` and
    trains epochs 2 and 3; ``-from 7`` raises FileNotFoundError."""
    import torch

    from vn_pointcloudcompletion_tpu_torch import __main__ as cli
    from vn_pointcloudcompletion_tpu_torch.training import trainer

    tag = "[-from]"
    config = _smoke_config(name="smoke_source", lr=3e-4, rotation="so3", log_frequency=1,
                           checkpoint_every=1)
    pair = (("models", "model_1.pth"), ("optimizer", "optim_1.pth"))
    first = []  # the first step's weights and the new run's copy of the pair
    step = trainer.train_step

    def spy(state, *args):
        if not first:
            exp = state.config.exp_dir
            weights = {k: t.detach().cpu().clone() for k, t in state.model.state_dict().items()}
            copied = []
            for sub, name in pair:
                with open(os.path.join(exp, sub, name), "rb") as f:
                    copied.append(f.read())
            first.append((weights, copied))
        return step(state, *args)

    with cli_workdir("chip_smoke_branch", config) as work:
        experiments = os.path.join(work, "experiments")
        t0 = time.perf_counter()
        cli.main(["-n", "smoke_source", "-epochs", "1", "overfit"])
        (source,) = os.listdir(experiments)
        trainer.train_step = spy
        try:
            summary = cli.main(["-n", source, "-from", "1", "-epochs", "3", "train"])
        finally:
            trainer.train_step = step
        t1 = time.perf_counter()
        (branched,) = [r for r in os.listdir(experiments) if r != source]
        originals = []
        for sub, name in pair:
            with open(os.path.join(experiments, source, sub, name), "rb") as f:
                originals.append(f.read())
        saved = torch.load(os.path.join(experiments, source, "models", "model_1.pth"),
                           weights_only=True)
        with open(os.path.join(experiments, branched, "train.log")) as f:
            log = f.read()
        last = torch.load(os.path.join(experiments, branched, "optimizer", "optim_last.pth"),
                          weights_only=True)
        try:
            cli.main(["-n", source, "-from", "7", "train"])
            refused = ""
        except FileNotFoundError as e:
            refused = str(e)
    weights, copied = first[0]
    same_weights = all(torch.equal(weights[k], saved[k]) for k in saved)
    print(f"{tag} source 2 epochs + branch from epoch 1 to 3: {t1 - t0:.3f} s (host clock); "
          f"pair copied byte for byte: {copied == originals}; first step from the pair's "
          f"weights: {same_weights}; [BRANCH INFO] logged: {'[BRANCH INFO]' in log}; epochs "
          f"run {summary['epochs_run']}, last epoch {last['epoch']}; -from 7: {refused!r}")
    if not (copied == originals and same_weights and "[BRANCH INFO] new run" in log
            and "Training Epoch [002/003]" in log and "Training Epoch [001/003]" not in log
            and summary["epochs_run"] == 2 and last["epoch"] == 3
            and "checkpoint_every" in refused):
        raise AssertionError(f"{tag} the branched run is not the source's epoch 1 continued")


MESH_EPOCHS = 1  # phase 16a: epochs 0 and 1 of two train steps each
MESH_TIMEOUT_S = 300  # phase 16b: every collective of a rank, and the ranks' join
# Phase 16b, two ranks against one process on one tape, each gradient's
# max|dg| / max|g| (measured 3.31e-3 at encoder.second_conv.0, NVIDIA H100
# 80GB HBM3, 700 W).  Not phase 5b's STEP_TOL: there the encoder is the
# same bits on both paths, here its BatchNorm sums are split over ranks,
# and the float32 E[n^2] - E[n]^2 of the norms moves its gradients as far
# as float32 moves the plain path from float64 (5b: 2.9e-3 in the
# decoder).  The float64 ratio (DGCNN_F64_RATIO) is the test of accuracy.
# Both bounds sit between the sound step and the controls of MESH_FAULTS,
# which break the step (same card, on the same tape): the gap 3.31e-3
# sound, 2.52 with per-rank BatchNorm statistics, 4.02 with the sums'
# cotangents not all-reduced; the float64 ratio 4.08, 1.59e4, 4.95e3.
MESH_STEP_TOL = 7e-3
MESH_FAULTS = ("local_stats", "unreduced_cotangents")  # phase 16b's controls


def mesh_world_one(dev, smi: str):
    """Phase 16a: ``train --mesh 1`` (one rank, NCCL) at full width on the
    flagship, counted as phase 5 counts (every flagship kernel launched, B,
    C, B', S by design for each step), then ``--resume test``; the same run
    without ``--mesh`` ends with the same bits in every parameter and
    buffer.  Then the step at world size 1 against the step without a mesh,
    in turns (CUDA events), and the gradient all-reduce alone.  Returns the
    run's launches."""
    import torch

    from vn_pointcloudcompletion_tpu_torch import __main__ as cli
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.parallel.mesh import (
        destroy_mesh,
        free_port,
        make_mesh,
        mean_over_ranks,
    )

    tag = "[mesh 1]"
    config = _smoke_config(name="smoke_mesh", lr=3e-4, rotation="so3", val_rotation="so3",
                           test_rotation="so3", log_frequency=1,
                           synthetic_train_samples=2 * BATCH, synthetic_val_samples=BATCH,
                           synthetic_test_samples=BATCH)
    steps_run = 2 * (MESH_EPOCHS + 1)
    with cli_workdir("chip_smoke_mesh", config) as work:
        experiments = os.path.join(work, "experiments")
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        summary = cli.main(["-n", "mesh", "-epochs", str(MESH_EPOCHS), "--mesh", "1", "train"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts, variants = cuda_lib.launch_counts(), cuda_lib.variant_counts()
        (run,) = os.listdir(experiments)
        table = cli.main(["-n", run, "--resume", "test"])
        t2 = time.perf_counter()
        plain_summary = cli.main(["-n", "nomesh", "-epochs", str(MESH_EPOCHS), "train"])
        t3 = time.perf_counter()
        (other,) = [r for r in os.listdir(experiments) if r != run]
        last = [torch.load(os.path.join(experiments, r, "models", "model_last.pth"),
                           weights_only=True) for r in (run, other)]
        with open(os.path.join(experiments, run, "train.log")) as f:
            log = f.read()
    unequal = [k for k in last[1] if not torch.equal(last[0][k], last[1][k])]
    print(f"{tag} train --mesh 1, {MESH_EPOCHS + 1} epochs of 2 steps + validation: "
          f"{t1 - t0:.3f} s; --resume test: {t2 - t1:.3f} s; the same run without --mesh: "
          f"{t3 - t2:.3f} s (host clock, checkpoint writes included)")
    print(f"{tag} launches: {json.dumps(counts)}")
    check_designs(f"{tag} train", counts, variants, "flagship")
    check_stats_designs(f"{tag} train", variants, STATS_STEP_DESIGNS["flagship"], steps_run)
    missing = [k for k in FLAGSHIP_KERNELS if counts[k] == 0]
    row = table["synthetic"]
    print(f"{tag} {len(last[1]) - len(unequal)} of {len(last[1])} parameters and buffers "
          f"equal in bits to the run without --mesh; --resume test: {json.dumps(row)}")
    if (missing or unequal or summary != plain_summary or summary["epochs_run"] != MESH_EPOCHS + 1
            or "Training Epoch [001/001]" not in log
            or not all(math.isfinite(v) for v in row.values())):
        raise AssertionError(f"{tag} kernels not launched {missing}, unequal {unequal[:3]}, "
                             f"{summary} vs {plain_summary}, row {row}")

    model = build_model(config).to(dev)
    partial, complete = synthetic_batch(dev, BATCH)
    mesh = make_mesh(0, 1, f"tcp://localhost:{free_port()}", dev.type)
    try:
        times = [step_cost(model, config, partial, complete, mesh=m)[0]
                 for m in (None, mesh, mesh, None)]
        grads = [torch.randn_like(p) for p in model.parameters()]
        losses = [torch.ones((), device=dev)] * 3
        reduce_ms = cuda_ms(lambda: mean_over_ranks(mesh, grads, losses), 20)
    finally:
        destroy_mesh()
    n = sum(g.numel() for g in grads)
    print(f"{tag} {smi}: train step at batch {BATCH}, median of 5 after 2 warm-up (CUDA "
          f"events): without a mesh {times[0]:.3f} ms, {times[3]:.3f} ms; world size 1 (NCCL) "
          f"{times[1]:.3f} ms, {times[2]:.3f} ms; the gradient all-reduce alone ({n} "
          f"float32 + 3 losses, concatenated, reduced, divided, copied back) {reduce_ms:.3f} ms",
          flush=True)
    return {**counts, **variants}


def digest(tensors: dict) -> dict:
    """Each tensor's bits as a hash, by name: equal bits across ranks."""
    import hashlib

    import torch

    return {k: hashlib.sha256(t.detach().cpu().reshape(-1).view(torch.uint8).numpy()
                              .tobytes()).hexdigest() for k, t in tensors.items()}


def tape_rows(value, rank: int, n: int, device):
    """A recorded decision's rows of one rank, on its device (every
    decision of the flagship's step is batch-first; the chamfer's is a
    pair)."""
    if isinstance(value, tuple):
        return tuple(tape_rows(v, rank, n, device) for v in value)
    return value[rank * n:(rank + 1) * n].to(device)


def inject_mesh_fault(fault: str) -> None:
    """Break this rank's data-parallel step as phase 16b's controls do, in
    this process only: "local_stats", every train-mode BatchNorm normalises
    with its own rank's rows (a per-rank DDP); "unreduced_cotangents", the
    BatchNorm sums' all-reduce keeps its forward but its backward does not
    sum the cotangents over ranks."""
    from vn_pointcloudcompletion_tpu_torch.models import common
    from vn_pointcloudcompletion_tpu_torch.nn import vn
    from vn_pointcloudcompletion_tpu_torch.parallel import mesh

    if fault == "local_stats":
        vn.global_sums = common.global_sums = lambda s1, s2, count: (s1, s2, count)
    elif fault == "unreduced_cotangents":
        mesh._AllReduceSum.backward = staticmethod(lambda ctx, g: g)
    else:
        raise ValueError(f"unknown fault {fault!r}")


def mesh_rank(rank, world, init, device, config, partial, complete, out_dir, reps,
              fault=None):
    """Phase 16b: one of ``world`` ranks on one card over gloo (CUDA
    tensors; NCCL refuses two ranks on one GPU).  The model of ``config``
    from its seed (rank 0's state broadcast), the rank's rows of the global
    batch ``partial``, ``complete``, the rotations from seed 1: one step on
    the rank's rows of the one-process step's DecisionTape
    (``out_dir/tape.pt``), whose gradients (rank 0) and hashes of
    everything after it (each rank) go to ``out_dir``; then ``reps`` steps
    timed (host clock to the step's host read) and counted (launches a
    step), and ``reps`` more with every all-reduce timed between two
    synchronisations.  ``fault``: the step broken as
    :func:`inject_mesh_fault` says, its files named after it."""
    from datetime import timedelta

    import torch

    sys.path.insert(0, ROOT)
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.parallel.mesh import (
        data_sharding,
        destroy_mesh,
        make_mesh,
    )
    from vn_pointcloudcompletion_tpu_torch.parallel.train_parallel import (
        make_parallel_steps,
        shard_state,
    )
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state

    if fault is not None:
        inject_mesh_fault(fault)
    suffix = "" if fault is None else f"_{fault}"

    mesh = make_mesh(rank, world, init, device, backend="gloo",
                     timeout=timedelta(seconds=MESH_TIMEOUT_S))
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    try:
        model = build_model(config).to(mesh.device)
        state = shard_state(create_train_state(model, config, 1), mesh)
        train_step, _ = make_parallel_steps(config, mesh)
        partial, complete = (data_sharding(mesh, t).to(mesh.device) for t in (partial, complete))
        gen = torch.Generator().manual_seed(1)
        recorded = torch.load(os.path.join(out_dir, "tape.pt"), weights_only=False)
        with DecisionTape() as tape:
            tape.run({k: [tape_rows(v, rank, partial.shape[0], mesh.device) for v in vs]
                      for k, vs in recorded.items()})
            m = train_step(state, partial, complete, gen)
        grads = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()
                 if p.grad is not None}
        adam = {f"{k}.{n}": t for k, p in model.named_parameters()
                for n, t in state.optimizer.state.get(p, {}).items()}
        hashes = {"metrics": {k: float(v) for k, v in m.items()}, "grads": digest(grads),
                  "state": digest(model.state_dict()), "adam": digest(adam)}
        if rank == 0:
            torch.save({"grads": grads, "metrics": hashes["metrics"]},
                       os.path.join(out_dir, f"grads0{suffix}.pt"))
        timing = time_mesh_steps(train_step, state, partial, complete, gen, reps, sync)
    finally:
        destroy_mesh()
    hashes["launches"], step_ms, timed_ms, spent = timing
    with open(os.path.join(out_dir, f"rank{rank}{suffix}.json"), "w") as f:
        json.dump({**hashes, "step_ms": step_ms, "timed_ms": timed_ms, "reduces": spent}, f)


def time_mesh_steps(train_step, state, partial, complete, gen, reps: int, sync):
    """Phase 16b's timing on one rank: ``reps`` steps timed (host clock to
    the step's host read) and counted, then ``reps`` more with every
    all-reduce timed between two synchronisations.  Returns (launches a
    step, step ms, step ms with the all-reduces timed, each step's
    all-reduces as (ms, values)); nothing where ``reps`` is 0."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib

    if not reps:
        return {}, [], [], []
    step_ms, timed_ms, spent = [], [], []
    cuda_lib.reset_launch_counts()
    for _ in range(reps):
        t0 = time.perf_counter()
        train_step(state, partial, complete, gen)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v // reps for k, v in cuda_lib.launch_counts().items() if v}
    reduce = torch.distributed.all_reduce

    def timed(t, *a, **k):
        sync()
        t0 = time.perf_counter()
        out = reduce(t, *a, **k)
        sync()
        spent[-1].append(((time.perf_counter() - t0) * 1e3, t.numel()))
        return out

    torch.distributed.all_reduce = timed
    try:
        for _ in range(reps):
            spent.append([])
            t0 = time.perf_counter()
            train_step(state, partial, complete, gen)
            timed_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.distributed.all_reduce = reduce
    return launches, step_ms, timed_ms, spent


def one_process_step(model, config, partial, complete, out_dir):
    """The one-process step that phase 16b's ranks are held to, its
    decisions recorded (DecisionTape) to ``out_dir/tape.pt`` for the ranks
    to replay: (metrics, gradients)."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.training import steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state

    with DecisionTape() as tape:
        tape.run()
        m = steps.train_step(create_train_state(model, config, 1), partial, complete,
                             torch.Generator().manual_seed(1))
    cpu = lambda v: tuple(map(cpu, v)) if isinstance(v, tuple) else v.cpu()  # noqa: E731
    torch.save({k: [cpu(v) for v in vs] for k, vs in tape.rec.items()},
               os.path.join(out_dir, "tape.pt"))
    return m, {k: p.grad for k, p in model.named_parameters() if p.grad is not None}, tape.rec


def mesh_two_ranks(dev, smi: str):
    """Phase 16b: two ranks sharing the card over gloo, global batch 16 (8 a
    rank): the first step's gradients against the one-process step at batch
    16 on the same card (the same weights, batch and rotations) and tape
    (the ranks replay their rows of its discrete decisions: otherwise the
    encoder's BatchNorm sums, split over ranks, round otherwise and flip
    argmax pools whose top two lie within float32 rounding), within
    MESH_STEP_TOL of each tensor's max, and each tensor no further from the
    float64 plain step on that tape than DGCNN_F64_RATIO x the one-process
    step is (phase 7b's test); parameters, buffers and Adam's state equal
    in bits on the two ranks; the step times of both, and the time in the
    all-reduces.  Then the controls: the same two-rank step broken as
    :func:`inject_mesh_fault` says (per-rank BatchNorm statistics; the sums'
    cotangents not summed over ranks) must fail one of the two bounds, or
    the bounds could not tell the step from those faults."""
    import copy

    import torch

    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.parallel.mesh import spawn_ranks

    tag = "[mesh 2 gloo]"
    world, reps = 2, 5
    config = _smoke_config(lr=1e-4, rotation="so3", batch_size=world * BATCH)
    model = build_model(config).to(dev)
    plain = copy.deepcopy(model).use_kernels_(False)
    partial, complete = synthetic_batch(dev, world * BATCH)
    out_dir = os.path.join(ROOT, "build", "chip_smoke_mesh2")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    m, want, rec = one_process_step(model, config, partial, complete, out_dir)
    with DecisionTape() as tape:  # the float64 reference on the same tape (phase 7b)
        tape.run(rec)
        step_grads(plain, config, partial, complete, torch.float32)
        tape.run({**rec, **tape.rec})
        g64 = step_grads(plain, config, partial, complete, torch.float64)[2]
    del plain, rec
    single_ms = step_cost(model, config, partial, complete)[0]
    del model
    torch.cuda.empty_cache()

    device = "cuda:0" if dev.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    spawn_ranks(mesh_rank, world, device, config, partial.cpu(), complete.cpu(), out_dir, reps,
                deadline=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    controls = {}
    for fault in MESH_FAULTS:
        spawn_ranks(mesh_rank, world, device, config, partial.cpu(), complete.cpu(), out_dir,
                    0, fault, deadline=MESH_TIMEOUT_S)
        bad = torch.load(os.path.join(out_dir, f"grads0_{fault}.pt"), weights_only=True)
        controls[fault] = check_on_one_tape(
            f"{tag} control, {fault} (k) vs one process (plain column), on one tape:",
            {k: g.to(dev).double() for k, g in bad["grads"].items()},
            {k: g.double() for k, g in want.items()}, g64, tol=MESH_STEP_TOL)
    caught = {fault: not passed for fault, passed in controls.items()}
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    got = torch.load(os.path.join(out_dir, "grads0.pt"), weights_only=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    grads = {k: g.to(dev).double() for k, g in got["grads"].items()}
    close = check_on_one_tape(f"{tag} two ranks (k) vs one process (plain column), on one "
                              "tape:", grads, {k: g.double() for k, g in want.items()}, g64,
                              tol=MESH_STEP_TOL)
    errs = rel_errs(grads, {k: g.double() for k, g in want.items()})
    loss_err = max(abs(got["metrics"][k] - float(m[k])) / abs(float(m[k]))
                   for k in ("coarse", "dense"))
    same = {k: ranks[0][k] == ranks[1][k] for k in ("metrics", "grads", "state", "adam")}
    missing = [k for k in FLAGSHIP_KERNELS for rank in ranks if not rank["launches"].get(k)]
    print(f"{tag} spawn to exit of both ranks: {wall:.1f} s; rank 0's step against one "
          f"process at batch {world * BATCH}: losses rel err {loss_err:.3e}, gradients "
          f"max|dg| / max|g| largest: {worst(errs)} (tolerance {MESH_STEP_TOL}); equal in bits "
          f"on both ranks: {json.dumps(same)}; rank 0's launches a step (untaped): "
          f"{json.dumps(ranks[0]['launches'])}")
    for r, rank in enumerate(ranks):
        per_step = [sum(ms for ms, _ in step) for step in rank["reduces"]]
        grad = [max(step, key=lambda x: x[1])[0] for step in rank["reduces"]]
        print(f"{tag} {smi}: rank {r}: step {statistics.median(rank['step_ms']):.3f} ms "
              f"(median of {reps}, host clock to the step's host read; steps "
              f"{', '.join(f'{x:.1f}' for x in rank['step_ms'])}); with every all-reduce "
              f"timed between two synchronisations: step "
              f"{statistics.median(rank['timed_ms']):.3f} ms, in all-reduces "
              f"{statistics.median(per_step):.3f} ms a step "
              f"({len(rank['reduces'][0])} a step: the gradients' {statistics.median(grad):.3f} "
              f"ms, {rank['reduces'][0][-1][1]} values)")
    print(f"{tag} {smi}: one process at batch {world * BATCH}: {single_ms:.3f} ms a step "
          f"(CUDA events, median of 5)")
    print(f"{tag} the controls fail the bounds: {json.dumps(caught)}")
    if missing or not (all(same.values()) and close and loss_err <= 1e-4):
        raise AssertionError(f"{tag} the two-rank step is not the one-process step")
    if not all(caught.values()):
        raise AssertionError(f"{tag} the bounds pass a broken step: {caught}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; allow_tf32: matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}; allow_bf16_reduced_precision_reduction "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}", flush=True)

    t0 = time.perf_counter()
    reports = cuda_lib.build_all()
    print(f"[build] {len(reports)} sources in {time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t:.1f} s wall", flush=True)
        return out

    records = phase("3 kernels", check_kernels, dev)
    knn_counts = phase("3b knn() at D 768 (K1)", knn_wide_path, dev)
    phase("4 flagship serve", serve_path, dev)
    counts = phase("5 flagship train", train_path, dev, "flagship", 0, PRETRAINED)
    phase("5b flagship train step", train_step_kernels_vs_plain, dev, smi)
    phase("6 VN DGCNN serve", serve_path, dev, "vn_dgcnn")
    dgcnn_counts = phase("7 VN DGCNN train", train_path, dev, "vn_dgcnn")
    phase("7b VN DGCNN train step", dgcnn_train_step, dev, smi)
    phase("8 DGCNN num_coarse 448 serve", serve_path, dev, "dgcnn_448")
    phase("8 DGCNN num_coarse 448 train", train_path, dev, "dgcnn_448")
    phase("8b DGCNN num_coarse 448 train step", scalar_train_step, dev, smi)
    phase("9 vn_pointr num_coarse 448 serve", serve_path, dev, "vn_pointr_448")
    pointr_counts = phase("9 vn_pointr num_coarse 448 train", train_path, dev, "vn_pointr_448")
    phase("9b vn_pointr num_coarse 448 train step", pointr_train_step, dev, smi)
    emd_counts = phase("10 flagship test --emd", emd_test_path, dev, "flagship")
    emd_counts_448 = phase("10 vn_pointr num_coarse 448 test --emd", emd_test_path, dev,
                           "vn_pointr_448")
    phase("10b flagship coarse losses emd, dcd", coarse_loss_train, dev)
    phase("11 standalone PCN, VNPCN, DGCNN", standalone_models, dev)
    bf16_counts = phase("12 bf16 serve", bf16_serve, dev, smi)
    bf16_train_counts = phase("13 bf16 train", bf16_train, dev, smi)
    phase("14a remat flagship float32", remat_flagship, dev, smi)
    phase("14b remat root config.json bf16", remat_root_config, dev, smi)
    phase("14c pretrained encoder --ckpt_path", pretrained_encoder_cli, dev)
    phase("14d -from branching", branch_cli, dev)
    phase("15a vn_pointr_448 + decoder stack serve", serve_path, dev, "vn_pointr_448_dec")
    phase("15b vn_pointr_448 + decoder stack train", train_path, dev, "vn_pointr_448_dec",
          0, "", True)
    phase("15b vn_pointr_448 + decoder stack train step", pointr_decoder_step, dev, smi)
    phase("15c vn_pointr_448 + decoder stack bf16", pointr_decoder_bf16, dev, smi)
    phase("15d scalar VNPCTransformer", scalar_pointr, dev, smi)
    mesh_counts = phase("16a flagship train --mesh 1 (NCCL)", mesh_world_one, dev, smi)
    phase("16b flagship, two ranks on the card (gloo)", mesh_two_ranks, dev, smi)
    phase("17a partial-scan renderer", render_on_card, dev, smi)
    phase("17b voxel OBJ export", obj_on_card, dev)
    phase("17d bf16 convergence, flagship overfit", bf16_convergence, dev, smi)
    # launches: each kernel's count in the training run of its path (K1's:
    # phase 3b's knn() call, its path; no model reaches it: the JAX package
    # takes it only for D > 512; C and C' in group=S mode are on no path:
    # no model passes a group to them; F's and
    # K3's rows at vn_pointr's shapes: phase 9's run, by design as well); the
    # bf16 rows' in phase 13's counted training runs (A', S, S', B', C'),
    # and the forward kernels' (A, B, C, K3) in phase 12's counted forwards
    # and metric step plus phase 13's runs (serve_launches, train_launches;
    # launches_a_step: a forward or train step of each path, as phases 12
    # and 13 assert them)
    for rec in records:
        sym = SYMBOL[rec["name"].split()[0]]
        if rec["name"].endswith(" bf16"):
            key = sym + ("[group,bf16]" if "group=" in rec["name"] else "[bf16]")
            if rec["name"].split()[0] in ("A'", "S", "S'", "B'", "C'"):
                rec["launches"] = bf16_train_counts.get(key, 0)
            else:  # the forward kernels (A, B, C, K3) serve and train
                rec["serve_launches"] = bf16_counts.get(key, 0)
                rec["train_launches"] = bf16_train_counts.get(key, 0)
                rec["launches"] = rec["serve_launches"] + rec["train_launches"]
                rec["launches_a_step"] = bf16_launches_a_step(key)
        elif "group=" in rec["name"]:
            rec["launches"] = pointr_counts[f"{sym}[group]"]
        elif sym == "emd_rounds":  # phase 10: both test --emd runs
            rec["launches"] = emd_counts[sym] + emd_counts_448[sym]
        elif sym == "topk_min":  # phase 3b, by design as well
            rec["launches"] = knn_counts[sym]
            rec["designs"] = {k.split("/")[1]: v for k, v in knn_counts.items()
                              if k.startswith(f"{sym}/")}
        else:
            on_pointr = " D 96 " in rec["name"] or " D 192 " in rec["name"] or "-> 224" in rec["name"]
            rec["launches"] = (counts if sym in FLAGSHIP_KERNELS else
                               pointr_counts if on_pointr else dgcnn_counts)[sym]
            if sym in FLAGSHIP_KERNELS and "group=" not in rec["name"]:
                rec["mesh_launches"] = mesh_counts[sym]  # phase 16a's run
            if sym in ("edge_knn_gather", "furthest_point_sample", "knn_min"):  # by design
                run = pointr_counts if on_pointr else dgcnn_counts
                rec["designs"] = {k.split("/")[1]: v for k, v in run.items()
                                  if k.startswith(f"{sym}/")}
        if sym in ("vn_layer_stats_fwd", "vn_layer_stats_bwd"):  # by design, the run's
            run = (bf16_train_counts if rec["name"].endswith(" bf16") else
                   pointr_counts if "group=" in rec["name"] else counts)
            prefix = SYMBOL[rec["name"].split()[0]] + (
                ("[group,bf16]" if "group=" in rec["name"] else "[bf16]")
                if rec["name"].endswith(" bf16") else "[group]" if "group=" in rec["name"] else "")
            rec["designs"] = {k.split("/")[1]: v for k, v in run.items()
                              if k.startswith(f"{prefix}/")}
        if rec["name"].endswith(" bf16") and sym in ("edge_knn_gather", "vn_bn_leaky_fwd"):
            rec["designs"] = {k.split("/")[1]: v for k, v in bf16_counts.items()
                              if k.startswith(f"{sym}[bf16]/")}
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
