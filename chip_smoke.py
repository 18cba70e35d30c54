#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

1. prints the torch/CUDA versions and the card's name and power limit, and
   starts one nvcc per kernel source (``csrc/*.cu``, sm_90a: the probe, the
   tail, the tail's backward and the conv-LSTM cell), all at once;
2. toolchain probe: ``add_one`` (``csrc/probe_add_one.cu``) on an (8, 128)
   f32 array must give exactly ``x + 1``, before anything larger is tried;
   then exactly ``x + 1`` at an odd length, on a tensor sliced one element
   in (not 16-byte aligned) and at n = 0;
3. holds the CDNA tail kernel against its plain PyTorch version, in both
   mask layouts (full resolution and blocked) and in bf16 and f32: at the
   serving shapes (B=200, 768, 800, 1536 and 10, the batches of the driven
   paths, at 48x64, C=3, P=1, K=5, M=10, SNA) and at
   shapes that stress the tiling (``TAIL_CASES``: images smaller than a tile
   or no multiple of it, several tiles across, B=1, K=3 and 7, M=16, SNA
   off, P=0, two packed planes (4 < C + P <= 8: C=1, P=4; C=3, P=3; C=4,
   P=4; K=7, M=16; odd sizes; several tiles; B=1) in every layout, the
   registration path's B=768, C=3, P=2, and block factor 3, which the
   entry expands to full resolution); and the
   source's second kernel against its plain versions in bf16 and f32 at
   B=768 and 200, P 0-3, SNA on and off, K 3, 5 and 7, and at odd sizes:
   through its effective-kernel entry (the per-pixel field given) and
   through its DNA mode (the field made from the DNA head's logits and the
   masks, the masks in f32 and in the compute type); and the tail's
   backward kernel (``csrc/cdna_tail_bwd.cu``) against its plain version,
   all four gradients, at the training shape (B=16, 48x64, C=3, M=10) in
   both mask layouts, at B=256 and at sizes that cut its 8 x 32 tiles,
   several tiles across, B=1, blocked r=2, K 3 and 7, M 16 with C 1, SNA on
   and off, bf16 and f32, each launch twice and bitwise equal; and the
   conv-LSTM kernel (``csrc/conv_lstm_ln.cu``) against its maths composed in
   f32 at the flagship's cells at B=768, the classic backbone's in bf16 at
   768 samples and in f32 at 200, and widths from 4 to 1024
   (``LSTM_CASES``): c' and h' within one ulp, y within one ulp and 1e-5;
   and the same source's stand-alone LayerNorm with the convolution's bias
   folded in (``bias_layer_norm``) against its plain version at the
   classic backbone's ``ln0`` and ``ln6`` (``ln6`` as ``dec3``'s cropped
   view) at 768 samples in bf16 and 200 in f32, and at F 64 to 1024
   (``NORM_CASES``): within 1e-6 of 1 + |y|, in bf16 one ulp more;
4. golden: each restored export in f32 (TF32 off) replays the JAX package's
   replan ``weights/<name>/golden_replan_f32.npz`` with the normals
   injected (xz_flagship: 16 samples x 15 steps x 3 iterations; ag_r5f_v2:
   24 samples x 9 steps x 3 iterations, latents injected too), and
   ag_r5f_v2 its MPPI replan ``golden_mppi_f32.npz`` (24 samples x 10 steps
   x 3 iterations, anchored, normals and latents injected): scores, elites
   and the elites' frames against the JAX numbers; then the
   flagship's golden again with ``fuse_decode`` on, and the goldens of the
   seeded exports of the JAX package's default predictor (the classic
   Finn-CDNA backbone, ``weights/classic_cdna``) and of its DNA twin
   (``weights/classic_dna``), 24 samples x 15 steps x 3 iterations each:
   the classic CDNA tail launches on full-resolution masks, DNA's through
   the DNA mode;
5. drives the serving replan: ``TorchPredictor`` with the restored
   xz_flagship (bf16) and ``FusedCEMPlanner`` with 200 samples x 15 steps x
   3 iterations, for a few replans with fresh contexts; checks the outputs,
   46 kernel launches per replan, and that one replan with the plain tail
   gives the same elites and scores.  On every driven path every launch
   must be on blocked masks;
6. drives ``PixelCostController.act()`` on seeded synthetic frames, each
   controller restoring its weights itself, with the tail's launch count
   worked out from the policy (``replan_launches``) and checked:
   - xz_bench20's point (768 samples, 15 actions x repeat 3 = 45 steps, 3
     iterations, replan every 10 steps, xz_flagship, bf16), 12 control
     steps: 2 replans x (1 + 3 x 45) = 272 launches;
   - ag_bench20's point (768 samples, 10 actions x repeat 3 = 30 steps, 3
     iterations, adim 4, sdim 5, one latent per sample, replan every 10
     steps, ``predictor_propagation``, ag_r5f_v2, bf16), 12 control steps:
     2 replans x (1 + 3 x 30) = 182 launches, the second replan on the
     first one's propagated distribution;
   - ag_bench20_hard's lever on the same point, ``stochastic_planning``
     (2,) with ``stochastic_penalty`` 1.0: one replan of 1536 rows, 91
     launches;
   - xz_bench20's point at 800 samples with ``sample_chunk`` 200: one
     replan = 1 context step + 3 iterations x 4 chunks x 45 steps at B=200
     + one 45-step re-roll of the 10 visualised elites = 586 launches; and
     the same 800 samples as one batch (136 launches), to time it against;
   - the RoboNet planning path on ag_r5f_v2
     (``experiments/robonet/view_generalization/single_view.py``: MPPI,
     600 samples, 5 iterations, 60 elites, 10 actions, replan every 10
     steps, drawn warm-up actions until step 5): (a) fused, with T = 10 and
     the AR(1) chain anchored on the last executed action, 16 steps, 2
     replans x (1 + 5 x 10) = 102 launches; (b) as written (T 15) in the
     host CEM loop, one teacher-forced forward of 1 + 10 steps per
     iteration, 5 x 11 = 55 launches per replan;
   - (c) the folding prior
     (``experiments/sawyer/mixed_objects/hparams_deformable_objects.py``:
     600 samples, 5 actions x repeat 3, 30 elites): 1 + 3 x 15 = 46;
   - (d) ``AutograspSampler`` and ``AutograspEpsilon`` at ag_bench20's
     point (768 x 10 x 3), the grip on ag_r5f_v2's fourth action dim: 91
     launches each, the derived grip holding only the close and open
     commands;
   - every other architecture of the JAX model, at xz_bench20's point
     (768 x 45 x 3, bf16, one replan each):
     (a) the classic CDNA export, 136 folded launches on full-resolution
     masks; (b) the classic DNA export, 136 launches of the DNA mode and
     none of the folded or the field-given entry; (c) the flagship with
     ``fuse_decode``, 136;
   every path's launches are read from the counters and must match the
   entry and mask layout its predictor's architecture gives, and every
   model step launches the conv-LSTM kernel once a cell (3 on the
   space-to-depth backbone: 408 a replan at xz_bench20, 273 at ag_bench20;
   5 on the classic one) and the stand-alone LayerNorm twice on the classic
   backbone (``ln0``, ``ln6``: 272 a replan at xz_bench20), never on the
   space-to-depth one;
   - training (``training/train_predictor.py``): the JAX package's three
     f32 train steps of the flagship (``golden_train_f32.npz``: B=4, 6
     frames, masks injected) replayed through the tail's forward and
     backward kernels (losses, gradient norms, every leaf's change); then
     ``train()`` at the flagship's full width (bf16, batch 16, 60 steps on
     synthetic batches): the loss must fall, every metric stay finite, 14
     forward and 14 backward tail launches a step and no plain version,
     ten more steps timed and one profiled; ``--stochastic`` at ag_r5f_v2's
     configuration for 10 steps, the KL printed; the flagship run's
     checkpoint restored by ``TorchPredictor`` and one 200 x 15 x 3 replan;
   - the other planning costs, each controller restoring its weights (the
     seeded exports of the GDN, classifier, NCE and inverse nets; the
     ensemble's members 2 and 3 and the registration predictor's view 1
     are seeded copies of xz_flagship, ``campaigns/stand_ins.py``'s):
     each JAX golden replayed in f32 (act() at t=1, 24 samples x 15
     steps x 3 iterations, the JAX draws injected: scores, elites, plans,
     the registration's tradeoffs and pixels; the inverse net's plans),
     then each again with the plain tail (the same elites, f32); their
     bf16 replans at the campaign points are phase 11's twins;
   - training from collected records: one line probing the host side of
     ingest (``g++``, ``jpeglib.h``, ``zlib.h``; whether ``google_crc32c``,
     ``cv2``, ``h5py`` and ``imageio`` import); 48 trajectories of the
     flagship's shapes (the trainer's synthetic batches, quantised to
     uint8) written by the port's ``GeneralAgentSaver`` into 6 GZIP-TFRecord
     shards in a temporary directory and read back exactly; ``train()`` of
     the flagship from them (``--data_dir``, the Python reader; bf16, batch
     16, 60 steps: 14 forward and 14 backward launches a step, no plain
     version, the loss must fall) and ten more steps timed beside the
     synthetic ones; where the probe found ``g++`` and ``zlib.h``, the
     port's native engine (``native/ingest.cpp``; without ``jpeglib.h``
     built without JPEG decoding) built, its batches equal to the Python
     reader's, and 10 steps with ``--loader fused``, timed; the GDN,
     classifier (goal labels), NCE and inverse trainers, 100 f32 steps each
     from the records, their steps timed, each net then served by its
     controller for one replan (``*_restored`` true; registration 182
     launches, classifier 91, NCE 136, inverse none); and the JAX tests'
     quality gates for those trainers, met on the card;
7. times the kernels and their plain versions beside their bounds (the tail
   in both mask layouts, with its share of the card's memory rate and the
   ``depth_to_space`` copy that the blocked layout saves; the second
   kernel's effective-kernel entry and DNA mode at B=768 and 200, each
   beside the bound of its own inputs; ``add_one`` also at 2^26 floats,
   beside ``torch.add``; the tail's backward at B=16 and 256; the
   conv-LSTM kernel at the flagship step's cells, B=768, beside the stock
   chain; the stand-alone LayerNorm at ``ln6``'s and ``ln0``'s shapes,
   B=768, beside its plain version), the 200-sample replan,
   and the replans of the xz_bench20 (also with ``fuse_decode``, in turns
   with it off), ag_bench20, chunked and one-batch 800-sample, RoboNet MPPI
   (fused and host loop), folding, classic CDNA (its cells through the
   stock chain and through the kernel, in turns) and classic DNA controllers
   (host clock and CUDA events), with a profiler breakdown of one replan of
   each but the one-batch 800-sample and the folding ones; then the
   replans on the nets trained from records the same way, and the tail
   kernel on two planes at the registration path's
   shape (B=768, C=3, P=2, blocked masks) beside its bound and its time
   at P=1;
8. the sim benchmark campaign: one line probing the host for it (whether
   ``mujoco`` imports and its version, which GL backend renders a 96x128
   frame, ``egl`` then ``osmesa``, each in a subprocess, and whether
   ``imageio`` and ``matplotlib`` import: the port needs neither); then
   ``PixelCostController.act()`` at xz_bench20's point (768 x 45 x 3, bf16,
   xz_flagship) on task 0's start frame and pixels with a real file worker
   as ``verbose_worker``: one replan (136 launches) whose dump is on disk
   (``plan.html``, the start PNG and 20 GIF89a files of 45 frames of
   48x64, read block by block), and the replan's host p50 and spread with
   the dump and without it, 10 replans each in turns; then, where MuJoCo
   renders, ``sim/run.py --benchmark`` of the twin configs
   ``campaigns/xz_bench20.py`` and ``ag_bench20.py`` in this process, all
   20 vendored tasks each, held to ``check_campaign`` (numpy alone, which
   the CPU campaign test also runs): the reports written, 136 and 91
   launches a replan, xz_bench20's per-task initial distance within
   1e-3 of the JAX run's (``benchmarks/xz_bench20/runs/r5_s768``), and a
   mean improvement of at least 0.086 (xz_bench20) and 0.010 (ag_bench20),
   printed beside the JAX runs' with the wall time and the replans' host
   p50.  Where MuJoCo does not render, one line says that the scored
   campaigns wait for it;
9. data collection and offline replay: ``sim/run.py`` of the twin config
   ``campaigns/offline_towel_classifier.py`` (``OfflineAgent``,
   ``OfflineSawyerEnv``, ``ClassifierController`` with
   ``FoldingCEMSampler``, 600 samples, the host CEM loop, ag_r5f_v2 and the
   seeded classifier, bf16) over 2 raw trajectories of 15 frames of 48x64
   written here (``ag_bench20``'s start frames blended into its goal frames
   with seeded noise; a state of width 5, the towel source's
   ``state_append`` constants after a seeded (x, y) walk): 3 episodes, one
   replan each, 3 x (1 + 15) = 48 tail launches a replan, every episode
   written as a raw folder, the replans' host times and the wall time
   printed, then 5 more replans timed and one profiled; the episodes
   converted by the port's ``file_2_record`` into
   GZIP TFRecords, read back equal to the raw frames, states and actions,
   and 5 ag_r5f_v2 train steps from them (``--stochastic``, batch 2: 14
   forward and 14 backward launches a step); one ``HumanCEMController``
   replan at bench.py's point on the flagship (200 x 15 x 3, the host
   loop: 48 launches) with a seeded script of scores in place of
   ``input()`` and a real file worker: the scores as scripted, each refit's
   elites the lowest scored and its mean theirs, the action the best-scored
   sample's first, every page and GIF on disk; then the HDF5 writers where
   ``h5py`` and ``imageio`` import and ``campaigns/collect_xz_r4.py`` (2
   trajectories of T 30, read back) where MuJoCo renders, else one line
   for each that waits;
10. pretrained TF1 weights, the data and profiling tools (``main``'s phase
   9): the flagship's numpy weights written by ``export_tf1_checkpoint`` as
   the TF1 bundle ``view0/model-5000`` beside a stale one of zeros at step
   100; ``TorchPredictor`` restored from it on the card prints the import
   of the step-5000 bundle, holds the numpy restore's state exactly, and
   replans bench.py's point (200 x 15 x 3, the same context and draws) to
   the numpy predictor's scores and actions bit for bit, 46 tiled launches
   each; the bundle's size, the export and import times (with the CRC32C
   in use) and both replans' host p50 in turns are printed;
   ``visualize_predictions.main`` (``--n 4``, bf16) on records written as
   in phase 5i and that bundle: a finite PSNR report, 4 strips and 14
   tiled launches, its forward timed alone; ``check_dataset.main`` on the
   same records; one replan of the bundle's predictor inside
   ``device_trace`` and ``PhaseTimer``: a chrome trace with CUDA kernel
   events (46 of the tail) and both phases; then the RoboNet reader on
   HDF5 written by the port's ``HDF5Saver`` and 5 flagship train steps
   from it where ``h5py`` and ``imageio`` import, and two
   ``collect_sawyer_arm.py`` trajectories of T 6 where MuJoCo renders,
   else one line for each that waits;
11. the robot path (``main``'s phase 10): the port's camera node
   (``native/camera_stream.cpp``) built by ``ops/_build.py`` and started
   twice in ``--test-pattern`` mode at 640x480 on the channels that the
   twin's topics name; a two-view model directory (view 0 ag_r5f_v2, view 1
   ag_r5f_v2 plus seeded noise); ``RobotEnvironment`` of
   ``sim/run_robot.py`` on ``campaigns/robot_sawyer_pixel_cost.py`` with
   ``--benchmark``, a kinematic fake arm (``FakeArm``), seeded clicks for
   ``select_points`` and a script for ``input()``: 2 trajectories of T 20
   (2 replans each, 600 samples x 15 steps x 3 iterations, 2 views, bf16:
   92 tiled launches a replan), each replan's launches counted and timed
   (host clock, CUDA events), the raw folders (a JPEG a frame and camera,
   the pickles, ``env_metadata.json``), ``checkpoint.pkl``, the stats
   against the clicks by hand, each camera's clip an mp4 (an ``ftyp`` box,
   T or more frames read back; where the file worker cannot open an mp4
   writer, a line says that the clips wait, and the run goes again without
   them); then a third trajectory under ``resume``; then the first replan
   again in f32 on the same context and draws, with the kernel and with
   the plain tail: scores within rtol 1e-4 and the same elites; then
   ``campaigns/robonet_franka.py`` through ``run_robot`` with
   ``--benchmark`` on one test-pattern node, its default weights
   (ag_r5f_v2) and ``use_fused_planner`` off (the fused planner refuses its
   10 actions under T 15, as the JAX package asserts): 2 trajectories of T
   15, a replan each at t=5, MPPI 200 samples x 5 iterations in the host
   loop, 5 x (1 + 10) = 55 tiled launches a replan, the raw folders, the
   stats and the clip; and ``campaigns/collect_robot_sawyer_grasp.py``
   through ``run_robot`` without ``--benchmark`` on five nodes: one
   ``GaussianPolicy`` trajectory of T 30, its raw frames read back at
   240x320, no tail launch;
12. the campaign twins (``main``'s phase 11): each planning twin of the
   benchmarks and of experiments/sim (``campaigns/<twin>.py``: hard,
   classifier, both ensembles, registration, NCE, both inverse baselines;
   ``sim_autograsp_stochastic``, ``sim_two_cam_registration``,
   ``sim_2d_grasping_pixel_cost``, ``sim_2d_grasping_nce_experiments``,
   ``sim_ensemble_grasping``) loaded from its own file with its default
   weights (the vendored exports and ``campaigns/stand_ins.py``) and built
   at its own operating point in bf16 on the card; the four experiments
   whose policy raises as written (an override equal to its default, as in
   the JAX package) raise that ``ValueError`` first and are then built
   with those keys dropped; every view and net restored; two ``act()``
   steps with one replan, then three replans timed as phase 7's (two on
   the host clock, one between CUDA events), every replan's tail launches
   equal to the count from the twin's policy (xz_bench20_ensemble: 3
   members x 3 iterations x one 46-step teacher-forced forward of 768
   samples = 414; xz2c_bench20_registration: 2 cameras x (1 + 3 x 30) =
   182), tiled on blocked masks (two packed planes for the registration
   twins); the
   benchmarks on their task 0 (the stored start frames, the env's pixels
   and state at reset, the goal image their goal source loads),
   experiments/sim on seeded synthetic frames; the inverse twins without a
   tail; one profiled replan of each of the ensemble, registration,
   classifier and NCE benchmark twins and of the longest one; the random
   baselines' policies built and acting once, no card work.  Phase 7 times
   the tail at B = 200, 768, 600, 800 and 1536 and two planes at B = 768
   and 200, each beside its bound, and holds two planes at the sawyer
   registration experiment's 96x128 (B=400, C=3, P=2, both layouts, bf16
   and f32) against the plain version and times it beside its bound;
13. the robot twins (``main``'s phase 12): each planning twin of
   experiments/sawyer and experiments/robonet (``campaigns/robot_sawyer_*``,
   ``robonet_*``: 22) built from its own file with its stand-ins (the
   registration experiment's: a seeded predictor at the flagship's widths
   at 96x128 and a seeded GDN) at its own point in bf16 on the card; those
   whose source does not build as written raise as it does first (an
   override equal to its default, a key no controller declares, a plan the
   fused planner refuses) and are built as a user must; every view and net
   restored; twins of equal policy (but for their weights) and agent point
   form a group (12), which replans once: act() to its first replan, then
   three timed replans, every replan's tail launches equal to the count
   from its policy (``robot_launches``), tiled on blocked masks, two planes
   at 96x128 for the registration twin; the human CEM on seeded scripted
   scores and a file worker; the inverse twins (192x256) without a tail.
14. the mesh (``main``'s phase 13, ``drive_mesh``): the flagship's replan
   (``parallel/flagship_check.py``: 48x64, M=200, 2 iterations, bf16, the
   restored flagship) unsharded, then over the card repeated 2 and 4 times
   (``Mesh((cuda:0,) * n)``, the counterpart of the JAX tests' virtual CPU
   mesh) and over ``make_mesh()`` (every card): launches ``1 + 2 x 15 x
   n`` (the context once, every model step once a share), CUDA-event spans,
   each held against unsharded (``check_sharded_replan``: the first
   iteration's scores at JAX's flagship tolerance and the best plans, in
   bf16 where its elites and scores agree, else both again in f32); 3
   flagship train steps at batch
   16 in f32 over the card twice (``--n_devices 2 --device cuda:0``)
   against one, at the port's train-step tolerances; and
   ``tools/dryrun_multichip.py`` at n = 4.
15. the checkpoints (``main``'s phase 14, ``drive_checkpoints``): the
   port's zstd decoder (``native/zstd_decode.cpp``) built and timed on the
   flagship's chunks; ``benchmarks/models/xz_flagship`` and ``ag_r5f_v2``
   restored on the card from their orbax step directories (OCDBT, zarr,
   zstd: ``prediction/checkpoints.py``), each restore timed and equal bit
   for bit to the numpy export's; a 200 x 15 x 3 bf16 replan from each
   orbax restore and from its numpy twin on the same draws, scores and
   elites equal, 46 tiled launches each; 3 f32 flagship train steps at
   batch 16 saving under ``build/``, the written ``step_3/`` read back
   equal to the trained state (parameters, optax count and moments), and
   one step resumed from it.

Every predictor must restore the numpy weights (``restored=True``); a
predictor on seeded weights raises.  It prints one JSON line describing the
kernels, then, as its last line, ``{"ok": true, "device": {...}}``.  Any
failed phase raises and exits non-zero; without a CUDA card it exits
non-zero before printing a result.
"""

import contextlib
import functools
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.models.layers import LN_EPS

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks: HBM3 bandwidth, f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

WEIGHTS = os.path.join(REPO, 'visual_foresight_torch', 'weights',
                       'xz_flagship')
H, W, C, P, K, NUM_MASKS = 48, 64, 3, 1, 5, 10
M, ITERS, NACT, REPEAT, N_CTX = 200, 3, 5, 3, 2
T = NACT * REPEAT
LAUNCHES_PER_REPLAN = 1 + ITERS * T           # encode step + rollouts
MASK_BLOCK = 4                                # the flagship's std_factor
# tail shapes beyond the serving ones: (label, overrides of
# b=6, h=20, w=36, c=3, p=1, k=5, m=10, sna=True), each run in the mask
# layouts listed under 'blocks' (0: full resolution)
TAIL_CASES = [
    ('smaller than a tile', dict(b=2, h=8, w=8, blocks=(0, 2, 4))),
    ('no multiple of the tile', dict(blocks=(0, 2, 4))),
    ('odd sizes', dict(b=3, h=13, w=10, blocks=(0,))),
    ('several tiles across', dict(b=2, h=16, w=136, blocks=(0, 4))),
    ('B=1', dict(b=1, h=48, w=64, blocks=(0, 4))),
    ('K=3', dict(k=3, blocks=(0, 4))),
    ('K=7', dict(k=7, blocks=(0, 4))),
    ('M=16', dict(m=16, blocks=(0, 4))),
    ('SNA off', dict(sna=False, blocks=(0, 4))),
    ('P=0', dict(p=0, blocks=(0, 4))),
    ('SNA off, P=0', dict(sna=False, p=0, blocks=(0, 2))),
    ('C=1, P=4', dict(c=1, p=4, blocks=(0, 2))),
    ('block factor 3', dict(h=18, w=36, blocks=(3,))),
    ('two planes, C=3, P=3, SNA off',
     dict(p=3, sna=False, blocks=(0, 2, 4))),
    ('two planes, C=4, P=4', dict(c=4, p=4, blocks=(0, 2, 4))),
    ('two planes, C=4, P=1, K=7, M=16',
     dict(c=4, p=1, k=7, m=16, blocks=(0, 2, 4))),
    ('two planes, odd sizes',
     dict(b=3, h=13, w=10, p=2, blocks=(0,))),
    ('two planes, several tiles across',
     dict(b=2, h=16, w=136, p=2, blocks=(0, 2, 4))),
    ('two planes, B=1', dict(b=1, h=48, w=64, p=2, blocks=(0, 2, 4))),
]
# bf16: one ulp near 1.0 is 7.8e-3; both sides accumulate in f32 and round
# once, so they differ by at most one ulp of outputs below 2
TAIL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# planner scores through 15 bf16 steps, relative to the largest score
SCORE_RTOL = 2e-2
N_WARM, N_TIMED = 2, 10
# f32 on the card (cuDNN and cuBLAS without TF32) against the JAX package's
# f32 on the CPU: other summation orders through 46 full-width steps.
# Measured on an H100: 5.0e-7 relative on the scores, 4.2e-6 on the frames;
# bf16 anywhere in the path would miss both by two orders of magnitude.
GOLDEN_SCORE_RTOL = 1e-4
GOLDEN_FRAME_ATOL = 1e-4
CAMPAIGNS_DIR = os.path.join(REPO, 'visual_foresight_torch', 'campaigns')
# the vendored nets' numpy exports (no trained weights of the ensemble,
# registration, classifier, NCE and inverse campaigns are in the repo: the
# GDN, classifier, NCE and inverse nets are seeded exports,
# tests/test_torch_weights_aux.py)
SEEDED = {n: os.path.join(os.path.dirname(WEIGHTS), 'seeded_' + n)
          for n in ('gdn', 'classifier', 'nce', 'inverse')}


def twin_config(name, **env):
    """The config of the campaign twin ``campaigns/<name>.py``, loaded with
    the ``VMPC_*`` variables of ``env`` and no others (each twin's
    stand-ins warn; here silenced: the script names its weights)."""
    import copy
    import warnings
    from visual_foresight_torch.sim.run import load_config
    clean = {k: v for k, v in os.environ.items() if not k.startswith('VMPC_')}
    with mock.patch.dict(os.environ, dict(clean, **env), clear=True), \
            warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return copy.deepcopy(load_config(os.path.join(CAMPAIGNS_DIR,
                                                      name + '.py')))


def twin_policy(name, drop=(), **env):
    """The policy of the twin ``name`` (``twin_config``) without its
    ``type`` and the keys of ``drop``."""
    return {k: v for k, v in twin_config(name, **env)['policy'].items()
            if k not in ('type',) + tuple(drop)}


# xz_bench20's policy, read from its twin (campaigns/xz_bench20.py)
AG_PARAMS = {'adim': 3, 'sdim': 3, 'ncam': 1, 'image_height': H,
             'image_width': W, 'T': 45}
CTRL_POLICY = dict(twin_policy('xz_bench20'), model_path=WEIGHTS)
CTRL_STEPS, CTRL_TIMED = 12, 5
# ag_bench20's policy (campaigns/ag_bench20.py) and agent, on the numpy
# export of ag_r5f_v2; ag_bench20_hard's twin with its two stochastic keys
# set (VMPC_STOCH_K=2, VMPC_STOCH_PEN=1.0)
AG_WEIGHTS = os.path.join(REPO, 'visual_foresight_torch', 'weights',
                          'ag_r5f_v2')
AG_AGENT = {'adim': 4, 'sdim': 5, 'ncam': 1, 'image_height': H,
            'image_width': W, 'T': 30}
AG_POLICY = dict(twin_policy('ag_bench20'), model_path=AG_WEIGHTS)
AG_HARD_POLICY = dict(twin_policy('ag_bench20_hard', VMPC_STOCH_K='2',
                                  VMPC_STOCH_PEN='1.0'),
                      model_path=AG_WEIGHTS)
# xz_bench20 with VMPC_NUM_SAMPLES=800 and VMPC_SAMPLE_CHUNK=200
CHUNK_POLICY = dict(CTRL_POLICY, num_samples=800, sample_chunk=200)
# the RoboNet MPPI policy, read from its twin
# (campaigns/robonet_view_generalization_single_view.py) on ag_r5f_v2; the
# sampler class is filled in by main()
ROBONET_POLICY = twin_policy('robonet_view_generalization_single_view',
                             drop=('sampler',), VMPC_MODEL_DIR=AG_WEIGHTS)
# fused MPPI plans at control cadence: T = nactions, anchored chain
ROBONET_FUSED_POLICY = dict(ROBONET_POLICY, T=10,
                            smooth_across_last_action=True)
# as written (T left at its default): the host CEM loop
ROBONET_HOST_POLICY = dict(ROBONET_POLICY, use_fused_planner=False)
ROBONET_STEPS = 16            # warm-ups at t < 5, replans at t = 5 and 15
# the folding policy, read from its twin
# (campaigns/robot_sawyer_mixed_objects_deformable.py): its two cameras cut
# to ag_r5f_v2's one view, its two tasks to the first
FOLDING_POLICY = twin_policy('robot_sawyer_mixed_objects_deformable',
                             drop=('sampler',), VMPC_MODEL_DIR=AG_WEIGHTS)
# the cuts of the two twins' policies, printed by main()
POLICY_CUTS = (
    'RoboNet MPPI (robonet_view_generalization_single_view): fused at T 10 '
    '(the twin leaves T at 15 under 10 actions, which only the host loop '
    'plans), the chain anchored on the last executed action; as written in '
    'the host loop; ag_r5f_v2 for the twin\'s stand-in, the same export',
    'folding (robot_sawyer_mixed_objects_deformable): one camera '
    '(ag_r5f_v2\'s one view for the twin\'s two-view stand-in), the first '
    'of its two tasks')
# the explicit-gripper samplers at ag_bench20's point; AutograspEpsilon
# finds z and the grip by name
AUTOGRASP_POLICY = dict(AG_POLICY)
AG_EPSILON_POLICY = dict(AG_POLICY, action_order=['x', 'y', 'z', 'grasp'])
# the JAX package's default predictor (the classic Finn-CDNA
# backbone, TPUPredictor's default hparams) and its DNA twin, seeded
# exports (tests/test_torch_weights_classic.py), at xz_bench20's point
CLASSIC_WEIGHTS = os.path.join(REPO, 'visual_foresight_torch', 'weights',
                               'classic_cdna')
DNA_WEIGHTS = os.path.join(REPO, 'visual_foresight_torch', 'weights',
                           'classic_dna')
CLASSIC_POLICY = dict(CTRL_POLICY, model_path=CLASSIC_WEIGHTS)
DNA_POLICY = dict(CTRL_POLICY, model_path=DNA_WEIGHTS)
FUSE_POLICY = dict(CTRL_POLICY, predictor_hparams={'fuse_decode': True})
# the other planning costs' goldens (f32, the JAX package's replans) and
# phase 5k's nets trained from records, at their campaigns' points read
# from their twins (campaigns/{xz2c_bench20_registration,
# ag_bench20_classifier,xz_bench20_nce,xz_bench20_inverse}.py; phase 11
# drives the twins themselves).  The ensemble's members 2 and 3 and the
# registration predictor's view 1 are seeded copies of xz_flagship
# (campaigns/stand_ins.py, the seeds in their goldens), the classifier runs
# ag_r5f_v2 in place of ag_r5f_v1
GOLDEN_PATHS = {
    'ensemble': os.path.join(WEIGHTS, 'golden_ensemble_f32.npz'),
    'registration': os.path.join(SEEDED['gdn'],
                                 'golden_registration_f32.npz'),
    'classifier': os.path.join(SEEDED['classifier'],
                               'golden_classifier_f32.npz'),
    'nce': os.path.join(SEEDED['nce'], 'golden_nce_f32.npz'),
}
# the act() inputs of each controller (the ensemble's: the pixels alone)
GOLDEN_ACT_KEYS = {'ensemble': ('desig_pix', 'goal_pix'),
                   'registration': ('desig_pix', 'goal_pix', 'goal_image'),
                   'classifier': ('goal_image',), 'nce': ('goal_image',)}
N_MEMBERS = 3
# the registration predictor's path is set by main() (predictor_dirs)
REG_AGENT = dict(AG_PARAMS, T=30, ncam=2, ntask=1)
REG_POLICY = twin_policy('xz2c_bench20_registration', drop=('model_path',),
                         VMPC_MODEL_DIR='unused',
                         VMPC_GDN_DIR=SEEDED['gdn'])
CLF_POLICY = twin_policy('ag_bench20_classifier', VMPC_MODEL_DIR=AG_WEIGHTS,
                         VMPC_CLASSIFIER_DIR=SEEDED['classifier'])
NCE_POLICY = twin_policy('xz_bench20_nce', VMPC_MODEL_DIR=WEIGHTS,
                         VMPC_EMBEDDING_DIR=SEEDED['nce'])
INV_AGENT = {'adim': 3, 'sdim': 3, 'image_height': H, 'image_width': W}
INV_POLICY = twin_policy('xz_bench20_inverse',
                         VMPC_MODEL_DIR=SEEDED['inverse'])
INV_STEPS = 10                # warm-ups at t < 2, replans at t = 2, 4, 6, 8
INVERSE_ATOL = 1e-5
# the registration path's distributions a camera: C + P = 5, two planes
REG_P = 2
# the batches the tail is timed at: the 200-sample replan, the campaigns'
# 768, and the batches the twins serve (sim_autograsp_stochastic's 600,
# the 800 of experiments/sim's pixel-cost, NCE and ensemble twins,
# ag_bench20_hard's 768 x 2 latent copies); on two planes the
# registration twins' 768 and 200
TAIL_TIMED_BATCHES = (M, 768, 600, 800, 1536)
TWO_PLANE_BATCHES = (768, M)
# the effective-kernel entry: B, P, SNA and K swept at 48x64, C=3
EFF_BATCHES, EFF_PS, EFF_KS = (768, 200), (0, 1, 2, 3), (3, 5, 7)
EFF_ODD = [dict(b=3, h=13, w=10), dict(b=2, h=9, w=300, c=1, p=4)]
N_VIS = 10                                    # the planner's default
DEFAULT_T = 15                                # the controllers' default T
SPEC_HP = {'xz_flagship': {'initial_std': 0.05, 'initial_std_lift': 0.15,
                           'initial_std_rot': np.pi / 18,
                           'initial_std_grasp': 2,
                           'action_order': ['x', 'z', 'grasp']},
           'ag_r5f_v2': {'initial_std': 0.04, 'initial_std_lift': 0.6,
                         'initial_std_rot': np.pi / 32,
                         'initial_std_grasp': 2, 'action_order': None}}
SPEC_HP['classic_cdna'] = SPEC_HP['classic_dna'] = SPEC_HP['xz_flagship']


# -- the sim benchmark campaign ------------------------------------------------
# xz_lifting_bench20's task 0 (benchmarks/tasks): its start frame, and the
# designated pixel, goal pixel and state that the port's CartgripperXZGrasp
# gives at reset from the task's reset state, at 64 pixels wide
# (tests/test_torch_envs.py holds them against the env)
TASK0_FRAME = os.path.join(REPO, 'benchmarks', 'tasks', 'xz_lifting_bench20',
                           'traj_group0', 'traj0', 'images0', 'im_0.png')
TASK0_DESIG_PIX = np.array([[[24, 36]]])
TASK0_GOAL_PIX = np.array([[[24, 1]]])
TASK0_STATE = np.array([0.048971992780443785, -0.013966588767465302, 1.0])
DUMP_TIMED = 20               # replans timed, half with the dump
N_VIS_GIFS = 2 * N_VIS        # the distribution and the frames of each
# the scored campaigns: the twin config, the JAX runs on the same tasks
# (the first one's per-task initial_dist is the reference), the floor on
# the mean improvement (the lowest JAX run less two standard errors of a
# 20-task mean), and the tail launches a replan
CAMPAIGNS = {
    'xz_bench20': {
        'jax_runs': ('benchmarks/xz_bench20/runs/r5_s768',
                     'benchmarks/xz_bench20/runs/r5_s768_chunked',
                     'benchmarks/xz_bench20/runs/r5_s800',
                     'benchmarks/xz_bench20_random/verbose'),
        'floor': 0.086, 'launches': 1 + ITERS * 45},
    'ag_bench20': {
        'jax_runs': ('benchmarks/ag_bench20/runs/r5_v2',),
        'floor': 0.010, 'launches': 1 + ITERS * 30},
}
INITIAL_DIST_ATOL = 1e-3
# a 96x128 offscreen render, in a subprocess for each GL backend
GL_PROBE = """
import mujoco
m = mujoco.MjModel.from_xml_string(
    "<mujoco><worldbody><light pos='0 0 3'/>"
    "<geom type='box' size='.2 .2 .2'/>"
    "<camera name='c' pos='0 -2 0' xyaxes='1 0 0 0 0 1'/>"
    "</worldbody></mujoco>")
d = mujoco.MjData(m)
mujoco.mj_forward(m, d)
r = mujoco.Renderer(m, 96, 128)
r.update_scene(d, camera='c')
im = r.render()
assert im.shape == (96, 128, 3) and im.std() > 0, im.shape
"""


def replan_launches(policy, iterations=None, horizon=None):
    """Tail launches of one cold replan under ``policy`` (``iterations``
    and the sampler's ``horizon`` default to the policy's): the context
    step at B=1, then ``horizon`` steps per rollout; one rollout per
    iteration, or one per chunk and iteration plus the re-roll of the
    visualised elites.  In the host CEM loop, one teacher-forced forward
    per iteration over the context action and the ``nactions`` plan."""
    iterations = iterations or policy.get('iterations', ITERS)
    if policy.get('use_fused_planner', True) is False:
        return iterations * (N_CTX - 1 + policy['nactions'])
    horizon = horizon or policy.get('T', DEFAULT_T)
    rows = policy['num_samples'] * (policy.get('stochastic_planning')
                                    or (1,))[0]
    chunk = policy.get('sample_chunk', 0)
    if chunk and rows > chunk and rows % chunk == 0:
        return 1 + (iterations * (rows // chunk) + 1) * horizon
    return 1 + iterations * horizon


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def tail_inputs(gen, b, dtype, sna=True, p=P, h=H, w=W, c=C, k=K,
                m=NUM_MASKS, mask_block=0, ones=False):
    """Realistic tail inputs: frames in [0, 1] (or all ones, so that a wrong
    halo shows at the border), normalized kernels, softmax masks in the
    full-resolution layout or blocked by ``mask_block``."""
    from visual_foresight_torch.ops.cdna_warp import normalize_kernels
    from visual_foresight_torch.ops.layout import space_to_depth
    dev = 'cuda'
    offset = 2 if sna else 1
    rand = lambda *s: torch.ones(s, device=dev) if ones else \
        torch.rand(s, generator=gen, device=dev)
    kernels = normalize_kernels(torch.rand((b, k, k, m), generator=gen,
                                           device=dev))
    masks = torch.softmax(2.0 * torch.randn(
        (b, h, w, m + offset), generator=gen, device=dev), dim=-1)
    if mask_block > 1:
        masks = space_to_depth(masks, mask_block)
    ts = (rand(b, h, w, c), rand(b, h, w, c), rand(b, h, w, p),
          rand(b, h, w, p), kernels, masks)
    return tuple(t.to(dtype).contiguous() for t in ts)


def check_tail(gen, b, dtype, label='serving shape', mask_block=0, **shape):
    """One launch against the plain version on the same inputs; the launch
    must read the masks blocked where they come blocked at r = 2 or 4.
    Returns the max abs error."""
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite, fused_warp_composite_reference)
    sna = shape.get('sna', True)
    args = tail_inputs(gen, b, dtype, mask_block=mask_block, **shape)
    before = (fused_warp_composite.launches,
              fused_warp_composite.blocked_launches)
    got = fused_warp_composite(*args, sna=sna, mask_block=mask_block)
    want = fused_warp_composite_reference(*args, sna=sna,
                                          mask_block=mask_block)
    torch.cuda.synchronize()
    took = (fused_warp_composite.launches - before[0],
            fused_warp_composite.blocked_launches - before[1])
    err = max(float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
              for g, w in zip(got, want))
    tol = TAIL_TOL[dtype]
    print('tail kernel vs plain ({}): B={} {} {} mask_block={} launches, '
          'blocked={}: max_abs_err={:.3e} (tol {:.0e})'.format(
              label, b, str(dtype).split('.')[-1], shape, mask_block, took,
              err, tol))
    if took != (1, int(mask_block in (2, 4))):
        raise AssertionError('expected one launch, {} blocked masks'.format(
            'on' if mask_block in (2, 4) else 'not on'))
    if not err <= tol:
        raise AssertionError('tail kernel disagrees with its plain version')
    return err


def eff_inputs(gen, b, dtype, sna=True, p=P, h=H, w=W, c=C, k=K,
               ones=False):
    """Inputs of the effective-kernel entry as DNA makes them: frames in
    [0, 1] (or all ones), normalized per-pixel kernels weighed by the
    transform masks' total, and the background masks that complete it."""
    dev, nbg = 'cuda', 2 if sna else 1
    rand = lambda *s: torch.ones(s, device=dev) if ones else \
        torch.rand(s, generator=gen, device=dev)
    masks = torch.softmax(2.0 * torch.randn((b, h, w, nbg + 1), generator=gen,
                                            device=dev), dim=-1)
    pk = torch.rand((b, h, w, k * k), generator=gen, device=dev)
    eff = pk / pk.sum(-1, keepdim=True) * masks[..., nbg:]
    ts = (rand(b, h, w, c), rand(b, h, w, c), rand(b, h, w, p),
          rand(b, h, w, p), eff, masks[..., :nbg])
    return tuple(t.to(dtype).contiguous() for t in ts)


def check_eff(gen, b, dtype, sna=True, ones=False, **shape):
    """One launch of the effective-kernel entry against its plain version
    on the same inputs.  Returns the max abs error."""
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite_eff, fused_warp_composite_eff_reference)
    args = eff_inputs(gen, b, dtype, sna=sna, ones=ones, **shape)
    before = fused_warp_composite_eff.launches
    got = fused_warp_composite_eff(*args, sna=sna)
    want = fused_warp_composite_eff_reference(*args, sna=sna)
    torch.cuda.synchronize()
    err = max(float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
              for g, w in zip(got, want))
    tol = TAIL_TOL[dtype]
    if fused_warp_composite_eff.launches != before + 1:
        raise AssertionError('the eff entry did not launch its kernel')
    if not err <= tol:
        print('eff kernel vs plain: B={} {} sna={} {}: max_abs_err={:.3e} '
              '(tol {:.0e})'.format(b, str(dtype).split('.')[-1], sna, shape,
                                    err, tol))
        raise AssertionError('the eff kernel disagrees with its plain '
                             'version')
    return err


def dna_inputs(gen, b, dtype, mask_dtype=torch.float32, sna=True, p=P, h=H,
               w=W, c=C, k=K, m=NUM_MASKS, ones=False):
    """Inputs of the DNA mode as the DNA head and the mask head leave them:
    frames in [0, 1] (or all ones), logits of the per-pixel kernels (some
    below zero, so that the ReLU shift matters) in ``dtype``, and softmax
    masks over the background and ``m`` transform masks in ``mask_dtype``."""
    dev, nc = 'cuda', m + (2 if sna else 1)
    rand = lambda *s: torch.ones(s, device=dev) if ones else \
        torch.rand(s, generator=gen, device=dev)
    logits = torch.randn((b, h, w, k * k), generator=gen, device=dev) * 0.5 \
        + 0.3
    masks = torch.softmax(2.0 * torch.randn((b, h, w, nc), generator=gen,
                                            device=dev), dim=-1)
    ts = (rand(b, h, w, c), rand(b, h, w, c), rand(b, h, w, p),
          rand(b, h, w, p), logits)
    return tuple(t.to(dtype).contiguous() for t in ts) + \
        (masks.to(mask_dtype).contiguous(),)


def check_dna(gen, b, dtype, mask_dtype, sna=True, ones=False, **shape):
    """One launch of the DNA mode against its plain version on the same
    inputs.  Returns the max abs error."""
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite_dna, fused_warp_composite_dna_reference)
    args = dna_inputs(gen, b, dtype, mask_dtype, sna=sna, ones=ones, **shape)
    before = fused_warp_composite_dna.launches
    got = fused_warp_composite_dna(*args, sna=sna)
    want = fused_warp_composite_dna_reference(*args, sna=sna)
    torch.cuda.synchronize()
    err = max(float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
              for g, w in zip(got, want))
    tol = TAIL_TOL[dtype]
    if fused_warp_composite_dna.launches != before + 1:
        raise AssertionError('the DNA mode did not launch its kernel')
    if not err <= tol:
        print('DNA kernel vs plain: B={} {} masks {} sna={} {}: max_abs_err='
              '{:.3e} (tol {:.0e})'.format(b, str(dtype).split('.')[-1],
                                          str(mask_dtype).split('.')[-1], sna,
                                          shape, err, tol))
        raise AssertionError('the DNA kernel disagrees with its plain '
                             'version')
    return err


def check_eff_cases(gen):
    """The effective-kernel entry, and the DNA mode with f32 masks and with
    masks in the compute type, in bf16 and f32 at B=768 and 200, P 0-3, SNA
    on and off, K 3, 5 and 7 (48x64, C=3), and at odd sizes.  Returns the
    largest bf16 error at the serving shape (K=5, P=1, SNA) of each:
    ``{'eff': err, 'dna': err}``."""
    def check(mode, dtype, mask_dtype, **kw):
        if mode == 'eff':
            return check_eff(gen, dtype=dtype, **kw)
        return check_dna(gen, dtype=dtype, mask_dtype=mask_dtype, **kw)

    types = {'eff': [(torch.bfloat16, None), (torch.float32, None)],
             'dna': [(torch.bfloat16, torch.float32),
                     (torch.bfloat16, torch.bfloat16),
                     (torch.float32, torch.float32)]}
    serving = {}
    for mode, pairs in types.items():
        worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
        serving[mode] = 0.0
        n = 0
        for dtype, mask_dtype in pairs:
            for b in EFF_BATCHES:
                for p in EFF_PS:
                    for sna in (True, False):
                        for k in EFF_KS:
                            err = check(mode, dtype, mask_dtype, b=b,
                                        sna=sna, p=p, k=k)
                            worst[dtype] = max(worst[dtype], err)
                            n += 1
                            if dtype == torch.bfloat16 and (p, k, sna) == \
                                    (P, K, True):
                                serving[mode] = max(serving[mode], err)
            for shape in EFF_ODD:
                for ones in (False, True):
                    worst[dtype] = max(worst[dtype], check(
                        mode, dtype, mask_dtype, ones=ones, **shape))
                    n += 1
        print('{} kernel vs plain: {} launches (B {}, P {}, SNA on/off, K {}, '
              'odd sizes {}{}), max_abs_err bf16 {:.3e} (tol {:.0e}), f32 '
              '{:.3e} (tol {:.0e}); serving shape bf16 {:.3e}'.format(
                  mode, n, EFF_BATCHES, EFF_PS, EFF_KS, EFF_ODD,
                  '; bf16 with f32 and bf16 masks' if mode == 'dna' else '',
                  worst[torch.bfloat16], TAIL_TOL[torch.bfloat16],
                  worst[torch.float32], TAIL_TOL[torch.float32],
                  serving[mode]))
    return serving


def check_tail_cases(gen):
    """The serving shapes and ``TAIL_CASES``, in both types and in each
    case's mask layouts.  Returns the largest bf16 errors at the serving
    shapes: of one packed plane (C=3, P=1), and of two at the registration
    path's shape (B=768, C=3, P=2)."""
    err_bf16 = reg_bf16 = 0.0
    # the batches of the driven paths: a chunk or the 200-sample replan,
    # the campaigns' 768, 800 in one batch, the hard set's 768 x 2 copies,
    # the chunked replan's re-roll of the visualised elites, the RoboNet
    # and folding policies' 600 (B=1 is among TAIL_CASES)
    for b in (M, CTRL_POLICY['num_samples'], CHUNK_POLICY['num_samples'],
              2 * AG_POLICY['num_samples'], N_VIS,
              ROBONET_POLICY['num_samples']):
        for mask_block in (0, MASK_BLOCK):
            err_bf16 = max(err_bf16, check_tail(gen, b, torch.bfloat16,
                                                mask_block=mask_block))
            check_tail(gen, b, torch.float32, mask_block=mask_block)
    for label, case in TAIL_CASES:
        shape = dict({'b': 6, 'h': 20, 'w': 36}, **case)
        blocks = shape.pop('blocks')
        b = shape.pop('b')
        for mask_block in blocks:
            for dtype in (torch.bfloat16, torch.float32):
                for ones in (False, True):
                    check_tail(gen, b, dtype, label, mask_block,
                               ones=ones, **shape)
    # the registration paths: two designated pixels a camera, C + P = 5, at
    # the benchmark's 768 samples and the two-camera experiment's 200
    for b in TWO_PLANE_BATCHES:
        for mask_block in (MASK_BLOCK, 0):
            for dtype in (torch.bfloat16, torch.float32):
                for ones in (False, True):
                    err = check_tail(gen, b, dtype, 'registration shape',
                                     mask_block, ones=ones, p=REG_P)
                    if dtype == torch.bfloat16 and not ones:
                        reg_bf16 = max(reg_bf16, err)
    return err_bf16, reg_bf16


def reset_tail_counts():
    from visual_foresight_torch.ops.conv_lstm_ln import (bias_layer_norm,
                                                         conv_lstm_ln)
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite, fused_warp_composite_dna,
        fused_warp_composite_eff)
    fused_warp_composite.launches = 0
    fused_warp_composite.blocked_launches = 0
    fused_warp_composite_eff.launches = 0
    fused_warp_composite_dna.launches = 0
    conv_lstm_ln.launches = 0
    bias_layer_norm.launches = 0


def read_tail_counts(path, want, hp):
    """The launches since ``reset_tail_counts``: ``want`` in all, each
    through the entry and on the mask layout that the architecture ``hp``
    gives (a predictor's ``_hp``, or ``model_hp`` of a model).  DNA runs the DNA mode (the field made inside the
    kernel), never the field-given entry; CDNA the folded entry, on blocked
    masks where the space-to-depth backbone keeps
    its low-resolution softmax (the serving predictor), else on
    full-resolution masks (the classic backbone).  Every step of those
    launches the conv-LSTM kernel once a cell (``lstm_launches``: 3 on the
    space-to-depth backbone, 5 on the classic one) and the stand-alone
    LayerNorm ``norm_launches`` times (2 on the classic backbone, none on
    the space-to-depth one).  Returns the counters as read, by kernel
    entry: ``{'cdna_tail': n, 'cdna_tail_eff': n, 'cdna_tail_dna': n,
    'conv_lstm_ln': n, 'bias_layer_norm': n}``."""
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite, fused_warp_composite_dna,
        fused_warp_composite_eff)
    from visual_foresight_torch.ops.conv_lstm_ln import (bias_layer_norm,
                                                         conv_lstm_ln)
    dna = bool(hp['dna'])
    blocked = bool(hp['std_factor']) and hp['mask_softmax'] == 'lowres'
    want_folded, want_dna = (0, want) if dna else (want, 0)
    launches = fused_warp_composite.launches
    on_blocks = fused_warp_composite.blocked_launches
    eff = fused_warp_composite_eff.launches
    dna_launches = fused_warp_composite_dna.launches
    print('{} path: {} tail kernel launches (expected {}), {} on blocked '
          'masks; {} DNA-mode launches (expected {}), {} of the field-given '
          'entry (expected 0)'.format(path, launches, want_folded, on_blocks,
                                      dna_launches, want_dna, eff))
    if launches != want_folded or dna_launches != want_dna or eff:
        raise AssertionError('the {} path did not run the tail kernels {}, '
                             '{} and 0 times'.format(path, want_folded,
                                                     want_dna))
    if on_blocks != (want_folded if blocked else 0):
        raise AssertionError('the {} path did not keep its masks {}'.format(
            path, 'blocked' if blocked else 'at full resolution'))
    cells, want_cells = conv_lstm_ln.launches, want * lstm_launches(hp)
    print('{} path: {} conv-LSTM kernel launches (expected {})'.format(
        path, cells, want_cells))
    if cells != want_cells:
        raise AssertionError('the {} path ran the conv-LSTM kernel {} times, '
                             'not {}'.format(path, cells, want_cells))
    norms, want_norms = bias_layer_norm.launches, want * norm_launches(hp)
    print('{} path: {} stand-alone LayerNorm launches (expected {})'.format(
        path, norms, want_norms))
    if norms != want_norms:
        raise AssertionError('the {} path ran the stand-alone LayerNorm {} '
                             'times, not {}'.format(path, norms, want_norms))
    return {'cdna_tail': launches, 'cdna_tail_eff': eff,
            'cdna_tail_dna': dna_launches,
            'conv_lstm_ln': cells, 'bias_layer_norm': norms}


def lstm_launches(hp):
    """Conv-LSTM kernel launches in one model step of the architecture
    ``hp`` (a predictor's ``_hp``, or ``model_hp`` of a model): one a cell,
    3 on the space-to-depth backbone and 5 on the classic one."""
    return 3 if hp['std_factor'] else 5


def norm_launches(hp):
    """Stand-alone LayerNorm launches (``bias_layer_norm``) in one model
    step of the architecture ``hp``: ``ln0`` and ``ln6`` on the classic
    backbone, none on the space-to-depth one."""
    return 0 if hp['std_factor'] else 2


def read_no_tail(path):
    """No tail launch since ``reset_tail_counts``, through any entry."""
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite, fused_warp_composite_dna,
        fused_warp_composite_eff)
    launches = {'cdna_tail': fused_warp_composite.launches,
                'cdna_tail_eff': fused_warp_composite_eff.launches,
                'cdna_tail_dna': fused_warp_composite_dna.launches}
    print('{} path: tail launches {} (expected none)'.format(path, launches))
    if any(launches.values()):
        raise AssertionError('the {} path launched the tail'.format(path))
    return launches


def graph_ms(fn, arg_sets, reps):
    """Device time of one ``fn`` call: ``reps`` calls cycling through
    ``arg_sets`` (together larger than L2) captured in one CUDA graph,
    timed with CUDA events, median of 5 replays."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def tail_bound(args, outs, sna):
    """Least time for the tail on an H100 SXM: every input read once and
    every output written once, against the f32 arithmetic the in-bounds
    taps need."""
    b, h, w, c = args[0].shape
    p, m = args[2].shape[-1], args[4].shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in args + outs)
    pad = K // 2
    rows = K * h - 2 * sum(range(1, pad + 1))   # in-bounds (row, tap-row)
    cols = K * w - 2 * sum(range(1, pad + 1))
    taps = b * rows * cols                      # in-bounds (pixel, tap)
    fma = taps * (m + c + p) + b * h * w * (c + p) * (2 if sna else 1)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2 * fma / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations'), t_bytes * 1e3


def profile_replan(run, what='replan'):
    """Device time by kernel over one replan (or the ``what`` that ``run``
    does; ``torch.profiler``) and the device's busy share of its wall time,
    printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not spans:
        print('profile: no device events recorded (breakdown not measured)')
        return
    busy, end = 0.0, None
    for a, b in sorted(spans):      # union of device intervals
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    print('profile of one {} (profiler on): wall {:.3f} ms, {} device '
          'kernels, device busy {:.3f} ms = {:.1%} of wall'.format(
              what, wall_us / 1e3, len(spans), busy / 1e3, busy / wall_us))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (n, us) in top:
        print('  {:9.3f} ms {:5d}x  {}'.format(us / 1e3, n, name[:90]))


def compare_scores(label, got, want, k, rtol, per_element=False):
    """Scores of two replans of the same plans, iteration by iteration:
    within ``rtol`` (of each score, or of the largest score) with the same
    ``k`` elites.  Where the elites differ, each swapped sample must score
    within that tolerance of the k-th elite (a tie), and later iterations,
    sampled from a different refit, are not compared.  Returns whether every
    iteration had the same elites, and the largest error."""
    worst = 0.0
    for itr in range(len(want)):
        sg = torch.as_tensor(got[itr]).float().cpu()
        sw = torch.as_tensor(want[itr]).float().cpu()
        diff = (sg - sw).abs()
        if per_element:
            err, tol = float((diff / sw.abs()).max()), rtol
        else:
            err, tol = float(diff.max()), rtol * float(sw.abs().max())
        worst = max(worst, err)
        eg = set(torch.topk(-sg, k).indices.tolist())
        ew = set(torch.topk(-sw, k).indices.tolist())
        print('{}, iteration {}: max score {} {:.3e} (tol {:.3e}), elites '
              'equal: {}'.format(label, itr, 'rel err' if per_element
                                 else 'diff', err, tol, eg == ew))
        if not err <= tol:
            raise AssertionError('{}: scores disagree'.format(label))
        if eg != ew:
            kth = float(torch.topk(-sw, k).values[-1].neg())
            gap = max(abs(float(sw[i]) - kth) for i in eg ^ ew)
            gap_tol = rtol * abs(kth) if per_element else tol
            print('elites differ at the boundary: gap {:.3e} (tol {:.3e})'
                  .format(gap, gap_tol))
            if not gap <= gap_tol:
                raise AssertionError('{}: elite sets disagree beyond a tie'
                                     .format(label))
            return False, worst
    return True, worst


def restored_predictor(dtype, weights=WEIGHTS, **hparams):
    """``TorchPredictor`` on the card with the numpy weights under
    ``weights`` (and the serving ``hparams`` given); raises if they did not
    restore."""
    from visual_foresight_torch.prediction.predictor import TorchPredictor
    predictor = TorchPredictor(weights, dict(hparams, dtype=dtype),
                               device='cuda').restore()
    n_params = sum(p.numel() for p in predictor.models[0].parameters())
    print('predictor ({}, {}{}): restored={} params={}'.format(
        os.path.basename(weights), dtype,
        ''.join(', {}={}'.format(k, v) for k, v in hparams.items()),
        predictor.restored, n_params))
    if not predictor.restored:
        raise AssertionError('the weights under {} did not restore'.format(
            weights))
    return predictor


def check_golden(name, **hparams):
    """Replay the JAX package's f32 replan of the restored export ``name``
    (plan noise injected, and the latents where the model has one), with
    the serving ``hparams`` given.  Returns (launches by kernel, score
    error, frame error)."""
    from visual_foresight_torch.planners.cem import FusedCEMPlanner
    from visual_foresight_torch.planners.costs import distance_grid
    from visual_foresight_torch.planners.gaussian import make_action_spec
    weights = os.path.join(os.path.dirname(WEIGHTS), name)
    with np.load(os.path.join(weights, 'golden_replan_f32.npz')) as f:
        g = {k: f[k] for k in f.files}
    predictor = restored_predictor('float32', weights, **hparams)
    k_elite, repeat = int(g['k_elite']), int(g['repeat'])
    spec = make_action_spec(dict(SPEC_HP[name], nactions=int(g['nactions']),
                                 repeat=repeat), g['ctx_actions'].shape[-1])
    planner = FusedCEMPlanner(spec, int(g['num_samples']),
                              iterations=int(g['iterations']),
                              k_elite=k_elite,
                              finalweight=float(g['finalweight']),
                              n_vis=int(g['n_vis']), device='cuda')
    reset_tail_counts()
    out = planner.replan(
        predictor.models, g['images'], g['states'], g['distribs'],
        g['ctx_actions'], distance_grid(g['goal'], H, W, device='cuda'),
        g['mean0'], g['sigma0'], noise=g['noise'], latents=g.get('latents'))
    torch.cuda.synchronize()
    steps = 1 + int(g['iterations']) * int(g['nactions']) * repeat
    label = ' '.join([name] + ['{}={}'.format(k, v)
                               for k, v in hparams.items()])
    launches = read_tail_counts('golden ' + label, steps, predictor._hp)
    same, score_err = compare_scores(
        'golden f32 replay of {} vs JAX'.format(label), out['scores_per_itr'],
        g['scores_per_itr'], k_elite, GOLDEN_SCORE_RTOL, per_element=True)
    if not same:
        raise AssertionError('golden {}: the elites differ'.format(label))
    # frames of the elites both sides returned, matched by sample index
    idx = out['vis']['indices'].tolist()
    pairs = [(idx.index(i), j) for j, i in
             enumerate(g['vis_indices'].tolist()) if i in idx]
    if not pairs:
        raise AssertionError('golden {}: no visualised elite in common'
                             .format(label))
    frames = out['vis']['gen_images'][:, repeat - 1::repeat].cpu()
    frame_err = max(float((frames[a] - torch.tensor(
        g['vis_gen_images'][b])).abs().max()) for a, b in pairs)
    print('golden frames of {} elites ({}): max abs err {:.3e} (tol '
          '{:.0e})'.format(len(pairs), label, frame_err, GOLDEN_FRAME_ATOL))
    if not frame_err <= GOLDEN_FRAME_ATOL:
        raise AssertionError('golden frames disagree with JAX')
    return launches, score_err, frame_err


def check_golden_mppi():
    """Replay the JAX package's f32 MPPI replan of the restored ag_r5f_v2
    (``golden_mppi_f32.npz``: normals, latents and the anchor injected)."""
    from visual_foresight_torch.planners.cem import FusedCEMPlanner
    from visual_foresight_torch.planners.costs import distance_grid
    from visual_foresight_torch.planners.gaussian import ActionSpec
    with np.load(os.path.join(AG_WEIGHTS, 'golden_mppi_f32.npz')) as f:
        g = {k: f[k] for k in f.files}
    predictor = restored_predictor('float32', AG_WEIGHTS)
    k_elite, n = int(g['k_elite']), int(g['nactions'])
    stds = tuple(float(x) for x in g['per_dim_std'])
    spec = ActionSpec(adim=len(stds), nactions=n, repeat=1,
                      per_dim_std=stds, clip_dims_xy=(), clip_dims_rot=(),
                      rej_dims_xy=(), rej_dims_lift=(), xy_std=stds[0],
                      lift_std=stds[2])
    planner = FusedCEMPlanner(
        spec, int(g['num_samples']), iterations=int(g['iterations']),
        k_elite=k_elite, finalweight=float(g['finalweight']),
        n_vis=int(g['n_vis']), device='cuda',
        mppi={'kappa': float(g['kappa']), 'beta_0': float(g['beta_0']),
              'beta_1': float(g['beta_1']), 'refit_cov': False,
              'mean_bias': None, 'per_dim_std': stds})
    reset_tail_counts()
    out = planner.replan(
        predictor.models, g['images'], g['states'], g['distribs'],
        g['ctx_actions'], distance_grid(g['goal'], H, W, device='cuda'),
        g['mean0'], g['sigma0'], noise=g['noise'], latents=g['latents'],
        anchor=g['anchor'], anchor_valid=float(g['anchor_valid']))
    torch.cuda.synchronize()
    launches = read_tail_counts('golden MPPI ag_r5f_v2',
                                1 + int(g['iterations']) * n, predictor._hp)
    same, score_err = compare_scores(
        'golden f32 MPPI replay of ag_r5f_v2 vs JAX', out['scores_per_itr'],
        g['scores_per_itr'], k_elite, GOLDEN_SCORE_RTOL, per_element=True)
    if not same:
        raise AssertionError('the MPPI golden elites differ')
    idx = out['vis']['indices'].tolist()
    if idx != g['vis_indices'].tolist():
        raise AssertionError('the MPPI golden visualised elites differ')
    frames = out['vis']['gen_images'][:, 2::3].cpu()
    frame_err = float((frames - torch.tensor(g['vis_gen_images'])).abs()
                      .max())
    mean_err = float((out['mean'].cpu() - torch.tensor(g['mean'])).abs()
                     .max())
    print('golden MPPI frames of {} elites: max abs err {:.3e} (tol {:.0e}); '
          'mean plan max abs err {:.3e}'.format(len(idx), frame_err,
                                                GOLDEN_FRAME_ATOL, mean_err))
    if not (frame_err <= GOLDEN_FRAME_ATOL and mean_err <= GOLDEN_FRAME_ATOL):
        raise AssertionError('golden MPPI frames or mean disagree with JAX')
    return launches, score_err, frame_err


def print_report(source, report, seconds):
    print('built {} in {:.1f} s'.format(source, seconds))
    for line in report.splitlines():
        if any(k in line for k in ('entry function', 'Used', 'spill')):
            print('  ' + line.strip())


def check_probe(gen):
    """Toolchain probe: drive the probe once (counted), then hold add_one
    against ``x + 1`` on random values.  Returns (launches, max_abs_err)."""
    from visual_foresight_torch.ops.probe import (PROBE_SHAPE, add_one,
                                                  add_one_reference,
                                                  toolchain_probe)
    add_one.launches = 0
    toolchain_probe('cuda')
    torch.cuda.synchronize()
    launches = add_one.launches
    print('toolchain probe: add_one(zeros{}) == 1 everywhere, {} launch'
          .format(PROBE_SHAPE, launches))
    if launches != 1:
        raise AssertionError('the probe did not launch add_one once')
    x = torch.randn(PROBE_SHAPE, generator=gen, device='cuda') * 1e3
    got, want = add_one(x), add_one_reference(x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print('add_one vs x + 1 at {}: max_abs_err={:.3e} (must be 0)'.format(
        PROBE_SHAPE, err))
    if not torch.equal(got, want):
        raise AssertionError('add_one is not x + 1')
    # an odd length, a tensor sliced one element in (not 16-byte aligned,
    # while its output is) and an empty tensor
    base = torch.randn(4099, generator=gen, device='cuda') * 1e3
    for label, x in (('odd length', base[:4097]),
                     ('sliced one element in', base[1:]),
                     ('empty', base[:0])):
        got = add_one(x)
        torch.cuda.synchronize()
        if not torch.equal(got, add_one_reference(x)):
            raise AssertionError('add_one is not x + 1 ({})'.format(label))
        print('add_one {} (n={}): exact'.format(label, x.numel()))
    return launches, err


def replan_200(predictor, name='xz_flagship'):
    """``replan(images, states, **noise)``: one 200 x 15 x 3 replan of
    ``FusedCEMPlanner`` on ``predictor`` (the action spec of the checkpoint
    ``name`` at the predictor's ``adim``, a goal pixel and a point
    distribution)."""
    from visual_foresight_torch.planners.cem import FusedCEMPlanner
    from visual_foresight_torch.planners.costs import distance_grid
    from visual_foresight_torch.planners.gaussian import (initial_mean,
                                                          initial_sigma,
                                                          make_action_spec)
    adim = predictor._hp['adim']
    spec = make_action_spec(dict(SPEC_HP[name], nactions=NACT,
                                 repeat=REPEAT), adim)
    planner = FusedCEMPlanner(spec, M, iterations=ITERS, k_elite=10,
                              finalweight=10.0, action_bound=True,
                              n_vis=10, device='cuda')
    distribs = np.zeros((1, N_CTX, H, W, P), np.float32)
    distribs[:, :, 24, 32, 0] = 1.0
    ctx_actions = np.zeros((N_CTX - 1, adim), np.float32)
    grids = distance_grid([[[10.0, 50.0]]], H, W, device='cuda')
    mean0 = initial_mean(spec, device='cuda')
    sigma0 = initial_sigma(spec, device='cuda')

    def replan(images, states, **noise):
        return planner.replan(predictor.models, images, states, distribs,
                              ctx_actions, grids, mean0, sigma0, **noise)
    return replan


def drive_replan_200():
    """The 200-sample replan, on the restored weights in bf16: returns
    (launches, host latencies, replan function, contexts, generator)."""
    predictor = restored_predictor('bfloat16')
    replan = replan_200(predictor)
    rng = np.random.RandomState(0)
    contexts = [(rng.rand(1, N_CTX, H, W, 3).astype(np.float32),
                 (rng.randn(N_CTX, 3) * 0.05).astype(np.float32))
                for _ in range(N_WARM + N_TIMED)]
    plan_gen = torch.Generator(device='cuda').manual_seed(1)

    reset_tail_counts()
    latencies, outs = [], []
    for i, (images, states) in enumerate(contexts):
        t0 = time.perf_counter()
        out = replan(images, states, generator=plan_gen)
        torch.cuda.synchronize()
        if i >= N_WARM:
            latencies.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = read_tail_counts(
        '200-sample replan ({} replans, {} launches each)'.format(
            len(contexts), LAUNCHES_PER_REPLAN),
        LAUNCHES_PER_REPLAN * len(contexts), predictor._hp)
    for out in outs:
        shapes = {'best_actions': (10, T, 3), 'best_scores': (10,),
                  'scores_per_itr': (ITERS, M)}
        for key, shape in shapes.items():
            if tuple(out[key].shape) != shape or \
                    not bool(torch.isfinite(out[key]).all()):
                raise AssertionError('replan output {} is {} or not finite'
                                     .format(key, tuple(out[key].shape)))
        vis = out['vis']['gen_images']
        if tuple(vis.shape) != (10, T, 1, H, W, 3) or \
                not bool(torch.isfinite(vis).all()):
            raise AssertionError('elite videos malformed')
    print('replan outputs finite; best score {:.4f}'.format(
        float(outs[-1]['best_scores'][0])))
    return launches, latencies, replan, contexts, plan_gen


def check_plain_tail_replan(replan, label, k, rtol=SCORE_RTOL,
                            per_element=False, same_elites=False):
    """``replan()`` (one replan on fixed inputs and draws, returning its
    scores by iteration and its elites) once with the tail kernel and once
    with the plain tail on the card: the scores within ``rtol``
    (``compare_scores``) and, with ``same_elites``, the same elites."""
    from visual_foresight_torch.models import cdna as cdna_model
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite, fused_warp_composite_reference)
    scores_k, elites_k = replan()
    cdna_model.fused_warp_composite = fused_warp_composite_reference
    try:
        scores_p, elites_p = replan()
    finally:
        cdna_model.fused_warp_composite = fused_warp_composite
    torch.cuda.synchronize()
    same, _ = compare_scores(label, scores_k, scores_p, k, rtol, per_element)
    if same_elites and (not same or not np.array_equal(elites_k, elites_p)):
        raise AssertionError('{}: the plain tail chose other elites'.format(
            label))


def check_plain_tail_replan_200(replan, contexts, plan_gen):
    """The same 200-sample replan with the plain tail on the card."""
    noise = torch.randn((ITERS, M, NACT * 3), generator=plan_gen,
                        device='cuda')
    images, states = contexts[0]

    def run():
        out = replan(images, states, noise=noise)
        return out['scores_per_itr'], None
    # replan_200's planner keeps 10 elites
    check_plain_tail_replan(run, 'replan kernel vs plain tail', 10)


def with_sampler(policy, name):
    """``policy`` with the port's sampler class ``name``."""
    from visual_foresight_torch.policy.cem_controllers.samplers import (
        autograsp_epsilon, autograsp_sampler, correlated_noise,
        folding_sampler)
    cls = {'mppi': correlated_noise.CorrelatedNoiseSampler,
           'autograsp': autograsp_sampler.AutograspSampler,
           'ag_epsilon': autograsp_epsilon.AutograspEpsilon,
           'folding': folding_sampler.FoldingCEMSampler}[name]
    return dict(policy, sampler=cls)


def check_restored(label, ctrl):
    """Every network of ``ctrl`` restored its numpy weights: the predictor,
    and the ensemble's members, the GDN, the classifier or the embedding
    where the controller has one."""
    flags = {'predictor': ctrl.predictor.restored}
    for attr in ('members_restored', 'gdn_restored', 'classifier_restored',
                 'embedding_restored'):
        if hasattr(ctrl, attr):
            flags[attr] = getattr(ctrl, attr)
    print('{} controller: restored {}'.format(label, flags))
    if not all(all(v) if isinstance(v, list) else v
               for v in flags.values()):
        raise AssertionError('the {} controller did not restore its '
                             'weights'.format(label))


def drive_controller(label, agent, policy, steps, cls=None, act_kw=None,
                     want=None, frames=None, states=None):
    """``act()`` of a ``cls`` controller (``PixelCostController`` by
    default) under ``policy`` for ``steps`` control steps on seeded
    synthetic frames of every camera and states (or ``frames`` and
    ``states`` given, a step each), with ``act_kw`` (the designated and
    goal pixels by default); a replan falls on the first planning step
    (``start_planning``, at least 1) and then every ``replan_interval``
    steps, earlier steps take warm-up actions.  Checks that the weights
    restored, the tail's launches (``read_tail_counts``: ``want`` a replan,
    or ``want(ctrl)`` where it is a function of the built controller,
    ``replan_launches(policy)`` by default), and that
    the actions and the last replan's scores are finite and of the
    expected shapes; frames are of the agent's size.  Returns (launches by
    kernel, controller, states)."""
    from visual_foresight_torch.policy.cem_controllers import (
        PixelCostController)
    ctrl = (cls or PixelCostController)(agent, dict(policy))
    check_restored(label, ctrl)
    adim, ncam = agent['adim'], agent.get('ncam', 1)
    h, w = agent.get('image_height', H), agent.get('image_width', W)
    rng = np.random.RandomState(2)
    if frames is None:
        frames = (rng.rand(steps, ncam, h, w, 3) * 255).astype(np.uint8)
        states = (rng.randn(steps, agent['sdim']) * 0.05).astype(np.float32)
    if act_kw is None:
        act_kw = {'desig_pix': np.array([[[24, 32]]]),
                  'goal_pix': np.array([[[10, 50]]])}
    # the controller's own values: a key that equals its default may be
    # left out of ``policy``
    hp = ctrl._hp
    stochastic = hp.stochastic_planning if 'stochastic_planning' in hp \
        else None
    start = max(hp.start_planning, N_CTX - 1)
    replans = 1 + (steps - 1 - start) // hp.replan_interval
    per_replan = want(ctrl) if callable(want) else \
        want or replan_launches(policy)
    ctrl.reset()
    reset_tail_counts()
    actions, n_samples = [], []
    for t in range(steps):
        out = ctrl.act(t=t, i_tr=0, images=frames[:t + 1],
                       state=states[:t + 1], **act_kw)
        actions.append(np.asarray(out['actions'], np.float32))
    torch.cuda.synchronize()
    launches = read_tail_counts(
        '{} controller ({} act() steps, {} replans x {})'.format(
            label, steps, replans, per_replan),
        replans * per_replan, ctrl.predictor._hp)
    for a in actions:
        if a.shape != (adim,) or not np.isfinite(a).all():
            raise AssertionError('{} controller action {} is malformed'
                                 .format(label, a))
    rows = hp.num_samples * (stochastic or (1,))[0]
    for itr in range(hp.iterations):
        scores = out['plan_stat']['scores_itr{}'.format(itr)]
        n_samples.append(scores.shape[-1])
        if scores.shape != (rows,) or not np.isfinite(scores).all():
            raise AssertionError('{} controller scores_itr{} malformed'
                                 .format(label, itr))
    print('{} controller actions finite, shape ({},); scores_itr* lengths '
          '{}; last action {}'.format(label, adim, n_samples, actions[-1]))
    if policy.get('predictor_propagation') and \
            not hasattr(ctrl, 'members_restored'):
        # the next replan's context: the best plan's predicted distribution
        # (the ensemble's loop, as JAX's, keeps the start pixel's)
        d = ctrl._chosen_distrib
        if d.shape != (N_CTX, ncam, h, w, ctrl._n_desig) or \
                not np.isfinite(d).all() or \
                not d.sum() > 0:
            raise AssertionError('{}: propagated distribution malformed'
                                 .format(label))
        print('{} propagated distribution: shape {}, mass per frame {}'
              .format(label, d.shape, d.sum(axis=(1, 2, 3, 4))))
    return launches, ctrl, states


def check_grip(label, ctrl, policy, ag_epsilon=False):
    """The derived grip (the last action dim) holds only the close and open
    commands: in every elite of the last replan under the autograsp latch.
    AutograspEpsilon transforms the first ``max(int(M * base_frac *
    base_frac_reduce ** itr), 1)`` plans of iteration ``itr``: its elites
    among those of the last iteration are checked, and one draw of the
    first iteration's plans (all M transformed) on the controller's
    generator, which launches no kernel."""
    hp = ctrl._hp
    grip = ctrl._best_actions[..., -1]
    rows = np.arange(grip.shape[0])
    if ag_epsilon:
        cmds = {1.0, -1.0}
        amount = max(int(policy['num_samples'] * hp.base_frac *
                         hp.base_frac_reduce ** (hp.iterations - 1)), 1)
        rows = rows[ctrl._best_indices < amount]
        planner, dev = ctrl._fused, ctrl.device
        spec = planner.spec
        plans = planner._sample_plans(
            0, policy['num_samples'], torch.zeros(spec.nactions * spec.adim,
                                                  device=dev),
            torch.eye(spec.nactions * spec.adim, device=dev) * 0.01, None,
            None, 0.0, torch.zeros((N_CTX, ctrl._sdim), device=dev), None,
            ctrl._generator, {})
        first = set(torch.unique(plans[..., -1]).tolist())
        print('{}: grip commands of the first iteration\'s {} plans: {}'
              .format(label, plans.shape[0], sorted(first)))
        if not first <= cmds:
            raise AssertionError('{}: the first iteration\'s grip holds {}'
                                 .format(label, sorted(first)))
    else:
        cmds = {float(hp.gripper_close_cmd), float(hp.gripper_open_cmd)}
    values = set(np.unique(grip[rows]).tolist())
    print('{}: grip commands of {} of {} elites of the last replan: {}'
          .format(label, len(rows), grip.shape[0], sorted(values)))
    if not values <= cmds or not (len(rows) or ag_epsilon):
        raise AssertionError('{}: the derived grip holds {}'.format(
            label, sorted(values)))


# -- the other planning costs ---------------------------------------------------

def predictor_dirs(kind, seeds):
    """The predictors of the ensemble and registration paths: the
    ensemble's member list (the flagship, then its seeded copies) or the
    two-camera registration predictor (view 1 a seeded copy of the
    flagship), as ``campaigns/stand_ins.py`` writes them for the twins
    (``build/stand_ins/``, once)."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')         # the stand-ins named here
        if kind == 'ensemble':
            return [WEIGHTS] + [stand_ins.noisy_copy(
                'xz_flagship', int(s), 'an ensemble member') for s in seeds]
        (seed,) = seeds
        return stand_ins.second_view('xz_flagship', int(seed),
                                     'a second view')


def controller_class(kind):
    from visual_foresight_torch.policy.cem_controllers import (
        registration_controller, variants)
    return {'ensemble': variants.CEMControllerEnsembleVidPred,
            'registration': registration_controller.RegisterGtruthController,
            'classifier': variants.ClassifierController,
            'nce': variants.NCECostController}[kind]


def cost_launches(cost, values, ncam):
    """Tail launches of one replan of a planning-cost controller, from its
    policy's ``values`` (a policy dict, or a controller's
    ``_hp.values()``): each ensemble member runs one teacher-forced forward
    over the context action and the plan an iteration; the others
    ``replan_launches`` a camera."""
    if cost == 'ensemble':
        return values.get('num_ensembles', N_MEMBERS) * \
            values.get('iterations', ITERS) * \
            (N_CTX - 1 + values.get('T', DEFAULT_T))
    return ncam * replan_launches(values)


def check_controller_golden(kind, dirs):
    """Replay the JAX package's f32 replan of a planning-cost controller
    (``GOLDEN_PATHS``: act() at t=1, 24 samples x 15 steps x 3 iterations,
    the JAX draws injected) through the port's controller on the card:
    scores, elites, the action (and the tradeoffs and the registered
    pixels); then the same replan with the plain tail, which must choose
    the same elites with the scores within the golden's tolerance.
    Returns the launches."""
    from visual_foresight_torch.models.convert import read_npz
    g = read_npz(GOLDEN_PATHS[kind])
    agent, policy = json.loads(str(g['agent'])), json.loads(str(g['policy']))
    weights = {'ensemble': {'model_path': dirs},
               'registration': {'model_path': dirs,
                                'gdn_path': SEEDED['gdn']},
               'classifier': {'model_path': AG_WEIGHTS,
                              'classifier_path': SEEDED['classifier']},
               'nce': {'model_path': WEIGHTS,
                       'embedding_path': SEEDED['nce']}}[kind]
    ctrl = controller_class(kind)(agent, dict(policy, **weights))
    check_restored('golden ' + kind, ctrl)
    # the JAX draws: through the ensemble's _draw_normals, one iteration a
    # call, or given to every replan of the fused planner
    noise = torch.as_tensor(g['noise'], device=ctrl.device)
    latents = g.get('latents')
    if latents is not None:
        latents = torch.as_tensor(latents, device=ctrl.device)
    draws = [None]
    if kind == 'ensemble':
        ctrl._draw_normals = lambda m, dim: next(draws[0])
    else:
        replan = ctrl._fused.replan
        ctrl._fused.replan = lambda *a, generator, **kw: replan(
            *a, noise=noise, latents=latents, **kw)

    def replay():
        draws[0] = iter(noise)
        ctrl.reset()
        out = ctrl.act(t=1, i_tr=0, images=g['images'], state=g['states'],
                       **{k: g[k] for k in GOLDEN_ACT_KEYS[kind]})
        torch.cuda.synchronize()
        return out, [out['plan_stat']['scores_itr{}'.format(i)]
                     for i in range(g['scores_per_itr'].shape[0])]

    reset_tail_counts()
    out, scores = replay()
    launches = read_tail_counts(
        'golden {} (f32)'.format(kind),
        cost_launches(kind, ctrl._hp.values(), agent.get('ncam', 1)),
        ctrl.predictor._hp)
    best, best_actions = ctrl._best_indices.copy(), ctrl._best_actions.copy()
    registered = getattr(ctrl, 'reg_tradeoff', None), \
        getattr(ctrl, '_desig_pix', None)
    # the same replan with the plain tail: f32 on both sides, so the same
    # elites and the scores within the golden's tolerance
    from visual_foresight_torch.models import cdna as cdna_model
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite, fused_warp_composite_reference)
    cdna_model.fused_warp_composite = fused_warp_composite_reference
    try:
        _, plain_scores = replay()
    finally:
        cdna_model.fused_warp_composite = fused_warp_composite
    same, _ = compare_scores(
        '{} replan (golden inputs, f32), kernel vs plain tail'.format(kind),
        scores, plain_scores, ctrl.elite_count, GOLDEN_SCORE_RTOL,
        per_element=True)
    if not same or not np.array_equal(ctrl._best_indices, best):
        raise AssertionError('{}: the plain tail chose other elites'.format(
            kind))
    same, score_err = compare_scores(
        'golden f32 replay of the {} controller vs JAX'.format(kind), scores,
        g['scores_per_itr'], ctrl.elite_count, GOLDEN_SCORE_RTOL,
        per_element=True)
    if not same or not np.array_equal(best, g['best_indices']):
        raise AssertionError('golden {}: the elites differ'.format(kind))
    close = lambda a, b: np.allclose(a, b, rtol=GOLDEN_SCORE_RTOL,
                                     atol=GOLDEN_FRAME_ATOL)
    act_err = float(np.abs(best_actions - g['best_actions']).max())
    ok = close(best_actions, g['best_actions']) and \
        close(out['actions'], g['action'])
    extra = ''
    if kind == 'registration':
        tradeoff, desig = registered
        extra = '; tradeoffs {} (JAX {}), registered pixels equal: {}'.format(
            np.round(tradeoff, 6).tolist(),
            np.round(g['tradeoff'], 6).tolist(),
            np.array_equal(desig, g['desig_registered']))
        ok = ok and np.allclose(tradeoff, g['tradeoff'],
                                rtol=GOLDEN_SCORE_RTOL) and \
            np.array_equal(desig, g['desig_registered'])
    print('golden {}: elites equal, elites\' plans max abs err {:.3e} (rtol '
          '{:.0e}, atol {:.0e}){}'.format(kind, act_err, GOLDEN_SCORE_RTOL,
                                          GOLDEN_FRAME_ATOL, extra))
    if not ok:
        raise AssertionError('golden {}: the plans disagree with JAX'.format(
            kind))
    return launches


def check_inverse_golden():
    """The seeded inverse net on the card in f32 against the JAX package's
    plans (``golden_inverse_f32.npz``), atol 1e-5."""
    from visual_foresight_torch.models.convert import read_npz
    from visual_foresight_torch.policy.inverse_models. \
        inverse_model_base_controller import TorchInverseModel
    g = read_npz(os.path.join(SEEDED['inverse'], 'golden_inverse_f32.npz'))
    model = TorchInverseModel(SEEDED['inverse'], {
        'adim': 3, 'plan_T': 7, 'num_context': 2}).restore()
    if not model.restored:
        raise AssertionError('the inverse net did not restore')
    err = max(float(np.abs(model(g['current'][i], g['goal'][i], None,
                                 g['context'][i:i + 1]) -
                           g['plans'][i:i + 1]).max()) for i in range(4))
    print('golden inverse net (f32, 4 inputs): plans max abs err {:.3e} '
          '(tol {:.0e})'.format(err, INVERSE_ATOL))
    if not err <= INVERSE_ATOL:
        raise AssertionError('the inverse net disagrees with JAX')


def drive_inverse(card, policy, name, agent=INV_AGENT, profile=True):
    """``InvModelBaseController.act()`` under ``policy`` (``agent``:
    xz_bench20_inverse's widths at 48x64 by default) for ``INV_STEPS``
    steps (warm-up draws, then a plan from the net every ``replan_every``
    steps) on seeded frames of the agent's size: finite actions, no tail
    launch; the host p50 and CUDA-event span of a replan (one forward of
    the net, printed as ``<name>_replan_*``) and, with ``profile``, a
    profiled one.  Returns the launches (all 0)."""
    from visual_foresight_torch.policy.inverse_models. \
        inverse_model_base_controller import InvModelBaseController
    ctrl = InvModelBaseController(agent, dict(policy))
    print('{} controller: restored={} ({})'.format(
        name, ctrl.predictor.restored, policy['model_params_path']))
    if not ctrl.predictor.restored:
        raise AssertionError('the {} controller did not restore'.format(name))
    h, w = agent['image_height'], agent['image_width']
    rng = np.random.RandomState(2)
    frames = (rng.rand(INV_STEPS, 1, 1, h, w, 3) * 255).astype(np.uint8)
    goal = (rng.rand(1, 1, h, w, 3) * 255).astype(np.uint8)
    np.random.seed(0)
    ctrl.reset()
    reset_tail_counts()
    actions = [ctrl.act(t=t, i_tr=0, images=frames[t],
                        goal_image=goal)['actions'] for t in range(INV_STEPS)]
    torch.cuda.synchronize()
    launches = read_no_tail('{} controller ({} act() steps)'.format(
        name, INV_STEPS))
    if any(a.shape != (agent['adim'],) or not np.isfinite(a).all()
           for a in actions):
        raise AssertionError('{} controller actions malformed'.format(name))
    print('{} controller actions finite; last {}'.format(name, actions[-1]))
    ctx = np.stack(ctrl.context_frames)[None]
    cur, g0 = frames[-1, -1, 0] / 255.0, goal[-1, 0] / 255.0
    replan = lambda: ctrl.predictor(cur, g0, None, ctx)
    host, device = [], []
    for _ in range(CTRL_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        replan()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        device.append(start.elapsed_time(end))
    point = 'one forward of the inverse net, adim {}, {}x{}, f32'.format(
        agent['adim'], h, w)
    print('{}_replan_p50_ms={:.3f} ({}, host clock, {} replans: {}) '
          '[{}]'.format(name, float(np.percentile(host, 50)), point,
                        CTRL_TIMED, ' '.join('{:.3f}'.format(x)
                                             for x in host), card))
    print('{}_replan_device_ms={:.3f} ({}, CUDA events, median) [{}]'
          .format(name, float(np.percentile(device, 50)), point, card))
    if profile:
        print('profile: one {} replan'.format(name))
        profile_replan(replan)
    return launches


def time_controller(name, point, ctrl, states, card, timed=CTRL_TIMED,
                    want=None):
    """Host p50 of ``timed`` replans of the controller (``perform_CEM``,
    which ``act`` calls when a replan is due) and the device span of one
    more (CUDA events around it), printed as ``<name>_p50_ms`` and
    ``<name>_device_ms``; with ``want``, the tail launches of those
    replans are ``want`` each (``read_tail_counts``).  Returns (host p50,
    span) in ms."""
    if want is not None:
        reset_tail_counts()
    latencies = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctrl.perform_CEM(states)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    ctrl.perform_CEM(states)
    end.record()
    torch.cuda.synchronize()
    p50, span = float(np.percentile(latencies, 50)), start.elapsed_time(end)
    if want is not None:
        read_tail_counts('{} timed replans ({} x {})'.format(
            name, timed + 1, want), (timed + 1) * want, ctrl.predictor._hp)
    print('{}_p50_ms={:.3f} ({}, host clock, {} replans: {}) '
          '[{}]'.format(name, p50, point, timed,
                        ' '.join('{:.3f}'.format(x) for x in latencies),
                        card))
    print('{}_device_ms={:.3f} ({}, CUDA events around one '
          'replan) [{}]'.format(name, span, point, card))
    return p50, span


def time_tail(gen, b, card):
    """Kernel times of the tail at batch ``b`` (bf16) in both mask layouts,
    the plain version's time, the bound, the share of the card's memory rate
    the kernel reaches, and the ``depth_to_space`` copy of the masks that
    the blocked layout saves.  Returns a dict of the numbers."""
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite, fused_warp_composite_reference)
    from visual_foresight_torch.ops.layout import depth_to_space
    res = {}
    for name, r in (('blocked', MASK_BLOCK), ('full', 0)):
        sets = [tail_inputs(gen, b, torch.bfloat16, mask_block=r)
                for _ in range(4)]
        res[name + '_ms'] = graph_ms(
            lambda *a: fused_warp_composite(*a, sna=True, mask_block=r),
            sets, reps=100)
        if r:
            res['plain_ms'] = graph_ms(
                lambda *a: fused_warp_composite_reference(
                    *a, sna=True, mask_block=r), sets, reps=10)
            res['unblock_ms'] = graph_ms(
                lambda *a: depth_to_space(a[5], r), sets, reps=100)
            outs = fused_warp_composite_reference(*sets[0], sna=True,
                                                  mask_block=r)
            res['bound_ms'], res['bound_by'], bytes_ms = tail_bound(
                sets[0], outs, sna=True)
        del sets
    where = '(B={} bf16, CUDA graph, CUDA events) [{}]'.format(b, card)
    for name in ('blocked', 'full'):
        share = bytes_ms / res[name + '_ms']
        print('cdna_tail_kernel_ms={:.5f} mask layout {}, {:.1%} of 3.35 '
              'TB/s {}'.format(res[name + '_ms'], name, share, where))
        if share > 1.0:
            raise AssertionError('the tail moved its bytes faster than the '
                                 'card can: the timing is wrong')
    print('cdna_tail_plain_ms={:.5f} mask layout blocked {}'.format(
        res['plain_ms'], where))
    print('masks_depth_to_space_ms={:.5f} the copy the blocked layout saves '
          '{}'.format(res['unblock_ms'], where))
    print('cdna_tail_bound_ms={:.5f} (B={}, by {}; H100 SXM 3.35 TB/s, 67 '
          'TFLOP/s f32) [{}]'.format(res['bound_ms'], b, res['bound_by'],
                                     card))
    return res


def time_two_planes(gen, b, tiled_ms, card):
    """The tail kernel on two packed planes at the registration path's
    tail shape (batch ``b``, 48x64, C=3, P=2, blocked masks r=4, bf16):
    kernel and plain version (CUDA graph, CUDA events) beside its bound and
    the kernel's time at P=1 (``tiled_ms``).  Returns the numbers."""
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite, fused_warp_composite_reference)
    sets = [tail_inputs(gen, b, torch.bfloat16, p=REG_P,
                        mask_block=MASK_BLOCK) for _ in range(4)]
    res = {'ms': graph_ms(lambda *a: fused_warp_composite(
        *a, sna=True, mask_block=MASK_BLOCK), sets, reps=100),
           'plain_ms': graph_ms(lambda *a: fused_warp_composite_reference(
               *a, sna=True, mask_block=MASK_BLOCK), sets, reps=10)}
    outs = fused_warp_composite_reference(*sets[0], sna=True,
                                          mask_block=MASK_BLOCK)
    res['bound_ms'], res['bound_by'], bytes_ms = tail_bound(sets[0], outs,
                                                            sna=True)
    del sets, outs
    share = bytes_ms / res['ms']
    print('cdna_tail_tiled_two_planes_kernel_ms={:.5f} plain_ms={:.5f} '
          'bound_ms={:.5f} (by {}), {:.1%} of 3.35 TB/s, {:.2f}x the kernel '
          'at P=1 ({:.5f} ms) (B={} bf16, 48x64, C=3, P=2, blocked masks '
          'r=4, CUDA graph, CUDA events) [{}]'.format(
              res['ms'], res['plain_ms'], res['bound_ms'], res['bound_by'],
              share, res['ms'] / tiled_ms, tiled_ms, b, card))
    if share > 1.0:
        raise AssertionError('the two-plane kernel moved its bytes faster '
                             'than the card can: the timing is wrong')
    return res


# the sawyer registration experiment's tail: 400 samples a camera, 96x128,
# C=3, two designated pixels (P=2), masks blocked r=4
REG96_SHAPE = dict(b=400, h=96, w=128, c=C, p=REG_P)


def check_two_planes_96x128(gen, card):
    """The tail kernel on two packed planes at the sawyer registration
    experiment's tail shape (``REG96_SHAPE``, blocked masks r=4; also at
    full resolution): one launch against the plain version in f32 and
    bf16, on random and on all-one frames, then the bf16 kernel and its
    plain version timed (CUDA graph, CUDA events) beside the bound of its
    inputs.  A launch failure or a disagreement raises.  Returns the
    numbers and the largest bf16 error."""
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite, fused_warp_composite_reference)
    shape = dict(REG96_SHAPE)
    b = shape.pop('b')
    err = 0.0
    for mask_block in (MASK_BLOCK, 0):
        for dtype in (torch.bfloat16, torch.float32):
            for ones in (False, True):
                e = check_tail(gen, b, dtype,
                               'sawyer registration at 96x128', mask_block,
                               ones=ones, **shape)
                if dtype == torch.bfloat16:
                    err = max(err, e)
    sets = [tail_inputs(gen, b, torch.bfloat16, mask_block=MASK_BLOCK,
                        **shape) for _ in range(4)]
    res = {'ms': graph_ms(lambda *a: fused_warp_composite(
        *a, sna=True, mask_block=MASK_BLOCK), sets, reps=50),
           'plain_ms': graph_ms(lambda *a: fused_warp_composite_reference(
               *a, sna=True, mask_block=MASK_BLOCK), sets, reps=5)}
    outs = fused_warp_composite_reference(*sets[0], sna=True,
                                          mask_block=MASK_BLOCK)
    res['bound_ms'], res['bound_by'], bytes_ms = tail_bound(sets[0], outs,
                                                            sna=True)
    del sets, outs
    res['max_abs_err'] = err
    share = bytes_ms / res['ms']
    print('cdna_tail_tiled_two_planes_96x128_kernel_ms={:.5f} plain_ms={:.5f} '
          'bound_ms={:.5f} (by {}), {:.1%} of 3.35 TB/s (B={} bf16, 96x128, '
          'C=3, P=2, blocked masks r=4, CUDA graph, CUDA events); bf16 '
          'max_abs_err={:.3e} [{}]'.format(
              res['ms'], res['plain_ms'], res['bound_ms'], res['bound_by'],
              share, b, err, card))
    if share > 1.0:
        raise AssertionError('the two-plane variant at 96x128 moved its '
                             'bytes faster than the card can: the timing '
                             'is wrong')
    return res


# csrc/cdna_tail.cu's tile of the tiled variant (kTileH x kTileW pixels of
# one sample a block)
TILE_H, TILE_W = 8, 64


def report_two_plane_tiles(gen, b, card):
    """The two-plane tiled variant at batch ``b`` (C=3, P=2, blocked masks
    r=4, bf16) at 48x64 and at 96x128, side by side: its grid of tiles, the
    blocks an SM holds (``cdna_tail_tiled_occupancy``, the CUDA occupancy
    query at the launch's shared memory) and the waves they make over the
    card's SMs, each launch's time (CUDA graph, CUDA events) against its
    byte bound; then one launch at each shape under ``torch.profiler``.
    Returns the numbers by shape."""
    import ctypes
    from visual_foresight_torch.ops import _build, cdna_tail
    from visual_foresight_torch.ops.dispatch import DTYPES
    query = _build.load(cdna_tail.SOURCE).cdna_tail_tiled_occupancy
    query.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    query.restype = ctypes.c_int
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    err = query(C, REG_P, K, NUM_MASKS, DTYPES[torch.bfloat16],
                ctypes.byref(blocks), ctypes.byref(smem))
    if err or blocks.value < 1:
        raise RuntimeError('the tiled variant\'s occupancy query failed: '
                           'cudaError {}, {} blocks'.format(err, blocks.value))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    run = lambda *a: cdna_tail.fused_warp_composite(*a, sna=True,
                                                    mask_block=MASK_BLOCK)
    res = {}
    for h, w in ((H, W), (REG96_SHAPE['h'], REG96_SHAPE['w'])):
        sets = [tail_inputs(gen, b, torch.bfloat16, p=REG_P, h=h, w=w,
                            mask_block=MASK_BLOCK) for _ in range(4)]
        ms = graph_ms(run, sets, reps=50)
        outs = cdna_tail.fused_warp_composite_reference(
            *sets[0], sna=True, mask_block=MASK_BLOCK)
        bound = tail_bound(sets[0], outs, sna=True)[0]
        across, down = -(-w // TILE_W), -(-h // TILE_H)
        tiles = across * down * b
        waves = tiles / float(sms * blocks.value)
        print('two-plane tiled variant at {}x{}, B={}: {} tiles of {}x{} '
              '({} x {} a sample), {} blocks of 128 threads an SM at {} '
              'bytes of shared memory each, {:.2f} waves over {} SMs; '
              '{:.5f} ms, {:.2f}x its {:.5f} ms byte bound, {:.2f} us a '
              'wave (CUDA graph, CUDA events) [{}]'.format(
                  h, w, b, tiles, TILE_H, TILE_W, down, across, blocks.value,
                  smem.value, waves, sms, ms, ms / bound, bound,
                  ms * 1e3 / waves, card))
        print('profile: one two-plane launch at {}x{}, B={}'.format(h, w, b))
        profile_replan(lambda: run(*sets[0]),
                       what='two-plane launch at {}x{}'.format(h, w))
        res['{}x{}'.format(h, w)] = dict(tiles=tiles, waves=waves, ms=ms,
                                         bound_ms=bound)
        del sets, outs
    res['blocks_per_sm'], res['smem_bytes'] = blocks.value, smem.value
    return res


def eff_bound(args, outs, sna, dna=False):
    """Least time for the effective-kernel entry (or, with ``dna``, the DNA
    mode, whose fifth and sixth inputs are the logits and the masks) on an
    H100 SXM: every input read once and every output written once, against
    the f32 arithmetic of the in-bounds taps and the compositing and, in the
    DNA mode, of the field: for each tap the shifted ReLU (three
    operations), the sum, the division and the product with the transform
    masks' total, and that total."""
    b, h, w, c = args[0].shape
    p, kk = args[2].shape[-1], args[4].shape[-1]
    k = int(round(kk ** 0.5))
    nbytes = sum(t.numel() * t.element_size() for t in args + outs)
    pad = k // 2
    rows = k * h - 2 * sum(range(1, pad + 1))
    cols = k * w - 2 * sum(range(1, pad + 1))
    fma = b * rows * cols * (c + p) + b * h * w * (c + p) * (2 if sna else 1)
    flop = 2 * fma
    if dna:
        nc = args[5].shape[-1]
        flop += b * h * w * (6 * kk + nc - (2 if sna else 1))
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flop / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations'), t_bytes * 1e3


def time_eff(gen, b, card):
    """The effective-kernel entry and the DNA mode at DNA's serving shape
    (48x64, C=3, P=1, K=5, SNA, bf16; the DNA mode with the classic
    backbone's f32 masks, 12 a pixel) and batch ``b``: kernel and plain
    version (CUDA graph, CUDA events), each bound from its own inputs and
    the kernel's share of the memory rate.  Returns ``{'eff': {...}, 'dna':
    {...}}``."""
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite_dna, fused_warp_composite_dna_reference,
        fused_warp_composite_eff, fused_warp_composite_eff_reference)
    res = {}
    for mode, make, kernel, plain in (
            ('eff', eff_inputs, fused_warp_composite_eff,
             fused_warp_composite_eff_reference),
            ('dna', dna_inputs, fused_warp_composite_dna,
             fused_warp_composite_dna_reference)):
        sets = [make(gen, b, torch.bfloat16) for _ in range(4)]
        r = {'ms': graph_ms(lambda *a: kernel(*a), sets, reps=100),
             'plain_ms': graph_ms(lambda *a: plain(*a), sets, reps=10)}
        outs = plain(*sets[0])
        r['bound_ms'], r['bound_by'], bytes_ms = eff_bound(
            sets[0], outs, sna=True, dna=mode == 'dna')
        del sets, outs
        share = bytes_ms / r['ms']
        print('cdna_tail_{}_kernel_ms={:.5f} plain_ms={:.5f} bound_ms={:.5f} '
              '(by {}), {:.1%} of 3.35 TB/s (B={} bf16{}, 48x64, C=3, P=1, '
              'K=5, SNA, CUDA graph, CUDA events) [{}]'.format(
                  mode, r['ms'], r['plain_ms'], r['bound_ms'], r['bound_by'],
                  share, b, ', f32 masks' if mode == 'dna' else '', card))
        if share > 1.0:
            raise AssertionError('the {} kernel moved its bytes faster than '
                                 'the card can: the timing is wrong'.format(
                                     mode))
        res[mode] = r
    return res


def time_add_one(gen, card, shape):
    """add_one, its plain version and PyTorch's own add on ``shape`` f32,
    beside the bound.  Returns (kernel_ms, plain_ms, library_ms, bound_ms,
    bound_by)."""
    from visual_foresight_torch.ops.probe import add_one, add_one_reference
    n = int(np.prod(shape))
    reps = 100 if n < 1 << 20 else 10
    sets = [(torch.randn(shape, generator=gen, device='cuda'),)
            for _ in range(4)]
    kernel_ms = graph_ms(add_one, sets, reps=reps)
    plain_ms = graph_ms(add_one_reference, sets, reps=reps)
    library_ms = graph_ms(lambda x: torch.add(x, 1.0), sets, reps=reps)
    del sets
    t_bytes, t_ops = 2 * 4 * n / PEAK_BYTES_PER_S, n / PEAK_F32_FLOP_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = 'bytes' if t_bytes >= t_ops else 'operations'
    print('add_one_kernel_ms={:.5f} plain_ms={:.5f} library_ms={:.5f} '
          '(torch.add) bound_ms={:.7f} (by {}) ({} f32, CUDA graph of {} '
          'launches, CUDA events) [{}]'.format(kernel_ms, plain_ms,
                                               library_ms, bound_ms,
                                               bound_by, shape, reps, card))
    if kernel_ms < bound_ms:
        raise AssertionError('add_one ran under its bound: the timing is '
                             'wrong')
    return kernel_ms, plain_ms, library_ms, bound_ms, bound_by


# -- the conv-LSTM cell and its LayerNorm (csrc/conv_lstm_ln.cu) -------------

# (rows, F, type, the recurrent addend): the flagship's cells at B=768
# (lstm1 and lstm4, then lstm3), the classic backbone's as its bf16
# controllers drive them at 768 samples (lstm1 and lstm5, lstm2 and lstm4,
# lstm3) and as the golden replays them at B=200 in f32, and widths from one
# lane a row to four 16-byte words a lane
LSTM_CASES = [(147456, 128, torch.bfloat16, True),
              (36864, 256, torch.bfloat16, True),
              (589824, 32, torch.bfloat16, False),
              (147456, 64, torch.bfloat16, False),
              (36864, 128, torch.bfloat16, False),
              (153600, 32, torch.float32, False),
              (38400, 64, torch.float32, False),
              (9600, 128, torch.float32, False),
              (997, 8, torch.bfloat16, True), (997, 4, torch.float32, False),
              (33, 1024, torch.bfloat16, True), (33, 512, torch.float32, True)]
# the predictor step's three cells at the serving point, each timed
LSTM_TIMED = ((147456, 128), (36864, 256))
LSTM_PER_STEP = (2, 1)                        # lstm1 and lstm4; lstm3


def lstm_inputs(gen, rows, feat, dtype, with_r):
    """Gate addends, state and LayerNorm parameters of ``rows`` pixel rows
    of ``feat`` features: (x, r or None, c, weight, bias)."""
    rand = lambda *s: torch.randn(s, generator=gen, device='cuda')
    return ((1.5 * rand(rows, 4 * feat)).to(dtype),
            (1.5 * rand(rows, 4 * feat)).to(dtype) if with_r else None,
            (2.0 * rand(rows, feat)).to(dtype),
            1.0 + 0.3 * rand(feat), 0.3 * rand(feat))


def check_lstm_cases(gen):
    """The conv-LSTM kernel against its maths composed in f32 at
    ``LSTM_CASES``: c' and h' within one ulp of their type (plus the f32
    rounding of the state update's terms), y within one ulp and 1e-5 of an
    f32 LayerNorm of the stored h'.  Returns the largest error of each
    as a share of its tolerance."""
    from visual_foresight_torch.ops.conv_lstm_ln import conv_lstm_ln
    worst = {'c': 0.0, 'h': 0.0, 'y': 0.0}
    for rows, feat, dtype, with_r in LSTM_CASES:
        x, r, c, wt, b = lstm_inputs(gen, rows, feat, dtype, with_r)
        with torch.no_grad():
            outs = conv_lstm_ln(x, r, c, wt, b, LN_EPS)
        z = x.float() + (0.0 if r is None else r.float())
        i, g, f, o = torch.split(z, feat, dim=-1)
        c32 = torch.sigmoid(f + 1.0) * c.float() + \
            torch.sigmoid(i) * torch.tanh(g)
        h32 = torch.sigmoid(o) * torch.tanh(c32)
        y32 = torch.nn.functional.layer_norm(outs[1].float(), (feat,), wt, b,
                                             eps=LN_EPS)
        slack = 4 * torch.finfo(torch.float32).eps * (1.0 + c.float().abs())
        errs = {}
        for name, got, ref, extra in (('c', outs[0], c32, slack),
                                      ('h', outs[1], h32, slack),
                                      ('y', outs[2], y32,
                                       1e-5 * (1.0 + y32.abs()))):
            _, exp = torch.frexp(ref)
            ulp = torch.ldexp(torch.full_like(ref, torch.finfo(dtype).eps),
                              exp - 1)
            errs[name] = float(((got.float() - ref).abs() /
                                (ulp + extra)).max())
            worst[name] = max(worst[name], errs[name])
            if not errs[name] <= 1.0:
                raise AssertionError('conv_lstm_ln at {} rows x {} {}: {} '
                                     'off by {:.3g} of its tolerance'.format(
                                         rows, feat, dtype, name,
                                         errs[name]))
        print('conv_lstm_ln {} rows x {} {}{}: largest error as a share of '
              'its tolerance: c\' {:.3g}, h\' {:.3g}, y {:.3g}'.format(
                  rows, feat, dtype, ' with r' if with_r else '', errs['c'],
                  errs['h'], errs['y']))
    return worst


def time_lstm(gen, card):
    """The conv-LSTM kernel's time at the serving step's cells
    (``LSTM_TIMED``, bf16, with the recurrent addend), the stock chain's
    (the plain version) and the byte bound; returns a dict by shape and the
    step's totals (``LSTM_PER_STEP``)."""
    from visual_foresight_torch.ops.conv_lstm_ln import (
        conv_lstm_ln, conv_lstm_ln_reference)
    res = {}
    for rows, feat in LSTM_TIMED:
        sets = [lstm_inputs(gen, rows, feat, torch.bfloat16, True)
                for _ in range(4)]
        with torch.no_grad():
            ms = graph_ms(lambda *a: conv_lstm_ln(*a, LN_EPS), sets, 100)
            plain_ms = graph_ms(lambda *a: conv_lstm_ln_reference(*a, LN_EPS),
                                sets, 10)
        del sets
        # read x, r (4F each) and c, write c', h' and y
        bound_ms = rows * feat * 2 * 12 / PEAK_BYTES_PER_S * 1e3
        key = '{}x{}'.format(rows, feat)
        res[key] = {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
                    'bound_by': 'bytes'}
        where = '({} rows x {} bf16 with r, CUDA graph, CUDA events) ' \
            '[{}]'.format(rows, feat, card)
        print('conv_lstm_ln_kernel_ms={:.5f} {:.1%} of 3.35 TB/s {}'.format(
            ms, bound_ms / ms, where))
        print('conv_lstm_ln_plain_ms={:.5f} {}'.format(plain_ms, where))
        print('conv_lstm_ln_bound_ms={:.5f} (by bytes; H100 SXM 3.35 TB/s) '
              '[{}]'.format(bound_ms, card))
        if bound_ms > ms:
            raise AssertionError('the conv-LSTM kernel moved its bytes '
                                 'faster than the card can: the timing is '
                                 'wrong')
    step = {k: sum(n * r[k] for n, r in zip(LSTM_PER_STEP, res.values()))
            for k in ('ms', 'plain_ms', 'bound_ms')}
    print('conv_lstm_ln a predictor step (B=768, three cells): kernel '
          '{ms:.5f} ms, stock chain {plain_ms:.5f} ms, bound {bound_ms:.5f} '
          'ms [{card}]'.format(card=card, **step))
    return dict(res, step=step)


# -- the stand-alone LayerNorm (csrc/conv_lstm_ln.cu, bias_layer_norm) -------

# (batch, H, W, F, type, dec3's crop): the classic backbone's ln6 and ln0
# as its bf16 controllers drive them at 768 samples and as the golden
# replays them at B=200 in f32, the PosteriorEncoder's wider rows, and
# widths up to 1024
NORM_CASES = [(768, 48, 64, 32, torch.bfloat16, True),
              (768, 24, 32, 32, torch.bfloat16, False),
              (200, 48, 64, 32, torch.float32, True),
              (200, 24, 32, 32, torch.float32, False),
              (16, 12, 16, 64, torch.bfloat16, False),
              (16, 6, 8, 128, torch.bfloat16, True),
              (3, 5, 7, 1024, torch.bfloat16, True),
              (3, 5, 7, 512, torch.float32, False)]
# ln6 and ln0 at the serving point, each once a step
NORM_TIMED = ((768, 48, 64, 32, True), (768, 24, 32, 32, False))


def norm_inputs(gen, b, h, w, feat, dtype, crop):
    """(x, conv_bias, weight, bias) of ``bias_layer_norm``: x (b, h, w,
    feat), as the crop of an uncropped (b, h + 1, w + 1, feat) product
    where ``crop``, as ``dec3``'s."""
    rand = lambda *s: torch.randn(s, generator=gen, device='cuda')
    pad = 1 if crop else 0
    full = (2.0 * rand(b, h + pad, w + pad, feat) + 0.5).to(dtype)
    return (full[:, :h, :w] if crop else full, rand(feat).to(dtype),
            1.0 + 0.3 * rand(feat), 0.3 * rand(feat))


def check_norm_cases(gen):
    """The stand-alone LayerNorm against its plain version at
    ``NORM_CASES``: within 1e-6 of 1 + |y| (the f32 sums in another
    order), and in bf16 one ulp more (both sides round an f32 result
    once).  Returns the largest error as a share of its tolerance."""
    from visual_foresight_torch.ops.conv_lstm_ln import (
        bias_layer_norm, bias_layer_norm_reference)
    worst = 0.0
    for b, h, w, feat, dtype, crop in NORM_CASES:
        x, cb, wt, bias = norm_inputs(gen, b, h, w, feat, dtype, crop)
        with torch.no_grad():
            got = bias_layer_norm(x, cb, wt, bias, LN_EPS).float()
            ref = bias_layer_norm_reference(x, cb, wt, bias, LN_EPS).float()
        tol = 1e-6 * (1.0 + ref.abs())
        if dtype == torch.bfloat16:
            _, exp = torch.frexp(ref)
            tol += torch.ldexp(torch.full_like(ref, torch.finfo(dtype).eps),
                               exp - 1)
        err = float(((got - ref).abs() / tol).max())
        worst = max(worst, err)
        label = '{}x{}x{}x{} {}{}'.format(b, h, w, feat, dtype,
                                          ' (crop)' if crop else '')
        if not err <= 1.0:
            raise AssertionError('bias_layer_norm at {}: off by {:.3g} of '
                                 'its tolerance'.format(label, err))
        print('bias_layer_norm {}: largest error as a share of its '
              'tolerance {:.3g}'.format(label, err))
    return worst


def time_norm(gen, card):
    """The stand-alone LayerNorm's time at ``ln6``'s and ``ln0``'s shapes
    (``NORM_TIMED``, bf16, with the convolution's bias, ``ln6`` reading
    ``dec3``'s crop in place), its plain version's (the stock chain's
    bias add, casts and LayerNorm) and the byte bound; returns a dict by
    shape and the step's totals."""
    from visual_foresight_torch.ops.conv_lstm_ln import (
        bias_layer_norm, bias_layer_norm_reference)
    res = {}
    for b, h, w, feat, crop in NORM_TIMED:
        sets = [norm_inputs(gen, b, h, w, feat, torch.bfloat16, crop)
                for _ in range(4)]
        with torch.no_grad():
            ms = graph_ms(lambda *a: bias_layer_norm(*a, LN_EPS), sets, 100)
            plain_ms = graph_ms(
                lambda *a: bias_layer_norm_reference(*a, LN_EPS), sets, 10)
        del sets
        # read x (the crop's values alone) and write y, bf16
        bound_ms = b * h * w * feat * 2 * 2 / PEAK_BYTES_PER_S * 1e3
        key = '{}x{}x{}x{}'.format(b, h, w, feat)
        res[key] = {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
                    'bound_by': 'bytes'}
        where = '({} bf16{}, with the convolution\'s bias, CUDA graph, ' \
            'CUDA events) [{}]'.format(key, ', a crop read in place' if crop
                                       else '', card)
        print('bias_layer_norm_kernel_ms={:.5f} {:.1%} of 3.35 TB/s {}'
              .format(ms, bound_ms / ms, where))
        print('bias_layer_norm_plain_ms={:.5f} {}'.format(plain_ms, where))
        print('bias_layer_norm_bound_ms={:.5f} (by bytes; H100 SXM 3.35 '
              'TB/s) [{}]'.format(bound_ms, card))
        if bound_ms > ms:
            raise AssertionError('the stand-alone LayerNorm moved its bytes '
                                 'faster than the card can: the timing is '
                                 'wrong')
    step = {k: sum(r[k] for r in res.values())
            for k in ('ms', 'plain_ms', 'bound_ms')}
    print('bias_layer_norm a classic step (B=768, ln6 and ln0): kernel '
          '{ms:.5f} ms, plain version {plain_ms:.5f} ms, bound {bound_ms:.5f} '
          'ms [{card}]'.format(card=card, **step))
    return dict(res, step=step)


class StockCells(object):
    """Inside the block, ``ConvLSTMCell.forward_norm`` takes the stock chain
    on the card too (the plain version in place of the kernel's entry)."""

    def __enter__(self):
        from visual_foresight_torch.models import layers
        from visual_foresight_torch.ops.conv_lstm_ln import (
            conv_lstm_ln_reference)
        self._patch = mock.patch.object(layers, 'conv_lstm_ln',
                                        conv_lstm_ln_reference)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


# -- training (the tail's backward kernel, the trainer, the train golden) ----

# the backward kernel's cases: (label, shape, mask layouts), each in both
# types, SNA on and off; the training shape first
BWD_CASES = [
    ('training shape', dict(b=16, h=H, w=W), (MASK_BLOCK, 0)),
    ('training shape at B=256', dict(b=256, h=H, w=W), (MASK_BLOCK,)),
    ('odd sizes', dict(b=3, h=13, w=10), (0,)),
    ('odd sizes that cut the 8 x 32 tiles', dict(b=2, h=13, w=37), (0,)),
    ('sizes that cut the tiles', dict(b=2, h=12, w=20), (0, 2, 4)),
    ('several tiles across', dict(b=2, h=16, w=136), (0, 2, 4)),
    ('B=1', dict(b=1, h=H, w=W), (0, MASK_BLOCK)),
    ('blocked r=2', dict(b=4, h=24, w=40), (2,)),
    ('K=3', dict(b=2, h=20, w=36, k=3), (0, 4)),
    ('K=7', dict(b=2, h=20, w=36, k=7), (0, 4)),
    ('M=16, C=1', dict(b=2, h=20, w=36, m=16, c=1), (0, 4)),
]
BWD_TIMED_BATCHES = (16, 256)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_TIMED = 16, 60, 10
# the mean loss of the last five steps under this share of the first five's
# (tests/test_torch_train.py: 0.66 after 30 steps at narrow widths on the
# CPU).  60 steps, not 30: at full width 30 steps took the loss down by 12 %
# (0.875 measured on an H100), within the noise of fresh batches; 60 by 55 %
LOSS_FALL = 0.8
STOCHASTIC_STEPS = 10
TRAIN_DIR = os.path.join(REPO, 'build', 'chip_smoke_train')
# the JAX train golden replayed on the card (f32, TF32 off): the same sums
# as on the CPU in another order through cuDNN's f32 convolutions
GOLDEN_TRAIN = os.path.join(WEIGHTS, 'golden_train_f32.npz')
GOLDEN_LOSS_RTOL, GOLDEN_NORM_RTOL, GOLDEN_CHANGE_RTOL = 5e-5, 5e-4, 5e-3


def bwd_inputs(gen, dtype, b, h, w, c=C, k=K, m=NUM_MASKS, sna=True,
               mask_block=0):
    """(grad_img, prev, first, kernels, masks) for the backward, P = 0."""
    args = tail_inputs(gen, b, dtype, sna=sna, p=0, h=h, w=w, c=c, k=k, m=m,
                       mask_block=mask_block)
    grad = torch.randn((b, h, w, c), generator=gen, device='cuda')
    return (grad.to(dtype).contiguous(),) + args[:2] + args[4:]


def check_bwd_cases(gen):
    """The backward kernel against its plain version on the same inputs, all
    four gradients, each within its tolerance of the gradient's largest
    magnitude (``TAIL_TOL``); two launches bitwise equal.  Returns the
    largest absolute and relative bf16 errors at the training shape."""
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite_backward,
        fused_warp_composite_backward_reference)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    train_abs = train_rel = 0.0
    n = 0
    for label, shape, blocks in BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            for sna in (True, False):
                for r in blocks:
                    args = bwd_inputs(gen, dtype, sna=sna, mask_block=r,
                                      **shape)
                    got = fused_warp_composite_backward(*args, sna=sna,
                                                        mask_block=r)
                    want = fused_warp_composite_backward_reference(
                        *args, sna=sna, mask_block=r)
                    again = fused_warp_composite_backward(*args, sna=sna,
                                                          mask_block=r)
                    torch.cuda.synchronize()
                    n += 1
                    for g, w, a in zip(got, want, again):
                        if not torch.equal(g, a):
                            raise AssertionError(
                                'the backward kernel is not deterministic '
                                '({}, {}, r={})'.format(label, dtype, r))
                        err = float((g.float() - w.float()).abs().max())
                        rel = err / max(float(w.float().abs().max()), 1e-30)
                        worst[dtype] = max(worst[dtype], rel)
                        if not rel <= TAIL_TOL[dtype]:
                            raise AssertionError(
                                'the backward kernel disagrees with its '
                                'plain version ({}, {}, SNA {}, r={}: {:.3e})'
                                .format(label, dtype, sna, r, rel))
                        if label == 'training shape' and \
                                dtype == torch.bfloat16:
                            train_abs = max(train_abs, err)
                            train_rel = max(train_rel, rel)
    print('tail backward kernel vs plain: {} cases (B=16 48x64 C=3 M=10 '
          'blocked and full-resolution masks; B=256; odd sizes, several '
          'tiles, B=1, r=2, K 3 and 7, M 16 C 1; SNA on/off; bf16 and f32), '
          'all four gradients, each launch '
          'twice bitwise equal; largest error over the gradient\'s largest '
          'magnitude bf16 {:.3e} (tol {:.0e}), f32 {:.3e} (tol {:.0e}); '
          'training shape bf16 max_abs_err {:.3e}'.format(
              n, worst[torch.bfloat16], TAIL_TOL[torch.bfloat16],
              worst[torch.float32], TAIL_TOL[torch.float32], train_abs))
    return train_abs, train_rel


def bwd_bound(args, outs, sna):
    """Least time for the tail's backward on an H100 SXM: inputs read once
    and gradients written once, against the f32 arithmetic of the in-bounds
    taps: g_eff (C a tap), g_masks and g_kern (M each), the field made again
    and g_prev (M + C), the background and SNA terms."""
    b, h, w, c = args[1].shape
    k, m = args[3].shape[1], args[3].shape[3]
    nbytes = sum(t.numel() * t.element_size() for t in args + outs)
    pad = k // 2
    rows = k * h - 2 * sum(range(1, pad + 1))
    cols = k * w - 2 * sum(range(1, pad + 1))
    taps = b * rows * cols
    fma = taps * (c + m + m + m + c) + b * h * w * c * (3 if sna else 2)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2 * fma / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def time_bwd(gen, b, card):
    """The backward kernel at batch ``b`` (bf16, blocked masks, SNA, all
    four gradients) against its plain version and its bound."""
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite_backward,
        fused_warp_composite_backward_reference)
    sets = [bwd_inputs(gen, torch.bfloat16, b, H, W, mask_block=MASK_BLOCK)
            for _ in range(4)]
    res = {'ms': graph_ms(lambda *a: fused_warp_composite_backward(
        *a, mask_block=MASK_BLOCK), sets, reps=50)}
    res['plain_ms'] = graph_ms(
        lambda *a: fused_warp_composite_backward_reference(
            *a, mask_block=MASK_BLOCK), sets, reps=5)
    outs = fused_warp_composite_backward_reference(*sets[0],
                                                   mask_block=MASK_BLOCK)
    res['bound_ms'], res['bound_by'] = bwd_bound(sets[0], outs, True)
    del sets
    print('cdna_tail_bwd_kernel_ms={:.5f} plain_ms={:.5f} bound_ms={:.5f} '
          '(by {}; {:.1f}x the bound) (B={} bf16 blocked masks, all four '
          'gradients, CUDA graph, CUDA events) [{}]'.format(
              res['ms'], res['plain_ms'], res['bound_ms'], res['bound_by'],
              res['ms'] / res['bound_ms'], b, card))
    if res['ms'] < res['bound_ms']:
        raise AssertionError('the backward kernel ran under its bound: the '
                             'timing is wrong')
    return res


def train_args(config, **flags):
    """The trainer's arguments for the architecture in ``config`` (a
    ``model_config.json``), on the card."""
    from visual_foresight_torch.training.train_predictor import (
        build_argparser)
    return build_argparser().parse_args(config_argv(config, **flags))


def config_argv(config, **flags):
    """The trainer's command line (``train_predictor.build_argparser``'s
    flags) for the architecture in ``config`` and the ``flags`` given, on
    the card."""
    with open(config) as f:
        cfg = json.load(f)
    argv = ['--device', 'cuda', '--std_factor', str(cfg['std_factor']),
            '--lstm_kernel', str(cfg['lstm_kernel']),
            '--num_masks', str(cfg['num_masks']),
            '--cdna_kernel_size', str(cfg['kernel_size']),
            '--latent_dim', str(cfg['latent_dim']),
            '--adim', str(cfg['adim']), '--sdim', str(cfg['sdim']),
            '--sequence_length', str(cfg['sequence_length']),
            '--context_frames', str(cfg['context_frames']),
            '--image_height', str(cfg['img_dims'][0]),
            '--image_width', str(cfg['img_dims'][1]),
            '--enc_features', *map(str, cfg['enc_features'])]
    argv += [] if cfg['separable_lstm'] else ['--dense_lstm']
    argv += [] if cfg['sna'] else ['--no_sna']
    argv += ['--bf16'] if cfg['dtype'] == 'bfloat16' else []
    for key, value in flags.items():
        argv += ['--' + key] + ([] if value is True else [str(value)])
    return argv


class PlainCalls:
    """Counts calls of the tail's plain versions (forward and backward)
    while it is entered; the kernels' wrappers look them up in the module,
    so a call from anywhere is counted."""

    NAMES = ('fused_warp_composite_reference',
             'fused_warp_composite_backward_reference')

    def __enter__(self):
        from visual_foresight_torch.ops import cdna_tail
        self.module, self.calls = cdna_tail, 0
        self.saved = {n: getattr(cdna_tail, n) for n in self.NAMES}
        for name, fn in self.saved.items():
            def counted(*a, _fn=fn, **k):
                self.calls += 1
                return _fn(*a, **k)
            setattr(cdna_tail, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def reset_train_counts():
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite_backward)
    reset_tail_counts()
    fused_warp_composite_backward.launches = 0


def read_train_counts(path, steps, model_steps):
    """The tail's launches since ``reset_train_counts`` on a training path:
    ``model_steps`` forward launches a train step (blocked masks) and
    as many backward launches, no other entry."""
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite, fused_warp_composite_backward,
        fused_warp_composite_dna, fused_warp_composite_eff)
    fwd, bwd = fused_warp_composite.launches, \
        fused_warp_composite_backward.launches
    want = steps * model_steps
    print('{}: {} train steps, {} forward tail launches ({} a step, {} on '
          'blocked masks) and {} backward kernel launches ({} a step); '
          'expected {} each'.format(
              path, steps, fwd, fwd / max(steps, 1),
              fused_warp_composite.blocked_launches, bwd,
              bwd / max(steps, 1), want))
    if fwd != want or bwd != want or fused_warp_composite_eff.launches or \
            fused_warp_composite_dna.launches:
        raise AssertionError('the {} path did not run {} forward and {} '
                             'backward tail launches'.format(path, want,
                                                             want))
    if fused_warp_composite.blocked_launches != want:
        raise AssertionError('the {} path left the blocked masks'.format(
            path))
    return {'cdna_tail': fwd, 'cdna_tail_bwd': bwd, 'cdna_tail_eff': 0,
            'cdna_tail_dna': 0}


def check_training(label, history, plain, wall, steps):
    """A ``train()`` run's history: ``steps`` logged steps, every metric
    finite, no plain version called, and the mean loss of the last five
    steps under ``LOSS_FALL`` times that of the first five."""
    losses = [h['loss'] for h in history]
    print('{}: {} steps in {:.1f} s (first steps build the kernels\' '
          'caches), loss {}; plain-version calls {}'.format(
              label, len(history), wall, ' '.join(
                  '{:.5f}'.format(x) for x in losses[::5] + losses[-1:]),
              plain.calls))
    if plain.calls:
        raise AssertionError('the {} path called a plain version'.format(
            label))
    if len(history) != steps or not all(
            np.isfinite([h[k] for k in h]).all() for h in history):
        raise AssertionError('{}: a training metric is not finite'.format(
            label))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print('{}: loss fell: mean of the first five steps {:.6f}, of the last '
          'five {:.6f}, ratio {:.3f} (must be under {})'.format(
              label, first, last, last / first, LOSS_FALL))
    if not last < LOSS_FALL * first:
        raise AssertionError('the {} loss did not fall'.format(label))


def time_train_steps(trainer, batches, first_step, name, where):
    """``TRAIN_TIMED`` more steps of ``trainer`` on ``next(batches)`` (numpy
    batches, made and moved to the card inside the timed region), each timed
    by the host clock and by CUDA events, printed as ``<name>_p50_ms`` and
    ``<name>_device_ms``.  Returns the per-step device ms."""
    from visual_foresight_torch.training.train_predictor import to_device
    step = [first_step]

    def one_step():
        batch = to_device(next(batches), trainer.device)
        trainer.train_step(batch, step[0], trainer.generator)
        step[0] += 1

    host, device = [], []
    for _ in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        one_step()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        device.append(start.elapsed_time(end))
    print('{}_p50_ms={:.3f} host clock, {} steps: {} {}'.format(
        name, float(np.percentile(host, 50)), TRAIN_TIMED,
        ' '.join('{:.3f}'.format(x) for x in host), where))
    print('{}_device_ms={:.3f} CUDA events around a step, median, span '
          '{:.3f}-{:.3f} {}'.format(name, float(np.percentile(device, 50)),
                                    min(device), max(device), where))
    return device, one_step


def drive_training(card):
    """``train()`` at the flagship's full width (its ``model_config.json``:
    space-to-depth 4, (128, 256, 256), separable 3x3 gates, SNA, 10 masks,
    15 frames, 48x64, bf16) on synthetic batches of 16 for 60 steps, saving
    to ``TRAIN_DIR``: the loss must fall and every metric stay finite, with
    14 forward and 14 backward tail launches a step and no plain version;
    then ten more steps timed (host clock and CUDA events) and one
    profiled.  Returns (launches, trainer, per-step device ms)."""
    from visual_foresight_torch.training.train_predictor import (
        synthetic_batches, train)
    args = train_args(os.path.join(WEIGHTS, 'model_config.json'),
                      batch_size=TRAIN_BATCH, steps=TRAIN_STEPS, log_every=1,
                      model_dir=TRAIN_DIR)
    model_steps = args.sequence_length - 1
    reset_train_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        history, trainer = train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_train_counts('flagship training', TRAIN_STEPS,
                                 model_steps)
    check_training('flagship training', history, plain, wall, TRAIN_STEPS)
    where = ('(xz_flagship full width, batch {}, 15 frames = 14 model steps, '
             '48x64, bf16, forward + backward + clipped AdamW, synthetic '
             'batches) [{}]'.format(TRAIN_BATCH, card))
    device, one_step = time_train_steps(
        trainer, synthetic_batches(args, seed=1), TRAIN_STEPS, 'train_step',
        where)
    print('profile: one flagship train step')
    profile_replan(one_step, what='train step')
    return launches, trainer, device


def drive_stochastic_training():
    """``train()`` with ``--stochastic`` at ag_r5f_v2's configuration
    (latent 8, adim 4, sdim 5; its ``model_config.json``) for ten steps at
    batch 16: the KL printed, everything finite, the tail's launches as on
    the flagship.  Returns the launches."""
    from visual_foresight_torch.training.train_predictor import train
    args = train_args(os.path.join(AG_WEIGHTS, 'model_config.json'),
                      batch_size=TRAIN_BATCH, steps=STOCHASTIC_STEPS,
                      log_every=1, stochastic=True, kl_anneal_start=0,
                      kl_anneal_end=STOCHASTIC_STEPS // 2)
    reset_train_counts()
    with PlainCalls() as plain:
        history, _ = train(args)
        torch.cuda.synchronize()
    launches = read_train_counts('stochastic ag_r5f_v2 training',
                                 STOCHASTIC_STEPS, args.sequence_length - 1)
    print('stochastic training (ag_r5f_v2 config, latent 8, posterior '
          'encoder): kl {} beta {} loss {}'.format(
              ' '.join('{:.4f}'.format(h['kl']) for h in history),
              ' '.join('{:.2e}'.format(h['kl_beta']) for h in history),
              ' '.join('{:.5f}'.format(h['loss']) for h in history)))
    if plain.calls or not all(np.isfinite([h[k] for k in h]).all()
                              for h in history):
        raise AssertionError('stochastic training: a plain version ran or a '
                             'metric is not finite')
    return launches


def serve_trained():
    """The flagship run's checkpoint in ``TRAIN_DIR`` served:
    ``TorchPredictor`` restores it (``restored=True``, adopting its
    ``model_config.json``) and drives one 200 x 15 x 3 replan with finite
    scores.  Returns its launches."""
    predictor = restored_predictor('bfloat16', weights=TRAIN_DIR)
    replan = replan_200(predictor)
    rng = np.random.RandomState(3)
    reset_tail_counts()
    with torch.no_grad():
        out = replan(rng.rand(1, N_CTX, H, W, 3).astype(np.float32),
                     (rng.randn(N_CTX, 3) * 0.05).astype(np.float32),
                     generator=torch.Generator(device='cuda').manual_seed(4))
        torch.cuda.synchronize()
    launches = read_tail_counts('trained checkpoint, one 200-sample replan',
                                LAUNCHES_PER_REPLAN, predictor._hp)
    scores = out['scores_per_itr']
    if tuple(scores.shape) != (ITERS, M) or \
            not bool(torch.isfinite(scores).all()):
        raise AssertionError('the trained checkpoint replanned to scores '
                             'that are not finite')
    print('trained checkpoint served: restored={}, one replan of {} x {} x '
          '{}, best score {:.4f}'.format(predictor.restored, M, T, ITERS,
                                         float(out['best_scores'][0])))
    return launches


def replay_train_golden():
    """Replay the JAX package's three f32 train steps of the flagship
    (``golden_train_f32.npz``, written by ``tests/test_torch_train_golden.py
    --write``) on the card through the tail's forward and backward kernels:
    losses, gradient norms, each leaf's change (sum and L2 norm) and two
    leaves in full.  Returns the launches."""
    from visual_foresight_torch.models.convert import (flatten_flax,
                                                       load_flax_params,
                                                       params_to_flax,
                                                       unflatten_flax)
    from visual_foresight_torch.training import train_predictor as ttrain
    with np.load(GOLDEN_TRAIN) as f:
        golden = {k: f[k] for k in f.files}
    cfg = {k[len('config/'):]: golden[k].item() for k in golden
           if k.startswith('config/')}
    args = train_args(os.path.join(WEIGHTS, 'model_config.json'),
                      batch_size=cfg['batch_size'], lr=cfg['lr'],
                      sequence_length=cfg['sequence_length'],
                      steps=cfg['steps'], ss_k=cfg['ss_k'])
    args.bf16 = False
    with np.load(os.path.join(WEIGHTS, 'view0', 'params.npz')) as f:
        before = {k: f[k] for k in f.files}
    model = ttrain.build_model(args)
    load_flax_params(model, unflatten_flax(before))
    model.to('cuda')
    tx = ttrain.ClippedAdamW(ttrain._named_params(model),
                             ttrain.training_schedule(args))
    step_fn = ttrain.make_train_step(model, tx, args.context_frames,
                                     ss_k=args.ss_k)
    batch = ttrain.to_device(next(ttrain.synthetic_batches(
        args, seed=cfg['seed'])), 'cuda')
    reset_train_counts()
    got = {k: [] for k in ('loss', 'img_l2', 'state_l2', 'grad_norm')}
    with PlainCalls() as plain:
        for step in range(cfg['steps']):
            metrics = step_fn(batch, step, gt_mask=torch.as_tensor(
                golden['gt_mask'][step], device='cuda'))
            for k in got:
                got[k].append(float(metrics[k]))
    launches = read_train_counts('JAX train golden replay (f32)',
                                 cfg['steps'], args.sequence_length - 1)
    if plain.calls:
        raise AssertionError('the golden replay called a plain version')
    after = flatten_flax(params_to_flax(model.state_dict()))
    worst = dict.fromkeys(('loss', 'grad_norm', 'change_norm', 'change_sum',
                           'full'), 0.0)
    for k, values in got.items():
        kind = 'grad_norm' if k == 'grad_norm' else 'loss'
        for g, w in zip(values, golden[k]):
            worst[kind] = max(worst[kind], abs(g - float(w)) / abs(float(w)))
    for leaf, (wsum, wnorm), size in zip(golden['digest_leaves'],
                                         golden['digest'],
                                         golden['digest_sizes']):
        change = after[str(leaf)] - before[str(leaf)]
        gsum = float(np.sum(change, dtype=np.float64))
        gnorm = float(np.linalg.norm(change.ravel()))
        worst['change_norm'] = max(worst['change_norm'],
                                   abs(gnorm - wnorm) / wnorm)
        worst['change_sum'] = max(worst['change_sum'], abs(gsum - wsum) /
                                  (np.sqrt(size) * wnorm))
    for key in golden:
        if key.startswith('full/'):
            leaf = key[len('full/'):]
            scale = float(np.abs(golden[key] - before[leaf]).max())
            worst['full'] = max(worst['full'], float(
                np.abs(after[leaf] - golden[key]).max()) / scale)
    print('JAX train golden (xz_flagship f32, B={}, {} frames, {} steps, '
          'masks injected): loss {} (JAX {}), grad_norm {} (JAX {}); largest '
          'relative errors {} (tolerances: losses {:.0e}, grad norms {:.0e}, '
          'changes and full leaves {:.0e})'.format(
              cfg['batch_size'], cfg['sequence_length'], cfg['steps'],
              ' '.join('{:.7g}'.format(x) for x in got['loss']),
              ' '.join('{:.7g}'.format(x) for x in golden['loss']),
              ' '.join('{:.7g}'.format(x) for x in got['grad_norm']),
              ' '.join('{:.7g}'.format(x) for x in golden['grad_norm']),
              {k: float('{:.3e}'.format(v)) for k, v in worst.items()},
              GOLDEN_LOSS_RTOL, GOLDEN_NORM_RTOL, GOLDEN_CHANGE_RTOL))
    if not (worst['loss'] <= GOLDEN_LOSS_RTOL and
            worst['grad_norm'] <= GOLDEN_NORM_RTOL and
            max(worst['change_norm'], worst['change_sum'],
                worst['full']) <= GOLDEN_CHANGE_RTOL):
        raise AssertionError('the card left the JAX train golden')
    return launches


# -- training from collected records ------------------------------------------

RECORD_TRAJS, RECORD_PER_FILE = 48, 8         # 6 shards, 3 batches of 16
NATIVE_STEPS = 10
SCORING_STEPS = 100
# name: (trainer module, entry, batch size, flags) of the scoring nets.  The
# records' square covers 16 of 3,072 pixels on a flat background, so two
# frames differ by a mean absolute gap of at most 32 / 3072 x 0.9 < 0.01:
# the default ambiguity threshold (0.01) would weigh every goal-conditioned
# negative 0
SCORING = {
    'gdn': ('train_gdn', 'train', 16, []),
    'classifier': ('train_classifier', 'train_classifier', 32,
                   ['--label_mode', 'goal', '--ambiguous_pixel_diff',
                    '0.001']),
    'nce': ('train_classifier', 'train_nce', 32, ['--mode', 'nce']),
    'inverse': ('train_inverse', 'train_inverse', 16,
                ['--adim', '3', '--plan_T', '7']),
}


def probe_host():
    """One line on what this machine offers the host side of ingest:
    ``g++`` on the PATH, ``jpeglib.h`` and ``zlib.h`` found by it, and
    whether ``google_crc32c``, ``cv2``, ``h5py`` and ``imageio`` (the
    RoboNet reader's) import.  Returns what the native engine's build lacks
    (empty where it can be built)."""
    import importlib
    from visual_foresight_torch.data import fused_ingest
    from visual_foresight_torch.data.tfrecord_io import (crc32c_impl,
                                                         crc32c_numpy)
    missing = fused_ingest.missing_build_tools()
    cxx = shutil.which(os.environ.get('CXX', 'g++'))
    imports = {}
    for name in ('google_crc32c', 'cv2', 'h5py', 'imageio'):
        try:
            importlib.import_module(name)
            imports[name] = 'imports'
        except Exception as e:           # noqa: BLE001 (a broken install)
            imports[name] = 'does not import ({})'.format(
                type(e).__name__)
    headers = {h: 'not probed' if cxx is None else
               ('missing' if h in missing else 'found')
               for h in fused_ingest.HEADERS}
    print('host ingest probe: g++ {}; {}; {}; CRC32C in use: {}; {} (for '
          'information: the port decodes zstd with its own decoder)'.format(
              cxx or 'not on the PATH',
              '; '.join('{} {}'.format(h, v) for h, v in headers.items()),
              '; '.join('{} {}'.format(m, v) for m, v in imports.items()),
              'the numpy fallback' if crc32c_impl() is crc32c_numpy
              else 'google_crc32c', probe_zstd(cxx)))
    return missing


def probe_zstd(cxx):
    """Whether this machine has ``zstd.h`` (found by ``cxx``) and
    ``libzstd.so.1`` (dlopen): for information only."""
    import ctypes
    header = 'not probed'
    if cxx is not None:
        proc = subprocess.run([cxx, '-fsyntax-only', '-x', 'c++', '-'],
                              input='#include <zstd.h>\n',
                              capture_output=True, text=True, check=False)
        header = 'missing' if proc.returncode else 'found'
    try:
        ctypes.CDLL('libzstd.so.1')
        lib = 'loads'
    except OSError:
        lib = 'missing'
    return 'zstd.h {}; libzstd.so.1 {}'.format(header, lib)


def write_records(root):
    """``RECORD_TRAJS`` trajectories of the flagship's shapes (15 frames of
    48x64, one camera, raw ``Byte`` images, adim 3, sdim 3) made from the
    trainer's synthetic batches (a moving square that follows the
    actions), quantised to uint8 and written by the port's
    ``GeneralAgentSaver`` (``RECORD_PER_FILE`` a shard, all train) into
    ``root``; then read back by ``BaseVideoDataset`` with shuffle off: the
    frames must equal the uint8 source exactly, the states and actions the
    source bit for bit."""
    from visual_foresight_torch.agent.utils.traj_saver import (
        GeneralAgentSaver)
    from visual_foresight_torch.data.dataset_reader import BaseVideoDataset
    from visual_foresight_torch.training.train_predictor import (
        synthetic_batches)
    args = train_args(os.path.join(WEIGHTS, 'model_config.json'),
                      batch_size=TRAIN_BATCH)
    batches = synthetic_batches(args, seed=2)
    src = [next(batches) for _ in range(RECORD_TRAJS // TRAIN_BATCH)]
    images = np.concatenate([np.round(b['images'] * 255).astype(np.uint8)
                             for b in src])
    states = np.concatenate([b['states'] for b in src])
    # one action a frame, as a collection run records them: the last is 0
    actions = np.concatenate([b['actions'] for b in src])
    actions = np.concatenate([actions, np.zeros_like(actions[:, :1])], 1)
    seq = images.shape[1]
    t0 = time.perf_counter()
    saver = GeneralAgentSaver(root, seq, traj_per_file=RECORD_PER_FILE,
                              split=(1.0, 0.0, 0.0))
    for i in range(RECORD_TRAJS):
        saver.save_traj({'traj_index': i},
                        {'images': images[i][:, None], 'state': states[i]},
                        [{'actions': a} for a in actions[i]])
    saver.flush()
    written = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = BaseVideoDataset(root, TRAIN_BATCH, hparams_dict={
        'shuffle': False, 'num_epochs': 1})
    got = list(ds.numpy_iterator(keys=('traj_index', 'images', 'state',
                                       'actions')))
    ds.close()
    read = time.perf_counter() - t0
    order = np.concatenate([b['traj_index'].reshape(-1) for b in got])
    if sorted(order.tolist()) != list(range(RECORD_TRAJS)):
        raise AssertionError('the records read back {} of the {} '
                             'trajectories'.format(len(order), RECORD_TRAJS))
    for key, want in (('images', images[:, :, None]), ('state', states),
                      ('actions', actions)):
        back = np.concatenate([b[key] for b in got])
        if back.dtype != want.dtype or not np.array_equal(back,
                                                          want[order]):
            raise AssertionError('the records\' {} differ from the source '
                                 '({} {} against {} {})'.format(
                                     key, back.dtype, back.shape,
                                     want.dtype, want.shape))
    print('records: {} trajectories of {} frames (48x64, one camera, raw '
          'bytes, adim 3, sdim 3) written by GeneralAgentSaver into {} '
          'shards in {:.2f} s ({:.1f} kB), read back by BaseVideoDataset in '
          '{:.2f} s: frames, states and actions equal to the source'.format(
              RECORD_TRAJS, seq, RECORD_TRAJS // RECORD_PER_FILE, written,
              sum(os.path.getsize(os.path.join(root, 'train', f))
                  for f in os.listdir(os.path.join(root, 'train'))) / 1e3,
              read))


def train_from_records(root, loader, steps, card, name, loss_falls=True):
    """``train()`` of the flagship (bf16, batch 16) on the records in
    ``root`` through ``loader`` ('python' or 'fused') for ``steps`` steps:
    14 forward and 14 backward tail launches a step on the tiled variant and
    blocked masks, no plain version, every metric finite, and with
    ``loss_falls`` the loss under ``LOSS_FALL`` of its start
    (``check_training``); then ``TRAIN_TIMED`` more steps from the records
    timed as ``<name>_*``.  Returns (launches, history, wall seconds,
    per-step device ms)."""
    from visual_foresight_torch.training.train_predictor import (
        record_batches, train)
    args = train_args(os.path.join(WEIGHTS, 'model_config.json'),
                      batch_size=TRAIN_BATCH, steps=steps, log_every=1,
                      data_dir=root, loader=loader)
    reset_train_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        history, trainer = train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    label = 'flagship training from records ({} reader)'.format(loader)
    launches = read_train_counts(label, steps, args.sequence_length - 1)
    if loss_falls:
        check_training(label, history, plain, wall, steps)
    elif plain.calls or len(history) != steps or not all(
            np.isfinite([h[k] for k in h]).all() for h in history):
        raise AssertionError('{}: a plain version ran or a metric is not '
                             'finite'.format(label))
    where = ('(xz_flagship full width, batch {}, 15 frames = 14 model steps, '
             '48x64, bf16, forward + backward + clipped AdamW, batches read '
             'from {} shards by the {} reader) [{}]'.format(
                 TRAIN_BATCH, RECORD_TRAJS // RECORD_PER_FILE, loader, card))
    device, one_step = time_train_steps(trainer, record_batches(args), steps,
                                        name, where)
    print('profile: one flagship train step from records ({} reader)'
          .format(loader))
    profile_replan(one_step, what='train step')
    return launches, history, wall, device


def check_native_ingest(root, missing, card):
    """The port's native engine (``native/ingest.cpp``), where the probe
    found ``g++`` and ``zlib.h`` (without ``jpeglib.h`` it is built without
    JPEG decoding; the records are raw): built, its batches at one thread
    with shuffle off equal to the Python reader's bit for bit, then
    ``NATIVE_STEPS`` flagship steps with ``--loader fused``, timed.  Where
    the probe found them missing, prints why and returns None; with them
    present a failed build raises.  Returns the launches."""
    from visual_foresight_torch.data import fused_ingest
    from visual_foresight_torch.data.dataset_reader import BaseVideoDataset
    from visual_foresight_torch.ops import _build
    blocking = [m for m in missing if m != 'jpeglib.h']
    if blocking:
        print('native ingest: not built ({} missing)'.format(
            ', '.join(blocking)))
        return None
    flags, libs = fused_ingest.engine_build()
    t0 = time.perf_counter()
    fused_ingest._load_library()
    print('native ingest: built {} ({}) in {:.1f} s'.format(
        os.path.relpath(_build.host_library_path(fused_ingest.SOURCE, libs,
                                                 flags), REPO),
        'without JPEG decoding: jpeglib.h missing' if flags else
        'with libjpeg', time.perf_counter() - t0))
    loader = fused_ingest.FusedTrajLoader(root, TRAIN_BATCH, num_epochs=1,
                                          shuffle=False, threads=1)
    native = list(loader)
    loader.close()
    ds = BaseVideoDataset(root, TRAIN_BATCH, hparams_dict={
        'shuffle': False, 'num_epochs': 1})
    python = list(ds.numpy_iterator(keys=('images', 'state', 'actions')))
    ds.close()
    same = len(native) == len(python) == RECORD_TRAJS // TRAIN_BATCH and \
        all(n[k].dtype == p[k].dtype and np.array_equal(n[k], p[k])
            for n, p in zip(native, python) for k in p)
    print('native ingest: {} batches at one thread, shuffle off, equal to '
          'the Python reader\'s bit for bit: {}'.format(len(native), same))
    if not same:
        raise AssertionError('the native engine\'s batches differ from the '
                             'Python reader\'s')
    launches, history, wall, _ = train_from_records(
        root, 'fused', NATIVE_STEPS, card, 'train_records_native_step',
        loss_falls=False)
    print('flagship training from records (native engine): {} steps in '
          '{:.1f} s, loss {}'.format(NATIVE_STEPS, wall, ' '.join(
              '{:.5f}'.format(h['loss']) for h in history)))
    return launches


class StepTimes:
    """While entered, times every step of the scoring nets' trainers
    (``training/net_trainer.py::make_step``: forward, backward and Adam on
    a batch already on the card) by the host clock and CUDA events, and
    keeps the last step and its batch (``step``, ``batch``)."""

    def __enter__(self):
        from visual_foresight_torch.training import net_trainer
        self.module, self.make_step = net_trainer, net_trainer.make_step
        self.host, self.device = [], []

        def make_step(tx, loss_fn):
            step = self.make_step(tx, loss_fn)

            def timed(*batch):
                self.step, self.batch = step, batch
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                out = step(*batch)
                end.record()
                torch.cuda.synchronize()
                self.host.append((time.perf_counter() - t0) * 1e3)
                self.device.append(start.elapsed_time(end))
                return out
            return timed
        net_trainer.make_step = make_step
        return self

    def __exit__(self, *exc):
        self.module.make_step = self.make_step


def train_scoring_nets(records, root, card):
    """Each scoring net (``SCORING``) trained on the card in f32 for
    ``SCORING_STEPS`` steps from the records in ``records``, written to
    ``root/<name>``: every logged metric finite, ``params.npz`` and
    ``net_config.json`` written; the step times (host clock and CUDA
    events, the steps after the first ten) printed, and one more step
    profiled.  Returns {name: model dir}."""
    import importlib
    dirs = {}
    for name, (module, entry, batch, flags) in SCORING.items():
        mod = importlib.import_module('visual_foresight_torch.training.' +
                                      module)
        dirs[name] = os.path.join(root, name)
        args = mod.build_argparser().parse_args(
            ['--data_dir', records, '--model_dir', dirs[name], '--steps',
             str(SCORING_STEPS), '--batch_size', str(batch), '--log_every',
             '10', '--device', 'cuda'] + flags)
        with StepTimes() as times:
            t0 = time.perf_counter()
            history, _ = getattr(mod, entry)(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        written = all(os.path.isfile(os.path.join(dirs[name], f))
                      for f in ('params.npz', 'net_config.json'))
        finite = all(np.isfinite([v for k, v in h.items()]).all()
                     for h in history)
        print('{} trained from records: {} steps at batch {} in {:.1f} s, '
              'first {} last {}; params.npz and net_config.json written: '
              '{}'.format(name, SCORING_STEPS, batch, wall, history[0],
                          history[-1], written))
        if not (written and finite and len(times.host) == SCORING_STEPS):
            raise AssertionError('the {} trainer left a metric that is not '
                                 'finite or no checkpoint'.format(name))
        host, device = times.host[10:], times.device[10:]
        where = '({}, batch {}, 48x64, f32, forward + backward + Adam, {} ' \
            'steps after the first ten) [{}]'.format(
                name, batch, len(host), card)
        print('train_{}_step_p50_ms={:.3f} host clock {}'.format(
            name, float(np.percentile(host, 50)), where))
        print('train_{}_step_device_ms={:.3f} CUDA events, median, span '
              '{:.3f}-{:.3f} {}'.format(name, float(np.percentile(device,
                                                                    50)),
                                        min(device), max(device), where))
        print('profile: one more {} train step'.format(name))
        profile_replan(lambda: times.step(*times.batch), what='train step')
    return dirs


def check_quality_gates(root):
    """The JAX tests' quality gates for its trainers, held to the port's
    trainers on the card, on the synthetic batches at the tests' sizes:
    the GDN's photometric loss falls in 30 steps (16x24, batch 8;
    ``tests/test_training.py:106-112``), the classifier's accuracy passes
    0.8 after 60 steps (16x24, batch 16; ``:115-122``), the goal-conditioned
    classifier's 0.85 after 250 (32x32, batch 32;
    ``test_classifier_recipe.py:29-33``), the inverse net's loss falls
    under half ``zero_mse`` in 120 steps (48x64, batch 16;
    ``test_inverse_model.py:21-27``)."""
    from visual_foresight_torch.training import (train_classifier,
                                                 train_gdn, train_inverse)
    cuda = ['--device', 'cuda']
    gdn, _ = train_gdn.train(train_gdn.build_argparser().parse_args(
        ['--steps', '30', '--batch_size', '8', '--image_height', '16',
         '--image_width', '24', '--log_every', '29'] + cuda))
    clf, _ = train_classifier.train_classifier(
        train_classifier.build_argparser().parse_args(
            ['--steps', '60', '--batch_size', '16', '--image_height', '16',
             '--image_width', '24', '--log_every', '59'] + cuda))
    goal, _ = train_classifier.train_classifier(
        train_classifier.build_argparser().parse_args(
            ['--steps', '250', '--batch_size', '32', '--image_height', '32',
             '--image_width', '32', '--log_every', '100', '--label_mode',
             'goal'] + cuda))
    inv, _ = train_inverse.train_inverse(
        train_inverse.build_argparser().parse_args(
            ['--steps', '120', '--batch_size', '16', '--image_height', '48',
             '--image_width', '64', '--log_every', '40', '--adim', '3',
             '--plan_T', '7', '--model_dir', os.path.join(root, 'gate')] +
            cuda))
    gates = [
        ('GDN photometric loss falls in 30 steps',
         '{:.5f} -> {:.5f}'.format(gdn[0]['photometric'],
                                   gdn[-1]['photometric']),
         gdn[-1]['photometric'] < gdn[0]['photometric']),
        ('classifier accuracy over 0.8 after 60 steps',
         '{:.3f}'.format(clf[-1]['acc']), clf[-1]['acc'] > 0.8),
        ('goal-conditioned classifier accuracy over 0.85 after 250 steps',
         '{:.3f}'.format(goal[-1]['acc']), goal[-1]['acc'] > 0.85),
        ('inverse loss under 0.5 x zero_mse after 120 steps',
         '{:.5f} against zero_mse {:.5f}'.format(inv[-1]['loss'],
                                                 inv[-1]['zero_mse']),
         inv[-1]['loss'] < 0.5 * inv[-1]['zero_mse'] and
         inv[0]['loss'] > inv[-1]['loss'])]
    for what, value, ok in gates:
        print('quality gate (JAX test, port trainer on the card): {}: {} '
              '-> {}'.format(what, value, 'met' if ok else 'NOT met'))
    if not all(ok for _, _, ok in gates):
        raise AssertionError('a trainer missed its JAX quality gate')

# -- the sim benchmark campaign ------------------------------------------------

def probe_campaign_host():
    """One line on what this machine offers the campaign path: whether
    ``mujoco`` imports (its version), which GL backend renders a 96x128
    frame (``egl``, then ``osmesa``, each in a subprocess), and whether
    ``imageio`` and ``matplotlib`` import (the port uses neither).  Returns
    (mujoco's version or None, the backend that renders or None)."""
    versions = {}
    for name in ('mujoco', 'imageio', 'matplotlib'):
        proc = subprocess.run(
            [sys.executable, '-c',
             'import {0}; print({0}.__version__)'.format(name)],
            capture_output=True, text=True, timeout=300)
        versions[name] = proc.stdout.strip() if proc.returncode == 0 \
            else None
    gl, tried = None, []
    if versions['mujoco']:
        for backend in ('egl', 'osmesa'):
            env = dict(os.environ, MUJOCO_GL=backend,
                       PYOPENGL_PLATFORM=backend)
            proc = subprocess.run([sys.executable, '-c', GL_PROBE], env=env,
                                  capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode == 0:
                gl = backend
                break
            lines = (proc.stderr.strip() or 'no output').splitlines()
            tried.append('{} fails ({})'.format(backend, lines[-1][:160]))
    print('campaign host probe: mujoco {}; GL backend rendering 96x128: {}'
          '{}; imageio {}; matplotlib {}'.format(
              versions['mujoco'] or 'does not import', gl or 'none',
              ' ({})'.format('; '.join(tried)) if tried else '',
              versions['imageio'] or 'does not import',
              versions['matplotlib'] or 'does not import'))
    return versions['mujoco'], gl


def gif_frame_sizes(data):
    """The (height, width) of every frame of a GIF89a, read by walking its
    blocks: the header, the global colour table, extensions and image
    blocks up to the trailer."""
    if data[:6] != b'GIF89a':
        raise AssertionError('not a GIF89a: {!r}'.format(data[:6]))

    def skip_sub_blocks(pos):
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    def colour_table(flags):
        return 3 << ((flags & 7) + 1) if flags & 0x80 else 0

    pos = 13 + colour_table(data[10])
    sizes = []
    while data[pos] != 0x3b:
        if data[pos] == 0x21:                      # an extension
            pos = skip_sub_blocks(pos + 2)
        elif data[pos] == 0x2c:                    # an image block
            w = int.from_bytes(data[pos + 5:pos + 7], 'little')
            h = int.from_bytes(data[pos + 7:pos + 9], 'little')
            pos = skip_sub_blocks(pos + 11 + colour_table(data[pos + 9]))
            sizes.append((h, w))
        else:
            raise AssertionError('unknown GIF block 0x{:02x} at {}'.format(
                data[pos], pos))
    return sizes


def check_dump_files(folder, frames):
    """``plan.html``, the start frame and every GIF it names are on disk;
    each GIF is a GIF89a of ``frames`` frames of 48x64."""
    with open(os.path.join(folder, 'plan.html')) as f:
        html = f.read()
    names = sorted(n for n in os.listdir(folder) if n.endswith('.gif'))
    if not os.path.isfile(os.path.join(folder, 'cam_0_start.png')) or \
            len(names) != N_VIS_GIFS or \
            any('src="{}"'.format(n) not in html for n in names):
        raise AssertionError('the dump in {} is incomplete: {}'.format(
            folder, sorted(os.listdir(folder))))
    for name in names:
        with open(os.path.join(folder, name), 'rb') as f:
            sizes = gif_frame_sizes(f.read())
        if sizes != [(H, W)] * frames:
            raise AssertionError('{}: frames {} (expected {} of {}x{})'
                                 .format(name, sizes[:3], frames, H, W))
    print('verbose dump: plan.html, cam_0_start.png and {} GIF89a files of '
          '{} frames of {}x{} in {}'.format(len(names), frames, H, W,
                                            os.path.basename(folder)))


def drive_verbose_dump(card):
    """``PixelCostController.act()`` at xz_bench20's point (768 x 45 x 3,
    bf16, xz_flagship) on task 0's start frame and pixels, with a real file
    worker as ``verbose_worker``: one replan, its dump on disk
    (``check_dump_files``) and its tail launches; then the replan's host
    p50 with the dump and without it, in turns (with, without, without,
    with, ...).  Returns the launches by kernel."""
    import cv2
    from visual_foresight_torch.agent.utils.file_saver import (
        start_file_worker)
    from visual_foresight_torch.policy.cem_controllers import (
        PixelCostController)
    frame = cv2.imread(TASK0_FRAME)[:, :, ::-1]
    if frame.shape != (H, W, 3):
        raise AssertionError('task 0 frame of shape {}'.format(frame.shape))
    images = np.repeat(frame[None, None], 2, axis=0)
    states = np.repeat(TASK0_STATE[None], 2, axis=0).astype(np.float32)
    ctrl = PixelCostController(AG_PARAMS, dict(CTRL_POLICY))
    check_restored('verbose dump', ctrl)
    root = tempfile.mkdtemp(prefix='chip_smoke_dump_')
    worker = start_file_worker()
    try:
        worker.put(('path', root))
        ctrl.reset()
        reset_tail_counts()
        for t in range(2):
            out = ctrl.act(t=t, i_tr=0, images=images[:t + 1],
                           state=states[:t + 1], desig_pix=TASK0_DESIG_PIX,
                           goal_pix=TASK0_GOAL_PIX, verbose_worker=worker)
        torch.cuda.synchronize()
        launches = read_tail_counts(
            'verbose dump at xz_bench20 (task 0, 2 act() steps, 1 replan)',
            replan_launches(CTRL_POLICY), ctrl.predictor._hp)
        if not np.isfinite(out['actions']).all():
            raise AssertionError('the dumped replan gave {}'.format(
                out['actions']))
        times = {True: [], False: []}
        for i in range(DUMP_TIMED):
            dump = i % 4 in (0, 3)
            ctrl._verbose_worker = worker if dump else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctrl.perform_CEM(states)
            torch.cuda.synchronize()
            times[dump].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        worker.close()                 # every dump written, the worker gone
        drain = time.perf_counter() - t0
        check_dump_files(os.path.join(root, 'planning_1_itr_2'),
                         CTRL_POLICY['T'])
    finally:
        shutil.rmtree(root)
    p50 = {k: float(np.percentile(v, 50)) for k, v in times.items()}
    spread = {k: float(np.max(v) - np.min(v)) for k, v in times.items()}
    print('verbose_dump_replan_p50_ms={:.3f} with the dump, {:.3f} without '
          '(xz_bench20 768 x 45 x 3, bf16, host clock, {} replans each: {} '
          'and {}); the dump adds {:.3f} ms a replan (p50s), against a '
          'spread (max - min) of {:.3f} ms with it and {:.3f} ms without; '
          'the worker drained its queue {:.3f} s after the last [{}]'.format(
              p50[True], p50[False], DUMP_TIMED // 2,
              ' '.join('{:.3f}'.format(x) for x in times[True]),
              ' '.join('{:.3f}'.format(x) for x in times[False]),
              p50[True] - p50[False], spread[True], spread[False], drain,
              card))
    return launches


def jax_scores(run):
    with open(os.path.join(REPO, run, 'scores_0to19.pkl'), 'rb') as f:
        return {k: np.asarray(v) for k, v in pickle.load(f).items()}


class ReplanClock(object):
    """Inside the block, every ``perform_CEM`` of ``cls``
    (``PixelCostController`` by default; the class's, so it reaches the
    controller that a runner builds) is timed on the host clock between two
    calls of ``sync``, and with a card also between two CUDA events:
    ``ms`` holds the replans' host times, ``span_ms`` their spans on the
    card, ``launches`` the tail launches of each, ``ctrls`` the last
    controller that planned, and ``acts`` a copy of the arguments of every
    ``act()`` at ``t`` = 1."""

    def __init__(self, sync, cls=None):
        from visual_foresight_torch.policy.cem_controllers import (
            PixelCostController)
        self._cls, self._sync = cls or PixelCostController, sync
        self.ms, self.span_ms, self.launches, self.acts = [], [], [], []
        self.ctrls = []

    def __enter__(self):
        import copy
        import functools
        from visual_foresight_torch.ops.cdna_tail import fused_warp_composite
        plan = self._plan = self._cls.perform_CEM
        act = self._act = self._cls.act
        events = torch.cuda.is_available()

        def timed_plan(ctrl, state):
            self.ctrls[:] = [ctrl]
            n0 = fused_warp_composite.launches
            if events:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
            self._sync()
            t0 = time.perf_counter()
            if events:
                start.record()
            plan(ctrl, state)
            if events:
                end.record()
            self._sync()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            if events:
                self.span_ms.append(start.elapsed_time(end))
            self.launches.append(fused_warp_composite.launches - n0)

        @functools.wraps(act)     # the agent reads act()'s signature
        def recorded_act(ctrl, *args, **kw):
            if kw.get('t') == 1:
                self.acts.append(copy.deepcopy(
                    {k: v for k, v in kw.items() if k != 'verbose_worker'}))
            return act(ctrl, *args, **kw)

        self._cls.perform_CEM = timed_plan
        self._cls.act = recorded_act
        return self

    def __exit__(self, *exc):
        self._cls.perform_CEM = self._plan
        self._cls.act = self._act


def check_campaign(name, result_dir, hp, replans, launches, per_replan,
                   floor, ref_initial=None, atol=INITIAL_DIST_ATOL):
    """The gates on a campaign that ``sim/run.py --benchmark`` ran in one
    worker, in numpy alone: its txt and pkl reports are in ``result_dir``,
    every task of ``hp`` (its config) is scored, the tail's ``launches``
    equal ``replans`` times ``per_replan``, each task's initial distance is
    within ``atol`` of ``ref_initial`` (the reference run's, indexed by
    task; skipped where None) and the mean improvement is at least
    ``floor``.  Prints one line and returns (the scores by key, the largest
    initial-distance gap or None)."""
    span = '{}to{}'.format(hp['start_index'], hp['end_index'])
    for report in ('results_{}.txt'.format(span), 'results_all.txt',
                   'scores_{}.pkl'.format(span)):
        if not os.path.isfile(os.path.join(result_dir, report)):
            raise AssertionError('{}: no {}'.format(name, report))
    with open(os.path.join(result_dir, 'scores_{}.pkl'.format(span)),
              'rb') as f:
        stats = {k: np.asarray(v) for k, v in pickle.load(f).items()}
    tasks = hp['end_index'] - hp['start_index'] + 1
    gap = None
    if ref_initial is not None:
        gap = float(np.max(np.abs(
            stats['initial_dist'] -
            np.asarray(ref_initial)[hp['start_index']:hp['end_index'] + 1])))
    mean_imp = float(np.mean(stats['improvement']))
    print('{} campaign gates: {} of {} tasks scored; {} tail launches for {} '
          'replans x {}; initial_dist largest gap {} (atol {}); mean '
          'improvement {:.5f} (floor {})'.format(
              name, stats['improvement'].shape[0], tasks, launches, replans,
              per_replan, 'not checked' if gap is None else
              '{:.3e}'.format(gap), atol, mean_imp, floor))
    if stats['improvement'].shape[0] != tasks:
        raise AssertionError('{}: {} of {} tasks scored'.format(
            name, stats['improvement'].shape[0], tasks))
    if replans == 0 or launches != replans * per_replan:
        raise AssertionError('{}: {} tail launches for {} replans x {}'
                             .format(name, launches, replans, per_replan))
    if gap is not None and not gap <= atol:
        raise AssertionError('{}: the re-created scenes are {:.3e} from the '
                             "reference's".format(name, gap))
    if not mean_imp >= floor:
        raise AssertionError('{}: mean improvement {:.5f} under {}'.format(
            name, mean_imp, floor))
    return stats, gap


def drive_campaign(name, card):
    """``sim/run.py --benchmark`` of the twin config ``name`` in this
    process, on the card, every vendored task, held to ``check_campaign``:
    the tail's launches equal to the replans times the policy's count, each
    task's initial distance within ``INITIAL_DIST_ATOL`` of the JAX run's
    (for xz_bench20, where it is fixed before the policy acts), and the
    mean improvement at least the campaign's floor.  Returns the launches
    by kernel."""
    import mujoco
    from visual_foresight_torch.sim import run
    band = CAMPAIGNS[name]
    config = os.path.join(REPO, 'visual_foresight_torch', 'campaigns',
                          name + '.py')
    reset_tail_counts()
    t0 = time.perf_counter()
    with ReplanClock(torch.cuda.synchronize) as clock:
        result_dir = run.main([config, '--benchmark'])
    wall = time.perf_counter() - t0
    if not clock.ms:
        raise AssertionError('{}: the campaign planned no time'.format(name))
    launches = read_tail_counts(
        '{} campaign ({} replans x {})'.format(name, len(clock.ms),
                                               band['launches']),
        len(clock.ms) * band['launches'], clock.ctrls[0].predictor._hp)
    ref = {run_dir: jax_scores(run_dir) for run_dir in band['jax_runs']}
    stats, gap = check_campaign(
        name, result_dir, run.load_config(config), len(clock.ms),
        launches['cdna_tail'] + launches['cdna_tail_dna'], band['launches'],
        band['floor'],
        ref[band['jax_runs'][0]]['initial_dist']
        if name == 'xz_bench20' else None)
    print('{}_campaign: {} tasks, mean improvement {:.5f}, final distance '
          '{:.5f}; JAX: {}; initial_dist largest gap to {} {} (mujoco {}); '
          'wall {:.1f} s, {} replans, host p50 {:.3f} ms [{}]'.format(
              name, stats['improvement'].shape[0],
              float(np.mean(stats['improvement'])),
              float(np.mean(stats['final_dist'])),
              ', '.join('{} {:.5f} / {:.5f}'.format(
                  os.path.relpath(r, 'benchmarks'),
                  float(np.mean(v['improvement'])),
                  float(np.mean(v['final_dist']))) for r, v in ref.items()),
              band['jax_runs'][0],
              'not checked' if gap is None else '{:.3e}'.format(gap),
              mujoco.__version__, wall, len(clock.ms),
              float(np.percentile(clock.ms, 50)), card))
    return launches


def drive_campaigns(card, gl):
    """Both scored campaigns where MuJoCo renders here (``gl`` names the
    backend the probe found); else one line saying that they wait."""
    if gl is None:
        print('scored campaigns: xz_bench20 and ag_bench20 wait for MuJoCo '
              'on the card machine (no mujoco that renders here)')
        return {}
    os.environ['MUJOCO_GL'] = gl
    return {'campaign_' + name: drive_campaign(name, card)
            for name in CAMPAIGNS}


# -- data collection and offline replay ---------------------------------------
# campaigns/offline_towel_classifier.py (the twin of experiments/offline_exp/
# towel_classifier) on 2 raw trajectories written here: 3 episodes of 15
# steps (the replay cycles through the folders), each one replan in the host
# CEM loop of 3 iterations x one teacher-forced forward of the context action
# and the 15-step plan at B=600
OFFLINE_TWIN = os.path.join(REPO, 'visual_foresight_torch', 'campaigns',
                            'offline_towel_classifier.py')
COLLECT_TWIN = os.path.join(REPO, 'visual_foresight_torch', 'campaigns',
                            'collect_xz_r4.py')
AG_TASKS = os.path.join(REPO, 'benchmarks', 'tasks', 'ag_bench20',
                        'traj_group0')
REPLAY_TRAJS, REPLAY_EPISODES, REPLAY_T = 2, 3, 15
OFFLINE_PER_REPLAN = ITERS * (N_CTX - 1 + DEFAULT_T)
OFFLINE_TRAIN_STEPS = 5
# the human-scored CEM at bench.py's point on the flagship (200 samples x
# 5 actions x repeat 3 = 15 steps, 3 iterations), in the host loop
# (num_samples, nactions, repeat and iterations at their defaults: 200, 5,
# 3 and 3)
HUMAN_POLICY = {'action_order': ['x', 'z', 'grasp'], 'initial_std_lift': 0.5,
                'rejection_sampling': False, 'model_path': WEIGHTS}
HUMAN_PER_REPLAN = ITERS * (N_CTX - 1 + T)


def write_replay(root):
    """``REPLAY_TRAJS`` raw trajectory folders of ``REPLAY_T`` frames in the
    layout ``RawSaver`` writes (``images0/im_<t>.png``, ``obs_dict.pkl``):
    the frames blend task k's start frame of ``ag_bench20`` into its goal
    frame, plus seeded noise; the state is a seeded (x, y) walk followed by
    the towel source's three ``state_append`` constants (width 5,
    ag_r5f_v2's sdim).  Returns the frames by trajectory."""
    import cv2
    from visual_foresight_torch.campaigns.offline_towel_classifier import (
        STATE_APPEND)
    rng = np.random.RandomState(8)
    frames = []
    for k in range(REPLAY_TRAJS):
        task = os.path.join(AG_TASKS, 'traj{}'.format(k), 'images0')
        start, goal = (cv2.imread(os.path.join(task, 'im_{}.png'.format(i)))
                       [:, :, ::-1].astype(np.float64) for i in (0, 1))
        traj = os.path.join(root, 'traj_group0', 'traj{}'.format(k))
        os.makedirs(os.path.join(traj, 'images0'))
        seq = []
        for t in range(REPLAY_T):
            a = t / (REPLAY_T - 1)
            im = (1 - a) * start + a * goal + rng.randn(*start.shape) * 4
            seq.append(np.clip(np.round(im), 0, 255).astype(np.uint8))
            cv2.imwrite(os.path.join(traj, 'images0', 'im_{}.png'.format(t)),
                        seq[-1][:, :, ::-1])
        xy = np.clip(0.5 + np.cumsum(rng.randn(REPLAY_T, 2) * 0.02, 0), 0, 1)
        state = np.concatenate([xy, np.tile(STATE_APPEND, (REPLAY_T, 1))], 1)
        with open(os.path.join(traj, 'obs_dict.pkl'), 'wb') as f:
            pickle.dump({'state': state}, f)
        frames.append(np.stack(seq))
    return frames


def drive_offline_replay(root, card):
    """``sim/run.py`` of the towel twin on the card over the raw
    trajectories of ``write_replay``: ``REPLAY_EPISODES`` episodes, each
    replaying a folder and planning once with ``ClassifierController``
    (``FoldingCEMSampler``, 600 samples, the host loop), the predictor and
    the classifier restored; the tail's launches equal the replans times
    ``OFFLINE_PER_REPLAN``; each episode is written as a raw folder (16
    frames of 48x64, 15 finite actions, ``offline_replay``).  The first
    replan warms cuDNN up; the others are timed.  Returns (launches, the
    episodes' raw directory).  Then the replan is timed (``time_controller``)
    and profiled once."""
    from visual_foresight_torch.policy.cem_controllers.variants import (
        ClassifierController)
    from visual_foresight_torch.sim import run
    replay, out = os.path.join(root, 'replay'), os.path.join(root, 'out')
    frames = write_replay(replay)
    reset_tail_counts()
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, VMPC_REPLAY_DIR=replay,
                         VMPC_DATA_DIR=out,
                         VMPC_END_INDEX=str(REPLAY_EPISODES - 1)), \
            ReplanClock(torch.cuda.synchronize, ClassifierController) as clock:
        run.main([OFFLINE_TWIN])
    wall = time.perf_counter() - t0
    if len(clock.ms) != REPLAY_EPISODES:
        raise AssertionError('offline replay: {} replans for {} episodes'
                             .format(len(clock.ms), REPLAY_EPISODES))
    ctrl = clock.ctrls[0]
    check_restored('offline replay (towel twin)', ctrl)
    launches = read_tail_counts(
        'offline replay ({} replans x {})'.format(len(clock.ms),
                                                   OFFLINE_PER_REPLAN),
        len(clock.ms) * OFFLINE_PER_REPLAN, ctrl.predictor._hp)
    raw = os.path.join(out, 'train')
    for k in range(REPLAY_EPISODES):
        traj = os.path.join(raw, 'traj_group0', 'traj{}'.format(k))
        with open(os.path.join(traj, 'policy_out.pkl'), 'rb') as f:
            actions = np.stack([p['actions'] for p in pickle.load(f)])
        with open(os.path.join(traj, 'agent_data.pkl'), 'rb') as f:
            agent_data = pickle.load(f)
        pngs = sorted(os.listdir(os.path.join(traj, 'images0')))
        if len(pngs) != REPLAY_T + 1 or actions.shape != (REPLAY_T, 4) or \
                not np.isfinite(actions).all() or \
                not agent_data.get('offline_replay'):
            raise AssertionError('offline replay: episode {} wrote {} frames '
                                 'and actions {}'.format(k, len(pngs),
                                                         actions.shape))
    print('offline_replay: {} episodes x {} steps replayed from {} raw '
          'trajectories (ag_bench20 frames + noise, 48x64, state width 5), '
          '{} replans (600 samples x 15 steps x 3 iters, folding prior, host '
          'loop, classifier cost, bf16, ag_r5f_v2 + seeded classifier), {} '
          'tail launches; replan host clock {:.3f} ms the first (cuDNN\'s '
          'warm-up), then {} ms (p50 {:.3f}); wall {:.1f} s with the '
          'controller\'s build; raw episodes written [{}]'.format(
              REPLAY_EPISODES, REPLAY_T, len(frames), len(clock.ms),
              launches['cdna_tail'], clock.ms[0],
              ' '.join('{:.3f}'.format(x) for x in clock.ms[1:]),
              float(np.percentile(clock.ms[1:], 50)), wall, card))
    point = ('600 samples x 15 steps x 3 iters, folding prior, host loop, '
             'classifier cost, bf16, ag_r5f_v2')
    time_controller('offline_replay_replan', point, ctrl, ctrl._state, card)
    print('profile: one offline replay replan')
    profile_replan(lambda: ctrl.perform_CEM(ctrl._state))
    return launches, raw


def train_converted_records(raw, root, card):
    """The replayed episodes converted by the port's ``file_2_record`` into
    GZIP TFRecords, read back by ``BaseVideoDataset`` (frames, actions and
    states equal to the raw files), then ``OFFLINE_TRAIN_STEPS`` train
    steps at ag_r5f_v2's configuration (``--stochastic``) from them: 14
    forward and 14 backward tail launches a step, no plain version, every
    metric finite.  Returns the launches."""
    import cv2
    from visual_foresight_torch.data.dataset_reader import BaseVideoDataset
    from visual_foresight_torch.training.train_predictor import train
    from visual_foresight_torch.utils import file_2_record
    records = os.path.join(root, 'records')
    t0 = time.perf_counter()
    file_2_record.main([records, raw, str(W), '--T', str(REPLAY_T),
                        '--nworkers', '1', '--traj_per_file',
                        str(REPLAY_EPISODES), '--split', '1', '0', '0'])
    converted = time.perf_counter() - t0
    ds = BaseVideoDataset(records, 1, hparams_dict={'shuffle': False,
                                                    'num_epochs': 1})
    got = list(ds.numpy_iterator(keys=('images', 'actions', 'state')))
    ds.close()
    if len(got) != REPLAY_EPISODES:
        raise AssertionError('the converted records hold {} trajectories'
                             .format(len(got)))
    for b in got:
        # the shards' order is file_2_record's shuffle: find the episode
        for k in range(REPLAY_EPISODES):
            traj = os.path.join(raw, 'traj_group0', 'traj{}'.format(k))
            with open(os.path.join(traj, 'policy_out.pkl'), 'rb') as f:
                actions = np.stack([p['actions'] for p in pickle.load(f)])
            if np.array_equal(b['actions'][0], actions.astype(
                    b['actions'].dtype)):
                break
        else:
            raise AssertionError('a converted trajectory\'s actions match no '
                                 'episode')
        with open(os.path.join(traj, 'obs_dict.pkl'), 'rb') as f:
            state = pickle.load(f)['state'][:REPLAY_T]    # one a frame
        frames = np.stack([cv2.imread(os.path.join(
            traj, 'images0', 'im_{}.png'.format(t)))[:, :, ::-1]
            for t in range(REPLAY_T)])
        if not np.array_equal(b['images'][0, :, 0], frames) or \
                not np.array_equal(b['state'][0],
                                   state.astype(b['state'].dtype)):
            raise AssertionError('the converted records differ from the raw '
                                 'episode {}'.format(k))
    args = train_args(os.path.join(AG_WEIGHTS, 'model_config.json'),
                      batch_size=REPLAY_TRAJS, steps=OFFLINE_TRAIN_STEPS,
                      log_every=1, data_dir=records, loader='python',
                      stochastic=True, kl_anneal_start=0,
                      kl_anneal_end=OFFLINE_TRAIN_STEPS)
    reset_train_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        history, _ = train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_train_counts('training from the converted records',
                                 OFFLINE_TRAIN_STEPS,
                                 args.sequence_length - 1)
    if plain.calls or len(history) != OFFLINE_TRAIN_STEPS or not all(
            np.isfinite([h[k] for k in h]).all() for h in history):
        raise AssertionError('training from the converted records: a plain '
                             'version ran or a metric is not finite')
    print('converted records: {} replayed episodes -> GZIP TFRecords by '
          'file_2_record in {:.2f} s, read back equal to the raw frames, '
          'states and actions; {} ag_r5f_v2 train steps (stochastic, batch '
          '{}, bf16) from them in {:.1f} s, loss {} [{}]'.format(
              REPLAY_EPISODES, converted, OFFLINE_TRAIN_STEPS, REPLAY_TRAJS,
              wall, ' '.join('{:.5f}'.format(h['loss']) for h in history),
              card))
    return launches


def drive_human_cem(root, card):
    """One ``HumanCEMController`` replan at bench.py's point on the
    flagship (200 x 15 x 3, bf16, the host loop) on task 0's start frame,
    with a seeded script of scores in place of ``input()`` and a real file
    worker: the tail's launches (3 forwards of 16 steps), the scores of
    every iteration equal to the script, each refit's elites the lowest
    scored samples and its mean theirs, the action the best-scored sample's
    first, and every page and GIF on disk.  Returns the launches."""
    import builtins
    import cv2
    from visual_foresight_torch.agent.utils.file_saver import (
        start_file_worker)
    from visual_foresight_torch.policy.cem_controllers.human_cem_controller \
        import HumanCEMController
    frame = cv2.imread(TASK0_FRAME)[:, :, ::-1]
    images = np.repeat(frame[None, None], 2, axis=0)
    states = np.repeat(TASK0_STATE[None], 2, axis=0).astype(np.float32)
    ctrl = HumanCEMController(AG_PARAMS, dict(HUMAN_POLICY))
    check_restored('human CEM', ctrl)
    rng = np.random.RandomState(12)
    given = []

    def scripted_input(prompt=''):
        if prompt.startswith('restore traj'):
            return 'n'
        given.append(float(rng.randint(0, 10000)) / 100)
        return str(given[-1])

    ctrl.reset()
    refits = []
    sampler = ctrl._sampler
    refit = sampler.sample_next_actions

    def traced_refit(n, best_actions, scores):
        out = refit(n, best_actions, scores)
        refits.append((best_actions.copy(), scores.copy(),
                       sampler._mean.copy()))
        return out

    sampler.sample_next_actions = traced_refit
    worker = start_file_worker()
    ask, builtins.input = builtins.input, scripted_input
    try:
        worker.put(('path', root))
        reset_tail_counts()
        t0 = time.perf_counter()
        for t in range(2):
            out = ctrl.act(t=t, i_tr=0, images=images[:t + 1],
                           state=states[:t + 1], verbose_worker=worker)
        torch.cuda.synchronize()
        replan = time.perf_counter() - t0
        launches = read_tail_counts(
            'human CEM (bench.py point, 1 replan x {})'.format(
                HUMAN_PER_REPLAN), HUMAN_PER_REPLAN, ctrl.predictor._hp)
    finally:
        builtins.input = ask
        t0 = time.perf_counter()
        worker.close()
        drain = time.perf_counter() - t0
    scores = np.reshape(given, (ITERS, M))
    k = ctrl.elite_count
    for itr in range(ITERS):
        if not np.array_equal(ctrl.plan_stat['scores_itr{}'.format(itr)],
                              scores[itr]):
            raise AssertionError('human CEM: iteration {} scored other than '
                                 'the script'.format(itr))
    for itr, (elites, elite_scores, mean) in enumerate(refits):
        lead = elites.reshape(k, NACT, REPEAT, -1)[:, :, -1].reshape(k, -1)
        if not np.array_equal(elite_scores, np.sort(scores[itr])[:k]) or \
                not np.array_equal(mean, lead.mean(0)):
            raise AssertionError('human CEM: refit {} did not follow the '
                                 'scripted scores'.format(itr))
    best = np.argsort(scores[-1], kind='stable')
    if len(refits) != ITERS - 1 or \
            not np.array_equal(ctrl._best_indices, best[:k]) or \
            not np.array_equal(out['actions'], ctrl._best_actions[0, 0]):
        raise AssertionError('human CEM: the plan is not the best-scored '
                             'sample\'s')
    for itr in range(ITERS):
        folder = os.path.join(root, 'planning_1_itr_{}'.format(itr))
        gifs = [n for n in os.listdir(folder) if n.endswith('.gif')]
        if len(gifs) != M or not all(os.path.isfile(os.path.join(folder, n))
                                     for n in ('preds.html', 'plan.html',
                                               'cam_0_start.png')):
            raise AssertionError('human CEM: the pages of iteration {} are '
                                 'incomplete'.format(itr))
    print('human_cem: one replan at bench.py\'s point (200 x 15 x 3, bf16, '
          'xz_flagship, host loop) with {} scripted scores, {} tail '
          'launches, the refits led by the lowest scores, the action the '
          'best-scored sample\'s; 2 act() steps {:.3f} s on the host clock; '
          '{} pages and {} GIFs written, the worker drained {:.3f} s after '
          'the act [{}]'.format(len(given), launches['cdna_tail'], replan,
                                2 * ITERS, ITERS * M, drain, card))
    return launches


def collect_where_possible(root, gl):
    """What of data collection the card machine cannot run: the MuJoCo
    collection (``collect_xz_r4.py``, 2 trajectories of T 30, its records
    read back) where MuJoCo renders (``gl``), and the HDF5 writers
    (``agent/utils/hdf5_saver.py``, ``utils/file_2_hdf5.py``) where
    ``h5py`` and ``imageio`` import; one line for each that waits."""
    import importlib
    missing = []
    for name in ('h5py', 'imageio'):
        try:
            importlib.import_module(name)
        except ImportError:
            missing.append(name)
    if missing:
        print('HDF5 writers (agent/utils/hdf5_saver.py, utils/file_2_hdf5.py)'
              ': wait for {} on the card machine; held against the JAX '
              'package on the CPU (tests/test_torch_collect.py)'.format(
                  ' and '.join(missing)))
    else:
        from visual_foresight_torch.agent.utils.hdf5_saver import HDF5Saver
        obs = {'images': np.zeros((4, 1, H, W, 3), np.uint8),
               'state': np.zeros((4, 3))}
        HDF5Saver(root, {}, {'T': 4}, traj_per_file=1,
                  split=(1.0, 0.0, 0.0)).save_traj(
                      0, {}, obs, [{'actions': np.zeros(3)}] * 3)
        print('HDF5 writers: h5py and imageio import; HDF5Saver wrote {}'
              .format(os.listdir(os.path.join(root, 'hdf5', 'train'))))
    if gl is None:
        print('MuJoCo collection (campaigns/collect_xz_r4.py): waits for '
              'MuJoCo on the card machine (no mujoco that renders here); '
              'run on the CPU in tests/test_torch_collect.py')
        return
    from visual_foresight_torch.data.dataset_reader import BaseVideoDataset
    from visual_foresight_torch.sim import run
    os.environ['MUJOCO_GL'] = gl
    data = os.path.join(root, 'collect')
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, VMPC_DATA_DIR=data, VMPC_END_INDEX='1'):
        run.main([COLLECT_TWIN])
    wall = time.perf_counter() - t0
    n = 0
    for half in ('good', 'bad'):
        for mode in ('train', 'val', 'test'):
            if os.listdir(os.path.join(data, 'records', half, mode)):
                ds = BaseVideoDataset(os.path.join(data, 'records', half), 1,
                                      hparams_dict={'shuffle': False,
                                                    'num_epochs': 1})
                n += len(list(ds.numpy_iterator(keys=('images',),
                                                mode=mode)))
                ds.close()
    if n != 2:
        raise AssertionError('collect_xz_r4: {} trajectories recorded'
                             .format(n))
    print('MuJoCo collection (collect_xz_r4, {}): 2 trajectories of T 30 '
          'recorded and read back in {:.1f} s'.format(gl, wall))


def drive_collection(card, gl):
    """Phase 8: the offline replay, its episodes converted and trained
    from, the human-scored CEM, and what waits.  Returns the launches by
    path."""
    root = tempfile.mkdtemp(prefix='chip_smoke_collect_')
    try:
        paths = {}
        paths['offline_replay'], raw = drive_offline_replay(root, card)
        paths['train_converted_records'] = train_converted_records(
            raw, root, card)
        human = os.path.join(root, 'human')
        os.makedirs(human)
        paths['human_cem'] = drive_human_cem(human, card)
        collect_where_possible(root, gl)
        return paths
    finally:
        shutil.rmtree(root)


# -- pretrained TF1 weights served, the data and profiling tools ---------------
# the flagship's numpy weights written by the port's export_tf1_checkpoint as
# a bundle at step 5000 beside a stale bundle of zeros at step 100 (the
# highest step is served); bench.py's point replanned once on the bundle's
# predictor and once on the numpy one, then timed in turns
TF1_STEP, TF1_STALE = 5000, 100
TF1_TENSORS = 38                  # the flagship's leaves
TF1_ROUNDS, TF1_TIMED = ('numpy', 'tf1', 'tf1', 'numpy'), 5
VIS_N = 4                         # visualize_predictions' --n
VIS_RUNS = 3                      # its runs, the first checked
HDF5_TRAJS, HDF5_PER_FILE, HDF5_STEPS = 16, 8, 5
SAWYER_TWIN = os.path.join(REPO, 'visual_foresight_torch', 'campaigns',
                           'collect_sawyer_arm.py')
# the sawyer arm twin cut to T 6 (2 actions under repeat 3) and two
# trajectories
SAWYER_CUT = '''import copy
from visual_foresight_torch.sim.run import load_config
config = copy.deepcopy(load_config({src!r}))
config['agent'].update(T=6, data_save_dir={out!r})
config['policy'].update(nactions=2)
config.update(start_index=0, end_index=1, traj_per_file=2,
              current_dir={root!r})
'''


def model_hp(model):
    """What ``read_tail_counts`` reads of an architecture, from a
    ``CDNAPredictor`` built without a predictor (``visualize_predictions``'
    model)."""
    return {'dna': model.step.dna, 'std_factor': model.std_factor,
            'mask_softmax': model.step.mask_softmax}


class ForwardClock(object):
    """Inside the block, every ``CDNAPredictor.forward`` (the class's, so it
    reaches the model that a tool builds) is timed by CUDA events on the
    current stream: ``ms`` holds the forwards' times, ``models`` the last
    model that ran."""

    def __enter__(self):
        from visual_foresight_torch.models.cdna import CDNAPredictor
        self.ms, self.models = [], []
        forward = self._forward = CDNAPredictor.forward

        def timed_forward(model, *args, **kwargs):
            self.models[:] = [model]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = forward(model, *args, **kwargs)
            end.record()
            end.synchronize()
            self.ms.append(start.elapsed_time(end))
            return out

        CDNAPredictor.forward = timed_forward
        return self

    def __exit__(self, *exc):
        from visual_foresight_torch.models.cdna import CDNAPredictor
        CDNAPredictor.forward = self._forward


def write_tf1(root):
    """The flagship's ``params.npz`` written by the port's
    ``export_tf1_checkpoint`` as the bundle ``root/view0/model-5000``
    beside a stale bundle of zeros at ``model-100`` and the flagship's
    ``model_config.json``.  Returns (the bundle's prefix, export seconds,
    the bundle's bytes)."""
    from visual_foresight_torch.models.convert import (read_npz,
                                                       unflatten_flax)
    from visual_foresight_torch.prediction import tf1_import
    flat = read_npz(os.path.join(WEIGHTS, 'view0', 'params.npz'))
    view0 = os.path.join(root, 'view0')
    prefix = os.path.join(view0, 'model-{}'.format(TF1_STEP))
    t0 = time.perf_counter()
    tf1_import.export_tf1_checkpoint(unflatten_flax(flat), prefix)
    export = time.perf_counter() - t0
    tf1_import.export_tf1_checkpoint(
        unflatten_flax({k: np.zeros_like(v) for k, v in flat.items()}),
        os.path.join(view0, 'model-{}'.format(TF1_STALE)))
    shutil.copy(os.path.join(WEIGHTS, 'model_config.json'), root)
    size = sum(os.path.getsize(os.path.join(view0, n))
               for n in os.listdir(view0)
               if n.startswith(os.path.basename(prefix) + '.'))
    return prefix, export, size


def drive_tf1(root, card):
    """The TF1 bundle served: ``TorchPredictor`` restored on the card from
    ``write_tf1``'s directory prints the import of the step-5000 bundle
    (``restored`` true), holds the numpy restore's state exactly, and its
    200 x 15 x 3 replan (the same context and draws) gives the numpy
    predictor's scores and actions bit for bit, 46 tiled launches each;
    then both replans' host times in turns.  The import is timed inside
    the restore (``predictor.load_view``: the bundle read, its CRCs and
    shapes checked, the tree loaded into the model).  Returns (the
    launches by path, the bundle predictor, its replan function)."""
    import contextlib
    import io
    from visual_foresight_torch.data.tfrecord_io import (crc32c_impl,
                                                         crc32c_numpy)
    from visual_foresight_torch.prediction import predictor as t_predictor
    crc = 'the numpy CRC32C' if crc32c_impl() is crc32c_numpy \
        else 'google_crc32c'
    prefix, export, size = write_tf1(root)
    load_view, loads = t_predictor.load_view, []

    def timed_load_view(*args):
        t0 = time.perf_counter()
        out = load_view(*args)
        loads.append(time.perf_counter() - t0)
        return out

    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log), mock.patch.object(
            t_predictor, 'load_view', timed_load_view):
        imported = restored_predictor('bfloat16', weights=root)
    restore = time.perf_counter() - t0
    sys.stdout.write(log.getvalue())
    want = 'imported TF1 checkpoint {} ({} tensors)'.format(prefix,
                                                            TF1_TENSORS)
    if want not in log.getvalue() or len(loads) != 1:
        raise AssertionError('the predictor did not print "{}" once'.format(
            want))
    import_s = loads[0]
    numpy_pred = restored_predictor('bfloat16')
    ref = numpy_pred.models[0].state_dict()
    for key, value in imported.models[0].state_dict().items():
        if not torch.equal(value, ref[key]):
            raise AssertionError('the TF1 restore differs from the numpy '
                                 'one at {}'.format(key))

    rng = np.random.RandomState(9)
    context = lambda: (rng.rand(1, N_CTX, H, W, 3).astype(np.float32),
                       (rng.randn(N_CTX, 3) * 0.05).astype(np.float32))
    images, states = context()
    preds = {'numpy': numpy_pred, 'tf1': imported}
    replans = {name: replan_200(p) for name, p in preds.items()}
    outs, paths = {}, {}
    for name, pred in preds.items():
        reset_tail_counts()
        outs[name] = replans[name](
            images, states,
            generator=torch.Generator(device='cuda').manual_seed(1))
        torch.cuda.synchronize()
        paths['{}_replan_200'.format(name)] = read_tail_counts(
            '200-sample replan on the {} restore'.format(
                'TF1 bundle' if name == 'tf1' else 'numpy'),
            LAUNCHES_PER_REPLAN, pred._hp)
    for key in ('best_actions', 'best_scores', 'scores_per_itr'):
        if not torch.equal(outs['tf1'][key], outs['numpy'][key]):
            raise AssertionError('the TF1-restored replan\'s {} differ from '
                                 'the numpy one\'s'.format(key))
    times = {name: [] for name in preds}
    spans = {name: [] for name in preds}
    gen = torch.Generator(device='cuda').manual_seed(2)
    for name in TF1_ROUNDS:
        replans[name](*context(), generator=gen)        # warm-up
        for _ in range(TF1_TIMED):
            args = context()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            replans[name](*args, generator=gen)
            end.record()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            spans[name].append(start.elapsed_time(end))
    p50 = {name: (float(np.percentile(times[name], 50)),
                  float(np.percentile(spans[name], 50))) for name in preds}
    print('tf1: the flagship as a TF1 bundle ({} bytes, {} tensors) '
          'exported in {:.3f} s and imported by the predictor\'s restore in '
          '{:.3f} s with {} (the predictor built and restored on the card in '
          '{:.3f} s); its state '
          'equals the numpy restore\'s, its 200 x 15 x 3 replan equals the '
          'numpy predictor\'s bit for bit ({} launches each); over {} '
          'replans each in turns {}, host p50 / CUDA-event span p50: TF1 '
          '{:.3f} / {:.3f} ms, numpy {:.3f} / {:.3f} ms [{}]'.format(
              size, TF1_TENSORS, export, import_s, crc, restore,
              LAUNCHES_PER_REPLAN, len(times['tf1']), '/'.join(TF1_ROUNDS),
              *p50['tf1'], *p50['numpy'], card))
    return paths, imported, replans['tf1']


def drive_tools(root, weights_root, card):
    """``visualize_predictions.main`` (``--n 4``, the flagship's flags, bf16)
    on the card, on records written as phase 5i writes them and the weights
    in ``weights_root``, ``VIS_RUNS`` times: the first gives a finite PSNR
    report of ``sequence_length - 1`` steps, 4 strips on disk and
    ``sequence_length - 1`` tiled launches; the tool's own forward is timed
    in every run (``ForwardClock``).  Then ``check_dataset.main`` on the
    same records.  Returns the first run's launches."""
    import cv2
    from visual_foresight_torch.training import visualize_predictions
    from visual_foresight_torch.utils import check_dataset
    config = os.path.join(WEIGHTS, 'model_config.json')
    records = os.path.join(root, 'records')
    write_records(records)
    strips = os.path.join(root, 'strips')
    argv = config_argv(config, data_dir=records, model_dir=weights_root,
                       n=VIS_N, out_dir=strips, mode='train')
    seq = train_args(config).sequence_length
    walls = []
    with ForwardClock() as clock:
        for run in range(VIS_RUNS):
            reset_tail_counts()
            t0 = time.perf_counter()
            report = visualize_predictions.main(argv)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if not run:
                launches = read_tail_counts(
                    'visualize_predictions (--n {}, {} frames)'.format(
                        VIS_N, seq), seq - 1, model_hp(clock.models[0]))
                first = report
    report = first
    if len(clock.ms) != VIS_RUNS:
        raise AssertionError('visualize_predictions ran {} forwards in {} '
                             'runs'.format(len(clock.ms), VIS_RUNS))
    values = report['psnr_per_step'] + [report['psnr_autoregressive'],
                                        report['psnr_final_step']]
    if len(report['psnr_per_step']) != seq - 1 or \
            not np.all(np.isfinite(values)):
        raise AssertionError('visualize_predictions: PSNR report {}'.format(
            report))
    for b in range(VIS_N):
        strip = cv2.imread(os.path.join(strips, 'traj{}.png'.format(b)))
        if strip is None or strip.shape != (2 * H, (seq - 1) * W, 3):
            raise AssertionError('visualize_predictions: strip {} is {}'
                                 .format(b, None if strip is None
                                         else strip.shape))
    t0 = time.perf_counter()
    check_dataset.main([records, '--batch_size', str(VIS_N), '--out',
                        os.path.join(root, 'dataset_check.png')])
    check = time.perf_counter() - t0
    tiles = cv2.imread(os.path.join(root, 'dataset_check.png'))
    if tiles is None or tiles.shape != (VIS_N * H, seq * W, 3):
        raise AssertionError('check_dataset: tiles {}'.format(
            None if tiles is None else tiles.shape))
    print('visualize_predictions: PSNR {} dB autoregressive, {} dB at the '
          'last step, {} strips, {} launches; {} runs of the tool, host '
          'clock {} s, its forward ({} x {} frames, bf16, CUDA events) {} '
          'ms; check_dataset {:.3f} s [{}]'.format(
              report['psnr_autoregressive'], report['psnr_final_step'],
              VIS_N, launches['cdna_tail'], VIS_RUNS,
              ' / '.join('{:.3f}'.format(w) for w in walls), VIS_N, seq,
              ' / '.join('{:.3f}'.format(ms) for ms in clock.ms), check,
              card))
    return launches


def drive_profiling(root, predictor, replan, card):
    """One 200 x 15 x 3 replan of the TF1-restored predictor inside
    ``device_trace`` and ``PhaseTimer`` phases (the replan, then the copy
    of its plan to the host): the chrome trace on disk holding CUDA kernel
    events (the tail's among them) and the phases, the timer's counts, and
    the replan's 46 launches.  Returns the launches."""
    import glob
    from visual_foresight_torch.utils.profiling import (PhaseTimer,
                                                        device_trace)
    rng = np.random.RandomState(11)
    images = rng.rand(1, N_CTX, H, W, 3).astype(np.float32)
    states = (rng.randn(N_CTX, 3) * 0.05).astype(np.float32)
    gen = torch.Generator(device='cuda').manual_seed(3)
    trace_dir = os.path.join(root, 'trace')
    timer = PhaseTimer()
    reset_tail_counts()
    with device_trace(trace_dir):
        with timer.phase('replan'):
            out = replan(images, states, generator=gen)
        with timer.phase('plan_to_host'):
            out['best_actions'].cpu()
    launches = read_tail_counts('profiled 200-sample replan (TF1 restore)',
                                LAUNCHES_PER_REPLAN, predictor._hp)
    report = timer.report()
    if {k: v['count'] for k, v in report.items()} != {'replan': 1,
                                                      'plan_to_host': 1}:
        raise AssertionError('PhaseTimer report {}'.format(report))
    files = glob.glob(os.path.join(trace_dir, '*.pt.trace.json'))
    if len(files) != 1:
        raise AssertionError('device_trace wrote {}'.format(files))
    with open(files[0]) as f:
        events = json.load(f)['traceEvents']
    kernels = [e for e in events if e.get('cat') == 'kernel']
    tail = [e for e in kernels if 'cdna_tail' in e.get('name', '')]
    names = {e.get('name') for e in events}
    if not kernels or len(tail) != LAUNCHES_PER_REPLAN or \
            not {'replan', 'plan_to_host'} <= names:
        raise AssertionError('the trace holds {} kernel events, {} of the '
                             'tail, phases {}'.format(
                                 len(kernels), len(tail),
                                 sorted({'replan', 'plan_to_host'} & names)))
    busy = sum(e.get('dur', 0) for e in kernels) / 1e3
    print('profiling: device_trace wrote {} ({:.1f} kB, {} events, {} CUDA '
          'kernels, {} of the tail, {:.3f} ms of kernel time); PhaseTimer {} '
          '[{}]'.format(os.path.basename(files[0]),
                        os.path.getsize(files[0]) / 1e3, len(events),
                        len(kernels), len(tail), busy, json.dumps(report),
                        card))
    return launches


def importable(name):
    import importlib
    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def write_hdf5(root, args):
    """``HDF5_TRAJS`` flagship-shaped trajectories (the trainer's synthetic
    batches as uint8) written by the port's ``HDF5Saver`` into the bucketed
    layout under ``root``."""
    from visual_foresight_torch.agent.utils.hdf5_saver import HDF5Saver
    from visual_foresight_torch.training.train_predictor import (
        synthetic_batches)
    seq = args.sequence_length
    saver = HDF5Saver(root, {'max_num_actions': seq}, {'T': seq},
                      traj_per_file=HDF5_PER_FILE, split=(1.0, 0.0, 0.0))
    batches = synthetic_batches(args, seed=4)
    i = 0
    while i < HDF5_TRAJS:
        batch = next(batches)
        for b in range(len(batch['images'])):
            obs = {'images': np.round(batch['images'][b] * 255).astype(
                np.uint8)[:, None], 'state': batch['states'][b]}
            saver.save_traj(i, {}, obs, [{'actions': a}
                                         for a in batch['actions'][b]])
            i += 1


def train_from_hdf5(args):
    """``write_hdf5``'s trajectories under ``args.data_dir``, then
    ``args.steps`` train steps from them through the RoboNet reader, logged
    every step: every logged value finite.  Returns (the history, the wall
    seconds)."""
    from visual_foresight_torch.training.train_predictor import train
    write_hdf5(args.data_dir, args)
    t0 = time.perf_counter()
    history, _ = train(args)
    if args.device != 'cpu':
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(history) != args.steps or not all(
            np.isfinite([h[k] for k in h]).all() for h in history):
        raise AssertionError('training from HDF5: {}'.format(history))
    return history, wall


def collect_sawyer(root, gl):
    """``SAWYER_CUT`` (two ``collect_sawyer_arm.py`` trajectories of T 6)
    through ``sim.run.main`` with MuJoCo on the GL backend ``gl``, into
    ``root``: two trajectories recorded and read back.  Returns the wall
    seconds."""
    from visual_foresight_torch.data.dataset_reader import BaseVideoDataset
    from visual_foresight_torch.sim import run
    cut = os.path.join(root, 'cut.py')
    with open(cut, 'w') as f:
        f.write(SAWYER_CUT.format(src=SAWYER_TWIN, root=root,
                                  out=os.path.join(root, 'data')))
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, MUJOCO_GL=gl):
        run.main([cut])
    wall = time.perf_counter() - t0
    records = os.path.join(root, 'data', 'records')
    n = 0
    for mode in ('train', 'val', 'test'):
        if os.listdir(os.path.join(records, mode)):
            ds = BaseVideoDataset(records, 1, hparams_dict={
                'shuffle': False, 'num_epochs': 1})
            n += len(list(ds.numpy_iterator(keys=('images',), mode=mode)))
            ds.close()
    if n != 2:
        raise AssertionError('collect_sawyer_arm: {} trajectories recorded'
                             .format(n))
    return wall


def run_or_wait(root, card, gl):
    """What the card machine may lack: ``train_from_hdf5`` at the
    flagship's widths (``HDF5_STEPS`` steps, tail launches counted) where
    ``h5py`` and ``imageio`` import; ``collect_sawyer`` where MuJoCo renders
    (``gl``); else one line for each that waits.  Returns the launches by
    path."""
    paths = {}
    missing = [n for n in ('h5py', 'imageio') if not importable(n)]
    if missing:
        print('RoboNet reader (data/robonet_reader.py, train_predictor '
              '--data_dir on HDF5): waits for {} on the card machine; held '
              'against the JAX package on the CPU '
              '(tests/test_torch_robonet.py)'.format(' and '.join(missing)))
    else:
        args = train_args(os.path.join(WEIGHTS, 'model_config.json'),
                          batch_size=TRAIN_BATCH, steps=HDF5_STEPS,
                          log_every=1, data_dir=os.path.join(root, 'hdf5'))
        reset_train_counts()
        history, wall = train_from_hdf5(args)
        paths['train_hdf5_xz_flagship'] = read_train_counts(
            'flagship training from HDF5 (RoboNet reader)', HDF5_STEPS,
            args.sequence_length - 1)
        print('RoboNet reader: {} trajectories written by HDF5Saver, {} '
              'flagship steps from them in {:.1f} s, loss {:.5f} to {:.5f} '
              '[{}]'.format(HDF5_TRAJS, HDF5_STEPS, wall,
                            history[0]['loss'], history[-1]['loss'], card))
    if gl is None:
        print('sawyer MuJoCo envs (envs/mujoco_env/sawyer_env, '
              'campaigns/collect_sawyer_arm.py, collect_sawyer_grasp.py): '
              'wait for MuJoCo on the card machine (no mujoco that renders '
              'here); held against the JAX package on the CPU '
              '(tests/test_torch_sawyer.py)')
        return paths
    sawyer = os.path.join(root, 'sawyer')
    os.makedirs(sawyer)
    wall = collect_sawyer(sawyer, gl)
    print('sawyer arm collection ({}): 2 trajectories of T 6 recorded and '
          'read back in {:.1f} s'.format(gl, wall))
    return paths


def drive_tf1_and_tools(card, gl):
    """Phase 9: the TF1 bundle served and replanned, the data tools and
    profiling on the card, and what waits.  Returns the launches by
    path."""
    root = tempfile.mkdtemp(prefix='chip_smoke_tf1_')
    try:
        tf1_root = os.path.join(root, 'tf1')
        paths, predictor, replan = drive_tf1(tf1_root, card)
        paths['visualize_predictions'] = drive_tools(root, tf1_root, card)
        paths['profiled_replan'] = drive_profiling(root, predictor, replan,
                                                   card)
        paths.update(run_or_wait(root, card, gl))
        return paths
    finally:
        shutil.rmtree(root)


# -- the robot path --------------------------------------------------------------
# campaigns/robot_sawyer_pixel_cost.py (the twin of experiments/sawyer/
# pixel_cost/hparams.py) through sim/run_robot.py's RobotEnvironment: a
# kinematic fake arm, two test-pattern camera nodes at 640x480 on channels
# of this process (``robot_cameras``: the twin's topics /camera0/image_raw
# and /camera1/image_raw with the pid added, so that two runs on one machine
# never share a ring), and a two-view model directory (view 0 ag_r5f_v2, view 1 ag_r5f_v2
# plus seeded noise); 2 trajectories of T 20 (a replan at t=1 and t=11,
# each 2 views x (1 + 3 x 15) = 92 launches at B=600), then a third resumed
ROBOT_TWIN = os.path.join(REPO, 'visual_foresight_torch', 'campaigns',
                          'robot_sawyer_pixel_cost.py')
ROBOT_NAME = 'vestri'         # a sawyer of envs/robot_envs/robot_configs.json
ROBOT_FRAME = (480, 640)      # the nodes' frames, the twin's IMTopic size
ROBOT_CAM_NAMES = ('front', 'left')
ROBOT_VIEW1_SEED = 91
ROBOT_CLICK_SEED = 15
ROBOT_MOVE_S = 0.1            # a fake move's time, recorded by the cameras
ROBOT_F32_SEED = 3


class FakeArm(object):
    """A kinematically exact fake arm with the surface of the robot
    controllers (``tests/test_robot_env.py::FakeController``'s), given to
    the robot env as its ``robot_type``.  A move takes ``move_s`` seconds,
    so that the cameras record frames meanwhile."""

    move_s = ROBOT_MOVE_S

    def __init__(self, robot_name, print_debug=False, email_cred_file='',
                 log_file='', gripper_attached='none'):
        self._xyz = np.array([0.6, 0.0, 0.25])
        self._yaw = 0.0
        self._gripper = 1.0   # open fraction

    def get_gripper_state(self, integrate_force=False):
        return self._gripper, None

    def get_gripper_limits(self):
        return 0.0, 1.0

    def open_gripper(self, wait=False):
        self._gripper = 1.0

    def close_gripper(self, wait=False):
        self._gripper = 0.0

    def quat_2_euler(self, quat):
        from scipy.spatial.transform import Rotation
        yaw, pitch, roll = Rotation.from_quat(
            np.roll(np.asarray(quat), -1)).as_euler('ZYX')
        return np.array([yaw, pitch, roll])

    def euler_2_quat(self, yaw=0.0, pitch=0.0, roll=0.0):
        from scipy.spatial.transform import Rotation
        return np.roll(Rotation.from_euler(
            'ZYX', [yaw, pitch, roll]).as_quat(), 1)

    def get_state(self):
        return np.zeros(7), np.zeros(7), self.get_cartesian_pose()

    def get_cartesian_pose(self):
        return np.concatenate([self._xyz, self.euler_2_quat(self._yaw)])

    def get_xyz_quat(self):
        eep = self.get_cartesian_pose()
        return eep[:3], eep[3:]

    def move_to_eep(self, target_pose, duration=1.5):
        time.sleep(self.move_s)
        self._xyz = np.asarray(target_pose[:3])
        self._yaw = self.quat_2_euler(target_pose[3:])[0]

    def move_to_neutral(self, duration=2.0):
        self._xyz = np.array([0.6, 0.0, 0.25])
        self._yaw = 0.0

    def redistribute_objects(self):
        pass


class ScriptedClicks(object):
    """``select_points`` answered from a seeded stream of pixels inside the
    frames; ``calls`` keeps each call's prefix and answer."""

    def __init__(self, seed):
        self._rng = np.random.RandomState(seed)
        self.calls = []

    def _draw(self, ncam, n_desig, h, w):
        return np.stack([self._rng.randint(0, (h, w), (n_desig, 2))
                         for _ in range(ncam)]).astype(np.int64)

    def __call__(self, images, cam_names, prefix, save_dir=None,
                 clicks_per_desig=2, n_desig=1):
        ncam, h, w = images.shape[:3]
        out = self._draw(ncam, n_desig, h, w)
        if clicks_per_desig == 2:
            out = (out, self._draw(ncam, n_desig, h, w))
        self.calls.append((prefix, out))
        return out


class ScriptedPrompts(object):
    """``input()`` answered from a script: yes to the goal definition's
    check, no to the retry question, enter to the others (the safe-neutral
    and annotation prompts); ``seen`` keeps the prompts."""

    def __init__(self):
        self.seen = []

    def __call__(self, prompt=''):
        self.seen.append(prompt)
        if 'definition okay' in prompt:
            return 'y'
        if 'retry' in prompt:
            return 'n'
        return ''


def robot_cameras(flips=(True, False)):
    """Cameras on channels of this process, one a flag of ``flips``: the
    node channels, and topics on them flipped as ``flips`` says (the
    pixel-cost twin's by default: camera 0 flipped, as in
    ``campaigns/robot_sawyer_pixel_cost.py``)."""
    from visual_foresight_torch.envs.robot_envs.util.topic_utils import (
        IMTopic)
    pid = os.getpid()
    channels = ['camera{}_image_raw_{}'.format(i, pid)
                for i in range(len(flips))]
    topics = [IMTopic('/camera{}/image_raw_{}'.format(i, pid), flip=flip)
              for i, flip in enumerate(flips)]
    return channels, topics


class CameraNodes(object):
    """The port's camera node (``native/camera_stream.cpp``), built at
    first use, started in ``--test-pattern`` mode on each of ``channels``;
    on exit each is stopped and its ``/dev/shm`` ring unlinked.  A ring left
    on a channel is removed first, so only the node's own ring counts as its
    start.  A node that does not build or start raises."""

    def __init__(self, channels, height, width, fps=30):
        self._channels, self._size = channels, (height, width)
        self._fps, self._procs = fps, []

    def __enter__(self):
        from visual_foresight_torch.native import start_cameras
        exe = start_cameras.ensure_built()
        h, w = self._size
        try:
            for ch in self._channels:
                if os.path.exists(self.ring(ch)):
                    os.remove(self.ring(ch))
                self._procs.append(subprocess.Popen(
                    [exe, '--channel', ch, '--test-pattern', '--width',
                     str(w), '--height', str(h), '--fps', str(self._fps)],
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
            deadline = time.time() + 10
            for ch, proc in zip(self._channels, self._procs):
                while not os.path.exists(self.ring(ch)):
                    if proc.poll() is not None or time.time() > deadline:
                        raise RuntimeError('the camera node on {} did not '
                                           'start (exit {})'.format(
                                               ch, proc.poll()))
                    time.sleep(0.05)
        except BaseException:
            self.__exit__()
            raise
        return exe

    @staticmethod
    def ring(channel):
        return '/dev/shm/vftpu_cam_' + channel

    def __exit__(self, *exc):
        for proc in self._procs:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for ch in self._channels:
            if os.path.exists(self.ring(ch)):
                os.remove(self.ring(ch))


def robot_model_dir(root):
    """The two-view model directory of the robot twin: ``view0/`` the
    numpy export of ag_r5f_v2, ``view1/`` the same plus seeded noise (as
    ``predictor_dirs`` makes registration's second view)."""
    from visual_foresight_torch.models.convert import perturbed_flat, read_npz
    flat = read_npz(os.path.join(AG_WEIGHTS, 'view0', 'params.npz'))
    for v, views in enumerate((flat, perturbed_flat(
            flat, ROBOT_VIEW1_SEED, stand_ins.COPY_SCALE))):
        os.makedirs(os.path.join(root, 'view{}'.format(v)))
        np.savez(os.path.join(root, 'view{}'.format(v), 'params.npz'),
                 **views)
    shutil.copyfile(os.path.join(AG_WEIGHTS, 'model_config.json'),
                    os.path.join(root, 'model_config.json'))
    return root


def robot_config(model_dir, result_dir, end_index, save_video=True,
                 twin=ROBOT_TWIN, **cut):
    """The config of the robot twin file ``twin`` (the sawyer pixel-cost
    twin by default) for ``RobotEnvironment``: the fake arm, the weights of
    ``model_dir`` (as ``VMPC_MODEL_DIR`` gives them; None: the twin's
    default weights), the results under ``result_dir`` (as ``RESULT_DIR``
    gives them) and ``end_index``; ``cut`` updates the agent, the env and
    the policy (``agent``, ``env``, ``policy`` dicts) for a run at a small
    size."""
    import copy
    import warnings
    from visual_foresight_torch.sim.run import load_config
    env_vars = {} if model_dir is None else {'VMPC_MODEL_DIR': model_dir}
    with mock.patch.dict(os.environ, env_vars), warnings.catch_warnings():
        warnings.simplefilter('ignore')
        config = copy.deepcopy(load_config(twin))
    env = config['agent']['env'][1]
    env.update(robot_name=ROBOT_NAME, robot_type=FakeArm,
               save_video=save_video, **cut.get('env', {}))
    config['agent'].update(data_save_dir=result_dir, **cut.get('agent', {}))
    config['policy'].update(cut.get('policy', {}))
    config['end_index'] = end_index
    return config


def run_robot_twin(config, clock, resume=False):
    """``RobotEnvironment`` of the port's ``sim/run_robot.py`` on
    ``config`` with ``--benchmark`` (``resume``: ``-r``), the clicks and
    prompts scripted, inside ``clock`` (a ``ReplanClock``); the cameras'
    readers stopped and the file worker drained after (``close_robot``).
    Returns (the clicks, the prompts, the controller).  Raises the file
    worker's ``Mp4Unwritable`` where it could not open an mp4 writer in a
    run that went through; a run that failed raises its own error."""
    from visual_foresight_torch.envs.robot_envs import base_env
    from visual_foresight_torch.sim import run_robot
    clicks, prompts = ScriptedClicks(ROBOT_CLICK_SEED), ScriptedPrompts()
    with mock.patch.object(base_env, 'select_points', clicks), \
            mock.patch('builtins.input', prompts), clock:
        robot = run_robot.RobotEnvironment(config, resume=resume,
                                           benchmark=True)
        try:
            robot.run()
        except BaseException:
            try:
                close_robot(robot)
            except Exception as e:
                print('robot twin: closing after the failed run: {}: {}'
                      .format(type(e).__name__, e))
            raise
        close_robot(robot)
    return clicks, prompts, robot.policy


def close_robot(robot):
    """Stop the cameras' readers of ``robot`` (a ``RobotEnvironment``),
    then drain and stop its file worker, which raises where it failed."""
    try:
        robot.agent.env.close()
    finally:
        robot.agent.cleanup()


def pix_to_width(pix, width, raw_width):
    """Pixels of a ``raw_width`` frame at ``width``, rounded: the hand
    computation that the stats are held to."""
    return np.round(np.asarray(pix, np.float64) * width / raw_width)


def check_robot_trajs(result_dir, trajs, clicks, T, save_video, width=W,
                      raw_width=ROBOT_FRAME[1], cam_names=ROBOT_CAM_NAMES):
    """The raw folders and the stats of trajectories ``trajs``: per camera
    one JPEG for each frame of ``obs_dict['images']``, the pickles and
    ``env_metadata.json``; finite actions; states inside the workspace
    (the xyz fraction in [0, 1], yaw and grip inside the env's bounds);
    ``final_dist``, ``start_dist`` and ``improvement`` as computed here
    from the scripted clicks (on frames ``raw_width`` wide, scored at
    ``width``); with ``save_video`` each camera's clip an mp4 of T or more
    frames; ``cam_names`` the env's names of its cameras.  Returns the
    numbers of clip frames."""
    import cv2
    bounds = json.load(open(os.path.join(
        REPO, 'visual_foresight_torch', 'envs', 'robot_envs',
        'robot_configs.json')))[ROBOT_NAME]
    lo, hi = np.array(bounds[0]), np.array(bounds[1])
    goals = [c for c in clicks.calls if c[0] == 'desig_goal']
    finals = [c for c in clicks.calls if c[0] == 'final']
    clip_frames = []
    for k, i in enumerate(trajs):
        traj = os.path.join(result_dir, 'raw', 'traj_group0',
                            'traj{}'.format(i))
        for name in ('agent_data.pkl', 'obs_dict.pkl', 'policy_out.pkl',
                     'env_metadata.json'):
            if not os.path.isfile(os.path.join(traj, name)):
                raise AssertionError('robot traj {}: no {}'.format(i, name))
        with open(os.path.join(traj, 'obs_dict.pkl'), 'rb') as f:
            obs = pickle.load(f)
        with open(os.path.join(traj, 'policy_out.pkl'), 'rb') as f:
            actions = np.stack([p['actions'] for p in pickle.load(f)])
        with open(os.path.join(traj, 'agent_data.pkl'), 'rb') as f:
            stats = pickle.load(f)['stats']
        for cam in range(len(cam_names)):
            jpgs = os.listdir(os.path.join(traj, 'images{}'.format(cam)))
            if sorted(jpgs) != sorted('im_{}.jpg'.format(t)
                                      for t in range(T + 1)):
                raise AssertionError('robot traj {}: images{} holds {}'
                                     .format(i, cam, sorted(jpgs)))
        state = obs['state']
        inside = (state[:, :3] >= -1e-6).all() and \
            (state[:, :3] <= 1 + 1e-6).all() and \
            (state[:, 3:] >= lo[3:] - 1e-6).all() and \
            (state[:, 3:] <= hi[3:] + 1e-6).all()
        if actions.shape != (T, 4) or not np.isfinite(actions).all() or \
                state.shape != (T + 1, 5) or not inside:
            raise AssertionError('robot traj {}: actions {} or states out of '
                                 'bounds'.format(i, actions.shape))
        start, goal = (pix_to_width(p, width, raw_width)
                       for p in goals[k][1])
        final = pix_to_width(finals[k][1], width, raw_width)
        want = {'final_dist': np.sqrt(((final - goal) ** 2).sum()),
                'start_dist': np.sqrt(((start - goal) ** 2).sum())}
        want['improvement'] = want['start_dist'] - want['final_dist']
        for key, value in want.items():
            if not abs(float(stats[key]) - value) <= 1e-9 * max(1, value):
                raise AssertionError('robot traj {}: {} {} against {} by '
                                     'hand'.format(i, key, stats[key],
                                                   value))
        if save_video:
            for cam in cam_names:
                clip = os.path.join(result_dir, 'bench', 'traj{}'.format(i),
                                    'recording{}'.format(i),
                                    '{}_clip.mp4'.format(cam))
                with open(clip, 'rb') as f:
                    head = f.read(12)
                capture, n = cv2.VideoCapture(clip), 0
                while capture.read()[0]:
                    n += 1
                capture.release()
                if head[4:8] != b'ftyp' or n < T:
                    raise AssertionError('robot traj {}: {} is no mp4 of T '
                                         'frames ({!r}, {} frames)'.format(
                                             i, clip, head[4:8], n))
                clip_frames.append(n)
    return clip_frames


def robot_runs(model_dir, result, save_video, topics):
    """The twin's two trajectories through ``run_robot`` on the card, on
    the camera ``topics``, then a third under ``-r``, each held to
    ``check_robot_trajs``; the tail counts reset first.  Returns (the two runs' ``ReplanClock``s, the controller,
    the prompts answered, ``checkpoint.pkl``'s ``ntraj`` after each run,
    the clip frames, the first run's wall time)."""
    reset_tail_counts()
    T = robot_config(model_dir, result, 1)['agent']['T']
    clocks, ntraj, frames = [], [], []
    t0 = time.perf_counter()
    for end_index, trajs in ((1, (0, 1)), (2, (2,))):
        clocks.append(ReplanClock(torch.cuda.synchronize))
        clicks, prompts, ctrl = run_robot_twin(
            robot_config(model_dir, result, end_index, save_video=save_video,
                         env={'camera_topics': topics}),
            clocks[-1], resume=end_index == 2)
        if end_index == 1:
            wall = time.perf_counter() - t0
        check_restored('robot twin', ctrl)
        if ctrl.device.type != 'cuda' or ctrl.predictor.n_cam != 2:
            raise AssertionError('the robot twin planned on {} with {} '
                                 'views'.format(ctrl.device,
                                                ctrl.predictor.n_cam))
        frames += check_robot_trajs(result, trajs, clicks, T, save_video)
        with open(os.path.join(result, 'checkpoint.pkl'), 'rb') as f:
            ntraj.append(pickle.load(f)['ntraj'])
    return clocks, ctrl, prompts, ntraj, frames, wall


def drive_robot(card):
    """Phase 10: the sawyer pixel-cost twin through ``run_robot`` on the
    card (the comment above ``ROBOT_TWIN``).  Returns the launches by path
    and whether the file worker wrote the clips."""
    from visual_foresight_torch.agent.utils.file_saver import Mp4Unwritable
    from visual_foresight_torch.policy.cem_controllers import (
        PixelCostController)
    root = tempfile.mkdtemp(prefix='chip_smoke_robot_')
    try:
        model_dir = robot_model_dir(os.path.join(root, 'model'))
        result = os.path.join(root, 'result')
        policy = robot_config(model_dir, result, 1)['policy']
        channels, topics = robot_cameras()
        per_replan = len(channels) * replan_launches(policy)
        with CameraNodes(channels, *ROBOT_FRAME) as exe:
            print('camera nodes: {} built from visual_foresight_torch/native/'
                  'camera_stream.cpp, {} at {}x{} in --test-pattern mode'
                  .format(os.path.relpath(exe, REPO), channels,
                          ROBOT_FRAME[1], ROBOT_FRAME[0]))
            save_video = True
            try:
                runs = robot_runs(model_dir, result, save_video, topics)
            except Mp4Unwritable as e:
                print('robot clips (bench/traj<i>/recording<i>/<cam>_clip.mp4)'
                      ': wait, the file worker cannot write an mp4 on this '
                      'machine ({}); rerun with save_video False'.format(e))
                save_video = False
                shutil.rmtree(result)
                runs = robot_runs(model_dir, result, save_video, topics)
        clocks, ctrl, prompts, ntraj, clip_frames, wall = runs
        replans = [n for c in clocks for n in c.launches]
        print('robot twin: {} replans ({} + {} resumed), tail launches each '
              '{} (expected {}: 2 views x (1 + 3 x 15)); checkpoint ntraj {} '
              'then {} after -r; prompts answered in the resumed run {}'
              .format(len(replans), len(clocks[0].launches),
                      len(clocks[1].launches), replans, per_replan, *ntraj,
                      len(prompts.seen)))
        if [len(c.launches) for c in clocks] != [4, 2] or \
                any(n != per_replan for n in replans) or ntraj != [2, 3]:
            raise AssertionError('the robot twin ran {} replans, launches {}, '
                                 'ntraj {}'.format(
                                     [len(c.launches) for c in clocks],
                                     replans, ntraj))
        launches = read_tail_counts(
            'robot twin ({} replans x {})'.format(len(replans), per_replan),
            len(replans) * per_replan, ctrl.predictor._hp)
        ms = [x for c in clocks for x in c.ms]
        span = [x for c in clocks for x in c.span_ms]
        T = robot_config(model_dir, result, 1)['agent']['T']
        print('robot_sawyer_pixel_cost: 3 trajectories of T {} through '
              'run_robot (2, then 1 under -r), 600 samples x 15 steps x 3 '
              'iters, 2 views, predictor_propagation, bf16, ag_r5f_v2 and a '
              'seeded second view; replan host ms {} (p50 {:.3f}), CUDA-event '
              'span ms {} (p50 {:.3f}); clips {} frames; wall {:.1f} s for '
              'the first two with the controller\'s build [{}]'.format(
                  T, ' '.join('{:.3f}'.format(x) for x in ms),
                  float(np.percentile(ms, 50)),
                  ' '.join('{:.3f}'.format(x) for x in span),
                  float(np.percentile(span, 50)),
                  clip_frames if save_video else 'not written', wall, card))

        # the first replan again in f32, on the same context and draws:
        # with the kernel and with the plain tail
        ctrl32 = PixelCostController(
            dict(ctrl.agentparams),
            dict(policy, predictor_hparams={'dtype': 'float32'}))
        check_restored('robot twin (f32)', ctrl32)

        def replan():
            ctrl32.reset()
            ctrl32._generator.manual_seed(ROBOT_F32_SEED)
            out = ctrl32.act(**clocks[0].acts[0])
            return ([out['plan_stat']['scores_itr{}'.format(i)]
                     for i in range(ctrl32._hp.iterations)],
                    ctrl32._best_indices.copy())
        check_plain_tail_replan(
            replan, 'robot twin replan at t=1 (f32), kernel vs plain tail',
            ctrl32.elite_count, GOLDEN_SCORE_RTOL, per_element=True,
            same_elites=True)

        # the run's controller replans at t=1 again under the profiler,
        # without the verbose dump (no worker): the device's share of it
        ctrl.reset()
        profile_replan(lambda: ctrl.act(**clocks[0].acts[0]),
                       'robot twin replan at t=1 (bf16, no dump) [{}]'.format(
                           card))
        return {'robot_sawyer_pixel_cost': launches}, save_video
    finally:
        shutil.rmtree(root)


# phase 10's RoboNet drive: the franka twin as a user runs it (its MPPI
# plan of 10 actions under T 15 only in the host CEM loop: the fused planner
# refuses it as written) with its default weights (ag_r5f_v2), one camera;
# two trajectories of T 15, a replan each at t=5 (the next would fall at
# t=15), each 5 iterations x (1 + 10) = 55 launches at B=200
ROBONET_ROBOT_TWIN = os.path.join(CAMPAIGNS_DIR, 'robonet_franka.py')
ROBONET_ROBOT_TRAJS = 2
# and one robot collection twin without --benchmark: the sawyer grasp
# collection (GaussianPolicy, five cameras at 240x320, T 30), one
# trajectory, its raw frames read back
COLLECT_ROBOT_TWIN = os.path.join(CAMPAIGNS_DIR,
                                  'collect_robot_sawyer_grasp.py')


def twin_flips(twin):
    """The flip flags of the camera topics that the twin file names."""
    from visual_foresight_torch.sim.run import load_config
    env = load_config(twin)['agent']['env'][1]
    return tuple(t.flip for t in env['camera_topics'])


def drive_robonet_robot(card, save_video, cut=None):
    """Phase 10's RoboNet drive (the comment above ``ROBONET_ROBOT_TWIN``):
    ``run_robot`` with ``--benchmark`` on the franka twin, ``FakeArm`` and
    a test-pattern camera node, the twin's default weights; each replan's
    launches, the raw folders, the stats against the clicks and (with
    ``save_video``) the clip.  ``cut`` (agent, env and policy updates) runs
    it at a small size, on the CPU where its policy names that device.
    Returns the launches by path."""
    from visual_foresight_torch.policy.cem_controllers.samplers import (
        correlated_noise)
    root = tempfile.mkdtemp(prefix='chip_smoke_robonet_robot_')
    try:
        channels, topics = robot_cameras(twin_flips(ROBONET_ROBOT_TWIN))
        cut = cut or {}
        policy_cut = dict(cut.get('policy', {}), use_fused_planner=False)
        config = robot_config(
            None, root, ROBONET_ROBOT_TRAJS - 1, save_video,
            twin=ROBONET_ROBOT_TWIN, env=dict(cut.get('env', {}),
                                              camera_topics=topics),
            agent=cut.get('agent', {}), policy=policy_cut)
        print('robonet_franka: use_fused_planner False, as a user runs it '
              '(the fused planner refuses 10 actions under T 15); weights '
              '{}'.format(os.path.relpath(config['policy']['model_path'],
                                          REPO)))
        per_replan = replan_launches(config['policy'])
        T = config['agent']['T']
        device = torch.device(config['policy'].get('device', 'cuda')).type
        clock = ReplanClock(torch.cuda.synchronize if device == 'cuda'
                            else (lambda: None))
        with CameraNodes(channels, *ROBOT_FRAME):
            reset_tail_counts()
            t0 = time.perf_counter()
            clicks, prompts, ctrl = run_robot_twin(config, clock)
            wall = time.perf_counter() - t0
        if device == 'cuda':
            check_restored('robonet_franka', ctrl)
        mppi = correlated_noise.CorrelatedNoiseSampler
        if ctrl.device.type != device or ctrl._fused is not None or \
                ctrl._hp.sampler is not mppi or \
                ctrl.predictor.n_cam != len(channels):
            raise AssertionError('robonet_franka planned on {} with {} '
                                 '(fused {})'.format(ctrl.device,
                                                     ctrl._hp.sampler,
                                                     ctrl._fused))
        frames = check_robot_trajs(root, range(ROBONET_ROBOT_TRAJS), clicks,
                                   T, save_video,
                                   width=config['agent']['image_width'],
                                   cam_names=ROBOT_CAM_NAMES[:len(channels)])
        print('robonet_franka: {} replans, tail launches each {} (expected '
              '{}: {} iterations x (1 + {}), the host loop)'.format(
                  len(clock.launches), clock.launches, per_replan,
                  ctrl._hp.iterations, ctrl._hp.nactions))
        want = [per_replan if device == 'cuda' else 0] * ROBONET_ROBOT_TRAJS
        if clock.launches != want:
            raise AssertionError('robonet_franka ran {} replans of {} '
                                 'launches'.format(len(clock.launches),
                                                   clock.launches))
        launches = read_tail_counts(
            'robonet_franka ({} replans x {})'.format(ROBONET_ROBOT_TRAJS,
                                                     per_replan),
            ROBONET_ROBOT_TRAJS * per_replan, ctrl.predictor._hp) \
            if device == 'cuda' else {}
        span = clock.span_ms or [float('nan')]
        print('robonet_franka: {} trajectories of T {} through run_robot '
              '--benchmark, MPPI {} samples x {} iters in the host loop, 1 '
              'view, {}, {}; replan host ms {} (p50 {:.3f}), CUDA-'
              'event span ms {} (p50 {:.3f}); clips {}; wall {:.1f} s with '
              'the controller\'s build [{}]'.format(
                  ROBONET_ROBOT_TRAJS, T, ctrl._hp.num_samples,
                  ctrl._hp.iterations, ctrl.predictor._hp['dtype'],
                  os.path.basename(config['policy']['model_path']),
                  ' '.join('{:.3f}'.format(x) for x in clock.ms),
                  float(np.percentile(clock.ms, 50)),
                  ' '.join('{:.3f}'.format(x) for x in span),
                  float(np.percentile(span, 50)),
                  frames if save_video else 'not written', wall, card))
        return {'robot_robonet_franka': launches}
    finally:
        shutil.rmtree(root)


def drive_robot_collection(card, cut=None):
    """Phase 10's collection drive (the comment above
    ``COLLECT_ROBOT_TWIN``): ``run_robot`` without ``--benchmark`` on the
    sawyer grasp collection twin, ``FakeArm`` and one test-pattern node a
    camera; the raw folder read back: one JPEG a frame and camera of the
    agent's size, finite actions of the env's width, states inside the
    workspace, ``checkpoint.pkl``; no tail launch.  ``cut`` (agent and
    policy updates) runs it at a small size.  Returns the launches by
    path."""
    import cv2
    from visual_foresight_torch.policy.random.gaussian import GaussianPolicy
    root = tempfile.mkdtemp(prefix='chip_smoke_robot_collect_')
    try:
        channels, topics = robot_cameras(twin_flips(COLLECT_ROBOT_TWIN))
        cut = cut or {}
        config = robot_config(None, root, 0, False, twin=COLLECT_ROBOT_TWIN,
                              env={'camera_topics': topics},
                              agent=dict(cut.get('agent', {}),
                                         record=os.path.join(root, 'record')),
                              policy=cut.get('policy', {}))
        agent = config['agent']
        T, h, w = agent['T'], agent['image_height'], agent['image_width']
        with CameraNodes(channels, *ROBOT_FRAME):
            reset_tail_counts()
            np.random.seed(0)
            t0 = time.perf_counter()
            from visual_foresight_torch.sim import run_robot
            robot = run_robot.RobotEnvironment(config)
            try:
                robot.run()
            finally:
                close_robot(robot)
            wall = time.perf_counter() - t0
        if type(robot.policy) is not GaussianPolicy:
            raise AssertionError('the collection twin ran {}'.format(
                type(robot.policy).__name__))
        launches = read_no_tail('robot collection twin (1 trajectory)')
        traj = os.path.join(root, 'raw', 'traj_group0', 'traj0')
        with open(os.path.join(traj, 'policy_out.pkl'), 'rb') as f:
            actions = np.stack([p['actions'] for p in pickle.load(f)])
        with open(os.path.join(traj, 'obs_dict.pkl'), 'rb') as f:
            state = pickle.load(f)['state']
        shapes = set()
        for cam in range(len(channels)):
            for t in range(T + 1):
                im = cv2.imread(os.path.join(traj, 'images{}'.format(cam),
                                             'im_{}.jpg'.format(t)))
                shapes.add(None if im is None else im.shape)
        with open(os.path.join(root, 'checkpoint.pkl'), 'rb') as f:
            ntraj = pickle.load(f)['ntraj']
        if shapes != {(h, w, 3)} or actions.shape != (T, 4) or \
                not np.isfinite(actions).all() or \
                state.shape != (T + 1, 5) or \
                not (state[:, :3] >= -1e-6).all() or \
                not (state[:, :3] <= 1 + 1e-6).all() or ntraj != 1:
            raise AssertionError('the collection twin\'s raw trajectory: '
                                 'frames {}, actions {}, states {}, ntraj '
                                 '{}'.format(shapes, actions.shape,
                                             state.shape, ntraj))
        print('collect_robot_sawyer_grasp: one trajectory of T {} through '
              'run_robot (no --benchmark), GaussianPolicy, {} cameras: {} '
              'JPEGs of {}x{} read back, actions {} finite, states in the '
              'workspace; wall {:.1f} s; no tail launch [{}]'.format(
                  T, len(channels), len(channels) * (T + 1), h, w,
                  actions.shape, wall, card))
        return {'robot_collect_sawyer_grasp': launches}
    finally:
        shutil.rmtree(root)


# -- the campaign twins ------------------------------------------------------------
# task 0 of each vendored task set: the designated pixels, goal pixels and
# state that the port's env gives at reset from the task's reset state, at
# 64 pixels wide (tests/test_torch_twin_runs.py holds them against the
# env); its start frames are the task's images<c>/im_0.png at 48x64 (the
# autograsp sets store 96x128, resized here as the agent resizes frames)
TASK0 = {
    'xz_lifting_bench20': (TASK0_DESIG_PIX, TASK0_GOAL_PIX, TASK0_STATE),
    'ag_bench20': (
        np.array([[[34, 45], [34, 30], [22, 40]]]),
        np.array([[[43, 27], [34, 14], [31, 43]]]),
        np.array([0.09515970070549083, 0.13011127511913304,
                  0.12548008853667184, -0.0012849840558106025, -1.0])),
    'ag_bench20_hard': (
        np.array([[[24, 40], [34, 30], [36, 45]]]),
        np.array([[[17, 34], [34, 29], [37, 45]]]),
        np.array([0.188394784305158, 0.30966497929047, 0.12620400000000012,
                  2.2936243203780817, -1.0])),
    'xz2c_bench20': (
        np.array([[[24, 52]], [[14, 32]]]), np.array([[[24, 6]], [[40, 32]]]),
        np.array([0.2899686737353413, 0.06185940156443665, 1.0])),
}
# the planning twins: (twin, cost, VMPC_* variables of the run, the keys
# that equal their defaults: the JAX source raises on the first, and a user
# drops them).  The benchmarks plan on their task 0, experiments/sim's on
# seeded synthetic frames (no tasks of theirs are vendored)
TWIN_POINTS = [
    ('ag_bench20_hard', 'pixel',
     {'VMPC_STOCH_K': '2', 'VMPC_STOCH_PEN': '1.0'}, ()),
    ('ag_bench20_classifier', 'classifier', {}, ()),
    ('ag_bench20_ensemble', 'ensemble', {}, ()),
    ('xz_bench20_ensemble', 'ensemble', {}, ()),
    ('xz2c_bench20_registration', 'registration', {}, ()),
    ('xz_bench20_nce', 'nce', {}, ()),
    ('xz_bench20_inverse', 'inverse', {}, ()),
    ('ag_bench20_inverse', 'inverse', {}, ()),
    ('sim_autograsp_stochastic', 'pixel', {}, ('repeat', 'iterations')),
    ('sim_two_cam_registration', 'registration', {},
     ('register_gtruth', 'num_samples', 'repeat', 'iterations')),
    ('sim_2d_grasping_pixel_cost', 'pixel', {}, ('repeat',)),
    ('sim_2d_grasping_nce_experiments', 'nce', {}, ()),
    ('sim_ensemble_grasping', 'ensemble', {}, ('verbose',)),
]
RANDOM_TWINS = ('xz_bench20_random', 'xz2c_bench20_random',
                'ag_bench20_random')
TWIN_TIMED = 2                # host-timed replans after the warm-up act()s
# the twins whose replans are profiled beside the longest one's: a
# benchmark of each planning cost that the pixel paths do not show
PROFILED_TWINS = ('xz_bench20_ensemble', 'xz2c_bench20_registration',
                  'ag_bench20_classifier', 'xz_bench20_nce')


def twin_agent(config):
    """The agent params a runner gives a twin's policy: the config's agent
    with the widths of its env (the autograsp cartgripper's actions and
    states 4 and 5 wide, the xz gripper's 3 and 3) and its cameras."""
    env_cls, env_params = config['agent']['env']
    widths = (4, 5) if env_cls.__name__ == 'AutograspCartgripperEnv' \
        else (3, 3)
    agent = {k: v for k, v in config['agent'].items()
             if k not in ('type', 'env')}
    return dict(agent, adim=widths[0], sdim=widths[1],
                ncam=env_params.get('ncam', 1))


def build_twin(name, env, drop):
    """The twin's config, agent and policy.  Where ``drop`` names keys,
    the policy as written must raise ``ValueError`` on the first (its JAX
    source does), and is then built without them."""
    config = twin_config(name, **env)
    cls = config['policy']['type']
    policy = {k: v for k, v in config['policy'].items() if k != 'type'}
    agent = twin_agent(config)
    if drop:
        want = 'Policy param {} override is identical to its default!' \
            .format(drop[0])
        try:
            cls(agent, dict(policy))
        except ValueError as e:
            if str(e) != want:
                raise AssertionError('twin {} raised {!r}, not {!r}'.format(
                    name, str(e), want))
        else:
            raise AssertionError('twin {} built as written; its JAX source '
                                 'raises'.format(name))
        print('twin {}: as written, the policy raises ValueError({!r}), as '
              'its JAX source does; built with {} dropped'.format(
                  name, want, ', '.join(drop)))
        policy = {k: v for k, v in policy.items() if k not in drop}
    return config, cls, agent, policy


def twin_inputs(name, cost, config, agent, steps):
    """(frames, states, act() inputs) of a twin's replans: a benchmark's
    task 0 (its stored start frames, the env's pixels and state at reset,
    the goal image its goal source loads), or for experiments/sim seeded
    synthetic frames and states (``drive_controller``'s) and pixels."""
    from visual_foresight_torch.agent.goal_sources import (
        TrajectoryFolderGoalSource)
    ncam = agent['ncam']
    root = config['agent']['start_goal_confs']
    task_set = os.path.basename(root.rstrip('/'))
    rng = np.random.RandomState(4)
    if task_set in TASK0:
        import cv2
        desig, goal, state = TASK0[task_set]
        folder = os.path.join(root, 'traj_group0', 'traj0')
        frame = np.stack([cv2.resize(cv2.imread(os.path.join(
            folder, 'images{}'.format(c), 'im_0.png'))[:, :, ::-1], (W, H),
            interpolation=cv2.INTER_AREA) for c in range(ncam)])
        if frame.shape != (ncam, H, W, 3):
            raise AssertionError('{}: task 0 frames of shape {}'.format(
                name, frame.shape))
        frames = np.repeat(frame[None], steps, axis=0)
        states = np.repeat(state[None], steps, axis=0).astype(np.float32)
        hp = dict(config['agent'], data_save_dir=tempfile.gettempdir())
        goal_image = TrajectoryFolderGoalSource(hp, ncam).load(0).goal_image
        print('twin {}: task 0 of {} ({} camera(s), designated pixels {}, '
              'goal pixels {})'.format(name, task_set, ncam,
                                       desig.tolist(), goal.tolist()))
    else:
        frames = states = None
        desig = np.array([[[24, 32]], [[30, 20]]])[:ncam]
        goal = np.array([[[10, 50]], [[15, 40]]])[:ncam]
        goal_image = rng.rand(1, ncam, H, W, 3).astype(np.float32)
        print('twin {}: seeded synthetic frames ({} camera(s))'.format(
            name, ncam))
    act_kw = {'pixel': ('desig_pix', 'goal_pix'),
              'ensemble': ('desig_pix', 'goal_pix'),
              'registration': ('desig_pix', 'goal_pix', 'goal_image'),
              'classifier': ('goal_image',),
              'nce': ('goal_image',)}[cost]
    given = {'desig_pix': desig, 'goal_pix': goal, 'goal_image': goal_image}
    return frames, states, {k: given[k] for k in act_kw}


def drive_random_twins():
    """Each random baseline's policy built from its twin and one act():
    no network, no card work.  Returns the launches by twin (all 0)."""
    paths = {}
    for name in RANDOM_TWINS:
        config, cls, agent, policy = build_twin(name, {}, ())
        reset_tail_counts()
        np.random.seed(0)
        pol = cls(agent, policy)
        action = pol.act(t=0)['actions']
        paths['twin_' + name] = read_no_tail('twin {} ({}, one act())'.format(
            name, cls.__name__))
        if action.shape != (agent['adim'],) or not np.isfinite(action).all():
            raise AssertionError('twin {}: action {}'.format(name, action))
        print('twin {}: {} action {}'.format(name, cls.__name__, action))
    return paths


def drive_twins(card):
    """``main``'s phase 11: each planning twin of the benchmarks and of
    experiments/sim built from its own file (``campaigns/<twin>.py``, its
    default weights: the vendored exports and ``campaigns/stand_ins.py``)
    at its own operating point, on the card in bf16; every view and net
    restored; two ``act()`` steps with one replan (``drive_controller``),
    then ``TWIN_TIMED`` + 1 timed replans (``time_controller``), every
    replan's tail launches equal to the count from the twin's policy and
    tiled on blocked masks; the inverse twins through ``drive_inverse`` (no
    tail); one profiled replan of each of ``PROFILED_TWINS`` and of the
    twin with the longest span; then the random baselines.  Returns the
    launches by path."""
    from visual_foresight_torch.policy.cem_controllers.variants import (
        CEMControllerEnsembleVidPred)
    paths, slowest, summary = {}, (0.0, None, None), []
    for name, cost, env, drop in TWIN_POINTS:
        config, cls, agent, policy = build_twin(name, env, drop)
        if cost == 'inverse':
            paths['twin_' + name] = drive_inverse(
                card, policy, name='twin_' + name, agent=agent)
            continue
        ncam = agent['ncam']
        # the values as written (those dropped equal their defaults)
        written = {k: v for k, v in config['policy'].items() if k != 'type'}
        per_replan = cost_launches(cost, written, ncam)
        frames, states, act_kw = twin_inputs(name, cost, config, agent, 2)
        paths['twin_' + name], ctrl, states = drive_controller(
            'twin ' + name, agent, policy, 2, cls=cls, act_kw=act_kw,
            want=per_replan, frames=frames, states=states)
        hp = ctrl.predictor._hp
        if ctrl.device.type != 'cuda' or hp['dtype'] != 'bfloat16':
            raise AssertionError('twin {} planned on {} in {}'.format(
                name, ctrl.device, hp['dtype']))
        if isinstance(ctrl, CEMControllerEnsembleVidPred) and \
                len(ctrl.members_restored) != written.get('num_ensembles',
                                                          N_MEMBERS):
            raise AssertionError('twin {}: {} members'.format(
                name, len(ctrl.members_restored)))
        if cost == 'registration':
            print('twin {}: registration tradeoffs {} and registered pixels '
                  '{}'.format(name, np.round(ctrl.reg_tradeoff, 4).tolist(),
                              ctrl._desig_pix.tolist()))
        rows = written['num_samples'] * (written.get('stochastic_planning')
                                         or (1,))[0]
        point = '{} x {} x {}, B={}, {} camera(s), {}, bf16, {} tiled tail ' \
            'launches a replan'.format(
                written['num_samples'], written.get('T', DEFAULT_T),
                written.get('iterations', ITERS), rows, ncam, cost,
                per_replan)
        p50, span = time_controller('twin_' + name + '_replan', point, ctrl,
                                    states, card, timed=TWIN_TIMED,
                                    want=per_replan)
        summary.append((name, p50, span, per_replan))
        if name in PROFILED_TWINS:
            print('profile: one replan of twin {}'.format(name))
            profile_replan(lambda: ctrl.perform_CEM(states))
        if span > slowest[0]:
            slowest = (span, name, (ctrl, states))
        del ctrl
    span, name, (ctrl, states) = slowest
    print('the longest replan span: twin {}, {:.3f} ms'.format(name, span))
    if name not in PROFILED_TWINS:
        print('profile: one replan of twin {}'.format(name))
        profile_replan(lambda: ctrl.perform_CEM(states))
    del ctrl
    paths.update(drive_random_twins())
    print('phase 11: {} planning twins replanned on the card, {} random '
          'baselines; host p50 / span ms: {} [{}]'.format(
              len(summary), len(RANDOM_TWINS), '; '.join(
                  '{} {:.1f} / {:.1f} ({} launches)'.format(n, p, s, k)
                  for n, p, s, k in summary), card))
    return paths


# -- the robot and RoboNet experiment twins ------------------------------
# each planning twin of experiments/sawyer and experiments/robonet: (twin,
# cost, the keys equal to their defaults (the source raises ValueError on
# the first, a user drops them), the keys no controller declares (KeyError),
# the fused planner's refusal of the plan as written, or None (a user turns
# use_fused_planner off; the host CEM loop plans it)); the CPU tests read
# these facts from here
ROBOT_MPPI_TWINS = (
    'robonet_baxter_fine_tune', 'robonet_baxter_fine_tune_baxter_scratch',
    'robonet_baxter_fine_tune_sawyer_baxter_fine_tune', 'robonet_franka',
    'robonet_new_bin_inlay_all_robots', 'robonet_new_bin_inlay_sawyer_only',
    'robonet_robotiq_fine_tune_start_all',
    'robonet_robotiq_fine_tune_start_sawyer', 'robonet_robotiq_from_scratch',
    'robonet_robotiq_zero_shot', 'robonet_view_generalization_all_views',
    'robonet_view_generalization_single_view')
# the fused planner's refusals: MPPI plans at control cadence (nactions ==
# T), the Gaussian path needs nactions * repeat == T
MPPI_CADENCE, REPEAT_CADENCE = 'control cadence', 'T must equal nactions*repeat'
ROBOT_TWIN_POINTS = [
    ('robot_sawyer_human_cem', 'human', (), (), None),
    ('robot_sawyer_registration_experiments', 'registration', ('verbose',),
     (), None),
    ('robot_sawyer_towel_classifier', 'classifier', (), ('state_append',),
     None),
    ('robot_sawyer_mixed_objects_deformable', 'pixel', (), (), None),
    ('robot_sawyer_mixed_objects_hardobjects', 'pixel', ('verbose',), (),
     None),
] + [(name, 'pixel', (), (), MPPI_CADENCE) for name in ROBOT_MPPI_TWINS] + [
    ('robonet_pixel_cost', 'pixel', (), (), REPEAT_CADENCE),
    ('robonet_inverse_model_franka_inverse_conf', 'inverse', (), (), None),
    ('robonet_inverse_model_multibot_one_step', 'inverse', (), (), None),
    ('robonet_inverse_model_sawyer_one_step', 'inverse', (), (), None),
    ('robonet_inverse_model_sawyer_two_step', 'inverse', ('replan_every',),
     (), None),
]
# the weights a twin names, left out of its group's key
WEIGHT_KEYS = ('model_path', 'gdn_path', 'classifier_path',
               'model_params_path', 'model_restore_path')
HUMAN_SCORE_SEED = 17


def robot_twin_agent(config):
    """The agent params ``run_robot`` gives a robot twin's policy: the
    config's agent with its env class's action and state widths
    (``ACTION_DIM``, ``STATE_DIM``) and one camera a topic (the class's
    ``DEFAULT_CAMERA_TOPICS`` where the config names none)."""
    env_cls, env_params = config['agent']['env']
    if env_cls.ACTION_DIM is None or env_cls.STATE_DIM is None:
        raise ValueError('{} states no action or state width'.format(
            env_cls.__name__))
    topics = env_params.get('camera_topics') or env_cls.DEFAULT_CAMERA_TOPICS
    agent = {k: v for k, v in config['agent'].items()
             if k not in ('type', 'env')}
    return dict(agent, adim=env_cls.ACTION_DIM, sdim=env_cls.STATE_DIM,
                ncam=len(topics))


def expect_refusal(name, build, kind, *matches):
    """``build()`` must raise ``kind`` with one of ``matches`` in its
    message, as the twin's JAX source does as written.  Returns the
    message."""
    try:
        build()
    except kind as e:
        if not any(m in str(e) for m in matches):
            raise AssertionError('twin {} raised {}({!r}), not on {!r}'
                                 .format(name, kind.__name__, str(e),
                                         matches))
        return str(e)
    raise AssertionError('twin {} built as written; its JAX source raises {}'
                         .format(name, kind.__name__))


def build_robot_twin(name, drop, undeclared, refusal, cut=None):
    """A robot twin's config, class, agent and policy as a user runs it:
    where its source does not build as written (an override equal to its
    default, a key no controller declares, a plan the fused planner
    refuses with ``refusal``), the twin must raise the same, and is then
    built without those keys or with ``use_fused_planner`` off; each such
    step is printed.
    ``cut`` updates the policy (a run at a small size)."""
    config = twin_config(name)
    cls = config['policy']['type']
    agent = robot_twin_agent(config)
    policy = dict({k: v for k, v in config['policy'].items() if k != 'type'},
                  **(cut or {}))
    build = lambda: cls(agent, dict(policy))
    if drop:
        want = 'Policy param {} override is identical to its default!' \
            .format(drop[0])
        expect_refusal(name, build, ValueError, want)
        print('twin {}: as written, ValueError({!r}), as its JAX source '
              'raises; built with {} dropped'.format(name, want,
                                                     ', '.join(drop)))
        policy = {k: v for k, v in policy.items() if k not in drop}
    if undeclared:
        expect_refusal(name, build, KeyError, undeclared[0])
        print('twin {}: as written, KeyError on {}, which neither package\'s '
              'controller declares; built without it'.format(
                  name, ', '.join(undeclared)))
        policy = {k: v for k, v in policy.items() if k not in undeclared}
    if refusal:
        msg = expect_refusal(name, build, ValueError, refusal)
        print('twin {}: as written, the fused planner refuses the plan '
              '(ValueError({!r}); the JAX package asserts); built with '
              'use_fused_planner False: the host CEM loop'.format(name, msg))
        policy['use_fused_planner'] = False
    return config, cls, agent, policy


def robot_group_key(policy, agent):
    """Twins whose policy (but for its weights) and agent point (T, the
    image size, the cameras, the action and state widths) agree share one
    group."""
    values = sorted((k, getattr(v, '__name__', repr(v)))
                    for k, v in policy.items() if k not in WEIGHT_KEYS)
    point = tuple(agent[k] for k in ('T', 'image_height', 'image_width',
                                     'ncam', 'adim', 'sdim'))
    return repr((values, point))


def robot_twin_groups(cut=None, inverse_cut=None):
    """Every robot twin of ``ROBOT_TWIN_POINTS`` as a user builds it
    (``build_robot_twin``; ``cut`` and ``inverse_cut`` update the CEM and
    the inverse-model policies), in groups of equal points
    (``robot_group_key``) in the order of their first member: a list of
    lists of (twin, cost, class, agent, policy)."""
    groups = {}
    for name, cost, drop, undeclared, refusal in ROBOT_TWIN_POINTS:
        config, cls, agent, policy = build_robot_twin(
            name, drop, undeclared, refusal,
            inverse_cut if cost == 'inverse' else cut)
        groups.setdefault(robot_group_key(policy, agent), []).append(
            (name, cost, cls, agent, policy))
    return list(groups.values())


def robot_launches(cost, ncam, ctrl):
    """Tail launches of one replan of a robot twin's built controller
    ``ctrl`` over ``ncam`` cameras, from its hparams and whether it plans
    fused (its sampler and cost decide: the classifier plans the folding
    prior in the host loop): none for the inverse model; in the host CEM
    loop one teacher-forced forward a camera and iteration over the context
    action and the plan (MPPI's ``nactions``, else ``nactions`` x
    ``repeat``); fused, ``cost_launches``."""
    if cost == 'inverse':
        return 0
    hp = ctrl._hp.values()
    if ctrl._fused is None:
        mppi = hp['sampler'].__name__ == 'CorrelatedNoiseSampler'
        steps = hp['nactions'] * (1 if mppi else hp['repeat'])
        return ncam * hp['iterations'] * (N_CTX - 1 + steps)
    return cost_launches(cost, hp, ncam)


class HumanScores(object):
    """``input()`` for ``HumanCEMController``: no to the restore question,
    then seeded scores; ``given`` keeps them."""

    def __init__(self, seed):
        self._rng = np.random.RandomState(seed)
        self.given = []

    def __call__(self, prompt=''):
        if prompt.startswith('restore traj'):
            return 'n'
        self.given.append(float(self._rng.randint(0, 10000)) / 100)
        return str(self.given[-1])


def robot_twin_inputs(agent, ncam):
    """Seeded act() inputs of a robot twin at its own image size: goal
    images, and designated and goal pixels inside the frame."""
    h, w = agent['image_height'], agent['image_width']
    rng = np.random.RandomState(4)
    desig = (np.array([[[24, 32]], [[30, 20]]]) * [h / H, w / W]).astype(
        np.int64)[:ncam]
    goal = (np.array([[[10, 50]], [[15, 40]]]) * [h / H, w / W]).astype(
        np.int64)[:ncam]
    return {'desig_pix': desig, 'goal_pix': goal,
            'goal_image': rng.rand(1, ncam, h, w, 3).astype(np.float32)}


def drive_robot_twins(card):
    """``main``'s phase 12: each planning twin of experiments/sawyer and
    experiments/robonet built from its own file with its default weights
    (the vendored exports and ``campaigns/stand_ins.py``: the registration
    experiment's 96x128 predictor and GDN among them) at its own point, in
    bf16 on the card; every view and net restored.  Twins whose policy but
    for its weights and whose agent point agree form a group, which replans
    once for all: two or more act() steps up to its first replan
    (``drive_controller``), then ``TWIN_TIMED`` + 1 timed replans
    (``time_controller``), every replan's tail launches as
    ``robot_launches`` predicts and tiled on blocked masks (two packed
    planes at 96x128 for the registration twin); the human CEM twin on
    seeded scripted scores and a file worker; the inverse twins through
    ``drive_inverse`` (no tail).  Returns the launches by path."""
    import builtins
    from visual_foresight_torch.agent.utils.file_saver import (
        start_file_worker)
    groups = robot_twin_groups()
    paths, summary = {}, []
    for members in groups:
        name, cost, cls, agent, policy = members[0]
        label = 'robot twin group {}'.format(' + '.join(m[0]
                                                        for m in members))
        # every member built and restored; the first replans for all
        for other in members[1:]:
            ctrl = other[2](other[3], dict(other[4]))
            if cost == 'inverse':
                print('twin {} controller: restored={}'.format(
                    other[0], ctrl.predictor.restored))
                if not ctrl.predictor.restored:
                    raise AssertionError('twin {} did not restore'.format(
                        other[0]))
            else:
                check_restored('twin ' + other[0], ctrl)
            del ctrl
        if cost == 'inverse':
            paths['twin_' + name] = drive_inverse(
                card, policy, 'twin_' + name, agent=agent, profile=False)
            summary.append((name, len(members), None, None, 0))
            continue
        ncam = agent['ncam']
        steps = max(policy.get('start_planning', 0), N_CTX - 1) + 1
        act_kw = robot_twin_inputs(agent, ncam)
        act_kw = {k: act_kw[k] for k in {
            'pixel': ('desig_pix', 'goal_pix'), 'human': ('desig_pix',
                                                          'goal_pix'),
            'registration': ('desig_pix', 'goal_pix', 'goal_image'),
            'classifier': ('goal_image',)}[cost]}
        scores, worker, ask = None, None, builtins.input
        root = tempfile.mkdtemp(prefix='chip_smoke_robot_twins_')
        try:
            if cost == 'human':
                scores = HumanScores(HUMAN_SCORE_SEED)
                builtins.input = scores
                worker = start_file_worker()
                worker.put(('path', root))
                act_kw['verbose_worker'] = worker
            paths['twin_' + name], ctrl, states = drive_controller(
                'twin ' + name + ' (' + label + ')', agent, policy, steps,
                cls=cls, act_kw=act_kw,
                want=functools.partial(robot_launches, cost, ncam))
            fused = ctrl._fused is not None
            want = robot_launches(cost, ncam, ctrl)
            if ctrl.device.type != 'cuda' or \
                    ctrl.predictor._hp['dtype'] != 'bfloat16':
                raise AssertionError('twin {} planned on {} in {}'.format(
                    name, ctrl.device, ctrl.predictor._hp['dtype']))
            if ctrl.predictor.n_cam != ncam:
                raise AssertionError('twin {}: {} views for {} cameras'
                                     .format(name, ctrl.predictor.n_cam,
                                             ncam))
            hp = ctrl._hp
            rows = hp.num_samples
            if cost == 'registration':
                print('twin {}: registration at {}x{} (a window of {} pixels '
                      'each side), tradeoffs {} and registered pixels {}'
                      .format(name, agent['image_height'],
                              agent['image_width'],
                              5 if agent['image_height'] >= 96 else 2,
                              np.round(ctrl.reg_tradeoff, 4).tolist(),
                              ctrl._desig_pix.tolist()))
            if scores is not None:
                n = len(scores.given)
                if n != hp.iterations * rows or not np.array_equal(
                        ctrl.plan_stat['scores_itr{}'.format(
                            hp.iterations - 1)],
                        scores.given[-rows:]):
                    raise AssertionError('twin {}: scored other than the '
                                         'script'.format(name))
            point = '{} x {} x {}, {}x{}, B={}, {} camera(s), {}, {}, bf16, ' \
                '{} tiled tail launches a replan'.format(
                    rows, hp.T, hp.iterations, agent['image_height'],
                    agent['image_width'], rows, ncam, cost,
                    'fused' if fused else 'host loop', want)
            timed = 1 if cost == 'human' else TWIN_TIMED
            p50, span = time_controller(
                'twin_' + name + '_replan', point, ctrl, states, card,
                timed=timed, want=want)
            summary.append((name, len(members), p50, span, want))
            del ctrl
        finally:
            builtins.input = ask
            if worker is not None:
                worker.close()
            shutil.rmtree(root)
    print('phase 12: {} robot twins built and restored in {} groups, each '
          'group replanned once; host p50 / span ms: {} [{}]'.format(
              len(ROBOT_TWIN_POINTS), len(groups), '; '.join(
                  '{} ({} twins) {}'.format(
                      n, k, 'inverse net, no tail' if p is None else
                      '{:.1f} / {:.1f} ({} launches)'.format(p, s, w))
                  for n, k, p, s, w in summary), card))
    return paths


# -- the mesh: the flagship's replan and train steps over several devices --

# the flagship replan of parallel/flagship_check.py (48x64, M=200, bf16)
# over the card repeated 2 and 4 times (the counterpart of the JAX tests'
# virtual CPU mesh) and over make_mesh() (every card of the machine)
MESH_ITERS, MESH_REPEATS, MESH_TIMED = 2, (2, 4), 3
# JAX's flagship mesh tolerances (tests/test_flagship_mesh.py:65-68): the
# first iteration's scores, from the same draws; the best plans, where the
# elites agree
MESH_SCORE_RTOL = MESH_SCORE_ATOL = 1e-3
MESH_ACTION_ATOL = 1e-4
# 3 flagship train steps at batch 16 over the card twice against one, in
# f32 (TF32 off) at the port's train-step tolerances
# (tests/test_torch_train.py:22-27): losses rtol 1e-5, the gradients' global
# norm 1e-4, parameters 2e-3 of each leaf's largest change
MESH_TRAIN_STEPS, MESH_TRAIN_DEVICES = 3, 2
MESH_LOSS_RTOL, MESH_NORM_RTOL, MESH_PARAM_TOL = 1e-5, 1e-4, 2e-3
DRYRUN_DEVICES = 4


def mesh_launches(shares, iterations=MESH_ITERS, steps=T):
    """Tail launches of a replan over ``shares`` devices: the context step
    once, at batch 1 on the lead device, then every model step once a
    share."""
    return 1 + iterations * steps * shares


def event_span(fn):
    """(``fn()``, its CUDA-event span in ms)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def flagship_runner():
    """``replan(mesh, dtype)``: one flagship replan
    (``parallel/flagship_check.py``, M=200, ``MESH_ITERS`` iterations, seed
    0) over ``mesh`` (None: unsharded) on the card, on the flagship restored
    once a dtype; raises where it does not restore."""
    from visual_foresight_torch.parallel.flagship_check import (
        flagship_replan, load_flagship_predictor)
    predictors = {}

    def replan(mesh, dtype='bfloat16'):
        if dtype not in predictors:
            predictor = load_flagship_predictor(num_samples=M, device='cuda',
                                                dtype=dtype)
            if not predictor.restored:
                raise AssertionError('the flagship did not restore')
            predictors[dtype] = predictor
        return flagship_replan(mesh=mesh, num_samples=M,
                               iterations=MESH_ITERS,
                               predictor=predictors[dtype], device='cuda')[0]
    replan.predictors = predictors
    return replan


def elite_orders(result, k=10):
    """Each iteration's ``k`` elite indices, best first."""
    return [torch.sort(s.float(), stable=True).indices[:k].tolist()
            for s in result['scores_per_itr']]


def sharded_errors(got, plain):
    """(whether every iteration kept the same elites in the same order,
    whether the first iteration's scores agree within JAX's flagship
    tolerance, their largest difference, the best plans' largest
    difference) of two flagship replans."""
    s_got = got['scores_per_itr'][0].float()
    s_plain = plain['scores_per_itr'][0].float()
    diff = (s_got - s_plain).abs()
    scores_ok = bool((diff <= MESH_SCORE_ATOL +
                      MESH_SCORE_RTOL * s_plain.abs()).all())
    act = float((got['best_actions'] - plain['best_actions']).abs().max())
    return (elite_orders(got) == elite_orders(plain), scores_ok,
            float(diff.max()), act)


def check_sharded_replan(label, got, plain, replan, mesh):
    """Hold ``got`` (the bf16 flagship replan over ``mesh``) against
    ``plain`` (unsharded): the first iteration's scores, drawn alike, within
    JAX's flagship tolerance, and with the same elites in the same order,
    the best plans within ``MESH_ACTION_ATOL``.  cuDNN may choose other
    algorithms at B/n, whose bf16 roundings differ through the recurrent
    steps; where the bf16 elites or scores differ, both run again in f32
    (TF32 off) through ``replan(mesh, dtype)`` and are held to the same
    bounds.  Prints which case applied; returns (case, largest
    first-iteration score difference, largest best-plan difference) of the
    case held."""
    same, scores_ok, score_err, act_err = sharded_errors(got, plain)
    print('{}: bf16: elites equal {}, first iteration max score diff {:.3e} '
          '(within rtol {} + atol {}: {}), best plans max diff {:.3e}'.format(
              label, same, score_err, MESH_SCORE_RTOL, MESH_SCORE_ATOL,
              scores_ok, act_err))
    case = 'bf16'
    if not (same and scores_ok):
        case = 'f32 (the bf16 {} differ)'.format(
            'elites' if not same else 'scores')
        same, scores_ok, score_err, act_err = sharded_errors(
            replan(mesh, 'float32'), replan(None, 'float32'))
        print('{}: f32: elites equal {}, first iteration max score diff '
              '{:.3e} (within: {}), best plans max diff {:.3e}'.format(
                  label, same, score_err, scores_ok, act_err))
    print('{}: held in {}'.format(label, case))
    if not scores_ok:
        raise AssertionError('{}: the sharded scores disagree'.format(label))
    if not act_err <= MESH_ACTION_ATOL:
        raise AssertionError('{}: the best plans disagree'.format(label))
    return case, score_err, act_err


def drive_mesh_replans(card):
    """The flagship replan unsharded, then over the card repeated 2 and 4
    times and over ``make_mesh()``: each run once untimed (cuDNN's first
    choices at B/n), then ``MESH_TIMED`` times between CUDA events with its
    launches counted (``mesh_launches`` a replan: tiled, on blocked masks),
    and held against unsharded (``check_sharded_replan``).  Returns the
    launches by path."""
    from visual_foresight_torch.parallel.mesh import Mesh, make_mesh
    replan = flagship_runner()
    lead = torch.device('cuda', 0)
    where = '(flagship, 48x64, M=200, {} iterations, bf16, {} replans) [{}]' \
        .format(MESH_ITERS, MESH_TIMED, card)
    meshes = [('unsharded', None)] + [
        ('x{}'.format(n), Mesh((lead,) * n)) for n in MESH_REPEATS] + [
        ('make_mesh', make_mesh())]
    paths, plain = {}, None
    for name, mesh in meshes:
        replan(mesh)
        reset_tail_counts()
        runs = [event_span(lambda: replan(mesh)) for _ in range(MESH_TIMED)]
        label = 'flagship replan {}'.format(
            'unsharded' if mesh is None else 'over {} ({})'.format(
                name, ', '.join(str(d) for d in mesh.devices)))
        paths['mesh_flagship_' + name] = read_tail_counts(
            label, MESH_TIMED * mesh_launches(1 if mesh is None
                                              else mesh.size),
            replan.predictors['bfloat16']._hp)
        spans = [span for _, span in runs]
        print('mesh_flagship_{}_span_ms={:.3f} median, {} {}'.format(
            name, float(np.median(spans)),
            ' '.join('{:.3f}'.format(x) for x in spans), where))
        if mesh is None:
            plain = runs[0][0]
        else:
            check_sharded_replan(label, runs[0][0], plain, replan, mesh)
    return paths


def drive_mesh_training(card):
    """``train()`` at the flagship's width, f32, batch 16 from synthetic
    batches: ``MESH_TRAIN_STEPS`` steps with ``--n_devices``
    ``MESH_TRAIN_DEVICES`` over the card repeated (``--device cuda:0``)
    against the same steps on one: 14 forward and 14 backward tail launches
    a step a share, no plain version, losses, gradient norms and parameters
    at the port's train-step tolerances.  Returns the launches by path."""
    from visual_foresight_torch.models.convert import flatten_flax
    from visual_foresight_torch.training import train_predictor as ttrain
    config = os.path.join(WEIGHTS, 'model_config.json')
    runs, paths = {}, {}
    for n in (1, MESH_TRAIN_DEVICES):
        args = train_args(config, batch_size=TRAIN_BATCH,
                          steps=MESH_TRAIN_STEPS, log_every=1, n_devices=n,
                          device='cuda:0')
        args.bf16 = False
        model_steps = args.sequence_length - 1
        reset_train_counts()
        with PlainCalls() as plain:
            (history, trainer), span = event_span(lambda: ttrain.train(args))
        path = 'mesh_train_{}'.format(n)
        paths[path] = read_train_counts(
            'flagship training, f32, over {}'.format(', '.join(
                str(d) for d in trainer.mesh.devices)),
            MESH_TRAIN_STEPS, model_steps * n)
        if plain.calls:
            raise AssertionError('{} called a plain version'.format(path))
        print('{}_span_ms={:.3f} ({} steps at batch {}, f32, the build of '
              'the model included) [{}]'.format(path, span, MESH_TRAIN_STEPS,
                                                TRAIN_BATCH, card))
        runs[n] = (history, flatten_flax(ttrain.params_to_flax(
            trainer.model.state_dict())))
        time_train_steps(
            trainer, ttrain.synthetic_batches(args, seed=1),
            MESH_TRAIN_STEPS, path + '_step', '(xz_flagship full width, f32, '
            'batch {} over {} share(s), 14 model steps) [{}]'.format(
                TRAIN_BATCH, n, card))
        del trainer
    init = ttrain.build_model(args)
    ttrain.init_params(init, seed=0)
    init = flatten_flax(ttrain.params_to_flax(init.state_dict()))
    (h1, p1), (hn, pn) = runs[1], runs[MESH_TRAIN_DEVICES]
    loss_err = max(abs(a['loss'] - b['loss']) / abs(a['loss'])
                   for a, b in zip(h1, hn))
    norm_err = max(abs(a['grad_norm'] - b['grad_norm']) / abs(a['grad_norm'])
                   for a, b in zip(h1, hn))
    param_err = max(float(np.abs(pn[k] - p1[k]).max()) / max(
        float(np.abs(p1[k] - init[k]).max()), 1e-30) for k in p1)
    print('mesh train steps over {} against one: losses max rel diff {:.3e} '
          '(rtol {}), gradient norms {:.3e} (rtol {}), parameters max diff '
          '{:.3e} of their leaf\'s largest change (tol {})'.format(
              MESH_TRAIN_DEVICES, loss_err, MESH_LOSS_RTOL, norm_err,
              MESH_NORM_RTOL, param_err, MESH_PARAM_TOL))
    if len(hn) != MESH_TRAIN_STEPS or not loss_err <= MESH_LOSS_RTOL or \
            not norm_err <= MESH_NORM_RTOL or not param_err <= MESH_PARAM_TOL:
        raise AssertionError('the sharded train steps disagree')
    return paths


def drive_dryrun(card):
    """``tools/dryrun_multichip.py`` at n = ``DRYRUN_DEVICES`` on the card:
    a sharded train step of the small classic model (5 model steps a share,
    forward and backward, full-resolution masks), its sharded replan (1 +
    2 x 6 steps a share) and the flagship's (1 + 15 a share, blocked), all
    tiled, no plain version.  Returns the launches."""
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite, fused_warp_composite_backward,
        fused_warp_composite_dna, fused_warp_composite_eff)
    from visual_foresight_torch.tools import dryrun_multichip
    n = DRYRUN_DEVICES
    train, small = 5 * n, mesh_launches(n, 2, 6)
    flag = mesh_launches(n, 1)
    reset_train_counts()
    with PlainCalls() as plain:
        _, span = event_span(lambda: dryrun_multichip.run(n, 'cuda'))
    fwd, bwd = fused_warp_composite.launches, \
        fused_warp_composite_backward.launches
    blocked = fused_warp_composite.blocked_launches
    print('dryrun_multichip({}): {} forward tail launches (expected {} = {} '
          'train + {} small replan + {} flagship), {} on blocked masks '
          '(expected {}); {} backward (expected {}); plain calls {}; span '
          '{:.3f} ms (the models\' builds and the flagship\'s restore '
          'included) [{}]'.format(
              n, fwd, train + small + flag, train, small, flag, blocked, flag,
              bwd, train, plain.calls, span, card))
    if fwd != train + small + flag or bwd != train or blocked != flag or \
            plain.calls or \
            fused_warp_composite_eff.launches or \
            fused_warp_composite_dna.launches:
        raise AssertionError('dryrun_multichip did not run the kernels as '
                             'expected')
    return {'dryrun_multichip_{}'.format(n): {
        'cdna_tail': fwd, 'cdna_tail_bwd': bwd, 'cdna_tail_eff': 0,
        'cdna_tail_dna': 0}}


def drive_mesh(card):
    """Phase 13: the mesh replans, the sharded train steps and the dry
    run; returns the launches by path."""
    t0 = time.time()
    paths = drive_mesh_replans(card)
    paths.update(drive_mesh_training(card))
    paths.update(drive_dryrun(card))
    print('phase 13 (mesh) took {:.1f} s'.format(time.time() - t0))
    return paths


# -- the checkpoints: the JAX package's orbax step directories on the card --
CKPT_DIR = os.path.join(REPO, 'build', 'chip_smoke_checkpoints')
CKPT_MODELS = ('xz_flagship', 'ag_r5f_v2')
CKPT_TRAIN_STEPS = 3


def time_decoder(step_dir, card):
    """The decoder's build (or load) time and its rate on the zstd chunks
    of the orbax step directory ``step_dir``."""
    from visual_foresight_torch.ops import _build
    from visual_foresight_torch.utils import ocdbt, zstd
    so = _build.host_library_path(zstd.SOURCE)
    cached = so.is_file()
    t0 = time.perf_counter()
    zstd.library()
    build_s = time.perf_counter() - t0
    reader = ocdbt.OcdbtReader(step_dir)
    frames = [reader.read(k) for k in reader.keys()
              if not k.endswith('.zarray')]
    zstd.decompress(frames[0])                               # warm
    t0 = time.perf_counter()
    out = sum(len(zstd.decompress(f)) for f in frames)
    decode_s = time.perf_counter() - t0
    print('checkpoints: zstd decoder {} in {:.3f} s ({}); {} chunks, {} '
          'bytes compressed to {} decoded in {:.4f} s: {:.1f} MB/s decoded '
          '(host) [{}]'.format('loaded' if cached else 'built with g++',
                              build_s, so.name, len(frames),
                              sum(len(f) for f in frames), out, decode_s,
                              out / decode_s / 1e6, card))
    return build_s, out / decode_s / 1e6


def restore_orbax(name, card):
    """``TorchPredictor`` on the card restored from
    ``benchmarks/models/<name>``'s orbax step directory (timed around
    ``load_view``, and the whole restore), its state held bit for bit
    against the numpy export's restore.  Returns (orbax predictor, numpy
    predictor, load seconds)."""
    import contextlib
    import io
    from visual_foresight_torch.prediction import predictor as t_predictor
    model_dir = os.path.join(REPO, 'benchmarks', 'models', name)
    load_view, loads = t_predictor.load_view, []

    def timed_load_view(*args):
        t0 = time.perf_counter()
        out = load_view(*args)
        loads.append(time.perf_counter() - t0)
        return out

    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log), mock.patch.object(
            t_predictor, 'load_view', timed_load_view):
        orbax = restored_predictor('bfloat16', weights=model_dir)
    whole = time.perf_counter() - t0
    sys.stdout.write(log.getvalue())
    if 'restored predictor params from {}'.format(os.path.join(
            model_dir, 'view0', 'step_')) not in log.getvalue() or \
            len(loads) != 1:
        raise AssertionError('{} was not restored from its orbax step '
                             'directory'.format(name))
    numpy_pred = restored_predictor(
        'bfloat16', weights=os.path.join(os.path.dirname(WEIGHTS), name))
    ref = numpy_pred.models[0].state_dict()
    got = orbax.models[0].state_dict()
    if got.keys() != ref.keys() or not all(torch.equal(got[k], ref[k])
                                           for k in ref):
        raise AssertionError('the orbax restore of {} differs from the '
                             'numpy export'.format(name))
    print('checkpoints: {} restored on the card from its orbax step '
          'directory in {:.3f} s (load_view: OCDBT, zarr, zstd and the '
          'load; the predictor built and restored in {:.3f} s), equal bit '
          'for bit to the numpy export [{}]'.format(name, loads[0], whole,
                                                    card))
    return orbax, numpy_pred, loads[0]


def replan_orbax_and_numpy(name, orbax, numpy_pred):
    """A 200 x 15 x 3 bf16 replan from the orbax restore and from the numpy
    one on the same context and draws: scores, elites and plans equal, 46
    tiled launches each.  Returns the launches by path."""
    rng = np.random.RandomState(14)
    images = rng.rand(1, N_CTX, H, W, 3).astype(np.float32)
    states = (rng.randn(N_CTX, orbax._hp['sdim']) * 0.05).astype(np.float32)
    outs, paths = {}, {}
    for source, pred in (('orbax', orbax), ('numpy', numpy_pred)):
        replan = replan_200(pred, name)
        reset_tail_counts()
        outs[source] = replan(
            images, states,
            generator=torch.Generator(device='cuda').manual_seed(5))
        torch.cuda.synchronize()
        paths['checkpoint_{}_{}_replan_200'.format(source, name)] = \
            read_tail_counts('200-sample replan of {} on the {} restore'
                             .format(name, source), LAUNCHES_PER_REPLAN,
                             pred._hp)
    for key in ('best_actions', 'best_scores', 'scores_per_itr'):
        if not torch.equal(outs['orbax'][key], outs['numpy'][key]):
            raise AssertionError('{}: the orbax-served replan\'s {} differ '
                                 'from the numpy one\'s'.format(name, key))
    order = lambda out: torch.argsort(out['scores_per_itr'], dim=1,
                                      stable=True)[:, :10]
    if not torch.equal(order(outs['orbax']), order(outs['numpy'])):
        raise AssertionError('{}: the elites differ'.format(name))
    if not bool(torch.isfinite(outs['orbax']['scores_per_itr']).all()):
        raise AssertionError('{}: scores not finite'.format(name))
    print('checkpoints: {} 200 x 15 x 3 bf16 replan from the orbax restore '
          'equals the numpy one\'s (scores, elites, plans) bit for bit, {} '
          'launches each; best score {:.4f}'.format(
              name, LAUNCHES_PER_REPLAN,
              float(outs['orbax']['best_scores'][0])))
    return paths


def train_and_resume(card):
    """``CKPT_TRAIN_STEPS`` f32 flagship train steps at batch 16 with
    ``--model_dir`` under ``build/``: the written ``view0/step_3`` and
    ``opt/step_3`` read back with the port's reader equal the trained
    parameters and optax's count and moments; then one step resumed from
    them.  Returns the launches of the resumed step."""
    from visual_foresight_torch.models.convert import params_from_flax
    from visual_foresight_torch.prediction import checkpoints
    from visual_foresight_torch.training.train_predictor import (
        _state_from_optax, build_argparser, train)
    root = os.path.join(CKPT_DIR, 'train')
    shutil.rmtree(root, ignore_errors=True)
    argv = [a for a in config_argv(os.path.join(WEIGHTS, 'model_config.json'),
                                   batch_size=TRAIN_BATCH, log_every=1,
                                   model_dir=root) if a != '--bf16']
    parse = lambda steps, *more: build_argparser().parse_args(
        argv + ['--steps', str(steps), *more])
    t0 = time.perf_counter()
    history, trainer = train(parse(CKPT_TRAIN_STEPS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step = 'step_{}'.format(CKPT_TRAIN_STEPS)
    t0 = time.perf_counter()
    tree = checkpoints.restore_params(os.path.join(root, 'view0'))
    opt = checkpoints.restore_params(os.path.join(root, 'opt'))
    read_s = time.perf_counter() - t0
    state = params_from_flax(tree)
    own = trainer.model.state_dict()
    if state.keys() != own.keys() or not all(
            np.array_equal(state[k], own[k].cpu().numpy()) for k in own):
        raise AssertionError('view0/{} differs from the trained '
                             'parameters'.format(step))
    saved = _state_from_optax(opt, {'model': trainer.model,
                                    'posterior': None})
    live = trainer.tx.state()
    if not saved['count'] == live['count'] == CKPT_TRAIN_STEPS or not all(
            np.array_equal(saved[m][n], live[m][n].cpu().numpy())
            for m in ('mu', 'nu') for n in live[m]):
        raise AssertionError('opt/{} differs from the trained optimizer '
                             'state'.format(step))
    reset_train_counts()
    resumed, _ = train(parse(CKPT_TRAIN_STEPS + 1, '--resume'))
    torch.cuda.synchronize()
    launches = read_train_counts('train_checkpoint_resume', 1, T - 1)
    if [h['step'] for h in resumed] != [CKPT_TRAIN_STEPS] or not all(
            np.isfinite([h[k] for k in h]).all() for h in resumed):
        raise AssertionError('the resumed run did not take step {} with '
                             'finite metrics'.format(CKPT_TRAIN_STEPS))
    print('checkpoints: {} f32 flagship train steps at batch {} in {:.1f} s '
          'wrote view0/{} and opt/{}; read back with the port\'s reader in '
          '{:.3f} s, equal to the trained parameters and optax state (count '
          '{}); one step resumed from them, loss {:.5f} [{}]'.format(
              CKPT_TRAIN_STEPS, TRAIN_BATCH, wall, step, step, read_s,
              saved['count'], resumed[0]['loss'], card))
    shutil.rmtree(root)
    return launches


def drive_checkpoints(card):
    """Phase 14: the decoder built and timed, both vendored orbax
    checkpoints restored and replanned on the card against their numpy
    twins, and a short flagship run saved, read back and resumed.  Returns
    the launches by path."""
    from visual_foresight_torch.prediction import checkpoints
    t0 = time.perf_counter()
    build_s, rate = time_decoder(checkpoints.latest_checkpoint(os.path.join(
        REPO, 'benchmarks', 'models', 'xz_flagship', 'view0')), card)
    paths, loads = {}, {}
    for name in CKPT_MODELS:
        orbax, numpy_pred, loads[name] = restore_orbax(name, card)
        paths.update(replan_orbax_and_numpy(name, orbax, numpy_pred))
        del orbax, numpy_pred
    paths['train_checkpoint_resume'] = train_and_resume(card)
    print('checkpoints: phase 14 in {:.1f} s: decoder {:.3f} s, {:.1f} MB/s; '
          'restores {} [{}]'.format(
              time.perf_counter() - t0, build_s, rate,
              ', '.join('{} {:.3f} s'.format(k, v) for k, v in loads.items()),
              card))
    return paths


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    from visual_foresight_torch.ops import (_build, cdna_tail, conv_lstm_ln,
                                           probe)
    from visual_foresight_torch.ops.probe import PROBE_SHAPE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_kind = torch.cuda.get_device_name(0)
    card = card_line()
    print('python {} torch {} cuda {}'.format(
        sys.version.split()[0], torch.__version__, torch.version.cuda))
    print('device: {} (count {})'.format(device_kind,
                                         torch.cuda.device_count()))
    print(card)

    # -- builds: one nvcc per kernel, all started together -------------------
    t0 = time.time()
    builds = _build.build_concurrently([probe.SOURCE, cdna_tail.SOURCE,
                                        cdna_tail.BWD_SOURCE,
                                        conv_lstm_ln.SOURCE])

    # -- 1. toolchain probe ----------------------------------------------------
    print_report(probe.SOURCE, builds[probe.SOURCE].result()[1],
                 time.time() - t0)
    gen = torch.Generator(device='cuda').manual_seed(0)
    probe_launches, probe_err = check_probe(gen)

    # -- 2. tail kernel against its plain version ------------------------------
    print_report(cdna_tail.SOURCE, builds[cdna_tail.SOURCE].result()[1],
                 time.time() - t0)
    err_bf16, reg_err = check_tail_cases(gen)
    eff_err = check_eff_cases(gen)
    print_report(cdna_tail.BWD_SOURCE,
                 builds[cdna_tail.BWD_SOURCE].result()[1], time.time() - t0)
    bwd_abs, bwd_rel = check_bwd_cases(gen)
    print_report(conv_lstm_ln.SOURCE,
                 builds[conv_lstm_ln.SOURCE].result()[1], time.time() - t0)
    lstm_err = check_lstm_cases(gen)
    norm_err = check_norm_cases(gen)

    # -- 3. golden: the JAX package's f32 replans, replayed -----------------------
    # launches by kernel, for each driven path
    paths = {}
    paths['golden'], _, _ = check_golden('xz_flagship')
    paths['golden_ag_r5f_v2'], _, _ = check_golden('ag_r5f_v2')
    paths['golden_mppi_ag_r5f_v2'], _, _ = check_golden_mppi()
    # the flagship's golden under fuse_decode; the seeded
    # classic exports' goldens, the folded tail on full-resolution masks
    # and DNA through the eff entry
    paths['golden_xz_flagship_fuse_decode'], _, _ = check_golden(
        'xz_flagship', fuse_decode=True)
    paths['golden_classic_cdna'], _, _ = check_golden('classic_cdna')
    paths['golden_classic_dna'], _, _ = check_golden('classic_dna')

    # -- 4. the 200-sample replan on the restored weights ----------------------
    paths['replan_200'], latencies, replan, contexts, plan_gen = \
        drive_replan_200()
    check_plain_tail_replan_200(replan, contexts, plan_gen)

    # -- 5. the controllers at the campaigns' operating points -------------------
    paths['controller'], ctrl, ctrl_states = drive_controller(
        'xz_bench20', AG_PARAMS, CTRL_POLICY, CTRL_STEPS)
    paths['controller_ag_bench20'], ag_ctrl, ag_states = drive_controller(
        'ag_bench20', AG_AGENT, AG_POLICY, CTRL_STEPS)
    paths['controller_ag_bench20_hard'], _, _ = drive_controller(
        'ag_bench20_hard (stochastic_planning 2, penalty 1.0)', AG_AGENT,
        AG_HARD_POLICY, 2)
    paths['controller_xz_bench20_chunk200'], chunk_ctrl, chunk_states = \
        drive_controller('xz_bench20 at 800 samples in chunks of 200',
                         AG_PARAMS, CHUNK_POLICY, 2)
    # the same 800 samples as one batch, to time the chunked replan against
    paths['controller_xz_bench20_800'], whole_ctrl, whole_states = \
        drive_controller('xz_bench20 at 800 samples in one batch', AG_PARAMS,
                         dict(CTRL_POLICY,
                              num_samples=CHUNK_POLICY['num_samples']), 2)

    # -- 5a-d. the other samplers: the RoboNet path and the folding prior ------
    for cut in POLICY_CUTS:
        print('policy read from its twin, cut: ' + cut)
    paths['controller_robonet_mppi'], mppi_ctrl, mppi_states = \
        drive_controller('RoboNet MPPI fused (T 10, anchored)', AG_AGENT,
                         with_sampler(ROBONET_FUSED_POLICY, 'mppi'),
                         ROBONET_STEPS)
    if not mppi_ctrl._fused.is_mppi:
        raise AssertionError('the RoboNet MPPI policy did not plan fused')
    paths['controller_robonet_mppi_host_loop'], host_ctrl, host_states = \
        drive_controller('RoboNet MPPI host loop (T 15)', AG_AGENT,
                         with_sampler(ROBONET_HOST_POLICY, 'mppi'), 6)
    if host_ctrl._fused is not None:
        raise AssertionError('the RoboNet policy as written planned fused')
    paths['controller_folding'], fold_ctrl, fold_states = drive_controller(
        'folding', AG_AGENT, with_sampler(FOLDING_POLICY, 'folding'), 2)
    paths['controller_autograsp'], ag_grip_ctrl, _ = drive_controller(
        'AutograspSampler at ag_bench20', AG_AGENT,
        with_sampler(AUTOGRASP_POLICY, 'autograsp'), 2)
    check_grip('AutograspSampler', ag_grip_ctrl, AUTOGRASP_POLICY)
    del ag_grip_ctrl
    paths['controller_ag_epsilon'], ag_eps_ctrl, _ = drive_controller(
        'AutograspEpsilon at ag_bench20', AG_AGENT,
        with_sampler(AG_EPSILON_POLICY, 'ag_epsilon'), 2)
    check_grip('AutograspEpsilon', ag_eps_ctrl, AG_EPSILON_POLICY,
               ag_epsilon=True)
    del ag_eps_ctrl

    # -- 5e-g. every architecture the JAX package builds --------------------
    paths['controller_classic_cdna'], classic_ctrl, classic_states = \
        drive_controller('classic CDNA (the JAX default) at xz_bench20',
                         AG_PARAMS, CLASSIC_POLICY, 2)
    paths['controller_classic_dna'], dna_ctrl, dna_states = \
        drive_controller('classic DNA at xz_bench20', AG_PARAMS, DNA_POLICY,
                         2)
    paths['controller_xz_bench20_fuse_decode'], fuse_ctrl, fuse_states = \
        drive_controller('xz_bench20 with fuse_decode', AG_PARAMS,
                         FUSE_POLICY, 2)
    built = [(c.predictor._hp['std_factor'], c.predictor._hp['dna'],
              c.predictor.models[0].step.fuse_decode)
             for c in (classic_ctrl, dna_ctrl, fuse_ctrl)]
    print('built (std_factor, dna, fuse_decode): classic {}, DNA {}, '
          'fuse_decode {}'.format(*built))
    if built != [(0, False, False), (0, True, False), (4, False, True)]:
        raise AssertionError('a predictor has the wrong architecture')

    # -- 5h. training: the JAX train golden in f32, the flagship at full
    # width, the stochastic configuration, then the trained checkpoint served
    paths['train_golden_f32'] = replay_train_golden()
    paths['train_xz_flagship'], trainer, synthetic_device = \
        drive_training(card)
    del trainer
    paths['train_stochastic_ag_r5f_v2'] = drive_stochastic_training()
    paths['serve_trained_checkpoint'] = serve_trained()
    shutil.rmtree(TRAIN_DIR)

    # -- 5i. training from collected records: shards written by the port,
    # the flagship trained from them (the Python reader, then the native
    # engine where it builds), the scoring nets trained from them (served
    # in 5k), and the JAX trainers' quality gates
    missing = probe_host()
    records_root = tempfile.mkdtemp(prefix='chip_smoke_records_')
    records = os.path.join(records_root, 'records')
    write_records(records)
    paths['train_records_xz_flagship'], _, _, records_device = \
        train_from_records(records, 'python', TRAIN_STEPS, card,
                           'train_records_step')
    print('train step from records against synthetic batches (CUDA events, '
          'median): {:.3f} ms against {:.3f} ms [{}]'.format(
              float(np.percentile(records_device, 50)),
              float(np.percentile(synthetic_device, 50)), card))
    native = check_native_ingest(records, missing, card)
    if native is not None:
        paths['train_records_native_xz_flagship'] = native
    trained = train_scoring_nets(records, records_root, card)
    check_quality_gates(records_root)

    # -- 5j. the other planning costs' JAX goldens in f32, each then with
    # the plain tail (their bf16 replans at full width are phase 11's twins)
    from visual_foresight_torch.models.convert import read_npz
    try:
        dirs = {k: predictor_dirs(k, read_npz(GOLDEN_PATHS[k])['copy_seeds'])
                for k in ('ensemble', 'registration')}
        for cost in ('ensemble', 'registration', 'classifier', 'nce'):
            paths['golden_' + cost] = check_controller_golden(
                cost, dirs.get(cost))
        check_inverse_golden()
        rng = np.random.RandomState(4)
        goal_image = lambda ncam: rng.rand(1, ncam, H, W, 3).astype(
            np.float32)

        # -- 5k. the nets trained from records in 5i, each served by its
        # controller for one replan
        paths['serve_trained_registration'], treg_ctrl, treg_states = \
            drive_controller(
                'xz2c_bench20_registration on the GDN trained from records',
                REG_AGENT, dict(REG_POLICY, model_path=dirs['registration'],
                                gdn_path=trained['gdn']), 2,
                cls=controller_class('registration'),
                act_kw={'desig_pix': np.array([[[24, 32]], [[30, 20]]]),
                        'goal_pix': np.array([[[10, 50]], [[15, 40]]]),
                        'goal_image': goal_image(2)},
                want=REG_AGENT['ncam'] * replan_launches(REG_POLICY))
        paths['serve_trained_classifier'], tclf_ctrl, tclf_states = \
            drive_controller(
                'ag_bench20_classifier on the classifier trained from '
                'records', AG_AGENT,
                dict(CLF_POLICY, classifier_path=trained['classifier']), 2,
                cls=controller_class('classifier'),
                act_kw={'goal_image': goal_image(1)})
        paths['serve_trained_nce'], tnce_ctrl, tnce_states = \
            drive_controller(
                'xz_bench20_nce on the embedding trained from records',
                AG_PARAMS, dict(NCE_POLICY, embedding_path=trained['nce']), 2,
                cls=controller_class('nce'),
                act_kw={'goal_image': goal_image(1)})
        paths['serve_trained_inverse'] = drive_inverse(
            card, dict(INV_POLICY, model_params_path=trained['inverse']),
            name='trained_inverse')
    finally:
        shutil.rmtree(records_root)

    # -- 6. times ----------------------------------------------------------------
    print('replan_p50_ms={:.3f} (200 samples x 15 steps x 48x64 x 3 iters, '
          'bf16, restored flagship, host clock, {} replans) [{}]'.format(
              float(np.percentile(latencies, 50)), N_TIMED, card))
    tails = {b: time_tail(gen, b, card) for b in TAIL_TIMED_BATCHES}
    tail = tails[CTRL_POLICY['num_samples']]
    add_one_times = time_add_one(gen, card, PROBE_SHAPE)
    time_add_one(gen, card, (1 << 26,))
    time_controller('controller_replan',
                    '768 samples x 45 steps x 48x64 x 3 iters, bf16', ctrl,
                    ctrl_states, card)
    # fuse_decode in turns with the unfused flagship: plain, fused, fused,
    # plain
    for _ in range(2):
        time_controller('xz_bench20_fuse_decode_replan',
                        '768 samples x 45 steps x 48x64 x 3 iters, bf16, '
                        'fuse_decode', fuse_ctrl, fuse_states, card)
    time_controller('controller_replan',
                    '768 samples x 45 steps x 48x64 x 3 iters, bf16', ctrl,
                    ctrl_states, card)
    # the conv-LSTM cells through the stock chain and through the kernel, in
    # turns: stock, kernel, kernel, stock
    for cells in ('stock', 'kernel', 'kernel', 'stock'):
        with StockCells() if cells == 'stock' else contextlib.nullcontext():
            time_controller('classic_cdna_replan_{}_cells'.format(cells),
                            '768 samples x 45 steps x 48x64 x 3 iters, bf16, '
                            'classic CDNA (the JAX default), seeded',
                            classic_ctrl, classic_states, card)
    time_controller('classic_dna_replan',
                    '768 samples x 45 steps x 48x64 x 3 iters, bf16, classic '
                    'DNA, seeded', dna_ctrl, dna_states, card)
    eff = time_eff(gen, CTRL_POLICY['num_samples'], card)
    lstm = time_lstm(gen, card)
    norm = time_norm(gen, card)
    time_eff(gen, M, card)
    time_controller('ag_bench20_replan',
                    '768 samples x 30 steps x 48x64 x 3 iters, adim 4, one '
                    'latent per sample, bf16, ag_r5f_v2', ag_ctrl, ag_states,
                    card)
    time_controller('xz_chunk200_replan',
                    '800 samples in 4 chunks of 200 x 45 steps x 48x64 x 3 '
                    'iters + a 45-step re-roll of 10 elites, bf16',
                    chunk_ctrl, chunk_states, card)
    time_controller('xz_800_replan',
                    '800 samples in one batch x 45 steps x 48x64 x 3 iters, '
                    'bf16', whole_ctrl, whole_states, card)
    time_controller('robonet_mppi_replan',
                    'MPPI 600 samples x 10 steps x 48x64 x 5 iters, anchored, '
                    'bf16, ag_r5f_v2', mppi_ctrl, mppi_states, card)
    time_controller('robonet_mppi_host_replan',
                    'MPPI host loop, 600 samples x 5 iters of one 11-step '
                    'teacher-forced forward, bf16, ag_r5f_v2', host_ctrl,
                    host_states, card)
    time_controller('folding_replan',
                    'folding 600 samples x 15 steps x 48x64 x 3 iters, bf16, '
                    'ag_r5f_v2', fold_ctrl, fold_states, card)
    for name, twin, c, st in (
            ('trained_registration', 'xz2c_bench20_registration', treg_ctrl,
             treg_states),
            ('trained_classifier', 'ag_bench20_classifier', tclf_ctrl,
             tclf_states),
            ('trained_nce', 'xz_bench20_nce', tnce_ctrl, tnce_states)):
        time_controller(name + '_replan', 'as twin {}\'s replan (phase 11), '
                        'on the net trained from records'.format(twin), c,
                        st, card)
    planes = {b: time_two_planes(gen, b, tails[b]['blocked_ms'], card)
              for b in TWO_PLANE_BATCHES}
    two_planes = planes[REG_POLICY['num_samples']]
    two_planes_96x128 = check_two_planes_96x128(gen, card)
    report_two_plane_tiles(gen, REG96_SHAPE['b'], card)
    profile_replan(lambda: replan(*contexts[0], generator=plan_gen))
    profile_replan(lambda: ctrl.perform_CEM(ctrl_states))
    print('profile: one ag_bench20 replan')
    profile_replan(lambda: ag_ctrl.perform_CEM(ag_states))
    print('profile: one xz_bench20 replan at 800 samples in chunks of 200')
    profile_replan(lambda: chunk_ctrl.perform_CEM(chunk_states))
    print('profile: one RoboNet MPPI replan, fused')
    profile_replan(lambda: mppi_ctrl.perform_CEM(mppi_states))
    print('profile: one RoboNet MPPI replan, host loop')
    profile_replan(lambda: host_ctrl.perform_CEM(host_states))
    print('profile: one classic CDNA replan at xz_bench20')
    profile_replan(lambda: classic_ctrl.perform_CEM(classic_states))
    print('profile: one classic DNA replan at xz_bench20')
    profile_replan(lambda: dna_ctrl.perform_CEM(dna_states))
    print('profile: one xz_bench20 replan with fuse_decode')
    profile_replan(lambda: fuse_ctrl.perform_CEM(fuse_states))

    bwd = {b: time_bwd(gen, b, card) for b in BWD_TIMED_BATCHES}

    # -- 7. the sim benchmark campaign: the host probe, the verbose dump at
    # xz_bench20's point, then both scored campaigns where MuJoCo renders
    _, gl = probe_campaign_host()
    paths['verbose_dump_xz_bench20'] = drive_verbose_dump(card)
    paths.update(drive_campaigns(card, gl))

    # -- 8. data collection and offline replay: the towel twin replayed on
    # the card, its episodes converted to records and trained from, one
    # human-scored replan, and a line for what waits (MuJoCo, h5py)
    collection = drive_collection(card, gl)
    paths.update(collection)

    # -- 9. the flagship served from a TF1 bundle (export, import, the
    # replan against the numpy restore's), visualize_predictions and
    # check_dataset on records, one replan under device_trace and
    # PhaseTimer, and the RoboNet reader and sawyer envs where their
    # packages import, else a line for each
    paths.update(drive_tf1_and_tools(card, gl))

    # -- 10. the robot path: the sawyer pixel-cost twin through run_robot
    # (a fake arm, two test-pattern camera nodes, a two-view model), two
    # trajectories and a resumed third, then its first replan in f32 with
    # the kernel and with the plain tail; the RoboNet franka twin through
    # run_robot --benchmark (host-loop MPPI, one camera), and the sawyer
    # grasp collection twin without --benchmark (five cameras)
    robot_paths, save_video = drive_robot(card)
    paths.update(robot_paths)
    paths.update(drive_robonet_robot(card, save_video))
    paths.update(drive_robot_collection(card))

    # -- 11. the campaign twins: each planning twin of the benchmarks and of
    # experiments/sim built from its own file at its own operating point
    # (bf16, cuda), every view and net restored, replanned through act();
    # the random baselines' policies built and acting on the host
    paths.update(drive_twins(card))

    # -- 12. the robot and RoboNet experiment twins: each built from its own
    # file with its stand-ins at its own point (bf16, cuda, every view and
    # net restored), one group of equal points replanned once; the
    # registration experiment's two planes at 96x128
    paths.update(drive_robot_twins(card))
    # -- 13. the mesh: the flagship's replan over the card repeated 2 and 4
    # times and over make_mesh(), each against unsharded; 3 train steps at
    # batch 16 over the card twice against one; the dry run at n = 4
    paths.update(drive_mesh(card))
    # -- 14. the checkpoints: the decoder built, both vendored orbax step
    # directories restored on the card against the numpy exports and
    # replanned against them, a short run saved, read back and resumed
    paths.update(drive_checkpoints(card))

    two_plane_paths = ['twin_' + n for n, c, _, _ in TWIN_POINTS
                       if c == 'registration'] + [
        'twin_' + p[0] for p in ROBOT_TWIN_POINTS if p[1] == 'registration']
    extra_path_launches = sum(
        n['cdna_tail'] for p, n in paths.items()
        if p == 'verbose_dump_xz_bench20' or p.startswith('campaign_') or
        (p.startswith('twin_') and p not in two_plane_paths) or
        p.startswith(('mesh_flagship_', 'dryrun_multichip_',
                      'checkpoint_')) or
        p in ('offline_replay', 'human_cem', 'numpy_replan_200',
              'tf1_replan_200', 'visualize_predictions', 'profiled_replan',
              'robot_sawyer_pixel_cost', 'robot_robonet_franka'))
    by_batch = lambda runs: {str(b): {k: r[k] for k in (
        'ms', 'plain_ms', 'bound_ms', 'bound_by')} for b, r in runs.items()}

    a_ms, a_plain, a_lib, a_bound, a_by = add_one_times
    dna_path = paths['controller_classic_dna']

    def by_path(name):
        return {p: n[name] for p, n in paths.items() if n.get(name)}

    print(json.dumps({'kernels': [{
        'name': 'cdna_tail', 'route': 'cuda',
        'source': 'visual_foresight_torch/csrc/cdna_tail.cu',
        'replaces': 'visual_foresight_tpu/ops/pallas_cdna.py:71',
        # the controller path, the campaign's (the dump and the scored
        # campaigns), data collection's (the offline replay, the human
        # CEM), phase 9's serving paths (the TF1 and numpy replans,
        # visualize_predictions, the profiled replan), phase 10's robot
        # twin and phase 11's campaign twins but the registration ones
        # (two planes, counted there), phase 13's mesh replans and its dry
        # run (its train step's forward too), phase 14's orbax and numpy
        # replans; training paths are in launches_by_path alone
        'launches': paths['controller']['cdna_tail'] + extra_path_launches,
        'launches_by_path': by_path('cdna_tail'),
        'max_abs_err': err_bf16, 'ms': tail['blocked_ms'],
        'ms_full_resolution_masks': tail['full_ms'],
        'plain_ms': tail['plain_ms'], 'bound_ms': tail['bound_ms'],
        'bound_by': tail['bound_by'], 'library_ms': None,
        # the blocked layout at each timed batch (B=768 above)
        'by_batch': by_batch({b: dict(r, ms=r['blocked_ms'])
                              for b, r in tails.items()}),
        # two packed planes: the registration twins (C=3, P=2)
        'tiled_two_planes': dict(
            two_planes,
            launches=sum(paths[p]['cdna_tail'] for p in two_plane_paths),
            max_abs_err=reg_err, library_ms=None,
            shape='B=768 48x64 C=3 P=2 blocked masks r=4 bf16',
            by_batch=by_batch(planes),
            # the sawyer registration experiment's shape
            at_96x128=dict(two_planes_96x128, library_ms=None,
                           shape='B=400 96x128 C=3 P=2 blocked masks r=4 '
                                 'bf16'))}, {
        # the source's second kernel, cdna_tail_eff_kernel: its DNA mode
        # on the DNA paths (the top-level numbers), its field-given entry
        # (the Pallas function's own contract) on none
        'name': 'cdna_tail_eff', 'route': 'cuda',
        'source': 'visual_foresight_torch/csrc/cdna_tail.cu',
        'replaces': 'visual_foresight_tpu/ops/pallas_cdna.py:71',
        'launches': sum(dna_path[e] for e in ('cdna_tail_dna',
                                              'cdna_tail_eff')),
        'launches_by_path': by_path('cdna_tail_dna'),
        'max_abs_err': eff_err['dna'], 'ms': eff['dna']['ms'],
        'plain_ms': eff['dna']['plain_ms'],
        'bound_ms': eff['dna']['bound_ms'],
        'bound_by': eff['dna']['bound_by'], 'library_ms': None,
        'entries': {
            'cdna_tail_dna_forward': dict(
                eff['dna'], launches=dna_path['cdna_tail_dna'],
                max_abs_err=eff_err['dna']),
            'cdna_tail_eff_forward': dict(
                eff['eff'], launches=dna_path['cdna_tail_eff'],
                max_abs_err=eff_err['eff'])}}, {
        # the tail's backward: no TPU kernel of its own (JAX differentiates
        # its XLA tail); the top-level numbers at the trainer's batch
        'name': 'cdna_tail_bwd', 'route': 'cuda',
        'source': 'visual_foresight_torch/csrc/cdna_tail_bwd.cu',
        'replaces': 'visual_foresight_tpu/ops/pallas_cdna.py:71',
        'gradient_of': 'visual_foresight_tpu/ops/cdna_warp.py:86 and :123, '
                       'differentiated by XLA in the JAX trainer',
        # the flagship's training, phase 13's sharded and unsharded steps
        # and the dry run's, phase 14's resumed step
        'launches': paths['train_xz_flagship']['cdna_tail_bwd'] + sum(
            n['cdna_tail_bwd'] for p, n in paths.items()
            if p.startswith(('mesh_train_', 'dryrun_multichip_',
                             'train_checkpoint_'))),
        'launches_by_path': by_path('cdna_tail_bwd'),
        'max_abs_err': bwd_abs, 'max_rel_err': bwd_rel,
        'ms': bwd[TRAIN_BATCH]['ms'], 'plain_ms': bwd[TRAIN_BATCH]['plain_ms'],
        'bound_ms': bwd[TRAIN_BATCH]['bound_ms'],
        'bound_by': bwd[TRAIN_BATCH]['bound_by'], 'library_ms': None,
        'by_batch': {str(b): r for b, r in bwd.items()}}, {
        # no TPU kernel: the JAX package leaves the conv-LSTM cell and its
        # LayerNorm to XLA, which fuses them; the top-level numbers are a
        # predictor step's three cells at B=768
        'name': 'conv_lstm_ln', 'route': 'cuda',
        'source': 'visual_foresight_torch/csrc/conv_lstm_ln.cu',
        'replaces': None,
        'launches': sum(n.get('conv_lstm_ln', 0) for n in paths.values()),
        'launches_by_path': by_path('conv_lstm_ln'),
        'max_err_share_of_tol': lstm_err, 'ms': lstm['step']['ms'],
        'plain_ms': lstm['step']['plain_ms'],
        'bound_ms': lstm['step']['bound_ms'], 'bound_by': 'bytes',
        'library_ms': None,
        'by_shape': {k: r for k, r in lstm.items() if k != 'step'}}, {
        # no TPU kernel either: the classic backbone's ln0 and ln6, with
        # their convolution's bias (XLA fuses them in the JAX package); the
        # top-level numbers are a classic step's two at B=768
        'name': 'bias_layer_norm', 'route': 'cuda',
        'source': 'visual_foresight_torch/csrc/conv_lstm_ln.cu',
        'replaces': None,
        'launches': sum(n.get('bias_layer_norm', 0) for n in paths.values()),
        'launches_by_path': by_path('bias_layer_norm'),
        'max_err_share_of_tol': norm_err, 'ms': norm['step']['ms'],
        'plain_ms': norm['step']['plain_ms'],
        'bound_ms': norm['step']['bound_ms'], 'bound_by': 'bytes',
        'library_ms': None,
        'by_shape': {k: r for k, r in norm.items() if k != 'step'}}, {
        'name': 'add_one', 'route': 'cuda',
        'source': 'visual_foresight_torch/csrc/probe_add_one.cu',
        'replaces': 'scripts/pallas_device_probe.py:92',
        'launches': probe_launches, 'max_abs_err': probe_err, 'ms': a_ms,
        'plain_ms': a_plain, 'bound_ms': a_bound, 'bound_by': a_by,
        'library_ms': a_lib}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': device_kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
