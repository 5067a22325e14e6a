#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``multimodal_sc_torch``) on one GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --route-check DIR

Builds every CUDA kernel from ``multimodal_sc_torch/csrc`` with ``nvcc``,
holds each kernel against its plain PyTorch version on the card at the
shapes of the paths below, times both (and the one library call that
computes the same function, where there is one) as device time, then
drives the port's paths through its entry points at full widths, random
weights from seed 0. At 1024 envs:

* the c4 DQN act-only iteration;
* arm A, act+learn on the c4 preset as it stands (fused blocks: the kernel
  when acting, the plain version inside the learner);
* arm B, act+learn with ``pallas_mha_block=False, pallas_attention=True``
  (the unfused fusion layers on the packed attention kernels, forward and
  backward), plus one learn step on a fixed batch through the kernels in
  f32 mode against the same step through the plain versions.

Then the c3 late-fusion JSCC train step (ViT camera codec + LiDAR BEV
codec, batch 64, 64x64 images, 1024 points, 32x32 BEV) in two arms:

* arm P, the c3 preset with ``pallas_attention=true``: the ViT's attention
  (dim 128, 4 heads) on the packed attention kernels, forward and backward;
* arm F, the same with ``camera.dim=192 camera.heads=3`` (head dim 64, a
  model dim the packed kernels refuse): the flash attention kernels,
  forward, dQ and dK/dV.

Each arm takes a few dozen train steps (the loss must fall) and one loss
and its gradients through the kernels are held against the same through
the plain versions. Then:

* c5, the PPO update at the preset (32 envs, T 64, 4 epochs x 4
  minibatches of 512): the rollout acts through ``mha_block``,
  ``conv_prelu`` and ``scatter_max``; the loss runs the fused blocks on
  their plain version, the convs and the scatter (forward and backward) on
  their kernels. One warm-up and three timed updates, then two minibatches'
  loss and gradients through the kernels against the plain versions, and
  against the plain versions in f64 (the plain f32 route's distance from
  f64 the yardstick);
* c1, the CNN JSCC train step (batch 64, 32x32): 9 ``conv_prelu`` launches
  a step, among them the decoder's 32 -> 3 output conv without PReLU. A few
  dozen steps (the loss must fall), the held-out evaluation, and one loss
  and its gradients through the kernel against its plain version.

Then the c2 paths (the CNN JSCC codec of c1 with the SNR FiLM and the
4-class seg head, batch 64, 32x32, a per-example SNR):

* c2, the train step at the preset: a few dozen steps (the loss must fall),
  9 ``conv_prelu`` launches a step, one loss (MSE + 0.1 x cross entropy)
  and its gradients through the kernel against its plain version; one step
  each over Rayleigh, Rician, OFDM with 2 pilots, 16-QAM and the adaptive
  rate; one batch swept over AWGN, Rayleigh and Rician at 7 SNRs;
* c3-cnn, the c3 late-fusion train step with ``camera.arch=cnn`` (the CNN
  codec at 64x64, batch 64): 9 ``conv_prelu``, one ``scatter_max`` and one
  backward launch a step, and the route comparison.

The conv kernel's banded path (Cin or Cout no multiple of 4) is also held
at the 64x64 shapes, and its planned bands against one band an image (the
kernel before banding), bit for bit, at the 32x32 shapes.

Then the deployed-policy paths of the c4 agent, at 1024 envs:

* fog + V2X (``env.fog_range=20 env.v2x_rays=32``): act-only and act+learn;
  the roadside unit's 32 rays ride the LiDAR codec a second time, so the
  fusion's LiDAR stream holds 512 tokens (``mha_block`` at (65, 512),
  (512, 65), (512, 512)) and the scatter runs twice a forward;
* the ViT trunk (``camera.arch=vit pallas_attention=true``, the preset's
  ViT widths: dim 128, depth 4, 4 heads, patch 4): act-only and
  act+learn, its 4 encoder and 2 token-decoder attentions on the packed
  kernels;

each with a learn step's loss and gradients through the kernels against
the plain versions. Then a checkpoint round trip on the card (a fog + V2X
state after two iterations saved at the c4 replay capacity, restored into
a fresh state, every tensor and generator compared bit for bit, one more
iteration from each compared again) and the ``eval-policy`` verb on the
restored EMA policy: one evaluation and a return-vs-SNR sweep over 2 kinds
x 3 SNRs.

Then the digital camera link (``camera.arch=vq``: 256 codes of dimension
64, each index's 8 bits over QPSK):

* c1_vq, the VQ camera JSCC train step (batch 64, 32x32, the codebook
  seeded from a real batch as a fresh run seeds it): 800 steps (the mean
  loss of the last 20 must lie below the first step's), 8 ``conv_prelu``
  launches a step in the 60 timed ones, the held-out
  evaluation, one loss (MSE + VQ loss) and its gradients through the
  kernel against its plain version, both on the codes the kernel's route
  picks (a different pick is allowed only at a near-tie); then one
  point at 5 dB of each deployment, uncoded, Hamming(7,4) hard and soft,
  and Type-I HARQ, each run twice from one seed and held bit-equal;
* c4_vq at 1024 envs, act-only and act+learn (the camera's 4 encoder
  convs, the fused blocks and the scatter on their kernels), with the
  learn step's route comparison, the act route against the learner's,
  and a checkpoint round trip held bit for bit, one iteration after it
  too.

The conv kernel's check prints the c1_vq step's 8 convs and the c4_vq act
step's 4 as groups of the shapes it holds.

Then the digital LiDAR codec and the semantic token paths:

* c3_vq, the c3 train step of arm P with ``lidar.arch=vq`` (256 codes of
  dimension 32, 1024 tokens of 8 bits = 4096 QPSK symbols an example; the
  usage term and dead-code re-seeding, the codebook seeded as a fresh run
  seeds it) at batch 64: the launches of arm P, a falling loss, changed
  parameters and codebook, the route comparison on the kernels' route's
  codes, a checkpoint round trip with one step after it bit-equal;
* c3_vq_prune (``lidar.vq_prune=true``): one train step, one point of the
  BEV keep sweep under each selection rule, of the SNR sweep uncoded and
  soft-coded, and of the entropy sweep (the Huffman link, decoded on the
  host, must give the fixed link's mIoU at 25 dB); the times of the
  nearest-code search, the link, ``code_rows``' backward, the drop-damage
  probes and ``decode_vlc_np``, each with its bound where it has one;
* c1_vq_prune and c1_vq under UEP: one train step each, one camera keep
  point per selection rule, one UEP sweep point under alpha 0.25 and
  water-filling, and the damage probes' times.

Then the full-digital agent (the c4 preset over the VQ camera and the VQ
LiDAR: 256 codes of dimension 32 on the 16x16 BEV grid, both codebooks
re-seeded, as the JAX package's c4_digital recipe trains it):

* c4_digital at 1024 envs, act-only and act+learn, with the learn step's
  route comparison on the kernels' route's codes, the act route against
  the learner's, one learn step with every re-seeding coin at 0 (each
  batch-dead code of both codebooks must become its candidate), and a
  checkpoint round trip held bit for bit, one iteration after it too;
* full-digital fog + V2X act-only at 1024 envs under Type-I HARQ on the
  camera, ego and RSU links (two scatters a forward), its link accounting
  summed over the three links at or above their one-shot symbols;
* the pruned digital LiDAR at ``channel.token_keep=0.5`` by the
  farthest-point order: one act step and one act+learn iteration;
* c5 over both digital links at the preset, one warm-up and three timed
  updates, and its route comparison (the plain and f64 routes held to the
  kernels' route's codes).

Then the package's front door, driven in process through
``multimodal_sc_torch.cli.main`` on the card:

* c4 at 1024 envs: ``show``; ``train`` for a few iterations with
  ``--metrics`` and a checkpoint (exact launch counts, finite last
  metrics; ``train.dqn``'s script trains the same beside it for its rate);
  ``eval-policy --use-ema`` over 1024 episodes of that checkpoint;
  ``export --use-ema``, loaded with ``load_artifact`` on the card: on 1024
  fresh observations its actions against the live EMA network's plain
  route (equal but at a top-two Q gap below 1e-4, TF32 off), the live
  kernel route's agreement printed beside them, and the device time of a
  call of each; the ``act`` verb against ``rl.dqn.act``;
* c2: ``train`` for a few steps with a checkpoint, ``eval`` of it (9 convs
  a batch), ``export`` of its codec (encoder, decoder, seg decoder) on the
  card against the live plain route within 1e-5, and ``api.reconstruct``
  against the c2 step's path;
* ``export`` of the c1_vq, c3 and c3_vq codecs from fresh weights, on the
  card against the live plain route: indices equal (but at near-ties),
  the rest within 1e-5.

An artifact runs the kernels' plain versions by design: each of its calls
must launch no kernel.

Then ``train.bf16`` (the codecs and the fused-block trunk in bf16 on f32
parameters), whose kernels read and write bf16 themselves, each counted
apart (``conv_prelu_bf16``, ``mha_block_bf16``, ``scatter_max_bf16``,
``scatter_max_bwd_bf16``, ``packed_attention_fwd_bf16``,
``packed_attention_bwd_bf16``, ``flash_attention_fwd_bf16``,
``flash_attention_bwd_dq_bf16``, ``flash_attention_bwd_dkv_bf16``; the
``kernels`` line lists them beside the f32 ones). The checks:
``conv_prelu`` at c4's act, c1's and c5's shapes on both routes, every
output within one bf16 step of its plain version (the share that differs
printed); ``mha_block`` at c4's, fog + V2X's and c5's act shapes (up to 256
keys on ``mha_wgmma_bf16_kernel``, past them on ``mha_mma_kernel``) within
one bf16 step of its own plus 5e-3 of its bf16-mode plain version, past
that a witnessed rounding flip, at most 1% of outputs differing, and at
each timed shape a sample of the outputs past one step witnessed too, with
``mha_mma_kernel`` timed beside the new kernel at c4's and c5's shapes;
the scatter forward and backward bit for bit with forced ties (a tie of
more than 256 points among the edge shapes), D % 8 == 0 on the kernels of
``csrc/scatter_bf16.cuh`` with the f32 kernels' bf16 instances timed beside
them at each timed shape (``kernel="atomics"``); the packed and flash
attention forward and backward at the timed shapes of their f32 checks
(and ragged, Lq > 128, several-key-split and odd head-dim ones) within
1e-2 plus one bf16 step of their bf16-I/O plain versions (dK and dV of the
packed backward rounded per 128-query block), mean under 1e-5, within
3e-2 of exact f32, and within one step of the same kernels' f32-I/O
results, their one rounding. Then the bf16 paths at the presets' widths:
c4 act-only and act+learn at 1024 envs (exact launch counts, falling loss,
f32 parameters and moments, the act and learn routes against the plain
versions, a checkpoint round trip), fog + V2X act-only, one c5 update's
timed run, c1 and c3-cnn train steps with their route comparisons; then
the c4 ViT trunk act-only and act+learn, c4 arm B act+learn and the c3
arms P and F train steps, each with its route comparison against the
attention kernels' plain versions; last the VQ codecs in bf16: c4_vq and
c4_digital act-only and act+learn at 1024 envs, one c5 digital update
with a minibatch's route comparison, c1_vq (800 steps) and c3_vq train
steps. Their route comparisons hold the plain route to the codes the
kernels' route picks (``_vq_routes``), a differing code allowed only at a
near-tie within ``BF16_TIE`` (2^-5) of the distances' scale, the count
printed. Each path's rate is printed beside its f32 rate from the same
call. The c1_vq timed steps run inside an ``annotate`` scope, which opens
an NVTX range on the card.

Last the distributed path (``runtime/mesh.py``, ``rl/dqn_sharded.py``,
``kernels/ring_attention.py``, data-parallel ``train.jscc`` and
``rl/ppo.py``, tensor-parallel checkpoints):

* (a) a process group of one over NCCL: the c4 act+learn iteration at
  1024 envs, once through ``rl/dqn.py``'s ``make_iteration`` and once
  through the sharded iteration from the same seed (cuDNN deterministic),
  parameters, target, EMA, replay, generator and every metric bit-equal,
  the sharded run's launches of ``mha_block``, ``conv_prelu``,
  ``scatter_max`` and ``scatter_max_bwd`` counted, both rates printed;
* (b) two spawned ranks sharing the card on gloo with CUDA tensors (NCCL
  refuses two ranks on one device), 512 envs each: the collectives the
  sharded path runs (all-reduce, broadcast, all-gather, barrier; gloo
  takes no CUDA tensor in all-to-all or point-to-point,
  ``scripts/gloo_cuda_probe.py``), the networks bit-equal across the ranks
  after each learn step of the first iterations and after the timed ones,
  one gradient all-reduce's time and bytes, and each rank's agent steps/s;
* (c) ring and Ulysses attention on the NCCL group of one against
  ``attention_reference``, outputs and gradients;
* (d) one c1 JSCC step on the two ranks of (b), each on its rows of one
  global batch and of its draws, against the same step in this process
  (TF32 off) within the CPU test's atol 1e-5 / rtol 1e-4;
* (e) one tensor-parallel step on the two ranks of (b) at data 1 x
  model 2: c4 arm B's fusion transformer at the learner's shapes, each
  rank on 2 of the 4 heads, its forward and one SGD step against the
  replicated step in this process on the plain versions (TF32 off) within
  the CPU TP test's 1e-5. The local model dim (64) is not whole 128-lane
  groups, so ``packed_eligible`` refuses it and the ranks' attention runs
  on the flash kernels: their launches are counted, the packed kernels'
  must be 0;
* (f) one c1_vq step (usage loss and re-seeding on) on the two ranks of
  (b), each on its rows of c1's global batch of 64 and of its draws, against
  the same step in this process within 1e-5 / 1e-4: the usage loss, the
  counts, the candidates, perplexity and index errors pooled;
* (g) c5 (rollout 16, one epoch of two minibatch steps) at data 1 x model
  2 through ``train.ppo.run``: two updates with a checkpoint after each,
  against one update, a stop and a resume, each rank's slices bit-equal;
* (h) one c5 digital update at data 2 (both codebooks re-seeding, usage
  pooled): the replicas bit-equal after it, its metrics finite and equal.

A rank that fails fails the run; every spawned process is joined.

The pillar scatter runs on every path but c1, c2 and the camera VQ
paths: its forward kernel in every forward, its backward kernel once per
learn, train or minibatch step.

Each path is driven with the launch counts set to 0 just before and read
just after, and fails unless every kernel of that path ran the expected
number of times and the outputs are finite. The f32 modes' bf16-I/O
instances (``mxu_bf16=False`` on bf16 tensors: the packed kernels' flash
instances with dK and dV per 128-query block, ``mha_block``'s f32 mode)
are held to their plain versions and timed as the others, with a witness
that the packed backward rounds per block; no config passes the flag, so
every path holds them to 0 launches and their lines print 0, per path. Prints the card, the
per-kernel JSON line and, last, ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, when CUDA is absent or any phase fails.
Imports nothing of JAX.

``--profile`` adds, after each path, where its time goes: the layers of
the act iteration and the parts of one learn, train step or PPO update
timed alone, the
device's idle share (an unprofiled wall time against the device time a
CUDA-only ``torch.profiler`` trace sees), and the trace's kernels by
device time.

``--route-check DIR`` builds the kernels and only compares the act route
with the learner's route on the observations a c4 fog + V2X DQN checkpoint
in ``DIR`` carries and holds in its replay buffer.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

# Published H100 SXM peaks (dense): bf16 and TF32 tensor-core and f32
# CUDA-core FLOP/s, HBM bytes/s. A card below its 700 W limit runs slower.
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
PEAK_F64 = 67e12            # f64 on the tensor cores (the data sheet's DGEMM)
PEAK_BYTES = 3.35e12

NUM_ENVS = 1024
WARMUP_ITERS = 3
TIMED_ITERS = 10
# Per-act-step launches the c4 main path must show: 4 fused blocks x
# depth 2; 5 encoder convs; one batched scatter.
# (A kernel a table does not name must not run on that path at all.)
EXPECTED_LAUNCHES = {"mha_block": 8, "conv_prelu": 5, "scatter_max": 1}
FUSION_DEPTH = 2            # c4 fusion.depth: each block shape twice a step
# Per act+learn iteration: the act forward at 1024 envs, then the learner's
# three forwards (and, for the packed attention, one backward) at batch 128.
# Arm A: the learner runs the fused blocks through the plain version.
# The scatter's backward runs once per learn step: only the online forward
# on the batch carries gradient (the target and double-DQN forwards run
# under no_grad), and its LiDAR tokens reach the Q-head through the first
# fusion layer's camera stream.
SCATTER_BWD_PER_STEP = 1
EXPECTED_LEARN_A = {"mha_block": 8, "conv_prelu": 5 + 15,
                    "scatter_max": 1 + 3,
                    "scatter_max_bwd": SCATTER_BWD_PER_STEP}
# Arm B: four attentions x depth 2 per forward. The backward runs for six
# of the eight: the last layer's LiDAR stream (lid2cam, lid_self) feeds
# nothing after it (the state is read from the camera stream's CLS token),
# so autograd never reaches those two.
ATTN_BWD_PER_STEP = 4 * FUSION_DEPTH - 2
EXPECTED_LEARN_B = {"conv_prelu": 5 + 15,
                    "scatter_max": 1 + 3,
                    "scatter_max_bwd": SCATTER_BWD_PER_STEP,
                    "packed_attention_fwd": 8 + 24,
                    "packed_attention_bwd": ATTN_BWD_PER_STEP}
ARM_B = ["pallas_mha_block=false", "pallas_attention=true"]
LEARN_WARMUP_ITERS = 5      # the replay is warm from iteration 3 (n_step 3)
LEARN_TIMED_ITERS = 10
LEARN_BATCH = 128           # c4 rl.batch_size
C4_ATTN_SHAPES = ((65, 256), (256, 65), (65, 65), (256, 256))

# The c3 late-fusion train step. Per step each arm runs one forward and one
# backward through 4 encoder + 4 decoder ViT blocks (every attention's
# inputs depend on parameters, so autograd reaches all eight) and one
# batched scatter in the LiDAR encoder, forward and backward (its point
# features come out of the pillar MLP's parameters).
C3_ARM_P = ["pallas_attention=true"]
C3_ARM_F = C3_ARM_P + ["camera.dim=192", "camera.heads=3"]
C3_ATTN_PER_STEP = 8
EXPECTED_C3_P = {"packed_attention_fwd": C3_ATTN_PER_STEP,
                 "packed_attention_bwd": C3_ATTN_PER_STEP, "scatter_max": 1,
                 "scatter_max_bwd": 1}
EXPECTED_C3_F = {"flash_attention_fwd": C3_ATTN_PER_STEP,
                 "flash_attention_bwd_dq": C3_ATTN_PER_STEP,
                 "flash_attention_bwd_dkv": C3_ATTN_PER_STEP, "scatter_max": 1,
                 "scatter_max_bwd": 1}
C3_BATCH = 64               # c3 train.batch_size
C3_WARMUP_STEPS = 3
C3_TIMED_STEPS = 30

# The c5 PPO update at the preset (32 envs, T 64, 4 epochs x 4 minibatches
# of 512). The rollout and the bootstrap value act T + 1 times through the
# kernels: 8 fused blocks, 5 encoder convs and one scatter a forward. Each
# minibatch step runs the loss forward with the fused blocks on their plain
# version (mha_block: none) and the convs and the scatter on their kernels,
# and its backward reaches the scatter's backward kernel once (the conv
# backward recomputes through the plain version).
C5_T, C5_ENVS, C5_MINIBATCH_STEPS = 64, 32, 4 * 4
C5_ACT_BATCHES = (C5_ENVS, 64)      # the preset, and the bar's rl.num_envs
C5_LOSS_BATCH = C5_T * C5_ENVS // 4
EXPECTED_C5 = {"mha_block": 4 * FUSION_DEPTH * (C5_T + 1),
               "conv_prelu": 5 * (C5_T + 1) + 5 * C5_MINIBATCH_STEPS,
               "scatter_max": (C5_T + 1) + C5_MINIBATCH_STEPS,
               "scatter_max_bwd": C5_MINIBATCH_STEPS}
C5_WARMUP_UPDATES = 1
C5_TIMED_UPDATES = 3

# The c1 CNN JSCC train step at batch 64, 32x32: 5 encoder convs and 4
# decoder convs (block_in, block0, block1, conv_out) on the conv kernel; the
# decoder's transposed convs are plain, as in the JAX package.
C1_BATCH = 64
EXPECTED_C1 = {"conv_prelu": 9}
C1_WARMUP_STEPS = 3
C1_TIMED_STEPS = 40

# c2 at the preset (batch 64, 32x32): the c1 codec's 9 convs a step (the
# seg head and the FiLMs are plain, as in the JAX package); the sweep: one
# forward a point, 3 kinds x 7 SNRs.
EXPECTED_C2 = {"conv_prelu": 9}
C2_WARMUP_STEPS = 3
C2_TIMED_STEPS = 30
C2_VARIANTS = (["channel.kind=rayleigh"], ["channel.kind=rician"],
               ["channel.kind=ofdm", "channel.pilots=2"],
               ["channel.modulation=16"], ["camera.adaptive_rate=true"])
C2_SWEEP_KINDS = ("awgn", "rayleigh", "rician")
# c3 on the CNN camera codec (64x64, batch 64): 9 convs, one scatter and its
# backward a step.
C3_CNN = ["camera.arch=cnn"]
EXPECTED_C3_CNN = {"conv_prelu": 9, "scatter_max": 1, "scatter_max_bwd": 1}

# c4 under fog with a roadside unit (RSU) 24 m ahead casting 32 rays: its
# points ride the LiDAR codec a second time and its 256 tokens join the
# ego's, so the fusion's LiDAR stream is 512 tokens. A forward: 8 fused
# blocks, 5 encoder convs, 2 scatters (ego, RSU). A learn step's online
# forward carries gradient into both scatters.
FOG_V2X = ["env.fog_range=20", "env.v2x_rays=32"]
V2X_RAYS = 32
V2X_ATTN_SHAPES = ((65, 512), (512, 65), (65, 65), (512, 512))
EXPECTED_V2X = {"mha_block": 8, "conv_prelu": 5, "scatter_max": 2}
EXPECTED_V2X_LEARN = {"mha_block": 8, "conv_prelu": 5 + 15,
                      "scatter_max": 2 + 3 * 2, "scatter_max_bwd": 2}
# c4 on the ViT trunk at the preset's ViT widths (dim 128, depth 4, 4 heads,
# patch 4: 64 tokens of d 32), its attention on the packed kernels: 4
# encoder and 2 token-decoder blocks a forward, every one reached by a
# learn step's gradient. No camera conv.
VIT = ["camera.arch=vit", "pallas_attention=true"]
VIT_ATTN_PER_FWD = 6
VIT_TOKENS = 64
EXPECTED_VIT = {"mha_block": 8, "scatter_max": 1,
                "packed_attention_fwd": VIT_ATTN_PER_FWD}
EXPECTED_VIT_LEARN = {"mha_block": 8, "scatter_max": 1 + 3,
                      "scatter_max_bwd": 1,
                      "packed_attention_fwd": 4 * VIT_ATTN_PER_FWD,
                      "packed_attention_bwd": VIT_ATTN_PER_FWD}
EVAL_EPISODES = 32
EVAL_KINDS, EVAL_SNRS = "awgn,rayleigh", "0,10,20"

# c1_vq (``camera.arch=vq``: 256 codes of dimension 64, batch 64, 32x32): a
# train step runs 8 convs on the kernel, enc0-3, from_code, dec0, dec1 and
# conv_out (the 1x1 to_code and the transposed convs are plain, as in the
# JAX package). A sweep point runs one forward (8 convs); a HARQ point
# encodes and decodes (4 + 4).
C1_VQ = ["camera.arch=vq"]
EXPECTED_C1_VQ = {"conv_prelu": 8}
C1_VQ_WARMUP_STEPS = 3
C1_VQ_TIMED_STEPS = 60
# The VQ loss holds flat or rises for its first few hundred steps (the
# warm-up, the codes' early collapse and recovery) and has fallen by step
# 600 in the runs on the H100: the loss is read after this many steps.
C1_VQ_LOSS_STEPS = 800
C1_VQ_SWEEP_SNR = 5.0
# The conv shapes of one c1_vq train step (H, W, Cin, Cout, stride, PReLU)
# and how often a step launches each; of one c4_vq act step, enc0-3.
C1_VQ_CONVS = (((32, 32, 3, 32, 2, True), 1), ((16, 16, 32, 64, 2, True), 1),
               ((8, 8, 64, 128, 1, True), 2), ((8, 8, 128, 128, 1, True), 3),
               ((32, 32, 32, 3, 1, False), 1))
# c4_vq at 1024 envs: the camera's 4 encoder convs on the kernel (its token
# conv is plain), the fusion's 8 fused blocks, one scatter a forward; a
# learn step's online forward reaches the scatter's backward once.
VQ4 = ["camera.arch=vq"]
EXPECTED_VQ4 = {"mha_block": 8, "conv_prelu": 4, "scatter_max": 1}
EXPECTED_VQ4_LEARN = {"mha_block": 8, "conv_prelu": 4 + 12,
                      "scatter_max": 1 + 3, "scatter_max_bwd": 1}
LEARN_ROUTE_VQ4 = {"conv_prelu": 12, "scatter_max": 3, "scatter_max_bwd": 1}

# c4_digital: the c4 preset over the VQ camera and the VQ LiDAR (256 codes of
# dimension 32 on the 16x16 BEV grid: 256 tokens of 8 bits = 1024 QPSK
# symbols an observation), both codebooks re-seeded, the usage term on the
# LiDAR's, as the JAX package's r5 runner trains it. A forward launches what
# c4_vq's does: the LiDAR's quantiser, link and token decoder are plain, as
# in the JAX package; a learn step's online forward reaches the scatter's
# backward once, through the LiDAR's straight-through path.
C4_DIGITAL = ["camera.arch=vq", "lidar.arch=vq", "camera.vq_usage_coef=0.0",
              "camera.vq_reseed=0.05", "lidar.vq_usage_coef=0.05",
              "lidar.vq_reseed=0.05"]
EXPECTED_C4_DIGITAL = EXPECTED_VQ4
EXPECTED_C4_DIGITAL_LEARN = EXPECTED_VQ4_LEARN
LEARN_ROUTE_C4_DIGITAL = LEARN_ROUTE_VQ4
# Full-digital fog + V2X under Type-I HARQ: the RSU's rays ride the digital
# LiDAR link a second time (two scatters a forward). The three links send
# at least their blocks once each: camera 512 bits, ego and RSU LiDAR 2048
# each, in blocks of 64 bits + CRC-8 = 36 QPSK symbols.
C4_DIGITAL_V2X_HARQ = C4_DIGITAL + FOG_V2X + ["channel.harq=true"]
EXPECTED_C4_DIGITAL_V2X = {"mha_block": 8, "conv_prelu": 4, "scatter_max": 2}
ONE_SHOT_SYMS_V2X = (512 // 64 + 2 * 2048 // 64) * 36
# The pruned digital LiDAR deployed at half its tokens by the farthest-point
# order (the learner trains at random kept fractions).
C4_DIGITAL_PRUNE = C4_DIGITAL + ["lidar.vq_prune=true",
                                 "channel.token_keep=0.5"]
# c5 over both digital links at the preset: the rollout's T + 1 forwards
# launch 8 fused blocks, the camera's 4 encoder convs and one scatter each;
# a minibatch step's loss forward the 4 convs and the scatter, its backward
# the scatter's backward.
C5_DIGITAL = ["camera.arch=vq", "lidar.arch=vq", "camera.vq_reseed=0.05",
              "lidar.vq_usage_coef=0.05", "lidar.vq_reseed=0.05"]
EXPECTED_C5_DIGITAL = {
    "mha_block": 4 * FUSION_DEPTH * (C5_T + 1),
    "conv_prelu": 4 * (C5_T + 1) + 4 * C5_MINIBATCH_STEPS,
    "scatter_max": (C5_T + 1) + C5_MINIBATCH_STEPS,
    "scatter_max_bwd": C5_MINIBATCH_STEPS}

# c3_vq: the c3 preset with the digital LiDAR codec as the JAX recipe trains
# it (``lidar.arch=vq``: 256 codes of dimension 32, 1024 tokens of 8 bits =
# 4096 QPSK symbols an example, the usage term and dead-code re-seeding),
# the ViT on arm P. A step launches what c3 arm P launches: the quantiser,
# the link, re-seeding and the BEV decoder are plain, as in the JAX package.
C3_VQ = C3_ARM_P + ["lidar.arch=vq", "lidar.vq_usage_coef=0.25",
                    "lidar.vq_reseed=0.05"]
C3_VQ_PRUNE = C3_VQ + ["lidar.vq_prune=true"]
# The BEV sweeps at one point: a keep point one encoder forward (one
# scatter) under each of the 4 rules, the drop-damage probes through the
# plain BEV decoder; an SNR point one forward, uncoded and soft FEC; the
# entropy sweep one encoder pass (its calibration and payload).
BEV_SELECTS = ("scatter", "random", "drop_damage", "drop_damage_scatter")
EXPECTED_C3_VQ_SWEEPS = {"scatter_max": len(BEV_SELECTS) + 2 + 1}
# c1_vq pruned and under UEP (batch 64): a step's 8 convs; the damage
# estimate decodes once more (from_code, dec0, dec1, conv_out: 4 convs, its
# probes' backward through the plain version). A pruned step selects at
# random (no damage); a UEP step estimates the damage once. A keep point per
# rule: 8, plus 4 for the damage rules; a UEP sweep point: 8 + 4.
C1_VQ_PRUNE = C1_VQ + ["camera.vq_prune=true"]
C1_VQ_UEP = C1_VQ + ["channel.uep_alpha=0.25"]
DAMAGE_CONVS = 4
CAM_SELECTS = ("drop_damage", "random", "scatter", "drop_damage_scatter",
               "damage")
UEP_MODES = {"alpha 0.25": ["channel.uep_alpha=0.25"],
             "waterfill": ["channel.uep_mode=waterfill",
                           "channel.uep_alpha=1"]}
EXPECTED_C1_VQ_PRUNE_UEP = {"conv_prelu": (
    8 + (8 + DAMAGE_CONVS) + 8 * len(CAM_SELECTS)
    + DAMAGE_CONVS * sum("damage" in s for s in CAM_SELECTS)
    + (8 + DAMAGE_CONVS) * len(UEP_MODES))}

# train.bf16: the codecs and the fusion trunk in bf16 on f32 parameters. A
# bf16 path launches what its f32 path launches, each kernel in its bf16-I/O
# variant, counted apart (``<kernel>_bf16``).
BF16 = ["train.bf16=true"]
BF16_KERNELS = ("mha_block", "conv_prelu", "scatter_max", "scatter_max_bwd",
                "packed_attention_fwd", "packed_attention_bwd",
                "flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv")


def _bf16_counts(expected):
    return {(k + "_bf16" if k in BF16_KERNELS else k): v
            for k, v in expected.items()}


EXPECTED_BF16 = _bf16_counts(EXPECTED_LAUNCHES)
EXPECTED_BF16_LEARN = _bf16_counts(EXPECTED_LEARN_A)
EXPECTED_BF16_V2X = _bf16_counts(EXPECTED_V2X)
EXPECTED_BF16_C5 = _bf16_counts(EXPECTED_C5)
EXPECTED_BF16_C1 = _bf16_counts(EXPECTED_C1)
EXPECTED_BF16_C3_CNN = _bf16_counts(EXPECTED_C3_CNN)
# The attention kernels' paths in bf16: the c4 ViT trunk, c4 arm B (the
# unfused fusion MHA on the packed kernels) and c3 arms P and F.
EXPECTED_BF16_VIT = _bf16_counts(EXPECTED_VIT)
EXPECTED_BF16_VIT_LEARN = _bf16_counts(EXPECTED_VIT_LEARN)
EXPECTED_BF16_LEARN_B = _bf16_counts(EXPECTED_LEARN_B)
EXPECTED_BF16_C3_P = _bf16_counts(EXPECTED_C3_P)
EXPECTED_BF16_C3_F = _bf16_counts(EXPECTED_C3_F)


def _counters():
    """name -> (module, attribute) of every kernel wrapper's launch count."""
    from multimodal_sc_torch.kernels import (attention, attention_packed,
                                             conv_block, mha_block,
                                             pillar_scatter)

    return {"mha_block": (mha_block, "launches"),
            "conv_prelu": (conv_block, "launches"),
            "scatter_max": (pillar_scatter, "launches"),
            "scatter_max_bwd": (pillar_scatter, "launches_bwd"),
            "mha_block_bf16": (mha_block, "launches_bf16"),
            "conv_prelu_bf16": (conv_block, "launches_bf16"),
            "scatter_max_bf16": (pillar_scatter, "launches_bf16"),
            "scatter_max_bwd_bf16": (pillar_scatter, "launches_bwd_bf16"),
            "packed_attention_fwd": (attention_packed, "launches_fwd"),
            "packed_attention_bwd": (attention_packed, "launches_bwd"),
            "flash_attention_fwd": (attention, "launches_fwd"),
            "flash_attention_bwd_dq": (attention, "launches_bwd_dq"),
            "flash_attention_bwd_dkv": (attention, "launches_bwd_dkv"),
            "packed_attention_fwd_bf16": (attention_packed,
                                          "launches_fwd_bf16"),
            "packed_attention_bwd_bf16": (attention_packed,
                                          "launches_bwd_bf16"),
            "flash_attention_fwd_bf16": (attention, "launches_fwd_bf16"),
            "flash_attention_bwd_dq_bf16": (attention,
                                            "launches_bwd_dq_bf16"),
            "flash_attention_bwd_dkv_bf16": (attention,
                                             "launches_bwd_dkv_bf16"),
            "packed_attention_fwd_f32io_bf16": (attention_packed,
                                                "launches_fwd_f32io_bf16"),
            "packed_attention_bwd_f32io_bf16": (attention_packed,
                                                "launches_bwd_f32io_bf16"),
            "mha_block_f32io_bf16": (mha_block, "launches_f32io_bf16")}


# The f32 modes' bf16-I/O instances: the kernels' own entry points
# (mxu_bf16=False on bf16 tensors), on no main path. Every path's counts
# hold them to 0 launches (``_check_counts``); their lines report 0.
OFF_PATH_KERNELS = ("packed_attention_fwd_f32io_bf16",
                    "packed_attention_bwd_f32io_bf16", "mha_block_f32io_bf16")


def _reset_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


# The off-path kernels' launches on each path whose counts were checked.
_OFF_PATH_SEEN = {}


def _check_counts(launches, expected, iters, what):
    for k in OFF_PATH_KERNELS:
        _OFF_PATH_SEEN.setdefault(k, {})[what] = launches.get(k, 0)
    for k in launches:
        per_iter = expected.get(k, 0)
        if launches[k] != per_iter * iters:
            raise RuntimeError(
                f"{what}: {k} launched {launches[k]} times in {iters} "
                f"iterations, expected {per_iter} per iteration")


def _ms(fn, iters=10, warmup=2):
    """Mean device time of ``fn`` in ms over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _device_ms(fn, iters=10, warmup=2):
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls.

    ``_ms`` of a call whose device work is shorter than its host work (a
    Python wrapper, allocations, a ctypes launch) reads the host. Here the
    stream is first held by a spin kernel (``torch.cuda._sleep``) longer
    than the host takes to enqueue the calls, so the events around them see
    only the device draining the queue."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t) * 1e3    # what the host spends
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    # At most 2 GHz: 2e6 cycles last at least a millisecond.
    torch.cuda._sleep(int(2e6 * (2 * iters * host_ms + 1)))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _ptxas_report(log):
    """(kernel, "R registers, S bytes spill stores, L bytes spill loads")
    for each kernel ``ptxas -v`` reports in a build log; the kernel by its
    name and template arguments, read from the mangled entry name."""
    import re

    kernel, spill, out = "?", "", []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = _demangle_kernel(entry.group(1))
        elif "spill stores" in line:
            spill = line.split(":", 1)[-1].strip()
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((kernel, f"{regs} registers; {spill}"))
    return out


def _demangle_kernel(mangled):
    """``name<args>`` of a kernel's Itanium-mangled entry name: the nested
    names (each its length, then its letters) read in order up to the one
    that ends in "kernel", then its template arguments (integers, bools,
    float or bf16)."""
    import re

    i = 3 if mangled.startswith("_ZN") else 2
    while i < len(mangled) and mangled[i].isdigit():
        n = re.match(r"\d+", mangled[i:]).group(0)
        name = mangled[i + len(n):i + len(n) + int(n)]
        i += len(n) + int(n)
        if name.endswith("kernel"):
            arg = r"(f)|\d+(__nv_bfloat16)|Li(\d+)E|Lb([01])E"
            args = re.match(rf"I((?:{arg})+)E", mangled[i:])
            if not args:
                return name
            return name + "<" + ", ".join(
                "float" if f else "bf16" if b else v if v else
                ("true" if t == "1" else "false")
                for f, b, v, t in re.findall(arg, args.group(1))) + ">"
    return mangled


def _bound_ms(flops, nbytes, peak_ops):
    t_ops = flops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _entry(name, route, source, replaces, rows):
    """One kernel's line: times and bounds per step of the path its rows
    come from, each shape's row weighted by how often one step launches it
    (``per_step``)."""
    def total(key):
        vals = [r[key] for r in rows]
        if any(v is None for v in vals):
            return None
        return sum(v * r["per_step"] for v, r in zip(vals, rows))

    bound = total("bound_ms")
    by_ops = sum(r["bound_ms"] * r["per_step"] for r in rows
                 if r["bound_by"] == "operations")
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": max(r["err"] for r in rows),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": bound,
            "bound_by": "operations" if by_ops >= bound / 2 else "bytes",
            "library_ms": total("library_ms")}


def _bf16_neighbours(pre):
    """Each f64 value's bf16 rounding (through f32, as an f32 sum is rounded),
    its other bf16 neighbour (itself where the value is exact in bf16), and
    how far the value lies from the midpoint of the two, in bf16 steps."""
    import torch

    f = pre.float()
    lo = (f.view(torch.int32) & -65536).view(torch.float32)
    hi = (lo.view(torch.int32) + 65536).view(torch.float32)
    y = f.bfloat16().float()
    alt = torch.where(f == lo, y, torch.where(y == lo, hi, lo))
    span = (hi.double() - lo.double()).abs()
    tie = ((pre - lo.double()).abs() / span - 0.5).abs()
    return y.double(), alt.double(), tie


def _bf16_flip_witness(x_q, x_kv, p, heads, idx, values, tie_max=1e-2,
                       round_out=False):
    """One output ``idx = (b, i, c)`` of the bf16 mode recomputed in f64 with
    the plain version's bf16 roundings, then once for each single rounding
    taken to its other bf16 neighbour: every entry of q, k and v, of the
    probabilities and of the head outputs (the LayerNorm outputs and the
    weights round the same way in any order of summation). For each of
    ``values`` (name -> the output a route gave) returns the nearest of the
    recomputation itself ("none") and the flips of operands whose f64 value
    lies within ``tie_max`` bf16 steps of its rounding's tie (where a sum
    in another order may round it the other way), as (operand, distance
    left, its distance from the tie); and the exact f64 output. With
    ``round_out`` (bf16 I/O) each candidate output is first rounded to
    bf16, as the kernel stores it."""
    import numpy as np
    import torch

    from multimodal_sc_torch.kernels import mha_block as mb

    b, i, c = idx
    lk, dm = x_kv.shape[1], x_q.shape[-1]
    dh = dm // heads
    scale = dh ** -0.5
    hd = torch.arange(dm, device=x_q.device) // dh
    lk_ar = torch.arange(lk, device=x_q.device)

    def ln64(x, s, bias):
        x = x.double()
        d = x - x.mean(-1, keepdim=True)
        rs = 1.0 / torch.sqrt(d.square().mean(-1, keepdim=True) + mb._EPS)
        return d * rs * s.double() + bias.double()

    def rnd(t):
        return _bf16_neighbours(t)[0]

    def forward(r):
        lnq = r(ln64(x_q[b, i], p["ln_q_scale"], p["ln_q_bias"]))
        lnkv = r(ln64(x_kv[b], p["ln_kv_scale"], p["ln_kv_bias"]))
        qp = lnq @ r(p["wq"].double()) + p["bq"].double()
        kp = lnkv @ r(p["wk"].double()) + p["bk"].double()
        vp = lnkv @ r(p["wv"].double()) + p["bv"].double()
        return qp, kp, vp, r(p["wo"].double())[:, c]

    def attend(q, k, v, r):
        s = (q.view(heads, dh)[:, None] * k.view(lk, heads, dh)
             .transpose(0, 1)).sum(-1) * scale
        pre_p = torch.softmax(s, -1)
        pre_a = torch.einsum("hj,jhd->hd", r(pre_p), v.view(lk, heads, dh))
        return s, pre_p, pre_a.reshape(dm)

    def head_out(pre_a, att_h, wo_h):
        # The change of output c when the head outputs ``att_h`` become the
        # rounded ``pre_a`` (same trailing shape (..., dh)).
        return ((rnd(pre_a) - att_h) * wo_h).sum(-1)

    ident = (lambda t: t)
    qp, kp, vp, wo_x = forward(ident)
    _, _, pre_x = attend(qp, kp, vp, ident)
    resid = x_q[b, i, c].double() + p["bo"][c].double()
    exact = (resid + pre_x @ wo_x).item()

    qp, kp, vp, wo_c = forward(rnd)
    (q, q_alt, q_tie), (k, k_alt, k_tie), (v, v_alt, v_tie) = (
        _bf16_neighbours(qp), _bf16_neighbours(kp), _bf16_neighbours(vp))
    s, pre_p, pre_a = attend(q, k, v, rnd)
    pr, pr_alt, pr_tie = _bf16_neighbours(pre_p)
    att, att_alt, att_tie = _bf16_neighbours(pre_a)
    base = resid + att @ wo_c
    att_h, wo_h = att.view(heads, dh), wo_c.view(heads, dh)
    v_h = v.view(lk, heads, dh)
    cands = {"none": (base.view(1), torch.full((1,), 0.5, dtype=base.dtype,
                                                device=base.device))}
    # A head output: one term of output c changes.
    cands["att"] = (base + (att_alt - att) * wo_c, att_tie)
    # v[j, d]: head output d gains pr[h(d), j] times the step, then rounds.
    pre_v = pre_a + pr.T[:, hd] * (v_alt - v)
    cands["v"] = (base + (rnd(pre_v) - att) * wo_c, v_tie)
    # A probability pr[h, j]: head h's outputs gain the step times v[j, h].
    pre_pr = (pre_a.view(heads, 1, dh) + (pr_alt - pr)[..., None]
              * v_h.transpose(0, 1))
    cands["prob"] = (base + head_out(pre_pr, att_h[:, None],
                                     wo_h[:, None]), pr_tie)
    # q[d]: every score of head h(d) moves; softmax, round, attend, round.
    s_q = s[hd] + (q_alt - q)[:, None] * k.T * scale
    pre_q = torch.einsum("dj,jde->de", rnd(torch.softmax(s_q, -1)),
                         v_h[:, hd])
    cands["q"] = (base + head_out(pre_q, att_h[hd], wo_h[hd]), q_tie)
    # k[j, d]: score j of head h(d) moves.
    s_k = s[hd].unsqueeze(0).repeat(lk, 1, 1)
    s_k[lk_ar, :, lk_ar] += q * (k_alt - k) * scale
    pre_k = torch.einsum("jdm,mde->jde", rnd(torch.softmax(s_k, -1)),
                         v_h[:, hd])
    cands["k"] = (base + head_out(pre_k, att_h[hd][None], wo_h[hd][None]),
                  k_tie)
    del s_k, pre_k
    out = {"exact": exact}
    for name, got in values.items():
        best = None
        for op, (vals, ties) in cands.items():
            if round_out:
                vals = rnd(vals)
            dist = (vals - got).abs().reshape(-1)
            if op != "none":
                dist = torch.where(ties.reshape(-1) <= tie_max, dist,
                                   math.inf)
            j = int(dist.argmin())
            if best is None or dist[j].item() < best[1]:
                at = [int(n) for n in np.unravel_index(j, tuple(vals.shape))]
                best = ("none" if op == "none" else f"{op}{at}",
                        dist[j].item(), ties.reshape(-1)[j].item())
        out[name] = best
    return out


def check_mha_block():
    """Kernel vs plain version at the four (Lq, Lk) pairs of the c4 path
    (timed; the kernel's line), then untimed shapes that reach the rest of
    the kernel: head dims 64, 16 and 8, Lk past the 256 keys held in shared
    memory (re-projected per pass), ragged last query tiles, one row and
    key. The bf16 mode runs twice on each and must give the same bits."""
    import torch

    from multimodal_sc_torch.kernels import mha_block as mb

    g = torch.Generator(device="cuda").manual_seed(0)
    dim = 128

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    p = {}
    for k in mb.PARAM_KEYS:
        if k.startswith("w"):
            p[k] = rnd(dim, dim) * dim ** -0.5
        elif "scale" in k:
            p[k] = 1.0 + 0.1 * rnd(dim)
        else:
            p[k] = 0.1 * rnd(dim)
    # (B, Lq, Lk, heads, timed, launches per c4 act step): the c4 act shapes
    # (the kernel's line), the same shapes at c5's rollout batches (32, the
    # preset; 64, the bar), then untimed shapes.
    cases = [(NUM_ENVS, lq, lk, 4, True, FUSION_DEPTH, False)
             for lq, lk in C4_ATTN_SHAPES]
    # The fog + V2X act shapes (rows of the kernel's line too): Lk 512 takes
    # the route past the 256 keys held in shared memory. Those with 512
    # tokens hold 34-67M outputs each, and there alone an output may pass
    # the 5e-3 gate if it is shown to be one rounding flip (below).
    cases += [(NUM_ENVS, lq, lk, 4, True, FUSION_DEPTH,
               (lq, lk) not in C4_ATTN_SHAPES)
              for lq, lk in V2X_ATTN_SHAPES]
    cases += [(b, lq, lk, 4, True, 0, False) for b in C5_ACT_BATCHES
              for lq, lk in C4_ATTN_SHAPES]
    cases += [(b, lq, lk, heads, False, 0, False)
              for b, lq, lk, heads in ((64, 65, 65, 2), (64, 65, 100, 8),
                                       (64, 17, 70, 16), (64, 33, 300, 4),
                                       (32, 96, 300, 4), (16, 100, 2048, 4),
                                       (8, 1, 1, 4))]
    rows = []
    worst = 0.0
    for b, lq, lk, heads, timed, per_step, flips_ok in cases:
        x_q, x_kv = rnd(b, lq, dim), rnd(b, lk, dim)
        ref = mb.mha_block_reference(x_q, x_kv, p, heads)
        ref_bf16 = mb.mha_block_reference_bf16(x_q, x_kv, p, heads)
        out_f32 = mb.mha_block(x_q, x_kv, p, heads, mxu_bf16=False)
        out_bf16 = mb.mha_block(x_q, x_kv, p, heads)
        if not torch.equal(out_bf16, mb.mha_block(x_q, x_kv, p, heads)):
            raise AssertionError("mha_block bf16 mode: two runs on the same "
                                 "inputs differ")
        torch.cuda.synchronize()
        err_f32 = (out_f32 - ref).abs().max().item()
        err_bf16 = (out_bf16 - ref_bf16).abs().max().item()
        mean_bf16 = (out_bf16 - ref_bf16).abs().mean().item()
        err_vs_f32 = (out_bf16 - ref).abs().max().item()
        mean_vs_f32 = (out_bf16 - ref).abs().mean().item()
        att = (ref - x_q).abs().max().item()
        worst = max(worst, err_bf16)
        # f32 mode: same arithmetic as the plain version in another order
        # of summation (128-term dots, <=2048-term softmax sums): 1e-4.
        torch.testing.assert_close(out_f32, ref, atol=1e-4, rtol=1e-4)
        # bf16 mode (the main path) against the plain version that rounds
        # the same operands to bf16 (the normalised probabilities among
        # them). Only the order of the f32 sums differs; now and then that
        # flips one operand's rounding by one bf16 step (2^-8 relative,
        # 2^-6 for an attention output in [2, 4)), which moves the outputs
        # it feeds by up to step * |wo| ~ 5e-3: the max gate, absolute (no
        # rtol, so it is not loosened by the O(1) residual x_q). Flips are
        # rare, so the mean error must stay below 1e-5, about 1% of the mean
        # distance between the bf16 and the exact f32 results (printed): a
        # kernel that rounded elsewhere, or not at all, fails it. Then the
        # loose gate against exact f32, 3e-2.
        diff = (out_bf16 - ref_bf16).abs()
        over = (diff > 5e-3).nonzero().tolist()
        if not flips_ok:
            torch.testing.assert_close(out_bf16, ref_bf16, atol=5e-3, rtol=0)
        elif len(over) > out_bf16.numel() // 10**6 or diff.max() > 1e-2:
            raise AssertionError(
                f"mha_block bf16 mode: {len(over)} outputs past 5e-3 of its "
                f"plain version, the largest {diff.max().item():.3e}")
        # At a 512-token shape an output past 5e-3 must be explained: the
        # f64 recomputation with the plain version's roundings, with at most
        # one operand that lies within 1e-2 of a bf16 step of its tie rounded
        # the other way, must land within 5e-4 (a tenth of the gate) of the
        # kernel's value and of the plain version's. Printed beside the
        # exact f64 output.
        for idx in over:
            wit = _bf16_flip_witness(x_q, x_kv, p, heads, idx, {
                "kernel": out_bf16[tuple(idx)].item(),
                "plain": ref_bf16[tuple(idx)].item()})
            ex = wit["exact"]
            step = 2.0 ** (math.floor(math.log2(abs(ex))) - 7)
            print(f"  mha_block B={b} Lq={lq} Lk={lk} output {idx}: kernel "
                  f"{out_bf16[tuple(idx)].item():.6f}, plain "
                  f"{ref_bf16[tuple(idx)].item():.6f}, exact f64 {ex:.6f} "
                  f"(kernel {abs(out_bf16[tuple(idx)].item() - ex):.3e} and "
                  f"plain {abs(ref_bf16[tuple(idx)].item() - ex):.3e} from it;"
                  f" a bf16 step there {step:.3e}); nearest single flips: "
                  f"kernel {wit['kernel']}, plain {wit['plain']}", flush=True)
            for who in ("kernel", "plain"):
                op, left, _ = wit[who]
                if left > 5e-4:
                    raise AssertionError(
                        f"mha_block bf16 mode: output {idx} at B={b} Lq={lq} "
                        f"Lk={lk} is no single rounding flip at a tie from "
                        f"the {who} value (nearest {op}, {left:.3e} left)")
        if mean_bf16 > 1e-5:
            raise AssertionError(f"mha_block bf16 mode: mean error "
                                 f"{mean_bf16:.3e} against its plain version")
        torch.testing.assert_close(out_bf16, ref, atol=3e-2, rtol=3e-2)
        line = (f"  mha_block B={b} Lq={lq} Lk={lk} h={heads} (att {att:.3f}): "
                f"err bf16 {err_bf16:.3e} ({len(over)} past 5e-3) mean "
                f"{mean_bf16:.2e} (vs f32 "
                f"{err_vs_f32:.3e} mean {mean_vs_f32:.2e}), f32 mode "
                f"{err_f32:.3e}")
        if not timed:
            print(line, flush=True)
            continue
        ms = _device_ms(lambda: mb.mha_block(x_q, x_kv, p, heads))
        plain = _device_ms(lambda: mb.mha_block_reference(x_q, x_kv, p, heads))
        flops = 2 * b * (2 * lq * dim * dim + 2 * lk * dim * dim
                         + 2 * lq * lk * dim)
        nbytes = 4 * (2 * b * lq * dim + b * lk * dim + 4 * dim * dim
                      + 8 * dim)
        bound, by = _bound_ms(flops, nbytes, PEAK_BF16)
        print(f"{line}; kernel {ms:.3f} ms, plain {plain:.3f} ms, "
              f"bound {bound:.4f} ms ({by}; bytes "
              f"{nbytes / PEAK_BYTES * 1e3:.4f} ms, bf16 tensor cores "
              f"{flops / PEAK_BF16 * 1e3:.4f} ms)", flush=True)
        # Each (Lq, Lk) pair runs once per fusion layer.
        if per_step:
            rows.append({"per_step": per_step, "err": err_bf16, "ms": ms,
                         "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                         "library_ms": None})
        del x_q, x_kv, ref, ref_bf16, out_f32, out_bf16
    entry = _entry("mha_block", "cuda", "multimodal_sc_torch/csrc/mha_block.cu",
                   "multimodal_sc_tpu/kernels/mha_block.py:149", rows)
    entry["max_abs_err"] = worst
    return [entry, _check_mha_f32_mode_bf16(p)]


def _gate_f32_mode_bf16(name, got, ref, tol, mag=None, roundings=1):
    """The gate of an f32 mode's bf16-I/O instance against its plain
    version on the same bf16 inputs: every output within the f32 mode's
    gate (atol and rtol ``tol``) plus one bf16 step of the plain value for
    each of its ``roundings`` (two f32 sums in other orders may round to
    neighbouring bf16 values), the step taken at ``mag`` where that is
    larger (the largest value a rounding of it took: a dK or dV block sum
    whose rounding flips moves a running sum that cancels to a small value
    by a step of the block sum), and the mean absolute difference under
    1e-5 (such flips are rare). Returns (max, mean, share of outputs whose
    bits differ)."""
    import torch

    if got.dtype != torch.bfloat16 or got.shape != ref.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}, want "
                             f"bf16 {tuple(ref.shape)}")
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    m = r.abs() if mag is None else torch.maximum(r.abs(), mag)
    over = int((diff > tol + tol * r.abs()
                + roundings * _bf16_step(m)).sum())
    mx, mean = diff.max().item(), diff.mean().item()
    if over or mean > 1e-5:
        raise AssertionError(f"{name}: {over} outputs past {tol} + a bf16 "
                             f"step of the plain version, max {mx:.3e}, "
                             f"mean {mean:.3e}")
    return mx, mean, (got != ref).float().mean().item()


def _check_mha_f32_mode_bf16(p):
    """``mha_block``'s f32 mode on bf16 activations (``mxu_bf16=False``:
    ``kv_proj_kernel<bf16>`` and ``attn_kernel<D, bf16>``) against
    ``mha_block_reference`` on the same bf16 inputs (widened, f32, the
    output rounded once), at c4's act shapes and fog + V2X's 512-key ones (B
    1024, timed: the line's rows, weighted as the kernel's own line), then
    untimed head dims 64, 16 and 8 and a ragged query tile. Two runs give
    the same bits. On no main path: its launches are printed, 0."""
    import torch

    from multimodal_sc_torch.kernels import mha_block as mb

    g = torch.Generator(device="cuda").manual_seed(25)
    bf, dim = torch.bfloat16, 128
    shapes = list(C4_ATTN_SHAPES) + [s for s in V2X_ATTN_SHAPES
                                     if s not in C4_ATTN_SHAPES]
    cases = [(NUM_ENVS, lq, lk, 4, FUSION_DEPTH) for lq, lk in shapes]
    cases += [(64, 65, 100, 2, 0), (64, 17, 70, 8, 0), (32, 33, 300, 16, 0)]
    rows, worst = [], 0.0
    for b, lq, lk, heads, per_step in cases:
        x_q = torch.randn(b, lq, dim, generator=g, device="cuda").to(bf)
        x_kv = torch.randn(b, lk, dim, generator=g, device="cuda").to(bf)
        before = (mb.launches_f32io_bf16, mb.launches_bf16)
        out = mb.mha_block(x_q, x_kv, p, heads, mxu_bf16=False)
        if (mb.launches_f32io_bf16, mb.launches_bf16) != tuple(
                n + 1 for n in before):
            raise AssertionError("mha_block f32 mode, bf16 I/O: not counted "
                                 "as its instance")
        if not torch.equal(out, mb.mha_block(x_q, x_kv, p, heads,
                                             mxu_bf16=False)):
            raise AssertionError("mha_block f32 mode, bf16 I/O: two runs on "
                                 "the same inputs differ")
        ref = mb.mha_block_reference(x_q, x_kv, p, heads)
        torch.cuda.synchronize()
        err, mean, share = _gate_f32_mode_bf16(
            f"mha_block f32 mode, bf16 I/O B={b} Lq={lq} Lk={lk}", out, ref,
            1e-4)
        worst = max(worst, err)
        line = (f"  mha_block f32 mode, bf16 I/O B={b} Lq={lq} Lk={lk} "
                f"h={heads}: err {err:.3e} mean {mean:.2e}, "
                f"{100 * share:.4f}% of outputs differ; two runs bit-equal")
        if not per_step:
            print(line, flush=True)
            continue
        ms = _device_ms(lambda: mb.mha_block(x_q, x_kv, p, heads,
                                             mxu_bf16=False))
        plain = _device_ms(lambda: mb.mha_block_reference(x_q, x_kv, p,
                                                          heads))
        # f32-grade products: at least three TF32 tensor-core passes each
        # (3 x operations / 495 TFLOP/s); bf16 activations, f32 parameters.
        flops = 2 * b * (2 * lq * dim * dim + 2 * lk * dim * dim
                         + 2 * lq * lk * dim)
        nbytes = (2 * (2 * b * lq * dim + b * lk * dim)
                  + 4 * (4 * dim * dim + 8 * dim))
        bound, by = _bound_ms(3 * flops, nbytes, PEAK_TF32)
        print(f"{line}; kernel {ms:.3f} ms, plain {plain:.3f} ms, bound "
              f"{bound:.4f} ms ({by})", flush=True)
        rows.append({"per_step": per_step, "err": err, "ms": ms,
                     "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                     "library_ms": None})
        del x_q, x_kv, out, ref
    entry = _entry("mha_block_f32io_bf16", "cuda",
                   "multimodal_sc_torch/csrc/mha_block.cu",
                   "multimodal_sc_tpu/kernels/mha_block.py:149", rows)
    entry["max_abs_err"] = worst
    return entry


def check_conv_prelu():
    """Kernel vs plain version at the five camera-encoder conv shapes, at
    the act batch (1024; these rows are the kernel's line), the c4
    learner's batch (128), the c5 loss minibatch (512) and c1's batch (64,
    with c1's decoder shapes), then at shapes that reach every predicate of
    the kernel:
    odd maps, Cin that is no multiple of the 32-channel step, Cout that is
    no multiple of 8 (masked columns of the tensor-core path) or of 4 (the
    per-image path)."""
    import torch
    import torch.nn.functional as F

    from multimodal_sc_torch.kernels import conv_block as cb

    g = torch.Generator(device="cuda").manual_seed(1)
    # (H, W, Cin, Cout, stride, PReLU) of CameraEncoderCNN at c4 widths.
    encoder = ((32, 32, 3, 32, 2, True), (16, 16, 32, 64, 2, True),
               (8, 8, 64, 128, 1, True), (8, 8, 128, 128, 1, True),
               (8, 8, 128, 16, 1, False))
    # CameraDecoderCNN at c1 widths: block_in and conv_out (the first
    # main-path layer without PReLU whose Cout, 3, is no multiple of 4: the
    # per-image path, a 166 KB padded window); block0 and block1 have the
    # encoder's last block's shape.
    decoder = ((8, 8, 16, 128, 1, True), (32, 32, 32, 3, 1, False))
    # (B, shape, timed, launches per act step): the c4 act batch (the
    # kernel's line), the c4 learner's, the c5 loss minibatch (512 at the
    # preset), the c5 rollout's act batch (32 at the preset; the bar's 64 is
    # c1's batch) and c1's batch, encoder and decoder.
    cases = [(NUM_ENVS, shape, True, 1) for shape in encoder]
    cases += [(b, shape, True, 0)
              for b in (LEARN_BATCH, C5_LOSS_BATCH, C5_ENVS)
              for shape in encoder]
    cases += [(C1_BATCH, shape, True, 0) for shape in encoder + decoder]
    cases += [(64, shape, False, 0) for shape in (
        (7, 9, 32, 64, 1, True), (7, 9, 32, 64, 2, True),
        (9, 7, 40, 24, 2, False), (8, 8, 16, 12, 1, True),
        (8, 8, 16, 10, 1, True), (5, 5, 4, 200, 1, True),
        (3, 3, 132, 136, 2, True))]
    rows = []
    timed_at = {}
    worst = 0.0
    for b, (h, w, cin, cout, s, prelu), timed, per_step in cases:
        x = torch.randn(b, h, w, cin, generator=g, device="cuda")
        wt = torch.randn(5, 5, cin, cout, generator=g,
                         device="cuda") / (25 * cin) ** 0.5
        bias = 0.1 * torch.randn(cout, generator=g, device="cuda")
        alpha = (torch.rand(cout, generator=g, device="cuda")
                 if prelu else None)
        ref = cb.conv_prelu_reference(x, wt, bias, alpha, s)
        out = cb.conv_prelu(x, wt, bias, alpha, s)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        # The plain side is exact f32 (TF32 off); the kernel's 3xTF32
        # products carry ~2^-22 each and sums of up to 3200 of them run in
        # another order: 1e-4, a gate for exact-f32 arithmetic.
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
        path = ("tensor cores" if cb.tensor_core_path(cin, cout)
                else "FMA units")
        line = (f"  conv_prelu B={b} {h}x{w}x{cin}->{cout} s{s} ({path}): "
                f"err {err:.3e}")
        if not timed:
            print(line, flush=True)
            continue
        ms = _device_ms(lambda: cb.conv_prelu(x, wt, bias, alpha, s))
        plain = _device_ms(lambda: cb.conv_prelu_reference(x, wt, bias, alpha, s))
        # Library yardstick: one cuDNN convolution (+ bias) on the input
        # padded beforehand; it leaves out the PReLU.
        (plo, phi), (qlo, qhi) = cb.same_pads(h, 5, s), cb.same_pads(w, 5, s)
        xc = F.pad(x.permute(0, 3, 1, 2), (qlo, qhi, plo, phi)).contiguous(
            memory_format=torch.channels_last)
        wc = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = _device_ms(lambda: F.conv2d(xc, wc, bias, stride=s))
        oh, ow = -(-h // s), -(-w // s)
        flops = 2 * b * oh * ow * cout * 25 * cin
        nbytes = 4 * (b * h * w * cin + 25 * cin * cout + 2 * cout
                      + b * oh * ow * cout)
        # The least time for f32-grade products on this card: three TF32
        # tensor-core products for each one (the 3xTF32 split), or the
        # bytes, whichever takes longer.
        bound, by = _bound_ms(3 * flops, nbytes, PEAK_TF32)
        print(f"{line}; kernel {ms:.3f} ms, plain {plain:.3f} ms, cuDNN "
              f"{lib:.3f} ms, bound {bound:.4f} ms ({by})", flush=True)
        row = {"per_step": per_step, "err": err, "ms": ms, "plain_ms": plain,
               "bound_ms": bound, "bound_by": by, "library_ms": lib}
        timed_at[b, (h, w, cin, cout, s, prelu)] = row
        if per_step:
            rows.append(row)
    # The digital camera's steps, from the shapes above: a c1_vq train
    # step's 8 convs at batch 64 (from_code's 64 -> 128 has enc2's shape,
    # dec0 and dec1 enc3's), a c4_vq act step's encoder at 1024 envs.
    for what, b, shapes in (
            ("c1_vq train step, 8 convs", C1_BATCH, C1_VQ_CONVS),
            ("c4_vq act step, enc0-3", NUM_ENVS,
             [(shape, 1) for shape in encoder[:4]])):
        group = [dict(timed_at[b, shape], per_step=n) for shape, n in shapes]
        line = _entry("conv_prelu", "cuda", "", "", group)
        print(f"  conv_prelu, {what} at B={b}: kernel {line['ms']:.4f} ms, "
              f"plain {line['plain_ms']:.4f} ms, cuDNN "
              f"{line['library_ms']:.4f} ms, bound {line['bound_ms']:.4f} ms "
              f"({line['bound_by']}), err {line['max_abs_err']:.3e}",
              flush=True)
    entry = _entry("conv_prelu", "cuda",
                   "multimodal_sc_torch/csrc/conv_prelu.cu",
                   "multimodal_sc_tpu/kernels/conv_block.py:69", rows)
    entry["max_abs_err"] = worst
    return entry


def check_conv_bands():
    """The banded path of ``conv_prelu`` (Cin or Cout no multiple of 4):
    kernel against plain version, timed with cuDNN beside it, at c1's and
    c5's shapes and the 64x64 ones of c3-cnn (whose one-image window of up
    to 592 KB no block holds); at the 32x32 shapes the planned bands give
    the same bits as one band an image, the kernel as it ran before
    banding. Returns the largest error."""
    import torch
    import torch.nn.functional as F

    from multimodal_sc_torch.kernels import conv_block as cb

    g = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    # (B, H, Cin, Cout, stride, PReLU)
    for b, h, cin, cout, s, prelu in (
            (C1_BATCH, 32, 32, 3, 1, False), (C1_BATCH, 32, 3, 32, 2, True),
            (C5_ENVS, 32, 3, 32, 2, True), (C3_BATCH, 64, 32, 3, 1, False),
            (C3_BATCH, 64, 3, 32, 2, True)):
        x = torch.rand(b, h, h, cin, generator=g, device="cuda")
        wt = torch.randn(5, 5, cin, cout, generator=g,
                         device="cuda") / (25 * cin) ** 0.5
        bias = 0.1 * torch.randn(cout, generator=g, device="cuda")
        alpha = (torch.rand(cout, generator=g, device="cuda")
                 if prelu else None)
        oh = -(-h // s)
        band = cb.band_plan(b, oh, oh, cin, 5, s)
        ref = cb.conv_prelu_reference(x, wt, bias, alpha, s)
        out = cb.conv_prelu(x, wt, bias, alpha, s)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
        same = "n/a (one image's window exceeds a block)"
        if cb.band_window_bytes(oh, oh, cin, 5, s) <= cb._SMEM_LIMIT:
            one = cb._conv_prelu_cuda(x, wt, bias, alpha, s, band=oh)
            torch.cuda.synchronize()
            if not torch.equal(one, out):
                raise RuntimeError(
                    f"conv_prelu bands of {band} rows differ from one band "
                    f"an image at B={b} {h}x{h}x{cin}->{cout}")
            same = "bit-equal"
        ms = _device_ms(lambda: cb.conv_prelu(x, wt, bias, alpha, s))
        plain = _device_ms(lambda: cb.conv_prelu_reference(x, wt, bias,
                                                           alpha, s))
        (plo, phi) = cb.same_pads(h, 5, s)
        xc = F.pad(x.permute(0, 3, 1, 2), (plo, phi, plo, phi)).contiguous(
            memory_format=torch.channels_last)
        wc = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = _device_ms(lambda: F.conv2d(xc, wc, bias, stride=s))
        flops = 2 * b * oh * oh * cout * 25 * cin
        nbytes = 4 * (b * h * h * cin + 25 * cin * cout + 2 * cout
                      + b * oh * oh * cout)
        # The FMA units compute this path: f32 products at the f32 peak.
        bound, by = _bound_ms(flops, nbytes, PEAK_F32)
        print(f"  conv_prelu banded B={b} {h}x{h}x{cin}->{cout} s{s}: band "
              f"{band} rows, {b * -(-oh // band)} blocks, "
              f"{cb.band_window_bytes(band, oh, cin, 5, s)} B window; err "
              f"{err:.3e}, against one band an image {same}; kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, cuDNN {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({by})", flush=True)
    return worst


def _pillar_inputs():
    """Point features and cells as the c4 path makes them: a real LiDAR
    observation of NUM_ENVS envs, voxelized (trash cells included)."""
    import torch

    from multimodal_sc_torch.codec.lidar_bev import voxelize
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.envs import driving

    cfg = get_preset("c4")
    g = torch.Generator(device="cuda").manual_seed(2)
    states = driving.reset_batch(cfg.env, NUM_ENVS, g, device="cuda")
    _, pts, mask = driving.observe_batch(cfg.env, states)
    lid = cfg.lidar
    _, cell = voxelize(pts, mask, lid.bev_hw, lid.x_range, lid.y_range)
    feats = torch.randn(NUM_ENVS, pts.shape[1], lid.pillar_dim, generator=g,
                        device="cuda")
    return feats, cell, lid.bev_hw[0] * lid.bev_hw[1]


def _v2x_pillar_inputs():
    """Point features and cells of the fog + V2X path: a real observation
    of NUM_ENVS envs, its fog-limited ego rays and the RSU's 32 rays
    voxelized apart, as the two LiDAR branch calls see them."""
    import torch

    from multimodal_sc_torch.codec.lidar_bev import voxelize
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.envs import driving

    cfg = get_preset("c4").override_str(FOG_V2X)
    g = torch.Generator(device="cuda").manual_seed(5)
    states = driving.reset_batch(cfg.env, NUM_ENVS, g, device="cuda")
    _, pts, mask = driving.observe_batch(cfg.env, states)
    lid, r = cfg.lidar, cfg.env.lidar_rays
    out = []
    for sl in (slice(0, r), slice(r, None)):
        _, cell = voxelize(pts[:, sl], mask[:, sl], lid.bev_hw, lid.x_range,
                           lid.y_range)
        feats = torch.randn(NUM_ENVS, cell.shape[1], lid.pillar_dim,
                            generator=g, device="cuda")
        out.append((feats, cell, lid.bev_hw[0] * lid.bev_hw[1]))
    return out


def _c3_pillar_inputs():
    """Point features and cells as the c3 path makes them: a batch of the
    synthetic clouds, voxelized onto the 32x32 grid (trash cells included)."""
    import torch

    from multimodal_sc_torch.codec.lidar_bev import voxelize
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.envs import datasets

    lid = get_preset("c3").lidar
    g = torch.Generator(device="cuda").manual_seed(4)
    pts, mask = datasets.synthetic_pointcloud_batch(
        datasets.draw_pointcloud(C3_BATCH, lid.max_points, g, "cuda",
                                 lid.x_range, lid.y_range),
        lid.x_range, lid.y_range)
    _, cell = voxelize(pts, mask, lid.bev_hw, lid.x_range, lid.y_range)
    feats = torch.randn(C3_BATCH, lid.max_points, lid.pillar_dim, generator=g,
                        device="cuda")
    return feats, cell, lid.bev_hw[0] * lid.bev_hw[1]


def _force_ties(feats, cell):
    """A copy of the inputs with ties: every 8th point copied onto the next
    (same cell, same features), and every 8th from the 4th onto the next in
    the first half of its features only."""
    import torch

    feats, cell = feats.clone(), cell.clone()
    n, d = feats.shape[1], feats.shape[2]
    for first, width in ((0, d), (4, d // 2)):
        if first >= n - 1:
            continue
        src = torch.arange(first, n - 1, 8, device=feats.device)
        cell[:, src + 1] = cell[:, src]
        feats[:, src + 1, :width] = feats[:, src, :width]
    return feats, cell


def _scatter_widths(cells, feats=None, bwd=False):
    """The slice widths the kernels of ``feats`` take at this shape, widest
    first (the bf16 kernels of ``csrc/scatter_bf16.cuh``: their planned
    widths that fit)."""
    from multimodal_sc_torch.kernels import pillar_scatter as ps

    if feats is not None and ps.lists_route(feats):
        n = feats.shape[1]
        return [w for w in ps.bf16_widths(feats.shape[2])
                if ps.bf16_smem_bytes(n, w, cells, bwd) <= ps.SMEM_BYTES]
    return [w for w in (64, 32, 16, 8, 4) if cells * w * 4 <= ps.SMEM_BYTES]


def _scatter_plan(feats, cells, bwd=False):
    """The kernels a scatter call on ``feats`` runs and their slice."""
    from multimodal_sc_torch.kernels import pillar_scatter as ps

    b, n, d = feats.shape
    if ps.lists_route(feats):
        width = ps.bf16_plan(b, n, d, cells, bwd)
        return (f"scatter_bf16.cuh, slice {width}, "
                f"{ps.bf16_threads(b, n, d, cells, width, bwd)} threads")
    width, vec = ps.slice_plan(b, d, cells)
    return f"slice {width}, vec {vec}"


def _scatter_counter(feats, bwd=False):
    """The launch count a scatter kernel call on ``feats`` adds to."""
    import torch

    return ("launches_bwd" if bwd else "launches") + (
        "_bf16" if feats.dtype == torch.bfloat16 else "")


def _scatter_case(what, feats, cell, cells, timed=True):
    """One shape of the scatter_max forward against its plain version, bit
    for bit, one launch per call; if timed, its row (and a line of times at
    each slice width). f32 or bf16 features."""
    import torch

    from multimodal_sc_torch.kernels import pillar_scatter as ps

    b, n, d = feats.shape
    esz = feats.element_size()
    counter = _scatter_counter(feats)
    ref = ps.scatter_max_reference(feats, cell, cells)
    before = getattr(ps, counter)
    out = ps.scatter_max(feats, cell, cells)
    torch.cuda.synchronize()
    if getattr(ps, counter) != before + 1:
        raise AssertionError(f"scatter_max: {getattr(ps, counter) - before} "
                             f"launches ({counter}) for one call")
    err = (out - ref).abs().max().item()
    # Max is exact and order-independent: the kernel must agree bit for bit.
    torch.testing.assert_close(out, ref, atol=0.0, rtol=0.0)
    valid = int((cell < cells).sum().item())
    line = (f"  scatter_max ({what}) {feats.dtype} B={b} N={n} D={d} "
            f"cells={cells} ({valid} of {b * n} points in range; "
            f"{_scatter_plan(feats, cells)}): err {err:.3e}")
    if not timed:
        print(line, flush=True)
        return None
    ms = _device_ms(lambda: ps.scatter_max(feats, cell, cells), iters=50)
    plain = _device_ms(lambda: ps.scatter_max_reference(feats, cell, cells),
                       iters=50)
    buf = torch.full((b, cells + 1, d), float("-inf"), dtype=feats.dtype,
                     device="cuda")
    idx = cell.long().unsqueeze(-1).expand(b, n, d)
    lib = _device_ms(lambda: torch.scatter_reduce(buf, 1, idx, feats, "amax"),
                     iters=50)
    # Cells read once, in-range features read once, the grid written once.
    nbytes = 4 * b * n + esz * (valid * d + b * cells * d)
    bound, by = _bound_ms(valid * d, nbytes, PEAK_F32)
    lists = ps.lists_route(feats)
    widths = "; ".join(
        f"{w}: {_device_ms(lambda: ps._scatter_max_cuda(feats, cell, cells, w), iters=50):.4f}"
        for w in _scatter_widths(cells, feats))
    old = (_device_ms(lambda: ps._scatter_max_cuda(
        feats, cell, cells, kernel="atomics"), iters=50) if lists else None)
    print(f"{line}; kernel {ms:.4f} ms, "
          + (f"scatter_max_kernel<bf16, 4> {old:.4f} ms, " if lists else "")
          + f"plain {plain:.4f} ms, scatter_reduce {lib:.4f} ms, bound "
          f"{bound:.5f} ms ({by}); by slice width (ms) {widths}", flush=True)
    return {"per_step": 1, "err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib,
            "old_ms": old}


def _scatter_bwd_case(what, feats, cell, cells, timed=True):
    """The scatter_max backward kernel, through autograd, against its plain
    version on inputs with forced ties (atol 0), run twice and compared bit
    for bit; if timed, its row."""
    import torch

    from multimodal_sc_torch.kernels import pillar_scatter as ps

    g = torch.Generator(device="cuda").manual_seed(6)
    feats, cell = _force_ties(feats, cell)
    b, n, d = feats.shape
    esz = feats.element_size()
    counter = _scatter_counter(feats, bwd=True)
    gy = torch.randn(b, cells, d, generator=g, device="cuda").to(feats.dtype)
    x = feats.clone().requires_grad_(True)
    out = ps.scatter_max(x, cell, cells)
    before = getattr(ps, counter)
    (got,) = torch.autograd.grad(out, x, gy)
    torch.cuda.synchronize()
    if getattr(ps, counter) != before + 1:
        raise AssertionError(f"scatter_max backward: "
                             f"{getattr(ps, counter) - before} launches "
                             f"({counter}) for one gradient")
    out = out.detach()
    want = ps.scatter_max_backward_reference(feats, cell, out, gy, cells)
    # The same compares and one IEEE division per hit on both sides: bit for
    # bit (atol 0). Integer counts, no float atomics: two runs agree.
    torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)
    again = ps._scatter_max_bwd_cuda(feats, cell, out, gy, cells)
    if not torch.equal(again, got):
        raise AssertionError("scatter_max backward: two runs on the same "
                             "inputs differ")
    err = (got - want).abs().max().item()
    # Ties among the maxima: (env, cell, feature) entries whose max is
    # reached by two points or more.
    pad = torch.zeros(b, 1, d, dtype=out.dtype, device="cuda")
    idx = cell.long().unsqueeze(-1).expand(b, n, d)
    hit = (cell < cells).unsqueeze(-1) & (
        feats == torch.cat([out, pad], 1).gather(1, idx))
    count = torch.zeros(b, cells + 1, d, device="cuda").scatter_add_(
        1, idx, hit.float())[:, :cells]
    ties = int((count > 1).sum().item())
    line = (f"  scatter_max backward ({what}) {feats.dtype} B={b} N={n} "
            f"D={d} cells={cells} ({ties} tied maxima, the most "
            f"{int(count.max().item())} points; "
            f"{_scatter_plan(feats, cells, bwd=True)})"
            f": err {err:.3e}, two runs bit-equal")
    if not timed:
        print(line, flush=True)
        return None
    ms = _device_ms(lambda: ps._scatter_max_bwd_cuda(feats, cell, out, gy,
                                                     cells), iters=50)
    plain = _device_ms(lambda: ps.scatter_max_backward_reference(
        feats, cell, out, gy, cells), iters=50)
    xr = feats.clone().requires_grad_(True)
    yr = ps.scatter_max_reference(xr, cell, cells)
    autograd = _device_ms(lambda: torch.autograd.grad(yr, xr, gy,
                                                      retain_graph=True),
                          iters=20)
    valid = int((cell < cells).sum().item())
    touched = int(((count > 0).sum(-1) > 0).sum().item())   # (env, cell)
    # Cells and in-range features read once, out and g at the cells that
    # hold points, every point's gradient written once.
    nbytes = 4 * b * n + esz * (valid * d + 2 * touched * d + b * n * d)
    bound, by = _bound_ms(valid * d, nbytes, PEAK_F32)
    lists = ps.lists_route(feats)
    widths = "; ".join(
        f"{w}: {_device_ms(lambda: ps._scatter_max_bwd_cuda(feats, cell, out, gy, cells, w), iters=50):.4f}"
        for w in _scatter_widths(cells, feats, bwd=True))
    old = (_device_ms(lambda: ps._scatter_max_bwd_cuda(
        feats, cell, out, gy, cells, kernel="atomics"), iters=50)
        if lists else None)
    print(f"{line}; kernel {ms:.4f} ms, "
          + (f"scatter_max_bwd_kernel<bf16, 4> {old:.4f} ms, " if lists
             else "")
          + f"plain {plain:.4f} ms, autograd of the plain forward "
          f"{autograd:.4f} ms, bound {bound:.5f} ms ({by}); by slice width "
          f"(ms) {widths}", flush=True)
    return {"per_step": 1, "err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "old_ms": old}


def _scatter_edges():
    """Edge shapes: an env with no point in range and an env whose points
    all share one negative cell, N no multiple of a block's 16-point stride;
    D = 40 (slices 16, 16, 8); D = 30 and D = 7 (no float4 rows); one
    point."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(9)
    feats, cell, cells = _pillar_inputs()
    feats, cell = feats[:96, :37].clone(), cell[:96, :37].clone()
    cell[0] = cells
    cell[1] = 5
    feats[1] = -feats[1].abs() - 1.0
    yield "all-trash env, N=37", feats, cell, cells
    for b, n, d, c in ((128, 64, 40, 256), (64, 100, 30, 1024),
                       (32, 50, 7, 256), (8, 1, 64, 256)):
        feats = torch.randn(b, n, d, generator=g, device="cuda")
        cell = torch.randint(0, c + 1, (b, n), generator=g, device="cuda",
                             dtype=torch.int32)
        yield f"D={d}, N={n}", feats, cell, c


def check_scatter_max():
    """Forward: the c4 act shape (its row is the kernel's line), the c4
    learn, c3 and c5 shapes and the edge shapes. Backward: the c3 shape (its
    row is the backward's line), the c4 learn and c5 loss shapes and the
    edge shapes."""
    c4 = _pillar_inputs()

    def first(b):
        return c4[0][:b], c4[1][:b], c4[2]

    c3 = _c3_pillar_inputs()
    row = _scatter_case("c4 act", *c4)
    _scatter_case("c4 learn", *first(LEARN_BATCH))
    _scatter_case("c3 and c3_vq", *c3)
    # c5 (c4's LiDAR): the rollout batch and the loss minibatch.
    _scatter_case("c5 act", *first(C5_ACT_BATCHES[0]))
    _scatter_case("c5 loss", *first(C5_LOSS_BATCH))
    bwd_row = _scatter_bwd_case("c3 and c3_vq", *c3)
    _scatter_bwd_case("c4 learn", *first(LEARN_BATCH))
    _scatter_bwd_case("c5 loss", *first(C5_LOSS_BATCH))
    # The fog + V2X path: the ego's fogged rays and the RSU's 32 a forward
    # (rows of the forward's line), the RSU's at the learn batch (a row of
    # the backward's line).
    ego, rsu = _v2x_pillar_inputs()
    v2x_rows = [_scatter_case("c4 fog+V2X ego", *ego),
                _scatter_case("c4 fog+V2X RSU", *rsu)]
    v2x_bwd = _scatter_bwd_case("c4 fog+V2X RSU learn", rsu[0][:LEARN_BATCH],
                                rsu[1][:LEARN_BATCH], rsu[2])
    for what, feats, cell, cells in _scatter_edges():
        _scatter_case(what, feats, cell, cells, timed=False)
        _scatter_bwd_case(what, feats, cell, cells, timed=False)
    src = "multimodal_sc_torch/csrc/pillar_scatter.cu"
    return [_entry("scatter_max", "cuda", src,
                   "multimodal_sc_tpu/kernels/pillar_scatter.py:79",
                   [row, *v2x_rows]),
            # No TPU kernel: XLA differentiates segment_max.
            _entry("scatter_max_bwd", "cuda", src,
                   "multimodal_sc_tpu/kernels/pillar_scatter.py:32",
                   [bwd_row, v2x_bwd])]


def _gate_bf16(name, got, ref_bf16, ref_f32):
    """The gates of the packed attention kernels' bf16 mode. Against the
    plain version that rounds the same operands only the order of the f32
    sums differs; now and then that flips the bf16 rounding of one
    probability p (or one dS), a step of up to 2^-8 p, which moves the
    outputs it feeds by that step times a v or dO entry (up to ~5.5 among
    the 33M normal draws of the largest case): 2e-2 p, and p reaches ~0.5,
    so the max gate is 1e-2, absolute. Flips are rare: the mean error must
    stay below 1e-5, a few percent of the mean distance between the bf16
    and the exact f32 results (1e-4 to 1e-3). Then the loose gate against
    exact f32, 3e-2. Returns (max, mean) against the rounding twin."""
    import torch

    diff = (got - ref_bf16).abs()
    mx, mean = diff.max().item(), diff.mean().item()
    torch.testing.assert_close(got, ref_bf16, atol=1e-2, rtol=0)
    if mean > 1e-5:
        raise AssertionError(f"{name} bf16 mode: mean error {mean:.3e} "
                             "against its plain version")
    torch.testing.assert_close(got, ref_f32, atol=3e-2, rtol=3e-2)
    return mx, mean


def check_packed_attention():
    """Forward and backward kernels vs their plain versions: the four c4
    (Lq, Lk) pairs at the act batch (1024) and the learner batch (128),
    plus ragged, two-group, d = 64, 16 and 8 shapes and Lk long enough for
    several key splits (two of those timed as well). Times are per act+learn
    iteration of arm B: each c4 pair runs twice per forward (depth 2), one
    forward at 1024 and three at 128, and the backward of one forward."""
    import torch
    import torch.nn.functional as F

    from multimodal_sc_torch.kernels import attention_packed as ap

    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    def heads_first(t, heads):
        b, l, dm = t.shape
        return t.reshape(b, l, heads, dm // heads).transpose(1, 2).contiguous()

    # (B, Lq, Lk, dm, heads, forward launches per iteration, backward ones).
    # A negative count marks the c3 arm-P shape: timed and printed per c3
    # train step, kept out of the kernel's line, which stays arm B's.
    cases = [(NUM_ENVS, lq, lk, 128, 4, FUSION_DEPTH, 0)
             for lq, lk in C4_ATTN_SHAPES]
    cases += [(C3_BATCH, 256, 256, 128, 4, -C3_ATTN_PER_STEP,
               -C3_ATTN_PER_STEP)]
    # The c4 ViT trunk (rows of the kernels' lines): 6 self-attentions of 64
    # tokens a forward, one forward at the act batch and three at the learn
    # batch an act+learn iteration, the backward of one.
    cases += [(NUM_ENVS, VIT_TOKENS, VIT_TOKENS, 128, 4, VIT_ATTN_PER_FWD, 0),
              (LEARN_BATCH, VIT_TOKENS, VIT_TOKENS, 128, 4,
               3 * VIT_ATTN_PER_FWD, VIT_ATTN_PER_FWD)]
    # Backward: the camera-stream attentions (Lq = 65) in both layers, the
    # LiDAR-stream ones in all layers but the last (ATTN_BWD_PER_STEP).
    cases += [(LEARN_BATCH, lq, lk, 128, 4, 3 * FUSION_DEPTH,
               FUSION_DEPTH if lq == 65 else FUSION_DEPTH - 1)
              for lq, lk in C4_ATTN_SHAPES]
    cases += [(64, 33, 70, 128, 4, 0, 0), (64, 64, 64, 256, 8, 0, 0),
              (64, 17, 100, 128, 2, 0, 0), (64, 200, 48, 128, 4, 0, 0),
              (64, 40, 24, 256, 8, 0, 0)]
    # Lk > 1024 (five key splits, partial dQ summed), d = 64 over three
    # splits, d = 16 and d = 8 (half a k-step of the bf16 mma).
    cases += [(4, 100, 1100, 128, 4, 0, 0), (8, 130, 300, 128, 2, 0, 0),
              (16, 70, 130, 128, 8, 0, 0), (16, 50, 300, 128, 16, 0, 0)]
    # On no main path, timed all the same (backward count -1): what the
    # partial dQ of several key splits costs. d = 64 at Lk = 256 takes two
    # splits, d = 32 at Lk = 2048 eight.
    cases += [(C3_BATCH, 256, 256, 128, 2, 0, -1),
              (C3_BATCH, 256, 2048, 128, 4, 0, -1)]
    fwd_rows, bwd_rows = [], []
    worst_fwd = worst_bwd = 0.0     # bf16-mode errors over every case
    for b, lq, lk, dm, heads, n_fwd, n_bwd in cases:
        q, k, v = rnd(b, lq, dm), rnd(b, lk, dm), rnd(b, lk, dm)
        do = rnd(b, lq, dm)
        ref = ap.packed_attention_reference(q, k, v, heads)
        ref_bf16 = ap.packed_attention_reference_bf16(q, k, v, heads)
        out_f32 = ap.packed_attention(q, k, v, heads, mxu_bf16=False)
        out_bf16 = ap.packed_attention(q, k, v, heads)
        torch.cuda.synchronize()
        # f32 mode: the plain version's arithmetic in another order of
        # summation (d-term dots, <= 256-term softmax sums): 1e-4.
        torch.testing.assert_close(out_f32, ref, atol=1e-4, rtol=1e-4)
        err_f32 = (out_f32 - ref).abs().max().item()
        err, mean = _gate_bf16("packed_attention forward", out_bf16, ref_bf16,
                               ref)
        # The logsumexp the forward hands the backward, both modes: the
        # flash kernels' gate, 2e-5.
        scale = (dm // heads) ** -0.5
        lse_err = 0.0
        lses = {}
        for mode in (False, True):
            _, lses[mode] = ap._fwd_cuda(q, k, v, heads, scale, mode,
                                         want_lse=True)
            _, ref_lse = ap.packed_attention_fwd_reference(q, k, v, heads,
                                                           scale, bf16=mode)
            torch.testing.assert_close(lses[mode], ref_lse, atol=2e-5,
                                       rtol=2e-5)
            lse_err = max(lse_err, (lses[mode] - ref_lse).abs().max().item())
        line = (f"  packed_attention B={b} Lq={lq} Lk={lk} dm={dm} h={heads}: "
                f"fwd err bf16 {err:.3e} mean {mean:.2e}, f32 mode "
                f"{err_f32:.3e}, lse {lse_err:.3e}")

        # Backward through autograd, so the Function's backward is what is
        # checked: gradients of sum(out * do) with respect to q, k, v.
        grads = {}
        for mode in (False, True):
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = ap.packed_attention(*ins, heads, mxu_bf16=mode)
            grads[mode] = torch.autograd.grad(out, ins, do)
            # No atomics: a second run gives the same bits.
            again = ap._bwd_cuda(q, k, v, out.detach(), lses[mode], do, heads,
                                 scale, mode)
            if not all(torch.equal(a, b_) for a, b_ in zip(again,
                                                           grads[mode])):
                raise AssertionError(
                    f"packed_attention backward (bf16={mode}): two runs on "
                    "the same inputs differ")
        torch.cuda.synchronize()
        ref_g = ap.packed_attention_bwd_reference(q, k, v, ref, do, heads,
                                                  scale)
        ref_g_bf16 = ap.packed_attention_bwd_reference(
            q, k, v, out_bf16, do, heads, scale, bf16=True)
        errs_f32, errs, means = [], [], []
        for got32, got16, want, want16 in zip(grads[False], grads[True],
                                              ref_g, ref_g_bf16):
            # f32 mode: sums of up to 256 products of O(1) terms in another
            # order, through exp and a difference (dp - delta): 5e-4.
            torch.testing.assert_close(got32, want, atol=5e-4, rtol=5e-4)
            errs_f32.append((got32 - want).abs().max().item())
            e, m = _gate_bf16("packed_attention backward", got16, want16, want)
            errs.append(e)
            means.append(m)
        berr, bmean, berr_f32 = max(errs), max(means), max(errs_f32)
        worst_fwd, worst_bwd = max(worst_fwd, err), max(worst_bwd, berr)
        line += (f"; bwd err bf16 {berr:.3e} mean {bmean:.2e}, f32 mode "
                 f"{berr_f32:.3e}")
        if not (n_fwd or n_bwd):
            print(line, flush=True)
            continue

        ms = _device_ms(lambda: ap.packed_attention(q, k, v, heads))
        plain = _device_ms(lambda: ap.packed_attention_reference(q, k, v, heads))
        qh, kh, vh = (heads_first(t, heads) for t in (q, k, v))
        lib = _device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        bound, by = _bound_ms(4 * b * lq * lk * dm,
                              4 * 2 * b * (lq + lk) * dm, PEAK_BF16)
        line += (f"; fwd kernel {ms:.3f} ms, plain {plain:.3f} ms, SDPA "
                 f"{lib:.3f} ms, bound {bound:.4f} ms ({by})")
        if n_fwd > 0:
            fwd_rows.append({"per_step": n_fwd, "err": err, "ms": ms,
                             "plain_ms": plain, "bound_ms": bound,
                             "bound_by": by, "library_ms": lib})
        elif n_fwd < 0:
            line += f" (c3 arm P: x{-n_fwd} per train step)"
        if n_bwd:
            ms = _device_ms(lambda: ap._bwd_cuda(q, k, v, out_bf16, lses[True], do,
                                          heads, scale, True))
            plain = _device_ms(lambda: ap.packed_attention_bwd_reference(
                q, k, v, ref, do, heads, scale))
            for t in (qh, kh, vh):
                t.requires_grad_(True)
            lib_out = F.scaled_dot_product_attention(qh, kh, vh)
            doh = heads_first(do, heads)
            lib = _device_ms(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                                  retain_graph=True))
            # Five products of 2 Lq Lk d operations per head on the bf16
            # tensor cores; q, k, v, o, dO, lse read and dq, dk, dv written
            # once, in f32.
            bound, by = _bound_ms(10 * b * lq * lk * dm,
                                  4 * (4 * b * (lq + lk) * dm
                                       + b * heads * lq), PEAK_BF16)
            line += (f"; bwd kernel {ms:.3f} ms, plain {plain:.3f} ms, SDPA "
                     f"backward {lib:.3f} ms, bound {bound:.4f} ms ({by})")
            if n_bwd > 0:
                bwd_rows.append({"per_step": n_bwd, "err": berr, "ms": ms,
                                 "plain_ms": plain, "bound_ms": bound,
                                 "bound_by": by, "library_ms": lib})
        print(line, flush=True)
        del q, k, v, do, ref, ref_bf16, out_f32, out_bf16, grads
    src = "multimodal_sc_torch/csrc/attention_packed.cu"
    entries = [
        _entry("packed_attention_fwd", "cuda", src,
               "multimodal_sc_tpu/kernels/attention_packed.py:170", fwd_rows),
        _entry("packed_attention_bwd", "cuda", src,
               "multimodal_sc_tpu/kernels/attention_packed.py:201", bwd_rows)]
    entries[0]["max_abs_err"], entries[1]["max_abs_err"] = worst_fwd, worst_bwd
    return entries + _check_packed_f32_mode_bf16()


def _block_magnitudes(q, k, v, out, dout, heads, scale, lse):
    """The largest value each dK and dV rounding of the packed f32 mode on
    bf16 tensors takes, by the plain version: over the 128-query blocks,
    each block's f32 sum and the running bf16 sum after it."""
    import torch

    from multimodal_sc_torch.kernels import attention_packed as ap

    mags, runs = [None, None], [None, None]
    for q0 in range(0, q.shape[1], ap.BLOCK_Q):
        rows = slice(q0, q0 + ap.BLOCK_Q)
        parts = ap.packed_attention_bwd_reference(
            q[:, rows].float(), k.float(), v.float(),
            out[:, rows].float(), dout[:, rows].float(), heads, scale,
            lse=lse[..., rows])[1:]
        for i, part in enumerate(parts):
            pb = part.bfloat16()
            runs[i] = pb if runs[i] is None else runs[i] + pb
            m = torch.maximum(part.abs(), runs[i].float().abs())
            mags[i] = m if mags[i] is None else torch.maximum(mags[i], m)
    return mags


def _check_packed_f32_mode_bf16():
    """The packed kernels' f32 mode on bf16 tensors (``mxu_bf16=False``:
    the flash kernels' bf16-I/O instances) against their plain versions on
    the same bf16 inputs (``packed_attention_fwd_reference`` and
    ``packed_attention_bwd_reference`` with bf16 off: f32 arithmetic, the
    output and dQ rounded once, dK and dV per 128-query block), forward and
    backward (through autograd) each run twice for the same bits. Timed at
    arm B's learn shapes (B 128, 65 x 256 and 256 x 65) and the ViT
    trunk's (L 64), one call each (the lines' rows); untimed at head dims
    64, 16 and 8 and at Lq = 300, three query blocks, the last partial:
    there the share of dK and dV elements that differ from the per-block
    plain version must be smaller than the share that differ from a plain
    version rounding once, or the block flush is untested. SDPA on the
    widened f32 tensors (TF32 off) is printed as a reference only: it
    computes no bf16 I/O. On no main path: its launches are printed, 0."""
    import torch
    import torch.nn.functional as F

    from multimodal_sc_torch.kernels import attention_packed as ap

    g = torch.Generator(device="cuda").manual_seed(26)
    bf = torch.bfloat16

    def heads_first(t, heads):
        b, l, dm = t.shape
        return t.float().reshape(b, l, heads, dm // heads).transpose(
            1, 2).contiguous()

    # (B, Lq, Lk, dm, heads, timed)
    cases = [(LEARN_BATCH, 65, 256, 128, 4, True),
             (LEARN_BATCH, 256, 65, 128, 4, True),
             (LEARN_BATCH, VIT_TOKENS, VIT_TOKENS, 128, 4, True),
             (8, 130, 300, 128, 2, False), (16, 70, 130, 128, 8, False),
             (16, 50, 300, 128, 16, False), (16, 300, 100, 128, 4, False)]
    fwd_rows, bwd_rows = [], []
    worst_fwd = worst_bwd = 0.0
    for b, lq, lk, dm, heads, timed in cases:
        q, k, v, do = (torch.randn(b, n, dm, generator=g,
                                   device="cuda").to(bf)
                       for n in (lq, lk, lk, lq))
        scale = (dm // heads) ** -0.5
        counts = (ap.launches_fwd_f32io_bf16, ap.launches_bwd_f32io_bf16)
        out, lse = ap._fwd_cuda(q, k, v, heads, scale, False, want_lse=True)
        if not torch.equal(out, ap._fwd_cuda(q, k, v, heads, scale,
                                             False)[0]):
            raise AssertionError("packed_attention f32 mode, bf16 I/O "
                                 "forward: two runs on the same inputs "
                                 "differ")
        want, want_lse = ap.packed_attention_fwd_reference(q, k, v, heads,
                                                           scale)
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = ap.packed_attention(*ins, heads, mxu_bf16=False)
        got = torch.autograd.grad(o, ins, do)
        again = ap._bwd_cuda(q, k, v, o.detach(), lse, do, heads, scale,
                             False)
        if not all(torch.equal(a, b_) for a, b_ in zip(again, got)):
            raise AssertionError("packed_attention f32 mode, bf16 I/O "
                                 "backward: two runs on the same inputs "
                                 "differ")
        if (ap.launches_fwd_f32io_bf16, ap.launches_bwd_f32io_bf16) != (
                counts[0] + 3, counts[1] + 2):
            raise AssertionError("packed_attention f32 mode, bf16 I/O: not "
                                 "counted as its instances")
        want_g = ap.packed_attention_bwd_reference(q, k, v, o.detach(), do,
                                                   heads, scale, lse=lse)
        torch.cuda.synchronize()
        name = f"packed_attention f32 mode, bf16 I/O B={b} Lq={lq} Lk={lk}"
        # The f32 mode's gates: 1e-4 forward, 5e-4 backward; the lse as the
        # flash kernels', 2e-5.
        err, mean, share = _gate_f32_mode_bf16(name + " forward", out, want,
                                               1e-4)
        torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)
        berr, bmean, bshare = 0.0, 0.0, 0.0
        # dK and dV round each block's sum and each join to the running
        # sum: 2 x blocks - 1 roundings, at the blocks' magnitudes.
        blocks = -(-lq // ap.BLOCK_Q)
        mags = [None] + _block_magnitudes(q, k, v, o.detach(), do, heads,
                                          scale, lse)
        for n_, a, w, mg in zip(("dq", "dk", "dv"), got, want_g, mags):
            e, m_, s_ = _gate_f32_mode_bf16(
                f"{name} {n_}", a, w, 5e-4, mg,
                1 if mg is None else 2 * blocks - 1)
            berr, bmean, bshare = max(berr, e), max(bmean, m_), max(bshare,
                                                                   s_)
        worst_fwd, worst_bwd = max(worst_fwd, err), max(worst_bwd, berr)
        line = (f"  {name} dm={dm} h={heads}: fwd err {err:.3e} mean "
                f"{mean:.2e} ({100 * share:.4f}% differ), bwd err "
                f"{berr:.3e} mean {bmean:.2e} ({100 * bshare:.4f}% differ); "
                "two runs bit-equal")
        if lq > ap.BLOCK_Q:
            once = [t.to(bf) for t in ap.packed_attention_bwd_reference(
                *(t.float() for t in (q, k, v, o.detach(), do)), heads, scale,
                lse=lse)]
            for n_, a, w, w1 in zip(("dk", "dv"), got[1:], want_g[1:],
                                    once[1:]):
                blocked = (a != w).float().mean().item()
                rounded_once = (a != w1).float().mean().item()
                line += (f"; {n_} differs from the per-block plain version "
                         f"in {100 * blocked:.4f}%, from the once-rounded "
                         f"one in {100 * rounded_once:.4f}%")
                if not blocked < rounded_once:
                    raise AssertionError(f"{name}: {n_} is no nearer the "
                                         "per-block rounding than the "
                                         "rounding once")
        if not timed:
            print(line, flush=True)
            continue
        qh, kh, vh, doh = (heads_first(t, heads) for t in (q, k, v, do))
        ms = _device_ms(lambda: ap.packed_attention(q, k, v, heads,
                                                    mxu_bf16=False))
        plain = _device_ms(lambda: ap.packed_attention_fwd_reference(
            q, k, v, heads, scale))
        sdpa = _device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        # Passes by operand type: a widened bf16 value splits into TF32
        # with a zero low part, so S = Q K^T (bf16 by bf16) needs one TF32
        # pass and P V (f32 P by bf16 V) two, 2 operations per score and
        # column each; q, k, v read and the output written once in bf16.
        work = b * lq * lk * dm
        bound, by = _bound_ms((1 + 2) * 2 * work,
                              2 * 2 * b * (lq + lk) * dm, PEAK_TF32)
        line += (f"; fwd kernel {ms:.4f} ms, plain {plain:.3f} ms, bound "
                 f"{bound:.4f} ms ({by}), SDPA on the widened f32 tensors "
                 f"{sdpa:.4f} ms (a reference only)")
        fwd_rows.append({"per_step": 1, "err": err, "ms": ms,
                         "plain_ms": plain, "bound_ms": bound,
                         "bound_by": by, "library_ms": None})
        o = o.detach()
        bms = _device_ms(lambda: ap._bwd_cuda(q, k, v, o, lse, do, heads,
                                              scale, False))
        bplain = _device_ms(lambda: ap.packed_attention_bwd_reference(
            q, k, v, o, do, heads, scale, lse=lse))
        for t in (qh, kh, vh):
            t.requires_grad_(True)
        lib_out = F.scaled_dot_product_attention(qh, kh, vh)
        bsdpa = _device_ms(lambda: torch.autograd.grad(
            lib_out, (qh, kh, vh), doh, retain_graph=True))
        # Per kernel, 2 operations per score and column a product: S and dP
        # (bf16 by bf16) one TF32 pass each, dQ = dS K, dV = P^T dO and
        # dK = dS^T Q (f32 by bf16) two; the dQ kernel S, dP, dQ (1 + 1 +
        # 2), the dK/dV kernel S, dP, dV, dK (1 + 1 + 2 + 2). q, k, v, O,
        # dO and lse read, dq, dk, dv written once.
        bound, by = _bound_ms((4 + 6) * 2 * work,
                              2 * b * (4 * lq + 4 * lk) * dm
                              + 4 * b * heads * lq, PEAK_TF32)
        line += (f"; bwd kernels {bms:.4f} ms, plain {bplain:.3f} ms, bound "
                 f"{bound:.4f} ms ({by}), SDPA backward on the widened f32 "
                 f"tensors {bsdpa:.4f} ms (a reference only)")
        bwd_rows.append({"per_step": 1, "err": berr, "ms": bms,
                         "plain_ms": bplain, "bound_ms": bound,
                         "bound_by": by, "library_ms": None})
        print(line, flush=True)
        del q, k, v, do, out, o, got, again, want_g, qh, kh, vh, doh, lib_out
    src = "multimodal_sc_torch/csrc/flash_kernels.cuh"
    entries = [
        _entry("packed_attention_fwd_f32io_bf16", "cuda", src,
               "multimodal_sc_tpu/kernels/attention_packed.py:170", fwd_rows),
        _entry("packed_attention_bwd_f32io_bf16", "cuda", src,
               "multimodal_sc_tpu/kernels/attention_packed.py:201", bwd_rows)]
    entries[0]["max_abs_err"], entries[1]["max_abs_err"] = worst_fwd, worst_bwd
    return entries


def check_flash_attention():
    """Forward, dQ and dK/dV kernels vs their plain versions: the c3 arm-F
    shape on the transposed views the ViT's MHA hands in, plus ragged,
    cross, odd-D and contiguous shapes; every backward run twice and
    compared bit for bit. Times are per arm-F train step (eight launches of
    each kernel)."""
    import torch
    import torch.nn.functional as F

    from multimodal_sc_torch.kernels import attention as fa

    g = torch.Generator(device="cuda").manual_seed(5)

    def heads_view(b, h, l, d):
        # As MHA makes it: a (B, L, H*D) projection seen as (B, H, L, D).
        return torch.randn(b, l, h, d, generator=g,
                           device="cuda").transpose(1, 2)

    def contiguous(b, h, l, d):
        return torch.randn(b, h, l, d, generator=g, device="cuda")

    # (B, H, Lq, Lk, D, layout, launches of each kernel per train step)
    cases = [(C3_BATCH, 3, 256, 256, 64, heads_view, C3_ATTN_PER_STEP),
             (2, 4, 100, 70, 32, contiguous, 0),
             (C3_BATCH, 3, 257, 257, 64, heads_view, 0),
             (2, 4, 64, 64, 48, heads_view, 0),
             (2, 2, 17, 17, 64, contiguous, 0),
             (3, 2, 33, 130, 128, heads_view, 0),
             (2, 3, 40, 24, 96, contiguous, 0),
             (4, 5, 300, 7, 8, heads_view, 0)]
    rows = {"fwd": [], "dq": [], "dkv": []}
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for b, h, lq, lk, d, make, per_step in cases:
        q, k, v = make(b, h, lq, d), make(b, h, lk, d), make(b, h, lk, d)
        do = make(b, h, lq, d)
        scale = d ** -0.5
        ref, ref_lse = fa.flash_attention_fwd_reference(q, k, v, scale)
        out, lse = fa._fwd_cuda(q, k, v, scale)
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        # Through autograd, so the Function's backward is what is checked.
        got = torch.autograd.grad(fa.attention(*ins, use_pallas=True), ins, do)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_reference(q, k, v, ref, ref_lse, do,
                                                scale)
        # Exact f32 on both sides, sums of D and Lk products in another
        # order; the gates of the JAX package's kernel tests: 2e-5 forward
        # (and the logsumexp), 2e-4 backward.
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, atol=2e-4, rtol=2e-4)
        # No atomics: two runs of the backward kernels give the same bits.
        runs = []
        for _ in range(2):
            dq_, delta_ = fa._bwd_dq_cuda(q, k, v, out, lse, do, scale)
            runs.append((dq_, delta_,
                         *fa._bwd_dkv_cuda(q, k, v, lse, delta_, do, scale)))
        if not all(torch.equal(a, b_) for a, b_ in zip(*runs)):
            raise AssertionError("flash_attention backward: two runs on the "
                                 "same inputs differ")
        errs = {"fwd": (out - ref).abs().max().item(),
                "dq": (got[0] - want[0]).abs().max().item(),
                "dkv": max((got[1] - want[1]).abs().max().item(),
                           (got[2] - want[2]).abs().max().item())}
        for key, e in errs.items():
            worst[key] = max(worst[key], e)
        line = (f"  flash_attention B={b} H={h} Lq={lq} Lk={lk} D={d} "
                f"({make.__name__}): err fwd {errs['fwd']:.3e}, lse "
                f"{(lse - ref_lse).abs().max().item():.3e}, dq "
                f"{errs['dq']:.3e}, dk/dv {errs['dkv']:.3e}; two backward runs "
                "bit-equal")
        if not per_step:
            print(line, flush=True)
            continue

        _, delta = fa.flash_attention_dq_reference(q, k, v, ref, ref_lse, do,
                                                   scale)
        work = b * h * lq * lk * d
        rows_bytes = 4 * b * h * d
        ms = {
            "fwd": _device_ms(lambda: fa._fwd_cuda(q, k, v, scale)),
            "dq": _device_ms(lambda: fa._bwd_dq_cuda(q, k, v, out, lse, do, scale)),
            "dkv": _device_ms(lambda: fa._bwd_dkv_cuda(q, k, v, lse, delta, do,
                                                scale))}
        plain = {
            "fwd": _device_ms(lambda: fa.flash_attention_fwd_reference(q, k, v,
                                                                scale)),
            "dq": _device_ms(lambda: fa.flash_attention_dq_reference(
                q, k, v, ref, ref_lse, do, scale)),
            "dkv": _device_ms(lambda: fa.flash_attention_dkv_reference(
                q, k, v, ref_lse, delta, do, scale))}
        # Library yardstick: SDPA forward, and SDPA's backward, which gives
        # dQ, dK and dV in one call: it stands beside both backward rows.
        qc, kc, vc = (t.contiguous().requires_grad_(True) for t in (q, k, v))
        lib_fwd = _device_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc))
        lib_out = F.scaled_dot_product_attention(qc, kc, vc)
        doc = do.contiguous()
        lib_bwd = _device_ms(lambda: torch.autograd.grad(lib_out, (qc, kc, vc), doc,
                                                  retain_graph=True))
        lib = {"fwd": lib_fwd, "dq": lib_bwd, "dkv": lib_bwd}
        # Operations: S and PV forward (4 per score and column); S, dP, dQ in
        # the dQ kernel (6); S, dP, dV, dK in the dK/dV kernel (8). Each is
        # f32-grade, which on this card takes at least three TF32
        # tensor-core products (the 3xTF32 split), whichever design runs:
        # 3 x operations / 495 TFLOP/s, as for conv_prelu. Bytes: every
        # operand read once, every result written once.
        bounds = {
            "fwd": _bound_ms(3 * 4 * work, rows_bytes * (2 * lq + 2 * lk)
                             + 4 * b * h * lq, PEAK_TF32),
            "dq": _bound_ms(3 * 6 * work, rows_bytes * (4 * lq + 2 * lk)
                            + 8 * b * h * lq, PEAK_TF32),
            "dkv": _bound_ms(3 * 8 * work, rows_bytes * (2 * lq + 4 * lk)
                             + 8 * b * h * lq, PEAK_TF32)}
        for key in rows:
            bound, by = bounds[key]
            line += (f"; {key} kernel {ms[key]:.4f} ms (earlier "
                     f"{FLASH_BF16_EARLIER_MS[key]:.4f}), plain "
                     f"{plain[key]:.3f} ms, bound {bound:.4f} ms ({by})")
            rows[key].append({"per_step": per_step, "err": errs[key],
                              "ms": ms[key], "plain_ms": plain[key],
                              "bound_ms": bound, "bound_by": by,
                              "library_ms": lib[key]})
        line += (f"; SDPA forward {lib_fwd:.3f} ms, backward (dQ, dK and dV "
                 f"together) {lib_bwd:.3f} ms")
        print(line, flush=True)
        del q, k, v, do, ref, out, ins, got, want, qc, kc, vc, lib_out
    src = "multimodal_sc_torch/csrc/flash_attention.cu"
    entries = [
        _entry("flash_attention_fwd", "cuda", src,
               "multimodal_sc_tpu/kernels/attention.py:103", rows["fwd"]),
        _entry("flash_attention_bwd_dq", "cuda", src,
               "multimodal_sc_tpu/kernels/attention.py:221", rows["dq"]),
        _entry("flash_attention_bwd_dkv", "cuda", src,
               "multimodal_sc_tpu/kernels/attention.py:252", rows["dkv"])]
    for e, key in zip(entries, ("fwd", "dq", "dkv")):
        e["max_abs_err"] = worst[key]
    return entries


def check_kernels():
    import torch

    # Exact f32 on the plain side: cuDNN convolutions default to TF32 on
    # Hopper, matmuls do not; both are pinned off for every comparison and
    # restored after, so the main path runs with PyTorch's defaults.
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        conv = check_conv_prelu()
        conv["max_abs_err"] = max(conv["max_abs_err"], check_conv_bands())
        return [*check_mha_block(), conv, *check_scatter_max(),
                *check_packed_attention(), *check_flash_attention()]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _init_dqn(cfg):
    """``dqn.init`` at 1024 envs; a digital trunk's codebooks seeded from
    its encoders' outputs, as ``train.dqn.run`` seeds a cold start, and
    copied to the target and the EMA."""
    from multimodal_sc_torch.rl import dqn
    from multimodal_sc_torch.rl.warmstart import cold_start

    state = dqn.init(cfg, seed=0, num_envs=NUM_ENVS, device="cuda")
    cold_start(cfg, (state.params, state.target_params, state.ema_params))
    return state


def drive_main_path(name="c4", overrides=(), expected=EXPECTED_LAUNCHES):
    """The c4 act-only iteration at 1024 envs; returns the launches of the
    timed run, the steps/s, and the config, state and iteration it ended
    with."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.rl import dqn

    cfg = get_preset("c4").override_str(overrides)
    t0 = time.perf_counter()
    state = _init_dqn(cfg)
    iteration = dqn.make_iteration(cfg, learn=False)
    for _ in range(WARMUP_ITERS):
        state, metrics = iteration(state)
    torch.cuda.synchronize()
    print(f"  init + {WARMUP_ITERS} warm-up iterations: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    _reset_counts()
    t0 = time.perf_counter()
    rewards = []
    for _ in range(TIMED_ITERS):
        state, metrics = iteration(state)
        rewards.append(metrics["reward"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()

    sps = TIMED_ITERS * NUM_ENVS / wall
    print(f"  act-only ({name}): {TIMED_ITERS} iterations x {NUM_ENVS} envs "
          f"in {wall:.3f} s = {sps:.1f} agent steps/s", flush=True)
    print(f"  launches in the timed run: {launches}", flush=True)
    print(f"  metrics: " + ", ".join(
        f"{k}={float(v):.4f}" for k, v in metrics.items()), flush=True)
    _check_counts(launches, expected, TIMED_ITERS, f"act-only ({name})")
    if not all(torch.isfinite(r).all() for r in rewards):
        raise RuntimeError("non-finite reward on the main path")
    if not all(torch.isfinite(v).all() for v in metrics.values()):
        raise RuntimeError(f"non-finite metrics: {metrics}")
    # Q-values of the final carried observation through the same network.
    with torch.no_grad():
        img = dqn.dequantize_image(state.obs_image)
        q = state.params(img, state.obs_points, state.obs_mask,
                         generator=state.generator)
    if q.shape != (NUM_ENVS, cfg.rl.num_actions) or not torch.isfinite(q).all():
        raise RuntimeError(f"bad Q-values: shape {tuple(q.shape)}")
    print(f"  Q-values {tuple(q.shape)} finite, mean {q.mean().item():.4f}",
          flush=True)
    return launches, sps, cfg, state, iteration


def _clone_params(net):
    return [p.detach().clone() for p in net.parameters()]


def _same(net, tensors):
    import torch

    return all(torch.equal(p, q) for p, q in zip(net.parameters(), tensors))


def drive_learn(name, overrides, expected):
    """The c4 act+learn iteration at 1024 envs through ``make_iteration``;
    returns the launches of the timed run, the steps/s, and the config,
    state and iteration it ended with."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.rl import dqn

    cfg = get_preset("c4").override_str(overrides)
    t0 = time.perf_counter()
    state = _init_dqn(cfg)
    target0 = _clone_params(state.target_params)
    iteration = dqn.make_iteration(cfg)
    for _ in range(LEARN_WARMUP_ITERS):
        state, metrics = iteration(state)
    torch.cuda.synchronize()
    # The n-step window emits from iteration n_step on; 1024 rows at once
    # make the replay warm, so every iteration since has learned.
    warm_steps = LEARN_WARMUP_ITERS - (cfg.rl.n_step - 1)
    if state.step != warm_steps:
        raise RuntimeError(f"{name}: {state.step} learn steps after "
                           f"{LEARN_WARMUP_ITERS} iterations, expected "
                           f"{warm_steps}")
    print(f"  init + {LEARN_WARMUP_ITERS} warm-up iterations: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    online0 = _clone_params(state.params)
    ema0 = _clone_params(state.ema_params)
    _reset_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(LEARN_TIMED_ITERS):
        state, metrics = iteration(state)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()

    sps = LEARN_TIMED_ITERS * NUM_ENVS / wall
    print(f"  act+learn ({name}): {LEARN_TIMED_ITERS} iterations x {NUM_ENVS} "
          f"envs in {wall:.3f} s = {sps:.1f} agent steps/s", flush=True)
    print(f"  launches in the timed run: {launches}", flush=True)
    print(f"  metrics: " + ", ".join(
        f"{k}={float(v):.4f}" for k, v in metrics.items()), flush=True)
    _check_counts(launches, expected, LEARN_TIMED_ITERS, name)
    losses = torch.stack(losses)
    if not torch.isfinite(losses).all() or not (losses != 0).all():
        raise RuntimeError(f"{name}: losses {losses.tolist()}")
    if not all(torch.isfinite(v).all() for v in metrics.values()):
        raise RuntimeError(f"{name}: non-finite metrics: {metrics}")
    if state.step != warm_steps + LEARN_TIMED_ITERS:
        raise RuntimeError(f"{name}: step {state.step} after "
                           f"{LEARN_TIMED_ITERS} more iterations")
    if _same(state.params, online0):
        raise RuntimeError(f"{name}: the online parameters did not change")
    if _same(state.ema_params, ema0):
        raise RuntimeError(f"{name}: the EMA did not move")
    if state.step >= cfg.rl.target_update_period or not _same(
            state.target_params, target0):
        raise RuntimeError(f"{name}: the target moved before its first sync")
    if any(p.grad is not None for p in state.target_params.parameters()):
        raise RuntimeError(f"{name}: the target network holds gradients")
    # Force the hard sync: one iteration that ends on a multiple of the
    # period must leave the target equal to the online network.
    state = state._replace(step=cfg.rl.target_update_period - 1)
    state, _ = iteration(state)
    torch.cuda.synchronize()
    if not _same(state.target_params, state.params.parameters()):
        raise RuntimeError(f"{name}: target != online after the sync step")
    print(f"  loss {losses[0].item():.4f} -> {losses[-1].item():.4f}; online "
          "and EMA moved, target still until the forced sync, then equal to "
          "the online network", flush=True)
    return launches, sps, cfg, state, iteration


# The learner's three forwards at batch 128 and one backward: arm B, fog +
# V2X (two scatters a forward, both reached by the gradient), the ViT trunk.
LEARN_ROUTE_B = {"conv_prelu": 15, "scatter_max": 3,
                 "scatter_max_bwd": SCATTER_BWD_PER_STEP,
                 "packed_attention_fwd": 24,
                 "packed_attention_bwd": ATTN_BWD_PER_STEP}
LEARN_ROUTE_V2X = {"conv_prelu": 15, "scatter_max": 6, "scatter_max_bwd": 2}
LEARN_ROUTE_VIT = {"scatter_max": 3, "scatter_max_bwd": 1,
                   "packed_attention_fwd": 3 * VIT_ATTN_PER_FWD,
                   "packed_attention_bwd": VIT_ATTN_PER_FWD}


def _link_noise(cfg, batch, g):
    """One channel-noise draw for each link of ``batch`` observations: the
    camera's, the ego LiDAR's and, with V2X, the RSU's."""
    import torch

    from multimodal_sc_torch.channel.digital import index_bits

    hw, lid = cfg.camera.image_hw, cfg.lidar
    n_cam = (hw[0] // 4) * (hw[1] // 4) * cfg.camera.c_sym
    if cfg.camera.arch == "vq":      # the QPSK symbols of the index bits
        n_cam = (hw[0] // 4) * (hw[1] // 4) * index_bits(
            cfg.camera.vq_codes) // 2
    n_lid = lid.bev_hw[0] * lid.bev_hw[1] * lid.c_sym
    if lid.arch == "vq":
        n_lid = lid.bev_hw[0] * lid.bev_hw[1] * index_bits(lid.vq_codes) // 2
    links = (n_cam, n_lid, n_lid) if cfg.env.v2x_rays else (n_cam, n_lid)
    return tuple(torch.randn(batch, n, 2, generator=g, device="cuda")
                 for n in links)


def compare_learn_routes(cfg, state, expected=LEARN_ROUTE_B):
    """One TD loss and its gradients on a fixed batch and fixed channel
    noise (every link's: camera, ego LiDAR and, with V2X, the RSU's),
    twice: through the kernels (packed attention in its f32 mode, forward
    and backward), launching as ``expected``, and through every kernel's
    plain version."""
    import torch

    from multimodal_sc_torch.codec import camera_vit, lidar_bev
    from multimodal_sc_torch.kernels import (attention_packed, conv_block,
                                             pillar_scatter)
    from multimodal_sc_torch.rl import dqn, replay

    bs = cfg.rl.batch_size
    g = torch.Generator(device="cuda").manual_seed(7)
    batch = dqn.dequantize_obs(cfg, replay.sample(
        state.buffer, None, bs, torch.arange(bs, device="cuda")))
    draws = dqn.LearnDraws(indices=torch.arange(bs, device="cuda"),
                           snr_db=None, noise_online=_link_noise(cfg, bs, g),
                           noise_target=_link_noise(cfg, bs, g),
                           noise_double=_link_noise(cfg, bs, g))
    forward = dqn.learner_forward(cfg)
    params = list(state.params.parameters())

    def loss_and_grads():
        loss = dqn._td_loss(cfg, forward, state.params, state.target_params,
                            batch, draws)
        # The last layer's LiDAR-stream tail feeds nothing: no gradient.
        return loss.detach(), torch.autograd.grad(loss, params,
                                                  allow_unused=True)

    routes = _vq_routes if cfg.camera.arch == "vq" else _two_routes
    _compare_grads("learn step", state.params, *routes(
        loss_and_grads, expected, "the learn step",
        [(camera_vit, "packed_attention",
          attention_packed.packed_attention_reference),
         (conv_block, "conv_prelu", conv_block.conv_prelu_reference),
         (lidar_bev, "scatter_max", pillar_scatter.scatter_max_reference)],
        [(camera_vit, "packed_attention", functools.partial(
            attention_packed.packed_attention, mxu_bf16=False))]))


def compare_act_routes(name, cfg, state, net="params", batches=None):
    """Q-values of ``state``'s network ``net`` through the act route (the
    fused blocks on their kernel) against the learner's route (their plain
    version), with the same channel noise, on ``batches`` of (images,
    points, masks) (default: the carried observations): the largest
    difference, the share of observations whose greedy action agrees, the
    median gap between the best two actions (the scale the difference is
    read against), and each route's greedy actions counted."""
    import torch

    from multimodal_sc_torch.rl import dqn

    g = torch.Generator(device="cuda").manual_seed(11)
    if batches is None:
        batches = [(dqn.dequantize_image(state.obs_image), state.obs_points,
                    state.obs_mask)]
    network, learner = getattr(state, net), dqn.learner_forward(cfg)
    diff, agree, n, gaps = 0.0, 0, 0, []
    hist = torch.zeros(2, cfg.rl.num_actions, dtype=torch.long, device="cuda")
    for obs in batches:
        noise = _link_noise(cfg, obs[0].shape[0], g)
        with torch.no_grad():
            q_act = network(*obs, channel_noise=noise)
            q_learn = learner(network, *obs, channel_noise=noise)
        diff = max(diff, (q_act - q_learn).abs().max().item())
        a_act, a_learn = q_act.argmax(-1), q_learn.argmax(-1)
        agree += (a_act == a_learn).sum().item()
        n += a_act.numel()
        top2 = q_learn.topk(2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        for row, a in zip(hist, (a_act, a_learn)):
            row += torch.bincount(a, minlength=cfg.rl.num_actions)
    print(f"  {name}, act route (kernel) vs learner route (plain) after "
          f"{state.step} learn steps: Q max difference {diff:.3e}, greedy "
          f"actions agree in {100 * agree / n:.2f}% of {n} observations, "
          f"median gap of the best two {torch.cat(gaps).median().item():.3e};"
          f" greedy actions counted (kernel / plain) {hist[0].tolist()} / "
          f"{hist[1].tolist()}", flush=True)


def route_check(ckpt_dir):
    """``--route-check DIR``: the act route against the learner's route on a
    c4 fog + V2X DQN checkpoint's own observations, for the online and the
    EMA network: its envs' carried observations, then every observation in
    its replay buffer, 1024 at a time."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.io.checkpoint import CheckpointManager
    from multimodal_sc_torch.rl import dqn, replay

    cfg = get_preset("c4").override_str(FOG_V2X)
    mgr = CheckpointManager(ckpt_dir)
    state = mgr.restore_latest(
        dqn.init(cfg, seed=0, num_envs=cfg.rl.num_envs, device="cuda"))
    if state is None:
        raise RuntimeError(f"no checkpoint in {ckpt_dir!r}")
    size = state.buffer.size

    def replay_batches():
        for lo in range(0, size, NUM_ENVS):
            idx = torch.arange(lo, min(lo + NUM_ENVS, size), device="cuda")
            b = dqn.dequantize_obs(cfg, replay.sample(state.buffer, None,
                                                      idx.numel(), idx))
            yield b.image, b.points, b.mask

    print(f"route check, checkpoint of iteration {mgr.latest_step()} in "
          f"{ckpt_dir}:", flush=True)
    for net in ("params", "ema_params"):
        compare_act_routes(f"{net}, carried observations", cfg, state, net)
        compare_act_routes(f"{net}, the {size} replay observations", cfg,
                           state, net, replay_batches())


def _state_diff(a, b):
    """(entries compared, entries that differ, the largest difference of a
    float tensor) of two train states, leaf by leaf of the trees a
    checkpoint saves of them."""
    import torch

    from multimodal_sc_torch.io.checkpoint import _save_field

    def leaves(x, path=""):
        items = (x.items() if isinstance(x, dict) else enumerate(x)
                 if isinstance(x, (list, tuple)) else None)
        if items is None:
            yield path, x
        for k, v in items or ():
            yield from leaves(v, f"{path}.{k}")

    la, lb = dict(leaves(_save_field(a))), dict(leaves(_save_field(b)))
    if la.keys() != lb.keys():
        raise RuntimeError(f"states differ in their entries: "
                           f"{sorted(set(la) ^ set(lb))[:5]}")
    differ, worst = [], 0.0
    for k, v in la.items():
        w = lb[k]
        if isinstance(v, torch.Tensor):
            same = v.dtype == w.dtype and torch.equal(v, w.to(v.device))
            if not same and v.is_floating_point():
                worst = max(worst, (v.double() - w.to(v.device).double())
                            .abs().max().item())
        else:
            same = v == w
        if not same:
            differ.append(k)
    return len(la), differ, worst


def checkpoint_round_trip(ckpt_dir, overrides=FOG_V2X):
    """A c4 state (fog + V2X unless ``overrides`` says otherwise) at 1024
    envs and the preset's replay capacity after two iterations: saved,
    restored into a fresh state of another seed, every entry compared bit
    for bit; then one iteration (its first learn step) from each, compared
    again. cuDNN is held to deterministic algorithms in this phase: the
    conv kernel's backward recomputes through cuDNN, whose default backward
    algorithms may sum in another order from one call to the next. Returns
    the config."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.io.checkpoint import CheckpointManager
    from multimodal_sc_torch.rl import dqn

    cfg = get_preset("c4").override_str(
        list(overrides) + [f"train.checkpoint_dir={ckpt_dir}"])
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state = _init_dqn(cfg)
        iteration = dqn.make_iteration(cfg)
        for _ in range(2):
            state, _ = iteration(state)
        mgr = CheckpointManager(ckpt_dir)
        mgr.save_config(cfg.to_json())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(2, state)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(ckpt_dir, "ckpt_2.pt"))
        fresh = dqn.init(cfg, seed=1, num_envs=NUM_ENVS, device="cuda")
        t0 = time.perf_counter()
        restored = mgr.restore_latest(fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        n, differ, _ = _state_diff(state, restored)
        if differ:
            raise RuntimeError(f"checkpoint round trip: {len(differ)} of {n} "
                               f"entries differ, e.g. {differ[:5]}")
        print(f"  ckpt_save_s {save_s:.2f} for {size / 2**20:.1f} MiB at "
              f"replay capacity {cfg.rl.replay_capacity} (restore "
              f"{restore_s:.2f} s); {n} entries restored bit for bit",
              flush=True)
        state, _ = iteration(state)
        restored, _ = iteration(restored)
        torch.cuda.synchronize()
        if state.step != 1 or restored.step != 1:
            raise RuntimeError(f"the third iteration took {state.step} / "
                               f"{restored.step} learn steps, expected 1")
        n, differ, worst = _state_diff(state, restored)
        if differ:
            raise RuntimeError(
                f"one iteration from the restored state: {len(differ)} of "
                f"{n} entries differ from the original's (largest float "
                f"difference {worst:.3e}), e.g. {differ[:5]}")
        print(f"  one iteration (a learn step) from each: all {n} entries "
              "bit-equal", flush=True)
        mgr.save(3, restored)
    finally:
        torch.backends.cudnn.deterministic = saved
    return cfg


def eval_policy_phase(cfg):
    """The ``eval-policy`` verb on the restored checkpoint's EMA policy: one
    evaluation, then a return-vs-SNR sweep; returns the launches."""
    from multimodal_sc_torch.evaluation import policy_eval

    over = [a for o in FOG_V2X + [
        f"train.checkpoint_dir={cfg.train.checkpoint_dir}"]
        for a in ("--set", o)]
    args = ["--config", "c4", "--use-ema", "--episodes",
            str(EVAL_EPISODES)] + over
    curves_path = os.path.join(cfg.train.checkpoint_dir, "curves.json")
    sweep = args + ["--snr-sweep", "--kinds", EVAL_KINDS,
                    f"--snrs={EVAL_SNRS}", "--out", curves_path]
    _reset_counts()
    t0 = time.perf_counter()
    outs = []
    for argv in (args, sweep):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if policy_eval.main(argv) != 0:
                raise RuntimeError(f"eval-policy {argv} failed")
        outs.append(buf.getvalue())
        print("  " + "\n  ".join(buf.getvalue().strip().splitlines()),
              flush=True)
    wall = time.perf_counter() - t0
    launches = _read_counts()
    one = json.loads(outs[0].strip().splitlines()[-1])
    with open(curves_path) as f:
        curves = json.load(f)
    kinds, snrs = EVAL_KINDS.split(","), EVAL_SNRS.split(",")
    rows = [r for k in kinds for r in curves[k]]
    if (list(curves) != kinds or len(rows) != len(kinds) * len(snrs)
            or not all(math.isfinite(r["episode_return_mean"])
                       for r in rows + [one])):
        raise RuntimeError(f"eval-policy: bad results {one} / {curves}")
    forwards = cfg.env.max_steps * (1 + len(rows))
    _check_counts(launches, EXPECTED_V2X, forwards, "eval-policy")
    print(f"  eval-policy: {1 + len(rows)} evaluations of {EVAL_EPISODES} "
          f"episodes x {cfg.env.max_steps} steps in {wall:.1f} s; launches "
          f"{launches}", flush=True)
    return launches


def check_reseed(name, cfg, state):
    """One learn step on the replay's first batch with every re-seeding coin
    at 0: each codebook's batch-dead codes (those the online forward's
    tokens did not pick) must all have jumped to their candidates, the
    batch's worst-quantised encoder outputs, and both codebooks changed."""
    import torch

    from multimodal_sc_torch.rl import dqn, replay

    bs = cfg.rl.batch_size
    idx = torch.arange(bs, device="cuda")
    batch = dqn.dequantize_obs(cfg, replay.sample(state.buffer, None, bs,
                                                  idx))
    g = torch.Generator(device="cuda").manual_seed(13)
    noise = [_link_noise(cfg, bs, g) for _ in range(3)]
    per = state.params.perception
    books = {"cam": per.cam_vq.codebook, "lid": per.lid_codebook}
    before = {k: b.detach().clone() for k, b in books.items()}
    zeros = {k: torch.zeros(b.shape[0], device="cuda")
             for k, b in books.items()}
    draws = dqn.LearnDraws(indices=idx, snr_db=None, noise_online=noise[0],
                           noise_target=noise[1], noise_double=noise[2],
                           coin=zeros["cam"], lid_coin=zeros["lid"])
    seen = {}
    reseed = dqn.apply_codebook_reseed

    def spy(cfg_, net, rs, *args):
        seen.update(rs)
        return reseed(cfg_, net, rs, *args)

    with mock.patch.object(dqn, "apply_codebook_reseed", spy):
        state, _ = dqn.learn_step(cfg, state, batch, draws)
    torch.cuda.synchronize()
    for k, book in books.items():
        counts, cands = seen[k]
        dead = counts < 1
        if not torch.equal(book.detach()[dead], cands[dead]):
            raise RuntimeError(f"{name}: {k} codebook: a dead code did not "
                               "jump to its candidate")
        if torch.equal(book.detach(), before[k]):
            raise RuntimeError(f"{name}: the {k} codebook did not change")
        print(f"  {name}: re-seed with every coin 0: {int(dead.sum())} of "
              f"{dead.numel()} {k} codes batch-dead, each now its "
              "candidate; the codebook changed", flush=True)
    return state


def time_c4_digital_parts(cfg, state):
    """``--profile``: the digital LiDAR's plain parts at the learner's shapes
    (batch 128 x 256 BEV tokens against 256 codes of dimension 32), beside
    the learn step they sit in: the nearest-code search without and with
    the re-seeding statistics (``torch.bincount`` reads the codes' maximum
    back to the host) as device and host times, and ``code_rows``'
    backward, the one-hot f64 GEMM, with its bound."""
    import torch

    from multimodal_sc_torch.codec import semantic_vq
    from multimodal_sc_torch.rl import dqn, replay

    bs, lid = cfg.rl.batch_size, cfg.lidar
    idx = torch.arange(bs, device="cuda")
    batch = dqn.dequantize_obs(cfg, replay.sample(state.buffer, None, bs,
                                                  idx))
    per = state.params.perception
    with torch.no_grad():
        bev = per.lid_backbone(per.pfn(batch.points[:, :cfg.env.lidar_rays],
                                       batch.mask[:, :cfg.env.lidar_rays]))
        z_e = per.lid_to_code(bev).float()
    cb = per.lid_codebook.detach()
    n, d, k = z_e.numel() // lid.vq_dim, lid.vq_dim, lid.vq_codes
    codes = semantic_vq.vector_quantize(z_e, cb)[1].reshape(-1).long()
    book = cb.clone().requires_grad_(True)
    grad = torch.randn(n, d, device="cuda")

    def search(stats):
        with torch.no_grad():
            semantic_vq.vector_quantize(z_e, cb, lid.vq_beta,
                                        lid.vq_usage_coef, lid.vq_usage_temp,
                                        with_stats=stats)

    draws = dqn.draw_learn(cfg, state.buffer.size, state.generator, "cuda")
    forward = dqn.learner_forward(cfg)
    def learn():
        dqn.learn_step(cfg, state, batch, draws, forward)

    rows = [
        ("learn step (host wall)", _ms(learn, iters=5), None, None),
        ("nearest-code search, no statistics", _device_ms(
            lambda: search(False)), *_bound_ms(
                2.0 * n * k * d, 4 * (n * d + k * d + n + n * d), PEAK_F32)),
        ("nearest-code search with the re-seeding statistics", _device_ms(
            lambda: search(True)), None, None),
        ("  the same, host wall", _ms(lambda: search(True)), None, None),
        ("  without them, host wall", _ms(lambda: search(False)), None,
         None),
        ("code_rows backward (one-hot f64 GEMM)", _device_ms(
            lambda: torch.autograd.grad(semantic_vq.code_rows(book, codes),
                                        book, grad)),
         *_bound_ms(2.0 * n * k * d, 4 * n * d + 8 * n + 4 * k * d,
                    PEAK_F64))]
    print(f"  c4_digital parts at the learner's LiDAR shape ({n} tokens, "
          f"{k} codes of {d}), ms:", flush=True)
    for what, ms, bound, by in rows:
        tail = (f"; bound {bound:.4f} ms ({by})" if bound is not None
                else "")
        print(f"    {what}: {ms:.4f}{tail}", flush=True)
    print("  the learn step alone, its device time by kernel:", flush=True)
    _idle_share(learn, rows[0][1], n=5)


def drive_c4_digital_v2x_harq():
    """Full-digital fog + V2X act-only at 1024 envs under Type-I HARQ on
    all three links, then one forward on the carried observations whose
    link accounting, summed over the camera, ego and RSU links, must lie at
    or above the one-shot floor. Returns the launches."""
    import torch

    from multimodal_sc_torch.rl import dqn

    name = "c4_digital fog + V2X, HARQ"
    launches, _, cfg, state, _ = drive_main_path(
        name, C4_DIGITAL_V2X_HARQ, EXPECTED_C4_DIGITAL_V2X)
    aux = {}
    with torch.no_grad():
        state.params(dqn.dequantize_image(state.obs_image), state.obs_points,
                     state.obs_mask, generator=state.generator, aux=aux)
    syms, rounds = float(aux["harq_syms"]), float(aux["harq_rounds"])
    resid = float(aux["harq_resid"])
    if not (syms >= ONE_SHOT_SYMS_V2X and rounds >= 1.0
            and 0.0 <= resid <= 1.0):
        raise RuntimeError(f"{name}: link accounting {syms} symbols, "
                           f"{rounds} rounds, {resid} residual failures")
    print(f"  {name}: {syms:.1f} symbols a step over the 3 links (one-shot "
          f"floor {ONE_SHOT_SYMS_V2X}), mean rounds {rounds:.4f}, residual "
          f"failures {resid:.4f}", flush=True)
    return launches


def drive_c4_digital_prune():
    """The pruned digital LiDAR deployed at half its tokens by the
    farthest-point order: one act step, then one act+learn iteration (its
    learn step trains at random kept fractions), launching as c4_digital's
    act and act+learn iterations. Returns the launches."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.rl import dqn

    name = "c4_digital pruned, token_keep 0.5 scatter"
    cfg = get_preset("c4").override_str(C4_DIGITAL_PRUNE).validate()
    state = _init_dqn(cfg)
    iteration = dqn.make_iteration(cfg)
    totals = {}
    for i in range(cfg.rl.n_step):
        _reset_counts()
        state, metrics = iteration(state)
        torch.cuda.synchronize()
        ran = _read_counts()
        learned = i == cfg.rl.n_step - 1
        _check_counts(ran, EXPECTED_C4_DIGITAL_LEARN if learned
                      else EXPECTED_C4_DIGITAL, 1, name)
        totals = {k: totals.get(k, 0) + v for k, v in ran.items()}
    loss = float(metrics["loss"])
    if state.step != 1 or not math.isfinite(loss) or loss == 0:
        raise RuntimeError(f"{name}: step {state.step}, loss {loss}")
    obs = (dqn.dequantize_image(state.obs_image), state.obs_points,
           state.obs_mask)
    noise = _link_noise(cfg, NUM_ENVS, torch.Generator(
        device="cuda").manual_seed(17))
    with torch.no_grad():
        q_half = state.params(*obs, channel_noise=noise)
        q_full = state.params(*obs, channel_noise=noise,
                              lidar_keep=torch.ones(NUM_ENVS, device="cuda"))
    gap = (q_half - q_full).abs().max().item()
    if not (torch.isfinite(q_half).all() and gap > 0):
        raise RuntimeError(f"{name}: Q at half the tokens vs all: {gap}")
    print(f"  {name}: one act step and one act+learn iteration, launches "
          f"{totals}; loss {loss:.4f}; Q at half the BEV tokens vs all of "
          f"them: largest difference {gap:.3e}", flush=True)
    return totals


def drive_c3(name, overrides, expected):
    """The c3 late-fusion train step at the preset's full widths through
    ``train.fusion_jscc`` (a digital LiDAR codec's codebook seeded as a
    fresh run seeds it): returns the launches of the timed run, the train
    steps/s, and the config, state, train step and batch stream it ended
    with."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.train import fusion_jscc as fj

    cfg = get_preset("c3").override_str(overrides)
    if cfg.train.batch_size != C3_BATCH:
        raise RuntimeError(f"c3 batch size {cfg.train.batch_size}")
    vq = cfg.lidar.arch == "vq"
    t0 = time.perf_counter()
    state = fj.create_train_state(cfg, seed=0, device="cuda")
    if vq:
        fj.seed_lidar_codebook(cfg, state.params, "cuda")
        codebook = state.params.lidar.codebook.detach().clone()
    train_step = fj.make_train_step(cfg)
    batches = fj.make_batches(cfg, "cuda")
    before = _clone_params(state.params)
    state, first = train_step(state, *next(batches))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for _ in range(C3_WARMUP_STEPS - 1):
        state, _ = train_step(state, *next(batches))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"  {n_params} parameters; init + first step {first_s:.2f} s", flush=True)

    _reset_counts()
    t0 = time.perf_counter()
    history = []
    for _ in range(C3_TIMED_STEPS):
        state, metrics = train_step(state, *next(batches))
        history.append(metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()

    rate = C3_TIMED_STEPS / wall
    print(f"  c3 train ({name}): {C3_TIMED_STEPS} steps x batch {C3_BATCH} in "
          f"{wall:.3f} s = {rate:.2f} train steps/s", flush=True)
    print(f"  launches in the timed run: {launches}", flush=True)
    print(f"  first step: " + ", ".join(
        f"{k}={float(v):.4f}" for k, v in first.items()), flush=True)
    print(f"  last step:  " + ", ".join(
        f"{k}={float(v):.4f}" for k, v in metrics.items()), flush=True)
    _check_counts(launches, expected, C3_TIMED_STEPS, name)
    for m in [first] + history:
        if not all(torch.isfinite(v).all() for v in m.values()):
            raise RuntimeError(f"{name}: non-finite metrics: {m}")
    if state.step != C3_WARMUP_STEPS + C3_TIMED_STEPS:
        raise RuntimeError(f"{name}: step {state.step}")
    if _same(state.params, before):
        raise RuntimeError(f"{name}: the parameters did not change")
    if vq and torch.equal(state.params.lidar.codebook, codebook):
        raise RuntimeError(f"{name}: the LiDAR codebook did not change")
    if not float(metrics["loss"]) < float(first["loss"]):
        raise RuntimeError(
            f"{name}: loss {float(metrics['loss']):.4f} after "
            f"{state.step} steps, not below the first step's "
            f"{float(first['loss']):.4f}")
    recon_shape = (C3_BATCH, *cfg.camera.image_hw, 3)
    with torch.no_grad():
        img, pts, mask, _ = next(batches)
        snr = torch.full((C3_BATCH,), cfg.channel.snr_db, device="cuda")
        recon, logits, _ = state.params(img, pts, mask, snr, state.generator)
    want_logits = (C3_BATCH, *cfg.lidar.bev_hw, cfg.lidar.seg_classes)
    if recon.shape != recon_shape or logits.shape != want_logits:
        raise RuntimeError(f"{name}: outputs {tuple(recon.shape)}, "
                           f"{tuple(logits.shape)}")
    print(f"  loss {float(first['loss']):.4f} -> {float(metrics['loss']):.4f}, "
          f"PSNR {float(first['psnr']):.2f} -> {float(metrics['psnr']):.2f} dB, "
          f"mIoU {float(first['miou']):.3f} -> {float(metrics['miou']):.3f}; "
          f"reconstruction {tuple(recon.shape)}, BEV logits "
          f"{tuple(logits.shape)}", flush=True)
    return launches, rate, cfg, state, train_step, batches


def _plain_attention(q, k, v, scale=None, use_pallas=False):
    from multimodal_sc_torch.kernels.attention import attention_reference

    return attention_reference(q, k, v, scale)


def compare_c3_routes(cfg, state, batches, expected):
    """One c3 loss and its gradients on a fixed batch and fixed channel
    noise, twice: through the kernels (packed attention in its f32 mode;
    the conv kernel on the CNN camera codec) and through every kernel's
    plain version; with a digital LiDAR codec both on the codes the
    kernels' route picks (``_vq_routes``)."""
    import torch

    from multimodal_sc_torch.channel.digital import index_bits
    from multimodal_sc_torch.codec import camera_vit, lidar_bev
    from multimodal_sc_torch.kernels import (attention_packed, conv_block,
                                             pillar_scatter)
    from multimodal_sc_torch.train import fusion_jscc as fj

    img, pts, mask, cls = next(batches)
    g = torch.Generator(device="cuda").manual_seed(8)
    model = state.params
    vq = cfg.lidar.arch == "vq"
    n_lid = (model.lidar.n_tokens * index_bits(model.lidar.vq_codes) // 2
             if vq else model.lidar.k)
    noise = tuple(torch.randn(C3_BATCH, n, 2, generator=g, device="cuda")
                  for n in (model.camera.k, n_lid))
    snr = torch.full((C3_BATCH,), cfg.channel.snr_db, device="cuda")
    target = fj.bev_target(cfg, pts, mask, cls)
    params = list(model.parameters())

    def loss_and_grads():
        loss, _ = fj.loss_fn(cfg, model, img, pts, mask, target, snr,
                             channel_noise=noise)
        return loss.detach(), torch.autograd.grad(loss, params)

    _compare_grads("train step", model, *(_vq_routes if vq else _two_routes)(
        loss_and_grads, expected, "the c3 train step",
        [(camera_vit, "packed_attention",
          attention_packed.packed_attention_reference),
         (camera_vit, "attention", _plain_attention),
         (conv_block, "conv_prelu", conv_block.conv_prelu_reference),
         (lidar_bev, "scatter_max", pillar_scatter.scatter_max_reference)],
        [(camera_vit, "packed_attention", functools.partial(
            attention_packed.packed_attention, mxu_bf16=False))]))


def drive_c5(name="c5", overrides=(), expected=EXPECTED_C5):
    """The c5 PPO update at the preset's full widths (with ``overrides``)
    through ``rl.ppo.make_train_step``, a digital trunk's codebooks seeded as
    ``train.ppo.run`` seeds a cold start: returns the launches of the timed
    run, the env steps/s, and the config, state and train step it ended
    with."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.rl import ppo
    from multimodal_sc_torch.rl.warmstart import cold_start

    cfg = get_preset("c5").override_str(overrides)
    r = cfg.rl
    if (r.rollout_length, r.num_envs,
            r.ppo_epochs * r.num_minibatches) != (C5_T, C5_ENVS,
                                                  C5_MINIBATCH_STEPS):
        raise RuntimeError(f"c5 preset: {r}")
    t0 = time.perf_counter()
    state = ppo.init(cfg, seed=0, device="cuda")
    cold_start(cfg, (state.params, state.ema_params))
    train_step = ppo.make_train_step(cfg)
    for _ in range(C5_WARMUP_UPDATES):
        state, first = train_step(state)
    torch.cuda.synchronize()
    print(f"  init + {C5_WARMUP_UPDATES} warm-up update(s): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    online0 = _clone_params(state.params)
    ema0 = _clone_params(state.ema_params)
    _reset_counts()
    t0 = time.perf_counter()
    history = []
    for _ in range(C5_TIMED_UPDATES):
        state, metrics = train_step(state)
        history.append(metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()

    rate = C5_TIMED_UPDATES * C5_T * C5_ENVS / wall
    print(f"  {name} PPO: {C5_TIMED_UPDATES} updates x {C5_T} steps x {C5_ENVS} "
          f"envs in {wall:.3f} s = {rate:.1f} env steps/s "
          f"({wall / C5_TIMED_UPDATES:.3f} s an update)", flush=True)
    print(f"  launches in the timed run: {launches}", flush=True)
    print(f"  metrics: " + ", ".join(
        f"{k}={float(v):.4f}" for k, v in metrics.items()), flush=True)
    _check_counts(launches, expected, C5_TIMED_UPDATES, name)
    for m in [first] + history:
        if not all(torch.isfinite(v).all() for v in m.values()):
            raise RuntimeError(f"c5: non-finite metrics: {m}")
    if not 0 < float(metrics["entropy"]) <= math.log(r.num_actions) + 1e-4:
        raise RuntimeError(f"c5: entropy {float(metrics['entropy'])}")
    if state.update != C5_WARMUP_UPDATES + C5_TIMED_UPDATES:
        raise RuntimeError(f"c5: update {state.update}")
    if _same(state.params, online0):
        raise RuntimeError("c5: the parameters did not change")
    if _same(state.ema_params, ema0):
        raise RuntimeError("c5: the EMA did not move")
    if any(p.grad is not None for p in state.params.parameters()):
        raise RuntimeError("c5: gradients left on the network")
    from multimodal_sc_torch.envs import driving

    with torch.no_grad():
        img, pts, mask = driving.observe_batch(cfg.env, state.env_states)
        logits, value = state.params(img, pts, mask, state.generator)
    if (logits.shape != (C5_ENVS, r.num_actions) or value.shape != (C5_ENVS,)
            or not (torch.isfinite(logits).all()
                    and torch.isfinite(value).all())):
        raise RuntimeError(f"c5: logits {tuple(logits.shape)}, value "
                           f"{tuple(value.shape)}")
    print(f"  logits {tuple(logits.shape)} and values {tuple(value.shape)} "
          f"finite, mean value {value.mean().item():.4f}; episode return "
          f"{float(first['episode_return']):.2f} -> "
          f"{float(metrics['episode_return']):.2f}", flush=True)
    return launches, rate, cfg, state, train_step


def _c5_minibatches(cfg, state):
    """Two loss minibatches as the update makes them: a rollout of the
    current policy, GAE from the bootstrap value, the first and the second
    512 transitions."""
    import torch

    from multimodal_sc_torch.rl import gae, ppo

    r = cfg.rl
    g = state.generator
    _, _, _, ro, (img, pts, mask) = ppo._collect_rollout(
        cfg, state.params, state.env_states, state.ep_return,
        state.last_return, g)
    with torch.no_grad():
        _, _, last_value = ppo.act(cfg, state.params, img, pts, mask, g)
    adv, ret = gae.gae(ro.reward, ro.value, ro.done, last_value, r.gamma,
                       r.gae_lambda)
    flat = {"image": ro.image, "points": ro.points, "mask": ro.mask,
            "action": ro.action, "logp": ro.logp, "adv": adv, "ret": ret,
            "snr": ro.snr_db}
    n = C5_T * C5_ENVS
    flat = {k: v.reshape(n, *v.shape[2:]) for k, v in flat.items()}
    return [{k: v[i * C5_LOSS_BATCH:(i + 1) * C5_LOSS_BATCH]
             for k, v in flat.items()} for i in range(2)]


def compare_c5_routes(cfg, state):
    """One PPO minibatch loss and its gradients on a fixed minibatch and
    fixed channel noise, three times: as the update runs it (conv and
    scatter kernels, the fused blocks on their plain version), through
    every kernel's plain version, and through the plain versions in f64 on
    an f64 copy of the network, the witness of both f32 routes' rounding.
    Two minibatches."""
    import copy

    import torch

    from multimodal_sc_torch.codec import lidar_bev
    from multimodal_sc_torch.kernels import conv_block, pillar_scatter
    from multimodal_sc_torch.rl import dqn, ppo
    from multimodal_sc_torch.rl.perception import ActorCritic

    from multimodal_sc_torch.codec import semantic_vq

    g = torch.Generator(device="cuda").manual_seed(9)
    forward = dqn.learner_forward(cfg, ActorCritic)
    net = state.params
    net64 = copy.deepcopy(net).double()
    # The modules convert their inputs to their activation dtype: f64 here.
    # The fused blocks run on their plain version, as the learner's forward
    # runs them.
    for m in net64.modules():
        for attr in ("dtype", "act_dtype"):
            if getattr(m, attr, None) == torch.float32:
                setattr(m, attr, torch.float64)
        if hasattr(m, "use_kernel"):
            m.use_kernel = False
    coef = ppo._entropy_coef(cfg, state.update)
    plain = [(conv_block, "conv_prelu", conv_block.conv_prelu_reference),
             (lidar_bev, "scatter_max", pillar_scatter.scatter_max_reference)]
    convs = 4 if cfg.camera.arch == "vq" else 5
    expected = {"conv_prelu": convs, "scatter_max": 1, "scatter_max_bwd": 1}
    digital = cfg.camera.arch == "vq" or cfg.lidar.arch == "vq"

    def loss_and_grads(model, batch, noise, fwd=forward):
        loss, _ = ppo._ppo_loss(cfg, fwd, model, batch, coef,
                                channel_noise=noise)
        return loss.detach(), torch.autograd.grad(
            loss, list(model.parameters()), allow_unused=True)

    for i, batch in enumerate(_c5_minibatches(cfg, state)):
        noise = _link_noise(cfg, C5_LOSS_BATCH, g)
        # Over a digital link all three routes quantise to the codes the
        # kernels' route picks (``_HeldCodes``).
        held = _HeldCodes()
        with (mock.patch.object(semantic_vq, "vector_quantize", held)
              if digital else contextlib.nullcontext()):
            def kernels_first():
                out = loss_and_grads(net, batch, noise)
                held.mode = "hold"
                return out

            routes = _two_routes(kernels_first, expected, "the c5 loss",
                                 plain)
            held.i = 0
            # The port's f32 outputs come from .float(); here it keeps
            # f64.
            before = _read_counts()
            with _patched(plain), mock.patch.object(
                    torch.Tensor, "float", lambda t: t.double()):
                loss_d, grads_d = loss_and_grads(
                    net64, {k: v.double() if v.is_floating_point() else v
                            for k, v in batch.items()},
                    tuple(z.double() for z in noise),
                    lambda model, *a, **kw: model(*a, **kw))
            torch.cuda.synchronize()
        if _read_counts() != before:
            raise RuntimeError("the f64 route of the c5 loss launched a "
                               "kernel")
        if digital:
            print(f"  PPO minibatch {i}: the plain and f64 routes picked the "
                  f"kernels' route's codes at all but {held.held} of "
                  f"{2 * sum(c.numel() for c in held.codes)} tokens "
                  "(near-ties)", flush=True)
        _hold_to_f64(f"PPO minibatch {i}", net, *routes, loss_d, grads_d)
        # The value loss makes these gradients 1e3-1e4 times the c4 learn
        # step's, and a weight's gradient is a sum over 512 x 64 positions
        # with cancellation: f32 rounding alone puts the plain route up to
        # 3.1e-3 of a tensor's largest entry from f64, so atol scales with
        # the tensor. The two f32 routes share most of their rounding.
        _compare_grads(f"PPO minibatch {i}", net, *routes,
                       of_tensor_max=1e-3)


def _hold_to_f64(what, net, loss_k, grads_k, loss_p, grads_p, loss_d,
                 grads_d):
    """Holds the kernels' f32 route (k) to the f64 route, with the plain f32
    route (p) as the yardstick of f32 rounding: every entry of a k gradient
    within 1e-5 + 1e-3 |f64| + f * (p's largest difference from f64 on that
    tensor) of f64, f at most 2. Prints both routes' distance from f64 and
    the tensors of largest f."""
    rows = []
    for (pname, _), gk, gp, gd in zip(net.named_parameters(), grads_k,
                                      grads_p, grads_d):
        if gd is None:
            continue
        ek = (gk.double() - gd).abs()
        ep = (gp.double() - gd).abs().max().item()
        excess = (ek - 1e-5 - 1e-3 * gd.abs()).clamp(min=0).max().item()
        f = excess / ep if ep > 0 else (math.inf if excess > 0 else 0.0)
        rows.append((f, ek.max().item(), ep, gd.abs().max().item(), pname))
    print(f"  {what}, f32 routes against f64: loss k "
          f"{loss_k.item() - loss_d.item():+.3e}, p "
          f"{loss_p.item() - loss_d.item():+.3e}; worst gradient difference "
          f"k {max(r[1] for r in rows):.3e}, p {max(r[2] for r in rows):.3e} "
          f"absolute, {max(r[2] / r[3] for r in rows if r[3] > 1e-4):.2e} of "
          f"its tensor's largest entry for p (tensors above 1e-4)",
          flush=True)
    shown = sorted(rows, reverse=True)[:6] + [
        r for r in rows if r[4] == "perception.cam_tok.conv_in.weight"]
    for f, ek, ep, top, pname in shown:
        print(f"    {pname}: f {f:.3f}, k {ek:.3e}, p {ep:.3e}, largest "
              f"entry {top:.3e}", flush=True)
    if shown[0][0] > 2.0:
        raise RuntimeError(f"{what}: {shown[0][4]}: the kernels' route lies "
                           f"{shown[0][0]:.3f} times the plain f32 route's "
                           "distance from f64 past the gate (at most 2)")


def _patched(patches):
    stack = contextlib.ExitStack()
    for mod, name, fn in patches:
        stack.enter_context(mock.patch.object(mod, name, fn))
    return stack


class _HeldCodes:
    """A stand-in for ``semantic_vq.vector_quantize`` that holds a route
    comparison to one set of codes. The kernels' route records the codes
    its own nearest-code search picks (``record``); the plain route then
    quantises to those codes (``hold``). Its own pick may differ only where
    the two codes lie at a near-tie, within ``tie`` of the distances' scale
    (1e-5 where the routes' features differ by f32 rounding, ``BF16_TIE``
    under train.bf16); anywhere else it raises. ``held`` counts the codes
    taken over from the first route, ``worst`` their largest gap."""

    def __init__(self, tie=1e-5):
        from multimodal_sc_torch.codec import semantic_vq

        self.orig = semantic_vq.vector_quantize
        self.codes, self.mode, self.i, self.held = [], "record", 0, 0
        self.tie, self.worst = tie, 0.0

    def __call__(self, z_e, codebook, beta=0.25, usage_coef=0.0,
                 usage_temp=0.5, with_stats=False, mesh=None):
        import torch

        from multimodal_sc_torch.codec import semantic_vq

        out = self.orig(z_e, codebook, beta, usage_coef, usage_temp,
                        with_stats, mesh)
        if self.mode == "record":
            self.codes.append(out[1])
            return out
        want = self.codes[self.i]
        self.i += 1
        if torch.equal(out[1], want):
            return out
        flat = z_e.detach().reshape(-1, codebook.shape[1])
        cb = codebook.detach()
        d2 = ((flat * flat).sum(1, keepdim=True) - 2.0 * flat @ cb.T
              + (cb * cb).sum(1)[None, :])
        own, held = out[1].reshape(-1).long(), want.reshape(-1).long()
        pos = (own != held).nonzero()[:, 0]
        gap = (d2[pos, held[pos]] - d2[pos, own[pos]]).abs()
        scale = (flat[pos] ** 2).sum(1) + (cb[held[pos]] ** 2).sum(1)
        worst = (gap / scale).max().item()
        if worst > self.tie:
            raise RuntimeError(
                f"the routes picked {pos.numel()} different codes, not all "
                f"at near-ties (largest gap {worst:.3e} of the distances' "
                f"scale, past {self.tie:.3e})")
        self.held += pos.numel()
        self.worst = max(self.worst, worst)
        z_q = semantic_vq.code_rows(codebook, held).reshape(z_e.shape)
        z_q_own = semantic_vq.code_rows(codebook, own).reshape(z_e.shape)
        # The same loss terms on the held codes (the usage term does not
        # depend on the pick).
        loss = (out[2] - (z_e.detach() - z_q_own).square().mean()
                - beta * (z_e - z_q_own.detach()).square().mean()
                + (z_e.detach() - z_q).square().mean()
                + beta * (z_e - z_q.detach()).square().mean())
        z_ste = z_e + (z_q - z_e).detach()
        return (z_ste, want, loss) + tuple(out[3:])


def _vq_routes(loss_and_grads, expected, what, plain_patches,
               kernel_patches=(), tie=1e-5):
    """``_two_routes`` for a loss with a VQ bottleneck: the plain route is
    held to the codes the kernels' route picked (``_HeldCodes`` with its
    near-tie bound ``tie``); prints how many were held at near-ties."""
    from multimodal_sc_torch.codec import semantic_vq

    held = _HeldCodes(tie)
    with mock.patch.object(semantic_vq, "vector_quantize", held):
        def both():
            out = loss_and_grads()
            held.mode = "hold"
            return out

        routes = _two_routes(both, expected, what, plain_patches,
                             kernel_patches)
    print(f"  {what}: the plain route picked the kernels' route's codes at "
          f"all but {held.held} of "
          f"{sum(c.numel() for c in held.codes)} tokens (near-ties: largest "
          f"gap {held.worst:.3e} of the distances' scale, bound {tie:.3e})",
          flush=True)
    return routes


def _two_routes(loss_and_grads, expected, what, plain_patches,
                kernel_patches=()):
    """``loss_and_grads()`` through the kernels, with ``kernel_patches``
    (module, name, function) in place (it must launch as ``expected``),
    then with ``plain_patches`` (module, name, plain version) in place (it
    must launch nothing), TF32 off on both."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = _read_counts()
        with _patched(kernel_patches):
            loss_k, grads_k = loss_and_grads()
        torch.cuda.synchronize()
        ran = {k: v - before[k] for k, v in _read_counts().items()}
        _check_counts(ran, expected, 1, f"kernel route of {what}")
        before = _read_counts()
        with _patched(plain_patches):
            loss_p, grads_p = loss_and_grads()
        torch.cuda.synchronize()
        if _read_counts() != before:
            raise RuntimeError(f"the plain route of {what} launched a kernel")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    return loss_k, grads_k, loss_p, grads_p


def _compare_grads(what, net, loss_k, grads_k, loss_p, grads_p,
                   of_tensor_max=0.0):
    """Exact f32 on both routes (TF32 off), each kernel within 1e-4 of its
    plain version: loss 1e-5, gradients rtol 1e-3 and atol 1e-5 for the
    entries near zero, plus ``of_tensor_max`` times the tensor's largest
    entry."""
    import torch

    torch.testing.assert_close(loss_k, loss_p, atol=1e-5, rtol=1e-5)
    worst_abs = worst_rel = 0.0
    for (pname, _), gk, gp in zip(net.named_parameters(), grads_k, grads_p):
        if gk is None or gp is None:
            if gk is not gp:
                raise RuntimeError(f"{pname}: a gradient on one route only")
            continue
        atol = 1e-5 + of_tensor_max * gp.abs().max().item()
        torch.testing.assert_close(gk, gp, atol=atol, rtol=1e-3,
                                   msg=lambda m: f"{pname}: {m}")
        diff, top = (gk - gp).abs().max().item(), gp.abs().max().item()
        worst_abs = max(worst_abs, diff)
        if top > 1e-4:
            worst_rel = max(worst_rel, diff / top)
    print(f"  {what}, kernels vs plain versions: loss {loss_k.item():.6f} vs "
          f"{loss_p.item():.6f}; worst gradient difference {worst_abs:.2e} "
          f"absolute, {worst_rel:.2e} of its tensor's largest entry (tensors "
          f"above 1e-4), over {len(grads_k)} tensors", flush=True)


def drive_c1(overrides=(), expected=EXPECTED_C1, name="c1"):
    """The c1 CNN JSCC train step at the preset's full widths (batch 64,
    32x32) through ``train.jscc``: returns the launches of the timed run,
    the train steps/s, and the config, state, train step and batch stream
    it ended with."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.envs.datasets import ImageDataset
    from multimodal_sc_torch.train import jscc

    cfg = get_preset("c1").override_str(overrides)
    tr = cfg.train
    if tr.batch_size != C1_BATCH:
        raise RuntimeError(f"c1 batch size {tr.batch_size}")
    t0 = time.perf_counter()
    state = jscc.create_train_state(cfg, seed=0, device="cuda")
    train_step = jscc.make_train_step(cfg)
    data = ImageDataset(tr.dataset, tr.batch_size, seed=tr.seed,
                        device="cuda")
    before = _clone_params(state.params)
    state, first = train_step(state, next(data))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for _ in range(C1_WARMUP_STEPS - 1):
        state, _ = train_step(state, next(data))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"  {n_params} parameters; init + first step {first_s:.2f} s",
          flush=True)

    _reset_counts()
    t0 = time.perf_counter()
    history = []
    for _ in range(C1_TIMED_STEPS):
        state, metrics = train_step(state, next(data))
        history.append(metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()

    rate = C1_TIMED_STEPS / wall
    print(f"  {name} train: {C1_TIMED_STEPS} steps x batch {C1_BATCH} in "
          f"{wall:.3f} s = {rate:.2f} train steps/s", flush=True)
    print(f"  launches in the timed run: {launches}", flush=True)
    _check_counts(launches, expected, C1_TIMED_STEPS, name)
    for m in [first] + history:
        if not all(torch.isfinite(v).all() for v in m.values()):
            raise RuntimeError(f"c1: non-finite metrics: {m}")
    if state.step != C1_WARMUP_STEPS + C1_TIMED_STEPS:
        raise RuntimeError(f"c1: step {state.step}")
    if _same(state.params, before):
        raise RuntimeError("c1: the parameters did not change")
    if not float(metrics["loss"]) < float(first["loss"]):
        raise RuntimeError(
            f"c1: loss {float(metrics['loss']):.4f} after {state.step} "
            f"steps, not below the first step's {float(first['loss']):.4f}")
    # The held-out evaluation, as ``run`` makes it: one forward of 9 convs.
    eval_img = next(ImageDataset(tr.dataset, tr.batch_size,
                                 seed=tr.seed + 999, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(10)
    counts = _read_counts()
    eval_psnr = jscc.make_eval_step(cfg)(state.params, eval_img, g)
    with torch.no_grad():
        recon = state.params(eval_img)
    torch.cuda.synchronize()
    ran = {k: v - counts[k] for k, v in _read_counts().items()}
    _check_counts(ran, expected, 2, f"{name} eval and reconstruction")
    if recon.shape != eval_img.shape or not torch.isfinite(recon).all() or \
            not (0 <= recon.min() and recon.max() <= 1):
        raise RuntimeError(f"c1: reconstruction {tuple(recon.shape)}")
    print(f"  loss {float(first['loss']):.4f} -> {float(metrics['loss']):.4f}, "
          f"PSNR {float(first['psnr']):.2f} -> {float(metrics['psnr']):.2f} dB"
          f"; held-out PSNR {float(eval_psnr):.2f} dB; reconstruction "
          f"{tuple(recon.shape)} in [0, 1]", flush=True)
    return launches, rate, cfg, state, train_step, data


def compare_c1_routes(cfg, state, data):
    """One c1 loss and its gradients on a fixed batch and fixed channel
    noise, twice: through the conv kernel and through its plain version."""
    import torch

    from multimodal_sc_torch.kernels import conv_block
    from multimodal_sc_torch.train import jscc

    img = next(data)
    model = state.params
    g = torch.Generator(device="cuda").manual_seed(11)
    noise = torch.randn(C1_BATCH, model.k, 2, generator=g, device="cuda")
    snr = torch.full((C1_BATCH,), cfg.channel.snr_db, device="cuda")
    params = list(model.parameters())

    def loss_and_grads():
        recon, _ = jscc.reconstruct(cfg, model, img, snr, noise=noise)
        loss = (recon - img).square().mean()
        return loss.detach(), torch.autograd.grad(loss, params)

    _compare_grads("c1 train step", model, *_two_routes(
        loss_and_grads, EXPECTED_C1, "the c1 train step",
        [(conv_block, "conv_prelu", conv_block.conv_prelu_reference)]))


def drive_c1_vq(overrides=C1_VQ, expected=EXPECTED_C1_VQ, name="c1_vq"):
    """The c1_vq train step (``--config c1 --set camera.arch=vq``: 256 codes
    of dimension 64 over QPSK, batch 64, 32x32) through ``train.jscc``, its
    codebook seeded from a real batch as a fresh run seeds it, the timed
    steps inside an ``annotate`` scope: returns the launches of the timed
    run, the train steps/s, and the config, state, train step and batch
    stream it ended with."""
    import torch

    from multimodal_sc_torch.codec.semantic_vq import init_codebook_from_batch
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.envs.datasets import ImageDataset
    from multimodal_sc_torch.obs import annotate
    from multimodal_sc_torch.train import jscc

    cfg = get_preset("c1").override_str(overrides)
    tr = cfg.train
    t0 = time.perf_counter()
    state = jscc.create_train_state(cfg, seed=0, device="cuda")
    train_step = jscc.make_train_step(cfg)
    data = ImageDataset(tr.dataset, tr.batch_size, seed=tr.seed,
                        device="cuda")
    init_codebook_from_batch(state.params, next(ImageDataset(
        tr.dataset, tr.batch_size, seed=tr.seed + 777, device="cuda")),
        torch.Generator(device="cuda").manual_seed(0xCB))
    before = _clone_params(state.params)
    state, first = train_step(state, next(data))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for _ in range(C1_VQ_WARMUP_STEPS - 1):
        state, _ = train_step(state, next(data))
    torch.cuda.synchronize()
    print(f"  {sum(p.numel() for p in state.params.parameters())} "
          f"parameters; init, codebook seeding and first step {first_s:.2f} "
          "s", flush=True)

    _reset_counts()
    t0 = time.perf_counter()
    history = []
    with annotate(f"{name} train steps"):
        for _ in range(C1_VQ_TIMED_STEPS):
            state, metrics = train_step(state, next(data))
            history.append(metrics)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    rate = C1_VQ_TIMED_STEPS / wall
    print(f"  {name} train: {C1_VQ_TIMED_STEPS} steps x batch {C1_BATCH} in "
          f"{wall:.3f} s = {rate:.2f} train steps/s", flush=True)
    print(f"  launches in the timed run: {launches}", flush=True)
    _check_counts(launches, expected, C1_VQ_TIMED_STEPS, name)
    while state.step < C1_VQ_LOSS_STEPS:
        state, metrics = train_step(state, next(data))
        history.append(metrics)
    for m in [first] + history:
        if not all(torch.isfinite(v).all() for v in m.values()):
            raise RuntimeError(f"{name}: non-finite metrics: {m}")
    if _same(state.params, before):
        raise RuntimeError(f"{name}: the parameters did not change")
    last = torch.stack([m["loss"] for m in history[-20:]]).mean()
    if not float(last) < float(first["loss"]):
        raise RuntimeError(
            f"{name}: mean loss of steps {state.step - 19}-{state.step} "
            f"{float(last):.4f}, not below the first step's "
            f"{float(first['loss']):.4f}")
    eval_img = next(ImageDataset(tr.dataset, tr.batch_size,
                                 seed=tr.seed + 999, device="cuda"))
    counts = _read_counts()
    eval_psnr = jscc.make_eval_step(cfg)(
        state.params, eval_img, torch.Generator(device="cuda").manual_seed(10))
    torch.cuda.synchronize()
    ran = {k: v - counts[k] for k, v in _read_counts().items()}
    _check_counts(ran, expected, 1, f"{name} eval")
    print(f"  loss {float(first['loss']):.4f} -> {float(last):.4f} (mean "
          f"of the last 20 of {state.step} steps), PSNR "
          f"{float(first['psnr']):.2f} -> "
          f"{float(metrics['psnr']):.2f} dB, perplexity "
          f"{float(metrics['code_perplexity']):.1f}, index errors "
          f"{float(metrics['index_error_rate']):.4f}; held-out PSNR "
          f"{float(eval_psnr):.2f} dB at {cfg.channel.snr_db} dB", flush=True)
    return launches, rate, cfg, state, train_step, data


def compare_c1_vq_routes(cfg, state, data):
    """One c1_vq loss (MSE + VQ loss) and its gradients on a fixed batch and
    fixed channel noise, through the conv kernel and through its plain
    version, both on the codes the kernel's route picks (``_vq_routes``)."""
    import torch

    from multimodal_sc_torch.kernels import conv_block

    img = next(data)
    model = state.params
    g = torch.Generator(device="cuda").manual_seed(11)
    noise = torch.randn(C1_BATCH, model.bits_per_image // 2, 2, generator=g,
                        device="cuda")
    snr = torch.full((C1_BATCH,), cfg.channel.snr_db, device="cuda")
    params = list(model.parameters())

    def loss_and_grads():
        recon, aux = model(img, snr, noise=noise)
        loss = (recon - img).square().mean() + aux["vq_loss"]
        return loss.detach(), torch.autograd.grad(loss, params)

    _compare_grads("c1_vq train step", model, *_vq_routes(
        loss_and_grads, EXPECTED_C1_VQ, "the c1_vq train step",
        [(conv_block, "conv_prelu", conv_block.conv_prelu_reference)]))


def sweep_c1_vq(cfg, state):
    """One point of each deployment of the c1_vq state at 5 dB over AWGN
    (uncoded, Hamming hard, Hamming soft, Type-I HARQ) on the held-out
    batch, each swept twice from the same seed: the results must be
    bit-equal. Returns the launches."""
    import torch

    from multimodal_sc_torch.envs.datasets import ImageDataset
    from multimodal_sc_torch.evaluation import snr_sweep

    tr = cfg.train
    images = next(ImageDataset(tr.dataset, tr.batch_size, seed=tr.seed + 999,
                               device="cuda"))
    kw = dict(snrs_db=(C1_VQ_SWEEP_SNR,), kinds=("awgn",),
              batches_per_point=1)
    _reset_counts()
    t0 = time.perf_counter()
    rows = {}
    for fec in ("none", "hamming74", "hamming74_soft", "harq"):
        runs = []
        for _ in range(2):
            if fec == "harq":
                runs.append(snr_sweep.sweep_camera_vq_harq(
                    cfg, state.params, images, tr.seed, **kw))
            else:
                runs.append(snr_sweep.sweep_camera_vq(
                    cfg.override_str([f"channel.fec={fec}"]), state.params,
                    images, tr.seed, **kw))
        if runs[0] != runs[1]:
            raise RuntimeError(f"c1_vq sweep ({fec}): two runs from one seed "
                               f"differ: {runs}")
        rows[fec] = runs[0]["awgn"][0]
        if not all(math.isfinite(v) for v in rows[fec].values()):
            raise RuntimeError(f"c1_vq sweep ({fec}): {rows[fec]}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    _check_counts(launches, EXPECTED_C1_VQ, 8, "c1_vq sweeps")
    for fec, row in rows.items():
        print(f"  {fec} at {C1_VQ_SWEEP_SNR} dB: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k != "snr_db")
            + "; bit-equal on a second run", flush=True)
    print(f"  8 sweep runs in {wall:.2f} s; launches {launches}", flush=True)
    return launches


def c3_checkpoint_round_trip(ckpt_dir, cfg, state, batches):
    """A c3 train state (c3_vq after its timed steps): saved, restored into
    a fresh state of another seed, every entry compared bit for bit; then
    one train step from each on one batch, compared again. cuDNN is held to
    deterministic algorithms in this phase (the BEV convs' backward)."""
    import torch

    from multimodal_sc_torch.io.checkpoint import CheckpointManager
    from multimodal_sc_torch.train import fusion_jscc as fj

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mgr = CheckpointManager(ckpt_dir)
        mgr.save_config(cfg.to_json())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(state.step, state)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(ckpt_dir,
                                            f"ckpt_{state.step}.pt"))
        restored = mgr.restore_latest(fj.create_train_state(cfg, seed=1,
                                                            device="cuda"))
        n, differ, _ = _state_diff(state, restored)
        if differ:
            raise RuntimeError(f"c3 checkpoint round trip: {len(differ)} of "
                               f"{n} entries differ, e.g. {differ[:5]}")
        print(f"  ckpt_save_s {save_s:.2f} for {size / 2**20:.1f} MiB; {n} "
              "entries restored bit for bit", flush=True)
        batch = next(batches)
        train_step = fj.make_train_step(cfg)
        state, _ = train_step(state, *batch)
        restored, _ = train_step(restored, *batch)
        torch.cuda.synchronize()
        n, differ, worst = _state_diff(state, restored)
        if differ:
            raise RuntimeError(
                f"one step from the restored c3 state: {len(differ)} of {n} "
                f"entries differ from the original's (largest float "
                f"difference {worst:.3e}), e.g. {differ[:5]}")
        print(f"  one train step from each: all {n} entries bit-equal",
              flush=True)
    finally:
        torch.backends.cudnn.deterministic = saved


def time_digital_parts(cfg, state, batches):
    """Device times of the digital LiDAR link's plain parts at the c3_vq
    step's shapes (the B x 32 x 32 tokens of the BEV grid), each beside its
    bound: the nearest-code search (a (65536, 32) x (32, 256) distance
    matmul, its argmin and the straight-through rows), the link (indices ->
    QPSK -> AWGN -> decisions), ``code_rows``' backward (the one-hot f64
    GEMM); the drop-damage probes of one call, and the host's
    ``decode_vlc_np`` of one entropy-sweep point."""
    import numpy as np
    import torch

    from multimodal_sc_torch.channel import entropy_coding
    from multimodal_sc_torch.channel.digital import qpsk_to_bits
    from multimodal_sc_torch.codec import semantic_vq

    img, pts, mask, cls = next(batches)
    lid = state.params.lidar
    with torch.no_grad():
        z_e = lid.encode_features(pts, mask)
        idx = lid.encode_tokens(pts, mask)[0]
    n, d = z_e.numel() // lid.vq_dim, lid.vq_dim
    k = lid.vq_codes
    snr = torch.full((C3_BATCH,), cfg.channel.snr_db, device="cuda")
    cb = lid.codebook.detach().clone().requires_grad_(True)
    grad = torch.randn(n, d, device="cuda")
    flat_idx = idx.reshape(-1).long()

    def code_rows_backward():
        torch.autograd.grad(semantic_vq.code_rows(cb, flat_idx), cb, grad)

    rows = []
    with torch.no_grad():
        rows.append(("nearest-code search", _device_ms(
            lambda: semantic_vq.vector_quantize(z_e, lid.codebook)),
            *_bound_ms(2.0 * n * k * d, 4 * (n * d + k * d + n + n * d),
                       PEAK_F32)))
        rows.append(("digital link (uncoded, AWGN)", _device_ms(
            lambda: semantic_vq.transmit_indices(cfg.channel, idx, k, snr)),
            *_bound_ms(0.0, 8 * idx.numel(), PEAK_F32)))
    rows.append(("code_rows backward (one-hot f64 GEMM)", _device_ms(
        code_rows_backward), *_bound_ms(
            2.0 * n * k * d, 4 * n * d + 8 * n + 4 * k * d, PEAK_F64)))
    probes = torch.randn((cfg.channel.uep_probes, C3_BATCH,
                          *cfg.lidar.bev_hw, cfg.lidar.seg_classes),
                         device="cuda")
    if hasattr(lid, "mask_embed"):
        rows.append(("BEV drop-damage probes, one call", _device_ms(
            lambda: lid.token_drop_damage(idx, probes), iters=5),
            None, None))
    for what, ms, bound, by in rows:
        tail = (f"; bound {bound:.4f} ms ({by})" if bound is not None
                else "")
        print(f"  {what}: {ms:.4f} ms{tail}", flush=True)
    probs = np.bincount(idx.cpu().numpy().ravel(), minlength=k) / idx.numel()
    codec = entropy_coding.build_huffman(probs, "cuda")
    bits, total = entropy_coding.encode_vlc(codec, idx)
    hard = qpsk_to_bits(entropy_coding.vlc_symbols(bits, total))
    t0 = time.perf_counter()
    out = entropy_coding.decode_vlc_np(codec, hard, total, idx.shape[1])
    host_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(out, idx.cpu().numpy()):
        raise RuntimeError("decode_vlc_np did not return the sent indices "
                           "from clean bits")
    print(f"  decode_vlc_np, one sweep point (B {C3_BATCH}, "
          f"{float(total.float().mean()):.0f} bits a row): {host_ms:.1f} ms "
          "of host time, the clean indices back", flush=True)


def drive_c3_vq_prune():
    """c3_vq_prune (``lidar.vq_prune=true``): one train step at the preset
    (kept fractions ~ U[vq_keep_min, 1), random selection), then one point
    of the BEV keep sweep under each selection rule (keep 0.5), of the SNR
    sweep uncoded and under soft Hamming(7,4) (5 dB: the soft link must
    err less), and of the entropy sweep (25 dB: the Huffman link must
    return the fixed link's mIoU, with no index error). Returns the
    launches."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.evaluation import snr_sweep
    from multimodal_sc_torch.train import fusion_jscc as fj

    cfg = get_preset("c3").override_str(C3_VQ_PRUNE)
    state = fj.create_train_state(cfg, seed=0, device="cuda")
    fj.seed_lidar_codebook(cfg, state.params, "cuda")
    train_step = fj.make_train_step(cfg)
    batches = fj.make_batches(cfg, "cuda")
    totals = {k: 0 for k in _counters()}
    _reset_counts()
    state, m = train_step(state, *next(batches))
    torch.cuda.synchronize()
    launches = _read_counts()
    _check_counts(launches, EXPECTED_C3_P, 1, "c3_vq_prune train step")
    kf = float(m["lidar_token_keep_frac"])
    if not all(torch.isfinite(v).all() for v in m.values()) or not (
            cfg.lidar.vq_keep_min - 1e-3 <= kf <= 1.0):
        raise RuntimeError(f"c3_vq_prune: metrics {m}")
    print("  train step: " + ", ".join(f"{k}={float(v):.4f}"
                                       for k, v in m.items()), flush=True)
    for k, v in launches.items():
        totals[k] += v
    img, pts, mask, cls = next(batches)
    target = fj.bev_target(cfg, pts, mask, cls)
    lid = state.params.lidar
    seed = cfg.train.seed
    _reset_counts()
    t0 = time.perf_counter()
    keep = snr_sweep.sweep_lidar_vq_keep(cfg, lid, pts, mask, target,
                                         seed + 0x6EEB, keeps=(0.5,),
                                         selects=BEV_SELECTS,
                                         batches_per_point=1)
    rows = {}
    for fec in ("none", "hamming74_soft"):
        rows[fec] = snr_sweep.sweep_lidar_vq(
            cfg.override_str([f"channel.fec={fec}"]), lid, pts, mask, target,
            seed + 0x11DA, snrs_db=(5.0,), kinds=("awgn",),
            batches_per_point=1)["awgn"][0]
    ent = snr_sweep.sweep_lidar_vq_entropy(
        cfg, lid, pts, mask, target, seed + 0xE27, snrs_db=(25.0,),
        kinds=("awgn",), batches_per_point=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    _check_counts(launches, EXPECTED_C3_VQ_SWEEPS, 1, "c3_vq_prune sweeps")
    for k, v in launches.items():
        totals[k] += v
    for sel, curve in keep.items():
        if curve[0]["keep_frac_actual"] != 0.5 or not math.isfinite(
                curve[0]["miou"]):
            raise RuntimeError(f"keep sweep ({sel}): {curve}")
        print(f"  keep 0.5, {sel}: mIoU {curve[0]['miou']:.4f}", flush=True)
    if not rows["hamming74_soft"]["index_err"] < rows["none"]["index_err"]:
        raise RuntimeError(f"soft FEC erred no less than uncoded: {rows}")
    e = ent["awgn"][0]
    if e["index_err_vlc"] != 0.0 or e["miou_vlc"] != e["miou_full"]:
        raise RuntimeError(f"entropy sweep at 25 dB: {e}")
    print(f"  5 dB AWGN: uncoded mIoU {rows['none']['miou']:.4f} (index "
          f"errors {rows['none']['index_err']:.4f}), soft Hamming "
          f"{rows['hamming74_soft']['miou']:.4f} "
          f"({rows['hamming74_soft']['index_err']:.4f})", flush=True)
    print(f"  entropy at 25 dB: calibration {ent['calibration']}; " + ", ".join(
        f"{k} {v:.4f}" for k, v in e.items() if k != "snr_db"), flush=True)
    print(f"  sweep points in {wall:.2f} s; launches {launches}", flush=True)
    time_digital_parts(cfg, state, batches)
    return totals


def drive_c1_vq_prune_uep(profile=False):
    """c1_vq_prune and c1_vq under UEP at the preset (batch 64): one train
    step each (the pruned one on kept fractions ~ U[vq_keep_min, 1) of
    random tokens, the UEP one with the damage probes in its forward), then
    one point of the camera keep sweep per selection rule (keep 0.25) and
    one UEP sweep point at 0 dB AWGN under alpha 0.25 and water-filling.
    With ``profile``, the busy share of whole c1_vq_prune steps after.
    Returns the launches."""
    import torch

    from multimodal_sc_torch.codec.semantic_vq import init_codebook_from_batch
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.envs.datasets import ImageDataset
    from multimodal_sc_torch.evaluation import snr_sweep
    from multimodal_sc_torch.train import jscc

    states, metrics, steps = {}, {}, {}
    for name, over in (("prune", C1_VQ_PRUNE), ("uep", C1_VQ_UEP)):
        cfg = get_preset("c1").override_str(over)
        tr = cfg.train
        states[name] = jscc.create_train_state(cfg, seed=0, device="cuda")
        init_codebook_from_batch(states[name].params, next(ImageDataset(
            tr.dataset, tr.batch_size, seed=tr.seed + 777, device="cuda")),
            torch.Generator(device="cuda").manual_seed(0xCB))
        steps[name] = (cfg, jscc.make_train_step(cfg), ImageDataset(
            tr.dataset, tr.batch_size, seed=tr.seed, device="cuda"))
    _reset_counts()
    for name, (cfg, train_step, data) in steps.items():
        states[name], metrics[name] = train_step(states[name], next(data))
        print(f"  {name} train step: " + ", ".join(
            f"{k}={float(v):.4f}" for k, v in metrics[name].items()),
            flush=True)
    if not all(torch.isfinite(v).all() for m in metrics.values()
               for v in m.values()) or "token_keep_frac" not in metrics[
                   "prune"]:
        raise RuntimeError(f"c1_vq prune / UEP steps: {metrics}")
    images = next(ImageDataset(tr.dataset, tr.batch_size, seed=tr.seed + 999,
                               device="cuda"))
    t0 = time.perf_counter()
    keep = snr_sweep.sweep_camera_vq_keep(
        get_preset("c1").override_str(C1_VQ_PRUNE), states["prune"].params,
        images, tr.seed, keeps=(0.25,), selects=CAM_SELECTS,
        batches_per_point=1)
    uep = {}
    for mode, over in UEP_MODES.items():
        uep[mode] = snr_sweep.sweep_camera_vq(
            get_preset("c1").override_str(C1_VQ + over),
            states["uep"].params, images, tr.seed, snrs_db=(0.0,),
            kinds=("awgn",), batches_per_point=1)["awgn"][0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    _check_counts(launches, EXPECTED_C1_VQ_PRUNE_UEP, 1,
                  "c1_vq prune and UEP phase")
    for row in [c[0] for c in keep.values()] + list(uep.values()):
        if not all(math.isfinite(v) for v in row.values()):
            raise RuntimeError(f"c1_vq prune / UEP sweeps: {keep} {uep}")
    for sel, curve in keep.items():
        print(f"  keep 0.25, {sel}: PSNR {curve[0]['psnr']:.3f} dB",
              flush=True)
    for mode, row in uep.items():
        print(f"  UEP {mode} at 0 dB AWGN: PSNR {row['psnr']:.3f} dB, index "
              f"errors {row['index_err']:.4f}", flush=True)
    print(f"  sweep points in {wall:.2f} s; launches {launches}", flush=True)
    model = states["prune"].params
    with torch.no_grad():
        idx = model.encode_tokens(images)[0]
    probes = torch.randn((2, *images.shape), device="cuda")
    for method in ("token_damage", "token_drop_damage"):
        ms = _device_ms(lambda: getattr(model, method)(idx, probes), iters=5)
        print(f"  camera {method} probes (2 VJPs, B {C1_BATCH}), one call: "
              f"{ms:.4f} ms", flush=True)
    if profile:
        print("profile (c1_vq_prune train):", flush=True)
        cfg, train_step, data = steps["prune"]
        profile_c1(cfg, states["prune"], train_step, data)
    return launches


def drive_c2():
    """The c2 train step at the preset's full widths (batch 64, 32x32, a
    per-example SNR, the seg head) through ``train.jscc``: returns the
    launches of the timed run, the train steps/s, and the config, state,
    train step and batch stream it ended with."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.envs.datasets import ImageDataset
    from multimodal_sc_torch.train import jscc

    cfg = get_preset("c2")
    tr = cfg.train
    if tr.batch_size != C1_BATCH or not cfg.channel.random_snr or \
            cfg.camera.seg_classes != 4:
        raise RuntimeError("c2: not the preset")
    t0 = time.perf_counter()
    state = jscc.create_train_state(cfg, seed=0, device="cuda")
    train_step = jscc.make_train_step(cfg)
    data = ImageDataset(tr.dataset, tr.batch_size, seed=tr.seed,
                        with_seg=True, device="cuda")
    before = _clone_params(state.params)
    state, first = train_step(state, next(data))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for _ in range(C2_WARMUP_STEPS - 1):
        state, _ = train_step(state, next(data))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"  {n_params} parameters; init + first step {first_s:.2f} s",
          flush=True)

    _reset_counts()
    t0 = time.perf_counter()
    history = []
    for _ in range(C2_TIMED_STEPS):
        state, metrics = train_step(state, next(data))
        history.append(metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    rate = C2_TIMED_STEPS / wall
    print(f"  c2 train: {C2_TIMED_STEPS} steps x batch {C1_BATCH} in "
          f"{wall:.3f} s = {rate:.2f} train steps/s", flush=True)
    print(f"  launches in the timed run: {launches}", flush=True)
    _check_counts(launches, EXPECTED_C2, C2_TIMED_STEPS, "c2")
    for m in [first] + history:
        if not all(torch.isfinite(v).all() for v in m.values()):
            raise RuntimeError(f"c2: non-finite metrics: {m}")
    if _same(state.params, before):
        raise RuntimeError("c2: the parameters did not change")
    if not float(metrics["loss"]) < float(first["loss"]):
        raise RuntimeError(
            f"c2: loss {float(metrics['loss']):.4f} after {state.step} "
            f"steps, not below the first step's {float(first['loss']):.4f}")
    print(f"  loss {float(first['loss']):.4f} -> {float(metrics['loss']):.4f}, "
          f"PSNR {float(first['psnr']):.2f} -> {float(metrics['psnr']):.2f} dB"
          f", mIoU {float(first['miou']):.3f} -> {float(metrics['miou']):.3f}",
          flush=True)
    return launches, rate, cfg, state, train_step, data


def compare_c2_routes(cfg, state, data):
    """One c2 loss (MSE + 0.1 x cross entropy, per-example SNR) and its
    gradients on a fixed batch and fixed draws, twice: through the conv
    kernel and through its plain version."""
    import torch

    from multimodal_sc_torch.kernels import conv_block
    from multimodal_sc_torch.train import jscc

    img, seg = next(data)
    model = state.params
    g = torch.Generator(device="cuda").manual_seed(12)
    draws = jscc.draw_step(cfg, C1_BATCH, g, "cuda")._replace(
        channel=torch.randn(C1_BATCH, model.k, 2, generator=g, device="cuda"))
    params = list(model.parameters())

    def loss_and_grads():
        loss, _ = jscc.loss_fn(cfg, model, img, seg, draws)
        return loss.detach(), torch.autograd.grad(loss, params)

    _compare_grads("c2 train step", model, *_two_routes(
        loss_and_grads, EXPECTED_C2, "the c2 train step",
        [(conv_block, "conv_prelu", conv_block.conv_prelu_reference)]))


def drive_c2_variants(data):
    """One c2 train step (fresh weights) over each other channel and
    codec: Rayleigh, Rician, OFDM with 2 pilots, 16-QAM, the adaptive rate;
    each launches the conv kernel 9 times and gives finite metrics. Returns
    the launches."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.train import jscc

    totals = {}
    for over in C2_VARIANTS:
        cfg = get_preset("c2").override_str(over)
        state = jscc.create_train_state(cfg, seed=0, device="cuda")
        train_step = jscc.make_train_step(cfg)
        batch = next(data)
        _reset_counts()
        state, m = train_step(state, batch)
        torch.cuda.synchronize()
        launches = _read_counts()
        _check_counts(launches, EXPECTED_C2, 1, f"c2 {over}")
        if not all(torch.isfinite(v).all() for v in m.values()):
            raise RuntimeError(f"c2 {over}: non-finite metrics: {m}")
        print(f"  c2 {' '.join(over)}: one step, loss "
              f"{float(m['loss']):.4f}, PSNR {float(m['psnr']):.2f} dB, "
              f"mIoU {float(m['miou']):.3f}", flush=True)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    return totals


def sweep_c2(cfg, state, data):
    """One held-out batch swept over 3 kinds x 7 SNRs (one draw a point):
    finite PSNR, SSIM and mIoU; returns the launches."""
    import torch

    from multimodal_sc_torch.channel import channel_kwargs
    from multimodal_sc_torch.evaluation import snr_sweep

    img, seg = next(data)
    _reset_counts()
    t0 = time.perf_counter()
    curves = snr_sweep.sweep_camera(
        state.params, img, 0, kinds=C2_SWEEP_KINDS, batches_per_point=1,
        seg=seg, **channel_kwargs(cfg.channel))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    points = len(C2_SWEEP_KINDS) * len(snr_sweep.DEFAULT_SNRS)
    _check_counts(launches, EXPECTED_C2, points, "c2 sweep")
    for kind, curve in curves.items():
        for p in curve:
            if not all(math.isfinite(p[k]) for k in ("psnr", "ssim", "miou")):
                raise RuntimeError(f"c2 sweep {kind}: {p}")
    print(f"  c2 sweep, {points} points in {wall:.2f} s; PSNR:", flush=True)
    print("\n".join("    " + line for line in
                    snr_sweep.format_table(curves).splitlines()), flush=True)
    return launches


def profile_c5(cfg, state, train_step):
    """Where the time of one c5 update goes: the rollout, the bootstrap
    value and the minibatch epochs timed alone, then the device's busy
    share of whole updates."""
    import torch

    from multimodal_sc_torch.rl import dqn, ppo
    from multimodal_sc_torch.rl.perception import ActorCritic

    holder = [state]

    def step_all():
        holder[0], _ = train_step(holder[0])

    g = state.generator
    forward = dqn.learner_forward(cfg, ActorCritic)

    def rollout():
        return ppo._collect_rollout(cfg, holder[0].params,
                                    holder[0].env_states, holder[0].ep_return,
                                    holder[0].last_return, g)

    _, _, _, ro, (img, pts, mask) = rollout()
    with torch.no_grad():
        _, _, last_value = ppo.act(cfg, state.params, img, pts, mask, g)

    def one_act():
        with torch.no_grad():
            return ppo.act(cfg, holder[0].params, img, pts, mask, g)

    batch = _c5_minibatches(cfg, state)[0]

    def minibatch_loss():
        return ppo._ppo_loss(cfg, forward, holder[0].params, batch, 0.01,
                             g)[0]

    params = list(state.params.parameters())
    parts = {
        "update": _ms(step_all, iters=2, warmup=1),
        "rollout (64 steps)": _ms(rollout, iters=2, warmup=1),
        "one act forward": _ms(one_act),
        "epochs (16 minibatch steps)": _ms(
            lambda: ppo._update(cfg, holder[0], ro, last_value, forward),
            iters=2, warmup=1),
        "minibatch loss": _ms(minibatch_loss),
        "minibatch loss_and_backward": _ms(lambda: torch.autograd.grad(
            minibatch_loss(), params, allow_unused=True)),
    }
    print("  ms per call, each part timed alone (CUDA events):", flush=True)
    for k, v in parts.items():
        print(f"    {k:34s} {v:9.3f}", flush=True)
    _idle_share(step_all, parts["update"], n=2)


def profile_c1(cfg, state, train_step, data):
    """The device's busy share of whole c1 train steps (batch included)."""
    holder = [state]

    def step_all():
        holder[0], _ = train_step(holder[0], next(data))

    wall = _ms(step_all, warmup=1)
    print(f"  train step incl. batch: {wall:.3f} ms", flush=True)
    _idle_share(step_all, wall)


def profile_c3(cfg, state, train_step, batches):
    """Where the time of one c3 train step goes: its parts timed alone on
    one batch, then the device's busy share of whole steps (batch
    generation included, as in ``run``)."""
    import torch

    from multimodal_sc_torch.train import fusion_jscc as fj

    holder = [state]

    def step_all():
        holder[0], _ = train_step(holder[0], *next(batches))

    img, pts, mask, cls = next(batches)
    model, g = state.params, state.generator
    snr = torch.full((C3_BATCH,), cfg.channel.snr_db, device="cuda")
    target = fj.bev_target(cfg, pts, mask, cls)
    params = list(model.parameters())

    def loss():
        return fj.loss_fn(cfg, model, img, pts, mask, target, snr, g)[0]

    parts = {
        "step incl. batch": _ms(step_all, warmup=1),
        "train_step": _ms(lambda: train_step(holder[0], img, pts, mask, cls)),
    }
    with torch.no_grad():
        z_cam = model.camera.encode(img, snr)
        parts.update({
            "make batch": _ms(lambda: next(batches)),
            "bev_target": _ms(lambda: fj.bev_target(cfg, pts, mask, cls)),
            "forward_no_grad": _ms(loss),
            "camera encode (no grad)": _ms(lambda: model.camera.encode(img,
                                                                      snr)),
            "camera decode (no grad)": _ms(lambda: model.camera.decode(z_cam,
                                                                      snr)),
        })
        lid = model.lidar
        if cfg.lidar.arch == "vq":
            z_q = lid.encode_tokens(pts, mask)[2]
            parts.update({
                "lidar encode_features (no grad)": _ms(
                    lambda: lid.encode_features(pts, mask)),
                "lidar forward, link inside (no grad)": _ms(
                    lambda: lid(pts, mask, snr, g)),
                "lidar codes_to_logits (no grad)": _ms(
                    lambda: lid.codes_to_logits(z_q)),
            })
        else:
            z_lid = lid.encode((pts, mask))
            parts.update({
                "lidar encode (no grad)": _ms(lambda: lid.encode((pts,
                                                                  mask))),
                "lidar decode (no grad)": _ms(lambda: lid.decode(z_lid)),
            })
    parts["forward_with_grad"] = _ms(loss)
    parts["loss_and_backward"] = _ms(
        lambda: torch.autograd.grad(loss(), params))
    parts["backward (difference)"] = (parts["loss_and_backward"]
                                      - parts["forward_with_grad"])
    parts["target_clip_adamw_metrics (difference)"] = (
        parts["train_step"] - parts["loss_and_backward"])
    print("  ms per call, each part timed alone (CUDA events):", flush=True)
    for k, v in parts.items():
        print(f"    {k:40s} {v:9.3f}", flush=True)
    _idle_share(step_all, parts["step incl. batch"])


def profile_main_path(cfg, state, iteration):
    """Where the time of one act-only iteration goes: each layer timed alone
    on the main path's own inputs, then the device's busy share."""
    import torch

    from multimodal_sc_torch.envs import driving
    from multimodal_sc_torch.rl import dqn

    holder = [state]

    def step_all():
        holder[0], _ = iteration(holder[0])

    net = state.params.eval()
    per = net.perception
    g = state.generator
    img = dqn.dequantize_image(state.obs_image)
    pts, mask = state.obs_points, state.obs_mask
    # One LiDAR branch call: the ego's rays (with V2X the RSU's make a
    # second call of the same codec).
    r = cfg.env.lidar_rays
    actions = torch.zeros(NUM_ENVS, dtype=torch.int32, device="cuda")
    snr = torch.full((NUM_ENVS,), cfg.channel.snr_db, device="cuda")
    with torch.no_grad():
        if cfg.camera.arch == "vq":
            from multimodal_sc_torch.codec.semantic_vq import (
                transmit_indices, vector_quantize)

            vq = per.cam_vq
            z_e = vq.encode_features(img)
            idx = vq.quantize(z_e)[0]
            z = vq.codebook[idx.long()]
            camera = {
                "camera_encoder": lambda: vq.encode_features(img),
                "nearest_code_search": lambda: vector_quantize(
                    z_e, vq.codebook, vq.vq_beta),
                "digital_link": lambda: transmit_indices(
                    cfg.channel, idx, vq.vq_codes, snr, g)}
        else:
            z = per.cam_enc(img)
            camera = {"camera_encoder": lambda: per.cam_enc(img)}
        cam_tok = per.cam_tok(z)
        lid_tok = per._lidar_branch(pts[:, :r], mask[:, :r], snr, g, None)
        if cfg.env.v2x_rays:
            lid_tok = torch.cat([lid_tok, lid_tok], dim=1)
        parts = {
            "iteration": _ms(step_all, warmup=1),
            "q_network": _ms(lambda: net(img, pts, mask, g)),
            **{k: _ms(fn) for k, fn in camera.items()},
            "camera_tokens": _ms(lambda: per.cam_tok(z)),
            "lidar_branch (one call)": _ms(lambda: per._lidar_branch(
                pts[:, :r], mask[:, :r], snr, g, None)),
            "fusion": _ms(lambda: per.fusion(cam_tok, lid_tok)),
            "env_step": _ms(lambda: driving.step_batch(
                cfg.env, holder[0].env_states, actions, g)),
        }
    print("  ms per call, each part timed alone (CUDA events):", flush=True)
    for k, v in parts.items():
        print(f"    {k:24s} {v:9.3f}", flush=True)

    _idle_share(step_all, parts["iteration"])


def _idle_share(step_all, wall, n=10):
    """The device's idle share of ``step_all``: ``wall`` is its unprofiled
    time in ms (the profiler's own host work would stretch it), the device
    time comes from a trace that records the device only."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step_all()
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) * 1e3 / n
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / n
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time")
    print(f"  per iteration over {n}: unprofiled wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms, idle {100 * (1 - busy / wall):.1f}% "
          f"(wall under the profiler {wall_prof:.3f} ms)", flush=True)
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        print(f"    {e.self_device_time_total / 1e3 / n:9.3f} ms "
              f"{e.count / n:6.1f}x  {e.key[:90]}", flush=True)


def profile_learn(cfg, state, iteration):
    """Where the time of one act+learn iteration goes: the learner's parts
    timed alone on one sampled batch, then the device's busy share."""
    import torch

    from multimodal_sc_torch.rl import dqn, replay

    holder = [state]

    def step_all():
        holder[0], _ = iteration(holder[0])

    forward = dqn.learner_forward(cfg)
    bs = cfg.rl.batch_size
    dev = state.obs_points.device
    params = list(state.params.parameters())

    def draw():
        return dqn.draw_learn(cfg, state.buffer.size, state.generator, dev)

    def sample(draws):
        return dqn.dequantize_obs(cfg, replay.sample(state.buffer, None, bs,
                                                     draws.indices))

    draws = draw()
    batch = sample(draws)
    g = state.generator

    def loss():
        return dqn._td_loss(cfg, forward, state.params, state.target_params,
                            batch, draws, g)

    def one_forward(with_grad):
        with torch.set_grad_enabled(with_grad):
            return forward(state.params, batch.image, batch.points,
                           batch.mask, g)

    parts = {
        "iteration": _ms(step_all, warmup=1),
        "learn_step": _ms(lambda: dqn.learn_step(cfg, holder[0], batch, draws,
                                                 forward)),
        "sample_batch": _ms(lambda: sample(draw())),
        "forward_no_grad": _ms(lambda: one_forward(False)),
        "forward_with_grad": _ms(lambda: one_forward(True)),
        "loss_3_forwards": _ms(loss),
        "loss_and_backward": _ms(
            lambda: torch.autograd.grad(loss(), params, allow_unused=True)),
    }
    parts["backward (difference)"] = (parts["loss_and_backward"]
                                      - parts["loss_3_forwards"])
    parts["clip_adam_target_ema (difference)"] = (
        parts["learn_step"] - parts["loss_and_backward"])
    print("  ms per call, each part timed alone (CUDA events):", flush=True)
    for k, v in parts.items():
        print(f"    {k:34s} {v:9.3f}", flush=True)
    _idle_share(step_all, parts["iteration"])


# The CLI and deployment phase, driven in process through
# ``multimodal_sc_torch.cli.main``. c4 trains at 1024 envs for a few
# iterations: each acts once (8 fused blocks, 5 encoder convs, 1 scatter);
# the n-step window first fills on the third, whose 1024 transitions exceed
# a batch, so every iteration from the third also learns (15 convs, 3
# scatters and 1 scatter backward, as arm A's learner).
CLI_C4_STEPS = 10
CLI_C4_LEARN_STEPS = CLI_C4_STEPS - 2
CLI_C4 = [f"rl.num_envs={NUM_ENVS}", f"train.steps={CLI_C4_STEPS}",
          f"train.checkpoint_every={CLI_C4_STEPS}", "train.log_every=2"]
EXPECTED_CLI_C4 = {
    "mha_block": 8 * CLI_C4_STEPS,
    "conv_prelu": 5 * CLI_C4_STEPS + 15 * CLI_C4_LEARN_STEPS,
    "scatter_max": CLI_C4_STEPS + 3 * CLI_C4_LEARN_STEPS,
    "scatter_max_bwd": CLI_C4_LEARN_STEPS}
CLI_EPISODES = NUM_ENVS
CLI_SEED = 2024             # the exported policy's noise seed
# c2 through the CLI: a few train steps (9 convs each), then the eval
# sweep of its checkpoint over AWGN at 7 SNRs x 4 batches (9 convs a batch).
CLI_C2_STEPS = 4
CLI_C2 = [f"train.steps={CLI_C2_STEPS}",
          f"train.checkpoint_every={CLI_C2_STEPS}"]
CLI_C2_SWEEP = 7 * 4
# Codecs exported from fresh weights (no checkpoint: the CLI warns).
CLI_CODECS = (("c1_vq", "c1", C1_VQ), ("c3", "c3", []), ("c3_vq", "c3", C3_VQ))


def _cli(argv):
    """``cli.main(argv)``, on the card but for ``show``, with its standard
    output captured; returns that output (it must exit 0)."""
    from multimodal_sc_torch import cli

    device = [] if argv[0] == "show" else ["--device", "cuda"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv) + device)
    if rc != 0:
        raise RuntimeError(f"cli {argv[:3]} exited {rc}")
    return buf.getvalue()


def _sets(overrides):
    return [a for o in overrides for a in ("--set", o)]


def _plain_patches():
    """(module, name, plain version) of every kernel a codec or trunk
    reaches outside the fused blocks (those run plain by their flag)."""
    from multimodal_sc_torch.codec import camera_vit, lidar_bev
    from multimodal_sc_torch.kernels import (attention_packed, conv_block,
                                             pillar_scatter)

    return [(camera_vit, "packed_attention",
             attention_packed.packed_attention_reference),
            (conv_block, "conv_prelu", conv_block.conv_prelu_reference),
            (lidar_bev, "scatter_max", pillar_scatter.scatter_max_reference)]


@contextlib.contextmanager
def _plain_route():
    """Every kernel's plain version, TF32 off (for an artifact's calls too);
    fails if a kernel launches."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    before = _read_counts()
    try:
        with _patched(_plain_patches()), torch.no_grad():
            yield
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    if _read_counts() != before:
        raise RuntimeError("a plain route launched a kernel")


def _no_launch(fn, what):
    """``fn()``, which must launch no kernel (an artifact runs the plain
    versions)."""
    import torch

    before = _read_counts()
    out = fn()
    torch.cuda.synchronize()
    if _read_counts() != before:
        raise RuntimeError(f"{what} launched a kernel")
    return out


def _near_tie_codes(what, got, want, z_e, codebook):
    """Indices ``got`` against ``want`` (B, N): where they differ, the two
    codes must lie at a near-tie of the encoder output ``z_e``'s distances
    (within 1e-5 of their scale, as ``_HeldCodes`` allows)."""
    import torch

    flat = z_e.reshape(-1, codebook.shape[1]).double()
    cb = codebook.detach().double()
    a, b = got.reshape(-1).long(), want.reshape(-1).long()
    pos = (a != b).nonzero()[:, 0]
    if pos.numel():
        da = ((flat[pos] - cb[a[pos]]) ** 2).sum(1)
        db = ((flat[pos] - cb[b[pos]]) ** 2).sum(1)
        scale = (flat[pos] ** 2).sum(1) + (cb[b[pos]] ** 2).sum(1)
        if ((da - db).abs() > 1e-5 * scale).any():
            raise RuntimeError(f"{what}: {pos.numel()} indices differ, not "
                               "all at near-ties")
    return pos.numel()


def _close(what, got, want, atol=1e-5):
    import torch

    torch.testing.assert_close(got, want, atol=atol, rtol=atol,
                               msg=lambda m: f"{what}: {m}")
    return (got - want).abs().max().item()


def cli_c4_phase(work):
    """``show``, ``train`` (with ``--metrics`` and a checkpoint; the module
    script's rate beside it), ``eval-policy --use-ema`` and ``export
    --use-ema`` of c4 at 1024 envs; then the artifact on the card against
    the live EMA network's plain route on 1024 fresh observations, the act
    verb against ``rl.dqn.act``. Returns the launches of the driven paths
    and the timings."""
    import torch

    from multimodal_sc_torch import act as act_verb
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.envs import driving
    from multimodal_sc_torch.evaluation import policy_eval
    from multimodal_sc_torch.io import export as export_lib
    from multimodal_sc_torch.rl import dqn
    from multimodal_sc_torch.train import dqn as dqn_train

    shown = json.loads(_cli(["show", "--config", "c4"]))
    if shown["name"] != "c4_dqn_fusion":
        raise RuntimeError(f"show: {shown['name']}")
    ckpt, metrics = os.path.join(work, "c4"), os.path.join(work, "c4.jsonl")
    over = CLI_C4 + [f"train.checkpoint_dir={ckpt}"]
    totals, times = {}, {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    _reset_counts()
    t0 = time.perf_counter()
    last = json.loads(_cli(["train", "--config", "c4", "--metrics", metrics]
                           + _sets(over)))
    times["cli train s"] = time.perf_counter() - t0
    launches = _read_counts()
    _check_counts(launches, EXPECTED_CLI_C4, 1, "cli train c4")
    add(launches)
    if not all(math.isfinite(v) for v in last.values()):
        raise RuntimeError(f"cli train c4: non-finite metrics {last}")
    records = [json.loads(line) for line in open(metrics)]
    if records[-1]["step"] != CLI_C4_STEPS or not os.path.exists(
            os.path.join(ckpt, f"ckpt_{CLI_C4_STEPS}.pt")):
        raise RuntimeError("cli train c4: no final record or checkpoint")
    times["cli train steps/s"] = last["steady_steps_per_sec_per_chip"]
    print(f"  cli train c4: {CLI_C4_STEPS} iterations x {NUM_ENVS} envs in "
          f"{times['cli train s']:.1f} s; last metrics: " + ", ".join(
              f"{k}={v:.4g}" for k, v in sorted(last.items())), flush=True)
    print(f"  launches {launches}", flush=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dqn_train.main(["--config", "c4", "--eval-envs", "32", "--device",
                        "cuda"] + _sets(CLI_C4))
    main_out = json.loads(buf.getvalue().strip().splitlines()[-1])
    times["module main steps/s"] = main_out["steady_steps_per_sec_per_chip"]
    print(f"  steady agent steps/s at {NUM_ENVS} envs: cli train "
          f"{times['cli train steps/s']}, train.dqn's script "
          f"{times['module main steps/s']}", flush=True)

    cfg = get_preset("c4").override_str(over)
    _reset_counts()
    t0 = time.perf_counter()
    ev = json.loads(_cli(["eval-policy", "--config", "c4", "--use-ema",
                          "--episodes", str(CLI_EPISODES)] + _sets(over)))
    wall = time.perf_counter() - t0
    launches = _read_counts()
    _check_counts(launches, EXPECTED_LAUNCHES, cfg.env.max_steps,
                  "cli eval-policy c4")
    add(launches)
    if not math.isfinite(ev["episode_return_mean"]):
        raise RuntimeError(f"cli eval-policy: {ev}")
    print(f"  cli eval-policy --use-ema: {CLI_EPISODES} episodes x "
          f"{cfg.env.max_steps} steps in {wall:.1f} s, return "
          f"{ev['episode_return_mean']:.3f}", flush=True)

    art = os.path.join(work, "c4_policy")
    t0 = time.perf_counter()
    out = json.loads(_no_launch(lambda: _cli(
        ["export", "--config", "c4", "--use-ema", "--out", art]
        + _sets(over)), "cli export c4"))
    times["export s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    policy = export_lib.load_artifact(art, device="cuda")["policy"]
    times["load s"] = time.perf_counter() - t0
    print(f"  cli export --use-ema: {out['parts']}, {out['bytes']} bytes, in "
          f"{times['export s']:.1f} s; load_artifact on the card "
          f"{times['load s']:.2f} s", flush=True)

    ema = policy_eval.select_dqn_policy(cfg, 0, "cuda", use_ema=True).eval()
    g = torch.Generator(device="cuda").manual_seed(99)
    obs = driving.observe_batch(cfg.env, driving.reset_batch(
        cfg.env, NUM_ENVS, g, "cuda"))
    learner = dqn.learner_forward(cfg)

    def q_of(route):
        with torch.no_grad(), torch.random.fork_rng(devices=["cuda"]):
            torch.manual_seed(CLI_SEED)
            return route(ema, *obs)

    with _plain_route():
        actions = _no_launch(lambda: policy(*obs, CLI_SEED), "the artifact")
        q_plain = q_of(learner)
    q_kernel = q_of(lambda net, *o: net(*o))
    top2 = q_plain.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    a_plain = q_plain.argmax(-1)
    off = actions.long() != a_plain
    if (gap[off] >= 1e-4).any():
        raise RuntimeError(
            f"exported policy: {int(off.sum())} of {NUM_ENVS} actions differ "
            "from the live plain route's, not all at a top-two gap below "
            "1e-4")
    agree = (q_kernel.argmax(-1) == a_plain).float().mean().item()
    print(f"  exported policy vs the live EMA network's plain route on "
          f"{NUM_ENVS} fresh observations: {NUM_ENVS - int(off.sum())} "
          f"actions equal ({int(off.sum())} at a top-two gap below 1e-4; "
          f"median gap {gap.median().item():.3e}); the live kernel route's "
          f"greedy actions agree with the plain route's in "
          f"{100 * agree:.2f}% (Q max difference "
          f"{(q_kernel - q_plain).abs().max().item():.3e})", flush=True)
    with torch.no_grad():
        times["artifact ms"] = _device_ms(lambda: policy(*obs, CLI_SEED))
        times["live ms"] = _device_ms(lambda: ema(*obs))
    print(f"  device time per call at B {NUM_ENVS}: exported policy (plain "
          f"versions) {times['artifact ms']:.3f} ms, live EMA network (the "
          f"kernels) {times['live ms']:.3f} ms", flush=True)

    _reset_counts()
    with torch.no_grad():
        a = act_verb(cfg, ema, *obs, torch.Generator(device="cuda")
                     .manual_seed(5), epsilon=0.05)
        b = dqn.act(cfg, ema, *obs, torch.Generator(device="cuda")
                    .manual_seed(5), epsilon=0.05)
    torch.cuda.synchronize()
    launches = _read_counts()
    _check_counts(launches, EXPECTED_LAUNCHES, 2, "the act verb")
    add(launches)
    if not torch.equal(a, b):
        raise RuntimeError("the act verb differs from rl.dqn.act")
    print(f"  act verb at B {NUM_ENVS} equals rl.dqn.act (eps 0.05)",
          flush=True)
    return totals, times


def cli_c2_phase(work):
    """``train`` c2 for a few steps with a checkpoint, ``eval`` of it,
    ``export`` of its codec held on the card to the live plain route, and
    ``api.reconstruct`` against the c2 step's path. Returns the launches."""
    import torch

    from multimodal_sc_torch import api
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.envs.datasets import ImageDataset
    from multimodal_sc_torch.io import export as export_lib
    from multimodal_sc_torch.io.checkpoint import CheckpointManager
    from multimodal_sc_torch.train import jscc

    ckpt = os.path.join(work, "c2")
    over = CLI_C2 + [f"train.checkpoint_dir={ckpt}"]
    totals = {}
    _reset_counts()
    last = json.loads(_cli(["train", "--config", "c2"] + _sets(over)))
    launches = _read_counts()
    _check_counts(launches, EXPECTED_C2, CLI_C2_STEPS, "cli train c2")
    totals.update(launches)
    _reset_counts()
    curves_path = os.path.join(work, "c2_curves.json")
    _cli(["eval", "--config", "c2", "--kinds", "awgn", "--out",
          curves_path] + _sets(over))
    launches = _read_counts()
    _check_counts(launches, EXPECTED_C2, CLI_C2_SWEEP, "cli eval c2")
    totals["conv_prelu"] += launches["conv_prelu"]
    curve = json.load(open(curves_path))["awgn"]
    if len(curve) != 7 or not all(math.isfinite(p["miou"]) for p in curve):
        raise RuntimeError(f"cli eval c2: {curve}")
    print(f"  cli train c2: {CLI_C2_STEPS} steps, loss {last['loss']:.4f}; "
          f"cli eval: PSNR {curve[0]['psnr']:.2f} -> {curve[-1]['psnr']:.2f}"
          f" dB over 7 SNRs; launches {totals}", flush=True)

    art = os.path.join(work, "c2_codec")
    out = json.loads(_no_launch(lambda: _cli(
        ["export", "--config", "c2", "--out", art] + _sets(over)),
        "cli export c2"))
    fns = export_lib.load_artifact(art, device="cuda")
    cfg = get_preset("c2").override_str(over)
    model = jscc.create_train_state(cfg, cfg.train.seed, "cuda").params
    CheckpointManager(ckpt).restore_params_latest(model)
    img, _ = next(ImageDataset(cfg.train.dataset, cfg.train.batch_size,
                               seed=5, with_seg=True, device="cuda"))
    snr = torch.linspace(-5.0, 25.0, img.shape[0], device="cuda")
    with _plain_route():
        z = _no_launch(lambda: fns["encoder"](img, snr), "the c2 artifact")
        rec = _no_launch(lambda: fns["decoder"](z, snr), "the c2 artifact")
        seg = _no_launch(lambda: fns["decoder_seg"](z, snr),
                         "the c2 artifact")
        errs = [_close("c2 encoder", z, model.encode(img, snr)),
                _close("c2 decoder", rec, model.decode(z, snr))]
        errs += [_close("c2 decoder_seg", g, w) for g, w in zip(
            seg, model.decode_seg(z, snr))]
    print(f"  cli export c2: {out['parts']}; on the card against the live "
          f"plain route, largest difference {max(errs):.3e}", flush=True)

    _reset_counts()
    with torch.no_grad():
        r1, z1 = api.reconstruct(model, img, 5.0, torch.Generator(
            device="cuda").manual_seed(3), **_channel_kw(cfg))
        r2, z2 = jscc.reconstruct(cfg, model, img, 5.0, torch.Generator(
            device="cuda").manual_seed(3))
    launches = _read_counts()
    _check_counts(launches, EXPECTED_C2, 2, "api.reconstruct")
    totals["conv_prelu"] += launches["conv_prelu"]
    if not (torch.equal(r1, r2) and torch.equal(z1, z2)):
        raise RuntimeError("api.reconstruct differs from the c2 step's path")
    print(f"  api.reconstruct at batch {img.shape[0]} equals the c2 step's "
          "transmit", flush=True)
    return totals


def _channel_kw(cfg):
    from multimodal_sc_torch.channel import channel_kwargs

    return {"kind": cfg.channel.kind, **channel_kwargs(cfg.channel)}


def cli_codec_exports(work):
    """``export`` of the c1_vq, c3 and c3_vq codecs from fresh weights,
    each part on the card against the live plain route: indices equal (or
    at near-ties), everything else within 1e-5."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.envs.datasets import (ImageDataset,
                                                   draw_pointcloud,
                                                   synthetic_pointcloud_batch)
    from multimodal_sc_torch.io import export as export_lib
    from multimodal_sc_torch.train import fusion_jscc, jscc

    for name, preset, over in CLI_CODECS:
        art = os.path.join(work, name)
        t0 = time.perf_counter()
        out = json.loads(_no_launch(lambda: _cli(
            ["export", "--config", preset, "--out", art] + _sets(over)),
            f"cli export {name}"))
        export_s = time.perf_counter() - t0
        fns = export_lib.load_artifact(art, device="cuda")
        cfg = get_preset(preset).override_str(over)
        tr, lid = cfg.train, cfg.lidar
        fused = tr.task == "jscc_fusion"
        model = (fusion_jscc if fused else jscc).create_train_state(
            cfg, tr.seed, "cuda").params
        camera = model.camera if fused else model
        img = next(ImageDataset(tr.dataset, tr.batch_size, seed=5,
                                device="cuda"))
        img = img[0] if isinstance(img, tuple) else img
        snr = torch.full((img.shape[0],), cfg.channel.snr_db, device="cuda")
        errs, ties = [], 0
        if cfg.camera.arch == "vq":
            with _plain_route():
                idx = _no_launch(lambda: fns["encoder"](img), name)
                rec = _no_launch(lambda: fns["decoder"](idx), name)
                ties += _near_tie_codes(
                    f"{name} encoder", idx, camera.encode_tokens(img)[0],
                    camera.encode_features(img), camera.codebook)
                errs.append(_close(f"{name} decoder", rec,
                                   camera.decode_tokens(idx)))
        else:
            with _plain_route():
                z = _no_launch(lambda: fns["encoder"](img, snr), name)
                rec = _no_launch(lambda: fns["decoder"](z, snr), name)
                errs += [_close(f"{name} encoder", z, camera.encode(img, snr)),
                         _close(f"{name} decoder", rec,
                                camera.decode(z, snr))]
        if fused:
            pts, mask = synthetic_pointcloud_batch(draw_pointcloud(
                tr.batch_size, lid.max_points, torch.Generator(
                    device="cuda").manual_seed(6), "cuda", lid.x_range,
                lid.y_range), lid.x_range, lid.y_range)
            enc, dec = fns["lidar_encoder"], fns["lidar_decoder"]
            if lid.arch == "vq":
                with _plain_route():
                    idx = _no_launch(lambda: enc(pts, mask), name)
                    logits = _no_launch(lambda: dec(idx), name)
                    ties += _near_tie_codes(
                        f"{name} lidar encoder", idx,
                        model.lidar.encode_tokens(pts, mask)[0],
                        model.lidar.encode_features(pts, mask),
                        model.lidar.codebook)
                    errs.append(_close(f"{name} lidar decoder", logits,
                                       model.lidar.decode_tokens(idx)))
            else:
                with _plain_route():
                    z = _no_launch(lambda: enc(pts, mask, snr), name)
                    logits = _no_launch(lambda: dec(z, snr), name)
                    errs += [_close(f"{name} lidar encoder", z,
                                    model.lidar.encode((pts, mask), snr)),
                             _close(f"{name} lidar decoder", logits,
                                    model.lidar.decode(z, snr))]
        print(f"  cli export {name} (fresh weights): {out['parts']} in "
              f"{export_s:.1f} s; on the card against the live plain route: "
              f"largest difference {max(errs):.3e}, {ties} indices at "
              "near-ties", flush=True)


# --- train.bf16: the kernels' bf16-I/O variants and the bf16 paths ---------

def _bf16_step(x):
    """One bf16 step (unit in the last place) at each |x|: bf16 keeps 8
    significant bits, so the step of a value in [2^e, 2^(e+1)) is 2^(e-7)."""
    import torch

    _, e = torch.frexp(x.float().abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


# Outputs below 2^-14 of a tensor's largest entry are held at the step of
# that floor: there two sums of the same f32 products in other orders
# differ by more than the value's own bf16 step (a 3200-term conv output
# near zero), and a bf16 rounding of either says nothing about the kernel.
BF16_FLOOR = 2.0 ** -14


def _ulp_gate(got, ref):
    """(mask of outputs more than one bf16 step apart, the largest distance
    in steps, the share of outputs whose bits differ). The step is the
    larger of the two values' (they may lie in neighbouring binades), at
    the floor at least."""
    import torch

    g, r = got.float(), ref.float()
    floor = BF16_FLOOR * r.abs().max()
    step = torch.maximum(_bf16_step(torch.maximum(r.abs(), floor)),
                         _bf16_step(torch.maximum(g.abs(), floor)))
    steps = (g - r).abs() / step
    return steps > 1.0, steps.max().item(), (got != ref).float().mean().item()


# The bf16 convs' time per step before the bf16 wgmma kernel
# (conv_mma_bf16_kernel on mma.sync and the banded Cin = 3 layer; NVIDIA
# H100 80GB HBM3, 700.00 W): ms per c4 act step (``PERF.md`` section 6).
CONV_BF16_EARLIER_MS = {"c4": 0.707}


def check_conv_prelu_bf16():
    """The conv kernel on bf16 operands against its plain version (the
    widened operands, an f32 conv with TF32 off, bias and PReLU, one
    rounding) at c4's act shapes (B 1024: the bf16 line's rows), c1's (B 64,
    encoder and decoder) and c5's (B 32), both routes, and at shapes that
    reach every predicate: every output within one bf16 step (``_ulp_gate``;
    the share that differs printed). A shape whose output tiles split their
    taps over a cluster of blocks runs twice and must give the same bits.
    Times beside cuDNN's bf16 conv2d (with its bias, without the PReLU),
    summed per c4 act step, c5 act forward and c1 train step."""
    import torch
    import torch.nn.functional as F

    from multimodal_sc_torch.kernels import conv_block as cb

    g = torch.Generator(device="cuda").manual_seed(21)
    bf = torch.bfloat16
    encoder = ((32, 32, 3, 32, 2, True), (16, 16, 32, 64, 2, True),
               (8, 8, 64, 128, 1, True), (8, 8, 128, 128, 1, True),
               (8, 8, 128, 16, 1, False))
    decoder = ((8, 8, 16, 128, 1, True), (32, 32, 32, 3, 1, False))
    cases = [(NUM_ENVS, shape, True, 1) for shape in encoder]
    cases += [(C5_ENVS, shape, True, 0) for shape in encoder]
    cases += [(C1_BATCH, shape, True, 0) for shape in encoder + decoder]
    cases += [(b, shape, False, 0) for b, shape in (
        (64, (7, 9, 32, 64, 1, True)), (64, (7, 9, 32, 64, 2, True)),
        (64, (9, 7, 40, 24, 2, False)), (64, (8, 8, 16, 12, 1, True)),
        (64, (8, 8, 8, 8, 1, True)), (64, (5, 5, 8, 200, 1, True)),
        (64, (3, 3, 136, 136, 2, True)), (C3_BATCH, (64, 64, 3, 32, 2, True)),
        (C3_BATCH, (64, 64, 32, 3, 1, False)))]
    rows, worst, timed_at = [], 0.0, {}
    for b, (h, w, cin, cout, s, prelu), timed, per_step in cases:
        x = torch.randn(b, h, w, cin, generator=g, device="cuda").to(bf)
        wt = (torch.randn(5, 5, cin, cout, generator=g, device="cuda")
              / (25 * cin) ** 0.5).to(bf)
        bias = (0.1 * torch.randn(cout, generator=g, device="cuda")).to(bf)
        alpha = (torch.rand(cout, generator=g, device="cuda").to(bf)
                 if prelu else None)
        ref = cb.conv_prelu_reference(x, wt, bias, alpha, s)
        out = cb.conv_prelu(x, wt, bias, alpha, s)
        torch.cuda.synchronize()
        if out.dtype != bf or out.shape != ref.shape:
            raise AssertionError(f"conv_prelu bf16: {out.dtype} "
                                 f"{tuple(out.shape)}")
        over, steps, share = _ulp_gate(out, ref)
        err = (out.float() - ref.float()).abs().max().item()
        worst = max(worst, err)
        tc = cb.tensor_core_path(cin, cout, bf)
        splits = cb.bf16_splits(b, h, w, cin, cout, 5, s) if tc else 1
        path = (f"tensor cores, {splits} blocks a tile" if tc
                else "FMA units, banded")
        line = (f"  conv_prelu bf16 B={b} {h}x{w}x{cin}->{cout} s{s} ({path})"
                f": {100 * share:.3f}% of outputs differ, at most "
                f"{steps:.2f} bf16 steps, err {err:.3e}")
        if over.any():
            raise AssertionError(f"{line}: {int(over.sum())} outputs more "
                                 "than one bf16 step from the plain version")
        if splits > 1:
            # The split tile's sums are added in rank order: no run-to-run
            # difference.
            if not torch.equal(out, cb.conv_prelu(x, wt, bias, alpha, s)):
                raise AssertionError(f"{line}: two runs of the split conv "
                                     "differ")
            line += "; rerun bit-equal"
        if not timed:
            print(line, flush=True)
            continue
        ms = _device_ms(lambda: cb.conv_prelu(x, wt, bias, alpha, s))
        plain = _device_ms(lambda: cb.conv_prelu_reference(x, wt, bias,
                                                           alpha, s))
        (plo, phi), (qlo, qhi) = cb.same_pads(h, 5, s), cb.same_pads(w, 5, s)
        xc = F.pad(x.permute(0, 3, 1, 2), (qlo, qhi, plo, phi)).contiguous(
            memory_format=torch.channels_last)
        wc = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = _device_ms(lambda: F.conv2d(xc, wc, bias, stride=s))
        oh, ow = -(-h // s), -(-w // s)
        flops = 2 * b * oh * ow * cout * 25 * cin
        nbytes = 2 * (b * h * w * cin + 25 * cin * cout + 2 * cout
                      + b * oh * ow * cout)
        # The function's bound, bf16 operands at the bf16 peak, whichever
        # path the kernel takes.
        bound, by = _bound_ms(flops, nbytes, PEAK_BF16)
        print(f"{line}; kernel {ms:.4f} ms, plain {plain:.4f} ms, cuDNN bf16 "
              f"{lib:.4f} ms, bound {bound:.4f} ms ({by})", flush=True)
        row = {"per_step": per_step, "err": err, "ms": ms, "plain_ms": plain,
               "bound_ms": bound, "bound_by": by, "library_ms": lib}
        timed_at[b, (h, w, cin, cout, s, prelu)] = row
        if per_step:
            rows.append(row)
    # Per step of each path: c4's act step and c5's act forward run the five
    # encoder convs once; a c1 train step its nine (the decoder's block0 and
    # block1 have enc3's shape).
    c1_convs = [(shape, 3 if shape == encoder[3] else 1)
                for shape in encoder + decoder]
    for what, b, shapes in (
            ("c4 act step, 5 convs", NUM_ENVS, [(x, 1) for x in encoder]),
            ("c5 act forward, 5 convs", C5_ENVS, [(x, 1) for x in encoder]),
            ("c1 train step, 9 convs", C1_BATCH, c1_convs)):
        group = [dict(timed_at[b, shape], per_step=n) for shape, n in shapes]
        line = _entry("conv_prelu_bf16", "cuda", "", "", group)
        earlier = CONV_BF16_EARLIER_MS.get(what.split()[0])
        print(f"  conv_prelu bf16, {what} at B={b}: kernel {line['ms']:.4f} "
              f"ms, plain {line['plain_ms']:.4f} ms, cuDNN bf16 "
              f"{line['library_ms']:.4f} ms, bound {line['bound_ms']:.4f} ms "
              f"({line['bound_by']})" + (
                  f", before the bf16 wgmma kernel {earlier} ms" if earlier
                  else ""), flush=True)
    entry = _entry("conv_prelu_bf16", "cuda",
                   "multimodal_sc_torch/csrc/conv_prelu.cu",
                   "multimodal_sc_tpu/kernels/conv_block.py:69", rows)
    entry["max_abs_err"] = worst
    return entry


# The fused block's bf16-I/O gates. Against the plain version that rounds
# where the kernel does, only the order of the f32 sums differs; now and then
# that flips one intermediate rounding (a k, v, probability or head output)
# by a bf16 step, which moves the outputs it feeds by up to the f32-I/O
# gate, 5e-3, absolute: outputs near zero then lie many of their own bf16
# steps apart. So every output must lie within one bf16 step of its own
# (the output's rounding) plus 5e-3; past that it must be one rounding flip
# at a tie (the witness, at most this many a shape, each recomputed in
# f64). Flips are rare: at most 1% of the outputs may differ at all (a
# kernel that rounded elsewhere differs in most of them). At each timed
# shape a sample of the outputs past one step but inside the gate gets the
# same witness: the gate's reach rests on their being flips too.
BF16_WITNESS_MAX = 64
BF16_WITNESS_SAMPLE = 8
BF16_MHA_ABS = 5e-3
BF16_MHA_SHARE = 1e-2


def check_mha_block_bf16():
    """The fused block with bf16 activations (f32 parameters) against its
    bf16-I/O plain version (``mha_block_reference_bf16``: the kernel's
    roundings, the output rounded once) at c4's four act shapes and the fog
    + V2X ones (B 1024: the bf16 line's rows), c5's act shapes (B 32), then
    shapes that reach the rest of the kernels. Up to 256 keys the call runs
    ``mha_wgmma_bf16_kernel`` (bf16 wgmma), past them ``mha_mma_kernel``.
    Every output within one bf16 step of its own plus ``BF16_MHA_ABS``;
    past that it must be one rounding flip at a tie (``_bf16_flip_witness``,
    its candidates rounded to bf16 as the kernel stores them, within one
    step of the kernel's output); at most ``BF16_MHA_SHARE`` of the outputs
    differ. Two runs give the same bits. At c4's and c5's shapes
    ``mha_mma_kernel``'s bf16-I/O instance runs beside it on the same
    inputs: its share of differing outputs, its outputs past one bf16 step
    and its time are printed beside the new kernel's (not gated), and
    summed per c4 act step and c5 act forward."""
    import torch

    from multimodal_sc_torch.kernels import mha_block as mb

    g = torch.Generator(device="cuda").manual_seed(22)
    bf, dim = torch.bfloat16, 128

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    p = {}
    for k in mb.PARAM_KEYS:
        if k.startswith("w"):
            p[k] = rnd(dim, dim) * dim ** -0.5
        elif "scale" in k:
            p[k] = 1.0 + 0.1 * rnd(dim)
        else:
            p[k] = 0.1 * rnd(dim)
    shapes = list(C4_ATTN_SHAPES) + [s for s in V2X_ATTN_SHAPES
                                     if s not in C4_ATTN_SHAPES]
    cases = [(NUM_ENVS, lq, lk, 4, True, FUSION_DEPTH) for lq, lk in shapes]
    cases += [(C5_ENVS, lq, lk, 4, True, 0) for lq, lk in C4_ATTN_SHAPES]
    cases += [(b, lq, lk, heads, False, 0)
              for b, lq, lk, heads in ((64, 65, 65, 2), (64, 65, 100, 8),
                                       (64, 17, 70, 16), (64, 33, 300, 4),
                                       (16, 130, 256, 2), (16, 100, 2048, 4),
                                       (8, 1, 1, 4))]
    flat = tuple(p[k] for k in mb.PARAM_KEYS)
    rows, worst, side = [], 0.0, {}
    for b, lq, lk, heads, timed, per_step in cases:
        x_q, x_kv = rnd(b, lq, dim).to(bf), rnd(b, lk, dim).to(bf)
        ref = mb.mha_block_reference_bf16(x_q, x_kv, p, heads)
        out = mb.mha_block(x_q, x_kv, p, heads)
        wgmma = mb.wgmma_route(True, True, lk)
        if not torch.equal(out, mb.mha_block(x_q, x_kv, p, heads)):
            raise AssertionError("mha_block bf16 I/O: two runs on the same "
                                 "inputs differ")
        torch.cuda.synchronize()
        if out.dtype != bf:
            raise AssertionError(f"mha_block bf16 I/O: output {out.dtype}")
        _, steps, share = _ulp_gate(out, ref)
        diff = (out.float() - ref.float()).abs()
        over = diff > _bf16_step(out) + BF16_MHA_ABS
        err = diff.max().item()
        worst = max(worst, err)
        n_over = int(over.sum())
        n_step = int((diff > _bf16_step(out)).sum())
        line = (f"  mha_block bf16 I/O B={b} Lq={lq} Lk={lk} h={heads} ("
                f"{'mha_wgmma_bf16_kernel' if wgmma else 'mha_mma_kernel'}"
                f"): {100 * share:.3f}% of outputs differ, {n_step} past one "
                f"bf16 step, at most {steps:.2f} of their bf16 steps, err "
                f"{err:.3e} ({n_over} past a step + {BF16_MHA_ABS})")
        if n_over > BF16_WITNESS_MAX or share > BF16_MHA_SHARE:
            raise AssertionError(f"{line}: more than {BF16_WITNESS_MAX} past "
                                 f"the gate or {100 * BF16_MHA_SHARE}% "
                                 "differing")
        def witness(idx):
            got = out[tuple(idx)].float().item()
            wit = _bf16_flip_witness(x_q.float(), x_kv.float(), p, heads, idx,
                                     {"kernel": got}, round_out=True)
            op, left, tie = wit["kernel"]
            step = _bf16_step(torch.tensor(got)).item()
            print(f"    output {idx}: kernel {got:.6f}, plain "
                  f"{ref[tuple(idx)].float().item():.6f}, exact f64 "
                  f"{wit['exact']:.6f}; nearest single flip {op} "
                  f"({left:.3e} left, {tie:.2e} from its tie)", flush=True)
            if left > step:
                raise AssertionError(
                    f"mha_block bf16 I/O: output {idx} at B={b} Lq={lq} "
                    f"Lk={lk} is no single rounding flip at a tie (nearest "
                    f"{op}, {left:.3e} left, a step {step:.3e})")

        for idx in over.nonzero().tolist():
            witness(idx)
        # The gate's reach: outputs past one bf16 step but inside the gate,
        # a sample spread over them at each timed shape, must each be one
        # rounding flip at a tie as well.
        inside = ((diff > _bf16_step(out)) & ~over).nonzero()
        if timed and len(inside):
            pick = torch.linspace(0, len(inside) - 1,
                                  min(len(inside), BF16_WITNESS_SAMPLE),
                                  device=inside.device).long()
            print(f"    {len(pick)} of the {len(inside)} outputs past one "
                  "bf16 step, inside the gate:", flush=True)
            for idx in inside[pick].tolist():
                witness(idx)
        if not timed:
            print(line, flush=True)
            continue
        ms = _device_ms(lambda: mb.mha_block(x_q, x_kv, p, heads))
        plain = _device_ms(lambda: mb.mha_block_reference(x_q, x_kv, p,
                                                          heads))
        flops = 2 * b * (2 * lq * dim * dim + 2 * lk * dim * dim
                         + 2 * lq * lk * dim)
        nbytes = (2 * (2 * b * lq * dim + b * lk * dim)
                  + 4 * (4 * dim * dim + 8 * dim))
        bound, by = _bound_ms(flops, nbytes, PEAK_BF16)
        print(f"{line}; kernel {ms:.3f} ms, plain {plain:.3f} ms, bound "
              f"{bound:.4f} ms ({by})", flush=True)
        row = {"per_step": per_step, "err": err, "ms": ms,
               "plain_ms": plain, "bound_ms": bound, "bound_by": by,
               "library_ms": None}
        if per_step:
            rows.append(row)
        if wgmma:
            # mha_mma_kernel's bf16-I/O instance on the same inputs.
            scale = (dim // heads) ** -0.5
            old = mb._mha_block_cuda(x_q, x_kv, flat, heads, scale, True,
                                     kernel="mma")
            torch.cuda.synchronize()
            _, old_steps, old_share = _ulp_gate(old, ref)
            old_step = int(((old.float() - ref.float()).abs()
                            > _bf16_step(old)).sum())
            old_ms = _device_ms(lambda: mb._mha_block_cuda(
                x_q, x_kv, flat, heads, scale, True, kernel="mma"))
            print(f"    mha_mma_kernel on the same inputs: "
                  f"{100 * old_share:.3f}% of outputs differ, {old_step} past "
                  f"one bf16 step, at most {old_steps:.2f} of their bf16 "
                  f"steps; {old_ms:.3f} ms", flush=True)
            side[b, lq, lk] = (row, old_ms, share, old_share, n_step,
                               old_step)
        del x_q, x_kv, ref, out
    for what, b in (("c4 act step", NUM_ENVS), ("c5 act forward", C5_ENVS)):
        got = [side[b, lq, lk] for lq, lk in C4_ATTN_SHAPES]
        new = FUSION_DEPTH * sum(r["ms"] for r, *_ in got)
        old = FUSION_DEPTH * sum(o for _, o, *_ in got)
        bound = FUSION_DEPTH * sum(r["bound_ms"] for r, *_ in got)
        print(f"  mha_block bf16 I/O per {what} (B={b}, 4 shapes x "
              f"{FUSION_DEPTH}): mha_wgmma_bf16_kernel {new:.4f} ms, "
              f"mha_mma_kernel {old:.4f} ms, bound {bound:.4f} ms; outputs "
              f"differing {', '.join(f'{100 * g[2]:.3f}%' for g in got)} "
              f"against {', '.join(f'{100 * g[3]:.3f}%' for g in got)}, "
              f"past one step {sum(g[4] for g in got)} against "
              f"{sum(g[5] for g in got)}", flush=True)
    entry = _entry("mha_block_bf16", "cuda",
                   "multimodal_sc_torch/csrc/mha_bf16.cuh",
                   "multimodal_sc_tpu/kernels/mha_block.py:149", rows)
    entry["kernel"] = ("mha_wgmma_bf16_kernel (bf16 wgmma) up to 256 keys; "
                       "mha_mma_kernel (csrc/mha_block.cu) past them")
    entry["max_abs_err"] = worst
    return entry


def _big_tie_case():
    """bf16 features of 4 envs of 600 points whose first 300 points of env
    0 share cell 5 and tie at its max in feature 0 (a count past 256, which
    bf16 cannot hold)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(11)
    feats = torch.randn(4, 600, 64, generator=g, device="cuda")
    cell = torch.randint(0, 257, (4, 600), generator=g, device="cuda",
                         dtype=torch.int32)
    cell[0] = torch.where(cell[0] == 5, 6, cell[0])
    cell[0, :300] = 5
    feats[0, :300, 0] = 7.0
    return "a tie of 300 points, N=600", feats.to(torch.bfloat16), cell, 256


def check_scatter_max_bf16():
    """The scatter kernels on bf16 features, bit for bit against their plain
    versions (the backward: JAX's f32 share rounded to bf16, bf16(g * (1 /
    count))), with forced ties, at c4's act (the forward's line), learn and
    fog + V2X shapes, c3's (the backward's line) and c5's, and the edge
    shapes (a tie of 300 points among them). D % 8 == 0 runs the kernels of
    ``csrc/scatter_bf16.cuh``; at each timed shape the f32 kernels' bf16
    instances (``kernel="atomics"``), which D 30 and D 7 still run, are
    timed beside them."""
    import torch

    bf = torch.bfloat16
    c4 = _pillar_inputs()
    c4 = (c4[0].to(bf), c4[1], c4[2])
    c3 = _c3_pillar_inputs()
    c3 = (c3[0].to(bf), c3[1], c3[2])

    def first(n):
        return c4[0][:n], c4[1][:n], c4[2]

    row = _scatter_case("c4 act", *c4)
    _scatter_case("c4 learn", *first(LEARN_BATCH))
    _scatter_case("c3-cnn", *c3)
    _scatter_case("c5 loss", *first(C5_LOSS_BATCH))
    bwd_row = _scatter_bwd_case("c3-cnn", *c3)
    _scatter_bwd_case("c4 learn", *first(LEARN_BATCH))
    _scatter_bwd_case("c5 loss", *first(C5_LOSS_BATCH))
    ego, rsu = ((f.to(bf), c, n) for f, c, n in _v2x_pillar_inputs())
    v2x_rows = [_scatter_case("c4 fog+V2X ego", *ego),
                _scatter_case("c4 fog+V2X RSU", *rsu)]
    for what, feats, cell, cells in [*_scatter_edges(), _big_tie_case()]:
        _scatter_case(what, feats.to(bf), cell, cells, timed=False)
        _scatter_bwd_case(what, feats.to(bf), cell, cells, timed=False)
    for what, rows in (("scatter_max_bf16_kernel per c4 act step and fog + "
                        "V2X act forward", [row, *v2x_rows]),
                       ("scatter_max_bwd_bf16_kernel per c3-cnn step",
                        [bwd_row])):
        print(f"  {what}: " + ", ".join(
            f"{r['ms']:.4f} ms (old instance {r['old_ms']:.4f}, bound "
            f"{r['bound_ms']:.5f})" for r in rows), flush=True)
    src = "multimodal_sc_torch/csrc/scatter_bf16.cuh"
    fwd = _entry("scatter_max_bf16", "cuda", src,
                 "multimodal_sc_tpu/kernels/pillar_scatter.py:79",
                 [row, *v2x_rows])
    fwd["kernel"] = ("scatter_max_bf16_kernel (csrc/scatter_bf16.cuh) at D "
                     "% 8 == 0; scatter_max_kernel<bf16, 4 | 1> "
                     "(csrc/pillar_scatter.cu) at other D")
    bwd = _entry("scatter_max_bwd_bf16", "cuda", src,
                 "multimodal_sc_tpu/kernels/pillar_scatter.py:32", [bwd_row])
    bwd["kernel"] = ("scatter_max_bwd_bf16_kernel (csrc/scatter_bf16.cuh) at "
                     "D % 8 == 0; scatter_max_bwd_kernel<bf16, 4 | 1> "
                     "(csrc/pillar_scatter.cu) at other D")
    return [fwd, bwd]


def _bf16_io_readings(got, ref_io):
    """A bf16 output against its bf16-I/O plain version: (max error, mean
    error, outputs past 1e-2 alone, outputs past 1e-2 plus one bf16 step of
    the plain version's value)."""
    diff = (got.float() - ref_io.float()).abs()
    return (diff.max().item(), diff.mean().item(), int((diff > 1e-2).sum()),
            int((diff > 1e-2 + _bf16_step(ref_io)).sum()))


def _gate_bf16_io(name, got, ref_io, ref_f32):
    """The gates of a bf16-I/O attention kernel's outputs (``PERF.md``
    section 6), against its plain version that rounds where it does, bf16
    in and out: within 1e-2 of it (the bf16 mode's gate) widened by one
    bf16 step of the output, whose final rounding two sums in other orders
    can flip (at |x| >= 2 one step is 1.56e-2, past 1e-2 alone); the mean
    error under 1e-5; and within 3e-2 of exact f32. Returns (max, mean,
    share of outputs whose bits differ, outputs past 1e-2 alone)."""
    import torch

    if got.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: output {got.dtype}, not bf16")
    mx, mean, strict, over = _bf16_io_readings(got, ref_io)
    if over or mean > 1e-5:
        raise AssertionError(f"{name}: {over} outputs past 1e-2 + a bf16 "
                             f"step of the plain version, max {mx:.3e}, "
                             f"mean {mean:.3e}")
    torch.testing.assert_close(got.float(), ref_f32.float(), atol=3e-2,
                               rtol=3e-2,
                               msg=lambda m: f"{name} against f32: {m}")
    return mx, mean, (got != ref_io).float().mean().item(), strict


def _own_rounding(name, got, f32_io):
    """A bf16-I/O output against the same kernel's f32-I/O output on the
    same values: the one rounding at the store, so within one bf16 step.
    Returns the share not bit-equal to round-to-nearest of it."""
    steps = ((got.float() - f32_io).abs() / _bf16_step(f32_io)).max().item()
    if steps > 1.0:
        raise AssertionError(f"{name}: {steps:.2f} bf16 steps from its f32 "
                             "I/O result, not its one rounding")
    return (got != f32_io.to(got.dtype)).float().mean().item()


# The bf16-I/O packed forward's time per arm-B act+learn step before the
# bf16 wgmma kernel (fwd_mma_kernel's bf16-I/O instance on mma.sync; NVIDIA
# H100 80GB HBM3, 700.00 W; ``PERF.md`` section 6).
PACKED_FWD_BF16_EARLIER_MS = 3.589


def check_packed_attention_bf16():
    """The packed kernels' bf16 mode with bf16 tensors (train.bf16) against
    their bf16-I/O plain versions (``_gate_bf16_io``; dK and dV rounded per
    128-query block as the JAX kernel sums them) at the timed shapes of the
    f32 check (arm B's act+learn iteration and the ViT trunk's, the c3
    arm-P shape, whose 256 queries are two blocks, printed per c3 step),
    and at ragged, Lq > 128, Lk > 256 (the forward's two passes),
    several-key-split, d = 64, 16 and 8 shapes. The forward's output is
    held to the same mode's f32-I/O kernel on the widened values (its output
    rounded, at ``_gate_bf16_io``), its lse within 2e-5 of that kernel's and
    the plain version's; dQ (and dK, dV where Lq is one block) to the same
    backward kernel's f32-I/O instance: their one rounding. Up to 256 keys
    the backward is ``bwd_wgmma_bf16_kernel`` (bf16 wgmma), past them
    ``bwd_mma_kernel``. Every backward runs twice, bit-equal. Times beside
    SDPA on the same bf16 tensors; the forward summed per arm-B act+learn
    step. At arm B's, the ViT trunk's and c3 arm P's shapes
    ``bwd_mma_kernel``'s bf16-I/O instance runs beside the new backward on
    the same inputs: its time, its share of outputs that differ from the
    plain version and its outputs past 1e-2 alone are printed beside the
    new kernel's (not gated), and summed per arm-B step."""
    import torch
    import torch.nn.functional as F

    from multimodal_sc_torch.kernels import attention_packed as ap

    g = torch.Generator(device="cuda").manual_seed(27)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(bf)

    def heads_first(t, heads):
        b, l, dm = t.shape
        return t.reshape(b, l, heads, dm // heads).transpose(1, 2).contiguous()

    # (B, Lq, Lk, dm, heads, forward and backward launches per iteration),
    # as in check_packed_attention.
    cases = [(NUM_ENVS, lq, lk, 128, 4, FUSION_DEPTH, 0)
             for lq, lk in C4_ATTN_SHAPES]
    cases += [(C3_BATCH, 256, 256, 128, 4, -C3_ATTN_PER_STEP,
               -C3_ATTN_PER_STEP)]
    cases += [(NUM_ENVS, VIT_TOKENS, VIT_TOKENS, 128, 4, VIT_ATTN_PER_FWD, 0),
              (LEARN_BATCH, VIT_TOKENS, VIT_TOKENS, 128, 4,
               3 * VIT_ATTN_PER_FWD, VIT_ATTN_PER_FWD)]
    cases += [(LEARN_BATCH, lq, lk, 128, 4, 3 * FUSION_DEPTH,
               FUSION_DEPTH if lq == 65 else FUSION_DEPTH - 1)
              for lq, lk in C4_ATTN_SHAPES]
    cases += [(64, 200, 48, 128, 4, 0, 0), (64, 33, 70, 128, 4, 0, 0),
              (64, 129, 100, 256, 8, 0, 0), (4, 100, 1100, 128, 4, 0, 0),
              (8, 130, 300, 128, 2, 0, 0), (16, 70, 130, 128, 8, 0, 0),
              (16, 50, 300, 128, 16, 0, 0), (16, 130, 200, 128, 2, 0, 0),
              (16, 65, 256, 128, 16, 0, 0)]
    fwd_rows, bwd_rows = [], []
    worst_fwd = worst_bwd = 0.0
    strict = outputs = 0        # outputs past 1e-2 alone, outputs held
    once = [0.0, 0.0, 0, 0]     # a once-rounded dK/dV's readings, worst
    exps = 0                    # the forward's exponentials a step
    side = []                   # the two backward kernels, timed shapes
    for b, lq, lk, dm, heads, n_fwd, n_bwd in cases:
        q, k, v, do = rnd(b, lq, dm), rnd(b, lk, dm), rnd(b, lk, dm), \
            rnd(b, lq, dm)
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        scale = (dm // heads) ** -0.5
        out, lse = ap._fwd_cuda(q, k, v, heads, scale, True, want_lse=True)
        out32, lse32 = ap._fwd_cuda(qf, kf, vf, heads, scale, True,
                                    want_lse=True)
        ref, ref_lse = ap.packed_attention_fwd_reference(q, k, v, heads,
                                                         scale, bf16=True)
        exact = ap.packed_attention_reference(qf, kf, vf, heads, scale)
        torch.cuda.synchronize()
        err, mean, share, n = _gate_bf16_io(
            "packed_attention forward bf16 I/O", out, ref, exact)
        strict, outputs = strict + n, outputs + out.numel()
        # The f32-I/O kernel sums S and P V in other orders, so its P
        # roundings flip elsewhere: the plain version's gates, not its one
        # rounding.
        _, _, own, _ = _gate_bf16_io(
            "packed_attention forward bf16 I/O against the f32-I/O kernel",
            out, out32.to(bf), exact)
        torch.testing.assert_close(lse, lse32, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
        # Backward through autograd: the Function's backward on bf16.
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        grads = torch.autograd.grad(ap.packed_attention(*ins, heads), ins, do)
        again = ap._bwd_cuda(q, k, v, out, lse, do, heads, scale, True)
        if not all(torch.equal(a, b_) for a, b_ in zip(again, grads)):
            raise AssertionError("packed_attention backward bf16 I/O: two "
                                 "runs on the same inputs differ")
        wgmma = ap.bwd_wgmma_route(True, True, lk)
        g32 = ap._bwd_cuda(qf, kf, vf, out.float(), lse, dof, heads, scale,
                           True, kernel="wgmma" if wgmma else None)
        ref_g = ap.packed_attention_bwd_reference(q, k, v, out, do, heads,
                                                  scale, bf16=True,
                                                  lse=ref_lse)
        exact_g = ap.packed_attention_bwd_reference(qf, kf, vf, exact, dof,
                                                    heads, scale)
        torch.cuda.synchronize()
        berrs, bmeans, bshares, owns, bstrict = [], [], [], [], 0
        for i, (got, want, ex, f32_io) in enumerate(zip(grads, ref_g,
                                                        exact_g, g32)):
            e, m, s, n = _gate_bf16_io(f"packed_attention backward bf16 "
                                       f"I/O d{'qkv'[i]}", got, want, ex)
            strict, outputs = strict + n, outputs + got.numel()
            bstrict += n
            berrs.append(e)
            bmeans.append(m)
            bshares.append(s)
            if i == 0 or lq <= ap.BLOCK_Q:
                owns.append(_own_rounding(
                    f"packed_attention backward bf16 I/O d{'qkv'[i]}", got,
                    f32_io))
        berr = max(berrs)
        worst_fwd, worst_bwd = max(worst_fwd, err), max(worst_bwd, berr)
        line = (f"  packed_attention bf16 I/O B={b} Lq={lq} Lk={lk} dm={dm} "
                f"h={heads} (backward "
                f"{'bwd_wgmma_bf16_kernel' if wgmma else 'bwd_mma_kernel'}): "
                f"fwd err {err:.3e} mean {mean:.2e} "
                f"({100 * share:.3f}% differ); bwd err {berr:.3e} mean "
                f"{max(bmeans):.2e} ({100 * max(bshares):.3f}% differ); "
                f"fwd {100 * own:.3f}% differ from the f32-I/O kernel's, "
                f"bwd {100 * max(owns):.3f}% off their one rounding")
        if lq > ap.BLOCK_Q:
            # What the gate reads of a dK / dV summed over all query blocks
            # in f32 and rounded once (the f32-I/O result rounded), not per
            # block as the JAX kernel sums them.
            case = [max(x) for x in zip(*(
                _bf16_io_readings(f32_io.to(bf), want)
                for f32_io, want in zip(g32[1:], ref_g[1:])))]
            once = [max(x) for x in zip(once, case)]
            line += (f"; dK/dV rounded once would read: max {case[0]:.3e}, "
                     f"mean {case[1]:.2e}, {case[3]} past the gate")
        if not (n_fwd or n_bwd):
            print(line, flush=True)
            continue
        ms = _device_ms(lambda: ap.packed_attention(q, k, v, heads))
        plain = _device_ms(lambda: ap.packed_attention_fwd_reference(
            q, k, v, heads, scale, bf16=True))
        qh, kh, vh = (heads_first(t, heads) for t in (q, k, v))
        lib = _device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        # bf16 rows read and written once at two bytes.
        bound, by = _bound_ms(4 * b * lq * lk * dm,
                              2 * 2 * b * (lq + lk) * dm, PEAK_BF16)
        line += (f"; fwd kernel {ms:.3f} ms, plain {plain:.3f} ms, SDPA bf16 "
                 f"{lib:.3f} ms, bound {bound:.4f} ms ({by})")
        if n_fwd > 0:
            fwd_rows.append({"per_step": n_fwd, "err": err, "ms": ms,
                             "plain_ms": plain, "bound_ms": bound,
                             "bound_by": by, "library_ms": lib})
            exps += n_fwd * b * heads * lq * lk
        else:
            line += f" (c3 arm P: x{-n_fwd} per train step)"
        if n_bwd:
            ms = _device_ms(lambda: ap._bwd_cuda(q, k, v, out, lse, do, heads,
                                                 scale, True))
            plain = _device_ms(lambda: ap.packed_attention_bwd_reference(
                q, k, v, out, do, heads, scale, bf16=True, lse=lse))
            for t in (qh, kh, vh):
                t.requires_grad_(True)
            lib_out = F.scaled_dot_product_attention(qh, kh, vh)
            doh = heads_first(do, heads)
            lib = _device_ms(lambda: torch.autograd.grad(
                lib_out, (qh, kh, vh), doh, retain_graph=True))
            bound, by = _bound_ms(10 * b * lq * lk * dm,
                                  2 * 4 * b * (lq + lk) * dm
                                  + 4 * b * heads * lq, PEAK_BF16)
            line += (f"; bwd kernel {ms:.3f} ms, plain {plain:.3f} ms, SDPA "
                     f"bf16 backward {lib:.3f} ms, bound {bound:.4f} ms ({by})")
            if n_bwd > 0:
                bwd_rows.append({"per_step": n_bwd, "err": berr, "ms": ms,
                                 "plain_ms": plain, "bound_ms": bound,
                                 "bound_by": by, "library_ms": lib})
            if wgmma:
                # bwd_mma_kernel's bf16-I/O instance on the same inputs.
                old = ap._bwd_cuda(q, k, v, out, lse, do, heads, scale, True,
                                   kernel="mma")
                torch.cuda.synchronize()
                old_share = max((a != w).float().mean().item()
                                for a, w in zip(old, ref_g))
                old_strict = sum(_bf16_io_readings(a, w)[2]
                                 for a, w in zip(old, ref_g))
                old_ms = _device_ms(lambda: ap._bwd_cuda(
                    q, k, v, out, lse, do, heads, scale, True, kernel="mma"))
                line += (f"; bwd_mma_kernel on the same inputs {old_ms:.3f} "
                         f"ms, {100 * old_share:.3f}% differ, {old_strict} "
                         f"past 1e-2 alone (the new kernel {ms:.3f} ms, "
                         f"{100 * max(bshares):.3f}%, {bstrict})")
                side.append((n_bwd, ms, old_ms, max(bshares), old_share,
                             bstrict, old_strict, bound))
        print(line, flush=True)
        del q, k, v, do, qf, kf, vf, dof, out, out32, ref, exact, grads, g32
        del ref_g, exact_g
    step = _entry("packed_attention_fwd_bf16", "cuda", "", "", fwd_rows)
    # Each probability's exponential once, on the exp2 units: 16 a clock on
    # each SM (the CUDA guide's throughput table for sm_90), at the card's
    # highest SM clock.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])
    exp_ms = exps / (16 * sms * mhz * 1e6) * 1e3
    print(f"  packed_attention_fwd_bf16, arm B act+learn step (with the ViT "
          f"trunk's rows): kernel {step['ms']:.4f} ms, plain "
          f"{step['plain_ms']:.4f} ms, SDPA bf16 {step['library_ms']:.4f} ms, "
          f"bound {step['bound_ms']:.4f} ms ({step['bound_by']}); "
          f"exponential floor {exp_ms:.4f} ms ({exps} exponentials, 16 a "
          f"clock on each of {sms} SMs at {mhz:.0f} MHz); before the bf16 "
          f"wgmma kernel {PACKED_FWD_BF16_EARLIER_MS} ms", flush=True)
    arm_b = [x for x in side if x[0] > 0]
    c3 = [x for x in side if x[0] < 0]
    for what, got in (("arm-B act+learn step (the ViT trunk's rows "
                       "included)", arm_b), ("c3 arm-P train step", c3)):
        n = [abs(x[0]) for x in got]
        print(f"  packed_attention_bwd_bf16 per {what}: bwd_wgmma_bf16_kernel "
              f"{sum(c * x[1] for c, x in zip(n, got)):.4f} ms, "
              f"bwd_mma_kernel {sum(c * x[2] for c, x in zip(n, got)):.4f} "
              f"ms, bound {sum(c * x[7] for c, x in zip(n, got)):.4f} ms; "
              f"outputs differing "
              f"{', '.join(f'{100 * x[3]:.3f}%' for x in got)} against "
              f"{', '.join(f'{100 * x[4]:.3f}%' for x in got)}, past 1e-2 "
              f"alone {sum(x[5] for x in got)} against "
              f"{sum(x[6] for x in got)}", flush=True)
    print(f"  packed_attention bf16 I/O gate readings: largest error "
          f"{max(worst_fwd, worst_bwd):.3e}, {strict} of {outputs} outputs "
          f"past 1e-2 alone (each within one more bf16 step); a once-rounded "
          f"dK/dV at Lq > {ap.BLOCK_Q}: max {once[0]:.3e}, largest mean "
          f"{once[1]:.2e} (gate 1e-5), {once[3]} outputs past 1e-2 + a step, "
          f"{once[2]} past 1e-2 alone: the gate "
          f"{'fails' if once[3] or once[1] > 1e-5 else 'passes'} it",
          flush=True)
    src = "multimodal_sc_torch/csrc/attention_packed.cu"
    entries = [
        _entry("packed_attention_fwd_bf16", "cuda", src,
               "multimodal_sc_tpu/kernels/attention_packed.py:170", fwd_rows),
        _entry("packed_attention_bwd_bf16", "cuda",
               "multimodal_sc_torch/csrc/packed_bwd_bf16.cuh",
               "multimodal_sc_tpu/kernels/attention_packed.py:201", bwd_rows)]
    entries[1]["kernel"] = ("bwd_wgmma_bf16_kernel (bf16 wgmma) up to 256 "
                            "keys; bwd_mma_kernel (csrc/attention_packed.cu) "
                            "past them")
    entries[0]["max_abs_err"], entries[1]["max_abs_err"] = worst_fwd, worst_bwd
    return entries


# The earlier bf16 kernels, bf16-I/O instances of the f32 kernels (3xTF32
# wgmma, plain loads), at the c3 arm-F shape, ms per launch on an NVIDIA
# H100 80GB HBM3 at 700 W (``PERF.md`` section 6): the times the bf16
# wgmma kernels replace.
FLASH_BF16_EARLIER_MS = {"fwd": 0.601 / 8, "dq": 0.916 / 8, "dkv": 1.094 / 8}


def check_flash_attention_bf16():
    """The flash kernels on bf16 tensors (``csrc/flash_bf16.cuh``, bf16
    wgmma) against their plain versions (``_gate_bf16_io``) at the c3
    arm-F shape on the transposed views the ViT's MHA hands in (timed, per
    arm-F train step), and at ragged, cross, odd-D (D 8 and 96: q scale in
    three pieces; D 8 on 16-byte copies of a 16-byte row), head-dim-128 and
    contiguous shapes, and a head dim no multiple of 8 (8-byte copies); the
    output, dQ, dK and dV held to the same kernels' f32 outputs (their one
    rounding at the store), those to the f32 kernels' results on the widened
    values within the f32 check's gates, delta bit-equal to theirs and lse
    within 2e-5 (S, and near-zero outputs, come from other tensor-core
    sums); every backward run twice, bit-equal; each case's launches
    counted. Times beside SDPA on bf16
    tensors, the bound, and the earlier kernels' times."""
    import torch
    import torch.nn.functional as F

    from multimodal_sc_torch.kernels import attention as fa

    g = torch.Generator(device="cuda").manual_seed(28)
    bf = torch.bfloat16

    def heads_view(b, h, l, d):
        return torch.randn(b, l, h, d, generator=g,
                           device="cuda").to(bf).transpose(1, 2)

    def contiguous(b, h, l, d):
        return torch.randn(b, h, l, d, generator=g, device="cuda").to(bf)

    cases = [(C3_BATCH, 3, 256, 256, 64, heads_view, C3_ATTN_PER_STEP),
             (2, 4, 100, 70, 32, contiguous, 0),
             (C3_BATCH, 3, 257, 257, 64, heads_view, 0),
             (2, 2, 17, 17, 64, contiguous, 0),
             (3, 2, 33, 130, 128, heads_view, 0),
             (2, 3, 40, 24, 96, contiguous, 0),
             (4, 5, 300, 7, 8, heads_view, 0),
             (2, 3, 90, 150, 12, contiguous, 0)]
    rows = {"fwd": [], "dq": [], "dkv": []}
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    strict = outputs = 0        # outputs past 1e-2 alone, outputs held
    counts = ("launches_fwd_bf16", "launches_bwd_dq_bf16",
              "launches_bwd_dkv_bf16")
    for b, h, lq, lk, d, make, per_step in cases:
        before = [getattr(fa, c) for c in counts]
        q, k, v = make(b, h, lq, d), make(b, h, lk, d), make(b, h, lk, d)
        do = make(b, h, lq, d)
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        scale = d ** -0.5
        out, lse = fa._fwd_cuda(q, k, v, scale)
        # The same kernel's f32 output (its sums before their one rounding)
        # and the f32 kernels' results on the widened values.
        own32 = fa._fwd_cuda(q, k, v, scale, out_dtype=torch.float32)[0]
        out32, lse32 = fa._fwd_cuda(qf, kf, vf, scale)
        ref, ref_lse = fa.flash_attention_fwd_reference(q, k, v, scale)
        exact = fa.flash_attention_fwd_reference(qf, kf, vf, scale)[0]
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = torch.autograd.grad(fa.attention(*ins, use_pallas=True), ins, do)
        runs = []
        for _ in range(2):
            dq_, delta_ = fa._bwd_dq_cuda(q, k, v, out, lse, do, scale)
            runs.append((dq_, delta_,
                         *fa._bwd_dkv_cuda(q, k, v, lse, delta_, do, scale)))
        if not all(torch.equal(a, b_) for a, b_ in zip(*runs)):
            raise AssertionError("flash_attention backward bf16 I/O: two "
                                 "runs on the same inputs differ")
        if not all(torch.equal(a, b_) for a, b_ in zip(got, (runs[0][0],
                                                             *runs[0][2:]))):
            raise AssertionError("flash_attention bf16 I/O: autograd's "
                                 "backward differs from the kernels'")
        dq32, delta32 = fa._bwd_dq_cuda(qf, kf, vf, out.float(), lse, dof,
                                        scale)
        g32 = (dq32, *fa._bwd_dkv_cuda(qf, kf, vf, lse, delta32, dof, scale))
        delta_ = runs[0][1]
        own_g = (fa._bwd_dq_cuda(q, k, v, out, lse, do, scale,
                                 out_dtype=torch.float32)[0],
                 *fa._bwd_dkv_cuda(q, k, v, lse, delta_, do, scale,
                                   out_dtype=torch.float32))
        ref_g = fa.flash_attention_bwd_reference(q, k, v, out, ref_lse, do,
                                                 scale)
        exact_g = fa.flash_attention_bwd_reference(qf, kf, vf, exact, ref_lse,
                                                   dof, scale)
        torch.cuda.synchronize()
        # The forward twice, autograd's backward once, two more runs and
        # each kernel once more with f32 outputs.
        if [getattr(fa, c) - n for c, n in zip(counts, before)] != [3, 4, 4]:
            raise AssertionError("flash_attention bf16: the bf16 kernels' "
                                 "launches not counted")
        if not torch.equal(runs[0][1], delta32):
            raise AssertionError("flash_attention bf16 I/O: delta differs "
                                 "from the f32 kernels'")
        torch.testing.assert_close(lse, lse32, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
        # The f32 sums against the f32 kernels': the f32 check's gates (2e-5
        # forward, 2e-4 backward), the two tensor-core sums in other orders.
        torch.testing.assert_close(own32, out32, atol=2e-5, rtol=2e-5)
        for a, f in zip(own_g, g32):
            torch.testing.assert_close(a, f, atol=2e-4, rtol=2e-4)
        errs, means, shares = {}, [], []
        owns = [_own_rounding("flash_attention forward bf16 I/O", out, own32)]
        errs["fwd"], m, s, n = _gate_bf16_io(
            "flash_attention forward bf16 I/O", out, ref, exact)
        strict, outputs = strict + n, outputs + out.numel()
        means.append(m)
        shares.append(s)
        bwd = []
        for i, (a, w, ex, f) in enumerate(zip(got, ref_g, exact_g, own_g)):
            what = f"flash_attention backward bf16 I/O d{'qkv'[i]}"
            e, m, s, n = _gate_bf16_io(what, a, w, ex)
            strict, outputs = strict + n, outputs + a.numel()
            owns.append(_own_rounding(what, a, f))
            bwd.append(e)
            means.append(m)
            shares.append(s)
        errs["dq"], errs["dkv"] = bwd[0], max(bwd[1:])
        for key, e in errs.items():
            worst[key] = max(worst[key], e)
        line = (f"  flash_attention bf16 I/O B={b} H={h} Lq={lq} Lk={lk} "
                f"D={d} ({make.__name__}): err fwd {errs['fwd']:.3e}, dq "
                f"{errs['dq']:.3e}, dk/dv {errs['dkv']:.3e}, mean "
                f"{max(means):.2e}, {100 * max(shares):.3f}% differ, "
                f"{100 * max(owns):.3f}% off their one rounding; lse "
                f"{(lse - lse32).abs().max().item():.2e} from the f32 "
                "kernel's, delta its bits; two backward runs bit-equal")
        if not per_step:
            print(line, flush=True)
            continue
        delta = runs[0][1]
        work = b * h * lq * lk * d
        rows_bytes = 2 * b * h * d      # a bf16 row of every (batch, head)
        ms = {"fwd": _device_ms(lambda: fa._fwd_cuda(q, k, v, scale)),
              "dq": _device_ms(lambda: fa._bwd_dq_cuda(q, k, v, out, lse, do,
                                                       scale)),
              "dkv": _device_ms(lambda: fa._bwd_dkv_cuda(q, k, v, lse, delta,
                                                         do, scale))}
        plain = {
            "fwd": _device_ms(lambda: fa.flash_attention_fwd_reference(
                q, k, v, scale)),
            "dq": _device_ms(lambda: fa.flash_attention_dq_reference(
                q, k, v, out, lse, do, scale)),
            "dkv": _device_ms(lambda: fa.flash_attention_dkv_reference(
                q, k, v, lse, delta, do, scale))}
        qc, kc, vc = (t.contiguous().requires_grad_(True) for t in (q, k, v))
        lib_fwd = _device_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc))
        lib_out = F.scaled_dot_product_attention(qc, kc, vc)
        doc = do.contiguous()
        lib_bwd = _device_ms(lambda: torch.autograd.grad(
            lib_out, (qc, kc, vc), doc, retain_graph=True))
        lib = {"fwd": lib_fwd, "dq": lib_bwd, "dkv": lib_bwd}
        # Operations, counted from the exactness of each product's operands
        # (2 * work each): a product of two bf16-exact operands is one bf16
        # tensor-core pass (its f32 sums are exact), one with an f32 operand
        # three (that operand split into three bf16 pieces, its 24 bits),
        # all at the bf16 rate; an f32 x f32 product would take six, the
        # time of the f32 check's 3xTF32. Exact: q, k, v, dO, and q * scale
        # where the scale is a power of two (D = 64); not P, dS. Forward
        # S, PV; dQ kernel S, dP = dO V^T, dQ; dK/dV kernel S, dP, dV, dK.
        # Bytes: the rows at two bytes, lse and delta at four.
        s_passes = 1 if math.frexp(scale)[0] == 0.5 else 3
        passes = {"fwd": s_passes + 3, "dq": s_passes + 1 + 3,
                  "dkv": s_passes + 1 + 3 + 3}
        bounds = {
            "fwd": _bound_ms(passes["fwd"] * 2 * work,
                             rows_bytes * (2 * lq + 2 * lk) + 4 * b * h * lq,
                             PEAK_BF16),
            "dq": _bound_ms(passes["dq"] * 2 * work,
                            rows_bytes * (4 * lq + 2 * lk) + 8 * b * h * lq,
                            PEAK_BF16),
            "dkv": _bound_ms(passes["dkv"] * 2 * work,
                             rows_bytes * (2 * lq + 4 * lk) + 8 * b * h * lq,
                             PEAK_BF16)}
        for key in rows:
            bound, by = bounds[key]
            line += (f"; {key} kernel {ms[key]:.4f} ms (earlier "
                     f"{FLASH_BF16_EARLIER_MS[key]:.4f}), plain "
                     f"{plain[key]:.3f} ms, bound {bound:.4f} ms ({by})")
            rows[key].append({"per_step": per_step, "err": errs[key],
                              "ms": ms[key], "plain_ms": plain[key],
                              "bound_ms": bound, "bound_by": by,
                              "library_ms": lib[key]})
        line += (f"; SDPA bf16 forward {lib_fwd:.3f} ms, backward (dQ, dK and "
                 f"dV together) {lib_bwd:.3f} ms")
        print(line, flush=True)
        del q, k, v, do, qf, kf, vf, dof, out, out32, ref, exact, ins, got
        del runs, g32, ref_g, exact_g, qc, kc, vc, lib_out, own32, own_g
    print(f"  flash_attention bf16 I/O gate readings: largest error "
          f"{max(worst.values()):.3e}, {strict} of {outputs} outputs past "
          f"1e-2 alone (each within one more bf16 step)", flush=True)
    src = "multimodal_sc_torch/csrc/flash_bf16.cuh"
    entries = [
        _entry("flash_attention_fwd_bf16", "cuda", src,
               "multimodal_sc_tpu/kernels/attention.py:103", rows["fwd"]),
        _entry("flash_attention_bwd_dq_bf16", "cuda", src,
               "multimodal_sc_tpu/kernels/attention.py:221", rows["dq"]),
        _entry("flash_attention_bwd_dkv_bf16", "cuda", src,
               "multimodal_sc_tpu/kernels/attention.py:252", rows["dkv"])]
    for e, key in zip(entries, ("fwd", "dq", "dkv")):
        e["max_abs_err"] = worst[key]
    return entries


def check_kernels_bf16():
    """The bf16-I/O variants, TF32 off on the plain side."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return [check_mha_block_bf16(), check_conv_prelu_bf16(),
                *check_scatter_max_bf16(), *check_packed_attention_bf16(),
                *check_flash_attention_bf16()]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _mha_plain_bf16(x_q, x_kv, params, heads, scale=None, mxu_bf16=None):
    from multimodal_sc_torch.kernels import mha_block as mb

    return mb.mha_block_reference_bf16(x_q, x_kv, params, heads, scale)


def _flash_plain_bf16(q, k, v, scale=None, use_pallas=False):
    from multimodal_sc_torch.kernels import attention

    if use_pallas:
        return attention.flash_attention_plain(q, k, v, scale)
    return attention.attention_reference(q, k, v, scale)


def _plain_patches_bf16(with_blocks=True):
    """The plain versions a bf16 route comparison swaps in: the conv and the
    scatter as the CPU runs them (their bf16 gradients the kernels'), the
    fused blocks' bf16-mode plain version (the kernel's roundings), and the
    attention kernels' plain versions in the mode the card runs (bf16
    operands for the packed ones), whose backward rounds where the kernels
    store."""
    from multimodal_sc_torch.codec import camera_vit, lidar_bev
    from multimodal_sc_torch.fusion import transformer
    from multimodal_sc_torch.kernels import (attention_packed, conv_block,
                                             pillar_scatter)

    out = [(conv_block, "conv_prelu", conv_block.conv_prelu_plain),
           (lidar_bev, "scatter_max", pillar_scatter.scatter_max_plain),
           (camera_vit, "packed_attention", functools.partial(
               attention_packed.packed_attention_plain, mxu_bf16=True)),
           (camera_vit, "attention", _flash_plain_bf16)]
    if with_blocks:
        out.append((transformer, "mha_block", _mha_plain_bf16))
    return out


# bf16 route gates. Both routes round the same operands to bf16; the sums
# run in other orders, and now and then that flips one rounding by a bf16
# step, which later layers carry on. Q and the losses: within 2^-5 of
# their largest value (8 bf16 steps); each gradient within 16 bf16 steps of
# the larger of its tensor's largest entry and 1/16 of the network's.
BF16_Q_GATE = 2.0 ** -5
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_STEPS = 16
# The near-tie bound of a VQ route comparison under bf16 (``_HeldCodes``):
# the plain route's own code may differ from the kernels' route's only where
# its distance gap lies within 2^-5 of the distances' scale |z|^2 + |c|^2.
# Features that differ by d (one bf16 rounding flipped somewhere upstream)
# move the gap between codes h and o by at most 2 |d| |o - h|; at d within 4
# bf16 steps of |z| that stays under 2^-5 of the scale. The f32 routes keep
# 1e-5.
BF16_TIE = 2.0 ** -5
# A learn step's three forwards at batch 128 and its backward: arm A (the
# fused blocks on their plain version), arm B and the ViT trunk.
LEARN_ROUTE_BF16 = _bf16_counts({"conv_prelu": 15, "scatter_max": 3,
                                 "scatter_max_bwd": SCATTER_BWD_PER_STEP})
LEARN_ROUTE_BF16_B = _bf16_counts(LEARN_ROUTE_B)
LEARN_ROUTE_BF16_VIT = _bf16_counts(LEARN_ROUTE_VIT)


def compare_act_routes_bf16(name, cfg, state, expected=None):
    """Q of the carried observations through the kernels and through their
    plain versions (the fused blocks' bf16-mode one), the same channel
    noise: within ``BF16_Q_GATE`` of the largest |Q|; the greedy actions
    equal but where the plain route's best two lie within twice that."""
    import torch

    from multimodal_sc_torch.codec import semantic_vq
    from multimodal_sc_torch.rl import dqn

    g = torch.Generator(device="cuda").manual_seed(23)
    obs = (dqn.dequantize_image(state.obs_image), state.obs_points,
           state.obs_mask)
    noise = _link_noise(cfg, obs[0].shape[0], g)
    net = state.params
    # Over a digital link the plain route quantises to the kernels' codes.
    vq = "vq" in (cfg.camera.arch, cfg.lidar.arch)
    held = _HeldCodes(BF16_TIE)
    with torch.no_grad(), (mock.patch.object(
            semantic_vq, "vector_quantize", held) if vq
            else contextlib.nullcontext()):
        before = _read_counts()
        q_k = net(*obs, channel_noise=noise)
        ran = {k: v - before[k] for k, v in _read_counts().items()}
        if expected is None:
            expected = (EXPECTED_BF16_V2X if cfg.env.v2x_rays
                        else EXPECTED_BF16)
        _check_counts(ran, expected, 1, f"{name} act route")
        held.mode = "hold"
        before = _read_counts()
        with _patched(_plain_patches_bf16()):
            q_p = net(*obs, channel_noise=noise)
        if _read_counts() != before:
            raise RuntimeError(f"{name}: the plain act route launched a "
                               "kernel")
    if vq:
        print(f"  {name}, act route: the plain route picked the kernels' "
              f"route's codes at all but {held.held} of "
              f"{sum(c.numel() for c in held.codes)} tokens (near-ties: "
              f"largest gap {held.worst:.3e} of the distances' scale, bound "
              f"{BF16_TIE:.3e})", flush=True)
    tol = BF16_Q_GATE * q_p.abs().max().item()
    diff = (q_k - q_p).abs().max().item()
    top2 = q_p.topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) <= 2 * tol
    same = q_k.argmax(-1) == q_p.argmax(-1)
    print(f"  {name}, act route: kernels vs plain versions, Q max difference "
          f"{diff:.3e} (gate {tol:.3e}), greedy actions agree in "
          f"{100 * same.float().mean().item():.2f}% of {same.numel()} "
          f"({int((~same).sum())} differ, each at a near-tie)", flush=True)
    if diff > tol or not bool((same | near).all()):
        raise RuntimeError(f"{name}: the act routes differ past the gate")


def _compare_grads_bf16(what, net, loss_k, grads_k, loss_p, grads_p):
    """The bf16 route gates on a loss and its gradients; gradients f32."""
    import torch

    torch.testing.assert_close(loss_k, loss_p, atol=0.0,
                               rtol=BF16_LOSS_RTOL)
    floor = max(gp.abs().max().item() for gp in grads_p
                if gp is not None) / 16
    worst = (0.0, "")
    for (pname, _), gk, gp in zip(net.named_parameters(), grads_k, grads_p):
        if gk is None or gp is None:
            if gk is not gp:
                raise RuntimeError(f"{pname}: a gradient on one route only")
            continue
        if gk.dtype != torch.float32:
            raise RuntimeError(f"{pname}: gradient {gk.dtype}")
        scale = max(gp.abs().max().item(), floor)
        steps = (gk - gp).abs().max().item() / (2.0 ** -8 * scale)
        worst = max(worst, (steps, pname))
    print(f"  {what}, kernels vs plain versions (bf16): loss "
          f"{loss_k.item():.6f} vs {loss_p.item():.6f}; worst gradient "
          f"{worst[0]:.2f} bf16 steps ({worst[1]}), over {len(grads_k)} "
          "tensors", flush=True)
    if worst[0] > BF16_GRAD_STEPS:
        raise RuntimeError(f"{what}: {worst[1]} {worst[0]:.2f} bf16 steps "
                           f"apart, past {BF16_GRAD_STEPS}")


def _bf16_routes(cfg):
    """``_two_routes``, or over a digital link ``_vq_routes`` at the bf16
    near-tie bound."""
    if "vq" in (cfg.camera.arch, cfg.lidar.arch):
        return functools.partial(_vq_routes, tie=BF16_TIE)
    return _two_routes


def compare_learn_routes_bf16(cfg, state, expected=LEARN_ROUTE_BF16):
    """One TD loss and its gradients on a fixed batch and channel noise
    through the kernels and through their plain versions (bf16)."""
    import torch

    from multimodal_sc_torch.rl import dqn, replay

    bs = cfg.rl.batch_size
    g = torch.Generator(device="cuda").manual_seed(24)
    batch = dqn.dequantize_obs(cfg, replay.sample(
        state.buffer, None, bs, torch.arange(bs, device="cuda")))
    draws = dqn.LearnDraws(indices=torch.arange(bs, device="cuda"),
                           snr_db=None, noise_online=_link_noise(cfg, bs, g),
                           noise_target=_link_noise(cfg, bs, g),
                           noise_double=_link_noise(cfg, bs, g))
    forward = dqn.learner_forward(cfg)
    params = list(state.params.parameters())

    def loss_and_grads():
        loss = dqn._td_loss(cfg, forward, state.params, state.target_params,
                            batch, draws)
        return loss.detach(), torch.autograd.grad(loss, params,
                                                  allow_unused=True)

    _compare_grads_bf16("learn step", state.params, *_bf16_routes(cfg)(
        loss_and_grads, expected, "the bf16 learn step",
        _plain_patches_bf16(with_blocks=False)))


def compare_c1_routes_bf16(cfg, state, data):
    import torch

    from multimodal_sc_torch.train import jscc

    img = next(data)
    model = state.params
    g = torch.Generator(device="cuda").manual_seed(25)
    noise = torch.randn(C1_BATCH, model.k, 2, generator=g, device="cuda")
    snr = torch.full((C1_BATCH,), cfg.channel.snr_db, device="cuda")
    params = list(model.parameters())

    def loss_and_grads():
        recon, _ = jscc.reconstruct(cfg, model, img, snr, noise=noise)
        loss = (recon - img).square().mean()
        return loss.detach(), torch.autograd.grad(loss, params)

    _compare_grads_bf16("c1 bf16 train step", model, *_two_routes(
        loss_and_grads, EXPECTED_BF16_C1, "the c1 bf16 train step",
        _plain_patches_bf16(with_blocks=False)))


def compare_c3_routes_bf16(cfg, state, batches,
                           expected=EXPECTED_BF16_C3_CNN):
    import torch

    from multimodal_sc_torch.channel.digital import index_bits
    from multimodal_sc_torch.train import fusion_jscc as fj

    img, pts, mask, cls = next(batches)
    g = torch.Generator(device="cuda").manual_seed(26)
    model = state.params
    n_lid = (model.lidar.n_tokens * index_bits(model.lidar.vq_codes) // 2
             if cfg.lidar.arch == "vq" else model.lidar.k)
    noise = tuple(torch.randn(C3_BATCH, n, 2, generator=g, device="cuda")
                  for n in (model.camera.k, n_lid))
    snr = torch.full((C3_BATCH,), cfg.channel.snr_db, device="cuda")
    target = fj.bev_target(cfg, pts, mask, cls)
    params = list(model.parameters())

    def loss_and_grads():
        loss, _ = fj.loss_fn(cfg, model, img, pts, mask, target, snr,
                             channel_noise=noise)
        return loss.detach(), torch.autograd.grad(loss, params)

    what = f"c3 {cfg.camera.arch} bf16 train step"
    _compare_grads_bf16(what, model, *_bf16_routes(cfg)(
        loss_and_grads, expected, f"the {what}",
        _plain_patches_bf16(with_blocks=False)))


def compare_c1_vq_routes_bf16(cfg, state, data):
    """``compare_c1_vq_routes`` under train.bf16: the bf16 gates, the codes
    held at the bf16 near-tie bound."""
    import torch

    img = next(data)
    model = state.params
    g = torch.Generator(device="cuda").manual_seed(27)
    noise = torch.randn(C1_BATCH, model.bits_per_image // 2, 2, generator=g,
                        device="cuda")
    snr = torch.full((C1_BATCH,), cfg.channel.snr_db, device="cuda")
    params = list(model.parameters())

    def loss_and_grads():
        recon, aux = model(img, snr, noise=noise)
        loss = (recon - img).square().mean() + aux["vq_loss"]
        return loss.detach(), torch.autograd.grad(loss, params)

    _compare_grads_bf16("c1_vq bf16 train step", model, *_bf16_routes(cfg)(
        loss_and_grads, _bf16_counts(EXPECTED_C1_VQ),
        "the c1_vq bf16 train step", _plain_patches_bf16(with_blocks=False)))


def compare_c5_routes_bf16(cfg, state):
    """One PPO minibatch loss and its gradients on a fixed minibatch and
    channel noise, as the update runs it (the convs and the scatter on
    their kernels, the fused blocks on their plain version) and through
    the plain versions, under train.bf16; over a digital link on the
    kernels' route's codes."""
    import torch

    from multimodal_sc_torch.rl import dqn, ppo
    from multimodal_sc_torch.rl.perception import ActorCritic

    g = torch.Generator(device="cuda").manual_seed(28)
    forward = dqn.learner_forward(cfg, ActorCritic)
    net = state.params
    coef = ppo._entropy_coef(cfg, state.update)
    batch = _c5_minibatches(cfg, state)[0]
    noise = _link_noise(cfg, C5_LOSS_BATCH, g)
    params = list(net.parameters())
    expected = _bf16_counts({"conv_prelu": 4 if cfg.camera.arch == "vq"
                             else 5, "scatter_max": 1, "scatter_max_bwd": 1})

    def loss_and_grads():
        loss, _ = ppo._ppo_loss(cfg, forward, net, batch, coef,
                                channel_noise=noise)
        return loss.detach(), torch.autograd.grad(loss, params,
                                                  allow_unused=True)

    _compare_grads_bf16("PPO minibatch (bf16)", net, *_bf16_routes(cfg)(
        loss_and_grads, expected, "the bf16 c5 loss",
        _plain_patches_bf16(with_blocks=False)))


def _all_f32(what, *nets, opt=None):
    """Parameters (and an optimizer's moments) stay f32 under train.bf16."""
    import torch

    for net in nets:
        for name, p in net.named_parameters():
            if p.dtype != torch.float32:
                raise RuntimeError(f"{what}: parameter {name} is {p.dtype}")
    if opt is not None:
        for st in opt.state.values():
            for k, v in st.items():
                if torch.is_tensor(v) and v.is_floating_point() and \
                        v.dtype != torch.float32:
                    raise RuntimeError(f"{what}: optimizer {k} is {v.dtype}")


def bf16_paths(profile=False):
    """The train.bf16 paths at the presets' widths: c4 act-only and
    act+learn at 1024 envs (route comparisons, a checkpoint round trip),
    fog + V2X act-only, one c5 update, c1 train steps, c3-cnn train steps;
    then the attention kernels' paths: the c4 ViT trunk act-only and
    act+learn, c4 arm B act+learn, c3 arms P and F train steps; then the
    VQ codecs: c4_vq and c4_digital act-only and act+learn, one c5 digital
    update, c1_vq and c3_vq train steps; each with its route comparison.
    Returns the launches summed and each path's rate."""
    import torch

    totals, rates = {}, {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    print("main path (c4 act-only, train.bf16):", flush=True)
    launches, rates["c4 act-only"], cfg, state, iteration = drive_main_path(
        "c4 bf16", BF16, EXPECTED_BF16)
    add(launches)
    compare_act_routes_bf16("c4 bf16", cfg, state)
    if profile:
        print("profile (c4 act-only, train.bf16):", flush=True)
        profile_main_path(cfg, state, iteration)
    del state, iteration
    print("main path (c4 act+learn, arm A, train.bf16):", flush=True)
    launches, rates["c4 act+learn, arm A"], cfg, state, iteration = (
        drive_learn("c4 bf16 act+learn", BF16, EXPECTED_BF16_LEARN))
    add(launches)
    _all_f32("c4 bf16", state.params, state.target_params, state.ema_params,
             opt=state.opt_state)
    compare_learn_routes_bf16(cfg, state)
    compare_act_routes_bf16("c4 bf16 after learning", cfg, state)
    if profile:
        print("profile (c4 act+learn, train.bf16):", flush=True)
        profile_learn(cfg, state, iteration)
    del state, iteration
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        print("checkpoint round trip (c4, train.bf16):", flush=True)
        checkpoint_round_trip(ckpt_dir, BF16)
    torch.cuda.empty_cache()
    print("main path (c4 fog + V2X act-only, train.bf16):", flush=True)
    launches, rates["c4 fog + V2X act-only"], cfg, state, iteration = (
        drive_main_path("c4 fog + V2X bf16", FOG_V2X + BF16,
                        EXPECTED_BF16_V2X))
    add(launches)
    compare_act_routes_bf16("c4 fog + V2X bf16", cfg, state)
    if profile:
        print("profile (c4 fog + V2X act-only, train.bf16):", flush=True)
        profile_main_path(cfg, state, iteration)
    del state, iteration
    torch.cuda.empty_cache()
    print("main path (c5 PPO update, train.bf16):", flush=True)
    launches, rates["c5 update"], cfg, state, train_step = drive_c5(
        "c5 bf16", BF16, EXPECTED_BF16_C5)
    add(launches)
    _all_f32("c5 bf16", state.params, state.ema_params, opt=state.opt_state)
    if profile:
        print("profile (c5 PPO update, train.bf16):", flush=True)
        profile_c5(cfg, state, train_step)
    del state, train_step
    torch.cuda.empty_cache()
    print("main path (c1 CNN JSCC train, train.bf16):", flush=True)
    launches, rates["c1 train"], cfg, state, train_step, data = drive_c1(
        BF16, EXPECTED_BF16_C1, "c1 bf16")
    add(launches)
    _all_f32("c1 bf16", state.params, opt=state.opt_state)
    compare_c1_routes_bf16(cfg, state, data)
    if profile:
        print("profile (c1 CNN JSCC train, train.bf16):", flush=True)
        profile_c1(cfg, state, train_step, data)
    del state, train_step, data
    torch.cuda.empty_cache()
    name = "c3-cnn bf16"
    print(f"main path (c3 late-fusion train, {name}):", flush=True)
    launches, rates["c3-cnn train"], cfg, state, train_step, batches = (
        drive_c3(name, C3_CNN + BF16, EXPECTED_BF16_C3_CNN))
    add(launches)
    _all_f32(name, state.params, opt=state.opt_state)
    compare_c3_routes_bf16(cfg, state, batches)
    if profile:
        print(f"profile (c3 late-fusion train, {name}):", flush=True)
        profile_c3(cfg, state, train_step, batches)
    del state, train_step, batches
    torch.cuda.empty_cache()
    # The packed and flash attention kernels' bf16-I/O instances.
    name = "c4 ViT trunk bf16"
    print(f"main path ({name} act-only):", flush=True)
    launches, rates["c4 ViT act-only"], cfg, state, iteration = (
        drive_main_path(name, VIT + BF16, EXPECTED_BF16_VIT))
    add(launches)
    compare_act_routes_bf16(name, cfg, state, EXPECTED_BF16_VIT)
    if profile:
        print(f"profile ({name} act-only):", flush=True)
        profile_main_path(cfg, state, iteration)
    del state, iteration
    print(f"main path ({name} act+learn):", flush=True)
    launches, rates["c4 ViT act+learn"], cfg, state, iteration = (
        drive_learn(f"{name} act+learn", VIT + BF16, EXPECTED_BF16_VIT_LEARN))
    add(launches)
    _all_f32(name, state.params, state.target_params, state.ema_params,
             opt=state.opt_state)
    compare_learn_routes_bf16(cfg, state, LEARN_ROUTE_BF16_VIT)
    compare_act_routes_bf16(f"{name} after learning", cfg, state,
                            EXPECTED_BF16_VIT)
    if profile:
        print(f"profile ({name} act+learn):", flush=True)
        profile_learn(cfg, state, iteration)
    del state, iteration
    torch.cuda.empty_cache()
    name = "c4 arm B bf16: unfused fusion on packed_attention"
    print(f"main path (c4 act+learn, {name}):", flush=True)
    launches, rates["c4 act+learn, arm B"], cfg, state, iteration = (
        drive_learn(name, ARM_B + BF16, EXPECTED_BF16_LEARN_B))
    add(launches)
    _all_f32(name, state.params, state.target_params, state.ema_params,
             opt=state.opt_state)
    compare_learn_routes_bf16(cfg, state, LEARN_ROUTE_BF16_B)
    if profile:
        print(f"profile (c4 act+learn, {name}):", flush=True)
        profile_learn(cfg, state, iteration)
    del state, iteration
    torch.cuda.empty_cache()
    for key, name, overrides, expected in (
            ("c3 arm P train", "arm P bf16: ViT on packed_attention",
             C3_ARM_P, EXPECTED_BF16_C3_P),
            ("c3 arm F train", "arm F bf16: ViT dim 192 on flash_attention",
             C3_ARM_F, EXPECTED_BF16_C3_F)):
        print(f"main path (c3 late-fusion train, {name}):", flush=True)
        launches, rates[key], cfg, state, train_step, batches = drive_c3(
            name, overrides + BF16, expected)
        add(launches)
        _all_f32(name, state.params, opt=state.opt_state)
        compare_c3_routes_bf16(cfg, state, batches, expected)
        if profile:
            print(f"profile (c3 late-fusion train, {name}):", flush=True)
            profile_c3(cfg, state, train_step, batches)
        del state, train_step, batches
        torch.cuda.empty_cache()
    # The VQ codecs: their code features bf16-valued, the nearest-code
    # searches in f32, the route comparisons on the kernels' route's codes.
    for key, overrides, act_exp, learn_exp, route_exp in (
            ("c4_vq", VQ4, EXPECTED_VQ4, EXPECTED_VQ4_LEARN,
             LEARN_ROUTE_VQ4),
            ("c4_digital", C4_DIGITAL, EXPECTED_C4_DIGITAL,
             EXPECTED_C4_DIGITAL_LEARN, LEARN_ROUTE_C4_DIGITAL)):
        name = f"{key} bf16"
        print(f"main path ({name} act-only):", flush=True)
        launches, rates[f"{key} act-only"], cfg, state, iteration = (
            drive_main_path(name, overrides + BF16, _bf16_counts(act_exp)))
        add(launches)
        compare_act_routes_bf16(name, cfg, state, _bf16_counts(act_exp))
        if profile:
            print(f"profile ({name} act-only):", flush=True)
            profile_main_path(cfg, state, iteration)
        del state, iteration
        print(f"main path ({name} act+learn):", flush=True)
        launches, rates[f"{key} act+learn"], cfg, state, iteration = (
            drive_learn(f"{name} act+learn", overrides + BF16,
                        _bf16_counts(learn_exp)))
        add(launches)
        _all_f32(name, state.params, state.target_params, state.ema_params,
                 opt=state.opt_state)
        compare_learn_routes_bf16(cfg, state, _bf16_counts(route_exp))
        compare_act_routes_bf16(f"{name} after learning", cfg, state,
                                _bf16_counts(act_exp))
        if profile:
            print(f"profile ({name} act+learn):", flush=True)
            profile_learn(cfg, state, iteration)
        del state, iteration
        torch.cuda.empty_cache()
    name = "c5 digital bf16"
    print(f"main path ({name}: PPO update over both digital links):",
          flush=True)
    launches, rates["c5 digital update"], cfg, state, train_step = drive_c5(
        name, C5_DIGITAL + BF16, _bf16_counts(EXPECTED_C5_DIGITAL))
    add(launches)
    _all_f32(name, state.params, state.ema_params, opt=state.opt_state)
    compare_c5_routes_bf16(cfg, state)
    if profile:
        print(f"profile ({name}):", flush=True)
        profile_c5(cfg, state, train_step)
    del state, train_step
    torch.cuda.empty_cache()
    name = "c1_vq bf16"
    print(f"main path ({name} digital camera JSCC train):", flush=True)
    launches, rates["c1_vq train"], cfg, state, train_step, data = (
        drive_c1_vq(C1_VQ + BF16, _bf16_counts(EXPECTED_C1_VQ), name))
    add(launches)
    _all_f32(name, state.params, opt=state.opt_state)
    compare_c1_vq_routes_bf16(cfg, state, data)
    if profile:
        print(f"profile ({name} train):", flush=True)
        profile_c1(cfg, state, train_step, data)
    del state, train_step, data
    torch.cuda.empty_cache()
    name = "c3_vq bf16: digital LiDAR codec, ViT on packed_attention"
    print(f"main path (c3 late-fusion train, {name}):", flush=True)
    launches, rates["c3_vq train"], cfg, state, train_step, batches = (
        drive_c3(name, C3_VQ + BF16, EXPECTED_BF16_C3_P))
    add(launches)
    _all_f32(name, state.params, opt=state.opt_state)
    compare_c3_routes_bf16(cfg, state, batches, EXPECTED_BF16_C3_P)
    if profile:
        print(f"profile (c3 late-fusion train, {name}):", flush=True)
        profile_c3(cfg, state, train_step, batches)
    del state, train_step, batches
    torch.cuda.empty_cache()
    return totals, rates


# The distributed phase. (a) runs DIST_WARM + DIST_TIMED iterations: the
# replay warms at iteration 3 (n_step 3), so the timed ones all learn.
DIST_WARM = 4
DIST_TIMED = 20
DIST_RANK_ENVS = 512
DIST_RANK_ITERS = 8
DIST_TIMEOUT_S = 400
DIST_ATTN_SHAPE = (64, 4, 256, 32)
DIST_TP_LR = 1e-2
# (f) c1_vq with usage and re-seeding at c1's global batch.
DIST_VQ = C1_VQ + ["camera.vq_usage_coef=0.1", "camera.vq_reseed=0.3"]
DIST_VQ_BATCH = 64
# (g) and (h): c5 cut to 16 steps of rollout and one epoch of two
# minibatch steps an update.
DIST_C5_CUT = ["rl.rollout_length=16", "rl.ppo_epochs=1",
               "rl.num_minibatches=2"]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _flat_cpu(net):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in net.parameters()]).cpu()


@contextlib.contextmanager
def _exact_cuda():
    """TF32 off and cuDNN deterministic for the bit-equal comparisons."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


def dist_world_of_one():
    """(a) The sharded c4 iteration on a process group of one (NCCL)
    against ``rl/dqn.py``'s, bit for bit; returns the sharded run's
    launches and both rates."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.rl import dqn, dqn_sharded
    from multimodal_sc_torch.runtime.mesh import make_mesh

    cfg = get_preset("c4")
    mesh = make_mesh()
    runs = {"single-card": [dqn.init(cfg, 0, NUM_ENVS, "cuda"),
                            dqn.make_iteration(cfg), [], 0.0],
            "sharded": [dqn_sharded.init(cfg, 0, mesh, NUM_ENVS, "cuda"),
                        dqn_sharded.make_iteration(cfg, mesh), [], 0.0]}

    def advance(name, iters, timed):
        run = runs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            run[0], metrics = run[1](run[0])
            run[2].append(metrics)
        torch.cuda.synchronize()
        if timed:
            run[3] += time.perf_counter() - t0

    for name in runs:
        advance(name, DIST_WARM, False)
    # The timed iterations in turns (single, sharded, sharded, single); the
    # two states draw from generators of their own, so the order leaves
    # their results alone.
    launches = dict.fromkeys(_read_counts(), 0)
    half = DIST_TIMED // 2
    for name in ("single-card", "sharded", "sharded", "single-card"):
        _reset_counts()
        advance(name, half, True)
        if name == "sharded":
            for k, v in _read_counts().items():
                launches[k] += v
    rates = {}
    for name, (state, _, _, wall) in runs.items():
        rates[name] = 2 * half * NUM_ENVS / wall
        print(f"  {name}: {2 * half} act+learn iterations x {NUM_ENVS} "
              f"envs in {wall:.3f} s = {rates[name]:.1f} agent steps/s; "
              f"learn steps {state.step}", flush=True)
    a, b = (dqn_sharded.from_dqn_state(runs["single-card"][0]),
            runs["sharded"][0])
    ha, hb = runs["single-card"][2], runs["sharded"][2]
    rate_a, rate_b = rates["single-card"], rates["sharded"]
    if a.step != DIST_WARM + 2 * half - (cfg.rl.n_step - 1):
        raise RuntimeError(f"world of one: {a.step} learn steps")
    for name in ("params", "target_params", "ema_params"):
        if not torch.equal(_flat_cpu(getattr(a, name)),
                           _flat_cpu(getattr(b, name))):
            raise RuntimeError(f"world of one: {name} differ")
    for x, y in zip(a.buffer_data, b.buffer_data):
        if not torch.equal(x, y):
            raise RuntimeError("world of one: the replay differs")
    if (a.buffer_size, a.buffer_cursor) != (b.buffer_size, b.buffer_cursor):
        raise RuntimeError("world of one: replay size or cursor differ")
    if not torch.equal(a.keys.get_state(), b.keys.get_state()):
        raise RuntimeError("world of one: the generators differ")
    for i, (ma, mb) in enumerate(zip(ha, hb)):
        for k in ma:
            if not torch.equal(ma[k], mb[k]):
                raise RuntimeError(f"world of one: iteration {i} metric {k}: "
                                   f"{float(ma[k])} vs {float(mb[k])}")
    print(f"  bit-equal: parameters, target, EMA, replay "
          f"({b.buffer_size} rows), generator and {len(ha)} iterations' "
          "metrics", flush=True)
    print(f"  sharded run's launches: {launches}", flush=True)
    _check_counts(launches, EXPECTED_LEARN_A, 2 * half, "world of one")
    return launches, rate_a, rate_b


def dist_ring_attention():
    """(c) Ring and Ulysses attention on the process group of one against
    ``attention_reference``, outputs and gradients."""
    import torch

    from multimodal_sc_torch.kernels.attention import attention_reference
    from multimodal_sc_torch.kernels.ring_attention import (
        ring_attention, shard_sequence, ulysses_attention)
    from multimodal_sc_torch.runtime.mesh import make_mesh

    mesh = make_mesh()
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, go = (torch.randn(DIST_ATTN_SHAPE, generator=g, device="cuda")
                   for _ in range(4))
    ref_in = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = attention_reference(*ref_in)
    ref.backward(go)
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        xs = [shard_sequence(t, mesh).clone().requires_grad_(True)
              for t in (q, k, v)]
        out = fn(*xs, mesh)
        out.backward(go)
        err = (out - ref).abs().max().item()
        gerr = max((x.grad - r.grad).abs().max().item()
                   for x, r in zip(xs, ref_in))
        print(f"  {name} attention at {DIST_ATTN_SHAPE}: max |out - ref| "
              f"{err:.3e}, max |grad - ref| {gerr:.3e}", flush=True)
        if err > 2e-5 or gerr > 1e-3:
            raise RuntimeError(f"{name} attention disagrees with "
                               "attention_reference")


def _c1_dist_inputs():
    """The c1 preset's state dict, one global batch and its draws, and the
    one-process step's parameters and metrics on the card (TF32 off)."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.envs.datasets import ImageDataset
    from multimodal_sc_torch.train import jscc

    cfg = get_preset("c1")
    state = jscc.create_train_state(cfg, 0, "cuda")
    sd = {k: v.detach().cpu().numpy().copy()
          for k, v in state.params.state_dict().items()}
    img = next(ImageDataset(cfg.train.dataset, C1_BATCH, seed=3,
                            device="cuda"))
    draws = jscc.draw_step(cfg, C1_BATCH, state.generator, "cuda")
    with torch.no_grad():
        z = state.params.encode(img, draws.snr_db)
    noise = torch.randn(z.shape, generator=state.generator, device="cuda")
    draws = draws._replace(channel=noise)
    state, metrics = jscc.make_train_step(cfg)(state, img, draws)
    want = {k: v.detach().cpu() for k, v in state.params.state_dict().items()}
    inputs = {"sd": sd, "img": img.cpu().numpy(),
              "snr_db": draws.snr_db.cpu().numpy(),
              "noise": noise.cpu().numpy()}
    return inputs, want, {k: float(v) for k, v in metrics.items()}


def _c1_vq_dist_inputs():
    """(f)'s inputs (the c1_vq state dict, one global batch, its SNR,
    channel noise and re-seeding coin) and the one-process step's
    parameters and metrics on the card (TF32 off)."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.envs.datasets import ImageDataset
    from multimodal_sc_torch.train import jscc

    cfg = get_preset("c1").override_str(DIST_VQ)
    state = jscc.create_train_state(cfg, 0, "cuda")
    sd = {k: v.detach().cpu().numpy().copy()
          for k, v in state.params.state_dict().items()}
    img = next(ImageDataset(cfg.train.dataset, DIST_VQ_BATCH, seed=4,
                            device="cuda"))
    g = state.generator
    draws = jscc.StepDraws(
        snr_db=torch.full((DIST_VQ_BATCH,), cfg.channel.snr_db,
                          device="cuda"),
        channel=torch.randn(DIST_VQ_BATCH, state.params.bits_per_image // 2,
                            2, generator=g, device="cuda"),
        coin=torch.rand(cfg.camera.vq_codes, generator=g, device="cuda"))
    state, metrics = jscc.make_train_step(cfg)(state, img, draws)
    want = {k: v.detach().cpu() for k, v in state.params.state_dict().items()}
    inputs = {"sd": sd, "img": img.cpu().numpy(),
              **{k: getattr(draws, k).cpu().numpy()
                 for k in ("snr_db", "channel", "coin")}}
    return inputs, want, {k: float(v) for k, v in metrics.items()}


def _c1_vq_rank_step(inputs):
    """(f) on this rank: the c1_vq step on its rows of the global batch
    and draws; the parameters and metrics after it."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.runtime.mesh import make_mesh, shard_batch
    from multimodal_sc_torch.train import jscc

    cfg = get_preset("c1").override_str(DIST_VQ)
    mesh = make_mesh()
    st = jscc.create_train_state(cfg, 0, "cuda")
    st.params.load_state_dict({k: torch.tensor(v)
                               for k, v in inputs["sd"].items()})
    draws = jscc.StepDraws(**{k: torch.tensor(inputs[k], device="cuda")
                              for k in ("snr_db", "channel", "coin")})
    st, m = jscc.make_train_step(cfg, mesh=mesh)(
        st, shard_batch(mesh, torch.tensor(inputs["img"], device="cuda")),
        draws)
    return {"params": {k: v.detach().cpu().numpy()
                       for k, v in st.params.state_dict().items()},
            "metrics": {k: float(v) for k, v in m.items()}}


def _c5_tp_run(ckpt_dir, steps):
    """``train.ppo.run`` at data 1 x model 2 with a checkpoint after every
    update: this rank's slices of the network and its update count."""
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.train import ppo as train_ppo

    cfg = get_preset("c5").override_str(DIST_C5_CUT + [
        "mesh.model_axis=2", f"train.steps={steps}",
        "train.checkpoint_every=1", f"train.checkpoint_dir={ckpt_dir}"])
    state, _ = train_ppo.run(cfg, device="cuda")
    return _flat_cpu(state.params), state.update


def _c5_tp_checkpoint(tmpdir):
    """(g) on this rank: two TP updates with a checkpoint after each,
    against one update, a stop and a resume (the runs' checkpoint
    directories under ``tmpdir``, which rank 0 writes and both ranks
    read). Returns whether this rank's slices agree bit for bit and the
    update counts."""
    import os

    import torch

    whole = _c5_tp_run(os.path.join(tmpdir, "whole"), 2)
    _c5_tp_run(os.path.join(tmpdir, "stopped"), 1)
    resumed = _c5_tp_run(os.path.join(tmpdir, "stopped"), 2)
    return {"equal": bool(torch.equal(whole[0], resumed[0])),
            "updates": (whole[1], resumed[1])}


def _c5_digital_rank_update():
    """(h) on this rank: one c5 digital update at data 2 (both codebooks
    re-seeding, the LiDAR one under its usage loss), each rank stepping
    half the envs; whether the replicas are bit-equal after it, and its
    metrics."""
    import torch
    import torch.distributed as dist

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.rl import ppo
    from multimodal_sc_torch.runtime.mesh import make_mesh

    cfg = get_preset("c5").override_str(C5_DIGITAL + DIST_C5_CUT)
    mesh = make_mesh()
    state = ppo.init(cfg, 0, "cuda", mesh)
    state, metrics = ppo.make_train_step(cfg, mesh)(state)
    flat = _flat_cpu(state.params)
    parts = [torch.empty_like(flat) for _ in range(2)]
    dist.all_gather(parts, flat)
    return {"equal": bool(torch.equal(parts[0], parts[1])),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _tp_fusion_kw(cfg):
    """c4 arm B's ``FusionTransformer`` arguments and its (camera, LiDAR)
    token counts."""
    hw, bev = cfg.camera.image_hw, cfg.lidar.bev_hw
    kw = dict(cam_in=cfg.fusion.dim, lid_in=cfg.lidar.pillar_dim,
              dim=cfg.fusion.dim, depth=cfg.fusion.depth,
              heads=cfg.fusion.heads, state_dim=cfg.fusion.state_dim,
              fused_block=False)
    return kw, ((hw[0] // 4) * (hw[1] // 4), bev[0] * bev[1])


def _tp_dist_inputs():
    """(e)'s inputs (a fusion transformer's state dict, camera and LiDAR
    tokens at the learner's batch, a target) and the replicated step's
    output, loss and parameters on the plain versions (TF32 off)."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.fusion.transformer import FusionTransformer

    kw, (lc, ll) = _tp_fusion_kw(get_preset("c4"))
    torch.manual_seed(0)
    net = FusionTransformer(**kw, use_pallas=False).cuda()
    g = torch.Generator(device="cuda").manual_seed(11)
    cam = torch.randn(LEARN_BATCH, lc, kw["cam_in"], generator=g,
                      device="cuda")
    lid = torch.randn(LEARN_BATCH, ll, kw["lid_in"], generator=g,
                      device="cuda")
    tgt = torch.randn(LEARN_BATCH, kw["state_dim"], generator=g,
                      device="cuda")
    inputs = {"sd": {k: v.detach().cpu().numpy().copy()
                     for k, v in net.state_dict().items()},
              "cam": cam.cpu().numpy(), "lid": lid.cpu().numpy(),
              "tgt": tgt.cpu().numpy()}
    y = net(cam, lid)
    loss = (y - tgt).square().mean()
    params = list(net.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    with torch.no_grad():
        for p, gr in zip(params, grads):
            if gr is not None:
                p -= DIST_TP_LR * gr
    want = {"y": y.detach().cpu(), "loss": float(loss.detach()),
            "params": {k: p.detach().cpu() for k, p in net.named_parameters()}}
    return inputs, want


def _tp_rank_step(tp_inputs):
    """(e) on this rank: the fusion transformer under TP at data 1 x model
    2 on the card, its forward and one SGD step; the output, the loss, the
    updated parameters gathered whole, the local head count and the
    launches of the forward and backward."""
    import torch
    import torch.distributed as dist

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.fusion.transformer import FusionTransformer
    from multimodal_sc_torch.runtime.mesh import make_mesh
    from multimodal_sc_torch.runtime.tp import apply_tp, tp_param_shardings

    kw, _ = _tp_fusion_kw(get_preset("c4"))
    mesh = make_mesh(data=1, model=2)
    net = FusionTransformer(**kw, use_pallas=True)
    net.load_state_dict({k: torch.tensor(v)
                         for k, v in tp_inputs["sd"].items()})
    net.cuda()
    specs = tp_param_shardings(net)
    apply_tp(net, mesh)
    cam, lid, tgt = (torch.tensor(tp_inputs[k], device="cuda")
                     for k in ("cam", "lid", "tgt"))
    _reset_counts()
    y = net(cam, lid)
    loss = (y - tgt).square().mean()
    params = list(net.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    torch.cuda.synchronize()
    launches = _read_counts()
    with torch.no_grad():
        for p, g in zip(params, grads):
            if g is not None:
                p -= DIST_TP_LR * g
    full = {}
    for name, p in net.named_parameters():
        t = p.detach()
        if specs[name]:
            parts = [torch.empty_like(t) for _ in range(mesh.model)]
            dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
            t = torch.cat(parts, dim=0 if specs[name][0] is None else 1)
        full[name] = t.cpu().numpy()
    attn = net.layer0.cam2lid
    return {"y": y.detach().cpu().numpy(), "loss": float(loss.detach()),
            "params": full, "heads": attn.heads,
            "head_dim": attn.dim // attn.heads, "lk": lid.shape[1],
            "launches": {k: v for k, v in launches.items() if v}}


def _dist_rank(rank, world, init_method, c1_inputs, results):
    """One rank of (b), (d) and (e); puts ``(rank, ok, payload)``."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world)
        results.put((rank, True, _dist_rank_work(rank, c1_inputs)))
    except Exception:           # the parent reports the rank's traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _gloo_cuda_collectives():
    """The collectives the sharded path runs, each once on CUDA tensors
    over gloo (gloo copies them through the host); returns their names.
    ``all_to_all_single`` and point-to-point sends are not among them:
    gloo takes no CUDA tensor there (``scripts/gloo_cuda_probe.py``)."""
    import torch
    import torch.distributed as dist

    x = torch.ones(8, device="cuda")
    n = dist.get_world_size()
    dist.all_reduce(x)
    dist.broadcast(x, src=0)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x)
    dist.barrier()
    torch.cuda.synchronize()
    if not all(torch.equal(p, torch.full_like(x, float(n))) for p in parts):
        raise RuntimeError(f"gloo on CUDA tensors: all_gather read {parts}")
    return ["all_reduce", "broadcast", "all_gather", "barrier"]


def _dist_rank_work(rank, c1_inputs):
    import torch
    import torch.distributed as dist

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.rl import dqn_sharded
    from multimodal_sc_torch.runtime.mesh import make_mesh, shard_batch
    from multimodal_sc_torch.train import jscc

    out = {"collectives": _gloo_cuda_collectives()}
    # (b) The sharded c4 iteration, 512 envs on each rank.
    cfg = get_preset("c4")
    mesh = make_mesh()
    state = dqn_sharded.init(cfg, 0, mesh, DIST_RANK_ENVS, "cuda")
    iteration = dqn_sharded.make_iteration(cfg, mesh)
    def equal_across_ranks():
        flat = torch.cat([_flat_cpu(n) for n in (
            state.params, state.target_params, state.ema_params)])
        parts = [torch.empty_like(flat) for _ in range(2)]
        dist.all_gather(parts, flat)
        return bool(torch.equal(parts[0], parts[1]))

    equal, steps = [], 0
    for _ in range(DIST_RANK_ITERS):
        state, metrics = iteration(state)
        if state.step > steps:          # after every learn step
            steps = state.step
            equal.append(equal_across_ranks())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DIST_TIMED):
        state, metrics = iteration(state)
    torch.cuda.synchronize()
    out["rate"] = DIST_TIMED * DIST_RANK_ENVS / (time.perf_counter() - t0)
    equal.append(equal_across_ranks())
    out["equal"] = equal
    out["steps"] = state.step
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    # One gradient bucket's all-reduce: the QNetwork's f32 parameters.
    n = sum(p.numel() for p in state.params.parameters()) + 1
    bucket = torch.ones(n, device="cuda")
    for _ in range(2):
        dist.all_reduce(bucket)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        dist.all_reduce(bucket)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t0) / 10 * 1e3
    out["allreduce_bytes"] = n * 4
    del state, iteration, bucket
    torch.cuda.empty_cache()
    # (d) One c1 step on this rank's rows of the global batch.
    c1 = get_preset("c1")
    st = jscc.create_train_state(c1, 0, "cuda")
    st.params.load_state_dict({k: torch.tensor(v)
                               for k, v in c1_inputs["sd"].items()})
    step = jscc.make_train_step(c1, mesh=mesh)
    draws = jscc.StepDraws(
        snr_db=torch.tensor(c1_inputs["snr_db"], device="cuda"),
        channel=torch.tensor(c1_inputs["noise"], device="cuda"))
    st, m = step(st, shard_batch(mesh, torch.tensor(c1_inputs["img"],
                                                    device="cuda")), draws)
    # numpy through the queue: no tensor handles outlive the rank.
    out["c1_params"] = {k: v.detach().cpu().numpy()
                        for k, v in st.params.state_dict().items()}
    out["c1_metrics"] = {k: float(v) for k, v in m.items()}
    del st, step
    torch.cuda.empty_cache()
    # (e) One tensor-parallel step at data 1 x model 2.
    out["tp"] = _tp_rank_step(c1_inputs["tp"])
    torch.cuda.empty_cache()
    # (f) One c1_vq step on this rank's rows, its statistics pooled.
    out["c1_vq"] = _c1_vq_rank_step(c1_inputs["c1_vq"])
    # (g) c5 under TP: a checkpoint, a stop and a resume.
    out["tp_ckpt"] = _c5_tp_checkpoint(c1_inputs["tmpdir"])
    torch.cuda.empty_cache()
    # (h) One data-parallel c5 digital update.
    out["c5_digital"] = _c5_digital_rank_update()
    return out


def dist_two_ranks():
    """(b), (d)-(h): two spawned ranks on the card over gloo."""
    import multiprocessing as mp

    import torch

    from multimodal_sc_torch.kernels.attention_packed import packed_eligible

    with _exact_cuda():
        c1_inputs, c1_want, c1_metrics = _c1_dist_inputs()
        c1_inputs["tp"], tp_want = _tp_dist_inputs()
        c1_inputs["c1_vq"], vq_want, vq_metrics = _c1_vq_dist_inputs()
    tmp = tempfile.TemporaryDirectory()
    c1_inputs["tmpdir"] = tmp.name
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_dist_rank,
                         args=(r, 2, init, c1_inputs, results))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in procs:
            rank, ok, payload = results.get(timeout=DIST_TIMEOUT_S)
            (got.__setitem__(rank, payload) if ok
             else errors.append(f"rank {rank}:\n{payload}"))
            if errors:
                break
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        tmp.cleanup()
    if errors:
        raise RuntimeError("distributed phase: " + errors[0])
    print(f"  two ranks: {time.perf_counter() - t0:.1f} s with the spawn",
          flush=True)
    print(f"  gloo on CUDA tensors ran {got[0]['collectives']}", flush=True)
    for rank in (0, 1):
        r = got[rank]
        print(f"  rank {rank}: {r['steps']} learn steps, networks equal "
              f"across ranks after each: {r['equal']}; "
              f"{r['rate']:.1f} agent steps/s at {DIST_RANK_ENVS} envs; "
              f"gradient all-reduce of {r['allreduce_bytes']} bytes "
              f"{r['allreduce_ms']:.3f} ms", flush=True)
        if not r["equal"] or not all(r["equal"]):
            raise RuntimeError(f"rank {rank}: the networks diverged: "
                               f"{r['equal']}")
    if got[0]["metrics"] != got[1]["metrics"]:
        raise RuntimeError("the ranks' pooled metrics differ")
    # (d) Against the one-process step.
    worst = 0.0
    for rank in (0, 1):
        r = got[rank]
        for k, w in c1_metrics.items():
            if not math.isclose(r["c1_metrics"][k], w, rel_tol=1e-4,
                                abs_tol=1e-5):
                raise RuntimeError(f"c1 on two ranks: {k} "
                                   f"{r['c1_metrics'][k]} vs {w}")
        for k, w in c1_want.items():
            d = (torch.tensor(r["c1_params"][k]) - w).abs()
            worst = max(worst, d.max().item())
            if (d > 1e-5 + 1e-4 * w.abs()).any():
                raise RuntimeError(f"c1 on two ranks: {k} off by "
                                   f"{d.max().item():.3e}")
    print(f"  c1 step on two ranks against one process: metrics "
          f"{got[0]['c1_metrics']} vs {c1_metrics}; worst parameter "
          f"difference {worst:.3e}", flush=True)
    # (e) Against the replicated step on the plain versions.
    for rank in (0, 1):
        r = got[rank]["tp"]
        y_err = float((torch.tensor(r["y"]) - tp_want["y"]).abs().max())
        if not torch.allclose(torch.tensor(r["y"]), tp_want["y"], atol=1e-5,
                              rtol=1e-5):
            raise RuntimeError(f"TP step, rank {rank}: output off by "
                               f"{y_err:.3e}")
        if not math.isclose(r["loss"], tp_want["loss"], rel_tol=1e-5):
            raise RuntimeError(f"TP step, rank {rank}: loss {r['loss']} vs "
                               f"{tp_want['loss']}")
        p_err = 0.0
        for k, w in tp_want["params"].items():
            d = (torch.tensor(r["params"][k]) - w).abs()
            p_err = max(p_err, d.max().item())
            if (d > 1e-5 + 1e-4 * w.abs()).any():
                raise RuntimeError(f"TP step, rank {rank}: {k} off by "
                                   f"{d.max().item():.3e}")
        packed = packed_eligible(r["heads"], r["head_dim"], r["lk"])
        on = {k: v for k, v in r["launches"].items()
              if k.startswith(("packed_attention", "flash_attention"))}
        want_on = (("packed_attention_fwd", "packed_attention_bwd") if packed
                   else ("flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"))
        if sorted(on) != sorted(want_on):
            raise RuntimeError(f"TP step, rank {rank}: attention launches "
                               f"{on}, expected {want_on} "
                               f"(packed_eligible {packed})")
        print(f"  TP step (data 1 x model 2), rank {rank}: {r['heads']} "
              f"local heads of dim {r['head_dim']}, packed_eligible "
              f"{packed}; launches {r['launches']}; against the replicated "
              f"plain step: output {y_err:.3e}, loss {r['loss']:.7g} vs "
              f"{tp_want['loss']:.7g}, worst parameter {p_err:.3e}",
              flush=True)
    # (f) The c1_vq step against one process on the global batch.
    worst = 0.0
    for rank in (0, 1):
        r = got[rank]["c1_vq"]
        if r["metrics"].keys() != vq_metrics.keys():
            raise RuntimeError(f"c1_vq on two ranks: metrics "
                               f"{sorted(r['metrics'])}")
        for k, w in vq_metrics.items():
            if not math.isclose(r["metrics"][k], w, rel_tol=1e-4,
                                abs_tol=1e-5):
                raise RuntimeError(f"c1_vq on two ranks: {k} "
                                   f"{r['metrics'][k]} vs {w}")
        for k, w in vq_want.items():
            d = (torch.tensor(r["params"][k]) - w).abs()
            worst = max(worst, d.max().item())
            if (d > 1e-5 + 1e-4 * w.abs()).any():
                raise RuntimeError(f"c1_vq on two ranks: {k} off by "
                                   f"{d.max().item():.3e}")
    print(f"  (f) c1_vq step on two ranks against one process (usage and "
          f"re-seeding pooled): metrics {got[0]['c1_vq']['metrics']} vs "
          f"{vq_metrics}; worst parameter difference {worst:.3e}",
          flush=True)
    # (g) and (h): bit-equal resume under TP; replicas equal.
    for rank in (0, 1):
        r = got[rank]
        if not r["tp_ckpt"]["equal"] or r["tp_ckpt"]["updates"] != (2, 2):
            raise RuntimeError(f"c5 under TP, rank {rank}: the resumed run "
                               f"differs from the run without a stop "
                               f"({r['tp_ckpt']})")
        if not r["c5_digital"]["equal"]:
            raise RuntimeError(f"c5 digital on two data ranks, rank {rank}: "
                               "the replicas diverged")
        bad = [k for k, v in r["c5_digital"]["metrics"].items()
               if not math.isfinite(v)]
        if bad:
            raise RuntimeError(f"c5 digital on two data ranks: {bad} not "
                               "finite")
    if got[0]["c5_digital"]["metrics"] != got[1]["c5_digital"]["metrics"]:
        raise RuntimeError("c5 digital on two data ranks: the pooled "
                           "metrics differ")
    print(f"  (g) c5 at data 1 x model 2: two updates with a checkpoint "
          f"each, against one, a stop and a resume: each rank's slices "
          f"bit-equal; (h) a c5 digital update at data 2: replicas "
          f"bit-equal, metrics {got[0]['c5_digital']['metrics']}",
          flush=True)
    return got


def distributed_phase():
    """(a)-(d); returns (a)'s launches and the rates it printed."""
    import torch
    import torch.distributed as dist

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        print(" (a) world of one over NCCL, c4 act+learn at "
              f"{NUM_ENVS} envs:", flush=True)
        with _exact_cuda():
            launches, rate_single, rate_sharded = dist_world_of_one()
        torch.cuda.empty_cache()
        print(" (c) ring and Ulysses attention, world of one over NCCL:",
              flush=True)
        with _exact_cuda():
            dist_ring_attention()
    finally:
        dist.destroy_process_group()
    print(" (b) two ranks sharing the card over gloo, (d) one c1 step on "
          "them, (e) one TP step at data 1 x model 2, (f) one c1_vq step, "
          "(g) a c5 TP run resumed from its checkpoint and (h) one c5 "
          "digital update at data 2:", flush=True)
    got = dist_two_ranks()
    print(f"  distributed phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, {"single": rate_single, "sharded": rate_sharded,
                      "rank0": got[0]["rate"], "rank1": got[1]["rate"],
                      "allreduce_ms": got[0]["allreduce_ms"],
                      "allreduce_bytes": got[0]["allreduce_bytes"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also break each path's iteration time down by "
                         "layer and kernel, with the device's idle share")
    ap.add_argument("--route-check", metavar="DIR",
                    help="only compare the act and learner routes on the "
                         "observations of the c4 fog + V2X DQN checkpoint "
                         "in DIR")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    try:
        from multimodal_sc_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              "repository root", file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    built = _build.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if args.route_check:
        route_check(args.route_check)
        return 0
    for name, (_, log) in sorted(built.items()):
        for kernel, report in _ptxas_report(log):
            print(f"  {name}: {kernel}: {report}", flush=True)

    print("kernel checks (TF32 off):", flush=True)
    kernels = check_kernels()
    print("kernel checks, bf16 I/O (train.bf16; TF32 off):", flush=True)
    kernels += check_kernels_bf16()
    from multimodal_sc_torch.config import get_preset

    # Each path is driven with the counts set to 0 just before it and read
    # just after; a kernel's line reports its launches summed over the paths.
    print("main path (c4 act-only):", flush=True)
    launches, sps, cfg, state, iteration = drive_main_path()
    rates = {"act-only": sps}
    if args.profile:
        print("profile (c4 act-only):", flush=True)
        profile_main_path(cfg, state, iteration)
    del state, iteration
    totals = dict(launches)
    for name, overrides, expected in (
            ("arm A: c4 preset", [], EXPECTED_LEARN_A),
            ("arm B: unfused fusion on packed_attention", ARM_B,
             EXPECTED_LEARN_B)):
        print(f"main path (c4 act+learn, {name}):", flush=True)
        launches, rates[f"act+learn, {name}"], cfg, state, iteration = (
            drive_learn(name, overrides, expected))
        for k, v in launches.items():
            totals[k] += v
        if overrides:
            compare_learn_routes(cfg, state)
        if args.profile:
            print(f"profile (c4 act+learn, {name}):", flush=True)
            profile_learn(cfg, state, iteration)
        del state, iteration
        torch.cuda.empty_cache()
    c3_rates = {}
    for name, overrides, expected in (
            ("arm P: ViT on packed_attention", C3_ARM_P, EXPECTED_C3_P),
            ("arm F: ViT dim 192 on flash_attention", C3_ARM_F,
             EXPECTED_C3_F)):
        print(f"main path (c3 late-fusion train, {name}):", flush=True)
        launches, c3_rates[name], cfg, state, train_step, batches = drive_c3(
            name, overrides, expected)
        for k, v in launches.items():
            totals[k] += v
        compare_c3_routes(cfg, state, batches, expected)
        if args.profile:
            print(f"profile (c3 late-fusion train, {name}):", flush=True)
            profile_c3(cfg, state, train_step, batches)
        del state, train_step, batches
        torch.cuda.empty_cache()
    name = "c3_vq: digital LiDAR codec, ViT on packed_attention"
    print(f"main path (c3 late-fusion train, {name}):", flush=True)
    launches, c3_rates[name], cfg, state, train_step, batches = drive_c3(
        name, C3_VQ, EXPECTED_C3_P)
    for k, v in launches.items():
        totals[k] += v
    compare_c3_routes(cfg, state, batches, EXPECTED_C3_P)
    if args.profile:
        print(f"profile (c3 late-fusion train, {name}):", flush=True)
        profile_c3(cfg, state, train_step, batches)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        print("checkpoint round trip (c3_vq):", flush=True)
        c3_checkpoint_round_trip(ckpt_dir, cfg, state, batches)
    del state, train_step, batches
    torch.cuda.empty_cache()
    print("main path (c3_vq_prune: a train step, the BEV keep, SNR and "
          "entropy sweeps):", flush=True)
    for k, v in drive_c3_vq_prune().items():
        totals[k] += v
    torch.cuda.empty_cache()
    print("main path (c5 PPO update):", flush=True)
    launches, c5_rate, cfg, state, train_step = drive_c5()
    for k, v in launches.items():
        totals[k] += v
    compare_c5_routes(cfg, state)
    if args.profile:
        print("profile (c5 PPO update):", flush=True)
        profile_c5(cfg, state, train_step)
    del state, train_step
    torch.cuda.empty_cache()
    print("main path (c1 CNN JSCC train):", flush=True)
    launches, c1_rate, cfg, state, train_step, data = drive_c1()
    for k, v in launches.items():
        totals[k] += v
    compare_c1_routes(cfg, state, data)
    if args.profile:
        print("profile (c1 CNN JSCC train):", flush=True)
        profile_c1(cfg, state, train_step, data)
    del state, train_step, data
    torch.cuda.empty_cache()
    print("main path (c1_vq digital camera JSCC train):", flush=True)
    launches, c1_vq_rate, cfg, state, train_step, data = drive_c1_vq()
    for k, v in launches.items():
        totals[k] += v
    compare_c1_vq_routes(cfg, state, data)
    if args.profile:
        print("profile (c1_vq train):", flush=True)
        profile_c1(cfg, state, train_step, data)
    print("main path (c1_vq sweeps: uncoded, Hamming, soft Hamming, HARQ):",
          flush=True)
    for k, v in sweep_c1_vq(cfg, state).items():
        totals[k] += v
    del state, train_step, data
    torch.cuda.empty_cache()
    print("main path (c1_vq_prune and UEP: a train step each, the keep and "
          "UEP sweeps):", flush=True)
    for k, v in drive_c1_vq_prune_uep(args.profile).items():
        totals[k] += v
    torch.cuda.empty_cache()
    print("main path (c2 SNR-sweep JSCC train):", flush=True)
    launches, c2_rate, cfg, state, train_step, data = drive_c2()
    for k, v in launches.items():
        totals[k] += v
    compare_c2_routes(cfg, state, data)
    if args.profile:
        print("profile (c2 SNR-sweep JSCC train):", flush=True)
        profile_c1(cfg, state, train_step, data)
    print("main path (c2 channels and codecs, one step each):", flush=True)
    for k, v in drive_c2_variants(data).items():
        totals[k] += v
    print("main path (c2 sweep):", flush=True)
    for k, v in sweep_c2(cfg, state, data).items():
        totals[k] += v
    del state, train_step, data
    torch.cuda.empty_cache()
    name = "c3-cnn: CNN camera codec at 64x64"
    print(f"main path (c3 late-fusion train, {name}):", flush=True)
    launches, c3_rates[name], cfg, state, train_step, batches = drive_c3(
        name, C3_CNN, EXPECTED_C3_CNN)
    for k, v in launches.items():
        totals[k] += v
    compare_c3_routes(cfg, state, batches, EXPECTED_C3_CNN)
    if args.profile:
        print(f"profile (c3 late-fusion train, {name}):", flush=True)
        profile_c3(cfg, state, train_step, batches)
    del state, train_step, batches
    torch.cuda.empty_cache()
    for name, overrides, act_exp, learn_exp, route_exp in (
            ("c4 fog + V2X", FOG_V2X, EXPECTED_V2X, EXPECTED_V2X_LEARN,
             LEARN_ROUTE_V2X),
            ("c4 ViT trunk", VIT, EXPECTED_VIT, EXPECTED_VIT_LEARN,
             LEARN_ROUTE_VIT),
            ("c4_vq digital camera", VQ4, EXPECTED_VQ4, EXPECTED_VQ4_LEARN,
             LEARN_ROUTE_VQ4),
            ("c4_digital full-digital", C4_DIGITAL, EXPECTED_C4_DIGITAL,
             EXPECTED_C4_DIGITAL_LEARN, LEARN_ROUTE_C4_DIGITAL)):
        print(f"main path ({name} act-only):", flush=True)
        launches, rates[f"act-only, {name}"], cfg, state, iteration = (
            drive_main_path(name, overrides, act_exp))
        for k, v in launches.items():
            totals[k] += v
        if args.profile:
            print(f"profile ({name} act-only):", flush=True)
            profile_main_path(cfg, state, iteration)
        del state, iteration
        print(f"main path ({name} act+learn):", flush=True)
        launches, rates[f"act+learn, {name}"], cfg, state, iteration = (
            drive_learn(name, overrides, learn_exp))
        for k, v in launches.items():
            totals[k] += v
        compare_learn_routes(cfg, state, route_exp)
        compare_act_routes(name, cfg, state)
        if args.profile:
            print(f"profile ({name} act+learn):", flush=True)
            profile_learn(cfg, state, iteration)
        if cfg.lidar.arch == "vq":
            if args.profile:
                time_c4_digital_parts(cfg, state)
            check_reseed(name, cfg, state)
        del state, iteration
        torch.cuda.empty_cache()
    print("main path (c4_digital fog + V2X act-only, HARQ on all three "
          "links):", flush=True)
    for k, v in drive_c4_digital_v2x_harq().items():
        totals[k] += v
    torch.cuda.empty_cache()
    print("main path (c4_digital pruned trunk, an act and a learn step):",
          flush=True)
    for k, v in drive_c4_digital_prune().items():
        totals[k] += v
    torch.cuda.empty_cache()
    print("main path (c5 PPO update over both digital links):", flush=True)
    launches, c5_digital_rate, cfg, state, train_step = drive_c5(
        "c5 digital", C5_DIGITAL, EXPECTED_C5_DIGITAL)
    for k, v in launches.items():
        totals[k] += v
    compare_c5_routes(cfg, state)
    if args.profile:
        print("profile (c5 PPO update over both digital links):", flush=True)
        profile_c5(cfg, state, train_step)
    del state, train_step
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        print("checkpoint round trip (c4 fog + V2X):", flush=True)
        cfg = checkpoint_round_trip(ckpt_dir)
        torch.cuda.empty_cache()
        print("eval-policy (c4 fog + V2X, the restored EMA):", flush=True)
        for k, v in eval_policy_phase(cfg).items():
            totals[k] += v
    with tempfile.TemporaryDirectory() as ckpt_dir:
        print("checkpoint round trip (c4_vq):", flush=True)
        checkpoint_round_trip(ckpt_dir, VQ4)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        print("checkpoint round trip (c4_digital):", flush=True)
        checkpoint_round_trip(ckpt_dir, C4_DIGITAL)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        print("CLI and deployment (c4 at 1024 envs: show, train, "
              "eval-policy, export, the act verb):", flush=True)
        launches, cli_times = cli_c4_phase(work)
        for k, v in launches.items():
            totals[k] += v
        torch.cuda.empty_cache()
        print("CLI and deployment (c2: train, eval, export; "
              "api.reconstruct):", flush=True)
        for k, v in cli_c2_phase(work).items():
            totals[k] += v
        torch.cuda.empty_cache()
        print("CLI export (the c1_vq, c3 and c3_vq codecs):", flush=True)
        cli_codec_exports(work)
        torch.cuda.empty_cache()
    bf16_totals, bf16_rates = bf16_paths(args.profile)
    for k, v in bf16_totals.items():
        totals[k] += v
    print("distributed path (process mesh, sharded c4 DQN, ring and Ulysses "
          "attention, data-parallel c1):", flush=True)
    launches, dist_rates = distributed_phase()
    for k, v in launches.items():
        totals[k] += v
    for k in kernels:
        k["launches"] = totals[k["name"]]
        if k["name"] in OFF_PATH_KERNELS:
            print(f"{k['name']}: {k['launches']} launches on the main paths "
                  "(the f32 mode on bf16 tensors: no config passes "
                  "mxu_bf16=False); per path: "
                  f"{_OFF_PATH_SEEN.get(k['name'], {})}", flush=True)
        elif k["launches"] <= 0:
            raise RuntimeError(f"{k['name']} was launched on no main path")
    print(f"agent steps/s at {NUM_ENVS} envs on {card}: " + "; ".join(
        f"{k} {v:.1f}" for k, v in rates.items()), flush=True)
    print(f"c3 train steps/s at batch {C3_BATCH} on {card}: " + "; ".join(
        f"{k} {v:.2f}" for k, v in c3_rates.items()), flush=True)
    print(f"c5 env steps/s at {C5_ENVS} envs on {card}: {c5_rate:.1f} (over "
          f"both digital links {c5_digital_rate:.1f}); c1 "
          f"train steps/s at batch {C1_BATCH}: {c1_rate:.2f}; c2: "
          f"{c2_rate:.2f}; c1_vq: {c1_vq_rate:.2f}", flush=True)
    print(f"CLI on {card}: c4 cli train {cli_times['cli train steps/s']} "
          f"agent steps/s at {NUM_ENVS} envs (train.dqn's script "
          f"{cli_times['module main steps/s']}); exported c4 policy "
          f"{cli_times['artifact ms']:.3f} ms a call at B {NUM_ENVS}, the "
          f"live kernels {cli_times['live ms']:.3f} ms; export "
          f"{cli_times['export s']:.1f} s, load {cli_times['load s']:.2f} s",
          flush=True)
    f32_rates = {"c4 act-only": rates["act-only"],
                 "c4 act+learn, arm A": rates["act+learn, arm A: c4 preset"],
                 "c4 fog + V2X act-only": rates["act-only, c4 fog + V2X"],
                 "c5 update": c5_rate, "c1 train": c1_rate,
                 "c3-cnn train": c3_rates["c3-cnn: CNN camera codec at 64x64"],
                 "c4 ViT act-only": rates["act-only, c4 ViT trunk"],
                 "c4 ViT act+learn": rates["act+learn, c4 ViT trunk"],
                 "c4 act+learn, arm B": rates[
                     "act+learn, arm B: unfused fusion on packed_attention"],
                 "c3 arm P train": c3_rates["arm P: ViT on packed_attention"],
                 "c3 arm F train": c3_rates[
                     "arm F: ViT dim 192 on flash_attention"],
                 "c4_vq act-only": rates["act-only, c4_vq digital camera"],
                 "c4_vq act+learn": rates["act+learn, c4_vq digital camera"],
                 "c4_digital act-only": rates[
                     "act-only, c4_digital full-digital"],
                 "c4_digital act+learn": rates[
                     "act+learn, c4_digital full-digital"],
                 "c5 digital update": c5_digital_rate,
                 "c1_vq train": c1_vq_rate,
                 "c3_vq train": c3_rates[
                     "c3_vq: digital LiDAR codec, ViT on packed_attention"]}
    print(f"train.bf16 against f32 in this call on {card} (agent or env "
          "steps/s, train steps/s): " + "; ".join(
              f"{k} {bf16_rates[k]:.2f} vs {f32_rates[k]:.2f} "
              f"({bf16_rates[k] / f32_rates[k]:.3f}x)" for k in bf16_rates),
          flush=True)
    print(f"distributed on {card}: c4 act+learn at {NUM_ENVS} envs, "
          f"single-card {dist_rates['single']:.1f} vs sharded world of one "
          f"{dist_rates['sharded']:.1f} agent steps/s "
          f"({dist_rates['sharded'] / dist_rates['single']:.3f}x); two "
          f"gloo ranks sharing the card at {DIST_RANK_ENVS} envs each "
          f"{dist_rates['rank0']:.1f} and {dist_rates['rank1']:.1f} agent "
          f"steps/s; gradient all-reduce {dist_rates['allreduce_bytes']} "
          f"bytes in {dist_rates['allreduce_ms']:.3f} ms", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
