"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--before CSRC [CSRC ...]]

Drives the port (nerf_simple_tpu_torch) at the flagship width,
NerfMLP(Lp=10, Ld=4, H=256):

1. device: refuses to run without CUDA; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the six CUDA sources from csrc/, one nvcc each, all
   at once (csrc/fused_contract.cu, first run in phase 16, in a process
   of its own beside phases 3-15, waited for before phase 16); prints the
   build time and ptxas registers and spills (the forward tile kernels,
   csrc/fwd_f32.cuh and csrc/fwd_bf16.cuh, and the backward tile kernels,
   csrc/bwd_f32.cuh and csrc/bwd_bf16.cuh, are built into five of them;
   the forward tile kernels' contracted instantiations and the input
   gradient's contract instantiation into csrc/fused_contract.cu's alone;
   the input-gradient kernel, csrc/input_grad.cuh, into B2's);
3. forward kernel and render kernel (B3) vs plain: the fused MLP forward
   and the fused render (forward + compositing) against their plain
   PyTorch versions on one render chunk (16,384 rays of a 400x400, f=555
   frame x 128 stratified samples = 2,097,152 rows), f32 and bf16, with
   random weights from a numpy seed; the f32 forward's TFLOP/s and share
   of its bound beside one f32 torch.mm of the chunk's rows (TF32 off);
   with ``--before CSRC``, the earlier forward beside the current one in
   turns, f32 and bf16, bit-equal;
4. serve: the novel-view server over HTTP on localhost, three 400x400
   frames through the forward kernel, then the frame against the plain
   backend; then one frame through ``render_rays_chunked`` with
   ``fused_eval`` (the render kernel, ten chunks) against the forward
   kernel plus torch compositing, f32 and bf16;
5. backward (B2) and train step (B1) vs plain: at 524,288 rows (a
   4096-ray x 128-sample batch drawn from the synthetic scene), f32 and
   bf16: per-tensor gradient errors, loss error, CUDA-event times, and
   the train step's bitwise determinism; with ``--before CSRC`` (a copy
   of an earlier commit's csrc/, e.g. ``git archive <commit>
   nerf_simple_tpu_torch/csrc`` unpacked under a gitignored build/), the
   earlier train-step, forward and backward sources are built from it
   and B1 bf16 and f32 are timed beside the current ones, in turns (step
   ms and the profiled kernel groups; the f32 forward's times join the
   f32 line), and so are the f32 backward tile kernel alone (phase 6)
   and the whole bf16 train step of phase 7;
6. wgrad: the backward's twelve weight-gradient sums alone at 524,288
   rows (probes/wgrad.py), f32 and bf16: the kernel in one launch (as B1
   and B2 run it) and as twelve calls, against float64 sums, the plain
   version and the library call torch.mm + sum (timed, never used);
   then the backward tile kernel alone at 524,288 rows
   (probes/bwd_tile.py), f32 and bf16, against its plain version; with
   ``--before``, the earlier f32 tile kernel (and that of each further
   copy given: variants of it) beside the current one, in turns, and the
   max difference of their planes from the current ones;
7. train: writes the synthetic scene (25 train, 2 val, 2 test images at
   800x800 with their metric-depth sidecars, loaded at half resolution), trains through ``train()`` (what
   ``python -m nerf_simple_tpu_torch.train`` runs) with lego.yaml's keys,
   ``backend: pallas``, ``compute_dtype: bf16``; checks the launch count,
   the loss, the val PSNR, a resume and that the server serves the
   exported params; then a few f32 steps from one state through the
   fused step, the two-kernel autograd path (fused_mlp: forward kernel
   and B2) and the plain path, whose losses must agree, and which
   launch the f32 backward tile kernel once a kernel step; the bf16 step's
   wall and the host's time to issue it, its kernel time by kernel and
   the host's time by torch op (torch.profiler), and the device's idle
   share;
8. eval: ``evaluate.test`` (what ``python -m nerf_simple_tpu_torch.
   evaluate`` runs) on the trained scene's test split with lego.yaml's
   test_params, ``backend: pallas``, ``compute_dtype: bf16``: stills 0
   and 1 with their PSNR, normals of still 0, and the orbit video cut to
   ORBIT_POSES frames (lego.yaml asks for 30);
9. hierarchical (``configs/lego_hierarchical.yaml``: Nc = 64 coarse
   samples, Nf = 192 importance samples, the fine net on the union of
   256; two nets): (a) B1 with its weights output (``out_weights``)
   against its plain version at the coarse pass's 262,144 rows (N = 64)
   and the fine pass's 1,048,576 (N = 256), f32 and bf16, and B2 at
   1,048,576 rows (planes past 2^31 elements), with the peak device
   memory; (b) trains through ``train()`` with the config's keys (bf16,
   pallas), steps cut to 300 + 100 resumed: two B1 launches a step, the
   loss, val PSNR, the resume, the exported .pth (the fine net), the
   step's wall, its kernel time by pass (coarse B1, fine B1, sampling),
   the idle share, the allocator's footprint over 100 steps; then f32
   steps from one state through the fused two-pass core and the autograd
   path (fused_mlp: forward kernel and B2), under JAX's bin-flip rule;
   (c) ``evaluate.test`` with the config's ``test_params`` (Nc = 64,
   N_samples = 192; bf16, pallas) on the test split: PSNR, s a still, and
   ms a hierarchical 400x400 frame;
10. the regularisers: (a) B1 with its distortion rail (``dist``, lambda =
   0.01 as ``configs/colmap360.yaml``) against its plain version in
   linear and disparity space, f32 and bf16, at the training batch
   (524,288 rows) and the hierarchical fine pass (1,048,576 rows): loss
   and gradients to B1's bounds, B1 with and without the rail in turns,
   ``composite_grad``'s profiled ms with and without it beside its bound
   and its plain version; (b) trains 200 bf16 steps through ``train()``
   with each regulariser: lego.yaml's keys + ``distortion_loss_weight``
   (the fused step, one B1 launch a step, each with the rail; the trained
   field's distortion below that of phase 7's checkpoint at step 200,
   trained without it from the same seed), + ``depth_loss_weight`` (autograd through the
   forward kernel and B2; depth RMSE of a train view against the scene's
   metric depth falls), + ``sigma_noise`` (the same path), and
   lego_hierarchical.yaml's keys + ``distortion_loss_weight`` (the fine
   pass's B1 with the rail); each: the loss halves, ms a step, rays/s,
   the profile;
11. proposal sampling (``configs/lego_proposal.yaml``: a ProposalMLP(Lp=6,
   D=4, H=64) at Np = 64 probes places the main field's Nf = 128
   samples): (a) the fused proposal core (``train/step.py::
   proposal_fused_loss``) with the CUDA B1 against the same core with
   B1's plain version, one batch of 4096 rays, the same probes and
   samples, f32 and bf16, the rail off and at lambda = 0.01: loss, both
   nets' gradients and the main field's weights to B1's bounds, one B1
   launch with the weights output and the rail together; B1 at that
   batch with both, the weights alone and neither, in turns; the core's
   other pieces alone (the proposal MLP, the sampling, the interlevel
   loss); (b) trains the config's keys + ``distortion_loss_weight: 0.01``
   through ``train()`` (bf16, pallas), 300 + 100 resumed steps: one B1
   launch a step with the weights and the rail, the loss halves, val PSNR
   rises, the interlevel loss of 4096 held-out val rays falls from step
   50 to step 300; the step's wall, host issue, kernel time by pass and
   idle share, the allocator's peak; f32 fused and autograd steps from
   one state under JAX's rule; (c) ``evaluate.test`` with its
   ``test_params`` (Np = 64, N_samples = 128): PSNR, s a still, ms a
   proposal 400x400 frame; (d) ``python -m nerf_simple_tpu_torch.serve
   --proposal-samples 64`` in a process of its own serves one frame over
   HTTP, which matches ``render_rays_chunked`` to 1 level;
12. mip cone casting (``configs/lego_mip.yaml``: mip_levels 2, one
   flagship net for both levels, Nf = 128 intervals a ray): (a) the
   cone-cast kernel variants against their plain versions, nets from
   ``derive_seed(0, 0)``, variances from the frames' real cone radii
   (2 / sqrt(12) / focal), f32 and bf16: the forward with the integrated
   encoder at a 2,097,152-row render chunk (and at zero variance bit-equal
   to the point forward), B1 with mip at the training batch (524,288 rows)
   plain, with the weights output, with the opaque tail, and with the
   interval rail and per-ray loss weights on row 14, B2 with mip on seeded
   cotangents, each with its ms and its plain version's; (b) trains the
   config's keys through ``train()`` (bf16, pallas), 300 + 100 resumed
   steps: two cone-cast B1 launches a step (``mip_launches`` 600, one of
   each pair with the weights output, 300), the loss halves, val PSNR
   rises; the step's wall, host issue, kernel time by pass (coarse B1,
   fine B1, between them, Adam; resample_edges and an x16 build alone)
   and idle share; f32 fused and autograd (forward kernel and B2, both
   with mip) steps from one state under JAX's rule; (c) ``evaluate.test``
   with its ``test_params``: PSNR, s a still, ms a two-level 400x400 mip
   frame; ``python -m nerf_simple_tpu_torch.serve --mip --mip-levels 2``
   in a process of its own serves one frame over HTTP, which matches
   ``render_rays_chunked`` to 1 level; with ``--before``, B1's point
   launch must be bit-equal to the earlier library's (phase 5b);
13. pose refinement (BARF: ``pose_opt``, ``pe_anneal_until``,
   ``pose_freeze_at`` with lego.yaml's keys): (a) the pose kernel variants
   against their plain versions, f32 and bf16: the forward with the anneal
   windows (alpha 0.3 and 1) at a 2,097,152-row chunk beside the forward
   without them (at alpha 1 bit-equal to it), B2 with ``want_dx`` at the
   training batch with and without the windows (its weight gradients
   bit-equal to the launch without ``want_dx``), the input-gradient kernel
   alone (csrc/input_grad.cuh, probes/input_grad.py) beside its plain
   version and a torch.mm yardstick; with ``--before``, the forward and B2
   without the new arguments bit-equal to the earlier library's, and every
   instantiation of the input-gradient kernel beside the earlier one in
   turns (``probes/input_grad.py::before_after``: dx bit-equal to the
   earlier's in f32 and bf16, two launches bit-equal, the f32 and bf16 ms
   of both); (b) 300
   steps through ``train()`` with the freeze at 150: one forward and one B2
   launch with the input gradient a step before it (the windows until step
   100), one B1 launch a step after it; the pose step's wall, kernel ms by
   pass, idle share and peak memory; (c) the JAX package's recipe
   (scripts/pose_freeze_bench.py: 12 train images at 100x100 perturbed by
   0.02 rad / 0.05; 3000 steps, cut from its 4000) unrefined and refined (anneal
   and freeze at 3/8): test PSNR of both and the rig's residual error; the
   refined rotation must keep at most POSE_ROT_KEPT of the perturbation's
   (the translation is reported); an f32 pose step's loss and gradients
   (field, dr, dt) through the kernels against the xla step from one
   state, its one f32 input-gradient launch counted in C (the ``kernels``
   line's ``launches_f32``); (d) ``evaluate.test`` of the refined run's train stills from the
   checkpoint's live deltas and from the freeze's sidecar, beside the
   unrefined render;
14. appearance codes (``appearance_dim: 8`` with lego.yaml's keys): (a) the
   appearance variants against their plain versions at the training batch
   (524,288 rows, each ray's code in input rows 8..15), f32 and bf16: the
   forward with the code rows beside the forward through the model without
   codes (zero codes bit-equal to it), B2 with ``want_dx`` (dWca, the codes'
   rows of dx, held row by row as 13a holds the pose dx) beside B2 without
   codes, the input-gradient kernel alone with the code rows; with
   ``--before``, B2 with ``want_dx`` and no codes bit-equal to the earlier
   library's; (b) 100 steps through ``train()``: one forward and one B2
   launch with the code rows and the input gradient a step, no B1, the
   checkpoint and npz with the code table; ``evaluate.test`` under the mean
   code (with normals), under image 0's, and an orbit; the appearance step's
   wall, kernel ms by pass and idle share, a pose + appearance step's wall;
   60 steps each with ``pose_opt``, with lego_hierarchical.yaml's keys and
   with lego_proposal.yaml's, each evaluated under a code; (c) the JAX
   package's exposure-twin recipe at the flagship width: the loss with codes
   below 0.35 of the loss without, the twins' brightness ratio in (1.4, 2.3);
15. pose refinement with mip and with proposal: (a) the input gradient's mip
   instantiation (csrc/input_grad.cuh, ``MIP``) at the mip training batch
   (524,288 rows at the scene's cone radius), f32 and bf16: B2 with ``mip``
   and ``want_dx`` against plain by ``explain_dx``'s rule (the mean,
   direction and variance rows each held row by row, its two mip faults
   caught, the zero rows zero), its grads bit-equal to the launch without
   dx; the kernel alone against plain with two planted faults (the damp
   dropped, the variance rows halved), its ms beside the point kernel's,
   plain and the torch.mm yardstick, and its bound; with ``--before``, B2
   under mip without dx and the point B2 with dx bit-equal to the earlier
   library's; (b) lego_mip.yaml's keys + ``pose_opt`` (warmup 10, freeze at
   100) through ``train()`` for 150 steps on a copy of the phase-7 scene
   with perturbed train poses: two B2 launches with the mip input gradient
   a step before the freeze, the fused mip core after it, the loss falls,
   the rig's error before and after, the step's wall and profile by pass,
   a refined train still; (c) lego_proposal.yaml's keys + ``pose_opt`` +
   ``pe_anneal_until: 40`` for 60 steps with a mid-anneal preview: the
   loss falls, the deltas move, the step's wall;
16. scene contraction, on a scene of the ``unbounded`` style (30/2/2 views
   at 200x200, cameras at radius 3..6): (a) the forward tile kernels'
   contracted instantiations (csrc/fused_contract.cu) as the forward, B2,
   B1 (the 360 recipe's launch: weights output, disparity-space rail) and
   B3 run them at a 524,288-row batch of the scene (rows moved onto both
   sides of the unit sphere and out to |x| ~ 30), point and mip, f32 and
   bf16, against their plain versions; bit-equal to the launches without
   contract inside the unit ball; a planted fault caught; with and without
   contract in turns; with ``--before``, the forward and B2 without
   contract bit-equal to the earlier library's and every kernel of the
   earlier libraries the same SASS; (b) configs/colmap360.yaml's keys (the
   360 recipe) at the flagship width for 300 + 100 resumed steps, one
   contracted B1 launch a step; the step's wall and profile beside the
   recipe without contract; one f32 step fused against autograd; the recipe
   at a reduced width for 300 steps (the loss halves, the held-out
   interlevel loss falls); eval (a still, a 2-frame orbit), one frame
   served over HTTP, a single-net fused_eval frame; (c) mip + contract at
   two levels, 100 steps and a still;
17. pose refinement and appearance codes on a contracted model, on the
   same scene: (a) the input-gradient kernel's contract instantiation
   (csrc/fused_contract.cu) in B2 with ``want_dx`` at the 524,288-row
   batch, f32 and bf16, against plain by ``explain_dx``'s row rule (its
   planted faults, the contraction's two among them, caught), its grads
   bit-equal to the launch without dx, bit-equal inside the ball to B2
   without contract, also with the codes and the windows; the contracted
   forward with the windows and with the codes against plain; the kernel
   alone beside the kernel without contract, plain, a torch.mm yardstick
   and its bound; with ``--before``, the launches without contract
   bit-equal to the earlier library's; (b) configs/colmap360.yaml's keys
   with its pose block switched on, 120 steps with a freeze at 30 on a
   copy of the scene with perturbed train poses: the contract input
   gradient a step before the freeze, the fused 360 core after it, the
   loss, the rig's error, the step's wall and profile, a refined still;
   (c) the same keys + appearance codes + pose with the anneal, 40 steps,
   a still under the mean code; (d) the same keys without the proposal net
   on a single net (pose with a freeze, pose with the anneal, codes) and a
   hierarchical pair (pose, codes + pose), 40 steps each and a still each;
   the first one's export served over HTTP by the CLI, one frame;
18. the mip-NeRF 360 composition, on the same scene: (a) the input
   gradient's MIP && CONTRACT instantiation (csrc/fused_contract.cu) in B2
   with mip, ``contract`` and ``want_dx`` at the 524,288-row batch under
   mip, f32 and bf16, against plain by ``explain_dx``'s row rule, its
   grads bit-equal to the launch without dx, bit-equal inside the ball to
   B2 with mip without contract; with and without dx in turns; the kernel
   alone against plain with three planted faults of the coupled transpose,
   beside the MIP kernel on the same planes, plain, a torch.mm yardstick
   and its bound; with ``--before``, B2 with mip and dx without contract
   bit-equal to the earlier library's; (b) configs/colmap360.yaml + mip +
   the opaque background, 60 steps through the fused mip x proposal core
   (one contracted cone-cast B1 launch a step with the weights output, the
   interval rail and the opaque tail), the loss falls; the step's wall and
   profile; a still; one frame served over HTTP by the CLI with ``--mip
   --proposal-samples 64``; (c) the same + its pose block, 40 steps with a
   freeze at 20 on the perturbed copy of the scene: the MIP && CONTRACT
   input gradient a step before the freeze, the fused core after it, the
   pose step's wall and profile; (d) 20 steps each of pose + mip + contract
   (lego_mip.yaml's keys) and of pose + mip x proposal (lego_proposal.yaml's
   keys + mip, on the phase-7 scene);
19. multiscale training and the data options, on the phase-7 scene: (a)
   B1's cone-cast launch on a 524,288-row batch drawn from the scene's
   4-scale pyramid (each ray's own cone, its area weight on row 14)
   against plain, f32 and bf16; with row 14 at 1 and at twice the
   weights; (b) configs/lego_mip.yaml + mip_multiscale, 100 steps (two
   cone-cast B1 launches a step, counted in C), the loss falls; the
   step's wall, host time, profile and idle share; test image 0 at 1,
   1/2, 1/4 and 1/8 against block-mean gt beside phase 12's single-scale
   model; 20 steps of mip x proposal + multiscale; (c) 20 steps each on a
   tiny_nerf npz and on the hard scene;
20. occupancy-grid sampling and mesh export (``configs/lego_occ.yaml``:
   Nf 64 placed by a 64^3 EMA grid over [-2, 2]^3, 32 probe bins, a refresh
   every 16 steps), on the phase-7 scene: (a) the grid's density probe
   through the forward kernel at one refresh's 262,144 cell points, f32
   and bf16, against plain; ms of the probe, one refresh and the sampler;
   (b) the config's keys through ``train()`` for 300 steps (cut from
   10,000): one B1 launch a step at the sampler's ts, 19 refreshes, the
   loss falls; the step's wall, host issue, kernel ms by pass (B1, the
   refresh's forward, before / after B1, Adam) and idle share beside the
   same config without occupancy; a ``debug_nan`` step on NaN rays raises;
   (c) ``evaluate.test`` with its ``test_params`` (the grid rebuilt from
   the checkpoint, ``occ_group`` 4) on the 2 test images, PSNR no lower
   than stratified at the same N less 0.21 dB (JAX's mse rule); a
   ``fused_eval`` frame with the grid (B3) against the unfused one; a frame
   served over HTTP with ``occupancy``; (d) ``python -m
   nerf_simple_tpu_torch.export_mesh`` of the checkpoint at resolution 128:
   faces, a valid .obj, its seconds;
21. the padding probe (B4) at full reps: kernel vs plain for K = 40, 72,
   80, 128, ms a launch, TFLOP/s and the ratios.

Every failed check raises, so the script exits non-zero without its last
line. The line before the last is one JSON object with the kernels, each
with its bound (utils/roofline.py: the larger of its operations over the
card's peak rate and its bytes over the memory rate) and the time of one
PyTorch library call computing the same function where there is one; the
last names the device. The build and train logs go
to smoke_logs/.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import functools
import glob
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

import numpy as np
import torch

H = W = 400
FOCAL = 555.0
N = 128
CHUNK = 16384
SEED = 0
# Kernel vs plain, max abs error on raw rgb and sigma. f32: both sum the
# same f32 products in another order over nine chained layers (K <= 256):
# ~1e-6 relative each, so 2e-4 (the JAX kernel test's bound) is wide.
# bf16: a different summation order flips the bf16 rounding of an
# occasional activation by one ulp (2^-8 relative), which the later
# layers carry; 2e-3 bounds that at unit-scale outputs.
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-3}
# Served frame, pallas vs xla backend at f32, and fused_eval vs the
# forward kernel plus torch compositing: clipped rgb in [0, 1].
FRAME_TOL = 1e-3
# Disparity of the fused_eval frame against the unfused one, relative:
# both composite the same raw outputs, summed in another order (the JAX
# test's bound, tests/test_kernels.py:433).
DISP_RTOL = 2e-3
ORBIT_POSES = 10  # eval's orbit video, cut from lego.yaml's 30 frames
# B1/B2 gradients, per tensor: max abs error over the plain version's max
# abs value. B2 gets seeded random cotangents on every sample: its weight
# gradients are sums of random-sign terms over 524,288 rows, and both the
# kernel and the plain f32 version land ~1e-3 (of the largest entry) from
# a float64 reference there (measured on the card), so they differ from
# each other by as much. B1's cotangents come from the compositing; there
# f32 kernel and plain agree to ~5e-6. bf16 rounding moves every gradient
# 0.5-10% from f32, and kernel and plain differ by a fraction of that
# (tests/test_torch_cuda.py). Beside the bound, the kernel must be no
# farther than twice the plain version's distance from the float64 result.
GRAD_TOL = {("B2", torch.float32): 1e-2, ("B2", torch.bfloat16): 5e-2,
            ("B1", torch.float32): 1e-4, ("B1", torch.bfloat16): 2e-3}
LOSS_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}  # relative
# f32 training steps from one state, fused vs two-kernel vs plain:
# relative loss difference. The paths sum in other orders (~1e-6), and
# Adam's early updates are lr * sign(g) where g is near zero, so a
# weight whose gradient sign differs between paths moves 2 lr apart.
STEP_TOL = 1e-3
BATCH, N_SAMPLES = 4096, 128
NC, NF = 64, 192  # configs/lego_hierarchical.yaml: coarse samples, importance samples
# The hierarchical step, f32, fused two-pass core against the autograd
# path from one state after one step: the loss to 1e-4 relative, and JAX's
# bin-flip rule on the parameters (tests/test_kernels.py,
# test_fused_hierarchical_train_matches_generic): under 0.1% of them
# farther apart than 5e-5 + 1e-3 |p|. The two paths' coarse weights differ
# in the last bits, and a u on a CDF edge then picks another fine sample.
HIER_LOSS_RTOL, BIN_FLIP_SHARE = 1e-4, 1e-3
# The regularisers: the distortion weight of configs/colmap360.yaml (the
# JAX package's 360 recipe); the original NeRF's sigma noise std (1.0); a
# depth weight of the JAX package's tests; steps of each training run (cut
# from 300 to 200 to pay for phase 19; phase 7's run checkpoints at step
# 200, the field the distortion run is held against).
DIST_LAMBDA, SIGMA_NOISE, DEPTH_WEIGHT, REG_ITERS = 0.01, 1.0, 0.1, 200
# configs/lego_proposal.yaml: proposal probes a ray (Nf = N_SAMPLES main
# samples). Its f32 fused and autograd steps from one state: JAX's rule
# (tests/test_proposal.py, test_proposal_fused_matches_xla): loss rtol
# 1e-4, every parameter within atol 5e-5 + rtol 2e-3. Both paths place
# the same samples (one proposal net, one generator), so no sample flips.
NP_PROP = 64
PROP_LOSS_RTOL, PROP_PARAM_ATOL, PROP_PARAM_RTOL = 1e-4, 5e-5, 2e-3
# The two-level mip step, f32, fused core against the autograd path from
# one state after one step: the loss to JAX's rtol 2e-4 (tests/test_mip.py,
# test_fused_two_level_mip_matches_xla_loss_and_grads) and the bin-flip
# rule of phase 9 on the parameters: the fine edges are resampled from the
# coarse weights, which the two paths compute in other orders.
MIP_LOSS_RTOL = 2e-4
# composite_grad's bound, with or without the rail: the bytes it must
# move, a row (out8's rgb and sigma and the ts read, 20 B; g's four rows
# written, 16 B) and a ray (the gt colour read, 12 B; its loss written,
# 4 B); its operations, under 100 f32 ones a row (four passes over a
# ray, ~25 each, read from the code), take far less time at 67 TFLOP/s.
COMPOSITE_BYTES_ROW, COMPOSITE_BYTES_RAY, COMPOSITE_FLOPS_ROW = 36, 16, 100
OUT = "smoke_logs"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def chunk_input(dev):
    """x16 (16, 2,097,152) for the middle chunk of a 400x400 frame, as the
    renderer builds it: rows 0..5 are the forward kernel's xT, row 6 the
    ts."""
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.ops.sampling import stratified_ts

    pose = torch.as_tensor(spherical_to_pose(4.0, -30.0, 0.0)[None], dtype=torch.float32, device=dev)
    rays = rays_for_poses(pose, H, W, FOCAL)[72000 : 72000 + CHUNK]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    ts = stratified_ts(g, CHUNK, N, 2.0, 6.0, dev)
    dT = rays[:, 3:6].T
    x16 = torch.zeros((16, CHUNK * N), dtype=torch.float32, device=dev)
    x16[0:3] = (rays[:, :3].T[:, :, None] + dT[:, :, None] * ts[None]).reshape(3, -1)
    x16[3:6] = (dT / torch.linalg.vector_norm(dT, dim=0, keepdim=True))[:, :, None].expand(3, CHUNK, N).reshape(3, -1)
    x16[6] = ts.reshape(-1)
    return x16


def get(url: str) -> tuple[bytes, str]:
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.read(), r.headers["Content-Type"]


def grad_errors(got, want) -> tuple[float, float]:
    """(max over tensors of max abs error / max abs plain, max abs error)."""
    rel = max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item() for g, w in zip(got, want))
    return rel, max((g - w).abs().max().item() for g, w in zip(got, want))


# the entries of an earlier library that the before/after phases call
BEFORE_ENTRIES = {"fused_train_step": ("fused_train_step", "fused_train_step_workspace_bytes"),
                  "fused_mlp_fwd": ("fused_mlp_fwd", "fused_mlp_fwd_image_bytes"),
                  "fused_mlp_bwd": ("backward_tile", "bwd_tile_image_bytes", "fused_mlp_bwd",
                                    "fused_mlp_bwd_workspace_bytes"),
                  "fused_render": ("fused_render_image_bytes",),
                  "fused_contract": ("fwd_contract_launch_count",)}


class EarlierEntries:
    """A library of an earlier commit whose entries lack trailing arguments
    (just before the stream) that the current ones have: ``cuts`` maps an
    entry to their count (each entry's ``contract`` last; before it the
    train step's ``mip`` and ``opaque_tail``,
    before them the rail's five, ``dist_on`` .. ``disparity``, and before
    those ``w_out``; the forward's ``app``, before it the anneal windows
    ``wx``, ``wd`` and before them ``mip``; B2's ``app``, before it ``wx``,
    ``wd``, ``dx`` and before them ``mip``; the backward tile kernel's
    ``app``); ``tails`` maps a sizing entry (no stream) to the count of its
    last arguments that the earlier one lacks (the sizes' ``app``). Called
    with the current entry's arguments, an entry drops those, which must be
    off (0, null)."""

    def __init__(self, lib, cuts: dict, tails: dict | None = None):
        self.lib, self.cuts, self.tails = lib, {k: v for k, v in cuts.items() if v}, tails or {}
        for name, cut in self.cuts.items():
            entry = getattr(lib, name)
            entry.argtypes = entry.argtypes[: -1 - cut] + entry.argtypes[-1:]
        for name, n in self.tails.items():
            entry = getattr(lib, name)
            entry.argtypes = entry.argtypes[:-n]

    def __getattr__(self, name):
        fn, cut, tail = getattr(self.lib, name), self.cuts.get(name, 0), self.tails.get(name, 0)
        if tail:
            def sized(*args):
                check(not any(args[-tail:]), f"an earlier {name} is asked for nothing it lacks")
                return fn(*args[:-tail])
            return sized
        if not cut:
            return fn

        def call(*args):
            check(not any(args[-1 - cut : -1]), f"an earlier {name} is asked for nothing it lacks")
            return fn(*args[: -1 - cut], args[-1])
        return call


def build_before(dirs, _build, mlp) -> list[dict]:
    """The sources of BEFORE_ENTRIES of other copies of csrc/ (the kernels
    a change replaces, or variants of them), built with the package's nvcc
    flags into <csrc>/../build/, one nvcc each, all at once; returns, copy
    by copy, their ctypes libraries by source, those entries bound as the
    current library's (a train step without the distortion rail or the
    weights output, or a train step, forward or B2 without mip, the pose
    arguments or the appearance flag, through ``EarlierEntries``). Prints
    ptxas's lines of each copy's backward tile kernels."""
    libs = _build.build_copies(dirs, BEFORE_ENTRIES)
    for d in dirs:
        for kernel, line in _build.ptxas_usage(_build.build_log[f"{d}/fused_mlp_bwd"]):
            if "bwd_kernel" in kernel:
                print(f"ptxas {d} {_build.short_name(kernel)[:48]}: {line}", flush=True)
    copies = [{name: mlp._bind(lib, name, BEFORE_ENTRIES[name]) for name, lib in libs[d].items()} for d in dirs]
    for d, c in zip(dirs, copies):
        with open(os.path.join(d, "fused_train_step.cu")) as fh:
            src = fh.read()
        no_contract = int("int contract" not in src)
        cut = no_contract + 2 * ("int opaque_tail" not in src) + 5 * ("dist_on" not in src) + ("w_out" not in src)
        if cut:
            c["fused_train_step"] = EarlierEntries(c["fused_train_step"], {"fused_train_step": cut})
        with open(os.path.join(d, "fused_mlp_fwd.cu")) as fh:
            src = fh.read()
        no_app, no_contract = int("int app" not in src), int("int contract" not in src)
        cut = ("int mip" not in src) + 2 * ("const float *wx" not in src) + no_app + no_contract
        if cut:
            c["fused_mlp_fwd"] = EarlierEntries(c["fused_mlp_fwd"], {"fused_mlp_fwd": cut},
                                                {"fused_mlp_fwd_image_bytes": no_app})
        with open(os.path.join(d, "fused_mlp_bwd.cu")) as fh:
            src = fh.read()
        no_app, no_contract = int("int app" not in src), int("int contract" not in src)
        cut = ("int mip" not in src) + 3 * ("float *dx" not in src) + no_app + no_contract
        if cut:
            c["fused_mlp_bwd"] = EarlierEntries(c["fused_mlp_bwd"], {"fused_mlp_bwd": cut, "backward_tile": no_app},
                                                {"fused_mlp_bwd_workspace_bytes": no_app})
    return copies


def in_turns(old, new) -> dict:
    """CUDA-event ms of ``old`` and ``new`` in turns (earlier, current,
    current, earlier; each the median of 5 calls): the median of each."""
    t = {"earlier": [], "current": []}
    for which in ("earlier", "current", "current", "earlier"):
        t[which].append(cuda_ms(old if which == "earlier" else new))
    return {k: float(np.median(v)) for k, v in t.items()}


def phase_forward_before_after(dev, params, model, mlp, x16, earlier, dt=torch.float32) -> dict:
    """The forward (compute type ``dt``) of an earlier forward library
    beside the current one on the render chunk, in turns, both called
    straight through ctypes with their outputs and weight images made once.
    The two must agree (``bit_equal``: to the bit)."""
    from nerf_simple_tpu_torch.models.nerf import NerfField

    w = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(params, dev)), dt)
    cw, xT = mlp._CPtrs(*mlp._ptrs(w)), x16[:8].contiguous()
    R, bf16 = xT.shape[1], int(dt == torch.bfloat16)

    def bind(lib, what):
        out = torch.empty((8, R), dtype=torch.float32, device=dev)
        image = torch.empty(lib.fused_mlp_fwd_image_bytes(model.Lp, model.Ld, model.H, bf16, 0), dtype=torch.uint8,
                            device=dev)

        def fwd():
            mlp._raise_on(lib.fused_mlp_fwd(xT.data_ptr(), out.data_ptr(), R, model.Lp, model.Ld, model.H, bf16, cw,
                                            image.data_ptr(), 0, None, None, 0, 0, mlp._stream(xT)), what)
        return fwd, out

    old, o_old = bind(earlier, "earlier fused_mlp_fwd")
    new, o_new = bind(mlp._lib("fused_mlp_fwd"), "fused_mlp_fwd")
    with torch.inference_mode():
        old()
        new()
        torch.cuda.synchronize()
        err = (o_new[:4] - o_old[:4]).abs().max().item()
        check(err <= TOL[dt], "current forward matches the earlier kernel")
        res = {"fwd_ms": in_turns(old, new), "fwd_err": err, "rows": R, "bit_equal": torch.equal(o_new, o_old)}
    del o_old, o_new
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def earlier_train_step(mlp, lib):
    """Inside, ``mlp.fused_train_step`` (and so the train step) launches the
    earlier library ``lib`` and hands it the transposed weights
    (``mlp._transposed``), as the earlier wrapper did: the step as it was."""
    lib_of, weights_t = mlp._lib, mlp._weights_t
    mlp._lib = lambda name: lib if name == "fused_train_step" else lib_of(name)
    mlp._weights_t = mlp._transposed
    try:
        yield
    finally:
        mlp._lib, mlp._weights_t = lib_of, weights_t


def phase_before_after(dev, params, model, mlp, x16_batch, earlier, dt=torch.bfloat16) -> dict:
    """B1 of an earlier train-step library beside the current one at the
    training batch, in compute type ``dt``, in turns (earlier, current,
    current, earlier, median of each): step ms and the profiled kernel
    groups (the tile kernels' among them). Both libraries are called the
    same way, straight through ctypes with a workspace made once, so the
    walls hold no wrapper time. The two must agree."""
    from nerf_simple_tpu_torch.models.nerf import NerfField

    w = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(params, dev)), dt)
    cw, wt = mlp._CPtrs(*mlp._ptrs(w)), mlp._transposed(w)  # an earlier bf16 library may read wt
    res = {}
    R, Nb = x16_batch.shape[1], N_SAMPLES
    bf16 = int(dt == torch.bfloat16)
    name = "bf16" if bf16 else "f32"

    def bind(lib, what):
        ws = torch.empty(lib.fused_train_step_workspace_bytes(R, Nb, model.Lp, model.Ld, model.H, bf16),
                         dtype=torch.uint8, device=dev)
        loss = torch.empty((), dtype=torch.float32, device=dev)
        grads = mlp._empty_grads(model, dev)
        cg = mlp._CPtrs(*mlp._ptrs(grads))

        def step():
            mlp._raise_on(lib.fused_train_step(x16_batch.data_ptr(), R, Nb, model.Lp, model.Ld, model.H, bf16,
                                               cw, wt, ws.data_ptr(), loss.data_ptr(), cg, None, 0, 0.0, 0.0,
                                               0.0, 0, 0, 0, 0, mlp._stream(x16_batch)), what)
        return step, loss, grads

    old_step, loss, grads = bind(earlier, "earlier fused_train_step")
    new_step, l_new, g_new = bind(mlp._lib("fused_train_step"), "fused_train_step")

    with torch.no_grad():
        old_step()
        new_step()
        rel = grad_errors(g_new, grads)[0]
        check(abs(l_new.item() / loss.item() - 1) <= LOSS_TOL[dt] and rel <= GRAD_TOL["B1", dt],
              f"current B1 {name} matches the earlier kernels")
        res["b1_bitwise"] = l_new.item() == loss.item() and all(torch.equal(a, b) for a, b in zip(g_new, grads))
        res["b1_ms"] = in_turns(old_step, new_step)
        res["b1_profile"] = {"earlier": profile_step(old_step), "current": profile_step(new_step)}
        res["b1_grad_rel"] = rel
    del old_step, new_step
    torch.cuda.empty_cache()
    b = res["b1_ms"]
    if not bf16:
        return res
    print(f"before/after B1 bf16 at {R} rows: earlier {b['earlier']:.3f} ms, current {b['current']:.3f} ms; "
          "profiled ms a call: " + "; ".join(
              f"{k}: " + ", ".join(f"{g} {v:.3f}" for g, v in sorted(p.items(), key=lambda kv: -kv[1]))
              for k, p in res["b1_profile"].items())
          + f"; current vs earlier grads {rel:.2e} of max, loss and grads bit-equal: {res['b1_bitwise']}",
          flush=True)
    return res


def step_walls(step, steps: int = 20, reps: int = 5) -> dict:
    """ms a call of ``step`` over runs of ``steps`` calls back to back, after
    one warm-up run: each run's device wall (CUDA events) and the host's
    time to issue it (perf_counter up to the last call's return, before
    the synchronize). Where the host issues slower than the card runs, the
    two agree and the card waits on the host."""
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    walls, hosts = [], []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        hosts.append((time.perf_counter() - t0) * 1e3 / steps)
        b.record()
        b.synchronize()
        walls.append(a.elapsed_time(b) / steps)
    return {"ms": float(np.median(walls)), "host_ms": float(np.median(hosts)), "walls": walls, "hosts": hosts}


def phase_build(sources, _build) -> None:
    fresh = [n for n in sources if not _build.library_path(n).exists()]
    t0 = time.perf_counter()
    seconds = _build.build(*sources)
    print(f"build: {', '.join(sources)} ({len(fresh)} compiled, one nvcc each, "
          f"in parallel) in {time.perf_counter() - t0:.2f} s; per source "
          + ", ".join(f"{n} {t:.2f} s" for n, t in seconds.items()), flush=True)
    with open(os.path.join(OUT, "build_log.txt"), "w") as fh:
        for name in sources:
            log = _build.build_log.get(name, "")
            fh.write(f"===== {name}\n{log}\n")
            for kernel, line in _build.ptxas_usage(log):
                print(f"ptxas {name} {_build.short_name(kernel)[:48]}: {line}")


def phase_forward(dev, params, model, mlp, x16):
    """The forward kernel against its plain version on the chunk, f32 and
    bf16; then the f32 kernel's rate and share of its bound beside the
    rate of one f32 torch.mm of the chunk's rows by a 256 x 256 matrix
    (TF32 off): the SIMT FMA rate a library reaches, timed here only."""
    from nerf_simple_tpu_torch.models.nerf import NerfField
    from nerf_simple_tpu_torch.utils.roofline import bound_ms

    field = NerfField.from_jax_params(params, dev)
    xT = x16[:8].contiguous()
    wts = mlp.pack_weights(field)
    stats = {}
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            w = mlp._cast_weights(wts, dt)
            got = mlp.fused_mlp_forward(w, xT, dt, model)
            ref = mlp.fused_mlp_forward_plain(w, xT, dt, model)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{dt} kernel output finite")
            check(bool((got[4:] == 0).all()), f"{dt} kernel rows 4..7 zero")
            err_rgb = (got[:3] - ref[:3]).abs().max().item()
            err_sig = (got[3] - ref[3]).abs().max().item()
            ms = cuda_ms(lambda: mlp.fused_mlp_forward(w, xT, dt, model))
            plain_ms = cuda_ms(lambda: mlp.fused_mlp_forward_plain(w, xT, dt, model))
            name = "f32" if dt == torch.float32 else "bf16"
            print(f"forward kernel vs plain {name} at {xT.shape[1]} rows: max abs err rgb "
                  f"{err_rgb:.3e} sigma {err_sig:.3e} (tol {TOL[dt]:.0e}); "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median of 5)", flush=True)
            check(err_rgb <= TOL[dt] and err_sig <= TOL[dt], f"{name} kernel within tolerance")
            stats[name] = dict(err=max(err_rgb, err_sig), ms=ms, plain_ms=plain_ms)
        R = xT.shape[1]
        flops = 2 * sum(o * k for o, k in mlp._weight_shapes(model).values() if k != 1) * R
        A = torch.from_numpy(np.random.default_rng(SEED).standard_normal((R, 256), dtype=np.float32)).to(dev)
        B = torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal((256, 256), dtype=np.float32)).to(dev)
        mm_ms = cuda_ms(lambda: torch.mm(A, B))
        del A, B
    f32 = stats["f32"]
    f32["tflops"] = flops / (f32["ms"] * 1e9)
    f32["share_of_bound"] = bound_ms(flops, 64 * R, torch.float32) / f32["ms"]
    f32["mm_tflops"] = 2 * R * 256 * 256 / (mm_ms * 1e9)
    print(f"forward kernel f32 at {R} rows: {f32['tflops']:.2f} TFLOP/s, {100 * f32['share_of_bound']:.1f}% of its "
          f"bound ({bound_ms(flops, 64 * R, torch.float32):.2f} ms, operations at 67 TFLOP/s); one f32 torch.mm "
          f"({R} x 256) @ (256 x 256), TF32 off: {mm_ms:.3f} ms, {f32['mm_tflops']:.2f} TFLOP/s", flush=True)
    torch.cuda.empty_cache()
    return stats


def phase_render(dev, params, model, mlp, x16):
    """B3 against its plain version on the chunk: each ray's rgb, depth and
    acc at its head column, zeros elsewhere; CUDA-event ms of both."""
    from nerf_simple_tpu_torch.models.nerf import NerfField

    wts = mlp.pack_weights(NerfField.from_jax_params(params, dev))
    heads = torch.zeros(x16.shape[1], dtype=torch.bool, device=dev)
    heads[::N] = True
    stats = {}
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            w = mlp._cast_weights(wts, dt)
            got = mlp.fused_render(w, x16, N, dt, model)
            ref = mlp.fused_render_plain(w, x16, N, dt, model)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{name} render kernel output finite")
            check(bool((got[:, ~heads] == 0).all()) and bool((got[5:] == 0).all()),
                  f"{name} render kernel: zeros off the head columns")
            err = (got[:5, heads] - ref[:5, heads]).abs().amax(1).tolist()
            err_rgb_acc, err_depth = max(err[:3] + err[4:]), err[3]
            del got, ref
            ms = cuda_ms(lambda: mlp.fused_render(w, x16, N, dt, model))
            plain_ms = cuda_ms(lambda: mlp.fused_render_plain(w, x16, N, dt, model))
            # depth sums w * t with t up to 6: six times the rgb bound
            print(f"B3 render kernel vs plain {name} at {x16.shape[1]} rows ({CHUNK} rays): max abs err "
                  f"rgb/acc {err_rgb_acc:.3e} (tol {TOL[dt]:.0e}), depth {err_depth:.3e} (tol "
                  f"{6 * TOL[dt]:.0e}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median of 5)",
                  flush=True)
            check(err_rgb_acc <= TOL[dt] and err_depth <= 6 * TOL[dt], f"{name} render kernel within tolerance")
            stats[name] = dict(err=max(err), ms=ms, plain_ms=plain_ms)
            torch.cuda.empty_cache()
    return stats


def phase_serve(dev, params, model, mlp) -> tuple[int, dict]:
    """Serves three frames over HTTP; returns the forward kernel's launches
    during the requests and the frame times of both backends."""
    from nerf_simple_tpu_torch.evaluate import load_params
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked
    from nerf_simple_tpu_torch.serve import RenderServer
    from nerf_simple_tpu_torch.train.checkpoint import export_params_npz, load_model_meta

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "params.npz")
        export_params_npz(path, params)
        with open(os.path.join(tmp, "model.json"), "w") as fh:
            json.dump({"family": "nerf", **dataclasses.asdict(model)}, fh)
        loaded = load_params(path)
        meta_model = load_model_meta(path)
    check(meta_model == model, "model.json round trip")
    settings = RenderSettings(backend="pallas")
    srv = RenderServer(loaded, H, W, FOCAL, settings, model=meta_model, device=dev)
    phis = (0.0, 120.0, 240.0)
    mlp.fused_mlp_forward.launches = 0
    served = serve_frames(srv, phis)
    launches = mlp.fused_mlp_forward.launches
    n_chunks = -(-H * W // CHUNK)
    print(f"kernel launches during the {len(phis)} requests: {launches} "
          f"({n_chunks} chunks a frame)", flush=True)
    check(launches == len(phis) * n_chunks, "every served chunk went through the kernel")

    # the served frame against the plain backend, same pose and seed
    pose = torch.as_tensor(spherical_to_pose(4.0, -30.0, phis[0])[None], dtype=torch.float32, device=dev)
    rays = rays_for_poses(pose, H, W, FOCAL)
    frame_ms, rgb = {}, {}
    for backend in ("pallas", "xla"):
        s = dataclasses.replace(settings, backend=backend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb[backend], disp = render_rays_chunked(srv.field, rays, srv.seed, s)
        torch.cuda.synchronize()
        frame_ms[backend] = (time.perf_counter() - t0) * 1e3
        check(bool(torch.isfinite(rgb[backend]).all() and torch.isfinite(disp).all()),
              f"{backend} frame finite")
    frame_err = (rgb["pallas"] - rgb["xla"]).abs().max().item()
    xla_u8 = (rgb["xla"].reshape(H, W, 3).cpu().numpy() * 255).astype(np.uint8)
    u8_err = int(np.abs(served[0].astype(int) - xla_u8.astype(int)).max())
    print(f"frame {H}x{W}x{N} f32: pallas {frame_ms['pallas']:.1f} ms, xla "
          f"{frame_ms['xla']:.1f} ms; max abs rgb diff {frame_err:.3e} (tol {FRAME_TOL:.0e}), "
          f"served PNG vs xla max diff {u8_err} levels", flush=True)
    check(frame_err <= FRAME_TOL and u8_err <= 1, "served frame matches the plain backend")
    return launches, frame_ms


def phase_fused_frame(dev, params, model, mlp) -> tuple[int, dict]:
    """One 400x400 frame through render_rays_chunked with fused_eval (the
    render kernel) against the forward kernel plus torch compositing, same
    seed, so the same ts. Returns the render kernel's launches in the f32
    frame and the frame times."""
    from nerf_simple_tpu_torch.models.nerf import NerfField
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked

    field = NerfField.from_jax_params(params, dev, model)
    pose = torch.as_tensor(spherical_to_pose(4.0, -30.0, 0.0)[None], dtype=torch.float32, device=dev)
    rays = rays_for_poses(pose, H, W, FOCAL)

    def frame(dt, fused):
        s = RenderSettings(backend="pallas", compute_dtype=dt, fused_eval=fused)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb, disp = render_rays_chunked(field, rays, SEED, s)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, rgb, disp

    mlp.fused_render.launches = 0
    first_ms, rgb_f, disp_f = frame(torch.float32, True)  # the eval render path
    launches = mlp.fused_render.launches
    n_chunks = -(-H * W // CHUNK)
    check(launches == n_chunks, "every chunk of the fused_eval frame went through the render kernel")
    frame_ms = {}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        _, rgb_f, disp_f = frame(dt, True)
        _, rgb_u, disp_u = frame(dt, False)
        check(bool(torch.isfinite(rgb_f).all() and torch.isfinite(disp_f).all()), f"{name} fused frame finite")
        rgb_err = (rgb_f - rgb_u).abs().max().item()
        disp_err = ((disp_f - disp_u).abs() / disp_u.abs()).max().item()
        # in turns: unfused, fused, fused, unfused, unfused, fused
        t = {True: [], False: []}
        for fused in (False, True, True, False, False, True):
            t[fused].append(frame(dt, fused)[0])
        frame_ms[name] = {"fused": float(np.median(t[True])), "unfused": float(np.median(t[False]))}
        print(f"fused_eval frame {H}x{W}x{N} {name}: render kernel {frame_ms[name]['fused']:.1f} ms, "
              f"forward kernel + torch compositing {frame_ms[name]['unfused']:.1f} ms (median of 3, "
              f"in turns); max abs rgb diff {rgb_err:.3e} (tol {FRAME_TOL:.0e}), max rel disparity "
              f"diff {disp_err:.3e} (tol {DISP_RTOL:.0e})", flush=True)
        check(rgb_err <= FRAME_TOL and disp_err <= DISP_RTOL, f"{name} fused_eval frame matches")
    print(f"render kernel launches during the f32 fused_eval frame: {launches} ({n_chunks} chunks; "
          f"first frame {first_ms:.1f} ms)", flush=True)
    return launches, frame_ms


def serve_frames(srv, phis) -> list:
    """GET /health and one /render per phi from the server over HTTP."""
    from nerf_simple_tpu_torch.serve import decode_png, serve

    httpd = serve(srv, 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    frames = []
    try:
        health = json.loads(get(url + "/health")[0])
        check(health["status"] == "ok" and health["frame"] == [srv.H, srv.W], "/health")
        for phi in phis:
            t0 = time.perf_counter()
            data, ctype = get(f"{url}/render?r=4&theta=-30&phi={phi:g}")
            http_ms = (time.perf_counter() - t0) * 1e3
            check(ctype == "image/png", "PNG content type")
            frames.append(decode_png(data))
            check(frames[-1].shape == (srv.H, srv.W, 3), f"{srv.H}x{srv.W}x3 frame")
            print(f"served /render phi={phi:g}: {len(data)} B PNG, {http_ms:.1f} ms "
                  f"(HTTP round trip)", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    return frames


def train_batch(dev, scene):
    """x16 (16, 524,288) for a 4096-ray batch of the synthetic scene, with
    stratified samples, as the train step builds it."""
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset, sample_ray_batch
    from nerf_simple_tpu_torch.ops.sampling import stratified_ts
    from nerf_simple_tpu_torch.train.step import build_x16

    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    rays_b, pix_b = sample_ray_batch(g, rd.rays["train"], rd.pixels["train"], BATCH)
    ts = stratified_ts(g, BATCH, N_SAMPLES, 2.0, 6.0, dev)
    return build_x16(rays_b, ts, pix_b)


def phase_backward_and_step(dev, params, model, mlp, x16):
    """B2 and B1 against their plain versions at the training batch, and
    all three against the plain float64 result."""
    from nerf_simple_tpu_torch.models.nerf import NerfField

    wts = mlp.pack_weights(NerfField.from_jax_params(params, dev))
    w64 = mlp.FusedWeights(*[t.double() for t in wts])
    xT = x16[:8].contiguous()
    gT = torch.from_numpy(np.random.default_rng(SEED).normal(size=tuple(xT.shape)).astype(np.float32)).to(dev)
    stats = {}
    with torch.no_grad():
        ref = {"B2": mlp.fused_mlp_backward_plain(w64, xT.double(), gT.double(), torch.float64, model),
               "B1": mlp.fused_train_step_plain(w64, x16.double(), N_SAMPLES, torch.float64, model)[1]}
        torch.cuda.empty_cache()
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            w = mlp._cast_weights(wts, dt)
            runs = {
                "B2": (lambda: (None, mlp.fused_mlp_backward(w, xT, gT, dt, model)),
                       lambda: (None, mlp.fused_mlp_backward_plain(w, xT, gT, dt, model))),
                "B1": (lambda: mlp.fused_train_step(w, x16, N_SAMPLES, dt, model),
                       lambda: mlp.fused_train_step_plain(w, x16, N_SAMPLES, dt, model)),
            }
            for kname, (kernel, plain) in runs.items():
                loss, got = kernel()
                loss_p, want = plain()
                check(all(bool(torch.isfinite(t).all()) for t in got), f"{kname} {name} finite")
                rel, abs_err = grad_errors(got, want)
                k64, p64 = grad_errors(got, ref[kname])[0], grad_errors(want, ref[kname])[0]
                line = (f"{kname} {'fused_mlp_backward' if kname == 'B2' else 'fused_train_step'} vs "
                        f"plain {name} at {xT.shape[1]} rows: grad err {rel:.3e} of max (tol "
                        f"{GRAD_TOL[kname, dt]:.0e}), max abs {abs_err:.3e}; from f64: kernel "
                        f"{k64:.3e}, plain {p64:.3e}")
                st = dict(err=abs_err, rel=rel, kernel_vs_f64=k64, plain_vs_f64=p64)
                check(rel <= GRAD_TOL[kname, dt], f"{kname} {name} within tolerance")
                check(k64 <= 2 * p64 + 1e-7, f"{kname} {name} as accurate as plain")
                if kname == "B1":
                    st["loss_err"] = abs(loss.item() / loss_p.item() - 1)
                    loss2, again = kernel()
                    bitwise = loss2.item() == loss.item() and all(torch.equal(a, b) for a, b in zip(got, again))
                    line += (f"; loss {loss.item():.6f} vs {loss_p.item():.6f} (rel err "
                             f"{st['loss_err']:.2e}, tol {LOSS_TOL[dt]:.0e}); two runs bitwise equal: {bitwise}")
                    check(st["loss_err"] <= LOSS_TOL[dt], f"B1 {name} loss within tolerance")
                    check(bitwise, f"B1 {name} deterministic")
                    del again
                del got, want
                st["ms"], st["plain_ms"] = cuda_ms(kernel), cuda_ms(plain)
                print(f"{line}; kernel {st['ms']:.3f} ms, plain {st['plain_ms']:.3f} ms (median of 5)",
                      flush=True)
                stats[f"{kname}_{name}"] = st
                torch.cuda.empty_cache()
    return stats


def phase_wgrad(dev):
    """The twelve weight-gradient sums alone (probes/wgrad.py): kernel vs
    float64 sums of the operands as stored (REL_TOL there: f32 1e-4, bf16
    1e-3 of the largest entry, for the reasons stated beside it) and no
    less accurate than the plain version; kernel, library and plain ms."""
    from nerf_simple_tpu_torch.probes import wgrad

    res = wgrad.run(dev)  # raises on a failed check
    for name in ("f32", "bf16"):
        v = res[name]
        print(f"wgrad {name}, twelve sums at {res['rows']} rows: kernel {v['ms']:.3f} ms in one launch "
              f"({v['ms_single']:.3f} ms as twelve calls), library torch.mm + sum {v['library_ms']:.3f} ms, "
              f"plain {v['plain_ms']:.3f} ms (runs of {wgrad.CALLS} calls, median of 5, in turns); bound {v['bound_ms']:.3f} ms "
              f"({v['bound_by']}), {100 * v['share_of_bound']:.1f}% of it; {v['tflops']:.1f} TFLOP/s, "
              f"{v['gb_s']:.0f} GB/s; from float64 of the operands as stored: kernel {v['rel_err']:.2e} "
              f"(twelve calls {v['single_rel_err']:.2e}), plain {v['plain_rel_err']:.2e} of max (tol "
              f"{wgrad.REL_TOL[torch.float32 if name == 'f32' else torch.bfloat16]:.0e}); kernel vs plain "
              f"max abs {v['max_abs_err']:.3e}; launches {v['launches']}", flush=True)
    return res


def phase_bwd_tile(dev):
    """The backward tile kernel alone (probes/bwd_tile.py): kernel vs plain
    planes (REL_TOL there: f32 1e-4, bf16 2e-2 of each group's largest
    entry, for the reasons stated beside it), pad rows zero; kernel and
    plain ms, the bound and its share."""
    from nerf_simple_tpu_torch.probes import bwd_tile

    res = bwd_tile.run(dev)  # raises on a failed check
    for name in ("f32", "bf16"):
        v = res[name]
        print(f"bwd_tile {name} at {res['rows']} rows: kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms "
              f"(a call of {bwd_tile.CALLS} back to back, median of 5, in turns); bound {v['bound_ms']:.3f} ms ({v['bound_by']}), "
              f"{100 * v['share_of_bound']:.1f}% of it; {v['gb_s']:.0f} GB/s, {v['tflops']:.1f} TFLOP/s; "
              f"vs plain {v['rel_err']:.2e} of max (tol {bwd_tile.REL_TOL[torch.float32 if name == 'f32' else torch.bfloat16]:.0e}), "
              f"max abs {v['max_abs_err']:.3e}, {100 * v['share_differ']:.3f}% of entries differ; "
              f"launches {v['launches']}", flush=True)
    return res


def phase_bwd_tile_before_after(dev, libs: dict) -> dict:
    """The f32 tile kernel alone of other fused_mlp_bwd libraries (``libs``:
    label -> library; "earlier" the parent's) beside the current one on the
    probe's inputs, in turns (probes/bwd_tile.py ``before_after``; the
    others get the transposes). Their planes must agree with the current
    ones within the probe's f32 tolerance."""
    from nerf_simple_tpu_torch.probes import bwd_tile

    res = bwd_tile.before_after(dev, libs)
    print(f"before/after f32 tile kernel at {res['rows']} rows (runs of {bwd_tile.CALLS} calls back to back, "
          "median of 5, in turns): " + ", ".join(f"{k} {res['ms'][k]:.3f} ms" for k in (*libs, "current"))
          + "; planes max abs diff " + ", ".join(f"{k} {res['max_abs_diff'][k]:.3e} ({res['rel_diff'][k]:.2e} of "
                                                  "max)" for k in libs), flush=True)
    for k in libs:
        check(res["rel_diff"][k] <= bwd_tile.REL_TOL[torch.float32], f"current f32 tile kernel matches {k}'s")
    return res


# With split_b1: the kernels outside B1, by name
STEP_GROUPS = (("sampling", ("searchsorted", "sort", "Sort", "scan", "distribution", "gather", "random")),
               ("adam", ("multi_tensor", "adam", "Adam")))


# With split_proposal: the proposal MLP's matmuls (cuBLAS kernels), by name
PROP_MATMUL = re.compile(r"gemm|gemv|cutlass|xmma|Kernel2", re.IGNORECASE)


def profile_step(step, others: dict | None = None, host: dict | None = None, split_b1: bool = False,
                 split_proposal: bool = False, split_mip: bool = False, split_pose: bool = False,
                 rest: str = "rays and compositing", forwards: int = 1, split_occ: bool = False,
                 steps: int = 10) -> dict:
    """Device time of each kernel group in one call of ``step`` (ms, mean of
    ``steps`` calls after 3 warm-up) under torch.profiler; {} when the profiler
    sees no device activity. ``others``, where given, gets the ms of each
    kernel of the group "other" by name; ``host``, the host's self time
    of each torch op a call (ms; the profiler's own cost included). With
    ``split_b1`` (a hierarchical step: two B1 launches), the kernels are
    taken in time order and each B1 launch's, from its forward weight
    image to its sums' reduce, go to "coarse B1" and "fine B1" in turns;
    the others to STEP_GROUPS or "other". With ``split_proposal`` (a
    proposal step: one B1 launch), the kernels in time order go to "B1"
    (its launch, as above), "adam" (by name), "proposal matmuls" (cuBLAS
    kernels, by name: the proposal MLP's forward and backward products),
    and the rest to "before B1" (probes, the proposal MLP's encoding and
    activations, its weights, the importance samples, x16, the pack) or
    "after B1" (the pack's backward, the interlevel loss, the proposal
    MLP's backward passes) as they fall in the step. With ``split_mip``
    (a two-level mip step: two B1 launches on one pack), the kernels in
    time order go to "coarse B1" and "fine B1" (each launch, as above),
    "adam" (by name), and the rest to "before B1" (the edges, the pack,
    the coarse x16), "between B1s" (resample_edges, the fine x16) or
    "after B1" (the pack's backward) as they fall in the step. With
    ``split_pose`` (a pose step: the forward kernel, then B2 with the input
    gradient), the kernels in time order go to "forward" (the weight image
    and tile kernel of each of the step's ``forwards`` forward launches: 2
    for a two-level mip step), "B2" (its recompute, tile kernel, sums
    and reduce), "input grad" (csrc/input_grad.cuh), "adam" (by name), and
    the rest to ``rest`` (the ray refinement or the code gather, the input
    build, the pack, torch compositing and their autograd); ``others``
    then gets that group by kernel. With ``split_occ`` (an occupancy step:
    a refresh's forward launch every few steps, one B1 launch), as
    ``split_proposal`` but a forward launch that no compositing follows is
    the refresh's ("refresh"), and no kernel is "proposal matmuls"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    groups = (("sums", "sums_"), ("sums_reduce", "reduce_kernel"), ("bwd_tile", "bwd_kernel"),
              ("fwd_tile", "fwd_kernel"), ("bwd_image", "bwd_image_kernel"), ("weight_image", "image_kernel"),
              ("compositing", "composite_grad"), ("compositing", "sum_kernel"))
    out: dict = {}
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),  # a user annotation spans kernels
                     key=lambda e: e.time_range.start)
    b1, n_b1, after_b1, phase, n_fwd, pending = None, 0, False, "before B1", 0, None

    def add(group, e):
        ms = e.time_range.elapsed_us() / (steps * 1e3)  # ms a step
        out[group] = out.get(group, 0.0) + ms
        if group in ("other", rest) and others is not None:
            others[e.name[:60]] = others.get(e.name[:60], 0.0) + ms

    for e in kernels:
        group = next((g for g, key in groups if key in e.name), "other")
        if split_occ:
            if group == "weight_image" and b1 is None:  # a B1 launch or a refresh's forward: compositing tells
                b1, pending = "B1", []
            if pending is not None:
                if group in ("weight_image", "fwd_tile"):
                    pending.append(e)
                    continue
                for p in pending:
                    add("B1" if group == "compositing" else "refresh", p)
                b1 = "B1" if group == "compositing" else None
                pending = None
            if b1:
                group = b1
                if "reduce_kernel" in e.name and "native" not in e.name:  # the sums' reduce, B1's last
                    b1, after_b1 = None, True
            elif any(k in e.name for k in STEP_GROUPS[1][1]):
                group, after_b1 = "adam", False
            else:
                group = "after B1" if after_b1 else "before B1"
            add(group, e)
            continue
        if split_pose:
            if group == "sums_reduce" and "native" in e.name:  # a torch reduction, not the sums'
                group = "other"
            if "::ig::input_grad" in e.name:  # input_grad_fma (f32) or input_grad_mma (bf16)
                group = "input grad"
            elif any(k in e.name for k in STEP_GROUPS[1][1]):
                group, n_fwd = "adam", 0  # the step's last kernels
            elif group in ("weight_image", "fwd_tile"):
                group, n_fwd = ("forward" if n_fwd < 2 * forwards else "B2"), n_fwd + 1  # the forwards'; B2's
            elif group in ("bwd_image", "bwd_tile", "sums", "sums_reduce"):
                group = "B2"
            else:
                group = rest
        elif split_mip:
            if group == "weight_image" and b1 is None:  # the first kernel of a B1 launch
                b1, n_b1 = ("coarse B1", "fine B1")[n_b1 % 2], n_b1 + 1
            if b1:
                last = group == "sums_reduce"  # the last one
                group = b1
                if last:
                    b1, phase = None, "between B1s" if b1 == "coarse B1" else "after B1"
            elif any(k in e.name for k in STEP_GROUPS[1][1]):
                group, phase = "adam", "before B1"
            else:
                group = phase
        elif split_proposal:
            if group == "weight_image" and b1 is None:
                b1 = "B1"
            adam = any(k in e.name for k in STEP_GROUPS[1][1])
            if b1:
                group = b1
                if "reduce_kernel" in e.name and "native" not in e.name:  # the sums' reduce, B1's last
                    b1, after_b1 = None, True
            elif adam:
                group, after_b1 = "adam", False
            elif PROP_MATMUL.search(e.name):
                group = "proposal matmuls"
            else:
                group = "after B1" if after_b1 else "before B1"
        elif split_b1:
            if group == "weight_image" and b1 is None:  # the first kernel of a B1 launch
                b1, n_b1 = ("coarse B1", "fine B1")[n_b1 % 2], n_b1 + 1
            last = b1 is not None and group == "sums_reduce"  # the last one
            group = b1 or next((g for g, keys in STEP_GROUPS if any(k in e.name for k in keys)), "other")
            b1 = None if last else b1
        add(group, e)
    if host is not None:
        for a in prof.key_averages():
            if a.self_cpu_time_total > 0:
                host[a.key[:60]] = a.self_cpu_time_total / (steps * 1e3)  # us over the calls -> ms a call
    return out


def scalars(log_dir: str, tag: str) -> list[float]:
    rows = []
    for path in glob.glob(os.path.join(log_dir, "run_*", "scalars.csv")):
        with open(path) as fh:
            rows += [(int(r[1]), float(r[3])) for r in csv.reader(fh) if r[2] == tag]
    return [v for _, v in sorted(rows)]


def phase_train(dev, scene, work, mlp, earlier=None):
    """Train through train(), resume, serve the export, time and profile
    the bf16 step (with ``earlier``, an earlier train-step library, beside
    the step as it was, in turns), then the f32 fused/two-kernel/plain
    step comparison. Returns its numbers."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.evaluate import load_params
    from nerf_simple_tpu_torch.models.nerf import NerfMLP
    from nerf_simple_tpu_torch.render.renderer import RenderSettings
    from nerf_simple_tpu_torch.serve import RenderServer
    from nerf_simple_tpu_torch.train.checkpoint import load_model_meta
    from nerf_simple_tpu_torch.train.loop import train
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    iters, more = 300, 100
    cfg = load_yaml("configs/lego.yaml")
    cfg.update(datapath=scene, savepath=os.path.join(work, "models"), log_dir=os.path.join(work, "logs"),
               backend="pallas", compute_dtype="bf16", num_iters=iters, ckpt_loss=1,
               ckpt_images=150, ckpt_model=150, steps_per_call=50)
    log = io.StringIO()
    mlp.fused_train_step.launches = mlp.fused_mlp_forward.launches = mlp.fused_mlp_backward.launches = 0
    mlp.wgrad_sums_launches(reset=True)
    mlp.bwd_tile_launches(reset=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(fused_train_step=mlp.fused_train_step.launches,
                    fused_mlp_forward=mlp.fused_mlp_forward.launches,
                    fused_mlp_backward=mlp.fused_mlp_backward.launches,
                    wgrad_sums=mlp.wgrad_sums_launches(), bwd_tile=mlp.bwd_tile_launches())
    cfg.update(resume=True, num_iters=iters + more)
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    resumed_launches = mlp.fused_train_step.launches - launches["fused_train_step"]
    text = log.getvalue()
    with open(os.path.join(OUT, "train_log.txt"), "w") as fh:
        fh.write(text)
    for line in text.splitlines():
        if "resumed from" in line or "final checkpoint" in line or "Val image" in line:
            print("train:", line, flush=True)
    losses = scalars(cfg["log_dir"], "Loss/train")
    psnr = scalars(cfg["log_dir"], "Loss/Val_Img_PSNR_0")
    first, last = float(np.mean(losses[:50])), float(np.mean(losses[iters - 50 : iters]))
    print(f"train: {iters} steps in {train_s:.1f} s with builds and renders; launches {launches}; "
          f"mean loss of the first 50 steps {first:.5f}, of steps {iters - 50}-{iters} {last:.5f}; "
          f"val PSNR(0) {', '.join(f'{p:.2f}' for p in psnr)} dB", flush=True)
    check(launches["fused_train_step"] == iters, "one fused train-step launch a step")
    check(launches["fused_mlp_forward"] > 0, "val renders went through the forward kernel")
    check(launches["wgrad_sums"] == iters, "one launch of the weight-gradient sums a step")
    check(launches["bwd_tile"] == iters, "one launch of the backward tile kernel a step")
    check(all(np.isfinite(losses)) and len(losses) == iters + more, "every loss logged and finite")
    check(last <= 0.5 * first, "the loss at least halved")
    check(psnr[-1] > psnr[0], "val PSNR rose")
    check("resumed from" in text and f"at step {iters}" in text, "resume printed")
    check(resumed_launches == more and state.step == iters + more, "resume added the steps")

    # the exported params, served
    path = os.path.join(work, "models", "lego", f"params_{iters + more}.npz")
    model = load_model_meta(path)
    check(model == NerfMLP(), "model.json of the run")
    srv = RenderServer(load_params(path), 400, 400, scene_focal(scene), RenderSettings(
        backend="pallas", compute_dtype=torch.bfloat16), model=model, device=dev)
    frame = serve_frames(srv, (30.0,))[0]
    check(frame.max() > 0, "the trained field renders something")

    # steady-state ms a step on the trained state
    step_fn = build_train_step(train_config(cfg), NerfMLP())
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset

    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    rays, pixels = rd.rays["train"], rd.pixels["train"]
    def step():
        return step_fn(state, rays, pixels)

    walls = step_walls(step)
    step_ms = walls["ms"]
    print(f"train step bf16 steady state: {step_ms:.3f} ms a step, {BATCH / step_ms * 1e3:,.0f} rays/s "
          f"(CUDA events over 20 steps, median of 5; runs {', '.join(f'{w:.3f}' for w in walls['walls'])}); "
          f"host issues a step in {walls['host_ms']:.3f} ms (runs "
          f"{', '.join(f'{h:.3f}' for h in walls['hosts'])})", flush=True)
    others, host = {}, {}
    prof = profile_step(step, others, host)
    busy = sum(prof.values())
    print("train step bf16 profile, device ms a step: " + (", ".join(
        f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1]))
        + f"; kernels {busy:.3f} of {step_ms:.3f} ms, idle share {1 - busy / step_ms:.3f}"
        if prof else "not measured (the profiler saw no device activity)"), flush=True)
    print("train step bf16 profile, the group other by kernel, ms a step: " + "; ".join(
        f"{n} {v:.3f}" for n, v in sorted(others.items(), key=lambda kv: -kv[1])[:8]), flush=True)
    print(f"train step bf16 profile, host self time a step: torch ops {sum(host.values()):.3f} ms (profiled); "
          + "; ".join(f"{n} {v:.3f}" for n, v in sorted(host.items(), key=lambda kv: -kv[1])[:10]), flush=True)
    turns = None
    if earlier is not None:  # the step as it was (the earlier library) beside this one, in turns
        t = {"earlier": [], "current": []}
        for which in ("earlier", "current", "current", "earlier", "earlier", "current"):
            with earlier_train_step(mlp, earlier) if which == "earlier" else contextlib.nullcontext():
                t[which].append(step_walls(step))
        turns = {k: {"ms": float(np.median([r["ms"] for r in v])),
                     "host_ms": float(np.median([r["host_ms"] for r in v]))} for k, v in t.items()}
        print("before/after train step bf16 (in turns, each the median of 5 runs of 20 steps; median of 3): "
              + "; ".join(f"{k} {v['ms']:.3f} ms a step ({BATCH / v['ms'] * 1e3:,.0f} rays/s), host issues "
                          f"it in {v['host_ms']:.3f} ms" for k, v in turns.items()), flush=True)

    # f32: fused step, two-kernel path (forward kernel + B2), plain path
    cfg32 = train_config({**cfg, "compute_dtype": "f32"})
    paths = {}
    mlp.fused_mlp_backward.launches = 0
    mlp.bwd_tile_launches(reset=True)
    for name, backend, fused in (("fused", "pallas", True), ("two-kernel", "pallas", False),
                                 ("plain", "xla", False)):
        c = dataclasses.replace(cfg32, backend=backend)
        st = make_train_state(c, NerfMLP(), dev)
        with warnings.catch_warnings():  # the two-kernel path warns, as JAX does
            warnings.simplefilter("ignore")
            fn = build_train_step(c, NerfMLP(), fused=fused)
        paths[name] = torch.stack([fn(st, rays, pixels) for _ in range(5)]).cpu().numpy()
    b2_launches, f32_tile_launches = mlp.fused_mlp_backward.launches, mlp.bwd_tile_launches()
    diff = max(float(np.max(np.abs(paths[n] / paths["plain"] - 1))) for n in ("fused", "two-kernel"))
    print(f"f32 steps from one state: fused {paths['fused']}, two-kernel {paths['two-kernel']}, "
          f"plain {paths['plain']}; max rel diff {diff:.2e} (tol {STEP_TOL:.0e}); B2 launches "
          f"{b2_launches}; f32 backward tile kernel launches {f32_tile_launches}", flush=True)
    check(diff <= STEP_TOL, "fused, two-kernel and plain steps agree")
    check(b2_launches == 5, "the two-kernel path went through B2 once a step")
    check(f32_tile_launches == 10, "the fused and two-kernel f32 steps launched the f32 tile kernel once a step")
    return dict(launches=launches, b2_launches=b2_launches, f32_tile_launches=f32_tile_launches, step_ms=step_ms,
                host_ms=walls["host_ms"], profile=prof, others=others, turns=turns)


def phase_eval(dev, scene, work, mlp):
    """evaluate.test on the trained run's test split: stills 0 and 1, the
    normals of still 0, the orbit video (ORBIT_POSES frames)."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.evaluate import test
    from nerf_simple_tpu_torch.utils.video import read_avi

    tp = load_yaml("configs/lego.yaml")["test_params"]
    tp.update(loadpath=os.path.join(work, "models", "lego"), datapath=scene,
              savepath=os.path.join(work, "results"), backend="pallas", compute_dtype="bf16",
              im_idxs=[0, 1])
    runs = {"stills": dict(animation=False),
            "normals": dict(animation=False, im_idxs=[0], normals=True),
            "orbit": dict(animation=True, num_poses=ORBIT_POSES)}
    log, secs = io.StringIO(), {}
    mlp.fused_mlp_forward.launches = 0
    for name, extra in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            test({**tp, **extra})
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    launches = mlp.fused_mlp_forward.launches
    text = log.getvalue()
    with open(os.path.join(OUT, "eval_log.txt"), "w") as fh:
        fh.write(text)
    for line in text.splitlines():
        print("eval:", line, flush=True)
    psnr = {int(i): float(p) for i, p in re.findall(r"im (\d+): mse=\S+ psnr=(\S+)", text)}
    out_dir = os.path.join(work, "results", "lego")
    files = set(os.listdir(out_dir))
    videos = [f for f in files if f.startswith("nerf_rgb")]
    check({"rgb_0.png", "rgb_1.png", "depth_0.png", "depth_1.png", "normal_0.png"} <= files,
          "stills, depth and normal PNGs written")
    check(len(videos) == 1, "one orbit video written")
    if videos[0].endswith(".avi"):
        frames, fps = read_avi(os.path.join(out_dir, videos[0]))
        check(frames.shape == (ORBIT_POSES, 400, 400, 3) and fps == 15, "the AVI holds the orbit")
    check(sorted(psnr) == [0, 1] and min(psnr.values()) >= 20.0, "test PSNR >= 20 dB")
    check(launches > 0, "eval rendered through the forward kernel")
    res = dict(psnr=psnr, s_per_still=secs["stills"] / 2, s_normals=secs["normals"],
               s_per_frame=secs["orbit"] / ORBIT_POSES, launches=launches, video=videos[0])
    print(f"eval: test PSNR {psnr[0]:.2f} / {psnr[1]:.2f} dB; {res['s_per_still']:.2f} s a still, "
          f"stills + normals of one {secs['normals']:.2f} s, orbit {res['s_per_frame']:.2f} s a frame "
          f"({ORBIT_POSES} frames, cut from 30; each wall includes loading the scene); "
          f"forward kernel launches {launches}; video {videos[0]}", flush=True)
    return res


def hier_fields(model, dev):
    """The hierarchical run's coarse and fine nets at init, as
    ``make_train_state`` seeds them (``derive_seed(SEED, 0)``, ``(SEED,
    1)``)."""
    from nerf_simple_tpu_torch.models.nerf import NerfField, init_nerf_params
    from nerf_simple_tpu_torch.render.renderer import derive_seed

    return [NerfField.from_jax_params(init_nerf_params(derive_seed(SEED, k), model), dev, model) for k in (0, 1)]


def phase_hier_kernels(dev, scene, model, mlp):
    """B1 with its weights output against its plain version at the two
    passes of a hierarchical step (one 4096-ray batch of the scene: Nc =
    64 stratified samples, 262,144 rows; the union with Nf = 192
    importance samples of the coarse kernel's bf16 weights, 1,048,576
    rows), f32 and bf16: weights, loss, gradients; the same launch
    without the weights output bit-equal; then B2 at 1,048,576 rows on
    seeded cotangents. Peak device memory of the phase."""
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset, sample_ray_batch
    from nerf_simple_tpu_torch.ops.sampling import importance_ts, merge_sorted, stratified_ts
    from nerf_simple_tpu_torch.train.step import build_x16

    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    rays_b, pix_b = sample_ray_batch(g, rd.rays["train"], rd.pixels["train"], BATCH)
    del rd
    ts_c = stratified_ts(g, BATCH, NC, 2.0, 6.0, dev)
    packed = [mlp.pack_weights(f) for f in hier_fields(model, dev)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    with torch.no_grad():
        x_c = build_x16(rays_b, ts_c, pix_b)
        w_c = mlp.fused_train_step(mlp._cast_weights(packed[0], torch.bfloat16), x_c, NC, torch.bfloat16, model,
                                   out_weights=True)[2]
        x_f = build_x16(rays_b, merge_sorted(ts_c, importance_ts(g, ts_c, w_c, NF)), pix_b)
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            for pas, x16, Np, wts in (("coarse", x_c, NC, packed[0]), ("fine", x_f, NC + NF, packed[1])):
                w = mlp._cast_weights(wts, dt)
                rows = x16.shape[1]
                loss, got, wk = mlp.fused_train_step(w, x16, Np, dt, model, out_weights=True)
                loss0, got0 = mlp.fused_train_step(w, x16, Np, dt, model)  # w_out null
                bitwise = loss0.item() == loss.item() and all(torch.equal(a, b) for a, b in zip(got, got0))
                del got0
                loss_p, want, wp = mlp.fused_train_step_plain(w, x16, Np, dt, model, out_weights=True)
                check(bool(torch.isfinite(wk).all()) and all(bool(torch.isfinite(t).all()) for t in got),
                      f"B1 {pas} {name} finite")
                w_err = (wk - wp).abs().max().item()
                rel, abs_err = grad_errors(got, want)
                loss_err = abs(loss.item() / loss_p.item() - 1)
                del got, want, wk, wp
                torch.cuda.empty_cache()
                st = dict(err=max(abs_err, w_err), w_err=w_err, rel=rel, loss_err=loss_err, rows=rows, N=Np,
                          ms=cuda_ms(lambda: mlp.fused_train_step(w, x16, Np, dt, model, out_weights=True)),
                          ms_no_weights=cuda_ms(lambda: mlp.fused_train_step(w, x16, Np, dt, model)),
                          plain_ms=cuda_ms(lambda: mlp.fused_train_step_plain(w, x16, Np, dt, model, True)))
                torch.cuda.empty_cache()
                print(f"B1 out_weights {pas} pass {name} at {rows} rows (N={Np}): weights max abs err {w_err:.3e} "
                      f"(tol {TOL[dt]:.0e}), grad err {rel:.3e} of max (tol {GRAD_TOL['B1', dt]:.0e}), loss rel err "
                      f"{loss_err:.2e} (tol {LOSS_TOL[dt]:.0e}); without the weights output bit-equal: {bitwise}; "
                      f"kernel {st['ms']:.3f} ms ({st['ms_no_weights']:.3f} without the weights), plain "
                      f"{st['plain_ms']:.3f} ms (median of 5)", flush=True)
                check(w_err <= TOL[dt] and rel <= GRAD_TOL["B1", dt] and loss_err <= LOSS_TOL[dt],
                      f"B1 out_weights {pas} {name} within tolerance")
                check(bitwise, f"B1 {pas} {name}: the weights output changes no loss or gradient")
                stats[f"{pas}_{name}"] = st
            # B2 past 2^31 plane elements
            w = mlp._cast_weights(packed[1], dt)
            xT = x_f[:8].contiguous()
            gT = torch.from_numpy(np.random.default_rng(SEED).normal(size=tuple(xT.shape)).astype(np.float32)).to(dev)
            got = mlp.fused_mlp_backward(w, xT, gT, dt, model)
            want = mlp.fused_mlp_backward_plain(w, xT, gT, dt, model)
            rel = grad_errors(got, want)[0]
            del got, want
            torch.cuda.empty_cache()
            print(f"B2 fused_mlp_backward vs plain {name} at {xT.shape[1]} rows: grad err {rel:.3e} of max (tol "
                  f"{GRAD_TOL['B2', dt]:.0e})", flush=True)
            check(rel <= GRAD_TOL["B2", dt], f"B2 {name} at {xT.shape[1]} rows within tolerance")
            stats[f"B2_{name}"] = dict(rel=rel, rows=xT.shape[1])
            del gT, xT
            torch.cuda.empty_cache()
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"hierarchical kernel phase: peak device memory {stats['peak_gb']:.2f} GB "
          "(max_memory_allocated; the f32 plain version of the fine pass the largest)", flush=True)
    return stats


def phase_hier_train(dev, scene, work, mlp):
    """Train configs/lego_hierarchical.yaml's keys through train() (bf16,
    pallas), 300 steps + 100 resumed; time and profile the step by pass;
    then f32 steps from one state, fused two-pass core against the
    autograd path."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.evaluate import load_params
    from nerf_simple_tpu_torch.models.nerf import NerfMLP
    from nerf_simple_tpu_torch.train.loop import train
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    iters, more = 300, 100
    cfg = load_yaml("configs/lego_hierarchical.yaml")
    cfg.update(datapath=scene, savepath=os.path.join(work, "models"), log_dir=os.path.join(work, "logs_hier"),
               num_iters=iters, ckpt_loss=1, ckpt_images=150, ckpt_model=150, steps_per_call=50)
    check(cfg["hierarchical"] and (cfg["Nc"], cfg["Nf"]) == (NC, NF) and cfg["backend"] == "pallas"
          and cfg["compute_dtype"] == "bf16", "the hierarchical config's keys")
    log = io.StringIO()
    mlp.fused_train_step.launches = mlp.fused_train_step.weights_launches = mlp.fused_mlp_forward.launches = 0
    mlp.wgrad_sums_launches(reset=True)
    mlp.bwd_tile_launches(reset=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(fused_train_step=mlp.fused_train_step.launches,
                    weights_output=mlp.fused_train_step.weights_launches,
                    fused_mlp_forward=mlp.fused_mlp_forward.launches,
                    wgrad_sums=mlp.wgrad_sums_launches(), bwd_tile=mlp.bwd_tile_launches())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg.update(resume=True, num_iters=iters + more)
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    resumed = mlp.fused_train_step.launches - launches["fused_train_step"]
    text = log.getvalue()
    with open(os.path.join(OUT, "train_hier_log.txt"), "w") as fh:
        fh.write(text)
    for line in text.splitlines():
        if "resumed from" in line or "final checkpoint" in line or "Val image" in line:
            print("train hierarchical:", line, flush=True)
    losses = scalars(cfg["log_dir"], "Loss/train")
    psnr = scalars(cfg["log_dir"], "Loss/Val_Img_PSNR_0")
    first, last = float(np.mean(losses[:50])), float(np.mean(losses[iters - 50 : iters]))
    print(f"train hierarchical: {iters} steps in {train_s:.1f} s with builds and renders; launches {launches}; "
          f"mean loss (coarse + fine) of the first 50 steps {first:.5f}, of steps {iters - 50}-{iters} {last:.5f}; "
          f"val PSNR(0) {', '.join(f'{p:.2f}' for p in psnr)} dB; peak device memory {peak_gb:.2f} GB", flush=True)
    check(launches["fused_train_step"] == 2 * iters, "two fused train-step launches a hierarchical step")
    check(launches["weights_output"] == iters, "one of them, the coarse pass, with the weights output")
    check(launches["wgrad_sums"] == 2 * iters and launches["bwd_tile"] == 2 * iters,
          "the sums and the backward tile kernel twice a step")
    check(launches["fused_mlp_forward"] > 0, "val renders went through the forward kernel")
    check(all(np.isfinite(losses)) and len(losses) == iters + more, "every loss logged and finite")
    check(last <= 0.5 * first, "the hierarchical loss at least halved")
    check(psnr[-1] > psnr[0], "hierarchical val PSNR rose")
    check("resumed from" in text and resumed == 2 * more and state.step == iters + more, "resume added the steps")
    exp = os.path.join(work, "models", cfg["exp_name"])
    fine = load_params(os.path.join(exp, f"params_{iters + more}.pth"))
    check(np.array_equal(fine["skip"]["w"], state.field.fine.to_jax_params()["skip"]["w"]),
          "the .pth export is the fine net")

    tcfg = train_config(cfg)
    model = NerfMLP(Lp=tcfg.net_Lp, Ld=tcfg.net_Ld, H=tcfg.net_H)
    step_fn = build_train_step(tcfg, model)
    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    rays, pixels = rd.rays["train"], rd.pixels["train"]

    def step():
        return step_fn(state, rays, pixels)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    walls = step_walls(step)
    reserved1 = torch.cuda.memory_reserved()
    step_ms = walls["ms"]
    print(f"train step hierarchical bf16 steady state: {step_ms:.3f} ms a step, {BATCH / step_ms * 1e3:,.0f} "
          f"rays/s (CUDA events over 20 steps, median of 5; runs {', '.join(f'{w:.3f}' for w in walls['walls'])}); "
          f"host issues a step in {walls['host_ms']:.3f} ms; allocator reserved {reserved0 / 1e9:.3f} GB before "
          f"120 steps, {reserved1 / 1e9:.3f} GB after", flush=True)
    check(reserved1 <= reserved0 + (256 << 20), "the allocator's footprint does not grow step after step")
    others, host = {}, {}
    prof = profile_step(step, others, host, split_b1=True)
    busy = sum(prof.values())
    print("train step hierarchical bf16 profile, device ms a step: " + (", ".join(
        f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1]))
        + f"; kernels {busy:.3f} of {step_ms:.3f} ms, idle share {1 - busy / step_ms:.3f}"
        if prof else "not measured (the profiler saw no device activity)"), flush=True)
    print("train step hierarchical bf16 profile, the group other by kernel, ms a step: " + "; ".join(
        f"{n} {v:.3f}" for n, v in sorted(others.items(), key=lambda kv: -kv[1])[:8]), flush=True)
    print(f"train step hierarchical bf16 profile, host self time a step: torch ops {sum(host.values()):.3f} ms "
          "(profiled); " + "; ".join(f"{n} {v:.3f}" for n, v in sorted(host.items(), key=lambda kv: -kv[1])[:10]),
          flush=True)
    del rd, state
    torch.cuda.empty_cache()

    # f32: the fused two-pass core against the autograd path, one step from one state
    cfg32 = dataclasses.replace(tcfg, compute_dtype="f32")
    runs = {}
    mlp.fused_mlp_backward.launches = 0
    for name, fused in (("fused", True), ("autograd", False)):
        st = make_train_state(cfg32, model, dev)
        with warnings.catch_warnings():  # the autograd path under pallas warns, as JAX does
            warnings.simplefilter("ignore")
            fn = build_train_step(cfg32, model, fused=fused)
        runs[name] = float(fn(st, rays, pixels)), st.field.to_jax_params()
        del st
        torch.cuda.empty_cache()
    b2_launches = mlp.fused_mlp_backward.launches
    (l_f, p_f), (l_a, p_a) = runs["fused"], runs["autograd"]
    bad = total = 0
    for k in ("coarse", "fine"):
        for layer in p_a[k]:
            for n in ("w", "b"):
                a, b = p_f[k][layer][n], p_a[k][layer][n]
                bad += int((np.abs(a - b) > 5e-5 + 1e-3 * np.abs(b)).sum())
                total += a.size
    loss_rel = abs(l_f / l_a - 1)
    print(f"f32 hierarchical step from one state: fused two-pass loss {l_f:.6f}, autograd (forward kernel + B2) "
          f"{l_a:.6f}, rel diff {loss_rel:.2e} (tol {HIER_LOSS_RTOL:.0e}); parameters past the bin-flip rule "
          f"{bad}/{total} (tol {BIN_FLIP_SHARE:.1%}); B2 launches {b2_launches}", flush=True)
    check(loss_rel <= HIER_LOSS_RTOL, "fused and autograd hierarchical losses agree")
    check(bad / total < BIN_FLIP_SHARE, "fused and autograd hierarchical steps agree under the bin-flip rule")
    check(b2_launches == 2, "the autograd path went through B2 once a pass")
    return dict(launches=launches, step_ms=step_ms, host_ms=walls["host_ms"], profile=prof, others=others,
                peak_gb=peak_gb, reserved_gb=(reserved0 / 1e9, reserved1 / 1e9), loss_rel_f32=loss_rel,
                bin_flips=bad / total, psnr=psnr, exp=exp)


def phase_hier_eval(dev, scene, work, mlp, exp):
    """evaluate.test with lego_hierarchical.yaml's test_params (Nc = 64,
    N_samples = 192, chunks of 16,384 rays) in bf16 on the pallas backend:
    stills 0 and 1; then ms a hierarchical 400x400 frame."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.evaluate import load_params, test
    from nerf_simple_tpu_torch.models.nerf import NerfPair
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked

    tp = load_yaml("configs/lego_hierarchical.yaml")["test_params"]
    check((tp["Nc"], tp["N_samples"]) == (NC, NF), "the hierarchical test_params")
    tp.update(loadpath=exp, datapath=scene, savepath=os.path.join(work, "results_hier"), backend="pallas",
              compute_dtype="bf16", im_idxs=[0, 1])
    log = io.StringIO()
    mlp.fused_mlp_forward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        test(tp)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = mlp.fused_mlp_forward.launches
    text = log.getvalue()
    for line in text.splitlines():
        print("eval hierarchical:", line, flush=True)
    psnr = {int(i): float(p) for i, p in re.findall(r"im (\d+): mse=\S+ psnr=(\S+)", text)}
    n_chunks = -(-H * W // CHUNK)
    check(sorted(psnr) == [0, 1] and min(psnr.values()) >= 20.0, "hierarchical test PSNR >= 20 dB")
    check(launches == 2 * 2 * n_chunks, "each still's chunks went through the forward kernel, coarse and fine")

    pair = NerfPair.from_jax_params(load_params(exp, keep_hierarchy=True), dev)
    s = RenderSettings(N=NF, N_coarse=NC, backend="pallas", compute_dtype=torch.bfloat16)
    pose = torch.as_tensor(spherical_to_pose(4.0, -30.0, 0.0)[None], dtype=torch.float32, device=dev)
    rays = rays_for_poses(pose, H, W, scene_focal(scene))
    times = []
    for _ in range(4):  # the first one warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb, disp = render_rays_chunked(pair, rays, SEED, s, chunk=tp["batch_size"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(rgb).all() and torch.isfinite(disp).all()), "hierarchical frame finite")
    frame_ms = float(np.median(times[1:]))
    res = dict(psnr=psnr, s_per_still=secs / 2, frame_ms=frame_ms, launches=launches)
    print(f"eval hierarchical: test PSNR {psnr[0]:.2f} / {psnr[1]:.2f} dB; {res['s_per_still']:.2f} s a still "
          f"(evaluate.test wall, loading included); a {H}x{W} frame at Nc={NC} + Nf={NF}, bf16: {frame_ms:.1f} ms "
          f"(median of 3, runs {', '.join(f'{t:.1f}' for t in times[1:])}); forward kernel launches {launches}",
          flush=True)
    return res


def kernel_ms(step, key: str, calls: int = 20) -> float:
    """Device ms of one launch of the kernel whose name holds ``key``, the
    median over ``calls`` calls of ``step`` (torch.profiler, after one
    call); nan where the profiler saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and key in e.name]
    return float(np.median(us)) / 1e3 if us else float("nan")


def walls_in_turns(fns: dict, steps: int = 10) -> dict:
    """ms a call of each of ``fns`` (label -> callable) in runs of ``steps``
    calls back to back (step_walls, median of 5 runs), in turns: the
    labels in order, then in reverse; the median of each."""
    t = {k: [] for k in fns}
    for k in (*fns, *reversed(fns)):
        t[k].append(step_walls(fns[k], steps)["ms"])
    return {k: float(np.median(v)) for k, v in t.items()}


def phase_dist_kernels(dev, scene, model, mlp):
    """B1 with the distortion rail (``dist``, lambda = DIST_LAMBDA) against
    its plain version, in linear and disparity space, f32 and bf16, at the
    training batch (4096 rays of the scene x 128 stratified samples in
    that space, 524,288 rows; the flagship net from numpy seed 0) and at
    the hierarchical fine pass (the union of 64 stratified samples and 192
    importance samples of the coarse net's bf16 weights, 1,048,576 rows;
    the fine net): loss and gradients to B1's bounds, the rail adding to
    the loss; B1 with and without the rail in turns (runs of calls back to
    back; bf16 also with the rail at weight 0, whose cotangents are those
    without it, and the kernel groups of B1 with and without it
    profiled), composite_grad's profiled ms a launch with and without it;
    the plain versions' ms, B1's and composite_grad's alone."""
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset, sample_ray_batch
    from nerf_simple_tpu_torch.models.nerf import NerfField, init_nerf_params
    from nerf_simple_tpu_torch.ops.sampling import importance_ts, merge_sorted, stratified_ts_spaced
    from nerf_simple_tpu_torch.train.step import build_x16

    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    rays_b, pix_b = sample_ray_batch(g, rd.rays["train"], rd.pixels["train"], BATCH)
    del rd
    coarse, fine = (mlp.pack_weights(f) for f in hier_fields(model, dev))
    single = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(SEED, model), dev))
    stats = {}
    with torch.no_grad():
        for space in ("linear", "disparity"):
            dist = (DIST_LAMBDA, 2.0, 6.0, space == "disparity")
            ts = stratified_ts_spaced(g, BATCH, N_SAMPLES, 2.0, 6.0, dev, space=space)
            ts_c = stratified_ts_spaced(g, BATCH, NC, 2.0, 6.0, dev, space=space)
            w_c = mlp.fused_train_step(mlp._cast_weights(coarse, torch.bfloat16), build_x16(rays_b, ts_c, pix_b), NC,
                                       torch.bfloat16, model, out_weights=True)[2]
            ts_f = merge_sorted(ts_c, importance_ts(g, ts_c, w_c, NF))
            for pas, ts_p, wts in (("train", ts, single), ("fine", ts_f, fine)):
                x16, Np = build_x16(rays_b, ts_p, pix_b), ts_p.shape[1]
                for dt in (torch.float32, torch.bfloat16):
                    name = "f32" if dt == torch.float32 else "bf16"
                    w = mlp._cast_weights(wts, dt)

                    def on():
                        return mlp.fused_train_step(w, x16, Np, dt, model, dist=dist)

                    def off():
                        return mlp.fused_train_step(w, x16, Np, dt, model)

                    def zero():  # the rail's code at weight 0: the same cotangents as without it
                        return mlp.fused_train_step(w, x16, Np, dt, model, dist=(0.0, *dist[1:]))

                    loss, got = on()
                    loss_p, want = mlp.fused_train_step_plain(w, x16, Np, dt, model, dist=dist)
                    check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(t).all()) for t in got),
                          f"B1 with the rail {pas} {space} {name} finite")
                    rel, abs_err = grad_errors(got, want)
                    loss_err = abs(loss.item() / loss_p.item() - 1)
                    added = loss.item() - off()[0].item()
                    del got, want
                    torch.cuda.empty_cache()
                    out8, rail = mlp.fused_mlp_forward(w, x16[:8].contiguous(), dt, model), mlp._dist_rail(dist, BATCH)
                    plain_composite_ms = cuda_ms(lambda: mlp._composite_grad(out8, x16, Np, rail))
                    del out8
                    if dt == torch.bfloat16:  # runs of 5 calls of 6-12 ms hide the wrapper's host time
                        turns = walls_in_turns({"off": off, "zero": zero, "on": on}, steps=5)
                    else:  # a call of 47-93 ms: single calls, the wrapper's host time (~0.1 ms) under 0.3% of one
                        turns = {"zero": float("nan"), **walls_in_turns({"off": off, "on": on}, steps=1)}
                    prof = {k: profile_step(f) for k, f in (("off", off), ("on", on))} if dt == torch.bfloat16 else {}
                    st = dict(err=abs_err, rel=rel, loss_err=loss_err, rows=x16.shape[1], N=Np, dist_added=added,
                              ms=turns["on"], ms_no_rail=turns["off"], ms_rail_weight_0=turns["zero"], profile=prof,
                              composite_ms=kernel_ms(on, "composite_grad", calls=20 if prof else 5),
                              composite_ms_no_rail=kernel_ms(off, "composite_grad", calls=20 if prof else 5),
                              plain_composite_ms=plain_composite_ms,
                              plain_ms=cuda_ms(lambda: mlp.fused_train_step_plain(w, x16, Np, dt, model, dist=dist),
                                               reps=3))
                    torch.cuda.empty_cache()
                    print(f"B1 dist rail {pas} pass, {space}, {name} at {st['rows']} rows (N={Np}, lambda "
                          f"{DIST_LAMBDA}): grad err {rel:.3e} of max (tol {GRAD_TOL['B1', dt]:.0e}), max abs "
                          f"{abs_err:.3e}; loss rel err {loss_err:.2e} (tol {LOSS_TOL[dt]:.0e}), the rail adds "
                          f"{added:.3e}; B1 {st['ms']:.3f} ms with the rail, {st['ms_no_rail']:.3f} without, "
                          f"{st['ms_rail_weight_0']:.3f} with it at weight 0 (runs of {5 if prof else 1} calls, "
                          "median of 5, in turns)" + "".join(f"; profiled {k}: " + ", ".join(
                              f"{g} {v:.3f}" for g, v in sorted(p.items(), key=lambda kv: -kv[1])) for k, p in prof.items())
                          + f"; composite_grad {st['composite_ms']:.4f} ms with, "
                          f"{st['composite_ms_no_rail']:.4f} without (profiled, median of {20 if prof else 5}), its plain "
                          "version (torch "
                          f"cumsums, with the rail) {plain_composite_ms:.3f} ms; plain B1 {st['plain_ms']:.3f} ms",
                          flush=True)
                    check(rel <= GRAD_TOL["B1", dt] and loss_err <= LOSS_TOL[dt],
                          f"B1 with the rail {pas} {space} {name} within B1's bounds")
                    check(added > 0, f"the rail adds to the loss ({pas} {space} {name})")
                    stats[f"{pas}_{space}_{name}"] = st
                del x16
                torch.cuda.empty_cache()
    return stats


def probe_distortion(field, rays, dev) -> float:
    """The distortion (s-space, point form, mean over rays) of ``field``'s
    weights on ``rays`` at 128 bin midpoints on [2, 6], f32 forward kernel."""
    from nerf_simple_tpu_torch.ops.sampling import stratified_ts
    from nerf_simple_tpu_torch.ops.volume import distortion_loss, s_norm
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays

    ts = stratified_ts(None, rays.shape[0], N_SAMPLES, 2.0, 6.0, dev, det=True)
    with torch.no_grad():
        out = render_rays(field, rays, None, RenderSettings(N=N_SAMPLES, backend="pallas"), ts=ts)
    return float(distortion_loss(out.weights, s_norm(ts, 2.0, 6.0)))


def phase_reg_train(dev, scene, work, mlp):
    """Train through train() (bf16, pallas, seed 0, REG_ITERS steps) with
    each regulariser: lego.yaml's keys + distortion_loss_weight
    DIST_LAMBDA (the fused step, one B1 launch a step with the rail; the
    trained field's distortion on 16,000 rays of train view 0 against
    phase 7's field at the same steps and seed, which trained without it:
    lower); + depth_loss_weight DEPTH_WEIGHT (autograd through the forward
    kernel and B2, no B1; the depth RMSE on those rays against the
    metric-depth sidecar falls from the initial field's); + sigma_noise
    SIGMA_NOISE (the same path; the loss at least halves);
    lego_hierarchical.yaml's keys + distortion_loss_weight DIST_LAMBDA
    (two B1 launches a step, the fine one with the rail). Each: the loss,
    the launches, ms a step and rays/s (step_walls), the step's profile."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.evaluate import load_params
    from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP
    from nerf_simple_tpu_torch.ops.sampling import stratified_ts
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays
    from nerf_simple_tpu_torch.train.loop import train
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    data = load_blender(scene, True, 25)
    check(data.splits["train"].metric_depth is not None, "the scene's metric-depth sidecars")
    rd = RayDataset.from_blender(data, dev)
    rays, pixels = rd.rays["train"], rd.pixels["train"]
    pixels4 = torch.cat([pixels, torch.as_tensor(data.splits["train"].metric_depth.reshape(-1, 1), device=dev)], 1)
    n = rd.H * rd.W
    probe = rays[:n:10]  # 16,000 rays of train view 0
    probe_depth = pixels4[:n:10, 3]

    def depth_rmse(field):
        ts = stratified_ts(None, probe.shape[0], N_SAMPLES, 2.0, 6.0, dev, det=True)
        with torch.no_grad():
            out = render_rays(field, probe, None, RenderSettings(N=N_SAMPLES, backend="pallas"), ts=ts)
        return float(torch.sqrt(torch.mean((out.depth - probe_depth) ** 2)))

    runs = {"distortion": ("configs/lego.yaml", dict(distortion_loss_weight=DIST_LAMBDA)),
            "depth": ("configs/lego.yaml", dict(depth_loss_weight=DEPTH_WEIGHT)),
            "sigma_noise": ("configs/lego.yaml", dict(sigma_noise=SIGMA_NOISE)),
            "hierarchical_distortion": ("configs/lego_hierarchical.yaml",
                                        dict(distortion_loss_weight=DIST_LAMBDA))}
    res = {}
    for name, (path, kw) in runs.items():
        cfg = load_yaml(path)
        cfg.update(datapath=scene, savepath=os.path.join(work, "models_reg"), exp_name=name,
                   log_dir=os.path.join(work, f"logs_{name}"), backend="pallas", compute_dtype="bf16",
                   num_iters=REG_ITERS, ckpt_loss=1, ckpt_images=10 * REG_ITERS, ckpt_model=REG_ITERS,
                   steps_per_call=50, **kw)
        tcfg = train_config(cfg)
        model = NerfMLP(Lp=tcfg.net_Lp, Ld=tcfg.net_Ld, H=tcfg.net_H)
        mlp.fused_train_step.launches = mlp.fused_train_step.weights_launches = 0
        mlp.fused_train_step.dist_launches = mlp.fused_mlp_backward.launches = mlp.fused_mlp_forward.launches = 0
        log = io.StringIO()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught, contextlib.redirect_stdout(log):
            warnings.simplefilter("always")
            state = train(cfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dict(fused_train_step=mlp.fused_train_step.launches,
                        weights_output=mlp.fused_train_step.weights_launches,
                        dist_rail=mlp.fused_train_step.dist_launches,
                        fused_mlp_backward=mlp.fused_mlp_backward.launches,
                        fused_mlp_forward=mlp.fused_mlp_forward.launches)
        with open(os.path.join(OUT, f"train_{name}_log.txt"), "w") as fh:
            fh.write(log.getvalue())
        losses = scalars(cfg["log_dir"], "Loss/train")
        first, last = float(np.mean(losses[:50])), float(np.mean(losses[-50:]))
        fallback = [str(w.message) for w in caught if "ineligible" in str(w.message)]
        check(len(losses) == REG_ITERS and all(np.isfinite(losses)), f"{name}: every loss logged and finite")
        check(last <= 0.5 * first, f"{name}: the loss at least halved")
        st = dict(launches=launches, first=first, last=last, train_s=train_s, fallback=bool(fallback))
        if name == "distortion":
            check(launches["fused_train_step"] == REG_ITERS and launches["dist_rail"] == REG_ITERS,
                  "distortion: one B1 launch a step, each with the rail")
            plain = NerfField.from_jax_params(
                load_params(os.path.join(work, "models", "lego", f"ckpt_{REG_ITERS}.pth")), dev)
            st["probe_distortion"], st["probe_distortion_without"] = (probe_distortion(state.field, probe, dev),
                                                                      probe_distortion(plain, probe, dev))
            check(st["probe_distortion"] < st["probe_distortion_without"],
                  "the field trained with the rail has less distortion than the one trained without it")
        elif name == "hierarchical_distortion":
            check(launches["fused_train_step"] == 2 * REG_ITERS and launches["weights_output"] == REG_ITERS
                  and launches["dist_rail"] == REG_ITERS,
                  "hierarchical distortion: two B1 launches a step, the coarse with the weights, the fine with the rail")
        else:
            check(launches["fused_train_step"] == 0 and launches["fused_mlp_backward"] == REG_ITERS
                  and launches["fused_mlp_forward"] >= REG_ITERS and fallback,
                  f"{name}: the autograd path (forward kernel and B2 once a step), with JAX's warning")
        if name == "depth":
            st["depth_rmse"] = depth_rmse(state.field)
            st["depth_rmse_init"] = depth_rmse(make_train_state(tcfg, model, dev).field)
            check(st["depth_rmse"] < st["depth_rmse_init"], "depth RMSE of train view 0 fell")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            step_fn = build_train_step(tcfg, model)
        pix = pixels4 if name == "depth" else pixels

        def step():
            return step_fn(state, rays, pix)

        walls = step_walls(step)
        prof = profile_step(step, split_b1=name == "hierarchical_distortion")
        busy = sum(prof.values())
        st.update(step_ms=walls["ms"], host_ms=walls["host_ms"], profile=prof,
                  idle=1 - busy / walls["ms"] if prof else None)
        extra = "".join(f"; {k} {st[k]:.5f}" for k in ("probe_distortion", "probe_distortion_without", "depth_rmse",
                                                         "depth_rmse_init") if k in st)
        print(f"train {name} ({os.path.basename(path)} + {kw}, bf16): {REG_ITERS} steps in {train_s:.1f} s; launches "
              f"{launches}; mean loss of the first 50 steps {first:.5f}, of the last 50 {last:.5f}{extra}; "
              f"{walls['ms']:.3f} ms a step ({BATCH / walls['ms'] * 1e3:,.0f} rays/s; runs "
              f"{', '.join(f'{w:.3f}' for w in walls['walls'])}), host issues it in {walls['host_ms']:.3f} ms; "
              "profile, device ms a step: " + (", ".join(
                  f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1]))
                  + f"; idle share {st['idle']:.3f}" if prof else "not measured")
              + (f"; warned: {fallback[0]}" if fallback else ""), flush=True)
        res[name] = st
        del state, step_fn
        torch.cuda.empty_cache()
    return res


def prop_pair(model, dev):
    """The proposal run's nets at init, as ``make_train_state`` seeds them:
    the proposal net from ``derive_seed(SEED, 0)``, the main field from
    ``(SEED, 1)``."""
    from nerf_simple_tpu_torch.models.nerf import NerfField, init_nerf_params
    from nerf_simple_tpu_torch.models.proposal import (
        ProposalField,
        ProposalMLP,
        ProposalPair,
        init_proposal_params,
    )
    from nerf_simple_tpu_torch.render.renderer import derive_seed

    pm = ProposalMLP()
    return ProposalPair(ProposalField.from_jax_params(init_proposal_params(derive_seed(SEED, 0), pm), dev, pm),
                        NerfField.from_jax_params(init_nerf_params(derive_seed(SEED, 1), model), dev, model))


@contextlib.contextmanager
def plain_b1(mlp):
    """The train step's B1 swapped for its plain version (no launch), for
    the comparison of a whole core with and without the kernel."""
    from nerf_simple_tpu_torch.train import step as step_mod

    def plain(wts, x16, N, compute_dtype, model, out_weights=False, dist=None):
        with torch.no_grad():
            return mlp.fused_train_step_plain(mlp._cast_weights(wts, compute_dtype), x16, N, compute_dtype, model,
                                              out_weights, dist)

    kernel, step_mod.fused_train_step = step_mod.fused_train_step, plain
    try:
        yield
    finally:
        step_mod.fused_train_step = kernel


def max_rel(got: dict, want: dict) -> float:
    """Max over tensors of max |got - want| over max |want|."""
    return max(((got[n] - w).abs().max() / w.abs().max().clamp_min(1e-30)).item() for n, w in want.items())


def phase_prop_kernels(dev, scene, model, mlp):
    """The fused proposal core (``train/step.py::proposal_fused_loss``) with
    the CUDA B1 against the same core with B1's plain version: one batch of
    4096 rays of the scene, NP_PROP stratified probes, N_SAMPLES
    importance samples of the initial proposal net's bf16 weights, the
    same probes and samples handed to both; nets from numpy seeds as the
    run seeds them; f32 and bf16, the rail off and at DIST_LAMBDA. Loss,
    both nets' gradients and the main field's weights to B1's bounds; one
    B1 launch, with the weights output and the rail. Then B1 at those
    samples (524,288 rows) with the weights output and the rail, with the
    weights output alone and with neither, in turns; and the core's other
    pieces alone (bf16): the proposal MLP's forward and backward, the
    sampling, the interlevel loss and its backward."""
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset, sample_ray_batch
    from nerf_simple_tpu_torch.models.proposal import ProposalPair, proposal_weights
    from nerf_simple_tpu_torch.ops.sampling import importance_ts, stratified_ts
    from nerf_simple_tpu_torch.ops.volume import interlevel_loss
    from nerf_simple_tpu_torch.train.step import build_x16, proposal_fused_loss

    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    rays_b, pix_b = sample_ray_batch(g, rd.rays["train"], rd.pixels["train"], BATCH)
    del rd
    pair0 = prop_pair(model, dev)
    ts_p = stratified_ts(g, BATCH, NP_PROP, 2.0, 6.0, dev)
    with torch.no_grad():
        w_prop = proposal_weights(pair0.prop, rays_b, ts_p, torch.bfloat16)
        ts_f = importance_ts(g, ts_p, w_prop, N_SAMPLES)
    params = pair0.to_jax_params()
    stats = {}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        for dist in (None, (DIST_LAMBDA, 2.0, 6.0, False)):
            runs = {}
            for which in ("kernel", "plain"):
                pair = ProposalPair.from_jax_params(params, dev)
                before = (mlp.fused_train_step.launches, mlp.fused_train_step.weights_dist_launches)
                with plain_b1(mlp) if which == "plain" else contextlib.nullcontext():
                    loss, w_f = proposal_fused_loss(pair, rays_b, pix_b, ts_p, None, N_SAMPLES, dt, model, 1.0,
                                                    dist=dist, ts_f=ts_f)
                torch.cuda.synchronize()
                launched = (mlp.fused_train_step.launches - before[0],
                            mlp.fused_train_step.weights_dist_launches - before[1])
                runs[which] = (loss.item(), w_f, {k: {n: p.grad for n, p in getattr(pair, k).named_parameters()}
                                                  for k in ("prop", "fine")}, launched)
            (loss, w, grads, launched), (loss_p, w_p, grads_p, launched_p) = runs["kernel"], runs["plain"]
            st = dict(w_err=(w - w_p).abs().max().item(), loss_err=abs(loss / loss_p - 1),
                      fine_rel=max_rel(grads["fine"], grads_p["fine"]),
                      prop_rel=max_rel(grads["prop"], grads_p["prop"]), launched=launched)
            tag = f"{name} {'rail' if dist else 'no rail'}"
            print(f"proposal core, B1 vs plain, {tag} at {BATCH * N_SAMPLES} rows (Np={NP_PROP}): weights max abs err "
                  f"{st['w_err']:.3e} (tol {TOL[dt]:.0e}), loss rel err {st['loss_err']:.2e} (tol "
                  f"{LOSS_TOL[dt]:.0e}), main field grads {st['fine_rel']:.3e} of max, proposal net grads "
                  f"{st['prop_rel']:.3e} of max (tol {GRAD_TOL['B1', dt]:.0e}); launches (B1, with weights and "
                  f"rail) {launched}, plain {launched_p}", flush=True)
            check(launched == (1, int(dist is not None)) and launched_p == (0, 0),
                  f"the proposal core launched B1 once ({tag}), with the weights and the rail together")
            check(st["w_err"] <= TOL[dt] and st["loss_err"] <= LOSS_TOL[dt]
                  and max(st["fine_rel"], st["prop_rel"]) <= GRAD_TOL["B1", dt],
                  f"the proposal core with B1 matches plain ({tag})")
            stats[f"{name}_{'dist' if dist else 'no_dist'}"] = st
            del runs, grads, grads_p
            torch.cuda.empty_cache()
    # B1 at the proposal batch with both outputs, the weights alone, neither: in turns
    x16 = build_x16(rays_b, ts_f, pix_b)
    dist = (DIST_LAMBDA, 2.0, 6.0, False)
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            wts = mlp._cast_weights(mlp.pack_weights(pair0.fine), dt)
            fns = {"weights_and_rail": lambda: mlp.fused_train_step(wts, x16, N_SAMPLES, dt, model, True, dist),
                   "weights": lambda: mlp.fused_train_step(wts, x16, N_SAMPLES, dt, model, True),
                   "neither": lambda: mlp.fused_train_step(wts, x16, N_SAMPLES, dt, model)}
            turns = walls_in_turns(fns, steps=10 if dt == torch.bfloat16 else 1)  # f32: single calls of ~47 ms
            stats[f"turns_{name}"] = turns
            stats[f"plain_ms_{name}"] = cuda_ms(lambda: mlp.fused_train_step_plain(
                wts, x16, N_SAMPLES, dt, model, True, dist), reps=3)
            print(f"B1 at the proposal batch, {name}, {BATCH * N_SAMPLES} rows (runs of "
                  f"{10 if dt == torch.bfloat16 else 1} calls, median of 5, in turns): " + ", ".join(
                      f"{k} {v:.3f} ms" for k, v in turns.items()) + f"; plain (both) {stats[f'plain_ms_{name}']:.3f} ms",
                  flush=True)
    # the core's other pieces alone, bf16: kernel ms a call (profiled) and wall ms a call (runs of 20)
    cot = torch.from_numpy(np.random.default_rng(SEED).normal(size=(BATCH, NP_PROP)).astype(np.float32)).to(dev)
    wp = w_prop.detach().clone().requires_grad_(True)

    def prop_mlp():
        proposal_weights(pair0.prop, rays_b, ts_p, torch.bfloat16).backward(cot)

    def sampling():
        return importance_ts(g, stratified_ts(g, BATCH, NP_PROP, 2.0, 6.0, dev), w_prop, N_SAMPLES)

    def interlevel():
        interlevel_loss(w, ts_f, wp, ts_p).backward()

    pieces = {}
    for k, fn in (("proposal_mlp", prop_mlp), ("sampling", sampling), ("interlevel", interlevel)):
        pieces[k] = dict(kernel_ms=sum(profile_step(fn).values()), wall_ms=step_walls(fn)["ms"])
    stats["pieces"] = pieces
    print("proposal pieces alone, bf16, a call (kernel ms profiled / wall ms of runs of 20): " + "; ".join(
        f"{k} {v['kernel_ms']:.3f} / {v['wall_ms']:.3f}" for k, v in pieces.items())
        + " (the proposal MLP: encoding, 5 products and relus at 262,144 rows, its weights, their backward)",
        flush=True)
    del x16, cot, wp
    torch.cuda.empty_cache()
    return stats


def phase_prop_train(dev, scene, work, mlp):
    """Train configs/lego_proposal.yaml's keys + distortion_loss_weight
    DIST_LAMBDA through train() (bf16, pallas), 300 steps + 100 resumed:
    one B1 launch a step with the weights output and the rail together;
    the loss halves, val PSNR rises, the interlevel loss of a held-out
    batch (4096 val rays, deterministic probes and samples) at step 300
    below its value at step 50. The step's wall, host issue and profile
    by pass, the allocator's peak; then f32 steps from one state through
    the fused proposal core and the autograd path under JAX's rule."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset, sample_ray_batch
    from nerf_simple_tpu_torch.evaluate import load_params
    from nerf_simple_tpu_torch.models.nerf import NerfMLP
    from nerf_simple_tpu_torch.models.proposal import ProposalPair
    from nerf_simple_tpu_torch.ops.volume import interlevel_loss
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_proposal
    from nerf_simple_tpu_torch.train.checkpoint import checkpoint_params
    from nerf_simple_tpu_torch.train.loop import train
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    iters, more = 300, 100
    cfg = load_yaml("configs/lego_proposal.yaml")
    cfg.update(datapath=scene, savepath=os.path.join(work, "models"), log_dir=os.path.join(work, "logs_prop"),
               num_iters=iters, ckpt_loss=1, ckpt_images=150, ckpt_model=150, steps_per_call=50,
               distortion_loss_weight=DIST_LAMBDA)
    check(cfg["proposal"] and (cfg["Np"], cfg["Nf"]) == (NP_PROP, N_SAMPLES) and cfg["backend"] == "pallas"
          and cfg["compute_dtype"] == "bf16", "the proposal config's keys")
    tcfg = train_config(cfg)
    model = NerfMLP(Lp=tcfg.net_Lp, Ld=tcfg.net_Ld, H=tcfg.net_H)
    log = io.StringIO()
    b1 = mlp.fused_train_step
    b1.launches = b1.weights_launches = b1.dist_launches = b1.weights_dist_launches = 0
    mlp.fused_mlp_forward.launches = 0
    mlp.wgrad_sums_launches(reset=True)
    mlp.bwd_tile_launches(reset=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(fused_train_step=b1.launches, weights_output=b1.weights_launches, dist_rail=b1.dist_launches,
                    weights_and_rail=b1.weights_dist_launches, fused_mlp_forward=mlp.fused_mlp_forward.launches,
                    wgrad_sums=mlp.wgrad_sums_launches(), bwd_tile=mlp.bwd_tile_launches())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg.update(resume=True, num_iters=iters + more)
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    resumed = b1.weights_dist_launches - launches["weights_and_rail"]
    text = log.getvalue()
    with open(os.path.join(OUT, "train_prop_log.txt"), "w") as fh:
        fh.write(text)
    for line in text.splitlines():
        if "resumed from" in line or "final checkpoint" in line or "Val image" in line:
            print("train proposal:", line, flush=True)
    losses = scalars(cfg["log_dir"], "Loss/train")
    psnr = scalars(cfg["log_dir"], "Loss/Val_Img_PSNR_0")
    first, last = float(np.mean(losses[:50])), float(np.mean(losses[iters - 50 : iters]))
    exp = os.path.join(work, "models", cfg["exp_name"])

    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    held, held_pix = sample_ray_batch(g, rd.rays["val"], rd.pixels["val"], BATCH)
    s_eval = RenderSettings(N=N_SAMPLES, N_prop=NP_PROP, backend="pallas", compute_dtype=torch.bfloat16)

    def held_out(field):
        """(interlevel, mse) of the held-out batch, probes and samples deterministic."""
        with torch.no_grad():
            out, (tp, wp, tf) = render_rays_proposal(field, held, None, s_eval, det_fine=True, return_aux=True)
        return float(interlevel_loss(out.weights, tf, wp, tp)), float(torch.mean((out.rgb - held_pix) ** 2))

    il = {"init": held_out(make_train_state(tcfg, model, dev).field)}
    for k in (50, iters):
        il[k] = held_out(ProposalPair.from_jax_params(checkpoint_params(os.path.join(exp, f"ckpt_{k}.pth")), dev))
    print(f"train proposal: {iters} steps in {train_s:.1f} s with builds and renders; launches {launches}; mean "
          f"loss (MSE + interlevel + distortion) of the first 50 steps {first:.5f}, of steps {iters - 50}-{iters} "
          f"{last:.5f}; val PSNR(0) {', '.join(f'{p:.2f}' for p in psnr)} dB; held-out batch (interlevel, MSE) "
          + ", ".join(f"step {k}: ({v[0]:.5f}, {v[1]:.5f})" for k, v in il.items())
          + f"; peak device memory {peak_gb:.2f} GB", flush=True)
    check(launches["fused_train_step"] == iters and launches["weights_and_rail"] == iters,
          "one B1 launch a proposal step, with the weights output and the rail together")
    check(launches["wgrad_sums"] == iters and launches["bwd_tile"] == iters,
          "the sums and the backward tile kernel once a step")
    check(launches["fused_mlp_forward"] > 0, "val renders went through the forward kernel")
    check(all(np.isfinite(losses)) and len(losses) == iters + more, "every loss logged and finite")
    check(last <= 0.5 * first, "the proposal loss at least halved")
    check(psnr[-1] > psnr[0], "proposal val PSNR rose")
    check(il[iters][0] < il[50][0], "the held-out interlevel loss fell from step 50 to step 300")
    check("resumed from" in text and resumed == more and state.step == iters + more, "resume added the steps")
    fine = load_params(os.path.join(exp, f"params_{iters + more}.pth"))
    check(np.array_equal(fine["skip"]["w"], state.field.fine.to_jax_params()["skip"]["w"]),
          "the .pth export is the main field")

    step_fn = build_train_step(tcfg, model)
    rays, pixels = rd.rays["train"], rd.pixels["train"]

    def step():
        return step_fn(state, rays, pixels)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    walls = step_walls(step)
    reserved1 = torch.cuda.memory_reserved()
    step_ms = walls["ms"]
    others, host = {}, {}
    prof = profile_step(step, others, host, split_proposal=True)
    busy = sum(prof.values())
    idle = 1 - busy / step_ms if prof else None
    print(f"train step proposal bf16 steady state: {step_ms:.3f} ms a step, {BATCH / step_ms * 1e3:,.0f} rays/s "
          f"(CUDA events over 20 steps, median of 5; runs {', '.join(f'{w:.3f}' for w in walls['walls'])}); host "
          f"issues a step in {walls['host_ms']:.3f} ms; allocator reserved {reserved0 / 1e9:.3f} GB before 120 "
          f"steps, {reserved1 / 1e9:.3f} GB after", flush=True)
    print("train step proposal bf16 profile, device ms a step: " + (", ".join(
        f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1]))
        + f"; kernels {busy:.3f} of {step_ms:.3f} ms, idle share {idle:.3f}"
        if prof else "not measured (the profiler saw no device activity)"), flush=True)
    print(f"train step proposal bf16 profile, host self time a step: torch ops {sum(host.values()):.3f} ms "
          "(profiled); " + "; ".join(f"{n} {v:.3f}" for n, v in sorted(host.items(), key=lambda kv: -kv[1])[:10]),
          flush=True)
    check(reserved1 <= reserved0 + (256 << 20), "the allocator's footprint does not grow step after step")
    del state
    torch.cuda.empty_cache()

    # f32: the fused proposal core against the autograd path, one step from one state
    cfg32 = dataclasses.replace(tcfg, compute_dtype="f32")
    runs = {}
    mlp.fused_mlp_backward.launches = 0
    for name, fused in (("fused", True), ("autograd", False)):
        st = make_train_state(cfg32, model, dev)
        with warnings.catch_warnings():  # the autograd path under pallas warns, as JAX does
            warnings.simplefilter("ignore")
            fn = build_train_step(cfg32, model, fused=fused)
        runs[name] = float(fn(st, rays, pixels)), st.field.to_jax_params()
        del st
        torch.cuda.empty_cache()
    b2_launches = mlp.fused_mlp_backward.launches
    (l_f, p_f), (l_a, p_a) = runs["fused"], runs["autograd"]
    bad = total = 0
    for k in ("prop", "fine"):
        for layer in p_a[k]:
            for n in ("w", "b"):
                a, b = p_f[k][layer][n], p_a[k][layer][n]
                bad += int((np.abs(a - b) > PROP_PARAM_ATOL + PROP_PARAM_RTOL * np.abs(b)).sum())
                total += a.size
    loss_rel = abs(l_f / l_a - 1)
    print(f"f32 proposal step from one state: fused core loss {l_f:.6f}, autograd (forward kernel + B2) {l_a:.6f}, "
          f"rel diff {loss_rel:.2e} (tol {PROP_LOSS_RTOL:.0e}); parameters past atol {PROP_PARAM_ATOL:.0e} + rtol "
          f"{PROP_PARAM_RTOL:.0e}: {bad}/{total} (tol 0); B2 launches {b2_launches}", flush=True)
    check(loss_rel <= PROP_LOSS_RTOL and bad == 0, "fused and autograd proposal steps agree under JAX's rule")
    check(b2_launches == 1, "the autograd path went through B2 once")
    return dict(launches=launches, step_ms=step_ms, host_ms=walls["host_ms"], profile=prof, others=others,
                idle=idle, peak_gb=peak_gb, reserved_gb=(reserved0 / 1e9, reserved1 / 1e9), loss_rel_f32=loss_rel,
                params_past_rule=bad, psnr=psnr, held_out=il, first=first, last=last, exp=exp)


def cli_frame(loadpath: str, focal: float, args: list, log_name: str, what: str, r: float = 4.5):
    """``python -m nerf_simple_tpu_torch.serve`` of ``loadpath`` (H x W,
    bf16, pallas, N_SAMPLES, and ``args``) in a process of its own: one
    frame at radius ``r``, theta -30, phi 30 over HTTP, between two
    /health reads; the server stopped. (PNG bytes, content type, the two
    /health answers, the request's ms.) Its output goes to
    OUT/``log_name``; ``what`` names the check that it started."""
    port = free_port()
    served_log = open(os.path.join(OUT, log_name), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "nerf_simple_tpu_torch.serve", "--loadpath", loadpath, "--height", str(H), "--width",
         str(W), "--focal", repr(float(focal)), "--backend", "pallas", "--dtype", "bf16", "--samples", str(N_SAMPLES),
         *args, "--port", str(port)], stdout=served_log, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 240
        while True:
            try:
                health = json.loads(get(url + "/health")[0])
                break
            except OSError:
                if proc.poll() is not None or time.time() > deadline:
                    with open(served_log.name) as fh:
                        print(fh.read()[-3000:], flush=True)
                    check(False, what)
                time.sleep(1.0)
        t0 = time.perf_counter()
        data, ctype = get(f"{url}/render?r={r:g}&theta=-30&phi=30")
        http_ms = (time.perf_counter() - t0) * 1e3
        health_after = json.loads(get(url + "/health")[0])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        served_log.close()
    return data, ctype, health, health_after, http_ms


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def phase_prop_eval(dev, scene, work, mlp, exp):
    """evaluate.test with lego_proposal.yaml's test_params (Np = 64,
    N_samples = 128, chunks of 16,384 rays) in bf16 on the pallas backend:
    stills 0 and 1; ms a proposal 400x400 frame; then
    ``python -m nerf_simple_tpu_torch.serve --proposal-samples 64`` in a
    process of its own serves one frame over HTTP, which must match
    ``render_rays_chunked`` to 1 level."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.evaluate import load_params, test
    from nerf_simple_tpu_torch.models.proposal import ProposalPair
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked
    from nerf_simple_tpu_torch.serve import decode_png

    tp = load_yaml("configs/lego_proposal.yaml")["test_params"]
    check((tp["Np"], tp["N_samples"]) == (NP_PROP, N_SAMPLES), "the proposal test_params")
    tp.update(loadpath=exp, datapath=scene, savepath=os.path.join(work, "results_prop"), backend="pallas",
              compute_dtype="bf16", im_idxs=[0, 1])
    log = io.StringIO()
    mlp.fused_mlp_forward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        test(tp)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = mlp.fused_mlp_forward.launches
    text = log.getvalue()
    for line in text.splitlines():
        print("eval proposal:", line, flush=True)
    psnr = {int(i): float(p) for i, p in re.findall(r"im (\d+): mse=\S+ psnr=(\S+)", text)}
    n_chunks = -(-H * W // CHUNK)
    check(sorted(psnr) == [0, 1] and min(psnr.values()) >= 20.0, "proposal test PSNR >= 20 dB")
    check(launches == 2 * n_chunks, "each still's chunks went through the forward kernel once")

    pair = ProposalPair.from_jax_params(load_params(exp, keep_hierarchy=True), dev)
    s = RenderSettings(N=N_SAMPLES, N_prop=NP_PROP, backend="pallas", compute_dtype=torch.bfloat16)
    focal = scene_focal(scene)

    def frame(phi):
        pose = torch.as_tensor(spherical_to_pose(4.0, -30.0, phi)[None], dtype=torch.float32, device=dev)
        return render_rays_chunked(pair, rays_for_poses(pose, H, W, focal), 0, s, chunk=tp["batch_size"])

    times = []
    mlp.fused_mlp_forward.launches = 0
    for _ in range(4):  # the first one warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb, disp = frame(0.0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    frame_launches = mlp.fused_mlp_forward.launches // 4
    check(bool(torch.isfinite(rgb).all() and torch.isfinite(disp).all()), "proposal frame finite")
    check(frame_launches == n_chunks, "a proposal frame's chunks went through the forward kernel")
    frame_ms = float(np.median(times[1:]))

    # the CLI server, in a process of its own, with the proposal samples
    data, ctype, health, health_after, http_ms = cli_frame(
        os.path.join(exp, "params_400.npz"), focal, ["--proposal-samples", str(NP_PROP)], "serve_prop_log.txt",
        "the proposal server started", r=4.0)
    check(health["proposal"] is True and ctype == "image/png", "/health of the proposal server")
    served = decode_png(data)
    want = (frame(30.0)[0].reshape(H, W, 3).cpu().numpy() * 255).astype(np.uint8)
    u8_err = int(np.abs(served.astype(int) - want.astype(int)).max())
    served_launches = health_after["kernel_launches"] - health["kernel_launches"]
    res = dict(psnr=psnr, s_per_still=secs / 2, frame_ms=frame_ms, launches=launches, frame_launches=frame_launches,
               served_u8_err=u8_err, served_launches=served_launches, http_ms=http_ms)
    print(f"eval proposal: test PSNR {psnr[0]:.2f} / {psnr[1]:.2f} dB; {res['s_per_still']:.2f} s a still "
          f"(evaluate.test wall, loading included); a {H}x{W} frame at Np={NP_PROP} + N={N_SAMPLES}, bf16: "
          f"{frame_ms:.1f} ms (median of 3, runs {', '.join(f'{t:.1f}' for t in times[1:])}); forward kernel "
          f"launches {launches} (stills), {frame_launches} a frame; served over HTTP by the CLI with "
          f"--proposal-samples {NP_PROP}: {len(data)} B PNG in {http_ms:.1f} ms, {served_launches} forward launches, "
          f"max diff from render_rays_chunked {u8_err} levels", flush=True)
    check(u8_err <= 1, "the served proposal frame matches render_rays_chunked to 1 level")
    check(served_launches == n_chunks, "the served frame's chunks went through the forward kernel")
    return res


def mip_chunk_input(dev, focal: float = FOCAL):
    """The mip forward's (16, 2,097,152) input for the middle chunk of a
    400x400 frame as the mip render builds it (render/renderer.py::
    _fused_mlp_bn_mip): N + 1 stratified edges a ray, the frustum
    Gaussians' means in rows 0..2, unit dirs 3..5, diagonal variances
    11..13, for the frame's cone radius 2 / sqrt(12) / focal."""
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.ops.sampling import frustum_gaussians_T, stratified_ts

    pose = torch.as_tensor(spherical_to_pose(4.0, -30.0, 0.0)[None], dtype=torch.float32, device=dev)
    rays = rays_for_poses(pose, H, W, focal)[72000 : 72000 + CHUNK]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    edges = stratified_ts(g, CHUNK, N + 1, 2.0, 6.0, dev)
    meanT, unitT, varT, _ = frustum_gaussians_T(rays, edges, mip_radius(focal))
    x16 = torch.zeros((16, CHUNK, N), dtype=torch.float32, device=dev)
    x16[0:3], x16[3:6], x16[11:14] = meanT, unitT[:, :, None], varT
    return x16.reshape(16, CHUNK * N)


def mip_radius(focal: float) -> float:
    """A pixel's world-space half-width at unit distance: the cone radius
    a unit of t that the entry points compute (mip-NeRF sec. 3.1)."""
    return 2.0 / np.sqrt(12.0) / focal


def phase_mip_kernels(dev, scene, model, mlp):
    """The cone-cast variants against their plain versions, nets from
    ``derive_seed(SEED, 0)`` (the mip run's init): the forward with the
    integrated encoder at a 2,097,152-row render chunk (and at zero
    variance bit-equal to the point forward); B1 with mip at the training
    batch (4096 rays x N_SAMPLES intervals of the scene, 524,288 rows, the
    scene's cone radius) in four cases: plain, with the weights output,
    with the opaque tail, with the interval rail and per-ray loss weights
    in [0.25, 2] on row 14; B2 with mip on seeded cotangents. f32 and
    bf16; ms (CUDA events, median of 5) and the plain version's."""
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset, sample_ray_batch
    from nerf_simple_tpu_torch.models.nerf import NerfField, init_nerf_params
    from nerf_simple_tpu_torch.ops.sampling import stratified_ts
    from nerf_simple_tpu_torch.render.renderer import derive_seed
    from nerf_simple_tpu_torch.train.step import build_x16_mip

    packed = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(derive_seed(SEED, 0), model), dev))
    stats = {}
    x = mip_chunk_input(dev)
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            w = mlp._cast_weights(packed, dt)
            before = mlp.fused_mlp_forward.mip_launches
            got = mlp.fused_mlp_forward(w, x, dt, model, mip=True)
            torch.cuda.synchronize()
            launched = mlp.fused_mlp_forward.mip_launches - before
            want = mlp.fused_mlp_forward_plain(w, x, dt, model, mip=True)
            err = (got[:4] - want[:4]).abs().max().item()
            x0 = x.clone()
            x0[11:14] = 0.0
            point_equal = torch.equal(mlp.fused_mlp_forward(w, x0, dt, model, mip=True),
                                      mlp.fused_mlp_forward(w, x0[:8].contiguous(), dt, model))
            del got, want, x0
            st = dict(err=err, ms=cuda_ms(lambda: mlp.fused_mlp_forward(w, x, dt, model, mip=True)),
                      point_ms=cuda_ms(lambda: mlp.fused_mlp_forward(w, x[:8].contiguous(), dt, model)),
                      plain_ms=cuda_ms(lambda: mlp.fused_mlp_forward_plain(w, x, dt, model, mip=True), reps=3),
                      rows=x.shape[1], point_equal=point_equal)
            torch.cuda.empty_cache()
            print(f"mip forward (integrated encoder) vs plain {name} at {x.shape[1]} rows: max abs err {err:.3e} "
                  f"(tol {TOL[dt]:.0e}); kernel {st['ms']:.3f} ms (the point forward {st['point_ms']:.3f} ms), plain "
                  f"{st['plain_ms']:.3f} ms; at zero variance bit-equal to the point forward: {point_equal}",
                  flush=True)
            check(launched == 1 and err <= TOL[dt], f"the mip forward {name} matches plain")
            check(point_equal, f"the mip forward {name} at zero variance is the point forward")
            stats[f"fwd_{name}"] = st
    del x
    torch.cuda.empty_cache()

    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    rays_b, pix_b = sample_ray_batch(g, rd.rays["train"], rd.pixels["train"], BATCH)
    del rd
    edges = stratified_ts(g, BATCH, N_SAMPLES + 1, 2.0, 6.0, dev)
    x16 = build_x16_mip(rays_b, edges, pix_b, mip_radius(scene_focal(scene)))
    x16_lw = x16.clone()
    x16_lw[14] = torch.from_numpy(np.random.default_rng(SEED).uniform(0.25, 2.0, BATCH).astype(np.float32)).to(
        dev).repeat_interleave(N_SAMPLES)
    cases = {"plain": (x16, {}), "weights": (x16, dict(out_weights=True)), "opaque": (x16, dict(opaque_tail=True)),
             "rail": (x16_lw, dict(dist=(DIST_LAMBDA, 2.0, 6.0, False)))}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            w = mlp._cast_weights(packed, dt)
            for case, (xc, kw) in cases.items():
                before = (mlp.fused_train_step.mip_launches, mlp.fused_train_step.opaque_launches)
                out = mlp.fused_train_step(w, xc, N_SAMPLES, dt, model, mip=True, **kw)
                torch.cuda.synchronize()
                launched = (mlp.fused_train_step.mip_launches - before[0],
                            mlp.fused_train_step.opaque_launches - before[1])
                want = mlp.fused_train_step_plain(w, xc, N_SAMPLES, dt, model, mip=True, **kw)
                check(all(bool(torch.isfinite(t).all()) for t in out[1]), f"B1 mip {case} {name} finite")
                rel, abs_err = grad_errors(out[1], want[1])
                loss_err = abs(out[0].item() / want[0].item() - 1)
                w_err = (out[2] - want[2]).abs().max().item() if kw.get("out_weights") else 0.0
                del out, want
                torch.cuda.empty_cache()
                st = dict(err=max(abs_err, w_err), rel=rel, loss_err=loss_err, w_err=w_err, rows=xc.shape[1],
                          ms=cuda_ms(lambda: mlp.fused_train_step(w, xc, N_SAMPLES, dt, model, mip=True, **kw)),
                          plain_ms=cuda_ms(lambda: mlp.fused_train_step_plain(w, xc, N_SAMPLES, dt, model, mip=True,
                                                                              **kw), reps=3))
                torch.cuda.empty_cache()
                print(f"B1 mip {case} vs plain {name} at {xc.shape[1]} rows: grad err {rel:.3e} of max (tol "
                      f"{GRAD_TOL['B1', dt]:.0e}), loss rel err {loss_err:.2e} (tol {LOSS_TOL[dt]:.0e})"
                      + (f", weights max abs err {w_err:.3e} (tol {TOL[dt]:.0e})" if kw.get("out_weights") else "")
                      + f"; kernel {st['ms']:.3f} ms, plain {st['plain_ms']:.3f} ms; launches (mip, opaque) "
                      f"{launched}", flush=True)
                check(launched == (1, int(case == "opaque")), f"B1 mip {case} {name} counted")
                check(rel <= GRAD_TOL["B1", dt] and loss_err <= LOSS_TOL[dt] and w_err <= TOL[dt],
                      f"B1 mip {case} {name} within tolerance")
                stats[f"b1_{case}_{name}"] = st
            gT = torch.from_numpy(np.random.default_rng(SEED).normal(size=(8, x16.shape[1])).astype(np.float32)).to(dev)
            got = mlp.fused_mlp_backward(w, x16, gT, dt, model, mip=True)
            want = mlp.fused_mlp_backward_plain(w, x16, gT, dt, model, mip=True)
            rel, abs_err = grad_errors(got, want)
            del got, want
            torch.cuda.empty_cache()
            st = dict(err=abs_err, rel=rel, rows=x16.shape[1],
                      ms=cuda_ms(lambda: mlp.fused_mlp_backward(w, x16, gT, dt, model, mip=True)),
                      plain_ms=cuda_ms(lambda: mlp.fused_mlp_backward_plain(w, x16, gT, dt, model, mip=True), reps=3))
            torch.cuda.empty_cache()
            print(f"B2 mip vs plain {name} at {x16.shape[1]} rows: grad err {rel:.3e} of max (tol "
                  f"{GRAD_TOL['B2', dt]:.0e}); kernel {st['ms']:.3f} ms, plain {st['plain_ms']:.3f} ms", flush=True)
            check(rel <= GRAD_TOL["B2", dt], f"B2 mip {name} within tolerance")
            stats[f"b2_{name}"] = st
            del gT
    del x16, x16_lw
    torch.cuda.empty_cache()
    return stats


def phase_mip_train(dev, scene, work, mlp):
    """Train configs/lego_mip.yaml's keys through train() (bf16, pallas,
    mip_levels 2: two cone-cast B1 launches a step on one pack, the coarse
    one with the weights output), 300 steps + 100 resumed; the step's
    wall, host issue and profile by pass (kernels in time order: before
    B1, coarse B1, between the two (resample_edges, the fine x16), fine B1,
    after B1, Adam; resample_edges and one x16 build also alone), the idle
    share; then f32 steps from one state, the fused core against the
    autograd path (the forward kernel and B2, both with mip)."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset, sample_ray_batch
    from nerf_simple_tpu_torch.evaluate import load_params
    from nerf_simple_tpu_torch.models.nerf import NerfMLP
    from nerf_simple_tpu_torch.ops.sampling import resample_edges, stratified_ts
    from nerf_simple_tpu_torch.train.loop import train
    from nerf_simple_tpu_torch.train.step import build_train_step, build_x16_mip, make_train_state

    iters, more = 300, 100
    cfg = load_yaml("configs/lego_mip.yaml")
    cfg.update(datapath=scene, savepath=os.path.join(work, "models"), log_dir=os.path.join(work, "logs_mip"),
               num_iters=iters, ckpt_loss=1, ckpt_images=150, ckpt_model=150, steps_per_call=50)
    check(cfg["mip"] and cfg["mip_levels"] == 2 and cfg["Nf"] == N_SAMPLES and cfg["backend"] == "pallas"
          and cfg["compute_dtype"] == "bf16", "the mip config's keys")
    b1 = mlp.fused_train_step
    counts = ("launches", "weights_launches", "mip_launches", "opaque_launches", "dist_launches")
    for c in counts:
        setattr(b1, c, 0)
    mlp.fused_mlp_forward.launches = mlp.fused_mlp_forward.mip_launches = 0
    mlp.wgrad_sums_launches(reset=True)
    mlp.bwd_tile_launches(reset=True)
    log = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {c: getattr(b1, c) for c in counts}
    launches.update(fused_mlp_forward=mlp.fused_mlp_forward.launches,
                    fused_mlp_forward_mip=mlp.fused_mlp_forward.mip_launches,
                    wgrad_sums=mlp.wgrad_sums_launches(), bwd_tile=mlp.bwd_tile_launches())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg.update(resume=True, num_iters=iters + more)
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    resumed = b1.mip_launches - launches["mip_launches"]
    text = log.getvalue()
    with open(os.path.join(OUT, "train_mip_log.txt"), "w") as fh:
        fh.write(text)
    for line in text.splitlines():
        if "resumed from" in line or "final checkpoint" in line or "Val image" in line:
            print("train mip:", line, flush=True)
    losses = scalars(cfg["log_dir"], "Loss/train")
    psnr = scalars(cfg["log_dir"], "Loss/Val_Img_PSNR_0")
    first, last = float(np.mean(losses[:50])), float(np.mean(losses[iters - 50 : iters]))
    print(f"train mip: {iters} steps in {train_s:.1f} s with builds and renders; launches {launches}; mean loss "
          f"(0.1 coarse + fine) of the first 50 steps {first:.5f}, of steps {iters - 50}-{iters} {last:.5f}; val "
          f"PSNR(0) {', '.join(f'{p:.2f}' for p in psnr)} dB; peak device memory {peak_gb:.2f} GB", flush=True)
    check(launches["launches"] == launches["mip_launches"] == 2 * iters,
          "two cone-cast B1 launches a mip_levels: 2 step")
    check(launches["weights_launches"] == iters and launches["opaque_launches"] == launches["dist_launches"] == 0,
          "one of them, the coarse level, with the weights output")
    check(launches["wgrad_sums"] == 2 * iters and launches["bwd_tile"] == 2 * iters,
          "the sums and the backward tile kernel twice a step")
    check(launches["fused_mlp_forward_mip"] > 0 and launches["fused_mlp_forward_mip"] == launches["fused_mlp_forward"],
          "val renders went through the forward kernel's integrated encoder")
    check(all(np.isfinite(losses)) and len(losses) == iters + more, "every loss logged and finite")
    check(last <= 0.5 * first, "the mip loss at least halved")
    check(psnr[-1] > psnr[0], "mip val PSNR rose")
    check("resumed from" in text and resumed == 2 * more and state.step == iters + more, "resume added the steps")
    exp = os.path.join(work, "models", cfg["exp_name"])
    check(np.array_equal(load_params(os.path.join(exp, f"params_{iters + more}.pth"))["skip"]["w"],
                         state.field.to_jax_params()["skip"]["w"]), "the .pth export is the field")

    tcfg = train_config(cfg)
    model = NerfMLP(Lp=tcfg.net_Lp, Ld=tcfg.net_Ld, H=tcfg.net_H)
    radius = mip_radius(scene_focal(scene))
    step_fn = build_train_step(tcfg, model, base_radius=radius)
    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    rays, pixels = rd.rays["train"], rd.pixels["train"]

    def step():
        return step_fn(state, rays, pixels)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = step_walls(step)
    step_ms = walls["ms"]
    others, host = {}, {}
    prof = profile_step(step, others, host, split_mip=True)
    busy = sum(prof.values())
    idle = 1 - busy / step_ms if prof else None
    # the pieces between the two B1 launches, alone (bf16 weights of the trained field)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    rays_b, pix_b = sample_ray_batch(g, rays, pixels, BATCH)
    edges = stratified_ts(g, BATCH, N_SAMPLES + 1, 2.0, 6.0, dev)
    w_c = torch.rand((BATCH, N_SAMPLES), generator=g, device=dev)
    pieces = {"resample_edges": sum(profile_step(lambda: resample_edges(g, edges, w_c, N_SAMPLES)).values()),
              "x16_build": sum(profile_step(lambda: build_x16_mip(rays_b, edges, pix_b, radius)).values())}
    print(f"train step mip bf16 steady state: {step_ms:.3f} ms a step, {BATCH / step_ms * 1e3:,.0f} rays/s (CUDA "
          f"events over 20 steps, median of 5; runs {', '.join(f'{w:.3f}' for w in walls['walls'])}); host issues a "
          f"step in {walls['host_ms']:.3f} ms", flush=True)
    print("train step mip bf16 profile, device ms a step: " + (", ".join(
        f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1]))
        + f"; kernels {busy:.3f} of {step_ms:.3f} ms, idle share {idle:.3f}; alone, kernel ms a call: "
        f"resample_edges {pieces['resample_edges']:.3f}, one x16 build {pieces['x16_build']:.3f}"
        if prof else "not measured (the profiler saw no device activity)"), flush=True)
    print("train step mip bf16 profile, the group other by kernel, ms a step: " + "; ".join(
        f"{n} {v:.3f}" for n, v in sorted(others.items(), key=lambda kv: -kv[1])[:8]), flush=True)
    print(f"train step mip bf16 profile, host self time a step: torch ops {sum(host.values()):.3f} ms (profiled); "
          + "; ".join(f"{n} {v:.3f}" for n, v in sorted(host.items(), key=lambda kv: -kv[1])[:10]), flush=True)
    del state, rd
    torch.cuda.empty_cache()

    # f32: the fused two-level core against the autograd path, one step from one state
    cfg32 = dataclasses.replace(tcfg, compute_dtype="f32")
    runs = {}
    mlp.fused_mlp_backward.launches = mlp.fused_mlp_backward.mip_launches = 0
    for name, fused in (("fused", True), ("autograd", False)):
        st = make_train_state(cfg32, model, dev)
        with warnings.catch_warnings():  # the autograd path under pallas warns, as JAX does
            warnings.simplefilter("ignore")
            fn = build_train_step(cfg32, model, fused=fused, base_radius=radius)
        runs[name] = float(fn(st, rays, pixels)), st.field.to_jax_params()
        del st
        torch.cuda.empty_cache()
    b2_launches = (mlp.fused_mlp_backward.launches, mlp.fused_mlp_backward.mip_launches)
    (l_f, p_f), (l_a, p_a) = runs["fused"], runs["autograd"]
    bad = total = 0
    for layer in p_a:
        for n in ("w", "b"):
            a, b = p_f[layer][n], p_a[layer][n]
            bad += int((np.abs(a - b) > 5e-5 + 1e-3 * np.abs(b)).sum())
            total += a.size
    loss_rel = abs(l_f / l_a - 1)
    print(f"f32 mip step from one state: fused two-level core loss {l_f:.6f}, autograd (forward kernel + B2, mip) "
          f"{l_a:.6f}, rel diff {loss_rel:.2e} (tol {MIP_LOSS_RTOL:.0e}); parameters past the bin-flip rule "
          f"{bad}/{total} (tol {BIN_FLIP_SHARE:.1%}); B2 launches (all, mip) {b2_launches}", flush=True)
    check(loss_rel <= MIP_LOSS_RTOL, "fused and autograd mip losses agree")
    check(bad / total < BIN_FLIP_SHARE, "fused and autograd mip steps agree under the bin-flip rule")
    check(b2_launches == (2, 2), "the autograd path went through B2's mip variant once a level")
    return dict(launches=launches, step_ms=step_ms, host_ms=walls["host_ms"], profile=prof, pieces=pieces,
                idle=idle, peak_gb=peak_gb, loss_rel_f32=loss_rel, bin_flips=bad / total, psnr=psnr, first=first,
                last=last, exp=exp, b2_launches=b2_launches[1])


def phase_mip_eval(dev, scene, work, mlp, exp):
    """evaluate.test with lego_mip.yaml's test_params (mip_levels 2,
    N_samples 128, chunks of 16,384 rays) in bf16 on the pallas backend:
    stills 0 and 1; ms a two-level 400x400 mip frame; then ``python -m
    nerf_simple_tpu_torch.serve --mip --mip-levels 2`` in a process of its
    own serves one frame over HTTP, which must match
    ``render_rays_chunked`` to 1 level."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.evaluate import load_params, test
    from nerf_simple_tpu_torch.models.nerf import NerfField
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked
    from nerf_simple_tpu_torch.serve import decode_png

    tp = load_yaml("configs/lego_mip.yaml")["test_params"]
    check(tp["mip"] and tp["mip_levels"] == 2 and tp["N_samples"] == N_SAMPLES, "the mip test_params")
    tp.update(loadpath=exp, datapath=scene, savepath=os.path.join(work, "results_mip"), backend="pallas",
              compute_dtype="bf16", im_idxs=[0, 1])
    log = io.StringIO()
    mlp.fused_mlp_forward.launches = mlp.fused_mlp_forward.mip_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        test(tp)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = mlp.fused_mlp_forward.mip_launches
    text = log.getvalue()
    for line in text.splitlines():
        print("eval mip:", line, flush=True)
    psnr = {int(i): float(p) for i, p in re.findall(r"im (\d+): mse=\S+ psnr=(\S+)", text)}
    n_chunks = -(-H * W // CHUNK)
    check(sorted(psnr) == [0, 1] and min(psnr.values()) >= 20.0, "mip test PSNR >= 20 dB")
    check(launches == mlp.fused_mlp_forward.launches == 2 * 2 * n_chunks,
          "each still's chunks went through the mip forward kernel, at both levels")

    field = NerfField.from_jax_params(load_params(exp), dev)
    focal = scene_focal(scene)
    s = RenderSettings(N=N_SAMPLES, backend="pallas", compute_dtype=torch.bfloat16, mip=True, mip_levels=2,
                       base_radius=mip_radius(focal))

    def frame(phi):
        pose = torch.as_tensor(spherical_to_pose(4.0, -30.0, phi)[None], dtype=torch.float32, device=dev)
        return render_rays_chunked(field, rays_for_poses(pose, H, W, focal), 0, s, chunk=tp["batch_size"])

    times = []
    for _ in range(4):  # the first one warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb, disp = frame(0.0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(rgb).all() and torch.isfinite(disp).all()), "mip frame finite")
    frame_ms = float(np.median(times[1:]))

    data, ctype, health, health_after, http_ms = cli_frame(
        os.path.join(exp, "params_400.npz"), focal, ["--mip", "--mip-levels", "2"], "serve_mip_log.txt",
        "the mip server started", r=4.0)
    check(health["mip"] is True and ctype == "image/png", "/health of the mip server")
    served = decode_png(data)
    want = (frame(30.0)[0].reshape(H, W, 3).cpu().numpy() * 255).astype(np.uint8)
    u8_err = int(np.abs(served.astype(int) - want.astype(int)).max())
    served_launches = health_after["kernel_launches"] - health["kernel_launches"]
    res = dict(psnr=psnr, s_per_still=secs / 2, frame_ms=frame_ms, launches=launches, served_u8_err=u8_err,
               served_launches=served_launches, http_ms=http_ms)
    print(f"eval mip: test PSNR {psnr[0]:.2f} / {psnr[1]:.2f} dB; {res['s_per_still']:.2f} s a still (evaluate.test "
          f"wall, loading included); a {H}x{W} two-level mip frame at N={N_SAMPLES}, bf16: {frame_ms:.1f} ms (median "
          f"of 3, runs {', '.join(f'{t:.1f}' for t in times[1:])}); mip forward launches {launches} (stills); served "
          f"over HTTP by the CLI with --mip --mip-levels 2: {len(data)} B PNG in {http_ms:.1f} ms, {served_launches} "
          f"forward launches, max diff from render_rays_chunked {u8_err} levels", flush=True)
    check(u8_err <= 1, "the served mip frame matches render_rays_chunked to 1 level")
    check(served_launches == 2 * n_chunks, "the served frame's chunks went through the forward kernel, both levels")
    return res


# Pose refinement (configs/lego.yaml + pose_opt): the recipe's length, cut
# from the JAX package's 4000 (scripts/pose_freeze_bench.py) to keep the
# script inside its time limit (at 3000 steps the translation ends above
# the perturbation; it is not held), its perturbation of the train
# poses, the share of the perturbation's rotation the refined rig may keep
# (measured 0.73 at 4000 steps, 0.788 at 3000; the unrefined rig keeps 1),
# and the f32 pose step's bounds from one state. The kernel
# step and the xla step sum in other orders: the loss to LOSS_TOL's f32
# bound, each gradient tensor (the field's and the delta tables') within
# 1e-3 of its largest entry (the dr/dt gradients are sums over every ray
# of an image, ~20,000 of 524,288 rows).
POSE_ITERS, POSE_DR, POSE_DT, POSE_SEED = 3000, 0.02, 0.05, 7
POSE_ROT_KEPT = 0.85
POSE_GRAD_RTOL = 1e-3
# dx against plain, max abs error over max |dx|: the input-gradient kernel
# on the same cotangent planes sums in another order (probes/input_grad.py).
# B2's dx also carries B2's own forward, whose relu masks can differ from
# the plain chain's where a pre-activation lies within the forward's
# rounding of 0; that row's dx then moves by a whole term (f32: 2.8e-2 of
# max |dx| at one row of 524,288). So B2's dx must equal the input-gradient
# kernel on the kernels' own planes bit for bit, every row past DX_TOL from
# plain (the position and direction rows each against their own largest
# entry) must have a flipped mask, the plain chain on the kernel's own masks
# must give it within DX_TOL at every row (probes/input_grad.py::explain_dx),
# and under DX_ROW_SHARE of the rows may lie past DX_TOL. The same rule
# must catch both planted faults there.
DX_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-3}
# DX_ROW_SHARE: the most rows past DX_TOL measured in a sound run, with
# room (f32 3.05e-5 at 524,288 rows, none in the card tests; bf16 1.46e-3
# at 4,113 rows, 5.7e-4 at 524,288), far below the least share a planted
# fault puts past it (0.66, bf16 at 524,288 rows).
DX_ROW_SHARE = {torch.float32: 1e-4, torch.bfloat16: 3e-3}


def _rotation(r) -> np.ndarray:
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def perturb_train_poses(scene: str, seed: int = POSE_SEED) -> None:
    """Rotate each train camera by POSE_DR rad about a random axis and move
    it by POSE_DT in a random direction (scripts/pose_freeze_bench.py:64-77,
    the JAX package's miscalibrated rig), in place."""
    path = os.path.join(scene, "transforms_train.json")
    with open(path) as fh:
        tj = json.load(fh)
    rng = np.random.default_rng(seed)
    for fr in tj["frames"]:
        p = np.array(fr["transform_matrix"], np.float64)
        er = rng.normal(size=3)
        er *= POSE_DR / max(np.linalg.norm(er), 1e-9)
        et = rng.normal(size=3)
        et *= POSE_DT / max(np.linalg.norm(et), 1e-9)
        p[:3, :3] = _rotation(er) @ p[:3, :3]
        p[:3, 3] += et
        fr["transform_matrix"] = p.tolist()
    with open(path, "w") as fh:
        json.dump(tj, fh)


def rig_error(clean: str, pert: str, dr=None, dt=None) -> dict:
    """Mean rotation (rad) and translation error of the train rig of
    ``pert`` against ``clean``, refined by the deltas (``dr``, ``dt``: a
    camera's rays rotate by R(dr) about its centre, which moves by dt):
    as they stand ("rot", "trans"), and after the one rigid motion of the
    whole rig that best maps its centres onto the clean ones ("rot_aligned",
    "trans_aligned"; Kabsch), since a field trained on a rig moved as a
    whole is as good: what BARF's evaluation aligns away."""
    poses = []
    for scene in (clean, pert):
        with open(os.path.join(scene, "transforms_train.json")) as fh:
            poses.append(np.array([f["transform_matrix"] for f in json.load(fh)["frames"]], np.float64))
    (pc, pp), n = poses, len(poses[0])
    R = np.stack([pp[i, :3, :3] if dr is None else _rotation(np.asarray(dr[i], np.float64)) @ pp[i, :3, :3]
                  for i in range(n)])
    c = pp[:, :3, 3] + (0.0 if dt is None else np.asarray(dt, np.float64))
    Rg, cg = pc[:, :3, :3], pc[:, :3, 3]
    U, _, Vt = np.linalg.svd((c - c.mean(0)).T @ (cg - cg.mean(0)))
    A = Vt.T @ np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))]) @ U.T  # rotation: c - mean -> cg - mean

    def errs(Rs, cs):
        cos = (np.einsum("nij,nij->n", Rs, Rg) - 1.0) / 2.0  # trace(R Rg^T)
        return float(np.mean(np.arccos(np.clip(cos, -1.0, 1.0)))), float(np.mean(np.linalg.norm(cs - cg, axis=1)))

    rot, trans = errs(R, c)
    rot_a, trans_a = errs(A[None] @ R, (c - c.mean(0)) @ A.T + cg.mean(0))
    return dict(rot=rot, trans=trans, rot_aligned=rot_a, trans_aligned=trans_a)


def phase_pose_kernels(dev, scene, model, mlp, earlier) -> dict:
    """13a. The pose kernel variants against their plain versions, nets
    from numpy seed SEED: the forward with the anneal windows (alpha 0.3
    and 1) at a 2,097,152-row render chunk, timed beside the forward
    without them and the plain one; at alpha 1 (every window 1) bit-equal
    to the forward without windows. B2 with ``want_dx`` at the training
    batch (524,288 rows) with and without the windows: its weight
    gradients and dx against plain, its weight gradients bit-equal to the
    same launch without ``want_dx``, timed beside it. The input-gradient
    kernel alone (probes/input_grad.py): ms, plain, the torch.mm
    yardstick, share of its bound. With ``earlier`` (an earlier commit's
    libraries), the forward and B2 without windows or dx bit-equal to
    theirs. f32 and bf16."""
    from nerf_simple_tpu_torch.models.nerf import NerfField, init_nerf_params
    from nerf_simple_tpu_torch.probes import input_grad as ig_probe
    from nerf_simple_tpu_torch.probes.wgrad import turns_ms

    packed = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(SEED, model), dev))
    stats = {}
    x = chunk_input(dev)[:8].contiguous()
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            w = mlp._cast_weights(packed, dt)
            none = mlp.fused_mlp_forward(w, x, dt, model)
            errs = {}
            for alpha in (0.3, 1.0):
                enc_w = mlp.anneal_row_weights(model, alpha, dev)
                before = mlp.fused_mlp_forward.anneal_launches
                got = mlp.fused_mlp_forward(w, x, dt, model, enc_w=enc_w)
                torch.cuda.synchronize()
                check(mlp.fused_mlp_forward.anneal_launches == before + 1, "the windowed forward is counted")
                want = mlp.fused_mlp_forward_plain(w, x, dt, model, enc_w=enc_w)
                errs[alpha] = (got[:4] - want[:4]).abs().max().item()
                if alpha == 1.0:
                    ones_equal = torch.equal(got, none)
                del got, want
                torch.cuda.empty_cache()
            enc_w = mlp.anneal_row_weights(model, 0.3, dev)
            ms = turns_ms({"windows": lambda: mlp.fused_mlp_forward(w, x, dt, model, enc_w=enc_w),
                           "none": lambda: mlp.fused_mlp_forward(w, x, dt, model)})
            st = dict(err=max(errs.values()), err_a03=errs[0.3], err_a1=errs[1.0], ms=ms["windows"],
                      ms_no_windows=ms["none"], rows=x.shape[1], alpha1_bit_equal=ones_equal,
                      plain_ms=cuda_ms(lambda: mlp.fused_mlp_forward_plain(w, x, dt, model, enc_w=enc_w), reps=3))
            if earlier:
                st["bit_equal_earlier"] = torch.equal(none, earlier_forward(mlp, earlier["fused_mlp_fwd"], w, x, dt,
                                                                            model))
            del none
            torch.cuda.empty_cache()
            print(f"pose forward (anneal windows) vs plain {name} at {x.shape[1]} rows: max abs err alpha 0.3 "
                  f"{errs[0.3]:.3e}, alpha 1 {errs[1.0]:.3e} (tol {TOL[dt]:.0e}); in turns: windows {st['ms']:.3f} ms, "
                  f"none {st['ms_no_windows']:.3f} ms; plain {st['plain_ms']:.3f} ms; alpha 1 bit-equal to no windows: "
                  f"{ones_equal}" + (f"; no windows bit-equal to the earlier library's: {st['bit_equal_earlier']}"
                                     if earlier else ""), flush=True)
            check(max(errs.values()) <= TOL[dt], f"the windowed forward {name} matches plain")
            check(ones_equal and st.get("bit_equal_earlier", True), f"the forward {name} without windows unchanged")
            stats[f"fwd_{name}"] = st
    del x
    torch.cuda.empty_cache()

    x16 = train_batch(dev, scene)
    x = x16[:8].contiguous()
    del x16
    gT = torch.from_numpy(np.random.default_rng(SEED).normal(size=(8, x.shape[1])).astype(np.float32)).to(dev)
    b2 = mlp.fused_mlp_backward
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            w = mlp._cast_weights(packed, dt)
            for case, enc_w in (("", None), ("_windows", mlp.anneal_row_weights(model, 0.3, dev))):
                before = (b2.dx_launches, mlp.input_grad_launches())
                grads, dx = b2(w, x, gT, dt, model, want_dx=True, enc_w=enc_w)
                torch.cuda.synchronize()
                check((b2.dx_launches, mlp.input_grad_launches()) == (before[0] + 1, before[1] + 1),
                      "B2 with want_dx counted, its input-gradient kernel counted in C")
                alone = b2(w, x, gT, dt, model, enc_w=enc_w)
                bit_equal = all(torch.equal(a, c) for a, c in zip(grads, alone))
                _, res = mlp.forward_residuals(w, x, dt, model, enc_w=enc_w)
                gws = mlp.backward_tile(w, res, gT, dt, model)
                del res
                composed = torch.equal(dx, mlp.input_grad(w, x, gws, dt, model, enc_w))
                del gws
                if earlier and enc_w is None:
                    bit_equal_earlier = all(torch.equal(a, c) for a, c in zip(
                        alone, earlier_backward(mlp, earlier["fused_mlp_bwd"], w, x, gT, dt, model)))
                want, dx_p = mlp.fused_mlp_backward_plain(w, x, gT, dt, model, want_dx=True, enc_w=enc_w)
                rel, abs_err = grad_errors(grads, want)
                dx_rel = ((dx - dx_p).abs().max() / dx_p.abs().max()).item()
                ex = ig_probe.explain_dx(w, x, gT, dx, dx_p, dt, model, enc_w, DX_TOL[dt])
                del grads, dx, alone, want, dx_p
                torch.cuda.empty_cache()
                ms = turns_ms({"dx": lambda: b2(w, x, gT, dt, model, want_dx=True, enc_w=enc_w),
                               "no_dx": lambda: b2(w, x, gT, dt, model, enc_w=enc_w)})
                st = dict(err=abs_err, rel=rel, dx_rel=dx_rel, dx_rows=ex, ms=ms["dx"], ms_no_dx=ms["no_dx"],
                          rows=x.shape[1], bit_equal_no_dx=bit_equal, dx_equal_composed=composed,
                          plain_ms=cuda_ms(lambda: mlp.fused_mlp_backward_plain(w, x, gT, dt, model, want_dx=True,
                                                                                enc_w=enc_w), reps=3))
                if earlier and enc_w is None:
                    st["bit_equal_earlier"] = bit_equal_earlier
                torch.cuda.empty_cache()
                print(f"B2 want_dx{case} vs plain {name} at {x.shape[1]} rows: grad err {rel:.3e} of max (tol "
                      f"{GRAD_TOL['B2', dt]:.0e}); dx err {dx_rel:.3e} of max |dx|, rows past {DX_TOL[dt]:.0e} of it "
                      f"{ex['n_past']} ({ex['share']:.2e}, tol {DX_ROW_SHARE[dt]:.0e}), rows with a flipped relu mask "
                      f"{ex['n_flipped']}, rows past without one {ex['n_unexplained']}, on the kernel's own masks "
                      f"{ex['own_masks_err']:.2e} of max |dx|; planted faults: " + ", ".join(
                          f"{k} {f['share']:.2e} of the rows past ({f['n_unexplained']} without a flipped mask)"
                          for k, f in ex["faults"].items()) + "; dx bit-equal to the input-gradient kernel on the "
                      f"kernels' own planes: {composed}; in turns: with dx {st['ms']:.3f} ms, without "
                      f"{st['ms_no_dx']:.3f} ms; plain {st['plain_ms']:.3f} ms; grads bit-equal to the launch without "
                      f"dx: {bit_equal}"
                      + (f"; without dx or windows bit-equal to the earlier library's: {bit_equal_earlier}"
                         if earlier and enc_w is None else ""), flush=True)
                check(rel <= GRAD_TOL["B2", dt] and composed and ex["n_unexplained"] == 0
                      and ex["own_masks_err"] <= DX_TOL[dt] and ex["share"] <= DX_ROW_SHARE[dt],
                      f"B2 want_dx{case} {name} within tolerance")
                check(all(f["n_unexplained"] > 0 for f in ex["faults"].values()),
                      f"the dx rule catches both planted faults ({name}{case})")
                check(bit_equal and st.get("bit_equal_earlier", True), f"B2 {name}'s weight gradients unchanged")
                stats[f"b2_{name}{case}"] = st
    del x, gT
    torch.cuda.empty_cache()
    ig = ig_probe.run(dev, model)
    for name in ("f32", "bf16"):
        v = ig[name]
        print(f"input-gradient kernel alone {name} at {ig['rows']} rows: {v['ms']:.3f} ms (windows "
              f"{v['ms_anneal']:.3f}), plain {v['plain_ms']:.3f} ms, torch.mm yardstick {v['library_ms']:.3f} ms; bound "
              f"{v['bound_ms']:.3f} ms ({v['bound_by']}), {100 * v['share_of_bound']:.1f}% of it, {v['tflops']:.1f} "
              f"TFLOP/s; dx err {v['rel_err']:.2e} of max |dx| (windows {ig[name + '_anneal']['rel_err']:.2e}; tol "
              f"{ig_probe.REL_TOL[torch.float32 if name == 'f32' else torch.bfloat16]:.0e})", flush=True)
    stats["input_grad"] = ig
    if earlier:  # every instantiation beside the earlier library's, in turns
        ba = ig_probe.before_after(dev, {k: earlier[k] for k in ("fused_mlp_bwd", "fused_contract")})
        print(ig_probe.before_after_line(ba), flush=True)
        stats["input_grad_before_after"] = ba
    return stats


def earlier_forward(mlp, lib, w, x, dt, model, enc_w=None) -> torch.Tensor:
    """The forward of an earlier library (no mip, no contract; the windows
    ``enc_w`` and an appearance model's codes as the current one takes
    them, which an earlier library without them refuses), straight through
    ctypes."""
    bf16, app = int(dt == torch.bfloat16), mlp._app(model)
    wx, wd = mlp._enc_w_ptrs(enc_w, model, x.device)
    out = torch.empty((8, x.shape[1]), dtype=torch.float32, device=x.device)
    image = torch.empty(lib.fused_mlp_fwd_image_bytes(model.Lp, model.Ld, model.H, bf16, app), dtype=torch.uint8,
                        device=x.device)
    mlp._raise_on(lib.fused_mlp_fwd(x.data_ptr(), out.data_ptr(), x.shape[1], model.Lp, model.Ld, model.H, bf16,
                                    mlp._CPtrs(*mlp._ptrs(w)), image.data_ptr(), 0, wx, wd, app, 0, mlp._stream(x)),
                  "earlier fused_mlp_fwd")
    return out


def earlier_backward(mlp, lib, w, x, gT, dt, model, want_dx: bool = False, mip: bool = False, enc_w=None):
    """B2 of an earlier library (no contract; the windows ``enc_w`` and an
    appearance model's codes as the current one takes them; with
    ``want_dx`` also dx, which an earlier library without the input
    gradient refuses; with ``mip`` its mip recompute, not with dx)."""
    bf16, app = int(dt == torch.bfloat16), mlp._app(model)
    wx, wd = mlp._enc_w_ptrs(enc_w, model, x.device, mip)
    ws = torch.empty(lib.fused_mlp_bwd_workspace_bytes(x.shape[1], model.Lp, model.Ld, model.H, bf16, app),
                     dtype=torch.uint8, device=x.device)
    grads = mlp._empty_grads(model, x.device)
    dx = torch.empty((mlp._x_rows(mip, model), x.shape[1]), dtype=torch.float32, device=x.device) if want_dx else None
    mlp._raise_on(lib.fused_mlp_bwd(x.data_ptr(), gT.data_ptr(), x.shape[1], model.Lp, model.Ld, model.H, bf16,
                                    mlp._CPtrs(*mlp._ptrs(w)), mlp._weights_t(w), ws.data_ptr(),
                                    mlp._CPtrs(*mlp._ptrs(grads)), int(mip), wx, wd,
                                    None if dx is None else dx.data_ptr(), app, 0, mlp._stream(x)),
                  "earlier fused_mlp_bwd")
    return (grads, dx) if want_dx else grads


def dx_as_earlier(dx, dx_earlier, dt, mip: bool = False) -> bool:
    """B2's dx against an earlier library's on the same inputs: bit-equal in
    f32; in bf16 within MIP_CONTRACT_TOL by row group (``row_err``), since
    the bf16 input-gradient kernel runs its products on the tensor cores
    (csrc/input_grad.cuh's input_grad_mma), which sum the same bf16
    products in f32 in another order than the SIMT kernel did."""
    from nerf_simple_tpu_torch.probes import input_grad as ig_probe

    if dt == torch.float32:
        return torch.equal(dx, dx_earlier)
    return ig_probe.row_err(dx, dx_earlier, mip).max().item() <= ig_probe.MIP_CONTRACT_TOL


def phase_pose_train(dev, scene, work, mlp) -> dict:
    """13b. The pose step, lego.yaml's keys + pose_opt (warmup 15),
    pe_anneal_until 100 and pose_freeze_at 150 (steps_per_call 50) through
    train() (bf16, pallas), 300 steps on the phase-7 scene: before the
    freeze one forward and one B2 launch with the input gradient a step,
    with the windows until step 100; after it one B1 launch a step; the
    sidecar written. Then the pose step itself mid-anneal (step 50, from
    a fresh state): its wall (CUDA events) and host issue, kernel ms by
    pass (torch.profiler, kernels in time order: the forward, B2, the
    input-gradient kernel, Adam, the rest: the ray and compositing
    autograd), idle share, peak memory."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.models.nerf import NerfMLP
    from nerf_simple_tpu_torch.train.loop import train
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    iters, freeze, until = 300, 150, 100
    cfg = load_yaml("configs/lego.yaml")
    cfg.update(datapath=scene, savepath=os.path.join(work, "models_pose"), log_dir=os.path.join(work, "logs_pose"),
               backend="pallas", compute_dtype="bf16", num_iters=iters, ckpt_loss=1, ckpt_images=500,
               ckpt_model=freeze, steps_per_call=50, pose_opt=True, pose_warmup=15, pe_anneal_until=until,
               pose_freeze_at=freeze)
    check(cfg["Nf"] == N_SAMPLES and cfg["batch_size"] == BATCH, "lego's keys")
    fwd, b2, b1 = mlp.fused_mlp_forward, mlp.fused_mlp_backward, mlp.fused_train_step
    fwd.launches = fwd.anneal_launches = b2.launches = b2.dx_launches = b2.anneal_launches = b1.launches = 0
    mlp.input_grad_launches(reset=True)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(fused_mlp_forward=fwd.launches, forward_anneal=fwd.anneal_launches, b2=b2.launches,
                    b2_dx=b2.dx_launches, b2_anneal=b2.anneal_launches, input_grad=mlp.input_grad_launches(),
                    fused_train_step=b1.launches)
    text = log.getvalue()
    with open(os.path.join(OUT, "train_pose_log.txt"), "w") as fh:
        fh.write(text)
    exp = os.path.join(work, "models_pose", cfg["exp_name"])
    losses = scalars(cfg["log_dir"], "Loss/train")
    print(f"train pose: {iters} steps in {train_s:.1f} s with renders; launches {launches}; "
          + next(line for line in text.splitlines() if "pose freeze at step" in line), flush=True)
    check(launches["b2_dx"] == launches["b2"] == launches["input_grad"] == freeze,
          "one B2 launch with the input gradient a step before the freeze")
    check(launches["b2_anneal"] == until and launches["forward_anneal"] >= until,
          "the forward and B2 with the windows until pe_anneal_until")
    check(launches["fused_train_step"] == iters - freeze, "one B1 launch a step after the freeze")
    check(os.path.exists(os.path.join(exp, "cam_deltas.npz")) and state.cams is None, "the freeze baked the deltas")
    check(all(np.isfinite(losses)) and len(losses) == iters, "every loss logged and finite")

    tcfg = train_config(cfg)
    model = NerfMLP(Lp=tcfg.net_Lp, Ld=tcfg.net_Ld, H=tcfg.net_H)
    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    rays, pixels = rd.rays["train"], rd.pixels["train"]
    n_pix = rd.H * rd.W
    st = make_train_state(tcfg, model, dev, n_images=rays.shape[0] // n_pix)
    step_fn = build_train_step(tcfg, model, rays_per_image=n_pix)

    def step():  # mid-anneal: the windows and the input gradient on every call
        st.step = 50
        return step_fn(st, rays, pixels)

    torch.cuda.reset_peak_memory_stats()
    walls = step_walls(step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    others = {}
    prof = profile_step(step, others, split_pose=True)
    busy = sum(prof.values())
    idle = 1 - busy / walls["ms"] if prof else None
    print(f"train step pose bf16 (mid-anneal): {walls['ms']:.3f} ms a step, {BATCH / walls['ms'] * 1e3:,.0f} rays/s "
          f"(CUDA events over 20 steps, median of 5; runs {', '.join(f'{w:.3f}' for w in walls['walls'])}); host "
          f"issues a step in {walls['host_ms']:.3f} ms; peak device memory {peak_gb:.2f} GB", flush=True)
    print("train step pose bf16 profile, device ms a step: " + (", ".join(
        f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1]))
        + f"; kernels {busy:.3f} of {walls['ms']:.3f} ms, idle share {idle:.3f}" if prof else
        "not measured (the profiler saw no device activity)"), flush=True)
    print("train step pose bf16 profile, the autograd group by kernel, ms a step: " + "; ".join(
        f"{n} {v:.3f}" for n, v in sorted(others.items(), key=lambda kv: -kv[1])[:8]), flush=True)
    del st, rd, state
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=walls["ms"], host_ms=walls["host_ms"], walls=walls["walls"], profile=prof,
                idle=idle, peak_gb=peak_gb, train_s=train_s)


def phase_pose_recipe(dev, work, mlp) -> dict:
    """13c. The JAX package's pose recipe (scripts/pose_freeze_bench.py) on
    the port's blob scene: 12 train (elevation-jittered, seed 3), 2 val, 2
    test images at 100x100, the train poses perturbed by POSE_DR rad /
    POSE_DT; lego.yaml's keys, POSE_ITERS steps (bf16, pallas) without
    refinement, and with pose_opt (warmup 1/20 of the run), the anneal
    and the freeze at 3/8. Test PSNR of both on the clean test poses (bf16
    pallas renders, N = 128), the rig's mean residual rotation and
    translation before and after; the refined rotation must be at most
    POSE_ROT_KEPT of the perturbation's and the mean test PSNR not below
    the unrefined run's. The translation is reported, not held: for a
    small object at the rig's centre a camera's sideways shift and a turn
    about its centre move the image alike, and the deltas take it up as
    rotation (the dt path's gradient is held to xla below). Then an
    f32 pose step's loss and gradients (the field's, dr, dt) from one
    state, through the kernels (the forward and B2 with the input
    gradient and the windows) against the xla autograd step."""
    import shutil

    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.data.synthetic import write_blender_scene
    from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked
    from nerf_simple_tpu_torch.train.loop import train
    from nerf_simple_tpu_torch.train.metrics import img_psnr
    from nerf_simple_tpu_torch.train.step import CamDeltas, autograd_loss, render_settings

    clean, pert = os.path.join(work, "pose_clean"), os.path.join(work, "pose_pert")
    write_blender_scene(clean, n_train=12, n_val=2, n_test=2, H=100, W=100, device=dev, train_jitter=3)
    shutil.copytree(clean, pert)
    perturb_train_poses(pert)
    before = rig_error(clean, pert)
    check(abs(before["rot"] - POSE_DR) < 1e-4 and abs(before["trans"] - POSE_DT) < 1e-4,  # f32 poses in the json
          "the rig is perturbed as asked")
    base = load_yaml("configs/lego.yaml")
    base.update(datapath=pert, half_res=False, backend="pallas", compute_dtype="bf16", num_iters=POSE_ITERS,
                steps_per_call=40, ckpt_loss=POSE_ITERS, ckpt_images=POSE_ITERS, ckpt_model=POSE_ITERS,
                num_train_imgs=12)
    q = 3 * POSE_ITERS // 8
    runs = {"unrefined": {}, "refined": dict(pose_opt=True, pose_warmup=POSE_ITERS // 20, pe_anneal_until=q,
                                             pose_freeze_at=q, ckpt_model=q)}
    data = load_blender(clean, False)
    test_rays = RayDataset.from_blender(data, dev).rays["test"]
    gts = data.splits["test"].images
    s = RenderSettings(N=N_SAMPLES, compute_dtype=torch.bfloat16, backend="pallas")
    out = {"rig_before": before}
    for name, kw in runs.items():
        cfg = {**base, **kw, "exp_name": name, "savepath": os.path.join(work, "models_recipe"),
               "log_dir": os.path.join(work, f"logs_{name}")}
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            state = train(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rgb, _ = render_rays_chunked(state.field, test_rays, 1, s, chunk=10240)
        rgb = rgb.reshape(-1, 100, 100, 3).cpu().numpy()
        psnr = [float(img_psnr(gts[j : j + 1], rgb[j : j + 1])) for j in range(len(gts))]
        res = dict(test_psnr=psnr, wall_s=wall, exp=os.path.join(work, "models_recipe", name))
        if kw:
            sidecar = os.path.join(res["exp"], "cam_deltas.npz")
            with np.load(sidecar) as d:
                res["rig_after"] = rig_error(clean, pert, d["dr"], d["dt"])
                res["freeze_step"] = int(d["freeze_step"])
            shutil.copy(sidecar, os.path.join(OUT, "pose_recipe_cam_deltas.npz"))
            for scene, label in ((clean, "clean"), (pert, "perturbed")):
                shutil.copy(os.path.join(scene, "transforms_train.json"),
                            os.path.join(OUT, f"pose_recipe_transforms_train_{label}.json"))
        out[name] = res
        ra = res.get("rig_after")
        print(f"pose recipe {name}: {POSE_ITERS} steps in {wall:.1f} s; test PSNR "
              f"{', '.join(f'{p:.2f}' for p in psnr)} dB" + (
                  f"; the rig's mean error before {before['rot']:.4f} rad / {before['trans']:.4f}, after "
                  f"{ra['rot']:.4f} rad / {ra['trans']:.4f}; the rig aligned as a whole: before "
                  f"{before['rot_aligned']:.4f} rad / {before['trans_aligned']:.4f}, after {ra['rot_aligned']:.4f} "
                  f"rad / {ra['trans_aligned']:.4f} (the freeze at step {res['freeze_step']})" if kw else ""),
              flush=True)
        del state
        torch.cuda.empty_cache()
    after = out["refined"]["rig_after"]
    out["rot_kept"] = after["rot"] / before["rot"]
    print(f"pose recipe: the refined rig keeps {out['rot_kept']:.3f} of the perturbation's rotation (at most "
          f"{POSE_ROT_KEPT}) and {after['trans'] / before['trans']:.3f} of its translation (not held); test PSNR "
          f"refined - unrefined by image: " + ", ".join(
              f"{a - b:+.2f}" for a, b in zip(out["refined"]["test_psnr"], out["unrefined"]["test_psnr"])) + " dB",
          flush=True)
    check(out["rot_kept"] <= POSE_ROT_KEPT, "the refined rig recovers the perturbation's rotation")
    check(np.mean(out["refined"]["test_psnr"]) >= np.mean(out["unrefined"]["test_psnr"]),
          "the refined run's test PSNR is not below the unrefined run's")

    # f32: one pose step's loss and gradients from one state, kernels against xla
    tcfg = train_config({**base, **runs["refined"], "compute_dtype": "f32"})
    model = NerfMLP(Lp=tcfg.net_Lp, Ld=tcfg.net_Ld, H=tcfg.net_H)
    rd = RayDataset.from_blender(load_blender(pert, False, 12), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    idx = torch.randint(0, rd.rays["train"].shape[0], (BATCH,), generator=g, device=dev)
    from nerf_simple_tpu_torch.ops.sampling import stratified_ts

    ts = stratified_ts(g, BATCH, N_SAMPLES, 2.0, 6.0, dev)
    dr, dt = (np.random.default_rng(SEED + k).normal(0, 0.01, (12, 3)).astype(np.float32) for k in (1, 2))
    got = {}
    mlp.fused_mlp_backward.dx_launches = mlp.fused_mlp_backward.anneal_launches = 0
    mlp.input_grad_f32_launches(reset=True)
    for backend in ("pallas", "xla"):
        field = NerfField.from_jax_params(init_nerf_params(SEED, model), dev, model)
        cams = CamDeltas(12, dev).copy_tables_({"dr": dr, "dt": dt})
        c = dataclasses.replace(tcfg, backend=backend)
        loss = autograd_loss(c, field, rd.rays["train"][idx], rd.pixels["train"][idx], ts, None, render_settings(c),
                             cams=cams, im_b=idx // 10000, enc_alpha=0.5)
        loss.backward()
        got[backend] = (loss.item(), {n: p.grad.clone() for n, p in field.named_parameters()},
                        {k: getattr(cams, k).grad.clone() for k in ("dr", "dt")})
        del field, cams
    f32_dx = mlp.input_grad_f32_launches()
    (lp, fp, cp), (lx, fx, cx) = got["pallas"], got["xla"]
    loss_rel = abs(lp / lx - 1)
    field_rel = max(((fp[n] - fx[n]).abs().max() / fx[n].abs().max()).item() for n in fx)
    cams_rel = {k: ((cp[k] - cx[k]).abs().max() / cx[k].abs().max()).item() for k in cx}
    print(f"f32 pose step from one state, the kernels (forward + B2 with the input gradient and windows at alpha 0.5) "
          f"against xla: loss rel {loss_rel:.2e} (tol {LOSS_TOL[torch.float32]:.0e}); field grads {field_rel:.2e} of max, "
          f"dr {cams_rel['dr']:.2e}, dt {cams_rel['dt']:.2e} (tol {POSE_GRAD_RTOL:.0e}); B2 launches with dx "
          f"{mlp.fused_mlp_backward.dx_launches}, with windows {mlp.fused_mlp_backward.anneal_launches}; f32 "
          f"input-gradient launches (input_grad_fma, counted in C) {f32_dx}", flush=True)
    check(loss_rel <= LOSS_TOL[torch.float32] and field_rel <= POSE_GRAD_RTOL and max(cams_rel.values()) <= POSE_GRAD_RTOL,
          "the f32 kernel pose step matches the xla step")
    check(mlp.fused_mlp_backward.dx_launches == mlp.fused_mlp_backward.anneal_launches == 1,
          "the kernel pose step ran B2 with the input gradient and the windows")
    check(f32_dx == 1, "the f32 pose step launched the f32 input-gradient kernel once")
    out.update(loss_rel_f32=loss_rel, field_rel_f32=field_rel, cams_rel_f32=cams_rel, clean=clean, pert=pert,
               input_grad_f32_launches=f32_dx)
    return out


def phase_pose_eval(dev, work, recipe) -> dict:
    """13d. evaluate.test of the refined recipe run's train stills 0 and 1
    (bf16, pallas, N_samples 128): from the checkpoint at the freeze (its
    live camera deltas) and from the final one (plain, with the
    cam_deltas.npz sidecar), each beside the same field's render of the
    unrefined (perturbed) train poses."""
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.evaluate import load_params, test
    from nerf_simple_tpu_torch.models.nerf import NerfField
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, derive_seed, render_image
    from nerf_simple_tpu_torch.train.metrics import img_psnr

    exp, pert = recipe["refined"]["exp"], recipe["pert"]
    data = load_blender(pert, False)
    rd = RayDataset.from_blender(data, dev)
    s = RenderSettings(N=N_SAMPLES, compute_dtype=torch.bfloat16, backend="pallas")
    out = {}
    for label, loadpath in (("checkpoint", os.path.join(exp, f"ckpt_{recipe['refined']['freeze_step']}.pth")),
                            ("sidecar", exp)):
        params, aux = load_params(loadpath, return_aux=True)
        check(("cams" in aux) == (label == "checkpoint"), f"the {label} eval's deltas")
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            test(dict(loadpath=loadpath, datapath=pert, savepath=os.path.join(work, f"eval_pose_{label}"),
                      half_res=False, im_set="train", im_idxs=[0, 1], N_samples=N_SAMPLES, compute_dtype="bf16",
                      backend="pallas", batch_size=16384))
        refined = [float(m) for m in re.findall(r"im \d+: mse=\S+ psnr=(\S+)", log.getvalue())]
        field = NerfField.from_jax_params(params, dev)
        unrefined = [float(img_psnr(data.splits["train"].images[i : i + 1],
                                    render_image(field, rd.rays["train"], 100, 100, i, derive_seed(0, i), s)[0]))
                     for i in (0, 1)]
        out[label] = dict(refined=refined, unrefined=unrefined)
        print(f"pose eval ({label}): train stills 0, 1 from the refined poses PSNR "
              f"{', '.join(f'{p:.2f}' for p in refined)} dB; the same field at the perturbed poses "
              f"{', '.join(f'{p:.2f}' for p in unrefined)} dB", flush=True)
        check(len(refined) == 2 and all(np.isfinite(refined)), f"the {label} eval rendered refined stills")
    return out


# Appearance codes (configs/lego.yaml + appearance_dim): the code width
# (the kernels' eight rows, full), the steps of the runs through train()
# (flagship, and each with pose refinement, the hierarchical pair and the
# proposal scheme), and the exposure-twin recipe's (the JAX package's
# 1200, tests/test_pose_app.py:513-573, cut to 800 to pay for phase 20; at
# 1200 the loss ratio was 0.006 and the brightness ratio 1.846) with its
# bounds: the loss with codes below APP_LOSS_RATIO of the loss without,
# the twins' brightness ratio in APP_BRIGHTNESS (1 / 0.55 injected).
APP_DIM, APP_ITERS, APP_SIDE_ITERS, APP_TWIN_ITERS = 8, 100, 60, 800
APP_LOSS_RATIO, APP_BRIGHTNESS = 0.35, (1.4, 2.3)


def app_batch(dev, scene, x16=None):
    """Phase 5's training batch (524,288 rows) as an appearance model's
    kernel input: xyz and unit dirs in rows 0..5, each ray's code (APP_DIM
    values from N(0, 0.5), numpy seed SEED) on its samples in rows 8..15."""
    x16 = train_batch(dev, scene) if x16 is None else x16
    x = torch.zeros_like(x16)
    x[:6] = x16[:6]
    codes = np.random.default_rng(SEED).normal(0, 0.5, (APP_DIM, BATCH)).astype(np.float32)
    x[8 : 8 + APP_DIM] = torch.from_numpy(np.repeat(codes, N_SAMPLES, axis=1)).to(dev)
    return x


def app_fields(dev, seed: int = SEED):
    """(the flagship appearance model, its field from numpy seed ``seed``,
    the model without codes, its field of the same weights but color0's
    code columns)."""
    from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params

    model, plain = NerfMLP(app_dim=APP_DIM), NerfMLP()
    params = init_nerf_params(seed, model)
    cut = {**params, "color0": {"w": params["color0"]["w"][: plain.H + plain.in_Cd], "b": params["color0"]["b"]}}
    return (model, NerfField.from_jax_params(params, dev, model), plain,
            NerfField.from_jax_params(cut, dev, plain))


def phase_app_kernels(dev, scene, mlp, earlier) -> dict:
    """14a. The appearance variants against their plain versions at the
    training batch (``app_batch``: 524,288 rows, codes in rows 8..15), the
    flagship appearance model from numpy seed SEED, f32 and bf16: the
    forward with the code rows beside the forward of the same rows through
    the model without codes (color0's code columns cut), in turns, and with
    zero codes bit-equal to it; B2 with ``want_dx`` (the recompute with the
    codes, dWca in Wcd's last eight columns, the codes' rows of dx) held as
    13a holds the pose dx (``explain_dx``: every row past DX_TOL from plain
    explained by a flipped relu mask, the code rows against their own
    largest entry, three planted faults caught), its weight gradients
    bit-equal to the launch without ``want_dx``, beside B2 with
    ``want_dx`` through the model without codes, in turns; the
    input-gradient kernel alone with the code rows (probes/input_grad.py).
    With ``earlier``, B2 with ``want_dx`` and no codes bit-equal (grads
    and dx) to the earlier library's."""
    from nerf_simple_tpu_torch.probes import input_grad as ig_probe
    from nerf_simple_tpu_torch.probes.wgrad import turns_ms

    model, field, plain, plain_field = app_fields(dev)
    x16 = train_batch(dev, scene)
    x = app_batch(dev, scene, x16)
    del x16
    x8 = x[:8].contiguous()
    x0 = x.clone()
    x0[8:] = 0
    gT = torch.from_numpy(np.random.default_rng(SEED).normal(size=(8, x.shape[1])).astype(np.float32)).to(dev)
    fwd, b2 = mlp.fused_mlp_forward, mlp.fused_mlp_backward
    stats = {}
    FD0 = mlp._enc_rows(model.Ld)
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            w = mlp._cast_weights(mlp.pack_weights(field), dt)
            wp = mlp._cast_weights(mlp.pack_weights(plain_field), dt)
            before = fwd.app_launches
            got = fwd(w, x, dt, model)
            torch.cuda.synchronize()
            check(fwd.app_launches == before + 1, "the forward with codes is counted")
            want = mlp.fused_mlp_forward_plain(w, x, dt, model)
            err = (got[:4] - want[:4]).abs().max().item()
            zero_equal = torch.equal(fwd(w, x0, dt, model), fwd(wp, x8, dt, plain))
            del got, want
            ms = turns_ms({"codes": lambda: fwd(w, x, dt, model), "none": lambda: fwd(wp, x8, dt, plain)})
            st = dict(err=err, ms=ms["codes"], ms_no_codes=ms["none"], rows=x.shape[1], zero_codes_bit_equal=zero_equal,
                      plain_ms=cuda_ms(lambda: mlp.fused_mlp_forward_plain(w, x, dt, model), reps=3))
            print(f"appearance forward vs plain {name} at {x.shape[1]} rows: max abs err {err:.3e} (tol "
                  f"{TOL[dt]:.0e}); in turns: codes {st['ms']:.3f} ms, the model without codes {st['ms_no_codes']:.3f} "
                  f"ms; plain {st['plain_ms']:.3f} ms; zero codes bit-equal to the model without codes: {zero_equal}",
                  flush=True)
            check(err <= TOL[dt] and zero_equal, f"the appearance forward {name} matches plain")
            stats[f"fwd_{name}"] = st
            torch.cuda.empty_cache()

            before = (b2.app_launches, b2.dx_launches, mlp.input_grad_launches())
            grads, dx = b2(w, x, gT, dt, model, want_dx=True)
            torch.cuda.synchronize()
            check((b2.app_launches, b2.dx_launches, mlp.input_grad_launches()) == tuple(b + 1 for b in before),
                  "B2 with codes and want_dx counted, its input-gradient kernel counted in C")
            alone = b2(w, x, gT, dt, model)
            bit_equal = all(torch.equal(a, c) for a, c in zip(grads, alone))
            del alone
            _, res = mlp.forward_residuals(w, x, dt, model)
            posd = mlp.Layout.of(model).posd
            code_plane = torch.equal(res[posd + FD0 : posd + FD0 + 8, : x.shape[1]].float(), x[8:16].to(dt).float())
            composed = torch.equal(dx, mlp.input_grad(w, x, mlp.backward_tile(w, res, gT, dt, model), dt, model))
            del res
            want, dx_p = mlp.fused_mlp_backward_plain(w, x, gT, dt, model, want_dx=True)
            rel, abs_err = grad_errors(grads, want)
            wca_rel = ((grads.Wcd[:, FD0:] - want.Wcd[:, FD0:]).abs().max() / want.Wcd[:, FD0:].abs().max()).item()
            code_rel = ((dx[8:] - dx_p[8:]).abs().max() / dx_p[8:].abs().max()).item()
            ex = ig_probe.explain_dx(w, x, gT, dx, dx_p, dt, model, None, DX_TOL[dt])
            pad_zero = bool((dx[6:8] == 0).all())
            del grads, dx, want, dx_p
            torch.cuda.empty_cache()
            st = dict(err=abs_err, rel=rel, wca_rel=wca_rel, code_rel=code_rel, dx_rows=ex, rows=x.shape[1],
                      bit_equal_no_dx=bit_equal, dx_equal_composed=composed, code_plane_equal=code_plane)
            if earlier:
                g_now, dx_now = b2(wp, x8, gT, dt, plain, want_dx=True)
                g_old, dx_old = earlier_backward(mlp, earlier["fused_mlp_bwd"], wp, x8, gT, dt, plain, want_dx=True)
                st["as_earlier"] = all(torch.equal(a, c) for a, c in zip(g_now, g_old)) and dx_as_earlier(
                    dx_now, dx_old, dt)
                del g_now, dx_now, g_old, dx_old
            ms = turns_ms({"codes": lambda: b2(w, x, gT, dt, model, want_dx=True),
                           "none": lambda: b2(wp, x8, gT, dt, plain, want_dx=True)})
            st.update(ms=ms["codes"], ms_no_codes=ms["none"],
                      plain_ms=cuda_ms(lambda: mlp.fused_mlp_backward_plain(w, x, gT, dt, model, want_dx=True), reps=3))
            torch.cuda.empty_cache()
            print(f"appearance B2 (want_dx) vs plain {name} at {x.shape[1]} rows: grad err {rel:.3e} of max (tol "
                  f"{GRAD_TOL['B2', dt]:.0e}), dWca {wca_rel:.3e} of its max; dx's code rows {code_rel:.3e} of their max "
                  "(a row with a flipped relu mask moves by a whole term: held row by row below); "
                  f"dx rows past {DX_TOL[dt]:.0e} {ex['n_past']} ({ex['share']:.2e}, tol {DX_ROW_SHARE[dt]:.0e}), with a "
                  f"flipped relu mask {ex['n_flipped']}, past without one {ex['n_unexplained']}, on the kernel's own "
                  f"masks {ex['own_masks_err']:.2e}; planted faults: " + ", ".join(
                      f"{k} {f['share']:.2e} past ({f['n_unexplained']} unexplained)" for k, f in ex["faults"].items())
                  + f"; dx bit-equal to the input-gradient kernel on the kernels' planes: {composed}; the code plane "
                  f"holds the codes: {code_plane}; grads bit-equal to the launch without dx: {bit_equal}; in turns: "
                  f"codes {st['ms']:.3f} ms, the model without codes {st['ms_no_codes']:.3f} ms; plain "
                  f"{st['plain_ms']:.3f} ms" + (f"; without codes (with dx) as the earlier library's (grads "
                                               f"bit-equal, dx bit-equal in f32, in bf16 within "
                                               f"{ig_probe.MIP_CONTRACT_TOL:.0e}): {st['as_earlier']}"
                                               if earlier else ""), flush=True)
            check(rel <= GRAD_TOL["B2", dt] and wca_rel <= GRAD_TOL["B2", dt] and composed
                  and code_plane and pad_zero and ex["n_unexplained"] == 0 and ex["own_masks_err"] <= DX_TOL[dt]
                  and ex["share"] <= DX_ROW_SHARE[dt], f"appearance B2 {name} within tolerance")
            check(len(ex["faults"]) == 3 and all(f["n_unexplained"] > 0 for f in ex["faults"].values()),
                  f"the dx rule catches the three planted faults ({name})")
            check(bit_equal and st.get("as_earlier", True), f"B2 {name} unchanged without codes")
            stats[f"b2_{name}"] = st
    del x, x8, x0, gT
    torch.cuda.empty_cache()
    ig = ig_probe.run(dev, model)
    for name in ("f32", "bf16"):
        v = ig[name]
        print(f"input-gradient kernel alone with codes {name} at {ig['rows']} rows: {v['ms']:.3f} ms (windows "
              f"{v['ms_anneal']:.3f}), plain {v['plain_ms']:.3f} ms, torch.mm yardstick {v['library_ms']:.3f} ms; bound "
              f"{v['bound_ms']:.3f} ms ({v['bound_by']}), {100 * v['share_of_bound']:.1f}% of it; dx err "
              f"{v['rel_err']:.2e} of max |dx|, code rows {v['code_rel_err']:.2e} of theirs", flush=True)
    stats["input_grad"] = ig
    return stats


def app_run(cfg: dict, what: str, mlp) -> tuple:
    """train() of ``cfg`` with the launch counts reset before it: (the
    state, the launches, the losses, the wall, the log's text)."""
    from nerf_simple_tpu_torch.train.loop import train

    fwd, b2, b1 = mlp.fused_mlp_forward, mlp.fused_mlp_backward, mlp.fused_train_step
    fwd.launches = fwd.app_launches = b2.launches = b2.app_launches = b2.dx_launches = b1.launches = 0
    mlp.input_grad_launches(reset=True)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(forward=fwd.launches, forward_app=fwd.app_launches, b2=b2.launches, b2_app=b2.app_launches,
                    b2_dx=b2.dx_launches, input_grad=mlp.input_grad_launches(), fused_train_step=b1.launches)
    text = log.getvalue()
    with open(os.path.join(OUT, f"train_app_{what}_log.txt"), "w") as fh:
        fh.write(text)
    losses = scalars(cfg["log_dir"], "Loss/train")
    return state, launches, losses, wall, text


def app_eval(exp: str, scene: str, work: str, label: str, **kw) -> dict:
    """evaluate.test of an appearance run's still 0 (bf16, pallas) with
    ``kw`` (``appearance_idx``, ``normals``, the sampler's keys): PSNR, the
    wall, the still's PNG bytes."""
    from nerf_simple_tpu_torch.evaluate import test

    out_dir = os.path.join(work, f"eval_app_{label}")
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        test({**dict(loadpath=exp, datapath=scene, savepath=out_dir, im_idxs=[0], N_samples=N_SAMPLES,
                     compute_dtype="bf16", backend="pallas", batch_size=16384), **kw})
    wall = time.perf_counter() - t0
    text = log.getvalue()
    with open(os.path.join(OUT, f"eval_app_{label}_log.txt"), "w") as fh:
        fh.write(text)
    if kw.get("animation"):
        return dict(wall_s=wall, video=bool(glob.glob(os.path.join(out_dir, "exp", "nerf_rgb*"))))
    psnr = [float(m) for m in re.findall(r"im \d+: mse=\S+ psnr=(\S+)", text)]
    with open(os.path.join(out_dir, "exp", "rgb_0.png"), "rb") as fh:
        png = fh.read()
    normals = os.path.exists(os.path.join(out_dir, "exp", "normal_0.png"))
    check(len(psnr) == 1 and np.isfinite(psnr[0]) and (normals or not kw.get("normals")),
          f"the appearance eval ({label}) rendered its still")
    return dict(psnr=psnr[0], wall_s=wall, png=png, normals=normals)


def phase_app_train(dev, scene, work, mlp) -> dict:
    """14b. Appearance codes through train() (bf16, pallas) on the phase-7
    scene: lego.yaml's keys + ``appearance_dim: 8``, APP_ITERS steps: one
    forward and one B2 launch with the code rows and the input gradient a
    step, no B1; the loss falls; the checkpoint and params npz carry the
    code table (no reference .pth); ``evaluate.test`` of still 0 under the
    mean code (with normals), under image 0's code, and a 2-frame orbit.
    Then the appearance step itself (from a fresh state): its wall and
    host issue, kernel ms by pass (torch.profiler, kernels in time order:
    forward, B2, input grad, Adam, the rest: the code gather, the input
    build, the pack, compositing and their autograd), idle share, peak
    memory. Then APP_SIDE_ITERS steps each of the same keys with
    ``pose_opt`` (the deltas and the codes through one input gradient a
    step; its step's wall), of lego_hierarchical.yaml's keys + the codes
    (both nets take them: two B2 launches a step) and of lego_proposal.yaml's
    (the main field takes them), each evaluated on one still under a code."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.models.nerf import NerfMLP
    from nerf_simple_tpu_torch.train import checkpoint as ckpt
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    def keys(path, what, iters, **kw):
        cfg = load_yaml(path)
        cfg.update(datapath=scene, savepath=os.path.join(work, "models_app"), exp_name=what,
                   log_dir=os.path.join(work, f"logs_app_{what}"), backend="pallas", compute_dtype="bf16",
                   num_iters=iters, ckpt_loss=1, ckpt_images=iters, ckpt_model=iters, steps_per_call=20,
                   appearance_dim=APP_DIM, **kw)
        return cfg

    out = {}
    cfg = keys("configs/lego.yaml", "lego", APP_ITERS)
    check(cfg["Nf"] == N_SAMPLES and cfg["batch_size"] == BATCH, "lego's keys")
    state, launches, losses, wall, _ = app_run(cfg, "lego", mlp)
    exp = os.path.join(work, "models_app", "lego")
    table = state.app.tables()
    held = ckpt.checkpoint_params(os.path.join(exp, f"ckpt_{APP_ITERS}.pth"))
    npz = ckpt.import_params_npz(os.path.join(exp, f"params_{APP_ITERS}.npz"))
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"train appearance (lego.yaml + appearance_dim {APP_DIM}): {APP_ITERS} steps in {wall:.1f} s with renders; "
          f"launches {launches}; loss {first:.5f} -> {last:.5f} (means of the first and last 10); the code table "
          f"{table.shape}, |code| max {np.abs(table).max():.4f}", flush=True)
    check(launches["b2_app"] == launches["b2_dx"] == launches["input_grad"] == launches["b2"] == APP_ITERS,
          "one B2 launch with the code rows and the input gradient a step")
    check(launches["forward_app"] == launches["forward"] >= APP_ITERS and launches["fused_train_step"] == 0,
          "every forward with the code rows, no B1")
    check(all(np.isfinite(losses)) and len(losses) == APP_ITERS and last < first, "the appearance loss falls")
    check(table.shape == (25, APP_DIM) and np.abs(table).max() > 0, "the codes train")
    check(set(held) == {"field", "app"} and np.array_equal(npz["app"], table)
          and not os.path.exists(os.path.join(exp, f"params_{APP_ITERS}.pth")),
          "the checkpoint and the npz carry the code table, no reference .pth")
    ev = {"mean": app_eval(exp, scene, work, "mean", appearance_idx=-1, normals=True),
          "image_0": app_eval(exp, scene, work, "image_0", appearance_idx=0),
          "orbit": app_eval(exp, scene, work, "orbit", appearance_idx=0, animation=True, num_poses=2)}
    check(ev["mean"]["png"] != ev["image_0"]["png"] and ev["orbit"]["video"], "the codes condition the eval")
    print(f"eval appearance: still 0 under the mean code {ev['mean']['psnr']:.2f} dB ({ev['mean']['wall_s']:.1f} s with "
          f"normals), under image 0's {ev['image_0']['psnr']:.2f} dB ({ev['image_0']['wall_s']:.1f} s); a 2-frame orbit "
          f"in {ev['orbit']['wall_s']:.1f} s", flush=True)
    out.update(launches=launches, loss_first=first, loss_last=last, train_s=wall,
               eval={k: {m: v for m, v in e.items() if m != "png"} for k, e in ev.items()})
    del state
    torch.cuda.empty_cache()

    tcfg = train_config(cfg)
    model = NerfMLP(Lp=tcfg.net_Lp, Ld=tcfg.net_Ld, H=tcfg.net_H, app_dim=APP_DIM)
    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    rays, pixels = rd.rays["train"], rd.pixels["train"]
    n_pix = rd.H * rd.W

    def step_of(c):
        st = make_train_state(c, model, dev, n_images=rays.shape[0] // n_pix)
        fn = build_train_step(c, model, rays_per_image=n_pix)
        return lambda: fn(st, rays, pixels)

    step = step_of(tcfg)
    torch.cuda.reset_peak_memory_stats()
    walls = step_walls(step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    others = {}
    prof = profile_step(step, others, split_pose=True, rest="gather and compositing")
    busy = sum(prof.values())
    idle = 1 - busy / walls["ms"] if prof else None
    print(f"train step appearance bf16: {walls['ms']:.3f} ms a step, {BATCH / walls['ms'] * 1e3:,.0f} rays/s (CUDA "
          f"events over 20 steps, median of 5; runs {', '.join(f'{w:.3f}' for w in walls['walls'])}); host issues a "
          f"step in {walls['host_ms']:.3f} ms; peak device memory {peak_gb:.2f} GB", flush=True)
    print("train step appearance bf16 profile, device ms a step: " + (", ".join(
        f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1]))
        + f"; kernels {busy:.3f} of {walls['ms']:.3f} ms, idle share {idle:.3f}" if prof else
        "not measured (the profiler saw no device activity)"), flush=True)
    print("train step appearance bf16 profile, the gather and compositing group by kernel, ms a step: " + "; ".join(
        f"{n} {v:.3f}" for n, v in sorted(others.items(), key=lambda kv: -kv[1])[:8]), flush=True)
    pose_step = step_of(dataclasses.replace(tcfg, pose_opt=True, pose_warmup=0))
    pose_walls = step_walls(pose_step)
    print(f"train step pose + appearance bf16: {pose_walls['ms']:.3f} ms a step (host {pose_walls['host_ms']:.3f} ms)",
          flush=True)
    out.update(step_ms=walls["ms"], host_ms=walls["host_ms"], walls=walls["walls"], profile=prof, idle=idle,
               peak_gb=peak_gb, pose_step_ms=pose_walls["ms"], pose_host_ms=pose_walls["host_ms"])
    del step, pose_step, rd, rays, pixels
    torch.cuda.empty_cache()

    side = {"pose": ("configs/lego.yaml", dict(pose_opt=True, pose_warmup=10), dict(im_set="train"), 1),
            "hierarchical": ("configs/lego_hierarchical.yaml", {}, dict(Nc=NC, N_samples=NF), 2),
            "proposal": ("configs/lego_proposal.yaml", {}, dict(Np=NP_PROP), 1)}
    for what, (path, kw, ev_kw, b2_a_step) in side.items():
        c = keys(path, what, APP_SIDE_ITERS, **kw)
        state, launches, losses, wall, _ = app_run(c, what, mlp)
        e = app_eval(os.path.join(work, "models_app", what), scene, work, what, appearance_idx=0, **ev_kw)
        moved = float(np.abs(state.app.tables()).max())
        print(f"train appearance + {what}: {APP_SIDE_ITERS} steps in {wall:.1f} s; launches {launches}; loss "
              f"{np.mean(losses[:10]):.5f} -> {np.mean(losses[-10:]):.5f}; |code| max {moved:.4f}"
              + (f", |dr| max {float(state.cams.dr.detach().abs().max()):.4f}" if what == "pose" else "")
              + f"; eval still 0 under image 0's code {e['psnr']:.2f} dB", flush=True)
        check(launches["b2_app"] == launches["b2_dx"] == launches["input_grad"] == b2_a_step * APP_SIDE_ITERS
              and launches["fused_train_step"] == 0, f"appearance + {what}: B2 with the code rows, no B1")
        check(all(np.isfinite(losses)) and moved > 0 and (what != "pose" or float(state.cams.dr.detach().abs().max()) > 0),
              f"appearance + {what} trains the codes")
        out[what] = dict(launches=launches, loss_first=float(np.mean(losses[:10])),
                         loss_last=float(np.mean(losses[-10:])), train_s=wall, eval_psnr=e["psnr"])
        del state
        torch.cuda.empty_cache()
    return out


def phase_app_twins(dev, work, mlp) -> dict:
    """14c. The JAX package's exposure-twin recipe at the flagship width:
    its scene (3 train views at 32x32 and a twin of each at 0.55 of its
    brightness, the same pose; data/synthetic.py::add_exposure_twins),
    lego.yaml's keys (bf16, pallas, 4096 rays x 128 samples a step) with
    ``appearance_dim: 8`` and without, APP_TWIN_ITERS steps each from the
    same seed: the loss (the mean of the last 10 steps) with codes below
    APP_LOSS_RATIO of the loss without; the first twin pair's rays rendered
    under the bright twin's code and under the dim twin's, their mean
    brightness ratio in APP_BRIGHTNESS (1 / 0.55 = 1.82 injected)."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.data.synthetic import add_exposure_twins, write_blender_scene
    from nerf_simple_tpu_torch.models.nerf import NerfMLP
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    scene = os.path.join(work, "app_twins")
    write_blender_scene(scene, n_train=3, n_val=1, n_test=1, H=32, W=32, device=dev, train_jitter=3)
    check(add_exposure_twins(scene) == 6, "the twin scene has six train views")
    data = load_blender(scene, False)
    rd = RayDataset.from_blender(data, dev)
    n_pix = data.H * data.W
    base = load_yaml("configs/lego.yaml")
    base.update(datapath=scene, half_res=False, backend="pallas", compute_dtype="bf16", num_iters=APP_TWIN_ITERS)
    out = {}
    for A in (APP_DIM, 0):
        cfg = train_config({**base, "appearance_dim": A})
        model = NerfMLP(Lp=cfg.net_Lp, Ld=cfg.net_Ld, H=cfg.net_H, app_dim=A)
        st = make_train_state(cfg, model, dev, n_images=6 if A else None)
        step = build_train_step(cfg, model, rays_per_image=n_pix)
        t0 = time.perf_counter()
        losses = torch.stack([step(st, rd.rays["train"], rd.pixels["train"]) for _ in range(APP_TWIN_ITERS)])
        loss = float(losses[-10:].mean())
        out[A] = dict(loss=loss, wall_s=time.perf_counter() - t0, state=st)
    st = out[APP_DIM].pop("state")
    out[0].pop("state")
    table = st.app.table.detach()
    s = RenderSettings(N=N_SAMPLES, compute_dtype=torch.bfloat16, backend="pallas")
    bright = [float(render_rays_chunked(st.field, rd.rays["train"][:n_pix], 5, s, chunk=1024, app=table[i])[0].mean())
              for i in (0, 3)]
    ratio = bright[0] / max(bright[1], 1e-9)
    loss_ratio = out[APP_DIM]["loss"] / out[0]["loss"]
    print(f"appearance exposure twins (flagship, bf16, {APP_TWIN_ITERS} steps): loss with codes "
          f"{out[APP_DIM]['loss']:.5f}, without {out[0]['loss']:.5f}, ratio {loss_ratio:.3f} (below {APP_LOSS_RATIO}); "
          f"image 0 rendered under its own code and its twin's: brightness {bright[0]:.4f} / {bright[1]:.4f} = "
          f"{ratio:.3f} (in {APP_BRIGHTNESS}; 1 / 0.55 = 1.818 injected); {out[APP_DIM]['wall_s']:.1f} s / "
          f"{out[0]['wall_s']:.1f} s", flush=True)
    check(loss_ratio < APP_LOSS_RATIO, "the codes absorb the twins' exposure gap")
    check(APP_BRIGHTNESS[0] < ratio < APP_BRIGHTNESS[1], "the twins' codes reproduce the injected exposure")
    del st, rd
    torch.cuda.empty_cache()
    return dict(loss_app=out[APP_DIM]["loss"], loss_plain=out[0]["loss"], loss_ratio=loss_ratio, brightness=bright,
                ratio=ratio, wall_s=[out[APP_DIM]["wall_s"], out[0]["wall_s"]])


# Pose refinement with mip and with proposal (phase 15): the mip run's
# steps and freeze (configs/lego_mip.yaml's keys + pose_opt, cut from
# 10,000 steps), the proposal run's steps and anneal (lego_proposal.yaml's
# keys + pose_opt; one mid-anneal preview at step 30).
PM_ITERS, PM_WARMUP, PM_FREEZE = 150, 10, 100
PP_ITERS, PP_ANNEAL, PP_PREVIEW = 60, 40, 30


def phase_pose_mip_kernels(dev, scene, model, mlp, earlier) -> dict:
    """15a. The input gradient's mip instantiation, nets from numpy seed
    SEED, f32 and bf16: B2 with ``mip`` and ``want_dx`` at the mip training
    batch (4096 rays x N_SAMPLES intervals of the scene at its cone radius,
    524,288 rows, as ``_fused_mlp_bn_mip`` builds it) against
    ``fused_mlp_backward_plain(mip=True, want_dx=True)`` by
    ``probes/input_grad.py::explain_dx``'s rule (the mean, direction and
    variance rows each held row by row; DX_TOL, DX_ROW_SHARE; the rows JAX
    leaves zero exactly zero; its two mip faults caught), its weight
    gradients bit-equal to the launch without dx, dx bit-equal to the mip
    kernel on the tile kernels' planes; B2 with and without dx in turns
    beside the plain version. The kernel alone (``probes/input_grad.py::
    run_mip``): against plain with its planted faults, its ms beside the
    point kernel's on the same planes, the plain version and the torch.mm
    yardstick, its bound. With ``earlier`` (an earlier commit's libraries): B2 under mip
    without dx and every launch without mip (B2 with dx on the point batch)
    bit-equal to the earlier library's (the SASS of every library against
    the earlier one's: ``sass_against_earlier``, phase 16a)."""
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset, sample_ray_batch
    from nerf_simple_tpu_torch.models.nerf import NerfField, init_nerf_params
    from nerf_simple_tpu_torch.ops.sampling import stratified_ts
    from nerf_simple_tpu_torch.probes import input_grad as ig_probe
    from nerf_simple_tpu_torch.probes.wgrad import turns_ms
    from nerf_simple_tpu_torch.train.step import build_x16_mip

    packed = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(SEED, model), dev))
    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    rays_b, pix_b = sample_ray_batch(g, rd.rays["train"], rd.pixels["train"], BATCH)
    del rd
    edges = stratified_ts(g, BATCH, N_SAMPLES + 1, 2.0, 6.0, dev)
    x = build_x16_mip(rays_b, edges, pix_b, mip_radius(scene_focal(scene)))
    x[6:11] = 0.0  # the render's input: means, dirs, variances only
    x[14] = 0.0
    x8 = train_batch(dev, scene)[:8].contiguous()
    gT = torch.from_numpy(np.random.default_rng(SEED).normal(size=(8, x.shape[1])).astype(np.float32)).to(dev)
    b2 = mlp.fused_mlp_backward
    stats = {}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            w = mlp._cast_weights(packed, dt)
            before = (b2.mip_dx_launches, mlp.input_grad_mip_launches())
            grads, dx = b2(w, x, gT, dt, model, mip=True, want_dx=True)
            torch.cuda.synchronize()
            check((b2.mip_dx_launches, mlp.input_grad_mip_launches()) == (before[0] + 1, before[1] + 1),
                  "B2 with mip and dx counted, its mip input-gradient kernel counted in C")
            alone = b2(w, x, gT, dt, model, mip=True)
            bit_equal = all(torch.equal(a, c) for a, c in zip(grads, alone))
            _, res = mlp.forward_residuals(w, x, dt, model, mip=True)
            gws = mlp.backward_tile(w, res, gT, dt, model)
            del res
            composed = torch.equal(dx, mlp.input_grad(w, x, gws, dt, model, mip=True))
            del gws
            zero_rows = bool((dx[list(ig_probe.MIP_ZERO_ROWS)] == 0).all())
            st = {}
            if earlier:
                lib = earlier["fused_mlp_bwd"]
                st["mip_no_dx_bit_equal_earlier"] = all(torch.equal(a, c) for a, c in zip(
                    alone, earlier_backward(mlp, lib, w, x, gT, dt, model, mip=True)))
                pg, pdx = b2(w, x8, gT, dt, model, want_dx=True)
                eg, edx = earlier_backward(mlp, lib, w, x8, gT, dt, model, want_dx=True)
                st["point_dx_as_earlier"] = (all(torch.equal(a, c) for a, c in zip(pg, eg))
                                             and dx_as_earlier(pdx, edx, dt))
                del pg, pdx, eg, edx
            want, dx_p = mlp.fused_mlp_backward_plain(w, x, gT, dt, model, mip=True, want_dx=True)
            rel, abs_err = grad_errors(grads, want)
            ex = ig_probe.explain_dx(w, x, gT, dx, dx_p, dt, model, None, DX_TOL[dt], mip=True)
            del grads, dx, alone, want, dx_p
            torch.cuda.empty_cache()
            ms = turns_ms({"dx": lambda: b2(w, x, gT, dt, model, mip=True, want_dx=True),
                           "no_dx": lambda: b2(w, x, gT, dt, model, mip=True)})
            st.update(err=abs_err, rel=rel, dx_rows=ex, ms=ms["dx"], ms_no_dx=ms["no_dx"], rows=x.shape[1],
                      bit_equal_no_dx=bit_equal, dx_equal_composed=composed, zero_rows_zero=zero_rows,
                      plain_ms=cuda_ms(lambda: mlp.fused_mlp_backward_plain(w, x, gT, dt, model, mip=True,
                                                                            want_dx=True), reps=3))
            torch.cuda.empty_cache()
            print(f"B2 mip want_dx vs plain {name} at {x.shape[1]} rows: grad err {rel:.3e} of max (tol "
                  f"{GRAD_TOL['B2', dt]:.0e}); dx rows past {DX_TOL[dt]:.0e} (mean, direction and variance rows each "
                  f"of their max) {ex['n_past']} ({ex['share']:.2e}, tol {DX_ROW_SHARE[dt]:.0e}), with a flipped relu "
                  f"mask {ex['n_flipped']}, past without one {ex['n_unexplained']}, on the kernel's own masks "
                  f"{ex['own_masks_err']:.2e}; planted faults: " + ", ".join(
                      f"{k} {f['share']:.2e} past ({f['n_unexplained']} without a flipped mask)"
                      for k, f in ex["faults"].items()) + f"; rows {ig_probe.MIP_ZERO_ROWS} zero: {zero_rows}; dx bit-equal "
                  f"to the mip input-gradient kernel on the kernels' own planes: {composed}; in turns: with dx "
                  f"{st['ms']:.3f} ms, without {st['ms_no_dx']:.3f} ms; plain {st['plain_ms']:.3f} ms; grads "
                  f"bit-equal to the launch without dx: {bit_equal}" + (
                      f"; without dx bit-equal to the earlier library's: {st['mip_no_dx_bit_equal_earlier']}; "
                      f"the point launch with dx as the earlier library's (grads bit-equal, dx bit-equal in f32, "
                      f"in bf16 within {ig_probe.MIP_CONTRACT_TOL:.0e}): {st['point_dx_as_earlier']}"
                      if earlier else ""), flush=True)
            check(rel <= GRAD_TOL["B2", dt] and composed and zero_rows and ex["n_unexplained"] == 0
                  and ex["own_masks_err"] <= DX_TOL[dt] and ex["share"] <= DX_ROW_SHARE[dt],
                  f"B2 mip want_dx {name} within tolerance")
            check(all(f["n_unexplained"] > 0 for f in ex["faults"].values()),
                  f"the mip dx rule catches both planted faults ({name})")
            check(bit_equal and st.get("mip_no_dx_bit_equal_earlier", True)
                  and st.get("point_dx_as_earlier", True), f"B2 {name}: the launches without dx, or without "
                  "mip, unchanged")
            stats[f"b2_{name}"] = st
    del x, x8, gT, rays_b, pix_b, edges
    torch.cuda.empty_cache()
    ig = ig_probe.run_mip(dev, model)
    for name in ("f32", "bf16"):
        v = ig[name]
        print(f"mip input-gradient kernel alone {name} at {ig['rows']} rows: {v['ms']:.3f} ms (the point kernel on "
              f"the same planes {v['point_ms']:.3f} ms), plain {v['plain_ms']:.3f} ms, torch.mm yardstick "
              f"{v['library_ms']:.3f} ms; bound {v['bound_ms']:.3f} ms ({v['bound_by']}), "
              f"{100 * v['share_of_bound']:.1f}% of it; dx err {v['rel_err']:.2e} by row group (variance rows "
              f"{v['var_rel_err']:.2e}; tol {ig_probe.REL_TOL[torch.float32 if name == 'f32' else torch.bfloat16]:.0e}); "
              f"planted faults {', '.join(f'{k} {e:.2e}' for k, e in v['fault_err'].items())}", flush=True)
    stats["input_grad"] = ig
    return stats


def sass_against_earlier(before_dir, _build) -> dict:
    """Each library of BEFORE_ENTRIES against the earlier commit's, kernel
    by kernel (``_build.sass_against``): every kernel of the earlier
    library, but the SIMT input-gradient kernels that the current ones
    replace by design (``probes/input_grad.py::SASS_REPLACED``), must build
    to the same SASS in the current one; the current one's other kernels
    are new."""
    from nerf_simple_tpu_torch.probes.input_grad import SASS_REPLACED, sass_line

    sass = _build.sass_against(before_dir, BEFORE_ENTRIES, SASS_REPLACED)
    print(sass_line(sass), flush=True)
    check(all(not v["differ"] and v["identical"] == v["earlier"] for v in sass.values()),
          "every kernel of the earlier libraries builds to the same SASS")
    return sass


def phase_pose_mip_train(dev, scene, work, mlp) -> dict:
    """15b. Pose refinement with cone casting through train() (bf16,
    pallas): configs/lego_mip.yaml's keys (mip_levels 2) + pose_opt,
    pose_warmup PM_WARMUP, pose_freeze_at PM_FREEZE, PM_ITERS steps, on a
    copy of the phase-7 scene whose train poses are perturbed as the pose
    recipe's (``perturb_train_poses``). Before the freeze each step runs
    two mip forwards and two B2 launches with the mip input gradient
    (counted by the wrapper and in C); after it, the fused mip core (two
    cone-cast B1 launches a step). The loss falls, the deltas are nonzero,
    the rig's error before and after (``rig_error``); then a pose + mip step
    from a fresh state: its wall and host issue, kernel ms by pass
    (``profile_step(split_pose, forwards=2)``), idle share; then
    ``evaluate.test`` of train still 0 from the refined rig (the sidecar)."""
    import shutil

    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.evaluate import test
    from nerf_simple_tpu_torch.models.nerf import NerfMLP
    from nerf_simple_tpu_torch.train.loop import train
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    pert = os.path.join(work, "pose_mip_scene")
    shutil.copytree(scene, pert)
    perturb_train_poses(pert)
    rig_before = rig_error(scene, pert)
    cfg = load_yaml("configs/lego_mip.yaml")
    cfg.update(datapath=pert, savepath=os.path.join(work, "models_pm"), log_dir=os.path.join(work, "logs_pm"),
               num_iters=PM_ITERS, ckpt_loss=1, ckpt_images=PM_ITERS, ckpt_model=PM_FREEZE, steps_per_call=50,
               pose_opt=True, pose_warmup=PM_WARMUP, pose_freeze_at=PM_FREEZE)
    check(cfg["mip"] and cfg["mip_levels"] == 2 and cfg["backend"] == "pallas" and cfg["compute_dtype"] == "bf16",
          "the mip config's keys")
    fwd, b2, b1 = mlp.fused_mlp_forward, mlp.fused_mlp_backward, mlp.fused_train_step
    fwd.launches = fwd.mip_launches = b2.launches = b2.dx_launches = b2.mip_dx_launches = 0
    b1.launches = b1.mip_launches = b1.weights_launches = 0
    mlp.input_grad_launches(reset=True)
    mlp.input_grad_mip_launches(reset=True)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(forward=fwd.launches, forward_mip=fwd.mip_launches, b2=b2.launches, b2_dx=b2.dx_launches,
                    b2_mip_dx=b2.mip_dx_launches, input_grad=mlp.input_grad_launches(),
                    input_grad_mip=mlp.input_grad_mip_launches(), b1=b1.launches, b1_mip=b1.mip_launches,
                    b1_weights=b1.weights_launches)
    text = log.getvalue()
    with open(os.path.join(OUT, "train_pose_mip_log.txt"), "w") as fh:
        fh.write(text)
    exp = os.path.join(work, "models_pm", cfg["exp_name"])
    losses = scalars(cfg["log_dir"], "Loss/train")
    with np.load(os.path.join(exp, "cam_deltas.npz")) as d:
        dr, dt, freeze_step = d["dr"], d["dt"], int(d["freeze_step"])
    rig_after = rig_error(scene, pert, dr, dt)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"train pose + mip: {PM_ITERS} steps in {train_s:.1f} s with renders; launches {launches}; loss (0.1 coarse "
          f"+ fine) {first:.5f} -> {last:.5f} (means of the first and last 10); |dr| max {np.abs(dr).max():.4f}, "
          f"|dt| max {np.abs(dt).max():.4f}; the rig's mean error before {rig_before['rot']:.4f} rad / "
          f"{rig_before['trans']:.4f}, after {rig_after['rot']:.4f} rad / {rig_after['trans']:.4f} (aligned as a "
          f"whole: before {rig_before['rot_aligned']:.4f} / {rig_before['trans_aligned']:.4f}, after "
          f"{rig_after['rot_aligned']:.4f} / {rig_after['trans_aligned']:.4f}); "
          + next(line for line in text.splitlines() if "pose freeze at step" in line), flush=True)
    check(freeze_step == PM_FREEZE and state.cams is None, "the freeze baked the deltas at pose_freeze_at")
    check(launches["b2_mip_dx"] == launches["b2_dx"] == launches["b2"] == launches["input_grad_mip"]
          == launches["input_grad"] == 2 * freeze_step, "two B2 launches with the mip input gradient a step before the "
          "freeze, counted where they launch")
    check(launches["b1_mip"] == launches["b1"] == 2 * (PM_ITERS - freeze_step)
          and launches["b1_weights"] == PM_ITERS - freeze_step,
          "the fused mip core (two cone-cast B1 launches a step) after the freeze")
    check(launches["forward_mip"] == launches["forward"] >= 2 * freeze_step, "the mip forwards (and the val renders)")
    check(all(np.isfinite(losses)) and len(losses) == PM_ITERS and last < first, "the pose + mip loss fell")
    check(np.abs(dr).max() > 0 and np.abs(dt).max() > 0, "the deltas moved")

    tcfg = train_config(cfg)
    model = NerfMLP(Lp=tcfg.net_Lp, Ld=tcfg.net_Ld, H=tcfg.net_H)
    rd = RayDataset.from_blender(load_blender(pert, True, 25), dev)
    rays, pixels = rd.rays["train"], rd.pixels["train"]
    n_pix = rd.H * rd.W
    st = make_train_state(tcfg, model, dev, n_images=rays.shape[0] // n_pix)
    step_fn = build_train_step(tcfg, model, base_radius=mip_radius(rd.f), rays_per_image=n_pix)

    def step():
        return step_fn(st, rays, pixels)

    torch.cuda.reset_peak_memory_stats()
    walls = step_walls(step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    others = {}
    prof = profile_step(step, others, split_pose=True, forwards=2, rest="frustums, compositing and rays")
    busy = sum(prof.values())
    idle = 1 - busy / walls["ms"] if prof else None
    print(f"train step pose + mip bf16 (two levels): {walls['ms']:.3f} ms a step, {BATCH / walls['ms'] * 1e3:,.0f} "
          f"rays/s (CUDA events over 20 steps, median of 5; runs {', '.join(f'{w:.3f}' for w in walls['walls'])}); "
          f"host issues a step in {walls['host_ms']:.3f} ms; peak device memory {peak_gb:.2f} GB", flush=True)
    print("train step pose + mip bf16 profile, device ms a step: " + (", ".join(
        f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1]))
        + f"; kernels {busy:.3f} of {walls['ms']:.3f} ms, idle share {idle:.3f}" if prof else
        "not measured (the profiler saw no device activity)"), flush=True)
    print("train step pose + mip bf16 profile, the frustum/compositing group by kernel, ms a step: " + "; ".join(
        f"{n} {v:.3f}" for n, v in sorted(others.items(), key=lambda kv: -kv[1])[:8]), flush=True)
    del st, step_fn, rd, rays, pixels, state
    torch.cuda.empty_cache()

    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        test(dict(loadpath=exp, datapath=pert, savepath=os.path.join(work, "eval_pm"), im_set="train", im_idxs=[0],
                  mip=True, mip_levels=2, N_samples=N_SAMPLES, compute_dtype="bf16", backend="pallas",
                  batch_size=16384))
    eval_s = time.perf_counter() - t0
    psnr = [float(m) for m in re.findall(r"im \d+: mse=\S+ psnr=(\S+)", log.getvalue())]
    print(f"eval pose + mip: train still 0 from the refined rig (the sidecar), two levels: PSNR "
          f"{', '.join(f'{p:.2f}' for p in psnr)} dB in {eval_s:.1f} s", flush=True)
    check(len(psnr) == 1 and np.isfinite(psnr[0]), "the refined mip still rendered")
    return dict(launches=launches, loss_first=first, loss_last=last, train_s=train_s, rig_before=rig_before,
                rig_after=rig_after, dr_max=float(np.abs(dr).max()), dt_max=float(np.abs(dt).max()),
                step_ms=walls["ms"], host_ms=walls["host_ms"], walls=walls["walls"], profile=prof, idle=idle,
                peak_gb=peak_gb, eval_psnr=psnr[0], eval_s=eval_s)


def phase_pose_prop_train(dev, scene, work, mlp) -> dict:
    """15c. Pose refinement with proposal sampling through train() (bf16,
    pallas): configs/lego_proposal.yaml's keys + pose_opt and
    pe_anneal_until PP_ANNEAL, PP_ITERS steps on the phase-7 scene, one
    preview (val and train renders) at PP_PREVIEW, mid-anneal: each step
    runs the main field's forward and B2 with the input gradient (the
    anneal windows until PP_ANNEAL), the proposal MLP in plain autograd, no
    B1. The loss falls and the deltas are nonzero; then the step's wall
    from a fresh state mid-anneal (step 20)."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.models.nerf import NerfMLP
    from nerf_simple_tpu_torch.train.loop import train
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    cfg = load_yaml("configs/lego_proposal.yaml")
    cfg.update(datapath=scene, savepath=os.path.join(work, "models_pp"), log_dir=os.path.join(work, "logs_pp"),
               num_iters=PP_ITERS, ckpt_loss=1, ckpt_images=PP_PREVIEW, ckpt_model=PP_ITERS, steps_per_call=10,
               pose_opt=True, pose_warmup=PM_WARMUP, pe_anneal_until=PP_ANNEAL)
    check(cfg["proposal"] and cfg["backend"] == "pallas" and cfg["compute_dtype"] == "bf16", "the proposal keys")
    fwd, b2, b1 = mlp.fused_mlp_forward, mlp.fused_mlp_backward, mlp.fused_train_step
    fwd.launches = fwd.anneal_launches = b2.launches = b2.dx_launches = b2.anneal_launches = b1.launches = 0
    mlp.input_grad_launches(reset=True)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(forward=fwd.launches, forward_anneal=fwd.anneal_launches, b2=b2.launches, b2_dx=b2.dx_launches,
                    b2_anneal=b2.anneal_launches, input_grad=mlp.input_grad_launches(), b1=b1.launches)
    text = log.getvalue()
    with open(os.path.join(OUT, "train_pose_prop_log.txt"), "w") as fh:
        fh.write(text)
    losses = scalars(cfg["log_dir"], "Loss/train")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    dr_max = float(state.cams.dr.detach().abs().max())
    dt_max = float(state.cams.dt.detach().abs().max())
    print(f"train pose + proposal: {PP_ITERS} steps in {train_s:.1f} s with a preview at step {PP_PREVIEW} "
          f"(mid-anneal, alpha {PP_PREVIEW / PP_ANNEAL:.2f}); launches {launches}; loss {first:.5f} -> {last:.5f} "
          f"(means of the first and last 10); |dr| max {dr_max:.4f}, |dt| max {dt_max:.4f}", flush=True)
    check(launches["b2_dx"] == launches["b2"] == launches["input_grad"] == PP_ITERS and launches["b1"] == 0,
          "one B2 launch with the input gradient a step, no B1")
    check(launches["b2_anneal"] == PP_ANNEAL and launches["forward_anneal"] > PP_ANNEAL,
          "the main field annealed until pe_anneal_until, the preview mid-anneal")
    check(all(np.isfinite(losses)) and len(losses) == PP_ITERS and last < first, "the pose + proposal loss fell")
    check(dr_max > 0 and dt_max > 0, "the deltas moved")

    tcfg = train_config(cfg)
    model = NerfMLP(Lp=tcfg.net_Lp, Ld=tcfg.net_Ld, H=tcfg.net_H)
    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    rays, pixels = rd.rays["train"], rd.pixels["train"]
    n_pix = rd.H * rd.W
    st = make_train_state(tcfg, model, dev, n_images=rays.shape[0] // n_pix)
    step_fn = build_train_step(tcfg, model, rays_per_image=n_pix)

    def step():  # mid-anneal: the windows and the input gradient on every call
        st.step = 20
        return step_fn(st, rays, pixels)

    walls = step_walls(step)
    print(f"train step pose + proposal bf16 (mid-anneal): {walls['ms']:.3f} ms a step, "
          f"{BATCH / walls['ms'] * 1e3:,.0f} rays/s (CUDA events over 20 steps, median of 5; runs "
          f"{', '.join(f'{w:.3f}' for w in walls['walls'])}); host issues a step in {walls['host_ms']:.3f} ms",
          flush=True)
    del st, step_fn, rd, rays, pixels, state
    torch.cuda.empty_cache()
    return dict(launches=launches, loss_first=first, loss_last=last, train_s=train_s, dr_max=dr_max, dt_max=dt_max,
                step_ms=walls["ms"], host_ms=walls["host_ms"], walls=walls["walls"])


# Scene contraction (phase 16): the unbounded scene, the JAX bench's layout
# (scripts/unbounded_bench.py:124-128: train_jitter 3, cameras at radius
# 3..6) cut to 30 train, 2 val and 2 test views at 200x200 (the bench: 100
# / 2 / 4); its bounds (the bench's tn 1, tf 30); the 360 recipe's steps
# (configs/colmap360.yaml runs 20,000) and the mip + contract run's; the
# rows placed by the unit sphere and far out in the kernel checks' batch.
UNB_VIEWS, UNB_HW, UNB_TN, UNB_TF = (30, 2, 2), 200, 1.0, 30.0
C360_ITERS, C360_MORE, CMIP_ITERS = 300, 100, 100
# The recipe at a reduced width and batch, which leaves the mean-colour
# plateau within C360_ITERS steps on this scene (at the flagship's width
# and batch the loss falls 42% in 300 steps and the held-out interlevel
# loss rises, on the plain path as on the kernels; PERF.md, section 6).
C360_SMALL = dict(net_H=128, Nf=64, Np=32, batch_size=1024)
EDGE_RAYS = 64  # the batch's last rays: their samples at |x| = 1 -+ 1e-4..1e-2 and 28..32


def unbounded_batch(dev, scene, mip: bool = False):
    """B1's (16, 524,288) input for a 4096-ray batch of the unbounded scene
    as the 360 step builds it: N_SAMPLES disparity-stratified samples on
    [UNB_TN, UNB_TF] a ray (under mip N_SAMPLES + 1 edges, the frustum
    Gaussians at the scene's cone radius); then the samples of the last
    EDGE_RAYS rays are moved onto both sides of the unit sphere and out
    to |x| ~ 30 (numpy seed SEED), so that every case of the contraction
    is in the batch."""
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset, sample_ray_batch
    from nerf_simple_tpu_torch.ops.sampling import stratified_ts_spaced
    from nerf_simple_tpu_torch.train.step import build_x16, build_x16_mip

    rd = RayDataset.from_blender(load_blender(scene, False, UNB_VIEWS[0]), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    rays_b, pix_b = sample_ray_batch(g, rd.rays["train"], rd.pixels["train"], BATCH)
    ts = stratified_ts_spaced(g, BATCH, N_SAMPLES + mip, UNB_TN, UNB_TF, dev, space="disparity")
    x = build_x16_mip(rays_b, ts, pix_b, mip_radius(scene_focal(scene, UNB_HW))) if mip else build_x16(rays_b, ts, pix_b)
    rng = np.random.default_rng(SEED)
    n = EDGE_RAYS * N_SAMPLES
    u = rng.normal(size=(3, n))
    u /= np.linalg.norm(u, axis=0, keepdims=True)
    eps = rng.uniform(1e-4, 1e-2, n)
    r = np.select([np.arange(n) % 3 == 0, np.arange(n) % 3 == 1], [1.0 - eps, 1.0 + eps], rng.uniform(28, 32, n))
    x[0:3, -n:] = torch.from_numpy((u * r).astype(np.float32)).to(dev)
    return x


def into_the_ball(x):
    """``x`` with every sample moved inside the unit ball (rows 0..2 scaled
    to |x| <= 0.999), the rest unchanged."""
    y = x.clone()
    n = y[0:3].norm(dim=0)
    y[0:3] *= torch.where(n > 0.999, 0.999 / n, 1.0)
    return y


@contextlib.contextmanager
def faulty_plain(mlp, fault: str):
    """A fault planted in the plain versions: ``raw`` leaves posx's raw rows
    uncontracted, ``var`` drops the variance warp under mip."""
    encode, contract = mlp._encode, mlp._contract
    if fault == "raw":
        def raw(xT, model, var=None, enc_w=None):
            posx, posd = encode(xT, model, var, enc_w)
            return torch.cat([xT[0:3], posx[3:]]), posd
        mlp._encode = raw
    else:
        mlp._contract = lambda xyz, var: (contract(xyz, var)[0], var)
    try:
        yield
    finally:
        mlp._encode, mlp._contract = encode, contract


def phase_contract_kernels(dev, scene, mlp, earlier, before_dir) -> dict:
    """16a. The contracted instantiations of the forward tile kernels
    (csrc/fused_contract.cu) as the forward, B2's recompute, B1 and B3 run
    them, nets from numpy seed SEED, f32 and bf16, at the unbounded batch
    (``unbounded_batch``: 524,288 rows, point and mip) against their plain
    versions, with the error measures and bounds of phases 3-5 (B1 the 360
    recipe's launch: the weights output and the disparity-space rail; under
    mip the weights output and the opaque tail); each bit-equal to the
    launch without contract where every sample lies inside the unit ball
    (the forward on the batch's own such rows; B2, B1 and B3 on the batch
    moved into the ball); a fault planted in the plain version (the raw
    rows left uncontracted; under mip the variance warp dropped) caught;
    the forward and B1 with and without contract in turns. With
    ``earlier``: the forward and B2 without contract bit-equal to the
    earlier library's on this batch, and every kernel of the earlier
    libraries the same SASS (``sass_against_earlier``)."""
    from nerf_simple_tpu_torch.kernels import _build
    from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
    from nerf_simple_tpu_torch.probes.wgrad import turns_ms

    model, cm = NerfMLP(), NerfMLP(contract=True)
    packed = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(SEED, model), dev))
    stats = {}
    before = mlp.contract_launches()
    for mip in (False, True):
        x = unbounded_batch(dev, scene, mip)
        xf = x if mip else x[:8].contiguous()
        norm = x[0:3].norm(dim=0)
        inside = norm <= 1.0
        x_in = into_the_ball(x)
        xf_in = x_in if mip else x_in[:8].contiguous()
        gT = torch.from_numpy(np.random.default_rng(SEED).normal(size=(8, x.shape[1])).astype(np.float32)).to(dev)
        kw = dict(out_weights=True, opaque_tail=True) if mip else dict(out_weights=True,
                                                                     dist=(DIST_LAMBDA, UNB_TN, UNB_TF, True))
        form = "mip" if mip else "point"
        with torch.no_grad():
            for dt in (torch.float32, torch.bfloat16):
                name = "f32" if dt == torch.float32 else "bf16"
                w = mlp._cast_weights(packed, dt)
                st = dict(rows=x.shape[1], inside_rows=int(inside.sum()), far_rows=int((norm > 20).sum()))
                # the forward
                got = mlp.fused_mlp_forward(w, xf, dt, cm, mip=mip)
                want = mlp.fused_mlp_forward_plain(w, xf, dt, cm, mip=mip)
                st["fwd_err"] = (got[:4] - want[:4]).abs().max().item()
                unc = mlp.fused_mlp_forward(w, xf, dt, model, mip=mip)
                st["fwd_inside_bit_equal"] = torch.equal(got[:, inside], unc[:, inside])
                with faulty_plain(mlp, "var" if mip else "raw"):
                    st["fault_err"] = (got[:4] - mlp.fused_mlp_forward_plain(w, xf, dt, cm, mip=mip)[:4]).abs().max().item()
                if earlier:
                    st["fwd_no_contract_bit_equal_earlier"] = mip or torch.equal(
                        unc, earlier_forward(mlp, earlier["fused_mlp_fwd"], w, xf, dt, model))
                del got, want, unc
                # B2's recompute
                g2 = mlp.fused_mlp_backward(w, xf, gT, dt, cm, mip=mip)
                st["b2_rel"], st["b2_err"] = grad_errors(g2, mlp.fused_mlp_backward_plain(w, xf, gT, dt, cm, mip=mip))
                st["b2_inside_bit_equal"] = all(torch.equal(a, b) for a, b in zip(
                    mlp.fused_mlp_backward(w, xf_in, gT, dt, cm, mip=mip),
                    mlp.fused_mlp_backward(w, xf_in, gT, dt, model, mip=mip)))
                if earlier:
                    st["b2_no_contract_bit_equal_earlier"] = all(torch.equal(a, b) for a, b in zip(
                        mlp.fused_mlp_backward(w, xf, gT, dt, model, mip=mip),
                        earlier_backward(mlp, earlier["fused_mlp_bwd"], w, xf, gT, dt, model, mip=mip)))
                del g2
                # B1
                out = mlp.fused_train_step(w, x, N_SAMPLES, dt, cm, mip=mip, **kw)
                ref = mlp.fused_train_step_plain(w, x, N_SAMPLES, dt, cm, mip=mip, **kw)
                st["b1_loss_err"] = abs(out[0].item() / ref[0].item() - 1)
                st["b1_rel"], st["b1_err"] = grad_errors(out[1], ref[1])
                st["b1_w_err"] = (out[2] - ref[2]).abs().max().item()
                a, b = (mlp.fused_train_step(w, x_in, N_SAMPLES, dt, m, mip=mip, **kw) for m in (cm, model))
                st["b1_inside_bit_equal"] = a[0].item() == b[0].item() and all(
                    torch.equal(p, q) for p, q in zip(a[1], b[1])) and torch.equal(a[2], b[2])
                del out, ref, a, b
                torch.cuda.empty_cache()
                # B3 (point compositing: the eval render of a single net)
                if not mip:
                    r3 = mlp.fused_render(w, x, N_SAMPLES, dt, cm)
                    st["b3_err"] = (r3[:3] - mlp.fused_render_plain(w, x, N_SAMPLES, dt, cm)[:3]).abs().max().item()
                    st["b3_inside_bit_equal"] = torch.equal(mlp.fused_render(w, x_in, N_SAMPLES, dt, cm),
                                                            mlp.fused_render(w, x_in, N_SAMPLES, dt, model))
                    del r3
                    # ms in turns (the forward; B1 as the 360 step launches it), and the plain versions
                    ms = turns_ms({"fwd": lambda: mlp.fused_mlp_forward(w, xf, dt, cm),
                                   "fwd_none": lambda: mlp.fused_mlp_forward(w, xf, dt, model),
                                   "b1": lambda: mlp.fused_train_step(w, x, N_SAMPLES, dt, cm, **kw),
                                   "b1_none": lambda: mlp.fused_train_step(w, x, N_SAMPLES, dt, model, **kw),
                                   "b2": lambda: mlp.fused_mlp_backward(w, xf, gT, dt, cm),
                                   "b3": lambda: mlp.fused_render(w, x, N_SAMPLES, dt, cm)})
                    st.update({f"{k}_ms": v for k, v in ms.items()})
                    st["fwd_plain_ms"] = cuda_ms(lambda: mlp.fused_mlp_forward_plain(w, xf, dt, cm), reps=3)
                    st["b1_plain_ms"] = cuda_ms(lambda: mlp.fused_train_step_plain(w, x, N_SAMPLES, dt, cm, **kw),
                                                reps=3)
                    st["b2_plain_ms"] = cuda_ms(lambda: mlp.fused_mlp_backward_plain(w, xf, gT, dt, cm), reps=3)
                    st["b3_plain_ms"] = cuda_ms(lambda: mlp.fused_render_plain(w, x, N_SAMPLES, dt, cm), reps=3)
                torch.cuda.empty_cache()
                stats[f"{form}_{name}"] = st
                print(f"contract {form} {name} at {st['rows']} rows ({st['inside_rows']} inside the unit ball, "
                      f"{st['far_rows']} past 20): forward vs plain {st['fwd_err']:.2e} (tol {TOL[dt]:.0e}), "
                      f"bit-equal to the launch without contract on the rows inside: {st['fwd_inside_bit_equal']}; "
                      f"planted fault ({'variance warp dropped' if mip else 'raw rows uncontracted'}) "
                      f"{st['fault_err']:.2e}; B2 grads {st['b2_rel']:.2e} of max (tol {GRAD_TOL['B2', dt]:.0e}); "
                      f"B1 ({', '.join(kw)}) loss {st['b1_loss_err']:.2e}, grads {st['b1_rel']:.2e} (tol "
                      f"{GRAD_TOL['B1', dt]:.0e}), weights {st['b1_w_err']:.2e}; inside the ball bit-equal: B2 "
                      f"{st['b2_inside_bit_equal']}, B1 {st['b1_inside_bit_equal']}"
                      + (f", B3 {st['b3_inside_bit_equal']}; B3 vs plain {st['b3_err']:.2e}" if not mip else "")
                      + ("".join(f"; {k} {v}" for k, v in st.items() if k.endswith("earlier"))), flush=True)
                if not mip:
                    print(f"contract {name} in turns at {st['rows']} rows: forward {st['fwd_ms']:.3f} ms (without "
                          f"contract {st['fwd_none_ms']:.3f}), B1 {st['b1_ms']:.3f} ({st['b1_none_ms']:.3f}), B2 "
                          f"{st['b2_ms']:.3f}, B3 {st['b3_ms']:.3f}; plain forward {st['fwd_plain_ms']:.3f}, B1 "
                          f"{st['b1_plain_ms']:.3f}, B2 {st['b2_plain_ms']:.3f}, B3 {st['b3_plain_ms']:.3f}",
                          flush=True)
                check(st["fwd_err"] <= TOL[dt] and st["b2_rel"] <= GRAD_TOL["B2", dt]
                      and st["b1_loss_err"] <= LOSS_TOL[dt] and st["b1_rel"] <= GRAD_TOL["B1", dt]
                      and st["b1_w_err"] <= TOL[dt] and st.get("b3_err", 0.0) <= TOL[dt],
                      f"the contracted kernels ({form}, {name}) match their plain versions")
                check(st["fwd_inside_bit_equal"] and st["b2_inside_bit_equal"] and st["b1_inside_bit_equal"]
                      and st.get("b3_inside_bit_equal", True), f"contracted launches ({form}, {name}) bit-equal to "
                      "the launches without contract inside the unit ball")
                check(st["fault_err"] > 5 * TOL[dt], f"the planted fault ({form}, {name}) is caught")
                check(all(v for k, v in st.items() if k.endswith("earlier")),
                      f"launches without contract ({form}, {name}) bit-equal to the earlier library's")
        del x, xf, x_in, xf_in, gT
        torch.cuda.empty_cache()
    stats["launches_here"] = mlp.contract_launches() - before
    if earlier:
        stats["sass"] = sass_against_earlier(before_dir, _build)
    for k, line in _build.ptxas_usage(_build.build_log.get("fused_contract", "")):
        if "fwd_kernel" in k:
            print(f"ptxas fused_contract {_build.short_name(k)[:48]}: {line}", flush=True)
    return stats


def c360_config(scene: str, work: str) -> dict:
    """configs/colmap360.yaml's keys, with the unbounded scene in the
    blender layout for its LLFF capture (its dataset, llff_factor and ndc
    keys dropped: LLFF is ROADMAP Queue A item 6), the scene's bounds, its
    full resolution, and C360_ITERS steps."""
    from nerf_simple_tpu_torch.config import load_yaml

    cfg = {k: v for k, v in load_yaml("configs/colmap360.yaml").items()
           if k not in ("dataset", "llff_factor", "ndc", "test_params")}
    cfg.update(datapath=scene, savepath=os.path.join(work, "models"), log_dir=os.path.join(work, "logs_c360"),
               exp_name="c360", tn=UNB_TN, tf=UNB_TF, half_res=False, num_train_imgs=UNB_VIEWS[0],
               num_iters=C360_ITERS, ckpt_loss=1, ckpt_images=150, ckpt_model=50, steps_per_call=50)
    return cfg


def phase_contract_train(dev, scene, work, mlp) -> dict:
    """16b. The 360 recipe (``c360_config``: contract, disparity spacing,
    proposal Np 64, the distortion rail, Nf 128, bf16, pallas, the
    flagship net) through train(), C360_ITERS steps and C360_MORE resumed,
    on the unbounded scene: one contracted B1 launch a step with the
    weights output and the rail (counted in Python and in C); every loss
    finite and the loss falling; the held-out interlevel loss (4096 val
    rays, deterministic probes and samples) at steps 50 and C360_ITERS.
    The bf16 step's wall, host issue and profile by pass, the idle share;
    the proposal step without contract on the same scene beside it. One
    f32 step from one state through the fused core (B1) and through the
    autograd path (the forward and B2), under JAX's rule. The recipe at
    C360_SMALL's sizes, C360_ITERS steps: the loss halves and the held-out
    interlevel loss falls. Then ``evaluate.test`` (one test still, a
    2-frame orbit), the CLI server with the recipe's samples, one 400x400
    frame over HTTP matched to ``render_rays_chunked`` to 1 level, and a
    single-net fused_eval frame of the contracted field (B3)."""
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset, sample_ray_batch
    from nerf_simple_tpu_torch.evaluate import load_params, test
    from nerf_simple_tpu_torch.models import model_from_train_config
    from nerf_simple_tpu_torch.models.proposal import ProposalMLP, ProposalPair
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.ops.volume import interlevel_loss
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked, render_rays_proposal
    from nerf_simple_tpu_torch.serve import decode_png
    from nerf_simple_tpu_torch.train.checkpoint import checkpoint_params, load_model_meta
    from nerf_simple_tpu_torch.train.loop import train
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    cfg = c360_config(scene, work)
    tcfg = train_config(cfg)
    cm = model_from_train_config(tcfg)
    check(cm.contract and (cm.Lp, cm.Ld, cm.H) == (10, 4, 256) and tcfg.proposal and (tcfg.Np, tcfg.Nf) == (64, 128)
          and tcfg.sampling_space == "disparity" and tcfg.distortion_loss_weight == DIST_LAMBDA
          and tcfg.backend == "pallas" and tcfg.compute_dtype == "bf16", "the 360 recipe's keys")
    b1, fwd, b2, b3 = mlp.fused_train_step, mlp.fused_mlp_forward, mlp.fused_mlp_backward, mlp.fused_render
    for f in (b1, fwd, b2, b3):
        f.launches = f.contract_launches = 0
    b1.weights_dist_launches = 0
    mlp.contract_launches(reset=True)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(b1=b1.launches, b1_contract=b1.contract_launches, weights_and_rail=b1.weights_dist_launches,
                    forward_contract=fwd.contract_launches)
    cfg.update(resume=True, num_iters=C360_ITERS + C360_MORE)
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    text = log.getvalue()
    with open(os.path.join(OUT, "train_c360_log.txt"), "w") as fh:
        fh.write(text)
    losses = scalars(cfg["log_dir"], "Loss/train")
    psnr = scalars(cfg["log_dir"], "Loss/Val_Img_PSNR_0")
    first, last = float(np.mean(losses[:50])), float(np.mean(losses[C360_ITERS - 50 : C360_ITERS]))
    exp = os.path.join(work, "models", cfg["exp_name"])
    check(load_model_meta(exp) == cm, "the sidecar carries the contracted model")

    rd = RayDataset.from_blender(load_blender(scene, False, UNB_VIEWS[0]), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    held, _ = sample_ray_batch(g, rd.rays["val"], rd.pixels["val"], BATCH)
    s_eval = RenderSettings(N=N_SAMPLES, N_prop=tcfg.Np, tn=UNB_TN, tf=UNB_TF, sampling_space="disparity",
                            backend="pallas", compute_dtype=torch.bfloat16)
    pm = ProposalMLP(tcfg.prop_Lp, tcfg.prop_D, tcfg.prop_H, contract=True)

    def held_out(field):
        with torch.no_grad():
            out, (tp, wp, tf) = render_rays_proposal(field, held, None, s_eval, det_fine=True, return_aux=True)
        return float(interlevel_loss(out.weights, tf, wp, tp))

    il = {"init": held_out(make_train_state(tcfg, cm, dev).field)}
    for k in (50, C360_ITERS):
        il[k] = held_out(ProposalPair.from_jax_params(checkpoint_params(os.path.join(exp, f"ckpt_{k}.pth")), dev,
                                                      cm, pm))
    print(f"train 360 recipe: {C360_ITERS} steps in {train_s:.1f} s with builds and renders; launches {launches}; "
          f"mean loss (MSE + interlevel + distortion) of the first 50 steps {first:.5f}, of steps "
          f"{C360_ITERS - 50}-{C360_ITERS} {last:.5f} (ratio {last / first:.3f}); val PSNR(0) "
          f"{', '.join(f'{p:.2f}' for p in psnr)} dB; held-out interlevel loss "
          + ", ".join(f"step {k}: {v:.5f}" for k, v in il.items()), flush=True)
    check(launches["b1"] == launches["b1_contract"] == launches["weights_and_rail"] == C360_ITERS,
          "one contracted B1 launch a 360 step, with the weights output and the rail")
    check(b1.contract_launches == C360_ITERS + C360_MORE and "resumed from" in text
          and state.step == C360_ITERS + C360_MORE, "the resume added its contracted steps")
    check(all(np.isfinite(losses)) and len(losses) == C360_ITERS + C360_MORE, "every 360 loss logged and finite")
    check(last < first, "the 360 loss fell")

    # f32: the fused 360 core against the autograd path, one step from one state
    cfg32 = dataclasses.replace(tcfg, compute_dtype="f32")
    runs = {}
    for name, fused in (("fused", True), ("autograd", False)):
        st = make_train_state(cfg32, cm, dev)
        with warnings.catch_warnings():  # the autograd path under pallas warns, as JAX does
            warnings.simplefilter("ignore")
            fn = build_train_step(cfg32, cm, fused=fused)
        runs[name] = float(fn(st, rd.rays["train"], rd.pixels["train"])), st.field.to_jax_params()
        del st
    (l_f, p_f), (l_a, p_a) = runs["fused"], runs["autograd"]
    bad = total = 0
    for k in ("prop", "fine"):
        for layer in p_a[k]:
            for n in ("w", "b"):
                a, b = p_f[k][layer][n], p_a[k][layer][n]
                bad += int((np.abs(a - b) > PROP_PARAM_ATOL + PROP_PARAM_RTOL * np.abs(b)).sum())
                total += a.size
    loss_rel_f32 = abs(l_f / l_a - 1)
    print(f"f32 360 step from one state: fused core (contracted B1) loss {l_f:.6f}, autograd (contracted forward + "
          f"B2) {l_a:.6f}, rel diff {loss_rel_f32:.2e} (tol {PROP_LOSS_RTOL:.0e}); parameters past atol "
          f"{PROP_PARAM_ATOL:.0e} + rtol {PROP_PARAM_RTOL:.0e}: {bad}/{total} (tol 0)", flush=True)
    check(loss_rel_f32 <= PROP_LOSS_RTOL and bad == 0, "the fused and autograd 360 steps agree under JAX's rule")

    # the recipe at C360_SMALL's sizes: out of the plateau within C360_ITERS steps
    small = {**c360_config(scene, work), **C360_SMALL, "exp_name": "c360_small",
             "log_dir": os.path.join(work, "logs_c360_small")}
    with contextlib.redirect_stdout(io.StringIO()):
        train(small)
    s_losses = scalars(small["log_dir"], "Loss/train")
    s_first, s_last = float(np.mean(s_losses[:50])), float(np.mean(s_losses[-50:]))
    stcfg = train_config(small)
    s_model, s_pm = model_from_train_config(stcfg), ProposalMLP(stcfg.prop_Lp, stcfg.prop_D, stcfg.prop_H, contract=True)
    s_held = RenderSettings(N=stcfg.Nf, N_prop=stcfg.Np, tn=UNB_TN, tf=UNB_TF, sampling_space="disparity",
                            backend="pallas", compute_dtype=torch.bfloat16)
    s_il = {}
    for k in (50, C360_ITERS):
        f = ProposalPair.from_jax_params(checkpoint_params(os.path.join(work, "models", "c360_small", f"ckpt_{k}.pth")),
                                         dev, s_model, s_pm)
        with torch.no_grad():
            out, (tp_, wp_, tf_) = render_rays_proposal(f, held, None, s_held, det_fine=True, return_aux=True)
        s_il[k] = float(interlevel_loss(out.weights, tf_, wp_, tp_))
    print(f"train 360 recipe at {C360_SMALL}: mean loss of the first 50 steps {s_first:.5f}, of the last 50 "
          f"{s_last:.5f} (ratio {s_last / s_first:.3f}); held-out interlevel loss " + ", ".join(
              f"step {k}: {v:.5f}" for k, v in s_il.items()), flush=True)
    check(all(np.isfinite(s_losses)) and s_last <= 0.5 * s_first, "the 360 recipe at the reduced sizes: loss halves")
    check(s_il[C360_ITERS] < s_il[50], "the 360 recipe at the reduced sizes: the held-out interlevel loss falls")

    step_fn = build_train_step(tcfg, cm)
    rays, pixels = rd.rays["train"], rd.pixels["train"]

    def step():
        return step_fn(state, rays, pixels)

    walls = step_walls(step)
    prof = profile_step(step, None, None, split_proposal=True)
    busy = sum(prof.values())
    idle = 1 - busy / walls["ms"] if prof else None
    ncfg = dataclasses.replace(tcfg, contract=False)
    plain_state = make_train_state(ncfg, model_from_train_config(ncfg), dev)
    plain_fn = build_train_step(ncfg, model_from_train_config(ncfg))
    plain_walls = step_walls(lambda: plain_fn(plain_state, rays, pixels))
    plain_prof = profile_step(lambda: plain_fn(plain_state, rays, pixels), None, None, split_proposal=True)
    del plain_state
    print(f"train step 360 recipe bf16: {walls['ms']:.3f} ms a step, {BATCH / walls['ms'] * 1e3:,.0f} rays/s (CUDA "
          f"events over 20 steps, median of 5; runs {', '.join(f'{w:.3f}' for w in walls['walls'])}); host issues a "
          f"step in {walls['host_ms']:.3f} ms; profile, device ms a step: " + (", ".join(
              f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1]))
              + f"; kernels {busy:.3f}, idle share {idle:.3f}" if prof else "not measured")
          + f". The proposal step without contract, same scene: {plain_walls['ms']:.3f} ms (host "
          f"{plain_walls['host_ms']:.3f}), kernels {sum(plain_prof.values()):.3f} (B1 {plain_prof.get('B1', 0):.3f})",
          flush=True)

    # eval: one test still, a 2-frame orbit
    tp = dict(loadpath=exp, datapath=scene, savepath=os.path.join(work, "results_c360"), exp_name="c360",
              batch_size=16384, half_res=False, im_set="test", im_idxs=[0], N_samples=N_SAMPLES, Np=tcfg.Np,
              sampling_space="disparity", tn=UNB_TN, tf=UNB_TF, backend="pallas", compute_dtype="bf16")
    elog = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(elog):
        test(tp)
        test({**tp, "animation": True, "num_poses": 2})
    eval_s = time.perf_counter() - t0
    etext = elog.getvalue()
    for line in etext.splitlines():
        print("eval 360 recipe:", line, flush=True)
    eval_psnr = [float(p) for p in re.findall(r"im 0: mse=\S+ psnr=(\S+)", etext)]
    videos = glob.glob(os.path.join(work, "results_c360", "c360", "nerf_rgb*"))
    check(len(eval_psnr) == 1 and np.isfinite(eval_psnr[0]) and len(videos) == 1, "the 360 eval: a still, a video")

    # the CLI server with the recipe's samples, one 400x400 frame
    pair = ProposalPair.from_jax_params(load_params(exp, keep_hierarchy=True), dev, cm, pm)
    focal = scene_focal(scene)
    s_frame = dataclasses.replace(s_eval, compute_dtype=torch.bfloat16)
    data, ctype, health, health_after, _ = cli_frame(
        os.path.join(exp, f"params_{C360_ITERS + C360_MORE}.npz"), focal,
        ["--proposal-samples", str(tcfg.Np), "--tn", str(UNB_TN), "--tf", str(UNB_TF), "--sampling-space", "disparity"],
        "serve_c360_log.txt", "the 360 server started")
    pose = torch.as_tensor(spherical_to_pose(4.5, -30.0, 30.0)[None], dtype=torch.float32, device=dev)
    frays = rays_for_poses(pose, H, W, focal)
    want = (render_rays_chunked(pair, frays, 0, s_frame)[0].reshape(H, W, 3).cpu().numpy() * 255).astype(np.uint8)
    u8_err = int(np.abs(decode_png(data).astype(int) - want.astype(int)).max())
    served_launches = health_after["kernel_launches"] - health["kernel_launches"]
    print(f"served 360 recipe: /health proposal {health['proposal']}; a {H}x{W} PNG over HTTP, {served_launches} "
          f"forward launches (contracted: the sidecar), max diff from render_rays_chunked {u8_err} levels", flush=True)
    check(health["proposal"] is True and ctype == "image/png" and u8_err <= 1,
          "the served 360 frame matches render_rays_chunked to 1 level")

    # the contracted field's eval render kernel: a single-net fused_eval frame (B3)
    s_b3 = RenderSettings(N=N_SAMPLES, tn=UNB_TN, tf=UNB_TF, sampling_space="disparity", backend="pallas",
                          compute_dtype=torch.bfloat16, fused_eval=True)
    rgb, _ = render_rays_chunked(pair.fine, frays, 0, s_b3)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(rgb).all()), "the single-net fused_eval frame of the contracted field is finite")
    launches.update(b1_contract_all=b1.contract_launches, forward_contract_all=fwd.contract_launches,
                    b2_contract=b2.contract_launches, b3_contract=b3.contract_launches,
                    c_contract=mlp.contract_launches())
    check(launches["c_contract"] == sum(launches[k] for k in ("b1_contract_all", "forward_contract_all",
                                                              "b2_contract", "b3_contract"))
          and launches["b2_contract"] == 1 and launches["b3_contract"] > 0,
          "every contracted launch of the run counted in C as in the wrappers; B2 and B3 ran contracted")
    print(f"360 recipe launches (counted from the first step to here): {launches}", flush=True)
    return dict(launches=launches, step_ms=walls["ms"], host_ms=walls["host_ms"], profile=prof, idle=idle,
                no_contract_step_ms=plain_walls["ms"], no_contract_host_ms=plain_walls["host_ms"],
                no_contract_profile=plain_prof, first=first, last=last, psnr=psnr, held_out=il,
                eval_psnr=eval_psnr[0], eval_s=eval_s, served_u8_err=u8_err, served_launches=served_launches,
                train_s=train_s, loss_rel_f32=loss_rel_f32, params_past_rule=bad,
                small=dict(sizes=C360_SMALL, first=s_first, last=s_last, held_out=s_il))


def phase_contract_mip(dev, scene, work, mlp) -> dict:
    """16c. mip + contract: configs/lego_mip.yaml's keys (two levels, one
    net) with contract and disparity spacing on the unbounded scene's
    bounds, CMIP_ITERS bf16 steps through train() (two contracted
    cone-cast B1 launches a step), then one test still by evaluate.test
    (the sidecar rebuilds the contracted model)."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.evaluate import test
    from nerf_simple_tpu_torch.train.loop import train

    cfg = load_yaml("configs/lego_mip.yaml")
    tp = cfg.pop("test_params")
    cfg.update(datapath=scene, savepath=os.path.join(work, "models"), log_dir=os.path.join(work, "logs_cmip"),
               exp_name="cmip", contract=True, sampling_space="disparity", tn=UNB_TN, tf=UNB_TF, half_res=False,
               num_train_imgs=UNB_VIEWS[0], num_iters=CMIP_ITERS, ckpt_loss=1, ckpt_images=10**6,
               ckpt_model=CMIP_ITERS, steps_per_call=50)
    b1 = mlp.fused_train_step
    b1.launches = b1.mip_launches = b1.contract_launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        train(cfg)
        tp.update(loadpath=os.path.join(work, "models", "cmip"), datapath=scene,
                  savepath=os.path.join(work, "results_cmip"), half_res=False, im_idxs=[0], sampling_space="disparity",
                  tn=UNB_TN, tf=UNB_TF, backend="pallas", compute_dtype="bf16")
        test(tp)
    secs = time.perf_counter() - t0
    text = log.getvalue()
    losses = scalars(cfg["log_dir"], "Loss/train")
    psnr = [float(p) for p in re.findall(r"im 0: mse=\S+ psnr=(\S+)", text)]
    launches = dict(b1=b1.launches, mip=b1.mip_launches, contract=b1.contract_launches)
    print(f"mip + contract: {CMIP_ITERS} steps (two levels) and a still in {secs:.1f} s; B1 launches {launches}; "
          f"mean loss of the first 20 steps {np.mean(losses[:20]):.5f}, of the last 20 {np.mean(losses[-20:]):.5f}; "
          f"test still PSNR {psnr}", flush=True)
    check(launches == dict(b1=2 * CMIP_ITERS, mip=2 * CMIP_ITERS, contract=2 * CMIP_ITERS),
          "two contracted cone-cast B1 launches a mip + contract step")
    check(all(np.isfinite(losses)) and np.mean(losses[-20:]) < np.mean(losses[:20]) and len(psnr) == 1
          and np.isfinite(psnr[0]), "mip + contract trains and evaluates")
    return dict(launches=launches, first=float(np.mean(losses[:20])), last=float(np.mean(losses[-20:])),
                psnr=psnr[0], seconds=secs)


# Pose refinement and appearance codes on a contracted model (phase 17):
# configs/colmap360.yaml's pose block (:52-58: pose_opt, pose_warmup 600
# and pose_freeze_at 5000 of its 20,000 steps), cut with the run to
# C360P_ITERS steps at the same fractions (the warmup 3%, the freeze at
# 25%); the appearance run's steps and anneal; the anneal progress of the
# kernel checks' windows.
C360P_ITERS, C360P_WARMUP, C360P_FREEZE = 120, 4, 30
CAPP_ITERS, CAPP_ANNEAL, CPOSE_ALPHA = 40, 20, 0.3


def phase_pose_contract_kernels(dev, scene, mlp, earlier) -> dict:
    """17a. The input gradient's contract instantiation (csrc/fused_contract.cu)
    and the contracted forward with the windows and the code rows, nets
    from numpy seed SEED, f32 and bf16, at the unbounded batch
    (``unbounded_batch``: 524,288 rows, 18,000-odd inside the unit ball):
    B2 with ``contract`` and ``want_dx`` against
    ``fused_mlp_backward_plain(want_dx=True)`` by ``explain_dx``'s row rule
    (its planted faults caught: the octave windows, and the contraction's
    two, the Jacobian's ``c (x . dy) x`` term dropped and the angles taken
    at the uncontracted x), its weight gradients bit-equal to the launch
    without dx, dx bit-equal to the contract kernel on the tile kernels'
    planes and, at the rows inside the ball, to B2 without contract; the
    same for an appearance model (APP_DIM codes) with the windows at
    CPOSE_ALPHA; the contracted forward with the windows and with the codes
    against plain, bit-equal inside the ball to the launch without
    contract; B2 with and without dx in turns. The kernel alone
    (``probes/input_grad.py::run_contract``): against plain with the two
    faults, its ms beside the kernel without contract on the same planes,
    the plain version and the torch.mm yardstick, its bound. With
    ``earlier``: the launches without contract (the forward with the
    windows, with the codes; B2 with dx, with the codes and the windows)
    bit-equal to the earlier library's (the SASS: phase 16a)."""
    from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
    from nerf_simple_tpu_torch.probes import input_grad as ig_probe
    from nerf_simple_tpu_torch.probes.wgrad import turns_ms

    model, cm = NerfMLP(), NerfMLP(contract=True)
    am, cam = NerfMLP(app_dim=APP_DIM), NerfMLP(contract=True, app_dim=APP_DIM)
    packed = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(SEED, model), dev))
    packed_app = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(SEED, am), dev, am))
    x = unbounded_batch(dev, scene)[:8].contiguous()
    rows = x.shape[1]
    inside = x[0:3].norm(dim=0) <= 1.0
    rng = np.random.default_rng(SEED)
    codes = torch.from_numpy(rng.normal(0, 0.5, (APP_DIM, rows)).astype(np.float32)).to(dev)
    xa = torch.cat([x, codes, torch.zeros((8 - APP_DIM, rows), device=dev)]).contiguous()
    gT = torch.from_numpy(rng.normal(size=(8, rows)).astype(np.float32)).to(dev)
    enc_w = mlp.anneal_row_weights(cm, CPOSE_ALPHA, dev)
    b2, fwd = mlp.fused_mlp_backward, mlp.fused_mlp_forward
    stats = {}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            w, wa = mlp._cast_weights(packed, dt), mlp._cast_weights(packed_app, dt)
            st = dict(rows=rows, inside_rows=int(inside.sum()))
            for case, (ww, xx, m, um, e) in {"": (w, x, cm, model, None),
                                             "_codes_windows": (wa, xa, cam, am, enc_w)}.items():
                before = (b2.dx_launches, b2.contract_launches, mlp.input_grad_contract_launches(),
                          mlp.input_grad_launches())
                grads, dx = b2(ww, xx, gT, dt, m, want_dx=True, enc_w=e)
                torch.cuda.synchronize()
                check((b2.dx_launches, b2.contract_launches, mlp.input_grad_contract_launches(),
                       mlp.input_grad_launches()) == (before[0] + 1, before[1] + 1, before[2] + 1, before[3] + 1),
                      "B2 with contract and dx counted, its contract input-gradient kernel counted in C")
                alone = b2(ww, xx, gT, dt, m, enc_w=e)
                st[f"bit_equal_no_dx{case}"] = all(torch.equal(a, c) for a, c in zip(grads, alone))
                del alone
                _, res = mlp.forward_residuals(ww, xx, dt, m, enc_w=e)
                gws = mlp.backward_tile(ww, res, gT, dt, m)
                del res
                st[f"dx_equal_composed{case}"] = torch.equal(dx, mlp.input_grad(ww, xx, gws, dt, m, e))
                del gws
                st[f"dx_inside_bit_equal{case}"] = torch.equal(dx[:, inside],
                                                              b2(ww, xx, gT, dt, um, want_dx=True, enc_w=e)[1][:, inside])
                if earlier:
                    g_old, dx_old = earlier_backward(mlp, earlier["fused_mlp_bwd"], ww, xx, gT, dt, um, want_dx=True,
                                                     enc_w=e)
                    g_new, dx_new = b2(ww, xx, gT, dt, um, want_dx=True, enc_w=e)
                    st[f"b2_dx_no_contract_as_earlier{case}"] = dx_as_earlier(dx_new, dx_old, dt) and all(
                        torch.equal(a, c) for a, c in zip(g_old, g_new))
                    del g_old, dx_old, g_new, dx_new
                want, dx_p = mlp.fused_mlp_backward_plain(ww, xx, gT, dt, m, want_dx=True, enc_w=e)
                st[f"rel{case}"], st[f"err{case}"] = grad_errors(grads, want)
                ex = ig_probe.explain_dx(ww, xx, gT, dx, dx_p, dt, m, e, DX_TOL[dt])
                st[f"dx_rows{case}"] = ex
                del grads, dx, want, dx_p
                torch.cuda.empty_cache()
                print(f"B2 contract want_dx{case.replace('_', ' ')} {name} at {rows} rows ({st['inside_rows']} inside "
                      f"the unit ball): grad err {st[f'rel{case}']:.3e} of max (tol {GRAD_TOL['B2', dt]:.0e}); dx rows "
                      f"past {DX_TOL[dt]:.0e} {ex['n_past']} ({ex['share']:.2e}, tol {DX_ROW_SHARE[dt]:.0e}), with a "
                      f"flipped relu mask {ex['n_flipped']}, past without one {ex['n_unexplained']}, on the kernel's "
                      f"own masks {ex['own_masks_err']:.2e}; planted faults: " + ", ".join(
                          f"{k} {f['share']:.2e} past ({f['n_unexplained']} without a flipped mask)"
                          for k, f in ex["faults"].items()) + f"; dx bit-equal to the contract kernel on the kernels' "
                      f"planes: {st[f'dx_equal_composed{case}']}, inside the ball to B2 without contract: "
                      f"{st[f'dx_inside_bit_equal{case}']}; grads bit-equal to the launch without dx: "
                      f"{st[f'bit_equal_no_dx{case}']}" + "".join(f"; {k} {v}" for k, v in st.items()
                                                                   if k.endswith(f"earlier{case}")), flush=True)
                check(st[f"rel{case}"] <= GRAD_TOL["B2", dt] and st[f"dx_equal_composed{case}"]
                      and ex["n_unexplained"] == 0 and ex["own_masks_err"] <= DX_TOL[dt]
                      and ex["share"] <= DX_ROW_SHARE[dt], f"B2 contract want_dx{case} {name} within tolerance")
                check(set(ig_probe.CONTRACT_FAULTS) <= set(ex["faults"])
                      and all(f["n_unexplained"] > 0 for f in ex["faults"].values()),
                      f"the dx rule catches every planted fault, the contraction's two among them ({name}{case})")
                check(st[f"bit_equal_no_dx{case}"] and st[f"dx_inside_bit_equal{case}"]
                      and st.get(f"b2_dx_no_contract_as_earlier{case}", True),
                      f"B2 contract {name}{case}: the grads without dx, the rows inside the ball and the launch "
                      "without contract unchanged")
            # the contracted forward with the windows, with the codes
            for case, (ww, xx, m, um, e) in {"windows": (w, x, cm, model, enc_w),
                                             "codes": (wa, xa, cam, am, None)}.items():
                before = (fwd.contract_launches, fwd.anneal_launches, fwd.app_launches, mlp.contract_launches())
                got = fwd(ww, xx, dt, m, enc_w=e)
                torch.cuda.synchronize()
                check((fwd.contract_launches, fwd.anneal_launches, fwd.app_launches, mlp.contract_launches()) == (
                    before[0] + 1, before[1] + (e is not None), before[2] + (m.app_dim > 0), before[3] + 1),
                      f"the contracted forward with the {case} counted")
                st[f"fwd_{case}_err"] = (got[:4] - mlp.fused_mlp_forward_plain(ww, xx, dt, m, enc_w=e)[:4]).abs().max().item()
                unc = fwd(ww, xx, dt, um, enc_w=e)
                st[f"fwd_{case}_inside_bit_equal"] = torch.equal(got[:, inside], unc[:, inside])
                if earlier:
                    st[f"fwd_{case}_no_contract_bit_equal_earlier"] = torch.equal(
                        unc, earlier_forward(mlp, earlier["fused_mlp_fwd"], ww, xx, dt, um, e))
                del got, unc
                ms = turns_ms({"contract": lambda: fwd(ww, xx, dt, m, enc_w=e), "none": lambda: fwd(ww, xx, dt, um,
                                                                                                    enc_w=e)})
                st[f"fwd_{case}_ms"], st[f"fwd_{case}_none_ms"] = ms["contract"], ms["none"]
                st[f"fwd_{case}_plain_ms"] = cuda_ms(lambda: mlp.fused_mlp_forward_plain(ww, xx, dt, m, enc_w=e),
                                                     reps=3)
                print(f"contracted forward with the {case} {name} at {rows} rows: vs plain {st[f'fwd_{case}_err']:.2e} "
                      f"(tol {TOL[dt]:.0e}), bit-equal inside the ball to the launch without contract: "
                      f"{st[f'fwd_{case}_inside_bit_equal']}; in turns {ms['contract']:.3f} ms, without contract "
                      f"{ms['none']:.3f} ms; plain {st[f'fwd_{case}_plain_ms']:.3f} ms"
                      + "".join(f"; {k} {v}" for k, v in st.items() if k.startswith(f"fwd_{case}")
                                and k.endswith("earlier")), flush=True)
                check(st[f"fwd_{case}_err"] <= TOL[dt] and st[f"fwd_{case}_inside_bit_equal"]
                      and st.get(f"fwd_{case}_no_contract_bit_equal_earlier", True),
                      f"the contracted forward with the {case} ({name}) matches plain, and the launch without contract")
            ms = turns_ms({"dx": lambda: b2(w, x, gT, dt, cm, want_dx=True), "no_dx": lambda: b2(w, x, gT, dt, cm)})
            st.update(ms=ms["dx"], ms_no_dx=ms["no_dx"], plain_ms=cuda_ms(
                lambda: mlp.fused_mlp_backward_plain(w, x, gT, dt, cm, want_dx=True), reps=3))
            print(f"B2 contract {name} in turns: with dx {st['ms']:.3f} ms, without {st['ms_no_dx']:.3f} ms; plain "
                  f"{st['plain_ms']:.3f} ms", flush=True)
            stats[name] = st
            torch.cuda.empty_cache()
    del x, xa, gT, codes
    torch.cuda.empty_cache()
    ig = ig_probe.run_contract(dev)
    for name in ("f32", "bf16"):
        v = ig[name]
        print(f"contract input-gradient kernel alone {name} at {ig['rows']} rows ({ig['inside_rows']} inside the unit "
              f"ball): {v['ms']:.3f} ms (without contract on the same planes {v['point_ms']:.3f} ms), plain "
              f"{v['plain_ms']:.3f} ms, torch.mm yardstick {v['library_ms']:.3f} ms; bound {v['bound_ms']:.3f} ms "
              f"({v['bound_by']}), {100 * v['share_of_bound']:.1f}% of it; dx err {v['rel_err']:.2e} by row group (tol "
              f"{ig_probe.REL_TOL[torch.float32 if name == 'f32' else torch.bfloat16]:.0e}); inside the ball bit-equal "
              f"to the kernel without contract: {v['inside_bit_equal']}; planted faults "
              f"{', '.join(f'{k} {e:.2e}' for k, e in v['fault_err'].items())}", flush=True)
    stats["input_grad"] = ig
    return stats


def c360_pose_config(scene: str, work: str) -> dict:
    """``c360_config`` with configs/colmap360.yaml's pose block switched on,
    cut to C360P_ITERS steps (C360P_WARMUP, C360P_FREEZE)."""
    cfg = c360_config(scene, work)
    cfg.update(exp_name="c360_pose", log_dir=os.path.join(work, "logs_c360_pose"), num_iters=C360P_ITERS,
               ckpt_images=C360P_ITERS, ckpt_model=C360P_FREEZE, steps_per_call=10, pose_opt=True,
               pose_warmup=C360P_WARMUP, pose_freeze_at=C360P_FREEZE)
    return cfg


def phase_pose_contract_train(dev, scene, work, mlp) -> dict:
    """17b. configs/colmap360.yaml's keys with its pose block switched on
    (``c360_pose_config``: contract, disparity, proposal Np 64, distortion
    0.01, pose_opt, the warmup and the freeze cut to the run) through
    train() (bf16, pallas, the flagship) on a copy of the unbounded scene
    whose train poses are perturbed as the pose recipe's
    (``perturb_train_poses``). Before the freeze each step runs the
    contracted forward and B2 with the contract input gradient (counted by
    the wrapper and in C), the proposal net in plain autograd; after it the
    fused 360 core (one contracted B1 launch a step). The loss, the deltas,
    the rig's error before and after (rotations and translations kept);
    the pose step's wall and profile from a fresh state before the freeze;
    then ``evaluate.test`` of train still 0 from the refined rig."""
    import shutil

    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.evaluate import test
    from nerf_simple_tpu_torch.models import model_from_train_config
    from nerf_simple_tpu_torch.train.loop import train
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    pert = os.path.join(work, "unbounded_pose")
    shutil.copytree(scene, pert)
    perturb_train_poses(pert)
    rig_before = rig_error(scene, pert)
    cfg = c360_pose_config(pert, work)
    tcfg = train_config(cfg)
    cm = model_from_train_config(tcfg)
    check(cm.contract and (cm.Lp, cm.Ld, cm.H) == (10, 4, 256) and tcfg.proposal and tcfg.Np == 64
          and tcfg.sampling_space == "disparity" and tcfg.distortion_loss_weight == DIST_LAMBDA and tcfg.pose_opt
          and tcfg.compute_dtype == "bf16", "the 360 recipe's keys with its pose block")
    fwd, b2, b1 = mlp.fused_mlp_forward, mlp.fused_mlp_backward, mlp.fused_train_step
    fwd.launches = fwd.contract_launches = b2.launches = b2.dx_launches = b2.contract_launches = 0
    b1.launches = b1.contract_launches = b1.weights_dist_launches = 0
    mlp.input_grad_launches(reset=True)
    mlp.contract_launches(reset=True)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(forward=fwd.launches, forward_contract=fwd.contract_launches, b2=b2.launches,
                    b2_dx=b2.dx_launches, b2_contract=b2.contract_launches,
                    input_grad_contract=mlp.input_grad_contract_launches(), input_grad=mlp.input_grad_launches(),
                    b1=b1.launches, b1_contract=b1.contract_launches, b1_weights_and_rail=b1.weights_dist_launches,
                    c_contract=mlp.contract_launches())
    text = log.getvalue()
    with open(os.path.join(OUT, "train_c360_pose_log.txt"), "w") as fh:
        fh.write(text)
    exp = os.path.join(work, "models", cfg["exp_name"])
    losses = scalars(cfg["log_dir"], "Loss/train")
    with np.load(os.path.join(exp, "cam_deltas.npz")) as d:
        dr, dt, freeze_step = d["dr"], d["dt"], int(d["freeze_step"])
    rig_after = rig_error(scene, pert, dr, dt)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    kept = {k: rig_after[k] / rig_before[k] for k in ("rot", "trans", "rot_aligned", "trans_aligned")}
    print(f"train 360 recipe + pose: {C360P_ITERS} steps in {train_s:.1f} s with renders; launches {launches}; loss "
          f"(MSE + interlevel + distortion) {first:.5f} -> {last:.5f} (means of the first and last 10); |dr| max "
          f"{np.abs(dr).max():.4f}, |dt| max {np.abs(dt).max():.4f}; the rig's mean error before "
          f"{rig_before['rot']:.4f} rad / {rig_before['trans']:.4f}, after {rig_after['rot']:.4f} rad / "
          f"{rig_after['trans']:.4f} (kept: rotations {kept['rot']:.3f}, translations {kept['trans']:.3f}; aligned as "
          f"a whole {kept['rot_aligned']:.3f} / {kept['trans_aligned']:.3f}); "
          + next(line for line in text.splitlines() if "pose freeze at step" in line), flush=True)
    check(freeze_step == C360P_FREEZE and state.cams is None, "the freeze baked the deltas at pose_freeze_at")
    check(launches["b2_dx"] == launches["b2_contract"] == launches["b2"] == launches["input_grad_contract"]
          == launches["input_grad"] == C360P_FREEZE, "one contracted B2 launch with the contract input gradient a "
          "step before the freeze, counted where it launches")
    check(launches["b1"] == launches["b1_contract"] == launches["b1_weights_and_rail"] == C360P_ITERS - C360P_FREEZE,
          "the fused 360 core (one contracted B1 launch with the weights and the rail a step) after the freeze")
    check(launches["forward_contract"] == launches["forward"] >= C360P_FREEZE
          and launches["c_contract"] == launches["forward_contract"] + launches["b2_contract"] + launches["b1_contract"],
          "the contracted forwards (and the val renders), every contracted launch counted in C")
    check(all(np.isfinite(losses)) and len(losses) == C360P_ITERS and last < first, "the 360 pose loss fell")
    check(np.abs(dr).max() > 0 and np.abs(dt).max() > 0, "the deltas moved")

    rd = RayDataset.from_blender(load_blender(pert, False, UNB_VIEWS[0]), dev)
    rays, pixels = rd.rays["train"], rd.pixels["train"]
    n_pix = rd.H * rd.W
    st = make_train_state(tcfg, cm, dev, n_images=rays.shape[0] // n_pix)
    step_fn = build_train_step(tcfg, cm, rays_per_image=n_pix)

    def step():  # before the freeze: the input gradient on every call
        return step_fn(st, rays, pixels)

    torch.cuda.reset_peak_memory_stats()
    walls = step_walls(step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    others = {}
    prof = profile_step(step, others, split_pose=True, rest="proposal net, rays, sampling and compositing")
    busy = sum(prof.values())
    idle = 1 - busy / walls["ms"] if prof else None
    print(f"train step 360 recipe + pose bf16 (before the freeze): {walls['ms']:.3f} ms a step, "
          f"{BATCH / walls['ms'] * 1e3:,.0f} rays/s (CUDA events over 20 steps, median of 5; runs "
          f"{', '.join(f'{w:.3f}' for w in walls['walls'])}); host issues a step in {walls['host_ms']:.3f} ms; peak "
          f"device memory {peak_gb:.2f} GB; profile, device ms a step: " + (", ".join(
              f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1]))
              + f"; kernels {busy:.3f}, idle share {idle:.3f}" if prof else "not measured"), flush=True)
    del st, step_fn, rd, rays, pixels, state
    torch.cuda.empty_cache()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        test(dict(loadpath=exp, datapath=pert, savepath=os.path.join(work, "eval_c360_pose"), im_set="train",
                  im_idxs=[0], half_res=False, N_samples=N_SAMPLES, Np=tcfg.Np, sampling_space="disparity",
                  tn=UNB_TN, tf=UNB_TF, compute_dtype="bf16", backend="pallas", batch_size=16384))
    eval_s = time.perf_counter() - t0
    psnr = [float(m) for m in re.findall(r"im \d+: mse=\S+ psnr=(\S+)", log.getvalue())]
    print(f"eval 360 recipe + pose: train still 0 from the refined rig (the sidecar): PSNR "
          f"{', '.join(f'{p:.2f}' for p in psnr)} dB in {eval_s:.1f} s", flush=True)
    check(len(psnr) == 1 and np.isfinite(psnr[0]), "the refined 360 still rendered")
    return dict(launches=launches, loss_first=first, loss_last=last, train_s=train_s, rig_before=rig_before,
                rig_after=rig_after, kept=kept, dr_max=float(np.abs(dr).max()), dt_max=float(np.abs(dt).max()),
                step_ms=walls["ms"], host_ms=walls["host_ms"], walls=walls["walls"], profile=prof, idle=idle,
                peak_gb=peak_gb, eval_psnr=psnr[0], eval_s=eval_s, pert=pert)


def phase_app_contract_train(dev, pert, work, mlp) -> dict:
    """17c. Appearance codes on a contracted model through train() (bf16,
    pallas, the flagship): the 360 recipe's keys (``c360_config``, the
    proposal main field) + ``appearance_dim`` APP_DIM + ``pose_opt`` with
    ``pe_anneal_until`` CAPP_ANNEAL (no freeze: JAX's rule with codes),
    CAPP_ITERS steps on the perturbed unbounded scene of 17b: each step the
    contracted forward with the code rows (and the windows until the
    anneal ends) and B2 with the codes and the contract input gradient
    (its KDA slots), counted; no B1. The loss and the code table; then
    ``evaluate.test`` of test still 0 under the mean code."""
    from nerf_simple_tpu_torch.evaluate import test
    from nerf_simple_tpu_torch.train.loop import train

    cfg = c360_config(pert, work)
    cfg.update(exp_name="c360_app", log_dir=os.path.join(work, "logs_c360_app"), num_iters=CAPP_ITERS,
               ckpt_images=10**6, ckpt_model=CAPP_ITERS, steps_per_call=10, appearance_dim=APP_DIM, pose_opt=True,
               pose_warmup=C360P_WARMUP, pe_anneal_until=CAPP_ANNEAL)
    fwd, b2, b1 = mlp.fused_mlp_forward, mlp.fused_mlp_backward, mlp.fused_train_step
    for f in (fwd, b2):
        f.launches = f.contract_launches = f.app_launches = f.anneal_launches = 0
    b2.dx_launches = b1.launches = 0
    mlp.input_grad_launches(reset=True)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(forward=fwd.launches, forward_contract=fwd.contract_launches, forward_app=fwd.app_launches,
                    forward_anneal=fwd.anneal_launches, b2=b2.launches, b2_contract=b2.contract_launches,
                    b2_app=b2.app_launches, b2_anneal=b2.anneal_launches, b2_dx=b2.dx_launches,
                    input_grad_contract=mlp.input_grad_contract_launches(), b1=b1.launches)
    with open(os.path.join(OUT, "train_c360_app_log.txt"), "w") as fh:
        fh.write(log.getvalue())
    losses = scalars(cfg["log_dir"], "Loss/train")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    table = state.app.tables()
    exp = os.path.join(work, "models", cfg["exp_name"])
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        test(dict(loadpath=exp, datapath=pert, savepath=os.path.join(work, "eval_c360_app"), im_idxs=[0],
                  half_res=False, N_samples=N_SAMPLES, Np=NP_PROP, sampling_space="disparity", tn=UNB_TN, tf=UNB_TF,
                  compute_dtype="bf16", backend="pallas", batch_size=16384, appearance_idx=-1))
    psnr = [float(m) for m in re.findall(r"im \d+: mse=\S+ psnr=(\S+)", log.getvalue())]
    print(f"train 360 recipe + appearance_dim {APP_DIM} + pose (anneal to {CAPP_ANNEAL}): {CAPP_ITERS} steps in "
          f"{train_s:.1f} s; launches {launches}; loss {first:.5f} -> {last:.5f} (means of the first and last 10); "
          f"code table |max| {np.abs(table).max():.4f}, spread over images {float(table.std(0).mean()):.4f}; eval "
          f"under the mean code: PSNR {psnr}", flush=True)
    check(launches["b2"] == launches["b2_contract"] == launches["b2_app"] == launches["b2_dx"]
          == launches["input_grad_contract"] == CAPP_ITERS and launches["b2_anneal"] == CAPP_ANNEAL
          and launches["b1"] == 0, "one contracted B2 launch with the codes and the contract input gradient a step "
          "(the windows until the anneal ends), no B1")
    check(launches["forward_contract"] == launches["forward_app"] == launches["forward"] >= CAPP_ITERS
          and launches["forward_anneal"] >= CAPP_ANNEAL, "the contracted forwards with the code rows and the windows")
    check(all(np.isfinite(losses)) and len(losses) == CAPP_ITERS and np.abs(table).max() > 0 and len(psnr) == 1
          and np.isfinite(psnr[0]), "the contracted appearance run trains, its codes move, and it evaluates")
    return dict(launches=launches, loss_first=first, loss_last=last, train_s=train_s,
                code_max=float(np.abs(table).max()), eval_psnr=psnr[0])


# the single nets and the hierarchical pairs of phase 17d: steps, the pose
# freeze of the first run (and the anneal's end of the second), Nc
CNET_ITERS, CNET_FREEZE, CNET_NC = 40, 20, 64
CNET_RUNS = {
    "single + pose (freeze)": dict(pose_opt=True, pose_freeze_at=CNET_FREEZE),
    "single + pose + anneal": dict(pose_opt=True, pe_anneal_until=CNET_FREEZE),
    "single + codes": dict(appearance_dim=APP_DIM),
    "hierarchical + pose": dict(hierarchical=True, Nc=CNET_NC, pose_opt=True),
    "hierarchical + codes + pose": dict(hierarchical=True, Nc=CNET_NC, appearance_dim=APP_DIM, pose_opt=True),
}


def phase_pose_app_contract_nets(dev, pert, work, mlp) -> dict:
    """17d. Pose refinement and appearance codes on a contracted single net
    and hierarchical pair (CNET_RUNS) through train() (bf16, pallas, the
    flagship, Nf 128, 4096 rays) on the perturbed unbounded scene of 17b:
    the 360 recipe's keys (``c360_config``) without the proposal net and the
    distortion, CNET_ITERS steps each. Before a freeze each step is the
    contracted forward (with the windows until the anneal ends, with the
    code rows) and one B2 launch a net with the contract input gradient;
    after the first run's freeze at CNET_FREEZE, one contracted B1 launch a
    step; counted. Each run's loss, then ``evaluate.test`` of one still
    (the refined train still of a pose run, test still 0 under the mean
    code of a codes run). The first run's export served by the CLI server,
    one frame over HTTP matched to ``render_rays_chunked`` to 1 level."""
    from nerf_simple_tpu_torch.evaluate import load_params, test
    from nerf_simple_tpu_torch.models.nerf import NerfField
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked
    from nerf_simple_tpu_torch.serve import decode_png
    from nerf_simple_tpu_torch.train.checkpoint import load_model_meta
    from nerf_simple_tpu_torch.train.loop import train

    fwd, b2, b1 = mlp.fused_mlp_forward, mlp.fused_mlp_backward, mlp.fused_train_step
    out = {}
    for i, (name, kw) in enumerate(CNET_RUNS.items()):
        cfg = c360_config(pert, work)
        cfg.update(exp_name=f"cnet{i}", log_dir=os.path.join(work, f"logs_cnet{i}"), num_iters=CNET_ITERS,
                   ckpt_images=10**6, ckpt_model=CNET_ITERS, steps_per_call=10, proposal=False,
                   distortion_loss_weight=0.0, pose_warmup=C360P_WARMUP, **kw)
        tcfg = train_config(cfg)
        hier, n_nets = tcfg.hierarchical, 2 if tcfg.hierarchical else 1
        fwd.launches = fwd.contract_launches = b2.launches = b2.contract_launches = b2.dx_launches = 0
        b1.launches = b1.contract_launches = 0
        mlp.input_grad_launches(reset=True)
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            train(cfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dict(forward=fwd.launches, forward_contract=fwd.contract_launches, b2=b2.launches,
                        b2_contract=b2.contract_launches, b2_dx=b2.dx_launches,
                        input_grad_contract=mlp.input_grad_contract_launches(), b1=b1.launches,
                        b1_contract=b1.contract_launches)
        with open(os.path.join(OUT, f"train_cnet{i}_log.txt"), "w") as fh:
            fh.write(log.getvalue())
        losses = scalars(cfg["log_dir"], "Loss/train")
        first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
        exp = os.path.join(work, "models", cfg["exp_name"])
        before_freeze = tcfg.pose_freeze_at or CNET_ITERS
        elog = io.StringIO()
        with contextlib.redirect_stdout(elog):
            test(dict(loadpath=exp, datapath=pert, savepath=os.path.join(work, f"eval_cnet{i}"), im_idxs=[0],
                      im_set="test" if tcfg.appearance_dim else "train", half_res=False, N_samples=N_SAMPLES,
                      Nc=CNET_NC if hier else 0, sampling_space="disparity", tn=UNB_TN, tf=UNB_TF,
                      compute_dtype="bf16", backend="pallas", batch_size=16384,
                      **(dict(appearance_idx=-1) if tcfg.appearance_dim else {})))
        psnr = [float(m) for m in re.findall(r"im \d+: mse=\S+ psnr=(\S+)", elog.getvalue())]
        print(f"train {name} + contract: {CNET_ITERS} steps in {train_s:.1f} s; launches {launches}; loss "
              f"{first:.5f} -> {last:.5f} (means of the first and last 10); eval still 0: PSNR {psnr}", flush=True)
        check(launches["b2"] == launches["b2_contract"] == launches["b2_dx"] == launches["input_grad_contract"]
              == n_nets * before_freeze, f"{name}: one contracted B2 launch with the contract input gradient a net "
              "and step before any freeze")
        check(launches["b1"] == launches["b1_contract"] == CNET_ITERS - before_freeze,
              f"{name}: one contracted B1 launch a step after the freeze, none before")
        check(launches["forward_contract"] == launches["forward"] >= n_nets * before_freeze,
              f"{name}: the contracted forwards")
        check(all(np.isfinite(losses)) and len(losses) == CNET_ITERS and len(psnr) == 1 and np.isfinite(psnr[0]),
              f"{name}: every loss finite, the still rendered")
        out[name] = dict(launches=launches, loss_first=first, loss_last=last, train_s=train_s, eval_psnr=psnr[0],
                         exp=exp)

    # the first run's export (a contracted single net, its rig refined and baked) served over HTTP
    exp = out["single + pose (freeze)"]["exp"]
    path = os.path.join(exp, f"params_{CNET_ITERS}.npz")
    focal = scene_focal(pert)
    data, ctype, health, health_after, _ = cli_frame(
        path, focal, ["--tn", str(UNB_TN), "--tf", str(UNB_TF), "--sampling-space", "disparity"],
        "serve_cnet_log.txt", "the contracted pose model's server started")
    field = NerfField.from_jax_params(load_params(path), dev, load_model_meta(path))
    s = RenderSettings(N=N_SAMPLES, tn=UNB_TN, tf=UNB_TF, sampling_space="disparity", backend="pallas",
                       compute_dtype=torch.bfloat16)
    pose = torch.as_tensor(spherical_to_pose(4.5, -30.0, 30.0)[None], dtype=torch.float32, device=dev)
    want = render_rays_chunked(field, rays_for_poses(pose, H, W, focal), 0, s)[0]
    want = (want.reshape(H, W, 3).cpu().numpy() * 255).astype(np.uint8)
    u8_err = int(np.abs(decode_png(data).astype(int) - want.astype(int)).max())
    served = health_after["kernel_launches"] - health["kernel_launches"]
    print(f"served single + pose + contract: a {H}x{W} PNG over HTTP, {served} forward launches, max diff from "
          f"render_rays_chunked {u8_err} levels", flush=True)
    check(field.model.contract and ctype == "image/png" and served > 0 and u8_err <= 1,
          "the served contracted pose model's frame matches render_rays_chunked to 1 level")
    out["served"] = dict(u8_err=u8_err, launches=served)
    return out


# The mip-NeRF 360 composition (phase 18): configs/colmap360.yaml + mip:
# true (the anti-aliased variant its comments describe) with the opaque
# background, cut to M360_ITERS steps; with its pose block, M360P_ITERS
# steps with the freeze at M360P_FREEZE (half the run; the warmup
# C360P_WARMUP); the sub-cases pose + mip + contract (lego_mip.yaml's keys
# on the contracted scene) and pose + mip x proposal (lego_proposal.yaml's
# keys + mip on the phase-7 scene), M360S_ITERS steps each.
M360_ITERS, M360P_ITERS, M360P_FREEZE, M360S_ITERS = 60, 40, 20, 20


def phase_mip360_kernels(dev, scene, mlp, earlier) -> dict:
    """18a. The input gradient's ``MIP && CONTRACT`` instantiation
    (csrc/fused_contract.cu), nets from numpy seed SEED, f32 and bf16, at
    the unbounded batch under mip (``unbounded_batch(mip=True)``: 524,288
    frustum Gaussians, their means on both sides of the unit sphere): B2
    with mip, ``contract`` and ``want_dx`` against
    ``fused_mlp_backward_plain`` by ``explain_dx``'s row rule, its weight
    gradients bit-equal to the launch without dx, dx bit-equal to the
    kernel on the tile kernels' planes and, at the rows inside the ball,
    to B2 with mip without contract; B2 with and without dx in turns. The
    kernel alone (``probes/input_grad.py::run_mip_contract`` on the batch):
    against plain within MIP_CONTRACT_TOL, its three planted faults past
    it (the coupled transpose's ``term_n`` dropped, its rank-one coupling
    dropped, the angles and damps uncontracted), its ms in turns beside the
    ``MIP`` kernel on the same planes, the plain version and the torch.mm
    yardstick, its bound. With ``earlier``: B2 with mip and dx without
    contract bit-equal to the earlier library's."""
    from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
    from nerf_simple_tpu_torch.probes import input_grad as ig_probe
    from nerf_simple_tpu_torch.probes.wgrad import turns_ms

    model, cm = NerfMLP(), NerfMLP(contract=True)
    packed = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(SEED, model), dev))
    x = unbounded_batch(dev, scene, mip=True)
    rows = x.shape[1]
    inside = x[0:3].norm(dim=0) <= 1.0
    gT = torch.from_numpy(np.random.default_rng(SEED).normal(size=(8, rows)).astype(np.float32)).to(dev)
    b2 = mlp.fused_mlp_backward
    stats = {}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            w = mlp._cast_weights(packed, dt)
            st = dict(rows=rows, inside_rows=int(inside.sum()))

            def counts():
                return (b2.dx_launches, b2.mip_dx_launches, b2.contract_launches,
                        mlp.input_grad_mip_contract_launches(), mlp.input_grad_mip_launches())

            before = counts()
            grads, dx = b2(w, x, gT, dt, cm, mip=True, want_dx=True)
            torch.cuda.synchronize()
            check(counts() == tuple(n + 1 for n in before), "B2 with mip, contract and dx counted, its MIP && "
                  "CONTRACT input-gradient kernel counted in C")
            alone = b2(w, x, gT, dt, cm, mip=True)
            st["bit_equal_no_dx"] = all(torch.equal(a, c) for a, c in zip(grads, alone))
            del alone
            _, res = mlp.forward_residuals(w, x, dt, cm, mip=True)
            gws = mlp.backward_tile(w, res, gT, dt, cm)
            del res
            st["dx_equal_composed"] = torch.equal(dx, mlp.input_grad(w, x, gws, dt, cm, mip=True))
            del gws
            st["dx_inside_bit_equal"] = torch.equal(dx[:, inside], b2(w, x, gT, dt, model, mip=True,
                                                                       want_dx=True)[1][:, inside])
            if earlier:
                g_old, dx_old = earlier_backward(mlp, earlier["fused_mlp_bwd"], w, x, gT, dt, model, want_dx=True,
                                                 mip=True)
                g_new, dx_new = b2(w, x, gT, dt, model, mip=True, want_dx=True)
                st["b2_mip_dx_no_contract_as_earlier"] = dx_as_earlier(dx_new, dx_old, dt, mip=True) and all(
                    torch.equal(a, c) for a, c in zip(g_old, g_new))
                del g_old, dx_old, g_new, dx_new
            want, dx_p = mlp.fused_mlp_backward_plain(w, x, gT, dt, cm, mip=True, want_dx=True)
            st["rel"], st["err"] = grad_errors(grads, want)
            ex = ig_probe.explain_dx(w, x, gT, dx, dx_p, dt, cm, None, DX_TOL[dt], mip=True)
            st["dx_rows"] = ex
            del grads, dx, want, dx_p
            torch.cuda.empty_cache()
            print(f"B2 mip + contract want_dx {name} at {rows} rows ({st['inside_rows']} inside the unit ball): grad "
                  f"err {st['rel']:.3e} of max (tol {GRAD_TOL['B2', dt]:.0e}); dx rows past {DX_TOL[dt]:.0e} "
                  f"{ex['n_past']} ({ex['share']:.2e}, tol {DX_ROW_SHARE[dt]:.0e}), with a flipped relu mask "
                  f"{ex['n_flipped']}, past without one {ex['n_unexplained']}, on the kernel's own masks "
                  f"{ex['own_masks_err']:.2e}; planted faults: " + ", ".join(
                      f"{k} {f['share']:.2e} past ({f['n_unexplained']} without a flipped mask)"
                      for k, f in ex["faults"].items()) + f"; dx bit-equal to the MIP && CONTRACT kernel on the "
                  f"kernels' planes: {st['dx_equal_composed']}, inside the ball to B2 with mip without contract: "
                  f"{st['dx_inside_bit_equal']}; grads bit-equal to the launch without dx: {st['bit_equal_no_dx']}"
                  + "".join(f"; {k} {v}" for k, v in st.items() if k.endswith("earlier")), flush=True)
            check(st["rel"] <= GRAD_TOL["B2", dt] and st["dx_equal_composed"] and ex["n_unexplained"] == 0
                  and ex["own_masks_err"] <= DX_TOL[dt] and ex["share"] <= DX_ROW_SHARE[dt],
                  f"B2 mip + contract want_dx {name} within tolerance")
            # bf16's row rule (DX_TOL 5e-3) is wider than term_n's move at these frustums; the kernel alone
            # below holds all three faults at MIP_CONTRACT_TOL in both types, and B2's dx is that kernel's
            check(set(ig_probe.MIP_CONTRACT_FAULTS) <= set(ex["faults"]) and (dt == torch.bfloat16 or all(
                f["n_unexplained"] > 0 for f in ex["faults"].values())),
                  f"the f32 dx rule catches every planted fault, the coupled transpose's three among them ({name})")
            check(st["bit_equal_no_dx"] and st["dx_inside_bit_equal"]
                  and st.get("b2_mip_dx_no_contract_as_earlier", True),
                  f"B2 mip + contract {name}: the grads without dx, the rows inside the ball and the launch without "
                  "contract unchanged")
            ms = turns_ms({"dx": lambda: b2(w, x, gT, dt, cm, mip=True, want_dx=True),
                           "no_dx": lambda: b2(w, x, gT, dt, cm, mip=True)})
            st.update(ms=ms["dx"], ms_no_dx=ms["no_dx"])
            print(f"B2 mip + contract {name} in turns: with dx {st['ms']:.3f} ms, without {st['ms_no_dx']:.3f} ms",
                  flush=True)
            stats[name] = st
            torch.cuda.empty_cache()
    del gT
    torch.cuda.empty_cache()
    ig = ig_probe.run_mip_contract(dev, x=x)
    del x
    torch.cuda.empty_cache()
    for name in ("f32", "bf16"):
        v = ig[name]
        print(f"MIP && CONTRACT input-gradient kernel alone {name} at {ig['rows']} rows of the unbounded batch "
              f"({ig['inside_rows']} inside the unit ball): {v['ms']:.3f} ms (the MIP kernel on the same planes "
              f"{v['mip_ms']:.3f} ms), plain {v['plain_ms']:.3f} ms, torch.mm yardstick {v['library_ms']:.3f} ms; bound "
              f"{v['bound_ms']:.3f} ms ({v['bound_by']}), {100 * v['share_of_bound']:.1f}% of it; dx err "
              f"{v['rel_err']:.2e} by row group (tol {ig_probe.MIP_CONTRACT_TOL:.0e}); inside the ball bit-equal to "
              f"the MIP kernel: {v['inside_bit_equal']}; planted faults "
              f"{', '.join(f'{k} {e:.2e}' for k, e in v['fault_err'].items())}", flush=True)
    stats["input_grad"] = ig
    return stats


def m360_config(scene: str, work: str, **kw) -> dict:
    """configs/colmap360.yaml's keys (``c360_config``) with ``mip: true``
    and the opaque background, M360_ITERS steps, and ``kw``."""
    cfg = c360_config(scene, work)
    cfg.update(exp_name="m360", log_dir=os.path.join(work, "logs_m360"), num_iters=M360_ITERS, ckpt_images=10**6,
               ckpt_model=M360_ITERS, steps_per_call=10, mip=True, opaque_background=True)
    cfg.update(kw)
    return cfg


def phase_mip360_train(dev, scene, work, mlp) -> dict:
    """18b. configs/colmap360.yaml + ``mip: true`` with the opaque background
    (``m360_config``: contract, disparity, proposal Np 64, distortion 0.01)
    through train() (bf16, pallas, the flagship) on the unbounded scene,
    M360_ITERS steps: the fused mip x proposal core, one contracted
    cone-cast B1 launch a step with the weights output, the interval rail
    and the opaque tail, counted; the loss falls. The step's wall and
    profile (B1, proposal matmuls, before / after B1, Adam) and idle share
    from a fresh state; ``evaluate.test`` of test still 0 (Np 64, mip);
    one frame served by ``python -m nerf_simple_tpu_torch.serve --mip
    --opaque-background --proposal-samples 64`` in a process of its own,
    matched to ``render_rays_chunked`` to 1 level."""
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.evaluate import load_params, test
    from nerf_simple_tpu_torch.models import model_from_train_config
    from nerf_simple_tpu_torch.models.proposal import ProposalPair, infer_proposal_arch
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked
    from nerf_simple_tpu_torch.serve import decode_png
    from nerf_simple_tpu_torch.train.checkpoint import load_model_meta
    from nerf_simple_tpu_torch.train.loop import train
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    cfg = m360_config(scene, work)
    tcfg = train_config(cfg)
    cm = model_from_train_config(tcfg)
    check(cm.contract and (cm.Lp, cm.Ld, cm.H) == (10, 4, 256) and tcfg.mip and tcfg.mip_levels == 1
          and tcfg.proposal and tcfg.Np == NP_PROP and tcfg.opaque_background and tcfg.sampling_space == "disparity"
          and tcfg.distortion_loss_weight == DIST_LAMBDA and tcfg.compute_dtype == "bf16",
          "configs/colmap360.yaml's keys + mip (the anti-aliased variant) + the opaque background")
    b1 = mlp.fused_train_step
    b1.launches = b1.mip_launches = b1.weights_dist_launches = b1.opaque_launches = b1.contract_launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        train(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(b1=b1.launches, mip=b1.mip_launches, weights_and_rail=b1.weights_dist_launches,
                    opaque=b1.opaque_launches, contract=b1.contract_launches)
    with open(os.path.join(OUT, "train_m360_log.txt"), "w") as fh:
        fh.write(log.getvalue())
    losses = scalars(cfg["log_dir"], "Loss/train")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"train 360 recipe + mip (opaque background): {M360_ITERS} steps in {train_s:.1f} s; B1 launches "
          f"{launches}; loss (MSE + interval interlevel + interval distortion) {first:.5f} -> {last:.5f} (means of "
          f"the first and last 10)", flush=True)
    check(all(v == M360_ITERS for v in launches.values()), "one contracted cone-cast B1 launch a step with the "
          "weights output, the interval rail and the opaque tail")
    check(all(np.isfinite(losses)) and len(losses) == M360_ITERS and last < first, "the mip x proposal loss fell")

    rd = RayDataset.from_blender(load_blender(scene, False, UNB_VIEWS[0]), dev)
    focal = scene_focal(scene, UNB_HW)
    st = make_train_state(tcfg, cm, dev)
    step_fn = build_train_step(tcfg, cm, base_radius=mip_radius(focal))

    def step():
        return step_fn(st, rd.rays["train"], rd.pixels["train"])

    walls = step_walls(step)
    prof = profile_step(step, split_proposal=True)
    busy = sum(prof.values())
    idle = 1 - busy / walls["ms"] if prof else None
    print(f"train step 360 recipe + mip bf16: {walls['ms']:.3f} ms a step, {BATCH / walls['ms'] * 1e3:,.0f} rays/s "
          f"(CUDA events over 20 steps, median of 5; runs {', '.join(f'{w:.3f}' for w in walls['walls'])}); host "
          f"issues a step in {walls['host_ms']:.3f} ms; profile, device ms a step: " + (", ".join(
              f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1]))
              + f"; kernels {busy:.3f}, idle share {idle:.3f}" if prof else "not measured"), flush=True)
    del st, step_fn, rd
    torch.cuda.empty_cache()

    exp = os.path.join(work, "models", cfg["exp_name"])
    elog = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(elog):
        test(dict(loadpath=exp, datapath=scene, savepath=os.path.join(work, "eval_m360"), im_idxs=[0],
                  half_res=False, N_samples=N_SAMPLES, Np=NP_PROP, mip=True, opaque_background=True,
                  sampling_space="disparity", tn=UNB_TN, tf=UNB_TF, compute_dtype="bf16", backend="pallas",
                  batch_size=16384))
    eval_s = time.perf_counter() - t0
    psnr = [float(m) for m in re.findall(r"im \d+: mse=\S+ psnr=(\S+)", elog.getvalue())]
    check(len(psnr) == 1 and np.isfinite(psnr[0]), "the mip x proposal still rendered")

    path = os.path.join(exp, f"params_{M360_ITERS}.npz")
    served_focal = scene_focal(scene)  # at the served frame's W
    data, ctype, health, health_after, http_ms = cli_frame(
        path, served_focal, ["--mip", "--opaque-background", "--proposal-samples", str(NP_PROP), "--tn",
                             str(UNB_TN), "--tf", str(UNB_TF), "--sampling-space", "disparity"],
        "serve_m360_log.txt", "the mip x proposal server started")
    meta, params = load_model_meta(path), load_params(path, keep_hierarchy=True)
    pair = ProposalPair.from_jax_params(params, dev, meta, dataclasses.replace(infer_proposal_arch(params["prop"]),
                                                                               contract=meta.contract))
    s = RenderSettings(N=N_SAMPLES, N_prop=NP_PROP, mip=True, opaque_background=True,
                       base_radius=mip_radius(served_focal), tn=UNB_TN, tf=UNB_TF, sampling_space="disparity",
                       backend="pallas", compute_dtype=torch.bfloat16)
    pose = torch.as_tensor(spherical_to_pose(4.5, -30.0, 30.0)[None], dtype=torch.float32, device=dev)
    want = render_rays_chunked(pair, rays_for_poses(pose, H, W, served_focal), 0, s)[0]
    want = (want.reshape(H, W, 3).cpu().numpy() * 255).astype(np.uint8)
    u8_err = int(np.abs(decode_png(data).astype(int) - want.astype(int)).max())
    served = health_after["kernel_launches"] - health["kernel_launches"]
    print(f"eval 360 recipe + mip: test still 0 PSNR {psnr[0]:.2f} dB in {eval_s:.1f} s (evaluate.test wall); served "
          f"by the CLI with --mip --proposal-samples {NP_PROP}: a {H}x{W} PNG in {http_ms:.1f} ms, {served} forward "
          f"launches, max diff from render_rays_chunked {u8_err} levels; /health mip {health.get('mip')}, proposal "
          f"{health.get('proposal')}", flush=True)
    check(ctype == "image/png" and health.get("mip") is True and health.get("proposal") is True and served > 0
          and pair.fine.model.contract and pair.prop.model.contract and u8_err <= 1,
          "the served (contracted) mip x proposal frame matches render_rays_chunked to 1 level")
    return dict(launches=launches, loss_first=first, loss_last=last, train_s=train_s, step_ms=walls["ms"],
                host_ms=walls["host_ms"], walls=walls["walls"], profile=prof, idle=idle, eval_psnr=psnr[0],
                eval_s=eval_s, served_u8_err=u8_err, served_launches=served, http_ms=http_ms)


def _m360_run(cfg: dict, mlp, name: str) -> tuple[dict, list]:
    """train(cfg) with the launch counts of the forward, B2 (with mip, dx,
    contract), the input gradient (its MIP && CONTRACT instantiation in C)
    and B1 reset first; (the counts, the losses)."""
    from nerf_simple_tpu_torch.train.loop import train

    fwd, b2, b1 = mlp.fused_mlp_forward, mlp.fused_mlp_backward, mlp.fused_train_step
    fwd.launches = fwd.mip_launches = b2.launches = b2.mip_dx_launches = b2.contract_launches = 0
    b1.launches = b1.mip_launches = b1.contract_launches = 0
    mlp.input_grad_launches(reset=True)
    mlp.input_grad_mip_launches(reset=True)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        train(cfg)
    torch.cuda.synchronize()
    with open(os.path.join(OUT, f"train_{cfg['exp_name']}_log.txt"), "w") as fh:
        fh.write(log.getvalue())
    launches = dict(forward_mip=fwd.mip_launches, b2=b2.launches, b2_mip_dx=b2.mip_dx_launches,
                    b2_contract=b2.contract_launches, input_grad_mip=mlp.input_grad_mip_launches(),
                    input_grad_mip_contract=mlp.input_grad_mip_contract_launches(), b1=b1.launches,
                    b1_mip=b1.mip_launches, b1_contract=b1.contract_launches)
    losses = scalars(cfg["log_dir"], "Loss/train")
    freeze = [line for line in log.getvalue().splitlines() if "pose freeze at step" in line]
    print(f"train {name}: {cfg['num_iters']} steps; launches {launches}; loss {np.mean(losses[:5]):.5f} -> "
          f"{np.mean(losses[-5:]):.5f} (means of the first and last 5)" + (f"; {freeze[0]}" if freeze else ""),
          flush=True)
    check(all(np.isfinite(losses)) and len(losses) == cfg["num_iters"], f"{name}: every loss finite")
    return launches, losses


def phase_mip360_pose(dev, scene, pert, work, mlp) -> dict:
    """18c-d. Pose refinement on the composition, through train() (bf16,
    pallas, the flagship): (c) ``m360_config`` + configs/colmap360.yaml's
    pose block on the perturbed unbounded scene of 17b, M360P_ITERS steps,
    the freeze at M360P_FREEZE: before it one contracted mip forward, one
    B2 with mip, contract and dx, one MIP && CONTRACT input-gradient
    launch a step (counted in C), after it one contracted cone-cast B1 a
    step; the pose step's wall and profile from a fresh state before the
    freeze. (d) M360S_ITERS steps each of pose + mip + contract
    (configs/lego_mip.yaml's keys, two levels, with contract on the
    perturbed scene: two B2 with dx and two MIP && CONTRACT launches a
    step) and of pose + mip x proposal without contract
    (configs/lego_proposal.yaml's keys + mip on the phase-7 scene: one B2
    with the MIP input gradient a step)."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.models import model_from_train_config
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    out = {}
    cfg = m360_config(pert, work, exp_name="m360_pose", log_dir=os.path.join(work, "logs_m360_pose"),
                      num_iters=M360P_ITERS, ckpt_model=M360P_FREEZE, pose_opt=True, pose_warmup=C360P_WARMUP,
                      pose_freeze_at=M360P_FREEZE)
    launches, losses = _m360_run(cfg, mlp, "360 recipe + mip + its pose block")
    n = M360P_FREEZE
    check(launches["b2_mip_dx"] == launches["b2_contract"] == launches["b2"] == launches["input_grad_mip"]
          == launches["input_grad_mip_contract"] == n, "one B2 launch with mip, contract and dx a step before the "
          "freeze, its MIP && CONTRACT input gradient counted in C")
    check(launches["b1"] == launches["b1_mip"] == launches["b1_contract"] == M360P_ITERS - n,
          "the fused mip x proposal core (one contracted cone-cast B1 launch a step) after the freeze")
    check(launches["forward_mip"] >= n, "the contracted mip forwards before the freeze")
    tcfg = train_config(cfg)
    cm = model_from_train_config(tcfg)
    rd = RayDataset.from_blender(load_blender(pert, False, UNB_VIEWS[0]), dev)
    n_pix = rd.H * rd.W
    st = make_train_state(tcfg, cm, dev, n_images=rd.rays["train"].shape[0] // n_pix)
    step_fn = build_train_step(tcfg, cm, rays_per_image=n_pix, base_radius=mip_radius(rd.f))

    def step():  # before the freeze: the MIP && CONTRACT input gradient on every call
        return step_fn(st, rd.rays["train"], rd.pixels["train"])

    walls = step_walls(step)
    prof = profile_step(step, split_pose=True, rest="proposal net, frustums, sampling and compositing")
    busy = sum(prof.values())
    idle = 1 - busy / walls["ms"] if prof else None
    print(f"train step 360 recipe + mip + pose bf16 (before the freeze): {walls['ms']:.3f} ms a step (CUDA events "
          f"over 20 steps, median of 5; runs {', '.join(f'{w:.3f}' for w in walls['walls'])}); host issues a step in "
          f"{walls['host_ms']:.3f} ms; profile, device ms a step: " + (", ".join(
              f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1]))
              + f"; kernels {busy:.3f}, idle share {idle:.3f}" if prof else "not measured"), flush=True)
    out["pose"] = dict(launches=launches, loss_first=float(np.mean(losses[:5])),
                       loss_last=float(np.mean(losses[-5:])), step_ms=walls["ms"], host_ms=walls["host_ms"],
                       walls=walls["walls"], profile=prof, idle=idle)
    del st, step_fn, rd
    torch.cuda.empty_cache()

    mcfg = load_yaml("configs/lego_mip.yaml")
    mcfg.pop("test_params")
    mcfg.update(datapath=pert, savepath=os.path.join(work, "models"), log_dir=os.path.join(work, "logs_m360_mc"),
                exp_name="m360_mc", contract=True, sampling_space="disparity", tn=UNB_TN, tf=UNB_TF, half_res=False,
                num_train_imgs=UNB_VIEWS[0], num_iters=M360S_ITERS, ckpt_loss=1, ckpt_images=10**6,
                ckpt_model=M360S_ITERS, steps_per_call=10, pose_opt=True, pose_warmup=C360P_WARMUP)
    levels = mcfg["mip_levels"]
    launches, losses = _m360_run(mcfg, mlp, f"pose + mip ({levels} levels) + contract")
    check(launches["b2_mip_dx"] == launches["b2_contract"] == launches["input_grad_mip_contract"]
          == levels * M360S_ITERS and launches["b1"] == 0, "pose + mip + contract: one B2 launch with the MIP && "
          "CONTRACT input gradient a level and step, no B1")
    out["pose_mip_contract"] = dict(launches=launches, loss_first=float(np.mean(losses[:5])),
                                    loss_last=float(np.mean(losses[-5:])))

    pcfg = load_yaml("configs/lego_proposal.yaml")
    pcfg.pop("test_params")
    pcfg.update(datapath=scene, savepath=os.path.join(work, "models"), log_dir=os.path.join(work, "logs_m360_mp"),
                exp_name="m360_mp", mip=True, num_iters=M360S_ITERS, ckpt_loss=1, ckpt_images=10**6,
                ckpt_model=M360S_ITERS, steps_per_call=10, pose_opt=True, pose_warmup=C360P_WARMUP)
    launches, losses = _m360_run(pcfg, mlp, "pose + mip x proposal")
    check(launches["b2_mip_dx"] == launches["input_grad_mip"] == M360S_ITERS and launches["b2_contract"] == 0
          and launches["input_grad_mip_contract"] == 0 and launches["b1"] == 0, "pose + mip x proposal: one B2 "
          "launch with the MIP input gradient a step, no B1")
    out["pose_mip_proposal"] = dict(launches=launches, loss_first=float(np.mean(losses[:5])),
                                    loss_last=float(np.mean(losses[-5:])))
    return out


# Multiscale training (mip-NeRF sec. 4; configs/lego_mip.yaml + mip_multiscale): the run's steps on phase 7's
# scene's pyramid, cut from lego's 10,000 as phase 12's mip run; mip x proposal on the pyramid and each data
# option (a tiny_nerf npz, the hard scene) train DATA_ITERS steps: enough to show the path runs on the card and the
# loss moves, not to converge.
MS_ITERS, DATA_ITERS = 100, 20


def phase_multiscale_kernels(dev, scene, mlp) -> dict:
    """19a. B1's cone-cast launch on one training batch drawn from the
    pyramid of phase 7's scene (``multiscale_train_arrays``: 25 views at
    400x400, 200x200, 100x100 and 50x50; 4096 rays, every scale present,
    x N_SAMPLES intervals, 524,288 rows; each ray's own cone in rows
    11..13, its area weight on row 14), the flagship from
    ``derive_seed(SEED, 0)``, f32 and bf16, against its plain version
    (loss and gradients to B1's bounds); the same batch with row 14 at 1
    (the loss the weights change), and at twice the weights (the loss and
    each gradient twice theirs, to B1's bounds): the weight reaches the
    loss. ms of each (CUDA events, median of 5) and the plain version's."""
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import MULTISCALE_SCALES, multiscale_train_arrays, sample_ray_batch
    from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
    from nerf_simple_tpu_torch.ops.sampling import stratified_ts
    from nerf_simple_tpu_torch.render.renderer import derive_seed
    from nerf_simple_tpu_torch.train.step import build_x16_mip

    model = NerfMLP()
    radius = mip_radius(scene_focal(scene))
    t0 = time.perf_counter()
    rays, pixels = multiscale_train_arrays(load_blender(scene, True, 25), radius, dev)
    torch.cuda.synchronize()
    pool_s = time.perf_counter() - t0
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 19)
    rays_b, pix_b = sample_ray_batch(g, rays, pixels, BATCH)
    scale = torch.round(rays_b[:, 6] / radius).to(torch.int64)
    per_scale = {s: int((scale == s).sum()) for s in MULTISCALE_SCALES}
    check(rays.shape[1] == 8 and min(per_scale.values()) > 0 and sum(per_scale.values()) == BATCH,
          "the batch draws 8-column rays of every scale")
    edges = stratified_ts(g, BATCH, N_SAMPLES + 1, 2.0, 6.0, dev)
    x16 = build_x16_mip(rays_b, edges, pix_b, radius)
    scalar = build_x16_mip(rays_b[:, :6], edges, pix_b, radius)
    check(torch.equal(x16[:11], scalar[:11]) and not torch.equal(x16[11:14], scalar[11:14]),
          "rows 11..13 carry each ray's own cone")
    check(float(x16[14].min()) < 1.0 < float(x16[14].max()), "row 14 carries the area weights")
    del scalar
    x_one, x_two = x16.clone(), x16.clone()
    x_one[14] = 1.0
    x_two[14] *= 2.0
    packed = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(derive_seed(SEED, 0), model), dev))
    stats = dict(rows=x16.shape[1], pool_rays=rays.shape[0], per_scale=per_scale, pool_s=pool_s)
    del rays, pixels
    b1, plain = mlp.fused_train_step, mlp.fused_train_step_plain
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            w = mlp._cast_weights(packed, dt)
            before = (b1.launches, b1.mip_launches)
            out = b1(w, x16, N_SAMPLES, dt, model, mip=True)
            torch.cuda.synchronize()
            launched = (b1.launches - before[0], b1.mip_launches - before[1])
            want = plain(w, x16, N_SAMPLES, dt, model, mip=True)
            check(all(bool(torch.isfinite(t).all()) for t in out[1]), f"B1 multiscale {name} finite")
            rel, abs_err = grad_errors(out[1], want[1])
            loss_err = abs(out[0].item() / want[0].item() - 1)
            one, one_p = b1(w, x_one, N_SAMPLES, dt, model, mip=True), plain(w, x_one, N_SAMPLES, dt, model, mip=True)
            rel_one = grad_errors(one[1], one_p[1])[0]
            loss_one_err = abs(one[0].item() / one_p[0].item() - 1)
            two = b1(w, x_two, N_SAMPLES, dt, model, mip=True)
            two_loss_err = abs(two[0].item() / (2 * out[0].item()) - 1)
            two_rel = grad_errors(two[1], [2 * t for t in out[1]])[0]
            st = dict(err=abs_err, rel=rel, loss_err=loss_err, loss=out[0].item(), loss_plain=want[0].item(),
                      loss_one=one[0].item(), loss_one_plain=one_p[0].item(), rel_one=rel_one,
                      loss_one_err=loss_one_err, two_loss_err=two_loss_err, two_rel=two_rel,
                      weights_move_loss=abs(out[0].item() / one[0].item() - 1))
            del out, want, one, one_p, two
            torch.cuda.empty_cache()
            st.update(ms=cuda_ms(lambda: b1(w, x16, N_SAMPLES, dt, model, mip=True)),
                      ms_one=cuda_ms(lambda: b1(w, x_one, N_SAMPLES, dt, model, mip=True)),
                      plain_ms=cuda_ms(lambda: plain(w, x16, N_SAMPLES, dt, model, mip=True), reps=3))
            torch.cuda.empty_cache()
            print(f"B1 multiscale vs plain {name} at {stats['rows']} rows of the pyramid (rays a scale {per_scale}): grad "
                  f"err {rel:.3e} of max (tol {GRAD_TOL['B1', dt]:.0e}), loss rel err {loss_err:.2e} (tol "
                  f"{LOSS_TOL[dt]:.0e}); loss {st['loss']:.6f} with the area weights, {st['loss_one']:.6f} with row 14 "
                  f"at 1 (kernel vs plain {loss_one_err:.2e}, grads {rel_one:.3e}); twice the weights: loss x2 within "
                  f"{two_loss_err:.2e}, grads within {two_rel:.3e} of max; kernel {st['ms']:.3f} ms (row 14 at 1: "
                  f"{st['ms_one']:.3f}), plain {st['plain_ms']:.3f} ms; launches (all, mip) {launched}", flush=True)
            check(launched == (1, 1), f"B1 multiscale {name} counted as a cone-cast launch")
            check(rel <= GRAD_TOL["B1", dt] and loss_err <= LOSS_TOL[dt], f"B1 multiscale {name} within B1's bounds")
            check(rel_one <= GRAD_TOL["B1", dt] and loss_one_err <= LOSS_TOL[dt],
                  f"B1 with row 14 at 1 {name} within B1's bounds")
            check(two_loss_err <= LOSS_TOL[dt] and two_rel <= GRAD_TOL["B1", dt],
                  f"twice the weights give twice the loss and gradients ({name})")
            stats[name] = st
    stats["pool_MB"] = stats["pool_rays"] * 11 * 4 / 1e6
    print(f"multiscale pool: {stats['pool_rays']:,} rays (8 columns) and their colours built in {pool_s:.2f} s "
          f"(scene loaded and the block means included)", flush=True)
    return stats


def psnr_at_scales(field, scene: str, dev, radius: float) -> dict:
    """PSNR of test image 0 of the scene rendered at 1, 1/2, 1/4 and 1/8 of
    400x400 (block-centred rays, each scale's cone ``s * radius`` in their
    column 6, column 7 unread; two mip levels, bf16, pallas) against the
    block means of its gt."""
    from nerf_simple_tpu_torch.data.blender import block_mean, load_blender
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses_scaled
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked
    from nerf_simple_tpu_torch.train.metrics import img_psnr

    data = load_blender(scene, True, 1)
    gt, pose = data.splits["test"].images[0], torch.as_tensor(data.splits["test"].poses[:1], device=dev)
    s_ = RenderSettings(N=N_SAMPLES, backend="pallas", compute_dtype=torch.bfloat16, mip=True, mip_levels=2,
                        base_radius=radius)
    out = {}
    for s in (1, 2, 4, 8):
        rays = rays_for_poses_scaled(pose, data.H, data.W, data.f, s)
        rays = torch.cat([rays, torch.tensor([s * radius, 1.0], device=dev).expand(rays.shape[0], 2)], 1)
        rgb, _ = render_rays_chunked(field, rays, 0, s_, chunk=CHUNK)
        want = gt if s == 1 else block_mean(gt, s)
        out[s] = float(img_psnr(want[None], rgb.reshape(1, *want.shape).cpu().numpy()))
    return out


def phase_multiscale_train(dev, scene, work, mlp, mip_exp: str) -> dict:
    """19b. configs/lego_mip.yaml + mip_multiscale: true through train() on
    phase 7's scene (bf16, pallas, two levels, MS_ITERS steps): the sampler
    draws from the 4-scale pool (5.3 M 8-column rays); two cone-cast B1
    launches a step, the coarse with the weights output, the sums and the
    backward tile kernel counted in C; the loss falls. The step's wall
    (CUDA events), the host's issue time, kernel ms by pass (coarse B1,
    fine B1, before / between / after, Adam) and the idle share. Test
    image 0 at the four scales against block-mean gt, beside phase 12's
    single-scale mip model (300 + 100 steps) at the same scales. Then
    DATA_ITERS steps of mip x proposal on the pyramid (lego_proposal.yaml
    + mip, the opaque background and distortion DIST_LAMBDA): one
    cone-cast launch a step with the weights output, the rail and the
    opaque tail."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import multiscale_train_arrays
    from nerf_simple_tpu_torch.evaluate import load_params
    from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP
    from nerf_simple_tpu_torch.train.loop import train
    from nerf_simple_tpu_torch.train.step import build_train_step

    cfg = load_yaml("configs/lego_mip.yaml")
    cfg.update(datapath=scene, savepath=os.path.join(work, "models"), exp_name="lego_mip_ms", mip_multiscale=True,
               log_dir=os.path.join(work, "logs_mip_ms"), num_iters=MS_ITERS, ckpt_loss=1, ckpt_images=10 * MS_ITERS,
               ckpt_model=MS_ITERS, steps_per_call=50)
    b1 = mlp.fused_train_step
    counts = ("launches", "weights_launches", "mip_launches", "opaque_launches", "dist_launches")
    for c in counts:
        setattr(b1, c, 0)
    mlp.wgrad_sums_launches(reset=True)
    mlp.bwd_tile_launches(reset=True)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {c: getattr(b1, c) for c in counts}
    launches.update(wgrad_sums=mlp.wgrad_sums_launches(), bwd_tile=mlp.bwd_tile_launches())
    with open(os.path.join(OUT, "train_mip_ms_log.txt"), "w") as fh:
        fh.write(log.getvalue())
    losses = scalars(cfg["log_dir"], "Loss/train")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"train multiscale (lego_mip.yaml + mip_multiscale): {MS_ITERS} steps in {train_s:.1f} s with the pool's "
          f"build and the step-0 renders; launches {launches}; mean loss (area-weighted, 0.1 coarse + fine) of the "
          f"first 10 steps {first:.5f}, of the last 10 {last:.5f}", flush=True)
    check(launches["launches"] == launches["mip_launches"] == 2 * MS_ITERS, "two cone-cast B1 launches a multiscale step")
    check(launches["weights_launches"] == MS_ITERS and launches["opaque_launches"] == launches["dist_launches"] == 0,
          "one of them, the coarse level, with the weights output")
    check(launches["wgrad_sums"] == launches["bwd_tile"] == 2 * MS_ITERS,
          "the sums and the backward tile kernel twice a step (counted in C)")
    check(len(losses) == MS_ITERS and all(np.isfinite(losses)), "every multiscale loss logged and finite")
    check(last < 0.7 * first, "the multiscale loss fell")

    tcfg = train_config(cfg)
    model = NerfMLP(Lp=tcfg.net_Lp, Ld=tcfg.net_Ld, H=tcfg.net_H)
    radius = mip_radius(scene_focal(scene))
    rays, pixels = multiscale_train_arrays(load_blender(scene, True, 25), radius, dev)
    step_fn = build_train_step(tcfg, model, base_radius=radius)

    def step():
        return step_fn(state, rays, pixels)

    walls = step_walls(step)
    others, host = {}, {}
    prof = profile_step(step, others, host, split_mip=True)
    busy = sum(prof.values())
    idle = 1 - busy / walls["ms"] if prof else None
    print(f"train step multiscale bf16 steady state: {walls['ms']:.3f} ms a step, {BATCH / walls['ms'] * 1e3:,.0f} "
          f"rays/s (CUDA events over 20 steps, median of 5; runs {', '.join(f'{w:.3f}' for w in walls['walls'])}); "
          f"host issues a step in {walls['host_ms']:.3f} ms; profile, device ms a step: " + (", ".join(
              f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1]))
              + f"; kernels {busy:.3f}, idle share {idle:.3f}" if prof else "not measured"), flush=True)
    del rays, pixels
    torch.cuda.empty_cache()
    psnr_ms = psnr_at_scales(state.field, scene, dev, radius)
    psnr_single = psnr_at_scales(NerfField.from_jax_params(load_params(mip_exp), dev), scene, dev, radius)
    print("test image 0 at 1, 1/2, 1/4, 1/8 (two-level bf16 renders, each scale's cone, against block-mean gt): "
          f"multiscale {MS_ITERS} steps " + ", ".join(f"{p:.2f}" for p in psnr_ms.values())
          + " dB; phase 12's single-scale mip model (400 steps) " + ", ".join(f"{p:.2f}" for p in psnr_single.values())
          + " dB", flush=True)
    check(all(np.isfinite(list(psnr_ms.values()))), "the multiscale stills are finite")
    del state
    torch.cuda.empty_cache()

    pcfg = load_yaml("configs/lego_proposal.yaml")
    pcfg.update(datapath=scene, savepath=os.path.join(work, "models"), exp_name="prop_mip_ms", mip=True,
                mip_multiscale=True, opaque_background=True, distortion_loss_weight=DIST_LAMBDA,
                log_dir=os.path.join(work, "logs_prop_mip_ms"), num_iters=DATA_ITERS, ckpt_loss=1,
                ckpt_images=10 * DATA_ITERS, ckpt_model=DATA_ITERS, steps_per_call=DATA_ITERS)
    for c in ("launches", "mip_launches", "weights_dist_launches", "opaque_launches"):
        setattr(b1, c, 0)
    with contextlib.redirect_stdout(io.StringIO()):
        train(pcfg)
    torch.cuda.synchronize()
    prop_launches = {c: getattr(b1, c) for c in ("launches", "mip_launches", "weights_dist_launches",
                                                 "opaque_launches")}
    prop_losses = scalars(pcfg["log_dir"], "Loss/train")
    print(f"train mip x proposal + multiscale: {DATA_ITERS} steps; launches {prop_launches}; loss (area-weighted MSE "
          f"+ interval interlevel + interval distortion) {np.mean(prop_losses[:5]):.5f} -> "
          f"{np.mean(prop_losses[-5:]):.5f} (means of the first and last 5)", flush=True)
    check(all(v == DATA_ITERS for v in prop_launches.values()),
          "one cone-cast B1 launch a mip x proposal step, with the weights, the rail and the opaque tail")
    check(len(prop_losses) == DATA_ITERS and all(np.isfinite(prop_losses)), "every mip x proposal loss finite")
    return dict(launches=launches, train_s=train_s, first=first, last=last, step_ms=walls["ms"],
                host_ms=walls["host_ms"], walls=walls["walls"], profile=prof, idle=idle,
                host_top={k: v for k, v in sorted(host.items(), key=lambda kv: -kv[1])[:8]},
                psnr_multiscale=psnr_ms, psnr_single_scale=psnr_single, proposal_launches=prop_launches,
                proposal_loss=(float(np.mean(prop_losses[:5])), float(np.mean(prop_losses[-5:]))))


def phase_data_options(dev, work, mlp) -> dict:
    """19c. The data options training took last: ``dataset: tiny_nerf`` (an
    npz of 106 renders of the blob scene at 100x100 from an orbit, as
    tiny_nerf_data.npz lays them out: 100 train, 3 val, 3 test) and the
    ``hard`` style (a scene of 8/2/2 views at 200x200), each trained
    DATA_ITERS steps of configs/lego.yaml's keys (bf16, pallas, the fused
    step: one B1 launch a step); the loss finite and lower at the end."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.data.synthetic import _FOV_X, orbit_cameras, render_gt, write_blender_scene
    from nerf_simple_tpu_torch.train.loop import train

    t0 = time.perf_counter()
    npz = os.path.join(work, "tiny_nerf_data.npz")
    poses = orbit_cameras(106, seed_jitter=3)
    focal = 100 / (2.0 * np.tan(_FOV_X / 2.0))
    np.savez(npz, images=render_gt(poses, 100, 100, focal, device=dev), poses=poses, focal=np.float64(focal))
    hard = os.path.join(work, "hard")
    write_blender_scene(hard, 8, 2, 2, H=200, W=200, device=dev, style="hard")
    print(f"data options: the tiny_nerf npz (106 views at 100x100) and the hard scene (8/2/2 at 200x200) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    res = {}
    for name, kw in (("tiny_nerf", dict(datapath=npz, dataset="tiny_nerf")),
                     ("hard", dict(datapath=hard, half_res=False, num_train_imgs=8))):
        cfg = load_yaml("configs/lego.yaml")
        cfg.update(savepath=os.path.join(work, "models_data"), exp_name=name, log_dir=os.path.join(work, f"logs_{name}"),
                   backend="pallas", compute_dtype="bf16", num_iters=DATA_ITERS, ckpt_loss=1,
                   ckpt_images=10 * DATA_ITERS, ckpt_model=DATA_ITERS, steps_per_call=DATA_ITERS, **kw)
        mlp.fused_train_step.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            train(cfg)
        torch.cuda.synchronize()
        losses = scalars(cfg["log_dir"], "Loss/train")
        res[name] = dict(launches=mlp.fused_train_step.launches, first=float(np.mean(losses[:5])),
                         last=float(np.mean(losses[-5:])), train_s=time.perf_counter() - t0)
        print(f"train {name} (lego.yaml's keys): {DATA_ITERS} steps in {res[name]['train_s']:.1f} s with loading; B1 "
              f"launches {res[name]['launches']}; loss {res[name]['first']:.5f} -> {res[name]['last']:.5f} (means of "
              "the first and last 5)", flush=True)
        check(res[name]["launches"] == DATA_ITERS and len(losses) == DATA_ITERS and all(np.isfinite(losses)),
              f"{name}: one B1 launch a step, every loss finite")
        check(res[name]["last"] < res[name]["first"], f"{name}: the loss fell")
    return res


# Phase 20 (occupancy, mesh export, debug_nan): configs/lego_occ.yaml's keys; steps cut from its 10,000 to
# 300, as phases 7, 9, 11 and 12 run: at 100 steps no cell of the rebuilt grid reads alpha above 0.1 (the
# density is still spread), so its samples are the uniform PDF's quantiles, 0.2 dB under stratified at N 64
# (measured on the card); at 300 the blobs' cells stand out (PERF.md, section 6).
OCC_ITERS, OCC_R, MESH_R = 300, 64, 128
# the eval PSNR with the grid may trail stratified sampling at the same N by
# no more than JAX's own rule allows (tests/test_occupancy.py:325: mse_occ
# <= 1.05 mse_strat, i.e. 10 log10(1.05) = 0.212 dB)
OCC_PSNR_SLACK = 0.21


def occ_points(dev, R: int, aabb: float, seed: int) -> torch.Tensor:
    """One jittered point a cell of the R^3 grid over [-aabb, aabb]^3, as
    ``update_occ_grid`` places its probe (R^3 rows)."""
    ii = torch.arange(R, dtype=torch.float32, device=dev)
    corners = torch.stack(torch.meshgrid(ii, ii, ii, indexing="ij"), -1).reshape(-1, 3)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return -aabb + (corners + torch.rand(corners.shape, generator=g, device=dev)) * (2.0 * aabb / R)


def phase_occ_kernels(dev, mlp) -> dict:
    """20a. The occupancy grid's density probe (``ops/occupancy.py::
    density_fn`` under "pallas") through the forward kernel at one refresh's
    OCC_R^3 = 262,144 jittered cell points, the flagship from
    ``derive_seed(SEED, 20)``, f32 and bf16: one launch each, raw sigma
    against the forward's plain version on the same input (the renderer's
    ``_kernel_input`` at t = 0, unit -z directions); ms of the probe, its
    plain version and one refresh (``update_occ_grid``, bf16, CUDA events,
    median of 5); the sampler alone on a 4096-ray batch (occ_Nb 32, Nf
    64)."""
    from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
    from nerf_simple_tpu_torch.ops import occupancy as occ
    from nerf_simple_tpu_torch.render.renderer import _kernel_input, derive_seed

    model = NerfMLP()
    field = NerfField.from_jax_params(init_nerf_params(derive_seed(SEED, 20), model), dev)
    pts = occ_points(dev, OCC_R, 2.0, SEED + 20)
    dirs = torch.zeros_like(pts)
    dirs[:, 2] = -1.0
    x8 = _kernel_input(torch.cat([pts, dirs], 1), torch.zeros((pts.shape[0], 1), device=dev), 8)
    fwd, stats = mlp.fused_mlp_forward, {"rows": pts.shape[0]}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        probe = occ.density_fn(field, "pallas", dt)
        before = fwd.launches
        got = probe(pts)
        torch.cuda.synchronize()
        launched = fwd.launches - before
        w = mlp._cast_weights(mlp.pack_weights(field), dt)
        with torch.no_grad():
            want = mlp.fused_mlp_forward_plain(w, x8, dt, model)[3]
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        st = dict(err=err, scale=scale, launched=launched, ms=cuda_ms(lambda: probe(pts)),
                  plain_ms=cuda_ms(lambda: mlp.fused_mlp_forward_plain(w, x8, dt, model), reps=3))
        stats[name] = st
        print(f"occupancy density probe {name} at {stats['rows']} rows (R = {OCC_R}): kernel vs plain max abs sigma "
              f"err {err:.3e} (tol {TOL[dt]:.0e} x max(1, |sigma| max {scale:.2f})); {launched} forward launch; probe "
              f"{st['ms']:.3f} ms, plain {st['plain_ms']:.3f} ms", flush=True)
        check(launched == 1 and err <= TOL[dt] * scale, f"the density probe {name} through the forward kernel")
    grid = occ.init_occ_grid(OCC_R, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    probe = occ.density_fn(field, "pallas", torch.bfloat16)
    stats["refresh_ms"] = cuda_ms(lambda: occ.update_occ_grid(grid, probe, g, 2.0, 0.95))
    rays = torch.cat([4.0 * torch.nn.functional.normalize(torch.randn(BATCH, 3, generator=g, device=dev), dim=1),
                      torch.randn(BATCH, 3, generator=g, device=dev)], 1)
    grid = occ.update_occ_grid(grid, probe, g, 2.0, 0.95)
    stats["sampler_ms"] = cuda_ms(lambda: occ.occupancy_ts(g, rays, grid, 64, 2.0, 6.0, 2.0, Nb=32, floor=0.01))
    print(f"occupancy: one refresh (bf16 probe, the EMA) {stats['refresh_ms']:.3f} ms; the sampler on {BATCH} rays "
          f"(Nb 32, N 64) {stats['sampler_ms']:.3f} ms", flush=True)
    return stats


def phase_occ_train(dev, scene, work, mlp) -> dict:
    """20b. configs/lego_occ.yaml's keys (bf16, pallas, Nf 64, occ_R 64,
    occ_Nb 32, a refresh every 16 steps) through train() on phase 7's scene,
    OCC_ITERS steps: one B1 launch a step, a refresh at steps 0, 16, ...
    (19 in 300, each one forward launch; the step-0 previews' 40 besides),
    the grid moved off its all-ones start, the loss falls. The step's wall (CUDA
    events), host issue, kernel ms by pass (B1, before B1: the refresh and
    the sampler, after B1, Adam; 16 steps profiled, so one refresh) and
    idle share, beside the same config with ``occupancy: false`` at Nf 64.
    A ``debug_nan`` step on NaN rays raises, naming NaN and the step.
    Returns (the stats, the scene's RayDataset for 20c)."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.models.nerf import NerfMLP
    from nerf_simple_tpu_torch.train import step as step_mod
    from nerf_simple_tpu_torch.train.loop import train

    cfg = load_yaml("configs/lego_occ.yaml")
    cfg.update(datapath=scene, savepath=os.path.join(work, "models"), log_dir=os.path.join(work, "logs_occ"),
               num_iters=OCC_ITERS, ckpt_loss=1, ckpt_images=10 * OCC_ITERS, ckpt_model=OCC_ITERS, steps_per_call=50)
    b1, fwd = mlp.fused_train_step, mlp.fused_mlp_forward
    b1.launches = fwd.launches = 0
    refreshes = []
    real_update = step_mod.update_occ_grid

    def counted(grid, *a, **kw):
        refreshes.append(int((grid == 1).all()))
        return real_update(grid, *a, **kw)

    step_mod.update_occ_grid = counted
    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            state = train(cfg)
        torch.cuda.synchronize()
    finally:
        step_mod.update_occ_grid = real_update
    train_s = time.perf_counter() - t0
    with open(os.path.join(OUT, "train_occ_log.txt"), "w") as fh:
        fh.write(log.getvalue())
    launches = dict(fused_train_step=b1.launches, fused_mlp_forward=fwd.launches, refreshes=len(refreshes))
    previews = 4 * -(-H * W // CHUNK)  # step 0: train and val renders of val_idxs [0, 1], 10 chunks each
    losses = scalars(cfg["log_dir"], "Loss/train")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"train occupancy (lego_occ.yaml): {OCC_ITERS} steps in {train_s:.1f} s with loading and the step-0 "
          f"previews; launches {launches} (previews {previews}); grid occupied share (> 0.5) "
          f"{float((state.occ > 0.5).float().mean()):.3f}, mean {float(state.occ.mean()):.3f}; mean loss of the first "
          f"10 steps {first:.5f}, of the last 10 {last:.5f}", flush=True)
    check(b1.launches == OCC_ITERS, "one B1 launch an occupancy step")
    check(len(refreshes) == -(-OCC_ITERS // 16) and refreshes[0] == 1 and sum(refreshes) == 1,
          "a refresh every 16 steps from the all-ones grid")
    check(fwd.launches == len(refreshes) + previews, "each refresh and each preview chunk through the forward kernel")
    check(not bool((state.occ == 1).all()), "the grid moved off its all-ones start")
    check(len(losses) == OCC_ITERS and all(np.isfinite(losses)) and last < 0.7 * first, "the occupancy loss fell")

    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    rays, pixels = rd.rays["train"], rd.pixels["train"]
    tcfg = train_config(cfg)
    model = NerfMLP()
    res = dict(launches=launches, train_s=train_s, first=first, last=last, losses=losses[::10],
               occupied=float((state.occ > 0.5).float().mean()))
    for name, c in (("occupancy", tcfg), ("stratified", dataclasses.replace(tcfg, occupancy=False))):
        st = state if name == "occupancy" else step_mod.make_train_state(c, model, dev)
        step_fn = step_mod.build_train_step(c, model)

        def step():
            return step_fn(st, rays, pixels)

        walls = step_walls(step)
        prof = profile_step(step, split_occ=True, steps=16)
        busy = sum(prof.values())
        idle = 1 - busy / walls["ms"] if prof else None
        res[name] = dict(step_ms=walls["ms"], host_ms=walls["host_ms"], walls=walls["walls"], profile=prof, idle=idle)
        print(f"train step {name} (lego_occ.yaml, Nf 64) bf16: {walls['ms']:.3f} ms a step (CUDA events over 20 steps, "
              f"median of 5; runs {', '.join(f'{w:.3f}' for w in walls['walls'])}); host issues a step in "
              f"{walls['host_ms']:.3f} ms; profile over 16 steps, device ms a step: " + (", ".join(
                  f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1]))
                  + f"; kernels {busy:.3f}, idle share {idle:.3f}" if prof else "not measured"), flush=True)

    nan_cfg = dataclasses.replace(tcfg, debug_nan=True)
    nan_state = step_mod.make_train_state(nan_cfg, model, dev)
    nan_step = step_mod.build_train_step(nan_cfg, model)
    try:
        nan_step(nan_state, torch.full_like(rays[:BATCH], float("nan")), pixels[:BATCH])
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    print(f"debug_nan step on NaN rays: {'raised: ' + raised if raised else 'did not raise'}", flush=True)
    check(raised is not None and "nan" in raised.lower() and "step 0" in raised, "debug_nan raises on NaN rays")
    loss = nan_step(nan_state, rays[:BATCH * 4], pixels[:BATCH * 4])
    check(bool(torch.isfinite(loss)) and nan_state.step == 1, "debug_nan passes a clean step")
    res["debug_nan"] = raised
    del rays, pixels
    torch.cuda.empty_cache()
    return res, rd


def phase_occ_eval(dev, scene, work, mlp, rd) -> dict:
    """20c-d. ``evaluate.test`` with lego_occ.yaml's test_params (the grid
    rebuilt from the checkpoint: 4 forward launches; N_samples 64 at the
    deterministic quantiles, occ_group 4) on the 2 test images, beside the
    same stills at stratified samples (N 64): PSNR with the grid no lower
    than stratified's less OCC_PSNR_SLACK; one fused_eval frame with the
    grid (10 B3 launches) against the forward kernel plus torch compositing;
    one frame served over HTTP by a RenderServer with ``occupancy`` (what
    ``--occupancy`` builds) matching its render; then ``python -m
    nerf_simple_tpu_torch.export_mesh`` of the checkpoint at resolution
    MESH_R (129^3 lattice points through the forward kernel, 9 launches):
    faces, a valid .obj, its seconds. ``rd``: the scene's RayDataset
    (20b's)."""
    from nerf_simple_tpu_torch import evaluate, export_mesh
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.models.nerf import NerfField
    from nerf_simple_tpu_torch.ops.occupancy import rebuild_occ
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, derive_seed, render_image, render_rays_chunked
    from nerf_simple_tpu_torch.serve import RenderServer, decode_png, serve
    from nerf_simple_tpu_torch.train.metrics import img_psnr

    exp = os.path.join(work, "models", "lego_occ")
    tp = load_yaml("configs/lego_occ.yaml")["test_params"]
    tp.update(loadpath=exp, datapath=scene, savepath=os.path.join(work, "results"), im_idxs=[0, 1], animation=False)
    fwd, b3 = mlp.fused_mlp_forward, mlp.fused_render
    fwd.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        evaluate.test(tp)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    psnr_occ = [float(m) for m in re.findall(r"psnr=([0-9.]+)", log.getvalue())]
    n_chunks = -(-H * W // CHUNK)
    eval_launches = fwd.launches
    check(eval_launches == 4 + 2 * n_chunks, "the rebuild's 4 probes and each still's chunks through the forward kernel")

    tc = evaluate.test_config_from_dict(tp)
    field = NerfField.from_jax_params(evaluate.load_params(exp), dev)
    s = RenderSettings(N=tc.N_samples, backend="pallas", compute_dtype=torch.bfloat16, occ_Nb=tc.occ_Nb,
                       occ_floor=tc.occ_floor, occ_aabb=tc.occ_aabb, occ_group=tc.occ_group)
    n = rd.H * rd.W
    psnr_strat = []
    for idx in (0, 1):
        rgb, _ = render_image(field, rd.rays["test"], rd.H, rd.W, idx, derive_seed(tc.seed, idx), s, chunk=tc.batch_size)
        gt = rd.pixels["test"][idx * n : (idx + 1) * n].reshape(1, rd.H, rd.W, 3).cpu().numpy()
        psnr_strat.append(float(img_psnr(gt, rgb)))
    print(f"eval lego_occ test_params (N_samples {tc.N_samples}, occ_group {tc.occ_group}) on 2 test stills in "
          f"{eval_s:.1f} s with loading and the grid's rebuild: PSNR with the grid {psnr_occ}, stratified at the same N "
          f"{[round(p, 2) for p in psnr_strat]}; forward launches {eval_launches}", flush=True)
    check(len(psnr_occ) == 2 and all(np.isfinite(psnr_occ)), "occupancy eval PSNR printed")
    check(min(po - ps for po, ps in zip(psnr_occ, psnr_strat)) >= -OCC_PSNR_SLACK,
          "eval PSNR with the grid >= stratified at the same N less 0.21 dB (JAX's mse rule)")

    grid = rebuild_occ(field, "pallas", torch.bfloat16, tc.occ_R, tc.occ_aabb, derive_seed(tc.seed, 99))
    low_n = {}  # the same stills at fewer samples (JAX's test compares at N 8): reported, not held
    for n_low in (16, 8):
        s_low = dataclasses.replace(s, N=n_low)
        for label, g_ in (("grid", grid), ("stratified", None)):
            low_n[f"{label}_{n_low}"] = [float(img_psnr(
                rd.pixels["test"][idx * n : (idx + 1) * n].reshape(1, rd.H, rd.W, 3).cpu().numpy(),
                render_image(field, rd.rays["test"], rd.H, rd.W, idx, derive_seed(tc.seed, idx), s_low,
                             chunk=tc.batch_size, occ=g_)[0])) for idx in (0, 1)]
    print("the same stills at fewer samples (reported): " + "; ".join(
        f"{k} {', '.join(f'{p:.2f}' for p in v)} dB" for k, v in low_n.items())
          + f"; rebuilt grid: cells above alpha 0.1 {float((grid > 0.1).float().mean()):.4f}, mean "
          f"{float(grid.mean()):.4f}", flush=True)
    pose = torch.as_tensor(spherical_to_pose(4.0, -30.0, 30.0)[None], dtype=torch.float32, device=dev)
    frame_rays = rays_for_poses(pose, rd.H, rd.W, rd.f)
    b3.launches = 0
    fused, _ = render_rays_chunked(field, frame_rays, 0, dataclasses.replace(s, fused_eval=True), CHUNK, occ=grid)
    torch.cuda.synchronize()
    b3_launches = b3.launches
    unfused, _ = render_rays_chunked(field, frame_rays, 0, s, CHUNK, occ=grid)
    frame_err = (fused - unfused).abs().max().item()
    print(f"fused_eval frame with the grid: {b3_launches} B3 launches, max abs rgb diff from the forward kernel + torch "
          f"compositing {frame_err:.3e} (tol {FRAME_TOL:.0e})", flush=True)
    check(b3_launches == n_chunks and frame_err <= FRAME_TOL, "B3 at the occupancy samples matches the unfused frame")

    params = evaluate.load_params(exp)
    srv = RenderServer(params, rd.H, rd.W, rd.f, s, device=dev, occupancy=True, occ_R=tc.occ_R)
    httpd = serve(srv, 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        health = json.loads(get(url + "/health")[0])
        t0 = time.perf_counter()
        data, ctype = get(f"{url}/render?r=4&theta=-30&phi=30")
        http_ms = (time.perf_counter() - t0) * 1e3
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    served = decode_png(data)
    direct = srv.render(4.0, -30.0, 30.0)
    print(f"served /render with the grid: {len(data)} B PNG, {http_ms:.1f} ms (HTTP); /health occupancy "
          f"{health['occupancy']}; max diff from the server's own render {int(np.abs(served.astype(int) - direct).max())}"
          f" levels", flush=True)
    check(ctype == "image/png" and health["occupancy"] and np.array_equal(served, direct),
          "the occupancy server serves its grid's frame")
    del srv
    torch.cuda.empty_cache()

    out = os.path.join(work, "lego_occ.obj")
    fwd.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        export_mesh.main(["--loadpath", exp, "--out", out, "--resolution", str(MESH_R), "--aabb", "2.0", "--iso", "1.0",
                          "--backend", "pallas", "--dtype", "bf16"])
    mesh_s = time.perf_counter() - t0
    with open(out) as fh:
        lines = fh.read().splitlines()
    nv = sum(ln.startswith("v ") for ln in lines)
    faces = np.array([[int(t) for t in ln.split()[1:]] for ln in lines if ln.startswith("f ")], np.int64).reshape(-1, 3)
    print(f"mesh export at resolution {MESH_R}: {log.getvalue().strip()}; {mesh_s:.2f} s with loading; forward launches "
          f"{fwd.launches}", flush=True)
    check(len(faces) > 0 and faces.min() >= 1 and faces.max() <= nv == 3 * len(faces), "the mesh has faces, a valid .obj")
    check(fwd.launches == -(-(MESH_R + 1) ** 3 // 262144), "the lattice through the forward kernel in 262,144-row chunks")
    return dict(psnr_occ=psnr_occ, psnr_strat=psnr_strat, psnr_low_n=low_n, eval_s=eval_s, eval_launches=eval_launches,
                b3_launches=b3_launches, frame_err=frame_err, served_ms=http_ms, mesh_s=mesh_s, mesh_faces=len(faces),
                mesh_launches=fwd.launches)


def phase_probe(dev):
    """The padding probe at full reps: kernel vs plain for each K, ms a
    launch by differencing launch counts, the ratios."""
    from nerf_simple_tpu_torch.probes import pad_passes

    pad_passes.pad_passes.launches = 0
    res = pad_passes.run_probe(dev)
    launches = pad_passes.pad_passes.launches
    for K, v in res["K"].items():
        print(f"B4 probe K={K:3d}: {v['ms']:.4f} ms a launch ({res['reps']} x (256,{K})@({K},{res['TR']})), "
              f"{v['tflops']:.1f} TFLOP/s at K={K}; plain {v['plain_ms']:.2f} ms; kernel vs plain "
              f"{v['rel_err']:.2e} of max (tol {pad_passes.REL_TOL:.0e})", flush=True)
    print(f"B4 probe ratios: K72/K128 {res['K72_over_K128']:.3f}, K72/K80 {res['K72_over_K80']:.3f}, "
          f"K40/K128 {res['K40_over_K128']:.3f}; TR={res['TR']} columns (64 an SM); launches {launches}",
          flush=True)
    return res, launches


def train_config(d):
    from nerf_simple_tpu_torch.config import train_config_from_dict

    return train_config_from_dict(d)


def scene_focal(scene: str, width: int = W) -> float:
    """The focal length of the scene's field of view at ``width`` pixels."""
    with open(os.path.join(scene, "transforms_train.json")) as fh:
        fov = json.load(fh)["camera_angle_x"]
    return width / (2.0 * np.tan(fov / 2.0))


def main() -> None:
    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch / CUDA port on one GPU.")
    ap.add_argument("--before", nargs="+", metavar="CSRC", help="csrc/ directories of an earlier commit, "
                    "then of any variants (kept out of the committed tree): their train-step, forward and backward "
                    "sources are built; each one's f32 backward tile kernel is timed beside the current one, and "
                    "the first one's B1, f32 forward and train step beside the current ones")
    args = ap.parse_args()
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    # full f32 matmuls in the plain versions (PyTorch's default; stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    os.makedirs(OUT, exist_ok=True)

    from nerf_simple_tpu_torch.data.synthetic import write_blender_scene
    from nerf_simple_tpu_torch.kernels import _build, mlp
    from nerf_simple_tpu_torch.models.nerf import NerfMLP, init_nerf_params
    from nerf_simple_tpu_torch.probes import bwd_tile, pad_passes, wgrad
    from nerf_simple_tpu_torch.utils.roofline import input_grad_work
    from nerf_simple_tpu_torch.utils.roofline import bound_by, bound_ms

    # 2. build (with --before, the earlier train-step and forward sources too)
    walls, t_phase = {}, time.perf_counter()
    phase_build((*mlp.SOURCES, pad_passes.SOURCE), _build)
    copies = build_before(args.before, _build, mlp) if args.before else []
    earlier = copies[0] if copies else {}
    walls["build"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 3-4. forward and render kernels vs plain; serving; the fused_eval frame
    model = NerfMLP()
    params = init_nerf_params(SEED, model)
    x16 = chunk_input(dev)
    fwd = phase_forward(dev, params, model, mlp, x16)
    fwd_turns = earlier and phase_forward_before_after(dev, params, model, mlp, x16, earlier["fused_mlp_fwd"])
    fwd_turns_bf16 = earlier and phase_forward_before_after(dev, params, model, mlp, x16, earlier["fused_mlp_fwd"],
                                                            torch.bfloat16)
    if earlier:
        check(fwd_turns["bit_equal"] and fwd_turns_bf16["bit_equal"],
              "the forward, f32 and bf16, bit-equal to the earlier library's")
        f = fwd_turns_bf16["fwd_ms"]
        print(f"before/after bf16 forward at {fwd_turns_bf16['rows']} rows: earlier {f['earlier']:.3f} ms, current "
              f"{f['current']:.3f} ms; bit-equal: {fwd_turns_bf16['bit_equal']} (f32: {fwd_turns['bit_equal']})",
              flush=True)
    rnd = phase_render(dev, params, model, mlp, x16)
    del x16
    torch.cuda.empty_cache()
    serve_launches, frame_ms = phase_serve(dev, params, model, mlp)
    render_launches, fused_frame_ms = phase_fused_frame(dev, params, model, mlp)

    with tempfile.TemporaryDirectory() as work:
        scene = os.path.join(work, "scene")
        t0 = time.perf_counter()
        write_blender_scene(scene, n_train=25, n_val=2, n_test=2, H=800, W=800, device=dev, write_depth=True)
        print(f"scene: 25/2/2 images at 800x800 and their metric depth written in {time.perf_counter() - t0:.1f} s",
              flush=True)
        # 5. B2 and B1 vs plain at the training batch
        bwd = phase_backward_and_step(dev, params, model, mlp, train_batch(dev, scene))
        torch.cuda.empty_cache()
        before = None
        if earlier:  # 5b. B1 (and the f32 forward) of the earlier sources beside the current ones
            batch = train_batch(dev, scene)
            before = phase_before_after(dev, params, model, mlp, batch, earlier["fused_train_step"])
            b32 = phase_before_after(dev, params, model, mlp, batch, earlier["fused_train_step"], torch.float32)
            del batch
            before["f32"] = {**fwd_turns, **b32}
            check(before["b1_bitwise"] and b32["b1_bitwise"],
                  "B1's point launch, bf16 and f32, bit-equal to the earlier library's")
            f, b = fwd_turns["fwd_ms"], b32["b1_ms"]
            print(f"before/after f32: forward at {fwd_turns['rows']} rows earlier {f['earlier']:.3f} ms, current "
                  f"{f['current']:.3f} ms (max abs diff {fwd_turns['fwd_err']:.2e}); B1 at {BATCH * N_SAMPLES} rows "
                  f"earlier {b['earlier']:.3f} ms, current {b['current']:.3f} ms (grads {b32['b1_grad_rel']:.2e} of "
                  f"max, loss and grads bit-equal: {b32['b1_bitwise']}); profiled ms a B1 call: " + "; ".join(
                      f"{k}: " + ", ".join(f"{g} {v:.3f}" for g, v in sorted(p.items(), key=lambda kv: -kv[1]))
                      for k, p in b32["b1_profile"].items()), flush=True)
        # 6. the weight-gradient sums alone, then the backward tile kernel alone
        wg = phase_wgrad(dev)
        torch.cuda.empty_cache()
        bt = phase_bwd_tile(dev)
        tile_turns = earlier and phase_bwd_tile_before_after(dev, {
            label: c["fused_mlp_bwd"] for label, c in zip(("earlier", *args.before[1:]), copies)})
        torch.cuda.empty_cache()
        # 7. train
        tr = phase_train(dev, scene, work, mlp, earlier.get("fused_train_step"))
        torch.cuda.empty_cache()
        # 8. eval of the trained run
        ev = phase_eval(dev, scene, work, mlp)
        torch.cuda.empty_cache()
        # 9. hierarchical: B1's weights output, training, eval
        walls["single-net path"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        hk = phase_hier_kernels(dev, scene, model, mlp)
        torch.cuda.empty_cache()
        ht = phase_hier_train(dev, scene, work, mlp)
        torch.cuda.empty_cache()
        he = phase_hier_eval(dev, scene, work, mlp, ht["exp"])
        walls["hierarchical"] = time.perf_counter() - t_phase
        # 10. the regularisers: B1's distortion rail vs plain, training with each
        t_phase = time.perf_counter()
        dk = phase_dist_kernels(dev, scene, model, mlp)
        torch.cuda.empty_cache()
        rt = phase_reg_train(dev, scene, work, mlp)
        walls["regularisers"] = time.perf_counter() - t_phase
        # 11. proposal sampling: the core with B1 vs plain, training, eval, serving
        t_phase = time.perf_counter()
        pk = phase_prop_kernels(dev, scene, model, mlp)
        torch.cuda.empty_cache()
        pt = phase_prop_train(dev, scene, work, mlp)
        torch.cuda.empty_cache()
        pe = phase_prop_eval(dev, scene, work, mlp, pt["exp"])
        walls["proposal"] = time.perf_counter() - t_phase
        # 12. mip cone casting: the cone-cast kernel variants vs plain, training, eval, serving
        t_phase = time.perf_counter()
        mk = phase_mip_kernels(dev, scene, model, mlp)
        torch.cuda.empty_cache()
        mt = phase_mip_train(dev, scene, work, mlp)
        torch.cuda.empty_cache()
        me = phase_mip_eval(dev, scene, work, mlp, mt["exp"])
        walls["mip"] = time.perf_counter() - t_phase
        # 13. pose refinement: the windows and the input gradient vs plain, the pose step, the recipe, eval
        t_phase = time.perf_counter()
        posek = phase_pose_kernels(dev, scene, model, mlp, earlier)
        torch.cuda.empty_cache()
        poset = phase_pose_train(dev, scene, work, mlp)
        torch.cuda.empty_cache()
        poser = phase_pose_recipe(dev, work, mlp)
        torch.cuda.empty_cache()
        posee = phase_pose_eval(dev, work, poser)
        walls["pose"] = time.perf_counter() - t_phase
        # 14. appearance codes: the code rows vs plain, the appearance steps, eval, the exposure twins
        t_phase = time.perf_counter()
        appk = phase_app_kernels(dev, scene, mlp, earlier)
        torch.cuda.empty_cache()
        appt = phase_app_train(dev, scene, work, mlp)
        torch.cuda.empty_cache()
        appr = phase_app_twins(dev, work, mlp)
        walls["appearance"] = time.perf_counter() - t_phase
        # 15. pose with mip and proposal: the mip input gradient vs plain, training through the freeze, eval
        t_phase = time.perf_counter()
        pmk = phase_pose_mip_kernels(dev, scene, model, mlp, earlier)
        torch.cuda.empty_cache()
        pmt = phase_pose_mip_train(dev, scene, work, mlp)
        torch.cuda.empty_cache()
        ppt = phase_pose_prop_train(dev, scene, work, mlp)
        walls["pose with mip and proposal"] = time.perf_counter() - t_phase
        # 16. scene contraction: the contracted kernels vs plain, the 360 recipe, mip + contract
        t_phase = time.perf_counter()
        unb = os.path.join(work, "unbounded")
        write_blender_scene(unb, *UNB_VIEWS, H=UNB_HW, W=UNB_HW, device=dev, train_jitter=3, style="unbounded",
                            camera_r_range=(3.0, 6.0))
        print(f"scene: unbounded style, {'/'.join(map(str, UNB_VIEWS))} images at {UNB_HW}x{UNB_HW}, cameras at "
              f"radius 3..6, written in {time.perf_counter() - t_phase:.1f} s", flush=True)
        ck = phase_contract_kernels(dev, unb, mlp, earlier, args.before[0] if args.before else None)
        torch.cuda.empty_cache()
        ct = phase_contract_train(dev, unb, work, mlp)
        torch.cuda.empty_cache()
        cmip = phase_contract_mip(dev, unb, work, mlp)
        walls["contract"] = time.perf_counter() - t_phase
        # 17. pose refinement and appearance codes on a contracted model: the contract input gradient and the
        # contracted forward with the windows and the codes vs plain, the 360 recipe's pose block, codes
        t_phase = time.perf_counter()
        pck = phase_pose_contract_kernels(dev, unb, mlp, earlier)
        torch.cuda.empty_cache()
        pct = phase_pose_contract_train(dev, unb, work, mlp)
        torch.cuda.empty_cache()
        pca = phase_app_contract_train(dev, pct["pert"], work, mlp)
        torch.cuda.empty_cache()
        pcn = phase_pose_app_contract_nets(dev, pct["pert"], work, mlp)
        walls["pose and appearance with contract"] = time.perf_counter() - t_phase
        # 18. the mip-NeRF 360 composition: the MIP && CONTRACT input gradient vs plain, mip x proposal on the
        # 360 recipe (train, eval, serve), with its pose block, and the sub-cases with pose
        t_phase = time.perf_counter()
        m3k = phase_mip360_kernels(dev, unb, mlp, earlier)
        torch.cuda.empty_cache()
        m3t = phase_mip360_train(dev, unb, work, mlp)
        torch.cuda.empty_cache()
        m3p = phase_mip360_pose(dev, scene, pct["pert"], work, mlp)
        walls["the mip-NeRF 360 composition"] = time.perf_counter() - t_phase
        # 19. multiscale training: B1 on a pyramid batch vs plain, lego_mip.yaml + mip_multiscale, mip x proposal on
        # the pyramid; the data options (a tiny_nerf npz, the hard scene)
        t_phase = time.perf_counter()
        msk = phase_multiscale_kernels(dev, scene, mlp)
        torch.cuda.empty_cache()
        mst = phase_multiscale_train(dev, scene, work, mlp, mt["exp"])
        torch.cuda.empty_cache()
        dopt = phase_data_options(dev, work, mlp)
        walls["multiscale and the data options"] = time.perf_counter() - t_phase
        # 20. occupancy: the density probe through the forward kernel, lego_occ.yaml's training and its step, eval
        # with the grid beside stratified, B3 and a served frame with the grid, the mesh export, debug_nan
        t_phase = time.perf_counter()
        occk = phase_occ_kernels(dev, mlp)
        torch.cuda.empty_cache()
        occt, occ_rd = phase_occ_train(dev, scene, work, mlp)
        occe = phase_occ_eval(dev, scene, work, mlp, occ_rd)
        del occ_rd
        walls["occupancy and mesh export"] = time.perf_counter() - t_phase
    # 21. the padding probe
    t_phase = time.perf_counter()
    probe, probe_launches = phase_probe(dev)
    walls["probe"] = time.perf_counter() - t_phase
    print("phase walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
          + f"; total {sum(walls.values()):.1f} s", flush=True)
    print("sub-phase walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in SUBWALLS.items()), flush=True)

    # bounds from the shapes (utils/roofline.py): MACs a row of the forward
    # (every packed matrix once) and of B1/B2 (forward recompute, W^T g of
    # the nine transposed matrices, the weight-gradient sums); the bytes
    # each kernel must move, its f32 inputs and outputs
    shapes = mlp._weight_shapes(model)
    fwd_macs = sum(o * k for o, k in shapes.values() if k != 1)
    train_macs = 2 * fwd_macs + sum(shapes[n][0] * shapes[n][1] for n in mlp._TRANSPOSED)
    grad_bytes = 4 * sum(o * k for o, k in shapes.values())
    chunk_rows, batch_rows = CHUNK * N, BATCH * N_SAMPLES

    def bounds(flops, nbytes, nbytes_bf16=None):
        nb = nbytes if nbytes_bf16 is None else nbytes_bf16
        return {"bound_ms": bound_ms(flops, nbytes, torch.float32),
                "bound_by": bound_by(flops, nbytes, torch.float32),
                "bound_ms_bf16": bound_ms(flops, nb, torch.bfloat16),
                "bound_by_bf16": bound_by(flops, nb, torch.bfloat16)}

    def entry(name, source, replaces, launches, st, work, library=(None, None), **extra):
        return {"name": name, "route": "cuda", "source": f"nerf_simple_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": st["f32"]["err"],
                "ms": st["f32"]["ms"], "plain_ms": st["f32"]["plain_ms"], **bounds(*work),
                "library_ms": library[0], "max_abs_err_bf16": st["bf16"]["err"],
                "ms_bf16": st["bf16"]["ms"], "plain_ms_bf16": st["bf16"]["plain_ms"],
                "library_ms_bf16": library[1], **extra}

    b2 = {k: bwd[f"B2_{k}"] for k in ("f32", "bf16")}
    b1 = {k: bwd[f"B1_{k}"] for k in ("f32", "bf16")}
    hier_b1 = {}  # B1 with the weights output at the two passes: its numbers and bounds
    for pas in ("coarse", "fine"):
        rows = hk[f"{pas}_f32"]["rows"]
        hier_b1[pas] = {"rows": rows, "N": hk[f"{pas}_f32"]["N"],
                        **bounds(2 * train_macs * rows, 68 * rows + grad_bytes),
                        **{f"{k}{'' if dt == 'f32' else '_bf16'}": hk[f"{pas}_{dt}"][k]
                           for dt in ("f32", "bf16")
                           for k in ("ms", "ms_no_weights", "plain_ms", "w_err", "rel", "loss_err")}}
    sums = {k: dict(err=wg[k]["max_abs_err"], ms=wg[k]["ms"], plain_ms=wg[k]["plain_ms"])
            for k in ("f32", "bf16")}
    (wg_flops, wg_bytes), (_, wg_bytes_bf16) = (wgrad.work(model, wg["rows"], dt)
                                                for dt in (torch.float32, torch.bfloat16))
    tile = {k: dict(err=bt[k]["max_abs_err"], ms=bt[k]["ms"], plain_ms=bt[k]["plain_ms"]) for k in ("f32", "bf16")}
    (tile_flops, tile_bytes), (_, tile_bytes_bf16) = (bwd_tile.work(model, bt["rows"], dt)
                                                      for dt in (torch.float32, torch.bfloat16))
    dist = {"launches": rt["distortion"]["launches"]["dist_rail"],
            "launches_hierarchical": rt["hierarchical_distortion"]["launches"]["dist_rail"],
            "source": "nerf_simple_tpu_torch/csrc/fused_train_step.cu (composite_grad, dist_grad)",
            "replaces": "nerf_simple_tpu/kernels/mlp.py:1343-1410", "lambda": DIST_LAMBDA,
            "max_abs_err": max(v["err"] for k, v in dk.items() if k.endswith("f32")),
            "max_abs_err_bf16": max(v["err"] for k, v in dk.items() if k.endswith("bf16")),
            # the rail's kernel, composite_grad, at the training batch (f32 compositing at either type)
            "ms": dk["train_linear_f32"]["composite_ms"], "plain_ms": dk["train_linear_f32"]["plain_composite_ms"],
            "ms_bf16": dk["train_linear_bf16"]["composite_ms"],
            "plain_ms_bf16": dk["train_linear_bf16"]["plain_composite_ms"], "library_ms": None,
            "b1_ms": dk["train_linear_f32"]["ms"], "b1_ms_no_rail": dk["train_linear_f32"]["ms_no_rail"],
            "b1_ms_bf16": dk["train_linear_bf16"]["ms"], "b1_ms_no_rail_bf16": dk["train_linear_bf16"]["ms_no_rail"],
            "b1_ms_rail_weight_0_bf16": dk["train_linear_bf16"]["ms_rail_weight_0"],
            "b1_plain_ms": dk["train_linear_f32"]["plain_ms"], "cases": dk,
            "training": {k: {m: v[m] for m in ("step_ms", "host_ms", "idle", "profile", "launches", "first", "last")}
                         | {m: v[m] for m in v if m.startswith(("probe", "depth"))} for k, v in rt.items()}}
    for pas in ("train", "fine"):  # composite_grad's bound at each pass, with the rail
        rows = dk[f"{pas}_linear_f32"]["rows"]
        nbytes = COMPOSITE_BYTES_ROW * rows + COMPOSITE_BYTES_RAY * BATCH
        dist[f"composite_{pas}"] = {
            "rows": rows, "bound_ms": bound_ms(COMPOSITE_FLOPS_ROW * rows, nbytes, torch.float32),
            "bound_by": bound_by(COMPOSITE_FLOPS_ROW * rows, nbytes, torch.float32),
            **{f"ms_{sp}_{dt}": dk[f"{pas}_{sp}_{dt}"]["composite_ms"] for sp in ("linear", "disparity")
               for dt in ("f32", "bf16")},
            **{f"ms_no_rail_{sp}_{dt}": dk[f"{pas}_{sp}_{dt}"]["composite_ms_no_rail"]
               for sp in ("linear", "disparity") for dt in ("f32", "bf16")}}
    dist["bound_ms"], dist["bound_by"] = dist["composite_train"]["bound_ms"], dist["composite_train"]["bound_by"]
    proposal = {  # B1 with the weights output and the rail in one launch: the proposal step's
        "weights_dist_launches": pt["launches"]["weights_and_rail"], "launches": pt["launches"],
        "core_vs_plain": {k: v for k, v in pk.items() if k.startswith(("f32", "bf16"))},
        "b1_turns_ms": {"f32": pk["turns_f32"], "bf16": pk["turns_bf16"]},
        "b1_plain_ms": {"f32": pk["plain_ms_f32"], "bf16": pk["plain_ms_bf16"]},
        "rows": BATCH * N_SAMPLES, **bounds(2 * train_macs * BATCH * N_SAMPLES, 68 * BATCH * N_SAMPLES + grad_bytes),
        "pieces_bf16": pk["pieces"], "step_ms_bf16": pt["step_ms"], "step_host_ms_bf16": pt["host_ms"],
        "step_profile_ms_bf16": pt["profile"], "idle_share": pt["idle"], "peak_gb": pt["peak_gb"],
        "held_out_interlevel_mse": {str(k): v for k, v in pt["held_out"].items()},
        "f32_loss_rel": pt["loss_rel_f32"], "f32_params_past_rule": pt["params_past_rule"],
        "eval_psnr": pe["psnr"], "eval_s_per_still": pe["s_per_still"], "frame_ms_bf16": pe["frame_ms"],
        "served_u8_err": pe["served_u8_err"]}
    # the cone-cast variants: the forward reads 9 of its 16 input rows (means,
    # dirs, variances) and writes 8; B1 reads 15 (row 15 is unread) and B2 9
    # with its 8 cotangent rows, and each writes the packed gradients
    mip_fwd = {k: dict(err=mk[f"fwd_{k}"]["err"], ms=mk[f"fwd_{k}"]["ms"], plain_ms=mk[f"fwd_{k}"]["plain_ms"])
               for k in ("f32", "bf16")}
    mip_b2 = {k: dict(err=mk[f"b2_{k}"]["err"], ms=mk[f"b2_{k}"]["ms"], plain_ms=mk[f"b2_{k}"]["plain_ms"])
              for k in ("f32", "bf16")}

    def mip_fields(st, flops, nbytes, launches, **extra):
        return {"launches": launches, "max_abs_err": st["f32"]["err"], "ms": st["f32"]["ms"],
                "plain_ms": st["f32"]["plain_ms"], "max_abs_err_bf16": st["bf16"]["err"], "ms_bf16": st["bf16"]["ms"],
                "plain_ms_bf16": st["bf16"]["plain_ms"], **bounds(flops, nbytes), "library_ms": None, **extra}

    mip_b1 = {case: {f"{k}{'' if dt == 'f32' else '_bf16'}": mk[f"b1_{case}_{dt}"][k] for dt in ("f32", "bf16")
                     for k in ("ms", "plain_ms", "rel", "loss_err", "w_err")} for case in ("plain", "weights", "opaque",
                                                                                       "rail")}
    mip_train = {  # the two-level mip step: two cone-cast B1 launches, the coarse one with the weights output
        **mip_fields({k: dict(err=max(mk[f"b1_{c}_{k}"]["err"] for c in mip_b1), ms=mk[f"b1_plain_{k}"]["ms"],
                              plain_ms=mk[f"b1_plain_{k}"]["plain_ms"]) for k in ("f32", "bf16")},
                     2 * train_macs * batch_rows, 4 * 15 * batch_rows + grad_bytes, mt["launches"]["mip_launches"]),
        "source": "nerf_simple_tpu_torch/csrc/fused_train_step.cu (composite_grad, dist_grad, rail_pos; "
                  "composite.cuh sample_at; the encoders of fwd_f32.cuh and fwd_bf16.cuh)",
        "replaces": "nerf_simple_tpu/kernels/mlp.py:1283-1291, :1317-1328, :1353-1373, :1406, :473-477",
        "weights_launches": mt["launches"]["weights_launches"], "opaque_launches": mt["launches"]["opaque_launches"],
        "cases": mip_b1, "step_ms_bf16": mt["step_ms"], "step_host_ms_bf16": mt["host_ms"],
        "step_profile_ms_bf16": mt["profile"], "pieces_ms_bf16": mt["pieces"], "idle_share": mt["idle"],
        "peak_gb": mt["peak_gb"], "f32_loss_rel": mt["loss_rel_f32"], "f32_bin_flips": mt["bin_flips"],
        "eval_psnr": me["psnr"], "eval_s_per_still": me["s_per_still"], "frame_ms_bf16": me["frame_ms"],
        "served_u8_err": me["served_u8_err"]}
    mip_rows = mk["fwd_f32"]["rows"]
    mip_forward = {**mip_fields(mip_fwd, 2 * fwd_macs * mip_rows, 4 * 17 * mip_rows, me["launches"],
                                point_ms=mk["fwd_f32"]["point_ms"], point_ms_bf16=mk["fwd_bf16"]["point_ms"],
                                rows=mip_rows, train_launches=mt["launches"]["fused_mlp_forward_mip"],
                                served_launches=me["served_launches"]),
                   "source": "nerf_simple_tpu_torch/csrc/fwd_f32.cuh, fwd_bf16.cuh (encode)",
                   "replaces": "nerf_simple_tpu/kernels/mlp.py:473-477 (Sv :175)"}
    mip_backward = {**mip_fields(mip_b2, 2 * train_macs * batch_rows, 4 * 17 * batch_rows + grad_bytes,
                                 mt["b2_launches"], rows=batch_rows),
                    "source": "nerf_simple_tpu_torch/csrc/fused_mlp_bwd.cu (the forward's encoders)",
                    "replaces": "nerf_simple_tpu/kernels/mlp.py:702, :717"}
    # the pose variants: the windowed forward (the forward's work), B2 with
    # want_dx (B2's work and the input gradient's), the input-gradient
    # kernel alone (probes/input_grad.py's reckoning)
    pose_fwd = {k: dict(err=posek[f"fwd_{k}"]["err"], ms=posek[f"fwd_{k}"]["ms"],
                        plain_ms=posek[f"fwd_{k}"]["plain_ms"]) for k in ("f32", "bf16")}
    anneal = {**mip_fields(pose_fwd, 2 * fwd_macs * chunk_rows, 64 * chunk_rows, poset["launches"]["forward_anneal"],
                           rows=chunk_rows, alpha=0.3, **{f"{m}{'' if k == 'f32' else '_bf16'}": posek[f"fwd_{k}"][m]
                                                          for k in ("f32", "bf16")
                                                          for m in ("ms_no_windows", "err_a03", "err_a1",
                                                                    "alpha1_bit_equal", "bit_equal_earlier")
                                                          if m in posek[f"fwd_{k}"]}),
              "source": "nerf_simple_tpu_torch/csrc/fwd_f32.cuh, fwd_bf16.cuh (encode: wx, wd)",
              "replaces": "nerf_simple_tpu/kernels/mlp.py:491-493 (_encode), :613, :648-650 (enc_w), :378 "
                          "(anneal_row_weights)"}
    ig = posek["input_grad"]
    ig_flops, ig_bytes = input_grad_work(model, ig["rows"], torch.float32)
    dx_b2 = {k: dict(err=posek[f"b2_{k}"]["err"], ms=posek[f"b2_{k}"]["ms"], plain_ms=posek[f"b2_{k}"]["plain_ms"])
             for k in ("f32", "bf16")}
    want_dx = {**mip_fields(dx_b2, 2 * train_macs * batch_rows + ig_flops, 64 * batch_rows + grad_bytes + 32 * batch_rows,
                            poset["launches"]["b2_dx"], rows=batch_rows, anneal_launches=poset["launches"]["b2_anneal"],
                            **{f"{m}{c}{'' if k == 'f32' else '_bf16'}": posek[f"b2_{k}{c}"][m]
                               for k in ("f32", "bf16") for c in ("", "_windows")
                               for m in ("rel", "dx_rel", "dx_rows", "ms_no_dx", "bit_equal_no_dx",
                                         "dx_equal_composed", "bit_equal_earlier")
                               if m in posek[f"b2_{k}{c}"]}),
               "source": "nerf_simple_tpu_torch/csrc/fused_mlp_bwd.cu (dx; the forward's encoders: wx, wd)",
               "replaces": "nerf_simple_tpu/kernels/mlp.py:733-746, :1107, :1118-1120, :707",
               "pose_step": {"step_ms_bf16": poset["step_ms"], "step_host_ms_bf16": poset["host_ms"],
                             "step_profile_ms_bf16": poset["profile"], "idle_share": poset["idle"],
                             "peak_gb": poset["peak_gb"], "launches": poset["launches"],
                             "recipe": {k: v for k, v in poser.items() if k not in ("clean", "pert")},
                             "eval": posee}}
    # the appearance variants: the forward with the code rows reads 14 of its
    # 16 input rows (xyz, dirs, the code) and writes 8; B2 with the codes and
    # want_dx reads those 14 and its 4 cotangent rows and writes dx's 16 and
    # the packed gradients; the input-gradient kernel with the code rows
    # (probes/input_grad.py's reckoning)
    app_model = NerfMLP(app_dim=APP_DIM)
    app_shapes = mlp._weight_shapes(app_model)
    app_fwd_macs = sum(o * k for o, k in app_shapes.values() if k != 1)
    app_train_macs = 2 * app_fwd_macs + sum(app_shapes[n][0] * app_shapes[n][1] for n in mlp._TRANSPOSED)
    app_grad_bytes = 4 * sum(o * k for o, k in app_shapes.values())
    app_rows, app_ig = appk["fwd_f32"]["rows"], appk["input_grad"]
    aig_flops, aig_bytes = input_grad_work(app_model, app_ig["rows"], torch.float32)

    def app_stats(prefix):
        return {k: dict(err=appk[f"{prefix}_{k}"]["err"], ms=appk[f"{prefix}_{k}"]["ms"],
                        plain_ms=appk[f"{prefix}_{k}"]["plain_ms"]) for k in ("f32", "bf16")}

    def app_extra(prefix, names):
        return {f"{m}{'' if k == 'f32' else '_bf16'}": appk[f"{prefix}_{k}"][m] for k in ("f32", "bf16")
                for m in names if m in appk[f"{prefix}_{k}"]}

    app_forward = {**mip_fields(app_stats("fwd"), 2 * app_fwd_macs * app_rows, 88 * app_rows,
                                appt["launches"]["forward_app"], rows=app_rows,
                                **app_extra("fwd", ("ms_no_codes", "zero_codes_bit_equal"))),
                   "source": "nerf_simple_tpu_torch/csrc/fwd_f32.cuh, fwd_bf16.cuh (encode: the code rows after posd; "
                             "Wcd's last eight columns, Wca)",
                   "replaces": "nerf_simple_tpu/kernels/mlp.py:541-545, :589-594, :624-641 (FusedWeightsApp.Wca "
                               ":222-258, packed :350-360)"}
    app_backward = {**mip_fields(app_stats("b2"), 2 * app_train_macs * app_rows + aig_flops,
                                 (56 + 16 + 64) * app_rows + app_grad_bytes, appt["launches"]["b2_app"], rows=app_rows,
                                 **app_extra("b2", ("rel", "wca_rel", "code_rel", "dx_rows", "ms_no_codes",
                                                    "bit_equal_no_dx", "dx_equal_composed", "code_plane_equal",
                                                    "as_earlier"))),
                    "source": "nerf_simple_tpu_torch/csrc/fused_mlp_bwd.cu (the recompute with the codes; Wcd's sum "
                              "over posd's code rows: dWca; input_grad.cuh: the code rows of dx)",
                    "replaces": "nerf_simple_tpu/kernels/mlp.py:716-724, :747-748, :854-857, :867, :1140-1145",
                    "app_step": {**{k: v for k, v in appt.items() if k != "walls"}, "twins": appr}}
    app_input_grad = {
        "launches": appt["launches"]["input_grad"], "max_abs_err": app_ig["f32"]["max_abs_err"],
        "ms": app_ig["f32"]["ms"], "plain_ms": app_ig["f32"]["plain_ms"], "bound_ms": app_ig["f32"]["bound_ms"],
        "bound_by": app_ig["f32"]["bound_by"], "library_ms": app_ig["f32"]["library_ms"],
        "max_abs_err_bf16": app_ig["bf16"]["max_abs_err"], "ms_bf16": app_ig["bf16"]["ms"],
        "plain_ms_bf16": app_ig["bf16"]["plain_ms"], "bound_ms_bf16": app_ig["bf16"]["bound_ms"],
        "bound_by_bf16": app_ig["bf16"]["bound_by"], "library_ms_bf16": app_ig["bf16"]["library_ms"],
        "rows": app_ig["rows"], "rel_err": app_ig["f32"]["rel_err"], "rel_err_bf16": app_ig["bf16"]["rel_err"],
        "code_rel_err": app_ig["f32"]["code_rel_err"], "code_rel_err_bf16": app_ig["bf16"]["code_rel_err"],
        "ms_no_codes": ig["f32"]["ms"], "ms_no_codes_bf16": ig["bf16"]["ms"], "flops": aig_flops, "bytes": aig_bytes,
        "source": "nerf_simple_tpu_torch/csrc/input_grad.cuh (KDA: the code slots; dx rows 8..15)",
        "replaces": "nerf_simple_tpu/kernels/mlp.py:867, :747-748, :1140-1145",
        "step_profile_ms_bf16": appt["profile"].get("input grad")}
    # the mip input gradient (probes/input_grad.py's reckoning, mip=True: nine
    # x rows read, sixteen dx rows written)
    igm = pmk["input_grad"]
    igm_flops, igm_bytes = input_grad_work(model, igm["rows"], torch.float32, mip=True)
    input_grad_mip = {
        "name": "input_grad_mip", "route": "cuda", "source": "nerf_simple_tpu_torch/csrc/input_grad.cuh",
        "replaces": "nerf_simple_tpu/kernels/mlp.py:941-1078 (_input_grad_tile_mip), :738-742 (_bwd_kernel's mip "
                    "and want_dx)",
        "launches": pmt["launches"]["input_grad_mip"], "max_abs_err": igm["f32"]["max_abs_err"], "ms": igm["f32"]["ms"],
        "plain_ms": igm["f32"]["plain_ms"], "bound_ms": igm["f32"]["bound_ms"], "bound_by": igm["f32"]["bound_by"],
        "library_ms": igm["f32"]["library_ms"], "max_abs_err_bf16": igm["bf16"]["max_abs_err"],
        "ms_bf16": igm["bf16"]["ms"], "plain_ms_bf16": igm["bf16"]["plain_ms"], "bound_ms_bf16": igm["bf16"]["bound_ms"],
        "bound_by_bf16": igm["bf16"]["bound_by"], "library_ms_bf16": igm["bf16"]["library_ms"],
        "variant": "input_grad_kernel<float, KD, MIP = true>, input_grad_mma<KD, MIP = true> (bf16)",
        "rows": igm["rows"], "flops": igm_flops, "bytes": igm_bytes,
        **{f"{m}{'' if k == 'f32' else '_bf16'}": igm[k][m] for k in ("f32", "bf16")
           for m in ("rel_err", "var_rel_err", "point_ms", "share_of_bound", "fault_err")},
        "b2_mip_dx": {k: {m: v for m, v in pmk[f"b2_{k}"].items()} for k in ("f32", "bf16")},
        "step_profile_ms_bf16": pmt["profile"].get("input grad"),
        "pose_mip_step": {k: v for k, v in pmt.items()}, "pose_proposal_step": {k: v for k, v in ppt.items()}}
    # the contracted instantiations (csrc/fused_contract.cu) as each kernel
    # runs them, at the unbounded batch: the work of the kernel without
    # contract (the contraction's ~30 operations a row are below its
    # rounding), the same bytes
    c_rows = ck["point_f32"]["rows"]

    def contract_entry(kernel, replaces, launches, flops, nbytes, **extra):
        st = {dt: ck[f"point_{dt}"] for dt in ("f32", "bf16")}
        return {"name": "fwd_tile (contract)", "route": "cuda", "source": "nerf_simple_tpu_torch/csrc/fused_contract.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(ck[f"{f}_f32"][f"{kernel}_err"] for f in ("point", "mip") if f"{kernel}_err" in
                                   ck[f"{f}_f32"]),
                "ms": st["f32"][f"{kernel}_ms"], "plain_ms": st["f32"][f"{kernel}_plain_ms"], **bounds(flops, nbytes),
                "library_ms": None,
                "max_abs_err_bf16": max(ck[f"{f}_bf16"][f"{kernel}_err"] for f in ("point", "mip") if f"{kernel}_err"
                                        in ck[f"{f}_bf16"]),
                "ms_bf16": st["bf16"][f"{kernel}_ms"], "plain_ms_bf16": st["bf16"][f"{kernel}_plain_ms"],
                "library_ms_bf16": None, "rows": c_rows,
                **{f"{k}_{f}_{dt}": ck[f"{f}_{dt}"][k] for f in ("point", "mip") for dt in ("f32", "bf16")
                   for k in (f"{kernel}_inside_bit_equal", f"{kernel}_rel") if k in ck[f"{f}_{dt}"]}, **extra}

    contract = {
        "fwd": contract_entry("fwd", "nerf_simple_tpu/kernels/mlp.py:437-456 (_encode's contract branch), reached "
                              "from :669", ct["launches"]["forward_contract_all"], 2 * fwd_macs * c_rows, 64 * c_rows,
                              ms_no_contract=ck["point_f32"]["fwd_none_ms"],
                              ms_no_contract_bf16=ck["point_bf16"]["fwd_none_ms"],
                              fault_err={k: v["fault_err"] for k, v in ck.items() if isinstance(v, dict)
                                         and "fault_err" in v}, sass_vs_earlier=ck.get("sass"),
                              c_launches=ct["launches"]["c_contract"]),
        "b2": contract_entry("b2", "nerf_simple_tpu/kernels/mlp.py:437-456 (_encode's contract branch), reached from "
                             "B2's recompute :1147", ct["launches"]["b2_contract"], 2 * train_macs * c_rows,
                             64 * c_rows + grad_bytes),
        "b1": contract_entry("b1", "nerf_simple_tpu/kernels/mlp.py:437-456 (_encode's contract branch), reached from "
                             ":1623", ct["launches"]["b1_contract_all"] + cmip["launches"]["contract"],
                             2 * train_macs * c_rows, 68 * c_rows + grad_bytes,
                             ms_no_contract=ck["point_f32"]["b1_none_ms"],
                             ms_no_contract_bf16=ck["point_bf16"]["b1_none_ms"],
                             launches_360=ct["launches"]["b1_contract_all"], launches_mip=cmip["launches"]["contract"],
                             c360_step={k: v for k, v in ct.items() if k != "launches"}, mip_contract=cmip),
        "b3": contract_entry("b3", "nerf_simple_tpu/kernels/mlp.py:437-456 (_encode's contract branch), reached from "
                             ":1734", ct["launches"]["b3_contract"], 2 * fwd_macs * c_rows, 96 * c_rows),
    }
    # the contracted forward with the windows and the codes, B2 with the
    # contract input gradient (phase 17a), and their launches on the main
    # path (17b-d)
    nets = {k: {m: v for m, v in r.items() if m != "exp"} for k, r in pcn.items()}
    nets_dx = sum(r["launches"]["input_grad_contract"] for k, r in pcn.items() if k != "served")
    contract["fwd"].update(
        windows_codes={k: {m: v for m, v in pck[k].items() if m.startswith("fwd_")} for k in ("f32", "bf16")},
        launches_pose_app=pct["launches"]["forward_contract"] + pca["launches"]["forward_contract"],
        launches_app=pca["launches"]["forward_app"], launches_windows=pca["launches"]["forward_anneal"])
    contract["b2"].update(
        want_dx={k: {m: v for m, v in pck[k].items() if not m.startswith("fwd_")} for k in ("f32", "bf16")},
        launches_dx=pct["launches"]["b2_dx"] + pca["launches"]["b2_dx"], launches_app=pca["launches"]["b2_app"],
        launches_windows=pca["launches"]["b2_anneal"])
    contract["b1"].update(launches_pose=pct["launches"]["b1_contract"])
    igc = pck["input_grad"]
    igc_flops, igc_bytes = input_grad_work(NerfMLP(contract=True), igc["rows"], torch.float32)
    input_grad_contract = {
        "name": "input_grad_contract", "route": "cuda", "source": "nerf_simple_tpu_torch/csrc/fused_contract.cu",
        "replaces": "nerf_simple_tpu/kernels/mlp.py:898-906, :933-938 (_input_grad_tile's contract branch), "
                    ":733-746 (_bwd_kernel's want_dx)",
        "launches": pct["launches"]["input_grad_contract"] + pca["launches"]["input_grad_contract"] + nets_dx,
        "max_abs_err": igc["f32"]["max_abs_err"], "ms": igc["f32"]["ms"], "plain_ms": igc["f32"]["plain_ms"],
        "bound_ms": igc["f32"]["bound_ms"], "bound_by": igc["f32"]["bound_by"], "library_ms": igc["f32"]["library_ms"],
        "max_abs_err_bf16": igc["bf16"]["max_abs_err"], "ms_bf16": igc["bf16"]["ms"],
        "plain_ms_bf16": igc["bf16"]["plain_ms"], "bound_ms_bf16": igc["bf16"]["bound_ms"],
        "bound_by_bf16": igc["bf16"]["bound_by"], "library_ms_bf16": igc["bf16"]["library_ms"],
        "variant": "input_grad_kernel<float, KD or KDA, MIP = false, CONTRACT = true>, input_grad_mma<KD or KDA, "
                   "MIP = false, CONTRACT = true> (bf16; csrc/input_grad.cuh)",
        "rows": igc["rows"], "inside_rows": igc["inside_rows"], "flops": igc_flops, "bytes": igc_bytes,
        **{f"{m}{'' if k == 'f32' else '_bf16'}": igc[k][m] for k in ("f32", "bf16")
           for m in ("rel_err", "point_ms", "share_of_bound", "fault_err", "inside_bit_equal")},
        "launches_pose": pct["launches"]["input_grad_contract"], "launches_app": pca["launches"]["input_grad_contract"],
        "step_profile_ms_bf16": pct["profile"].get("input grad"),
        "launches_nets": nets_dx, "c360_pose": {k: v for k, v in pct.items() if k != "pert"}, "c360_app": pca,
        "contract_nets": nets}
    # the input gradient's MIP && CONTRACT instantiation alone and in B2 (phase 18a), its launches on the main path
    # (18c-d: the 360 recipe + mip + its pose block before the freeze, pose + mip + contract)
    igm = m3k["input_grad"]
    igm_flops, igm_bytes = input_grad_work(NerfMLP(contract=True), igm["rows"], torch.float32, mip=True)
    m3_dx = {k: r["launches"]["input_grad_mip_contract"] for k, r in m3p.items()}
    input_grad_mip_contract = {
        "name": "input_grad_mip_contract", "route": "cuda", "source": "nerf_simple_tpu_torch/csrc/fused_contract.cu",
        "replaces": "nerf_simple_tpu/kernels/mlp.py:972-983, :1034-1064 (_input_grad_tile_mip's contract branch), "
                    ":738-742 (_bwd_kernel's want_dx under mip)",
        "launches": sum(m3_dx.values()), "max_abs_err": igm["f32"]["max_abs_err"], "ms": igm["f32"]["ms"],
        "plain_ms": igm["f32"]["plain_ms"], "bound_ms": igm["f32"]["bound_ms"], "bound_by": igm["f32"]["bound_by"],
        "library_ms": igm["f32"]["library_ms"], "max_abs_err_bf16": igm["bf16"]["max_abs_err"],
        "ms_bf16": igm["bf16"]["ms"], "plain_ms_bf16": igm["bf16"]["plain_ms"], "bound_ms_bf16": igm["bf16"]["bound_ms"],
        "bound_by_bf16": igm["bf16"]["bound_by"], "library_ms_bf16": igm["bf16"]["library_ms"],
        "variant": "input_grad_kernel<float, KD, MIP = true, CONTRACT = true>, input_grad_mma<KD, MIP = true, "
                   "CONTRACT = true> (bf16; csrc/input_grad.cuh)",
        "rows": igm["rows"], "inside_rows": igm["inside_rows"], "flops": igm_flops, "bytes": igm_bytes,
        **{f"{m}{'' if k == 'f32' else '_bf16'}": igm[k][m] for k in ("f32", "bf16")
           for m in ("rel_err", "var_rel_err", "mip_ms", "share_of_bound", "fault_err", "inside_bit_equal")},
        "launches_by_run": m3_dx, "step_profile_ms_bf16": m3p["pose"]["profile"].get("input grad"),
        "b2": {k: dict(m3k[k]) for k in ("f32", "bf16")}, "m360_pose": m3p}
    # occupancy (phase 20): the density probe is the forward at one refresh's
    # rows (xyz and dirs read, the 8 output rows written); B1 at the
    # sampler's ts is the point launch at Nf 64
    occ_rows = occk["rows"]
    occ_forward = {
        **mip_fields({k: dict(err=occk[k]["err"], ms=occk[k]["ms"], plain_ms=occk[k]["plain_ms"]) for k in ("f32", "bf16")},
                     2 * fwd_macs * occ_rows, 64 * occ_rows,
                     occt["launches"]["refreshes"] + occe["eval_launches"] + occe["mesh_launches"], rows=occ_rows,
                     refresh_ms_bf16=occk["refresh_ms"], sampler_ms=occk["sampler_ms"],
                     launches_train=occt["launches"]["fused_mlp_forward"], launches_eval=occe["eval_launches"],
                     launches_mesh=occe["mesh_launches"], mesh_s=occe["mesh_s"], mesh_faces=occe["mesh_faces"]),
        "source": "nerf_simple_tpu_torch/csrc/fused_mlp_fwd.cu (ops/occupancy.py::density_fn)",
        "replaces": "nerf_simple_tpu/kernels/mlp.py:669, reached from nerf_simple_tpu/ops/occupancy.py:187-208 (JAX "
                    "probes with XLA there)"}
    occ_b1 = {"launches": occt["launches"]["fused_train_step"], "refreshes": occt["launches"]["refreshes"],
              "train": {k: v for k, v in occt.items() if k != "launches"},
              "eval_psnr": occe["psnr_occ"], "eval_psnr_stratified": occe["psnr_strat"],
              "eval_psnr_low_n": occe["psnr_low_n"],
              "served_ms": occe["served_ms"]}
    probe_bound = {K: bound_ms(2 * pad_passes.M * K * probe["TR"] * probe["reps"], 0, torch.bfloat16)
                   for K in probe["K"]}
    fwd_bound_bf16 = bound_ms(2 * fwd_macs * chunk_rows, 64 * chunk_rows, torch.bfloat16)
    print(smi)
    print(json.dumps({"kernels": [
        entry("fused_mlp_forward", "fused_mlp_fwd.cu", "nerf_simple_tpu/kernels/mlp.py:669",
              serve_launches, fwd, (2 * fwd_macs * chunk_rows, 64 * chunk_rows),
              tflops_bf16=2 * fwd_macs * chunk_rows / (fwd["bf16"]["ms"] * 1e9),
              share_of_bound_bf16=fwd_bound_bf16 / fwd["bf16"]["ms"],
              tflops=fwd["f32"]["tflops"], share_of_bound=fwd["f32"]["share_of_bound"],
              mm_tflops_f32=fwd["f32"]["mm_tflops"],
              source_f32="nerf_simple_tpu_torch/csrc/fwd_f32.cuh", before_after_f32=fwd_turns or None,
              before_after_bf16=fwd_turns_bf16 or None,
              source_bf16="nerf_simple_tpu_torch/csrc/fwd_bf16.cuh",
              frame_ms=frame_ms["pallas"], plain_frame_ms=frame_ms["xla"],
              train_launches=tr["launches"]["fused_mlp_forward"], eval_launches=ev["launches"],
              proposal_eval_launches=pe["launches"], proposal_frame_launches=pe["frame_launches"],
              proposal_served_launches=pe["served_launches"], proposal_frame_ms_bf16=pe["frame_ms"],
              eval_psnr=ev["psnr"], eval_s_per_still=ev["s_per_still"], eval_s_per_frame=ev["s_per_frame"],
              mip=mip_forward, anneal=anneal, app=app_forward, contract={**contract["fwd"], "name": "fused_mlp_forward"},
              occupancy=occ_forward),
        entry("fused_mlp_backward", "fused_mlp_bwd.cu", "nerf_simple_tpu/kernels/mlp.py:1147",
              tr["b2_launches"], b2, (2 * train_macs * batch_rows, 64 * batch_rows + grad_bytes),
              grad_rel_err=b2["f32"]["rel"], grad_rel_err_bf16=b2["bf16"]["rel"], mip=mip_backward, want_dx=want_dx,
              app=app_backward, contract={**contract["b2"], "name": "fused_mlp_backward"}),
        {"name": "input_grad", "route": "cuda", "source": "nerf_simple_tpu_torch/csrc/input_grad.cuh",
         "replaces": "nerf_simple_tpu/kernels/mlp.py:871-938 (_input_grad_tile), :733-746 (_bwd_kernel's want_dx), "
                     ":865-868 (the encoded inputs' cotangents)",
         "launches": poset["launches"]["input_grad"], "max_abs_err": ig["f32"]["max_abs_err"], "ms": ig["f32"]["ms"],
         "plain_ms": ig["f32"]["plain_ms"], "bound_ms": ig["f32"]["bound_ms"], "bound_by": ig["f32"]["bound_by"],
         "library_ms": ig["f32"]["library_ms"], "max_abs_err_bf16": ig["bf16"]["max_abs_err"],
         "ms_bf16": ig["bf16"]["ms"], "plain_ms_bf16": ig["bf16"]["plain_ms"], "bound_ms_bf16": ig["bf16"]["bound_ms"],
         "bound_by_bf16": ig["bf16"]["bound_by"], "library_ms_bf16": ig["bf16"]["library_ms"], "rows": ig["rows"],
         "rel_err": ig["f32"]["rel_err"], "rel_err_bf16": ig["bf16"]["rel_err"],
         "rel_err_windows": ig["f32_anneal"]["rel_err"], "rel_err_windows_bf16": ig["bf16_anneal"]["rel_err"],
         "ms_windows": ig["f32"]["ms_anneal"], "ms_windows_bf16": ig["bf16"]["ms_anneal"],
         "share_of_bound": ig["f32"]["share_of_bound"], "share_of_bound_bf16": ig["bf16"]["share_of_bound"],
         "flops": ig_flops, "bytes": ig_bytes,
         "step_profile_ms_bf16": poset["profile"].get("input grad"), "app": app_input_grad,
         "launches_f32": poser["input_grad_f32_launches"]},
        input_grad_mip,
        input_grad_contract,
        input_grad_mip_contract,
        entry("fused_train_step", "fused_train_step.cu", "nerf_simple_tpu/kernels/mlp.py:1623",
              tr["launches"]["fused_train_step"], b1, (2 * train_macs * batch_rows, 64 * batch_rows + grad_bytes),
              grad_rel_err=b1["f32"]["rel"], grad_rel_err_bf16=b1["bf16"]["rel"],
              loss_rel_err=b1["f32"]["loss_err"], loss_rel_err_bf16=b1["bf16"]["loss_err"],
              step_ms_bf16=tr["step_ms"], step_host_ms_bf16=tr["host_ms"], step_profile_ms_bf16=tr["profile"],
              before_after=before and {**before, "step": tr["turns"]},
              out_weights={"launches": ht["launches"]["weights_output"], "passes": hier_b1},
              launches_hierarchical=ht["launches"]["fused_train_step"],
              hierarchical_step_ms_bf16=ht["step_ms"], hierarchical_step_host_ms_bf16=ht["host_ms"],
              hierarchical_step_profile_ms_bf16=ht["profile"], hierarchical_peak_gb=ht["peak_gb"],
              hierarchical_f32_loss_rel=ht["loss_rel_f32"], hierarchical_f32_bin_flips=ht["bin_flips"],
              hierarchical_frame_ms_bf16=he["frame_ms"], hierarchical_eval_psnr=he["psnr"],
              hierarchical_eval_s_per_still=he["s_per_still"], b2_rel_err_1m_rows=hk["B2_f32"]["rel"],
              b2_rel_err_1m_rows_bf16=hk["B2_bf16"]["rel"], kernel_phase_peak_gb=hk["peak_gb"], dist=dist,
              weights_dist_launches=pt["launches"]["weights_and_rail"], proposal=proposal, mip=mip_train,
              contract={**contract["b1"], "name": "fused_train_step"},
              mip_proposal={**m3t, "launches_pose": m3p["pose"]["launches"]["b1"]},
              occupancy=occ_b1,
              multiscale={"launches": mst["launches"]["mip_launches"], "weights_launches": mst["launches"][
                  "weights_launches"], "c_launches": {k: mst["launches"][k] for k in ("wgrad_sums", "bwd_tile")},
                  "max_abs_err": msk["f32"]["err"], "ms": msk["f32"]["ms"], "plain_ms": msk["f32"]["plain_ms"],
                  **bounds(2 * train_macs * msk["rows"], 4 * 15 * msk["rows"] + grad_bytes), "library_ms": None,
                  "max_abs_err_bf16": msk["bf16"]["err"], "ms_bf16": msk["bf16"]["ms"],
                  "plain_ms_bf16": msk["bf16"]["plain_ms"], "library_ms_bf16": None,
                  "source": "nerf_simple_tpu_torch/csrc/fused_train_step.cu (the mip branch; row 14's weight, "
                            "rows 11..13 from each ray's cone)",
                  "replaces": "nerf_simple_tpu/kernels/mlp.py:1623 (the mip branch of _train_kernel, row 14 :1406)",
                  "batch": {k: v for k, v in msk.items() if k not in ("f32", "bf16")},
                  "cases": {k: msk[k] for k in ("f32", "bf16")}, "train": mst, "data_options": dopt}),
        entry("wgrad_sums", "wgrad.cuh", "nerf_simple_tpu/kernels/mlp.py:774",
              tr["launches"]["wgrad_sums"], sums, (wg_flops, wg_bytes, wg_bytes_bf16),
              (wg["f32"]["library_ms"], wg["bf16"]["library_ms"]),
              replaces_also="nerf_simple_tpu/kernels/mlp.py:1081",
              ms_twelve_calls=wg["f32"]["ms_single"], ms_twelve_calls_bf16=wg["bf16"]["ms_single"],
              rel_err_f64=wg["f32"]["rel_err"], rel_err_f64_bf16=wg["bf16"]["rel_err"],
              plain_rel_err_f64=wg["f32"]["plain_rel_err"], plain_rel_err_f64_bf16=wg["bf16"]["plain_rel_err"]),
        entry("bwd_tile", "bwd_f32.cuh", "nerf_simple_tpu/kernels/mlp.py:808",
              tr["f32_tile_launches"], tile, (tile_flops, tile_bytes, tile_bytes_bf16),
              launches_bf16=tr["launches"]["bwd_tile"],
              replaces_also="nerf_simple_tpu/kernels/mlp.py:757", source_bf16="nerf_simple_tpu_torch/csrc/bwd_bf16.cuh",
              before_after_f32=tile_turns or None,
              share_of_bound=bt["f32"]["share_of_bound"], share_of_bound_bf16=bt["bf16"]["share_of_bound"],
              tflops=bt["f32"]["tflops"],
              rel_err=bt["f32"]["rel_err"], rel_err_bf16=bt["bf16"]["rel_err"],
              gb_s_bf16=bt["bf16"]["gb_s"], probe_launches=bt["bf16"]["launches"],
              step_profile_ms_bf16=tr["profile"].get("bwd_tile")),
        entry("fused_render", "fused_render.cu", "nerf_simple_tpu/kernels/mlp.py:1734",
              render_launches, rnd, (2 * fwd_macs * chunk_rows, 96 * chunk_rows),
              frame_ms=fused_frame_ms["f32"]["fused"], unfused_frame_ms=fused_frame_ms["f32"]["unfused"],
              frame_ms_bf16=fused_frame_ms["bf16"]["fused"],
              unfused_frame_ms_bf16=fused_frame_ms["bf16"]["unfused"], contract={**contract["b3"], "name": "fused_render"},
              occupancy={"launches": occe["b3_launches"], "frame_err": occe["frame_err"]}),
        {"name": "pad_passes_probe", "route": "cuda",
         "source": "nerf_simple_tpu_torch/csrc/pad_passes_probe.cu",
         "replaces": "scripts/pad_passes_probe.py:82", "launches": probe_launches,
         "max_abs_err": max(v["max_abs_err"] for v in probe["K"].values()),
         "ms": probe["K"][72]["ms"], "plain_ms": probe["K"][72]["plain_ms"],
         "bound_ms": probe_bound[72], "bound_by": "operations", "library_ms": None,
         "K": {str(K): {"ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": probe_bound[K],
                        "tflops": v["tflops"], "rel_err": v["rel_err"]} for K, v in probe["K"].items()},
         "TR": probe["TR"], "reps": probe["reps"], "K72_over_K128": probe["K72_over_K128"],
         "K72_over_K80": probe["K72_over_K80"], "K40_over_K128": probe["K40_over_K128"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


# every phase function's wall: printed as it ends (also when a check
# fails) and together after the phase walls
SUBWALLS: dict = {}


def _timed(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            wall = time.perf_counter() - t0
            SUBWALLS[fn.__name__] = SUBWALLS.get(fn.__name__, 0.0) + wall
            print(f"wall of {fn.__name__}: {wall:.1f} s", flush=True)
    return run


for _name in [n for n in globals() if n.startswith("phase_")]:
    globals()[_name] = _timed(globals()[_name])

if __name__ == "__main__":
    main()
