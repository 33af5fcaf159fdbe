#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--physics-epochs N] [--adjoint-epochs N] [--adams-epochs N]

Imports nothing of JAX.  Phases, one JSON line each; any failure raises,
so the exit code is non-zero:

  build      compiles every ``graph_odenet_tpu_torch/csrc/*.cu`` with nvcc
             (one process per source, all at once) into
             ``graph_odenet_tpu_torch/_build/``; the ptxas register and
             spill lines of every kernel.
  kernel     ``spmm_csr`` forward and backward on the card against the plain
             version ``spmm_csr_reference`` run in float64 on the same inputs
             (rtol = atol = 1e-5; see ``check_kernel``), on the Pubmed twin at
             F = 16 and F = 3, a
             hub graph and the bench graph (169,343 nodes, zipf(1.8)
             receivers, F = 128); ms per fwd+bwd for the kernel and for the
             plain version in float32 through autograd, for the bare pair
             ``csr_reduce(x)`` + ``csr_reduce(g, transpose=True)`` beside
             the bare ``torch.sparse.mm`` pair, and for cuSPARSE through
             autograd; each wrapper call's host µs, device µs and device
             launches (``call_costs``).  The run fails if a call launches
             more than one kernel or any kernel but ``csr_reduce_kernel``;
             fewer launches than calls is reported as the profiler's miss
             (``profiler_missed``), not failed.
  host_parts the parts of a wrapper call's host cost, 10,000 calls each: the
             current stream by three public routes, ``torch.empty``, and the
             C entry called as the wrapper calls it, with F = 0 (it returns
             before launching).
  attention  the GAT kernels (gat_fwd, gat_bwd, gat_dwh and the weighted
             SpMM) against their plain versions in float64 on the same
             inputs, and the Functions' values and gradients against the
             plain path in float64 (``ATT_TOL``; see ``check_attention``),
             on the Citeseer twin (H=8/F=8 with dropout 0.6, H=1/F=64,
             H=1/F=6), two hub graphs and the bench graph; ms per fwd+bwd
             of ``attention_aggregate`` through the kernels and through the
             plain version in float32; each kernel wrapper's host µs, device
             µs and device launches per call (``call_costs``).  The run fails
             if a ``gat_fwd``, ``gat_bwd`` or ``gat_dwh`` call launches more
             than one kernel or any kernel but its own, at any shape (the hub
             graphs' split rows included).
  slice      trains ``pubmed-gcnode`` (GCN-ODE, rk4, 200 epochs with early
             stop) on the card, checks that it went through the kernel and
             reached test accuracy >= 0.65, and holds the trained model's
             log-probs through the kernel against the segment path.
  gat_slice  trains config 2 (GAT-ODE, dopri5_scan, on the Citeseer twin) on
             the card through the GAT kernels to test accuracy >= 0.60, and
             holds the trained model's log-probs against the segment path.
  dense      one GCN-ODE fwd+bwd at Pubmed size through dense Â, the kernel
             and the segment path.
  bucket     the CSR kernel's bucket mode (B2) on the full arxiv twin
             partitioned into P = 8 (64 buckets of 21,168 rows) and P = 1:
             every bucket's forward (CSR view), backward (CSC view) and
             positional form, written into NaNs, against the plain version
             in float64 at TOL, upstream the gradient of ``sum(sin(·))``;
             each receiver block's buckets in the ring's order (the first
             written, the rest added in place), forward and backward,
             against the single-device ``spmm_csr``; ms of fwd+bwd over all
             buckets, kernel and plain version (float32) and cuSPARSE, and
             the kernel with zero-filled outputs that every bucket adds
             into (``zero_fill_add_ms``), the form without the write; host
             µs, device µs and device launches per call of the write and the
             add form (``call_costs``).  At P = 1 (the cells' shape) also
             the footprint probe (``footprint_probe``: F = 128 with the
             columns remapped ``col % R``, so the gathered table shrinks
             and nothing else changes) and the SHA-256 of the forward and
             backward calls' outputs at F = 256 on seeded inputs, written
             and added (``bucket_digests``), which ``chip_ab.py`` compares
             across trees.
  config4    ``run_config(4)`` (edge-partitioned GCN-ODE, one part on one
             card) on the full arxiv twin through the bucket kernel, after
             one training step through the kernel held against the same step
             through the plain versions (dropout 0; ``CONFIG4_RTOL``; the
             plain sums in a fixed order, see ``fixed_order_sums``), and a
             ``torch.profiler`` breakdown of three training steps.
  library    ``torch.sparse.mm`` on a CSR tensor (cuSPARSE) for the
             function B1 and B2 compute, fwd+bwd, at the bench shape, the
             Pubmed F = 16 shape and the arxiv F = 256 shape; used nowhere
             in the port.
  bucket_weighted
             the weighted bucket mode (B2-w) on the calibrated arxiv twin:
             at P = 1 the sharded GAT-ODE's three shapes (H=4/F=64, H=1/F=256,
             H=1/F=40), forward over the CSR view and backward over the CSC
             view with the numerators permuted, written into NaNs and added
             into a random output, and at P = 8 all 64 buckets at H=4/F=64,
             each receiver block's buckets also in the ring's order, against
             the plain version in float64 at TOL.  The numerators are each
             receiver's softmax (positive, summing to 1) and the backward's
             upstream is the gradient of ``sum(sin(·))``, so the hub rows'
             sums do not cancel.  ms of fwd+bwd at P = 1 for the kernel, the
             plain version (float32) and, for H = 1, cuSPARSE on CSR tensors
             whose values are the numerators (and the kernel against
             cuSPARSE alone, in turns over ``LONG_ITERS`` iterations); ms of
             the backward's plain ``dpv`` gathers; host µs, device µs and
             device launches per forward call.  B2-w's per-edge dot
             (``edge_dot``, the backward's ``dpv``) at the three shapes and
             on every bucket at P = 8 against its plain version in float64
             (``_dot_err``), two calls bit-equal; its ms beside the plain
             ``dpv``'s, its bound, and its host µs, device µs and device
             launches per call (one launch of ``edge_dot_kernel``).  At the
             F = 256 shapes the SHA-256 of each call's output on seeded
             inputs, as in ``bucket``, and at H = 1 the footprint probe.
  softmax_passes
             the attention softmax's order-free passes on the calibrated
             arxiv twin at P = 1: ``gather_rows`` against ``index_select``
             and ``segment_max`` against ``scatter_reduce`` ("amax" from the
             floor), each bit for bit, at H = 1 and 4 in f32 with the
             receivers in CSR order and in ``t_perm``'s (CSC) order; ms of
             each and of its PyTorch call in turns, the bound by bytes, and
             host µs and device µs per call of both, and device launches per
             call (one of ``gather_rows_kernel`` or, rows of 2, 4 or 8 bytes,
             ``gather_packed_kernel``; one of ``segment_max_kernel`` beside
             the fill of the floor).
  config4_gat
             the edge-partitioned GAT-ODE (hidden 64 × 4 heads, rk4 × 4,
             dropout 0.6, ``ring_pallas``, ``remat``) on the full calibrated
             arxiv twin through ``fit_sharded_node_classifier``, 6 epochs, one
             part on one card, after one training step (dropout 0) through the
             kernel held against the same step through the plain versions of
             the bucket mode and the per-edge dot and against ``mode="ring"``
             (``CONFIG4_RTOL``); B2-w's launches and the per-edge dot's (18 a
             training step, none in an evaluation);
             peak device memory and ms of a step with ``remat`` on and off,
             and a ``torch.profiler`` breakdown of three training steps.
  physics    config 3 (interaction-network ODE on spring n-body data; no
             kernel on its path).  (a) In float64, 8 windows of the config's
             data through a freshly initialised full-width INODE
             (dopri5_scan, 16 attempts, remat): one batched solve against 8
             one-sample solves of the same form, per-sample accept and reject
             counts equal and trajectories within ``PHYS_REL``; and one
             window-loss gradient on the card against the same on the CPU
             within ``PHYS_GRAD_REL`` (the IN's ``index_add_`` in a fixed
             order, see ``fixed_order_sums``).  A ``torch.profiler``
             breakdown of training steps of both models at batch 512.  (b)
             ``physics_rollout_curves`` at full width (6 bodies, 256 sims ×
             200 steps, batch 512, relation MLP 4 × 150 → 50, object MLP 100,
             window 10, horizon 50) for ``PHYS_EPOCHS`` epochs, the cut
             printed (``--physics-epochs 20``: the config's own epochs,
             through ``run_config(3, rollout=50)``): s/epoch of both
             trainers, both losses per epoch (each must fall and stay
             finite), the solver's attempts per interval and host reads per
             forward, peak device memory, and the rollout MSE of both models
             at horizons 1, 5, 10, 20 and 50 (the IN-ODE's must end below the
             discrete IN's).
  adjoint    the continuous and the checkpointed adjoint (``odeint_adjoint``)
             on the calibrated Pubmed twin.  (1) For ``pubmed-gcnode`` (B1)
             and ``pubmed-gatode`` (B3-B5, the score hint, hash attention
             dropout 0.6 in the encoder) with each adjoint, one training step
             through the kernels in float32 against the same adjoint through
             the plain path in float64 (``ADJ_RTOL``), its backward profiled:
             the phase fails unless that backward launched the model's kernels
             (``ADJ_KERNELS``) and called no plain version; the gap to direct
             backprop is printed, not gated.  (2) ``pubmed-gatode`` at full
             width trained through ``fit_node_classifier`` with ``adjoint``
             False, True and ``"checkpoint"``, ``ADJ_EPOCHS`` epochs each
             (``--adjoint-epochs 300``: uncut, printed as ``epochs_cut_from``):
             s/epoch, test accuracy (>= 0.40, and >= 0.80 for the uncut
             checkpointed run), a falling loss, peak device memory, the last
             forward's solver stats, the dynamics' evaluations an epoch inside
             the backward and whether each reverse solve reached the first
             output time (counted by wrappers here), the host's reads in a
             step.  (3) Config 3's IN-ODE at full width with each adjoint: in
             float64 the batched adjoint's gradient over 8 windows against the
             sum of one solve per window (``PHYS_REL``), then one training step
             at batch 512 with each adjoint and with direct backprop
             (``remat``): wall ms, peak memory, evaluations.

  resume     (run after config4_gat, while both arxiv twins are built)
             config 4 at full width (the full arxiv twin, hidden 256, one
             part, B2, dropout 0.5) trained ``RESUME_EPOCHS`` epochs straight,
             then stopped after the first ones with a checkpoint every epoch,
             everything dropped, and resumed to the end in a fresh call: the
             losses must be bit-equal.  The same for the sharded GAT-ODE
             (``ring_pallas``, dropout 0.6, ``remat``; B2-w) on the calibrated
             twin, its losses within ``RESUME_GAT_RTOL`` (its plain per-edge
             passes add with atomics).  The checkpoint's bytes and each save's
             and restore's ms.
  solvers    the Adams family and VCABM through the kernels.  (1)
             ``pubmed-gcnode`` (B1) trained with rk4, ``implicit_adams``,
             ``explicit_adams`` and rk4 again, in turns: s/epoch, NFE a
             forward, test accuracy (each >= 0.65).  (2) One training step of GCN-ODE on ``adams`` and
             ``adams_scan`` (B1) and of ``pubmed-gatode`` on ``adams_scan``
             (B3-B5) through the kernels in float32 against the plain path in
             float64 (``SOLVER_RTOL``, see ``adjoint_step_check``), each solve
             reaching its end; GCN-ODE's continuous adjoint on
             ``implicit_adams`` against the plain path and against direct
             backprop (``SOLVER_ADJ_GAP``); the host reads of one forward per
             solver attempt.  (3) ``pubmed-gatode`` trained on ``adams_scan``
             and on ``dopri5_scan``, ``SOLVER_GAT_EPOCHS`` epochs each:
             s/epoch, test accuracy, host reads a step, peak memory.  (4)
             ``scipy_solver`` on a float64 card tensor against dopri5
             (``SCIPY_RTOL``).  (5) ``odeint_checked`` raises on a NaN made on
             the card.  (6) ``validate_tiling``'s host ms on the full arxiv
             twin's views.
  batched_adams
             config 3's IN-ODE on the batched VCABM (``adams_scan``, each
             window its own order and steps; no kernel on its path).  (a) In
             float64, 8 windows through a fresh full-width INODE: one batched
             solve against each window alone (a batch of copies of it, so
             that every kernel rounds its row as in the batch), per-sample
             ``nfe``, accepts, rejects and final order equal and trajectories
             within ``PHYS_REL``, the batch of one reported beside, not gated
             (VCABM's order rule turns its 1e-15 of other rounding into other
             steps), with two witnesses to that, not gated: the unbatched form
             beside it, and its counts under states scaled by 1 + k·2^-52
             where the batch of one differs; the same windows batched against
             one by one in float64 on the CPU; the batched continuous adjoint's gradient against the
             sum of the windows' alone (``PHYS_REL``); ``scipy_solver`` with
             ``batch_dims=1`` on a card tensor against each sample alone
             (``SCIPY_RTOL``).  (c) A ``torch.profiler`` breakdown of one
             training step at batch 512, and one forward's host reads, at
             most one an attempt round plus ``VCABM_FIXED_READS``.  (b)
             ``physics_rollout_curves`` on ``adams_scan`` at full width
             (config 3's data, batch, widths, window and 16 attempts an
             interval) for ``ADAMS_EPOCHS`` epochs (``--adams-epochs``, the
             cut printed): s/epoch, the window loss per epoch (must fall and
             stay finite), attempts per interval, final-order spread and
             success share, peak device memory, window MSE and the rollout
             MSE at horizons 1, 5, 10, 20 and 50 (finite); the physics
             phase's dopri5_scan figures beside.
  surfaces   (last) the bench functions, the CLI, ``entry()`` and A20 on the
             card.  (1) ``bench.spmm_bench()`` (the bench shape, F=128),
             ``gat_bench`` at H=8/F=8 with dropout 0.6, at H=1/F=128 and at
             H=8/F=8 with dropout 0.6 and ``use_scores=False`` (B1-w),
             ``ode_bench(representation="kernel")``, ``ode_model_bench`` of
             GCN-ODE and GAT-ODE with ``mode="train_step"`` and
             ``scaling_bench()`` on one card, each at the JAX package's
             defaults and with every kernel count from 0: each must launch
             its kernels and call no plain version.  (2) The CLI in
             subprocesses: ``node --dataset pubmed --calibrated --model
             gcnode --representation kernel`` for ``SURFACE_EPOCHS`` epochs
             with ``--ckpt-dir``, then ``predict``, whose test accuracy must
             equal ``node``'s best (both through B1, plain versions refused),
             and ``python -m graph_odenet_tpu_torch.cli bench spmm``.  (3)
             ``entry()``'s forward on the card against the same forward on
             the CPU in float64 (``SLICE_TOL``).  (4) A20 on the full arxiv
             twin at one part through B2, against the plain version in
             float64 at TOL: the two column halves at F=256 reduced apart
             and joined equal the whole, and ``[b, B, F]`` (one launch)
             equals ``b`` single calls.
  bf16       (after surfaces) the bfloat16 tier.  (a) Each bf16 entry against
             its plain version on the card on the same inputs: B1 fwd+bwd
             (``csr_reduce`` on bf16 features, forward and transposed) on the
             Pubmed twin at F = 16 and the bench graph at F = 128; B2 on the
             arxiv twin at P = 8 and P = 1, F = 256 (every bucket's write,
             add and CSC write forms); B4 and B5 on a bf16 Wh on the Citeseer
             twin (H=8/F=8 with hash dropout 0.6, H=1/F=64, H=1/F=6) and the
             bench graph (H=8/F=8 hash, H=1/F=128).  bf16 outputs within one
             bf16 ulp plus ``BF16_ATOL`` plus ``BF16_SUM_RTOL`` of the sum of
             their terms' magnitudes, the f32 outputs of B4/B5 at
             ``BF16_F32_TOL``; each call one launch of its own kernel, 20
             repeats bit-equal; ms of the bf16 call, the f32 call at the same
             shape and the plain version, the bound with 2-byte features, and
             ``torch.sparse.mm`` on bf16 CSR tensors or the error it raises.
             B2's bf16 launches on a path: ``spmm_sharded`` fwd+bwd at one
             part.  (b) ``pubmed-gcnode`` (B1) and config 2 (B3-B5) built
             with ``dtype=torch.bfloat16`` (``param_dtype`` float32) and with
             float32 from the same seed, trained by the trainer's recipe in
             the smoke's own loop: step-0 loss, s/epoch, test accuracy (the
             bf16 runs >= 0.65 and >= 0.60), peak memory, the kernel and bf16
             launches (none of a plain version), and the ODE state's dtype
             (bf16 for GCN-ODE, f32 for the GAT-ODE on the kernels).  (c)
             The sharded models at full width, one part: config 4's GCN-ODE
             (the arxiv twin, hidden 256, rk4 × 4) and the sharded GAT-ODE
             (the calibrated twin, 64 × 4 heads, ``ring_pallas``, ``remat``),
             each built with ``dtype=torch.bfloat16`` and bf16 features.
             One step (dropout 0) through the kernels against the plain
             versions on the card with their sums in a fixed order:
             log-probs and loss at ``BF16_STEP_TOL``, each gradient at its
             rtol with atol relative to its largest entry; then each model
             in bf16 and in f32 from the same seed trained in the smoke's
             own loop by the sharded trainer's recipe (Adam with weight
             decay, dropout, 30 and 6 epochs), the bf16 step profiled
             (``profile_steps``; the f32 steps' in phases config4 and
             config4_gat): step-0 and last loss, test
             accuracy, ``step_ms``, peak memory, the ODE state's and Adam's
             moments' dtypes, B2/B2-w launches by entry, plain calls.  The
             bf16 runs must lower their loss, pass PERF.md §2's accuracy
             limits (> 1/40, > 2/40), call no plain version, and launch B2's
             bf16 entry on every GCN-ODE layer (36 a step, 18 an
             evaluation) and B2-w's f32 entry on the widened chunk under the
             GAT-ODE (52 a step, 18 an evaluation).

Then the kernel table (each kernel's launches on its main path, error,
ms, plain ms, the bound of its work on an H100 and the library call's ms;
``adjoint_launches``: B1's in pubmed-gcnode's adjoint step checks, B3-B5's
in pubmed-gatode's training runs with either adjoint; ``solver_launches``:
B1's in the solvers phase's Adams trainings of pubmed-gcnode, B3-B5's in its
adams_scan training of pubmed-gatode; ``resume_launches``: B2's and B2-w's in
the resume phase's three runs of each model; ``surfaces_launches``: each
kernel's in the surfaces phase, CLI subprocesses included; ``bf16``: the
bf16 entry's figures from the bf16 phase for B1, B2, B4 and B5, its
``launches`` those of the bf16 model runs, for B2 config 4's in bf16 and
``spmm_sharded``'s beside; ``bf16_model_launches``: B2-w's under the bf16
sharded GAT-ODE),
the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
"""

import copy
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = dict(rtol=1e-5, atol=1e-5)
# The slice's log-probs pass through 18 aggregations, each summed in a
# different order by the kernel and by the segment path.
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)
MIN_TEST_ACC = 0.65
SPMM_PER_EPOCH = 54  # 18 forward + 18 backward in training, 18 in evaluation
# The GAT kernels against their plain versions in float64: 1e-5 on the
# Citeseer twin and the hub graphs.  On the bench graph 1e-4: there a row of
# the CSC view holds up to 164,913 edges, and a sum of that many random
# terms cancels to values near 1, which float32 in any order misses by more
# than 1e-5 (the plain version in float32 is reported beside the kernel).
ATT_TOL = dict(rtol=1e-5, atol=1e-5)
BENCH_ATT_TOL = dict(rtol=1e-4, atol=1e-4)
GAT_MIN_TEST_ACC = 0.60  # config 2; the JAX package reaches 0.696 ± 0.019, chance is 1/6
GAT_LAYERS = 3  # encoder, dynamics and readout: each epoch launches every kernel >= 3 times
# Config 4's one training step through the kernel against the plain versions:
# 18 aggregations of f32 sums in two orders, then gradients through all of
# them; atol is relative to each gradient's largest entry.
CONFIG4_RTOL = 1e-4
BUCKET_PARTS = (8, 1)
ARXIV_HIDDEN = 256  # config 4's width: the encoder's and the dynamics' aggregations
# The sharded GAT-ODE at full width: 4 heads of 64 in the encoder, one head of
# 256 in the dynamics, one head of 40 classes in the readout.
GAT_HIDDEN, GAT_HEADS, GAT_STEPS, GAT_EPOCHS = 64, 4, 4, 6
GAT_SHAPES = ((GAT_HEADS, GAT_HIDDEN), (1, GAT_HEADS * GAT_HIDDEN), (1, 40))
# Per training step 1 + 4·steps + 1 attention layers: each launches B2-w once
# forward and once backward, and the dynamics' layers once more when remat
# recomputes them; an evaluation runs the forward alone.
GAT_LAYERS_PER_FORWARD = 2 + 4 * GAT_STEPS
GAT_MIN_TEST_ACC_SHARDED = 2.0 / 40
# B2-w against cuSPARSE at H = 1, alternated in one call: at F = 40 ten
# iterations read 0.39 and 0.56 ms in two runs, either side of cuSPARSE.
LONG_ITERS = 100
# Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM and f32 outside the
# tensor cores.  A kernel's bound is the larger of its bytes and its flops over these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Config 3's checks: 8 windows in float64, batched against one by one (relative
# to the largest |value|), and one gradient on the card against the CPU.
PHYS_WINDOWS, PHYS_REL, PHYS_GRAD_REL = 8, 1e-10, 1e-8
PHYS_HORIZON, PHYS_HORIZONS = 50, (1, 5, 10, 20, 50)
# Config 3's epochs in the default run, cut from its 20 to keep the phase near
# a minute: an epoch of both trainers took 4.3–5.7 s (host-bound, PERF.md).
PHYS_EPOCHS = 6
# The adjoint phase.  (1) One training step through the kernels in float32
# against the same adjoint through the plain path in float64: rtol ADJ_RTOL,
# atol ADJ_RTOL of each gradient's largest entry plus ADJ_F32 times the plain
# path's own float32 error on it.  At initialisation the gradients of GAT-ODE's
# attention vectors are small sums that cancel, and the plain path in float32
# misses them by 2.4e-3 of their largest entry (CPU rehearsal at a third of
# the Pubmed twin); the kernel's rounding is of that size too.
ADJ_RTOL, ADJ_F32 = 1e-3, 4.0
# The kernels each model's adjoint backward must launch.
ADJ_KERNELS = {"gcnode": ("csr_reduce_kernel",),
               "gatode": ("gat_fwd_kernel", "gat_bwd_kernel", "gat_dwh_kernel")}
# ... and the backward of direct backprop through the steps.
BACKPROP_KERNELS = {"gcnode": ("csr_reduce_kernel",),
                    "gatode": ("gat_bwd_kernel", "gat_dwh_kernel")}
# (2) pubmed-gatode's epochs in the default run, cut from its 300 to keep the
# phase near a minute (on an H100 80GB HBM3 at 700 W, 40 epochs took
# 0.11-0.16 s each and reached test accuracy 0.845-0.850 with every adjoint);
# every run must learn (chance is 1/3), and the checkpointed adjoint's uncut
# run must reach 0.80 (the JAX package's adjoint seeds: 0.858-0.886,
# RESULTS.md; accuracies, not speeds).
ADJ_EPOCHS = 100
ADJ_MIN_TEST_ACC, ADJ_FULL_MIN_TEST_ACC = 0.40, 0.80
ADJOINTS = (True, "checkpoint")
# The solvers phase.  (1) pubmed-gcnode trained with each fixed-grid method (each
# must reach MIN_TEST_ACC).  (2) One step of GCN-ODE on adams and adams_scan and of
# GAT-ODE on adams_scan through the kernels in float32 against the plain path in
# float64 at SOLVER_RTOL (atol SOLVER_RTOL of each gradient's largest entry plus
# ADJ_F32 times the plain float32 path's own error), VCABM_STEPS attempts an
# interval; GCN-ODE's continuous adjoint on implicit_adams within SOLVER_ADJ_GAP of
# direct backprop (of each gradient's largest entry).  (3) pubmed-gatode trained
# SOLVER_GAT_EPOCHS epochs on adams_scan and on dopri5_scan.  (4) scipy_solver on a
# card tensor against dopri5, both at rtol 1e-10, within SCIPY_RTOL.
SOLVER_TRAIN_METHODS = ("rk4", "implicit_adams", "explicit_adams", "rk4")  # in turns
SOLVER_RTOL = 1e-5
VCABM_STEPS = 32  # the GAT-ODE recipe's attempt budget
SOLVER_ADJ_GAP = 1e-3
SOLVER_GAT_EPOCHS = 40
SCIPY_DIM, SCIPY_RTOL = 256, 1e-8
# The batched_adams phase: config 3's IN-ODE on adams_scan.  Its epochs in the
# default run, cut from the config's 20 to keep the phase near 90 s (on an H100
# 80GB HBM3 at 700 W an epoch took 8.8-9.8 s and the phase 107 s at 6 epochs,
# PERF.md); the reads of a forward besides one an attempt round (the copies of
# ts and of the γ* constants to the card); the samples of its scipy_solver
# check.
ADAMS_EPOCHS = 4
VCABM_FIXED_READS = 2
ADAMS_SCIPY_BATCH = 4
VALIDATE_REPEATS = 3
# The resume phase: epochs before the stop and in all.  Config 4 must resume bit
# for bit (B2 merges split rows in a fixed order); the sharded GAT-ODE's plain
# per-edge passes add with atomics, so its losses are held to RESUME_GAT_RTOL.
RESUME_EPOCHS = (4, 8)
RESUME_GAT_EPOCHS = (2, 4)
RESUME_GAT_RTOL = 1e-6
# The surfaces phase: the CLI's epochs of pubmed-gcnode, the batch of A20's
# leading axis and its width, and the kernels each bench record must launch.
SURFACE_EPOCHS, A20_BATCH, A20_F = 30, 4, 64
GAT_KERNELS = ("gat_fwd", "gat_bwd", "gat_dwh")
# The bf16 phase.  A bf16 output (B1, B2) is held within one bf16 ulp of the
# plain version's on the card plus BF16_ATOL plus BF16_SUM_RTOL times the sum
# of its terms' magnitudes (both round an f32 sum once, the sums in other
# orders, and where the terms cancel the two f32 sums differ by more than an
# ulp of the result: on an H100 the plain version's atomic order put B2's CSC
# write at the arxiv twin's hub senders at 1.73 of the tolerance without the
# sum term; tests/test_torch_bf16.py::test_smoke_bf16_check_allows_the_order_of_a_cancelling_sum);
# the f32 outputs of B4/B5 on a bf16 Wh at BF16_F32_TOL.  Every checked call
# is repeated BF16_REPEATS times, bit-equal.
BF16_ATOL = 1e-5
BF16_SUM_RTOL = 2.0 ** -20  # 16 f32 unit roundoffs
BF16_F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REPEATS = 20
# The one-step check of a bf16 sharded model against the plain versions on the
# card (tests/test_torch_bf16.py's tolerance): log-probs and loss; each
# gradient at the rtol with atol the rtol of its largest entry (a_dst's: of
# a_src's and a_dst's, as a_dst's gradient cancels to a residue that neither
# bf16 path resolves).
BF16_STEP_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_GAT_LIBRARY = ("none: no single PyTorch call computes a per-receiver softmax over the "
                    "edge logits and the weighted gather")
# The CLI's own main, run as a subprocess with every plain version refused; the
# kernels' launch counts follow its JSON line.
CLI_LAUNCHER = """
import json, sys
from graph_odenet_tpu_torch import cli
from graph_odenet_tpu_torch.ops import csr_spmm, gat_attn

def refuse(*args, **kw):
    raise AssertionError("a plain version ran on the card")

for mod, name in ((csr_spmm, "_reduce_plain"), (csr_spmm, "_bucket_reduce_plain"),
                  (csr_spmm, "_edge_dot_plain"), (gat_attn, "gat_fwd_plain"),
                  (gat_attn, "gat_bwd_plain"), (gat_attn, "gat_dwh_plain")):
    setattr(mod, name, refuse)
cli.main(sys.argv[1:])
print(json.dumps(dict(csr=csr_spmm.launches, csr_weighted=csr_spmm.weighted_launches,
                      bucket=csr_spmm.bucket_launches,
                      bucket_weighted=csr_spmm.bucket_weighted_launches,
                      edge_dot=csr_spmm.edge_dot_launches, **gat_attn.launches)))
"""


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def timed_ms(fn, iters):
    """Mean wall ms of ``fn()`` over ``iters`` calls, synchronised around the loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def alternate(fns, iters):
    """Time each of ``fns`` in the order a, b, b, a and average the two runs."""
    names = list(fns)
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append(timed_ms(fns[n], iters))
    return {n: sum(v) / len(v) for n, v in runs.items()}


def profiled(fn, calls):
    """``torch.profiler`` over ``calls`` calls of ``fn``: device µs and device
    launches per call, and the names of the kernels launched.  The profiler
    records a second round of the calls, with idle time before and after
    them (it can miss kernels in its first round and near the ends of its
    window); its step marks and the program's spans (``gode.*``, mirrored
    onto the device's timeline) are not kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            time.sleep(0.02)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
            prof.step()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("ProfilerStep", "gode."))]
    return dict(device_us=sum(e.self_device_time_total for e in kernels) / calls,
                launches_per_call=sum(e.count for e in kernels) / calls,
                kernels=sorted({e.key[:60] for e in kernels}))


def call_costs(fn, calls=1000, per=1, profile_calls=20):
    """What one wrapper call costs, ``fn()`` making ``per`` calls: host µs per
    call (``time.perf_counter`` around ``calls`` unsynchronised calls, the
    queue drained before; the clock stops before the closing drain), wall µs
    per call (the clock stops after it), and device µs and device launches
    per call from ``torch.profiler`` over ``profile_calls`` calls.  The
    profiler drops kernels now and then (3 of 64 in one run, 63 of 64 in
    another): a round that shows fewer launches than calls is profiled
    again, up to three times."""
    rounds = max(1, calls // per)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        fn()
    issued = time.perf_counter()
    torch.cuda.synchronize()
    done = time.perf_counter()
    for _ in range(3):  # a round that shows fewer launches than calls lost some: again
        dev = profiled(fn, max(1, profile_calls // per))
        if dev["launches_per_call"] >= per:
            break
    return dict(calls=rounds * per, host_us=(issued - t0) * 1e6 / (rounds * per),
                wall_us=(done - t0) * 1e6 / (rounds * per),
                device_us=dev["device_us"] / per, launches_per_call=dev["launches_per_call"] / per,
                kernels=dev["kernels"])


def phase_host_parts(dev, calls=10_000):
    """µs per call of the parts of a wrapper call's host cost (see the module doc)."""
    from graph_odenet_tpu_torch.ops import _build
    from graph_odenet_tpu_torch.ops.csr_spmm import csr_view

    def us(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e6 / calls

    x = torch.zeros(64, 64, device=dev)
    ptr, stream = x.data_ptr(), torch.cuda.current_stream(dev.index).cuda_stream
    plan = csr_view([0], [0], [1.0], 1, 1).to(dev).plan
    entry = _build.load_library("csr_spmm").gode_csr_reduce_f32
    parts = {
        "current_stream(device)": us(lambda: torch.cuda.current_stream(dev).cuda_stream),
        "current_stream(index)": us(lambda: torch.cuda.current_stream(dev.index).cuda_stream),
        "current_stream()": us(lambda: torch.cuda.current_stream().cuda_stream),
        "torch.empty": us(lambda: torch.empty((64, 64), device=dev)),
        "C entry, as the wrapper calls it": us(
            lambda: entry(plan.address, ptr, None, ptr, None, 0, 1, 0, 32, 4, 0, 0, stream)),
    }
    emit("host_parts", calls=calls, us_per_call=parts)
    return parts


def bound(n_bytes, n_flops):
    """Least ms an H100 could take for work that moves ``n_bytes`` (each
    input read once, each output written once) and does ``n_flops`` f32
    operations, and which of the two bounds it."""
    t_bytes, t_flops = n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_F32_FLOPS
    return dict(bound_ms=max(t_bytes, t_flops) * 1e3,
                bound_by="bytes" if t_bytes >= t_flops else "operations")


def spmm_work(n_rows, n_edge, f, accumulate=False, es=4):
    """(bytes, flops) of one SpMM ``out (+)= A x`` over a CSR view: x and out
    (read too when added into) of ``es`` bytes an element (4 f32, 2 bf16),
    int64 row pointers, int32 columns, f32 weights."""
    n_bytes = (3 if accumulate else 2) * n_rows * f * es + (n_rows + 1) * 8 + n_edge * 8
    return n_bytes, 2 * n_edge * f + (n_rows * f if accumulate else 0)


def weighted_bucket_work(n_rows, n_edge, h, f, accumulate=False):
    """(bytes, flops) of one weighted bucket reduction ``out (+)= A(pv) x`` at H
    = ``h``, F = ``f``: x and out (read too when added into), int64 row
    pointers, int32 columns, the f32 ``[L, H]`` numerators."""
    n_bytes = ((3 if accumulate else 2) * n_rows * h * f * 4 + (n_rows + 1) * 8 + n_edge * 4
               + n_edge * h * 4)
    return n_bytes, 2 * n_edge * h * f + (n_rows * h * f if accumulate else 0)


def edge_dot_work(n_rows, n_cols, n_edge, h, f):
    """(bytes, flops) of one per-edge dot (B2-w's ``dpv``) at H = ``h``, F =
    ``f`` over a view of ``n_rows`` rows gathering a table of ``n_cols``: the
    f32 table x and the f32 gradient g (each read once), int64 row pointers,
    int32 columns, the f32 ``[L, H]`` result."""
    return (n_cols * h * f * 4 + n_rows * h * f * 4 + (n_rows + 1) * 8 + n_edge * 4
            + n_edge * h * 4, 2 * n_edge * h * f)


def _dot_err(got, view, x, g, heads, feat):
    """(max abs err, max err / tolerance) of the per-edge dot ``got`` against
    its plain version in float64 on the same inputs (the sums in a fixed
    order, ``fixed_order_sums``), at 1e-5 + 1e-5 of the sum of the terms'
    magnitudes: the dots of random rows cancel, so a tolerance relative to
    the dot itself would measure the cancellation, not the kernel."""
    from graph_odenet_tpu_torch.ops.csr_spmm import _edge_dot_plain

    with fixed_order_sums(), torch.no_grad():
        want = _edge_dot_plain(view, x.double(), g.double(), heads, feat)
        scale = _edge_dot_plain(view, x.double().abs(), g.double().abs(), heads, feat)
    d = (got.double() - want).abs().nan_to_num(nan=float("inf"))
    if not d.numel():  # an empty bucket
        return 0.0, 0.0
    return float(d.max()), float((d / (1e-5 + 1e-5 * scale)).max())


def attention_work(kernel, n, e, h, f, es=4):
    """(bytes, flops) of one call of a GAT kernel or the weighted SpMM on a
    graph of ``n`` padded nodes and ``e`` edges at H = ``h``, F = ``f``: each
    input read once, each output written once, Wh in ``es`` bytes an element
    (4 f32, 2 bf16; every other array f32); the f32 operations of the
    softmax and the weighted sums (the dropout hash's integer operations not
    counted)."""
    return {
        "csr_spmm_weighted": (2 * n * h * f * 4 + (n + 1) * 8 + e * 4 + e * h * 4,
                              2 * e * h * f),
        "gat_fwd": (e * h * 4 + n * h * f * (es + 4) + (n + 1) * 8 + e * 4 + 2 * n * h * 4,
                    e * h * (2 * f + 5)),
        "gat_bwd": (e * h * 4 + n * h * f * (es + 4) + 3 * n * h * 4 + 2 * e * 4 + e * h * 4,
                    e * h * (2 * f + 6)),
        "gat_dwh": (4 * n * h * 4 + 2 * n * h * f * 4 + (n + 1) * 8 + e * 4,
                    e * h * (2 * f + 8)),
    }[kernel]


def bench_graph(from_edges, n_nodes=169_343, n_edges=1_166_243, seed=0, normalize="row"):
    """The graph of ``bench.py``'s ``build_graph``, built with the port."""
    rng = np.random.default_rng(seed)
    pop = rng.zipf(1.8, size=n_edges).astype(np.int64) % n_nodes
    src = rng.integers(0, n_nodes, size=n_edges)
    return from_edges(
        src, pop, n_node=n_nodes, normalize=normalize, node_multiple=128, edge_multiple=1024
    )


def hub_graph(from_edges):
    """Node 0 is cited by 1,500 random edges (as in tests/test_pallas.py)."""
    rng = np.random.default_rng(1)
    n = 200
    s = np.concatenate([rng.integers(0, n, size=1500), rng.integers(0, n, size=300)])
    r = np.concatenate([np.zeros(1500, dtype=np.int64), rng.integers(0, n, size=300)])
    return from_edges(s, r, n_node=n, normalize="row", node_multiple=128)


def phase_build():
    from graph_odenet_tpu_torch.ops import _build

    fresh = [n for n in _build.SOURCES if not _build.library_path(n).exists()]
    t0 = time.perf_counter()
    libs = _build.build()
    for name in libs:
        _build.load_library(name)
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name, lib in libs.items():
        report = lib.with_name(f"{lib.stem}.ptxas.txt").read_text().splitlines()
        ptxas[name] = [
            ln.strip() for ln in report
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln
        ]
    emit("build", seconds=seconds, compiled_now=fresh,
         libraries={n: os.path.relpath(p, ROOT) for n, p in libs.items()}, ptxas=ptxas)


def check_kernel(name, g, f, dev, iters, seed):
    """Kernel vs plain version at one shape.

    Checked at TOL against the plain version in float64: the values and the
    gradient of ``sum(sin(spmm(x)))``, the probe of the CPU parity tests.
    Reported, not checked: the error of the gradient for a random normal
    upstream, for the kernel and for the plain version in float32.  On a
    hub row of the bench graph such a sum cancels from tens of thousands of
    terms to a value near 1, and f32 rounding in any order exceeds 1e-5.
    """
    from graph_odenet_tpu_torch.ops import prepare, spmm_csr, spmm_csr_reference
    from graph_odenet_tpu_torch.ops.csr_spmm import csr_reduce

    rng = np.random.default_rng(seed)
    csr = prepare(g).to(dev)
    x0 = torch.from_numpy(rng.standard_normal((g.n_node_pad, f)).astype(np.float32)).to(dev)
    up = torch.from_numpy(rng.standard_normal((g.n_node_pad, f)).astype(np.float32)).to(dev)

    def sin_probe(fn, dtype):
        x = x0.detach().to(dtype).requires_grad_(True)  # x0 itself stays without grad
        out = fn(csr, x)
        (dx,) = torch.autograd.grad(torch.sin(out).sum(), x)
        return out.detach(), dx

    def fwd_bwd(fn, dtype=torch.float32):
        x = x0.detach().to(dtype).requires_grad_(True)  # x0 itself stays without grad
        return torch.autograd.grad(fn(csr, x), x, up.to(dtype))[0]

    def max_err(a, b):
        return float((a.double() - b).abs().max())

    def err_over_tol(a, b):  # <= 1 where assert_close passes
        return float(((a.double() - b).abs() / (TOL["atol"] + TOL["rtol"] * b.abs())).max())

    out, dx = sin_probe(spmm_csr, torch.float32)
    torch.cuda.synchronize()
    ref, dref = sin_probe(spmm_csr_reference, torch.float64)
    torch.testing.assert_close(out, ref.float(), **TOL)
    torch.testing.assert_close(dx, dref.float(), **TOL)
    stress_ref = fwd_bwd(spmm_csr_reference, torch.float64)
    a, at = _sparse_csr_pair(csr)

    def library_autograd():
        x = x0.clone().requires_grad_(True)
        return torch.autograd.grad(torch.sparse.mm(a, x), x, up)[0]

    times = alternate({
        "plain": lambda: fwd_bwd(spmm_csr_reference),
        "kernel": lambda: fwd_bwd(spmm_csr),
        "kernel_bare": lambda: (csr_reduce(csr, x0), csr_reduce(csr, up, transpose=True)),
        "library_bare": lambda: (torch.sparse.mm(a, x0), torch.sparse.mm(at, up)),
        "library_autograd": library_autograd,
    }, iters)
    costs = {
        "csr_fwd": call_costs(lambda: csr_reduce(csr, x0)),
        "csr_bwd": call_costs(lambda: csr_reduce(csr, up, transpose=True)),
    }
    row = dict(
        graph=name, n_node_pad=g.n_node_pad, n_edge=g.n_edge, F=f,
        max_abs_err=max(max_err(out, ref), max_err(dx, dref)),
        max_err_over_tol=max(err_over_tol(out, ref), err_over_tol(dx, dref)),
        stress_bwd_max_abs_err=max_err(fwd_bwd(spmm_csr), stress_ref),
        plain_f32_stress_bwd_max_abs_err=max_err(fwd_bwd(spmm_csr_reference), stress_ref),
        ms=times["kernel"], plain_ms=times["plain"], bare_ms=times["kernel_bare"],
        library_bare_ms=times["library_bare"], library_autograd_ms=times["library_autograd"],
        call_costs=costs,
        max_row_edges=int(csr.row_ptr.diff().max()), split_rows=int(csr.part.split_row.numel()),
        **bound(*(2 * v for v in spmm_work(g.n_node_pad, csr.n_edge, f))),
    )
    emit("kernel", **row)
    return row


def phase_kernel(dev, pubmed_graph, bench_row):
    from graph_odenet_tpu_torch.graph import from_edges

    rows = [
        check_kernel("pubmed-twin", pubmed_graph, 16, dev, iters=200, seed=0),
        check_kernel("pubmed-twin", pubmed_graph, 3, dev, iters=200, seed=1),
        check_kernel("hub", hub_graph(from_edges), 128, dev, iters=200, seed=2),
        check_kernel("bench", bench_row, 128, dev, iters=20, seed=3),
    ]
    return rows


def split_hub_graph(from_edges, into):
    """Node 0 with 1,500 distinct in- (or out-) neighbours, unsymmetrised, so
    that its row spans several warp segments of the CSR (or CSC) view."""
    rng = np.random.default_rng(4)
    far = rng.permutation(np.arange(1, 2000))[:1500]
    s, r = (far, np.zeros_like(far)) if into else (np.zeros_like(far), far)
    return from_edges(s, r, n_node=2000, normalize=None, symmetrize=False)


def _err(a, b, tol):
    """(max abs err, max err / tolerance) of float32 ``a`` against float64 ``b``;
    a NaN in ``a`` (a row left unwritten) counts as an infinite error."""
    d = (a.double() - b).abs().nan_to_num(nan=float("inf"))
    return float(d.max()), float((d / (tol["atol"] + tol["rtol"] * b.abs())).max())


def check_attention(name, g, heads, feat, mode, dev, iters, seed, tol=ATT_TOL, cost_calls=1000):
    """The GAT kernels at one shape.  ``mode``: "hint" (score hint, the
    config-2 path), "hint_hash" (plus the counter-hash dropout 0.6) or
    "mask" (no hint, an explicit [E, H] dropout mask 0.6: the weighted SpMM
    computes dWh).

    1. Each kernel's wrapper against its plain version run in float64 on
       the same inputs (upstream gradient random normal; the backward
       kernels take the forward kernel's m and l).
    2. ``attention_aggregate`` through the kernels: values and the gradient
       of ``sum(sin(out))`` w.r.t. s_src, s_dst and wh, against the plain
       path (``gat_aggregate_reference``) in float64.
    Both at ``tol``; the plain version in float32 is held to the same
    references and reported.  Then ms per fwd+bwd through the entry point,
    for the kernels and for the plain version in float32, and of each kernel
    alone; the kernel launches of the timed entry-point runs are counted;
    each kernel wrapper's host µs, wall µs, device µs and device launches per
    call over ``cost_calls`` calls (``call_costs``).
    """
    from graph_odenet_tpu_torch.ops import csr_spmm, gat_attn, prepare
    from graph_odenet_tpu_torch.ops.dropmask import attention_dropout_scale
    from graph_odenet_tpu_torch.ops.sddmm import attention_aggregate, edge_scores

    rng = np.random.default_rng(seed)
    csr = prepare(g).to(dev)
    n, rate, drop_seed, slope = g.n_node_pad, 0.6, 1234 + seed, 0.2

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    s_src0, s_dst0 = randn(n, heads, scale=1.5), randn(n, heads, scale=1.5)
    wh0, up = randn(n, heads, feat), randn(n, heads, feat)
    drop = (drop_seed, rate) if mode == "hint_hash" else None
    dmask = (
        attention_dropout_scale(drop_seed, csr.senders, csr.receivers, heads, rate)
        if mode == "mask" else None
    )
    dd = lambda t: None if t is None else t.double()  # noqa: E731
    errs, plain_errs = {}, {}

    # 1. Kernel by kernel.
    logits = edge_scores(csr, s_src0, s_dst0, negative_slope=slope)
    out, m, l = gat_attn.gat_fwd(csr, logits, wh0, dmask=dmask, drop=drop)
    beta = (up * out).sum(-1)
    dlog, alpha_d = gat_attn.gat_bwd(
        csr, logits, wh0, up, m, l, beta, dmask=dmask, drop=drop, emit_alpha=mode == "mask"
    )
    if mode == "mask":
        alpha_csc = alpha_d.index_select(0, csr.t_perm)
        x = up.view(n, heads * feat)
        dwh = csr_spmm.csr_reduce(csr, x, transpose=True, alpha=alpha_csc, feat=feat)
        dwh_ref = csr_spmm._reduce_plain(
            csr.t_row_ptr, csr.t_receivers, None, x.double(), alpha_csc.double(), feat)
        errs["csr_spmm_weighted"] = _err(dwh, dwh_ref, tol)
        plain_errs["csr_spmm_weighted"] = _err(csr_spmm._reduce_plain(
            csr.t_row_ptr, csr.t_receivers, None, x, alpha_csc, feat), dwh_ref, tol)
    else:
        dwh = gat_attn.gat_dwh(csr, s_src0, s_dst0, m, l, up, slope, drop=drop)
        dwh_ref = gat_attn.gat_dwh_plain(
            csr, s_src0.double(), s_dst0.double(), m.double(), l.double(), up.double(), slope,
            drop=drop)
        errs["gat_dwh"] = _err(dwh, dwh_ref, tol)
        plain_errs["gat_dwh"] = _err(gat_attn.gat_dwh_plain(
            csr, s_src0, s_dst0, m, l, up, slope, drop=drop), dwh_ref, tol)
    torch.cuda.synchronize()
    ref = gat_attn.gat_fwd_plain(csr, logits.double(), wh0.double(), dmask=dmask, drop=drop)
    errs["gat_fwd"] = max((_err(a, b, tol) for a, b in zip((out, m, l), ref)), key=lambda e: e[1])
    dlog_ref, alpha_ref = gat_attn.gat_bwd_plain(
        csr, logits.double(), wh0.double(), up.double(), m.double(), l.double(), beta.double(),
        dmask=dd(dmask), drop=drop, emit_alpha=mode == "mask")
    errs["gat_bwd"] = _err(dlog, dlog_ref, tol)
    if mode == "mask":
        errs["gat_bwd"] = max(errs["gat_bwd"], _err(alpha_d, alpha_ref, tol), key=lambda e: e[1])

    # 2. The entry point, values and gradients.
    def entry(dtype, kernel):
        a, b, w = (t.to(dtype).requires_grad_(True) for t in (s_src0, s_dst0, wh0))
        lg = edge_scores(csr, a, b, negative_slope=slope)
        if kernel:
            o = attention_aggregate(
                csr, lg, w, dropout_seed=drop_seed if drop else None,
                dropout_rate=rate if drop else 0.0, dmask=dmask,
                scores=None if mode == "mask" else (a, b), negative_slope=slope)
        else:
            o = gat_attn.gat_aggregate_reference(csr, lg, w, dmask=dd(dmask), drop=drop)
        return o, a, b, w

    def probe(dtype, kernel):
        o, a, b, w = entry(dtype, kernel)
        return (o.detach(), *torch.autograd.grad(torch.sin(o).sum(), (a, b, w)))

    got = probe(torch.float32, True)
    torch.cuda.synchronize()
    want = probe(torch.float64, False)
    outputs = ("out", "d_s_src", "d_s_dst", "d_wh")
    entry_errs = {k: _err(x, y, tol) for k, x, y in zip(outputs, got, want)}
    plain_entry_errs = {
        k: _err(x, y, tol) for k, x, y in zip(outputs, probe(torch.float32, False), want)}
    errs["entry"] = max(entry_errs.values(), key=lambda e: e[1])
    plain_errs["entry"] = max(plain_entry_errs.values(), key=lambda e: e[1])
    worst = max(errs.values(), key=lambda e: e[1])
    if worst[1] > 1.0:
        raise AssertionError(f"attention {name} H={heads} F={feat} {mode}: {errs}; entry by "
                             f"output {entry_errs}, plain f32 {plain_entry_errs}")

    # Each kernel alone against its plain version, both in float32.
    per_kernel = {
        "gat_fwd": {
            "plain": lambda: gat_attn.gat_fwd_plain(csr, logits, wh0, dmask=dmask, drop=drop),
            "kernel": lambda: gat_attn.gat_fwd(csr, logits, wh0, dmask=dmask, drop=drop),
        },
        "gat_bwd": {
            "plain": lambda: gat_attn.gat_bwd_plain(
                csr, logits, wh0, up, m, l, beta, dmask=dmask, drop=drop,
                emit_alpha=mode == "mask"),
            "kernel": lambda: gat_attn.gat_bwd(
                csr, logits, wh0, up, m, l, beta, dmask=dmask, drop=drop,
                emit_alpha=mode == "mask"),
        },
    }
    if mode == "mask":
        per_kernel["csr_spmm_weighted"] = {
            "plain": lambda: csr_spmm._reduce_plain(
                csr.t_row_ptr, csr.t_receivers, None, x, alpha_csc, feat),
            "kernel": lambda: csr_spmm.csr_reduce(
                csr, x, transpose=True, alpha=alpha_csc, feat=feat),
        }
    else:
        per_kernel["gat_dwh"] = {
            "plain": lambda: gat_attn.gat_dwh_plain(
                csr, s_src0, s_dst0, m, l, up, slope, drop=drop),
            "kernel": lambda: gat_attn.gat_dwh(csr, s_src0, s_dst0, m, l, up, slope, drop=drop),
        }
    kernel_ms = {k: alternate(fns, iters) for k, fns in per_kernel.items()}
    # What one call of each kernel's wrapper costs: host, wall, device, launches.
    costs = {k: call_costs(fns["kernel"], calls=cost_calls) for k, fns in per_kernel.items()}

    def fwd_bwd(kernel):
        def run():
            o, a, b, w = entry(torch.float32, kernel)
            torch.autograd.grad(o, (a, b, w), up)
        return run

    counts = [csr_spmm.weighted_launches, dict(gat_attn.launches)]
    times = alternate({"plain": fwd_bwd(False), "kernel": fwd_bwd(True)}, iters)
    launched = {k: v - counts[1][k] for k, v in gat_attn.launches.items()}
    launched["csr_spmm_weighted"] = csr_spmm.weighted_launches - counts[0]
    row = dict(
        graph=name, n_node_pad=n, n_edge=csr.n_edge, H=heads, F=feat, mode=mode,
        max_row_edges=int(csr.row_ptr.diff().max()), max_col_edges=int(csr.t_row_ptr.diff().max()),
        tolerance=tol,
        max_abs_err={k: e[0] for k, e in errs.items()},
        max_err_over_tol={k: e[1] for k, e in errs.items()},
        plain_f32_max_err_over_tol={k: e[1] for k, e in plain_errs.items()},
        entry_max_err_over_tol={k: e[1] for k, e in entry_errs.items()},
        plain_f32_entry_max_err_over_tol={k: e[1] for k, e in plain_entry_errs.items()},
        ms=times["kernel"], plain_ms=times["plain"],
        edges_per_s=csr.n_edge / (times["kernel"] * 1e-3), launches=launched,
        kernel_ms={k: t["kernel"] for k, t in kernel_ms.items()},
        kernel_plain_ms={k: t["plain"] for k, t in kernel_ms.items()},
        call_costs=costs,
    )
    bounds = {k: bound(*attention_work(k, n, csr.n_edge, heads, feat)) for k in kernel_ms}
    row["bound_ms"] = {k: b["bound_ms"] for k, b in bounds.items()}
    row["bound_by"] = {k: b["bound_by"] for k, b in bounds.items()}
    emit("attention", **row)
    return row


def phase_attention(dev, bench, iters=50, bench_iters=10):
    """``bench``: the bench graph with unnormalised weights (attention ignores them)."""
    from graph_odenet_tpu_torch.data import synthetic_planetoid
    from graph_odenet_tpu_torch.graph import from_edges

    cite = synthetic_planetoid("citeseer", seed=42, calibrated=True).graph
    hub_in, hub_out = split_hub_graph(from_edges, True), split_hub_graph(from_edges, False)
    return [
        check_attention("citeseer-twin", cite, 8, 8, "hint_hash", dev, iters, seed=10),
        check_attention("citeseer-twin", cite, 1, 64, "hint", dev, iters, seed=11),
        check_attention("citeseer-twin", cite, 1, 6, "hint", dev, iters, seed=12),
        check_attention("hub-receiver", hub_in, 8, 8, "hint", dev, iters, seed=13),
        check_attention("hub-sender", hub_out, 8, 8, "hint", dev, iters, seed=14),
        check_attention("bench", bench, 8, 8, "hint_hash", dev, bench_iters, 15, BENCH_ATT_TOL,
                        cost_calls=100),
        check_attention("bench", bench, 1, 128, "hint", dev, bench_iters, 16, BENCH_ATT_TOL,
                        cost_calls=100),
        check_attention("bench", bench, 8, 8, "mask", dev, bench_iters, 17, BENCH_ATT_TOL,
                        cost_calls=100),
    ]


def phase_slice(dev, data):
    """Train through ``run_config``; ``data`` is the same twin, for the checks."""
    from graph_odenet_tpu_torch.configs import get_config, run_config
    from graph_odenet_tpu_torch.ops import csr_spmm, prepare
    from graph_odenet_tpu_torch.train import build_model

    csr_spmm.launches = 0
    res = run_config("pubmed-gcnode", calibrated=True, device=dev)
    launches = csr_spmm.launches

    if res["representation"] != "kernel":
        raise AssertionError(f"pubmed-gcnode took {res['representation']!r}, not the kernel")
    if launches < SPMM_PER_EPOCH * res["epochs_run"]:
        raise AssertionError(f"{launches} kernel launches for {res['epochs_run']} epochs")
    if not res["best"]["test_acc"] >= MIN_TEST_ACC:
        raise AssertionError(f"test accuracy {res['best']['test_acc']} < {MIN_TEST_ACC}")

    # The trained model through the kernel against the plain segment path.
    _, cfg = get_config("pubmed-gcnode")
    model = build_model(cfg, data.n_class, data.features.shape[1])
    model.load_state_dict(res["params"])
    model.to(dev).eval()
    with torch.no_grad():
        lp_kernel = model(prepare(data.graph), data.features)
        lp_segment = model(data.graph, data.features)
    if lp_kernel.shape != (data.graph.n_node_pad, data.n_class):
        raise AssertionError(f"log-probs of shape {tuple(lp_kernel.shape)}")
    if not torch.isfinite(lp_kernel).all():
        raise AssertionError("non-finite log-probs")
    torch.testing.assert_close(lp_kernel, lp_segment, **SLICE_TOL)

    emit(
        "slice", config=res["config"], dataset=res["dataset"], best=res["best"],
        epochs_run=res["epochs_run"], seconds=res["seconds"],
        seconds_per_epoch=res["seconds"] / res["epochs_run"],
        representation=res["representation"], launches=launches,
        logprob_max_abs_diff_vs_segment=float((lp_kernel - lp_segment).abs().max()),
    )
    return launches


def phase_gat_slice(dev):
    """Config 2 through ``run_config``: GAT-ODE (dopri5_scan) on the Citeseer twin."""
    from graph_odenet_tpu_torch.configs import get_config, run_config
    from graph_odenet_tpu_torch.data import synthetic_planetoid
    from graph_odenet_tpu_torch.ops import gat_attn, prepare
    from graph_odenet_tpu_torch.train import build_model

    for k in gat_attn.launches:
        gat_attn.launches[k] = 0
    res = run_config(2, calibrated=True, device=dev)
    launches = dict(gat_attn.launches)

    epochs = res["epochs_run"]
    if res["representation"] != "kernel":
        raise AssertionError(f"config 2 took {res['representation']!r}, not the kernels")
    if min(launches.values()) < GAT_LAYERS * epochs:
        raise AssertionError(f"{launches} GAT kernel launches for {epochs} epochs")
    if not res["best"]["test_acc"] >= GAT_MIN_TEST_ACC:
        raise AssertionError(f"test accuracy {res['best']['test_acc']} < {GAT_MIN_TEST_ACC}")
    if not res["ode_stats"]["success"]:
        raise AssertionError(f"the last forward's solver failed: {res['ode_stats']}")

    # The trained model through the kernels against the plain segment path.
    _, cfg = get_config(2)
    data = synthetic_planetoid("citeseer", seed=cfg.seed, calibrated=True).to(dev)
    model = build_model(cfg, data.n_class, data.features.shape[1])
    model.load_state_dict(res["params"])
    model.to(dev).eval()
    with torch.no_grad():
        lp_kernel = model(prepare(data.graph), data.features)
        stats = dict(model.odeblock.stats)
        lp_segment = model(data.graph, data.features)
    if lp_kernel.shape != (data.graph.n_node_pad, data.n_class):
        raise AssertionError(f"log-probs of shape {tuple(lp_kernel.shape)}")
    if not torch.isfinite(lp_kernel).all():
        raise AssertionError("non-finite log-probs")
    torch.testing.assert_close(lp_kernel, lp_segment, **SLICE_TOL)

    emit(
        "gat_slice", config=res["config"], dataset=res["dataset"], best=res["best"],
        epochs_run=epochs, seconds=res["seconds"], seconds_per_epoch=res["seconds"] / epochs,
        representation=res["representation"], launches=launches,
        last_train_ode_stats=res["ode_stats"], eval_ode_stats=stats,
        nfe_per_forward=stats["nfe"],
        logprob_max_abs_diff_vs_segment=float((lp_kernel - lp_segment).abs().max()),
    )
    return launches


def bench_path_launches(dev, bench, iters=5):
    """The GAT bench's path (``attention_aggregate`` without the score hint,
    H=8/F=8, dropout mask 0.6, at the bench shape): kernel launches per run."""
    from graph_odenet_tpu_torch.ops import csr_spmm, prepare
    from graph_odenet_tpu_torch.ops.dropmask import attention_dropout_scale
    from graph_odenet_tpu_torch.ops.sddmm import attention_aggregate

    rng = np.random.default_rng(20)
    csr = prepare(bench).to(dev)
    logits = torch.from_numpy(rng.standard_normal((csr.n_edge, 8)).astype(np.float32)).to(dev)
    wh = torch.from_numpy(rng.standard_normal((bench.n_node_pad, 8, 8)).astype(np.float32)).to(dev)
    dmask = attention_dropout_scale(5, csr.senders, csr.receivers, 8, 0.6)
    csr_spmm.weighted_launches = 0
    for _ in range(iters):
        lg, w = logits.clone().requires_grad_(True), wh.clone().requires_grad_(True)
        out = attention_aggregate(csr, lg, w, dmask=dmask)
        torch.autograd.grad(out.sum(), (lg, w))
    torch.cuda.synchronize()
    return csr_spmm.weighted_launches


def phase_dense(dev, data):
    from graph_odenet_tpu_torch.configs import get_config
    from graph_odenet_tpu_torch.ops import prepare
    from graph_odenet_tpu_torch.train import build_model
    from graph_odenet_tpu_torch.utils.metrics import masked_nll

    _, cfg = get_config("pubmed-gcnode")
    gen = torch.Generator().manual_seed(cfg.seed)
    model = build_model(cfg, data.n_class, data.features.shape[1], generator=gen).to(dev)
    drop = torch.Generator(device=dev).manual_seed(cfg.seed)
    adjs = {"dense": data.dense_adj(), "kernel": prepare(data.graph), "segment": data.graph}

    def step(adj):
        def run():
            out = model(adj, data.features, deterministic=False, generator=drop)
            loss = masked_nll(out, data.labels, data.idx_train)
            return torch.autograd.grad(loss, list(model.parameters()))
        return run

    times = alternate({k: step(a) for k, a in adjs.items()}, iters=20)
    emit(
        "dense", n_node_pad=data.graph.n_node_pad, what="GCN-ODE fwd+bwd ms",
        dense_ms=times["dense"], kernel_ms=times["kernel"], segment_ms=times["segment"],
    )


def _randn(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


def sha256(t):
    """SHA-256 of a tensor's bytes: equal digests, equal bits."""
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def bucket_digests(view, x, out0, **kw):
    """SHA-256 of ``bucket_reduce`` over ``view`` on seeded inputs, written
    (into NaNs) and added into ``out0``, after both calls."""
    from graph_odenet_tpu_torch.ops.csr_spmm import bucket_reduce

    wrote = bucket_reduce(view, x, torch.full_like(out0, float("nan")), accumulate=False, **kw)
    added = bucket_reduce(view, x, out0.clone(), **kw)
    torch.cuda.synchronize()
    return dict(write=sha256(wrote), add=sha256(added))


def event_ms(fn, launches):
    """Device ms a call of ``fn()``: CUDA events around ``launches`` calls,
    after one call to warm up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def footprint_probe(dev, view, f=128, weighted=False, fractions=(1, 2, 4, 16), launches=100,
                    seed=31):
    """B2's write form (``weighted``: B2-w's at H = 1) at F = ``f`` over
    ``view`` with its columns remapped as ``col % R``, R = n_cols / each of
    ``fractions``: the same segments, edges, lanes and instructions, the
    gathered table ``R × f × 4`` bytes.  Device ms a launch for each R, the R
    in turns (in order, then reversed, averaged), so the time falls with the
    table only as far as L2 misses bound the call.  Every call takes the
    G = 32 schedule: the resident walk, where the package has it, is turned
    off for the probe."""
    from graph_odenet_tpu_torch.ops import csr_spmm
    from graph_odenet_tpu_torch.ops.csr_spmm import bucket_reduce

    budget = getattr(csr_spmm, "L2_RESIDENT_BYTES", None)
    if budget is not None:
        csr_spmm.L2_RESIDENT_BYTES = float("inf")
    try:
        rng = np.random.default_rng(seed)
        out = torch.empty((view.n_rows, f), device=dev)
        alpha = _randn(rng, (view.n_edge, 1), dev).abs() if weighted else None
        calls = {}
        for frac in fractions:
            r = view.n_cols // frac
            v = dataclasses.replace(view, col=(view.col % r).to(torch.int32), n_cols=r)
            x = _randn(rng, (r, f), dev)
            calls[r] = (lambda v=v, x=x: bucket_reduce(v, x, out, accumulate=False, alpha=alpha,
                                                       feat=f if weighted else None))
        ms = {r: [] for r in calls}
        for r in list(calls) + list(calls)[::-1]:
            ms[r].append(event_ms(calls[r], launches))
    finally:
        if budget is not None:
            csr_spmm.L2_RESIDENT_BYTES = budget
    return [dict(rows=r, table_mb=r * f * 4 / 1e6, ms=sum(t) / len(t), turns=t)
            for r, t in ms.items()]


def phase_bucket(dev, graph, f=ARXIV_HIDDEN, iters=10):
    """B2 on every bucket of the arxiv twin at P = 8 and P = 1 (see the module doc)."""
    from graph_odenet_tpu_torch.ops import csr_spmm, prepare, spmm_csr
    from graph_odenet_tpu_torch.ops.csr_spmm import _bucket_reduce_plain, bucket_reduce
    from graph_odenet_tpu_torch.parallel import partition_by_receiver

    rng = np.random.default_rng(30)
    n = graph.n_node_pad
    x = _randn(rng, (n, f), dev)
    csr = prepare(graph).to(dev)
    xr = x.clone().requires_grad_(True)
    want = spmm_csr(csr, xr)
    up = torch.cos(want).detach()  # d sum(sin(Â x)) / d(Â x)
    (want_dx,) = torch.autograd.grad(want, xr, up)
    rows = {}
    for n_parts in BUCKET_PARTS:
        t0 = time.perf_counter()
        pg = partition_by_receiver(graph, n_parts).to(dev)
        partition_s = time.perf_counter() - t0
        B = pg.block_size
        errs = []

        def check(got, ref):
            errs.append(_err(got, ref, TOL))

        def nan(dtype=torch.float32):  # the write form must write every row
            return torch.full((B, f), float("nan"), device=dev, dtype=dtype)

        out = torch.full((n, f), float("nan"), device=dev)
        for p in range(n_parts):
            for k in range(n_parts):  # the ring's order: the own block first, written
                b = (p + k) % n_parts
                bk, chunk = pg.bucket(p, b), x[b * B:(b + 1) * B]
                y = bucket_reduce(bk.fwd, chunk, nan(), accumulate=False)
                y64 = _bucket_reduce_plain(bk.fwd, chunk.double(), nan(torch.float64),
                                           accumulate=False)
                g_b = torch.cos(y64).float()  # d sum(sin(y)) / dy
                d = bucket_reduce(bk.bwd, g_b, nan(), accumulate=False)
                d64 = _bucket_reduce_plain(bk.bwd, g_b.double(), nan(torch.float64),
                                           accumulate=False)
                msgs = chunk.index_select(0, bk.fwd.col) * bk.fwd.weight[:, None]
                pos = bucket_reduce(bk.fwd, msgs, nan(), positional=True, accumulate=False)
                pos64 = _bucket_reduce_plain(bk.fwd, msgs.double(), nan(torch.float64), True,
                                             accumulate=False)
                torch.cuda.synchronize()
                check(y, y64)
                check(d, d64)
                check(pos, pos64)
                bucket_reduce(bk.fwd, chunk, out[p * B:(p + 1) * B], accumulate=k > 0)
        # The reverse ring: block b's gradient gathers bucket [p, b] of every
        # rank p, from rank b + 1 on, written first and then added into.
        dx = torch.full((n, f), float("nan"), device=dev)
        for b in range(n_parts):
            for k in range(n_parts):
                p = (b + 1 + k) % n_parts
                bucket_reduce(pg.bucket(p, b).bwd, up[p * B:(p + 1) * B], dx[b * B:(b + 1) * B],
                              accumulate=k > 0)
        torch.cuda.synchronize()
        acc_err = max(_err(out, want.detach().double(), TOL), _err(dx, want_dx.double(), TOL),
                      key=lambda e: e[1])
        worst = max(errs, key=lambda e: e[1])
        if worst[1] > 1.0 or acc_err[1] > 1.0:
            raise AssertionError(f"bucket P={n_parts}: per bucket {worst}, accumulated {acc_err}")

        def fwd_bwd(reduce, write=True):
            """Each output's first bucket writes it and the rest add; or, not
            ``write``, outputs zero-filled and every bucket adds."""
            def run():
                new = torch.empty if write else torch.zeros
                o, dxx = new(n, f, device=dev), new(n, f, device=dev)
                for p in range(n_parts):
                    for b in range(n_parts):
                        bk = pg.bucket(p, b)
                        reduce(bk.fwd, x[b * B:(b + 1) * B], o[p * B:(p + 1) * B],
                               accumulate=b > 0 or not write)
                        reduce(bk.bwd, up[p * B:(p + 1) * B], dxx[b * B:(b + 1) * B],
                               accumulate=p > 0 or not write)
            return run

        # cuSPARSE for the same buckets: A_pb x_b and A_pbᵀ g_p.
        mats = [
            [(_sparse_csr(pg.bucket(p, b).fwd), _sparse_csr(pg.bucket(p, b).bwd))
             for b in range(n_parts)] for p in range(n_parts)
        ]

        def library():
            for p in range(n_parts):
                for b in range(n_parts):
                    a, at = mats[p][b]
                    torch.sparse.mm(a, x[b * B:(b + 1) * B])
                    torch.sparse.mm(at, up[p * B:(p + 1) * B])

        times = alternate({"plain": fwd_bwd(_bucket_reduce_plain), "kernel": fwd_bwd(bucket_reduce),
                           "zero_fill_add": fwd_bwd(bucket_reduce, write=False),
                           "library": library}, iters)

        def forward_calls(write):
            """One forward call per bucket, each written or each added."""
            o = torch.zeros(n, f, device=dev)

            def run():
                for p in range(n_parts):
                    for b in range(n_parts):
                        bucket_reduce(pg.bucket(p, b).fwd, x[b * B:(b + 1) * B],
                                      o[p * B:(p + 1) * B], accumulate=not write)
            return run

        calls = 1024 if n_parts > 1 else 100
        costs = {form: call_costs(forward_calls(form == "write"), calls=calls, per=n_parts ** 2)
                 for form in ("write", "add")}
        work = [spmm_work(B, int(pg.bucket_edges[p, b]), f, accumulate=acc)
                for p in range(n_parts) for b in range(n_parts) for acc in (b > 0, p > 0)]
        n_bytes, n_flops = (sum(w[i] for w in work) for i in (0, 1))  # fwd and bwd
        rows[n_parts] = dict(
            n_parts=n_parts, block_rows=B, buckets=n_parts ** 2,
            largest_bucket=int(pg.bucket_edges.max()), n_edge=graph.n_edge, F=f,
            partition_s=partition_s, max_abs_err=worst[0], max_err_over_tol=worst[1],
            accumulated_max_err_over_tol=acc_err[1],
            split_rows=sum(int(pg.bucket(p, b).fwd.part.split_row.numel())
                           for p in range(n_parts) for b in range(n_parts)),
            ms=times["kernel"], plain_ms=times["plain"], library_ms=times["library"],
            zero_fill_add_ms=times["zero_fill_add"], call_costs=costs, **bound(n_bytes, n_flops),
        )
        if n_parts == 1:  # the cells' shape: the footprint probe and the outputs' digests
            bk1, drng = pg.bucket(0, 0), np.random.default_rng(32)
            rows[1]["footprint"] = footprint_probe(dev, bk1.fwd)
            rows[1]["sha256"] = {name: bucket_digests(view, x, _randn(drng, (n, f), dev))
                                 for name, view in (("fwd", bk1.fwd), ("bwd", bk1.bwd))}
            rows[1]["resident_launches"] = getattr(csr_spmm, "bucket_resident_launches", None)
        emit("bucket", **rows[n_parts])
    return rows


def _sparse_csr(view):
    """A ``CSRView`` as a torch CSR tensor (cuSPARSE's operand)."""
    return torch.sparse_csr_tensor(view.row_ptr, view.col.long(), view.weight,
                                   (view.n_rows, view.n_cols))


class fixed_order_sums:
    """Within the block ``index_add_`` sums in a fixed order instead of with
    atomics in the order the card schedules them.  ``warn_only=True`` lets a
    block hold matmuls too: cuBLAS has no deterministic mode to switch to, and
    on one stream it rounds the same way in every call.

    Config 4's encoder is ``relu(Â x W + b)`` with ``b = 0`` at the start, and
    on the arxiv twin some of those pre-activations are sums that cancel to a
    rounding residue (7e-12 at one node through the kernel, exactly 0.0 through
    the plain version in about one run in twelve).  The sign of a residue
    picks the ReLU's slope, so the plain step's gradient of ``w_in`` and
    ``b_in`` jumped between two values 1.5 tolerances apart from run to run
    while the kernel's, whose sums have one order, never moved.  A check of a
    gradient across a kink needs both sides to be a function of their
    inputs: with the order fixed the plain step is one too."""

    def __init__(self, warn_only=False):
        self.warn_only = warn_only
        self.caught = warnings.catch_warnings()

    def __enter__(self):
        self.caught.__enter__()
        warnings.filterwarnings("ignore", message=".*CUBLAS_WORKSPACE_CONFIG.*")
        torch.use_deterministic_algorithms(True, warn_only=self.warn_only)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(False)
        self.caught.__exit__(*exc)


def _grads_close(got, want, rtol, what, scale=None):
    """``got`` against ``want`` at ``rtol``, atol relative to each gradient's
    largest entry (or to ``scale[k]``); the worst error over tolerance of each."""
    errs = {}
    for k, g in want.items():
        atol = rtol * (float(g.abs().max()) if scale is None else scale[k])
        errs[k] = float(((got[k] - g).abs() / (atol + rtol * g.abs())).max())
        torch.testing.assert_close(
            got[k], g, rtol=rtol, atol=atol,
            msg=lambda m, k=k: f"{what} {k}: {errs[k]} of the tolerance\n{m}")
    return errs


def phase_config4(dev, data):
    """Config 4 through ``run_config``; ``data`` is the same twin, for the one-step check."""
    from graph_odenet_tpu_torch.configs import get_config, run_config
    from graph_odenet_tpu_torch.ops import csr_spmm, prepare, spmm_csr_reference
    from graph_odenet_tpu_torch.parallel import partition_by_receiver, sharded_gcn, spmm_sharded

    _, cfg = get_config(4)
    # One training step (dropout 0) through the kernel and through the plain versions.
    pg = partition_by_receiver(data.graph, 1).to(dev)
    csr = prepare(data.graph).to(dev)
    model = sharded_gcn.init_params(data.features.shape[1], cfg.hidden, data.n_class,
                                    generator=torch.Generator().manual_seed(0)).to(dev)
    x, labels = data.features.to(dev), data.labels.to(dev)
    y1h = torch.nn.functional.one_hot(labels.clamp(min=0), data.n_class).float()
    w = torch.zeros(data.graph.n_node_pad, device=dev)
    w[data.idx_train.to(dev)] = 1.0

    def step(agg):
        model.zero_grad(set_to_none=True)
        lp = sharded_gcn.forward_with(model, agg, x, steps=cfg.steps, t1=cfg.t1)
        loss = -(lp * y1h).sum(-1).mul(w).sum() / w.sum()
        loss.backward()
        return loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}

    kernel_agg = lambda h: spmm_sharded(pg, h, mode=cfg.mode)  # noqa: E731
    before = csr_spmm.bucket_launches
    loss_k, grads_k = step(kernel_agg)
    check_launches = csr_spmm.bucket_launches - before

    def plain_agg(h):
        with fixed_order_sums():
            return spmm_csr_reference(csr, h)

    loss_p, grads_p = step(plain_agg)
    torch.cuda.synchronize()
    step_err = {"loss": float((loss_k - loss_p).abs() / loss_p.abs())}
    torch.testing.assert_close(loss_k, loss_p, rtol=CONFIG4_RTOL, atol=0.0)
    step_err.update(_grads_close(grads_k, grads_p, CONFIG4_RTOL, "config4"))
    profile = profile_steps(model, lambda: step(kernel_agg), cfg)
    del model, csr, pg

    csr_spmm.bucket_launches = 0
    res = run_config(4, device=dev)
    launches = csr_spmm.bucket_launches

    epochs = res["epochs_run"]
    if not (np.isfinite(res["loss_first"]) and np.isfinite(res["loss_final"])):
        raise AssertionError(f"config 4: non-finite loss {res}")
    if not res["loss_final"] < res["loss_first"]:
        raise AssertionError(f"config 4: the loss did not fall: {res}")
    if not res["test_acc"] > 1.0 / data.n_class:
        raise AssertionError(f"config 4: test accuracy {res['test_acc']} at chance")
    if launches < 36 * epochs:  # 18 aggregations forward and 18 backward a step
        raise AssertionError(f"config 4: {launches} bucket kernel launches for {epochs} epochs")
    emit(
        "config4", config=res["config"], dataset=res["dataset"], n_parts=res["n_parts"],
        n_node_pad=data.graph.n_node_pad, n_edge=data.graph.n_edge, hidden=cfg.hidden,
        epochs_run=epochs, best_epoch=res["best_epoch"], test_acc=res["test_acc"],
        val_acc=res["val_acc"], val_loss=res["val_loss"], loss_first=res["loss_first"],
        loss_final=res["loss_final"], step_ms=res["step_ms"], seconds=res["seconds"],
        seconds_per_epoch=res["seconds"] / epochs, launches=launches,
        one_step_check=dict(rtol=CONFIG4_RTOL, launches=check_launches, err_over_tol=step_err),
        profile=profile,
    )
    return launches


# Device kernels by what they do, matched on the kernel's name in this order.
KERNEL_KINDS = (
    ("bucket_kernel", ("csr_reduce_kernel",)),
    ("matmul", ("gemm", "cutlass", "cublas")),
    ("gather", ("indexSelect", "index_select", "gather")),
    ("segment_ops", ("scatter", "indexFuncLargeIndex", "indexFuncSmallIndex", "index_add")),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized")),
)


def kernel_kind(name):
    return next((kind for kind, keys in KERNEL_KINDS if any(k in name for k in keys)), "other")


def profile_steps(model, loss_and_grads, cfg, steps=3, top=8):
    """``torch.profiler`` over ``steps`` training steps (dropout 0, then
    Adam): wall and device-busy ms per step, the kernels that take most of
    the device time (single stream, so their times add up to busy) and the
    device time by kind of kernel (``KERNEL_KINDS``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, weight_decay=cfg.weight_decay)

    def train_step():
        loss_and_grads()
        opt.step()

    train_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # Device events only: CPU ops also carry the device time of what they launched;
    # the program's spans (gode.*) are mirrored onto the device but are no kernels.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.key.startswith("gode.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    by_kind = {}
    for e in kernels:
        kind = kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return dict(
        steps=steps, wall_ms_per_step=wall_ms, device_busy_ms_per_step=busy_ms,
        busy_share=busy_ms / wall_ms, ms_per_step_by_kind=by_kind,
        launches_per_step=sum(e.count for e in kernels) / steps,
        top_kernels_ms_per_step={e.key[:90]: e.self_device_time_total / 1e3 / steps for e in top},
    )


def _softmax_numerators(rng, rows, n_rows, heads, dev):
    """Positive ``[L, H]`` weights that sum to 1 over each row's edges."""
    u = torch.from_numpy((rng.random((rows.shape[0], heads)) + 0.5).astype(np.float32)).to(dev)
    total = torch.zeros((n_rows, heads), device=dev).index_add_(0, rows, u)
    return (u / total.index_select(0, rows)).contiguous()


def phase_bucket_weighted(dev, graph, iters=10):
    """B2-w and its per-edge dot on the arxiv twin at P = 1 and P = 8 (see the
    module doc)."""
    from graph_odenet_tpu_torch.ops import csr_spmm
    from graph_odenet_tpu_torch.ops.csr_spmm import (
        _bucket_reduce_plain, _edge_dot_plain, bucket_reduce, edge_dot,
    )
    from graph_odenet_tpu_torch.parallel import partition_by_receiver

    rng = np.random.default_rng(50)
    n = graph.n_node_pad
    errs = []

    def check(view, x, pv, feat, out0):
        """Write form into NaNs and add form into ``out0`` against float64."""
        f = x.shape[1]
        ref = _bucket_reduce_plain(view, x.double(), torch.empty_like(out0, dtype=torch.float64),
                                   accumulate=False, alpha=pv.double(), feat=feat)
        wrote = bucket_reduce(view, x, torch.full_like(out0, float("nan")), accumulate=False,
                              alpha=pv, feat=feat)
        added = bucket_reduce(view, x, out0.clone(), alpha=pv, feat=feat)
        torch.cuda.synchronize()
        errs.append(_err(wrote, ref, TOL))
        errs.append(_err(added, out0.double() + ref, TOL))
        assert wrote.shape == (view.n_rows, f)
        return ref

    # P = 1: the three shapes of the sharded GAT-ODE's layers.
    pg = partition_by_receiver(graph, 1).to(dev)
    bk, blk = pg.bucket(0, 0), pg.blocks[0]
    rows = {}
    for heads, feat in GAT_SHAPES:
        f = heads * feat
        x, out0 = _randn(rng, (n, f), dev), _randn(rng, (n, f), dev)
        pv = _softmax_numerators(rng, blk.receivers, n, heads, dev)
        pv_t = pv.index_select(0, bk.t_perm)
        before = len(errs)
        y64 = check(bk.fwd, x, pv, feat, out0)
        g = torch.cos(y64).float()  # d sum(sin(y)) / dy
        check(bk.bwd, g, pv_t, feat, out0)
        worst = max(errs[before:], key=lambda e: e[1])
        # The per-edge dot (dpv) on the forward's table and the backward's upstream.
        dots = csr_spmm.edge_dot_launches
        dot = edge_dot(bk.fwd, x, g, heads, feat)
        dot_again = edge_dot(bk.fwd, x, g, heads, feat)
        torch.cuda.synchronize()
        dot_err = _dot_err(dot, bk.fwd, x, g, heads, feat)
        errs.append(dot_err)
        if not torch.equal(dot, dot_again) or csr_spmm.edge_dot_launches - dots != 2:
            raise AssertionError(f"bucket_weighted H={heads} F={feat}: the per-edge dot's two "
                                 "calls differ or did not launch once each")

        def fwd_bwd(reduce):
            def run():
                o, dx = torch.empty(n, f, device=dev), torch.empty(n, f, device=dev)
                reduce(bk.fwd, x, o, accumulate=False, alpha=pv, feat=feat)
                reduce(bk.bwd, g, dx, accumulate=False, alpha=pv_t, feat=feat)
            return run

        fns = {"plain": fwd_bwd(_bucket_reduce_plain), "kernel": fwd_bwd(bucket_reduce),
               "dpv": lambda: _edge_dot_plain(bk.fwd, x, g, heads, feat, blk.receivers),
               "edge_dot": lambda: edge_dot(bk.fwd, x, g, heads, feat)}
        if heads == 1:  # one library call computes the same function: cuSPARSE with pv as values
            a = torch.sparse_csr_tensor(bk.fwd.row_ptr, bk.fwd.col.long(), pv[:, 0].contiguous(), (n, n))
            at = torch.sparse_csr_tensor(bk.bwd.row_ptr, bk.bwd.col.long(), pv_t[:, 0].contiguous(), (n, n))
            lib_err = max(_err(torch.sparse.mm(a, x), y64, BENCH_ATT_TOL)[1],
                          _err(torch.sparse.mm(at, g), _bucket_reduce_plain(
                              bk.bwd, g.double(), torch.empty(n, f, device=dev, dtype=torch.float64),
                              accumulate=False, alpha=pv_t.double(), feat=feat), BENCH_ATT_TOL)[1])
            fns["library"] = lambda: (torch.sparse.mm(a, x), torch.sparse.mm(at, g))
        times = alternate(fns, iters)
        if heads == 1:  # the kernel against cuSPARSE alone, in turns, many times
            times.update({f"{k}_long": v for k, v in alternate(
                {"kernel": fns["kernel"], "library": fns["library"]}, LONG_ITERS).items()})
        o = torch.empty(n, f, device=dev)
        costs = call_costs(lambda: bucket_reduce(bk.fwd, x, o, accumulate=False, alpha=pv,
                                                 feat=feat), calls=100)
        dot_costs = call_costs(lambda: edge_dot(bk.fwd, x, g, heads, feat), calls=100)
        work = [weighted_bucket_work(n, bk.fwd.n_edge, heads, feat)] * 2  # fwd and bwd
        rows[heads, feat] = dict(
            n_parts=1, H=heads, F=feat, n_node_pad=n, n_edge=bk.fwd.n_edge,
            max_row_edges=int(bk.fwd.row_ptr.diff().max()),
            max_col_edges=int(bk.bwd.row_ptr.diff().max()),
            split_rows=int(bk.fwd.part.split_row.numel()),
            max_abs_err=worst[0], max_err_over_tol=worst[1],
            ms=times["kernel"], plain_ms=times["plain"], dpv_plain_ms=times["dpv"],
            edge_dot=dict(ms=times["edge_dot"], plain_ms=times["dpv"], max_abs_err=dot_err[0],
                          max_err_over_tol=dot_err[1], call_costs=dot_costs,
                          **bound(*edge_dot_work(n, n, bk.fwd.n_edge, heads, feat))),
            library_ms=times.get("library"),
            long_ms=times.get("kernel_long"), library_long_ms=times.get("library_long"),
            long_iters=LONG_ITERS if heads == 1 else None, call_costs=costs,
            library_max_err_over_1e4=lib_err if heads == 1 else None,
            **bound(sum(w[0] for w in work), sum(w[1] for w in work)),
        )
        if f == ARXIV_HIDDEN:  # a cell's shape: digests on inputs of their own seed
            drng = np.random.default_rng(51 + heads)
            xd, od = _randn(drng, (n, f), dev), _randn(drng, (n, f), dev)
            ad = torch.from_numpy((drng.random((bk.fwd.n_edge, heads)) + 0.5).astype(np.float32))
            ad = ad.to(dev)
            rows[heads, feat]["sha256"] = {
                name: bucket_digests(view, xd, od, alpha=a, feat=feat)
                for name, view, a in (("fwd", bk.fwd, ad), ("bwd", bk.bwd, ad[bk.t_perm]))}
            rows[heads, feat]["resident_launches"] = getattr(csr_spmm, "bucket_resident_launches",
                                                             None)
            if heads == 1:
                rows[heads, feat]["footprint"] = footprint_probe(dev, bk.fwd, weighted=True)
        emit("bucket_weighted", **rows[heads, feat])
        del x, out0, pv, pv_t, y64, g, o

    # P = 8: every bucket, and each receiver block's buckets in the ring's order.
    heads, feat = GAT_SHAPES[0]
    f = heads * feat
    pg = partition_by_receiver(graph, 8).to(dev)
    B = pg.block_size
    x, up = _randn(rng, (n, f), dev), _randn(rng, (n, f), dev)
    before, launched = len(errs), csr_spmm.bucket_weighted_launches
    ring_errs = []
    for p in range(8):
        blk = pg.blocks[p]
        pv = _softmax_numerators(rng, blk.receivers, B, heads, dev)
        out = torch.full((B, f), float("nan"), device=dev)
        ref = torch.zeros((B, f), device=dev, dtype=torch.float64)
        for k in range(8):
            b = (p + k) % 8
            bucket, chunk, pv_b = pg.bucket(p, b), x[b * B:(b + 1) * B], pv[blk.bucket(b)]
            y64 = check(bucket.fwd, chunk, pv_b, feat, up[p * B:(p + 1) * B])
            ref += y64
            up_b = torch.cos(y64).float()
            check(bucket.bwd, up_b, pv_b.index_select(0, bucket.t_perm), feat, chunk)
            errs.append(_dot_err(edge_dot(bucket.fwd, chunk, up_b, heads, feat), bucket.fwd,
                                 chunk, up_b, heads, feat))
            bucket_reduce(bucket.fwd, chunk, out, accumulate=k > 0, alpha=pv_b, feat=feat)
        torch.cuda.synchronize()
        ring_errs.append(_err(out, ref, TOL))
    worst, ring = max(errs[before:], key=lambda e: e[1]), max(ring_errs, key=lambda e: e[1])
    rows["P8"] = dict(
        n_parts=8, H=heads, F=feat, buckets=64, block_rows=B,
        largest_bucket=int(pg.bucket_edges.max()), smallest_bucket=int(pg.bucket_edges.min()),
        launches=csr_spmm.bucket_weighted_launches - launched,
        max_abs_err=worst[0], max_err_over_tol=worst[1], ring_order_max_err_over_tol=ring[1],
    )
    emit("bucket_weighted", **rows["P8"])
    bad = max(errs, key=lambda e: e[1])
    if bad[1] > 1.0 or ring[1] > 1.0:
        raise AssertionError(f"bucket_weighted: worst {bad}, ring order {ring}")
    return rows


class plain_bucket_mode:
    """Within the block, ``parallel.halo`` reduces every bucket with the bucket
    mode's plain version instead of the kernel, and takes B2-w's ``dpv`` by
    the per-edge dot's plain version: the yardstick of a whole step."""

    def __enter__(self):
        from graph_odenet_tpu_torch.ops.csr_spmm import _bucket_reduce_plain, _edge_dot_plain
        from graph_odenet_tpu_torch.parallel import halo

        self.halo, self.kernels = halo, (halo.bucket_reduce, halo.edge_dot)
        halo.bucket_reduce = lambda view, x, out, **kw: _bucket_reduce_plain(view, x, out, **kw)
        halo.edge_dot = _edge_dot_plain

    def __exit__(self, *exc):
        self.halo.bucket_reduce, self.halo.edge_dot = self.kernels


class plain_softmax_passes:
    """Within the block the sharded GAT and GRAND-nl take the softmax's
    order-free passes through PyTorch's calls instead of the kernels:
    ``index_select`` (autograd's backward) for ``gather_rows``,
    ``scatter_reduce`` for ``segment_max``, ``ops.segment.segment_sum`` for
    the denominators' Function: the calls the kernels replace."""

    def __enter__(self):
        from graph_odenet_tpu_torch.ops import segment
        from graph_odenet_tpu_torch.ops.csr_spmm import MAX_FLOOR
        from graph_odenet_tpu_torch.parallel import halo, sharded_gat, sharded_grand

        def gather(t, idx):
            return t.index_select(0, idx)

        def seg_max(e, rows, n_rows):
            e = e.detach()
            m = e.new_full((n_rows, e.shape[1]), MAX_FLOOR)
            return m.scatter_reduce(0, rows.long()[:, None].expand_as(e), e, "amax",
                                    include_self=True)

        self.saved = [(m, k, getattr(m, k)) for m, k in (
            (sharded_gat, "gather_rows"), (sharded_grand, "gather_rows"), (halo, "gather_rows"),
            (sharded_gat, "segment_max"), (sharded_gat, "_Denominators"))]
        for m in (sharded_gat, sharded_grand, halo):
            m.gather_rows = gather
        sharded_gat.segment_max = seg_max
        sharded_gat._Denominators = types.SimpleNamespace(apply=segment.segment_sum)

    def __exit__(self, *exc):
        for m, k, v in self.saved:
            setattr(m, k, v)


def phase_softmax_passes(dev, graph, iters=50):
    """``gather_rows`` and ``segment_max`` on the calibrated arxiv twin at P = 1
    against PyTorch's calls (see the module doc).  Returns ``{name: row}``."""
    from graph_odenet_tpu_torch.ops import csr_spmm
    from graph_odenet_tpu_torch.ops.csr_spmm import MAX_FLOOR, gather_rows, segment_max
    from graph_odenet_tpu_torch.parallel import partition_by_receiver

    pg = partition_by_receiver(graph, 1).to(dev)
    blk, perm = pg.blocks[0], pg.bucket(0, 0).t_perm
    n, n_edge = pg.block_size, blk.receivers.shape[0]
    rng = np.random.default_rng(51)

    def scatter_max(e, rows):
        m = e.new_full((n, e.shape[1]), MAX_FLOOR)
        return m.scatter_reduce(0, rows[:, None].expand_as(e), e, "amax", include_self=True)

    def bits(t):
        return t.view(torch.int32)

    rows = {}
    for heads in (1, 4):
        table, e = _randn(rng, (n, heads), dev), _randn(rng, (n_edge, heads), dev)
        per_edge = _randn(rng, (n_edge, heads), dev)
        e_t, rows_t = e.index_select(0, perm), blk.receivers.index_select(0, perm)
        # (kernel, PyTorch's call, rows of the table or of the max): the gathers of
        # m and of the denominators (by receiver), of the scores (by sender), of the
        # scores' gradients into CSC order (an [E, H] table by t_perm); the max in
        # CSR order and in t_perm's.
        calls = {
            "gather_rows receivers": (lambda: gather_rows(table, blk.receivers),
                                      lambda: table.index_select(0, blk.receivers), n),
            "gather_rows senders": (lambda: gather_rows(table, blk.senders),
                                    lambda: table.index_select(0, blk.senders), n),
            "gather_rows t_perm": (lambda: gather_rows(per_edge, perm),
                                   lambda: per_edge.index_select(0, perm), n_edge),
            "segment_max sorted": (lambda: segment_max(e, blk.receivers, n),
                                   lambda: scatter_max(e, blk.receivers), n),
            "segment_max t_perm": (lambda: segment_max(e_t, rows_t, n),
                                   lambda: scatter_max(e_t, rows_t), n),
        }
        for key, (kernel, library, n_table) in calls.items():
            name = key.split()[0]
            counter = f"{name}_launches"
            before = getattr(csr_spmm, counter)
            got, want = kernel(), library()
            torch.cuda.synchronize()
            if getattr(csr_spmm, counter) - before != 1 or not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"softmax_passes {key} H={heads}: not one launch or not "
                                     "bit-equal to PyTorch's call")
            times = alternate({"kernel": kernel, "library": library}, iters)
            costs, lib_costs = call_costs(kernel, calls=200), call_costs(library, calls=200)
            # segment_max: its kernel beside the fill of the floor.
            most = 1 if name == "gather_rows" else 2
            mine = ("gather_rows_kernel", "gather_packed_kernel") if name == "gather_rows" \
                else ("segment_max_kernel",)
            if costs["launches_per_call"] > most or not any(m in k for m in mine
                                                             for k in costs["kernels"]):
                raise AssertionError(f"softmax_passes {key}: kernels {costs['kernels']}")
            # [E, H] f32 written (gather) or read (max), E int64 indices, the table or the max.
            cost = bound(n_edge * heads * 4 + n_edge * 8 + n_table * heads * 4, 0)
            rows[f"{key} H={heads}"] = row = dict(
                ms=times["kernel"], library_ms=times["library"], **cost,
                shape=f"[{n_edge}, {heads}] f32, {n_table} rows of table or max",
                host_us=costs["host_us"], device_us=costs["device_us"],
                library_host_us=lib_costs["host_us"], library_device_us=lib_costs["device_us"],
                launches_per_call=costs["launches_per_call"], kernels=costs["kernels"],
                share_of_bound=(cost["bound_ms"] * 1e3 / costs["device_us"]
                                if costs["device_us"] else float("nan")))
            emit("softmax_passes", name=f"{key} H={heads}", **row)
    return rows


def sharded_gat_config():
    """The sharded GAT-ODE's recipe on the calibrated arxiv twin (phases
    config4_gat and bf16)."""
    from graph_odenet_tpu_torch.parallel import ShardedTrainConfig

    return ShardedTrainConfig(
        model="gatode", hidden=GAT_HIDDEN, heads=GAT_HEADS, steps=GAT_STEPS, dropout=0.6, lr=0.01,
        weight_decay=5e-4, mode="ring_pallas", remat=True, epochs=GAT_EPOCHS)


def phase_config4_gat(dev, data):
    """The sharded GAT-ODE at full width through the trainer (see the module doc)."""
    from graph_odenet_tpu_torch.ops import csr_spmm
    from graph_odenet_tpu_torch.parallel import (
        fit_sharded_node_classifier, partition_by_receiver, sharded_gat,
    )

    cfg = sharded_gat_config()
    pg = partition_by_receiver(data.graph, 1).to(dev)
    model = sharded_gat.init_gatode_params(
        data.features.shape[1], cfg.hidden, cfg.heads, data.n_class,
        generator=torch.Generator().manual_seed(0)).to(dev)
    x, labels = data.features.to(dev), data.labels.to(dev)
    y1h = torch.nn.functional.one_hot(labels.clamp(min=0), data.n_class).float()
    w = torch.zeros(data.graph.n_node_pad, device=dev)
    w[data.idx_train.to(dev)] = 1.0

    def step(mode="ring_pallas", remat=True):
        model.zero_grad(set_to_none=True)
        lp = sharded_gat.gatode_forward(model, pg, x, steps=cfg.steps, t1=cfg.t1, mode=mode,
                                        remat=remat)
        loss = -(lp * y1h).sum(-1).mul(w).sum() / w.sum()
        loss.backward()
        return loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}

    # One training step (dropout 0): the kernel against the bucket mode's plain
    # version, and against the ring of online-softmax updates (no kernel).
    before = csr_spmm.bucket_weighted_launches, csr_spmm.edge_dot_launches
    loss_k, grads_k = step()
    check_launches = csr_spmm.bucket_weighted_launches - before[0]
    check_dots = csr_spmm.edge_dot_launches - before[1]
    with plain_bucket_mode():
        loss_p, grads_p = step()
    loss_r, grads_r = step(mode="ring")
    torch.cuda.synchronize()
    if (csr_spmm.bucket_weighted_launches - before[0],
            csr_spmm.edge_dot_launches - before[1]) != (check_launches, check_dots):
        raise AssertionError("the plain step or the ring step launched a kernel")
    step_err = {}
    for name, loss, grads in (("plain", loss_p, grads_p), ("ring", loss_r, grads_r)):
        torch.testing.assert_close(loss_k, loss, rtol=CONFIG4_RTOL, atol=0.0, msg=name)
        step_err[name] = {"loss": float((loss_k - loss).abs() / loss.abs()),
                          **_grads_close(grads_k, grads, CONFIG4_RTOL, f"config4_gat {name}")}
    del grads_k, grads_p, grads_r

    # Peak device memory and ms of one step with and without remat; remat is
    # needed where the step without it does not fit the card.
    peak = {}
    for remat in (True, False):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        step(remat=remat)
        torch.cuda.synchronize()
        peak["remat" if remat else "no_remat"] = dict(
            resident_gb=resident / 1e9, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    peak.update(card_gb=card_gb, remat_needed=peak["no_remat"]["peak_gb"] > card_gb)
    remat_ms = alternate({"remat": lambda: step(remat=True),
                          "no_remat": lambda: step(remat=False)}, iters=2)
    profile = profile_steps(model, step, cfg, top=12)
    del model, pg, x, y1h, w

    csr_spmm.bucket_weighted_launches = csr_spmm.edge_dot_launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = fit_sharded_node_classifier(cfg, data)
    launches, dots = csr_spmm.bucket_weighted_launches, csr_spmm.edge_dot_launches
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    epochs = res["epochs_run"]
    evals = len([e for e in range(epochs) if e % 5 == 0 or e == epochs - 1])
    per_step = 2 * GAT_LAYERS_PER_FORWARD + 4 * GAT_STEPS  # forward, backward, remat's recompute
    want = epochs * per_step + evals * GAT_LAYERS_PER_FORWARD
    if not (np.isfinite(res["loss_first"]) and np.isfinite(res["loss_final"])):
        raise AssertionError(f"config4_gat: non-finite loss {res}")
    if not res["loss_final"] < res["loss_first"]:
        raise AssertionError(f"config4_gat: the loss did not fall: {res}")
    if not res["test_acc"] > GAT_MIN_TEST_ACC_SHARDED:
        raise AssertionError(f"config4_gat: test accuracy {res['test_acc']} <= {GAT_MIN_TEST_ACC_SHARDED}")
    # B2-w's per-edge dot: once a layer in each training step's backward, never
    # in an evaluation.
    if launches != want or check_launches != per_step or dots != epochs * GAT_LAYERS_PER_FORWARD \
            or check_dots != GAT_LAYERS_PER_FORWARD:
        raise AssertionError(
            f"config4_gat: {launches} B2-w launches for {epochs} epochs and {evals} evaluations "
            f"(expected {want}); {check_launches} in the checked step (expected {per_step}); "
            f"{dots} per-edge dots (expected {epochs * GAT_LAYERS_PER_FORWARD}), "
            f"{check_dots} in the checked step (expected {GAT_LAYERS_PER_FORWARD})")
    emit(
        "config4_gat", model=cfg.model, hidden=cfg.hidden, heads=cfg.heads, steps=cfg.steps,
        mode=cfg.mode, remat=cfg.remat, dropout=cfg.dropout, n_parts=res["n_parts"],
        n_node_pad=data.graph.n_node_pad, n_edge=data.graph.n_edge, epochs_run=epochs,
        best_epoch=res["best_epoch"], test_acc=res["test_acc"], val_acc=res["val_acc"],
        val_loss=res["val_loss"], loss_first=res["loss_first"], loss_final=res["loss_final"],
        step_ms=res["step_ms"], seconds=res["seconds"], seconds_per_epoch=res["seconds"] / epochs,
        launches=launches, launches_per_step=per_step, edge_dot_launches=dots,
        edge_dot_launches_per_step=check_dots, train_peak_gb=train_peak_gb,
        one_step_check=dict(rtol=CONFIG4_RTOL, launches=check_launches,
                            edge_dot_launches=check_dots, err_over_tol=step_err),
        step_peak_memory=peak, fwd_bwd_ms=remat_ms, profile=profile,
    )
    return dict(bucket_weighted=launches, edge_dot=dots)


def _rel_err(got, want):
    """Largest |got − want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max())


def _kernel_counts():
    from graph_odenet_tpu_torch.ops import csr_spmm, gat_attn

    return dict(csr=csr_spmm.launches, csr_weighted=csr_spmm.weighted_launches,
                bucket=csr_spmm.bucket_launches,
                bucket_weighted=csr_spmm.bucket_weighted_launches,
                edge_dot=csr_spmm.edge_dot_launches, **gat_attn.launches)


def phase_physics(dev, epochs=PHYS_EPOCHS):
    """Config 3 (see the module doc): the batched solver's checks, a profile
    of both trainers' steps, then the deliverable at full width."""
    from types import SimpleNamespace

    from graph_odenet_tpu_torch.configs import CONFIG_NAMES, get_config, run_config
    from graph_odenet_tpu_torch.data import SpringSystem, generate_trajectories, one_step_dataset
    from graph_odenet_tpu_torch.models import INODE, InteractionNetwork
    from graph_odenet_tpu_torch.train.physics import physics_rollout_curves, trajectory_windows

    _, cfg = get_config(3)
    t0 = time.perf_counter()
    system = SpringSystem(n_bodies=cfg.n_bodies, dim=cfg.dim)
    trajs = generate_trajectories(system, cfg.n_sims, cfg.n_steps,
                                  generator=torch.Generator().manual_seed(cfg.seed), device=dev)
    wins = trajectory_windows(trajs, cfg.ode_window)[:PHYS_WINDOWS].double()
    model = INODE(
        dim=cfg.dim, effect_dim=cfg.effect_dim, relation_hidden=cfg.relation_hidden,
        object_hidden=cfg.object_hidden, method=cfg.ode_method, steps=cfg.ode_steps,
        remat=cfg.ode_remat, rtol=cfg.rtol, atol=cfg.atol,
        generator=torch.Generator().manual_seed(cfg.seed),
    ).double().to(dev)
    ts = torch.arange(cfg.ode_window + 1, dtype=torch.float64) * system.dt

    def solve(m, batch):
        senders, receivers = system.edges(batch.device)
        w0 = batch[:, 0]
        return m(w0[..., 1:], ts, w0[..., :1], senders, receivers)

    def counts(m):
        return {k: m.stats[k].cpu() for k in ("n_accept", "n_reject")}

    # (a) One batched solve against one solve per window, in float64.
    with fixed_order_sums(warn_only=True), torch.no_grad():
        together = solve(model, wins)
        batched = counts(model)
        alone, one_by_one = [], {k: [] for k in batched}
        for i in range(PHYS_WINDOWS):
            alone.append(solve(model, wins[i:i + 1]))
            for k, v in counts(model).items():
                one_by_one[k].append(v)
    one_by_one = {k: torch.cat(v) for k, v in one_by_one.items()}
    for k in batched:
        if not torch.equal(batched[k], one_by_one[k]):
            raise AssertionError(f"physics: {k} batched {batched[k].tolist()} against one by "
                                 f"one {one_by_one[k].tolist()}")
    traj_err = _rel_err(together, torch.cat(alone))
    if not traj_err <= PHYS_REL:
        raise AssertionError(f"physics: batched against one by one {traj_err} > {PHYS_REL}")

    # One training step's gradient on the card against the CPU, in float64.
    def step(m, batch):
        m.zero_grad(set_to_none=True)
        loss = torch.mean((solve(m, batch) - batch[..., 1:]) ** 2)
        loss.backward()
        return loss.detach().cpu(), {k: p.grad.cpu() for k, p in m.named_parameters()}

    with fixed_order_sums(warn_only=True):
        loss_card, grads_card = step(model, wins)
    loss_cpu, grads_cpu = step(copy.deepcopy(model).cpu(), wins.cpu())
    grad_err = {k: _rel_err(grads_card[k], g) for k, g in grads_cpu.items()}
    grad_err["loss"] = _rel_err(loss_card, loss_cpu)
    if not max(grad_err.values()) <= PHYS_GRAD_REL:
        raise AssertionError(f"physics: card against CPU gradient {grad_err} > {PHYS_GRAD_REL}")
    check_seconds = time.perf_counter() - t0

    # Where a training step's time goes, at the config's batch, in float32.
    opt_cfg = SimpleNamespace(lr=cfg.lr, weight_decay=0.0)
    batch = trajectory_windows(trajs, cfg.ode_window)[:cfg.batch_size]
    inode = INODE(
        dim=cfg.dim, effect_dim=cfg.effect_dim, relation_hidden=cfg.relation_hidden,
        object_hidden=cfg.object_hidden, method=cfg.ode_method, steps=cfg.ode_steps,
        remat=cfg.ode_remat, rtol=cfg.rtol, atol=cfg.atol,
        generator=torch.Generator().manual_seed(cfg.seed),
    ).to(dev)
    net = InteractionNetwork(1 + 2 * cfg.dim, cfg.dim, cfg.effect_dim, cfg.relation_hidden,
                             cfg.object_hidden, generator=torch.Generator().manual_seed(0)).to(dev)
    states, targets = (x[:cfg.batch_size] for x in one_step_dataset(trajs, cfg.dim))
    senders, receivers = system.edges(dev)

    def inode_step():
        inode.zero_grad(set_to_none=True)
        torch.mean((solve(inode, batch) - batch[..., 1:]) ** 2).backward()

    def net_step():
        net.zero_grad(set_to_none=True)
        torch.mean((net(states, senders, receivers) - targets) ** 2).backward()

    profile = dict(inode=profile_steps(inode, inode_step, opt_cfg, steps=2, top=6),
                   inode_host_reads_per_forward=inode.stats["host_reads"],
                   discrete=profile_steps(net, net_step, opt_cfg, steps=10, top=6))
    del model, trajs, wins, inode, net, batch, states, targets

    # (b) Config 3 at full width through its entry points.
    before = _kernel_counts()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    if epochs == cfg.epochs:
        res = run_config(3, rollout=PHYS_HORIZON, device=dev)
    else:
        res = dict(physics_rollout_curves(dataclasses.replace(cfg, epochs=epochs),
                                          horizon=PHYS_HORIZON, device=dev),
                   config=CONFIG_NAMES[3])
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated(dev)
    launched = {k: v - before[k] for k, v in _kernel_counts().items()}
    epochs = res["cfg"]["epochs"]
    histories = {k: res[k] for k in ("one_step_mse_history", "window_mse_history")}
    for name, h in histories.items():
        if not (len(h) == epochs and np.all(np.isfinite(h)) and h[-1] < h[0]):
            raise AssertionError(f"physics: {name} did not fall or is not finite: {h}")
    disc, ode = res["rollout_mse_discrete"], res["rollout_mse_inode"]
    if not (np.all(np.isfinite(disc)) and np.all(np.isfinite(ode)) and disc[0] < 1e-9
            and ode[0] < 1e-9):
        raise AssertionError(f"physics: rollout curves {disc} {ode}")
    if not ode[PHYS_HORIZON] < disc[PHYS_HORIZON]:
        raise AssertionError(f"physics: IN-ODE rollout MSE {ode[PHYS_HORIZON]} not below the "
                             f"discrete IN's {disc[PHYS_HORIZON]} at {PHYS_HORIZON}")
    emit(
        "physics", config=res["config"], device=res["device"],
        epochs_cut_from=None if epochs == cfg.epochs else cfg.epochs,
        check=dict(windows=PHYS_WINDOWS, dtype="float64", n_accept=batched["n_accept"].tolist(),
                   n_reject=batched["n_reject"].tolist(), traj_rel_err=traj_err,
                   traj_rel_tol=PHYS_REL, grad_rel_err=grad_err, grad_rel_tol=PHYS_GRAD_REL,
                   seconds=check_seconds),
        profile=profile,
        epochs=epochs, n_windows=res["cfg"]["n_sims"] * (res["cfg"]["n_steps"]
                                                         // res["cfg"]["ode_window"]),
        seconds_per_epoch_in=res["train_seconds_in"] / epochs,
        seconds_per_epoch_inode=res["train_seconds_inode"] / epochs,
        train_seconds_in=res["train_seconds_in"], train_seconds_inode=res["train_seconds_inode"],
        one_step_mse=res["one_step_mse"], window_mse=res["window_mse"], **histories,
        train_solver=res["train_solver"], rollout_solver=res["rollout_solver"],
        peak_memory_bytes=peak,
        rollout_mse={h: dict(discrete=disc[h], inode=ode[h]) for h in PHYS_HORIZONS},
        total_seconds=res["total_seconds"], wall_seconds=wall, kernel_launches=launched,
    )
    return dict(method=cfg.ode_method, epochs=epochs,
                seconds_per_epoch_inode=res["train_seconds_inode"] / epochs,
                window_mse=res["window_mse"], window_mse_history=res["window_mse_history"],
                train_solver=res["train_solver"], rollout_solver=res["rollout_solver"],
                peak_memory_bytes=peak, rollout_mse_inode={h: ode[h] for h in PHYS_HORIZONS},
                inode_host_reads_per_forward=profile["inode_host_reads_per_forward"],
                profile=profile["inode"])


class adjoint_probe:
    """Counts what the port reports nowhere, by wrappers in this script: calls
    of ``owner.attr`` (the dynamics), those made inside an adjoint's backward,
    and the success flags of the continuous adjoint's reverse solves (JAX's
    ``odeint_adjoint`` does not surface them either).  The flags are kept as
    they come and read after the block, so the probe adds no host read."""

    def __init__(self, owner, attr="forward"):
        self.owner, self.attr = owner, attr
        self.evals = self.reverse_evals = 0
        self.in_reverse = False
        self.reverse_success = []

    def __enter__(self):
        from graph_odenet_tpu_torch.ode import adjoint

        probe, dynamics, odeint = self, getattr(self.owner, self.attr), adjoint.odeint
        fns = (adjoint._OdeintAdjoint, adjoint._OdeintCkptAdjoint)
        self.saved = [(self.owner, self.attr, dynamics), (adjoint, "odeint", odeint)] + [
            (fn, "backward", staticmethod(fn.backward)) for fn in fns]

        def counted(*args, **kw):
            probe.evals += 1
            probe.reverse_evals += probe.in_reverse
            return dynamics(*args, **kw)

        def reverse_odeint(*args, **kw):
            if not probe.in_reverse:
                return odeint(*args, **kw)
            ys, stats = odeint(*args, **dict(kw, return_stats=True))
            probe.reverse_success.append(stats["success"])
            return ys

        def reversing(backward):
            def wrapped(ctx, *grads):
                probe.in_reverse = True
                try:
                    return backward(ctx, *grads)
                finally:
                    probe.in_reverse = False
            return staticmethod(wrapped)

        setattr(self.owner, self.attr, counted)
        adjoint.odeint = reverse_odeint
        for fn in fns:
            fn.backward = reversing(fn.backward)
        return self

    def __exit__(self, *exc):
        for obj, name, value in self.saved:
            setattr(obj, name, value)

    def reverse_solves(self):
        """Reverse solves (samples of a batch each), and how many of them
        reached the first output time."""
        flags = [torch.as_tensor(f).reshape(-1) for f in self.reverse_success]
        flags = torch.cat(flags).cpu() if flags else torch.zeros(0, dtype=torch.bool)
        return dict(solves=int(flags.numel()), reached=int(flags.sum()))


def host_syncs(fn):
    """The synchronising calls (host reads of device values) of ``fn()``, by the
    warnings of ``torch.cuda.set_sync_debug_mode`` (its own notice, once a
    process, that the mode is a prototype is not one)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


class plain_calls:
    """Counts calls of the kernels' plain versions inside the block."""

    def __enter__(self):
        from graph_odenet_tpu_torch.ops import csr_spmm, gat_attn

        self.count = 0
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in (
            (csr_spmm, "_reduce_plain"), (csr_spmm, "_bucket_reduce_plain"),
            (csr_spmm, "_edge_dot_plain"), (gat_attn, "gat_fwd_plain"),
            (gat_attn, "gat_bwd_plain"), (gat_attn, "gat_dwh_plain"))]

        def counting(fn):
            def wrapped(*args, **kw):
                self.count += 1
                return fn(*args, **kw)
            return wrapped

        for mod, name, fn in self.saved:
            setattr(mod, name, counting(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def adjoint_step_check(cfg, data, adjoint, dev, seed=0, rtol=ADJ_RTOL):
    """One training step of ``cfg``'s model on ``data`` (feature dropout 0; GAT-ODE keeps
    its encoder's hash attention dropout, seeded alike) with ``adjoint``:
    through the kernels in float32, its backward profiled, against the same
    adjoint through the plain segment path in float64 with the sums in a
    fixed order (``fixed_order_sums``: GCN-ODE's encoder has a ReLU), at
    ``rtol`` (atol ``rtol`` of each gradient's largest entry plus ``ADJ_F32``
    times the plain float32 path's own error on it); and the gap of each
    gradient to direct backprop through the kernels, as a number.  Raises
    unless the backward launched the model's kernels (``ADJ_KERNELS``; with
    ``adjoint`` False, direct backprop, ``BACKPROP_KERNELS``) and called no
    plain version."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from graph_odenet_tpu_torch.ops import prepare
    from graph_odenet_tpu_torch.train import build_model
    from graph_odenet_tpu_torch.train.node_classification import GAT_FAMILY
    from graph_odenet_tpu_torch.utils.metrics import masked_nll

    name = cfg.model
    gat = name in GAT_FAMILY
    model = build_model(dataclasses.replace(cfg, adjoint=adjoint), data.n_class,
                        data.features.shape[1], generator=torch.Generator().manual_seed(seed))
    model.dropout = 0.0
    model.to(dev)
    csr = prepare(data.graph).to(dev)

    def forward(m, adj, x):
        kw = dict(deterministic=False, seed_generator=torch.Generator().manual_seed(seed))
        m.zero_grad(set_to_none=True)
        return masked_nll(m(adj, x, **kw) if gat else m(adj, x), data.labels, data.idx_train)

    def grads(m):
        return {k: p.grad.detach().double() for k, p in m.named_parameters()}

    with plain_calls() as plain:
        loss = forward(model, csr, data.features)
        before = _kernel_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loss.backward()
            torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _kernel_counts().items() if v > before[k]}
    kernel_grads = grads(model)
    seen = sorted({e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA})
    missing = [k for k in (ADJ_KERNELS if adjoint else BACKPROP_KERNELS)[name]
               if not any(k in s for s in seen)]
    if missing or plain.count:
        raise AssertionError(f"adjoint {name} {adjoint!r}: backward launched no {missing}, "
                             f"{plain.count} plain-version calls; kernels {seen}")
    stats = dict(model.odeblock.stats)

    plain = {}
    for dtype in (torch.float64, torch.float32):
        plain_model = copy.deepcopy(model).to(dtype)
        with fixed_order_sums(warn_only=True):
            plain_loss = forward(plain_model, data.graph, data.features.to(dtype))
            plain_loss.backward()
        plain[dtype] = plain_loss.detach().double(), grads(plain_model)
    (want_loss, want), (_, f32) = plain[torch.float64], plain[torch.float32]
    err = {"loss": float((loss.detach().double() - want_loss).abs() / want_loss.abs())}
    f32_err = {k: float((f32[k] - g).abs().max() / g.abs().max()) for k, g in want.items()}
    for k, g in want.items():
        atol = rtol * float(g.abs().max()) + ADJ_F32 * float((f32[k] - g).abs().max())
        err[k] = float(((kernel_grads[k] - g).abs() / (atol + rtol * g.abs())).max())
        torch.testing.assert_close(kernel_grads[k], g, rtol=rtol, atol=atol, msg=lambda m, k=k: (
            f"{cfg.method} {name} adjoint {adjoint!r} {k}: {err[k]} of the tolerance\n{m}"))

    gap = None
    if adjoint:
        model.odeblock.adjoint = False
        forward(model, csr, data.features).backward()
        direct = grads(model)
        gap = {k: float((g - direct[k]).abs().max() / direct[k].abs().max())
               for k, g in kernel_grads.items()}
    return dict(model=name, method=cfg.method, adjoint=adjoint, rtol=rtol, f32_factor=ADJ_F32,
                err_over_tol=err,
                max_err_over_tol=max(v for k, v in err.items() if k != "loss"),
                plain_f32_rel_err=f32_err,
                backward_launches=launched, backward_device_kernels=len(seen),
                backward_port_kernels=sorted({k for k in ("csr_reduce_kernel", "gat_fwd_kernel",
                                                          "gat_bwd_kernel", "gat_dwh_kernel")
                                              if any(k in s for s in seen)}),
                forward_stats=stats, rel_gap_to_direct_backprop=gap)


def train_with_adjoint(cfg, data, adjoint, dev):
    """``cfg`` trained through ``fit_node_classifier`` with ``adjoint``: its
    result, the dynamics' evaluations an epoch in the backward, the reverse
    solves' reach, the host's reads in one more training step, peak memory."""
    from graph_odenet_tpu_torch.models.odeblock import GATDynamics
    from graph_odenet_tpu_torch.ops import prepare
    from graph_odenet_tpu_torch.train import build_model, fit_node_classifier
    from graph_odenet_tpu_torch.utils.metrics import masked_nll

    before = _kernel_counts()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp, adjoint_probe(GATDynamics) as probe:
        cfg = dataclasses.replace(cfg, adjoint=adjoint, log_path=os.path.join(tmp, "log.jsonl"))
        res = fit_node_classifier(cfg, data, device=dev)
        with open(cfg.log_path) as fh:
            losses = [json.loads(line)["loss"] for line in fh]
    peak = torch.cuda.max_memory_allocated(dev)
    launched = {k: v - before[k] for k, v in _kernel_counts().items() if v > before[k]}

    # One more training step, as the trainer takes it, for its host reads.
    model = build_model(cfg, data.n_class, data.features.shape[1]).to(dev)
    csr = prepare(data.graph).to(dev)
    gens = dict(generator=torch.Generator(device=dev).manual_seed(cfg.seed),
                seed_generator=torch.Generator().manual_seed(cfg.seed))
    out = {}

    def fwd():
        out["loss"] = masked_nll(model(csr, data.features, deterministic=False, **gens),
                                 data.labels, data.idx_train)

    reads = dict(forward=host_syncs(fwd), backward=host_syncs(lambda: out["loss"].backward()))
    epochs = res["epochs_run"]
    return dict(
        adjoint=adjoint, epochs=epochs, seconds_per_epoch=res["seconds"] / epochs,
        test_acc=res["best"]["test_acc"], best_epoch=res["best"]["epoch"],
        loss_first=losses[0], loss_last5=float(np.mean(losses[-5:])), peak_memory_bytes=peak,
        ode_stats=res["ode_stats"], reverse_evals_per_epoch=probe.reverse_evals / epochs,
        evals_per_epoch=probe.evals / epochs, reverse_solves=probe.reverse_solves(),
        host_reads_per_step=reads, kernel_launches=launched,
    )


def inode_adjoints(dev, windows=PHYS_WINDOWS):
    """Config 3's IN-ODE at full width with both adjoints: in float64, the
    batched adjoint's gradient over ``windows`` windows against the sum of
    one solve per window (``PHYS_REL``, the sums in a fixed order); then one
    training step at the config's batch with each adjoint and with direct
    backprop (``remat`` as configured): wall ms, peak memory, evaluations."""
    from graph_odenet_tpu_torch.configs import get_config
    from graph_odenet_tpu_torch.data import SpringSystem, generate_trajectories
    from graph_odenet_tpu_torch.models import INODE
    from graph_odenet_tpu_torch.train.physics import trajectory_windows

    _, cfg = get_config(3)
    system = SpringSystem(n_bodies=cfg.n_bodies, dim=cfg.dim)
    trajs = generate_trajectories(system, cfg.n_sims, cfg.n_steps,
                                  generator=torch.Generator().manual_seed(cfg.seed), device=dev)
    ts = torch.arange(cfg.ode_window + 1, dtype=torch.float64) * system.dt
    senders, receivers = system.edges(dev)

    def make(adjoint, dtype):
        return INODE(
            dim=cfg.dim, effect_dim=cfg.effect_dim, relation_hidden=cfg.relation_hidden,
            object_hidden=cfg.object_hidden, method=cfg.ode_method, steps=cfg.ode_steps,
            remat=cfg.ode_remat, rtol=cfg.rtol, atol=cfg.atol, adjoint=adjoint,
            generator=torch.Generator().manual_seed(cfg.seed),
        ).to(dtype=dtype, device=dev)

    def step(m, batch, per_window=False):
        """A training step's gradients; ``per_window``: of the sum of each
        window's loss, so that each window's cotangent, which the continuous
        adjoint's reverse solve controls against ``atol``, is the same in a
        batch as alone."""
        m.zero_grad(set_to_none=True)
        w0 = batch[:, 0]
        out = m(w0[..., 1:], ts.to(batch.dtype), w0[..., :1], senders, receivers)
        err = (out - batch[..., 1:]) ** 2
        (err.flatten(1).mean(1).sum() if per_window else err.mean()).backward()
        return {k: p.grad.detach().clone() for k, p in m.named_parameters()}

    wins = trajectory_windows(trajs, cfg.ode_window)[:windows].double()
    checks = {}
    for adjoint in ADJOINTS:
        m = make(adjoint, torch.float64)
        with fixed_order_sums(warn_only=True), adjoint_probe(INODE, "_dynamics") as probe:
            together = step(m, wins, per_window=True)
            n_accept = m.stats["n_accept"].tolist()
            alone = [step(m, wins[i:i + 1], per_window=True) for i in range(windows)]
        err = {k: _rel_err(g, sum(a[k] for a in alone)) for k, g in together.items()}
        if not max(err.values()) <= PHYS_REL:
            raise AssertionError(f"inode adjoint {adjoint!r}: batched against one by one "
                                 f"{err} > {PHYS_REL}")
        checks[str(adjoint)] = dict(max_rel_err=max(err.values()), n_accept=n_accept,
                                    reverse_solves=probe.reverse_solves())

    batch = trajectory_windows(trajs, cfg.ode_window)[:cfg.batch_size]
    steps = {}
    for adjoint in (False,) + ADJOINTS:
        m = make(adjoint, torch.float32)
        step(m, batch)  # warm
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with adjoint_probe(INODE, "_dynamics") as probe:
            t0 = time.perf_counter()
            grads = step(m, batch)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        if not all(torch.isfinite(g).all() for g in grads.values()):
            raise AssertionError(f"inode adjoint {adjoint!r}: non-finite gradient at batch "
                                 f"{cfg.batch_size}")
        steps[str(adjoint)] = dict(
            wall_ms=wall * 1e3, peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
            evals=probe.evals, reverse_evals=probe.reverse_evals,
            reverse_solves=probe.reverse_solves(),
            forward_attempts=int((m.stats["n_accept"] + m.stats["n_reject"]).sum()),
            forward_host_reads=m.stats["host_reads"])
    return dict(config="nbody-inode-rollout", windows=windows, rel_tol=PHYS_REL,
                batched_against_one_by_one=checks, batch=cfg.batch_size, remat=cfg.ode_remat,
                step=steps)


def phase_adjoint(dev, data, epochs=ADJ_EPOCHS):
    """The continuous and checkpointed adjoints on the card (see the module doc)."""
    from graph_odenet_tpu_torch.configs import get_config

    checks = [adjoint_step_check(get_config(f"pubmed-{model}")[1], data, adjoint, dev)
              for model in ADJ_KERNELS for adjoint in ADJOINTS]
    _, cfg = get_config("pubmed-gatode")
    runs = {}
    for adjoint in (False,) + ADJOINTS:
        run = train_with_adjoint(dataclasses.replace(cfg, epochs=epochs), data, adjoint, dev)
        limit = (ADJ_FULL_MIN_TEST_ACC if adjoint == "checkpoint" and epochs == cfg.epochs
                 else ADJ_MIN_TEST_ACC)
        if not (run["loss_last5"] < run["loss_first"] and run["test_acc"] >= limit):
            raise AssertionError(f"pubmed-gatode adjoint={adjoint!r}: loss {run['loss_first']} "
                                 f"-> {run['loss_last5']}, test accuracy {run['test_acc']} "
                                 f"(limit {limit})")
        if adjoint and min(run["kernel_launches"].get(k, 0) for k in (
                "gat_fwd", "gat_bwd", "gat_dwh")) == 0:
            raise AssertionError(f"pubmed-gatode adjoint={adjoint!r}: {run['kernel_launches']}")
        runs[str(adjoint)] = run
    inode = inode_adjoints(dev)
    emit("adjoint", step_checks=checks, pubmed_gatode=runs,
         epochs_cut_from=None if epochs == cfg.epochs else cfg.epochs, inode=inode)
    return dict(checks=checks, runs=runs)


def _zero_kernel_counts():
    from graph_odenet_tpu_torch.ops import csr_spmm, gat_attn

    csr_spmm.launches = csr_spmm.weighted_launches = 0
    csr_spmm.bucket_launches = csr_spmm.bucket_weighted_launches = csr_spmm.edge_dot_launches = 0
    for k in gat_attn.launches:
        gat_attn.launches[k] = 0


def reads_per_attempt(cfg, data, dev):
    """One forward of ``cfg``'s model on the card: its host reads and its
    solver's attempts (accepted and rejected steps)."""
    from graph_odenet_tpu_torch.ops import prepare
    from graph_odenet_tpu_torch.train import build_model

    model = build_model(cfg, data.n_class, data.features.shape[1]).to(dev).eval()
    csr = prepare(data.graph).to(dev)
    with torch.no_grad():
        reads = host_syncs(lambda: model(csr, data.features))
    stats = dict(model.odeblock.stats)
    attempts = stats["n_accept"] + stats["n_reject"]
    return dict(host_reads=reads, attempts=attempts, host_reads_per_attempt=reads / attempts,
                stats=stats)


def phase_solvers(dev, data, arxiv_graph):
    """The Adams family, VCABM, ``scipy_solver`` and the sanitizers on the card
    (see the module doc).  Returns the kernels' launches on the Adams trainings."""
    from graph_odenet_tpu_torch.configs import get_config
    from graph_odenet_tpu_torch.ode import odeint
    from graph_odenet_tpu_torch.ops import prepare
    from graph_odenet_tpu_torch.train import fit_node_classifier
    from graph_odenet_tpu_torch.utils import odeint_checked, validate_tiling

    _, gcn = get_config("pubmed-gcnode")
    _, gat = get_config("pubmed-gatode")
    launches = {}

    def count(run):
        """``run()`` with every kernel count from 0; the counts it left."""
        _zero_kernel_counts()
        out = run()
        for k, v in _kernel_counts().items():
            launches[k] = launches.get(k, 0) + v
        return out

    # (1) pubmed-gcnode trained with each fixed-grid method (B1), in turns.
    trained = []
    for method in SOLVER_TRAIN_METHODS:
        run = lambda: fit_node_classifier(dataclasses.replace(gcn, method=method), data,  # noqa: E731
                                          device=dev)
        res = count(run) if method != "rk4" else run()
        epochs = res["epochs_run"]
        if res["representation"] != "kernel" or not res["best"]["test_acc"] >= MIN_TEST_ACC:
            raise AssertionError(f"pubmed-gcnode {method}: {res['representation']}, test "
                                 f"accuracy {res['best']['test_acc']} < {MIN_TEST_ACC}")
        trained.append(dict(method=method, epochs=epochs, seconds_per_epoch=res["seconds"] / epochs,
                            test_acc=res["best"]["test_acc"], best_epoch=res["best"]["epoch"],
                            nfe_per_forward=res["ode_stats"]["nfe"]))
    # Each epoch aggregates the encoder's, every dynamics evaluation's and the
    # readout's input forward, backward and in evaluation.
    if launches.get("csr", 0) < sum(3 * (t["nfe_per_forward"] + 2) * t["epochs"]
                                    for t in trained if t["method"] != "rk4"):
        raise AssertionError(f"{launches} kernel launches on the Adams trainings {trained}")

    # (2) One step of each model and VCABM form through the kernels against the
    # plain path in float64; the continuous adjoint on implicit_adams.
    checks = [adjoint_step_check(dataclasses.replace(gcn, method=m, steps=VCABM_STEPS), data,
                                 False, dev, rtol=SOLVER_RTOL) for m in ("adams", "adams_scan")]
    checks.append(adjoint_step_check(dataclasses.replace(gat, method="adams_scan"), data, False,
                                     dev, rtol=SOLVER_RTOL))
    for c in checks:
        if not c["forward_stats"]["success"]:
            raise AssertionError(f"{c['model']} {c['method']}: the solve stopped short: "
                                 f"{c['forward_stats']}")
    adj = adjoint_step_check(dataclasses.replace(gcn, method="implicit_adams"), data, True, dev)
    if max(adj["rel_gap_to_direct_backprop"].values()) > SOLVER_ADJ_GAP:
        raise AssertionError(f"implicit_adams continuous adjoint against direct backprop: "
                             f"{adj['rel_gap_to_direct_backprop']}")
    reads = {f"gcnode {m}": reads_per_attempt(dataclasses.replace(gcn, method=m,
                                                                  steps=VCABM_STEPS), data, dev)
             for m in ("adams", "adams_scan", "dopri5_scan")}

    # (3) pubmed-gatode trained on adams_scan (B3-B5) beside dopri5_scan.
    gat_runs = {}
    for method in ("adams_scan", "dopri5_scan"):
        cfg = dataclasses.replace(gat, method=method, epochs=SOLVER_GAT_EPOCHS)
        run = lambda: train_with_adjoint(cfg, data, False, dev)  # noqa: E731
        r = count(run) if method == "adams_scan" else run()
        if not (r["loss_last5"] < r["loss_first"] and r["test_acc"] >= ADJ_MIN_TEST_ACC):
            raise AssertionError(f"pubmed-gatode {method}: loss {r['loss_first']} -> "
                                 f"{r['loss_last5']}, test accuracy {r['test_acc']}")
        gat_runs[method] = r
    if min(launches.get(k, 0) for k in ("gat_fwd", "gat_bwd", "gat_dwh")) == 0:
        raise AssertionError(f"pubmed-gatode adams_scan: kernel launches {launches}")

    # (4) scipy_solver on a card tensor against dopri5.
    gen = torch.Generator().manual_seed(0)
    a = (torch.randn(SCIPY_DIM, SCIPY_DIM, generator=gen, dtype=torch.float64)
         / SCIPY_DIM ** 0.5).to(dev)
    y0 = torch.randn(SCIPY_DIM, generator=gen, dtype=torch.float64).to(dev)
    ts = torch.linspace(0.0, 1.0, 5, dtype=torch.float64, device=dev)

    def field(t, y):
        return torch.tanh(a @ y) - 0.5 * y + 0.1 * torch.sin(t)

    t0 = time.perf_counter()
    ys_scipy = odeint(field, y0, ts, method="scipy_solver", rtol=1e-10, atol=1e-12)
    scipy_ms = (time.perf_counter() - t0) * 1e3
    ys_dopri, dopri = odeint(field, y0, ts, method="dopri5", rtol=1e-10, atol=1e-12,
                             return_stats=True)
    if ys_scipy.device != y0.device or ys_scipy.dtype != y0.dtype:
        raise AssertionError(f"scipy_solver returned {ys_scipy.dtype} on {ys_scipy.device}")
    torch.testing.assert_close(ys_scipy, ys_dopri, rtol=SCIPY_RTOL, atol=SCIPY_RTOL)

    # (5) A NaN made on the card is caught.
    try:
        odeint_checked(lambda t, y: -y + torch.where(t > 0.5, torch.nan, 0.0),
                       torch.ones(1000, device=dev), torch.linspace(0.0, 1.0, 5, device=dev),
                       method="rk4")
    except RuntimeError as e:
        nan_message = str(e)
    else:
        raise AssertionError("odeint_checked let a NaN made on the card through")

    # (6) validate_tiling on the full arxiv twin (host views, as prepare runs it).
    t0 = time.perf_counter()
    csr = prepare(arxiv_graph)
    prepare_ms = (time.perf_counter() - t0) * 1e3
    validate_ms = []
    for _ in range(VALIDATE_REPEATS):
        t0 = time.perf_counter()
        validate_tiling(csr)
        validate_ms.append((time.perf_counter() - t0) * 1e3)

    emit("solvers", pubmed_gcnode=trained, step_checks=checks, implicit_adams_adjoint=adj,
         reads_per_attempt=reads, pubmed_gatode=gat_runs,
         scipy=dict(dim=SCIPY_DIM, ms=scipy_ms, rtol=SCIPY_RTOL,
                    max_abs_diff=float((ys_scipy - ys_dopri).abs().max()), dopri5_stats=dopri),
         odeint_checked_nan=nan_message,
         validate_tiling=dict(n_edge=csr.n_edge, host_ms=validate_ms, prepare_ms=prepare_ms),
         launches=launches)
    return launches


def _scipy_batched(dev):
    """``scipy_solver`` with ``batch_dims=1`` on a card tensor against each
    sample solved alone (``ADAMS_SCIPY_BATCH`` samples of the solvers phase's
    ``SCIPY_DIM``-wide field, each with its own rate)."""
    from graph_odenet_tpu_torch.ode import odeint

    gen = torch.Generator().manual_seed(1)
    a = (torch.randn(SCIPY_DIM, SCIPY_DIM, generator=gen, dtype=torch.float64)
         / SCIPY_DIM ** 0.5).to(dev)
    y0 = torch.randn(ADAMS_SCIPY_BATCH, SCIPY_DIM, generator=gen, dtype=torch.float64).to(dev)
    rate = torch.linspace(0.25, 2.0, ADAMS_SCIPY_BATCH, dtype=torch.float64, device=dev)
    ts = torch.linspace(0.0, 1.0, 5, dtype=torch.float64)
    kw = dict(method="scipy_solver", rtol=1e-10, atol=1e-12)

    def field(t, y):
        return torch.tanh(y @ a.T) - rate[:, None] * y + 0.1 * torch.sin(t)[:, None]

    t0 = time.perf_counter()
    together = odeint(field, y0, ts, batch_dims=1, **kw)
    batched_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    alone = torch.stack([odeint(lambda t, y, b=b: torch.tanh(a @ y) - rate[b] * y
                                + 0.1 * torch.sin(t), y0[b], ts, **kw)
                         for b in range(ADAMS_SCIPY_BATCH)], dim=1)
    alone_ms = (time.perf_counter() - t0) * 1e3
    if together.device != y0.device or together.shape != alone.shape:
        raise AssertionError(f"scipy_solver batched: {tuple(together.shape)} on "
                             f"{together.device}")
    torch.testing.assert_close(together, alone, rtol=SCIPY_RTOL, atol=SCIPY_RTOL)
    return dict(batch=ADAMS_SCIPY_BATCH, dim=SCIPY_DIM, rtol=SCIPY_RTOL, batched_ms=batched_ms,
                one_by_one_ms=alone_ms, max_abs_diff=float((together - alone).abs().max()))


def phase_batched_adams(dev, physics, epochs=ADAMS_EPOCHS):
    """Config 3's IN-ODE on the batched VCABM (see the module doc); ``physics``:
    the physics phase's dopri5_scan figures, printed beside."""
    from types import SimpleNamespace

    from graph_odenet_tpu_torch.configs import get_config
    from graph_odenet_tpu_torch.data import SpringSystem, generate_trajectories
    from graph_odenet_tpu_torch.models import INODE
    from graph_odenet_tpu_torch.train.physics import physics_rollout_curves, trajectory_windows

    _, cfg = get_config(3)
    cfg = dataclasses.replace(cfg, ode_method="adams_scan")
    t0 = time.perf_counter()
    system = SpringSystem(n_bodies=cfg.n_bodies, dim=cfg.dim)
    trajs = generate_trajectories(system, cfg.n_sims, cfg.n_steps,
                                  generator=torch.Generator().manual_seed(cfg.seed), device=dev)
    wins = trajectory_windows(trajs, cfg.ode_window)
    del trajs
    ts = torch.arange(cfg.ode_window + 1, dtype=torch.float64) * system.dt
    senders, receivers = system.edges(dev)

    def make(dtype, adjoint=False):
        return INODE(
            dim=cfg.dim, effect_dim=cfg.effect_dim, relation_hidden=cfg.relation_hidden,
            object_hidden=cfg.object_hidden, method=cfg.ode_method, steps=cfg.ode_steps,
            remat=cfg.ode_remat, rtol=cfg.rtol, atol=cfg.atol, adjoint=adjoint,
            generator=torch.Generator().manual_seed(cfg.seed),
        ).to(dtype=dtype, device=dev)

    def solve(m, batch):
        w0 = batch[:, 0]
        return m(w0[..., 1:], ts.to(batch.dtype), w0[..., :1], senders, receivers)

    # (a) In float64: one batched solve against each window solved alone.  Alone
    # is a batch of copies of the window: the same shapes, so cuBLAS and the
    # reductions round its row as they round it in the batch.  A batch of one
    # rounds otherwise (by 1e-15, the physics phase's check), and VCABM's order
    # rule, which compares error estimates that rounding dominates at this
    # config's small first steps, turns that into other steps (one window took
    # 38 accepts alone against 37 batched on an H100, PERF.md), so the batch of
    # one is reported, not gated.
    small = wins[:PHYS_WINDOWS].double()
    model = make(torch.float64)
    keys = ("nfe", "n_accept", "n_reject", "final_order")

    def copies(i):
        return small[i:i + 1].expand_as(small).contiguous()

    def solve_rows(batch_of, rows):
        """The trajectory and counts of row ``rows(i)`` of each window's solve."""
        outs, counts = [], {k: [] for k in keys}
        for i in range(PHYS_WINDOWS):
            out, r = solve(model, batch_of(i)), rows(i)
            outs.append(out[r])
            for k in keys:
                counts[k].append(int(model.stats[k][r]))
        return torch.stack(outs), counts

    with fixed_order_sums(warn_only=True), torch.no_grad():
        together = solve(model, small)
        batched = {k: model.stats[k].tolist() for k in keys}
        alone, one_by_one = solve_rows(copies, lambda i: 0)
        single, singly = solve_rows(lambda i: small[i:i + 1], lambda i: 0)
    for k in keys:
        if batched[k] != one_by_one[k]:
            raise AssertionError(f"batched_adams: {k} batched {batched[k]} against alone "
                                 f"{one_by_one[k]}")
    traj_err = _rel_err(together, alone)
    if not traj_err <= PHYS_REL:
        raise AssertionError(f"batched_adams: batched against alone {traj_err} > {PHYS_REL}")
    # Two more witnesses that the batch of one differs by rounding alone, not
    # gated.  On the card, the unbatched form (batch_dims=0, the solve the
    # batched one was held to) beside each window's batch of one; where the
    # batch of one takes other steps, the unbatched form's counts with the
    # window's state scaled by 1 + k·2^-52, |k| <= 3: two outcomes there mean
    # the order rule turns one unit of rounding into other steps.  On the
    # CPU, the same windows and weights in float64, batched against each
    # window as a batch of one.
    def unbatched_counts(window, scale=1.0):
        w0 = window[0]
        model(w0[..., 1:] * scale, ts.to(window.dtype), w0[..., :1], senders, receivers)
        return [int(model.stats[k]) for k in keys]

    def cpu_counts(batch, graph):
        w0 = batch[:, 0]
        model(w0[..., 1:], ts, w0[..., :1], *graph)
        return [[int(model.stats[k][r]) for k in keys] for r in range(batch.shape[0])]

    differs = [i for i in range(PHYS_WINDOWS) if any(batched[k][i] != singly[k][i] for k in keys)]
    with fixed_order_sums(warn_only=True), torch.no_grad():
        unbatched = [unbatched_counts(small[i]) for i in range(PHYS_WINDOWS)]
        perturbed = {i: sorted({tuple(unbatched_counts(small[i], 1 + k * 2.0 ** -52))
                                for k in range(-3, 4)}) for i in differs}
        model.cpu()
        graph, on_cpu = (senders.cpu(), receivers.cpu()), small.cpu()
        cpu_batched = cpu_counts(on_cpu, graph)
        cpu_one = [cpu_counts(on_cpu[i:i + 1], graph)[0] for i in range(PHYS_WINDOWS)]
    batch_of_one = dict(
        traj_rel_err=_rel_err(together, single),
        counts_differ={k: [batched[k], singly[k]] for k in keys if batched[k] != singly[k]},
        counts=keys, batched=[[batched[k][i] for k in keys] for i in range(PHYS_WINDOWS)],
        alone=[[singly[k][i] for k in keys] for i in range(PHYS_WINDOWS)],
        unbatched=unbatched, unbatched_perturbed=perturbed,
        cpu_float64=dict(batched=cpu_batched, alone=cpu_one, equal=cpu_batched == cpu_one),
    )

    # The batched continuous adjoint's gradient against the sum of the windows'
    # alone (each window's loss on its first copy).
    adj = make(torch.float64, adjoint=True)

    def window_grads(batch, first=None):
        adj.zero_grad(set_to_none=True)
        err = (solve(adj, batch) - batch[..., 1:]) ** 2
        err.flatten(1).mean(1)[:first].sum().backward()
        return {k: p.grad.detach().clone() for k, p in adj.named_parameters()}

    with fixed_order_sums(warn_only=True):
        grads = window_grads(small)
        per_window = [window_grads(copies(i), first=1) for i in range(PHYS_WINDOWS)]
    adj_err = {k: _rel_err(g, sum(w[k] for w in per_window)) for k, g in grads.items()}
    if not max(adj_err.values()) <= PHYS_REL:
        raise AssertionError(f"batched_adams: adjoint batched against alone {adj_err}")
    scipy = _scipy_batched(dev)
    del model, adj, small, together, alone, single
    check_seconds = time.perf_counter() - t0

    # (c) Where a training step's time goes, and one forward's host reads, at
    # the config's batch in float32.
    batch = wins[:cfg.batch_size]
    inode = make(torch.float32)

    def inode_step():
        inode.zero_grad(set_to_none=True)
        torch.mean((solve(inode, batch) - batch[..., 1:]) ** 2).backward()

    profile = profile_steps(inode, inode_step, SimpleNamespace(lr=cfg.lr, weight_decay=0.0),
                            steps=1, top=8)
    with torch.no_grad():
        syncs = host_syncs(lambda: solve(inode, batch))
    rounds = inode.stats["host_reads"]
    if not syncs <= rounds + VCABM_FIXED_READS:
        raise AssertionError(f"batched_adams: {syncs} host reads in a forward of {rounds} "
                             f"attempt rounds (+{VCABM_FIXED_READS} fixed)")
    reads = dict(syncs=syncs, attempt_rounds=rounds, fixed=VCABM_FIXED_READS,
                 attempts=int((inode.stats["n_accept"] + inode.stats["n_reject"]).sum()))
    del inode, batch, wins

    # (b) Config 3 trained and rolled out on adams_scan at full width.
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    res = physics_rollout_curves(dataclasses.replace(cfg, epochs=epochs), horizon=PHYS_HORIZON,
                                 device=dev)
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated(dev)
    hist = res["window_mse_history"]
    if not (len(hist) == epochs and np.all(np.isfinite(hist)) and hist[-1] < hist[0]):
        raise AssertionError(f"batched_adams: window MSE did not fall or is not finite: {hist}")
    ode = res["rollout_mse_inode"]
    if not (np.all(np.isfinite(ode)) and ode[0] < 1e-9):
        raise AssertionError(f"batched_adams: rollout curve {ode}")
    emit(
        "batched_adams", config=res["config"], device=res["device"], method=cfg.ode_method,
        check=dict(windows=PHYS_WINDOWS, dtype="float64", **batched, traj_rel_err=traj_err,
                   adjoint_grad_rel_err=adj_err, rel_tol=PHYS_REL, batch_of_one=batch_of_one,
                   scipy=scipy, seconds=check_seconds),
        profile=profile, host_reads_per_forward=reads,
        epochs=epochs, epochs_cut_from=cfg.epochs,
        seconds_per_epoch_inode=res["train_seconds_inode"] / epochs,
        seconds_per_epoch_in=res["train_seconds_in"] / epochs,
        window_mse=res["window_mse"], window_mse_history=hist,
        train_solver=res["train_solver"], rollout_solver=res["rollout_solver"],
        peak_memory_bytes=peak,
        rollout_mse={h: dict(discrete=res["rollout_mse_discrete"][h], inode=ode[h])
                     for h in PHYS_HORIZONS},
        total_seconds=res["total_seconds"], wall_seconds=wall,
        dopri5_scan=physics,
    )


def _resume_run(cfg, data, dev, first, total):
    """``total`` epochs straight; then ``first`` epochs saving every epoch, the
    live state dropped, and a fresh call resuming to ``total``.  The losses of
    both, the checkpoint's bytes and each save's and restore's ms."""
    import gc

    from graph_odenet_tpu_torch.parallel import fit_sharded_node_classifier
    from graph_odenet_tpu_torch.utils.checkpoint import Checkpointer

    straight = fit_sharded_node_classifier(dataclasses.replace(cfg, epochs=total), data,
                                           device=dev)["losses"]
    ms = {"save": [], "restore": []}
    real = {k: getattr(Checkpointer, k) for k in ms}

    def timed_call(name):
        def call(self, *args, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = real[name](self, *args, **kw)
            torch.cuda.synchronize(dev)
            ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        kw = dict(ckpt_dir=tmp, ckpt_every=1)
        for k in ms:
            setattr(Checkpointer, k, timed_call(k))
        try:
            res = fit_sharded_node_classifier(dataclasses.replace(cfg, epochs=first, **kw), data,
                                              device=dev)
            losses_first = res["losses"]
            del res  # the failure: nothing is kept but the directory
            gc.collect()
            torch.cuda.empty_cache()
            resumed = fit_sharded_node_classifier(dataclasses.replace(cfg, epochs=total, **kw),
                                                  data, device=dev)
        finally:
            for k, f in real.items():
                setattr(Checkpointer, k, f)
        ckpt = Checkpointer(tmp)
        n_bytes = os.path.getsize(ckpt._path(ckpt.latest_step()))
    return dict(epochs=(first, total), straight=straight, first=losses_first,
                resumed=resumed["losses"], epochs_run=resumed["epochs_run"],
                checkpoint_bytes=n_bytes, save_ms=ms["save"], restore_ms=ms["restore"])


def phase_resume(dev, arxiv, arxiv_cal):
    """Config 4 and the sharded GAT-ODE stopped and resumed from a checkpoint
    (see the module doc)."""
    from graph_odenet_tpu_torch.configs import get_config, sharded_train_config
    from graph_odenet_tpu_torch.parallel import ShardedTrainConfig

    launches = {}

    def counted(kernel, *args):
        """``_resume_run(*args)`` with every kernel count from 0; fails unless
        ``kernel`` launched."""
        _zero_kernel_counts()
        out = _resume_run(*args)
        launches[kernel] = _kernel_counts()[kernel]
        if not launches[kernel]:
            raise AssertionError(f"the resume path launched no {kernel} kernel")
        return out

    config4 = counted("bucket", sharded_train_config(get_config(4)[1]), arxiv, dev,
                      *RESUME_EPOCHS)
    n = RESUME_EPOCHS[0]
    if config4["first"] != config4["straight"][:n] or config4["resumed"] != config4["straight"][n:]:
        raise AssertionError(f"config 4: the resumed run is not the uninterrupted one: {config4}")
    gat = counted("bucket_weighted", ShardedTrainConfig(
        model="gatode", hidden=GAT_HIDDEN, heads=GAT_HEADS, steps=GAT_STEPS, dropout=0.6,
        lr=0.01, weight_decay=5e-4, mode="ring_pallas", remat=True), arxiv_cal, dev,
        *RESUME_GAT_EPOCHS)
    n = RESUME_GAT_EPOCHS[0]
    np.testing.assert_allclose(gat["first"] + gat["resumed"], gat["straight"],
                               rtol=RESUME_GAT_RTOL, atol=0,
                               err_msg="the sharded GAT-ODE's resumed run")
    if gat["epochs_run"] != RESUME_GAT_EPOCHS[1] or len(gat["resumed"]) != RESUME_GAT_EPOCHS[1] - n:
        raise AssertionError(f"the sharded GAT-ODE resumed at the wrong epoch: {gat}")
    emit("resume", config4=dict(config4, bit_equal=True), sharded_gatode=dict(
        gat, rtol=RESUME_GAT_RTOL, max_rel_diff=float(max(
            abs(a - b) / abs(b) for a, b in zip(gat["first"] + gat["resumed"], gat["straight"])))),
        launches=launches)
    return launches


def _run_cli(*argv, launcher=True):
    """The port's CLI in a subprocess on the card: its JSON line and, through
    ``CLI_LAUNCHER``, its kernels' launch counts (plain versions refused);
    without ``launcher``, as users run it, ``python -m``."""
    cmd = [sys.executable, "-c", CLI_LAUNCHER] if launcher else [
        sys.executable, "-m", "graph_odenet_tpu_torch.cli"]
    run = subprocess.run([*cmd, *argv], cwd=ROOT, capture_output=True, text=True, timeout=600)
    if run.returncode:
        raise AssertionError(f"cli {' '.join(argv)}: exit {run.returncode}\n{run.stderr[-4000:]}")
    lines = run.stdout.strip().splitlines()
    return json.loads(lines[-2 if launcher else -1]), json.loads(lines[-1]) if launcher else {}


def phase_surfaces(dev, arxiv):
    """The bench functions, the CLI, ``entry()`` and A20 on the card (see the
    module doc).  Returns each kernel's launches in the phase."""
    from graph_odenet_tpu_torch import bench
    from graph_odenet_tpu_torch.entry import entry
    from graph_odenet_tpu_torch.ops import csr_spmm
    from graph_odenet_tpu_torch.parallel import partition_by_receiver, spmm_sharded

    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # (1) The bench functions at the JAX package's defaults.
    for what, fn, kernels in (
        ("spmm_bench", bench.spmm_bench, ("csr",)),
        ("gat_bench H=8 F=8 dropout 0.6",
         lambda: bench.gat_bench(heads=8, feat=8, dropout=0.6), GAT_KERNELS),
        ("gat_bench H=1 F=128", bench.gat_bench, GAT_KERNELS),
        ("gat_bench H=8 F=8 dropout 0.6 use_scores=False",
         lambda: bench.gat_bench(heads=8, feat=8, dropout=0.6, use_scores=False),
         ("gat_fwd", "gat_bwd", "csr_weighted")),
        ("ode_bench kernel", lambda: bench.ode_bench(representation="kernel"), ("csr",)),
        ("ode_model_bench gcnode train_step",
         lambda: bench.ode_model_bench("gcnode", mode="train_step"), ()),
        ("ode_model_bench gatode train_step",
         lambda: bench.ode_model_bench("gatode", mode="train_step"), GAT_KERNELS),
        ("scaling_bench", bench.scaling_bench, ("bucket",)),
    ):
        _zero_kernel_counts()
        with plain_calls() as plain:
            rec = fn()
            torch.cuda.synchronize()
        counts = _kernel_counts()
        if plain.count or not all(counts[k] for k in kernels) \
                or rec["device"] != torch.cuda.get_device_name(dev):
            raise AssertionError(f"{what}: launches {counts}, plain calls {plain.count}, "
                                 f"record {rec}")
        add(counts)
        emit("surfaces", what=what, record=rec, launches=counts)

    # (2) The CLI: train and save, restore and evaluate, bench.
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        data_flags = ("--dataset", "pubmed", "--calibrated", "--model", "gcnode")
        trained, n_launches = _run_cli("node", *data_flags, "--representation", "kernel",
                                       "--epochs", str(SURFACE_EPOCHS), "--ckpt-dir", tmp,
                                       "--quiet")
        predicted, p_launches = _run_cli("predict", "--ckpt-dir", tmp, *data_flags)
    if not (n_launches["csr"] and p_launches["csr"]) \
            or predicted["test_acc"] != trained["best"]["test_acc"]:
        raise AssertionError(f"cli node {trained} ({n_launches}), predict {predicted} "
                             f"({p_launches})")
    add(n_launches)
    add(p_launches)
    emit("surfaces", what="cli node, predict", node=trained, node_launches=n_launches,
         predict=predicted, predict_launches=p_launches)
    rec, _ = _run_cli("bench", "spmm", launcher=False)
    if rec["device"] != torch.cuda.get_device_name(dev) or not rec["kernel_edges_per_s"] > 0:
        raise AssertionError(f"cli bench spmm: {rec}")
    emit("surfaces", what="cli bench spmm", record=rec)

    # (3) entry(): the card's forward against the CPU's in float64.
    fn, (params, adj, x) = entry()
    with torch.no_grad():
        out = fn(params, adj, x)
        ref = fn({k: v.double().cpu() for k, v in params.items()}, adj.double().cpu(),
                 x.double().cpu())
    torch.cuda.synchronize()
    entry_err = _err(out.cpu(), ref, SLICE_TOL)
    if out.shape != ref.shape or not torch.isfinite(out).all() or entry_err[1] > 1.0:
        raise AssertionError(f"entry(): {tuple(out.shape)}, error {entry_err}")
    emit("surfaces", what="entry", shape=list(out.shape), max_abs_err=entry_err[0],
         max_err_over_tol=entry_err[1], tolerance="rtol=atol=1e-4 against the CPU in float64")

    # (4) A20 at one part through B2: column halves and a leading batch axis.
    pg = partition_by_receiver(arxiv.graph, 1).to(dev)
    view, rows = pg.bucket(0, 0).fwd, pg.block_size
    rng = np.random.default_rng(50)
    x = _randn(rng, (rows, ARXIV_HIDDEN), dev)
    xb = _randn(rng, (A20_BATCH, rows, A20_F), dev)
    half = ARXIV_HIDDEN // 2
    _zero_kernel_counts()
    with plain_calls() as plain:
        full = spmm_sharded(pg, x)
        joined = torch.cat([spmm_sharded(pg, x[:, h * half:(h + 1) * half].contiguous(),
                                         check_vma=False) for h in (0, 1)], dim=1)
        before = csr_spmm.bucket_launches
        batched = spmm_sharded(pg, xb)
        batch_launches = csr_spmm.bucket_launches - before
        singles = torch.stack([spmm_sharded(pg, xb[i].contiguous()) for i in range(A20_BATCH)])
        torch.cuda.synchronize()
    counts = _kernel_counts()
    add(counts)

    def plain64(t):
        return csr_spmm._bucket_reduce_plain(view, t.double(), t.new_empty(
            (rows, t.shape[1]), dtype=torch.float64), accumulate=False)

    want = plain64(x)
    want_b = torch.stack([plain64(xb[i]) for i in range(A20_BATCH)])
    errs = dict(full=_err(full, want, TOL), halves_joined=_err(joined, want, TOL),
                batched=_err(batched, want_b, TOL), singles=_err(singles, want_b, TOL))
    if plain.count or batch_launches != 1 or counts["bucket"] != 3 + 1 + A20_BATCH \
            or max(e[1] for e in errs.values()) > 1.0:
        raise AssertionError(f"A20: errors {errs}, launches {counts}, batched call "
                             f"{batch_launches}, plain calls {plain.count}")
    emit("surfaces", what="A20 one part, B2", n_node_pad=rows, F=ARXIV_HIDDEN, batch=A20_BATCH,
         batch_F=A20_F, max_abs_err={k: e[0] for k, e in errs.items()},
         max_err_over_tol={k: e[1] for k, e in errs.items()},
         tolerance="rtol=atol=1e-5 against the plain version in float64",
         batched_call_launches=batch_launches, launches=counts)
    emit("surfaces", what="launches", launches=launches)
    return launches


def _sparse_csr_pair(csr):
    """Â and Âᵀ of a ``CSRGraph`` as torch CSR tensors (cuSPARSE's operands)."""
    n = csr.n_node_pad
    return (torch.sparse_csr_tensor(csr.row_ptr, csr.senders.long(), csr.weight, (n, n)),
            torch.sparse_csr_tensor(csr.t_row_ptr, csr.t_receivers.long(), csr.t_weight, (n, n)))


def phase_library(dev, graphs, iters=20):
    """cuSPARSE (``torch.sparse.mm`` on CSR tensors) for ``Â x`` and ``Âᵀ g``:
    ms per fwd+bwd at each ``(name, graph, F)``, checked against ``spmm_csr``."""
    from graph_odenet_tpu_torch.ops import prepare, spmm_csr

    rng = np.random.default_rng(40)
    out = {}
    for name, g, f in graphs:
        csr = prepare(g).to(dev)
        a, at = _sparse_csr_pair(csr)
        x, up = _randn(rng, (g.n_node_pad, f), dev), _randn(rng, (g.n_node_pad, f), dev)
        xr = x.clone().requires_grad_(True)
        y = spmm_csr(csr, xr)
        (dx,) = torch.autograd.grad(y, xr, up)
        err = max(_err(torch.sparse.mm(a, x), y.detach().double(), BENCH_ATT_TOL),
                  _err(torch.sparse.mm(at, up), dx.double(), BENCH_ATT_TOL), key=lambda e: e[1])
        ms = timed_ms(lambda: (torch.sparse.mm(a, x), torch.sparse.mm(at, up)), iters)
        out[name] = dict(graph=name, n_node_pad=g.n_node_pad, n_edge=csr.n_edge, F=f,
                         ms=ms, max_err_over_tol_vs_kernel=err[1])
    emit("library", what="torch.sparse.mm fwd+bwd (cuSPARSE)", shapes=list(out.values()))
    return out


def _bf16_err(got, want, scale, atol=BF16_ATOL):
    """(max abs err, max err over tolerance) of bf16 ``got`` against bf16
    ``want``, the tolerance one bf16 ulp of ``want`` plus ``atol`` plus
    ``BF16_SUM_RTOL`` times ``scale``, each output's sum of its terms'
    magnitudes (both round an f32 sum once, the two sums in other orders);
    a NaN in ``got`` counts as an infinite error."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)  # |w| in [2^(e-1), 2^e), 8 bits
    d = (got.float() - w).abs().nan_to_num(nan=float("inf"))
    return float(d.max()), float((d / (ulp + atol + BF16_SUM_RTOL * scale.float())).max())


def _term_sums(row_ptr, col, weight, x):
    """Each output's ``Σ |w·x[col]|``: the scale of the rounding of an f32 sum
    of its terms."""
    from graph_odenet_tpu_torch.ops.csr_spmm import _reduce_plain

    return _reduce_plain(row_ptr, col, weight.abs(), x.float().abs())


def _bit_equal_repeats(fn, first, n=BF16_REPEATS):
    """Whether ``n`` more calls of ``fn`` return ``first`` bit for bit."""
    outs = [fn() for _ in range(n)]
    torch.cuda.synchronize()
    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
    return all(a is b or torch.equal(a, b)  # None (no α·D asked for) is None
               for o in outs for a, b in zip(as_tuple(o), as_tuple(first)))


def _library_bf16(make, iters):
    """ms of ``make()``'s call (``torch.sparse.mm`` on bf16 CSR tensors), or the
    error torch raises for it."""
    try:
        fn = make()
        return dict(library_ms=timed_ms(fn, iters))
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        return dict(library_ms=None, library_error=f"{type(exc).__name__}: {str(exc)[:200]}")


def _bf16_row(name, errs, repeats, costs, times, work, **extra):
    """One shape's record; raises unless every call is one launch of its own
    kernel, the repeats are bit-equal and the errors within tolerance."""
    over = max(e[1] for e in errs.values())
    if over > 1.0 or not repeats:
        raise AssertionError(f"bf16 {name}: {errs} of the tolerance, repeats equal: {repeats}")
    for form, (c, kernel) in costs.items():
        if c["launches_per_call"] > 1 or any(kernel not in k for k in c["kernels"]):
            raise AssertionError(f"bf16 {name} {form}: {c['launches_per_call']} launches a "
                                 f"call, kernels {c['kernels']}")
    row = dict(shape=name, max_abs_err=max(e[0] for e in errs.values()), max_err_over_tol=over,
               repeats_bit_equal=BF16_REPEATS,
               launches_per_call={k: c["launches_per_call"] for k, (c, _) in costs.items()},
               host_us={k: c["host_us"] for k, (c, _) in costs.items()},
               device_us={k: c["device_us"] for k, (c, _) in costs.items()},
               ms=times["bf16"], f32_ms=times["f32"], plain_ms=times["plain"],
               **bound(*work), **extra)
    emit("bf16_kernel", **row)
    return row


def bf16_spmm(name, g, f, dev, iters, seed):
    """B1 fwd+bwd on bf16 features at one shape: ``csr_reduce(x)`` and
    ``csr_reduce(g, transpose=True)`` against the plain version on the card."""
    from graph_odenet_tpu_torch.ops import prepare
    from graph_odenet_tpu_torch.ops.csr_spmm import _reduce_plain, csr_reduce

    rng = np.random.default_rng(seed)
    csr = prepare(g).to(dev)
    x32, up32 = _randn(rng, (g.n_node_pad, f), dev), _randn(rng, (g.n_node_pad, f), dev)
    x, up = x32.to(torch.bfloat16), up32.to(torch.bfloat16)

    def plain():
        return (_reduce_plain(csr.row_ptr, csr.senders, csr.weight, x),
                _reduce_plain(csr.t_row_ptr, csr.t_receivers, csr.t_weight, up))

    def kernel():
        return csr_reduce(csr, x), csr_reduce(csr, up, transpose=True)

    out, dx = kernel()
    ref, dref = plain()
    errs = {"fwd": _bf16_err(out, ref, _term_sums(csr.row_ptr, csr.senders, csr.weight, x)),
            "bwd": _bf16_err(dx, dref, _term_sums(csr.t_row_ptr, csr.t_receivers, csr.t_weight,
                                                  up))}
    repeats = _bit_equal_repeats(kernel, (out, dx))
    costs = {"csr_fwd": (call_costs(lambda: csr_reduce(csr, x), calls=200), "csr_reduce_kernel"),
             "csr_bwd": (call_costs(lambda: csr_reduce(csr, up, transpose=True), calls=200),
                         "csr_reduce_kernel")}
    times = alternate({
        "bf16": kernel, "plain": plain,
        "f32": lambda: (csr_reduce(csr, x32), csr_reduce(csr, up32, transpose=True)),
    }, iters)

    def library():
        a, at = (m.to(torch.bfloat16) for m in _sparse_csr_pair(csr))
        torch.sparse.mm(a, x)  # raises here where torch takes no bf16 CSR product
        return lambda: (torch.sparse.mm(a, x), torch.sparse.mm(at, up))

    work = (2 * v for v in spmm_work(g.n_node_pad, csr.n_edge, f, es=2))
    return _bf16_row(f"{name}, F={f}, fwd+bwd", errs, repeats, costs, times, work,
                     f32_bound_ms=bound(*(2 * v for v in spmm_work(g.n_node_pad, csr.n_edge,
                                                                    f)))["bound_ms"],
                     **_library_bf16(library, iters))


def bf16_buckets(dev, graph, f, iters):
    """B2 on bf16 rows of the arxiv twin at P = 8 and P = 1: every bucket's
    write form (CSR view, into NaNs), add form (into random rows) and CSC
    write form against the plain version on the card; at P = 1 the repeats,
    costs and ms of fwd+bwd (the one bucket's CSR and CSC write forms)."""
    from graph_odenet_tpu_torch.ops.csr_spmm import _bucket_reduce_plain, bucket_reduce
    from graph_odenet_tpu_torch.parallel import partition_by_receiver

    bf16 = torch.bfloat16
    rng = np.random.default_rng(41)
    x32 = _randn(rng, (graph.n_node_pad, f), dev)
    x = x32.to(bf16)
    rows = {}
    for n_parts in BUCKET_PARTS:
        pg = partition_by_receiver(graph, n_parts).to(dev)
        B = pg.block_size
        errs = {}
        nan = lambda: torch.full((B, f), float("nan"), device=dev, dtype=bf16)  # noqa: E731
        for p in range(n_parts):
            for b in range(n_parts):
                bk, chunk = pg.bucket(p, b), x[b * B:(b + 1) * B]
                base = _randn(rng, (B, f), dev).to(bf16)
                for form, view, accumulate, start in (
                        ("write", bk.fwd, False, nan), ("add", bk.fwd, True, base.clone),
                        ("csc_write", bk.bwd, False, nan)):
                    got = bucket_reduce(view, chunk, start(), accumulate=accumulate)
                    want = _bucket_reduce_plain(view, chunk, start(), accumulate=accumulate)
                    scale = _term_sums(view.row_ptr, view.col, view.weight, chunk)
                    if accumulate:
                        scale = scale + base.float().abs()
                    errs[form] = max(errs.get(form, (0.0, 0.0)), _bf16_err(got, want, scale),
                                     key=lambda e: e[1])
        rows[n_parts] = errs
    bk = pg.bucket(0, 0)  # P = 1: config 4 on one card
    up32 = _randn(rng, (B, f), dev)
    up = up32.to(bf16)

    def fwd_bwd(xx, uu):
        return (bucket_reduce(bk.fwd, xx, torch.empty_like(xx), accumulate=False),
                bucket_reduce(bk.bwd, uu, torch.empty_like(uu), accumulate=False))

    first = fwd_bwd(x, up)
    repeats = _bit_equal_repeats(lambda: fwd_bwd(x, up), first)
    out = torch.empty_like(x)
    costs = {"write": (call_costs(lambda: bucket_reduce(bk.fwd, x, out, accumulate=False),
                                  calls=100), "csr_reduce_kernel"),
             "add": (call_costs(lambda: bucket_reduce(bk.fwd, x, out), calls=100),
                     "csr_reduce_kernel")}
    times = alternate({
        "bf16": lambda: fwd_bwd(x, up), "f32": lambda: fwd_bwd(x32, up32),
        "plain": lambda: (
            _bucket_reduce_plain(bk.fwd, x, torch.empty_like(x), accumulate=False),
            _bucket_reduce_plain(bk.bwd, up, torch.empty_like(up), accumulate=False)),
    }, iters)

    def library():
        a, at = (_sparse_csr(v).to(bf16) for v in (bk.fwd, bk.bwd))
        torch.sparse.mm(a, x)
        return lambda: (torch.sparse.mm(a, x), torch.sparse.mm(at, up))

    errs = {f"P={p} {form}": e for p, r in rows.items() for form, e in r.items()}
    work = (2 * v for v in spmm_work(B, bk.fwd.n_edge, f, es=2))
    return _bf16_row(f"arxiv twin, P=1, F={f}, fwd+bwd; every bucket at P=8 and P=1", errs,
                     repeats, costs, times, work,
                     f32_bound_ms=bound(*(2 * v for v in spmm_work(B, bk.fwd.n_edge, f)))[
                         "bound_ms"], **_library_bf16(library, iters))


def bf16_attention(name, g, heads, feat, hashed, dev, iters, seed):
    """B4 and B5 on a bf16 Wh at one shape against their plain versions on the
    card (f32 outputs, ``BF16_F32_TOL``); one record per kernel."""
    from graph_odenet_tpu_torch.ops import gat_attn, prepare
    from graph_odenet_tpu_torch.ops.sddmm import edge_scores

    rng = np.random.default_rng(seed)
    csr = prepare(g).to(dev)
    n = g.n_node_pad
    s_src, s_dst = (_randn(rng, (n, heads), dev) * 1.5 for _ in range(2))
    logits = edge_scores(csr, s_src, s_dst)
    wh32, up = _randn(rng, (n, heads, feat), dev), _randn(rng, (n, heads, feat), dev)
    wh = wh32.to(torch.bfloat16)
    drop = (4321 + seed, 0.6) if hashed else None
    out, m, l = gat_attn.gat_fwd(csr, logits, wh, drop=drop)
    beta = (up * out).sum(-1)
    calls = {
        "gat_fwd": (lambda w: gat_attn.gat_fwd(csr, logits, w, drop=drop),
                    lambda: gat_attn.gat_fwd_plain(csr, logits, wh, drop=drop)),
        "gat_bwd": (lambda w: gat_attn.gat_bwd(csr, logits, w, up, m, l, beta, drop=drop),
                    lambda: gat_attn.gat_bwd_plain(csr, logits, wh, up, m, l, beta, drop=drop)),
    }
    shape = f"{name}, H={heads}, F={feat}{', hash dropout 0.6' if hashed else ''}"
    rows = {}
    for kernel, (call, plain) in calls.items():
        got, want = call(wh), plain()
        names = ("out", "m", "l") if kernel == "gat_fwd" else ("dlogits",)
        errs = {k: _err(a, b.double(), BF16_F32_TOL) for k, a, b in zip(names, got, want)}
        repeats = _bit_equal_repeats(lambda: call(wh), got)
        costs = {kernel: (call_costs(lambda: call(wh), calls=200), f"{kernel}_kernel")}
        times = alternate({"bf16": lambda: call(wh), "f32": lambda: call(wh32),
                           "plain": plain}, iters)
        work = attention_work(kernel, n, csr.n_edge, heads, feat, es=2)
        rows[kernel] = _bf16_row(
            f"{shape}, {kernel}", errs, repeats, costs, times, work,
            f32_bound_ms=bound(*attention_work(kernel, n, csr.n_edge, heads, feat))["bound_ms"],
            library_ms=None, library_error=BF16_GAT_LIBRARY)
    return rows


def bf16_train(cfg, data, adj, dtype, dev, gat):
    """``cfg``'s model built with ``dtype`` (``param_dtype`` float32) and
    trained by the trainer's recipe: Adam with the config's lr and weight
    decay (L2 in the gradient), its epochs and early stopping on validation
    loss, its dropout (the feature masks drawn in float32 whatever the
    dtype, so both runs drop the same features).  The step-0 loss, s/epoch,
    the best epoch's test accuracy, peak device memory and the kernel
    launches; the dtype of the ODE state."""
    from graph_odenet_tpu_torch.models import GATODE, GCNODE
    from graph_odenet_tpu_torch.ops import csr_spmm, gat_attn
    from graph_odenet_tpu_torch.utils.metrics import masked_accuracy, masked_nll

    ode = dict(t1=cfg.t1, method=cfg.method, steps=cfg.steps, rtol=cfg.rtol, atol=cfg.atol,
               adjoint=cfg.adjoint, activation=cfg.activation)
    kw = dict(n_class=data.n_class, dropout=cfg.dropout, dtype=dtype,
              generator=torch.Generator().manual_seed(cfg.seed), **ode)
    n_in = data.features.shape[1]
    model = (GATODE(n_in, hidden=cfg.hidden, heads=cfg.heads, **kw) if gat
             else GCNODE(n_in, hidden=cfg.hidden, **kw)).to(dev)
    states = []
    model.odeblock.dynamics.register_forward_pre_hook(lambda m, a: states.append(a[2].dtype))
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, weight_decay=cfg.weight_decay)
    gens = dict(generator=torch.Generator(device=dev).manual_seed(cfg.seed))
    if gat:
        gens["seed_generator"] = torch.Generator().manual_seed(cfg.seed)
    best, bad, losses = dict(val_loss=float("inf"), test_acc=0.0, epoch=-1), 0, []
    _zero_kernel_counts()
    for counts in (csr_spmm.bf16_launches, gat_attn.bf16_launches):
        for k in counts:
            counts[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with plain_calls() as plain:
        for epoch in range(cfg.epochs):
            model.train()
            opt.zero_grad(set_to_none=True)
            loss = masked_nll(model(adj, data.features, deterministic=False, **gens),
                              data.labels, data.idx_train)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            model.eval()
            with torch.no_grad():
                out = model(adj, data.features)
                val_loss = float(masked_nll(out, data.labels, data.idx_val))
            if val_loss < best["val_loss"]:
                best = dict(val_loss=val_loss, epoch=epoch,
                            test_acc=float(masked_accuracy(out, data.labels, data.idx_test)))
                bad = 0
            else:
                bad += 1
                if bad > cfg.patience:
                    break
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(dtype=str(dtype).removeprefix("torch."), epochs_run=epoch + 1,
                seconds_per_epoch=seconds / (epoch + 1), best=best,
                step0_loss=float(losses[0]), last_loss=float(losses[-1]),
                peak_bytes=torch.cuda.max_memory_allocated(dev), plain_calls=plain.count,
                launches=_kernel_counts(),
                bf16_launches={**csr_spmm.bf16_launches, **gat_attn.bf16_launches},
                state_dtypes=sorted({str(d).removeprefix("torch.") for d in states}),
                ode_stats=model.odeblock.stats)


def bf16_sharded_launches(dev, graph, f, calls=3):
    """B2 on bf16 rows through the entry point: ``spmm_sharded`` at one part
    (mode ``ring``), forward and backward ``calls`` times; its bf16 launches
    and the dtypes of its output and gradient."""
    from graph_odenet_tpu_torch.ops import csr_spmm
    from graph_odenet_tpu_torch.parallel import partition_by_receiver, spmm_sharded

    pg = partition_by_receiver(graph, 1).to(dev)
    x = _randn(np.random.default_rng(42), (pg.block_size, f), dev).to(torch.bfloat16)
    csr_spmm.bf16_launches["bucket"] = 0
    with plain_calls() as plain:
        for _ in range(calls):
            xr = x.clone().requires_grad_(True)
            out = spmm_sharded(pg, xr, mode="ring")
            (dx,) = torch.autograd.grad(out, xr, torch.ones_like(out))
        torch.cuda.synchronize()
    if plain.count or (out.dtype, dx.dtype) != (torch.bfloat16, torch.bfloat16):
        raise AssertionError(f"spmm_sharded in bf16: {plain.count} plain calls, "
                             f"{out.dtype} out, {dx.dtype} gradient")
    return csr_spmm.bf16_launches["bucket"]


def _sharded_init(cfg, data, dtype, seed=0):
    """``cfg``'s sharded model, every leaf in ``dtype``, on the CPU."""
    from graph_odenet_tpu_torch.parallel import sharded_gat, sharded_gcn

    gen, f_in = torch.Generator().manual_seed(seed), data.features.shape[1]
    if cfg.model == "gatode":
        return sharded_gat.init_gatode_params(f_in, cfg.hidden, cfg.heads, data.n_class,
                                              generator=gen, dtype=dtype)
    return sharded_gcn.init_params(f_in, cfg.hidden, data.n_class, generator=gen, dtype=dtype)


def _sharded_forward(cfg, model, pg, x, **kw):
    """The entry point of ``cfg``'s model (``gatode_forward`` or ``forward``)."""
    from graph_odenet_tpu_torch.parallel import sharded_gat, sharded_gcn

    common = dict(steps=cfg.steps, t1=cfg.t1, mode=cfg.mode, **kw)
    if cfg.model == "gatode":
        return sharded_gat.gatode_forward(model, pg, x, remat=cfg.remat, **common)
    return sharded_gcn.forward(model, pg, x, **common)


def _sharded_labels(data, dev):
    """One-hot f32 labels (zero rows for unlabelled padding) and the f32
    masks of the training, validation and test nodes, on ``dev``."""
    labels = data.labels.to(dev)
    y1h = torch.nn.functional.one_hot(labels.clamp(min=0), data.n_class).float()
    y1h *= (labels >= 0)[:, None]
    masks = []
    for idx in (data.idx_train, data.idx_val, data.idx_test):
        m = torch.zeros(data.graph.n_node_pad, device=dev)
        m[idx.to(dev)] = 1.0
        masks.append(m)
    return labels, y1h, masks


def _b2_counts():
    """B2's and B2-w's launches so far: every bucket launch, those of the
    bf16 entry, the weighted ones (f32 entry), and B2-w's per-edge dot."""
    from graph_odenet_tpu_torch.ops import csr_spmm

    return dict(bucket=csr_spmm.bucket_launches, bucket_bf16=csr_spmm.bf16_launches["bucket"],
                bucket_weighted=csr_spmm.bucket_weighted_launches,
                edge_dot=csr_spmm.edge_dot_launches)


def _zero_b2_counts():
    from graph_odenet_tpu_torch.ops import csr_spmm

    csr_spmm.bucket_launches = csr_spmm.bucket_weighted_launches = csr_spmm.edge_dot_launches = 0
    csr_spmm.bf16_launches["bucket"] = 0


class recorded_dtypes:
    """Within the block, the dtypes of what the sharded GAT's B2-w Function
    takes (``chunk``) and of the gradient it hands back for it (``dchunk``),
    and of what the sharded models' aggregations take (``state``: ``h @ w``,
    so the ODE state's dtype)."""

    def __enter__(self):
        from graph_odenet_tpu_torch.parallel import sharded_gat, sharded_gcn

        self.seen = {"chunk": set(), "dchunk": set(), "state": set()}
        self.saved = [(sharded_gat, "_bucket_spmm_weighted"), (sharded_gat, "gat_sharded"),
                      (sharded_gcn, "spmm_sharded")]
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in self.saved]
        bucket, gat, spmm = (fn for _, _, fn in self.saved)

        def bucket_rec(chunk, *args, **kw):
            self.seen["chunk"].add(str(chunk.dtype).removeprefix("torch."))
            if chunk.requires_grad:
                chunk.register_hook(
                    lambda g: self.seen["dchunk"].add(str(g.dtype).removeprefix("torch.")))
            return bucket(chunk, *args, **kw)

        def gat_rec(pg, s_src, s_dst, wh, *args, **kw):
            self.seen["state"].add(str(wh.dtype).removeprefix("torch."))
            return gat(pg, s_src, s_dst, wh, *args, **kw)

        def spmm_rec(pg, h, *args, **kw):
            self.seen["state"].add(str(h.dtype).removeprefix("torch."))
            return spmm(pg, h, *args, **kw)

        for (mod, name, _), fn in zip(self.saved, (bucket_rec, gat_rec, spmm_rec)):
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def dtypes(self):
        return {k: sorted(v) for k, v in self.seen.items()}


def sharded_step_check(cfg, data, dev, dtype=torch.bfloat16, profile=False):
    """One training step of ``cfg``'s sharded model built in ``dtype`` (dropout
    0) through the kernels, then through the bucket mode's plain version with
    every sum of the step in a fixed order (``plain_bucket_mode`` inside
    ``fixed_order_sums``).  The log-probs and the loss at ``BF16_STEP_TOL``,
    each gradient at its rtol with atol that rtol of its largest entry
    (``_grads_close``; of a_src's and a_dst's together for a_dst, whose
    gradient cancels).  Returns the errors over tolerance, the kernel step's
    B2/B2-w launches and plain calls, the dtypes of the log-probs, the
    gradients, B2-w's ``chunk`` and ``dchunk`` and the ODE state, and with
    ``profile`` a ``profile_steps`` breakdown of the kernel step; raises if a
    check fails or the kernel step called a plain version."""
    from graph_odenet_tpu_torch.parallel import partition_by_receiver

    pg = partition_by_receiver(data.graph, 1).to(dev)
    model = _sharded_init(cfg, data, dtype).to(dev)
    x = data.features.to(dev).to(dtype)
    _, y1h, (w, _, _) = _sharded_labels(data, dev)

    def step():
        model.zero_grad(set_to_none=True)
        lp = _sharded_forward(cfg, model, pg, x)
        loss = -(lp * y1h).sum(-1).mul(w).sum() / w.sum()
        loss.backward()
        return lp.detach(), loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}

    _zero_b2_counts()
    with plain_calls() as plain, recorded_dtypes() as rec:
        lp_k, loss_k, grads_k = step()
        torch.cuda.synchronize()
    launches = _b2_counts()
    with plain_bucket_mode(), fixed_order_sums(warn_only=True):
        lp_p, loss_p, grads_p = step()
    torch.cuda.synchronize()
    if _b2_counts() != launches:
        raise AssertionError(f"{cfg.model}: the plain step launched a kernel")
    if plain.count:
        raise AssertionError(f"{cfg.model} in {dtype}: {plain.count} plain calls in the kernel step")
    rtol, atol = BF16_STEP_TOL["rtol"], BF16_STEP_TOL["atol"]
    err = {}
    for name, got, want in (("log_probs", lp_k, lp_p), ("loss", loss_k, loss_p)):
        err[name] = float(((got.float() - want.float()).abs()
                           / (atol + rtol * want.float().abs())).max())
        torch.testing.assert_close(got.float(), want.float(), **BF16_STEP_TOL,
                                   msg=lambda m, n=name: f"{cfg.model} {n}\n{m}")
    # A receiver's shift of every logit leaves its softmax as it is but for the
    # LeakyReLU's kink, so the gradient of a_dst is a residue of terms of the
    # size of a_src's: its atol takes the scale of both.
    scale = {k: float(g.abs().max()) for k, g in grads_p.items()}
    for k in scale:
        if k.startswith("a_dst_"):
            scale[k] = max(scale[k], scale["a_src_" + k.removeprefix("a_dst_")])
    err.update(_grads_close({k: g.float() for k, g in grads_k.items()},
                            {k: g.float() for k, g in grads_p.items()}, rtol,
                            f"{cfg.model} in {dtype}", scale))
    out = dict(err_over_tol=err, launches=launches, plain_calls=plain.count,
               lp_dtype=str(lp_k.dtype).removeprefix("torch."),
               grad_dtypes=sorted({str(g.dtype).removeprefix("torch.") for g in grads_k.values()}),
               **rec.dtypes())
    if profile:
        out["profile"] = profile_steps(model, step, cfg, top=12)
    return out


def bf16_sharded_train(cfg, data, dtype, dev):
    """``cfg``'s sharded model built with ``dtype`` (features too) and trained in
    the smoke's own loop by the sharded trainer's recipe at one part: Adam
    with the config's lr and weight decay (L2 in the gradient), its dropout
    (the feature masks drawn in f32, so both dtypes drop the same features;
    the GAT-ODE's attention-dropout seeds from a CPU generator), its epochs,
    evaluation every 5 epochs and at the last (over 200,000 edges), test
    accuracy at the best validation loss.  The step-0 and last losses,
    ``step_ms`` (the fastest step after the first), s/epoch, peak device
    memory, the dtypes of the ODE state and of Adam's moments, the B2/B2-w
    launches, the plain calls."""
    from graph_odenet_tpu_torch.parallel import partition_by_receiver

    pg = partition_by_receiver(data.graph, 1).to(dev)
    model = _sharded_init(cfg, data, dtype, seed=cfg.seed).to(dev)
    x = data.features.to(dev).to(dtype)
    labels, y1h, (w_tr, w_va, w_te) = _sharded_labels(data, dev)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, weight_decay=cfg.weight_decay)
    gens = dict(generator=torch.Generator(device=dev).manual_seed(cfg.seed + 1))
    if cfg.model == "gatode":
        gens["seed_generator"] = torch.Generator().manual_seed(cfg.seed + 1)

    def nll(lp, w):
        return -(lp * y1h).sum(-1).mul(w).sum() / w.sum()

    best, losses, step_ms, evals = dict(val_loss=float("inf"), test_acc=0.0, epoch=-1), [], None, 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_b2_counts()
    t0 = time.perf_counter()
    with plain_calls() as plain, recorded_dtypes() as rec:
        for epoch in range(cfg.epochs):
            t_step = time.perf_counter()
            model.train()
            opt.zero_grad(set_to_none=True)
            loss = nll(_sharded_forward(cfg, model, pg, x, dropout=cfg.dropout, **gens), w_tr)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))  # waits for the step
            if epoch > 0:
                dt = (time.perf_counter() - t_step) * 1e3
                step_ms = dt if step_ms is None else min(step_ms, dt)
            if epoch % 5 == 0 or epoch == cfg.epochs - 1:
                evals += 1
                model.eval()
                with torch.no_grad():
                    lp = _sharded_forward(cfg, model, pg, x)
                    val_loss = float(nll(lp, w_va))
                if val_loss < best["val_loss"]:
                    hit = (lp.argmax(-1) == labels).float()
                    best = dict(val_loss=val_loss, epoch=epoch,
                                test_acc=float((hit * w_te).sum() / w_te.sum()))
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    moments = {str(t.dtype).removeprefix("torch.") for st in opt.state.values()
               for k, t in st.items() if k in ("exp_avg", "exp_avg_sq")}
    return dict(dtype=str(dtype).removeprefix("torch."), epochs_run=cfg.epochs, evals=evals,
                step0_loss=losses[0], last_loss=losses[-1], best=best, step_ms=step_ms,
                seconds_per_epoch=seconds / cfg.epochs,
                peak_bytes=torch.cuda.max_memory_allocated(dev), plain_calls=plain.count,
                launches=_b2_counts(), adam_moments=sorted(moments), **rec.dtypes())


def phase_bf16_sharded(dev, arxiv, arxiv_cal):
    """Both sharded models built in bf16 beside f32 at full width (config 4's
    GCN-ODE on the arxiv twin, the GAT-ODE's recipe on the calibrated twin):
    the one-step check against the plain versions, then training; see the
    module doc."""
    from graph_odenet_tpu_torch.configs import get_config, sharded_train_config

    out = {}
    gcn_cfg = sharded_train_config(get_config(4)[1])
    for name, cfg, data, floor in (("config4", gcn_cfg, arxiv, 1.0 / arxiv.n_class),
                                   ("sharded_gatode", sharded_gat_config(), arxiv_cal,
                                    GAT_MIN_TEST_ACC_SHARDED)):
        gat = cfg.model == "gatode"
        check = sharded_step_check(cfg, data, dev, profile=True)
        runs = {str(d).removeprefix("torch."): bf16_sharded_train(cfg, data, d, dev)
                for d in (torch.float32, torch.bfloat16)}
        r = runs["bfloat16"]
        # Each model aggregates 2 + 4·steps times a forward, once more each in the
        # backward, and the GAT-ODE's remat recomputes the 4 a substep.
        # B2-w's per-edge dot: once a layer in each training step's backward.
        per_eval = 2 + 4 * cfg.steps
        per_step = 2 * per_eval + (4 * cfg.steps if gat else 0)
        want = r["epochs_run"] * per_step + r["evals"] * per_eval
        want_launches = (
            dict(bucket=0, bucket_bf16=0, bucket_weighted=want, edge_dot=r["epochs_run"] * per_eval)
            if gat else dict(bucket=want, bucket_bf16=want, bucket_weighted=0, edge_dot=0))
        step_launches = (dict(bucket=0, bucket_bf16=0, bucket_weighted=per_step, edge_dot=per_eval)
                         if gat else dict(bucket=per_step, bucket_bf16=per_step,
                                          bucket_weighted=0, edge_dot=0))
        failed = []
        if not r["last_loss"] < r["step0_loss"]:
            failed.append("the loss did not fall")
        if not r["best"]["test_acc"] > floor:
            failed.append(f"test accuracy {r['best']['test_acc']} <= {floor}")
        if r["plain_calls"] or check["plain_calls"]:
            failed.append("a plain version was called")
        if r["launches"] != want_launches or check["launches"] != step_launches:
            failed.append(f"launches {r['launches']} (expected {want_launches}), in the checked "
                          f"step {check['launches']} (expected {step_launches})")
        if r["state"] != ["bfloat16"] or check["lp_dtype"] != "bfloat16" \
                or check["grad_dtypes"] != ["bfloat16"]:
            failed.append(f"dtypes: state {r['state']}, log-probs {check['lp_dtype']}, "
                          f"gradients {check['grad_dtypes']}")
        if gat and (check["chunk"], check["dchunk"]) != (["bfloat16"], ["bfloat16"]):
            failed.append(f"B2-w chunk {check['chunk']}, dchunk {check['dchunk']}")
        if failed:
            raise AssertionError(f"bf16 {name}: {'; '.join(failed)}: {r}, {check}")
        out[name] = dict(runs, check=check, launches_per_step=per_step)
        emit("bf16_sharded", model=name, n_node_pad=data.graph.n_node_pad,
             n_edge=data.graph.n_edge, hidden=cfg.hidden, heads=getattr(cfg, "heads", None),
             steps=cfg.steps, mode=cfg.mode, remat=cfg.remat if gat else None,
             one_step_check=dict(tolerance=BF16_STEP_TOL, **check), **runs)
    return out


def phase_bf16(dev, data, bench_row, bench, arxiv, arxiv_cal, iters=20, bench_iters=10):
    """The bf16 tier on the card (see the module doc)."""
    from graph_odenet_tpu_torch.configs import get_config
    from graph_odenet_tpu_torch.data import synthetic_planetoid
    from graph_odenet_tpu_torch.ops import prepare

    cite = synthetic_planetoid("citeseer", seed=42, calibrated=True).graph
    spmm = [bf16_spmm("pubmed-twin", data.graph, 16, dev, iters, seed=50),
            bf16_spmm("bench", bench_row, 128, dev, bench_iters, seed=51)]
    bucket = bf16_buckets(dev, arxiv.graph, ARXIV_HIDDEN, bench_iters)
    bucket["launches"] = bf16_sharded_launches(dev, arxiv.graph, ARXIV_HIDDEN)
    att = [bf16_attention("citeseer-twin", cite, 8, 8, True, dev, iters, seed=52),
           bf16_attention("citeseer-twin", cite, 1, 64, False, dev, iters, seed=53),
           bf16_attention("citeseer-twin", cite, 1, 6, False, dev, iters, seed=54),
           bf16_attention("bench", bench, 8, 8, True, dev, bench_iters, seed=55),
           bf16_attention("bench", bench, 1, 128, False, dev, bench_iters, seed=56)]

    models = {}
    for name, gat in (("pubmed-gcnode", False), (2, True)):
        _, cfg = get_config(name)
        twin = data if not gat else synthetic_planetoid(
            "citeseer", seed=cfg.seed, calibrated=True).to(dev)
        adj = prepare(twin.graph)  # the kernels (B1; B3-B5)
        runs = {str(d).removeprefix("torch."): bf16_train(cfg, twin, adj, d, dev, gat)
                for d in (torch.float32, torch.bfloat16)}
        r = runs["bfloat16"]
        floor = GAT_MIN_TEST_ACC if gat else MIN_TEST_ACC
        need = ("gat_fwd", "gat_bwd") if gat else ("csr",)
        if r["plain_calls"] or not r["best"]["test_acc"] >= floor or not all(
                r["bf16_launches"][k] > 0 for k in need) or (gat and not r["launches"]["gat_dwh"]):
            raise AssertionError(f"{name} in bf16: {r}")
        want_state = "float32" if gat else "bfloat16"  # the GAT kernels return f32
        if r["state_dtypes"] != [want_state]:
            raise AssertionError(f"{name} in bf16 integrated a {r['state_dtypes']} state")
        models[str(name)] = runs
        emit("bf16_model", config=str(name), dataset=twin.name, **{
            k: {f: v[f] for f in ("epochs_run", "seconds_per_epoch", "best", "step0_loss",
                                  "last_loss", "peak_bytes", "plain_calls", "bf16_launches",
                                  "launches", "state_dtypes", "ode_stats")}
            for k, v in runs.items()})
    sharded = phase_bf16_sharded(dev, arxiv, arxiv_cal)
    return dict(spmm=spmm, bucket=bucket, att=att, models=models, sharded=sharded)


def main():
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA card.")
    parser.add_argument("--physics-epochs", type=int, default=PHYS_EPOCHS,
                        help="config 3's epochs (its own are 20; default %(default)s)")
    parser.add_argument("--adjoint-epochs", type=int, default=ADJ_EPOCHS,
                        help="pubmed-gatode's epochs with each adjoint (its own are 300; "
                             "default %(default)s)")
    parser.add_argument("--adams-epochs", type=int, default=ADAMS_EPOCHS,
                        help="config 3's epochs on adams_scan (its own are 20; default "
                             "%(default)s)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from graph_odenet_tpu_torch.configs import get_config
    from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv, synthetic_planetoid
    from graph_odenet_tpu_torch.graph import from_edges

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda, card=card)

    times = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        times[phase] = time.perf_counter() - t0
        return out

    timed("build", phase_build)
    _, cfg = get_config("pubmed-gcnode")
    data = synthetic_planetoid("pubmed", seed=cfg.seed, calibrated=True).to(dev)
    bench_row = bench_graph(from_edges)
    rows = timed("kernel", phase_kernel, dev, data.graph, bench_row)
    timed("host_parts", phase_host_parts, dev)
    bench = bench_graph(from_edges, normalize=None)
    att = timed("attention", phase_attention, dev, bench)
    launches = timed("slice", phase_slice, dev, data)
    gat_launches = timed("gat_slice", phase_gat_slice, dev)
    weighted = timed("bench_path", bench_path_launches, dev, bench)
    if weighted < 5:
        raise AssertionError(f"{weighted} weighted SpMM launches on the GAT bench path")
    timed("dense", phase_dense, dev, data)
    arxiv = synthetic_ogbn_arxiv(seed=0)  # run_config(4)'s twin
    buckets = timed("bucket", phase_bucket, dev, arxiv.graph)
    bucket_launches = timed("config4", phase_config4, dev, arxiv)
    library = timed("library", phase_library, dev, [
        ("bench", bench_row, 128), ("pubmed-twin", data.graph, 16),
        ("arxiv-twin", arxiv.graph, ARXIV_HIDDEN),
    ])
    arxiv_cal = synthetic_ogbn_arxiv(seed=0, calibrated=True)  # the sharded GAT-ODE's twin
    weighted_buckets = timed("bucket_weighted", phase_bucket_weighted, dev, arxiv_cal.graph)
    softmax = timed("softmax_passes", phase_softmax_passes, dev, arxiv_cal.graph)
    gat_bucket_launches = timed("config4_gat", phase_config4_gat, dev, arxiv_cal)
    resume_launches = timed("resume", phase_resume, dev, arxiv, arxiv_cal)
    physics = timed("physics", phase_physics, dev, args.physics_epochs)
    adj = timed("adjoint", phase_adjoint, dev, data, args.adjoint_epochs)
    solver_launches = timed("solvers", phase_solvers, dev, data, arxiv.graph)
    timed("batched_adams", phase_batched_adams, dev, physics, args.adams_epochs)
    surface_launches = timed("surfaces", phase_surfaces, dev, arxiv)
    bf16 = timed("bf16", phase_bf16, dev, data, bench_row, bench, arxiv, arxiv_cal)
    del arxiv, arxiv_cal
    # Launches on the adjoint's paths: B1 in pubmed-gcnode's adjoint backward
    # steps, B3-B5 in pubmed-gatode's training runs with either adjoint.
    adjoint_launches = {k: sum(r["kernel_launches"].get(k, 0) for r in adj["runs"].values()
                               if r["adjoint"]) for k in ("gat_fwd", "gat_bwd", "gat_dwh")}
    adjoint_launches["csr"] = sum(c["backward_launches"].get("csr", 0) for c in adj["checks"])
    emit("seconds", **times)
    per_call = [(r["graph"], k, c) for r in rows for k, c in r["call_costs"].items()]
    per_call += [(f"P={p}", k, c) for p, r in buckets.items() for k, c in r["call_costs"].items()]
    per_call += [(f"weighted {k}", "write", r["call_costs"]) for k, r in weighted_buckets.items()
                 if "call_costs" in r]
    own = {k: "csr_reduce_kernel" for _, k, _ in per_call}
    per_call += [(f"H={h},F={f}", "edge_dot", weighted_buckets[h, f]["edge_dot"]["call_costs"])
                 for h, f in GAT_SHAPES]
    own["edge_dot"] = "edge_dot_kernel"
    # gat_fwd, gat_bwd and gat_dwh: one launch of their own kernel a call, split rows too.
    att_calls = [(f"{r['graph']} H={r['H']} F={r['F']} {r['mode']}", k, r["call_costs"][k])
                 for r in att for k in ("gat_fwd", "gat_bwd", "gat_dwh") if k in r["call_costs"]]
    own.update({k: f"{k}_kernel" for _, k, _ in att_calls})
    per_call += att_calls
    for shape, form, c in per_call:
        if c["launches_per_call"] > 1 or any(own[form] not in k for k in c["kernels"]):
            raise AssertionError(f"{shape} {form}: {c['launches_per_call']} device launches a "
                                 f"call, kernels {c['kernels']}")
    # The profiler drops kernels now and then; fewer launches than calls is its miss.
    emit("profiler_missed", calls=[(shape, form, c["launches_per_call"])
                                   for shape, form, c in per_call if c["launches_per_call"] < 1])

    def att_entry(kernel, source, replaces, row, launched, costs=False):
        checked = [r for r in att if kernel in r["max_abs_err"]]
        h, f = row["H"], row["F"]
        # Worst error over tolerance of all shapes, each at its own tolerance.
        entry = {
            "name": kernel, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launched,
            "max_abs_err": max(r["max_abs_err"][kernel] for r in checked),
            "max_err_over_tol": max(r["max_err_over_tol"][kernel] for r in checked),
            "tolerance": "rtol=atol=1e-5 against the plain version in float64 "
                         "(1e-4 on the bench graph)",
            "ms": row["kernel_ms"][kernel], "plain_ms": row["kernel_plain_ms"][kernel],
            "bound_ms": row["bound_ms"][kernel], "bound_by": row["bound_by"][kernel],
            "library_ms": None,
            "shape": f"{row['graph']}, H={h}, F={f}, {row['mode']}, one call",
        }
        if costs:  # per call at this shape, and every figure at the other shapes
            c = row["call_costs"][kernel]
            entry.update(
                host_us=c["host_us"], device_us=c["device_us"],
                device_launches_per_call=max(r["call_costs"][kernel]["launches_per_call"]
                                             for r in checked),
                other_shapes={
                    f"{r['graph']} H={r['H']} F={r['F']} {r['mode']}": dict(
                        ms=r["kernel_ms"][kernel], plain_ms=r["kernel_plain_ms"][kernel],
                        bound_ms=r["bound_ms"][kernel], bound_by=r["bound_by"][kernel],
                        host_us=r["call_costs"][kernel]["host_us"],
                        device_us=r["call_costs"][kernel]["device_us"],
                        device_launches_per_call=r["call_costs"][kernel]["launches_per_call"])
                    for r in checked if r is not row})
        return entry

    def bf16_entry(rows_of, launched, tolerance):
        """The ``bf16`` object of a kernel's entry: the first row's shape, every
        row's worst error over its tolerance, the others' figures."""
        row = rows_of[0]
        pick = ("ms", "f32_ms", "plain_ms", "bound_ms", "f32_bound_ms", "bound_by",
                "library_ms", "library_error", "launches_per_call", "max_err_over_tol")
        return dict(
            {k: row[k] for k in pick if k in row}, launches=launched, shape=row["shape"],
            max_err_over_tol=max(r["max_err_over_tol"] for r in rows_of), tolerance=tolerance,
            repeats_bit_equal=BF16_REPEATS,
            other_shapes={r["shape"]: {k: r[k] for k in pick if k in r} for r in rows_of[1:]})

    ulp_tol = (f"one bf16 ulp + {BF16_ATOL} + {BF16_SUM_RTOL:g}·Σ|terms| against the plain "
               "version on the card")
    f32_tol = "rtol=atol=1e-4 (f32 outputs) against the plain version on the card"
    bf16_gcn = bf16["models"]["pubmed-gcnode"]["bfloat16"]["bf16_launches"]
    bf16_gat = bf16["models"]["2"]["bfloat16"]["bf16_launches"]
    # B2's bf16 entry on config 4 in bf16; B2-w's f32 entry under the bf16 GAT-ODE.
    bf16_b2 = bf16["sharded"]["config4"]["bfloat16"]["launches"]
    bf16_b2w = bf16["sharded"]["sharded_gatode"]["bfloat16"]["launches"]["bucket_weighted"]
    bf16_objects = {
        "csr_spmm": bf16_entry(bf16["spmm"], bf16_gcn["csr"], ulp_tol),
        "csr_spmm_bucket": dict(
            bf16_entry([bf16["bucket"]], bf16_b2["bucket_bf16"], ulp_tol),
            spmm_sharded_launches=bf16["bucket"]["launches"]),
        **{k: bf16_entry([r[k] for r in bf16["att"]], bf16_gat[k], f32_tol)
           for k in ("gat_fwd", "gat_bwd")},
    }
    main_row = rows[0]  # the slice's shape: Pubmed twin, F = 16
    cite_row, mask_row = att[0], att[7]  # config 2's encoder shape; the bench's no-hint shape
    dyn_row = weighted_buckets[GAT_SHAPES[1]]  # the sharded GAT-ODE's dynamics: H = 1, F = 256
    gat_src = "graph_odenet_tpu_torch/csrc/gat_attn.cu"
    spmm_src = "graph_odenet_tpu_torch/csrc/csr_spmm.cu"
    print(json.dumps({"kernels": [
        {
            "name": "csr_spmm",
            "route": "cuda",
            "source": spmm_src,
            "replaces": "graph_odenet_tpu/ops/pallas_spmm.py:479",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_err_over_tol": max(r["max_err_over_tol"] for r in rows),
            "tolerance": "rtol=atol=1e-5 against the plain version in float64",
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": library["pubmed-twin"]["ms"],
            "shape": "Pubmed twin, F=16, fwd+bwd",
            "adjoint_launches": adjoint_launches["csr"],
            "solver_launches": solver_launches.get("csr", 0),
            "surfaces_launches": surface_launches.get("csr", 0),
            "bf16": bf16_objects["csr_spmm"],
            "bare_ms": main_row["bare_ms"], "library_bare_ms": main_row["library_bare_ms"],
            "host_us": {k: c["host_us"] for k, c in main_row["call_costs"].items()},
            "device_launches_per_call": max(
                c["launches_per_call"] for r in rows for c in r["call_costs"].values()),
        },
        {
            "name": "csr_spmm_bucket",
            "route": "cuda",
            "source": spmm_src,
            "replaces": "graph_odenet_tpu/ops/pallas_spmm.py:227",
            "launches": bucket_launches,
            "max_abs_err": max(r["max_abs_err"] for r in buckets.values()),
            "max_err_over_tol": max(max(r["max_err_over_tol"], r["accumulated_max_err_over_tol"])
                                    for r in buckets.values()),
            "tolerance": "rtol=atol=1e-5 against the plain version in float64, every bucket "
                         "at P=8 and P=1; accumulated blocks against spmm_csr",
            "ms": buckets[1]["ms"],
            "plain_ms": buckets[1]["plain_ms"],
            "bound_ms": buckets[1]["bound_ms"],
            "bound_by": buckets[1]["bound_by"],
            "library_ms": buckets[1]["library_ms"],
            "shape": f"arxiv twin, P=1 (config 4 on one card), F={ARXIV_HIDDEN}, fwd+bwd",
            "resume_launches": resume_launches["bucket"],
            "surfaces_launches": surface_launches.get("bucket", 0),
            "bf16": bf16_objects["csr_spmm_bucket"],
            "host_us_P8": {k: c["host_us"] for k, c in buckets[8]["call_costs"].items()},
            "device_launches_per_call": max(
                c["launches_per_call"] for r in buckets.values() for c in r["call_costs"].values()),
        },
        {
            "name": "csr_spmm_bucket_weighted",
            "route": "cuda",
            "source": spmm_src,
            "replaces": "graph_odenet_tpu/ops/pallas_spmm.py:227",
            "via": "weighted, graph_odenet_tpu/parallel/halo.py:147",
            "launches": gat_bucket_launches["bucket_weighted"],
            "max_abs_err": max(r["max_abs_err"] for r in weighted_buckets.values()),
            "max_err_over_tol": max(
                max(r["max_err_over_tol"], r.get("ring_order_max_err_over_tol", 0.0))
                for r in weighted_buckets.values()),
            "tolerance": "rtol=atol=1e-5 against the plain version in float64: three shapes at "
                         "P=1, every bucket at P=8, written and added, CSR and CSC",
            "ms": dyn_row["ms"],
            "plain_ms": dyn_row["plain_ms"],
            "bound_ms": dyn_row["bound_ms"],
            "bound_by": dyn_row["bound_by"],
            "library_ms": dyn_row["library_ms"],
            "shape": "calibrated arxiv twin, P=1, H=1, F=256 (the dynamics' layers, 16 of the "
                     "18 of a forward), fwd+bwd",
            "resume_launches": resume_launches["bucket_weighted"],
            "surfaces_launches": surface_launches.get("bucket_weighted", 0),
            "bf16_model_launches": bf16_b2w,
            "other_shapes": {f"H={h},F={f}": {k: weighted_buckets[h, f][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "dpv_plain_ms")}
                for h, f in GAT_SHAPES},
        },
        {
            "name": "edge_dot",
            "route": "cuda",
            "source": spmm_src,
            "replaces": "none: B2-w's dpv, which the JAX package leaves to XLA "
                        "(graph_odenet_tpu/parallel/halo.py:179)",
            "launches": gat_bucket_launches["edge_dot"],
            "max_abs_err": max(weighted_buckets[sh]["edge_dot"]["max_abs_err"]
                               for sh in GAT_SHAPES),
            "max_err_over_tol": max(weighted_buckets[sh]["edge_dot"]["max_err_over_tol"]
                                    for sh in GAT_SHAPES),
            "tolerance": "1e-5 + 1e-5 of the terms' magnitudes against the plain version in "
                         "float64: three shapes at P=1, every bucket at P=8",
            **{k: dyn_row["edge_dot"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            "shape": "calibrated arxiv twin, P=1, H=1, F=256 (the dynamics' layers), one call",
            "other_shapes": {f"H={h},F={f}": {k: weighted_buckets[h, f]["edge_dot"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")} for h, f in GAT_SHAPES},
        },
        *({
            "name": name,
            "route": "cuda",
            "source": spmm_src,
            "replaces": f"none: PyTorch's {library} in the attention softmax (the JAX package "
                        "leaves it to XLA)",
            "tolerance": "bit-equal to PyTorch's call",
            **{k: softmax[f"{row} H=4"][k] for k in (
                "ms", "library_ms", "bound_ms", "bound_by", "host_us", "device_us",
                "library_device_us", "launches_per_call")},
            "shape": f"calibrated arxiv twin, P=1, [E, 4] f32, {row}, one call",
            "other_shapes": {k: {f: r[f] for f in ("ms", "library_ms", "bound_ms", "device_us",
                                                   "library_device_us")}
                             for k, r in softmax.items() if k.startswith(name)},
        } for name, library, row in (
            ("gather_rows", "index_select", "gather_rows receivers"),
            ("segment_max", "scatter_reduce amax", "segment_max sorted"))),
        dict(att_entry("csr_spmm_weighted", spmm_src, "graph_odenet_tpu/ops/pallas_spmm.py:479",
                       mask_row, weighted),
             surfaces_launches=surface_launches.get("csr_weighted", 0)),
        *(dict(att_entry(k, gat_src, replaces, cite_row, gat_launches[k], costs=True),
               adjoint_launches=adjoint_launches[k],
               solver_launches=solver_launches.get(k, 0),
               surfaces_launches=surface_launches.get(k, 0),
               **({"bf16": bf16_objects[k]} if k in bf16_objects else {})) for k, replaces in (
            ("gat_fwd", "graph_odenet_tpu/ops/pallas_gat.py:206"),
            ("gat_bwd", "graph_odenet_tpu/ops/pallas_gat.py:890"),
            ("gat_dwh", "graph_odenet_tpu/ops/pallas_spmm.py:736"))),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
