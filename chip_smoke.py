#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

(``python3 chip_smoke.py --bo-group G OUT.json`` runs one group of phases
4b-4f alone and writes its launches to OUT.json: the script starts one
such process for each group. ``--mesh-rank R W PORT DIR`` and
``--mesh-nccl PORT DIR`` are phase 7's rank processes, and
``--train-mesh-rank R W PORT DIR`` and ``--train-mesh-nccl PORT DIR``
phase 8's, which it starts.)

Phases, each of which raises on failure (non-zero exit):

1. setup: the card's name and power limit, torch/CUDA versions, TF32 off,
   and the build of every kernel from the sources in the checkout (one
   nvcc per source, all seven at once; seconds, and each instance's
   registers and spills, logged; the scans' float32 backward instances
   must not spill); ``flash_attention``'s SASS must hold
   tensor-core instructions (``cuobjdump``, where the toolkit has it);
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, with error and CUDA-event times beside
   its bound and, where one PyTorch call computes the same function, that
   call's time: ``matern_score`` (both entries at the (S, N, n) the
   batched grid, the sequential run and Qwen2-1.5B's serving run launch
   and at ceiling rows, timed cold as well as warm; the posterior entry
   also at a ragged N for every instance, at padded n, and on a real fit
   with a failed lane and candidates on training points, its mean equal
   to the mean entry's bit for bit, its shared memory equal to
   ``posterior_plan``'s and, at the main path's rows, enough blocks an
   SM for one wave; its build must not spill),
   ``flash_attention`` (bf16 at Qwen2-1.5B's,
   RecurrentGemma-2B's, Qwen1.5-MoE-A2.7B's (16/16, hd 128; also at its
   training batch, B 4 x S 512) and Kimi K2's (64/8, hd 112) heads, and
   the reference's kernel cases; bf16 also against the plain emulation
   of its tiles), its backward ``flash_attention_bwd`` (dq, dk and dv at
   Qwen2-1.5B's training microbatch in bf16 and float32, a ragged S,
   RecurrentGemma-2B's local layer over its 2048 window at S 4096,
   Qwen1.5-MoE-A2.7B's heads at B 2 and at its training batch B 4 x S
   512, Kimi K2's heads, and the reference's kernel cases; against the
   float32
   plain backward on the same inputs and the plain emulation of its own
   arithmetic (bf16: the tensor-core kernels, P and dS rounded to bf16)
   within ``BWD_TOL`` of each tensor's largest magnitude, the forward's
   log-sum-exp within ``LSE_ATOL``, twice bit for bit, timed warm and
   cold beside SDPA's backward and the CUDA-core kernels' earlier time,
   with the registers and spills of the kernels each row runs; its
   tensor-core instances must build without spills), ``decode_attention``
   (also against the plain emulation of its splits, a row with no allowed
   slot among the shapes, and twice, bit for bit), both timed cold as
   well as warm,
   ``rglru_scan`` (RecurrentGemma-2B's prefill, split-serving and decode
   shapes, its 2048-step window, and the reference's cases; also against
   the plain emulation of its chunks, in place, twice bit for bit, with
   its plan, blocks an SM and waves, and timed cold as well as warm: the
   calls rotate over copies of the inputs that together pass twice the
   L2 size) and ``rwkv6_scan`` (RWKV6-3B's
   shapes in f32 and bf16, the reference's cases and a ragged hd 100,
   the state written in place, twice bit for bit, with its plan, blocks
   an SM and waves, timed cold as well as warm, and in float32 with the
   backward's saved states written equal to the forward without them bit
   for bit; its hd-160 build and the float32 instances that save the
   states must not spill), and the scans' float32 backwards
   ``rglru_scan_bwd`` (RecurrentGemma-2B's training microbatch, the
   split-serving length, one step, the reference's cases) and
   ``rwkv6_scan_bwd`` (RWKV6-3B's training microbatch and split-serving
   length, the reference's cases, a ragged hd 100, a logw whose w
   underflows to 0, the row kernel's hd-64 and hd-256 instances and an
   hd 37 that takes its 4-byte copies; the forward's saved states
   against the plain forward's): each gradient against the plain
   reverse loop within ``BWD_TOL`` and the plain emulation of the
   kernels' order within ``SCAN_BWD_EMU_TOL`` of its largest
   magnitude, with and without a cotangent for the last state, twice
   bit for bit, timed warm and cold beside the bound and the plain loop
   (no PyTorch call computes them), the row kernel's plan
   (``bwd_plan``) held to its build, with its blocks an SM and waves;
3. the sequential engine, ``BayesSplitEdge(default_vgg19_problem(),
   budget=20).run(seed=0)``, must reach 87.5 % at split layer 7;
4. the batched engine on the 16-scenario VGG19 grid (seeds 0-3 x gain
   offsets 0/-2 dB x budgets 20/28) must match the per-scenario
   accuracies recorded in ``benchmarks/artifacts/BENCH_bo_engine.json``;
4b. the whole-run engine (``WholeRunBayesSplitEdge``): the same grid,
   warm and compacted, must match ``accuracies.wholerun`` there (its
   wall time, iterations, lane log, mean warm-fit steps, host reads and
   synchronisations logged); the grid cold, compacted and uncompacted,
   equal in every output leaf; the hetero mix (16 lanes, budgets 6-20,
   VGG19 + ResNet101) and the LM request mix (12 scenarios, L 24-61)
   with the reference's answers and lane logs
   (``tests/data/torch_wholerun_expected.json``), packed and in two
   shards (``run_packed_shards``) equal to unpacked bit for bit; the
   prior bank: an empty and a never-hitting bank equal no bank, a warmed
   bank hits every scenario and never does worse, and ``save``/``load``
   keeps its state; and a ``lane_independence`` line (whether the fit's
   library calls give a lane the same bits at 1, 4, 8 and 16 lanes);
4c. the streaming server (``StreamingBayesSplitEdge``), a ``stream``
   line a run (wall time, arrivals/s, dispatches, the lane log with each
   phase's acquisition iterations and 16-lane chunks, occupancy, queue
   depth, host reads, synchronisations, posterior launches and their
   (S, N, n)): (a) the hetero mix through 8 lanes, cold equal to the
   cold uncompacted whole run in every output leaf and to the
   reference's answers and lane log
   (``tests/data/torch_stream_expected.json``; traces within a 1/64
   quantum), warm within the reference's warm tolerance of the warm
   compacted whole run; (b) a 128-arrival mixed CNN + LM trace
   (``arrival_trace("poisson", n=128, seed=0)`` over
   ``MIXED_TRACE_ARCHS``), warm, through 8 and 64 lanes, the two widths
   within the warm tolerance of each other and the reference's quantized
   answers; (c) chaos on 16 VGG19 requests through 4 lanes, cold: a kill
   at round 2 resumed from its checkpoint and deduped, and a NaN poison
   at round 2 (requeued), each equal to the fault-free run bit for bit;
4d. the fleet (``sim_fleet``: a router and two 4-lane workers over a
   simulated transport, one thread), a ``fleet`` line a run (wall time,
   router cycles, the transport's sent/delivered/dropped/duplicated
   counts, retries, dispatches, acquisition iterations and chunks, host
   reads, synchronisations, posterior launches): (a) zero-fault over the
   hetero mix, cold, equal to 4c's 8-lane single-host stream (run again
   in 4d's process) in every result leaf and so to the reference's
   answers; (b) a lossy network
   (``NetworkChaos``: 5 % drop, 5 % duplication, reordering, delay, a
   partition of ``w0`` healed later) over a 16-arrival bursty deadlined
   trace: every request exactly once, the deadline hit rate at least 0.9
   of the fault-free fleet's, the served answers the fault-free fleet's
   bit for bit;
4e. Table 1 (``benchmarks/table1_torch.py``): the nine methods
   sequentially and the two BO rows through the batched engine (the
   seven host and PPO rows are the same code in both modes, so only the
   sequential mode runs them), each row with its wall time, held to the
   reference's rows (``tests/data/torch_table1_expected.json``): the
   host searches exactly, Bayes-Split-Edge and Basic-BO at parity level
   3, PPO on the reference's ``jax.random`` draws (every evaluation's
   split layer and feasibility bit, the best accuracy, every power
   within ``PPO_POWER_TOL``);
4f. the paper's figures (``benchmarks/*_torch.py``), a ``figure`` line
   each (wall time, BO runs, evaluations, synchronisations, posterior
   launches and their (S, N, n), mismatches and deviations), each held
   by its script's ``mismatches`` to the reference's answers
   (``tests/data/torch_figures_{paper,regret,ablation}_expected.json``):
   Figs 2-4 (host numbers); Figs 6 and 7 built from 4e's sequential
   runs (the same calls) with their host-only methods, grid and band,
   Basic-BO's steps held at parity level 3 (it leaves the reference's
   path of evaluations on the card; ``CARD_LEVEL3``);
   Fig 8 ``--mixed-arch``, Fig 9 ``--batched`` and Fig 10 ``--batched``
   at the reference's default seeds (3, 3, 10); trace robustness (5
   frames). The figures' sequential modes are held on the CPU only
   (``tests/test_torch_figures_{regret,ablation}.py``);
   4b-4f wait on the host between small launches, so they run side by
   side, a process each (``BO_GROUPS``) on the one card, while the
   script measures nothing else; each process's lines are printed when
   all have ended, and their wall times are those of a shared host;
4g. VGG19 at full width (``models/vgg.py``: 1000 classes, 224 x 224 x
   3, float32, 143.7 M parameters from ``torch.Generator`` seed 0, one
   seeded image, cuDNN deterministic): ``split_forward`` at every split
   0..37 equal to the unsplit forward bit for bit, its boundary bytes
   the profile's ``activation_bytes(l)``, the logits at l = 7 within
   ``VGG_LOGIT_TOL`` of a float64 forward on the host, and a BO run with
   the real VGG19 as executor equal to phase 3's run bit for bit (the
   executor called once an evaluation at the ledger's (l, p), the
   posterior launched as often as in phase 3); a ``vgg`` line (BO and
   executor seconds, per split the device half, hop and server half ms
   and the boundary bytes) and a ``profile`` line of one forward at
   l = 7 beside its bound;
5. for each of Qwen2-1.5B, RecurrentGemma-2B, RWKV6-3B and
   Qwen1.5-MoE-A2.7B at full width (bf16, weights from
   ``torch.Generator`` seed 0), one model at a time:
   split serving, where ``launch.serve.main`` (budget 15, with its own
   model, built and freed before the phase's) must
   pick the split and power the CPU run picks and ``SplitRunner`` at four
   splits must equal the unsplit forward bit for bit; greedy decoding (a
   B 2 x 512 prompt, 32 new tokens, ``max_seq`` 1024); where the time
   goes (``torch.profiler``: device time by kernel class and the idle
   share) in one split-serving forward, one prefill and one decode step,
   each line holding exactly the port's CUDA kernels ``MODEL_RUNS`` says
   (a line that lost events is profiled again over fewer calls, at most
   twice, and then fails); for the MoE model a ``moe`` line a path (the
   split-serving forward, the full forward, the prefill, one decode
   step: assignments, capacity, dropped assignments in total and at the
   worst layer, the largest expert load, the summed aux loss, and the MoE
   layers' device ms: expert products, shared experts, the rest);
   and prefill + one decode step against the full forward, in bf16 and
   on a float32 copy of the model (drawn anew from the same seed once the
   bf16 model is freed, each leaf rounded through bf16: the same weights,
   and both do not fit the card at 14.3 B parameters); where an MoE
   route drops an assignment, the check runs again on the same weights
   at a capacity factor under which nothing drops, and says so; a
   ``moe_route_flips`` line counts the routed (token, expert) pairs that
   differ between the bf16 and the float32 checks, and within each
   between the prefill or decode step and the full forward; the greedy
   run's tokens and logits, and the float32 copy's logits on those
   tokens, are kept for phase 7 (``GENERATED``);
6. training, Qwen2-1.5B (``TRAIN_ARCH``): (a) ``launch.train`` at full
   width and depth, bf16, remat, AdamW (every optimizer clips the
   gradients leaf by leaf), B 4 x S 512 in 2 microbatches,
   20 steps (``TRAIN_RUN``): the loss falls (the mean of the last five
   below the first five), each step launches exactly
   ``train_launches`` (28 x 2 x 2 flash forwards, 28 x 2 backwards) and
   no plain version; a ``profile`` line of one step and a ``train`` line
   (step ms on the host's clock, tokens/s, device busy and idle share,
   peak memory, the loss curve, MFU, the step split into forward, CE,
   backward and optimizer); (b) one AdamW step at full width, 2 layers,
   float32, through the kernels and through the plain versions on the
   same weights and batch, the loss, every gradient leaf and the updated
   parameters within ``STEP_GRAD_TOL``, ``STEP_ATOL``/``STEP_SHARE`` and
   ``STEP_ATOL_ALL``, and the same step in bf16 through the kernels (the
   tensor-core backward), every gradient leaf within
   ``STEP_GRAD_TOL_BF16`` of the float32 plain step's; (c) 2 layers at
   full width with the vocab cut to 32,000, bf16, int8 gradient
   compression, 6 steps with a checkpoint
   every 2 and a failure injected at step 3 through
   ``TrainController``: the resumed run equals the uninterrupted one bit
   for bit in every parameter, moment and error-feedback leaf; then,
   one model at a time, RWKV6-3B and RecurrentGemma-2B (``RECURRENT_ARCHS``):
   (a) as 6a (``RECURRENT_RUN``: 10 and 20 steps at lr 1e-5),
   the loss held over the first and last three, each step launching
   exactly ``train_launches``
   (RecurrentGemma-2B: 72 ``rglru_scan``, 36 ``rglru_scan_bwd``, 32
   flash forwards and 16 backwards; RWKV6-3B: 128 ``rwkv6_scan``, 64
   ``rwkv6_scan_bwd``), with its ``profile`` and ``train`` lines; (b)
   as 6b in float32 on one pattern cycle of RecurrentGemma-2B (rglru,
   rglru, local) and 2 layers of RWKV6-3B, the plain route the plain
   scans under autograd; then Qwen1.5-MoE-A2.7B (``MOE_ARCH``), alone on
   the card: the MoE layer's determinism check (one full-width layer,
   bf16, T 4 x 512 at capacity factor 1.5, which drops: two backwards
   equal bit for bit in every gradient, x included; its device ms
   forward and backward and its expert products'); (a) as 6a at full
   width and depth, bf16, remat, Adafactor, B 4 x S 512 in one
   microbatch, 10 steps at lr 1e-5 (``MOE_RUN``), each step launching
   exactly 48 flash forwards and 24 backwards, with its ``profile``,
   ``train`` (MFU from the active parameters) and ``moe`` lines (drops,
   aux, the capacity rows executed against the assignments, the expert
   products' ms forward and backward); (b) one Adafactor step in
   float32 on 2 MoE layers at full width, B 2 x S 512, the plain route's
   experts pinned to the kernel route's after the flipped (token,
   expert) pairs are counted; (c) as 6c with Adafactor and no
   compression, every parameter and factored moment bit for bit.
7. the mesh, ranks as processes sharing the one card (no multi-GPU
   figure): ``MESH_RANKS`` gloo ranks and one NCCL process of world size
   1, started together, each printing ``mesh`` lines (backend, ranks,
   collectives by kind, bytes and bytes staged through the host, wall
   time); (a) 4b's grid (warm) and hetero mix (cold) over a ``("scen",)``
   mesh, each rank its contiguous shard, held to 4b's results at the
   reference's bars (evaluations and best accuracy equal, incumbent
   traces within WARM_TRACE_TOL; bit for bit logged), each rank's
   posterior launches one an acquisition iteration, and the NCCL mesh
   of one rank equal to 4b bit for bit; (b) ``MESH_RUNS`` served over a
   (data 1, model 2) mesh at full width, bf16, each rank building its
   shards from phase 5's seed one rank after another: Qwen1.5-MoE-A2.7B
   in its own ``"tensor"`` mode and (2 layers, against a 1-rank run of
   those 2 layers made here) in ``"expert"`` mode, Qwen2-1.5B,
   RecurrentGemma-2B (its KV ring split over the ranks, decode merged
   by log-sum-exp) and RWKV6-3B: ``greedy_generate`` on phase 5's
   prompt, each rank's launches those of a 1-rank run, its tokens
   compared with phase 5's, and on phase 5's tokens its logits within
   ``TP_ERR_FACTOR`` times the 1-rank bf16 run's own error against the
   float32 copy, any other token choice a tie (``TP_TIE_FACTOR``).
   Phase 2 also holds ``decode_attention`` with its log-sum-exp
   (``DECODE_LSE_SHAPES``) against the plain version.
8. training on the mesh, run beside phases 4b-4f (they wait on the
   host; its ranks need nothing of the phases before it):
   ``MESH_RANKS`` gloo ranks sharing the card, then one NCCL process of
   world size 1, each printing ``mesh_train_*``
   lines (loss, gnorm, the worst gradient leaf and moment against the
   1-rank step, launches, collectives by kind with bytes and bytes
   staged through the host, step time on the host's clock, peak
   memory): (a) one float32 AdamW step of Qwen2-1.5B at full width and
   depth, B 4 x S 512, on (data 1, model 2) tensor parallel, on the
   same mesh with sequence parallelism (``MESH_SP``) and on
   (data 2, model 1) with FSDP, each held to the 1-rank step on the same
   weights and batch (run once by rank 0, its gradients and moments
   mapped into the other rank by CUDA IPC) at
   ``MESH_STEP_TOL`` (loss, gnorm, every gradient leaf and moment by its
   norm; RWKV6-3B's ``mix.u`` at ``MESH_LOOSE_FACTOR`` times that, and
   each RWKV6-3B leaf's bar raised by its own kernel-against-plain
   difference in the 1-rank step, ``MESH_NOISE_ARCHS``, which must stay
   within ``MESH_NOISE_CAP``); (b) 5
   bf16 steps on each mesh through ``launch.train.build`` at
   ``TRAIN_RUN``'s lr, the first batch's loss falling, the mesh's token
   losses on it within twice the 1-rank bf16 run's own (per-token) error
   against float32, and the first step's loss their mean; (c) one
   float32 step of RecurrentGemma-2B and
   RWKV6-3B (one pattern cycle, 2 layers) on (1, 2) and of 2 MoE layers
   of Qwen1.5-MoE-A2.7B with Adafactor in both ``moe_sharding`` modes on
   (1, 2) and in ``"tensor"`` mode on (2, 1) (the global batch routed
   whole, as the reference's jit routes it with a model axis of one),
   and with sequence parallelism on (1, 2) for the first two and the
   ``"tensor"`` MoE (their launches under paths of their own, ``:sp``),
   each held as (a); (d) 2 layers, bf16: 2 steps on (1, 2), a save
   (gathered, one rank writes), a restore onto (2, 1) with FSDP equal
   bit for bit, a third step whose token losses lie within three times
   the 2-layer model's own bf16 error of an unbroken 1-rank run's; (e)
   one bf16 step of (b)'s model over a world-1 NCCL mesh (NCCL
   initialised, no collective run), equal bit for bit to the same step
   with no mesh. Phase 2 holds each kernel these steps launch,
   forward and backward, at the shape a rank sees
   (``MESH_FLASH_SHAPES``, the scans' ``mesh_tp`` rows).
9. the dry run (``python -m repro_torch.launch.dryrun``) of
   ``DRYRUN_CELLS`` on the pod mesh (256 fake ranks), in children on
   this host's torch, run beside phase 6's first training run: fake CUDA
   tensors over a ``"fake"`` process group, nothing allocated on the
   card, no kernel launched; a ``dryrun`` line a cell (status, FLOPs,
   argument and peak bytes a rank, trace seconds); any status but ok
   fails. Phase 2 also logs the host time the kernels' ``torch.library``
   operators add to a launch (``op_overhead``).

Launch counters are zeroed just before each main path (phases 3, 4, each
whole run of 4b, each stream of 4c, each fleet of 4d, each row of 4e,
each figure of 4f, the executor run of 4g, each model's split,
serving and generation runs, and each training run and step check of
phase 6, each rank's whole run and generation of phase 7, and each
rank's mesh step and bf16 run of phase 8) and read just after:
each kernel of the path must have launched as often as the model's
layers say (``MODEL_RUNS``: per forward and per decode step), every other
kernel never, and the plain versions never. In phases 3, 4, 4b-4g
and the serving runs every block scoring is one posterior launch (in
4c and 4d, one a 16-lane chunk of an acquisition iteration), whose
(S, N, n) is logged, with no triangular solve beside it; every main-path
row of phase 2 must be among the (S, N, n) so logged. The last line
is the JSON ``{"ok": true, "device": {...}}``; a JSON line before it
lists every kernel with its launches by path, error, times and bound.
Exits non-zero without a CUDA device, and outside a checkout (it
imports ``src/repro_torch``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
RTOL = ATOL = 1e-5        # kernel vs plain: the summation order differs
SQRT5 = 2.23606797749979
# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# sqrt and exp run on the special-function units: 16 results per clock
# per SM on compute capability 9.0 against 128 f32 FMAs (256 operations)
# per clock per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput), so 1/16 of the f32 operation peak
PEAK_SFU_PER_S = PEAK_F32_FLOPS / 16
PEAK_BF16_FLOPS = 989e12            # dense tensor-core bf16
ATTN_RTOL = 1e-2                    # the reference's kernel tolerances
ATTN_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
QWEN = dict(Hq=12, Hkv=2, hd=128)   # Qwen2-1.5B's attention heads
MOE = dict(Hq=16, Hkv=16, hd=128)   # Qwen1.5-MoE-A2.7B's
KIMI = dict(Hq=64, Hkv=8, hd=112)   # Kimi K2's (the pool's one hd 112)
# phase 8's shapes, one rank's (forward and backward): Qwen2-1.5B's B 4 x
# S 512 on (data 1, model 2), 6/1 heads a rank, in float32 (8a) and bf16
# (8b, 8d); its whole batch over a world-1 NCCL mesh (8e); and 8c's
# float32 steps at B 2 x S 512: RecurrentGemma-2B's local layer, whose
# heads the rules replicate, and Qwen1.5-MoE-A2.7B's 8/8 heads a rank on
# (1, 2) and its 16/16 on (2, 1), one sequence a rank. (FSDP's (2, 1)
# ranks run Qwen2-1.5B's B 2 x S 512 at 12/2 heads: the training rows.)
MESH_FLASH_SHAPES = [
    ("mesh_tp", 4, 512, 0, torch.bfloat16, 6, 1, 128),
    ("mesh_tp_f32", 4, 512, 0, torch.float32, 6, 1, 128),
    ("mesh_nccl", 4, 512, 0, torch.bfloat16, *QWEN.values()),
    ("mesh_dp_f32", 2, 512, 0, torch.float32, *QWEN.values()),
    ("mesh_recurrentgemma_f32", 2, 512, 2048, torch.float32, 10, 1, 256),
    ("mesh_moe_tp_f32", 2, 512, 0, torch.float32, 8, 8, 128),
    ("mesh_moe_dp_f32", 1, 512, 0, torch.float32, *MOE.values()),
]
# flash attention: (name, B, S, window, dtype, Hq, Hkv, hd)
FLASH_SHAPES = [
    ("split_serving", 2, 32, 0, torch.bfloat16, *QWEN.values()),
    ("prefill", 2, 512, 0, torch.bfloat16, *QWEN.values()),
    ("long", 1, 4096, 0, torch.bfloat16, *QWEN.values()),
    ("prefill_window", 2, 512, 128, torch.bfloat16, *QWEN.values()),
    ("ragged", 2, 100, 0, torch.bfloat16, *QWEN.values()),
    # the pool's other head dims: 120 (H2O-Danube3), 256 (RecurrentGemma)
    ("hd120", 1, 256, 0, torch.bfloat16, 8, 2, 120),
    ("hd256_window", 1, 512, 128, torch.bfloat16, 10, 1, 256),
    ("hd256_f32", 1, 128, 0, torch.float32, 4, 1, 256),
    # RecurrentGemma-2B's local layers in prefill
    ("recurrentgemma_prefill", 2, 512, 2048, torch.bfloat16, 10, 1, 256),
    # Qwen1.5-MoE-A2.7B's prefill, split-serving forward (G = 1) and
    # training batch (B 4 x S 512 in one microbatch), and Kimi K2's heads,
    # which no model of the card runs (1.03 T parameters)
    ("moe_prefill", 2, 512, 0, torch.bfloat16, *MOE.values()),
    ("moe_split_serving", 2, 32, 0, torch.bfloat16, *MOE.values()),
    ("moe_train", 4, 512, 0, torch.bfloat16, *MOE.values()),
    ("kimi_prefill", 1, 512, 0, torch.bfloat16, *KIMI.values()),
    *MESH_FLASH_SHAPES,
    # the reference's kernel cases (tests/test_kernels.py)
    ("case0", 2, 128, 0, torch.float32, 4, 2, 32),
    ("case1", 1, 256, 0, torch.float32, 8, 8, 64),
    ("case2", 1, 96, 0, torch.float32, 4, 1, 16),
    ("case3", 2, 128, 24, torch.float32, 4, 4, 32),
    ("case4", 1, 160, 48, torch.float32, 8, 2, 64),
    ("case5", 2, 128, 0, torch.bfloat16, 4, 2, 32),
    ("case6", 1, 64, 0, torch.bfloat16, 2, 2, 128),
]
FLASH_MAIN = "prefill"
# flash attention's backward: (name, B, S, window, dtype, Hq, Hkv, hd);
# "train" is a microbatch of phase 6's Qwen2-1.5B training run
FLASH_BWD_SHAPES = [
    ("train", 2, 512, 0, torch.bfloat16, *QWEN.values()),
    ("train_f32", 2, 512, 0, torch.float32, *QWEN.values()),
    ("ragged", 2, 500, 0, torch.bfloat16, *QWEN.values()),
    # RecurrentGemma-2B's local layer over its whole window
    ("recurrentgemma_local", 1, 4096, 2048, torch.bfloat16, 10, 1, 256),
    # Qwen1.5-MoE-A2.7B's heads at the dense LMs' microbatch, and its
    # training batch (phase 6's MoE run: B 4 x S 512, one microbatch)
    ("moe_heads", 2, 512, 0, torch.bfloat16, *MOE.values()),
    ("moe_train", 4, 512, 0, torch.bfloat16, *MOE.values()),
    ("kimi_train", 1, 512, 0, torch.bfloat16, *KIMI.values()),
    *(row for row in MESH_FLASH_SHAPES if row[0] != "mesh_dp_f32"),
    *(row for row in FLASH_SHAPES if row[0].startswith("case")),
]
FLASH_BWD_MAIN = "train"
# backward vs the float32 plain backward on the same inputs, of each
# tensor's largest magnitude: float32 differs in summation order only;
# bfloat16 rounds P and dS to bf16 before their tensor-core products (2^-9
# relative each), the outputs round to bf16 (2^-9) and D uses the bf16
# output: 3.0-6.6e-3 in the plain emulation of that arithmetic
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the backward's cold ms before its tensor-core redesign (final run of the
# CUDA-core kernels on an H100 80GB HBM3 at 700 W, PERF.md)
BWD_EARLIER_COLD_MS = dict(train=0.6948, train_f32=0.7017, ragged=0.6765,
                           recurrentgemma_local=19.13, moe_heads=0.8990,
                           kimi_train=1.423)
LSE_ATOL = 1e-4      # base-2 log-sum-exp, float32 sums in another order
# decode attention: (name, B, T, last, q_pos, window, dtype, Hq, Hkv,
# hd); slot p % T holds position p for p <= last, the rest are empty
DECODE_SHAPES = [
    ("decode", 2, 1024, 543, 543, 0, torch.bfloat16, *QWEN.values()),
    ("ring_window", 2, 256, 700, 700, 256, torch.bfloat16, *QWEN.values()),
    ("hd120", 1, 256, 200, 200, 0, torch.bfloat16, 8, 2, 120),
    ("hd256", 1, 512, 300, 300, 0, torch.bfloat16, 10, 1, 256),
    ("hd256_f32", 1, 128, 99, 100, 0, torch.float32, 4, 1, 256),
    # RecurrentGemma-2B's local layers in decoding (ring of 1024 slots)
    ("recurrentgemma_decode", 2, 1024, 543, 543, 2048, torch.bfloat16, 10,
     1, 256),
    # ... and one rank's half of that ring in phase 7b (model 2)
    ("recurrentgemma_slice", 2, 512, 543, 543, 2048, torch.bfloat16, 10, 1,
     256),
    # Qwen1.5-MoE-A2.7B's decoding, and Kimi K2's heads
    ("moe_decode", 2, 1024, 543, 543, 0, torch.bfloat16, *MOE.values()),
    ("kimi_decode", 1, 1024, 543, 543, 0, torch.bfloat16, *KIMI.values()),
    # the reference's kernel cases (tests/test_kernels.py)
    ("case0", 2, 128, 99, 100, 0, torch.float32, 4, 2, 32),
    ("case1", 1, 256, 255, 256, 0, torch.float32, 8, 1, 64),
    ("case2", 2, 96, 59, 60, 32, torch.float32, 4, 4, 32),
    ("case3", 1, 128, 76, 77, 0, torch.bfloat16, 8, 2, 128),
    # a row with no allowed slot (every position is after q_pos): the
    # uniform mean over all T slots, as the plain version gives
    ("no_allowed_slot", 1, 256, 100, -1, 0, torch.bfloat16, 12, 2, 128),
]
DECODE_MAIN = "decode"
# decode_attention with its log-sum-exp output (return_lse): the main
# path's shape is RecurrentGemma-2B's local layer in phase 7b, whose ring
# of 1024 slots splits over the 2 ranks of ``model`` (512 slots each);
# the output must equal the call without it bit for bit, the log-sum-exp
# the plain version's within DECODE_LSE_ATOL (natural log, float32 sums
# in another order)
DECODE_LSE_SHAPES = ("recurrentgemma_slice", "decode", "case2",
                     "no_allowed_slot")
DECODE_LSE_MAIN = "recurrentgemma_slice"
DECODE_LSE_ATOL = 1e-4
DEVICE = "cuda"
# rglru_scan: (name, B, S, R, dtype); RecurrentGemma-2B's R is 2560
RGLRU_SHAPES = [
    ("prefill", 2, 512, 2560, torch.float32),
    ("split_serving", 2, 32, 2560, torch.float32),
    ("decode", 2, 1, 2560, torch.float32),
    ("prefill_bf16", 2, 512, 2560, torch.bfloat16),
    # RecurrentGemma-2B's window: the kernel runs S in 16 pieces
    ("prefill_2k", 1, 2048, 2560, torch.float32),
    # one rank's channels in phase 8c: (data 1, model 2), B 2 x S 512
    ("mesh_tp", 2, 512, 1280, torch.float32),
    # the reference's kernel cases (tests/test_kernels.py)
    ("case0", 2, 64, 32, torch.float32),
    ("case1", 1, 100, 48, torch.float32),
    ("case2", 2, 64, 32, torch.bfloat16),
]
RGLRU_MAIN = "prefill"
# rwkv6_scan: (name, B, S, H, hd, dtype); RWKV6-3B has 16 heads of 160
RWKV_SHAPES = [
    ("prefill", 2, 512, 16, 160, torch.float32),
    ("split_serving", 2, 32, 16, 160, torch.float32),
    ("decode", 2, 1, 16, 160, torch.float32),
    ("prefill_bf16", 2, 512, 16, 160, torch.bfloat16),
    # one rank's heads in phase 8c: (data 1, model 2), B 2 x S 512
    ("mesh_tp", 2, 512, 8, 160, torch.float32),
    # the reference's kernel cases (tests/test_kernels.py)
    ("case0", 2, 64, 2, 16, torch.float32),
    ("case1", 1, 100, 4, 32, torch.float32),
    ("case2", 2, 48, 2, 16, torch.bfloat16),
    # a partial column tile, row group and chunk; split serving in bf16
    ("hd100_ragged", 1, 77, 3, 100, torch.float32),
    ("split_serving_bf16", 2, 32, 16, 160, torch.bfloat16),
]
RWKV_MAIN = "prefill"
# scans vs plain: float32 differs by fused multiply-adds and summation
# order only; bfloat16 takes the reference's kernel-test bar (5 x its
# atol of 2e-2, rtol 3e-2), since outputs round to bf16 on both sides
SCAN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-1, 3e-2)}
# the scans' backwards, float32: (name, B, S, R) and (name, B, S, H, hd,
# underflow); "train" is a microbatch of phase 6's RecurrentGemma-2B and
# RWKV6-3B runs, "split_serving" the serving length, the cases the
# reference's (tests/test_kernels.py) in float32; "underflow" draws logw
# = -exp(8) (w = 0 in float32, the model's clip) on every other step
RGLRU_BWD_SHAPES = [
    ("train", 2, 512, 2560),
    ("split_serving", 2, 32, 2560),
    ("one_step", 2, 1, 2560),
    ("mesh_tp", 2, 512, 1280),
    ("case0", 2, 64, 32),
    ("case1", 1, 100, 48),
]
RWKV_BWD_SHAPES = [
    ("train", 2, 512, 16, 160, False),
    ("split_serving", 2, 32, 16, 160, False),
    ("mesh_tp", 2, 512, 8, 160, False),
    ("case0", 2, 64, 2, 16, False),
    ("case1", 1, 100, 4, 32, False),
    ("case2", 2, 48, 2, 16, False),
    ("hd100_ragged", 1, 77, 3, 100, False),
    ("underflow", 2, 64, 16, 160, True),
    # the row kernel's other instances (widths 64 and 256), each with a
    # last span of one step; hd 37 takes the 4-byte copies (hd % 4 != 0)
    # and a partial block of rows
    ("hd64", 2, 41, 4, 64, False),
    ("hd256", 1, 33, 2, 256, False),
    ("hd37", 1, 19, 2, 37, False),
]
SCAN_BWD_MAIN = "train"
# a backward against the plain emulation of its own order: the same sums
# in the same order, fused multiply-adds taken unfused (RWKV6) or
# emulated in float64 (RG-LRU); of each tensor's largest magnitude
SCAN_BWD_EMU_TOL = 1e-5


@dataclasses.dataclass(frozen=True)
class ModelRun:
    """One full-width model of phase 5: the splits to check, what the
    serving driver must pick on the CPU run's word, and the kernel
    launches of one forward and of one decode step."""
    arch: str
    splits: tuple
    expect: tuple                   # split, power (W), evaluations
    per_forward: dict
    per_step: dict
    bf16_tol: tuple = None          # (atol, rtol) of prefill + decode
    # bf16 prefill + decode held to the float32 forward (within the bf16
    # forward's own error) instead of to the bf16 forward (``decode_check``)
    bf16_vs_float32: bool = False


MODEL_RUNS = [
    ModelRun("qwen2-1.5b", (0, 1, 14, 28), (1, 0.040, 15),
             dict(flash_attention=28), dict(decode_attention=28),
             bf16_tol=(3e-2, 2e-2)),
    # 26 layers: 18 rglru, 8 local attention (window 2048)
    ModelRun("recurrentgemma-2b", (0, 1, 13, 26), (1, 0.027, 15),
             dict(flash_attention=8, rglru_scan=18),
             dict(decode_attention=8, rglru_scan=18)),
    ModelRun("rwkv6-3b", (0, 1, 16, 32), (1, 0.143, 15),
             dict(rwkv6_scan=32), dict(rwkv6_scan=32)),
    # 24 layers, each attention (16/16 heads) and 60 routed experts
    # bf16_tol from its first card runs: the bf16 routes 0.078 apart at
    # |h| <= 3.79, 1.056 times Qwen2-1.5B's (3e-2, 2e-2) at the worst
    ModelRun("qwen2-moe-a2.7b", (0, 1, 12, 24), (1, 0.059, 15),
             dict(flash_attention=24), dict(decode_attention=24),
             bf16_tol=(5e-2, 2e-2), bf16_vs_float32=True),
]
SPLIT_BATCH, SPLIT_SEQ = 2, 32
SERVE_BUDGET = 15
GEN_BATCH, GEN_PROMPT, GEN_NEW, GEN_MAX_SEQ = 2, 512, 32, 1024
# prefill + decode vs the full forward's last hidden state. Float32
# differs only in summation order. In bf16 the two routes round at
# different places (the residual stream at every layer: a unit of the
# last place is 2^-8 relative, 0.0156 at |h| = 4), so they are held to
# the bf16 forward's own error against the float32 copy on the same
# inputs; Qwen2-1.5B also to a fixed (atol, rtol).
HIDDEN_TOL = (1e-3, 1e-3)
MAIN_N = 64 * 64 + 37 + 45          # grid + VGG19 boundary + local slots
MIX_N = 64 * 64 + 61 + 45           # ... at the mixed CNN + LM l_pad 61
# (S, N, n, d) of the matern rows. The main path's, as its block scorings
# log them: the batched grid at n 16 (S 16 -> 12 live lanes), then at
# n 32 (S 10 -> 3, most often 6), the sequential run (S 1, n 16), the
# whole-run grid's 16-lane chunks at n 32 (and n 16, as the batched
# grid), the serving runs of SERVE_ARCHS (S 1, n 16, N = 4096 + their
# layers + 45; ``main_rows``) and the streaming server's chunks of the
# mixed CNN + LM trace (16 lanes at l_pad 61, n 16 and 32). Ceiling
# rows: S 16 at n 48 and 64, which no run reaches, and S 256 (a
# serving-pool width)
MAIN_ROWS = [(16, MAIN_N, 16, 2), (6, MAIN_N, 32, 2), (1, MAIN_N, 16, 2),
             (16, MAIN_N, 32, 2), (16, MIX_N, 16, 2), (16, MIX_N, 32, 2)]
CEILING_ROWS = [(16, MAIN_N, 48, 2), (16, MAIN_N, 64, 2),
                (256, MAIN_N, 64, 2)]
SERVE_ARCHS = ("qwen2-1.5b", "qwen2-moe-a2.7b")
MAIN_SHAPE = (16, MAIN_N, 16, 2)
CEILING_SHAPE = (16, MAIN_N, 64, 2)
# (S, N, n) -> posterior launches, over every block scoring watched
LAUNCHED_SHAPES = {}
# posterior rows off the main path: a ragged N at every instance, and n
# that are padded to their instance in shared memory
RAGGED_N = 203
RAGGED_POINTS = (16, 32, 48, 64, 5, 20, 37)
# posterior vs plain: mu and dmu within rtol 1e-5 and an atol of 1e-5
# plus 1e-6 of the sum of their summands' magnitudes (sums of n float32
# terms taken in another order; a fitted GP's alpha makes the terms far
# larger than their sum); sigma^2 within 1e-5 sv y_sigma^2 (the
# cancellation in sv - |L^-1 ks|^2)
POST_RTOL, POST_ATOL, POST_TERMS = 1e-5, 1e-5, 1e-6
SLEEP_CYCLES = 50_000_000           # keeps the queue full while timing
# the scans' plain loops take milliseconds a call (a Python loop over S):
# timed with fewer calls than the kernels
PLAIN_TIMING = dict(samples=3, inner=2)


def log(*a):
    print(*a, flush=True)


def ptxas_summary(build_log: str) -> list:
    """Registers, spill stores and spill loads of each kernel instance,
    from nvcc's ``-Xptxas -v`` output."""
    rows = []
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            rows.append(dict(entry=m.group(1)))
            continue
        if not rows:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[-1].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def sass_counts(library: Path) -> dict | None:
    """Tensor-core (HMMA, HGMMA) and ldmatrix (LDSM) instructions in a
    built library, from ``cuobjdump -sass``; None where it is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", out))
            for op in ("HMMA", "HGMMA", "LDSM", "LDGSTS")}


def check_rwkv6_build(instances: list) -> None:
    """The premise of ``rwkv6_scan``'s design: the instances RWKV6-3B
    runs (hd 160: chains of 5 rows, float32 and bf16) keep their state
    in registers, spilling nothing, with few enough registers that two
    blocks of ``THREADS`` fit an SM's 65,536. Checked where this process
    built the library."""
    from repro_torch.kernels.rwkv6_scan.ops import THREADS

    if not instances:
        log("build rwkv6_scan: already built, registers not checked")
        return
    model = [r for r in instances
             if re.search(r"rwkv6_scan_kernelI(f|13__nv_bfloat16)Li5E",
                          r["entry"])]
    if len(model) != 2:
        raise AssertionError(f"rwkv6_scan: {len(model)} instances of "
                             "5-row chains in the build log, expected 2")
    most = 65536 // (2 * THREADS)
    for r in model:
        if (r.get("registers", 255) > most or r.get("spill_stores")
                or r.get("spill_loads")):
            raise AssertionError(f"rwkv6_scan instance {r['entry']}: "
                                 f"{r}; the design needs <= {most} "
                                 "registers and no spill")


def check_matern_build(instances: list) -> None:
    """The premise of the posterior kernel's design: each instance
    (NMAX 16, 32, 48, 64) keeps ks[NMAX] in registers, spilling
    nothing. Checked where this process built the library."""
    if not instances:
        log("build matern_score: already built, spills not checked")
        return
    post = [r for r in instances
            if "matern_posterior_kernel" in r["entry"]]
    if len(post) != 4:
        raise AssertionError(f"matern_score: {len(post)} posterior "
                             "instances in the build log, expected 4")
    for r in post:
        if r.get("spill_stores") or r.get("spill_loads"):
            raise AssertionError(f"matern_posterior instance {r['entry']} "
                                 f"spills: {r}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 2: kernel against plain
# --------------------------------------------------------------------------


def main_rows():
    """MAIN_ROWS with the serving row of each of SERVE_ARCHS: N is the
    64 x 64 grid, one boundary slot a layer of the problem
    ``launch/serve.py`` builds for it, and the local slots."""
    from repro_torch.configs import get_config
    from repro_torch.core.acquisition import N_LOCAL
    from repro_torch.launch import serve

    return MAIN_ROWS + [
        (1, 64 * 64 + serve.build_problem(get_config(a), SPLIT_SEQ).L
         + N_LOCAL, 16, 2) for a in SERVE_ARCHS]


def score_inputs(S, N, n, d, seed=0):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)

    return (t(rng.random((S, N, d))), t(rng.random((S, n, d))),
            t(rng.standard_normal((S, n))), t(rng.random((S, n)) < 0.8),
            t(0.1 + rng.random(S)), t(0.5 + rng.random(S)))


def posterior_inputs(S, N, n, seed=0):
    """``score_inputs`` (d = 2) and what the posterior takes besides: L,
    the Cholesky factor of the masked training kernel as the GP builds
    it (noise 1e-3; column-major, as the main path hands it over), y_mu
    and y_sigma."""
    from repro_torch.core import gp

    cand, x, alpha, mask, ls, sv = score_inputs(S, N, n, 2, seed)
    theta = dict(log_ls=torch.log(ls), log_sv=torch.log(sv),
                 log_nv=torch.full_like(ls, float(np.log(1e-3))))
    L = gp.cholesky(gp._masked_kernel(x, mask.bool(), theta,
                                      gp.GPConfig().jitter))
    rng = np.random.default_rng(seed + 1)
    y_mu = torch.as_tensor(80 + rng.standard_normal(S), dtype=torch.float32,
                           device=DEVICE)
    y_sigma = torch.as_tensor(0.5 + rng.random(S), dtype=torch.float32,
                              device=DEVICE)
    return cand, x, alpha, mask, L, ls, sv, y_mu, y_sigma


def fitted_inputs():
    """A real fit: ``gp.fit_batch`` on seeded data (S 4, 32 points, lane
    s with 32 - 5 s of them active), the batched grid's N of random
    candidates, two of which sit on training points, and lane 3's factor
    NaN on and below the diagonal, as ``gp.cholesky`` leaves a lane whose
    kernel is not positive definite."""
    from repro_torch.core import gp

    rng = np.random.default_rng(7)
    S, m = 4, 32
    x = rng.random((S, m, 2))
    y = (80 + 5 * np.sin(4 * x[..., 0]) + 3 * x[..., 1]
         + 0.1 * rng.standard_normal((S, m)))
    mask = np.arange(m)[None] < (32 - 5 * np.arange(S))[:, None]
    cache = gp.fit_batch(gp.as_dataset(dict(
        x=np.where(mask[..., None], x, 0), y=np.where(mask, y, 0),
        mask=mask), DEVICE), gp.GPConfig())
    cand = torch.as_tensor(rng.random((S, MAIN_N, 2)), dtype=torch.float32,
                           device=DEVICE)
    cand[0, 0] = cache["x"][0, 0]
    cand[1, 7] = cache["x"][1, 3]
    tril = torch.ones(m, m, dtype=torch.bool, device=DEVICE).tril()
    L = cache["L"].clone()
    L[3] += torch.where(tril, float("nan"), 0.0)
    th = cache["theta"]
    return (cand, cache["x"].contiguous(), cache["alpha"].contiguous(),
            cache["mask"].float(), L, torch.exp(th["log_ls"]),
            torch.exp(th["log_sv"]), cache["y_mu"], cache["y_sigma"])


def bound(nbytes, flops, sfu=0):
    """Least time on an H100 for one call, and which term sets it: the
    larger of the bytes (each input read once, each output written once)
    at the HBM rate and the float32 operations at the f32 peak (sqrt and
    exp, ``sfu`` of them, at the special-function units' rate)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max(flops / PEAK_F32_FLOPS, sfu / PEAK_SFU_PER_S)
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes",
            dict(bytes_ms=1e3 * t_bytes, f32_ms=1e3 * flops / PEAK_F32_FLOPS,
                 sfu_ms=1e3 * sfu / PEAK_SFU_PER_S))


def matern_bound(S, N, n, d):
    """Least time on an H100 for one call, and which term sets it: the
    larger of the bytes (each input read once, the output written once)
    at the HBM rate, the f32 operations at the f32 peak, and the sqrt and
    exp at the special-function rate.

    Per (candidate, point) pair the function needs 3d + 10 f32 operations
    (an FMA counts 2): d subtracts, d multiplies and d - 1 adds for the
    squared distance; the max with 1e-16; r = sqrt(.) * (1/ls) and
    r^2 = d2 * (1/ls^2), one multiply each; 1 + sqrt5 r + (5/3) r^2 as
    two FMAs (4); the exp argument (1); polynomial times exp (1); and the
    accumulate w_i * k + acc as one FMA (2). Work that does not depend on
    the candidate is done once: w_i = mask_i * alpha_i * sv per point
    (2 per point) and 1/ls, 1/ls^2 per scenario (2 per scenario). Each
    pair also needs one sqrt and one exp, which the special-function
    units run."""
    nbytes = 4 * (S * N * d + S * n * d + 2 * S * n + 2 * S + S * N)
    pairs = S * N * n
    flops = pairs * (3 * d + 10) + 2 * S * n + 2 * S
    return bound(nbytes, flops, sfu=2 * pairs)


def posterior_bound(S, N, n):
    """Least time on an H100 for one posterior call (d = 2), as
    ``matern_bound`` prices the mean.

    Per (candidate, point) pair 25 f32 operations: the mean's 3d + 10 =
    16; ks_i = mask_i k (1); 1 + sqrt5 r as an FMA (2), times e (1),
    times the point's gradient factor (1); the two gradient accumulates
    as FMAs (4). The reference's r / max(r, 1e-12) is 1 on these inputs
    (ls <= 5000) and is not counted. The solve L v = ks: for each j,
    v = ks_j (1/L_jj) (1) and s += v^2 (2), then one FMA (2) for each
    i > j: n^2 + 2n. Per candidate at the end 7: sv - s, its clamp,
    sqrt(var) y_sigma, mu y_sigma + y_mu (2), dmu y_sigma (2). So
    n^2 + 27 n + 7 a candidate, with 2n + 1 sqrt and exp. Once a point:
    w_i, its gradient factor and 1/L_ii (3); once a scenario: 1/ls,
    1/ls^2, sqrt5 sv, (5/3) sv and (-5/3) sv / ls^2 (6). Bytes: cand,
    x, alpha, mask, L and four scalars a scenario read; mu, sigma and
    dmu written."""
    nbytes = 4 * (2 * S * N + 2 * S * n + 2 * S * n + S * n * n + 4 * S
                  + 4 * S * N)
    flops = S * N * (n * n + 27 * n + 7) + 3 * S * n + 6 * S
    return bound(nbytes, flops, sfu=S * N * (2 * n + 1))


def time_calls(fn, args, inner=20):
    """Device ms per call: CUDA events around ``inner`` back-to-back calls
    queued behind a sleep kernel, so host launch cost leaves no gaps."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(inner):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner


def kernel_phase(matern_score, matern_score_ref, shapes):
    """The mean entry at each row of ``shapes`` against its plain
    version; timed warm (back-to-back calls on one set of inputs) and
    cold (``cold_ms``)."""
    rows = []
    for S, N, n, d in shapes:
        args = score_inputs(S, N, n, d, seed=S + n)
        got = matern_score(*args)
        ref = matern_score_ref(*args)
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        abs_err = float(diff.max())
        rel_err = float((diff / ref.abs().clamp(min=1e-30)).max())
        ok = bool(torch.allclose(got, ref, rtol=RTOL, atol=ATOL))
        for fn in (matern_score_ref, matern_score):      # warm-up
            time_calls(fn, args, inner=3)
        ms, plain = [], []
        for _ in range(25):                              # in turns
            plain.append(time_calls(matern_score_ref, args))
            ms.append(time_calls(matern_score, args))
        bound_ms, bound_by, terms = matern_bound(S, N, n, d)
        row = dict(S=S, N=N, n=n, d=d, max_abs_err=abs_err,
                   max_rel_err=rel_err, allclose=ok,
                   ms=cold_ms(matern_score, cold_copies(args)),
                   ms_warm=statistics.median(ms),
                   plain_ms=statistics.median(plain),
                   bound_ms=bound_ms, bound_by=bound_by, bound_terms=terms)
        log("matern_score", json.dumps(row))
        if not ok:
            raise AssertionError(f"matern_score disagrees with its plain "
                                 f"version at {(S, N, n, d)}: max abs err "
                                 f"{abs_err}, rtol/atol {RTOL}/{ATOL}")
        rows.append(row)
    return rows


def posterior_terms(cand, x, alpha, mask, L, ls, sv, y_mu, y_sigma):
    """Per candidate, the sum of the magnitudes of the terms that make mu
    (S, N) and each component of dmu (S, N, 2), raw scale, in float64."""
    c, xs = cand.double(), x.double()
    lsd, svd = ls.double()[:, None, None], sv.double()[:, None, None]
    diff = xs[:, :, None, :] - c[:, None, :, :]              # (S, n, N, 2)
    r = torch.sqrt(torch.sum(diff * diff, -1).clamp(min=1e-16)) / lsd
    e = torch.exp(-SQRT5 * r)
    w = (alpha * mask).double().abs()[:, :, None]
    ys = y_sigma.double()[:, None]
    t_mu = ys * torch.sum(w * svd * (1 + SQRT5 * r + 5 * r * r / 3) * e, 1)
    g = w * (5 / 3) * svd * (1 + SQRT5 * r) * e / (lsd * lsd)
    t_dmu = ys[..., None] * torch.sum(g[..., None] * diff.abs(), 1)
    return t_mu, t_dmu


def check_posterior(name, got, want, args):
    """The posterior entry against its plain version: NaN in the same
    places; mu and dmu within POST_RTOL, POST_ATOL and POST_TERMS of the
    terms' magnitudes; sigma^2 within 1e-5 sv y_sigma^2. Returns the
    errors."""
    t_mu, t_dmu = posterior_terms(*args)
    sv, ys = args[6].double(), args[8].double()
    out = dict(nan_positions_equal=all(
        torch.equal(torch.isnan(a), torch.isnan(b)) for a, b in
        zip(got, want)))
    ok = out["nan_positions_equal"]
    for key, a, b, t in (("mu", got[0], want[0], t_mu),
                         ("dmu", got[2], want[2], t_dmu)):
        live = torch.isfinite(b)
        err = (a.double() - b.double()).abs()[live]
        allowed = (POST_RTOL * b.double().abs() + POST_ATOL
                   + POST_TERMS * t)[live]
        out[f"{key}_max_abs_err"] = float(err.max()) if err.numel() else 0.0
        out[f"{key}_err_over_terms"] = (float((err / t[live]).max())
                                        if err.numel() else 0.0)
        ok = ok and bool((err <= allowed).all())
    live = torch.isfinite(want[1])
    var_err = ((got[1].double() ** 2 - want[1].double() ** 2).abs()
               / (sv * ys * ys)[:, None])[live]
    out["var_max_err_over_sv"] = (float(var_err.max()) if var_err.numel()
                                  else 0.0)
    ok = ok and bool((var_err <= 1e-5).all())
    if not ok:
        raise AssertionError(f"matern_posterior disagrees with its plain "
                             f"version at {name}: {out}")
    return out


def posterior_row(kernels, name, args, timed=True, main=False):
    """One posterior row: against the plain version (``check_posterior``),
    its mu against the mean entry's on the raw scale bit for bit, the
    built kernel against the plan (``posterior_plan``): its shared memory,
    and at a ``main`` row blocks enough an SM for the grid to run in one
    wave; timed cold and warm, beside the plain version and the bound,
    where ``timed``."""
    from repro_torch.kernels.matern_score import kernel as ms_kernel
    from repro_torch.kernels.matern_score.ops import SMS, posterior_plan

    cand, x, alpha, mask, L, ls, sv, y_mu, y_sigma = args
    S, N, _ = cand.shape
    n = x.shape[1]
    got = kernels.matern_posterior(*args)
    want = kernels.matern_posterior_ref(*args)
    mean = kernels.matern_score(cand, x, alpha, mask, ls, sv)
    torch.cuda.synchronize()
    row = dict(name=name, S=S, N=N, n=n,
               **check_posterior(name, got, want, args))
    if not torch.equal(got[0], mean * y_sigma[:, None] + y_mu[:, None]):
        raise AssertionError(f"matern_posterior at {name}: mu differs from "
                             "the mean entry's on the raw scale")
    plan = posterior_plan(S, N, n)
    built = ms_kernel.posterior_build(plan.instance, plan.threads)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    waves = plan.waves(built["blocks_per_sm"])
    row.update(main=main, instance=plan.instance, threads=plan.threads,
               grid=list(plan.grid), sms=sms, waves=waves, **built)
    if (sms != SMS or built["smem_bytes"] != plan.smem_bytes
            or (main and waves != 1)):
        raise AssertionError(f"matern_posterior at {name}: the built "
                             f"kernel has {built} on {sms} SMs, "
                             f"{waves} waves; posterior_plan is {plan}")
    if timed:
        ms = median_ms(dict(
            plain=lambda: kernels.matern_posterior_ref(*args),
            kernel=lambda: kernels.matern_posterior(*args)), ())
        bound_ms, bound_by, terms = posterior_bound(S, N, n)
        row.update(ms=cold_ms(kernels.matern_posterior, cold_copies(args)),
                   ms_warm=ms["kernel"], plain_ms=ms["plain"],
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   bound_terms=terms)
    log("matern_posterior", json.dumps(row))
    return row


def posterior_phase(kernels, shapes, main):
    """The posterior entry at each row of ``shapes`` (timed; those in
    ``main`` are the main path's), at a ragged N for every instance and
    for n padded to one, and on a real fit with a failed lane and
    candidates on training points."""
    rows = [posterior_row(kernels, f"S{S}_N{N}_n{n}",
                          posterior_inputs(S, N, n, seed=S + n),
                          main=(S, N, n, d) in main)
            for S, N, n, d in shapes]
    rows += [posterior_row(kernels, f"ragged_n{n}",
                           posterior_inputs(3, RAGGED_N, n, seed=n),
                           timed=False) for n in RAGGED_POINTS]
    rows.append(posterior_row(kernels, "fitted", fitted_inputs(),
                              timed=False))
    return rows


# --------------------------------------------------------------------------
# phases 3 and 4: the main path
# --------------------------------------------------------------------------


@contextlib.contextmanager
def block_scoring_watched():
    """Watch the block scoring of a BO run: the calls of
    ``acquisition.block_scores``, the (S, N, n) of each posterior launch,
    and the ``torch.linalg.solve_triangular`` calls made inside block
    scoring; yields them."""
    from repro_torch.core import acquisition

    seen = dict(block_scores=0, shapes={}, solves_in_block_scoring=0)
    inside = [False]
    scores_fn = acquisition.block_scores
    posterior_fn = acquisition.matern_posterior
    solve_fn = torch.linalg.solve_triangular

    def block_scores(*a, **k):
        seen["block_scores"] += 1
        inside[0] = True
        try:
            return scores_fn(*a, **k)
        finally:
            inside[0] = False

    def posterior(cand, x, *a):
        shape = (*cand.shape[:2], x.shape[1])
        key = "x".join(map(str, shape))
        seen["shapes"][key] = seen["shapes"].get(key, 0) + 1
        LAUNCHED_SHAPES[shape] = LAUNCHED_SHAPES.get(shape, 0) + 1
        return posterior_fn(cand, x, *a)

    def solve(*a, **k):
        seen["solves_in_block_scoring"] += inside[0]
        return solve_fn(*a, **k)

    with mock.patch.object(acquisition, "block_scores", block_scores), \
            mock.patch.object(acquisition, "matern_posterior", posterior), \
            mock.patch.object(torch.linalg, "solve_triangular", solve):
        yield seen


def check_block_scoring(what, seen, counts, plain, kernels):
    """One posterior launch, and nothing else of the kernel, a block
    scoring; no plain version and no triangular solve in it."""
    posterior = kernels.matern_posterior.launches
    if not (seen["block_scores"] == posterior == counts["matern_score"]
            == sum(seen["shapes"].values())):
        raise AssertionError(f"{what}: {seen['block_scores']} block "
                             f"scorings, {posterior} posterior launches, "
                             f"{counts['matern_score']} matern_score "
                             f"launches ({seen['shapes']})")
    if seen["solves_in_block_scoring"] or any(plain.values()):
        raise AssertionError(f"{what}: block scoring ran "
                             f"{seen['solves_in_block_scoring']} triangular "
                             f"solves; plain versions called: {plain}")


def sequential_phase(core, kernels):
    pb = core.default_vgg19_problem()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with plain_calls_counted() as plain, block_scoring_watched() as seen:
        res = core.BayesSplitEdge(pb, budget=20).run(seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    layer, p_w = pb.denormalize(res.best_a)
    log("sequential", json.dumps(dict(
        wall_s=wall, best_accuracy=res.best_accuracy, layer=layer, p_w=p_w,
        n_evals=res.n_evals, launches=counts, block_scoring=seen)))
    if res.best_accuracy < 87.5 - 1e-6 or layer != 7:
        raise AssertionError(f"sequential run missed the optimum: "
                             f"{res.best_accuracy} at layer {layer}")
    check_block_scoring("sequential", seen, counts, plain, kernels)
    return counts, res


def batched_scenarios(core):
    return core.make_vgg19_scenarios(seeds=(0, 1, 2, 3),
                                     gain_offsets_db=(0.0, -2.0),
                                     budgets=(20, 28))[:16]


def batched_phase(core, kernels):
    expect = json.loads((ROOT / "benchmarks" / "artifacts"
                         / "BENCH_bo_engine.json").read_text())
    expect = expect["accuracies"]["batched"]
    scs = batched_scenarios(core)
    iters = []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with plain_calls_counted() as plain, block_scoring_watched() as seen:
        res = core.BatchedBayesSplitEdge(scs).run(
            on_iteration=lambda i, c: iters.append(i))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    accs = [r.best_accuracy for r in res]
    feas = [r.best_a is not None for r in res]
    log("batched", json.dumps(dict(wall_s=wall, iterations=len(iters),
                                   launches=counts, accuracies=accs,
                                   feasible=feas,
                                   n_evals=[r.n_evals for r in res],
                                   block_scoring=seen)))
    if accs != expect or feas != [a > 0 for a in expect]:
        raise AssertionError(f"batched accuracies {accs} (feasible {feas}) "
                             f"!= recorded {expect}")
    if counts["matern_score"] != len(iters):
        raise AssertionError(f"matern_score launched {counts} times in "
                             f"{len(iters)} batched iterations")
    check_block_scoring("batched", seen, counts, plain, kernels)
    return counts, wall, len(iters)


def breakdown_phase(core):
    """A second batched run with the device synchronised around each part
    of an iteration: GP fit, block scoring (the kernel and the sigma/grad
    terms), refinement, and the host bookkeeping that is left."""
    from repro_torch.core import acquisition, batch_bo, gp

    spent = dict(gp_fit=0.0, block_scoring=0.0, maximize=0.0)

    def timed(name, fn):
        def wrap(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return wrap

    with mock.patch.object(gp, "fit_batch", timed("gp_fit", gp.fit_batch)), \
         mock.patch.object(acquisition, "block_scores",
                           timed("block_scoring", acquisition.block_scores)), \
         mock.patch.object(batch_bo, "maximize_batch",
                           timed("maximize", batch_bo.maximize_batch)):
        t0 = time.perf_counter()
        core.BatchedBayesSplitEdge(batched_scenarios(core)).run()
        total = time.perf_counter() - t0
    parts = dict(gp_fit=spent["gp_fit"], block_scoring=spent["block_scoring"],
                 refinement=spent["maximize"] - spent["block_scoring"])
    parts["host_bookkeeping"] = total - sum(parts.values())
    share = {k: v / total for k, v in parts.items()}
    log("batched_breakdown", json.dumps(dict(wall_s=total, seconds=parts,
                                             share=share)))
    return share


# --------------------------------------------------------------------------
# phase 4b: the whole-run engine
# --------------------------------------------------------------------------

# the reference's cold answers and lane logs on the hetero and LM mixes,
# written and held to the reference by tests/test_torch_wholerun_answers.py
WHOLERUN_EXPECTED = ROOT / "tests" / "data" / "torch_wholerun_expected.json"
ANSWER_KEYS = ("best_accuracy", "feasible", "n_evals")


@contextlib.contextmanager
def syncs_counted():
    """Count the host-device synchronisations in the block (torch's sync
    debug mode warns on each one); yields a dict whose ``n`` is set on
    exit."""
    seen = dict(n=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield seen
        finally:
            torch.cuda.set_sync_debug_mode("default")
            seen["n"] = sum("synchroniz" in str(w.message) for w in caught)


# the 4b runs that phase 7a shards (each run's plain_results): "grid",
# warm and compacted, and "hetero", cold and compacted
WHOLERUN_RESULTS = {}
RESULT_FIELDS = ("n_evals", "best_accuracy", "best_utility", "utilities",
                 "incumbent_trace", "feasible")


def plain_results(results) -> list:
    """Each BOResult's numbers, JSON-ready (best_a as a list or None)."""
    return [dict({f: getattr(r, f) for f in RESULT_FIELDS},
                 best_a=None if r.best_a is None else
                 [float(x) for x in r.best_a]) for r in results]


def answers(results) -> dict:
    return dict(best_accuracy=[r.best_accuracy for r in results],
                feasible=[r.best_a is not None for r in results],
                n_evals=[r.n_evals for r in results])


def results_differ(what, a, b):
    """Raise unless two result lists are equal bit for bit."""
    keys = ("n_evals", "utilities", "accuracies", "feasible",
            "incumbent_trace", "best_utility")
    for i, (ra, rb) in enumerate(zip(a, b)):
        bad = [k for k in keys if getattr(ra, k) != getattr(rb, k)]
        if not np.array_equal(ra.best_a, rb.best_a):
            bad.append("best_a")
        if bad:
            raise AssertionError(f"{what}: scenario {i} differs in {bad}")
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} results against {len(b)}")


def raw_differ(what, a, b, rows, path=""):
    """Raise unless two engines' raw output leaves (``_last_raw``) are
    equal bit for bit in their first ``rows`` rows."""
    for k, v in a.items():
        if isinstance(v, dict):
            raw_differ(what, v, b[k], rows, f"{path}{k}/")
        elif v[:rows].tobytes() != b[k][:rows].tobytes():
            lanes = np.flatnonzero([x.tobytes() != y.tobytes() for x, y
                                    in zip(v[:rows], b[k][:rows])])
            raise AssertionError(f"{what}: leaf {path}{k} differs in "
                                 f"lanes {lanes.tolist()}")


def wholerun_run(core, kernels, what, scs, config):
    """One whole run, launch counts zeroed just before and read just
    after: logs its wall time, iterations, lane log, fit cost, host reads
    and synchronisations, and checks that every block scoring was one
    posterior launch (one an acquisition iteration: every run here has
    at most LANE_WIDTH lanes), that no other kernel and no plain version
    ran."""
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with plain_calls_counted() as plain, block_scoring_watched() as seen, \
            syncs_counted() as syncs:
        eng = core.WholeRunBayesSplitEdge(scs, config)
        res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    lane = eng.lane_stats()
    log("wholerun", json.dumps(dict(
        what=what, wall_s=wall, scenarios=len(scs),
        iterations=sum(e["iters"] for e in lane["lane_log"]),
        acq_iters=lane["acq_iters"], lane_log=lane["lane_log"],
        occupancy_mean=lane["occupancy_mean"],
        host_reads=lane["host_reads"], syncs=syncs["n"],
        fit=eng.fit_cost_stats(), launches=counts, block_scoring=seen,
        **answers(res))))
    if counts["matern_score"] != lane["acq_iters"]:
        raise AssertionError(f"{what}: {counts['matern_score']} "
                             f"matern_score launches in {lane['acq_iters']}"
                             " acquisition iterations")
    others = {k: n for k, n in counts.items() if k != "matern_score" and n}
    if others:
        raise AssertionError(f"{what}: other kernels launched: {others}")
    check_block_scoring(what, seen, counts, plain, kernels)
    return eng, res, counts


def lane_independence():
    """Whether the GP fit's library calls give a lane the same bits at
    every lane count: each op at 16 lanes against the same op on the
    first 1, 4 and 8 lanes. Logged, never failing: the engine runs the
    fit and the acquisition on chunks of exactly LANE_WIDTH lanes
    whatever these calls do (``core/wholerun.py``)."""
    from repro_torch.core import gp
    rng = np.random.default_rng(0)
    S, m = 16, 32
    x = torch.as_tensor(rng.random((S, m, 2)), dtype=torch.float32,
                        device=DEVICE)
    y = torch.as_tensor(rng.random((S, m)), dtype=torch.float32,
                        device=DEVICE)
    mask = torch.ones((S, m), dtype=torch.bool, device=DEVICE)
    theta = gp.init_theta(gp.GPConfig(), (S,), DEVICE)
    K = gp._masked_kernel(x, mask, theta, 1e-3)
    L = torch.linalg.cholesky_ex(K)[0]
    b = y[..., None]
    ops = dict(
        cholesky_ex=lambda k: torch.linalg.cholesky_ex(K[:k])[0],
        cholesky_solve=lambda k: torch.cholesky_solve(b[:k], L[:k]),
        solve_triangular=lambda k: torch.linalg.solve_triangular(
            L[:k], b[:k], upper=False),
        matmul=lambda k: K[:k] @ b[:k],
        mll_grad=lambda k: gp._mll_grad({n: v[:k] for n, v in theta.items()},
                                        x[:k], y[:k], mask[:k], 1e-3
                                        )["log_ls"],
        fit_batch=lambda k: gp.fit_batch(
            dict(x=x[:k], y=y[:k], mask=mask[:k]),
            gp.GPConfig())["theta"]["log_ls"])
    same = {}
    for name, op in ops.items():
        full = op(S)
        same[name] = {k: bool(torch.equal(op(k), full[:k]))
                      for k in (1, 4, 8)}
    log("lane_independence", json.dumps(dict(
        lanes=S, points=m, equal_to_16_lanes=same)))


def wholerun_phase(core, kernels):
    """The whole-run engine: the 16-scenario grid warm (the main path)
    and cold, compacted against uncompacted; the hetero and LM mixes
    against the reference's answers, compacted, packed and in shards; and
    the prior bank's contracts."""
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.core.priorbank import PriorBank
    from repro_torch.wireless.traces import MIXED_TRACE_ARCHS

    t_phase = time.perf_counter()
    bench = json.loads((ROOT / "benchmarks" / "artifacts"
                        / "BENCH_bo_engine.json").read_text())
    expect = bench["accuracies"]["wholerun"]
    want = json.loads(WHOLERUN_EXPECTED.read_text())
    if tuple(want["lm"]["archs"]) != MIXED_TRACE_ARCHS:
        raise AssertionError(f"LM mix {want['lm']['archs']} is not "
                             f"{MIXED_TRACE_ARCHS}")
    if list(map(dict, want["hetero"]["lane_log"])) != bench["hetero"][
            "compaction_lane_log"]:
        raise AssertionError("the hetero lane log of the expected answers "
                             "is not BENCH_bo_engine.json's")
    cold = EngineConfig(warm_start=False)
    cold_u = EngineConfig(warm_start=False, compact=False)
    lane_independence()

    # the grid, warm and compacted (the defaults): the main path
    scs = batched_scenarios(core)
    _, res, counts = wholerun_run(core, kernels, "grid", scs, None)
    WHOLERUN_RESULTS["grid"] = plain_results(res)
    accs = [r.best_accuracy for r in res]
    feas = [r.best_a is not None for r in res]
    if accs != expect or feas != [a > 0 for a in expect]:
        raise AssertionError(f"whole-run accuracies {accs} (feasible "
                             f"{feas}) != recorded {expect}")

    # the grid, cold: compacted against uncompacted, every output leaf
    e_c, r_c, _ = wholerun_run(core, kernels, "grid cold", scs, cold)
    e_u, r_u, _ = wholerun_run(core, kernels, "grid cold uncompacted", scs,
                               cold_u)
    raw_differ("grid cold compacted vs uncompacted", e_c._last_raw,
               e_u._last_raw, len(scs))
    results_differ("grid cold compacted vs uncompacted", r_c, r_u)

    # the hetero and LM mixes against the reference's answers
    for name in ("hetero", "lm"):
        mix = want[name]

        def mk(mix=mix):
            return core.make_hetero_scenarios(
                seeds=mix["seeds"], budgets=mix["budgets"],
                archs=mix["archs"])
        runs = dict(compacted=wholerun_run(core, kernels, f"{name} cold",
                                           mk(), cold))
        if name == "hetero":
            runs["uncompacted"] = wholerun_run(
                core, kernels, f"{name} cold uncompacted", mk(), cold_u)
            runs["packed"] = wholerun_run(
                core, kernels, f"{name} cold packed", mk(),
                EngineConfig(warm_start=False, pack=True))
        eng, res, _ = runs["compacted"]
        if name in MESH_WHOLERUN:
            WHOLERUN_RESULTS[name] = plain_results(res)
        got = answers(res)
        lane_log = eng.lane_stats()["lane_log"]
        log("wholerun_answers", json.dumps(dict(
            mix=name, lane_log=lane_log, reference_lane_log=mix["lane_log"],
            answers=got, reference={k: mix[k] for k in ANSWER_KEYS})))
        if got != {k: mix[k] for k in ANSWER_KEYS}:
            raise AssertionError(f"{name}: answers {got} are not the "
                                 "reference's")
        if lane_log != mix["lane_log"]:
            raise AssertionError(f"{name}: lane log {lane_log} is not the "
                                 f"reference's {mix['lane_log']}")
        ref_eng, ref_res, _ = runs.get("uncompacted", runs["compacted"])
        for how, (e, r, _) in runs.items():
            if e is not ref_eng:
                raw_differ(f"{name} {how}", e._last_raw, ref_eng._last_raw,
                           len(r))
                results_differ(f"{name} {how}", r, ref_res)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        shards = core.run_packed_shards(mk(), n_shards=2, config=cold)
        torch.cuda.synchronize()
        log("wholerun", json.dumps(dict(
            what=f"{name} cold run_packed_shards(n_shards=2)",
            wall_s=time.perf_counter() - t0,
            launches=kernels.launch_counts(), **answers(shards))))
        results_differ(f"{name} run_packed_shards", shards, ref_res)

    # the prior bank, in memory (tests/test_priorbank.py's set and config)
    def bank_scens(budgets=(6, 8)):
        return [core.Scenario(core.default_vgg19_problem(), seed=s,
                              budget=b) for s in (0, 1) for b in budgets]

    def run(scens, bank=None):
        return core.WholeRunBayesSplitEdge(scens, cold, bank=bank).run()

    base = run(bank_scens())
    bank = PriorBank()
    results_differ("empty bank", run(bank_scens(), bank), base)
    never = PriorBank()
    run(bank_scens((20,)), never)
    results_differ("never-hitting bank", run(bank_scens((6,)),
                                             never.freeze()),
                   run(bank_scens((6,))))
    warm = run(bank_scens(), bank.freeze())

    def evals_to(r, target):
        hit = np.flatnonzero(np.asarray(r.incumbent_trace) >= target - 1e-9)
        return int(hit[0]) + 1 if hit.size else len(r.incumbent_trace) + 1

    transfer = [dict(cold=c.best_utility, bank=w.best_utility,
                     evals_cold=evals_to(c, c.best_utility),
                     evals_bank=evals_to(w, c.best_utility))
                for c, w in zip(base, warm)]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        bank.save(d)
        back = PriorBank.load(d)
    tree, tree_back = bank.state_tree(), back.state_tree()
    roundtrip = (set(tree) == set(tree_back)
                 and all(tree[k].dtype == tree_back[k].dtype
                         and tree[k].tobytes() == tree_back[k].tobytes()
                         for k in tree))
    log("wholerun_bank", json.dumps(dict(
        stats=bank.stats(), never_hitting=never.stats(), transfer=transfer,
        save_load_roundtrip=roundtrip)))
    if bank.hits < len(base):
        raise AssertionError(f"the frozen bank hit {bank.hits} times in "
                             f"{len(base)} scenarios")
    for i, t in enumerate(transfer):
        if t["bank"] < t["cold"] - 1e-9 or t["evals_bank"] > t["evals_cold"]:
            raise AssertionError(f"bank scenario {i} did worse than cold: "
                                 f"{t}")
    if never.hits:
        raise AssertionError(f"the never-hitting bank hit: {never.stats()}")
    if not roundtrip:
        raise AssertionError("PriorBank save/load changed its state_tree")
    log("wholerun_phase", json.dumps(dict(
        seconds=time.perf_counter() - t_phase)))
    return counts


# --------------------------------------------------------------------------
# phase 4c: the streaming server
# --------------------------------------------------------------------------

# the reference's stream answers on (a) and (b), written and held to the
# reference by tests/test_torch_stream_answers.py
STREAM_EXPECTED = ROOT / "tests" / "data" / "torch_stream_expected.json"
QUANTUM = 100.0 / 64.0              # one accuracy quantum (parity level 3)
WARM_TRACE_TOL = 0.5                # the reference's warm trace bound
STREAM_OUT_KEYS = ("ev_u", "ev_acc", "ev_feas", "ev_trace", "ev_l", "n",
                   "best_a", "best_u", "has_best", "fit_steps", "fit_calls",
                   "fault")         # wholerun._OUT_KEYS but the lane's gen


def trace_div(a, b) -> float:
    m = min(len(a), len(b))
    if m == 0:
        return 0.0
    return float(np.max(np.abs(np.asarray(a[:m]) - np.asarray(b[:m]))))


def stream_launches(what, kernels, engines, seen, plain):
    """The launch rules of a stream run: one posterior launch a
    LANE_WIDTH chunk of an acquisition iteration (the engines'
    ``acq_chunks``), every block scoring one of them, no other kernel and
    no plain version."""
    counts = kernels.launch_counts()
    chunks = sum(e._counters["acq_chunks"] for e in engines)
    if counts["matern_score"] != chunks:
        raise AssertionError(f"{what}: {counts['matern_score']} "
                             f"matern_score launches for {chunks} chunks "
                             "of acquisition iterations")
    others = {k: n for k, n in counts.items() if k != "matern_score" and n}
    if others:
        raise AssertionError(f"{what}: other kernels launched: {others}")
    check_block_scoring(what, seen, counts, plain, kernels)
    return counts


def stream_line(what, wall, engines, results, counts, syncs, seen):
    """The ``stream`` line of one run (``engines``: the server, or a
    killed server and the one resumed from its checkpoint)."""
    st = engines[-1].stream_stats()
    c = {k: sum(e._counters[k] for e in engines)
         for k in engines[-1]._counters}
    log("stream", json.dumps(dict(
        what=what, wall_s=wall, serve_wall_s=st["wall_s"],
        results=len(results), arrivals_per_s=len(results) / wall,
        dispatches=st["n_dispatches"], rounds=st["rounds"],
        lane_log=[[e["lanes"], e["live"], e["bucket"], e["iters"],
                   e["acq_iters"], e["chunks"]] for e in st["lane_log"]],
        lane_log_keys=["lanes", "live", "bucket", "iters", "acq_iters",
                       "chunks"],
        occupancy_mean=st["occupancy_mean"],
        queue_depth_mean=st["queue_depth_mean"],
        queue_depth_max=st["queue_depth_max"],
        acq_iters=c["acq_iters"], acq_chunks=c["acq_chunks"],
        chunks_per_acq_iter=(c["acq_chunks"] / c["acq_iters"]
                             if c["acq_iters"] else 0.0),
        host_reads=st["host_reads"], syncs=syncs["n"],
        launches=counts, block_scoring=seen,
        faults={k: c[k] for k in ("n_faults", "n_requeued", "n_degraded",
                                  "n_checkpoints")})))


def stream_run(core, kernels, what, make_feed, config, **kw):
    """One stream (``kill_at`` set: a run killed at that round, resumed
    from its checkpoint and deduped), launch counts zeroed just before
    and read just after; logs its ``stream`` line and holds the launch
    rules. Returns ``(results by request, engines)``."""
    from repro_torch.runtime.chaos import FaultInjector, SimulatedCrash
    from repro_torch.runtime.stream import (StreamingBayesSplitEdge,
                                            dedup_results)

    kill_at = kw.pop("kill_at", None)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with plain_calls_counted() as plain, block_scoring_watched() as seen, \
            syncs_counted() as syncs, \
            tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        if kill_at is None:
            engines = [StreamingBayesSplitEdge(make_feed(), config, **kw)]
            got = list(engines[0].serve())
        else:
            ch = FaultInjector(seed=0, kill_at=[kill_at])
            engines = [StreamingBayesSplitEdge(
                make_feed(), config, chaos=ch, ckpt_dir=ckpt, ckpt_every=1,
                **kw)]
            got = []
            try:
                for r in engines[0].serve():
                    got.append(r)
            except SimulatedCrash:
                pass
            else:
                raise AssertionError(f"{what}: the kill at round "
                                     f"{kill_at} never fired")
            engines.append(StreamingBayesSplitEdge.resume(
                ckpt, make_feed(), config=config))
            got = dedup_results(got + list(engines[1].serve()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = stream_launches(what, kernels, engines, seen, plain)
    stream_line(what, wall, engines, got, counts, syncs, seen)
    return {r.index: r for r in got}, engines


def stream_results_differ(what, got, ref):
    """Raise unless two streams' results are equal bit for bit, request
    by request."""
    if sorted(got) != sorted(ref):
        raise AssertionError(f"{what}: requests {sorted(got)} against "
                             f"{sorted(ref)}")
    results_differ(what, [got[i].result for i in sorted(got)],
                   [ref[i].result for i in sorted(ref)])


def warm_agree(what, got, ref):
    """Equal eval counts and accuracies, incumbent traces within
    WARM_TRACE_TOL (the reference's warm contract); returns the largest
    trace divergence."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        d = trace_div(a.incumbent_trace, b.incumbent_trace)
        worst = max(worst, d)
        if (a.n_evals != b.n_evals or a.best_accuracy != b.best_accuracy
                or d >= WARM_TRACE_TOL):
            raise AssertionError(
                f"{what}: request {i}: n_evals {a.n_evals}/{b.n_evals}, "
                f"accuracy {a.best_accuracy}/{b.best_accuracy}, trace "
                f"divergence {d}")
    return worst


def stream_phase(core, kernels):
    """Phase 4c: the streaming server. (a) the hetero mix through 8 lanes,
    cold against the cold uncompacted whole run (every output leaf) and
    the reference's answers, warm against the warm compacted whole run;
    (b) the 128-arrival mixed CNN + LM trace, warm, through 8 and 64
    lanes; (c) chaos, cold: kill at round 2 and resume, and a NaN poison
    at round 2, each against the fault-free run bit for bit. Returns the
    matern_score launches by run."""
    from repro_torch.core import wholerun as wr
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.runtime.chaos import FaultInjector
    from repro_torch.runtime.stream import requests_from_trace
    from repro_torch.wireless.traces import MIXED_TRACE_ARCHS, arrival_trace

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    want = json.loads(STREAM_EXPECTED.read_text())
    cold = EngineConfig(warm_start=False)
    by_run = {}

    def run(what, make_feed, config, **kw):
        got, engines = stream_run(core, kernels, what, make_feed, config,
                                  **kw)
        by_run[what] = sum(e._counters["acq_chunks"] for e in engines)
        return got, engines

    # (a) the hetero mix through 8 lanes
    ha = want["hetero"]

    def hetero():
        return core.make_hetero_scenarios(seeds=ha["seeds"],
                                          budgets=ha["budgets"],
                                          archs=ha["archs"])
    got, (eng,) = run("hetero cold, 8 lanes", hetero, cold,
                      n_lanes=ha["n_lanes"])
    offline = core.WholeRunBayesSplitEdge(
        hetero(), EngineConfig(warm_start=False, compact=False))
    off_res = offline.run()
    results_differ("hetero cold stream vs uncompacted whole run",
                   [got[i].result for i in sorted(got)], off_res)
    for i, r in got.items():
        bad = [k for k in STREAM_OUT_KEYS
               if r.raw[k].tobytes() != offline._last_raw[k][i].tobytes()]
        if bad:
            raise AssertionError(f"hetero cold stream: request {i} differs "
                                 f"from the whole run in {bad}")
    res = [got[i].result for i in sorted(got)]
    lane_log = [[e["lanes"], e["live"], e["bucket"], e["iters"]]
                for e in eng.stream_stats()["lane_log"]]
    divs = [trace_div(r.incumbent_trace, t)
            for r, t in zip(res, ha["incumbent_trace"])]
    mine = answers(res)
    log("stream_answers", json.dumps(dict(
        run="hetero cold, 8 lanes", answers=mine, lane_log=lane_log,
        reference={k: ha[k] for k in ANSWER_KEYS},
        reference_lane_log=ha["lane_log"],
        max_trace_divergence=max(divs))))
    if mine != {k: ha[k] for k in ANSWER_KEYS} or lane_log != ha["lane_log"]:
        raise AssertionError("hetero cold stream: answers or lane log are "
                             "not the reference's")
    if max(divs) > QUANTUM:
        raise AssertionError(f"hetero cold stream: incumbent traces "
                             f"{max(divs)} from the reference's")
    got_w, _ = run("hetero warm, 8 lanes", hetero, None,
                   n_lanes=ha["n_lanes"])
    warm_off = core.WholeRunBayesSplitEdge(hetero()).run()
    worst = warm_agree("hetero warm stream vs warm compacted whole run",
                       [got_w[i].result for i in sorted(got_w)], warm_off)
    log("stream_warm", json.dumps(dict(
        run="hetero warm, 8 lanes", max_trace_divergence=worst,
        tolerance=WARM_TRACE_TOL)))

    # (b) the mixed CNN + LM trace at two pool widths
    tw = want["trace"]
    tr = arrival_trace(**{k: tw[k] for k in ("kind", "n", "seed",
                                              "budgets", "archs")})
    if tuple(tw["archs"]) != MIXED_TRACE_ARCHS:
        raise AssertionError(f"trace archs {tw['archs']} are not "
                             f"{MIXED_TRACE_ARCHS}")
    widths = {}
    for lanes in (8, 64):
        g, _ = run(f"trace warm, {lanes} lanes",
                   lambda: requests_from_trace(tr), None, n_lanes=lanes,
                   l_pad=tw["l_pad"], budget_max=tw["budget_max"])
        widths[lanes] = [g[i].result for i in sorted(g)]
    worst = warm_agree("trace: 64 lanes vs 8", widths[64], widths[8])
    r8 = widths[8]
    acc = [r.best_accuracy for r in r8]
    feas = [r.best_a is not None for r in r8]
    n_diff = [i for i, r in enumerate(r8) if r.n_evals != tw["n_evals"][i]]
    ref_div = max(trace_div(r.incumbent_trace, t)
                  for r, t in zip(r8, tw["incumbent_trace"]))
    log("stream_trace", json.dumps(dict(
        widths_max_trace_divergence=worst,
        reference_accuracy_equal=acc == tw["best_accuracy"],
        reference_feasible_equal=feas == tw["feasible"],
        reference_n_evals_differ=n_diff,
        reference_max_trace_divergence=ref_div)))
    if acc != tw["best_accuracy"] or feas != tw["feasible"]:
        raise AssertionError("trace warm, 8 lanes: quantized answers are "
                             "not the reference's")

    # (c) chaos, cold: the 16 VGG19 requests of tests/test_chaos.py
    def reqs16():
        return [core.scenario_from_request("vgg19", (-1) ** i * 1.5,
                                           (6, 8, 10)[i % 3], i)
                for i in range(16)]
    ref, _ = run("chaos fault-free, 4 lanes", reqs16, cold, n_lanes=4)
    killed, _ = run("chaos kill at round 2, resumed", reqs16, cold,
                    n_lanes=4, kill_at=2)
    stream_results_differ("kill/resume vs fault-free", killed, ref)
    ch = FaultInjector(seed=1, nan_poison_at=[2])
    poisoned, (eng,) = run("chaos NaN poison at round 2", reqs16, cold,
                           n_lanes=4, chaos=ch)
    st = eng.stream_stats()
    if not any(e["kind"] == "nan_poison" for e in ch.events):
        raise AssertionError(f"the NaN poison never fired: {ch.events}")
    if st["n_faults"] < 1 or st["n_requeued"] < 1 or st["n_degraded"]:
        raise AssertionError(f"NaN poison: faults {st['n_faults']}, "
                             f"requeued {st['n_requeued']}, degraded "
                             f"{st['n_degraded']}")
    stream_results_differ("NaN-poison requeue vs fault-free", poisoned, ref)
    log("stream_phase", json.dumps(dict(
        seconds=time.perf_counter() - t_phase, lane_width=wr.LANE_WIDTH,
        launches_by_run=by_run)))
    return by_run


# --------------------------------------------------------------------------
# phase 4d: the fleet
# --------------------------------------------------------------------------

# benchmarks/bench_engine.py's run_fleet: 2 workers x 4 lanes against the
# 8-lane single host; the lossy run's trace, fleet and network faults
FLEET_WORKERS, FLEET_LANES = 2, 4
FLEET_TRACE = dict(kind="bursty", n=16, seed=0, budgets=(6, 10, 14, 20),
                   deadline_slack=(2.0, 8.0))
FLEET_TRACE_KW = dict(n_workers=FLEET_WORKERS, n_lanes=FLEET_LANES,
                      dt_s=0.05, request_timeout=24.0, max_attempts=5)
FLEET_CHAOS = dict(seed=3, drop_rate=0.05, dup_rate=0.05, reorder_rate=0.2,
                   delay_max=2, partition_at=[(8, "w0", "router")],
                   heal_at=[(24, "*", "*")])
FLEET_HIT_RATE_FLOOR = 0.9          # lossy hit rate over the fault-free one


def fleet_run(kernels, what, make_router):
    """One simulated fleet on the card (``sim_fleet``: the router drives
    its workers in one thread), launch counts zeroed just before and read
    just after: logs its ``fleet`` line (wall time, router cycles, the
    transport's sent/delivered/dropped/duplicated counts, retries,
    timeouts, dispatches, acquisition iterations and LANE_WIDTH chunks,
    host reads, synchronisations) and holds the stream's launch rules
    over the workers' engines. Returns ``(router, {index: the emitted
    StreamResult})``."""
    from repro_torch.core import wholerun as wr

    kernels.reset_launch_counts()
    reads0 = wr._counts["host_reads"]
    t0 = time.perf_counter()
    with plain_calls_counted() as plain, block_scoring_watched() as seen, \
            syncs_counted() as syncs:
        rt = make_router()
        emitted = []
        rt.on_result = emitted.append
        rt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engines = [w.eng for w in rt._drive]
    counts = stream_launches(what, kernels, engines, seen, plain)
    st = rt.fleet_stats()
    log("fleet", json.dumps(dict(
        what=what, wall_s=wall, results=len(emitted), cycles=st["cycles"],
        transport=st["transport"], retries=st["n_retries"],
        timeouts=st["n_timeouts"], dup_results=st["n_dup_results"],
        degraded=st["n_degraded"], undeliverable=st["n_undeliverable"],
        workers_dead=st["workers_dead"],
        deadline_hit_rate=st["deadline_hit_rate"],
        dispatches=sum(w.counters["n_dispatches"] for w in rt._drive),
        workers={w.name: w.counters for w in rt._drive},
        acq_iters=sum(e._counters["acq_iters"] for e in engines),
        acq_chunks=sum(e._counters["acq_chunks"] for e in engines),
        host_reads=wr._counts["host_reads"] - reads0, syncs=syncs["n"],
        launches=counts, block_scoring=seen)))
    indices = [r.index for r in emitted]
    if len(indices) != len(set(indices)):
        raise AssertionError(f"{what}: the router emitted a request twice")
    return rt, {r.index: r for r in emitted}


def fleet_phase(core, kernels):
    """Phase 4d: the fleet (``runtime/fleet.py``) on the card. (a)
    zero-fault: 2 workers x 4 lanes over the hetero mix, cold, equal to
    the 8-lane single-host stream (phase 4c's first run, run again here)
    in every result leaf, and so to the reference's answers; (b) lossy: 5 % drop,
    5 % duplication, reordering, delay and one partition/heal cycle over a
    bursty deadlined trace, every request exactly once, the deadline hit
    rate at least FLEET_HIT_RATE_FLOOR of the fault-free fleet's, and
    every answer the fault-free fleet's bit for bit. Returns the
    matern_score launches by run."""
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.runtime.chaos import NetworkChaos
    from repro_torch.runtime.fleet import sim_fleet
    from repro_torch.runtime.stream import requests_from_trace
    from repro_torch.wireless.traces import arrival_trace

    t_phase = time.perf_counter()
    want = json.loads(STREAM_EXPECTED.read_text())["hetero"]
    cold = EngineConfig(warm_start=False)
    by_run = {}

    def run(what, make_router):
        rt, got = fleet_run(kernels, what, make_router)
        by_run[what] = sum(w.eng._counters["acq_chunks"] for w in rt._drive)
        return rt, got

    def hetero():
        return core.make_hetero_scenarios(seeds=want["seeds"],
                                          budgets=want["budgets"],
                                          archs=want["archs"])

    # (a) zero-fault, against the single host bit for bit
    if FLEET_WORKERS * FLEET_LANES != want["n_lanes"]:
        raise AssertionError("the fleet's lanes are not the single host's")
    single, _ = stream_run(core, kernels, "hetero cold, 8 lanes (4d's "
                           "single host)", hetero, cold,
                           n_lanes=want["n_lanes"])
    what = f"zero-fault, {FLEET_WORKERS} x {FLEET_LANES} lanes, hetero cold"
    rt, got = run(what, lambda: sim_fleet(
        hetero(), n_workers=FLEET_WORKERS, config=cold, n_lanes=FLEET_LANES,
        device=DEVICE))
    st = rt.fleet_stats()
    if st["n_retries"] or st["n_degraded"] or st["transport"]["dropped"]:
        raise AssertionError(f"{what}: faults in a zero-fault run: {st}")
    stream_results_differ(f"{what} vs the single host", got, single)
    for i, r in got.items():
        bad = [k for k in STREAM_OUT_KEYS
               if r.raw[k].tobytes() != single[i].raw[k].tobytes()]
        if bad:
            raise AssertionError(f"{what}: request {i} differs from the "
                                 f"single host in {bad}")
    res = [got[i].result for i in sorted(got)]
    divs = [trace_div(r.incumbent_trace, t)
            for r, t in zip(res, want["incumbent_trace"])]
    mine = answers(res)
    log("fleet_answers", json.dumps(dict(
        run=what, equal_to_single_host=True, answers=mine,
        reference={k: want[k] for k in ANSWER_KEYS},
        max_trace_divergence=max(divs))))
    if mine != {k: want[k] for k in ANSWER_KEYS} or max(divs) > QUANTUM:
        raise AssertionError(f"{what}: answers are not the reference's")

    # (b) a lossy network over a bursty deadlined trace
    tr = arrival_trace(**FLEET_TRACE)

    def trace_fleet(chaos=None):
        return sim_fleet(requests_from_trace(tr), config=cold,
                         arrivals=tr["t"], chaos=chaos, device=DEVICE,
                         **FLEET_TRACE_KW)
    rt_ff, ff = run("fault-free, bursty trace", trace_fleet)
    chaos = NetworkChaos(**FLEET_CHAOS)
    rt_l, lossy = run("lossy, bursty trace", lambda: trace_fleet(chaos))
    ff_hit = rt_ff.fleet_stats()["deadline_hit_rate"]
    st = rt_l.fleet_stats()
    kinds = [e["kind"] for e in chaos.events]
    log("fleet_lossy", json.dumps(dict(
        requests=tr["n"], exactly_once=sorted(lossy) == list(range(tr["n"])),
        faultfree_hit_rate=ff_hit, lossy_hit_rate=st["deadline_hit_rate"],
        floor=FLEET_HIT_RATE_FLOOR, chaos_events=len(chaos.events),
        partitions=kinds.count("partition"), heals=kinds.count("heal"),
        transport=st["transport"])))
    if sorted(lossy) != list(range(tr["n"])):
        raise AssertionError(f"lossy fleet: requests {sorted(lossy)} are "
                             "not each emitted exactly once")
    if st["transport"]["dropped"] == 0 or "heal" not in kinds:
        raise AssertionError(f"lossy fleet: the faults did not fire: {st}")
    if st["deadline_hit_rate"] < FLEET_HIT_RATE_FLOOR * ff_hit:
        raise AssertionError(f"lossy fleet: hit rate "
                             f"{st['deadline_hit_rate']} < "
                             f"{FLEET_HIT_RATE_FLOOR} x {ff_hit}")
    served = {i: r for i, r in lossy.items() if not r.degraded}
    stream_results_differ("lossy fleet vs fault-free (served requests)",
                          served, {i: ff[i] for i in served})
    log("fleet_phase", json.dumps(dict(
        seconds=time.perf_counter() - t_phase, launches_by_run=by_run)))
    return by_run


# --------------------------------------------------------------------------
# phase 4e: Table 1
# --------------------------------------------------------------------------

# the reference's nine rows, sequential and batched, and its PPO draws,
# written and held to the reference by tests/test_torch_table1_answers.py
TABLE1_EXPECTED = ROOT / "tests" / "data" / "torch_table1_expected.json"


def table1_phase(kernels):
    """Phase 4e: the nine rows of Table 1 on the card
    (``benchmarks/table1_torch.py``) sequentially, and the two BO rows
    through the batched engine (the seven other rows are the same code in
    both modes), each held to the reference's row by
    ``table1_torch.mismatches`` (the host rows exactly, the BO rows at
    parity level 3, PPO on the reference's draws within
    ``PPO_POWER_TOL``), with its wall time. On the BO rows every block
    scoring is one posterior launch with no triangular solve; the other
    rows launch no kernel. Returns the BO rows' matern_score launches and
    the sequential rows (``table1_torch.table``'s), from which phase 4f
    builds Figs 6 and 7."""
    from benchmarks import table1_torch as t1

    t_phase = time.perf_counter()
    want = json.loads(TABLE1_EXPECTED.read_text())
    by_run, sequential = {}, []
    for mode in ("sequential", "batched"):
        for name in want["rows"]:
            if mode == "batched" and name not in t1.BO_ROWS:
                continue
            what = f"{mode}: {name}"
            kernels.reset_launch_counts()
            with plain_calls_counted() as plain, \
                    block_scoring_watched() as seen, syncs_counted() as syncs:
                ((_, pb, res, wall),) = t1.table(
                    want["seed"], batched=mode == "batched", device=DEVICE,
                    ppo_draws=want["ppo_draws"], rows=[name])
            counts = kernels.launch_counts()
            if mode == "sequential":
                sequential.append((name, pb, res, wall))
            got = t1.answers(name, pb, res)
            ref = next(r for r in want[mode] if r["algorithm"] == name)
            bad = t1.mismatches(got, ref)
            line = dict(mode=mode, row=name, wall_s=wall,
                        **{k: got[k] for k in ("n_evals", "split_layer",
                                               "power_w", "best_accuracy",
                                               "feasible")},
                        reference={k: ref[k] for k in (
                            "n_evals", "split_layer", "power_w",
                            "best_accuracy", "feasible")},
                        mismatches=bad, syncs=syncs["n"], launches=counts,
                        block_scoring=seen)
            if name == t1.PPO_ROW:
                line["max_power_diff_w"] = max(
                    abs(a - b) for a, b in zip(got["eval_powers_w"],
                                               ref["eval_powers_w"]))
                line["power_tol_w"] = t1.PPO_POWER_TOL
            log("table1", json.dumps(line))
            if bad:
                raise AssertionError(f"table1 {what}: {bad} are not the "
                                     "reference's")
            if name in t1.BO_ROWS:
                if counts["matern_score"] == 0:
                    raise AssertionError(f"table1 {what}: no posterior "
                                         "launch")
                check_block_scoring(f"table1 {what}", seen, counts, plain,
                                    kernels)
                by_run[what] = counts["matern_score"]
            elif any(counts.values()) or any(plain.values()):
                raise AssertionError(f"table1 {what}: launched {counts}, "
                                     f"plain versions {plain}")
    log("table1_phase", json.dumps(dict(
        seconds=time.perf_counter() - t_phase, launches_by_run=by_run)))
    return by_run, sequential


# --------------------------------------------------------------------------
# phase 4f: the paper's figures
# --------------------------------------------------------------------------

# the reference's answers, written and held to the reference by
# tests/test_torch_figures_{paper,regret,ablation}.py
FIGURES_EXPECTED = {name: ROOT / "tests" / "data" /
                    f"torch_figures_{name}_expected.json"
                    for name in ("paper", "regret", "ablation")}


def figure_run(kernels, what, run, bo=True):
    """One figure's run with the launch counters zeroed around it: its
    output, every BO run's final (``finals_recorded``) and a dict of
    wall seconds, evaluations, synchronisations and launches. A BO
    figure's block scorings are each one posterior launch with no
    triangular solve and no plain version; a host figure launches
    nothing."""
    from benchmarks import table1_torch as t1
    from repro_torch.core import bo as bo_mod

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with plain_calls_counted() as plain, block_scoring_watched() as seen, \
            syncs_counted() as syncs, t1.finals_recorded(bo_mod) as finals:
        out = run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    stats = dict(wall_s=wall, bo_runs=len(finals),
                 evaluations=sum(f["n_evals"] for f in finals),
                 syncs=syncs["n"], posterior_launches=counts["matern_score"],
                 block_scoring=seen, launches=counts)
    if bo:
        if counts["matern_score"] == 0:
            raise AssertionError(f"figure {what}: no posterior launch")
        check_block_scoring(f"figure {what}", seen, counts, plain, kernels)
    elif any(counts.values()) or any(plain.values()):
        raise AssertionError(f"figure {what}: launched {counts}, plain "
                             f"versions {plain}")
    return out, finals, stats


def figures_phase(kernels, table1_rows, names):
    """Phase 4f: the paper's figures on the card, each held to the
    reference's answers by its script's ``mismatches``, a ``figure``
    line each: Figs 2-4 (host numbers); Figs 6 and 7 built from phase
    4e's sequential Table 1 runs (``table1_rows``: the same calls), with
    their host-only methods, grid and band run here; Fig 8
    ``--mixed-arch``, Fig 9 ``--batched`` and Fig 10 ``--batched`` at the
    reference's default seeds (3, 3, 10); trace robustness (5 frames).
    The sequential modes of Figs 8-10 are held on the CPU only
    (``tests/test_torch_figures_{regret,ablation}.py``). Every line is
    logged before a figure that disagrees fails the phase. Runs the
    figures in ``names`` (``table1_rows`` may be None without Figs 6 and
    7). Returns the posterior launches by figure."""
    from benchmarks import fig6_convergence_torch as fig6
    from benchmarks import fig7_space_torch as fig7
    from benchmarks import fig8_regret_torch as fig8
    from benchmarks import fig9_ablation_torch as fig9
    from benchmarks import fig10_seeds_torch as fig10
    from benchmarks import profiling_torch as profiling
    from benchmarks import table1_torch as t1
    from benchmarks import trace_robustness_torch as trace

    t_phase = time.perf_counter()
    paper = json.loads(FIGURES_EXPECTED["paper"].read_text())
    regret = json.loads(FIGURES_EXPECTED["regret"].read_text())
    ablation = json.loads(FIGURES_EXPECTED["ablation"].read_text())
    draws = json.loads(TABLE1_EXPECTED.read_text())["ppo_draws"]
    # (name, module, run, expected answers, answers takes the finals,
    # BO runs inside the run); Figs 6 and 7 take their rule's card form
    # (``fig6_convergence_torch.CARD_LEVEL3``)
    figures = [
        ("fig2-4", profiling, profiling.run, paper["profiling"], False,
         False),
        ("fig6", fig6, lambda: fig6.run(0, DEVICE, draws, table1_rows),
         paper["fig6"], False, False),
        ("fig7", fig7, lambda: fig7.run(0, DEVICE, draws, table1_rows),
         paper["fig7"], False, False),
        ("fig8 --mixed-arch", fig8,
         lambda: fig8.run(regret["mixed_arch"]["seeds"], mixed_arch=True,
                          device=DEVICE),
         regret["mixed_arch"]["answers"], True, True),
        ("fig9 --batched", fig9,
         lambda: fig9.run(ablation["fig9"]["batched"]["seeds"],
                          batched=True, device=DEVICE),
         ablation["fig9"]["batched"]["answers"], True, True),
        ("fig10 --batched", fig10,
         lambda: fig10.run(ablation["fig10"]["batched"]["seeds"],
                           batched=True, device=DEVICE),
         ablation["fig10"]["batched"]["answers"], True, True),
        ("trace_robustness", trace, lambda: trace.run(device=DEVICE),
         paper["trace_robustness"], False, True),
    ]
    by_run, failed = {}, {}
    unknown = set(names) - {f[0] for f in figures}
    if unknown:
        raise ValueError(f"no figure {sorted(unknown)}")
    for what, mod, run, want, with_finals, bo in figures:
        if what not in names:
            continue
        out, finals, stats = figure_run(kernels, what, run, bo)
        got = mod.answers(out, finals) if with_finals else mod.answers(out)
        bad = (mod.mismatches(got, want, on_card=True)
               if mod in (fig6, fig7) else mod.mismatches(got, want))
        log("figure", json.dumps(dict(
            figure=what, **stats, mismatches=bad,
            tolerances=getattr(mod, "TOL", {}),
            deviations=t1.deviations(got, want),
            bo_runs_from="phase 4e (table1 sequential)"
            if what in ("fig6", "fig7") else "this run")))
        if bad:
            failed[what] = bad
        if bo:
            by_run[what] = stats["posterior_launches"]
    log("figures_phase", json.dumps(dict(
        seconds=time.perf_counter() - t_phase, launches_by_run=by_run)))
    if failed:
        raise AssertionError(f"figures not held to the reference's "
                             f"answers: {failed}")
    return by_run


# --------------------------------------------------------------------------
# phases 4b-4f side by side
# --------------------------------------------------------------------------

# The BO phases wait on the host between small launches, so each group
# runs in a process of its own on the one card while the parent waits.
# The groups are near even in time: 4e takes Table 1 with the figures
# built from its runs and Fig 10, 4f the other BO figures.
HOST_FIGURES = ("fig2-4", "fig6", "fig7", "fig10 --batched")
BO_FIGURES = ("fig8 --mixed-arch", "fig9 --batched", "trace_robustness")
BO_GROUPS = ("4b", "4c", "4d", "4e", "4f")


def bo_group(group, core, kernels) -> dict:
    """Run one of ``BO_GROUPS`` in this process: the matern_score
    launches by path (the keys of the ``kernels`` line's
    ``launches_by_path``)."""
    if group == "4b":
        return {"wholerun": wholerun_phase(core, kernels)["matern_score"]}
    if group == "4c":
        runs = {"stream": stream_phase(core, kernels)}
    elif group == "4d":
        runs = {"fleet": fleet_phase(core, kernels)}
    elif group == "4e":
        table1, rows = table1_phase(kernels)
        runs = {"table1": table1,
                "figures": figures_phase(kernels, rows, HOST_FIGURES)}
    elif group == "4f":
        runs = {"figures": figures_phase(kernels, None, BO_FIGURES)}
    else:
        raise ValueError(f"no BO group {group!r}")
    return {f"{path}:{what}": n for path, by_run in runs.items()
            for what, n in by_run.items()}


def bo_child(group: str, out: str) -> int:
    """A group's process: TF32 off as in phase 1, the group run, its
    launches by path, seconds and posterior shapes written to ``out``."""
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as core
    import repro_torch.kernels as kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    by_path = bo_group(group, core, kernels)
    Path(out).write_text(json.dumps(dict(
        by_path=by_path, seconds=time.perf_counter() - t0,
        shapes=[[list(k), n] for k, n in LAUNCHED_SHAPES.items()],
        wholerun=WHOLERUN_RESULTS)))
    return 0


def bo_phases(seconds: dict) -> dict:
    """Phases 4b-4f: ``BO_GROUPS`` side by side, a process each; each
    group's lines printed in order once all have ended (its standard
    error after them), the posterior shapes merged into
    ``LAUNCHED_SHAPES``, each group's seconds (from its start, imports
    included) and the block's wall time into ``seconds``. A failed group
    ends the others and fails the phase. Returns the matern_score
    launches by path."""
    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    by_path, procs = {}, {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        files = {g: [Path(d) / f"{g}.{x}" for x in ("out", "err", "json")]
                 for g in BO_GROUPS}
        try:
            for g, (out, err, res) in files.items():
                with open(out, "w") as o, open(err, "w") as e:
                    procs[g] = subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()),
                         "--bo-group", g, str(res)],
                        cwd=ROOT, stdout=o, stderr=e)
            while (any(p.poll() is None for p in procs.values())
                   and not any(p.poll() for p in procs.values())):
                time.sleep(0.5)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                p.wait()
        for g, (out, err, res) in files.items():
            sys.stdout.write(out.read_text())
            sys.stdout.flush()
            sys.stderr.write(err.read_text())
            sys.stderr.flush()
            if procs[g].returncode:
                continue
            got = json.loads(res.read_text())
            by_path.update(got["by_path"])
            WHOLERUN_RESULTS.update(got["wholerun"])
            seconds[g] = got["seconds"]
            for shape, n in got["shapes"]:
                LAUNCHED_SHAPES[tuple(shape)] = (
                    LAUNCHED_SHAPES.get(tuple(shape), 0) + n)
    seconds["4b-4f"] = time.perf_counter() - t0
    codes = {g: p.returncode for g, p in procs.items() if p.returncode}
    if codes:
        raise AssertionError(f"BO groups failed (exit codes; negative: "
                             f"ended by the script): {codes}")
    return by_path


# --------------------------------------------------------------------------
# phase 4g: VGG19 at full width
# --------------------------------------------------------------------------

VGG_CLASSES = 1000
VGG_PROFILED_SPLIT = 7
# the card's float32 logits (TF32 off) against the same weights' float64
# forward on the CPU: the reference's own split-vs-full tolerance
VGG_LOGIT_TOL = dict(atol=1e-3, rtol=1e-3)


def vgg_split_times(vgg, params, img, l):
    """Device ms of each part of ``split_forward`` at split ``l``: the
    device half, the hop and the server half (classifier included), the
    card synchronised around each; with the logits and the payload's
    bytes."""
    marks = [time.perf_counter()]
    act = vgg.vgg19_features(params, img, 0, l)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    received, nbytes = vgg.wireless_hop(act)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    logits = vgg.vgg19_classifier(params,
                                  vgg.vgg19_features(params, received, l, 37))
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    device_ms, hop_ms, server_ms = (1e3 * (b - a)
                                    for a, b in zip(marks, marks[1:]))
    return logits, nbytes, dict(l=l, device_half_ms=device_ms, hop_ms=hop_ms,
                                server_half_ms=server_ms,
                                boundary_bytes=nbytes)


def vgg_phase(core, kernels, seq_counts, seq_res):
    """Phase 4g: VGG19 (``models/vgg.py``) at full width, 1000 classes,
    224 x 224 x 3, float32, weights from ``torch.Generator`` seed 0, one
    seeded image (batch 1), cuDNN deterministic. ``split_forward`` at
    every split 0..37 equals the unsplit forward bit for bit and ships
    the profile's ``activation_bytes(l)``; the logits at l = 7 lie
    within VGG_LOGIT_TOL of the same weights' float64 forward on the
    CPU; ``BayesSplitEdge(default_vgg19_problem(executor=make_executor(
    ...)), budget=20).run(seed=0)`` gives phase 3's answers bit for bit,
    calls the executor once an evaluation at the ledger's (l, p) and
    launches the posterior as often as phase 3. Logs a ``vgg`` line (BO
    and executor seconds; per split the device half, hop and server half
    ms and the boundary bytes) and a ``profile`` line of one forward at
    l = 7 beside its bound. Returns the run's launch counts."""
    from repro_torch.configs.cnn import get_cnn_config
    from repro_torch.models import vgg

    t_phase = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    cfg = get_cnn_config("vgg19-imagenet-mini")
    params = vgg.init_vgg19(torch.Generator(DEVICE).manual_seed(0),
                            n_classes=VGG_CLASSES, device=DEVICE)
    leaves = [t for pair in params["convs"] + params["fcs"] for t in pair]
    n_params = sum(t.numel() for t in leaves)
    img = 0.1 * torch.randn((1, 224, 224, 3), device=DEVICE,
                            generator=torch.Generator(DEVICE).manual_seed(1))
    with torch.no_grad():
        full = vgg.vgg19_classifier(params, vgg.vgg19_features(params, img))
        splits = []
        for l in range(38):
            logits, nbytes, row = vgg_split_times(vgg, params, img, l)
            again, nbytes2 = vgg.split_forward(params, img, l)
            want = int(cfg.activation_bytes(l))
            if not (torch.equal(logits, full) and torch.equal(again, full)):
                raise AssertionError(f"vgg19 split at {l} differs from the "
                                     "unsplit forward")
            if not nbytes == nbytes2 == want:
                raise AssertionError(f"vgg19 split at {l}: {nbytes} boundary "
                                     f"bytes, the profile says {want}")
            splits.append(row)
        cpu = {k: [tuple(t.to("cpu", torch.float64) for t in pair)
                   for pair in v] for k, v in params.items()}
        ref64, _ = vgg.split_forward(cpu, img.to("cpu", torch.float64),
                                     VGG_PROFILED_SPLIT)
        at_split = next(r for r in splits if r["l"] == VGG_PROFILED_SPLIT)
        got64 = full.to("cpu", torch.float64)
        err = float((got64 - ref64).abs().max())
        if not torch.allclose(got64, ref64, **VGG_LOGIT_TOL):
            raise AssertionError(f"vgg19 logits at l={VGG_PROFILED_SPLIT} "
                                 f"are {err} from the float64 forward")
        del cpu
        calls, spent = [], [0.0]
        run_real = vgg.make_executor(params, img)

        def executor(l, p_w):
            calls.append((l, p_w))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_real(l, p_w)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0

        pb = core.default_vgg19_problem(executor=executor)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with plain_calls_counted() as plain, block_scoring_watched() as seen:
            res = core.BayesSplitEdge(pb, budget=20).run(seed=0)
        torch.cuda.synchronize()
        bo_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check_block_scoring("vgg executor run", seen, counts, plain, kernels)
    if counts != seq_counts:
        raise AssertionError(f"vgg executor run launched {counts}, phase 3 "
                             f"{seq_counts}")
    if calls != [(h.l, h.p_w) for h in pb.history] or len(calls) != \
            res.n_evals:
        raise AssertionError(f"vgg executor called {len(calls)} times for "
                             f"{res.n_evals} evaluations, or off the ledger")
    same = (res.n_evals == seq_res.n_evals
            and res.accuracies == seq_res.accuracies
            and res.utilities == seq_res.utilities
            and res.feasible == seq_res.feasible
            and res.incumbent_trace == seq_res.incumbent_trace
            and np.array_equal(res.best_a, seq_res.best_a))
    layer, p_w = pb.denormalize(res.best_a)
    log("vgg", json.dumps(dict(
        classes=VGG_CLASSES, params=n_params,
        weight_bytes=sum(t.numel() * t.element_size() for t in leaves),
        cudnn_deterministic=torch.backends.cudnn.deterministic,
        splits_equal_unsplit=len(splits), logits_vs_float64=dict(
            split=VGG_PROFILED_SPLIT, max_abs_err=err, **VGG_LOGIT_TOL),
        bo_s=bo_s, executor_s=spent[0], executor_calls=len(calls),
        n_evals=res.n_evals, layer=layer, p_w=p_w,
        best_accuracy=res.best_accuracy, equals_phase3=same,
        launches=counts, block_scoring=seen, per_split=splits,
        device_half_ms_at_split=at_split["device_half_ms"])))
    if not same:
        raise AssertionError("the vgg executor run's answers are not phase "
                             "3's")
    # one forward at l = 7: its bound is the larger of its MACs (the 40
    # layers of the profile, 2 operations each) at the f32 peak and its
    # bytes (the weights, the image and the logits) at the HBM rate
    macs = sum(layer.macs for layer in cfg.layers)
    nbytes = (sum(t.numel() * t.element_size() for t in leaves)
              + img.numel() * 4 + VGG_CLASSES * 4)
    bound_ms, bound_by, terms = bound(nbytes, 2 * macs)
    with torch.no_grad():
        profile_calls("vgg19", f"split_forward_l{VGG_PROFILED_SPLIT}",
                      lambda: vgg.split_forward(params, img,
                                                VGG_PROFILED_SPLIT),
                      10, {}, extra=dict(macs=macs, bytes=nbytes,
                                         bound_ms=bound_ms,
                                         bound_by=bound_by,
                                         bound_terms=terms))
    torch.backends.cudnn.deterministic = False
    del params, leaves
    torch.cuda.empty_cache()
    log("vgg_phase", json.dumps(dict(seconds=time.perf_counter() - t_phase)))
    return counts


# --------------------------------------------------------------------------
# phase 2: the attention kernels against their plain versions
# --------------------------------------------------------------------------


def median_ms(fns, args, samples=5, inner=10):
    """Median device ms per call of each function, sampled in turns."""
    for fn in fns.values():                              # warm-up
        time_calls(fn, args, inner=2)
    times = {name: [] for name in fns}
    for _ in range(samples):
        for name, fn in fns.items():
            times[name].append(time_calls(fn, args, inner))
    return {name: statistics.median(t) for name, t in times.items()}


def attn_bound(nbytes, pairs, hd, Hq, dtype, per_pair=4):
    """Least time on an H100: the larger of the bytes at the HBM rate and
    the ``per_pair`` hd operations per allowed (q, k) pair per q head (4
    in the forward, 10 in the backward) at the peak for the inputs' type
    (bf16 tensor cores, or f32)."""
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = per_pair * hd * Hq * pairs / peak
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes",
            dict(bytes_ms=1e3 * t_bytes, ops_ms=1e3 * t_ops))


def allowed_pairs(Sq, Skv, window, causal=True):
    """(q, k) pairs the mask allows, per (batch row, q head)."""
    i = np.arange(Sq)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(Sq, int)
    return int(np.maximum(0, hi - lo + 1).sum())


def check_close(name, shape, got, ref, dtype):
    diff = (got.float() - ref.float()).abs()
    err = float(diff.max())
    ok = bool(torch.allclose(got.float(), ref.float(), rtol=ATTN_RTOL,
                             atol=ATTN_ATOL[dtype]))
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{shape}: max abs err {err}, rtol/atol "
                             f"{ATTN_RTOL}/{ATTN_ATOL[dtype]}")
    return err


def flash_phase(kernels):
    """Each FLASH_SHAPES row against the plain version (bf16 also
    against the plain emulation of its tiles), with SDPA's time beside
    it; timed warm (back-to-back calls on one set of inputs) and cold
    (``cold_ms``)."""
    from repro_torch.kernels.flash_attention.ref import attention_tiled_ref

    F = torch.nn.functional
    rows = []
    for name, B, S, window, dtype, Hq, Hkv, hd in FLASH_SHAPES:
        rng = np.random.default_rng(S + hd + window)
        q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                                   device=DEVICE).to(dtype)
                   for s in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
        got = kernels.flash_attention(q, k, v, causal=True, window=window)
        ref = kernels.attention_ref(q, k, v, causal=True, window=window)
        emu = (attention_tiled_ref(q, k, v, window=window)
               if dtype == torch.bfloat16 else ref)
        torch.cuda.synchronize()
        err = check_close("flash_attention", name, got, ref, dtype)
        emu_err = float((got.float() - emu.float()).abs().max())
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            i = torch.arange(S, device=DEVICE)
            mask = ((i[None, :] <= i[:, None])
                    & (i[:, None] - i[None, :] < window))
            library = (lambda q_, k_, v_: F.scaled_dot_product_attention(
                q_, k_, v_, attn_mask=mask, enable_gqa=True))
        else:
            library = (lambda q_, k_, v_: F.scaled_dot_product_attention(
                q_, k_, v_, is_causal=True, enable_gqa=True))
        ms = median_ms(dict(
            plain=lambda: kernels.attention_ref(q, k, v, window=window),
            kernel=lambda: kernels.flash_attention(q, k, v, window=window),
            library=lambda: library(qh, kh, vh)), ())
        ms_cold = cold_ms(lambda q_, k_, v_: kernels.flash_attention(
            q_, k_, v_, window=window), cold_copies((q, k, v)))
        esize = q.element_size()
        nbytes = esize * (2 * q.numel() + k.numel() + v.numel())
        pairs = B * allowed_pairs(S, S, window)
        bound_ms, bound_by, terms = attn_bound(nbytes, pairs, hd, Hq, dtype)
        row = dict(name=name, B=B, S=S, Hq=Hq, Hkv=Hkv, hd=hd, window=window,
                   dtype=str(dtype).split(".")[-1], max_abs_err=err,
                   emulation_max_abs_err=emu_err,
                   blocks=-(-S // 64) * Hq * B, ms=ms["kernel"],
                   ms_cold=ms_cold,
                   plain_ms=ms["plain"], library_ms=ms["library"],
                   bound_ms=bound_ms, bound_by=bound_by, bound_terms=terms)
        log("flash_attention", json.dumps(row))
        rows.append(row)
    return rows


def check_rel(name, shape, what, got, want, tol):
    """max |got - want| within ``tol`` of want's largest magnitude."""
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    if err > tol * scale:
        raise AssertionError(f"{name} {what} disagrees with its plain "
                             f"version at {shape}: max abs err {err}, "
                             f"{tol} of the largest magnitude {scale}")
    return err, err / scale if scale else 0.0


def bwd_build(instances, hd, dtype):
    """Registers and spills of the kernels a row runs that hold its
    products: bf16 the tensor-core dq + dk/dv kernel, float32 the
    CUDA-core dq and dk/dv kernels, of width 64, 128 or 256, from the
    build log's ``-Xptxas -v``; None where this process did not build the
    library. Raises where the instance is missing, or where a tensor-core
    instance spills: its design keeps the accumulators in registers."""
    if not instances:
        return None
    width = 64 if hd <= 64 else 128 if hd <= 128 else 256
    kinds = ((f"dqkv_kernel_tcILi{width}E",) if dtype == torch.bfloat16
             else (f"dq_kernelILi{width}E", f"dkv_kernelILi{width}E"))
    out = {}
    for kind in kinds:
        r = next((r for r in instances
                  if f"flash_bwd_{kind}" in r["entry"]), None)
        if r is None:
            raise AssertionError(f"flash_attention_bwd: no instance {kind} "
                                 "in the build log")
        if dtype == torch.bfloat16 and (r.get("spill_stores")
                                        or r.get("spill_loads")):
            raise AssertionError(f"flash_attention_bwd instance "
                                 f"{r['entry']} spills: {r}")
        out[kind.split("_kernel")[0]] = {
            k: r.get(k) for k in ("registers", "spill_stores", "spill_loads")}
    return out


def flash_bwd_phase(kernels, instances=()):
    """Each FLASH_BWD_SHAPES row: the forward's log-sum-exp against
    ``attention_lse_ref``; the backward kernel's dq, dk and dv against
    the plain backward (``attention_bwd_ref``, autograd through the
    plain forward, in float32 on the same inputs) and against the plain
    emulation of its own arithmetic (``attention_bwd_tiled_ref``, P and
    dS rounded to bf16 on bf16 rows), each within BWD_TOL of the tensor's
    largest magnitude; run twice, bit for bit; timed warm and cold beside
    its bound, SDPA's backward and the CUDA-core kernels' earlier cold
    time, with the registers and spills of the kernels it runs
    (``instances``: the build log's ``ptxas_summary``)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_tiled_ref, attention_lse_ref)

    F = torch.nn.functional
    rows = []
    for name, B, S, window, dtype, Hq, Hkv, hd in FLASH_BWD_SHAPES:
        t_row = time.perf_counter()
        rng = np.random.default_rng(S + hd + window + 1)
        q, k, v, do = (torch.as_tensor(rng.standard_normal(sh),
                                       dtype=torch.float32,
                                       device=DEVICE).to(dtype)
                       for sh in ((B, S, Hq, hd), (B, S, Hkv, hd),
                                  (B, S, Hkv, hd), (B, S, Hq, hd)))
        out, lse = fops.flash_attention_fwd(q, k, v, True, window)
        grads = fops.flash_attention_bwd(q, k, v, out, lse, do, True, window)
        again = fops.flash_attention_bwd(q, k, v, out, lse, do, True, window)
        want = kernels.attention_bwd_ref(q.float(), k.float(), v.float(),
                                         do.float(), causal=True,
                                         window=window)
        torch.cuda.synchronize()
        t_emu = time.perf_counter()
        emu = attention_bwd_tiled_ref(q, k, v, out, lse, do, True, window,
                                      p_dtype=dtype)
        lse_want = attention_lse_ref(q, k, True, window)
        torch.cuda.synchronize()
        t_emu = time.perf_counter() - t_emu
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"flash_attention_bwd at {name}: two calls "
                                 "on the same inputs differ")
        tol = BWD_TOL[dtype]
        errs, rel, emu_rel = {}, {}, {}
        for label, g, w, e in zip(("dq", "dk", "dv"), grads, want, emu):
            errs[label], rel[label] = check_rel(
                "flash_attention_bwd", name, label, g, w, tol)
            emu_rel[label] = check_rel(
                "flash_attention_bwd", name, f"{label} (emulation)", g, e,
                tol)[1]
        lse_err = float((lse - lse_want).abs().max())
        if lse_err > LSE_ATOL:
            raise AssertionError(f"flash_attention lse at {name}: max abs "
                                 f"err {lse_err} > {LSE_ATOL}")
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        if window:
            i = torch.arange(S, device=DEVICE)
            mask = ((i[None, :] <= i[:, None])
                    & (i[:, None] - i[None, :] < window))
            lib_out = F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=True)
        else:
            lib_out = F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True)
        doh = do.transpose(1, 2)
        ms = median_ms(dict(
            plain=lambda: kernels.attention_bwd_ref(q, k, v, do, True,
                                                    window),
            kernel=lambda: fops.flash_attention_bwd(q, k, v, out, lse, do,
                                                    True, window),
            library=lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                                retain_graph=True)),
            (), samples=3, inner=5)
        ms_cold = cold_ms(lambda *a: fops.flash_attention_bwd(
            *a, True, window), cold_copies((q, k, v, out, lse, do)),
            samples=3, inner=5)
        esize = q.element_size()
        # q, k, v, o, do and lse read once; dq, dk, dv written once
        nbytes = (esize * (4 * q.numel() + 2 * k.numel() + 2 * v.numel())
                  + lse.element_size() * lse.numel())
        pairs = B * allowed_pairs(S, S, window)
        bound_ms, bound_by, terms = attn_bound(nbytes, pairs, hd, Hq, dtype,
                                               per_pair=10)
        row = dict(name=name, B=B, S=S, Hq=Hq, Hkv=Hkv, hd=hd, window=window,
                   dtype=str(dtype).split(".")[-1],
                   max_abs_err=max(errs.values()), rel_err=rel,
                   emulation_rel_err=emu_rel, lse_max_abs_err=lse_err,
                   tol=tol, repeat_bitwise=True, ms=ms["kernel"],
                   ms_cold=ms_cold, plain_ms=ms["plain"],
                   library_ms=ms["library"], bound_ms=bound_ms,
                   bound_by=bound_by, bound_terms=terms, bytes=nbytes,
                   pairs_per_head=pairs,
                   earlier_ms_cold=BWD_EARLIER_COLD_MS.get(name),
                   build=bwd_build(instances, hd, dtype),
                   emulation_s=t_emu, seconds=time.perf_counter() - t_row)
        log("flash_attention_bwd", json.dumps(row))
        rows.append(row)
        del lib_out, want, emu
    return rows


def decode_inputs(B, T, last, q_pos, Hq, Hkv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                               device=DEVICE).to(dtype)
               for s in ((B, Hq, hd), (B, T, Hkv, hd), (B, T, Hkv, hd)))
    pos = np.full((B, T), np.iinfo(np.int32).max, np.int32)
    for p in range(max(0, last - T + 1), last + 1):
        pos[:, p % T] = p
    kv_pos = torch.as_tensor(pos, device=DEVICE)
    q_pos = torch.full((B,), q_pos, dtype=torch.int32, device=DEVICE)
    return q, k, v, kv_pos, q_pos


def decode_phase(kernels):
    """Each DECODE_SHAPES row against the plain version and the plain
    emulation of its splits, twice bit for bit, with SDPA's time beside
    it; timed warm and cold (``cold_ms``)."""
    from repro_torch.kernels.decode_attention.ops import decode_splits
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_split_ref)

    F = torch.nn.functional
    rows = []
    for name, B, T, last, qp, window, dtype, Hq, Hkv, hd in DECODE_SHAPES:
        args = decode_inputs(B, T, last, qp, Hq, Hkv, hd, dtype, seed=T + hd)
        q, k, v, kv_pos, q_pos = args
        got = kernels.decode_attention(*args, window=window)
        again = kernels.decode_attention(*args, window=window)
        ref = kernels.decode_attention_ref(*args, window=window)
        n_split, chunk = decode_splits(B, Hkv, T)
        emu = decode_attention_split_ref(*args, window=window,
                                         n_split=n_split, chunk=chunk)
        torch.cuda.synchronize()
        err = check_close("decode_attention", name, got, ref, dtype)
        if not torch.equal(got, again):
            raise AssertionError(f"decode_attention at {name} does not "
                                 "repeat bit for bit")
        emu_err = float((got.float() - emu.float()).abs().max())
        kp, qpl = kv_pos.long(), q_pos.long()[:, None]
        allowed = (kp <= qpl) & ((qpl - kp < window) if window else True)
        mask = allowed[:, None, None, :]                 # (B, 1, 1, T)
        qh, kh, vh = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        ms = median_ms(dict(
            plain=lambda: kernels.decode_attention_ref(*args, window=window),
            kernel=lambda: kernels.decode_attention(*args, window=window),
            library=lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=True)), ())
        ms_cold = cold_ms(lambda *a: kernels.decode_attention(
            *a, window=window), cold_copies(args))
        # the K/V bytes this run's mask needs (each allowed slot once per
        # kv head), every kv_pos, q_pos, q and o
        n_slots = int(allowed.sum())
        esize = q.element_size()
        nbytes = (esize * (2 * n_slots * Hkv * hd + 2 * q.numel())
                  + 4 * (kv_pos.numel() + B))
        bound_ms, bound_by, terms = attn_bound(nbytes, n_slots, hd, Hq, dtype)
        row = dict(name=name, B=B, T=T, last=last, q_pos=qp, Hq=Hq, Hkv=Hkv,
                   hd=hd, window=window, dtype=str(dtype).split(".")[-1],
                   allowed_slots=n_slots, splits=n_split,
                   slots_per_split=chunk, blocks=B * Hkv * n_split,
                   max_abs_err=err, emulation_max_abs_err=emu_err,
                   ms=ms["kernel"], ms_cold=ms_cold,
                   plain_ms=ms["plain"], library_ms=ms["library"],
                   bound_ms=bound_ms, bound_by=bound_by, bound_terms=terms)
        log("decode_attention", json.dumps(row))
        rows.append(row)
    return rows


def decode_lse_phase(kernels, decode_rows):
    """``decode_attention`` with ``return_lse`` at DECODE_LSE_SHAPES: its
    output equal to the call without the log-sum-exp bit for bit, twice
    bit for bit; the log-sum-exp against the plain version's and the
    plain emulation of the splits'; timed warm and cold beside the call
    without it. No PyTorch call returns the log-sum-exp: library_ms is
    None."""
    from repro_torch.kernels.decode_attention.ops import decode_splits
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_split_ref)

    rows = []
    by_name = {r["name"]: r for r in decode_rows}
    for name, B, T, last, qp, window, dtype, Hq, Hkv, hd in DECODE_SHAPES:
        if name not in DECODE_LSE_SHAPES:
            continue
        args = decode_inputs(B, T, last, qp, Hq, Hkv, hd, dtype, seed=T + hd)
        o, lse = kernels.decode_attention(*args, window=window,
                                          return_lse=True)
        o2, lse2 = kernels.decode_attention(*args, window=window,
                                            return_lse=True)
        plain = kernels.decode_attention(*args, window=window)
        ref_o, ref_lse = kernels.decode_attention_ref(
            *args, window=window, return_lse=True)
        n_split, chunk = decode_splits(B, Hkv, T)
        _, emu_lse = decode_attention_split_ref(
            *args, window=window, n_split=n_split, chunk=chunk,
            return_lse=True)
        torch.cuda.synchronize()
        err = check_close("decode_attention lse", name, o, ref_o, dtype)
        if not (torch.equal(o, plain) and torch.equal(o, o2)
                and torch.equal(lse, lse2)):
            raise AssertionError(f"decode_attention with lse at {name}: "
                                 "its output is not the call's without "
                                 "it, or does not repeat, bit for bit")
        finite = ref_lse > -1e29           # a row with an allowed slot
        lse_err = float((lse - ref_lse)[finite].abs().max()
                        if finite.any() else 0.0)
        emu_err = float((lse - emu_lse)[finite].abs().max()
                        if finite.any() else 0.0)
        if (lse_err > DECODE_LSE_ATOL or emu_err > DECODE_LSE_ATOL
                or not torch.equal(lse <= -1e29, ~finite)):
            raise AssertionError(f"decode_attention lse at {name}: err "
                                 f"{lse_err} (emulation {emu_err}) > "
                                 f"{DECODE_LSE_ATOL}")
        ms = median_ms(dict(
            plain=lambda: kernels.decode_attention_ref(
                *args, window=window, return_lse=True),
            kernel=lambda: kernels.decode_attention(
                *args, window=window, return_lse=True)), ())
        ms_cold = cold_ms(lambda *a: kernels.decode_attention(
            *a, window=window, return_lse=True), cold_copies(args))
        base = by_name[name]
        # the call without it, plus 4 bytes a (row, q head) written
        bound_ms, bound_by, terms = attn_bound(
            base["bound_terms"]["bytes_ms"] * 1e-3 * PEAK_BYTES_PER_S
            + 4 * B * Hq, base["allowed_slots"], hd, Hq, dtype)
        row = dict(name=name, B=B, T=T, Hq=Hq, Hkv=Hkv, hd=hd, window=window,
                   dtype=str(dtype).split(".")[-1], max_abs_err=err,
                   lse_max_abs_err=lse_err, lse_emulation_max_abs_err=emu_err,
                   ms=ms["kernel"], ms_cold=ms_cold,
                   ms_without_lse=base["ms"],
                   ms_cold_without_lse=base["ms_cold"],
                   plain_ms=ms["plain"], library_ms=None,
                   bound_ms=bound_ms, bound_by=bound_by, bound_terms=terms)
        log("decode_attention_lse", json.dumps(row))
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# phase 2: the recurrent scans against their plain versions
# --------------------------------------------------------------------------


def check_scan(name, shape, pairs, dtype):
    """Max abs error over (got, want) pairs; raises outside SCAN_TOL."""
    atol, rtol = SCAN_TOL[dtype]
    err = 0.0
    for got, want in pairs:
        g, w = got.float(), want.float()
        err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
        if not torch.allclose(g, w, atol=atol, rtol=rtol):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {shape}: max abs err {err}, atol/rtol "
                                 f"{atol}/{rtol}")
    return err


def rglru_inputs(B, S, R, dtype, seed):
    rng = np.random.default_rng(seed)
    a = torch.sigmoid(torch.as_tensor(rng.standard_normal((B, S, R)),
                                      dtype=torch.float32, device=DEVICE))
    b = torch.as_tensor(rng.standard_normal((B, S, R)), dtype=torch.float32,
                        device=DEVICE)
    h0 = torch.as_tensor(rng.standard_normal((B, R)), dtype=torch.float32,
                         device=DEVICE)
    return a.to(dtype), b.to(dtype), h0


def cold_copies(args):
    """Copies of a call's inputs, enough that between two uses of one
    copy the calls on the others read more than twice the L2 size."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    nbytes = sum(t.numel() * t.element_size() for t in args)
    return [tuple(t.clone() for t in args)
            for _ in range(2 * l2 // nbytes + 2)]


def cold_ms(fn, copies, samples=5, inner=20):
    """Median device ms per call, timed as ``time_calls`` times, with the
    calls rotating over ``copies`` (``cold_copies``): no call finds its
    inputs in the L2. One pass over the copies first."""
    turn = itertools.count()

    def calls():
        fn(*copies[next(turn) % len(copies)])

    for _ in copies:
        calls()
    return statistics.median(time_calls(calls, (), inner)
                             for _ in range(samples))


def rglru_phase(kernels):
    """Each RGLRU_SHAPES row against the plain version and the plain
    emulation of the kernel's order (``rglru_scan_chunked_ref``), twice
    bit for bit, in place as out of place, hs[:, -1] as h_last rounded,
    with the kernel's plan (``scan_plan``, held to what the built kernel
    launches), blocks an SM and waves; timed warm (back-to-back calls on
    one set of inputs, as before) and cold (``cold_ms``)."""
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    from repro_torch.kernels.rglru_scan import rglru_scan_chunked_ref
    from repro_torch.kernels.rglru_scan.ops import scan_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, B, S, R, dtype in RGLRU_SHAPES:
        args = rglru_inputs(B, S, R, dtype, seed=S + R)
        a, b, h0 = args
        got = kernels.rglru_scan(*args)
        again = kernels.rglru_scan(*args)
        want = kernels.rglru_scan_ref(*args)
        emulated = rglru_scan_chunked_ref(*args)
        state = h0.clone()                    # h_last written over h0
        in_place = kernels.rglru_scan(a, b, state, h_out=state)
        torch.cuda.synchronize()
        err = check_scan("rglru_scan", name, zip(got, want), dtype)
        emu_err = check_scan("rglru_scan (against its emulation)", name,
                             zip(got, emulated), dtype)
        if not (torch.equal(state, got[1]) and torch.equal(in_place[0],
                                                           got[0])):
            raise AssertionError(f"rglru_scan in place differs at {name}")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"rglru_scan at {name} does not repeat "
                                 "bit for bit")
        if not torch.equal(got[0][:, -1], got[1].to(dtype)):
            raise AssertionError(f"rglru_scan at {name}: hs[:, -1] is not "
                                 "h_last rounded")
        plan = scan_plan(B, S, R, dtype)
        built = rg_kernel.launch_plan(S, dtype)
        if ((built["chunk"], built["chunks"], built["smem_bytes"])
                != (plan.chunk, plan.chunks, plan.smem_bytes)
                or built["blocks_per_sm"] < plan.blocks_per_sm):
            raise AssertionError(f"rglru_scan at {name}: the kernel "
                                 f"launches {built}, scan_plan says {plan}")
        per_sm = built["blocks_per_sm"]
        ms = median_ms(dict(kernel=lambda: kernels.rglru_scan(*args)), ())
        ms.update(median_ms(dict(
            plain=lambda: kernels.rglru_scan_ref(*args)), (), **PLAIN_TIMING))
        ms_cold = cold_ms(kernels.rglru_scan, cold_copies(args))
        n = B * S * R
        nbytes = a.element_size() * 3 * n + 4 * 2 * B * R
        bound_ms, bound_by, terms = bound(nbytes, 2 * n)
        row = dict(name=name, B=B, S=S, R=R, dtype=str(dtype).split(".")[-1],
                   max_abs_err=err, emulation_max_abs_err=emu_err,
                   chunk=plan.chunk, chunks=plan.chunks, pieces=plan.pieces,
                   threads=plan.threads, grid=list(plan.grid),
                   smem_bytes=plan.smem_bytes, blocks_per_sm=per_sm,
                   plan_blocks_per_sm=plan.blocks_per_sm, sms=sms,
                   waves=-(-plan.blocks // (per_sm * sms)),
                   ms=ms["kernel"], ms_cold=ms_cold, plain_ms=ms["plain"],
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   bound_terms=terms)
        log("rglru_scan", json.dumps(row))
        rows.append(row)
    return rows


def rwkv6_phase(kernels):
    """Each RWKV_SHAPES row against the plain version, twice bit for bit,
    in place as out of place, in float32 with the backward's saved
    states written bit for bit as without (``rwkv6_scan_fwd``; the
    instance that saves them is float32 only), with the kernel's plan
    (``scan_plan``), the
    blocks an SM holds and the waves its grid needs on this card; timed
    warm (``ms``) and cold (``ms_cold``, ``cold_ms``)."""
    from repro_torch.kernels.rwkv6_scan import kernel as rw_kernel
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_fwd
    from repro_torch.kernels.rwkv6_scan.ops import scan_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, B, S, H, hd, dtype in RWKV_SHAPES:
        rng = np.random.default_rng(S + hd)

        def t(x, dt=dtype):
            return torch.as_tensor(x, dtype=torch.float32,
                                   device=DEVICE).to(dt)

        r, k, v = (t(rng.standard_normal((B, S, H, hd))) for _ in range(3))
        logw = t(-np.exp(rng.standard_normal((B, S, H, hd))) * 0.5)
        u = t(rng.standard_normal((H, hd)) * 0.1, torch.float32)
        s0 = t(rng.standard_normal((B, H, hd, hd)) * 0.1, torch.float32)
        args = (r, k, v, logw, u, s0)
        got = kernels.rwkv6_scan(*args)
        again = kernels.rwkv6_scan(*args)
        want = kernels.rwkv6_scan_ref(*args)
        state = s0.clone()                    # s_last written over s0
        o_in_place, _ = kernels.rwkv6_scan(r, k, v, logw, u, state,
                                           s_out=state)
        if dtype == torch.float32:           # the saving instance's type
            with_states = rwkv6_scan_fwd(*args)
            torch.cuda.synchronize()
            if not (torch.equal(with_states[0], got[0])
                    and torch.equal(with_states[1], got[1])):
                raise AssertionError(f"rwkv6_scan at {name}: the forward "
                                     "with the backward's saved states "
                                     "differs from the one without them")
            del with_states
        err = check_scan("rwkv6_scan", name, zip(got, want), dtype)
        if not (torch.equal(state, got[1]) and torch.equal(o_in_place,
                                                           got[0])):
            raise AssertionError(f"rwkv6_scan in place differs at {name}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"rwkv6_scan at {name} does not repeat "
                                 "bit for bit")
        plan = scan_plan(B, H, hd, S, dtype)
        if rw_kernel.smem_bytes(hd, dtype) != plan.smem_bytes:
            raise AssertionError(
                f"rwkv6_scan at {name}: the kernel takes "
                f"{rw_kernel.smem_bytes(hd, dtype)} bytes of shared memory, "
                f"scan_plan says {plan.smem_bytes}")
        per_sm = rw_kernel.blocks_per_sm(hd, dtype)
        waves = -(-plan.blocks // (per_sm * sms))
        ms = median_ms(dict(kernel=lambda: kernels.rwkv6_scan(*args)), ())
        ms.update(median_ms(dict(
            plain=lambda: kernels.rwkv6_scan_ref(*args)), (), **PLAIN_TIMING))
        ms_cold = cold_ms(kernels.rwkv6_scan, cold_copies(args))
        # per (b, t, h): each state element takes k v (1), w S + k v (2)
        # and r S + acc (2); r . (u k) 3 hd and its v term 2 hd; one exp
        # per row
        steps = B * S * H
        flops = steps * (5 * hd * hd + 5 * hd)
        nbytes = (r.element_size() * 5 * steps * hd
                  + 4 * (H * hd + 2 * B * H * hd * hd))
        bound_ms, bound_by, terms = bound(nbytes, flops, sfu=steps * hd)
        row = dict(name=name, B=B, S=S, H=H, hd=hd,
                   dtype=str(dtype).split(".")[-1], max_abs_err=err,
                   rows_per_chain=plan.chain, chunk=plan.chunk,
                   grid=list(plan.grid), smem_bytes=plan.smem_bytes,
                   blocks_per_sm=per_sm, sms=sms, waves=waves,
                   ms=ms["kernel"], ms_cold=ms_cold, plain_ms=ms["plain"],
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   bound_terms=terms)
        log("rwkv6_scan", json.dumps(row))
        if (B, H, hd) == (2, 16, 160) and (per_sm < 2 or waves != 1):
            raise AssertionError(
                f"rwkv6_scan at {name}: {per_sm} blocks an SM and {waves} "
                "waves; the design needs two blocks an SM and one wave at "
                "RWKV6-3B's heads")
        rows.append(row)
    return rows


def rglru_bwd_phase(kernels):
    """Each RGLRU_BWD_SHAPES row: the backward kernel's da, db and dh0 at
    random cotangents (dh_last included) after the forward kernel,
    against the plain reverse loop (``rglru_scan_bwd_ref``) within
    BWD_TOL and the plain emulation of its chunks
    (``rglru_scan_bwd_chunked_ref``) within SCAN_BWD_EMU_TOL of each
    tensor's largest magnitude, and with no dh_last; twice bit for bit;
    timed warm and cold beside its bound and the plain loop."""
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd_chunked_ref

    rows = []
    for name, B, S, R in RGLRU_BWD_SHAPES:
        t_row = time.perf_counter()
        a, b, h0 = rglru_inputs(B, S, R, torch.float32, seed=S + R + 1)
        rng = np.random.default_rng(S + R + 2)
        dhs = torch.as_tensor(rng.standard_normal((B, S, R)),
                              dtype=torch.float32, device=DEVICE)
        dh_last = torch.as_tensor(rng.standard_normal((B, R)),
                                  dtype=torch.float32, device=DEVICE)
        hs, _ = kernels.rglru_scan(a, b, h0)
        args = (a, h0, hs, dhs, dh_last)
        got = kernels.rglru_scan_bwd(*args)
        again = kernels.rglru_scan_bwd(*args)
        no_last = kernels.rglru_scan_bwd(a, h0, hs, dhs)
        want = kernels.rglru_scan_bwd_ref(*args)
        want_nl = kernels.rglru_scan_bwd_ref(a, h0, hs, dhs)
        emu = rglru_scan_bwd_chunked_ref(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"rglru_scan_bwd at {name}: two calls on "
                                 "the same inputs differ")
        errs, rel, emu_rel = {}, {}, {}
        for label, g, w, e, gn, wn in zip(("da", "db", "dh0"), got, want,
                                          emu, no_last, want_nl):
            errs[label], rel[label] = check_rel(
                "rglru_scan_bwd", name, label, g, w, BWD_TOL[torch.float32])
            emu_rel[label] = check_rel("rglru_scan_bwd", name,
                                       f"{label} (emulation)", g, e,
                                       SCAN_BWD_EMU_TOL)[1]
            check_rel("rglru_scan_bwd", name, f"{label} (no dh_last)", gn,
                      wn, BWD_TOL[torch.float32])
        ms = median_ms(dict(kernel=lambda: kernels.rglru_scan_bwd(*args)),
                       ())
        plain = median_ms(dict(
            plain=lambda: kernels.rglru_scan_bwd_ref(*args)), (),
            **PLAIN_TIMING)
        ms_cold = cold_ms(kernels.rglru_scan_bwd, cold_copies(args))
        n = B * S * R
        # a, hs and dhs read, da and db written; h0 and dh_last read, dh0
        # written; g's multiply-add and da's product an element
        nbytes = 4 * (5 * n + 3 * B * R)
        bound_ms, bound_by, terms = bound(nbytes, 3 * n)
        row = dict(name=name, B=B, S=S, R=R, dtype="float32",
                   max_abs_err=max(errs.values()), rel_err=rel,
                   emulation_rel_err=emu_rel, tol=BWD_TOL[torch.float32],
                   emulation_tol=SCAN_BWD_EMU_TOL, repeat_bitwise=True,
                   ms=ms["kernel"], ms_cold=ms_cold, plain_ms=plain["plain"],
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   bound_terms=terms, seconds=time.perf_counter() - t_row)
        log("rglru_scan_bwd", json.dumps(row))
        rows.append(row)
    return rows


def rwkv_bwd_inputs(B, S, H, hd, underflow, seed):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=DEVICE)

    r, k, v, do = (t(rng.standard_normal((B, S, H, hd))) for _ in range(4))
    logw = -np.exp(rng.standard_normal((B, S, H, hd))) * 0.5
    if underflow:
        logw[:, ::2] = -np.exp(8.0)
    u = t(rng.standard_normal((H, hd)) * 0.1)
    s0, ds_last = (t(rng.standard_normal((B, H, hd, hd)) * 0.1)
                   for _ in range(2))
    return r, k, v, t(logw), u, s0, do, ds_last


def rwkv6_bwd_phase(kernels):
    """Each RWKV_BWD_SHAPES row: the forward with its saved states
    (``rwkv6_scan_fwd``) equal to the forward without them bit for bit
    and its states the plain forward's within SCAN_TOL; the backward
    kernels' dr, dk, dv, dlogw, du and ds0 at random cotangents
    (ds_last included) against the plain reverse loop
    (``rwkv6_scan_bwd_ref``) within BWD_TOL and the plain emulation of
    their order (``rwkv6_scan_bwd_tiled_ref``) within SCAN_BWD_EMU_TOL
    of each tensor's largest magnitude, and with no ds_last; twice bit
    for bit; timed warm and cold beside the bound and the plain loop
    (the row kernel also alone, ``rows_ms``), with the row kernel's plan
    (``bwd_plan``: lanes, rows, threads, shared bytes, held to what the
    built kernel reports) and the blocks an SM holds and the waves its
    grid needs on this card."""
    from repro_torch.kernels.rwkv6_scan import kernel as rw_kernel
    from repro_torch.kernels.rwkv6_scan import (rwkv6_checkpoints_ref,
                                                rwkv6_scan_bwd_tiled_ref,
                                                rwkv6_scan_fwd)
    from repro_torch.kernels.rwkv6_scan.ops import bwd_plan
    from repro_torch.kernels.rwkv6_scan.ref import CKPT_STEPS

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    rows = []
    labels = ("dr", "dk", "dv", "dlogw", "du", "ds0")
    for name, B, S, H, hd, underflow in RWKV_BWD_SHAPES:
        t_row = time.perf_counter()
        r, k, v, logw, u, s0, do, ds_last = rwkv_bwd_inputs(
            B, S, H, hd, underflow, seed=S + hd + 3)
        o, s_last = kernels.rwkv6_scan(r, k, v, logw, u, s0)
        o_ck, s_ck, ckpt = rwkv6_scan_fwd(r, k, v, logw, u, s0)
        torch.cuda.synchronize()
        if not (torch.equal(o, o_ck) and torch.equal(s_last, s_ck)):
            raise AssertionError(f"rwkv6_scan at {name}: the forward with "
                                 "its saved states differs from the one "
                                 "without them")
        ck_err = check_scan("rwkv6_scan checkpoints", name, [
            (ckpt, rwkv6_checkpoints_ref(r, k, v, logw, u, s0))],
            torch.float32)
        args = (r, k, v, logw, u, s0, ckpt, do, ds_last)
        got = kernels.rwkv6_scan_bwd(*args)
        again = kernels.rwkv6_scan_bwd(*args)
        no_last = kernels.rwkv6_scan_bwd(*args[:-1])
        want = kernels.rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, do, ds_last)
        want_nl = kernels.rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, do)
        emu = rwkv6_scan_bwd_tiled_ref(r, k, v, logw, u, s0, do, ds_last)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"rwkv6_scan_bwd at {name}: two calls on "
                                 "the same inputs differ")
        errs, rel, emu_rel = {}, {}, {}
        for label, g, w, e, gn, wn in zip(labels, got, want, emu, no_last,
                                          want_nl):
            errs[label], rel[label] = check_rel(
                "rwkv6_scan_bwd", name, label, g, w, BWD_TOL[torch.float32])
            emu_rel[label] = check_rel("rwkv6_scan_bwd", name,
                                       f"{label} (emulation)", g, e,
                                       SCAN_BWD_EMU_TOL)[1]
            check_rel("rwkv6_scan_bwd", name, f"{label} (no ds_last)", gn,
                      wn, BWD_TOL[torch.float32])
        del want, want_nl, emu
        ms = median_ms(dict(kernel=lambda: kernels.rwkv6_scan_bwd(*args)),
                       (), samples=3, inner=5)
        plain = median_ms(dict(plain=lambda: kernels.rwkv6_scan_bwd_ref(
            r, k, v, logw, u, s0, do, ds_last)), (), samples=3, inner=1)
        copies = cold_copies(args)
        ms_cold = cold_ms(kernels.rwkv6_scan_bwd, copies, samples=3, inner=5)
        plan = bwd_plan(B, H, hd, S)
        built = rw_kernel.bwd_build(hd)
        if (built["lanes"], built["threads"], built["smem_bytes"]) != (
                plan.lanes, plan.threads, plan.smem_bytes):
            raise AssertionError(f"rwkv6_scan_bwd at {name}: the row kernel "
                                 f"builds {built}, bwd_plan says {plan}")
        per_sm = built["blocks_per_sm"]
        waves = -(-plan.blocks // (per_sm * sms))
        if name == SCAN_BWD_MAIN and (per_sm < 2 or waves != 1):
            raise AssertionError(
                f"rwkv6_scan_bwd at {name}: {per_sm} blocks an SM and "
                f"{waves} waves; the design needs two blocks an SM and one "
                "wave at RWKV6-3B's training microbatch")
        rows_ms = rows_ms_cold = None
        if name == SCAN_BWD_MAIN:        # the row kernel and du's sum alone
            outs = [torch.empty_like(r) for _ in range(3)] + [
                torch.empty(B, H, hd, device=DEVICE),
                torch.empty(H, hd, device=DEVICE)]

            def rows_only(r, k, v, logw, u, s0, ckpt, do, ds_last):
                rw_kernel.launch_bwd_rows(r, k, v, logw, u, ckpt, do,
                                          ds_last, *outs)
            rows_ms = median_ms(dict(k=lambda: rows_only(*args)), (),
                                samples=3, inner=5)["k"]
            rows_ms_cold = cold_ms(rows_only, copies, samples=3, inner=5)
            del outs
        del copies
        # per (b, t, h): 14 operations a state element (the state's
        # recompute 3, G's update 3, dr, dk, dv and dlogw 2 each) and
        # 12 a row (v . do, r . (u k), the bonus terms, du); one exp a
        # row. The function's own traffic: read once r, k, v, logw, do,
        # u, s0 and ds_last; written once dr, dk, dv, dlogw, du and ds0.
        # The saved states are this design's, not the function's: their
        # bytes are logged beside the bound (checkpoint_bytes)
        steps = B * S * H
        flops = steps * (14 * hd * hd + 12 * hd)
        state = B * H * hd * hd
        nbytes = 4 * (9 * steps * hd + 2 * H * hd + 3 * state)
        bound_ms, bound_by, terms = bound(nbytes, flops, sfu=steps * hd)
        row = dict(name=name, B=B, S=S, H=H, hd=hd, dtype="float32",
                   underflow=underflow, checkpoint_steps=CKPT_STEPS,
                   checkpoint_bytes=4 * ckpt.numel(),
                   checkpoint_max_abs_err=ck_err,
                   max_abs_err=max(errs.values()), rel_err=rel,
                   emulation_rel_err=emu_rel, tol=BWD_TOL[torch.float32],
                   emulation_tol=SCAN_BWD_EMU_TOL, repeat_bitwise=True,
                   ms=ms["kernel"], ms_cold=ms_cold, plain_ms=plain["plain"],
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   bound_terms=terms, rows_ms=rows_ms,
                   rows_ms_cold=rows_ms_cold,
                   plan=dict(lanes=plan.lanes,
                             rows_per_thread=plan.rows_per_thread,
                             columns=plan.columns, rows=plan.rows,
                             reg_states=plan.reg_states,
                             threads=plan.threads, grid=list(plan.grid),
                             blocks=plan.blocks, smem_bytes=plan.smem_bytes),
                   blocks_per_sm=per_sm, sms=sms, waves=waves,
                   seconds=time.perf_counter() - t_row)
        log("rwkv6_scan_bwd", json.dumps(row))
        rows.append(row)
    return rows


def check_scan_bwd_build(libs: dict) -> None:
    """Registers and spills of the scans' backward instances and of the
    RWKV6 forward that saves the states, from the build logs; each
    float32 instance must build without spills. Checked where this
    process built the libraries."""
    found = []
    for lib, pattern in ((libs["rglru_scan"], "rglru_bwd_kernel"),
                         (libs["rwkv6_scan"], "rwkv6_scan_save_kernel"),
                         (libs["rwkv6_scan"], "rwkv6_bwd_dv_kernel"),
                         (libs["rwkv6_scan_bwd"], "rwkv6_bwd_")):
        instances = ptxas_summary(lib.build_log)
        if not instances:
            log(f"build {lib.name}: already built, backward spills not "
                "checked")
            continue
        mine = [r for r in instances if pattern in r["entry"]]
        if not mine:
            raise AssertionError(f"{lib.name}: no {pattern} instance in the "
                                 "build log")
        found += mine
    log("build scan backwards", json.dumps(dict(instances=found)))
    spilled = [r for r in found
               if r.get("spill_stores") or r.get("spill_loads")]
    if spilled:
        raise AssertionError(f"scan backward instances spill: {spilled}")


# --------------------------------------------------------------------------
# phase 5: the LMs at full width
# --------------------------------------------------------------------------


@contextlib.contextmanager
def plain_calls_counted():
    """Count the calls of the plain versions of the port's kernels, as
    their wrappers see them; yields the counts."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.matern_score import ops as mops
    from repro_torch.kernels.rglru_scan import ops as gops
    from repro_torch.kernels.rwkv6_scan import ops as wops

    targets = [(mops, "matern_score_ref"), (mops, "matern_posterior_ref"),
               (fops, "attention_ref"), (fops, "attention_lse_ref"),
               (fops, "attention_bwd_ref"), (dops, "decode_attention_ref"),
               (gops, "rglru_scan_ref"), (gops, "rglru_scan_bwd_ref"),
               (wops, "rwkv6_scan_ref"), (wops, "rwkv6_scan_bwd_ref"),
               (wops, "rwkv6_checkpoints_ref")]
    counts = {name: 0 for _, name in targets}

    def counted(name, fn):
        def wrap(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrap

    with contextlib.ExitStack() as stack:
        for mod, name in targets:
            stack.enter_context(mock.patch.object(
                mod, name, counted(name, getattr(mod, name))))
        yield counts


def check_launches(what, counts, want, plain):
    """Every kernel launched exactly ``want[name]`` times (0 if absent),
    and no plain version called."""
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{what}: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}: {counts}")
    if any(plain.values()):
        raise AssertionError(f"{what}: plain versions called on the card: "
                             f"{plain}")


def per(run, forwards=0, steps=0):
    """Launches of ``forwards`` forwards and ``steps`` decode steps."""
    names = set(run.per_forward) | set(run.per_step)
    return {k: forwards * run.per_forward.get(k, 0)
            + steps * run.per_step.get(k, 0) for k in names}


def split_phase(kernels, run, cfg, model):
    """SplitRunner at several splits against the unsplit forward."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.splitpoint import SplitRunner

    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (SPLIT_BATCH, SPLIT_SEQ)),
                             dtype=torch.int32, device=DEVICE)
    pos = torch.arange(SPLIT_SEQ, dtype=torch.int32, device=DEVICE
                       ).expand(SPLIT_BATCH, SPLIT_SEQ)
    runner = SplitRunner(cfg, model, SPLIT_BATCH, SPLIT_SEQ)
    kernels.reset_launch_counts()
    with plain_calls_counted() as plain:
        with torch.inference_mode():
            hidden, _, _ = tfm.forward(model, tokens=tokens, positions=pos)
            full = tfm.logits_fn(model, hidden)
        want_bytes = (SPLIT_BATCH * SPLIT_SEQ * cfg.d_model
                      * getattr(torch, cfg.dtype).itemsize)
        for l in run.splits:
            logits, bb = runner.run(l, tokens=tokens)
            torch.cuda.synchronize()
            err = float((logits.float() - full.float()).abs().max())
            log("split", json.dumps(dict(
                arch=run.arch, l=l, boundary_bytes=bb,
                max_abs_diff_vs_unsplit=err,
                finite=bool(logits.isfinite().all()))))
            if not torch.equal(logits, full):
                raise AssertionError(f"{run.arch}: split at l={l} differs "
                                     f"from the unsplit forward by up to "
                                     f"{err}")
            if bb != want_bytes:
                raise AssertionError(f"{run.arch}: boundary bytes {bb} at "
                                     f"l={l}, expected {want_bytes}")
    counts = kernels.launch_counts()
    check_launches(f"{run.arch} split", counts,
                   per(run, forwards=len(run.splits) + 1), plain)
    return counts


def serve_phase(kernels, run, cfg):
    """The port's serving entry point, with counts zeroed before."""
    from repro_torch.launch import serve
    from repro_torch.runtime.splitpoint import SplitRunner

    forward_s = []
    run_fn = SplitRunner.run

    def timed_run(self, *a, **k):            # the partitioned forwards
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = run_fn(self, *a, **k)
        torch.cuda.synchronize()
        forward_s.append(time.perf_counter() - t1)
        return out

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with plain_calls_counted() as plain, block_scoring_watched() as seen, \
            mock.patch.object(SplitRunner, "run", timed_run):
        res = serve.main(["--arch", run.arch, "--budget", str(SERVE_BUDGET),
                          "--device", DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    pb = serve.build_problem(cfg, SPLIT_SEQ)
    l, p = pb.denormalize(res.best_a)
    e, tau = pb.constraint_values(res.best_a)
    n_fwd = len(forward_s)          # every evaluation + the served batch
    log("serve", json.dumps(dict(
        arch=run.arch, split=l, power_w=p, energy_j=e, delay_s=tau,
        n_evals=res.n_evals, wall_s=wall, forwards=n_fwd,
        forward_s=sum(forward_s),
        forward_ms_median=1e3 * statistics.median(forward_s),
        rest_s=wall - sum(forward_s), launches=counts, plain_calls=plain,
        block_scoring=seen)))
    if n_fwd != res.n_evals + 1:
        raise AssertionError(f"{n_fwd} partitioned forwards for "
                             f"{res.n_evals} evaluations")
    if (l, round(p, 3), res.n_evals) != run.expect:
        raise AssertionError(f"{run.arch}: serving picked (l, P, evals) = "
                             f"{(l, p, res.n_evals)}, the CPU run "
                             f"{run.expect}")
    if counts["matern_score"] == 0:
        raise AssertionError(f"{run.arch} serve: matern_score never "
                             "launched")
    check_launches(f"{run.arch} serve", counts,
                   dict(per(run, forwards=n_fwd),
                        matern_score=counts["matern_score"]), plain)
    check_block_scoring(f"{run.arch} serve", seen, counts, plain, kernels)
    return counts


# each phase-5 greedy run's tokens (B, GEN_NEW) and logits (B, GEN_NEW,
# Vp), on the host: what phase 7b's tensor-parallel runs are held to
GENERATED = {}


def gen_prompt(cfg):
    """Phase 5's prompt (GEN_BATCH, GEN_PROMPT), drawn from seed 1."""
    rng = np.random.default_rng(1)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (GEN_BATCH, GEN_PROMPT)),
                           dtype=torch.int32, device=DEVICE)


@contextlib.contextmanager
def logits_recorded():
    """Each ``transformer.logits_fn`` call's logits at the last position
    (B, Vp), appended to the yielded list as the serving steps take
    them."""
    from repro_torch.models import transformer as tfm

    rec, fn = [], tfm.logits_fn

    def recorded(model, hidden):
        out = fn(model, hidden)
        rec.append(out[:, -1])
        return out

    with mock.patch.object(tfm, "logits_fn", recorded):
        yield rec


def forced_logits(model, cfg, tokens, ctx=None):
    """The logits (B, GEN_NEW, Vp) of phase 5's prefill and its
    GEN_NEW - 1 decode steps through the serving steps (under ``ctx``
    too), each decode step fed the token of ``tokens`` (B, GEN_NEW) at
    its position (teacher forcing), so two models' logits compare step
    by step on the same inputs."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import serve as rserve

    prompt = gen_prompt(cfg)
    cache = tfm.init_cache(cfg, GEN_BATCH, GEN_MAX_SEQ, dtype=cfg.dtype,
                           device=DEVICE, ctx=ctx)
    tokens = tokens.to(DEVICE)
    if ctx is not None:
        prompt = ctx.local(prompt, ("batch", None))
        tokens = ctx.local(tokens, ("batch", None))
    prefill = rserve.make_prefill_step(cfg, ctx)
    decode = rserve.make_decode_step(cfg, ctx)
    with logits_recorded() as rec:
        prefill(model, dict(tokens=prompt), cache)
        for j in range(GEN_NEW - 1):
            decode(model, tokens[:, j:j + 1], cache, GEN_PROMPT + j)
    return torch.stack(rec, 1)


def generate_phase(kernels, run, cfg, model):
    """Greedy decoding through ``greedy_generate``, counts zeroed before;
    then prefill and per-token decode times."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import serve as rserve

    prompt = gen_prompt(cfg)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plain_calls_counted() as plain, logits_recorded() as rec:
        out = rserve.greedy_generate(model, cfg, prompt, GEN_NEW, GEN_MAX_SEQ)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    GENERATED[run.arch] = dict(tokens=out.cpu(),
                               logits=torch.stack(rec, 1).cpu())
    steps = GEN_NEW - 1
    # the same run, timed by part: prefill, then each decode step
    prefill = rserve.make_prefill_step(cfg)
    decode = rserve.make_decode_step(cfg)
    times = dict(prefill=[], decode=[])
    for _ in range(3):
        cache = tfm.init_cache(cfg, GEN_BATCH, GEN_MAX_SEQ, dtype=cfg.dtype,
                               device=DEVICE)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok, cache = prefill(model, dict(tokens=prompt), cache)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for t in range(GEN_PROMPT, GEN_PROMPT + steps):
            tok, cache = decode(model, tok, cache, t)
        torch.cuda.synchronize()
        times["prefill"].append(1e3 * (t2 - t1))
        times["decode"].append(1e3 * (time.perf_counter() - t2) / steps)
    log("generate", json.dumps(dict(
        arch=run.arch, tokens_shape=list(out.shape),
        first_tokens=out[0, :8].tolist(), wall_s=wall, launches=counts,
        plain_calls=plain, prefill_ms=statistics.median(times["prefill"]),
        decode_ms_per_token=statistics.median(times["decode"]))))
    if tuple(out.shape) != (GEN_BATCH, GEN_NEW) or out.dtype != torch.int32:
        raise AssertionError(f"generated {tuple(out.shape)} {out.dtype}")
    if ((out < 0) | (out >= cfg.vocab_size)).any():
        raise AssertionError("a generated token is outside the vocabulary")
    check_launches(f"{run.arch} generate", counts,
                   per(run, forwards=1, steps=steps), plain)
    return counts


PORT_KERNELS = ("flash_attention", "flash_attention_bwd", "decode_attention",
                "matern_score", "rglru_scan", "rglru_scan_bwd", "rwkv6_scan",
                "rwkv6_scan_bwd")


def kernel_class(name: str) -> str:
    if "flash_bwd_" in name:
        return "flash_attention_bwd"
    if "rglru_bwd_" in name:
        return "rglru_scan_bwd"
    if "rwkv6_bwd_" in name:
        return "rwkv6_scan_bwd"
    if "rwkv6_scan_save_kernel" in name:
        return "rwkv6_scan"
    for kernel in PORT_KERNELS:
        if f"{kernel}_kernel" in name:
            return kernel
    if any(k in name.lower() for k in ("gemm", "gemv", "cutlass", "xmma",
                                       "cublas", "splitk", "nvjet")):
        return "matmul"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copy"
    return "other"


# CUDA kernels one launch of a wrapper runs: a decode_attention call is
# its splits and their merge (both names match kernel_class), a bf16
# flash_attention_bwd call its D, dq + dk/dv and group-sum kernels at
# every shape (float32 runs dq and dk/dv apart, four; every profiled path
# is bf16), an rwkv6_scan_bwd call its dv and ds0 (the forward's body in
# reverse time), row and du kernels
CUDA_KERNELS_PER_LAUNCH = dict(decode_attention=2, flash_attention_bwd=3,
                               rwkv6_scan_bwd=3)
PROFILE_RETRIES = 2
# calls of a phase-5 path under the profiler: its events (tens of
# thousands a call for the LMs) take Python time each to read back, the
# larger part of a model's phase at 10-16 calls
PROFILED_CALLS = 2


def profiled(fn, n):
    """Device ms per call by kernel class and by name, and the CUDA
    kernels of each class over ``n`` calls, from ``torch.profiler``. The
    device records are read from the profiler's raw results: building
    its event tree (``prof.events()``) for a training step's tens of
    thousands of kernels and their ops took 14-24 s a step on an H100
    host, the same records either way."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy, counts, by_name = {}, {}, {}
    for ev in prof.profiler.kineto_results.events():
        if (ev.device_type() != torch.autograd.DeviceType.CUDA
                or ev.name().startswith("[") or ev.is_hidden_event()):
            continue
        name = ev.name()
        ms = (ev.end_ns() - ev.start_ns()) / 1e6 / n
        c = kernel_class(name)
        busy[c] = busy.get(c, 0.0) + ms
        counts[c] = counts.get(c, 0) + 1
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + ms
    return busy, counts, by_name


def profile_calls(arch, path, fn, n, launches, extra=None, profiled_n=None):
    """Host ms per call (CUDA-synchronised, no profiler) over n calls,
    then the device time per call by kernel class from ``torch.profiler``
    over ``profiled_n`` (default n) more; the idle share is 1 - device
    busy / host time. ``launches``
    is the port's kernel launches of one call (``MODEL_RUNS``): the
    profile must hold exactly that many CUDA kernels of each port kernel
    a call. Where the profiler dropped events, the path is profiled again
    with half the calls, at most PROFILE_RETRIES times; a line that is
    still short raises. ``extra`` joins the logged line, which is
    returned."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / n
    want = {c: launches.get(c, 0) * CUDA_KERNELS_PER_LAUNCH.get(c, 1)
            for c in PORT_KERNELS}
    host_n, n = n, profiled_n or n
    short = []
    for attempt in range(PROFILE_RETRIES + 1):
        busy, counts, by_name = profiled(fn, n)
        got = {c: counts.get(c, 0) for c in PORT_KERNELS}
        if got == {c: w * n for c, w in want.items()}:
            break
        if any(got[c] > want[c] * n for c in PORT_KERNELS):
            raise AssertionError(f"{arch} {path}: the profile holds more "
                                 f"port kernels than launched: {got} over "
                                 f"{n} calls, {want} a call")
        short.append(dict(calls=n, port_kernels=got))
        log(f"profile {arch} {path}: events dropped over {n} calls "
            f"({got}, {want} a call)")
        n = max(1, n // 2)
    else:
        raise AssertionError(f"{arch} {path}: the profiler dropped events "
                             f"in {len(short)} tries: {short}")
    total = sum(busy.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    line = dict(
        arch=arch, path=path, calls=n, host_calls=host_n,
        host_ms_per_call=host_ms,
        device_busy_ms_per_call=total if total else "not measured",
        idle_share=1 - total / host_ms if total else "not measured",
        device_ms_by_class=busy,
        kernels_per_call={c: k / n for c, k in counts.items()},
        port_kernels_per_call=want, short_tries=short,
        top_kernels_ms=dict(top), **(extra or {}))
    log("profile", json.dumps(line))
    return line


def profile_phase(run, cfg, model):
    """Where the time goes: one split-serving forward (an evaluation of
    the BO), one prefill, one decode step."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import serve as rserve
    from repro_torch.runtime.splitpoint import SplitRunner

    runner = SplitRunner(cfg, model, SPLIT_BATCH, SPLIT_SEQ)
    l = run.splits[2]
    profile_calls(run.arch, f"split_serving_forward_l{l}",
                  lambda: runner.run(l), 10, per(run, forwards=1),
                  profiled_n=PROFILED_CALLS)
    rng = np.random.default_rng(3)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (GEN_BATCH, GEN_PROMPT)),
                             dtype=torch.int32, device=DEVICE)
    prefill = rserve.make_prefill_step(cfg)
    decode = rserve.make_decode_step(cfg)
    cache = tfm.init_cache(cfg, GEN_BATCH, GEN_MAX_SEQ, dtype=cfg.dtype,
                           device=DEVICE)
    profile_calls(run.arch, "prefill_512",
                  lambda: prefill(model, dict(tokens=prompt), cache), 3,
                  per(run, forwards=1), profiled_n=PROFILED_CALLS)
    tok = prompt[:, -1:]
    profile_calls(run.arch, "decode_step",
                  lambda: decode(model, tok, cache, GEN_PROMPT), 16,
                  per(run, steps=1), profiled_n=PROFILED_CALLS)


def prefill_decode(cfg, model, dtype):
    """Prefill on S - 1 tokens then one decode step, and the full
    forward: the last position's hidden state of each, in float32."""
    from repro_torch.models import transformer as tfm

    rng = np.random.default_rng(2)
    S = GEN_PROMPT
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (GEN_BATCH, S)),
                          dtype=torch.int32, device=DEVICE)
    pos = torch.arange(S, dtype=torch.int32, device=DEVICE
                       ).expand(GEN_BATCH, S)
    with torch.inference_mode():
        full, _, _ = tfm.forward(model, tokens=tok, positions=pos)
        cache = tfm.init_cache(cfg, GEN_BATCH, GEN_MAX_SEQ, dtype=dtype,
                               device=DEVICE)
        tfm.forward(model, tokens=tok[:, :-1], positions=pos[:, :-1],
                    cache=cache, t=0, mode="prefill")
        dec, _, _ = tfm.forward(model, tokens=tok[:, -1:],
                                positions=pos[:, -1:], cache=cache, t=S - 1,
                                mode="decode")
    return dec[:, 0].float(), full[:, -1].float()


# MoE layers (phase 5): how many assignments drop, and where the time goes


@contextlib.contextmanager
def moe_recorded():
    """Record each capacity dispatch of the MoE layers: its tokens T,
    top-k, capacity C, the experts' loads (a host read a layer, so only
    in untimed passes) and the top-k ids; yields the records."""
    from repro_torch.models import moe

    records = []
    dispatch = moe._dispatch_ffn_capacity

    def recorded(xt, topw, topi, wg, wu, wd, cfg, e_lo, e_n, cap, **kw):
        load = torch.bincount(topi.reshape(-1), minlength=cfg.n_experts)
        records.append(dict(T=xt.shape[0], k=topi.shape[1], E=e_n, C=cap,
                            load=load.tolist(), ids=topi))
        return dispatch(xt, topw, topi, wg, wu, wd, cfg, e_lo, e_n, cap,
                        **kw)

    with mock.patch.object(moe, "_dispatch_ffn_capacity", recorded):
        yield records


def drop_stats(records):
    """For each T among the records (a path: its MoE layers), the
    assignments, capacity, mean load, dropped assignments in total and
    at the worst layer, and the largest expert load."""
    out = {}
    for T in dict.fromkeys(r["T"] for r in records):
        rows = [r for r in records if r["T"] == T]
        drops = [sum(max(n - r["C"], 0) for n in r["load"]) for r in rows]
        r0 = rows[0]
        out[T] = dict(tokens=T, layers=len(rows), assignments=T * r0["k"],
                      capacity=r0["C"], mean_load=T * r0["k"] / r0["E"],
                      dropped=sum(drops), dropped_worst_layer=max(drops),
                      largest_load=max(max(r["load"]) for r in rows))
    return out


@contextlib.contextmanager
def moe_capacity(model, factor):
    """The model's MoE layers at another capacity factor."""
    from repro_torch.models.moe import MoE

    layers = [m for m in model.modules() if isinstance(m, MoE)]
    cfg = layers[0].cfg
    for m in layers:
        m.cfg = dataclasses.replace(cfg, capacity_factor=factor)
    try:
        yield
    finally:
        for m in layers:
            m.cfg = cfg


def moe_device_ms(fn):
    """The MoE layers' device ms in one call of ``fn`` (after a warm-up),
    from ``torch.profiler``: in total, in the expert products (their
    ``aten::bmm``), in the shared experts' MLP and in the rest (routing,
    dispatch, combine); each layer is a ``record_function`` range, read
    from its CPU event's device time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import moe

    def ranged(name, f):
        def wrap(*a, **k):
            with record_function(name):
                return f(*a, **k)
        return wrap

    with mock.patch.object(moe, "moe_apply",
                           ranged("moe_layer", moe.moe_apply)), \
            mock.patch.object(moe, "mlp_apply",
                              ranged("moe_shared_mlp", moe.mlp_apply)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()

    def within(ev, name, skip=None):
        """Device ms of the events named ``name`` under ``ev``."""
        if ev.name == name:
            return ev.device_time_total / 1e3
        return sum(within(c, name, skip) for c in ev.cpu_children
                   if c.name != skip)

    cpu = torch.autograd.DeviceType.CPU
    layers = [ev for ev in prof.events()
              if ev.name == "moe_layer" and ev.device_type == cpu]
    total = sum(ev.device_time_total for ev in layers) / 1e3
    if not total:
        return dict(layers=len(layers), moe_ms="not measured")
    experts = sum(within(ev, "aten::bmm", skip="moe_shared_mlp")
                  for ev in layers)
    shared = sum(within(ev, "moe_shared_mlp") for ev in layers)
    return dict(layers=len(layers), moe_ms=total, experts_bmm_ms=experts,
                shared_mlp_ms=shared, other_ms=total - experts - shared)


def moe_phase(run, cfg, model):
    """A ``moe`` line for each path of the MoE model: the split-serving
    forward (T = 2 x 32), the full forward (2 x 512), the prefill (2 x
    511) and one decode step (T 2): drops (``drop_stats``), the summed
    aux loss, and the MoE layers' device ms (``moe_device_ms``)."""
    from repro_torch.models import transformer as tfm

    def tokens(seed, B, S):
        rng = np.random.default_rng(seed)
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                              dtype=torch.int32, device=DEVICE)
        return tok, torch.arange(S, dtype=torch.int32, device=DEVICE
                                 ).expand(B, S)

    split_tok, split_pos = tokens(0, SPLIT_BATCH, SPLIT_SEQ)
    tok, pos = tokens(2, GEN_BATCH, GEN_PROMPT)
    cache = tfm.init_cache(cfg, GEN_BATCH, GEN_MAX_SEQ, dtype=cfg.dtype,
                           device=DEVICE)
    paths = dict(
        split_serving_forward=lambda: tfm.forward(
            model, tokens=split_tok, positions=split_pos),
        forward=lambda: tfm.forward(model, tokens=tok, positions=pos),
        prefill=lambda: tfm.forward(
            model, tokens=tok[:, :-1], positions=pos[:, :-1], cache=cache,
            t=0, mode="prefill"),
        decode_step=lambda: tfm.forward(
            model, tokens=tok[:, -1:], positions=pos[:, -1:], cache=cache,
            t=GEN_PROMPT - 1, mode="decode"))
    with torch.inference_mode():
        for path, fn in paths.items():
            with moe_recorded() as records:
                _, _, aux = fn()
            (stats,) = drop_stats(records).values()
            log("moe", json.dumps(dict(
                arch=run.arch, path=path, aux=float(aux),
                capacity_factor=cfg.capacity_factor, **stats,
                device_ms=moe_device_ms(fn))))


def routes_checked(run, cfg, model, dtype):
    """``prefill_decode``, with each MoE route's drops recorded (the
    full forward T 1024, the prefill T 1022, the decode step T 2). The
    capacity path drops by design, and the two routes see other loads:
    where either drops, the check runs again on the same weights at the
    capacity factor E / k (C >= T: nothing can drop). Logs which check
    ran; returns (dec, full) of the check that counts and its MoE
    dispatches' records (``moe_recorded``; none for a dense model)."""
    if not cfg.moe:
        return prefill_decode(cfg, model, dtype), []
    with moe_recorded() as records:
        out = prefill_decode(cfg, model, dtype)
    drops = {T: d["dropped"] for T, d in drop_stats(records).items()}
    line = dict(arch=run.arch, dtype=str(dtype).split(".")[-1],
                capacity_factor=cfg.capacity_factor, dropped_by_tokens=drops,
                check="as configured")
    if any(drops.values()):
        factor = cfg.n_experts / cfg.top_k
        with moe_capacity(model, factor), moe_recorded() as records:
            out = prefill_decode(cfg, model, dtype)
        again = {T: d["dropped"] for T, d in drop_stats(records).items()}
        line.update(check=f"drop-free capacity_factor {factor}",
                    dropped_by_tokens_drop_free=again)
        if any(again.values()):
            raise AssertionError(f"{run.arch}: {again} dropped at "
                                 f"capacity factor {factor}")
    log("moe_decode_check", json.dumps(line))
    return out, records


def route_flips(run, cfg, rec16, rec32):
    """A ``moe_route_flips`` line: the routed (token, expert) pairs that
    differ between the bf16 and the float32 checks of ``routes_checked``
    (each path's layers: the full forward T 1024, the prefill T 1022,
    the decode step T 2), and within each dtype between the prefill or
    the decode step and the full forward at the same positions (the two
    routes ``decode_check`` compares)."""
    E, L, S = cfg.n_experts, cfg.n_layers, GEN_PROMPT
    paths = ("forward", "prefill", "decode_step")

    def by_path(rec):
        if len(rec) != len(paths) * L:
            raise AssertionError(f"{run.arch}: {len(rec)} MoE dispatches "
                                 f"in prefill + decode, {len(paths) * L} "
                                 "expected")
        return {p: [r["ids"] for r in rec[i * L:(i + 1) * L]]
                for i, p in enumerate(paths)}

    def count(a, b):
        return int(sum(pairs_differ(x, y, E) for x, y in zip(a, b)))

    def within(ids):
        full = [f.reshape(GEN_BATCH, S, -1) for f in ids["forward"]]
        return dict(
            prefill_vs_forward=count(
                ids["prefill"], [f[:, :-1].reshape(-1, f.shape[-1])
                                 for f in full]),
            decode_vs_forward=count(ids["decode_step"],
                                    [f[:, -1] for f in full]))

    i16, i32 = by_path(rec16), by_path(rec32)
    log("moe_route_flips", json.dumps(dict(
        arch=run.arch, layers=L,
        pairs={p: L * i16[p][0].numel() for p in paths},
        bf16_vs_float32={p: count(i16[p], i32[p]) for p in paths},
        bf16=within(i16), float32=within(i32))))


def decode_check(run, bf16, f32):
    """Prefill + decode against the full forward. Float32: within
    HIDDEN_TOL. Bfloat16: the two routes may differ by no more than the
    bf16 forward differs from the float32 copy on the same inputs (its
    own rounding error), and within ``run.bf16_tol`` where one is set.
    With ``run.bf16_vs_float32`` the bf16 decode route is held to the
    float32 forward instead, within that same error: where the two bf16
    routes round independently (Qwen1.5-MoE-A2.7B on the H100: its 16 KV
    heads through flash and through split-T decode give last hidden
    states 5 bf16 ulps apart, each about 4 from float32), they may
    differ by up to twice it while each is as close to float32."""
    (dec16, full16), (dec32, full32) = bf16, f32
    atol, rtol = HIDDEN_TOL
    err32 = float((dec32 - full32).abs().max())
    ok32 = bool(torch.allclose(dec32, full32, atol=atol, rtol=rtol))
    err16 = float((dec16 - full16).abs().max())
    rounding = float((full16 - full32).abs().max())
    dec_err = float((dec16 - full32).abs().max())
    ok16 = (dec_err if run.bf16_vs_float32 else err16) <= rounding
    if run.bf16_tol:
        ok16 = ok16 and bool(torch.allclose(dec16, full16,
                                            atol=run.bf16_tol[0],
                                            rtol=run.bf16_tol[1]))
    # against Qwen2-1.5B's bf16_tol: <= 1 where it would hold
    qwen2_tol = float(((dec16 - full16).abs()
                       / (3e-2 + 2e-2 * full16.abs())).max())
    log("decode_vs_forward", json.dumps(dict(
        arch=run.arch, float32_max_abs_err=err32, float32_atol=atol,
        float32_rtol=rtol, bf16_max_abs_err=err16,
        bf16_forward_vs_float32=rounding, bf16_tol=run.bf16_tol,
        bf16_vs_float32=run.bf16_vs_float32, dec_bf16_vs_float32=dec_err,
        bf16_err_over_qwen2_tol=qwen2_tol,
        hidden_absmax=float(full32.abs().max()), ok=ok32 and ok16)))
    for name, t in (("bf16", dec16), ("float32", dec32)):
        if not bool(t.isfinite().all()):
            raise AssertionError(f"{run.arch}: {name} decode is not finite")
    if not ok32:
        raise AssertionError(f"{run.arch}: prefill + decode differs from "
                             f"the forward by {err32} in float32")
    if not ok16:
        raise AssertionError(f"{run.arch}: prefill + decode differs from "
                             f"the forward by {err16} in bf16, from the "
                             f"float32 forward by {dec_err} (the bf16 "
                             f"forward's own error: {rounding})")


def float32_copy(cfg32):
    """The bf16 model's weights in float32, with no bf16 model resident:
    drawn as ``init_model`` drew it (from seed 0, in float32, then cast),
    each leaf rounded through bf16."""
    from repro_torch.models import transformer as tfm

    model = tfm.init_model(cfg32, torch.Generator(DEVICE).manual_seed(0),
                           DEVICE)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.bfloat16())
    return model


def model_phase(kernels, run):
    """Phase 5 for one model: serve (the entry point builds and frees its
    own model), load the model, split, decode, profile, check decoding
    in bf16, free it, check decoding on a float32 copy; a
    ``model_phase`` line gives each step's seconds. Returns the launch
    counts of its serving, split and generation runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    steps, lap = {}, [time.perf_counter()]

    def step(name, fn, *a):
        out = fn(*a)
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - lap[0]
        lap[0] = time.perf_counter()
        return out

    cfg = get_config(run.arch)
    counts = dict(serve=step("serve", serve_phase, kernels, run, cfg))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = step("init", tfm.init_model, cfg,
                 torch.Generator(DEVICE).manual_seed(0), DEVICE)
    log("model", json.dumps(dict(
        arch=run.arch, params=sum(p.numel() for p in model.parameters()),
        param_counts=cfg.param_counts(), dtype=cfg.param_dtype,
        init_s=steps["init"],
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)))
    counts.update(
        split=step("split", split_phase, kernels, run, cfg, model),
        generate=step("generate", generate_phase, kernels, run, cfg, model))
    step("profile", profile_phase, run, cfg, model)
    if cfg.moe:
        step("moe", moe_phase, run, cfg, model)
    bf16, rec16 = step("bf16 check", routes_checked, run, cfg, model,
                       torch.bfloat16)
    del model
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = step("float32 copy", float32_copy, cfg32)
    f32, rec32 = step("float32 check", routes_checked, run, cfg32, model32,
                      torch.float32)
    GENERATED[run.arch]["logits32"] = step(
        "float32 logits", lambda: forced_logits(
            model32, cfg32, GENERATED[run.arch]["tokens"]).float().cpu())
    decode_check(run, bf16, f32)
    if cfg.moe:
        route_flips(run, cfg, rec16, rec32)
    del model32
    torch.cuda.empty_cache()
    log("model_phase", json.dumps(dict(arch=run.arch, seconds=steps)))
    return counts


# --------------------------------------------------------------------------
# phase 6: training
# --------------------------------------------------------------------------

TRAIN_ARCH = "qwen2-1.5b"
# 6a: full width and depth, bf16 as configured, remat as configured. At
# width 1536 Adam's first steps move every weight by about lr whatever
# its gradient's size, and from lr 1e-4 up the loss rises over 30 steps
# (1e-3: the mean of the last five 0.59 above the first five's, the
# held-out loss 0.71-0.86 up); 1e-5 lowers both the most of 3e-5, 1e-5
# and 3e-6 (benchmarks/train_lr_sweep_torch.py on an H100); 20 steps
# (cut from 30 for the script's time) lower both as well
TRAIN_RUN = dict(steps=20, batch=4, seq=512, microbatches=2, lr=1e-5,
                 optimizer="adamw")
# the recurrent LMs, after Qwen2-1.5B's runs, one model at a time: 6a as
# TRAIN_RUN at lr 1e-5, the loss held over the first and last three
# steps. The warm-up takes 20 steps, so 10 steps end at half the peak
# lr. In 10 steps 1e-5 lowers RWKV6-3B's loss and held-out loss (1e-4
# lowers them more); none of 3e-4, 1e-4, 3e-5 and 1e-5 lowers
# RecurrentGemma-2B's held-out loss, which 1e-5 lowers over 20 steps
# (benchmarks/train_lr_sweep_torch.py on an H100)
RECURRENT_ARCHS = ("rwkv6-3b", "recurrentgemma-2b")
RECURRENT_RUN = {
    "recurrentgemma-2b": dict(steps=20, batch=4, seq=512, microbatches=2,
                              lr=1e-5, optimizer="adamw"),
    "rwkv6-3b": dict(steps=10, batch=4, seq=512, microbatches=2, lr=1e-5,
                     optimizer="adamw"),
}
# Qwen1.5-MoE-A2.7B, last, alone on the card: 14.3 B bf16 parameters and
# their bf16 gradients are 57.3 GB, so Adafactor (AdamW's float32
# moments would add 114.5 GB) and one microbatch (two would add a 57.3 GB
# float32 accumulator); 10 steps at lr 1e-5, the loss held over the first
# and last three steps. In 10 steps 1e-5 lowers the loss and the held-out
# loss (by 0.007 and 0.011), 3e-5 lowers both more (0.021 and 0.036) and
# 1e-4 raises both (benchmarks/train_lr_sweep_torch.py on an H100); 3e-5
# is the next choice should a change leave 1e-5 short
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_RUN = dict(steps=10, batch=4, seq=512, microbatches=1, lr=1e-5,
               optimizer="adafactor")
# steps at each end of a 6a run whose mean losses are compared; the lr
# sweep (benchmarks/train_lr_sweep_torch.py) judges a rate by the same
LOSS_WINDOW = {TRAIN_ARCH: 5, "recurrentgemma-2b": 3, "rwkv6-3b": 3,
               MOE_ARCH: 3}
# two batches the run never sees: their mean loss must fall too
HELD_OUT_STEPS = (1000, 1001)
# 6b: one step at full width, float32, kernels vs plain, with the 6a
# run's optimizer: 2 layers of Qwen2-1.5B (and the same step in bf16),
# one pattern cycle of RecurrentGemma-2B (rglru, rglru, local), 2 layers
# of RWKV6-3B and 2 MoE layers of Qwen1.5-MoE-A2.7B (Adafactor)
STEP_CHECK = dict(layers=2, batch=2, seq=512, lr=1e-3)
STEP_CHECK_LAYERS = {TRAIN_ARCH: 2, "recurrentgemma-2b": 3, "rwkv6-3b": 2,
                     MOE_ARCH: 2}
# gradients of the two routes: float32 sums in another order, through 2
# layers and the CE; of each leaf's largest magnitude
STEP_GRAD_TOL = 1e-4
# 6b in bf16 (the same weights rounded to bf16, through the kernels)
# against the float32 plain step: the attention kernels may carry into a
# leaf's gradient the bf16 forward's error (ATTN_ATOL, 2e-2 of an output
# of magnitude ~1) and the backward's (BWD_TOL, 2e-2 of each gradient's
# largest magnitude), 4e-2 in all; bf16 rounding elsewhere in the step
# adds less (at most 1.6e-2 through the plain attention on the card)
STEP_GRAD_TOL_BF16 = ATTN_ATOL[torch.bfloat16] + BWD_TOL[torch.bfloat16]
# the updated parameters: Adam's first step is g / (|g| + eps) an
# element, so an element whose gradient is float32 noise (1e-7 of its
# leaf's largest) may move anywhere within a sign flip (2 lr) between
# the two routes: all but STEP_SHARE of the elements within STEP_ATOL x
# lr (the CPU tests' bar, tests/test_torch_train.py), every element
# within STEP_ATOL_ALL x lr (its first card run: 0.1 lr at most over the
# 327 M elements, 6.8e-5 of them beyond 1e-3 lr)
STEP_ATOL, STEP_SHARE, STEP_ATOL_ALL = 1e-3, 1e-3, 2.0
# 6c: 2 layers at full width, the vocab cut to train_100m.py's 32,000,
# bf16, a checkpoint every 2 steps, a failure at step 3: Qwen2-1.5B with
# AdamW and int8 gradient compression, Qwen1.5-MoE-A2.7B with Adafactor
RESUME = dict(layers=2, vocab=32_000, steps=6, every=2, fail_at=3,
              batch=2, seq=256, lr=1e-3)
RESUME_RUN = {TRAIN_ARCH: dict(optimizer="adamw", compress=True),
              MOE_ARCH: dict(optimizer="adafactor", compress=False)}
# the MoE layer's determinism check: one full-width layer, bf16, the 6a
# run's T = 4 x 512 tokens at the configured capacity factor (1.5: C
# 204), its backward twice. The tokens are 64 prototype hidden states
# plus noise of 0.1 their scale, so the routing concentrates as a real
# batch's does and assignments drop (unit-normal tokens spread evenly:
# the largest load 170, nothing dropped, in the first card run)
MOE_LAYER_CHECK = dict(batch=4, seq=512, prototypes=64, noise=0.1, seed=7)


def train_run(arch):
    """The 6a run of ``arch``."""
    return {TRAIN_ARCH: TRAIN_RUN, MOE_ARCH: MOE_RUN}.get(
        arch) or RECURRENT_RUN[arch]




def train_launches(cfg, microbatches):
    """Kernel launches of one training step: each attention, RG-LRU or
    RWKV6 layer's forward kernel once a microbatch, twice under remat
    (the backward runs the layer again), and its backward kernel once."""
    kinds = cfg.layer_kinds()
    fwd = microbatches * (2 if cfg.remat else 1)
    out = {}
    for kernel, names in (("flash_attention", ("attn", "local",
                                               "attn_dense")),
                          ("rglru_scan", ("rglru",)),
                          ("rwkv6_scan", ("rwkv",))):
        n = sum(k in names for k in kinds)
        if n:
            out[kernel] = n * fwd
            out[f"{kernel}_bwd"] = n * microbatches
    return out


def device_batch(pipe, step):
    return {k: torch.as_tensor(v, device=DEVICE)
            for k, v in pipe.batch_at(step).items()}


def held_out_loss(model, cfg, batches):
    """The mean loss of ``batches``, no gradient."""
    from repro_torch.train.trainer import loss_fn

    with torch.no_grad():
        return statistics.mean(float(loss_fn(model, b, cfg)[0])
                               for b in batches)


def model_flops(cfg, n_params, B, S):
    """Model operations of one training step, recompute not counted: 6
    per parameter per token (the tied embedding once, as the unembedding;
    for an MoE the parameters a token reaches, ``param_counts()``'s
    ``active``) and 12 hd per allowed (q, k) pair per q head per attention
    layer."""
    n_attn = sum(k in ("attn", "local", "attn_dense")
                 for k in cfg.layer_kinds())
    pairs = B * allowed_pairs(S, S, 0)
    return 6 * n_params * B * S + 12 * cfg.hd * cfg.n_heads * n_attn * pairs


def train_breakdown(cfg, model, opt, opt_state, batch, microbatches):
    """One microbatch's trunk forward, cross-entropy (forward and
    backward, to the hidden state and the unembedding), trunk backward
    (remat's second forward included), and one optimizer update, each on
    the host's clock between synchronisations. Updates the model."""
    from repro_torch.models import transformer as tfm
    from repro_torch.train.losses import vocab_parallel_ce
    from repro_torch.train.trainer import trainable_params

    params = trainable_params(model)
    toks = batch["tokens"][:batch["tokens"].shape[0] // microbatches]
    inp, labels = toks[:, :-1], toks[:, 1:]
    B, S = labels.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=DEVICE).expand(B, S)
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        return out

    with torch.enable_grad():
        hidden, _, _ = timed("forward", lambda: tfm.forward(
            model, tokens=inp, positions=positions, mode="train"))
        h = hidden.detach().requires_grad_(True)
        w = model.embed if cfg.tie_embeddings else model.unembed
        dh, _ = timed("ce", lambda: torch.autograd.grad(
            vocab_parallel_ce(h, tfm.unembed_weight(model), labels, cfg),
            (h, w)))
        grads = timed("backward", lambda: torch.autograd.grad(
            hidden, list(params.values()), dh, allow_unused=True,
            materialize_grads=True))
    # the optimizer takes the gradients in their own dtype and clips them
    # leaf by leaf, as the step does
    grads = dict(zip(params, grads))
    timed("optimizer", lambda: opt.update(grads, opt_state, params))
    per_step = {k: v * (1 if k == "optimizer" else microbatches)
                for k, v in ms.items()}
    return dict(microbatch_ms=ms, step_ms=per_step)


def train_phase(kernels, arch=TRAIN_ARCH, moe_layer=None):
    """6a: ``launch.train`` on ``arch`` at full width and depth
    (``train_run(arch)``); the loss must fall (the mean of the last
    ``LOSS_WINDOW`` steps below the first's, and the held-out loss below
    the seeded weights'), each step must launch exactly
    ``train_launches``' kernels and no plain version; a ``train`` line
    with step times, tokens/s, device busy and idle share of a profiled
    step, peak memory, the loss curve, MFU, the optimizer the run used
    and the step split into forward, backward, CE and optimizer; for an
    MoE a ``moe`` line of one more step (``moe_train_line``, with the
    expert products' times from ``moe_layer``, ``moe_layer_phase``'s).
    Returns the launches of the run by kernel."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as tfm

    a = train_run(arch)
    cfg = get_config(arch)
    mb = a["microbatches"]
    t_part = [time.perf_counter()]
    seconds = {}

    def lap(name):
        seconds[name] = time.perf_counter() - t_part[0]
        t_part[0] = time.perf_counter()

    argv = ["--arch", arch, "--steps", str(a["steps"]), "--batch",
            str(a["batch"]), "--seq", str(a["seq"]), "--microbatches",
            str(mb), "--lr", str(a["lr"]), "--optimizer", a["optimizer"],
            "--ckpt", ""]
    per_step = train_launches(cfg, mb)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, a["batch"], a["seq"])
    held = [device_batch(pipe, s) for s in HELD_OUT_STEPS]
    fresh = tfm.init_model(cfg, torch.Generator(DEVICE).manual_seed(0),
                           DEVICE)
    held_before = held_out_loss(fresh, cfg, held)
    del fresh
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lap("held_out_before")
    with plain_calls_counted() as plain:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        run = train_mod.train(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    check_launches(f"train {arch}", counts,
                   {k: v * a["steps"] for k, v in per_step.items()}, plain)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = run.losses
    w = LOSS_WINDOW[arch]
    first, last = statistics.mean(losses[:w]), statistics.mean(losses[-w:])
    held_after = held_out_loss(run.model, cfg, held)
    lap("run")
    if not (len(losses) == a["steps"] and last < first
            and held_after < held_before and all(np.isfinite(losses))):
        raise AssertionError(f"train {arch}: the loss did not fall: "
                             f"{losses}, held-out {held_before} -> "
                             f"{held_after}")
    if run.optimizer != a["optimizer"]:
        raise AssertionError(f"train {arch}: the run used {run.optimizer}, "
                             f"not {a['optimizer']}")
    n_params = sum(p.numel() for p in run.model.parameters())
    n_model = cfg.param_counts()["active"] if cfg.moe else n_params
    tokens = a["batch"] * a["seq"]
    steady = run.step_seconds[2:]
    step_s = statistics.median(steady)

    opt, step_fn = train_mod.build(cfg, run.model, lr=a["lr"],
                                   total_steps=a["steps"],
                                   num_microbatches=mb,
                                   optimizer=run.optimizer)
    batch = device_batch(pipe, a["steps"])
    state = [run.state]

    def one_step():
        state[0], m = step_fn(state[0], batch)
        return m

    prof = profile_calls(arch, "train_step", one_step, 1, per_step,
                         profiled_n=1)
    lap("profile")
    if cfg.moe:
        moe_train_line(arch, cfg, one_step, a, moe_layer)
        lap("moe")
    split = train_breakdown(cfg, run.model, opt, state[0][1], batch, mb)
    lap("breakdown")
    flops = model_flops(cfg, n_model, a["batch"], a["seq"])
    busy = prof["device_busy_ms_per_call"]
    log("train", json.dumps(dict(
        arch=arch, params=n_params, param_counts=cfg.param_counts(),
        flops_params=n_model, dtype=cfg.param_dtype, remat=cfg.remat,
        optimizer=run.optimizer,
        **{k: v for k, v in a.items() if k != "optimizer"},
        tokens_per_step=tokens, wall_s=wall,
        step_ms=[1e3 * t for t in run.step_seconds],
        step_ms_median=1e3 * step_s, tokens_per_s=tokens / step_s,
        device_busy_ms_per_step=busy, idle_share=prof["idle_share"],
        host_ms_profiled_step=prof["host_ms_per_call"],
        peak_memory_gb=peak_gb, optimizer_state_gb=sum(
            t.numel() * t.element_size()
            for t in _flat_state(state[0][1]).values()) / 1e9,
        losses=losses, loss_window=w,
        first_mean=first, last_mean=last, held_out_steps=HELD_OUT_STEPS,
        held_out_loss_before=held_before, held_out_loss_after=held_after,
        launches_per_step=per_step,
        launches=counts, plain_calls=plain, split=split,
        model_tflop_per_step=flops / 1e12,
        mfu=flops / step_s / PEAK_BF16_FLOPS,
        mfu_device_busy=(flops / (busy / 1e3) / PEAK_BF16_FLOPS
                         if isinstance(busy, float) else "not measured"),
        seconds=seconds)))
    del run, state, step_fn, opt
    torch.cuda.empty_cache()
    return {k: a["steps"] * v for k, v in per_step.items()}


def moe_train_line(arch, cfg, one_step, a, layer):
    """A ``moe`` line of one more training step: its MoE layers' drops
    (the forward's dispatches; remat runs each layer again in the
    backward), the step's aux loss, the operations the capacity buffers
    execute (E C rows a layer) against the T k the assignments need, and
    the expert products' device ms forward and backward: those of one
    layer at this shape (``moe_layer_phase``), times the layers, the
    forward taken twice under remat."""
    with moe_recorded() as records:
        m = one_step()
    L = cfg.n_layers
    if len(records) != L * (2 if cfg.remat else 1):
        raise AssertionError(f"{arch}: {len(records)} MoE dispatches in a "
                             f"step of {L} layers")
    (stats,) = drop_stats(records[:L]).values()
    T, k, E, C = (records[0][x] for x in ("T", "k", "E", "C"))
    row_flops = 6 * 3 * cfg.d_model * cfg.d_ff
    fwd = 2 if cfg.remat else 1
    bmm = {}
    if isinstance(layer.get("experts_bmm_fwd_ms"), float):
        bmm = dict(
            experts_bmm_ms_per_layer=dict(
                forward=layer["experts_bmm_fwd_ms"],
                backward=layer["experts_bmm_bwd_ms"]),
            experts_bmm_ms_per_step=dict(
                forward=L * fwd * layer["experts_bmm_fwd_ms"],
                backward=L * layer["experts_bmm_bwd_ms"]))
    log("moe", json.dumps(dict(
        arch=arch, path="train_step", aux=float(m["aux"]),
        capacity_factor=cfg.capacity_factor, batch=a["batch"], seq=a["seq"],
        **stats, capacity_rows=E * C, assignment_rows=T * k,
        expert_tflop_executed=L * E * C * row_flops / 1e12,
        expert_tflop_assigned=L * T * k * row_flops / 1e12,
        expert_ms_from="moe_layer_check at this shape, times the layers",
        **bmm)))


@contextlib.contextmanager
def plain_route():
    """The models' kernels replaced by their plain versions, autograd
    through them: ``attention_ref`` for ``flash_attention`` and the
    plain scans for ``rglru_scan`` and ``rwkv6_scan``."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.models import rwkv6 as rwkv6_mod
    from repro_torch.models import transformer as tfm

    with mock.patch.object(tfm, "flash_attention", attention_ref), \
            mock.patch.object(rglru_mod, "rglru_scan",
                              lambda a, b, h0, h_out=None:
                              rglru_scan_ref(a, b, h0)), \
            mock.patch.object(rwkv6_mod, "rwkv6_scan",
                              lambda r, k, v, logw, u, s0, s_out=None:
                              rwkv6_scan_ref(r, k, v, logw, u, s0)):
        yield


def moe_layer_names(model) -> dict:
    """id of each MoE layer's router parameter -> the layer's name."""
    from repro_torch.models.moe import MoE

    return {id(m.router): name for name, m in model.named_modules()
            if isinstance(m, MoE)}


@contextlib.contextmanager
def moe_routes_recorded(model):
    """Record the top-k expert ids of each call of each MoE layer of
    ``model`` (remat calls a layer again in the backward); yields them
    by layer name."""
    from repro_torch.models import moe

    names, ids = moe_layer_names(model), {}
    route = moe._route

    def recorded(xt, router_w, cfg, batch_ctx=None):
        topw, topi, aux = route(xt, router_w, cfg, batch_ctx)
        ids.setdefault(names[id(router_w)], []).append(topi)
        return topw, topi, aux

    with mock.patch.object(moe, "_route", recorded):
        yield ids


def pairs_differ(a, b, E: int):
    """(token, expert) pairs of the top-k ids ``a`` (T, k) that ``b``'s
    do not hold, a device count."""
    def hot(ids):
        return torch.zeros(ids.shape[0], E, dtype=torch.bool,
                           device=ids.device).scatter_(1, ids, True)
    return (hot(a) & ~hot(b)).sum()


@contextlib.contextmanager
def moe_routes_pinned(model, ids):
    """Each MoE layer of ``model`` routes its tokens to the experts of
    its first call in ``ids`` (``moe_routes_recorded``), the weights
    renormalised from its own router probabilities at those experts and
    the aux loss from them, as ``moe._route`` computes both; yields, by
    layer, the (token, expert) pairs of ``ids`` that the layer's own
    top-k does not hold, at its first call."""
    from repro_torch.models import moe

    names, flips = moe_layer_names(model), {}

    def pinned(xt, router_w, cfg, batch_ctx=None):
        assert batch_ctx is None, "routes are pinned off a mesh only"
        name = names[id(router_w)]
        pin = ids[name][0]
        T, k, E = xt.shape[0], cfg.top_k, cfg.n_experts
        with moe.no_tf32():
            logits = xt.float() @ router_w.float()
        probs = torch.softmax(logits, dim=-1)
        if name not in flips:   # outside autograd: remat's recompute
            flips[name] = pairs_differ(   # must save what the first saved
                pin, torch.topk(probs.detach(), k, dim=-1).indices, E)
        topw = probs.gather(-1, pin)
        topw = topw / topw.sum(dim=-1, keepdim=True)
        fe = moe._counts(pin, E).float() / (T * k)
        return topw, pin, E * torch.sum(fe * probs.mean(dim=0))

    with mock.patch.object(moe, "_route", pinned):
        yield flips


def route_line(cfg, routes, flips):
    """What 6b logs of an MoE's routes: the kernel route's assignments,
    the pairs the plain route's own top-k flipped (by layer and in all),
    and the calls of each layer, remat's second of which must route as
    its first."""
    by_layer = {n: int(v) for n, v in flips.items()}
    first = next(iter(routes.values()))[0]
    if not all(torch.equal(c, calls[0]) for calls in routes.values()
               for c in calls[1:]):
        raise AssertionError("train step check: remat's second call of an "
                             "MoE layer routed otherwise than its first")
    return dict(layers=len(routes), assignments_per_layer=first.numel(),
                flipped_pairs=sum(by_layer.values()),
                flipped_pairs_by_layer=by_layer,
                calls_per_layer=[len(c) for c in routes.values()],
                pinned="plain route's experts set to the kernel route's")


def step_optimizer(name, lr, model):
    """``name``'s optimizer (6b's and phase 8's one-step checks) over a
    cosine schedule with no warm-up to 10 steps."""
    from repro_torch.train import optimizer as optim
    from repro_torch.train.trainer import stacked_leaves

    sched = optim.cosine_schedule(lr, 0, 10)
    return (optim.adafactor(sched, stacks=stacked_leaves(model))
            if name == "adafactor" else optim.adamw(sched))


def step_check_phase(kernels, arch=TRAIN_ARCH):
    """6b: one step of ``arch`` at full width and ``STEP_CHECK_LAYERS``
    layers, float32, with its 6a run's optimizer, through the kernels and
    through the plain versions (``plain_route``: autograd through them),
    on the same weights and batch: the loss, every gradient leaf and the
    updated parameters agree within the stated bars; for Qwen2-1.5B also
    the gradients of the step in bf16 through the kernels
    (``step_check_bf16``). An MoE's plain route takes the kernel route's
    experts (``moe_routes_pinned``): a token whose top-k the two routes'
    float32 differences flip would send its gradient to other experts;
    the flipped (token, expert) pairs are counted first. Returns the
    kernels' launches."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.models import transformer as tfm
    from repro_torch.train.trainer import trainable_params, value_and_grad

    c = STEP_CHECK
    t_part = [time.perf_counter()]
    seconds = {}

    def lap(name):
        seconds[name] = time.perf_counter() - t_part[0]
        t_part[0] = time.perf_counter()

    layers = STEP_CHECK_LAYERS[arch]
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              dtype="float32", param_dtype="float32")
    model = tfm.init_model(cfg, torch.Generator(DEVICE).manual_seed(0),
                           DEVICE)
    plain_model = copy.deepcopy(model)
    batch = device_batch(SyntheticTokenPipeline(cfg.vocab_size, c["batch"],
                                                c["seq"]), 0)
    optimizer = train_run(arch)["optimizer"]
    opt = step_optimizer(optimizer, c["lr"], model)
    pk, pp = trainable_params(model), trainable_params(plain_model)
    sk, sp = opt.init(pk), opt.init(pp)
    lap("setup")
    with plain_calls_counted() as plain, \
            moe_routes_recorded(model) as routes:
        kernels.reset_launch_counts()
        (lk, _), gk = value_and_grad(model, batch, cfg)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    lap("kernels")
    check_launches(f"train step check {arch} (kernels)", counts,
                   train_launches(cfg, 1), plain)
    kernels.reset_launch_counts()
    with plain_route(), moe_routes_pinned(plain_model, routes) as flips:
        (lp, _), gp = value_and_grad(plain_model, batch, cfg)
        torch.cuda.synchronize()
    lap("plain")
    route = route_line(cfg, routes, flips) if cfg.moe else None
    check_launches(f"train step check {arch} (plain)",
                   kernels.launch_counts(), {}, {})
    loss_err = abs(float(lk) - float(lp))
    if loss_err > 1e-5 * abs(float(lp)):
        raise AssertionError(f"train step check {arch}: loss {float(lk)} "
                             f"through the kernels, {float(lp)} through "
                             "plain")
    grad_rel = {}
    for name in gp:
        scale = float(gp[name].abs().max())
        err = float((gk[name] - gp[name]).abs().max())
        grad_rel[name] = err / scale if scale else err
        if err > STEP_GRAD_TOL * scale:
            raise AssertionError(f"train step check {arch}: gradient of "
                                 f"{name} differs by {err}, "
                                 f"{STEP_GRAD_TOL} of {scale} allowed")
    bf16 = (step_check_bf16(kernels, cfg, model, batch, gp)
            if arch == TRAIN_ARCH else None)
    lap("bf16")
    opt.update(gk, sk, pk)
    opt.update(gp, sp, pp)
    with torch.no_grad():
        diff = torch.cat([(pk[n] - pp[n]).abs().flatten() for n in pk])
    lap("update")
    lr = c["lr"]
    share = float((diff > STEP_ATOL * lr).float().mean())
    worst = float(diff.max())
    if share > STEP_SHARE or worst > STEP_ATOL_ALL * lr:
        raise AssertionError(f"train step check {arch}: updated parameters "
                             f"differ by up to {worst} ({share} of the "
                             f"elements beyond {STEP_ATOL * lr})")
    worst_leaf = max(grad_rel, key=grad_rel.get)
    log("train_step_check", json.dumps(dict(
        arch=arch, layers=layers, layer_kinds=list(cfg.layer_kinds()),
        dtype="float32", batch=c["batch"], seq=c["seq"], lr=lr,
        optimizer=optimizer, moe_routes=route,
        loss_kernels=float(lk), loss_plain=float(lp), loss_abs_err=loss_err,
        grad_rel_err_max=grad_rel[worst_leaf], grad_worst_leaf=worst_leaf,
        grad_leaves=len(grad_rel), param_abs_err_max=worst,
        param_share_beyond=share, launches=counts,
        tol=dict(grad=STEP_GRAD_TOL, param_atol_lr=STEP_ATOL,
                 param_share=STEP_SHARE, param_atol_all_lr=STEP_ATOL_ALL),
        bf16=bf16, seconds=seconds)))
    del model, plain_model, gk, gp, sk, sp
    torch.cuda.empty_cache()
    counts = dict(counts)
    for name, n in (bf16 or {}).get("launches", {}).items():
        counts[name] = counts.get(name, 0) + n
    return counts


def step_check_bf16(kernels, cfg, model, batch, want):
    """6b in bf16: the float32 model's weights rounded to bf16 and the
    same batch through the kernels (the bf16 forward and the tensor-core
    backward), each gradient leaf within STEP_GRAD_TOL_BF16 of its
    largest magnitude in the float32 plain step's (``want``)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.train.trainer import value_and_grad

    cfg16 = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")
    model16 = tfm.Transformer(cfg16, DEVICE)
    with torch.no_grad():
        for (name, p16), (name32, p32) in zip(model16.named_parameters(),
                                              model.named_parameters()):
            assert name == name32
            p16.copy_(p32)
    with plain_calls_counted() as plain:
        kernels.reset_launch_counts()
        (loss, _), got = value_and_grad(model16, batch, cfg16)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    check_launches("train step check (bf16 kernels)", counts,
                   train_launches(cfg16, 1), plain)
    rel = {}
    for name, w in want.items():
        scale = float(w.abs().max())
        err = float((got[name].float() - w).abs().max())
        rel[name] = err / scale if scale else err
    worst = max(rel, key=rel.get)
    line = dict(loss=float(loss), grad_rel_err_max=rel[worst],
                grad_worst_leaf=worst, grad_rel_err=rel,
                tol=STEP_GRAD_TOL_BF16, launches=counts)
    if rel[worst] > STEP_GRAD_TOL_BF16:
        log("train_step_check_bf16", json.dumps(line))
        raise AssertionError(f"train step check (bf16): gradient of {worst} "
                             f"differs by {rel[worst]} of its largest "
                             f"magnitude, {STEP_GRAD_TOL_BF16} allowed")
    del model16, got
    return line


class PlainDispatch:
    """The capacity dispatch's gather under autograd's own backward (an
    accumulating ``index_put_``), in place of ``moe._Dispatch``."""

    @staticmethod
    def apply(xt, src_t, filled, keep, slot, k):
        return torch.where(filled[..., None], xt[src_t], 0)


def moe_layer_phase():
    """The MoE layer's determinism check: one full-width Qwen1.5-MoE-A2.7B
    layer, bf16, seeded weights and input (``MOE_LAYER_CHECK``) at the 6a
    run's T (4 x 512) and its capacity factor, which must drop
    assignments: the gradients of x, the
    router, the experts and the shared experts from two backwards must
    be equal bit for bit; the same with autograd's gather backward in
    place of ``moe._Dispatch`` is logged, not held. A ``moe_layer_check``
    line with the drops and, from ``torch.profiler``, the layer's device
    ms forward and backward and its expert products' (``aten::bmm``)
    share of each. Returns the line."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.common import init_tensor
    from repro_torch.train.trainer import AUX_COEF

    c = MOE_LAYER_CHECK
    cfg = get_config(MOE_ARCH)
    dt = torch.bfloat16
    gen = torch.Generator(DEVICE).manual_seed(c["seed"])
    layer = moe.MoE(cfg, device=DEVICE, dtype=dt)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(init_tensor(tuple(p.shape), p.init, p.init_scale, gen,
                                dt))
    layer.requires_grad_(True)
    shape = (c["batch"], c["seq"], cfg.d_model)
    protos = torch.randn((c["prototypes"], cfg.d_model), generator=gen,
                         device=DEVICE)
    which = torch.randint(0, c["prototypes"], shape[:2], generator=gen,
                          device=DEVICE)
    x = (protos[which] + c["noise"] * torch.randn(
        shape, generator=gen, device=DEVICE)).to(dt)
    cot = torch.randn(shape, generator=gen, device=DEVICE).to(dt)
    names = ["x"] + [n for n, _ in layer.named_parameters()]
    aux_cot = torch.tensor(AUX_COEF, device=DEVICE)

    def grads():
        xl = x.clone().requires_grad_(True)
        with record_function("moe_layer_forward"):
            out, aux = moe.moe_apply(layer, xl, cfg)
        return dict(zip(names, torch.autograd.grad(
            [out, aux], [xl] + list(layer.parameters()), [cot, aux_cot])))

    with moe_recorded() as records:
        first = grads()
    second = grads()
    (stats,) = drop_stats(records).values()
    differ = [n for n in names if not torch.equal(first[n], second[n])]
    with mock.patch.object(moe, "_Dispatch", PlainDispatch):
        plain = [grads()["x"] for _ in range(2)]
    plain_equal = torch.equal(*plain)
    plain_vs_ours = float((plain[0].float() - first["x"].float()).abs().max())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        grads()
        torch.cuda.synchronize()
    line = dict(arch=MOE_ARCH, dtype="bfloat16", batch=c["batch"],
                seq=c["seq"], capacity_factor=cfg.capacity_factor, **stats,
                grads=len(names), bitwise_equal=not differ, differ=differ,
                autograd_gather_x_bitwise=plain_equal,
                autograd_gather_x_vs_ours_max_abs=plain_vs_ours,
                **layer_device_ms(prof))
    log("moe_layer_check", json.dumps(line))
    if not stats["dropped"]:
        raise AssertionError("moe layer check: nothing dropped at capacity "
                             f"factor {cfg.capacity_factor}")
    if differ:
        raise AssertionError(f"moe layer check: two backwards differ in "
                             f"{differ}")
    del layer, first, second, plain
    torch.cuda.empty_cache()
    return line


def layer_device_ms(prof) -> dict:
    """Device ms of a profiled forward and backward: the forward (its
    ``moe_layer_forward`` range), the backward (the rest), the expert
    products (``aten::bmm``) in each, those the autograd engine ran
    counted as the backward's, and the largest CUDA kernels."""
    events = prof.events()

    def in_backward(ev):
        while ev is not None:
            if ev.name.startswith("autograd::engine::evaluate_function"):
                return True
            ev = ev.cpu_parent
        return False

    cpu = torch.autograd.DeviceType.CPU
    fwd = sum(ev.device_time_total for ev in events
              if ev.name == "moe_layer_forward" and ev.device_type == cpu)
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        # the forward's range shows on the device's timeline too, as an
        # annotation spanning its kernels: not counted again
        if (ev.device_type() == torch.autograd.DeviceType.CUDA
                and not ev.name().startswith("[")
                and ev.name() != "moe_layer_forward"
                and not ev.is_hidden_event()):
            key = ev.name()[:60]
            by_name[key] = by_name.get(key, 0) + (ev.end_ns()
                                                  - ev.start_ns()) / 1e3
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    bmm = [ev for ev in events if ev.name == "aten::bmm"
           and ev.device_type == cpu]
    bwd_bmm = sum(ev.device_time_total for ev in bmm if in_backward(ev))
    fwd_bmm = sum(ev.device_time_total for ev in bmm) - bwd_bmm
    if not (fwd and total):
        return dict(layer_ms="not measured")
    return dict(layer_fwd_ms=fwd / 1e3, layer_bwd_ms=(total - fwd) / 1e3,
                experts_bmm_fwd_ms=fwd_bmm / 1e3,
                experts_bmm_bwd_ms=bwd_bmm / 1e3,
                experts_bmm_calls=dict(
                    forward=sum(not in_backward(ev) for ev in bmm),
                    backward=sum(in_backward(ev) for ev in bmm)),
                top_kernels_ms={k: v / 1e3 for k, v in top})


def resume_phase(kernels, arch=TRAIN_ARCH):
    """6c: a run stopped by a failure at step ``fail_at`` and resumed from
    its checkpoint equals the uninterrupted run bit for bit, in every
    parameter, optimizer state leaf (AdamW's moments, Adafactor's
    factored moments), error-feedback leaf and the step: the reference's
    contract in ``test_train_controller_resume_after_failure``, at 2
    layers of full width (``RESUME``), with ``RESUME_RUN[arch]``'s
    optimizer and gradient compression."""
    import os

    from repro_torch.checkpoint.ckpt import CheckpointManager, latest_step
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.distributed.collectives import init_error_state
    from repro_torch.distributed.fault_tolerance import TrainController
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.train.trainer import trainable_params

    r, how = RESUME, RESUME_RUN[arch]
    cfg = dataclasses.replace(get_config(arch), n_layers=r["layers"],
                              vocab_size=r["vocab"])
    pipe = SyntheticTokenPipeline(cfg.vocab_size, r["batch"], r["seq"])

    def fresh():
        model = tfm.init_model(cfg, torch.Generator(DEVICE).manual_seed(0),
                               DEVICE)
        opt, step_fn = train_mod.build(cfg, model, compress=how["compress"],
                                       lr=r["lr"], total_steps=r["steps"],
                                       optimizer=how["optimizer"])
        params = trainable_params(model)
        err = init_error_state(params) if how["compress"] else ()
        return step_fn, (params, opt.init(params), err)

    class Failure(RuntimeError):
        pass

    def injector(step):
        if step == r["fail_at"]:
            raise Failure(step)

    def host(state):
        return {k: v.detach().cpu().clone()
                for k, v in _flat_state(state).items()}

    batch_fn = functools.partial(device_batch, pipe)
    times = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        step_fn, state = fresh()
        final, step_a, _ = TrainController(
            step_fn, batch_fn, train_mod.NoCheckpoints(),
            max_steps=r["steps"]).run(state, install_sigterm=False)
        want = host(final)
        del final, state, step_fn
        times["uninterrupted_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mgr = CheckpointManager(os.path.join(d, "ckpt"),
                                save_interval=r["every"], async_save=False)
        step_fn, state = fresh()
        try:
            TrainController(step_fn, batch_fn, mgr, max_steps=r["steps"],
                            failure_injector=injector).run(
                state, install_sigterm=False)
            raise AssertionError("resume check: the failure was not raised")
        except Failure:
            pass
        del state, step_fn
        saved = latest_step(mgr.dir)
        if saved != r["fail_at"]:
            raise AssertionError(f"resume check: latest checkpoint {saved}, "
                                 f"the crash path must save {r['fail_at']}")
        step_fn, state = fresh()
        found = mgr.restore_latest(state, DEVICE)
        train_mod.copy_state(state, found[1])
        final, step_b, _ = TrainController(
            step_fn, batch_fn, mgr, max_steps=r["steps"]).run(
            state, start_step=saved, install_sigterm=False)
        got = host(final)
        times["interrupted_and_resumed_s"] = time.perf_counter() - t0
        del final, state, step_fn
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    if step_a != step_b or sorted(want) != sorted(got) or differ:
        raise AssertionError(f"resume check: the resumed run differs from "
                             f"the uninterrupted one in {differ[:5]} "
                             f"({len(differ)} leaves)")
    log("train_resume", json.dumps(dict(
        arch=arch, **r, dtype=cfg.param_dtype, optimizer=how["optimizer"],
        compress_grads=how["compress"],
        leaves=len(want), elements=sum(t.numel() for t in want.values()),
        bitwise_equal=True, final_step=step_b, resumed_from=saved,
        **times)))
    torch.cuda.empty_cache()


def _flat_state(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_state(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_state(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


# --------------------------------------------------------------------------
# phase 7: the mesh
# --------------------------------------------------------------------------

# ranks of phase 7: processes sharing the one card, joined over gloo on
# 127.0.0.1 (one card: no multi-GPU figure), and one NCCL process of
# world size 1
MESH_RANKS = 2
MESH_TIMEOUT_S = 600
# 7a: 4b's runs, each over a ("scen",) mesh of MESH_RANKS ranks
MESH_WHOLERUN = ("grid", "hetero")
# 7b: (key, arch, layers (None: full depth), moe_sharding (None: the
# config's own)); a (data 1, model MESH_RANKS) mesh, bf16, full width,
# phase 5's prompt and seed, GEN_NEW tokens; held to phase 5's run of the
# same model, but the 2-layer expert-mode MoE, held to a 1-rank run of
# that 2-layer model made here
MESH_RUNS = (("qwen2-moe-a2.7b", "qwen2-moe-a2.7b", None, None),
             ("qwen2-moe-a2.7b:expert:2", "qwen2-moe-a2.7b", 2, "expert"),
             ("qwen2-1.5b", "qwen2-1.5b", None, None),
             ("recurrentgemma-2b", "recurrentgemma-2b", None, None),
             ("rwkv6-3b", "rwkv6-3b", None, None))
# 7b's bar, on phase 5's tokens (teacher forcing) against the float32
# copy's logits there: the tensor-parallel bf16 logits lie within twice
# the 1-rank bf16 run's own error (its max over every step). TP rounds a
# row-parallel output twice, each rank's partial sum and then their sum,
# where the 1-rank run rounds it once, so each such rounding errs by at
# most twice as much (|y0| + |y1| = |y| where the partials agree in
# sign); the other operations are the 1-rank run's. A step may choose
# another token than the 1-rank run only where the two tokens' float32
# logits lie within the two runs' errors, 3 times that error (a tie in
# bf16). The free-running greedy tokens are compared and logged. (The
# ModelRuns' bf16_tol are bars on hidden states, |h| <= 4, not logits.)
TP_ERR_FACTOR = 2.0
TP_TIE_FACTOR = 1.0 + TP_ERR_FACTOR


def mesh_run(key):
    """(cfg, ModelRun with the launches of that depth) of a MESH_RUNS
    key."""
    from repro_torch.configs import get_config

    _, arch, layers, mode = next(m for m in MESH_RUNS if m[0] == key)
    cfg = get_config(arch)
    run = next(r for r in MODEL_RUNS if r.arch == arch)
    if mode:
        cfg = dataclasses.replace(cfg, moe_sharding=mode)
    if layers:
        n = cfg.n_layers
        cfg = dataclasses.replace(cfg, n_layers=layers)
        run = dataclasses.replace(
            run, per_forward={k: v * layers // n
                              for k, v in run.per_forward.items()},
            per_step={k: v * layers // n for k, v in run.per_step.items()})
    return cfg, run


def mesh_generated(cfg):
    """What phase 5 keeps of a model, for ``cfg``: a 1-rank greedy run
    from phase 5's seed and prompt (tokens and logits) and the float32
    copy's logits on those tokens (``logits32``), on the host, each
    model freed."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import serve as rserve

    model = tfm.init_model(cfg, torch.Generator(DEVICE).manual_seed(0),
                           DEVICE)
    with logits_recorded() as rec:
        out = rserve.greedy_generate(model, cfg, gen_prompt(cfg), GEN_NEW,
                                     GEN_MAX_SEQ)
    got = dict(tokens=out.cpu(), logits=torch.stack(rec, 1).cpu())
    del model, rec
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = float32_copy(cfg32)
    got["logits32"] = forced_logits(model32, cfg32,
                                    got["tokens"]).float().cpu()
    del model32
    torch.cuda.empty_cache()
    return got


def mesh_line(what, t0, **extra):
    """A rank's ``mesh`` line: backend, ranks, its collectives by kind
    (calls, bytes sent, bytes staged through the host, seconds) since
    the last reset, and the wall time since ``t0``."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives

    log("mesh", json.dumps(dict(
        what=what, backend=dist.get_backend(), rank=dist.get_rank(),
        ranks=dist.get_world_size(), collectives=collectives.counts(),
        wall_s=time.perf_counter() - t0, **extra)))


def mesh_wholerun(core, kernels, mesh):
    """7a on this rank: MESH_WHOLERUN's runs over ``mesh``, each rank's
    posterior launches and lane log."""
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.distributed import collectives

    want = json.loads(WHOLERUN_EXPECTED.read_text())["hetero"]
    batches = dict(
        grid=(batched_scenarios(core), None),
        hetero=(core.make_hetero_scenarios(
            seeds=want["seeds"], budgets=want["budgets"],
            archs=want["archs"]), EngineConfig(warm_start=False)))
    out = {}
    for name in MESH_WHOLERUN:
        scs, config = batches[name]
        kernels.reset_launch_counts()
        collectives.reset_counts()
        t0 = time.perf_counter()
        eng = core.WholeRunBayesSplitEdge(scs, config, mesh=mesh,
                                          device=DEVICE)
        res = eng.run()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        lane = eng.lane_stats()
        mesh_line(f"7a wholerun {name}", t0, launches=counts,
                  lane_log=lane["lane_log"], acq_iters=lane["acq_iters"])
        if counts["matern_score"] == 0 or (
                counts["matern_score"] != lane["acq_iters"]):
            raise AssertionError(f"7a {name}: {counts['matern_score']} "
                                 "posterior launches on this rank in "
                                 f"{lane['acq_iters']} acquisition "
                                 "iterations")
        out[name] = dict(results=plain_results(res), launches=counts,
                         lane_log=lane["lane_log"],
                         wall_s=time.perf_counter() - t0)
    return out


def mesh_serving(kernels, rank, world, d):
    """7b on this rank: each MESH_RUNS model built on the card one rank
    after another (each draws every whole leaf and keeps its shard),
    then ``greedy_generate`` with the mesh's ctx, launches counted;
    tokens and logits held to the 1-rank run's."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import serve as rserve

    mesh = make_mesh((1, world), ("data", "model"), "gloo")
    ref = torch.load(Path(d) / "generated.pt")
    out = {}
    for key, *_ in MESH_RUNS:
        cfg, run = mesh_run(key)
        ctx = make_ctx(cfg, mesh)
        t0 = time.perf_counter()
        for r in range(world):
            if r == rank:
                model = tfm.init_model(
                    cfg, torch.Generator(DEVICE).manual_seed(0), DEVICE,
                    ctx=ctx)
                torch.cuda.empty_cache()
            dist.barrier()
        init_s = time.perf_counter() - t0
        mem = torch.cuda.memory_allocated() / 1e9
        kernels.reset_launch_counts()
        collectives.reset_counts()
        t1 = time.perf_counter()
        with plain_calls_counted() as plain, logits_recorded() as rec:
            tokens = rserve.greedy_generate(model, cfg, gen_prompt(cfg),
                                            GEN_NEW, GEN_MAX_SEQ, ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = kernels.launch_counts()
        want = ref[key]
        same = tokens.cpu() == want["tokens"]
        first = (int((~same).any(0).float().argmax())
                 if not same.all() else None)
        # the same model on phase 5's tokens, uncounted: every step's
        # logits on the 1-rank run's inputs
        forced = forced_logits(model, cfg, want["tokens"], ctx).float()
        ref16 = want["logits"].to(DEVICE).float()
        ref32 = want["logits32"].to(DEVICE)
        own = float((ref16 - ref32).abs().max())
        tp32 = float((forced - ref32).abs().max())
        choice, ref_tok = forced.argmax(-1), ref16.argmax(-1)
        flips = (choice != ref_tok).nonzero().tolist()
        gaps = [float((ref32[b_, j, choice[b_, j]]
                       - ref32[b_, j, ref_tok[b_, j]]).abs())
                for b_, j in flips]
        row = dict(key=key, tokens_equal=bool(same.all()),
                   first_differing_step=first,
                   tp_vs_1rank_bf16=float((forced - ref16).abs().max()),
                   tp_vs_float32=tp32, one_rank_bf16_vs_float32=own,
                   logits_ok=tp32 <= TP_ERR_FACTOR * own,
                   forced_flips=[[b_, j, g] for (b_, j), g in
                                 zip(flips, gaps)],
                   flips_ok=all(g <= TP_TIE_FACTOR * own for g in gaps),
                   logits_absmax=float(ref32.abs().max()),
                   launches=counts, plain_calls=plain, init_s=init_s,
                   generate_s=wall, memory_allocated_gb=mem,
                   first_tokens=tokens[0, :8].tolist())
        mesh_line(f"7b {key}", t1, **row)
        check_launches(f"7b {key} rank {rank}", counts,
                       per(run, forwards=1, steps=GEN_NEW - 1), plain)
        out[key] = row
        del model, rec, forced, ref16, ref32
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def mesh_rank(rank: int, world: int, port: int, d: str) -> int:
    """A gloo rank of phase 7 (``--mesh-rank``): 7a, then 7b; its
    results written to ``d/rank{rank}.json``."""
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    import repro_torch.core as core
    import repro_torch.kernels as kernels
    from repro_torch.distributed.sharding import scenario_mesh
    from repro_torch.launch.mesh import init_process_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_process_group("gloo", rank, world, "127.0.0.1", port)
    try:
        out = dict(rank=rank, wholerun=mesh_wholerun(core, kernels,
                                                     scenario_mesh()))
        out["serving"] = mesh_serving(kernels, rank, world, d)
        out["seconds"] = time.perf_counter() - t0
        Path(d, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_nccl(port: int, d: str) -> int:
    """The NCCL process of phase 7 (``--mesh-nccl``): 7a's grid over a
    world-size-1 NCCL ``("scen",)`` mesh."""
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    import repro_torch.core as core
    import repro_torch.kernels as kernels
    from repro_torch.distributed.sharding import scenario_mesh
    from repro_torch.launch.mesh import init_process_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_process_group("nccl", 0, 1, "127.0.0.1", port)
    try:
        mesh = scenario_mesh()
        out = mesh_wholerun(core, kernels, mesh)
        out = dict(grid=out["grid"], hetero=out["hetero"],
                   seconds=time.perf_counter() - t0)
        Path(d, "nccl.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_processes(cmds, d, env=None):
    """Start ``cmds`` (name -> this script's arguments, or ``["-m",
    module, ...]``) together, each writing its output to files in ``d``;
    (processes, files, start)."""
    procs, files = {}, {}
    try:
        for name, args in cmds.items():
            files[name] = [Path(d) / f"{name}.{x}" for x in ("out", "err")]
            script = [] if args[:1] == ["-m"] else [
                str(Path(__file__).resolve())]
            with open(files[name][0], "w") as o, \
                    open(files[name][1], "w") as e:
                procs[name] = subprocess.Popen(
                    [sys.executable, *script, *args],
                    cwd=ROOT, stdout=o, stderr=e, env=env)
    except BaseException:
        stop_processes((procs, files, None))
        raise
    return procs, files, time.perf_counter()


def stop_processes(started) -> None:
    for p in started[0].values():
        if p.poll() is None:
            p.kill()
        p.wait()


def finish_processes(started, timeout) -> None:
    """Wait for ``start_processes``' processes, a failed one ending the
    others and failing the phase; their output printed once all have
    ended."""
    procs, files, t1 = started
    try:
        while (any(p.poll() is None for p in procs.values())
               and not any(p.poll() for p in procs.values())
               and time.perf_counter() - t1 < timeout):
            time.sleep(0.5)
    finally:
        stop_processes(started)
    for name, (out, err) in files.items():
        sys.stdout.write(out.read_text())
        sys.stdout.flush()
        sys.stderr.write(err.read_text())
        sys.stderr.flush()
    codes = {n: p.returncode for n, p in procs.items() if p.returncode}
    if codes:
        raise AssertionError(f"processes failed (exit codes; negative: "
                             f"ended by the script): {codes}")


def spawn_ranks(cmds, d, timeout):
    """``cmds`` run together to their end (``finish_processes``)."""
    finish_processes(start_processes(cmds, d), timeout)


def mesh_phase(seconds: dict) -> dict:
    """Phase 7: the 2-layer expert-mode MoE's 1-rank run made here and
    phase 5's runs written for the ranks; MESH_RANKS gloo ranks and the
    NCCL process started together, their lines printed once all have
    ended, a failed one ending the others and failing the phase. Holds
    7a to 4b's runs (the reference's bars: evaluations and best accuracy
    equal, traces within WARM_TRACE_TOL; bit for bit logged; the NCCL
    world of 1 bit for bit) and 7b's rows. Returns the kernel launches
    by path."""
    t0 = time.perf_counter()
    key2 = MESH_RUNS[1][0]
    GENERATED[key2] = mesh_generated(mesh_run(key2)[0])
    seconds["7 reference run"] = time.perf_counter() - t0
    (ROOT / "build").mkdir(exist_ok=True)
    by_path = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        torch.save({k: GENERATED[k] for k, *_ in MESH_RUNS},
                   Path(d) / "generated.pt")
        torch.cuda.empty_cache()
        port = free_port()
        cmds = {f"rank{r}": ["--mesh-rank", str(r), str(MESH_RANKS),
                             str(port), d] for r in range(MESH_RANKS)}
        cmds["nccl"] = ["--mesh-nccl", str(free_port()), d]
        t1 = time.perf_counter()
        spawn_ranks(cmds, d, MESH_TIMEOUT_S)
        seconds["7 ranks"] = time.perf_counter() - t1
        ranks = [json.loads((Path(d) / f"rank{r}.json").read_text())
                 for r in range(MESH_RANKS)]
        nccl = json.loads((Path(d) / "nccl.json").read_text())
    verdict = {}
    for name in MESH_WHOLERUN:
        want = WHOLERUN_RESULTS[name]
        for rank in ranks:
            got = rank["wholerun"][name]["results"]
            for a, b in zip(got, want, strict=True):
                if (a["n_evals"], a["best_accuracy"]) != (
                        b["n_evals"], b["best_accuracy"]) or trace_div(
                            a["incumbent_trace"],
                            b["incumbent_trace"]) >= WARM_TRACE_TOL:
                    raise AssertionError(f"7a {name} rank {rank['rank']}: "
                                         f"{a} against 4b's {b}")
            by_path[f"mesh_wholerun:{name}:rank{rank['rank']}"] = rank[
                "wholerun"][name]["launches"]
        if any(r["wholerun"][name]["results"]
               != ranks[0]["wholerun"][name]["results"] for r in ranks):
            raise AssertionError(f"7a {name}: the ranks' results differ")
        verdict[name] = dict(
            bitwise=ranks[0]["wholerun"][name]["results"] == want,
            nccl_world_1_bitwise=nccl[name]["results"] == want,
            walls_s=[r["wholerun"][name]["wall_s"] for r in ranks],
            nccl_wall_s=nccl[name]["wall_s"])
        if not verdict[name]["nccl_world_1_bitwise"]:
            raise AssertionError(f"7a {name}: the NCCL mesh of one rank is "
                                 "not 4b's run bit for bit")
    log("mesh_wholerun", json.dumps(verdict))
    rows = {}
    for key, *_ in MESH_RUNS:
        rows[key] = [r["serving"][key] for r in ranks]
        for rank, row in zip(ranks, rows[key]):
            by_path[f"mesh_generate:{key}:rank{rank['rank']}"] = row[
                "launches"]
            if not (row["logits_ok"] and row["flips_ok"]):
                raise AssertionError(f"7b {key} rank {rank['rank']}: {row}")
    log("mesh_serving", json.dumps(dict(
        ranks=MESH_RANKS, tokens_equal={k: all(r["tokens_equal"] for r in v)
                                        for k, v in rows.items()},
        first_differing_step={k: v[0]["first_differing_step"]
                              for k, v in rows.items()},
        tp_vs_float32={k: v[0]["tp_vs_float32"] for k, v in rows.items()},
        one_rank_bf16_vs_float32={k: v[0]["one_rank_bf16_vs_float32"]
                                  for k, v in rows.items()},
        forced_flips={k: len(v[0]["forced_flips"]) for k, v in rows.items()},
        rank_seconds=[r["seconds"] for r in ranks],
        nccl_seconds=nccl["seconds"])))
    seconds["7"] = time.perf_counter() - t0
    return by_path


# ---------------------------------------------------------------------------
# phase 8: training on the mesh
# ---------------------------------------------------------------------------

# 8a-8b: Qwen2-1.5B at full width and depth, B 4 x S 512 in one
# microbatch, over (data 1, model 2), tensor parallel, and (data 2,
# model 1) with FSDP: MESH_RANKS gloo ranks sharing the card
MESH_TRAIN = dict(batch=4, seq=512)
MESH_TRAIN_MESHES = (("tp", (1, 2), False), ("fsdp", (2, 1), True))
# 8a's third ctx: sequence parallelism (seq on model) over the tp mesh
MESH_SP = dict(sp="tp")
# 8a and 8c: one float32 step of the mesh against the 1-rank step on the
# same weights and global batch (rank 0 runs that step once and keeps its
# gradients and moments on the card; the other rank maps them into its
# own process, CUDA IPC, and each takes its shards as views: nothing is
# copied).
# The CPU tests' bars (tests/test_torch_mesh_train.py): the loss and
# gnorm within MESH_STEP_TOL relative; each gradient leaf within
# MESH_STEP_TOL of its norm, each AdamW moment within twice that; the
# leaves split over ranks are compared over the whole leaf (the ranks'
# sums of squares added). RWKV6-3B's ``mix.u`` leaves (MESH_LOOSE_LEAVES)
# at MESH_LOOSE_FACTOR times those bars: that gradient sums the WKV
# scan's terms with cancellation, and the order of those sums moves it by
# 1.74e-5 of its norm on the CPU before any mesh, 2.56e-5 between the
# card's 8- and 16-head scans
MESH_STEP_TOL = 1e-5
MESH_LOOSE_LEAVES = (".mix.u",)
MESH_LOOSE_FACTOR = 4.0
# and where an architecture's float32 gradients move with the order of
# sums by as much as the bar (RWKV6-3B, its WKV scan: 6b's step through
# the kernels lies up to 2.4e-5 of a leaf's largest element from the
# plain versions' on the card, and the mesh moved ``mix.wk`` by 1.22e-5
# of its norm in a run with no such term), the 1-rank step also
# runs through the plain versions, and each leaf's bar is raised by that
# leaf's own kernel-against-plain difference, by its norm; a difference
# past MESH_NOISE_CAP of the leaf's norm (twice that for a moment,
# MESH_LOOSE_FACTOR times for MESH_LOOSE_LEAVES) fails the phase
MESH_NOISE_ARCHS = ("rwkv6-3b",)
MESH_NOISE_CAP = 2e-5
MESH_STEP_LR = 1e-3
# 8b: TRAIN_RUN's lr, 5 steps on each mesh through ``launch.train``'s
# ``build``. Its bar, token by token on the first batch before the first
# step: the mean |difference| of the mesh's and the float32 model's
# token losses within TP_ERR_FACTOR times the 1-rank bf16 run's own (as
# 7b's); and the first step's loss the mean of the mesh's token losses
# within MESH_STEP_TOL relative (float32 sums in another order). (The
# difference of two mean losses can cancel to near zero: no bar.)
MESH_BF16 = dict(steps=5, lr=TRAIN_RUN["lr"])
# 8c: (arch, moe_sharding, mesh shape, optimizer, sequence parallelism
# too), one float32 step each at full width and STEP_CHECK_LAYERS layers,
# B 2 x S 512 (with sequence parallelism also a second step over the same
# mesh, seq on model, held to the same 1-rank step); the MoE at (2, 1)
# routes the global batch, as the reference's jit does with a model axis
# of one (its per-data-shard shard_map needs model > 1)
MESH_FAMILY = (("recurrentgemma-2b", None, (1, 2), "adamw", True),
               ("rwkv6-3b", None, (1, 2), "adamw", True),
               (MOE_ARCH, "tensor", (1, 2), "adafactor", True),
               (MOE_ARCH, "expert", (1, 2), "adafactor", False),
               (MOE_ARCH, "tensor", (2, 1), "adafactor", False))
MESH_FAMILY_BATCH = dict(batch=2, seq=512)
# 8d: 2 layers at full width, bf16: 2 steps on (1, 2), saved, restored on
# (2, 1) with FSDP, one more step; against an unbroken 1-rank run, token
# by token on the third batch before the third step: the mean |difference|
# of the two runs' token losses within TP_TIE_FACTOR times the 2-layer
# model's own bf16 error against float32 on that batch (its seed-0
# weights: the TP run's error at most twice it, the 1-rank run's once, as
# 7b's ties), and the third step's loss the mean of its token losses
# within MESH_STEP_TOL relative
MESH_ELASTIC = dict(layers=2, steps=2, batch=4, seq=512)
MESH_TRAIN_TIMEOUT_S = 600


def one_rank_step(cfg, optimizer, lr, batch):
    """The 1-rank step of ``cfg`` (weights from seed 0) on the global
    ``batch``: its loss and gnorm, its gradients and, for AdamW, its
    moments after the step, whole and on the card; the model freed. For
    MESH_NOISE_ARCHS also each leaf's (and moment's) difference between
    the step through the plain versions and this one, by its norm
    (``noise``)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.train.trainer import trainable_params, value_and_grad

    def step(plain):
        model = tfm.init_model(cfg, torch.Generator(DEVICE).manual_seed(0),
                               DEVICE)
        params = trainable_params(model)
        opt = step_optimizer(optimizer, lr, model)
        with plain_route() if plain else contextlib.nullcontext():
            (loss, _), grads = value_and_grad(model, batch, cfg)
        _, state, met = opt.update(grads, opt.init(params), params)
        return params, loss, grads, state, met

    noise = {}
    if cfg.name in MESH_NOISE_ARCHS:
        _, _, gp, sp, _ = step(True)
    params, loss, grads, state, met = step(False)
    if cfg.name in MESH_NOISE_ARCHS:
        def rel(a, b):
            return float(torch.linalg.vector_norm(a - b)
                         / torch.linalg.vector_norm(b))
        noise = {k: rel(gp[k], grads[k]) for k in grads}
        if optimizer == "adamw":
            noise.update({f"{m}:{k}": rel(sp[m][k], state[m][k])
                          for m in ("m", "v") for k in grads})
        del gp, sp
    out = dict(loss=float(loss), gnorm=float(met["gnorm"]), grads=grads,
               noise=noise)
    if optimizer == "adamw":
        out["m"], out["v"] = state["m"], state["v"]
    del params
    torch.cuda.empty_cache()
    return out


def shared_from_rank0(rank, value):
    """Rank 0's ``value`` (a dict whose tensors lie on the card, nested a
    level at most) in every rank's process: the other ranks map rank 0's
    card memory (CUDA IPC, the card they share), so nothing is copied.
    Rank 0 keeps its tensors alive until every rank has dropped them
    (``done_with_shared``)."""
    import torch.distributed as dist
    from torch.multiprocessing.reductions import reduce_tensor

    def pack(v):
        if isinstance(v, dict):
            return {k: pack(x) for k, x in v.items()}
        return ("ipc", reduce_tensor(v)) if torch.is_tensor(v) else v

    def unpack(v):
        if isinstance(v, dict):
            return {k: unpack(x) for k, x in v.items()}
        if isinstance(v, tuple) and len(v) == 2 and v[0] == "ipc":
            fn, args = v[1]
            return fn(*args)
        return v

    box = [pack(value) if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return value if rank == 0 else unpack(box[0])


def done_with_shared() -> None:
    """Every rank past its use of ``shared_from_rank0``'s tensors."""
    import torch.distributed as dist

    torch.cuda.synchronize()
    dist.barrier()


def leaf_errors(ctx, params, got, want):
    """Each leaf's |got - want| over |want| in the norm of the whole
    leaf: each rank's sums of squares added over the mesh axes the leaf
    is split on, one collective a set of axes."""
    from repro_torch.distributed.collectives import mesh_collective

    groups = {}
    for k in want:
        groups.setdefault(ctx.split_axes(params[k].axes), []).append(k)
    out = {}
    for axes, names in groups.items():
        sums = []
        for k in names:
            w = want[k].to(got[k].device).float()
            sums.append(torch.stack([
                torch.sum(torch.square(got[k].float() - w)),
                torch.sum(torch.square(w))]))
        sums = torch.stack(sums)
        for a in axes:
            sums = mesh_collective("sum", sums, ctx, a)
        for k, (d2, r2) in zip(names, sums.tolist()):
            out[k] = (d2 / r2) ** 0.5 if r2 else d2 ** 0.5
    return out


def mesh_step(kernels, what, cfg, ctx, optimizer, lr, batch, one):
    """One step of ``cfg`` over ``ctx`` (the rank's shards, seed 0) on
    the rank's shard of the global ``batch``, launches and collectives
    counted, held to ``one`` (``one_rank_step``'s, whole: the rank's
    shards are views of it) at MESH_STEP_TOL; returns its row."""
    from repro_torch.distributed import collectives
    from repro_torch.models import transformer as tfm
    from repro_torch.train.trainer import (local_batch, reduce_gradients,
                                           trainable_params, value_and_grad)

    model = tfm.init_model(cfg, torch.Generator(DEVICE).manual_seed(0),
                           DEVICE, ctx=ctx)
    params = trainable_params(model)
    opt = step_optimizer(optimizer, lr, model)
    state = opt.init(params)
    mine = local_batch(batch, ctx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    collectives.reset_counts()
    t0 = time.perf_counter()
    with plain_calls_counted() as plain:
        (loss, _), grads = value_and_grad(model, mine, cfg, ctx)
        grads = reduce_gradients(grads, params, ctx)
        _, state, met = opt.update(grads, state, params, ctx=ctx)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    coll = collectives.counts()
    check_launches(what, counts, train_launches(cfg, 1), plain)

    def mine(tree):
        return {k: ctx.local(v, params[k].axes) for k, v in tree.items()}

    grad_err = leaf_errors(ctx, params, grads, mine(one["grads"]))
    moment_err = {}
    for k in ("m", "v"):
        if k in one:
            for n, e in leaf_errors(ctx, params, state[k],
                                    mine(one[k])).items():
                moment_err[f"{k}:{n}"] = e

    def factor(name):
        return (MESH_LOOSE_FACTOR if name.endswith(MESH_LOOSE_LEAVES)
                else 1.0) * (2 if ":" in name else 1)

    def leaf_bar(name):
        return MESH_STEP_TOL * factor(name) + one["noise"].get(name, 0.0)

    noisy = {k: e for k, e in one["noise"].items()
             if e > MESH_NOISE_CAP * factor(k)}
    if noisy:
        raise AssertionError(f"{what}: the 1-rank step's kernel-against-"
                             f"plain gap passes MESH_NOISE_CAP: {noisy}")

    def worst(errs, loose):
        errs = {k: e for k, e in errs.items()
                if k.endswith(MESH_LOOSE_LEAVES) == loose}
        k = max(errs, key=errs.get) if errs else None
        return dict(leaf=k, rel_err=errs.get(k),
                    bar=leaf_bar(k) if k else None)

    row = dict(
        what=what, arch=cfg.name, layers=cfg.n_layers, optimizer=optimizer,
        ranks=ctx.axis_sizes, fsdp=ctx.rules.get("embed") is not None,
        moe_sharding=cfg.moe_sharding if cfg.moe else None,
        loss=float(loss), loss_1rank=one["loss"], gnorm=float(met["gnorm"]),
        gnorm_1rank=one["gnorm"],
        grad_rel_err_max=max(grad_err.values()),
        grad_worst=worst(grad_err, False),
        grad_worst_loose=worst(grad_err, True),
        moment_worst=worst(moment_err, False),
        moment_worst_loose=worst(moment_err, True),
        leaves=len(grad_err), noise_max=max(one["noise"].values(),
                                            default=None),
        seq_parallel=ctx.rules.get("seq") is not None,
        launches=counts, collectives=coll,
        step_s=seconds, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        tol=dict(loss_gnorm=MESH_STEP_TOL, grad=MESH_STEP_TOL,
                 moment=2 * MESH_STEP_TOL, loose_leaves=MESH_LOOSE_LEAVES,
                 loose_factor=MESH_LOOSE_FACTOR))
    log("mesh_train_step", json.dumps(row))
    bad = [k for k in ("loss", "gnorm") if abs(row[k] - row[f"{k}_1rank"])
           > MESH_STEP_TOL * abs(row[f"{k}_1rank"])]
    bad += [k for k, e in {**grad_err, **moment_err}.items()
            if e > leaf_bar(k)]
    if bad:
        raise AssertionError(f"{what}: the mesh step differs from the "
                             f"1-rank step ({bad[:8]}): {row}")
    del model, params, grads, state
    torch.cuda.empty_cache()
    return row


def serially(rank, world, fn):
    """``fn()`` on each rank in turn (one rank's 1-rank step at a time on
    the shared card); every rank's result."""
    import torch.distributed as dist

    out = None
    for r in range(world):
        if r == rank:
            out = fn()
        dist.barrier()
    return out


def mesh_checks(kernels, rank, world, what, cfg, meshes, optimizer, lr,
                batch):
    """8a or 8c: the 1-rank step, run once by rank 0 and mapped into the
    others (``shared_from_rank0``), then each mesh's step held to it.
    ``meshes``: name -> (mesh, fsdp, seq_parallel). Returns the rows by
    name."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import make_ctx

    ctxs = {name: make_ctx(cfg, mesh, fsdp=fsdp, seq_parallel=sp)
            for name, (mesh, fsdp, sp) in meshes.items()}
    one = one_rank_step(cfg, optimizer, lr, batch) if rank == 0 else None
    dist.barrier()
    one = shared_from_rank0(rank, one)
    rows = {}
    for name, ctx in ctxs.items():
        rows[name] = mesh_step(kernels, f"{what} {name}", cfg, ctx,
                               optimizer, lr, batch, one)
    done_with_shared()
    del one
    torch.cuda.empty_cache()
    return rows


def token_losses(cfg, batch, ctx=None, model=None):
    """Each token's loss of the global ``batch`` (B * S, in order), no
    gradient: float32 logits, 256 tokens at a time. ``model`` (seed 0 on
    one rank, made and freed here, where None) may hold a rank's shards
    under ``ctx``: the rank's rows then run through the mesh's forward,
    logits over a vocab split over ``model`` are gathered, and the rows'
    losses gathered over the batch axes."""
    from repro_torch.distributed.collectives import mesh_collective
    from repro_torch.models import transformer as tfm
    from repro_torch.train.trainer import local_batch

    made = model is None
    if made:
        model = tfm.init_model(cfg, torch.Generator(DEVICE).manual_seed(0),
                               DEVICE)
    tokens = local_batch(batch, ctx)["tokens"]
    labels = tokens[:, 1:].reshape(-1).long()
    B, S = tokens[:, 1:].shape
    with torch.no_grad():
        hidden, _, _ = tfm.forward(
            model, tokens=tokens[:, :-1], mode="train",
            positions=torch.arange(S, dtype=torch.int32,
                                   device=DEVICE).expand(B, S))
        w = tfm.unembed_weight(model).float()
        out = []
        for h, lab in zip(hidden.float().reshape(B * S, -1).split(256),
                          labels.split(256)):
            logits = h @ w
            if model.vocab_ctx is not None:
                logits = mesh_collective("gather", logits, model.vocab_ctx,
                                         "model", dim=-1)
            logits[:, cfg.vocab_size:] = float("-inf")
            out.append(torch.logsumexp(logits, -1)
                       - logits.gather(1, lab[:, None])[:, 0])
        out = torch.cat(out)
        for a in reversed(ctx.batch_axes if ctx is not None else ()):
            out = mesh_collective("gather", out, ctx, a, dim=0)
    del hidden, w
    if made:
        del model
        torch.cuda.empty_cache()
    return out


def bf16_bar(cfg16, batch, factor=TP_ERR_FACTOR):
    """A bf16 bar on ``batch``: (the float32 model's token losses, on the
    host; dict of the float32 and 1-rank bf16 mean losses, the 1-rank
    run's own error, the mean |difference| of its and the float32
    model's token losses, and ``factor`` times that, ``bar``)."""
    n32 = token_losses(dataclasses.replace(cfg16, dtype="float32",
                                           param_dtype="float32"), batch)
    n16 = token_losses(cfg16, batch)
    own = float((n16 - n32).abs().mean())
    return n32.cpu(), dict(loss_float32=float(n32.mean()),
                           loss_1rank_bf16=float(n16.mean()), own_err=own,
                           factor=factor, bar=factor * own)


def mesh_bf16_run(kernels, what, cfg, ctx, pipe, steps, ref):
    """8b on one mesh: ``steps`` steps through ``launch.train.build`` (the
    rank's shards from seed 0, its shard of each batch); each step's
    loss and ms on the host's clock, the collectives by kind, the peak
    memory; the loss on the first batch must fall, and the mesh's token
    losses on it before the first step lie within ``ref``'s bar
    (``bf16_bar``'s) of the float32 model's, their mean the first step's
    loss."""
    from repro_torch.distributed import collectives
    from repro_torch.launch.train import build
    from repro_torch.models import transformer as tfm
    from repro_torch.train.trainer import (local_batch, loss_fn,
                                           trainable_params)

    model = tfm.init_model(cfg, torch.Generator(DEVICE).manual_seed(0),
                           DEVICE, ctx=ctx)
    opt, step_fn = build(cfg, model, lr=MESH_BF16["lr"],
                         total_steps=steps, ctx=ctx)
    params = trainable_params(model)
    state = (params, opt.init(params), ())
    n32, bar = ref
    tok = token_losses(cfg, device_batch(pipe, 0), ctx, model).cpu()
    batches = [local_batch(device_batch(pipe, s), ctx) for s in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    collectives.reset_counts()
    losses, ms = [], []
    with plain_calls_counted() as plain:
        for b in batches:
            t0 = time.perf_counter()
            state, met = step_fn(state, b)
            losses.append(float(met["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    coll = collectives.counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_launches(what, counts, {k: v * steps for k, v in
                                  train_launches(cfg, 1).items()}, plain)
    with torch.no_grad():
        after = float(loss_fn(model, batches[0], cfg, ctx)[0])
    row = dict(what=what, ranks=ctx.axis_sizes,
               fsdp=ctx.rules.get("embed") is not None, losses=losses,
               first_batch_loss_after=after, step_ms=ms,
               token_err=float((tok - n32).abs().mean()),
               token_bar=bar["bar"], tokens_mean=float(tok.mean()),
               first_loss_vs_tokens=abs(losses[0] - float(tok.mean())),
               first_loss_float32_err=abs(losses[0] - bar["loss_float32"]),
               launches=counts, collectives=coll, peak_memory_gb=peak)
    log("mesh_train_bf16", json.dumps(row))
    if not after < losses[0]:
        raise AssertionError(f"{what}: the first batch's loss did not fall: "
                             f"{losses[0]} -> {after}")
    if row["token_err"] > bar["bar"]:
        raise AssertionError(f"{what}: the token losses lie "
                             f"{row['token_err']} from float32's, "
                             f"{bar['bar']} allowed")
    if row["first_loss_vs_tokens"] > MESH_STEP_TOL * abs(losses[0]):
        raise AssertionError(f"{what}: first loss {losses[0]}, its tokens' "
                             f"mean {row['tokens_mean']}")
    del model, params, state, batches
    torch.cuda.empty_cache()
    return row


def mesh_elastic(kernels, rank, world, meshes, pipe, d):
    """8d: 2 layers at full width, bf16: the unbroken 1-rank run's 3
    losses and its token losses on the third batch (rank 0), then 2 steps
    on (1, 2), a save (gathered, rank 0 writes), a restore onto (2, 1)
    with FSDP, every leaf equal to the saved one bit for bit (gathered
    again), and a third step whose token losses lie within MESH_ELASTIC's
    bar of the unbroken run's."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import mesh_collective
    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.launch.train import build, copy_state
    from repro_torch.models import transformer as tfm
    from repro_torch.train.trainer import (local_batch, state_shardings,
                                           trainable_params)

    c = MESH_ELASTIC
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=c["layers"])
    steps = c["steps"] + 1

    def run(ctx):
        model = tfm.init_model(cfg, torch.Generator(DEVICE).manual_seed(0),
                               DEVICE, ctx=ctx)
        opt, step_fn = build(cfg, model, lr=MESH_BF16["lr"],
                             total_steps=steps, ctx=ctx)
        params = trainable_params(model)
        return model, step_fn, (params, opt.init(params), ())

    def unbroken():
        _, bar = bf16_bar(cfg, device_batch(pipe, c["steps"]),
                          TP_TIE_FACTOR)
        model, step_fn, state = run(None)
        losses = []
        for s in range(steps):
            if s == c["steps"]:
                tok = token_losses(cfg, device_batch(pipe, s), None,
                                   model).cpu()
            state, met = step_fn(state, device_batch(pipe, s))
            losses.append(float(met["loss"]))
        del model, state
        torch.cuda.empty_cache()
        return losses, tok, bar
    whole, whole_tok, bar = mesh_collective(
        "gather_object", unbroken() if rank == 0 else None,
        group=torch.distributed.group.WORLD)[0]
    t0 = time.perf_counter()
    ctx12 = make_ctx(cfg, meshes["tp"])
    model, step_fn, state = run(ctx12)
    losses = []
    for s in range(c["steps"]):
        state, met = step_fn(state, local_batch(device_batch(pipe, s),
                                                ctx12))
        losses.append(float(met["loss"]))
    shard = state_shardings(state, state[0], ctx12)
    saved = ckpt._map_leaves(lambda _, t: t.clone(),
                             ckpt.gather_tree(state, shard))
    mgr = ckpt.CheckpointManager(d, async_save=False, shardings=shard)
    t1 = time.perf_counter()
    mgr.maybe_save(c["steps"], state, force=True)
    mgr.wait()
    save_s = time.perf_counter() - t1
    del model, state
    torch.cuda.empty_cache()
    ctx21 = make_ctx(cfg, meshes["fsdp"], fsdp=True)
    model, step_fn, state = run(ctx21)
    shard21 = state_shardings(state, state[0], ctx21)
    t1 = time.perf_counter()
    found, back = ckpt.CheckpointManager(d).restore_latest(state, DEVICE,
                                                           shard21)
    copy_state(state, back)
    del back
    restore_s = time.perf_counter() - t1
    got = ckpt._flatten(ckpt.gather_tree(state, shard21))
    want = ckpt._flatten(saved)
    differ = [k for k in want if got[k].dtype != want[k].dtype
              or not torch.equal(got[k], want[k])]
    del got, want, saved
    tok = token_losses(cfg, device_batch(pipe, c["steps"]), ctx21,
                       model).cpu()
    kernels.reset_launch_counts()
    with plain_calls_counted() as plain:
        state, met = step_fn(state, local_batch(
            device_batch(pipe, c["steps"]), ctx21))
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_launches("8d the restored step", counts, train_launches(cfg, 1),
                   plain)
    losses.append(float(met["loss"]))
    row = dict(layers=c["layers"], saved_step=c["steps"],
               restored_step=found, leaves_differing=differ,
               losses=losses, unbroken_losses=whole,
               third_loss_err=abs(losses[-1] - whole[-1]),
               token_err=float((tok - whole_tok).abs().mean()), bar=bar,
               third_loss_vs_tokens=abs(losses[-1] - float(tok.mean())),
               save_s=save_s, restore_s=restore_s,
               checkpoint_gb=sum(f.stat().st_size for f in Path(d).rglob("*")
                                 if f.is_file()) / 1e9,
               wall_s=time.perf_counter() - t0, launches=counts)
    log("mesh_train_elastic", json.dumps(row))
    if found != c["steps"] or differ:
        raise AssertionError(f"8d: restored step {found}, leaves differing "
                             f"from the saved ones: {differ[:8]}")
    if row["token_err"] > bar["bar"]:
        raise AssertionError(f"8d: the token losses after the restore lie "
                             f"{row['token_err']} from the unbroken run's, "
                             f"{bar['bar']} allowed")
    if row["third_loss_vs_tokens"] > MESH_STEP_TOL * abs(losses[-1]):
        raise AssertionError(f"8d: third loss {losses[-1]}, its tokens' "
                             f"mean {float(tok.mean())}")
    del model, state
    torch.cuda.empty_cache()
    return row


def train_mesh_rank(rank: int, world: int, port: int, d: str) -> int:
    """A gloo rank of phase 8 (``--train-mesh-rank``): 8a-8d; its rows
    and launches by path written to ``d/rank{rank}.json``."""
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.launch.mesh import init_process_group, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_process_group("gloo", rank, world, "127.0.0.1", port)
    seconds, by_path, out = {}, {}, dict(rank=rank)
    lap = [time.perf_counter()]

    def done(name):
        seconds[name] = time.perf_counter() - lap[0]
        lap[0] = time.perf_counter()

    try:
        meshes = {name: make_mesh(shape, ("data", "model"), "gloo")
                  for name, shape, _ in MESH_TRAIN_MESHES}
        fsdp = {name: f for name, _, f in MESH_TRAIN_MESHES}
        cfg16 = get_config(TRAIN_ARCH)
        cfg32 = dataclasses.replace(cfg16, dtype="float32",
                                    param_dtype="float32")
        pipe = SyntheticTokenPipeline(cfg16.vocab_size, **MESH_TRAIN)
        batch = device_batch(pipe, 0)
        ctxs8a = {n: (meshes[n], fsdp[n], False) for n in meshes}
        ctxs8a.update({n: (meshes[m], fsdp[m], True)
                       for n, m in MESH_SP.items()})
        out["8a"] = mesh_checks(kernels, rank, world, "8a", cfg32, ctxs8a,
                                "adamw", MESH_STEP_LR, batch)
        for name, row in out["8a"].items():
            by_path[f"train_mesh_step:{name}:rank{rank}"] = row["launches"]
        done("8a")
        ref = serially(rank, world, lambda: bf16_bar(cfg16, batch))
        out["8b"] = dict(ref[1])
        for name in meshes:
            ctx = make_ctx(cfg16, meshes[name], fsdp=fsdp[name])
            row = mesh_bf16_run(kernels, f"8b {name}", cfg16, ctx, pipe,
                                MESH_BF16["steps"], ref)
            out["8b"][name] = row
            by_path[f"train_mesh_bf16:{name}:rank{rank}"] = row["launches"]
            done(f"8b {name}")
        out["8c"] = []
        for arch, mode, shape, optimizer, sp in MESH_FAMILY:
            cfg = dataclasses.replace(
                get_config(arch), n_layers=STEP_CHECK_LAYERS[arch],
                dtype="float32", param_dtype="float32")
            if mode:
                cfg = dataclasses.replace(cfg, moe_sharding=mode)
            fam = SyntheticTokenPipeline(cfg.vocab_size, **MESH_FAMILY_BATCH)
            mesh = meshes["tp" if shape == (1, 2) else "fsdp"]
            key = f"{arch}:{mode or ''}:{'x'.join(map(str, shape))}"
            ctxs = {key: (mesh, False, False)}
            if sp:
                ctxs[f"{key}:sp"] = (mesh, False, True)
            rows = mesh_checks(kernels, rank, world, "8c", cfg, ctxs,
                               optimizer, MESH_STEP_LR, device_batch(fam, 0))
            for name, row in rows.items():
                out["8c"].append(row)
                by_path[f"train_mesh_step:{name}:rank{rank}"] = \
                    row["launches"]
            done(f"8c {key}")
        out["8d"] = mesh_elastic(kernels, rank, world, meshes, pipe,
                                 str(Path(d) / "elastic"))
        by_path[f"train_mesh_elastic:rank{rank}"] = out["8d"]["launches"]
        done("8d")
        out.update(seconds=seconds, by_path=by_path,
                   wall_s=time.perf_counter() - t_start)
        torch.cuda.empty_cache()      # 8e's process steps once this is out
        Path(d, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def train_mesh_nccl(port: int, d: str) -> int:
    """8e (``--train-mesh-nccl``): one bf16 step of 8b's model with no
    mesh, then the same step over a world-1 NCCL ``("data", "model")``
    mesh (every axis of one rank: no collective runs, NCCL is only
    initialised), its loss and parameters after the step equal to the
    first's bit for bit; the losses, the leaves that differ and the
    mesh step's launches written to ``d/nccl.json``."""
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.launch.train import build
    from repro_torch.models import transformer as tfm
    from repro_torch.train.trainer import trainable_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_process_group("nccl", 0, 1, "127.0.0.1", port)
    try:
        # started with the gloo ranks (its start-up beside their work), it
        # steps once they have ended and freed the card's memory
        t_wait = time.perf_counter()
        while not all(Path(d, f"rank{r}.json").exists()
                      for r in range(MESH_RANKS)):
            if time.perf_counter() - t_wait > MESH_TRAIN_TIMEOUT_S:
                raise TimeoutError("8e: the gloo ranks never ended")
            time.sleep(0.5)
        waited_s = time.perf_counter() - t_wait
        cfg = get_config(TRAIN_ARCH)
        batch = device_batch(SyntheticTokenPipeline(cfg.vocab_size,
                                                    **MESH_TRAIN), 0)

        def made(ctx):
            model = tfm.init_model(cfg, torch.Generator(DEVICE).manual_seed(
                0), DEVICE, ctx=ctx)
            opt, step_fn = build(cfg, model, lr=MESH_BF16["lr"],
                                 total_steps=MESH_BF16["steps"], ctx=ctx)
            params = trainable_params(model)
            return step_fn, (params, opt.init(params), ())

        step_fn, state = made(None)
        state, met = step_fn(state, batch)
        loss_none, params_none = float(met["loss"]), state[0]
        del step_fn, state
        torch.cuda.empty_cache()
        step_fn, state = made(make_ctx(cfg, make_mesh(
            (1, 1), ("data", "model"), "nccl")))
        kernels.reset_launch_counts()
        with plain_calls_counted() as plain:
            t1 = time.perf_counter()
            state, met = step_fn(state, batch)
            loss, params = float(met["loss"]), state[0]
            step_s = time.perf_counter() - t1
        counts = kernels.launch_counts()
        check_launches("8e", counts, train_launches(cfg, 1), plain)
        differ = [k for k in params_none
                  if not torch.equal(params[k], params_none[k])]
        Path(d, "nccl.json").write_text(json.dumps(dict(
            loss=loss, loss_no_mesh=loss_none, leaves=len(params),
            leaves_differing=differ, step_s=step_s, launches=counts,
            backend=dist.get_backend(), waited_s=waited_s,
            wall_s=time.perf_counter() - t0)))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_train_start(d):
    """Start phase 8's processes, writing into ``d``: MESH_RANKS gloo ranks
    that run 8a-8d and one NCCL process of world size 1 that runs 8e once
    they have ended."""
    torch.cuda.empty_cache()
    port = free_port()
    cmds = {f"train{r}": ["--train-mesh-rank", str(r), str(MESH_RANKS),
                          str(port), d] for r in range(MESH_RANKS)}
    cmds["nccl"] = ["--train-mesh-nccl", str(free_port()), d]
    return start_processes(cmds, d)


def mesh_train_phase(seconds: dict) -> dict:
    """Phase 8 alone: ``mesh_train_start`` and ``mesh_train_finish``."""
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        return mesh_train_finish(mesh_train_start(d), d, seconds)


def mesh_train_finish(started, d, seconds: dict) -> dict:
    """Phase 8's end: its processes waited for, every rank's rows
    printed, 8e's step held to the step with no mesh bit for bit.
    Returns the kernel launches by path."""
    finish_processes(started, MESH_TRAIN_TIMEOUT_S)
    seconds["8"] = time.perf_counter() - started[2]
    ranks = [json.loads((Path(d) / f"rank{r}.json").read_text())
             for r in range(MESH_RANKS)]
    nccl = json.loads((Path(d) / "nccl.json").read_text())
    by_path = {}
    for rank in ranks:
        by_path.update(rank["by_path"])
    by_path["train_mesh_nccl:rank0"] = nccl["launches"]
    log("mesh_train_nccl", json.dumps(nccl))
    if nccl["loss"] != nccl["loss_no_mesh"] or nccl["leaves_differing"]:
        raise AssertionError(f"8e: the world-1 NCCL step differs from the "
                             f"step with no mesh: loss {nccl['loss']} "
                             f"against {nccl['loss_no_mesh']}, leaves "
                             f"{nccl['leaves_differing'][:8]}")
    log("mesh_train", json.dumps(dict(
        ranks=MESH_RANKS,
        step_8a={n: [r["8a"][n]["step_s"] for r in ranks]
                 for n in ranks[0]["8a"]},
        grad_rel_err_max={n: max(r["8a"][n]["grad_rel_err_max"]
                                 for r in ranks) for n in ranks[0]["8a"]},
        bf16_step_ms={n: [r["8b"][n]["step_ms"] for r in ranks]
                      for n in ("tp", "fsdp")},
        bf16_losses={n: ranks[0]["8b"][n]["losses"] for n in ("tp", "fsdp")},
        family={row["what"]: row["grad_rel_err_max"]
                for row in ranks[0]["8c"]},
        bf16_token_err={n: ranks[0]["8b"][n]["token_err"]
                        for n in ("tp", "fsdp")},
        bf16_token_bar=ranks[0]["8b"]["bar"],
        elastic_token_err=ranks[0]["8d"]["token_err"],
        elastic_token_bar=ranks[0]["8d"]["bar"]["bar"],
        rank_seconds=[r["seconds"] for r in ranks])))
    return by_path


# phase 9: the dry run's cells, (arch, shape, sequence parallelism), on
# the production pod mesh
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k", False),
                ("qwen2-1.5b", "train_4k", True),
                ("rwkv6-3b", "prefill_32k", False))
DRYRUN_TIMEOUT_S = 300


def dryrun_start(d):
    """Start phase 9's children, one a cell, writing into ``d``."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_TEST_MESH", None)
    cmds = {f"dryrun{i}": ["-m", "repro_torch.launch.dryrun", "--arch", a,
                           "--shape", shape, "--mesh", "pod", "--out", d,
                           "--tag", f"phase9_{i}"]
            + (["--seq-parallel"] if sp else [])
            for i, (a, shape, sp) in enumerate(DRYRUN_CELLS)}
    return start_processes(cmds, d, env=env)


def dryrun_finish(started, d, seconds: dict) -> None:
    """Phase 9's end: its children waited for, a ``dryrun`` line a
    cell; a status other than ok fails the phase."""
    finish_processes(started, DRYRUN_TIMEOUT_S)
    seconds["9"] = time.perf_counter() - started[2]
    for i, (arch, shape, sp) in enumerate(DRYRUN_CELLS):
        res = json.loads(Path(d, f"{arch}__{shape}__pod__phase9_{i}.json")
                         .read_text())
        row = dict(arch=arch, shape=shape, seq_parallel=sp,
                   status=res["status"], error=res.get("error"))
        if res["status"] == "ok":
            mem = res["memory"]
            row.update(n_chips=res["n_chips"], device=res["device"],
                       flops=res["analysis"]["flops"],
                       traced_flops=res["analysis"]["traced_flops"],
                       argument_bytes=mem["argument_bytes"],
                       peak_bytes=mem["peak_bytes"], split=mem["split"],
                       collective_bytes=res["collective_bytes"],
                       trace_s=res["trace_s"])
        log("dryrun", json.dumps(row))
        if res["status"] != "ok":
            raise AssertionError(f"phase 9: {arch} {shape} (sequence "
                                 f"parallelism {sp}) is {res['status']}: "
                                 f"{res.get('error')}")


def op_overhead(kernels) -> dict:
    """The host time a ``repro_torch`` operator adds to a launch:
    ``rglru_scan``'s smallest launch called through its operator and
    through the ``ctypes`` entry directly, many times each, the card kept
    ahead of the host (the launches queue behind a sleeping kernel), in
    microseconds a call; logged as an ``op_overhead`` line."""
    from repro_torch.kernels.rglru_scan import kernel, ops

    a = torch.rand(1, 1, 64, device=DEVICE)
    b, h0 = torch.rand_like(a), torch.zeros(1, 64, device=DEVICE)
    hs, h = torch.empty_like(a), torch.empty_like(h0)
    n = 2000

    def per_call(fn):
        fn(a, b, h0, hs, h)
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            torch.cuda._sleep(SLEEP_CYCLES)
            t0 = time.perf_counter()
            for _ in range(n):
                fn(a, b, h0, hs, h)
            best = min(best, (time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
        return best

    direct = per_call(kernel.launch)
    through = per_call(ops._launch)
    kernels.reset_launch_counts()
    row = dict(kernel="rglru_scan", calls=n, direct_us=direct,
               operator_us=through, added_us=through - direct)
    log("op_overhead", json.dumps(row))
    return row


def matern_entry(rows, post_rows, by_path, main):
    """``matern_score``'s item of the ``kernels`` line. The main path
    launches the posterior entry, so the item's times are its cold and
    warm times at MAIN_SHAPE, with its other rows of ``main`` and the
    CEILING_ROWS beside them, the mean entry's rows at MAIN_SHAPE and
    CEILING_SHAPE, and the launches by (S, N, n) over the main paths."""
    def at(rows_, shape):
        return next(r for r in rows_ if (r["S"], r["N"], r["n"], 2) == shape
                    and "ms" in r)

    main_row = at(post_rows, MAIN_SHAPE)
    times = ("ms", "ms_warm", "plain_ms", "bound_ms", "bound_by")
    return dict(
        name="matern_score", route="cuda",
        source="src/repro_torch/kernels/matern_score/matern_score.cu",
        replaces="src/repro/kernels/matern_score/kernel.py:38",
        entry="matern_posterior_launch", launches=sum(by_path.values()),
        launches_by_path=by_path,
        max_abs_err=max([r["max_abs_err"] for r in rows]
                        + [max(r["mu_max_abs_err"], r["dmu_max_abs_err"])
                           for r in post_rows]),
        **{k: main_row[k] for k in times}, library_ms=None,
        shape=list(MAIN_SHAPE),
        launches_by_shape={"x".join(map(str, k)): v for k, v in
                           sorted(LAUNCHED_SHAPES.items())},
        main_rows=[dict(shape=list(s), **{k: at(post_rows, s)[k]
                                          for k in times})
                   for s in main if s != MAIN_SHAPE],
        ceiling=[dict(shape=list(s), **{k: at(post_rows, s)[k]
                                        for k in times})
                 for s in CEILING_ROWS],
        mean_entry={"x".join(map(str, s[:3])): {k: at(rows, s)[k]
                                                for k in times}
                    for s in (MAIN_SHAPE, CEILING_SHAPE)})


def kernel_entry(name, replaces, rows, main, by_path, source=None,
                 **extra):
    """A kernel's item of the ``kernels`` line; ``ms`` is the cold time
    where the phase took one (``ms_warm`` then beside it); ``extra``
    joins it."""
    row = next(r for r in rows if r["name"] == main)
    warm = {"ms_warm": row["ms"]} if "ms_cold" in row else {}
    return dict(name=name, route="cuda",
                source=source or f"src/repro_torch/kernels/{name}/{name}.cu",
                replaces=replaces, launches=sum(by_path.values()),
                launches_by_path=by_path,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=row.get("ms_cold", row["ms"]), **warm,
                plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"], shape=main, **extra)


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as core
    import repro_torch.kernels as kernels
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.matern_score import kernel as ms_kernel
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as rw_kernel

    # phase 1: setup
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(json.dumps(dict(
        python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)))
    libs = {"matern_score": ms_kernel.LIB, "flash_attention": fa_kernel.LIB,
            "flash_attention_bwd": fa_kernel.BWD_LIB,
            "decode_attention": da_kernel.LIB, "rglru_scan": rg_kernel.LIB,
            "rwkv6_scan": rw_kernel.LIB,
            "rwkv6_scan_bwd": rw_kernel.BWD_LIB}
    t0 = time.perf_counter()
    nvcc.build_all(libs.values())
    for lib in libs.values():
        lib.load()
    log("build", json.dumps(dict(seconds=time.perf_counter() - t0, nvcc_seconds={
        name: lib.build_seconds for name, lib in libs.items()})))
    for name, lib in libs.items():
        instances = ptxas_summary(lib.build_log)
        log(f"build {name}", json.dumps(dict(instances=instances)))
        if any(r.get("spill_stores") or r.get("spill_loads")
               for r in instances):
            log(f"build {name}: an instance spills registers")
    check_rwkv6_build(ptxas_summary(rw_kernel.LIB.build_log))
    check_matern_build(ptxas_summary(ms_kernel.LIB.build_log))
    check_scan_bwd_build(libs)
    bwd_instances = ptxas_summary(fa_kernel.BWD_LIB.build_log)
    if bwd_instances:  # each tensor-core width is built and spills nothing
        for width in (64, 128, 256):
            bwd_build(bwd_instances, width, torch.bfloat16)
    else:
        log("build flash_attention_bwd: already built, spills not checked")
    sass = sass_counts(fa_kernel.LIB.library_path())
    log("sass flash_attention", json.dumps(sass))
    if sass is not None and sass["HMMA"] + sass["HGMMA"] == 0:
        raise AssertionError("flash_attention has no tensor-core "
                             "instruction in its SASS")

    # phase 2: kernels against plain (launches here are not counted)
    seconds, lap = {}, [time.perf_counter()]

    def timed(name, fn, *a):
        """Run a phase and keep its seconds for the ``timings`` line."""
        out = fn(*a)
        seconds[name] = time.perf_counter() - lap[0]
        lap[0] = time.perf_counter()
        return out

    main_shapes = main_rows()
    shapes = main_shapes + CEILING_ROWS
    rows = timed("2 matern_score", kernel_phase, kernels.matern_score,
                 kernels.matern_score_ref, shapes)
    post_rows = timed("2 matern_posterior", posterior_phase, kernels,
                      shapes, main_shapes)
    flash_rows = timed("2 flash_attention", flash_phase, kernels)
    flash_bwd_rows = timed("2 flash_attention_bwd", flash_bwd_phase, kernels,
                           bwd_instances)
    decode_rows = timed("2 decode_attention", decode_phase, kernels)
    decode_lse_rows = timed("2 decode_attention lse", decode_lse_phase,
                            kernels, decode_rows)
    rglru_rows = timed("2 rglru_scan", rglru_phase, kernels)
    rwkv_rows = timed("2 rwkv6_scan", rwkv6_phase, kernels)
    rglru_bwd_rows = timed("2 rglru_scan_bwd", rglru_bwd_phase, kernels)
    rwkv_bwd_rows = timed("2 rwkv6_scan_bwd", rwkv6_bwd_phase, kernels)
    timed("2 op overhead", op_overhead, kernels)

    # phases 3 and 4: the BO engines
    seq_counts, seq_res = timed("3", sequential_phase, core, kernels)
    bat_counts, _, _ = timed("4", batched_phase, core, kernels)
    if seq_counts["matern_score"] == 0 or bat_counts["matern_score"] == 0:
        raise AssertionError(f"matern_score was not launched on the main "
                             f"path (sequential {seq_counts}, batched "
                             f"{bat_counts})")
    timed("4 breakdown", breakdown_phase, core)
    # phases 4b-4f, and beside them phase 8 (training on the mesh): its
    # ranks need nothing of the phases before it, and 4b-4f wait on the
    # host, not the card
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d8:
        train8 = mesh_train_start(d8)
        try:
            bo_counts = bo_phases(seconds)
        except BaseException:
            stop_processes(train8)
            raise
        mesh8_counts = mesh_train_finish(train8, d8, seconds)
    lap[0] = time.perf_counter()
    vgg_counts = timed("4g", vgg_phase, core, kernels, seq_counts, seq_res)

    # phase 5: the LMs at full width, bf16, one at a time
    by_path = {name: {} for name in kernels.WRAPPERS}
    by_path["matern_score"].update(sequential=seq_counts["matern_score"],
                                   batched=bat_counts["matern_score"],
                                   **bo_counts)
    by_path["matern_score"]["vgg:executor run"] = vgg_counts["matern_score"]
    for run in MODEL_RUNS:
        for path, counts in timed(f"5 {run.arch}", model_phase, kernels,
                                  run).items():
            for name, n in counts.items():
                if n:
                    by_path[name][f"{path}:{run.arch}"] = n

    # phase 6: training, one model at a time; phase 9 (the dry run, on
    # the host) beside its first run, which waits on the card
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d9:
        dry9 = dryrun_start(d9)
        try:
            train_counts = {TRAIN_ARCH: timed("6a train", train_phase,
                                              kernels)}
        except BaseException:
            stop_processes(dry9)
            raise
        dryrun_finish(dry9, d9, seconds)
    lap[0] = time.perf_counter()
    step_counts = {TRAIN_ARCH: timed("6b step check", step_check_phase,
                                     kernels)}
    timed("6c resume", resume_phase, kernels)
    for arch in RECURRENT_ARCHS:
        train_counts[arch] = timed(f"6a train {arch}", train_phase, kernels,
                                   arch)
        step_counts[arch] = timed(f"6b step check {arch}", step_check_phase,
                                  kernels, arch)
    moe_layer = timed("6 moe layer check", moe_layer_phase)
    train_counts[MOE_ARCH] = timed(f"6a train {MOE_ARCH}", train_phase,
                                   kernels, MOE_ARCH, moe_layer)
    step_counts[MOE_ARCH] = timed(f"6b step check {MOE_ARCH}",
                                  step_check_phase, kernels, MOE_ARCH)
    timed(f"6c resume {MOE_ARCH}", resume_phase, kernels, MOE_ARCH)
    for arch in train_counts:
        for path, counts in (("train", train_counts[arch]),
                             ("train_step_check", step_counts[arch])):
            for name, n in counts.items():
                if n:
                    by_path[name][f"{path}:{arch}"] = n

    # phase 7: the mesh, ranks sharing the card
    lap[0] = time.perf_counter()
    for path, counts in mesh_phase(seconds).items():
        for name, n in counts.items():
            if n:
                by_path[name][path] = n
    for path, counts in mesh8_counts.items():      # phase 8's, above
        for name, n in counts.items():
            if n:
                by_path[name][path] = n
    lse_launches = {p: n for p, n in by_path["decode_attention"].items()
                    if p.startswith("mesh_generate:recurrentgemma-2b")}
    for name, paths in by_path.items():
        if not paths:
            raise AssertionError(f"{name} was launched on no main path")
    unseen = [s for s in main_shapes if s[:3] not in LAUNCHED_SHAPES]
    if unseen:
        raise AssertionError(f"matern rows {unseen} are not among the "
                             "(S, N, n) the main paths launched: "
                             f"{LAUNCHED_SHAPES}")

    log("timings", json.dumps(dict(
        seconds=seconds, script_s=time.perf_counter() - t_start)))
    log(json.dumps({"kernels": [
        matern_entry(rows, post_rows, by_path["matern_score"],
                     main_shapes),
        kernel_entry("flash_attention",
                     "src/repro/kernels/flash_attention/kernel.py:84",
                     flash_rows, FLASH_MAIN, by_path["flash_attention"]),
        kernel_entry(
            "flash_attention_bwd",
            "src/repro/kernels/flash_attention/kernel.py:84 (the forward; "
            "the reference has no backward kernel: it differentiates its "
            "jnp naive_attention with XLA)",
            flash_bwd_rows, FLASH_BWD_MAIN, by_path["flash_attention_bwd"],
            source="src/repro_torch/kernels/flash_attention/"
                   "flash_attention_bwd.cu",
            design="bf16 redesigned for the tensor cores: deterministic "
                   "dK/dV and dQ kernels on mma.sync (bf16 in, f32 "
                   "accumulate), no atomics; float32 on the CUDA cores"),
        kernel_entry("decode_attention",
                     "src/repro/kernels/decode_attention/kernel.py:63",
                     decode_rows, DECODE_MAIN, by_path["decode_attention"]),
        kernel_entry(
            "decode_attention_lse",
            "src/repro/kernels/decode_attention/kernel.py:63 (with the "
            "row's log-sum-exp written by the merge kernel: the reference "
            "has none; its GSPMD lowers the partial-softmax combine of a "
            "sequence-sharded cache itself)",
            decode_lse_rows, DECODE_LSE_MAIN, lse_launches,
            source="src/repro_torch/kernels/decode_attention/"
                   "decode_attention.cu",
            design="the decode kernel's return_lse: the split-T merge also "
                   "writes max m + log(sum w l) a (row, q head); phase 7b's "
                   "RecurrentGemma-2B decode merges the ranks' ring slices "
                   "with it"),
        kernel_entry("rglru_scan",
                     "src/repro/kernels/rglru_scan/kernel.py:46",
                     rglru_rows, RGLRU_MAIN, by_path["rglru_scan"]),
        kernel_entry("rwkv6_scan",
                     "src/repro/kernels/rwkv6_scan/kernel.py:57",
                     rwkv_rows, RWKV_MAIN, by_path["rwkv6_scan"]),
        kernel_entry(
            "rglru_scan_bwd",
            "src/repro/kernels/rglru_scan/kernel.py:46 (the forward; the "
            "reference has no backward kernel: it differentiates its "
            "associative scan, src/repro/models/rglru.py:105, with XLA)",
            rglru_bwd_rows, SCAN_BWD_MAIN, by_path["rglru_scan_bwd"],
            source="src/repro_torch/kernels/rglru_scan/rglru_scan.cu",
            design="the forward's chunked scan with time reversed, "
                   "float32, no atomics"),
        kernel_entry(
            "rwkv6_scan_bwd",
            "src/repro/kernels/rwkv6_scan/kernel.py:57 (the forward; the "
            "reference has no backward kernel: it differentiates its "
            "jax.lax.scan, src/repro/models/rwkv6.py:55, with XLA)",
            rwkv_bwd_rows, SCAN_BWD_MAIN, by_path["rwkv6_scan_bwd"],
            source="src/repro_torch/kernels/rwkv6_scan/rwkv6_scan_bwd.cu "
                   "and rwkv6_scan.cu (rwkv6_bwd_dv_kernel)",
            design="dv and ds0 by the forward's body in reverse time; dr, "
                   "dk, dlogw by a row kernel that walks each 8-step span "
                   "once from the forward's saved state, the span's states "
                   "on chip, a copy warp staging the next span; float32, "
                   "no atomics"),
    ]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--bo-group"]:
        sys.exit(bo_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--mesh-rank"]:
        r, w, port, d = sys.argv[2:6]
        sys.exit(mesh_rank(int(r), int(w), int(port), d))
    if sys.argv[1:2] == ["--mesh-nccl"]:
        sys.exit(mesh_nccl(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--train-mesh-rank"]:
        r, w, port, d = sys.argv[2:6]
        sys.exit(train_mesh_rank(int(r), int(w), int(port), d))
    if sys.argv[1:2] == ["--train-mesh-nccl"]:
        sys.exit(train_mesh_nccl(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
