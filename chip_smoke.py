#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check its kernels.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run:

1. device        — the card's name and power limit (``nvidia-smi``).
2. build         — compile every ``csrc/*.cu`` of the port for sm_90a into
                   ``build/kernels/``, one ``nvcc`` per source, all started
                   together; print the build seconds and ptxas report, and
                   the flash library's tensor-core (HGMMA) and TMA-load
                   (UTMALDG) instruction counts, the WKV library's
                   tensor-core (HMMA) count and the scan library's
                   special-function (MUFU) and shuffle (SHFL) counts from
                   ``cuobjdump -sass`` (the named ones must be non-zero; a
                   missing cuobjdump is printed); and, since the library's
                   count holds the forward's, the HGMMA and UTMALDG counts
                   of each bf16 backward kernel's own SASS (its three (Dqk,
                   Dv) instances; each must be non-zero) beside its ptxas
                   registers and spill bytes, and the registers and spill
                   bytes of every instance at (192, 128), (48, 32) and
                   (32, 32).
3. kernel        — the flash-attention kernel against its plain PyTorch
                   version on the card at the serving path's shapes (bf16
                   max abs error <= 1e-2: one output rounding plus another
                   sum order; f32 <= 1e-5), with the kernel's, the plain
                   version's and ``scaled_dot_product_attention``'s times
                   (CUDA events over back-to-back calls, which hold the
                   host's time between launches where that is longer)
                   beside the card's bound for the same work; also the
                   kernel's and the library call's device time per call
                   under ``torch.profiler`` (``device_ms``) and the host's
                   time to issue one kernel call (``issue_ms``).  Then
                   mixtral-8x7b's attention (S=8192, GQA 32/8, the window of
                   4096 active) and deepseek-v2-236b's MLA (q/k 192, v 128,
                   128 heads; S=1024 and 4096 bf16, S=300 f32), where the
                   library column names SDPA's kernel (its backend) or
                   says that it refused.
4. kernel (wkv)  — the WKV kernel against its plain (chunked) version, all
                   float32 with K=64, out and final state within
                   1e-4 * max(1, max |plain|): float32 sums in another order
                   through decay factors up to exp(chunk * 4.6 / 2); also
                   the first pass's states entering each chunk against
                   ``wkv_chunk_states``, so that a wrong pass is named.  One
                   row puts every log-decay at the floor.
5. model         — full-width olmo-1b in float32 with seeded random weights:
                   fused prefill of 128 tokens (through the kernel) against
                   the stepped decode loop (plain decode attention), logits
                   and cache K/V within 1e-3.
6. serving       — full-width olmo-1b in bf16 under ``ServingRuntime`` with
                   the OptPerf allocator over two nodes and
                   ``RealServingEngine``: 16 seeded requests, all completed,
                   none dropped, every token inside the vocab, two
                   undisturbed requests equal to a direct greedy decode, and
                   one kernel launch per layer per prefill.
7. model (rwkv6) — full-width rwkv6-7b in float32 with seeded random
                   weights: the forward over 128 tokens launches the WKV
                   kernel once per layer and its logits equal the stepped
                   decode loop's (plain recurrence) within 1e-3.
8. serving (rwkv6) — rwkv6-7b in bf16 at published widths, cut to
                   ``SSM_SERVING_LAYERS`` (8 of 32) layers to keep the
                   whole run inside its time limit, under
                   ``ServingRuntime``: 8 seeded requests whose prompts step the decode loop, as
                   the reference's engine does for a family with no fused
                   prefill; all completed, none dropped, tokens inside the
                   vocab, two undisturbed requests equal to a direct greedy
                   decode; then the per-call times of a 1024-token forward
                   and a decode step, and their device time and idle share
                   under ``torch.profiler``.
9. kernel (ssm)  — the selective-scan kernel against its plain (step by
                   step) version, float32 with N=16, y and final state
                   within 1e-5 * max(1, max |plain|): float32 sums over the
                   16 states in another order, through segments carried
                   with the reference's combine; rows cover a T with no
                   whole last segment and a T below one segment.  Beside
                   the times: busy ms, device ms with the L2 cache flushed
                   before every call (``cold_ms``) and the SM clock.
10. model (hymba) — full-width hymba-1.5b in float32 with seeded random
                   weights: the forward over 128 tokens (inside the window)
                   launches the flash-attention kernel (head dim 64) and the
                   selective-scan kernel once per layer each, and its logits
                   equal the stepped decode loop's (plain torch) within 1e-3.
11. serving (hymba) — hymba-1.5b in bf16, cut to 8 of 32 layers, as
                   phase 8; then the
                   per-call times of a 1024-token forward and a decode step,
                   each kernel's share, device time and idle share.
12. kernel (flash bwd) — the flash-attention backward kernel (dQ, dK, dV
                   from the forward's log-sum-exp) against autograd through
                   the plain ``attention_ref`` on the card, at the training
                   shape and at hymba's, llama3-8b's, a float32,
                   mixtral-8x7b's training shape (B=8, S=512, GQA 32/8) and
                   deepseek-v2-236b's (B=8, S=512, 128 heads at (192, 128)):
                   bf16 within 2e-2 * max(1, max |plain|), f32 within 1e-4 *
                   max(1, max |plain|), and a bf16 row's dq, dk, dv the same
                   bits on two calls (no atomics); with the kernel's, the
                   plain backward's (``attention_backward_ref``) and SDPA's
                   backward times (CUDA events, and SDPA's device ms under
                   ``torch.profiler``) beside the card's bound.
13. training (olmo-1b) — ``HeteroTrainer`` over ``RealBackend`` and
                   ``EpochLoop``: full-width olmo-1b in bf16 (remat on) on
                   the simulated ``cluster_A`` (3 nodes) with
                   ``CannikinController(3, [16, 32, 64], ref_batch=16)``,
                   ``SyntheticLM(seq 512, seed 0)``, SGD at lr 0.01, 2 steps
                   per epoch, 5 epochs (two bootstrap, three OptPerf), the
                   two-program path.  Every loss finite, no node excluded,
                   launch counts as the path predicts, 8 x steps + 2
                   transfers per epoch, peak memory under 80 GB; each node
                   step's wall and device ms; and one node's float32
                   gradient at full width (b=2, S=256) through the kernels
                   against the same gradient with the plain attention passed
                   through the layers' ``attend`` seam: global sq-norm within
                   1e-5 relative, every leaf within 1e-4 * max(1, max |g|).
14. fused training (olmo-1b) — phase 13's run with ``EpochLoop(fused=True)``:
                   epoch 2 plans on the host and runs fused, epochs 3-4
                   plan from certified on-device proposals.  Plans equal
                   phase 13's, ``lr_scale`` within 1e-6 relative, losses
                   within 1e-4 relative, at least 2 fused plans, no
                   certification failure, the worst certification error
                   within 1e-5, 12 h2d and 13 d2h transfers per fused epoch,
                   phase 13's flash launch counts; the device part of each
                   fused epoch runs under
                   ``torch.cuda.set_sync_debug_mode("error")``.  Then the
                   sweep stage alone: device ms, kernel launches and records
                   per call, and the host's issue ms.

15. runtime (olmo-1b) — the Cannikin cluster runtime with full-width
                   olmo-1b bf16 jobs (seq 512, SGD at lr 0.01).  First the
                   scheduler's ``"jax"`` engine on the card against the host
                   ``"batched"`` engine on ``random_jobs(3, 12, seed=0)`` and
                   ``random_jobs(8, 32, seed=1)``: equal assignments,
                   aggregate goodput within 1e-5 relative, no block handed
                   to the scalar oracle; wall, device ms and launches per
                   ``allocate``.  Then ``compare_policies`` (the CLI's
                   ``--mode trace --backend real`` path) on
                   ``synthetic_trace(2, 4, seed=0, total_batch=16)`` with
                   the ``"jax"`` engine on the card, 2 epochs of 2 steps per
                   event and ``FaultPlan.chaos_real(4, seed=0)``: every loss
                   finite, the poisoned node excluded on every step of its
                   window while a job holds it and nowhere else, exactly one
                   solver timeout and one engine degradation (none in the
                   fault-free twin), no invariant violation, the twin's
                   allocations equal to a host-engine replay, flash launches
                   as the path predicts, peak memory under 80 GB; each
                   reconcile's and job-epoch's seconds.  Then one job at
                   published widths, cut to ``PREEMPT_LAYERS`` (4 of 16)
                   layers, preempted through a checkpoint file and
                   resumed: losses, params, momentum and GNS state the same
                   bits as an unpreempted run; the file's bytes and the
                   seconds to write, verify and restore it.
16. sharded training (olmo-1b) — ``RealBackend(sharded=True)``: phase
                   13's configuration through ``EpochLoop``, the node axis
                   split over a NCCL world of one (no default process
                   group).  Against the unsharded backend on the same plans
                   and seeds, 2 epochs of 2 steps: parameters, momentum,
                   every |g_i|^2 and |g|^2 the same bits, losses within
                   ``SHARDED_LOSS_REL``, 96 flash forwards per step against
                   112 (no whole-batch loss forward) and 48 backwards; then
                   one whole train step of each at phase 14's first adaptive
                   plan: wall and device ms, the flash and NCCL kernels'
                   device ms.  Then one fused adaptive epoch on the sharded
                   backend: phase 14's plans and first proposal, certified
                   within 1e-5, 12 h2d and 13 d2h, no host sync.  Then the
                   CLI as a user runs it, ``python -m
                   repro_torch.launch.train --mode spmd --full-width`` (3
                   steps of AdamW at lr 0.01, seq 512, batch 16 in 2
                   microbatches): exit 0, three finite losses, each step's
                   ms.  Where the machine has 2 cards or more, the same
                   comparison in float32 over a NCCL world of
                   ``node_shard_count(3, cards)`` processes with the
                   reference's tolerances; on one card a line says it was
                   not run.  Peak memory of the in-process parts under 80
                   GB.  At its end the world of one's NCCL group is shut
                   down (``release_world_of_one``), so that no communicator
                   outlives the phase.  ``python3 chip_smoke.py --only sharded`` runs
                   phases 1, 2 and 16 alone; ``--only split`` phases 1, 2
                   and 16's multi-card part.
17. kernel (wkv and ssm bwd) — the WKV and selective-scan backward kernels
                   against their plain backwards (``wkv_backward_ref``,
                   ``ssm_scan_backward_ref``) in float32 at one node's
                   training slice (B=40, T=512; WKV H=64, the scan D=3200)
                   and at a ragged T, a strong decay and a nonzero
                   final-state gradient: each output within 1e-4 * max(1,
                   max |plain|), two calls the same bits; ms, plain ms,
                   device ms and the bound.  The scan backward starts
                   from the forward's tile states, as the training path
                   does.
18. training (rwkv6) — rwkv6-7b in bf16, its depth cut to
                   ``RWKV6_TRAIN_LAYERS`` of 32 at published widths, on
                   phase 13's recipe through ``EpochLoop``: five
                   two-program epochs, then three fused ones (the last a
                   fused adaptive epoch whose proposal is certified within
                   1e-5); losses finite, no node excluded, launches as the
                   path predicts (``expected_training_launches``), peak
                   memory under 80 GB, each node step's wall and device ms
                   and its backward kernels' part, and one node's float32
                   gradient (b=2, S=256) through the kernels against the
                   plain versions passed through the model's ``scan`` seam
                   (sq-norm within 1e-5 relative, leaves within 1e-4 *
                   max(1, max |g|)).  Its uncut CLI does not fit one card;
                   a line says so.
19. training (hymba) — the same for hymba-1.5b at published widths, cut
                   to ``HYMBA_TRAIN_LAYERS`` (16 of 32) layers (``attend`` and
                   ``scan`` seams; the gradient check at
                   ``HYMBA_GRAD_LAYERS`` layers), then ``python -m
                   repro_torch.launch.train --mode spmd --arch hymba-1.5b
                   --full-width``: exit 0, three finite losses.
                   ``python3 chip_smoke.py --only train-ssm`` runs phases
                   1, 2 and 17-19 alone.
20. model (dense configs) — the config-only dense ports in float32 at
                   published widths, as phase 5: minitron-4b at full depth,
                   internlm2-20b and chameleon-34b cut to 4 layers
                   (``DENSE_MODEL_LAYERS``; uncut they hold 80 and 137 GB).
21. model (mixtral) — mixtral-8x7b in float32, 4 of 32 layers
                   (``MIXTRAL_MODEL_LAYERS``), 128 tokens: at the published
                   capacity factor 1.25 the forward (one flash launch a
                   layer) against the same forward with the plain attention
                   through the ``attend`` seam; at capacity factor 4.0 (=
                   experts / top-k: nothing drops) against the stepped decode
                   loop; logits within 1e-3; ``drop_frac`` and ``lb_loss``.
22. serving (mixtral) — mixtral-8x7b in bf16, 8 of 32 layers
                   (``MIXTRAL_SERVING_LAYERS``; uncut 93.4 GB), as phase 8;
                   then a 1024-token forward (16 flash launches) and a decode
                   step: wall and device ms, idle share, the flash part, the
                   decode step's byte bound.
23. training (mixtral) — mixtral-8x7b in bf16, 2 of 32 layers
                   (``MIXTRAL_TRAIN_LAYERS``: ``_step`` holds ~14 B a
                   parameter), on phase 13's recipe, two-program: losses
                   finite, no node excluded, 14 flash forwards and 6
                   backward calls a step, peak under 80 GB, each node
                   step's wall and device ms with the flash part and the
                   share of routings its padded slice drops (through
                   ``api.loss`` after the run), and one node's float32 gradient
                   against the plain attention (as phase 13).  A line says
                   the uncut CLI does not fit (AdamW's moments: 374 GB).
                   ``python3 chip_smoke.py --only moe`` runs phases 1, 2
                   and 20-23 alone.
24. model (deepseek) — deepseek-v2-236b in float32, 3 of 60 layers (the
                   dense layer 0 and 2 MoE; ``DEEPSEEK_MODEL_LAYERS``), 128
                   tokens: at the published capacity factor 1.25 the forward
                   (one flash launch a layer at (192, 128)) against the same
                   forward with the plain attention through the ``attend``
                   seam; at 160/6 (nothing drops) against the stepped
                   absorbed decode over the latent cache; logits within
                   1e-3; ``drop_frac`` and ``lb_loss``.
25. serving (deepseek) — deepseek-v2-236b in bf16, 4 of 60 layers
                   (``DEEPSEEK_SERVING_LAYERS``; 26.6 GB), as phase 22; the
                   decode step's byte bound counts the top-6 routed and the
                   shared experts of each MoE layer.
26. training (deepseek) — deepseek-v2-236b in bf16, 2 of 60 layers: one
                   node's step through ``api.loss`` and its backward at a
                   padded b=40 (34 weighted), S=512, remat on (wall and
                   device ms, the flash forward and backward parts,
                   launches, peak under 80 GB); one node's float32 gradient
                   through the kernels against the plain attention (as
                   phase 13); a line on why the 3-node ``EpochLoop`` does
                   not fit (~14 B a parameter of ``_step`` state: 75 GB);
                   then ``python -m repro_torch.launch.train`` with its
                   default arguments (reduced olmo-1b, float32, head dim 32,
                   on the float32 instance at (32, 32)): exit 0, every loss
                   finite.  ``python3 chip_smoke.py --only deepseek`` runs
                   phases 1, 2, the deepseek rows of 3 and 12, and 24-26.
27. model (whisper) — whisper-large-v3 in float32 at published widths
                   (``WHISPER_MODEL_LAYERS``; uncut), B=2, 1500 frames, 128
                   text tokens: ``api.logits`` (one flash launch an
                   attention: the encoder's and the cross non-causal, the
                   decoder's causal) against the same forward with the plain
                   attention through the three seams, within 1e-4; against
                   ``encode``, ``prime_cache`` and the stepped decode (plain
                   torch), within 1e-3; the gradient of ``api.loss`` with
                   per-sample weights through the kernels against the plain
                   seams (sq-norm within 1e-5 relative, leaves within 1e-4 *
                   max(1, max |g|)).
28. serving (whisper) — whisper-large-v3 in bf16, uncut: eight windows of
                   1500 frames through ``encode`` (32 flash launches),
                   ``prime_cache`` and 64 greedy ``decode_step``s (none):
                   finite logits, tokens inside the vocab; the encoder
                   forward's and a decode step's wall and device ms, idle
                   share and flash part, beside the decode step's byte
                   bound.  The reference drives whisper through the
                   registry only (no serving engine or ``EpochLoop`` has
                   audio input), and so does the port.
29. training (whisper) — whisper-large-v3 in bf16, uncut, remat on: 3
                   steps of ``build_train_step(api, adamw(...))`` on B=8 x
                   1500 frames and 375 tokens with per-sample weights: every
                   loss finite, weights changed, 192 flash forwards and 96
                   backward calls a step, peak under 80 GB; the step's wall
                   and device ms and the flash parts.  Phases 3 and 12 carry
                   whisper's non-causal rows (B=8, 20 heads of 64: the
                   encoder at S = T = 1500 and the cross-attention at S =
                   375, T = 1500).  ``python3 chip_smoke.py --only whisper``
                   runs phases 1, 2, those rows and 27-29.
30. dry run      — the dry run (``python -m repro_torch.launch.dryrun``) on
                   the ``"cuda"`` single-pod mesh, the kernels' custom ops'
                   route, in child processes side by side: olmo-1b
                   ``train_4k`` and ``decode_32k``, deepseek-v2-236b
                   ``train_4k`` (depth cut to ``DRYRUN_DEEPSEEK_LAYERS``;
                   FSDP, the expert axis, MLA through flash at (192, 128)),
                   rwkv6-7b ``prefill_32k`` and hymba-1.5b ``long_500k``,
                   each ``ok``, with a ``[dryrun]`` line of its per-device
                   counts (not card times) and whether its argument and temp
                   bytes fit 80 GB.  Then, in another child, the dry run held
                   to a real step: full-width olmo-1b bf16,
                   ``build_train_step`` with AdamW at B=8 x 512, traced on a
                   one-rank ``"cuda"`` mesh and then run on the card under
                   ``FlopCounterMode``: argument bytes equal, matmul FLOPs
                   equal (flash's custom ops included), the real peak within
                   10 % of the predicted argument + temp bytes; the real step
                   launches the flash forward and backward.  ``python3
                   chip_smoke.py --only dryrun`` runs phases 1, 2 and 30.

The launch counts are set to 0 just before each model's path (phases 5-6
for olmo-1b, 7-8 for rwkv6-7b, 10-11 for hymba-1.5b, 13 and 14 for
training, 15's trace, each run of 16, each training run of 18 and 19,
each model of 20, each forward of 21, 22's serving run and forward, 23's
training run, each forward of 24, 25's serving run and forward, 26's node
steps, 27's forward, encode, stepped decode and each gradient, 28's encoder
forward and decode loop, 29's training steps, 30's real step) and read just
after it.
Device ms of a named kernel are per launch the profiler recorded, with the
count of records beside them.  The last three lines of standard output are
the card line from ``nvidia-smi``, a JSON line describing each kernel, and
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the repository beside
it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# Phase 18's whole-batch loss asks for one 15 GiB block at a 61 GB peak,
# after the WKV passes' 2 GB scratch blocks have cut the cache up: with
# fixed segments that request has failed on a card with 29 GB cached but
# free.  Growable segments keep the cache whole (set before torch loads;
# it changes no allocated byte, which every peak here reads).
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HBM_BYTES_S = 3.35e12                  # H100 SXM device memory rate
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}  # f32 off the tensor cores
REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:85"
SOURCE_REL = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
MAIN_CASE = "olmo-1b S=512"            # the kernel line's shape: a typical prompt
WKV_REPLACES = "src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:86"
WKV_SOURCE_REL = "src/repro_torch/kernels/rwkv6_wkv/csrc/wkv.cu"
WKV_MAIN_CASE = "rwkv6-7b T=1024"      # the forward's shape at 1024 tokens
WKV_PROFILE_PREFIX = "wkv_"            # every CUDA kernel of the WKV passes
WKV_KERNELS = 2                        # wkv_states_kernel, wkv_out_kernel per call
SSM_REPLACES = "src/repro/kernels/ssm_scan/ssm_scan.py:63"
SSM_SOURCE_REL = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu"
SSM_MAIN_CASE = "hymba-1.5b T=1024"    # the forward's shape at 1024 tokens
SSM_PROFILE_PREFIX = "ssm_"            # every CUDA kernel of the selective scan
HYMBA_FLASH_CASE = "hymba-1.5b global S=1024"
FLASH_PROFILE_NAME = "flash_fwd_kernel"  # both forward instances
BWD_PROFILE_NAME = "flash_bwd_"        # the backward's three kernels
BWD_SM90_KERNELS = ("flash_bwd_dkdv_kernel_sm90", "flash_bwd_dq_kernel_sm90")  # bf16
# Mangled-name tags of the flash instances at (Dqk, Dv) = (192, 128), (48, 32)
# and (32, 32), whose ptxas registers and spills phase 2 prints.
NEW_INSTANCE_TAGS = ("ILi192ELi128E", "ILi48ELi32E", "ILi32ELi32E", "IfLi192ELi128E",
                     "IfLi48ELi32E", "IfLi32ELi32E")
BWD_MAIN_CASE = "olmo-1b train S=512 B=8"
# Whisper-large-v3's non-causal attentions (20 heads of 64, MHA, bf16, B=8):
# the encoder's self-attention over 1500 frames (23 tiles of 64 and 28
# rows) and the cross-attention of 375 text positions against them.
WHISPER_ENC_CASE = "whisper-large-v3 encoder S=T=1500"
WHISPER_CROSS_CASE = "whisper-large-v3 cross S=375 T=1500"
WHISPER_CASES = [
    (WHISPER_ENC_CASE, 8, 1500, 20, 20, "bf16", None, 64, 1500, False),
    (WHISPER_CROSS_CASE, 8, 375, 20, 20, "bf16", None, 64, 1500, False),
]
# name, B, S, H, KV, dtype, window, D[, T, causal] (see ``flash_shape``: T
# defaults to S and causal to True); D is a (Dqk, Dv) pair where v's head
# dim differs (DeepSeek-V2's MLA)
BWD_CASES = [
    ("olmo-1b train S=512 B=8", 8, 512, 16, 16, "bf16", None, 128),
    ("hymba-1.5b global S=1024", 1, 1024, 25, 5, "bf16", None, 64),
    ("hymba-1.5b window=1024 S=2048", 1, 2048, 25, 5, "bf16", 1024, 64),
    ("llama3-8b heads S=1024", 1, 1024, 32, 8, "bf16", None, 128),
    ("f32 S=T=300", 1, 300, 16, 16, "f32", None, 128),
    ("mixtral-8x7b train B=8 S=512", 8, 512, 32, 8, "bf16", 4096, 128),
    ("deepseek-v2-236b train B=8 S=512", 8, 512, 128, 128, "bf16", None, (192, 128)),
    *WHISPER_CASES,
]
BWD_REL = {"bf16": 2e-2, "f32": 1e-4}

# name, B, S, H, KV, dtype, window, D or (Dqk, Dv)[, T, causal], as BWD_CASES
KERNEL_CASES = [
    ("olmo-1b S=128", 1, 128, 16, 16, "bf16", None, 128),
    ("olmo-1b S=512", 1, 512, 16, 16, "bf16", None, 128),
    ("olmo-1b S=2048", 1, 2048, 16, 16, "bf16", None, 128),
    ("llama3-8b heads S=1024", 1, 1024, 32, 8, "bf16", None, 128),
    ("window=256 S=1024", 1, 1024, 16, 16, "bf16", 256, 128),
    ("f32 S=T=300", 1, 300, 16, 16, "f32", None, 128),
    ("hymba-1.5b global S=1024", 1, 1024, 25, 5, "bf16", None, 64),
    ("hymba-1.5b window=1024 S=2048", 1, 2048, 25, 5, "bf16", 1024, 64),
    ("D=64 f32 S=T=300", 1, 300, 25, 5, "f32", None, 64),
    ("mixtral-8x7b S=8192 window=4096", 1, 8192, 32, 8, "bf16", 4096, 128),
    ("deepseek-v2-236b S=1024", 1, 1024, 128, 128, "bf16", None, (192, 128)),
    ("deepseek-v2-236b S=4096", 1, 4096, 128, 128, "bf16", None, (192, 128)),
    ("deepseek f32 S=T=300", 1, 300, 16, 16, "f32", None, (192, 128)),
    *WHISPER_CASES,
]
# The deepseek-v2-236b rows of phases 3 and 12 (the MLA instance, (192, 128)).
DEEPSEEK_CASE = "deepseek-v2-236b S=1024"
DEEPSEEK_BWD_CASE = "deepseek-v2-236b train B=8 S=512"
TOL = {"bf16": 1e-2, "f32": 1e-5}
# name, B, T, H, chunk, strong decay (float32, K = 64)
WKV_CASES = [
    ("rwkv6-7b T=1024", 1, 1024, 64, 32, False),
    ("T=128", 1, 128, 64, 32, False),
    ("ragged T=300", 1, 300, 64, 32, False),
    ("B=4 T=256", 4, 256, 64, 32, False),
    ("chunk 64 T=1024", 1, 1024, 64, 64, False),
    ("strong decay T=1024", 1, 1024, 64, 32, True),
]
WKV_REL = 1e-4
# name, B, T, D, chunk, strong decay (float32, N = 16)
SSM_CASES = [
    ("hymba-1.5b T=1024", 1, 1024, 3200, 128, False),
    ("T=128", 1, 128, 3200, 128, False),
    ("ragged T=300", 1, 300, 3200, 128, False),
    ("B=4 T=256", 4, 256, 3200, 128, False),
    ("D=203 (last 8-channel tile ragged)", 1, 256, 203, 128, False),
    ("strong decay T=1024", 1, 1024, 3200, 128, True),
    ("T=1021 (no whole last segment)", 1, 1021, 3200, 128, False),
    ("T=5 (below one segment)", 1, 5, 3200, 128, True),
]
SSM_REL = 1e-5
SFU_EXP_S = 132 * 16 * 1.98e9          # H100 SXM: 16 exponentials per clock and SM at boost
WKV_BWD_SOURCE_REL = "src/repro_torch/kernels/rwkv6_wkv/csrc/wkv_backward.cu"
SSM_BWD_SOURCE_REL = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan_backward.cu"
WKV_BWD_PROFILE = "wkv_bwd_"           # the WKV backward's three kernels
SSM_BWD_PROFILE = "ssm_bwd_"           # the scan backward's two kernels
# CUDA kernels per backward call, by profiler prefix: the flash backward's
# three; wkv_bwd_state_kernel, wkv_bwd_grad_kernel, wkv_bwd_du_kernel;
# ssm_bwd_kernel, ssm_bwd_reduce_kernel.
BWD_KERNELS_PER_CALL = {BWD_PROFILE_NAME: 3, WKV_BWD_PROFILE: 3, SSM_BWD_PROFILE: 2}
# Phase 17: name, B, T, H (or D), chunk, strong decay, final-state gradient
# (float32; WKV K = 64, the scan N = 16).  The first row of each is one
# node's training slice (b_max 40 at S 512).
WKV_BWD_CASES = [
    ("rwkv6-7b train B=40 T=512", 40, 512, 64, 32, False, False),
    ("ragged T=300", 2, 300, 64, 32, False, True),
    ("strong decay T=512", 4, 512, 64, 32, True, False),
    ("final-state grad B=8 T=512", 8, 512, 64, 32, False, True),
]
SSM_BWD_CASES = [
    ("hymba-1.5b train B=40 T=512", 40, 512, 3200, 128, False, False),
    ("ragged T=301 D=203", 2, 301, 203, 128, False, True),
    ("strong decay T=512", 4, 512, 3200, 128, True, False),
    ("final-state grad B=8 T=512", 8, 512, 3200, 128, False, True),
]
WKV_BWD_MAIN_CASE = WKV_BWD_CASES[0][0]
SSM_BWD_MAIN_CASE = SSM_BWD_CASES[0][0]
KERNEL_BWD_REL = 1e-4  # float32 sums in another order, per output x max(1, max |plain|)
RWKV6_TRAIN_LAYERS = 12  # phase 18's depth cut (of 32): see PERF.md section 4
# Cuts that keep the whole run inside its time limit (PERF.md section 4):
SSM_SERVING_LAYERS = 8   # phases 8 and 11 serve rwkv6-7b and hymba-1.5b 8 of 32 layers deep
HYMBA_TRAIN_LAYERS = 16  # phase 19 trains hymba-1.5b 16 of 32 layers deep
PREEMPT_LAYERS = 4       # phase 15's preempt/resume job: olmo-1b 4 of 16 layers deep
# Phases 20-23's depth cuts at published widths (None: uncut); PERF.md section 4.
DENSE_MODEL_LAYERS = {"minitron-4b": None, "internlm2-20b": 4, "chameleon-34b": 4}
MIXTRAL_MODEL_LAYERS = 4     # phase 21, float32: 6.1 B parameters, 24 GB
MIXTRAL_SERVING_LAYERS = 8   # phase 22, bf16: 11.9 B parameters, 23.7 GB
MIXTRAL_TRAIN_LAYERS = 2     # phase 23, bf16: 3.16 B parameters, ~14 B each held by _step
MIXTRAL_DROPLESS_CF = 4.0    # = experts / top-k: every expert's capacity is T
# Phases 24-26's depth cuts of deepseek-v2-236b (60 layers: the dense layer
# 0, then MoE) at published widths; PERF.md section 4.
DEEPSEEK_MODEL_LAYERS = 3    # phase 24, float32: dense + 2 MoE, 9.33 B parameters, 37.3 GB
DEEPSEEK_SERVING_LAYERS = 4  # phase 25, bf16: dense + 3 MoE, 13.30 B parameters, 26.6 GB
DEEPSEEK_TRAIN_LAYERS = 2    # phase 26, bf16: dense + 1 MoE, 5.36 B parameters
DEEPSEEK_DROPLESS_CF = 160 / 6  # = experts / top-k: every expert's capacity is T
# Phases 27-29: whisper-large-v3 (32 encoder + 32 decoder layers) at published
# widths; PERF.md section 4.
WHISPER_MODEL_LAYERS = None  # phase 27, float32: uncut (1.53 B parameters, 6.1 GB)
WHISPER_MODEL_TEXT = 128     # phase 27's text positions, stepped one by one
WHISPER_DECODE_STEPS = 64    # phase 28's greedy decode steps
WHISPER_TRAIN_TEXT = 375     # phase 29's text positions: S_enc / 4, the reference's ratio
DEVICE = "cuda"


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls."""
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


def host_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the host clock around synchronized work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_split(torch, fn, calls: int, wall_ms: float, kernels, launches=None):
    """Device milliseconds per call (kernel time under ``torch.profiler``),
    each named kernel's part of it, the device's idle share of ``wall_ms``,
    the unprofiled host time per call, each named kernel's busy ms and its
    count of records (see ``profile_device``).  The total is per call made:
    a lost record lowers it, which the named kernels' records show."""
    dev, named, busy, records = profile_device(torch, fn, calls, kernels, launches=launches)
    return dev, named, 1.0 - dev / wall_ms, busy, records


def device_ms(torch, fn, calls: int, warmup: int = 3) -> float:
    """Milliseconds of device time per call: every kernel ``fn`` launches,
    under ``torch.profiler``.  Unlike ``cuda_ms`` it leaves out the host's
    time between launches, which bounds a short kernel's back-to-back rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return profile_device(torch, fn, calls, ())[0]


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals: the time at least one
    of them runs."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile_device(torch, fn, calls: int, kernels, attempts: int = 5, launches=None,
                   sole: bool = False):
    """Device milliseconds per call (the sum of kernel times under
    ``torch.profiler``), each named kernel's part of that sum (every kernel
    whose name holds the given name), each named kernel's busy milliseconds
    per call (the union of those same kernels' intervals, which counts once
    the time where they overlap, as the WKV passes do, and equals their
    part of the sum where none overlap), and each named kernel's count of
    records.  The profiler can lose kernel records (on an H100, this
    script's scan windows recorded 12-13 of 20 launches): where ``launches``
    gives a named kernel's launches per call, its part and busy time are
    taken per recorded launch times that count, not per call.  A window that
    records no device time, or no record of a kernel in ``launches``, is
    reported on stderr and profiled again, up to ``attempts`` windows.  If
    every window lost them, the same calls are timed with CUDA events
    instead: that time per call is the device ms, and each named kernel's
    part and busy ms where the call launches only the named kernels
    (``sole``), else NaN; every count of records is then 0, and a line on
    stdout says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launches = launches or {}
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        device = 0.0
        named = dict.fromkeys(kernels, 0.0)
        records = dict.fromkeys(kernels, 0)
        cuda_events = 0
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
                cuda_events += evt.count
                device += evt.self_device_time_total
                for kernel in kernels:
                    if kernel in evt.key:
                        named[kernel] += evt.self_device_time_total
                        records[kernel] += evt.count
        if device > 0.0 and all(records[k] for k in launches):
            per = {k: records[k] / launches[k] if k in launches else calls for k in kernels}
            named_ms = {kernel: t / 1e3 / per[kernel] for kernel, t in named.items()}
            busy_ms = {kernel: busy_us((evt.time_range.start, evt.time_range.end)
                                       for evt in prof.events()
                                       if evt.device_type == DeviceType.CUDA
                                       and evt.self_device_time_total > 0
                                       and kernel in evt.name) / 1e3 / per[kernel]
                       for kernel in kernels}
            return device / 1e3 / calls, named_ms, busy_ms, records
        print(f"chip_smoke: profile window {attempt + 1} of {attempts} over {calls} calls: "
              f"{cuda_events} device records, {device:.1f} us, named records {records} "
              f"(launches per call {launches})", file=sys.stderr, flush=True)
    total = cuda_ms(torch, fn, calls, warmup=0)
    part = total if sole else float("nan")
    log("profile", f"the profiler recorded no device time (or no record of {list(launches)}) "
        f"in {attempts} windows: device ms {total:.4f} per call from CUDA events over "
        f"{calls} calls; named kernels {list(kernels)} "
        + ("are the whole call" if sole else "not measured"))
    return (total, dict.fromkeys(kernels, part), dict.fromkeys(kernels, part),
            dict.fromkeys(kernels, 0))


def head_dims(d):
    """(Dqk, Dv) of a case's head dim or pair."""
    return d if isinstance(d, tuple) else (d, d)


def flash_shape(case):
    """(name, B, S, T, H, KV, dtype, window, D, causal) of a flash case; a
    case without T and causal is causal self-attention (T = S)."""
    name, b, s, h, kv, dt, window, d, *rest = case
    t, causal = rest if rest else (s, True)
    return name, b, s, t, h, kv, dt, window, d, causal


def attention_pairs(s, t, window, causal):
    """The (query, key) pairs an attention call computes: causal
    self-attention (T = S) up to the window, or every S x T pair."""
    if not causal:
        if window is not None:
            raise ValueError("a non-causal bound with a window is not counted here")
        return s * t
    w = s if window is None else min(window, s)
    return sum(min(q + 1, w) for q in range(s))


def roofline(nbytes, flops, dtype):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the peak rate for the dtype."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def attention_bound(b, s, h, kv, d, dtype, window, t=None, causal=True):
    """Least time for one attention call: q (Dqk) read and o (Dv) written
    once over S, k (Dqk) and v (Dv) read once over T (default S), over the
    memory rate; or the products over the valid (query, key) pairs of this
    call (``attention_pairs``) over the peak rate for the dtype."""
    t = s if t is None else t
    dqk, dv = head_dims(d)
    elem = 2 if dtype == "bf16" else 4
    nbytes = elem * b * (s * h * (dqk + dv) + t * kv * (dqk + dv))
    flops = 2 * (dqk + dv) * b * h * attention_pairs(s, t, window, causal)
    return roofline(nbytes, flops, dtype)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log("device", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    return card


def phase_build():
    import re

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    sources = [flash_ops.SOURCE, wkv_ops.SOURCE, ssm_ops.SOURCE, wkv_ops.BACKWARD_SOURCE,
               ssm_ops.BACKWARD_SOURCE]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        results = list(pool.map(build.build, sources))
    for res in results:
        log("build", f"{res.path.name}: {res.seconds:.2f} s")
        for line in res.log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "wgmma", "Function properties")):
                log("build", line.strip())
    for fn, regs, stores, loads in ptxas_summary(results[0].log, BWD_SM90_KERNELS):
        log("build", f"ptxas {fn}: registers={regs} spill_stores={stores} spill_loads={loads}")
    # The instances added for DeepSeek-V2's MLA (192, 128) and the float32
    # ones at the reduced configs' head dims.
    for fn, regs, stores, loads in ptxas_summary(results[0].log, NEW_INSTANCE_TAGS):
        if not any(kernel in fn for kernel in BWD_SM90_KERNELS):  # printed above
            log("build", f"ptxas {fn}: registers={regs} spill_stores={stores} spill_loads={loads}")
    for res in results[3:]:
        for fn, regs, stores, loads in ptxas_summary(res.log, ("_bwd_",)):
            log("build", f"ptxas {fn}: registers={regs} spill_stores={stores} spill_loads={loads}")
    for res, need, why in ((results[0], ("HGMMA", "UTMALDG"), "run wgmma on TMA tiles"),
                           (results[1], ("HMMA",), "run its products on the tensor cores"),
                           (results[2], ("MUFU",), "compute its exponentials")):
        source = res.path.name.split("-")[0] + ".cu"
        by_fn = sass_counts(build, res.path)
        if by_fn is None:
            log("build", f"{source} SASS: cuobjdump is missing, {'/'.join(need)} not counted")
            continue
        counts = sum_counts(by_fn.values())
        log("build", f"{source} SASS: " + " ".join(f"{k}={v}" for k, v in counts.items()))
        if not all(counts[op] for op in need):
            raise AssertionError(f"{source} must {why}: {counts}")
        if res is not results[0]:
            continue
        # The library-wide count holds the forward's wgmma and TMA loads:
        # the bf16 backward kernels must show their own.
        for kernel in BWD_SM90_KERNELS:
            own = {fn: c for fn, c in by_fn.items() if kernel in fn}
            if len(own) != 3:  # head dims (64, 64), (128, 128), (192, 128)
                raise AssertionError(f"{kernel}: expected three instances in the SASS, got {list(own)}")
            for fn, c in sorted(own.items()):
                dims = ",".join(re.search(r"ILi(\d+)ELi(\d+)E", fn).groups())
                log("build", f"{source} SASS {kernel}<{dims}>: "
                    + " ".join(f"{k}={c[k]}" for k in ("HGMMA", "UTMALDG")))
                if not (c["HGMMA"] and c["UTMALDG"]):
                    raise AssertionError(f"{fn} must run wgmma on TMA tiles: {c}")


def ptxas_summary(log_text, names):
    """(function, registers, spill-store bytes, spill-load bytes) from ptxas's
    ``-v`` report for each entry function whose name holds one of ``names``."""
    import re

    rows, current, spills = [], None, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current and any(n in current for n in names):
            rows.append((current, int(m.group(1)), *(spills or (None, None))))
            spills = None
    return rows


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS", "MUFU", "SHFL")


def sum_counts(counts):
    total = dict.fromkeys(SASS_OPS, 0)
    for c in counts:
        for op in SASS_OPS:
            total[op] += c[op]
    return total


def sass_counts(build, lib):
    """Tensor-core (HGMMA: wgmma; HMMA: mma.sync), TMA-load (UTMALDG),
    cp.async (LDGSTS), special-function (MUFU: exponentials) and cross-lane
    (SHFL) instructions in each function of a built library's SASS (by its
    mangled name), or None without cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump")
    beside = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if tool is None and os.path.exists(beside):
        tool = beside
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    by_fn, counts = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            counts = by_fn.setdefault(line.split("Function :", 1)[1].strip(),
                                      dict.fromkeys(SASS_OPS, 0))
            continue
        if counts is None:
            continue
        for word in line.split():
            op = word.split(".")[0]
            if op in counts:
                counts[op] += 1
    return by_fn


def issue_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Host milliseconds to issue one call: the host clock over ``iters``
    calls, read before the closing synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def flash_case(torch, flash_attention, attention_ref, case, gen):
    """One ``KERNEL_CASES`` row for a flash-attention entry and its plain
    version: the kernel's max abs error, its, the plain version's and
    ``scaled_dot_product_attention``'s CUDA-event ms over back-to-back calls
    (``ms``, ``plain_ms``, ``library_ms``), the kernel's device ms per
    recorded launch under ``torch.profiler`` (``device_ms``, with
    ``records`` of the 20 launches) and the library call's per call
    (``library_device_ms``), the host's ms to issue one kernel call
    (``issue_ms``) and the card's bound."""
    import torch.nn.functional as F

    name, b, s, t, h, kv, dt, window, d, causal = flash_shape(case)
    dqk, dv = head_dims(d)
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    q, k, v = (torch.randn((b, n_rows, n, dim), generator=gen, device=DEVICE).to(dtype)
               for n_rows, n, dim in ((s, h, dqk), (t, kv, dqk), (t, kv, dv)))

    def kernel():
        return flash_attention(q, k, v, causal=causal, window=window)

    out = kernel()
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=causal, window=window)
    err = (out.float() - ref.float()).abs().max().item()
    del out, ref

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = sdpa_window_mask(torch, s, window)

    def library():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=h != kv)

    bound_ms, bound_by = attention_bound(b, s, h, kv, d, dt, window, t, causal)
    ms = cuda_ms(torch, kernel, 20)
    _, named, _, records = profile_device(torch, kernel, 20, (FLASH_PROFILE_NAME,),
                                          launches={FLASH_PROFILE_NAME: 1}, sole=True)
    return dict(
        max_abs_err=err,
        ms=ms,
        plain_ms=cuda_ms(torch, lambda: attention_ref(q, k, v, causal=causal, window=window),
                         5),
        device_ms=named[FLASH_PROFILE_NAME], records=records[FLASH_PROFILE_NAME],
        issue_ms=issue_ms(torch, kernel, 20),
        bound_ms=bound_ms, bound_by=bound_by,
        **library_row(torch, library, 20),
    )


def sdpa_window_mask(torch, s, window):
    """SDPA's boolean mask for causal self-attention inside a window (a key
    at most ``window - 1`` behind its query), or None without a window."""
    if window is None:
        return None
    pos = torch.arange(s, device=DEVICE)
    return (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)


def library_row(torch, library, calls):
    """The yardstick PyTorch call's CUDA-event ms (``library_ms``), its
    device ms per call (``library_device_ms``) and the name of its longest
    kernel, which says which SDPA backend ran (``library_kernel``); where
    the call refuses these inputs (an SDPA without a backend for them),
    ``library_ms`` is None and ``library_kernel`` says why."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        library()
        torch.cuda.synchronize()
    except RuntimeError as err:
        return dict(library_ms=None, library_device_ms=None,
                    library_kernel="refused: " + str(err).splitlines()[0][:160])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        library()
        torch.cuda.synchronize()
    kernels = [(evt.self_device_time_total, evt.key) for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA]
    return dict(library_ms=cuda_ms(torch, library, calls),
                library_device_ms=device_ms(torch, library, calls),
                library_kernel=max(kernels)[1][:80] if kernels else "no kernel recorded")


def phase_kernel(torch, cases=KERNEL_CASES):
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = {}
    for case in cases:
        name, b, s, t, h, kv, dt, window, d, causal = flash_shape(case)
        row = rows[name] = flash_case(torch, flash_attention, attention_ref, case, gen)
        err, ms = row["max_abs_err"], row["ms"]
        if not err <= TOL[dt]:
            raise AssertionError(f"{name}: max abs err {err:.3e} > {TOL[dt]:.0e}")
        log("kernel", f"{name} B={b} H={h} KV={kv} D={d} {dt} window={window}"
            f"{cross_label(s, t, causal)}: "
            f"max_abs_err={err:.3e} (tol {TOL[dt]:.0e}) ms={ms:.4f} "
            f"plain_ms={row['plain_ms']:.4f} library_ms={fmt_ms(row['library_ms'])} "
            f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) "
            f"of_bound={row['bound_ms'] / ms:.4f} device_ms={row['device_ms']:.4f} "
            f"records={row['records']}/20 "
            f"library_device_ms={fmt_ms(row['library_device_ms'])} "
            f"library_kernel={row['library_kernel']!r} issue_ms={row['issue_ms']:.4f}")
    return rows


def cross_label(s, t, causal):
    """A kernel row's label for what is not causal self-attention."""
    return "" if (t, causal) == (s, True) else f" T={t} causal={causal}"


def fmt_ms(ms):
    return "None" if ms is None else f"{ms:.4f}"


def wkv_bound(b, t, h, k):
    """Least time for one WKV call: r, k, v, log_w read once, out written
    once, plus u and the final state (float32), over the memory rate; or
    the sequential recurrence's 4 K^2 operations per token and head over
    the float32 rate."""
    nbytes = 4 * (5 * b * t * h * k + h * k + b * h * k * k)
    flops = 4 * k * k * b * t * h
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS["f32"]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def wkv_case(torch, mod, case, gen):
    """One ``WKV_CASES`` row for a WKV package ``mod`` (its ``wkv`` and
    plain ``wkv_chunked``): max abs errors of out and the final state and,
    where the package has ``wkv_with_chunk_states``, of the first pass's
    states entering each chunk against ``wkv_chunk_states``, each beside
    its tolerance; the kernel's and the plain version's CUDA-event ms over
    back-to-back calls (``ms``, ``plain_ms``), the kernel's device ms per
    call under ``torch.profiler`` (``device_ms``: the WKV passes' summed
    time; ``busy_ms``: the union of their intervals, which counts their
    overlap once; both per recorded launch, ``records`` of the 40), the
    host's ms to issue one call (``issue_ms``) and the card's bound."""
    name, b, t, h, chunk, strong = case
    k = 64

    def rand(shape, scale):
        return torch.randn(shape, generator=gen, device=DEVICE) * scale

    r, kk, v = (rand((b, t, h, k), 0.5) for _ in range(3))
    if strong:  # every log-decay clamps to the floor: mid-point exponents +-chunk * 2.3
        lw = mod.LOG_DECAY_MIN - rand((b, t, h, k), 1.0).abs()
    else:
        lw = -torch.exp(rand((b, t, h, k), 1.0))
    u = rand((h, k), 0.2)
    pairs = []
    # A package from before the two-pass kernel (tools/kernel_compare.py
    # times one beside this checkout) has no chunk states to check.
    if hasattr(mod, "wkv_with_chunk_states"):
        out, state, states = mod.wkv_with_chunk_states(r, kk, v, lw, u, chunk=chunk)
        torch.cuda.synchronize()
        pairs.append(("states", states, mod.wkv_chunk_states(kk, v, lw, chunk=chunk)[0]))
    else:
        out, state = mod.wkv(r, kk, v, lw, u, chunk=chunk)
    ref_out, ref_state = mod.wkv_chunked(r, kk, v, lw, u, chunk=chunk)
    pairs += [("out", out, ref_out), ("state", state, ref_state)]
    errs = {key: (got - want).abs().max().item() for key, got, want in pairs}
    tols = {key: WKV_REL * max(1.0, want.abs().max().item()) for key, _, want in pairs}
    del pairs, out, state, ref_out, ref_state

    def kernel():
        return mod.wkv(r, kk, v, lw, u, chunk=chunk)

    bound_ms, bound_by = wkv_bound(b, t, h, k)
    ms = cuda_ms(torch, kernel, 20)
    _, named, busy, records = profile_device(torch, kernel, 20, (WKV_PROFILE_PREFIX,),
                                             launches={WKV_PROFILE_PREFIX: WKV_KERNELS},
                                             sole=True)
    return dict(
        errs=errs, tols=tols, max_abs_err=max(errs.values()), ms=ms,
        plain_ms=cuda_ms(torch, lambda: mod.wkv_chunked(r, kk, v, lw, u, chunk=chunk), 3),
        library_ms=None, device_ms=named[WKV_PROFILE_PREFIX], busy_ms=busy[WKV_PROFILE_PREFIX],
        records=records[WKV_PROFILE_PREFIX],
        issue_ms=issue_ms(torch, kernel, 20),
        bound_ms=bound_ms, bound_by=bound_by,
    )


def phase_kernel_wkv(torch):
    from repro_torch.kernels import rwkv6_wkv

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    rows = {}
    for case in WKV_CASES:
        name, b, t, h, chunk, strong = case
        row = rows[name] = wkv_case(torch, rwkv6_wkv, case, gen)
        errs, tols, ms = row["errs"], row["tols"], row["ms"]
        for key, err in errs.items():
            if not err <= tols[key]:
                raise AssertionError(f"wkv {name}: {key} max abs err {err:.3e} > {tols[key]:.3e}")
        log("kernel", f"wkv {name} B={b} H={h} K=64 chunk={chunk} f32: max_abs_err "
            + " ".join(f"{key}={err:.3e} (tol {tols[key]:.3e})" for key, err in errs.items())
            + f" ms={ms:.4f} plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.5f} "
            f"({row['bound_by']}) of_bound={row['bound_ms'] / ms:.4f} "
            f"device_ms={row['device_ms']:.4f} busy_ms={row['busy_ms']:.4f} "
            f"records={row['records']}/{20 * WKV_KERNELS} "
            f"of_bound_busy={row['bound_ms'] / row['busy_ms']:.4f} "
            f"issue_ms={row['issue_ms']:.4f}")
    return rows


def ssm_bound(b, t, d, n):
    """Least time for one selective-scan call: u and dt read once and y
    written once, plus B, C, log_a and the final state (float32), over the
    memory rate; or about seven float32 operations (the exponential counted
    as one) per (token, channel, state) over the float32 rate.  Also the
    exponentials alone at the SFU's rate, which the table has no row for."""
    nbytes = 4 * (3 * b * t * d + 2 * b * t * n + d * n + b * d * n)
    flops = 7 * b * t * d * n
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS["f32"]
    sfu_ms = b * t * d * n / SFU_EXP_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", sfu_ms
    return t_ops * 1e3, "operations", sfu_ms


def sm_clock() -> str:
    """The card's SM clock and active clock-event reasons, as ``nvidia-smi``
    reads them now (its error text where the query fails)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks_throttle_reasons.active",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return (proc.stdout.strip() or proc.stderr.strip()).splitlines()[0]


def cold_device_ms(torch, fn, calls: int, kernel: str, flush_mb: int = 256):
    """Device ms per call of the kernels named ``kernel`` (one launch per
    call) when every call finds the L2 cache cold: a ``flush_mb`` scratch
    tensor is written before each call, and only the named kernels' time is
    counted; and how many of the ``calls`` launches the profiler recorded."""
    flush = torch.empty(flush_mb * 2**18, dtype=torch.float32, device=DEVICE)

    def cold():
        flush.zero_()
        fn()

    for _ in range(2):
        cold()
    torch.cuda.synchronize()
    _, named, _, records = profile_device(torch, cold, calls, (kernel,), launches={kernel: 1})
    del flush
    return named[kernel], records[kernel]


def ssm_inputs(torch, case, gen):
    """Seeded float32 inputs of one ``SSM_CASES`` row: dt > 0 as softplus
    gives it, A = -exp(log_a) < 0; a strong-decay row draws dt |A| up to
    about 50, so the state forgets within a step."""
    name, b, t, d, chunk, strong = case
    n = 16

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    u = rand(b, t, d)
    dt = torch.exp(rand(b, t, d) * 0.5) * (3.0 if strong else 0.3)
    bt, ct = rand(b, t, n), rand(b, t, n)
    log_a = rand(d, n) * (1.0 if strong else 0.5)
    return u, dt, bt, ct, log_a


def ssm_row(torch, mod, inputs, chunk):
    """The selective-scan package ``mod`` (its ``ssm_scan`` and plain
    ``selective_scan_ref``) on ``inputs`` (u, dt, b_t, c_t, log_a): max abs
    errors of y and the final state, each beside its tolerance; the
    kernel's and the plain version's CUDA-event ms over back-to-back calls
    (``ms``, ``plain_ms``), the ``ssm_`` kernels' device ms per call under
    ``torch.profiler`` (``device_ms``: their summed time; ``busy_ms``: the
    union of their intervals), both per recorded launch, and how many of
    the 20 launches the profiler recorded (``records``), the same with the
    L2 cache flushed before every call (``cold_ms``, ``cold_records``), the
    host's ms to issue one call (``issue_ms``), the card's bound and the SM
    clock before and after the row."""
    u, dt, bt, ct, log_a = inputs
    b, t, d = u.shape
    n = bt.shape[-1]
    clock_before = sm_clock()
    y, h = mod.ssm_scan(u, dt, bt, ct, log_a, chunk=chunk)
    torch.cuda.synchronize()
    ref_y, ref_h = mod.selective_scan_ref(u, dt, log_a, bt, ct)
    pairs = (("y", y, ref_y), ("state", h, ref_h))
    errs = {key: (got - want).abs().max().item() for key, got, want in pairs}
    tols = {key: SSM_REL * max(1.0, want.abs().max().item()) for key, _, want in pairs}
    del pairs, y, h, ref_y, ref_h

    def kernel():
        return mod.ssm_scan(u, dt, bt, ct, log_a, chunk=chunk)

    bound_ms, bound_by, sfu_ms = ssm_bound(b, t, d, n)
    ms = cuda_ms(torch, kernel, 20)
    _, named, busy, records = profile_device(torch, kernel, 20, (SSM_PROFILE_PREFIX,),
                                             launches={SSM_PROFILE_PREFIX: 1}, sole=True)
    cold_ms, cold_records = cold_device_ms(torch, kernel, 20, SSM_PROFILE_PREFIX)
    return dict(
        errs=errs, tols=tols, max_abs_err=max(errs.values()), ms=ms,
        plain_ms=cuda_ms(torch, lambda: mod.selective_scan_ref(u, dt, log_a, bt, ct), 2,
                         warmup=1),
        library_ms=None, device_ms=named[SSM_PROFILE_PREFIX],
        busy_ms=busy[SSM_PROFILE_PREFIX], records=records[SSM_PROFILE_PREFIX],
        cold_ms=cold_ms, cold_records=cold_records,
        issue_ms=issue_ms(torch, kernel, 20),
        bound_ms=bound_ms, bound_by=bound_by, sfu_exp_ms=sfu_ms,
        clock_before=clock_before, clock_after=sm_clock(),
    )


def ssm_case(torch, mod, case, gen):
    """One ``SSM_CASES`` row for a selective-scan package ``mod``: see
    ``ssm_row``."""
    return ssm_row(torch, mod, ssm_inputs(torch, case, gen), case[4])


def log_ssm_row(label, row):
    errs, tols, ms = row["errs"], row["tols"], row["ms"]
    for key, err in errs.items():
        if not err <= tols[key]:
            raise AssertionError(f"ssm {label}: {key} max abs err {err:.3e} > {tols[key]:.3e}")
    log("kernel", f"ssm {label} f32: max_abs_err "
        + " ".join(f"{key}={err:.3e} (tol {tols[key]:.3e})" for key, err in errs.items())
        + f" ms={ms:.4f} plain_ms={row['plain_ms']:.4f} library_ms=none "
        f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) sfu_exp_ms={row['sfu_exp_ms']:.5f} "
        f"device_ms={row['device_ms']:.4f} busy_ms={row['busy_ms']:.4f} "
        f"of_bound_device={row['bound_ms'] / row['device_ms']:.4f} "
        f"cold_ms={row['cold_ms']:.4f} records={row['records']}/20 cold_records="
        f"{row['cold_records']}/20 issue_ms={row['issue_ms']:.4f} "
        f"clock [{row['clock_before']}] -> [{row['clock_after']}]")


def phase_kernel_ssm(torch):
    from repro_torch.kernels import ssm_scan

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    rows = {}
    for case in SSM_CASES:
        name, b, t, d, chunk, strong = case
        rows[name] = ssm_case(torch, ssm_scan, case, gen)
        log_ssm_row(f"{name}: B={b} T={t} D={d} N=16 chunk={chunk}", rows[name])
    return rows


KERNEL_NAMES = ("flash_attention", "rwkv6_wkv", "ssm_scan", "flash_attention_backward",
                "rwkv6_wkv_backward", "ssm_scan_backward")
# Each forward kernel's backward, and the forward kernels of each family's path.
BACKWARD_OF = {"flash_attention": "flash_attention_backward",
               "rwkv6_wkv": "rwkv6_wkv_backward", "ssm_scan": "ssm_scan_backward"}
PATH_KERNELS = {"dense": ("flash_attention",), "moe": ("flash_attention",),
                "ssm": ("rwkv6_wkv",), "hybrid": ("flash_attention", "ssm_scan")}


def _wrappers():
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from repro_torch.kernels.rwkv6_wkv import wkv, wkv_backward
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_backward

    return dict(zip(KERNEL_NAMES, (flash_attention, wkv, ssm_scan, flash_attention_backward,
                                   wkv_backward, ssm_scan_backward)))


def no_launches(**counts):
    """Every kernel's count at 0, but for ``counts``."""
    return {**dict.fromkeys(KERNEL_NAMES, 0), **counts}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _wrappers().items()}


def prefill_vs_stepped(torch, api, label, seed=1, s=128):
    """A dense model in float32 (seeded random weights): fused prefill of
    ``s`` tokens through the kernel, one launch per layer and nothing else,
    against the stepped decode loop (plain decode attention), logits and
    cache K/V within 1e-3."""
    cfg = api.cfg
    model = api.init(0, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (1, s), generator=gen, device=DEVICE)
    reset_launches()
    fused_logits, fused = api.prefill(model, api.init_cache(1, s, device=DEVICE), toks)
    torch.cuda.synchronize()
    counts = read_launches()
    if counts != no_launches(flash_attention=cfg.n_layers):
        raise AssertionError(f"{label} fused prefill launched {counts}, not the flash kernel "
                             f"once per layer ({cfg.n_layers})")
    stepped = api.init_cache(1, s, device=DEVICE)
    rows = []
    for p in range(s):
        lg, stepped = api.decode_step(model, stepped, toks[:, p : p + 1], p)
        rows.append(lg)
    stepped_logits = torch.cat(rows, dim=1)
    torch.cuda.synchronize()
    if not torch.isfinite(fused_logits).all():
        raise AssertionError(f"{label}: non-finite prefill logits")
    errs = {
        "logits": (fused_logits - stepped_logits).abs().max().item(),
        "k": (fused["k"] - stepped["k"]).abs().max().item(),
        "v": (fused["v"] - stepped["v"]).abs().max().item(),
    }
    log("model", f"{label} f32 ({cfg.n_layers} layers, {api.param_count()} params), prefill "
        f"{s} tokens ({counts['flash_attention']} flash launches) vs stepped decode: "
        + ", ".join(f"{k} max abs err {v:.3e}" for k, v in errs.items())
        + f"; logits scale {stepped_logits.abs().max().item():.3f}")
    for key, err in errs.items():
        if not err <= 1e-3:
            raise AssertionError(f"{label} fused vs stepped {key}: {err:.3e} > 1e-3")
    del model, fused, stepped, rows


def phase_model(torch):
    from repro_torch.configs import olmo_1b
    from repro_torch.models.registry import build_api

    cfg = dataclasses.replace(
        olmo_1b.config(), param_dtype=torch.float32, compute_dtype=torch.float32)
    prefill_vs_stepped(torch, build_api("olmo-1b", cfg), "full olmo-1b")


def recording(base):
    class Recording(base):
        """Keeps each request's token stream when it leaves a node."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.streams = {}

        def release(self, ar):
            self.streams[ar.rid] = list(ar.tokens)
            super().release(ar)

    return Recording


def serving_summary(torch, name, rep, wall, counts):
    summ = rep.summary
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("serving", f"{name} sustained_req_s={summ['sustained_req_s']:.4f} "
        f"token_throughput_s={summ['token_throughput_s']:.2f} "
        f"token_latency_s p50={summ['token_latency']['p50']:.5f} "
        f"p99={summ['token_latency']['p99']:.5f} "
        f"ttft_s p50={summ['ttft']['p50']:.5f} p99={summ['ttft']['p99']:.5f} "
        f"elapsed_s={summ['elapsed_s']:.4f} peak_mem_gb={peak_gb:.3f} wall_s={wall:.3f} "
        f"allocations={rep.allocations} refits={rep.counters['refits']} launches={counts}")


def check_streams(torch, api, model, engine, rt, wl, max_len):
    """Every stream has its length and stays inside the vocab; two requests
    served without a requeue equal a direct greedy decode."""
    from repro_torch.serving import prefill_cache

    vocab = api.cfg.vocab
    for req in wl:
        stream = engine.streams[req.rid]
        if len(stream) != req.gen_len or not all(0 <= t < vocab for t in stream):
            raise AssertionError(f"request {req.rid}: bad stream {stream}")
    undisturbed = [r for r in rt.metrics.records() if r.requeues == 0][:2]
    for rec in undisturbed:
        req = next(r for r in wl if r.rid == rec.rid)
        cache = api.init_cache(1, max_len, device=DEVICE)
        prompt = torch.as_tensor(req.prompt_tokens(vocab)[None, :], device=DEVICE)
        logits, cache = prefill_cache(api, model, cache, prompt)
        toks = [int(logits[0, -1].argmax())]
        for pos in range(req.prompt_len, req.prompt_len + req.gen_len - 1):
            last = torch.tensor([[toks[-1]]], device=DEVICE)
            logits, cache = api.decode_step(model, cache, last, pos)
            toks.append(int(logits[0, -1].argmax()))
        if toks != engine.streams[req.rid]:
            raise AssertionError(f"request {req.rid}: served stream differs from direct decode")
    return [r.rid for r in undisturbed]


def phase_serving(torch):
    from repro_torch.configs import get_api
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serving import (
        RealServingEngine, ServingAllocator, ServingConfig, ServingRuntime,
        generate_requests,
    )

    Recording = recording(RealServingEngine)
    api = get_api("olmo-1b")
    cfg = api.cfg
    model = api.init(0, device=DEVICE)
    wl = generate_requests(
        16, seed=0, rate=8.0, prompt_min=64, prompt_mean=256, prompt_max=1024,
        gen_min=8, gen_mean=32, gen_max=64,
    )
    engine = Recording(api, model, max_len=2048, device=DEVICE)

    # Warm-up outside the counted run: cuBLAS handles, the kernel's first launch.
    warm = api.init_cache(1, 2048, device=DEVICE)
    _, warm = api.prefill(model, warm, torch.zeros((1, 64), dtype=torch.long, device=DEVICE))
    api.decode_step(model, warm, torch.zeros((1, 1), dtype=torch.long, device=DEVICE), 64)
    torch.cuda.synchronize()
    del warm

    alloc = ServingAllocator({0: (0.01, 0.01), 1: (0.01, 0.01)}, total_slots=8, mode="optperf")
    rt = ServingRuntime(engine, alloc, wl, nodes=[0, 1],
                        config=ServingConfig(total_slots=8, resolve_every=1.0))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    rep = rt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    launches = counts["flash_attention"]

    summ = rep.summary
    prefills = rep.counters["admitted"]
    log("serving", f"olmo-1b bf16 full width, 2 nodes, 8 slots, max_len 2048: "
        f"completed={summ['completed']}/{summ['requests']} dropped={summ['dropped']} "
        f"requeues={summ['requeues']} prefills={prefills} kernel_launches={launches}")
    serving_summary(torch, "olmo-1b", rep, wall, counts)
    if summ["completed"] != 16 or summ["dropped"] != 0:
        raise AssertionError(f"served {summ['completed']}/16 with {summ['dropped']} dropped")
    if (launches != cfg.n_layers * prefills or counts["rwkv6_wkv"] or counts["ssm_scan"]
            or counts["flash_attention_backward"]):
        raise AssertionError(f"launches {counts} != {cfg.n_layers} x {prefills} prefills")
    rids = check_streams(torch, api, model, engine, rt, wl, 2048)
    log("serving", f"requests {rids} equal a direct greedy decode")

    # What one tick is made of: a prefill, a decode step, and the kernel's share.
    s = 256
    prompt = torch.zeros((1, s), dtype=torch.long, device=DEVICE)
    cache = api.init_cache(1, 2048, device=DEVICE)
    prefill_ms = host_ms(torch, lambda: api.prefill(model, cache, prompt), 5)
    last = torch.zeros((1, 1), dtype=torch.long, device=DEVICE)
    decode_ms = host_ms(torch, lambda: api.decode_step(model, cache, last, s), 20)
    q = torch.randn((1, s, cfg.n_heads, cfg.head_dim), device=DEVICE, dtype=cfg.compute_dtype)
    kernel_ms = cuda_ms(torch, lambda: flash_attention(q, q, q), 20)
    log("serving", f"per call: prefill({s} tokens) {prefill_ms:.3f} ms, of which the kernel "
        f"{cfg.n_layers} x {kernel_ms:.4f} ms = {cfg.n_layers * kernel_ms / prefill_ms:.1%}; "
        f"decode_step at pos {s} {decode_ms:.3f} ms")
    for name, fn, wall_ms in (("prefill", lambda: api.prefill(model, cache, prompt), prefill_ms),
                              ("decode_step", lambda: api.decode_step(model, cache, last, s),
                               decode_ms)):
        launches = {FLASH_PROFILE_NAME: cfg.n_layers} if name == "prefill" else None
        dev, named, idle, _, records = device_split(torch, fn, 3, wall_ms, (FLASH_PROFILE_NAME,),
                                                    launches)
        log("serving", f"profile olmo-1b {name}: device {dev:.3f} ms of {wall_ms:.3f} ms "
            f"(idle share {idle:.4f}), flash kernel {named[FLASH_PROFILE_NAME]:.3f} ms "
            f"(records {records[FLASH_PROFILE_NAME]}/{3 * cfg.n_layers if launches else 0})")
    return counts


def phase_model_rwkv6(torch):
    from repro_torch.configs import rwkv6_7b
    from repro_torch.models.registry import build_api

    cfg = dataclasses.replace(
        rwkv6_7b.config(), param_dtype=torch.float32, compute_dtype=torch.float32)
    api = build_api("rwkv6-7b", cfg)
    model = api.init(0, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    s = 128
    toks = torch.randint(0, cfg.vocab, (1, s), generator=gen, device=DEVICE)
    before = read_launches()["rwkv6_wkv"]
    full = api.logits(model, {"tokens": toks})
    torch.cuda.synchronize()
    launched = read_launches()["rwkv6_wkv"] - before
    if launched != cfg.n_layers:
        raise AssertionError(f"the forward launched the WKV kernel {launched} times, "
                             f"not once per layer ({cfg.n_layers})")
    cache = api.init_cache(1, s, device=DEVICE)
    rows = []
    for p in range(s):
        lg, cache = api.decode_step(model, cache, toks[:, p : p + 1], p)
        rows.append(lg)
    stepped = torch.cat(rows, dim=1)
    torch.cuda.synchronize()
    if not torch.isfinite(full).all() or full.shape != (1, s, cfg.vocab):
        raise AssertionError(f"forward logits: shape {tuple(full.shape)} or non-finite values")
    err = (full - stepped).abs().max().item()
    log("model", f"full rwkv6-7b f32 ({api.param_count()} params), forward over {s} tokens "
        f"({launched} WKV launches) vs stepped decode: logits max abs err {err:.3e} "
        f"(limit 1e-3); logits scale {stepped.abs().max().item():.3f}")
    if not err <= 1e-3:
        raise AssertionError(f"forward vs stepped logits: {err:.3e} > 1e-3")
    del model, cache, full, stepped, rows


def phase_serving_rwkv6(torch, wkv_ms):
    from repro_torch.configs import get_api
    from repro_torch.models.registry import build_api
    from repro_torch.serving import (
        RealServingEngine, ServingAllocator, ServingConfig, ServingRuntime,
        generate_requests,
    )

    api = build_api("rwkv6-7b", dataclasses.replace(get_api("rwkv6-7b").cfg,
                                                    n_layers=SSM_SERVING_LAYERS))
    cfg = api.cfg
    model = api.init(0, device=DEVICE)
    max_len = 256
    wl = generate_requests(
        8, seed=0, rate=4.0, prompt_min=16, prompt_mean=48, prompt_max=128,
        gen_min=8, gen_mean=16, gen_max=32,
    )
    engine = recording(RealServingEngine)(api, model, max_len=max_len, device=DEVICE)

    # Warm-up outside the counted run: cuBLAS handles.
    warm = api.init_cache(1, max_len, device=DEVICE)
    api.decode_step(model, warm, torch.zeros((1, 1), dtype=torch.long, device=DEVICE), 0)
    torch.cuda.synchronize()
    del warm

    alloc = ServingAllocator({0: (0.01, 0.01), 1: (0.01, 0.01)}, total_slots=4, mode="optperf")
    rt = ServingRuntime(engine, alloc, wl, nodes=[0, 1],
                        config=ServingConfig(total_slots=4, resolve_every=1.0))
    torch.cuda.reset_peak_memory_stats()
    before = read_launches()
    t0 = time.perf_counter()
    rep = rt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = read_launches()
    served = {k: after[k] - before[k] for k in after}

    summ = rep.summary
    log("serving", f"rwkv6-7b bf16 full width, 2 nodes, 4 slots, max_len {max_len}: "
        f"completed={summ['completed']}/{summ['requests']} dropped={summ['dropped']} "
        f"requeues={summ['requeues']} prefills={rep.counters['admitted']} "
        f"(prompts step the decode loop; launches in this run {served})")
    serving_summary(torch, "rwkv6-7b", rep, wall, served)
    if summ["completed"] != 8 or summ["dropped"] != 0:
        raise AssertionError(f"served {summ['completed']}/8 with {summ['dropped']} dropped")
    if any(served.values()):
        raise AssertionError(f"stepped prompt ingestion launched kernels: {served}")
    rids = check_streams(torch, api, model, engine, rt, wl, max_len)
    log("serving", f"rwkv6-7b requests {rids} equal a direct greedy decode")
    counts = read_launches()

    # What a forward and a tick are made of, and the kernel's share.
    s = 1024
    toks = torch.zeros((1, s), dtype=torch.long, device=DEVICE)
    logits_ms = host_ms(torch, lambda: api.logits(model, {"tokens": toks}), 3, warmup=1)
    cache = api.init_cache(1, max_len, device=DEVICE)
    last = torch.zeros((1, 1), dtype=torch.long, device=DEVICE)
    decode_ms = host_ms(torch, lambda: api.decode_step(model, cache, last, 0), 10)
    log("serving", f"per call: rwkv6-7b bf16 api.logits({s} tokens) {logits_ms:.3f} ms, of which "
        f"the WKV kernel {cfg.n_layers} x {wkv_ms:.4f} ms = "
        f"{cfg.n_layers * wkv_ms / logits_ms:.1%}; decode_step {decode_ms:.3f} ms")
    for name, fn, wall_ms in (("forward", lambda: api.logits(model, {"tokens": toks}), logits_ms),
                              ("decode_step", lambda: api.decode_step(model, cache, last, 0),
                               decode_ms)):
        per = WKV_KERNELS * cfg.n_layers if name == "forward" else 0
        dev, named, idle, busy, records = device_split(
            torch, fn, 3, wall_ms, (WKV_PROFILE_PREFIX,),
            {WKV_PROFILE_PREFIX: per} if per else None)
        log("serving", f"profile rwkv6-7b {name}: device {dev:.3f} ms of {wall_ms:.3f} ms "
            f"(idle share {idle:.4f}), WKV kernel (every pass) "
            f"{named[WKV_PROFILE_PREFIX]:.3f} ms, busy {busy[WKV_PROFILE_PREFIX]:.3f} ms "
            f"(records {records[WKV_PROFILE_PREFIX]}/{3 * per})")
    return counts


def phase_model_hymba(torch):
    from repro_torch.configs import hymba_1_5b
    from repro_torch.models.registry import build_api

    cfg = dataclasses.replace(
        hymba_1_5b.config(), param_dtype=torch.float32, compute_dtype=torch.float32)
    api = build_api("hymba-1.5b", cfg)
    model = api.init(0, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    s = 128  # inside the window: the reference's forward and decode agree only there
    toks = torch.randint(0, cfg.vocab, (1, s), generator=gen, device=DEVICE)
    before = read_launches()
    full = api.logits(model, {"tokens": toks})
    torch.cuda.synchronize()
    after = read_launches()
    launched = {k: after[k] - before[k] for k in after}
    want = no_launches(flash_attention=cfg.n_layers, ssm_scan=cfg.n_layers)
    if launched != want:
        raise AssertionError(f"the forward launched {launched}, not {want}")
    cache = api.init_cache(1, s, device=DEVICE)
    rows = []
    for p in range(s):
        lg, cache = api.decode_step(model, cache, toks[:, p : p + 1], p)
        rows.append(lg)
    stepped = torch.cat(rows, dim=1)
    torch.cuda.synchronize()
    if not torch.isfinite(full).all() or full.shape != (1, s, cfg.vocab):
        raise AssertionError(f"forward logits: shape {tuple(full.shape)} or non-finite values")
    err = (full - stepped).abs().max().item()
    log("model", f"full hymba-1.5b f32 ({api.param_count()} params), forward over {s} tokens "
        f"(launches {launched}) vs stepped decode: logits max abs err {err:.3e} "
        f"(limit 1e-3); logits scale {stepped.abs().max().item():.3f}")
    if not err <= 1e-3:
        raise AssertionError(f"forward vs stepped logits: {err:.3e} > 1e-3")
    del model, cache, full, stepped, rows


def phase_serving_hymba(torch, flash_ms, ssm_ms):
    from repro_torch.configs import get_api
    from repro_torch.models.registry import build_api
    from repro_torch.serving import (
        RealServingEngine, ServingAllocator, ServingConfig, ServingRuntime,
        generate_requests,
    )

    api = build_api("hymba-1.5b", dataclasses.replace(get_api("hymba-1.5b").cfg,
                                                      n_layers=SSM_SERVING_LAYERS))
    cfg = api.cfg
    model = api.init(0, device=DEVICE)
    max_len = 256
    wl = generate_requests(
        8, seed=0, rate=4.0, prompt_min=16, prompt_mean=48, prompt_max=128,
        gen_min=8, gen_mean=16, gen_max=32,
    )
    engine = recording(RealServingEngine)(api, model, max_len=max_len, device=DEVICE)

    # Warm-up outside the counted run: cuBLAS handles.
    warm = api.init_cache(1, max_len, device=DEVICE)
    api.decode_step(model, warm, torch.zeros((1, 1), dtype=torch.long, device=DEVICE), 0)
    torch.cuda.synchronize()
    del warm

    alloc = ServingAllocator({0: (0.01, 0.01), 1: (0.01, 0.01)}, total_slots=4, mode="optperf")
    rt = ServingRuntime(engine, alloc, wl, nodes=[0, 1],
                        config=ServingConfig(total_slots=4, resolve_every=1.0))
    torch.cuda.reset_peak_memory_stats()
    before = read_launches()
    t0 = time.perf_counter()
    rep = rt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = read_launches()
    served = {k: after[k] - before[k] for k in after}

    summ = rep.summary
    log("serving", f"hymba-1.5b bf16 full width, 2 nodes, 4 slots, max_len {max_len}: "
        f"completed={summ['completed']}/{summ['requests']} dropped={summ['dropped']} "
        f"requeues={summ['requeues']} prefills={rep.counters['admitted']} "
        f"(prompts step the decode loop; launches in this run {served})")
    serving_summary(torch, "hymba-1.5b", rep, wall, served)
    if summ["completed"] != 8 or summ["dropped"] != 0:
        raise AssertionError(f"served {summ['completed']}/8 with {summ['dropped']} dropped")
    if any(served.values()):
        raise AssertionError(f"stepped prompt ingestion launched kernels: {served}")
    rids = check_streams(torch, api, model, engine, rt, wl, max_len)
    log("serving", f"hymba-1.5b requests {rids} equal a direct greedy decode")
    counts = read_launches()

    # What a forward and a tick are made of, and each kernel's share.
    s = 1024
    toks = torch.zeros((1, s), dtype=torch.long, device=DEVICE)
    logits_ms = host_ms(torch, lambda: api.logits(model, {"tokens": toks}), 3, warmup=1)
    cache = api.init_cache(1, max_len, device=DEVICE)
    last = torch.zeros((1, 1), dtype=torch.long, device=DEVICE)
    decode_ms = host_ms(torch, lambda: api.decode_step(model, cache, last, 0), 10)
    n = cfg.n_layers
    log("serving", f"per call: hymba-1.5b bf16 api.logits({s} tokens) {logits_ms:.3f} ms, of "
        f"which the flash kernel {n} x {flash_ms:.4f} ms = {n * flash_ms / logits_ms:.1%} and "
        f"the selective-scan kernel {n} x {ssm_ms:.4f} ms = {n * ssm_ms / logits_ms:.1%}; "
        f"decode_step {decode_ms:.3f} ms")
    names = (FLASH_PROFILE_NAME, SSM_PROFILE_PREFIX)
    for name, fn, wall_ms in (("forward", lambda: api.logits(model, {"tokens": toks}), logits_ms),
                              ("decode_step", lambda: api.decode_step(model, cache, last, 0),
                               decode_ms)):
        launches = ({SSM_PROFILE_PREFIX: cfg.n_layers, FLASH_PROFILE_NAME: cfg.n_layers}
                    if name == "forward" else None)
        dev, named, idle, busy, records = device_split(torch, fn, 3, wall_ms, names, launches)
        want = 3 * cfg.n_layers if launches else 0
        log("serving", f"profile hymba-1.5b {name}: device {dev:.3f} ms of {wall_ms:.3f} ms "
            f"(idle share {idle:.4f}), flash kernel {named[FLASH_PROFILE_NAME]:.3f} ms, "
            f"selective-scan kernels {named[SSM_PROFILE_PREFIX]:.3f} ms, "
            f"busy {busy[SSM_PROFILE_PREFIX]:.3f} ms (records flash "
            f"{records[FLASH_PROFILE_NAME]}/{want}, scan {records[SSM_PROFILE_PREFIX]}/{want})")
    return counts


def attention_bwd_bound(b, s, h, kv, d, dtype, window, t=None, causal=True):
    """Least time for one attention backward: q (Dqk), o, dO (Dv) and the
    lse read once and dq (Dqk) written once over S, k (Dqk), v (Dv) read and
    dk (Dqk), dv (Dv) written once over T (default S), over the memory
    rate; or its five products over the valid (query, key) pairs (S, dK
    and dQ over Dqk; dP and dV over Dv) over the peak rate for the dtype."""
    t = s if t is None else t
    dqk, dv = head_dims(d)
    elem = 2 if dtype == "bf16" else 4
    nbytes = elem * b * 2 * (dqk + dv) * (s * h + t * kv) + 4 * b * h * s
    flops = 2 * (3 * dqk + 2 * dv) * b * h * attention_pairs(s, t, window, causal)
    return roofline(nbytes, flops, dtype)


def flash_bwd_case(torch, case, gen):
    """One ``BWD_CASES`` row: the backward kernel's dq, dk, dv against
    autograd through ``attention_ref`` (max abs errors, each beside its
    tolerance) and whether two calls give the same bits; the kernel's, the
    plain backward's (``attention_backward_ref``: the same inputs, the same
    formulas) and SDPA's backward's CUDA-event ms over back-to-back calls;
    the kernel's device ms per recorded call (its three kernels), SDPA's
    backward's device ms per call and the card's bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        attention_backward_ref, attention_ref, flash_attention_backward, ops)

    name, b, s, t, h, kv, dt, window, d, causal = flash_shape(case)
    dqk, dv = head_dims(d)
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    q, k, v, do = (torch.randn((b, n_rows, n, dim), generator=gen, device=DEVICE).to(dtype)
                   for n_rows, n, dim in ((s, h, dqk), (t, kv, dqk), (t, kv, dv), (s, h, dv)))
    scale = 1.0 / dqk ** 0.5
    out, lse = ops._forward(q, k, v, causal, window, scale, None, with_lse=True)

    def kernel():
        return flash_attention_backward(q, k, v, out, lse, do, causal=causal, window=window)

    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, causal=causal, window=window), leaves, do)
    errs = {key: (g.float() - w.float()).abs().max().item()
            for key, g, w in zip(("dq", "dk", "dv"), got, want)}
    tols = {key: BWD_REL[dt] * max(1.0, w.float().abs().max().item())
            for key, w in zip(("dq", "dk", "dv"), want)}
    del got, want, leaves

    qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_() for x in (q, k, v))
    mask = sdpa_window_mask(torch, s, window)
    lib_do = do.transpose(1, 2)
    lib_out = []

    def library():
        if not lib_out:  # SDPA's forward once; a refusal raises here
            lib_out.append(F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=h != kv))
        return torch.autograd.grad(lib_out[0], (qt, kt, vt), lib_do, retain_graph=True)

    bound_ms, bound_by = attention_bwd_bound(b, s, h, kv, d, dt, window, t, causal)
    ms = cuda_ms(torch, kernel, 10)
    _, named, _, records = profile_device(torch, kernel, 10, (BWD_PROFILE_NAME,),
                                          launches={BWD_PROFILE_NAME: 3}, sole=True)
    row = dict(
        errs=errs, tols=tols, max_abs_err=max(errs.values()), bitwise_repeat=bitwise, ms=ms,
        plain_ms=cuda_ms(torch, lambda: attention_backward_ref(
            q, k, v, out, lse, do, causal=causal, window=window), 2, warmup=1),
        device_ms=named[BWD_PROFILE_NAME], records=records[BWD_PROFILE_NAME],
        bound_ms=bound_ms, bound_by=bound_by,
        **library_row(torch, library, 10),
    )
    del lib_out
    return row


def phase_kernel_bwd(torch, cases=BWD_CASES):
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    rows = {}
    for case in cases:
        name, b, s, t, h, kv, dt, window, d, causal = flash_shape(case)
        row = rows[name] = flash_bwd_case(torch, case, gen)
        for key, err in row["errs"].items():
            if not err <= row["tols"][key]:
                raise AssertionError(f"flash bwd {name}: {key} max abs err {err:.3e} > "
                                     f"{row['tols'][key]:.3e}")
        if dt == "bf16" and not row["bitwise_repeat"]:
            raise AssertionError(f"flash bwd {name}: two calls gave different bits")
        log("kernel", f"flash bwd {name} B={b} H={h} KV={kv} D={d} {dt} window={window}"
            f"{cross_label(s, t, causal)}: "
            "max_abs_err " + " ".join(f"{key}={err:.3e} (tol {row['tols'][key]:.3e})"
                                      for key, err in row["errs"].items())
            + f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={fmt_ms(row['library_ms'])} "
            f"library_device_ms={fmt_ms(row['library_device_ms'])} "
            f"library_kernel={row['library_kernel']!r} bound_ms={row['bound_ms']:.5f} "
            f"({row['bound_by']}) device_ms={row['device_ms']:.4f} "
            f"records={row['records']}/30 of_bound_device={row['bound_ms'] / row['device_ms']:.4f} "
            f"bitwise_repeat={row['bitwise_repeat']}")
    return rows


def plain_seams(family, window=None):
    """The plain versions a family's ``train_forward`` takes in place of
    its kernels' entries (its ``attend`` and ``scan`` seams); ``window`` is
    the attention window of a family that attends through one."""
    import functools

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.rwkv6_wkv import wkv_chunked
    from repro_torch.kernels.ssm_scan import selective_scan_ref

    if family == "dense":
        return {"attend": functools.partial(attention_ref, causal=True)}
    if family == "moe":
        return {"attend": functools.partial(attention_ref, causal=True, window=window)}
    if family == "ssm":
        return {"scan": wkv_chunked}
    if family == "audio":
        return {"enc_attend": functools.partial(attention_ref, causal=False),
                "self_attend": functools.partial(attention_ref, causal=True),
                "cross_attend": functools.partial(attention_ref, causal=False)}
    return {"attend": attention_ref,
            "scan": lambda u, dt, b_t, c_t, log_a, chunk: selective_scan_ref(
                u, dt, log_a, b_t, c_t)}


def node_grad_check(torch, arch="olmo-1b", n_layers=None, phase="training"):
    """One node's float32 gradient at full width (b=2, S=256; ``n_layers``
    deep when given): through the kernels against the plain versions passed
    through the model's seams (``plain_seams``).  A MoE loss adds its aux
    terms, as ``ModelApi.loss`` does."""
    from repro_torch.configs import get_api
    from repro_torch.models import common
    from repro_torch.models.registry import MOE_LB_WEIGHT, MOE_Z_WEIGHT, build_api

    cfg = dataclasses.replace(
        get_api(arch).cfg, param_dtype=torch.float32, compute_dtype=torch.float32,
        **({} if n_layers is None else {"n_layers": n_layers}))
    model = build_api(arch, cfg).init(0, device=DEVICE).requires_grad_(True)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (2, 257), generator=gen, device=DEVICE)
    grads = {}
    seams = plain_seams(cfg.family, getattr(cfg, "window", None))
    for name, seam in (("kernel", {}), ("plain", seams)):
        out = model.train_forward(tokens[:, :-1], **seam)
        logits, stats = out if isinstance(out, tuple) else (out, None)
        loss, w_sum = common.weighted_cross_entropy(logits, tokens[:, 1:])
        loss = loss / w_sum
        if stats is not None:
            loss = loss + MOE_LB_WEIGHT * stats["lb_loss"] + MOE_Z_WEIGHT * stats["z_loss"]
        grads[name] = torch.autograd.grad(loss, list(model.parameters()))
        del out, logits, loss, stats
    check_grads(phase, f"full {arch} f32 node gradient (b=2, S=256, {cfg.n_layers} layers), "
                f"kernels vs plain {'/'.join(seams)}", model, grads)
    del model, grads


def check_grads(phase, label, model, grads):
    """Hold the gradients through the kernels (``grads["kernel"]``, one per
    parameter of ``model``) against the plain ones (``grads["plain"]``):
    global sq-norm within 1e-5 relative, every leaf within 1e-4 x max(1,
    max |g|); log both and raise past either limit."""
    # In chunks of 2^26 elements: a whole leaf in float64 (deepseek's
    # expert weights: 10 GB) does not fit beside two float32 gradients.
    def chunks(x):
        return x.reshape(-1).split(1 << 26)

    sq = {k: sum(float((c.double() ** 2).sum()) for g in v for c in chunks(g))
          for k, v in grads.items()}
    rel_sq = abs(sq["kernel"] - sq["plain"]) / sq["plain"]
    worst = max((max(float((a - b).abs().max()) for a, b in zip(chunks(g), chunks(w)))
                 / max(1.0, max(float(c.abs().max()) for c in chunks(w))), n)
                for (n, _), g, w in zip(model.named_parameters(), grads["kernel"],
                                        grads["plain"]))
    log(phase, f"{label}: global sq-norm {sq['kernel']:.6e} vs {sq['plain']:.6e} (rel "
        f"{rel_sq:.3e}, limit 1e-5); worst leaf {worst[1]} err {worst[0]:.3e} x max(1, max|g|) "
        "(limit 1e-4)")
    if not rel_sq <= 1e-5 or not worst[0] <= 1e-4:
        raise AssertionError(f"{label}: sq-norm rel {rel_sq:.3e}, leaf {worst}")


def node_step_profile(torch, backend, data, b, b_max, launches):
    """One node's step (its forward and backward, ``backend.node_grads``) on
    a padded (b_max, S) slice of ``data`` with b samples weighted: wall ms
    on the host clock, then device ms, idle share, and the parts and
    records of the kernels named in ``launches`` (name -> kernel records
    per step) under ``torch.profiler``, per recorded launch."""
    raw = data.batch(0, b_max)
    tok = torch.as_tensor(raw["tokens"], device=DEVICE)
    lab = torch.as_tensor(raw["labels"], device=DEVICE)
    msk = (torch.arange(b_max, device=DEVICE) < b).float()

    def step():
        return backend.node_grads(tok, lab, msk)

    wall_ms = host_ms(torch, step, 2, warmup=1)
    dev, named, idle, _, records = device_split(torch, step, 1, wall_ms, tuple(launches),
                                                launches)
    return wall_ms, dev, idle, named, records


# Profiler names of a forward kernel (one record per call: for WKV its first
# pass) and of its backward's kernels (``BWD_KERNELS_PER_CALL`` a call).
STEP_PROFILES = {
    "flash_attention": (FLASH_PROFILE_NAME, BWD_PROFILE_NAME),
    "rwkv6_wkv": ("wkv_states_kernel", WKV_BWD_PROFILE),
    "ssm_scan": ("ssm_scan_kernel", SSM_BWD_PROFILE),
}


def node_step_row(torch, backend, data, b, b_max):
    """One node step (``node_step_profile``) with each of the family's
    kernels' parts, forward and backward, per recorded launch and their
    records and launches per step (``kernels``); for olmo-1b also under
    the flash keys the training phase prints."""
    cfg = backend.api.cfg
    launches = {}
    for kernel in PATH_KERNELS[cfg.family]:
        fwd, bwd = STEP_PROFILES[kernel]
        launches[fwd] = (2 if cfg.remat else 1) * cfg.n_layers
        launches[bwd] = BWD_KERNELS_PER_CALL[bwd] * cfg.n_layers
    wall_ms, dev, idle, named, records = node_step_profile(torch, backend, data, b, b_max,
                                                           launches)
    row = dict(wall_ms=wall_ms, device_ms=dev, idle_share=idle,
               kernels={k: dict(ms=named[k], records=records[k], launches=n)
                        for k, n in launches.items()})
    if FLASH_PROFILE_NAME in launches:
        row.update(flash_fwd_ms=named[FLASH_PROFILE_NAME],
                   flash_fwd_records=records[FLASH_PROFILE_NAME],
                   flash_fwd_launches=launches[FLASH_PROFILE_NAME],
                   flash_bwd_ms=named[BWD_PROFILE_NAME],
                   flash_bwd_records=records[BWD_PROFILE_NAME],
                   flash_bwd_launches=launches[BWD_PROFILE_NAME])
    return row


TRAIN_EPOCHS = 5      # two bootstrap epochs, then three OptPerf epochs
TRAIN_STEPS = 2       # steps per epoch
LOSS_REL = 1e-4       # fused vs two-program losses (see phase_fused_training)


def training_run(torch, fused: bool):
    """Full-width olmo-1b (bf16, remat) under ``HeteroTrainer`` on the
    simulated cluster_A for ``TRAIN_EPOCHS`` epochs, through the fused
    epoch when ``fused``.  Returns the trainer, one row per epoch (plan,
    losses, noise scales, wall seconds, transfers), each staged
    (context, proposal), the launch counts of the run and its peak
    memory."""
    from repro_torch.configs import get_api
    from repro_torch.core.controller import CannikinController
    from repro_torch.core.simulator import SimulatedCluster, cluster_A
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim.optimizers import constant_schedule, sgd
    from repro_torch.train.hetero import HeteroTrainer

    api = get_api("olmo-1b")
    profiles, comm = cluster_A()
    sim = SimulatedCluster(profiles, comm, noise=0.01, seed=0)
    policy = CannikinController(sim.n, batch_candidates=[16, 32, 64], ref_batch=16,
                                device=DEVICE)
    data = SyntheticLM(vocab=api.cfg.vocab, seq_len=512, seed=0)
    trainer = HeteroTrainer(api, sgd(constant_schedule(0.01)), sim, policy, data,
                            steps_per_epoch=TRAIN_STEPS, seed=0, device=DEVICE)
    trainer.loop.fused = fused
    proposals, contexts = [], []
    stage = policy.stage_fused_proposal

    def record(ctx, proposal):
        proposals.append(proposal)
        contexts.append(ctx)
        stage(ctx, proposal)

    policy.stage_fused_proposal = record
    backend = trainer.backend
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows = []
    for _ in range(TRAIN_EPOCHS):
        before = backend.transfers.snapshot()
        staged = len(proposals)
        te = time.perf_counter()
        rec = trainer.run_epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - te
        after = backend.transfers.snapshot()
        res = trainer.loop.last_result
        plan = trainer.loop.history[-1].plan
        rows.append(dict(
            epoch=rec.epoch, phase=rec.phase, policy=plan.batch_policy, total=rec.total_batch,
            batches=list(rec.batches), lr_scale=rec.lr_scale, losses=list(res.losses),
            b_noise_host=rec.b_noise,
            b_noise_device=proposals[-1].b_noise if len(proposals) > staged else None,
            wall_s=wall, sim_s=rec.sim_seconds, anomalies=list(res.grad_anomalies),
            h2d=after["h2d"] - before["h2d"], d2h=after["d2h"] - before["d2h"],
            sq_i=[list(o.local_sqnorms) for o in res.grad_observations],
            sq_g=[o.global_sqnorm for o in res.grad_observations]))
        r = rows[-1]
        log("training", f"{'fused' if fused else 'two-program'} epoch {r['epoch']} "
            f"phase={r['phase']} policy={r['policy']} total_batch={r['total']} "
            f"batches={r['batches']} lr_scale={r['lr_scale']:.6f} "
            f"losses={[round(x, 6) for x in r['losses']]} b_noise host={r['b_noise_host']:.6e} "
            f"device={r['b_noise_device']} sim_epoch_s={r['sim_s']:.6f} "
            f"sq_i={[[f'{x:.6e}' for x in q] for q in r['sq_i']]} "
            f"sq_g={[f'{x:.6e}' for x in r['sq_g']]} anomalies={r['anomalies']} "
            f"wall_s={wall:.3f} transfers h2d={r['h2d']} d2h={r['d2h']}")
        if not all(math.isfinite(x) for x in r["losses"]) or any(r["anomalies"]):
            raise AssertionError(f"epoch {r['epoch']}: losses {r['losses']}, anomalies "
                                 f"{r['anomalies']}")
    return (trainer, rows, list(zip(contexts, proposals)), read_launches(),
            torch.cuda.max_memory_allocated())


def expected_training_launches(cfg, n, steps=TRAIN_EPOCHS * TRAIN_STEPS):
    """Kernel launches of ``steps`` unsharded training steps: per step and
    forward kernel of the family's path, each node's forward (twice per
    layer with remat) and the whole-batch loss forward; one backward per
    node and layer."""
    per_node = 2 if cfg.remat else 1  # remat runs each layer's forward again
    want = no_launches()
    for name in PATH_KERNELS[cfg.family]:
        want[name] = steps * (n * per_node * cfg.n_layers + cfg.n_layers)
        want[BACKWARD_OF[name]] = steps * n * cfg.n_layers
    return want


def phase_training(torch):
    """Full-width olmo-1b trained by HeteroTrainer on the simulated
    cluster_A, through the two-program path."""
    t0 = time.perf_counter()
    trainer, rows, _, counts, peak = training_run(torch, fused=False)
    backend, data = trainer.backend, trainer.data
    cfg, n = backend.api.cfg, trainer.cluster.n
    want = expected_training_launches(cfg, n)
    log("training", f"olmo-1b bf16 full width, cluster_A ({n} nodes), {TRAIN_EPOCHS} epochs x "
        f"{TRAIN_STEPS} steps in {time.perf_counter() - t0:.2f} s; launches {counts} (expected "
        f"{want}); peak_mem_gb={peak / 1e9:.3f}; transfers {backend.transfers.snapshot()}")
    if counts != want:
        raise AssertionError(f"training launches {counts} != {want}")
    if [r["phase"] for r in rows] != ["bootstrap"] * 2 + ["optperf"] * (TRAIN_EPOCHS - 2):
        raise AssertionError("the controller did not reach its OptPerf phase")
    if not peak < 80e9:
        raise AssertionError(f"peak device memory {peak / 1e9:.1f} GB")
    for r in rows:
        if (r["h2d"], r["d2h"]) != (4 * TRAIN_STEPS + 2, 4 * TRAIN_STEPS):
            raise AssertionError(f"two-program epoch {r['epoch']} transfers {r}")

    # Each node's step of the last plan: its forward and backward alone.
    batches = rows[-1]["batches"]
    b_max = max(8, -(-max(batches) // 8) * 8)
    for i, b in enumerate(batches):
        row = node_step_row(torch, backend, data, b, b_max)
        log("training", f"node {i} step (b={b} of padded {b_max}, S=512): wall "
            f"{row['wall_ms']:.2f} ms, device {row['device_ms']:.2f} ms (idle share "
            f"{row['idle_share']:.4f}); flash forward {row['flash_fwd_ms']:.2f} ms (records "
            f"{row['flash_fwd_records']}/{row['flash_fwd_launches']}), flash backward "
            f"{row['flash_bwd_ms']:.2f} ms (records {row['flash_bwd_records']}/"
            f"{row['flash_bwd_launches']})")
    del trainer, backend
    torch.cuda.empty_cache()
    node_grad_check(torch)
    return counts, rows


def sweep_profile(torch, ctx, b_noise):
    """The fused epoch's sweep stage (``fused_goodput_sweep``) alone on the
    card at the run's context: device ms per call (kernel time under
    ``torch.profiler`` per recorded kernel times the launches, and the
    recorded sum), its kernel records and kernel launches per call (the
    host's launch calls the profiler saw), and the host's ms to issue it
    and to finish it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.backend import fused_goodput_sweep

    dt, dev = ctx.coeffs.alphas.dtype, ctx.coeffs.alphas.device
    lo0 = torch.full((), ctx.lo0, dtype=dt, device=dev)
    b0 = torch.full((), ctx.ref_batch, dtype=dt, device=dev)
    bn = torch.full((), b_noise, dtype=torch.float32, device=dev)

    def sweep():
        return fused_goodput_sweep(ctx.coeffs, ctx.candidates, lo0, b0, bn)

    wall_ms = host_ms(torch, sweep, 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            sweep()
        torch.cuda.synchronize()
    device_us, records, launches = 0.0, 0, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            device_us += evt.self_device_time_total
            records += evt.count
        elif evt.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launches += evt.count
    if not records or not launches:
        raise RuntimeError(f"sweep profile: {records} kernel records, {launches} launches")
    per_launch = device_us / 1e3 / records
    return dict(device_ms=per_launch * launches / calls, recorded_ms=device_us / 1e3 / calls,
                records=records / calls, launches=launches / calls, wall_ms=wall_ms,
                issue_ms=issue_ms)


def phase_fused_training(torch, two_program):
    """Phase 13's run through the fused epoch (``EpochLoop(fused=True)``):
    the same plans, losses within ``LOSS_REL`` (both paths run one step
    body on the same data with the same kernels and, with b_noise infinite
    at random weights, the same lr_scale; only a kernel's summation order
    may differ, and that moves a bf16 update by far less), certified
    proposals, 12 h2d and 13 d2h per fused epoch, and the flash launches of
    phase 13."""
    from repro_torch.core.controller import FUSED_CERT_TOL

    t0 = time.perf_counter()
    trainer, rows, staged, counts, peak = training_run(torch, fused=True)
    backend, policy = trainer.backend, trainer.policy
    n = trainer.cluster.n
    want = expected_training_launches(backend.api.cfg, n)
    s = policy.stats
    log("training", f"fused: {TRAIN_EPOCHS} epochs in {time.perf_counter() - t0:.2f} s; "
        f"launches {counts} (expected {want}); peak_mem_gb={peak / 1e9:.3f}; fused_plans="
        f"{s.fused_plans} fused_certifications={s.fused_certifications} fused_cert_failures="
        f"{s.fused_cert_failures} fused_max_rel_err={s.fused_max_rel_err:.3e} (limit "
        f"{FUSED_CERT_TOL}); fused epochs built once per n: {sorted(backend._fused_cache)}")
    for _, p in staged:
        log("training", f"proposal best_index={p.best_index} total={p.total_batch} "
            f"batches={[round(x, 4) for x in p.batches]} t_stars={list(p.t_stars)} "
            f"goodputs={list(p.goodputs)} b_noise={p.b_noise} sweep_iters={p.sweep_iters}")
    worst = 0.0
    for a, b in zip(two_program, rows):
        rel = max(abs(x - y) / abs(y) for x, y in zip(b["losses"], a["losses"]))
        worst = max(worst, rel)
        log("training", f"epoch {a['epoch']}: wall s two-program {a['wall_s']:.3f} fused "
            f"{b['wall_s']:.3f} (ratio {b['wall_s'] / a['wall_s']:.4f}); loss rel diff "
            f"{rel:.3e}; lr_scale {a['lr_scale']!r} vs {b['lr_scale']!r}")
        if (a["total"], a["batches"]) != (b["total"], b["batches"]):
            raise AssertionError(f"epoch {a['epoch']}: plans differ: {a} vs {b}")
        if not abs(b["lr_scale"] - a["lr_scale"]) <= 1e-6 * abs(a["lr_scale"]):
            raise AssertionError(f"epoch {a['epoch']}: lr_scale differs: {a} vs {b}")
        if not rel <= LOSS_REL:
            raise AssertionError(f"epoch {a['epoch']}: losses differ by {rel:.3e}")
    fused_rows = rows[2:]
    adaptive = [(a["wall_s"], b["wall_s"]) for a, b in zip(two_program[2:], fused_rows)]
    log("training", f"per adaptive epoch wall s: two-program "
        f"{[round(a, 4) for a, _ in adaptive]}, fused {[round(b, 4) for _, b in adaptive]}; "
        f"worst loss rel diff {worst:.3e} (limit {LOSS_REL})")
    if [r["policy"] for r in fused_rows] != (
            ["cannikin-gns"] + ["cannikin-gns+fused"] * (TRAIN_EPOCHS - 3)):
        raise AssertionError(f"fused plans: {[r['policy'] for r in rows]}")
    for r in fused_rows:
        if (r["h2d"], r["d2h"]) != (12, 13):
            raise AssertionError(f"fused epoch {r['epoch']} transfers h2d={r['h2d']} "
                                 f"d2h={r['d2h']}, expected 12 and 13")
    if not (s.fused_plans >= 2 and s.fused_cert_failures == 0
            and s.fused_max_rel_err <= FUSED_CERT_TOL):
        raise AssertionError(f"fused certification: {s}")
    if counts != want:
        raise AssertionError(f"fused training launches {counts} != {want}")
    ctx, last = staged[-1]
    prof = sweep_profile(torch, ctx, last.b_noise)
    log("training", f"sweep (C={len(ctx.candidates_np)}, n={n}, float32): device "
        f"{prof['device_ms']:.4f} ms per call ({prof['recorded_ms']:.4f} ms in "
        f"{prof['records']:.0f} kernel records) over {prof['launches']:.0f} kernel launches; "
        f"host issue {prof['issue_ms']:.3f} ms, wall {prof['wall_ms']:.3f} ms")
    del trainer, backend
    torch.cuda.empty_cache()
    return counts, rows, [p for _, p in staged]


RUNTIME_NODES = 4       # phase 15's trace cluster
RUNTIME_STEPS = 2       # steps per job-epoch
RUNTIME_EPE = 2         # epochs after each reconciled event
RUNTIME_REL = 1e-5      # device vs host engine aggregate goodput (float32 sweep)


def runtime_config(n_layers=None):
    """Full-width olmo-1b bf16 jobs for phase 15 (``n_layers`` deep; None:
    all 16): seq 512, SGD at lr 0.01 (phase 13's rate; the reference's 0.3
    is a reduced-model rate, and a diverging bf16 loss would count as an
    anomaly beside the poison)."""
    from repro_torch.runtime import RealBackendConfig

    return RealBackendConfig(arch="olmo-1b", reduced=False, seq_len=512, lr=0.01,
                             device=DEVICE, n_layers=n_layers)


def engine_profile(torch, fn, calls: int = 1):
    """Device ms and kernel launches per call of ``fn`` under
    ``torch.profiler`` (0 and 0 for a host-only call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device_us, launches = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            device_us += evt.self_device_time_total
        elif evt.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launches += evt.count
    return device_us / 1e3 / calls, launches / calls


def runtime_engines(torch):
    """The scheduler's device engine against the host engine: the same
    allocations, aggregate goodput within ``RUNTIME_REL``, no block handed
    to the scalar oracle; wall, device ms and launches per cold
    ``allocate``."""
    from repro_torch.core.scheduler import Scheduler, allocate, random_jobs

    for n_jobs, n_nodes, seed in ((3, 12, 0), (8, 32, 1)):
        jobs = random_jobs(n_jobs, n_nodes, seed)
        allocs, rows = {}, {}
        for engine, device in (("jax", DEVICE), ("batched", None)):
            s = Scheduler(n_nodes, engine=engine, device=device)
            for job in jobs:
                allocs[engine] = s.add_job(job)
            if s.fallback_blocks:
                raise AssertionError(f"{engine}: {s.fallback_blocks} blocks fell back to the "
                                     "scalar oracle")

            def cold(engine=engine, device=device):
                return allocate(jobs, n_nodes, engine=engine, device=device)

            if cold().assignment != allocs[engine].assignment:
                raise AssertionError(f"{engine}: cold allocate differs from the Scheduler's")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                cold()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 3
            dev_ms, launches = engine_profile(torch, cold)
            rows[engine] = (wall, dev_ms, launches, s.warm_rounds, s.cold_rounds,
                            s.solved_rows, s.cached_rows)
        a, b = allocs["jax"], allocs["batched"]
        rel = abs(a.aggregate_goodput - b.aggregate_goodput) / abs(b.aggregate_goodput)
        for engine, (wall, dev_ms, launches, warm, cold_r, solved, cached) in rows.items():
            log("runtime", f"scheduler {n_jobs} jobs x {n_nodes} nodes engine={engine}: "
                f"allocate wall {wall:.3f} ms, device {dev_ms:.4f} ms over {launches:.0f} "
                f"kernel launches per call; incremental warm_rounds={warm} cold_rounds="
                f"{cold_r} solved_rows={solved} cached_rows={cached}")
        log("runtime", f"scheduler {n_jobs} jobs x {n_nodes} nodes: assignments equal="
            f"{a.assignment == b.assignment}, aggregate goodput device "
            f"{a.aggregate_goodput!r} host {b.aggregate_goodput!r} (rel {rel:.3e}, limit "
            f"{RUNTIME_REL})")
        if a.assignment != b.assignment or not rel <= RUNTIME_REL:
            raise AssertionError(f"device engine {a} != host engine {b}")


class _JobLog:
    """Every job-epoch a runtime's real backends run: the fault clock, the
    held node ids, the plan, the losses, the excluded-step counts and the
    wall seconds."""

    def __init__(self, torch):
        self.torch = torch
        self.rows = []

    def wrap(self, backend, job):
        execute = backend.execute

        def run(batches, steps, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = execute(batches, steps, **kw)
            self.torch.cuda.synchronize()
            self.rows.append(dict(
                job=job, faulted=backend.injector is not None,
                epoch=backend.injector.epoch if backend.injector is not None else None,
                nodes=tuple(backend._node_ids), batches=list(batches),
                losses=list(res.losses), anomalies=tuple(res.grad_anomalies),
                wall_s=time.perf_counter() - t0))
            return res

        backend.execute = run
        return backend


def _logged_config(job_log):
    """``runtime_config()`` whose backends log each job-epoch."""
    from repro_torch.runtime import RealBackendConfig

    class Logged(RealBackendConfig):
        def build(self, *, noise=0.0, seed=0, injector=None):
            backend = super().build(noise=noise, seed=seed, injector=injector)
            return job_log.wrap(backend, f"seed{seed}")

    return Logged(**dataclasses.asdict(runtime_config()))


def _timed_reconciles(times):
    """A ``ClusterRuntime`` whose ``step`` logs (reconcile seconds, policy
    solve seconds); the reconcile includes building and binding backends."""
    from repro_torch.runtime.runtime import ClusterRuntime

    class Timed(ClusterRuntime):
        def _apply(self, event):
            t0 = time.perf_counter()
            out = super()._apply(event)
            self._solve_s = time.perf_counter() - t0
            return out

        def step(self):
            t0 = time.perf_counter()
            rec = super().step()
            times.append((time.perf_counter() - t0, self._solve_s))
            return rec

    return Timed


def runtime_trace(torch):
    """``compare_policies`` (the CLI's ``--mode trace --backend real``
    path) on ``synthetic_trace(2, 4, seed=0)`` with full-width olmo-1b jobs,
    the ``"jax"`` engine on the card and ``FaultPlan.chaos_real``."""
    import repro_torch.runtime.trace as trace_mod
    from repro_torch.runtime import FaultPlan, compare_policies, replay, synthetic_trace

    n = RUNTIME_NODES
    trace, _ = synthetic_trace(2, n, seed=0, backend="real", total_batch=16)
    plan = FaultPlan.chaos_real(n, seed=0)
    job_log, times = _JobLog(torch), []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    plain_cls = trace_mod.ClusterRuntime
    trace_mod.ClusterRuntime = _timed_reconciles(times)
    try:
        rep = compare_policies(
            trace, n, policies=("cannikin",), engine="jax", epochs_per_event=RUNTIME_EPE,
            steps=RUNTIME_STEPS, noise=0.01, seed=0, real_backend=_logged_config(job_log),
            faults=plan, invariants=True, device=DEVICE)["cannikin"]
    finally:
        trace_mod.ClusterRuntime = plain_cls
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, peak = read_launches(), torch.cuda.max_memory_allocated()
    twin = rep.baseline
    for label, r, off in (("twin", twin, 0), ("faulted", rep, len(twin.records))):
        for k, rec in enumerate(r.records):
            rs, ss = times[off + k]
            log("runtime", f"{label} reconcile {rec.label} at t={rec.time}: allocation "
                f"{dict(rec.allocation.assignment)} aggregate goodput "
                f"{rec.aggregate_goodput!r}; reconcile {rs:.4f} s (policy solve {ss:.4f} s)")
    for row in job_log.rows:
        log("runtime", f"{'faulted' if row['faulted'] else 'twin'} {row['job']} epoch "
            f"{row['epoch']} nodes={row['nodes']} batches={row['batches']} losses="
            f"{[round(x, 6) for x in row['losses']]} excluded={row['anomalies']} wall_s="
            f"{row['wall_s']:.3f}")
    tele = rep.runtime.fault_telemetry()
    log("runtime", f"fault_telemetry {json.dumps(tele, sort_keys=True, default=str)}")
    log("runtime", f"counters faulted {rep.runtime.counters()} twin {twin.runtime.counters()}; "
        f"goodput_retention {rep.goodput_retention!r}; job epochs {rep.epochs}")

    # The poisoned node is excluded on every step of its window, whenever a
    # running job holds it, and nowhere else.
    poison = plan.poisons[0]
    window = range(poison.at_epoch, poison.at_epoch + poison.duration)
    held = 0
    for row in job_log.rows:
        if not all(math.isfinite(x) for x in row["losses"]):
            raise AssertionError(f"non-finite loss: {row}")
        for nid, count in zip(row["nodes"], row["anomalies"]):
            hit = row["faulted"] and nid == poison.node and row["epoch"] in window
            held += hit
            if count != (RUNTIME_STEPS if hit else 0):
                raise AssertionError(f"node {nid} excluded {count} steps: {row}")
    if not held:
        raise AssertionError("no running job held the poisoned node in its window")
    c, tc = rep.runtime.counters(), twin.runtime.counters()
    if (c.get("solver_timeouts"), c.get("engine_degradations")) != (1, 1):
        raise AssertionError(f"faulted run: {c}")
    if "engine_degradations" in tc or "solver_timeouts" in tc:
        raise AssertionError(f"fault-free twin degraded: {tc}")
    if twin.runtime.policy.scheduler.engine != "jax" or twin.runtime.policy.scheduler.fallback_blocks:
        raise AssertionError("the twin's device engine fell back")
    if rep.runtime.invariant_violations or tele["invariants"]["violations"]:
        raise AssertionError(f"invariant violations: {rep.runtime.invariant_violations}")
    host_trace, _ = synthetic_trace(2, n, seed=0, backend="sim", total_batch=16)
    host = replay(host_trace, n, policy="cannikin", engine="batched", seed=0)
    got = [dict(r.allocation.assignment) for r in twin.records]
    want = [dict(r.allocation.assignment) for r in host.records]
    log("runtime", f"twin allocations {got}; host engine {want}")
    if got != want:
        raise AssertionError("the twin's device-engine allocations differ from the host's")

    from repro_torch.configs import get_api

    cfg = get_api("olmo-1b").cfg
    per_node = 2 if cfg.remat else 1  # remat runs each layer's forward again
    want_counts = no_launches()
    for row in job_log.rows:  # each node's forward and backward, the loss forward
        k = len(row["batches"])
        want_counts["flash_attention"] += RUNTIME_STEPS * (k * per_node + 1) * cfg.n_layers
        want_counts["flash_attention_backward"] += RUNTIME_STEPS * k * cfg.n_layers
    log("runtime", f"trace wall {wall:.2f} s, {len(job_log.rows)} job-epochs; launches "
        f"{counts} (expected {want_counts}); peak_mem_gb={peak / 1e9:.3f}")
    if counts != want_counts:
        raise AssertionError(f"runtime launches {counts} != {want_counts}")
    if not peak < 80e9:
        raise AssertionError(f"peak device memory {peak / 1e9:.1f} GB")
    del rep, twin, host
    return counts


def _drive_full_width(torch, preempt: bool, ckpt_dir, config):
    """The reference test's ``_drive`` at full width: one real job on a
    3-node ``ClusterRuntime``, 2 x 2 epochs; with ``preempt``, preempt
    (one checkpoint generation), zero the live params and GNS state,
    resubmit, then 2 x 2 more.  Returns the handle and the seconds to
    write, verify and restore."""
    from repro_torch.core.gns import GNSState
    from repro_torch.core.perf_model import CommModel
    from repro_torch.core.scheduler import JobSpec
    from repro_torch.core.simulator import GPU_CATALOG
    from repro_torch.runtime import ClusterRuntime, JobState
    from repro_torch.train.checkpoint import verify_checkpoint

    rt = ClusterRuntime(3, policy="cannikin", seed=0, real_backend=config,
                        checkpoint_dir=ckpt_dir if preempt else None)
    spec = JobSpec(
        name="rj",
        node_models=tuple(GPU_CATALOG[n].model() for n in ("a100", "v100", "rtx6000")),
        comm=CommModel(t_o=0.04, t_u=0.008, gamma=0.15),
        total_batch=16, b_noise=500.0, ref_batch=16, backend="real")
    handle = rt.submit(spec, at=0.0)
    rt.run()
    rt.advance(epochs=2, steps=RUNTIME_STEPS)
    secs = {}
    if preempt:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.preempt(spec.name, at=1.0)
        rt.run()
        secs["write_s"] = time.perf_counter() - t0
        if handle.state != JobState.PREEMPTED or not handle.checkpoint_path:
            raise AssertionError(f"preemption wrote no checkpoint: {handle}")
        secs["bytes"] = os.path.getsize(handle.checkpoint_path)
        t0 = time.perf_counter()
        if not verify_checkpoint(handle.checkpoint_path):
            raise AssertionError("the checkpoint does not verify")
        secs["verify_s"] = time.perf_counter() - t0
        with torch.no_grad():
            for p in handle.backend.named.values():
                p.zero_()
        handle.backend.gns = GNSState()
        handle.backend.steps_done = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.submit(spec, at=2.0)
        rt.run()
        torch.cuda.synchronize()
        secs["restore_s"] = time.perf_counter() - t0
        if handle.state != JobState.RUNNING or handle.restores != 1:
            raise AssertionError(f"resume did not restore: {handle}")
    rt.advance(epochs=2, steps=RUNTIME_STEPS)
    return handle, secs


def runtime_preempt(torch):
    """Preempt and resume a job of olmo-1b at published widths,
    ``PREEMPT_LAYERS`` deep, through its checkpoint file: losses, params,
    optimizer state and GNS state bitwise equal to an unpreempted run with
    the same seed."""
    import shutil
    import tempfile

    from repro_torch.configs import get_api
    from repro_torch.models.registry import build_api

    config = runtime_config(PREEMPT_LAYERS)
    api = build_api("olmo-1b", dataclasses.replace(get_api("olmo-1b").cfg,
                                                   n_layers=PREEMPT_LAYERS))
    cfg = api.cfg
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        plain, _ = _drive_full_width(torch, False, None, config)
        n_params = sum(p.numel() for p in plain.backend.named.values())
        if (plain.backend.api.cfg.n_layers, n_params) != (PREEMPT_LAYERS, api.param_count()):
            raise AssertionError(f"the job is not cut to {PREEMPT_LAYERS} layers: "
                                 f"{plain.backend.api.cfg.n_layers} layers, {n_params} params")
        need = 2 * 4 * n_params  # params and SGD momentum, float32 on disk
        free = shutil.disk_usage(ckpt_dir).free
        log("runtime", f"checkpoint dir free {free / 1e9:.1f} GB; one generation needs about "
            f"{need / 1e9:.1f} GB ({n_params} params of {cfg.name}, {cfg.n_layers} of 16 "
            "layers)")
        if free < 1.2 * need:
            raise RuntimeError(f"{free / 1e9:.1f} GB free for a {need / 1e9:.1f} GB checkpoint")
        resumed, secs = _drive_full_width(torch, True, ckpt_dir, config)
        peak = torch.cuda.max_memory_allocated()
        same_losses = [r.mean_loss for r in plain.records] == [r.mean_loss for r in resumed.records]
        same_params = all(torch.equal(p, resumed.backend.named[k])
                          for k, p in plain.backend.named.items())
        same_mom = all(torch.equal(a, b) for a, b in zip(
            plain.backend.opt_state.momentum.values(),
            resumed.backend.opt_state.momentum.values()))
        same_gns = plain.backend.gns == resumed.backend.gns
        log("runtime", f"preempt/resume ({cfg.n_layers} layers): plans "
            f"{[r.batches for r in resumed.records]}, losses "
            f"{[r.mean_loss for r in resumed.records]}; bitwise losses={same_losses} "
            f"params={same_params} momentum={same_mom} gns={same_gns}; checkpoint "
            f"{secs['bytes']} bytes, write {secs['write_s']:.2f} s (snapshot + save), verify "
            f"{secs['verify_s']:.2f} s, restore {secs['restore_s']:.2f} s (read + verify + "
            f"load); peak_mem_gb={peak / 1e9:.3f}")
        if not (same_losses and same_params and same_mom and same_gns
                and [r.batches for r in plain.records] == [r.batches for r in resumed.records]
                and resumed.preemptions == 1 and plain.epochs_run == resumed.epochs_run == 4):
            raise AssertionError("the preempted run differs from the unpreempted one")
        if not peak < 80e9:
            raise AssertionError(f"peak device memory {peak / 1e9:.1f} GB")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def phase_runtime(torch):
    """Phase 15: the scheduler's device engine, a chaos trace of full-width
    jobs through ``compare_policies``, and a preempt/resume at published
    widths (``PREEMPT_LAYERS`` deep)."""
    t0 = time.perf_counter()
    runtime_engines(torch)
    t1 = time.perf_counter()
    counts = runtime_trace(torch)
    # The replays' runtimes and the logged backends sit in reference cycles
    # (the invariant checker holds its runtime, a wrapped ``execute`` its
    # backend): collect them before the next models are built.
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    runtime_preempt(torch)
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    log("runtime", f"phase 15 in {t3 - t0:.1f} s: engines {t1 - t0:.1f} s, trace "
        f"{t2 - t1:.1f} s, preempt/resume {t3 - t2:.1f} s")
    return counts


SHARDED_EPOCHS = 2        # phase 16's two-program comparison: both bootstrap epochs
SHARDED_FUSED_EPOCHS = 3  # two bootstrap epochs, then one fused adaptive epoch
# Sharded vs unsharded losses, bf16 on the card: the sharded step composes
# the loss from each node's forward (M = b_max * S rows per GEMM), the
# unsharded one runs a whole-batch forward (M = n * b_max * S), which cuBLAS
# may tile otherwise; bf16 logits carry 2^-8 relative rounding (the CPU,
# whose rows are independent of M, reads 1.4e-7 in bf16).
SHARDED_LOSS_REL = 1e-3
SPMD_CLI = ["--mode", "spmd", "--arch", "olmo-1b", "--full-width", "--steps", "3",
            "--seq-len", "512", "--ref-batch", "16", "--microbatches", "2", "--lr", "0.01"]
NCCL_PROFILE_NAME = "nccl"  # every NCCL kernel


def sharded_loop(torch, sharded: bool, epochs: int, *, fused: bool = False, cfg=None,
                 arch="olmo-1b"):
    """Phase 13's configuration (cluster_A, ``CannikinController(3, [16, 32,
    64], ref_batch=16)``, ``SyntheticLM(seq 512, seed 0)``, SGD at lr 0.01,
    2 steps per epoch) through ``EpochLoop`` over ``RealBackend(sharded=
    sharded)``, for ``epochs`` epochs, with ``arch`` (at ``cfg`` when
    given).  Returns the backend, the loop, the staged proposals, one row
    per epoch and the launch counts."""
    from repro_torch.configs import get_api
    from repro_torch.core.controller import CannikinController
    from repro_torch.core.simulator import SimulatedCluster, cluster_A
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.registry import build_api
    from repro_torch.optim.optimizers import constant_schedule, sgd
    from repro_torch.runtime.backend import EpochLoop, RealBackend

    api = get_api(arch) if cfg is None else build_api(arch, cfg)
    profiles, comm = cluster_A()
    sim = SimulatedCluster(profiles, comm, noise=0.01, seed=0)
    policy = CannikinController(sim.n, batch_candidates=[16, 32, 64], ref_batch=16,
                                device=DEVICE)
    backend = RealBackend(api, sgd(constant_schedule(0.01)),
                          SyntheticLM(vocab=api.cfg.vocab, seq_len=512, seed=0), cluster=sim,
                          seed=0, gns_decay=policy.gns_decay, device=DEVICE, sharded=sharded)
    loop = EpochLoop(policy, backend, steps_per_epoch=TRAIN_STEPS, fused=fused)
    proposals = []
    stage = policy.stage_fused_proposal

    def record(ctx, proposal):
        proposals.append(proposal)
        stage(ctx, proposal)

    policy.stage_fused_proposal = record
    torch.cuda.synchronize()
    reset_launches()
    rows = []
    for _ in range(epochs):
        before = backend.transfers.snapshot()
        t0 = time.perf_counter()
        rec = loop.run_epoch()
        torch.cuda.synchronize()
        res, after = loop.last_result, backend.transfers.snapshot()
        rows.append(dict(
            epoch=rec.epoch, phase=rec.phase, total=rec.total_batch, batches=list(rec.batches),
            policy=rec.plan.batch_policy, lr_scale=rec.lr_scale, losses=list(res.losses),
            sq_i=[list(o.local_sqnorms) for o in res.grad_observations],
            sq_g=[o.global_sqnorm for o in res.grad_observations],
            anomalies=list(res.grad_anomalies), wall_s=time.perf_counter() - t0,
            h2d=after["h2d"] - before["h2d"], d2h=after["d2h"] - before["d2h"]))
    return backend, loop, proposals, rows, read_launches()


def expected_sharded_launches(cfg, n, steps, sharded):
    """Flash launches per ``steps`` steps: each node's forward (twice per
    layer with remat) and, unsharded, the whole-batch loss forward; one
    backward per node and layer."""
    per_node = 2 if cfg.remat else 1
    want = no_launches()
    want["flash_attention"] = steps * (n * per_node + (0 if sharded else 1)) * cfg.n_layers
    want["flash_attention_backward"] = steps * n * cfg.n_layers
    return want


def same_replica(torch, a, b):
    """Parameters and momentum of two backends: the same bits."""
    return (all(torch.equal(p, b.named[k]) for k, p in a.named.items()),
            all(torch.equal(m, b.opt_state.momentum[k])
                for k, m in a.opt_state.momentum.items()))


def train_step_row(torch, backend, batches, sharded):
    """One whole train step of ``backend`` (every node's forward and
    backward, the guard, the aggregate, the update; sharded, its
    collectives) on a padded batch of the plan ``batches``: wall ms on the
    host clock, device ms and idle share under ``torch.profiler``, the flash
    kernels' and the NCCL kernels' device ms per step with their records."""
    from repro_torch.core.aggregation import ratios
    from repro_torch.runtime.backend import _quantize

    n, b_max = len(batches), _quantize(max(batches))
    tok, lab, msk = backend._next_padded(list(batches), b_max)
    step, place = backend._step_for(n)
    args = (place(tok), place(lab), place(msk),
            torch.as_tensor(ratios(batches), dtype=torch.float32, device=DEVICE), 1.0,
            torch.ones(n, dtype=torch.float32, device=DEVICE))
    cfg = backend.api.cfg
    want = expected_sharded_launches(cfg, n, 1, sharded)
    launches = {FLASH_PROFILE_NAME: want["flash_attention"],
                BWD_PROFILE_NAME: 3 * want["flash_attention_backward"]}

    def run():
        return step(*args)

    wall_ms = host_ms(torch, run, 2, warmup=1)
    dev, named, idle, _, records = device_split(
        torch, run, 1, wall_ms, (FLASH_PROFILE_NAME, BWD_PROFILE_NAME, NCCL_PROFILE_NAME),
        launches)
    return dict(wall_ms=wall_ms, device_ms=dev, idle_share=idle, named=named, records=records,
                launches=launches, collectives=len(backend.named) + 1 if sharded else 0)


def sharded_vs_unsharded(torch, adaptive_batches):
    """Part 1: the two-program path, sharded over a NCCL world of one
    against unsharded, on the same plans and seeds: the same parameter,
    momentum, |g_i|^2 and |g|^2 bits, losses within ``SHARDED_LOSS_REL``,
    96 flash forwards per step against 112; then one whole step of each
    at the adaptive plan ``adaptive_batches`` under the profiler."""
    plain, _, _, plain_rows, plain_counts = sharded_loop(torch, False, SHARDED_EPOCHS)
    sharded, _, _, rows, counts = sharded_loop(torch, True, SHARDED_EPOCHS)
    cfg, n, mesh = sharded.api.cfg, len(rows[0]["batches"]), sharded._mesh
    steps = SHARDED_EPOCHS * TRAIN_STEPS
    same_params, same_mom = same_replica(torch, plain, sharded)
    worst = 0.0
    for a, b in zip(plain_rows, rows):
        rel = max(abs(x - y) / abs(x) for x, y in zip(a["losses"], b["losses"]))
        worst = max(worst, rel)
        log("sharded", f"epoch {b['epoch']} batches={b['batches']} losses sharded "
            f"{b['losses']} unsharded {a['losses']} (rel {rel:.3e}); sq_i same bits="
            f"{a['sq_i'] == b['sq_i']} sq_g same bits={a['sq_g'] == b['sq_g']}; wall s sharded "
            f"{b['wall_s']:.3f} unsharded {a['wall_s']:.3f}; transfers h2d={b['h2d']} "
            f"d2h={b['d2h']}")
        if (a["total"], a["batches"]) != (b["total"], b["batches"]):
            raise AssertionError(f"epoch {a['epoch']}: plans differ: {a} vs {b}")
        if a["sq_i"] != b["sq_i"] or a["sq_g"] != b["sq_g"] or any(b["anomalies"]):
            raise AssertionError(f"epoch {a['epoch']}: gradient telemetry differs: {a} vs {b}")
        if (a["h2d"], a["d2h"]) != (b["h2d"], b["d2h"]):
            raise AssertionError(f"epoch {a['epoch']}: transfers differ: {a} vs {b}")
    want = expected_sharded_launches(cfg, n, steps, True)
    want_plain = expected_sharded_launches(cfg, n, steps, False)
    log("sharded", f"NCCL world of one: mesh shards={mesh.shards} world={mesh.world} group="
        f"{type(mesh.group).__name__}; params same bits={same_params} momentum same bits="
        f"{same_mom}; worst loss rel {worst:.3e} (limit {SHARDED_LOSS_REL}); launches sharded "
        f"{counts} (expected {want}), unsharded {plain_counts} (expected {want_plain}); per "
        f"step {counts['flash_attention'] // steps} vs {plain_counts['flash_attention'] // steps}"
        " flash forwards")
    if not (same_params and same_mom):
        raise AssertionError("the sharded step's replica differs from the unsharded one's")
    if not worst <= SHARDED_LOSS_REL:
        raise AssertionError(f"sharded losses differ by {worst:.3e}")
    if counts != want or plain_counts != want_plain:
        raise AssertionError(f"launches: sharded {counts}, unsharded {plain_counts}")
    for name, backend, sh in (("unsharded", plain, False), ("sharded", sharded, True)):
        row = train_step_row(torch, backend, adaptive_batches, sh)
        log("sharded", f"{name} train step (batches {adaptive_batches}, S=512): wall "
            f"{row['wall_ms']:.2f} ms, device {row['device_ms']:.2f} ms (idle share "
            f"{row['idle_share']:.4f}); flash forward {row['named'][FLASH_PROFILE_NAME]:.2f} ms "
            f"(records {row['records'][FLASH_PROFILE_NAME]}/{row['launches'][FLASH_PROFILE_NAME]})"
            f", flash backward {row['named'][BWD_PROFILE_NAME]:.2f} ms (records "
            f"{row['records'][BWD_PROFILE_NAME]}/{row['launches'][BWD_PROFILE_NAME]}); NCCL "
            f"kernels {row['named'][NCCL_PROFILE_NAME]:.4f} ms in "
            f"{row['records'][NCCL_PROFILE_NAME]} records over {row['collectives']} all-reduces")
    del plain, sharded
    gc.collect()
    torch.cuda.empty_cache()
    return want


def sharded_fused(torch, fused_rows, fused_proposals):
    """Part 2: one adaptive epoch through ``EpochLoop(fused=True)`` on the
    sharded backend (the fused epoch runs under
    ``set_sync_debug_mode("error")``): plans equal phase 14's, the proposal
    phase 14's first, certified within ``FUSED_CERT_TOL``."""
    from repro_torch.core.controller import FUSED_CERT_TOL

    backend, loop, proposals, rows, counts = sharded_loop(
        torch, True, SHARDED_FUSED_EPOCHS, fused=True)
    s = loop.policy.stats
    want = expected_sharded_launches(backend.api.cfg, len(rows[0]["batches"]),
                                     SHARDED_FUSED_EPOCHS * TRAIN_STEPS, True)
    for a, b in zip(fused_rows, rows):
        log("sharded", f"fused run epoch {b['epoch']} policy={b['policy']} total={b['total']} "
            f"batches={b['batches']} (phase 14: {a['total']} {a['batches']}) losses "
            f"{b['losses']} wall_s={b['wall_s']:.3f} transfers h2d={b['h2d']} d2h={b['d2h']}")
        if (a["total"], a["batches"], a["policy"]) != (b["total"], b["batches"], b["policy"]):
            raise AssertionError(f"epoch {a['epoch']}: plans differ from phase 14's")
    p, q = proposals[0], fused_proposals[0]
    log("sharded", f"fused: proposal best_index={p.best_index} total={p.total_batch} batches="
        f"{[round(float(x), 4) for x in p.batches]} (phase 14: {q.best_index} {q.total_batch}); "
        f"fused_plans={s.fused_plans} fused_certifications={s.fused_certifications} "
        f"fused_cert_failures={s.fused_cert_failures} fused_max_rel_err="
        f"{s.fused_max_rel_err:.3e} (limit {FUSED_CERT_TOL}); launches {counts} (expected "
        f"{want}); fused epochs built for {sorted(backend._fused_cache)}")
    if [r["policy"] for r in rows] != [None, None, "cannikin-gns"]:
        raise AssertionError(f"fused policies {[r['policy'] for r in rows]}")
    if (rows[-1]["h2d"], rows[-1]["d2h"]) != (12, 13):
        raise AssertionError(f"fused epoch transfers {rows[-1]}")
    if (p.best_index, p.total_batch) != (q.best_index, q.total_batch) or not (
            max(abs(x - y) for x, y in zip(p.batches, q.batches)) <= 1e-5 * q.total_batch):
        raise AssertionError(f"proposal {p} differs from phase 14's {q}")
    if not (s.fused_certifications >= 1 and s.fused_cert_failures == 0
            and s.fused_max_rel_err <= FUSED_CERT_TOL):
        raise AssertionError(f"fused certification: {s}")
    if counts != want or sorted(backend._fused_cache) != [(len(rows[0]["batches"]), 1)]:
        raise AssertionError(f"fused launches {counts} or cache {sorted(backend._fused_cache)}")
    del backend, loop
    gc.collect()
    torch.cuda.empty_cache()


def spmd_cli(torch, argv=SPMD_CLI, phase="sharded"):
    """Part 3: ``python -m repro_torch.launch.train --mode spmd --full-width``
    (``argv``) on the card, as a user runs it: exit 0 and three finite
    losses."""
    import re

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"] + argv,
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    lines = [re.match(r"step +(\d+) loss=(\S+) \((\d+)ms\)", x) for x in proc.stdout.splitlines()]
    losses = [float(m.group(2)) for m in lines if m]
    step_ms = [int(m.group(3)) for m in lines if m]
    log(phase, f"CLI {' '.join(argv)}: exit {proc.returncode} in {secs:.1f} s, losses "
        f"{losses}, per-step ms {step_ms}")
    if proc.returncode != 0 or len(losses) != 3 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"--mode spmd failed: {proc.stdout[-2000:]} {proc.stderr[-4000:]}")


def sharded_rank(rank, world, init_file, out_path):
    """One rank of part 4's NCCL world: phase 13's configuration in float32
    (so that the reference's tolerances mean something: bf16 parameters
    would move by whole bf16 steps where the float32 sums differ in the last
    bit), sharded over the world's ranks; rank 0 first runs the unsharded
    twin and compares."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import olmo_1b

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(olmo_1b.config(), param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    result = None
    if rank == 0:
        plain, _, _, plain_rows, _ = sharded_loop(torch, False, SHARDED_EPOCHS, cfg=cfg)
        want_params = {k: v.detach().cpu() for k, v in plain.named.items()}
        del plain
        torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        backend, _, _, rows, counts = sharded_loop(torch, True, SHARDED_EPOCHS, cfg=cfg)
        if rank == 0:
            loss_rel = max(abs(x - y) / abs(y) for a, b in zip(rows, plain_rows)
                           for x, y in zip(b["losses"], a["losses"]))
            param_excess = max(float(((v.detach().cpu() - want_params[k]).abs()
                                      - (1e-6 + 1e-5 * want_params[k].abs())).max())
                               for k, v in backend.named.items())
            sq_rel = max(abs(x - y) / abs(y) for a, b in zip(rows, plain_rows)
                         for x, y in zip(sum(b["sq_i"], []) + b["sq_g"],
                                         sum(a["sq_i"], []) + a["sq_g"]))
            result = dict(loss_rel=loss_rel, param_excess=param_excess, sq_rel=sq_rel,
                          plans_equal=[r["batches"] for r in rows] == [
                              r["batches"] for r in plain_rows],
                          mesh=(backend._mesh.shards, backend._mesh.world), counts=counts,
                          walls=[r["wall_s"] for r in rows],
                          plain_walls=[r["wall_s"] for r in plain_rows])
            with open(out_path, "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


def split_node_axis(torch):
    """Part 4: where the machine has 2 cards or more, phase 13's
    configuration (float32) over a NCCL world of ``node_shard_count(3,
    cards)`` processes against the unsharded step, with the reference's
    tolerances: losses rtol 1e-6, parameters rtol 1e-5 / atol 1e-6."""
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import node_shard_count

    cards = torch.cuda.device_count()
    if cards < 2:
        log("sharded", f"split node axis: not run on this machine ({cards} card; NCCL takes one "
            "rank per card)")
        return
    world = node_shard_count(3, cards)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        t0 = time.perf_counter()
        mp.spawn(sharded_rank, args=(world, os.path.join(tmp, "store"), out_path),
                 nprocs=world, join=True)
        with open(out_path) as f:
            res = json.load(f)
    log("sharded", f"split node axis over {world} cards (NCCL, float32): mesh {res['mesh']}, "
        f"plans equal={res['plans_equal']}, loss rel {res['loss_rel']:.3e} (limit 1e-6), "
        f"params excess over rtol 1e-5 / atol 1e-6 {res['param_excess']:.3e} (limit 0), "
        f"sq-norm rel {res['sq_rel']:.3e}; launches {res['counts']}; epoch wall s sharded "
        f"{[round(x, 3) for x in res['walls']]} unsharded "
        f"{[round(x, 3) for x in res['plain_walls']]}; {time.perf_counter() - t0:.1f} s")
    if not (res["plans_equal"] and res["mesh"] == [world, world] and res["loss_rel"] <= 1e-6
            and res["param_excess"] <= 0.0):
        raise AssertionError(f"split node axis: {res}")


def phase_sharded(torch, fused_rows=None, fused_proposals=None):
    """Phase 16: the node-sharded step (see the module docstring), held
    against phase 14's unsharded fused run (run here for
    ``SHARDED_FUSED_EPOCHS`` epochs when not given); at its end the world
    of one's NCCL group is shut down."""
    from repro_torch.launch.mesh import release_world_of_one

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if fused_rows is None:
        backend, _, fused_proposals, fused_rows, _ = sharded_loop(
            torch, False, SHARDED_FUSED_EPOCHS, fused=True)
        del backend
        gc.collect()
        torch.cuda.empty_cache()
    fused_rows = fused_rows[:SHARDED_FUSED_EPOCHS]
    sharded_vs_unsharded(torch, fused_rows[-1]["batches"])
    t1 = time.perf_counter()
    sharded_fused(torch, fused_rows, fused_proposals)
    peak = torch.cuda.max_memory_allocated()
    t2 = time.perf_counter()
    spmd_cli(torch)
    t3 = time.perf_counter()
    split_node_axis(torch)
    t4 = time.perf_counter()
    # The sharded backends are gone: shut their world-of-one NCCL group down.
    gc.collect()
    released = release_world_of_one()
    log("sharded", f"phase 16 in {t4 - t0:.1f} s: two-program {t1 - t0:.1f} s, fused "
        f"{t2 - t1:.1f} s, CLI {t3 - t2:.1f} s, split node axis {t4 - t3:.1f} s; "
        f"peak_mem_gb={peak / 1e9:.3f} (two-program and fused parts); released {released} "
        "world-of-one group(s)")
    if not peak < 80e9:
        raise AssertionError(f"peak device memory {peak / 1e9:.1f} GB")


def event_timed(torch, fn):
    """(fn(), its CUDA-event milliseconds) for one call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


WKV_BWD_CHUNK = 32  # the backward kernel's chunk (kChunk in wkv_backward.cu)


def wkv_bwd_bound(b, t, h, k, with_ds):
    """Least time for one WKV backward: r, k, v, log_w and dout read once,
    dr, dk, dv and dlog_w written once, plus u, du, the final state and its
    gradient (float32), over the memory rate; or the chunked form's 5 K^2 +
    6 C K multiply-adds per token and head over the dense TF32 rate, the
    least operations of the forms the kernels run.  Also returns the
    recurrence form's bound (12 K^2 operations per token and head over the
    float32 rate off the tensor cores), the first backward's."""
    nbytes = 4 * (9 * b * t * h * k + 2 * h * k + (2 if with_ds else 1) * b * h * k * k)
    flops = 2 * (5 * k * k + 6 * WKV_BWD_CHUNK * k) * b * t * h
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS["tf32"]
    recurrence_ms = 12 * k * k * b * t * h / PEAK_FLOPS["f32"] * 1e3
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", recurrence_ms
    return t_ops * 1e3, "operations", recurrence_ms


def ssm_bwd_bound(b, t, d, n, with_dh):
    """Least time for one selective-scan backward: u, dt and dy read once,
    du and ddt written once, B, C, dB, dC, log_a, dlog_a and the final
    state's gradient (float32), over the memory rate; or about 16 operations
    per (token, channel, state) (the state recomputed, the carried gradient,
    four products, the decay) over the float32 rate."""
    nbytes = 4 * (5 * b * t * d + 4 * b * t * n + 2 * d * n + (b * d * n if with_dh else 0))
    flops = 16 * b * t * d * n
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS["f32"]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", None
    return t_ops * 1e3, "operations", None


def bwd_row(torch, kernel, plain, keys, profile, bound):
    """A backward kernel's row: max abs error of each output against the
    plain backward on the same inputs, each beside its tolerance
    (``KERNEL_BWD_REL`` x max(1, max |plain|)), whether two calls give the
    same bits, the kernel's CUDA-event ms over back-to-back calls, the plain
    backward's for one call, the kernel's device ms per recorded call under
    ``torch.profiler`` with its records, and the bound."""
    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want, plain_ms = event_timed(torch, plain)
    errs = {key: (g - w).abs().max().item() for key, g, w in zip(keys, got, want)}
    tols = {key: KERNEL_BWD_REL * max(1.0, w.abs().max().item()) for key, w in zip(keys, want)}
    del got, want
    ms = cuda_ms(torch, kernel, 5, warmup=1)
    _, named, _, records = profile_device(torch, kernel, 5, (profile,),
                                          launches={profile: BWD_KERNELS_PER_CALL[profile]},
                                          sole=True)
    bound_ms, bound_by, recurrence_ms = bound
    return dict(errs=errs, tols=tols, max_abs_err=max(errs.values()), bitwise_repeat=bitwise,
                ms=ms, plain_ms=plain_ms, library_ms=None, device_ms=named[profile],
                records=records[profile], bound_ms=bound_ms, bound_by=bound_by,
                recurrence_bound_ms=recurrence_ms)


def wkv_bwd_case(torch, case, gen):
    """One ``WKV_BWD_CASES`` row (see ``bwd_row``): the forward kernel gives
    the final state; a strong-decay row draws every log-decay in [-4.6,
    -3.45], inside the clamp, so each carries a gradient."""
    from repro_torch.kernels import rwkv6_wkv as mod

    name, b, t, h, chunk, strong, with_ds = case
    k = 64

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * scale

    r, kk, v = (rand((b, t, h, k), 0.5) for _ in range(3))
    if strong:
        lw = mod.LOG_DECAY_MIN * (1.0 - 0.25 * torch.rand((b, t, h, k), generator=gen,
                                                          device=DEVICE))
    else:
        lw = -torch.exp(rand((b, t, h, k)))
    u = rand((h, k), 0.2)
    dout = rand((b, t, h, k))
    ds = rand((b, h, k, k)) if with_ds else None
    _, state = mod.wkv(r, kk, v, lw, u, chunk=chunk)
    return bwd_row(
        torch, lambda: mod.wkv_backward(r, kk, v, lw, u, state, dout, ds, chunk=chunk),
        lambda: mod.wkv_backward_ref(r, kk, v, lw, u, dout, ds),
        ("dr", "dk", "dv", "dlog_w", "du"), WKV_BWD_PROFILE, wkv_bwd_bound(b, t, h, k, with_ds))


def ssm_bwd_case(torch, case, gen):
    """One ``SSM_BWD_CASES`` row (see ``bwd_row``) on ``ssm_inputs``, B and
    C read as views of one (B, T, 2N) tensor, as the model passes them: the
    backward from the forward's tile states, as the training path runs it
    (a checkout before the second design has none)."""
    from repro_torch.kernels import ssm_scan as mod

    name, b, t, d, chunk, strong, with_dh = case
    n = 16
    u, dt, _, _, log_a = ssm_inputs(torch, (name, b, t, d, chunk, strong), gen)
    bc = torch.randn((b, t, 2 * n), generator=gen, device=DEVICE)
    bt, ct = bc[..., :n], bc[..., n:]
    dy = torch.randn((b, t, d), generator=gen, device=DEVICE)
    dh = torch.randn((b, d, n), generator=gen, device=DEVICE) if with_dh else None
    kw = {}
    if hasattr(mod, "ssm_scan_tile_states"):
        kw["tiles"] = mod.ssm_scan_tile_states(u, dt, bt, ct, log_a, chunk=chunk)[2]
    return bwd_row(
        torch, lambda: mod.ssm_scan_backward(u, dt, bt, ct, log_a, dy, dh, chunk=chunk, **kw),
        lambda: mod.ssm_scan_backward_ref(u, dt, bt, ct, log_a, dy, dh),
        ("du", "ddt", "db", "dc", "dlog_a"), SSM_BWD_PROFILE, ssm_bwd_bound(b, t, d, n, with_dh))


def phase_kernel_backwards(torch):
    """Phase 17: each backward kernel against its plain backward."""
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    rows = {}
    for label, cases, case_fn, profile in (
            ("wkv", WKV_BWD_CASES, wkv_bwd_case, WKV_BWD_PROFILE),
            ("ssm", SSM_BWD_CASES, ssm_bwd_case, SSM_BWD_PROFILE)):
        for case in cases:
            name, b, t, width, chunk, strong, with_grad = case
            row = rows[(label, name)] = case_fn(torch, case, gen)
            for key, err in row["errs"].items():
                if not err <= row["tols"][key]:
                    raise AssertionError(f"{label} bwd {name}: {key} max abs err {err:.3e} > "
                                         f"{row['tols'][key]:.3e}")
            if not row["bitwise_repeat"]:
                raise AssertionError(f"{label} bwd {name}: two calls gave different bits")
            log("kernel", f"{label} bwd {name}: B={b} T={t} {'H' if label == 'wkv' else 'D'}="
                f"{width} chunk={chunk} final-state grad={with_grad} f32: max_abs_err "
                + " ".join(f"{key}={err:.3e} (tol {row['tols'][key]:.3e})"
                           for key, err in row["errs"].items())
                + f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} library_ms=none "
                f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}"
                + (f"; recurrence form {row['recurrence_bound_ms']:.5f}"
                   if row["recurrence_bound_ms"] else "")
                + f") device_ms={row['device_ms']:.4f} records={row['records']}/"
                f"{5 * BWD_KERNELS_PER_CALL[profile]} of_bound_device="
                f"{row['bound_ms'] / row['device_ms']:.4f} bitwise_repeat={row['bitwise_repeat']}")
    return rows


# Layers of hymba-1.5b's float32 node-gradient check.  At all 32 layers the
# float32 gradient of the function is itself fixed only to about 4.5e-5
# (|dg| / |g| between the plain path and the same path with SDPA's math
# attention, or with attention and scan in float64, on an H100), and the
# global sq-norm of two right float32 implementations differs by 2e-6 to
# 1.8e-5, over the 1e-5 limit; at 16 layers it is 2e-6 (PERF.md section 6).
HYMBA_GRAD_LAYERS = 16
# name, arch, n_layers (None: all), the node-gradient check's layers, the
# CLI's arguments (None: it does not fit)
SSM_TRAINING = {
    "rwkv6": ("rwkv6-7b", RWKV6_TRAIN_LAYERS, RWKV6_TRAIN_LAYERS, None),
    "hymba": ("hymba-1.5b", HYMBA_TRAIN_LAYERS, HYMBA_GRAD_LAYERS,
              ["--mode", "spmd", "--arch", "hymba-1.5b", "--full-width", "--steps", "3",
               "--seq-len", "512", "--ref-batch", "16", "--microbatches", "2", "--lr", "0.01"]),
}


def phase_train_ssm(torch, which):
    """Phases 18 and 19: rwkv6-7b (depth cut to ``RWKV6_TRAIN_LAYERS``) or
    hymba-1.5b (to ``HYMBA_TRAIN_LAYERS``) in bf16 at published widths on
    phase 13's recipe through ``EpochLoop``
    (``sharded_loop``, unsharded): five epochs on the two-program path, then
    three on the fused path (two bootstrap, one fused adaptive epoch, its
    proposal certified); every loss finite, no node excluded, launches as the
    path predicts, peak memory under 80 GB; each node step of the last plan;
    one node's float32 gradient through the kernels against the plain
    versions (at the check's depth in ``SSM_TRAINING``); the CLI where it
    fits."""
    from repro_torch.configs import get_api
    from repro_torch.core.controller import FUSED_CERT_TOL

    label = f"training ({which})"
    arch, n_layers, grad_layers, cli = SSM_TRAINING[which]
    cfg = get_api(arch).cfg
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    fwd = PATH_KERNELS[cfg.family]
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend, loop, _, rows, counts = sharded_loop(torch, False, TRAIN_EPOCHS, cfg=cfg, arch=arch)
    peak = torch.cuda.max_memory_allocated()
    n = len(rows[0]["batches"])
    want = expected_training_launches(cfg, n)
    for r in rows:
        log(label, f"two-program epoch {r['epoch']} phase={r['phase']} total_batch={r['total']} "
            f"batches={r['batches']} losses={[round(x, 6) for x in r['losses']]} "
            f"anomalies={r['anomalies']} wall_s={r['wall_s']:.3f} transfers h2d={r['h2d']} "
            f"d2h={r['d2h']}")
        if not all(math.isfinite(x) for x in r["losses"]) or any(r["anomalies"]):
            raise AssertionError(f"{arch} epoch {r['epoch']}: {r}")
    log(label, f"{arch} bf16 ({cfg.n_layers} layers, published widths), cluster_A ({n} nodes), "
        f"{TRAIN_EPOCHS} epochs x {TRAIN_STEPS} steps in {time.perf_counter() - t0:.2f} s; "
        f"launches {counts} (expected {want}); peak_mem_gb={peak / 1e9:.3f}")
    if counts != want:
        raise AssertionError(f"{arch} training launches {counts} != {want}")
    if [r["phase"] for r in rows] != ["bootstrap"] * 2 + ["optperf"] * (TRAIN_EPOCHS - 2):
        raise AssertionError("the controller did not reach its OptPerf phase")
    if not peak < 80e9:
        raise AssertionError(f"peak device memory {peak / 1e9:.1f} GB")

    # Each node's step of the last plan: its forward and backward alone.
    per_node = 2 if cfg.remat else 1
    profile = {STEP_PROFILES[k][1]: BWD_KERNELS_PER_CALL[STEP_PROFILES[k][1]] * cfg.n_layers
               for k in fwd}
    batches = rows[-1]["batches"]
    b_max = max(8, -(-max(batches) // 8) * 8)
    for i, b in enumerate(batches):
        wall_ms, dev, idle, named, records = node_step_profile(
            torch, backend, backend.data, b, b_max, profile)
        log(label, f"node {i} step (b={b} of padded {b_max}, S=512): wall {wall_ms:.2f} ms, "
            f"device {dev:.2f} ms (idle share {idle:.4f}); backward kernels "
            + ", ".join(f"{k}* {named[k]:.3f} ms (records {records[k]}/{profile[k]})"
                        for k in profile)
            + f"; forward launches per step {per_node * cfg.n_layers} of each of {list(fwd)}")
    del backend, loop
    gc.collect()
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    backend, loop, proposals, frows, fcounts = sharded_loop(
        torch, False, SHARDED_FUSED_EPOCHS, fused=True, cfg=cfg, arch=arch)
    s = loop.policy.stats
    fwant = expected_training_launches(cfg, n, SHARDED_FUSED_EPOCHS * TRAIN_STEPS)
    worst = 0.0
    for a, b in zip(rows, frows):
        rel = max(abs(x - y) / abs(y) for x, y in zip(b["losses"], a["losses"]))
        worst = max(worst, rel)
        log(label, f"fused epoch {b['epoch']} policy={b['policy']} total_batch={b['total']} "
            f"batches={b['batches']} losses={[round(x, 6) for x in b['losses']]} (loss rel diff "
            f"{rel:.3e}) wall_s={b['wall_s']:.3f} (two-program {a['wall_s']:.3f}) transfers "
            f"h2d={b['h2d']} d2h={b['d2h']}")
        if (a["total"], a["batches"]) != (b["total"], b["batches"]) or not rel <= LOSS_REL:
            raise AssertionError(f"epoch {a['epoch']}: fused {b} vs two-program {a}")
    p = proposals[0]
    log(label, f"fused: {SHARDED_FUSED_EPOCHS} epochs in {time.perf_counter() - t1:.2f} s; "
        f"proposal best_index={p.best_index} total={p.total_batch} fused_plans={s.fused_plans} "
        f"fused_certifications={s.fused_certifications} fused_cert_failures="
        f"{s.fused_cert_failures} fused_max_rel_err={s.fused_max_rel_err:.3e} (limit "
        f"{FUSED_CERT_TOL}); launches {fcounts} (expected {fwant})")
    if [r["policy"] for r in frows] != [None, None, "cannikin-gns"]:
        raise AssertionError(f"fused policies {[r['policy'] for r in frows]}")
    if (frows[-1]["h2d"], frows[-1]["d2h"]) != (12, 13):
        raise AssertionError(f"fused epoch transfers {frows[-1]}")
    if not (s.fused_certifications >= 1 and s.fused_cert_failures == 0
            and s.fused_max_rel_err <= FUSED_CERT_TOL):
        raise AssertionError(f"fused certification: {s}")
    if fcounts != fwant:
        raise AssertionError(f"fused launches {fcounts} != {fwant}")
    peak = max(peak, torch.cuda.max_memory_allocated())
    del backend, loop
    gc.collect()
    torch.cuda.empty_cache()

    t2 = time.perf_counter()
    node_grad_check(torch, arch, grad_layers, phase=label)
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    if cli is None:
        log(label, f"CLI --mode spmd --arch {arch} --full-width: not run, it does not fit one "
            "80 GB card: AdamW's two float32 moments of its 7.53 B parameters alone are 60 GB")
    else:
        spmd_cli(torch, cli, phase=label)
    log(label, f"phase in {time.perf_counter() - t0:.1f} s: two-program {t1 - t0:.1f} s, fused "
        f"{t2 - t1:.1f} s, node gradient {t3 - t2:.1f} s, CLI {time.perf_counter() - t3:.1f} s; "
        f"peak_mem_gb={peak / 1e9:.3f} (the two training runs)")
    return counts


def phase_model_dense_configs(torch):
    """Phase 20: the config-only dense ports in float32 at published
    widths (depths in ``DENSE_MODEL_LAYERS``), as phase 5."""
    from repro_torch.configs import get_api
    from repro_torch.models.registry import build_api

    for seed, (arch, n_layers) in enumerate(DENSE_MODEL_LAYERS.items(), start=11):
        cfg = dataclasses.replace(
            get_api(arch).cfg, param_dtype=torch.float32, compute_dtype=torch.float32,
            **({} if n_layers is None else {"n_layers": n_layers}))
        cut = "full depth" if n_layers is None else f"depth cut to {n_layers}"
        prefill_vs_stepped(torch, build_api(arch, cfg), f"{arch} ({cut})", seed=seed)
        gc.collect()
        torch.cuda.empty_cache()


def mixtral_cfg(torch, n_layers, dtype=None, **overrides):
    """mixtral-8x7b at published widths, ``n_layers`` deep, in ``dtype``
    (default the published bf16)."""
    from repro_torch.configs import mixtral_8x7b

    cfg = dataclasses.replace(mixtral_8x7b.config(), n_layers=n_layers, **overrides)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    return cfg


def phase_model_mixtral(torch):
    """Phase 21: mixtral-8x7b in float32, ``MIXTRAL_MODEL_LAYERS`` deep, 128
    tokens.  At the published capacity factor the forward (one flash launch
    a layer) against the same forward with the plain attention through the
    ``attend`` seam; at the dropless one (capacity = T) against the stepped
    decode loop (plain decode attention, the selected experts only); logits
    within 1e-3."""
    import functools

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.models.registry import build_api

    cfg = mixtral_cfg(torch, MIXTRAL_MODEL_LAYERS, torch.float32)
    api = build_api("mixtral-8x7b", cfg)
    model = api.init(0, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    s = 128
    toks = torch.randint(0, cfg.vocab, (1, s), generator=gen, device=DEVICE)
    plain = functools.partial(attention_ref, causal=True, window=cfg.window)
    for cf in (cfg.capacity_factor, MIXTRAL_DROPLESS_CF):
        model.cfg = dataclasses.replace(cfg, capacity_factor=cf)
        reset_launches()
        logits, stats = model(toks)
        torch.cuda.synchronize()
        counts = read_launches()
        if counts != no_launches(flash_attention=cfg.n_layers):
            raise AssertionError(f"mixtral forward launched {counts}, not the flash kernel once "
                                 f"per layer ({cfg.n_layers})")
        if not torch.isfinite(logits).all() or logits.shape != (1, s, cfg.vocab):
            raise AssertionError(f"forward logits: shape {tuple(logits.shape)} or non-finite")
        stat = ", ".join(f"{k}={float(v):.6f}" for k, v in stats.items())
        if cf != MIXTRAL_DROPLESS_CF:
            with torch.no_grad():
                want, want_stats = model.train_forward(toks, attend=plain)
            what = "the same forward with the plain attention (attend seam)"
            stat += " (plain: " + ", ".join(
                f"{k}={float(v):.6f}" for k, v in want_stats.items()) + ")"
        else:
            if float(stats["drop_frac"]) != 0.0:
                raise AssertionError(f"capacity factor {cf} dropped routings: {stat}")
            cache = api.init_cache(1, s, device=DEVICE)
            rows = []
            for p in range(s):
                lg, cache = api.decode_step(model, cache, toks[:, p : p + 1], p)
                rows.append(lg)
            want = torch.cat(rows, dim=1)
            what = "the stepped decode loop"
            del cache, rows
        err = (logits - want).abs().max().item()
        log("model", f"mixtral-8x7b f32 ({cfg.n_layers} of 32 layers, {api.param_count()} "
            f"params) capacity_factor {cf}: forward over {s} tokens "
            f"({counts['flash_attention']} flash launches) vs {what}: logits max abs err "
            f"{err:.3e} (limit 1e-3); logits scale {want.abs().max().item():.3f}; {stat}")
        if not err <= 1e-3:
            raise AssertionError(f"mixtral forward vs {what}: {err:.3e} > 1e-3")
    del model


def phase_serving_mixtral(torch):
    """Phase 22: mixtral-8x7b in bf16, ``MIXTRAL_SERVING_LAYERS`` deep,
    under ``ServingRuntime`` as phase 8 (prompts step the decode loop);
    then a 1024-token forward (no host sync inside it) and a decode step:
    wall and device ms, idle share, the flash kernel's part, and the decode
    step's byte bound."""
    from repro_torch.models.registry import build_api
    from repro_torch.runtime.backend import _host_syncs_raise
    from repro_torch.serving import (
        RealServingEngine, ServingAllocator, ServingConfig, ServingRuntime,
        generate_requests,
    )

    cfg = mixtral_cfg(torch, MIXTRAL_SERVING_LAYERS)
    api = build_api("mixtral-8x7b", cfg)
    model = api.init(0, device=DEVICE)
    max_len = 256
    wl = generate_requests(
        8, seed=0, rate=4.0, prompt_min=16, prompt_mean=48, prompt_max=128,
        gen_min=8, gen_mean=16, gen_max=32,
    )
    engine = recording(RealServingEngine)(api, model, max_len=max_len, device=DEVICE)

    # Warm-up outside the counted run: cuBLAS handles.
    warm = api.init_cache(1, max_len, device=DEVICE)
    api.decode_step(model, warm, torch.zeros((1, 1), dtype=torch.long, device=DEVICE), 0)
    torch.cuda.synchronize()
    del warm

    alloc = ServingAllocator({0: (0.01, 0.01), 1: (0.01, 0.01)}, total_slots=4, mode="optperf")
    rt = ServingRuntime(engine, alloc, wl, nodes=[0, 1],
                        config=ServingConfig(total_slots=4, resolve_every=1.0))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    rep = rt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    served = read_launches()

    summ = rep.summary
    log("serving", f"mixtral-8x7b bf16 ({cfg.n_layers} of 32 layers, {api.param_count()} "
        f"params), 2 nodes, 4 slots, max_len {max_len}: completed={summ['completed']}/"
        f"{summ['requests']} dropped={summ['dropped']} requeues={summ['requeues']} "
        f"prefills={rep.counters['admitted']} (prompts step the decode loop; launches in this "
        f"run {served})")
    serving_summary(torch, "mixtral-8x7b", rep, wall, served)
    if summ["completed"] != 8 or summ["dropped"] != 0:
        raise AssertionError(f"served {summ['completed']}/8 with {summ['dropped']} dropped")
    if any(served.values()):
        raise AssertionError(f"stepped prompt ingestion launched kernels: {served}")
    rids = check_streams(torch, api, model, engine, rt, wl, max_len)
    log("serving", f"mixtral-8x7b requests {rids} equal a direct greedy decode")

    # What a forward and a decode step are made of, and the kernel's share.
    s = 1024
    gen = torch.Generator(device=DEVICE).manual_seed(22)
    toks = torch.randint(0, cfg.vocab, (1, s), generator=gen, device=DEVICE)
    reset_launches()
    torch.cuda.synchronize()
    with _host_syncs_raise(model.device):  # the capacity path reads nothing back
        _, stats = model(toks)
    if read_launches() != no_launches(flash_attention=cfg.n_layers):
        raise AssertionError(f"the {s}-token forward launched {read_launches()}")
    logits_ms = host_ms(torch, lambda: api.logits(model, {"tokens": toks}), 3, warmup=1)
    cache = api.init_cache(1, max_len, device=DEVICE)
    last = torch.zeros((1, 1), dtype=torch.long, device=DEVICE)
    decode_ms = host_ms(torch, lambda: api.decode_step(model, cache, last, 0), 10)
    # A batch-1 decode step reads its two experts' matrices, the attention
    # projections and the norms of every layer, and the LM head.
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.head_dim
    layer_bytes = 2 * (cfg.top_k * 3 * d * f + d * dh * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
                       + d * cfg.n_experts + 2 * d)
    decode_bound = (cfg.n_layers * layer_bytes + 2 * d * cfg.vocab) / HBM_BYTES_S * 1e3
    log("serving", f"per call: mixtral-8x7b bf16 api.logits({s} tokens) {logits_ms:.3f} ms "
        f"(drop_frac {float(stats['drop_frac']):.4f}); decode_step {decode_ms:.3f} ms against "
        f"its byte bound {decode_bound:.3f} ms "
        f"({(cfg.n_layers * layer_bytes + 2 * d * cfg.vocab) / 1e9:.2f} GB at "
        f"{HBM_BYTES_S / 1e12:.2f} TB/s)")
    for name, fn, wall_ms in (("forward", lambda: api.logits(model, {"tokens": toks}), logits_ms),
                              ("decode_step", lambda: api.decode_step(model, cache, last, 0),
                               decode_ms)):
        launches = {FLASH_PROFILE_NAME: cfg.n_layers} if name == "forward" else None
        dev, named, idle, _, records = device_split(torch, fn, 3, wall_ms, (FLASH_PROFILE_NAME,),
                                                    launches)
        log("serving", f"profile mixtral-8x7b {name}: device {dev:.3f} ms of {wall_ms:.3f} ms "
            f"(idle share {idle:.4f}), flash kernel {named[FLASH_PROFILE_NAME]:.3f} ms "
            f"(records {records[FLASH_PROFILE_NAME]}/{3 * cfg.n_layers if launches else 0})"
            + (f"; byte bound {decode_bound:.3f} ms, {decode_bound / dev:.1%} of the device "
               "time" if name == "decode_step" else ""))
    del model, cache
    return served


def node_drop_fracs(torch, backend, batches, b_max):
    """The share of routings that each node's slice of one step drops, the
    slices laid out as the training path lays them out
    (``HeteroBatchPartitioner`` rows, then zero-token pad rows up to
    ``b_max``, which take capacity too): ``drop_frac`` of the aux of one
    ``api.loss`` call a node on the backend's trained parameters."""
    from repro_torch.data.pipeline import HeteroBatchPartitioner

    padded, _ = HeteroBatchPartitioner.padded(backend.data.batch(0, sum(batches)), batches)
    width, seq = padded["tokens"].shape[1:]
    fracs = []
    for i, b in enumerate(batches):
        batch = {"weights": (torch.arange(b_max, device=DEVICE) < b).float()}
        for key in ("tokens", "labels"):
            batch[key] = torch.zeros((b_max, seq), dtype=torch.int32, device=DEVICE)
            batch[key][:width] = torch.as_tensor(padded[key][i], device=DEVICE)
        with torch.no_grad():
            fracs.append(float(backend.api.loss(backend.params, batch)[1]["drop_frac"]))
    return fracs


def phase_train_mixtral(torch):
    """Phase 23: mixtral-8x7b in bf16, ``MIXTRAL_TRAIN_LAYERS`` deep, on
    phase 13's recipe through ``EpochLoop`` (two-program, unsharded): losses
    finite, no node excluded, the controller's OptPerf phase, launches as
    the path predicts, peak memory under 80 GB; each node step of the last
    plan with the flash kernels' part and the share of routings it drops;
    one node's float32 gradient through the kernels against the plain
    attention."""
    label = "training (mixtral)"
    arch = "mixtral-8x7b"
    cfg = mixtral_cfg(torch, MIXTRAL_TRAIN_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend, loop, _, rows, counts = sharded_loop(torch, False, TRAIN_EPOCHS, cfg=cfg, arch=arch)
    peak = torch.cuda.max_memory_allocated()
    n = len(rows[0]["batches"])
    want = expected_training_launches(cfg, n)
    for r in rows:
        log(label, f"two-program epoch {r['epoch']} phase={r['phase']} total_batch={r['total']} "
            f"batches={r['batches']} losses={[round(x, 6) for x in r['losses']]} "
            f"anomalies={r['anomalies']} wall_s={r['wall_s']:.3f} transfers h2d={r['h2d']} "
            f"d2h={r['d2h']}")
        if not all(math.isfinite(x) for x in r["losses"]) or any(r["anomalies"]):
            raise AssertionError(f"{arch} epoch {r['epoch']}: {r}")
    log(label, f"{arch} bf16 ({cfg.n_layers} of 32 layers, published widths, "
        f"{backend.api.param_count()} params), cluster_A ({n} nodes), {TRAIN_EPOCHS} epochs x "
        f"{TRAIN_STEPS} steps in {time.perf_counter() - t0:.2f} s; launches {counts} (expected "
        f"{want}); peak_mem_gb={peak / 1e9:.3f}")
    if counts != want:
        raise AssertionError(f"{arch} training launches {counts} != {want}")
    if [r["phase"] for r in rows] != ["bootstrap"] * 2 + ["optperf"] * (TRAIN_EPOCHS - 2):
        raise AssertionError("the controller did not reach its OptPerf phase")
    if not peak < 80e9:
        raise AssertionError(f"peak device memory {peak / 1e9:.1f} GB")

    # Each node's step of the last plan: its forward and backward alone.
    batches = rows[-1]["batches"]
    b_max = max(8, -(-max(batches) // 8) * 8)
    drops = node_drop_fracs(torch, backend, batches, b_max)
    for i, (b, drop) in enumerate(zip(batches, drops)):
        row = node_step_row(torch, backend, backend.data, b, b_max)
        log(label, f"node {i} step (b={b} of padded {b_max}, S=512): wall "
            f"{row['wall_ms']:.2f} ms, device {row['device_ms']:.2f} ms (idle share "
            f"{row['idle_share']:.4f}); flash forward {row['flash_fwd_ms']:.2f} ms (records "
            f"{row['flash_fwd_records']}/{row['flash_fwd_launches']}), flash backward "
            f"{row['flash_bwd_ms']:.2f} ms (records {row['flash_bwd_records']}/"
            f"{row['flash_bwd_launches']}); drop_frac {drop:.4f} (its padded slice of a step "
            "through api.loss on the trained parameters)")
    del backend, loop
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    node_grad_check(torch, arch, MIXTRAL_TRAIN_LAYERS, phase=label)
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.configs import get_api

    full = get_api(arch).param_count()
    log(label, f"CLI --mode spmd --arch {arch} --full-width: not run, it does not fit one 80 GB "
        f"card: AdamW's two float32 moments of its {full / 1e9:.2f} B parameters alone are "
        f"{8 * full / 1e9:.0f} GB")
    log(label, f"phase in {time.perf_counter() - t0:.1f} s: training {t1 - t0:.1f} s, node "
        f"gradient {time.perf_counter() - t1:.1f} s; peak_mem_gb={peak / 1e9:.3f}")
    return counts


def run_moe_phases(torch, enter):
    """Phases 20-23, each entered under its name."""
    enter("model (dense configs)")
    phase_model_dense_configs(torch)
    enter("model (mixtral)")
    phase_model_mixtral(torch)
    gc.collect()
    torch.cuda.empty_cache()
    enter("serving (mixtral)")
    counts = phase_serving_mixtral(torch)
    log("serving", f"mixtral-8x7b path launches {counts}")
    gc.collect()
    torch.cuda.empty_cache()
    enter("training (mixtral)")
    phase_train_mixtral(torch)


def deepseek_cfg(torch, n_layers, dtype=None, **overrides):
    """deepseek-v2-236b at published widths, ``n_layers`` deep (the dense
    layer 0, then MoE layers), in ``dtype`` (default the published bf16)."""
    from repro_torch.configs import deepseek_v2_236b

    cfg = dataclasses.replace(deepseek_v2_236b.config(), n_layers=n_layers, **overrides)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    return cfg


def deepseek_decode_bytes(cfg):
    """Bytes a batch-1 decode step of ``cfg`` must read in its dtype: every
    layer's MLA projections and norms, the dense layer 0's FFN, each MoE
    layer's router, top-k routed experts and shared experts, and the LM
    head (the latent cache at a few hundred tokens is under 1 MB)."""
    d, h, f = cfg.d_model, cfg.n_heads, cfg.d_ff_expert
    attn = (d * cfg.q_lora_rank + cfg.q_lora_rank + cfg.q_lora_rank * h * cfg.qk_dim
            + d * cfg.kv_lora_rank + cfg.kv_lora_rank + d * cfg.qk_rope_dim
            + cfg.kv_lora_rank * h * (cfg.qk_nope_dim + cfg.v_head_dim)
            + h * cfg.v_head_dim * d + 2 * d)
    dense = 3 * d * cfg.d_ff_dense
    moe = d * cfg.n_experts + cfg.top_k * 3 * d * f + 3 * d * cfg.n_shared_experts * f
    return cfg.param_dtype.itemsize * (cfg.n_layers * attn + dense + (cfg.n_layers - 1) * moe + d * cfg.vocab + d)


def phase_model_deepseek(torch):
    """Phase 24: deepseek-v2-236b in float32, ``DEEPSEEK_MODEL_LAYERS`` deep,
    128 tokens.  At the published capacity factor the forward (one flash
    launch a layer, MLA at (192, 128)) against the same forward with the
    plain attention through the ``attend`` seam; at the dropless one
    (capacity = T) against the stepped absorbed decode (plain torch over
    the latent cache, the selected experts only); logits within 1e-3."""
    import functools

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.models.registry import build_api

    cfg = deepseek_cfg(torch, DEEPSEEK_MODEL_LAYERS, torch.float32)
    api = build_api("deepseek-v2-236b", cfg)
    model = api.init(0, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(24)
    s = 128
    toks = torch.randint(0, cfg.vocab, (1, s), generator=gen, device=DEVICE)
    plain = functools.partial(attention_ref, causal=True)
    for cf in (cfg.capacity_factor, DEEPSEEK_DROPLESS_CF):
        model.cfg = dataclasses.replace(cfg, capacity_factor=cf)
        reset_launches()
        logits, stats = model(toks)
        torch.cuda.synchronize()
        counts = read_launches()
        if counts != no_launches(flash_attention=cfg.n_layers):
            raise AssertionError(f"deepseek forward launched {counts}, not the flash kernel "
                                 f"once per layer ({cfg.n_layers})")
        if not torch.isfinite(logits).all() or logits.shape != (1, s, cfg.vocab):
            raise AssertionError(f"forward logits: shape {tuple(logits.shape)} or non-finite")
        stat = ", ".join(f"{k}={float(v):.6f}" for k, v in stats.items())
        if cf != DEEPSEEK_DROPLESS_CF:
            with torch.no_grad():
                want, want_stats = model.train_forward(toks, attend=plain)
            what = "the same forward with the plain attention (attend seam)"
            stat += " (plain: " + ", ".join(
                f"{k}={float(v):.6f}" for k, v in want_stats.items()) + ")"
        else:
            if float(stats["drop_frac"]) != 0.0:
                raise AssertionError(f"capacity factor {cf} dropped routings: {stat}")
            cache = api.init_cache(1, s, device=DEVICE)
            rows = []
            for p in range(s):
                lg, cache = api.decode_step(model, cache, toks[:, p : p + 1], p)
                rows.append(lg)
            want = torch.cat(rows, dim=1)
            what = "the stepped absorbed decode"
            del cache, rows
        err = (logits - want).abs().max().item()
        log("model", f"deepseek-v2-236b f32 ({cfg.n_layers} of 60 layers, {api.param_count()} "
            f"params) capacity_factor {cf:.4f}: forward over {s} tokens "
            f"({counts['flash_attention']} flash launches at (192, 128)) vs {what}: logits max "
            f"abs err {err:.3e} (limit 1e-3); logits scale {want.abs().max().item():.3f}; {stat}")
        if not err <= 1e-3:
            raise AssertionError(f"deepseek forward vs {what}: {err:.3e} > 1e-3")
    del model


def phase_serving_deepseek(torch):
    """Phase 25: deepseek-v2-236b in bf16, ``DEEPSEEK_SERVING_LAYERS`` deep,
    under ``ServingRuntime`` as phase 22 (prompts step the absorbed decode
    loop); then a 1024-token forward (no host sync inside it) and a decode
    step: wall and device ms, idle share, the flash part, and the decode
    step's byte bound."""
    from repro_torch.models.registry import build_api
    from repro_torch.runtime.backend import _host_syncs_raise
    from repro_torch.serving import (
        RealServingEngine, ServingAllocator, ServingConfig, ServingRuntime,
        generate_requests,
    )

    cfg = deepseek_cfg(torch, DEEPSEEK_SERVING_LAYERS)
    api = build_api("deepseek-v2-236b", cfg)
    model = api.init(0, device=DEVICE)
    max_len = 256
    wl = generate_requests(
        8, seed=0, rate=4.0, prompt_min=16, prompt_mean=48, prompt_max=128,
        gen_min=8, gen_mean=16, gen_max=32,
    )
    engine = recording(RealServingEngine)(api, model, max_len=max_len, device=DEVICE)
    warm = api.init_cache(1, max_len, device=DEVICE)
    api.decode_step(model, warm, torch.zeros((1, 1), dtype=torch.long, device=DEVICE), 0)
    torch.cuda.synchronize()
    del warm

    alloc = ServingAllocator({0: (0.01, 0.01), 1: (0.01, 0.01)}, total_slots=4, mode="optperf")
    rt = ServingRuntime(engine, alloc, wl, nodes=[0, 1],
                        config=ServingConfig(total_slots=4, resolve_every=1.0))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    rep = rt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    served = read_launches()
    summ = rep.summary
    log("serving", f"deepseek-v2-236b bf16 ({cfg.n_layers} of 60 layers, {api.param_count()} "
        f"params), 2 nodes, 4 slots, max_len {max_len}: completed={summ['completed']}/"
        f"{summ['requests']} dropped={summ['dropped']} requeues={summ['requeues']} "
        f"prefills={rep.counters['admitted']} (prompts step the absorbed decode loop; launches "
        f"in this run {served})")
    serving_summary(torch, "deepseek-v2-236b", rep, wall, served)
    if summ["completed"] != 8 or summ["dropped"] != 0:
        raise AssertionError(f"served {summ['completed']}/8 with {summ['dropped']} dropped")
    if any(served.values()):
        raise AssertionError(f"stepped prompt ingestion launched kernels: {served}")
    rids = check_streams(torch, api, model, engine, rt, wl, max_len)
    log("serving", f"deepseek-v2-236b requests {rids} equal a direct greedy decode")

    s = 1024
    gen = torch.Generator(device=DEVICE).manual_seed(25)
    toks = torch.randint(0, cfg.vocab, (1, s), generator=gen, device=DEVICE)
    reset_launches()
    torch.cuda.synchronize()
    with _host_syncs_raise(model.device):  # the capacity path reads nothing back
        _, stats = model(toks)
    forward_counts = read_launches()
    if forward_counts != no_launches(flash_attention=cfg.n_layers):
        raise AssertionError(f"the {s}-token forward launched {forward_counts}")
    logits_ms = host_ms(torch, lambda: api.logits(model, {"tokens": toks}), 3, warmup=1)
    cache = api.init_cache(1, max_len, device=DEVICE)
    last = torch.zeros((1, 1), dtype=torch.long, device=DEVICE)
    decode_ms = host_ms(torch, lambda: api.decode_step(model, cache, last, 0), 10)
    nbytes = deepseek_decode_bytes(cfg)
    decode_bound = nbytes / HBM_BYTES_S * 1e3
    log("serving", f"per call: deepseek-v2-236b bf16 api.logits({s} tokens) {logits_ms:.3f} ms "
        f"(drop_frac {float(stats['drop_frac']):.4f}); decode_step {decode_ms:.3f} ms against "
        f"its byte bound {decode_bound:.3f} ms ({nbytes / 1e9:.2f} GB at "
        f"{HBM_BYTES_S / 1e12:.2f} TB/s: top-{cfg.top_k} routed and the shared experts a MoE "
        "layer)")
    for name, fn, wall_ms in (("forward", lambda: api.logits(model, {"tokens": toks}), logits_ms),
                              ("decode_step", lambda: api.decode_step(model, cache, last, 0),
                               decode_ms)):
        launches = {FLASH_PROFILE_NAME: cfg.n_layers} if name == "forward" else None
        dev, named, idle, _, records = device_split(torch, fn, 3, wall_ms, (FLASH_PROFILE_NAME,),
                                                    launches)
        log("serving", f"profile deepseek-v2-236b {name}: device {dev:.3f} ms of {wall_ms:.3f} "
            f"ms (idle share {idle:.4f}), flash kernel {named[FLASH_PROFILE_NAME]:.3f} ms "
            f"(records {records[FLASH_PROFILE_NAME]}/{3 * cfg.n_layers if launches else 0})"
            + (f"; byte bound {decode_bound:.3f} ms, {decode_bound / dev:.1%} of the device "
               "time" if name == "decode_step" else ""))
    del model, cache
    return forward_counts


class NodeGrads:
    """One node's forward and backward through ``api.loss`` on a model
    that holds no optimizer state: ``RealBackend.node_grads`` without the
    rest of ``_step`` (momentum, the other nodes' gradients, the
    aggregate), which a MoE layer of deepseek-v2-236b does not leave room
    for on one card."""

    def __init__(self, api, params, data):
        self.api, self.params, self.data = api, params, data
        self.named = dict(params.named_parameters())

    def node_grads(self, tokens, labels, mask):
        import torch

        loss, _ = self.api.loss(self.params, {"tokens": tokens, "labels": labels,
                                              "weights": mask})
        return torch.autograd.grad(loss, list(self.named.values()))


# _step holds about 14 bytes a parameter (PERF.md section 4): bf16 weights,
# float32 momentum, three nodes' gradients and their float32 aggregate.
STEP_BYTES_PER_PARAM = 14


def phase_train_deepseek(torch):
    """Phase 26: deepseek-v2-236b at ``DEEPSEEK_TRAIN_LAYERS`` layers.  One
    node's bf16 step through ``api.loss`` and its backward at a padded
    b=40 (34 weighted), S=512, remat on: wall and device ms, the flash
    forward and backward parts, launches, peak memory under 80 GB; one
    node's float32 gradient through the kernels against the plain attention
    (as phase 13); why the 3-node ``EpochLoop`` does not fit; then the
    training CLI with its default arguments."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.registry import build_api

    label = "training (deepseek)"
    arch = "deepseek-v2-236b"
    t0 = time.perf_counter()
    cfg = deepseek_cfg(torch, DEEPSEEK_TRAIN_LAYERS)
    api = build_api(arch, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend = NodeGrads(api, api.init(0, device=DEVICE).requires_grad_(True),
                        SyntheticLM(vocab=cfg.vocab, seq_len=512, seed=0))
    b, b_max = 34, 40
    reset_launches()
    row = node_step_row(torch, backend, backend.data, b, b_max)
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    # node_step_profile runs the step a few times (a warm-up, two timed, and
    # one or more profiled): per step, each layer's forward twice (remat)
    # and its backward once.
    steps = counts["flash_attention_backward"] // cfg.n_layers
    want = no_launches(flash_attention=steps * 2 * cfg.n_layers,
                       flash_attention_backward=steps * cfg.n_layers)
    log(label, f"{arch} bf16 ({cfg.n_layers} of 60 layers, published widths, "
        f"{api.param_count()} params), one node step (b={b} of padded {b_max}, S=512, remat): "
        f"wall {row['wall_ms']:.2f} ms, device {row['device_ms']:.2f} ms (idle share "
        f"{row['idle_share']:.4f}); flash forward {row['flash_fwd_ms']:.3f} ms (records "
        f"{row['flash_fwd_records']}/{row['flash_fwd_launches']}), flash backward "
        f"{row['flash_bwd_ms']:.3f} ms (records {row['flash_bwd_records']}/"
        f"{row['flash_bwd_launches']}); launches over {steps} steps {counts} (expected "
        f"{want}); "
        f"peak_mem_gb={peak / 1e9:.3f}")
    if counts != want or steps < 4:
        raise AssertionError(f"{arch} node steps launched {counts} != {want}")
    if not peak < 80e9:
        raise AssertionError(f"peak device memory {peak / 1e9:.1f} GB")
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    node_grad_check(torch, arch, DEEPSEEK_TRAIN_LAYERS, phase=label)
    gc.collect()
    torch.cuda.empty_cache()
    n = api.param_count()
    one = build_api(arch, deepseek_cfg(torch, 1)).param_count()
    log(label, f"EpochLoop (3 nodes): not run on one card: _step holds ~{STEP_BYTES_PER_PARAM} B a "
        f"parameter, {STEP_BYTES_PER_PARAM * n / 1e9:.1f} GB at {cfg.n_layers} layers "
        f"({n / 1e9:.2f} B parameters) before any activation; 1 layer "
        f"({STEP_BYTES_PER_PARAM * one / 1e9:.1f} GB) has no MoE layer, and the reference's "
        "aux stats are then means over none (NaN), so its loss is NaN; the epoch runs on the CPU "
        "at the reduced config against the reference (tests/test_torch_train_moe.py)")
    t2 = time.perf_counter()
    default_cli(torch, label)
    log(label, f"phase in {time.perf_counter() - t0:.1f} s: node step {t1 - t0:.1f} s, node "
        f"gradient {t2 - t1:.1f} s, CLI {time.perf_counter() - t2:.1f} s; "
        f"peak_mem_gb={peak / 1e9:.3f}")
    return counts


def default_cli(torch, phase):
    """``python -m repro_torch.launch.train`` with its default arguments
    (the hetero loop on cluster B over reduced olmo-1b, float32, head dim
    32) on the card: exit 0 and every epoch's loss finite."""
    import re

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    losses = [float(m.group(1)) for m in re.finditer(r"loss=(\S+)", proc.stdout)]
    log(phase, f"CLI with default arguments (python -m repro_torch.launch.train): exit "
        f"{proc.returncode} in {secs:.1f} s, {len(losses)} epochs, losses {losses}")
    if proc.returncode != 0 or not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"the default CLI failed: {proc.stdout[-2000:]} "
                             f"{proc.stderr[-4000:]}")


def run_deepseek_phases(torch, enter):
    """Phases 24-26, each entered under its name; returns the serving
    forward's launches and the node steps'."""
    enter("model (deepseek)")
    phase_model_deepseek(torch)
    gc.collect()
    torch.cuda.empty_cache()
    enter("serving (deepseek)")
    forward_counts = phase_serving_deepseek(torch)
    log("serving", f"deepseek-v2-236b 1024-token forward launches {forward_counts}")
    gc.collect()
    torch.cuda.empty_cache()
    enter("training (deepseek)")
    train_counts = phase_train_deepseek(torch)
    return forward_counts, train_counts


def whisper_cfg(torch, dtype=None, n_layers=None):
    """whisper-large-v3 at published widths, ``n_layers`` deep on each side
    (default uncut: 32 + 32), in ``dtype`` (default the published bf16)."""
    from repro_torch.configs import whisper_large_v3

    cfg = whisper_large_v3.config()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_enc_layers=n_layers, n_dec_layers=n_layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    return cfg


def whisper_attentions(cfg):
    """Flash launches of one whisper forward: each encoder layer's
    self-attention, each decoder layer's self- and cross-attention."""
    return cfg.n_enc_layers + 2 * cfg.n_dec_layers


def whisper_batch(torch, cfg, b, s, seed):
    """Seeded ``audio_embed`` (b, enc_frames, d_model) in the compute dtype,
    tokens and next-token labels (b, s), and per-sample weights (the last
    sample half weighted)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    audio = torch.randn((b, cfg.enc_frames, cfg.d_model), generator=gen, device=DEVICE)
    toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen, device=DEVICE)
    weights = torch.ones(b, device=DEVICE)
    weights[-1] = 0.5
    return {"audio_embed": audio.to(cfg.compute_dtype), "tokens": toks[:, :-1],
            "labels": toks[:, 1:], "weights": weights}


@contextlib.contextmanager
def seams_on(model, seams):
    """Within the block, ``model.train_forward`` (what ``api.loss`` calls)
    takes ``seams``."""
    model.train_forward = functools.partial(type(model).train_forward, model, **seams)
    try:
        yield model
    finally:
        del model.train_forward


def phase_model_whisper(torch):
    """Phase 27: whisper-large-v3 in float32 at published widths,
    ``WHISPER_MODEL_LAYERS`` deep, B=2, 1500 frames, ``WHISPER_MODEL_TEXT``
    text tokens.  ``api.logits`` through the kernels (one flash launch an
    attention) against the same forward with the plain attention through
    the three seams, within 1e-4; against ``encode``, ``prime_cache`` and
    the stepped decode (plain torch, no launch), within 1e-3; the gradient
    of ``api.loss`` with per-sample weights through the kernels against
    the plain seams (``check_grads``)."""
    from repro_torch.models.registry import build_api

    label = "model (whisper)"
    cfg = whisper_cfg(torch, torch.float32, WHISPER_MODEL_LAYERS)
    api = build_api("whisper-large-v3", cfg)
    model = api.init(0, device=DEVICE)
    b, s = 2, WHISPER_MODEL_TEXT
    batch = whisper_batch(torch, cfg, b, s, seed=27)
    n = whisper_attentions(cfg)
    reset_launches()
    logits = api.logits(model, batch)
    torch.cuda.synchronize()
    counts = read_launches()
    if counts != no_launches(flash_attention=n):
        raise AssertionError(f"whisper forward launched {counts}, not the flash kernel once "
                             f"an attention ({n})")
    if not torch.isfinite(logits).all() or logits.shape != (b, s, cfg.vocab):
        raise AssertionError(f"forward logits: shape {tuple(logits.shape)} or non-finite")
    seams = plain_seams(cfg.family)
    with torch.no_grad():
        plain = model.train_forward(batch["audio_embed"], batch["tokens"], **seams)
    seam_err = (logits - plain).abs().max().item()
    del plain

    reset_launches()
    enc = model.encode(batch["audio_embed"])
    cache = model.prime_cache(api.init_cache(b, s, device=DEVICE), enc)
    torch.cuda.synchronize()
    enc_counts = read_launches()
    reset_launches()
    rows = []
    for p in range(s):
        lg, cache = api.decode_step(model, cache, batch["tokens"][:, p:p + 1], p)
        rows.append(lg)
    stepped = torch.cat(rows, dim=1)
    torch.cuda.synchronize()
    decode_counts = read_launches()
    step_err = (logits - stepped).abs().max().item()
    log(label, f"whisper-large-v3 f32 ({cfg.n_enc_layers} + {cfg.n_dec_layers} layers, "
        f"{api.param_count()} params), B={b}, {cfg.enc_frames} frames, {s} tokens: api.logits "
        f"({counts['flash_attention']} flash launches) vs the plain attention through the "
        f"seams {'/'.join(seams)}: max abs err {seam_err:.3e} (limit 1e-4); vs encode "
        f"({enc_counts['flash_attention']} launches), prime_cache and {s} stepped decode_steps "
        f"({decode_counts['flash_attention']} launches): max abs err {step_err:.3e} (limit "
        f"1e-3); logits scale {logits.abs().max().item():.3f}")
    if enc_counts != no_launches(flash_attention=cfg.n_enc_layers) or any(
            decode_counts.values()):
        raise AssertionError(f"encode launched {enc_counts}, the stepped decode {decode_counts}")
    if not seam_err <= 1e-4:
        raise AssertionError(f"whisper kernels vs plain seams: {seam_err:.3e} > 1e-4")
    if not step_err <= 1e-3:
        raise AssertionError(f"whisper forward vs stepped decode: {step_err:.3e} > 1e-3")
    del cache, rows, stepped, enc

    model.requires_grad_(True)
    grads = {}
    for name, seam in (("kernel", {}), ("plain", seams)):
        reset_launches()
        with seams_on(model, seam):
            loss, _ = api.loss(model, batch)
        grads[name] = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        launched = read_launches()
        want = (no_launches(flash_attention=(2 if cfg.remat else 1) * n,
                            flash_attention_backward=n) if name == "kernel" else no_launches())
        if launched != want:
            raise AssertionError(f"{name} loss gradient launched {launched}, not {want}")
        del loss
    check_grads(label, f"whisper-large-v3 f32 gradient of api.loss (B={b}, weights "
                f"{batch['weights'].tolist()}, {cfg.n_enc_layers} + {cfg.n_dec_layers} layers, "
                f"remat={cfg.remat}), kernels vs plain {'/'.join(seams)}", model, grads)
    del model, grads


def top_kernels(torch, fn, n=6):
    """One call of ``fn`` under ``torch.profiler``: its ``n`` CUDA kernels
    with the most device time, as "name ms xcount" strings, and its count
    of kernel records (what the host launched, where none was lost)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted(((evt.self_device_time_total / 1e3, evt.key, evt.count)
                      for evt in prof.key_averages()
                      if evt.device_type == DeviceType.CUDA
                      and not getattr(evt, "is_user_annotation", False)), reverse=True)
    return ([f"{name[:70]} {ms:.3f} ms x{count}" for ms, name, count in kernels[:n]],
            sum(count for _, _, count in kernels))


def whisper_decode_bytes(cfg, b, enc_len, pos):
    """Bytes one decode step at ``pos`` must move (weights and caches in
    the parameter dtype): each decoder layer's self-attention projections,
    the cross-attention's q and output projections (its K/V come primed),
    the MLP and three norms; the final norm and the tied head (the
    embedding, read once); the primed cross K/V over ``enc_len`` frames and
    the self cache over ``pos + 1`` positions read, one position written;
    the float32 logits written."""
    d, hd, f = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff
    weights = cfg.n_dec_layers * (6 * d * hd + 2 * d * f + 6 * d) + 2 * d + cfg.vocab * d
    caches = cfg.n_dec_layers * b * 2 * hd * (enc_len + pos + 2)
    return cfg.param_dtype.itemsize * (weights + caches) + 4 * b * cfg.vocab


def phase_serving_whisper(torch):
    """Phase 28: whisper-large-v3 in bf16, uncut.  Eight 30-second windows
    (``audio_embed`` (8, 1500, 1280), seeded) through ``encode`` (32 flash
    launches and nothing else), ``prime_cache`` and ``WHISPER_DECODE_STEPS``
    greedy ``decode_step``s (no launch): every logit finite, every token
    inside the vocab; the encoder forward's and a decode step's wall and
    device ms, idle share and flash part, and the decode step's byte
    bound."""
    from repro_torch.models.registry import build_api

    label = "serving (whisper)"
    cfg = whisper_cfg(torch)
    api = build_api("whisper-large-v3", cfg)
    model = api.init(0, device=DEVICE)
    b, steps = 8, WHISPER_DECODE_STEPS
    audio = whisper_batch(torch, cfg, b, 1, seed=28)["audio_embed"]
    model.encode(audio)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    enc = model.encode(audio)
    torch.cuda.synchronize()
    enc_counts = read_launches()
    if enc_counts != no_launches(flash_attention=cfg.n_enc_layers):
        raise AssertionError(f"the encoder forward launched {enc_counts}")
    if not torch.isfinite(enc).all():
        raise AssertionError("non-finite encoder output")
    cache = model.prime_cache(api.init_cache(b, steps, device=DEVICE), enc)
    tok = torch.zeros((b, 1), dtype=torch.long, device=DEVICE)
    out = []
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in range(steps):
        logits, cache = api.decode_step(model, cache, tok, p)
        tok = logits[:, -1:].argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / steps
    decode_counts = read_launches()
    toks = torch.cat(out, dim=1)
    if any(decode_counts.values()):
        raise AssertionError(f"the stepped decode launched {decode_counts}")
    if not torch.isfinite(logits).all() or not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError("non-finite decode logits or a token outside the vocab")
    peak = torch.cuda.max_memory_allocated()
    log(label, f"whisper-large-v3 bf16 (uncut, {api.param_count()} params), {b} windows of "
        f"{cfg.enc_frames} frames: encode ({enc_counts['flash_attention']} flash launches), "
        f"prime_cache, {steps} greedy decode_steps ({decode_counts['flash_attention']} "
        f"launches) at {loop_ms:.3f} ms a step; every logit finite, tokens inside the vocab "
        f"(first window's first 8: {toks[0, :8].tolist()}); peak_mem_gb={peak / 1e9:.3f}")

    last = steps - 1
    nbytes = whisper_decode_bytes(cfg, b, enc.shape[1], last)
    bound = nbytes / HBM_BYTES_S * 1e3
    enc_ms = host_ms(torch, lambda: model.encode(audio), 3, warmup=1)
    decode_ms = host_ms(torch, lambda: api.decode_step(model, cache, tok, last), 10)
    for name, fn, wall_ms, launches in (
            ("encoder forward", lambda: model.encode(audio), enc_ms,
             {FLASH_PROFILE_NAME: cfg.n_enc_layers}),
            ("decode_step", lambda: api.decode_step(model, cache, tok, last), decode_ms, None)):
        dev, named, idle, _, records = device_split(torch, fn, 3, wall_ms, (FLASH_PROFILE_NAME,),
                                                    launches)
        log(label, f"profile whisper-large-v3 {name} (B={b}): wall {wall_ms:.3f} ms, device "
            f"{dev:.3f} ms (idle share {idle:.4f}), flash kernel {named[FLASH_PROFILE_NAME]:.3f} "
            f"ms (records {records[FLASH_PROFILE_NAME]}/{3 * cfg.n_enc_layers if launches else 0})"
            + (f"; byte bound {bound:.3f} ms ({nbytes / 1e9:.3f} GB at {HBM_BYTES_S / 1e12:.2f} "
               f"TB/s: decoder weights but the cross K/V projections, the tied head, the cross "
               f"K/V of {enc.shape[1]} frames, the self cache at pos {last}), "
               f"{bound / dev:.1%} of the device time" if launches is None else ""))
        top, records = top_kernels(torch, fn)
        log(label, f"whisper-large-v3 {name}: {records} kernel records; the most device time: "
            + "; ".join(top))
    del model, cache, enc
    return enc_counts


WHISPER_TRAIN_STEPS = 3
WHISPER_TRAIN_LR = 1e-3  # AdamW: moves every bf16 weight matrix in one step


def phase_train_whisper(torch):
    """Phase 29: whisper-large-v3 in bf16, uncut, remat on:
    ``WHISPER_TRAIN_STEPS`` steps of ``build_train_step(api, adamw(...))`` on
    B=8 of (1500, 1280) frames and 375 tokens and labels with per-sample
    weights: every loss finite, watched weights changed by each step, 192
    flash forwards and 96 backward calls a step, peak under 80 GB; the
    step's wall and device ms and the flash forward and backward parts."""
    from repro_torch.models.registry import build_api
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.train.step import build_train_step

    label = "training (whisper)"
    cfg = whisper_cfg(torch)
    api = build_api("whisper-large-v3", cfg)
    model = api.init(0, device=DEVICE).requires_grad_(True)
    opt = adamw(constant_schedule(WHISPER_TRAIN_LR))
    step = build_train_step(api, opt)
    state = opt.init(dict(model.named_parameters()))
    b, s = 8, WHISPER_TRAIN_TEXT
    batch = whisper_batch(torch, cfg, b, s, seed=29)
    named = dict(model.named_parameters())
    watch = ("embed", "enc_layers.0.attn.wq", f"dec_layers.{cfg.n_dec_layers - 1}.mlp.w_out")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, walls = [], []
    for _ in range(WHISPER_TRAIN_STEPS):
        before = {k: named[k].detach().clone() for k in watch}
        t0 = time.perf_counter()
        model, state, metrics = step(model, state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        still = [k for k in watch if torch.equal(before[k], named[k])]
        if still or not math.isfinite(losses[-1]):
            raise AssertionError(f"step {len(losses)}: loss {losses[-1]}, unchanged {still}")
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n = whisper_attentions(cfg)
    per_step = (2 if cfg.remat else 1) * n
    want = no_launches(flash_attention=WHISPER_TRAIN_STEPS * per_step,
                       flash_attention_backward=WHISPER_TRAIN_STEPS * n)
    launches = {FLASH_PROFILE_NAME: per_step, BWD_PROFILE_NAME: BWD_KERNELS_PER_CALL[
        BWD_PROFILE_NAME] * n}
    dev, part, idle, _, records = device_split(
        torch, lambda: step(model, state, batch), 1, min(walls[1:]), tuple(launches), launches)
    log(label, f"whisper-large-v3 bf16 (uncut, {api.param_count()} params, remat), "
        f"{WHISPER_TRAIN_STEPS} AdamW steps (lr {WHISPER_TRAIN_LR}) on B={b} x "
        f"{cfg.enc_frames} frames and {s} tokens, weights {batch['weights'].tolist()}: losses "
        f"{losses}; wall ms {[round(w, 2) for w in walls]}; a step: device {dev:.2f} ms (idle "
        f"share {idle:.4f}), flash forward {part[FLASH_PROFILE_NAME]:.3f} ms (records "
        f"{records[FLASH_PROFILE_NAME]}/{per_step}), flash backward "
        f"{part[BWD_PROFILE_NAME]:.3f} ms (records {records[BWD_PROFILE_NAME]}/"
        f"{launches[BWD_PROFILE_NAME]}); launches over {WHISPER_TRAIN_STEPS} steps {counts} "
        f"(expected {want}); peak_mem_gb={peak / 1e9:.3f}")
    top, records = top_kernels(torch, lambda: step(model, state, batch))
    log(label, f"whisper-large-v3 train step: {records} kernel records; the most device time: "
        + "; ".join(top))
    if counts != want:
        raise AssertionError(f"whisper training launched {counts} != {want}")
    if not peak < 80e9:
        raise AssertionError(f"peak device memory {peak / 1e9:.1f} GB")
    del model, state, step
    return counts


def run_whisper_phases(torch, enter):
    """Phases 27-29, each entered under its name; returns the encoder
    forward's launches and the training steps'."""
    enter("model (whisper)")
    phase_model_whisper(torch)
    gc.collect()
    torch.cuda.empty_cache()
    enter("serving (whisper)")
    forward_counts = phase_serving_whisper(torch)
    gc.collect()
    torch.cuda.empty_cache()
    enter("training (whisper)")
    train_counts = phase_train_whisper(torch)
    return forward_counts, train_counts


# Phase 30: the dry run on the card's machine.  deepseek-v2-236b's train step
# traces 16 microbatches a step; cut to 3 of 60 layers it fits the phase's
# time beside the other cases.
DRYRUN_DEEPSEEK_LAYERS = 3
DRYRUN_CASES = (
    ("olmo-1b", "train_4k", None),
    ("olmo-1b", "decode_32k", None),
    ("deepseek-v2-236b", "train_4k", DRYRUN_DEEPSEEK_LAYERS),
    ("rwkv6-7b", "prefill_32k", None),
    ("hymba-1.5b", "long_500k", None),
)
DRYRUN_STEP = dict(arch="olmo-1b", batch=8, seq=512)
DRYRUN_PEAK_TOL = 0.10
CARD_BYTES = 80e9


def dryrun_step_child(out_path: str) -> int:
    """Phase 30's second part, in a process of its own (the trace takes a
    fake default process group): full-width olmo-1b bf16, AdamW, at
    ``DRYRUN_STEP``'s batch, traced by the dry run on a one-rank ``"cuda"``
    mesh, then run for real on the card; writes both sides' numbers."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import InputShape, get_api
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_fake_mesh, make_rules
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.train.step import build_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    b, s = DRYRUN_STEP["batch"], DRYRUN_STEP["seq"]
    api = get_api(DRYRUN_STEP["arch"])
    shape = InputShape("step_check", s, b, "train")
    mesh = make_fake_mesh((1, 1), ("data", "model"), device_type="cuda")
    rules = make_rules(mesh, api.arch_id, kind="train", global_batch=b)
    t0 = time.perf_counter()
    traced = dryrun.trace_step(api, shape, mesh, rules, device="cuda")
    trace_s = time.perf_counter() - t0

    model = api.init(0, device="cuda")
    model.requires_grad_(True)
    opt = adamw(constant_schedule(1e-4))
    named = dict(model.named_parameters())
    state = opt.init(named)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {
        "tokens": torch.randint(0, api.cfg.vocab, (b, s), generator=gen, device="cuda",
                                dtype=torch.int32),
        "labels": torch.randint(0, api.cfg.vocab, (b, s), generator=gen, device="cuda",
                                dtype=torch.int32),
        "weights": torch.ones(b, device="cuda"),
    }
    args = [*named.values(), *state.m.values(), *state.v.values(), *batch.values()]
    arg_bytes = sum(t.numel() * t.element_size() for t in args)
    step = build_train_step(api, opt, microbatches=traced["microbatches"], with_metrics=False)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as counter:
        _, _, metrics = step(model, state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    result = {
        "trace_s": trace_s, "wall_s": wall_s, "loss": loss,
        "microbatches": traced["microbatches"],
        "predicted": {**traced["memory"], "matmul_flops": traced["stats"].matmul_flops},
        "real": {"argument_size_in_bytes": arg_bytes, "allocated_before": before,
                 "peak": torch.cuda.max_memory_allocated(),
                 "matmul_flops": counter.get_total_flops()},
        "launches": read_launches(),
    }
    with open(out_path, "w") as f:
        json.dump(result, f)
    return 0


def dryrun_line(rec) -> str:
    mem = rec["memory"]
    args, temp = mem["argument_size_in_bytes"], mem["temp_size_in_bytes"]
    cut = f", {rec['layers']} layers" if rec.get("layers") else ""
    return (f"{rec['arch']} {rec['shape']} {rec['mesh']} ({rec['device']}{cut}): "
            f"{rec['status']} in {rec['trace_seconds']} s; per device (counts, not card "
            f"times): matmul_flops={rec['hlo']['matmul_flops']:.4e} "
            f"flops={rec['hlo']['flops']:.4e} collective bytes by kind "
            f"{rec['hlo']['collective_by_kind']} counts {rec['hlo']['collective_counts']}; "
            f"argument {args / 1e9:.3f} GB, temp {temp / 1e9:.3f} GB, fits "
            f"{CARD_BYTES / 1e9:.0f} GB: {args + temp < CARD_BYTES}")


def phase_dryrun(torch):
    """Phase 30: the dry run's cases on the ``"cuda"`` single-pod mesh and
    the one-device check against a real step, every child at once."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as out:
        procs = []
        for arch, shape, layers in DRYRUN_CASES:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--mesh", "single", "--device", "cuda", "--out", out,
                   "--force"] + ([] if layers is None else ["--layers", str(layers)])
            procs.append(subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        step_path = os.path.join(out, "step.json")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                       "--dryrun-step", step_path], env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
        outputs = [p.communicate(timeout=900) for p in procs]
        failed = []
        for (arch, shape, layers), p, (_, err) in zip(DRYRUN_CASES, procs, outputs):
            suffix = "" if layers is None else f"__L{layers}"
            path = os.path.join(out, f"{arch}__{shape}__single{suffix}.json")
            rec = json.load(open(path)) if os.path.exists(path) else {"status": "missing"}
            if rec["status"] != "ok":
                failed.append((arch, shape, rec.get("error"), rec.get("traceback", err[-3000:])))
                log("dryrun", f"{arch} {shape}: {rec['status']} {rec.get('error', '')}")
                continue
            log("dryrun", dryrun_line(rec))
            if not (rec["hlo"]["matmul_flops"] > 0 and rec["hlo"]["unknown_trip_whiles"] == 0):
                failed.append((arch, shape, "no matmul FLOPs counted", ""))
        if procs[-1].returncode != 0 or not os.path.exists(step_path):
            raise AssertionError(f"the step check failed: {outputs[-1][1][-4000:]}; "
                                 f"dry-run cases failed: {failed}")
        res = json.load(open(step_path))
    pred, real = res["predicted"], res["real"]
    predicted_peak = pred["argument_size_in_bytes"] + pred["temp_size_in_bytes"]
    peak_rel = abs(real["peak"] - predicted_peak) / predicted_peak
    want = no_launches(flash_attention=2 * 16 * res["microbatches"],
                       flash_attention_backward=16 * res["microbatches"])
    log("dryrun", f"step check: {DRYRUN_STEP['arch']} bf16 AdamW B={DRYRUN_STEP['batch']} x "
        f"{DRYRUN_STEP['seq']} ({res['microbatches']} microbatches), traced on a one-rank "
        f"cuda mesh in {res['trace_s']:.1f} s, run on the card in {res['wall_s']:.2f} s "
        f"(loss {res['loss']:.4f}): argument bytes predicted {pred['argument_size_in_bytes']} "
        f"real {real['argument_size_in_bytes']}; matmul FLOPs predicted "
        f"{pred['matmul_flops']:.6e} real {real['matmul_flops']:.6e} (FlopCounterMode); "
        f"peak predicted (argument + temp) {predicted_peak / 1e9:.3f} GB real "
        f"{real['peak'] / 1e9:.3f} GB (allocated before the step "
        f"{real['allocated_before'] / 1e9:.3f} GB), rel {peak_rel:.4f} (limit "
        f"{DRYRUN_PEAK_TOL}); launches {res['launches']} (expected {want}); phase "
        f"{time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError(f"dry-run cases failed: {failed}")
    if pred["argument_size_in_bytes"] != real["argument_size_in_bytes"]:
        raise AssertionError("the dry run's argument bytes differ from the real step's")
    if pred["matmul_flops"] != real["matmul_flops"]:
        raise AssertionError("the dry run's matmul FLOPs differ from the real step's")
    if not peak_rel <= DRYRUN_PEAK_TOL:
        raise AssertionError(f"the real peak is {peak_rel:.3f} off the prediction")
    if res["launches"] != want or not math.isfinite(res["loss"]):
        raise AssertionError(f"the real step launched {res['launches']} != {want}")
    return res["launches"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here without the repository's src/)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    starts = []  # (phase, start seconds) in order

    def enter(name):
        starts.append((name, time.perf_counter()))
        return name

    enter("device")
    try:
        card = phase_device()
        enter("build")
        phase_build()
        if sys.argv[1:] in (["--only", "sharded"], ["--only", "split"]):
            enter("sharded training (olmo-1b)")
            if sys.argv[2] == "split":
                split_node_axis(torch)
            else:
                phase_sharded(torch)
            log("done", f"{' '.join(sys.argv[1:])} passed in "
                f"{time.perf_counter() - t_start:.1f} s")
            print(card)
            return 0
        if sys.argv[1:] == ["--only", "moe"]:
            run_moe_phases(torch, enter)
            log("done", f"--only moe passed in {time.perf_counter() - t_start:.1f} s; "
                "seconds per phase: " + ", ".join(
                    f"{name} {end - start:.1f}" for (name, start), end in zip(
                        starts, [t for _, t in starts[1:]] + [time.perf_counter()])))
            print(card)
            return 0
        if sys.argv[1:] == ["--only", "deepseek"]:
            enter("kernel")
            phase_kernel(torch, [c for c in KERNEL_CASES if isinstance(c[7], tuple)])
            enter("kernel (flash bwd)")
            phase_kernel_bwd(torch, [c for c in BWD_CASES if isinstance(c[7], tuple)])
            torch.cuda.empty_cache()
            run_deepseek_phases(torch, enter)
            log("done", f"--only deepseek passed in {time.perf_counter() - t_start:.1f} s; "
                "seconds per phase: " + ", ".join(
                    f"{name} {end - start:.1f}" for (name, start), end in zip(
                        starts, [t for _, t in starts[1:]] + [time.perf_counter()])))
            print(card)
            return 0
        if sys.argv[1:] == ["--only", "whisper"]:
            enter("kernel")
            phase_kernel(torch, WHISPER_CASES)
            enter("kernel (flash bwd)")
            phase_kernel_bwd(torch, WHISPER_CASES)
            torch.cuda.empty_cache()
            run_whisper_phases(torch, enter)
            log("done", f"--only whisper passed in {time.perf_counter() - t_start:.1f} s; "
                "seconds per phase: " + ", ".join(
                    f"{name} {end - start:.1f}" for (name, start), end in zip(
                        starts, [t for _, t in starts[1:]] + [time.perf_counter()])))
            print(card)
            return 0
        if sys.argv[1:] == ["--only", "dryrun"]:
            enter("dry run")
            phase_dryrun(torch)
            log("done", f"--only dryrun passed in {time.perf_counter() - t_start:.1f} s")
            print(card)
            return 0
        if sys.argv[1:] == ["--only", "train-ssm"]:
            enter("kernel (wkv and ssm bwd)")
            phase_kernel_backwards(torch)
            for which in ("rwkv6", "hymba"):
                enter(f"training ({which})")
                phase_train_ssm(torch, which)
            log("done", f"--only train-ssm passed in {time.perf_counter() - t_start:.1f} s; "
                "seconds per phase: " + ", ".join(
                    f"{name} {end - start:.1f}" for (name, start), end in zip(
                        starts, [t for _, t in starts[1:]] + [time.perf_counter()])))
            print(card)
            return 0
        enter("kernel")
        rows = phase_kernel(torch)
        enter("kernel (wkv)")
        wkv_rows = phase_kernel_wkv(torch)
        enter("model")
        phase_model(torch)
        enter("serving")
        olmo_counts = phase_serving(torch)
        torch.cuda.empty_cache()
        enter("model (rwkv6)")
        reset_launches()
        phase_model_rwkv6(torch)
        torch.cuda.empty_cache()
        enter("serving (rwkv6)")
        rwkv6_counts = phase_serving_rwkv6(torch, wkv_rows[WKV_MAIN_CASE]["ms"])
        log("serving", f"rwkv6-7b path launches {rwkv6_counts}")
        if rwkv6_counts != no_launches(rwkv6_wkv=32):
            raise AssertionError("the rwkv6-7b path must launch the WKV kernel once per "
                                 f"layer of its forward and nothing else: {rwkv6_counts}")
        torch.cuda.empty_cache()
        enter("kernel (ssm)")
        ssm_rows = phase_kernel_ssm(torch)
        enter("model (hymba)")
        reset_launches()
        phase_model_hymba(torch)
        torch.cuda.empty_cache()
        enter("serving (hymba)")
        hymba_counts = phase_serving_hymba(
            torch, rows[HYMBA_FLASH_CASE]["ms"], ssm_rows[SSM_MAIN_CASE]["ms"])
        log("serving", f"hymba-1.5b path launches {hymba_counts}")
        if hymba_counts != no_launches(flash_attention=32, ssm_scan=32):
            raise AssertionError("the hymba-1.5b path must launch the flash-attention and "
                                 "selective-scan kernels once per layer of its forward and "
                                 f"nothing else: {hymba_counts}")
        torch.cuda.empty_cache()
        enter("kernel (flash bwd)")
        bwd_rows = phase_kernel_bwd(torch)
        torch.cuda.empty_cache()
        enter("training (olmo-1b)")
        train_counts, train_rows = phase_training(torch)
        torch.cuda.empty_cache()
        enter("fused training (olmo-1b)")
        _, fused_rows, fused_proposals = phase_fused_training(torch, train_rows)
        torch.cuda.empty_cache()
        enter("runtime (olmo-1b)")
        runtime_counts = phase_runtime(torch)
        log("runtime", f"olmo-1b runtime path launches {runtime_counts}")
        gc.collect()
        torch.cuda.empty_cache()
        enter("sharded training (olmo-1b)")
        phase_sharded(torch, fused_rows, fused_proposals)
        gc.collect()
        torch.cuda.empty_cache()
        enter("kernel (wkv and ssm bwd)")
        ssm_bwd_rows = phase_kernel_backwards(torch)
        torch.cuda.empty_cache()
        enter("training (rwkv6)")
        rwkv6_train_counts = phase_train_ssm(torch, "rwkv6")
        enter("training (hymba)")
        hymba_train_counts = phase_train_ssm(torch, "hymba")
        gc.collect()
        torch.cuda.empty_cache()
        run_moe_phases(torch, enter)
        gc.collect()
        torch.cuda.empty_cache()
        ds_forward_counts, ds_train_counts = run_deepseek_phases(torch, enter)
        gc.collect()
        torch.cuda.empty_cache()
        wh_forward_counts, wh_train_counts = run_whisper_phases(torch, enter)
        gc.collect()
        torch.cuda.empty_cache()
        enter("dry run")
        phase_dryrun(torch)
    except Exception:  # the run's boundary: report the phase and fail
        traceback.print_exc()
        print(f"chip_smoke: phase {starts[-1][0]} failed", file=sys.stderr)
        return 1
    t_end = time.perf_counter()
    log("done", f"all phases passed in {t_end - t_start:.1f} s (phases 1-30); seconds per "
        "phase: " + ", ".join(f"{name} {end - start:.1f}" for (name, start), end in zip(
            starts, [t for _, t in starts[1:]] + [t_end])))
    kernels = []
    for name, source, replaces, main_row, launches in (
        ("flash_attention", SOURCE_REL, REPLACES, rows[MAIN_CASE],
         olmo_counts["flash_attention"]),
        ("rwkv6_wkv", WKV_SOURCE_REL, WKV_REPLACES, wkv_rows[WKV_MAIN_CASE],
         rwkv6_counts["rwkv6_wkv"]),
        ("ssm_scan", SSM_SOURCE_REL, SSM_REPLACES, ssm_rows[SSM_MAIN_CASE],
         hymba_counts["ssm_scan"]),
        ("flash_attention_backward", SOURCE_REL, REPLACES, bwd_rows[BWD_MAIN_CASE],
         train_counts["flash_attention_backward"]),
        ("rwkv6_wkv_backward", WKV_BWD_SOURCE_REL, WKV_REPLACES,
         ssm_bwd_rows[("wkv", WKV_BWD_MAIN_CASE)], rwkv6_train_counts["rwkv6_wkv_backward"]),
        ("ssm_scan_backward", SSM_BWD_SOURCE_REL, SSM_REPLACES,
         ssm_bwd_rows[("ssm", SSM_BWD_MAIN_CASE)], hymba_train_counts["ssm_scan_backward"]),
        # The MLA instance (q/k 192, v 128) on deepseek-v2-236b's paths: the
        # 1024-token forward of phase 25 and the node steps of phase 26.
        ("flash_attention[192,128]", SOURCE_REL, REPLACES, rows[DEEPSEEK_CASE],
         ds_forward_counts["flash_attention"]),
        ("flash_attention_backward[192,128]", SOURCE_REL, REPLACES, bwd_rows[DEEPSEEK_BWD_CASE],
         ds_train_counts["flash_attention_backward"]),
        # Non-causal (S x T pairs) on whisper-large-v3's paths: the encoder
        # forward of phase 28 and the training steps of phase 29 (whose
        # decoder self-attention is causal).
        ("flash_attention[whisper]", SOURCE_REL, REPLACES, rows[WHISPER_ENC_CASE],
         wh_forward_counts["flash_attention"]),
        ("flash_attention_backward[whisper]", SOURCE_REL, REPLACES, bwd_rows[WHISPER_ENC_CASE],
         wh_train_counts["flash_attention_backward"]),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": main_row["max_abs_err"],
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "device_ms": main_row["device_ms"],
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-step"]:
        sys.exit(dryrun_step_child(sys.argv[2]))
    sys.exit(main())
