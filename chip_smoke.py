#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--out DIR]

Phases, in order, each printing its seconds; any failure exits non-zero:

1. device: requires a CUDA card and prints the
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. build: compiles every kernel source under ``src/repro_torch/kernels/
   csrc/`` (``flash_decode``, ``flash_attn_fwd``, ``flash_attn_bwd``,
   ``adam_adapt``, ``weighted_ce``, ``lion_adapt``, ``adafactor_adapt``),
   one nvcc per source, all at once; prints each build's seconds, the
   ``-Xptxas -v`` register, spill and shared-memory lines and, for the two
   training attention libraries, each kernel's count of tensor-core
   instructions (HMMA and HGMMA) in ``cuobjdump -sass``: every bf16 and f16
   forward must hold HGMMA (wgmma), every dq and dk/dv HMMA.
3. decode kernel: ``flash_decode`` against its plain PyTorch version on
   the card at gemma3-1b shapes (B in {1, 4, 8}, KV=1, G=4, Dh=256, T in
   {16, 128, 1024, 2048}, window on and off, softcap 0 and 50, cluster
   sizes (splits) 1, 3, 7 and the plan's), at qwen2-moe-a2.7b's layer
   (B 1 and 4, T 1024, KV 16, G 1, Dh 128; splits 1, 4 and the plan's),
   at zamba2-7b's shared attention block (B 1 and 4, T 64, 128 and 1024:
   phase 21's cache lengths and the timed bucket; KV 32, G 1, Dh 112;
   splits 1 and the plan's; against the plain version in f32, the bf16
   plain version's own distance printed), at whisper-small's decoder
   layer (B 1 and 4, T 16-256 and 448: phase 22's buckets and its
   context; KV 12, G 1, Dh 64) and llama-3.2-vision-90b's self layer (B 1
   and 4, T 16-128 and 1024; KV 8, G 8, Dh 128), both as zamba2-7b's, and
   at the serving twin's (gemma3-1b smoke: B 1 and 8, T 16 and 32, KV
   1, G 2, Dh 64, window 8 on and off; splits 1, 2 and the plan's),
   f32 within 1e-5 and bf16 within
   2e-2 abs, and the 2-byte dtypes within half an ulp (+1e-5) of the plain
   version in f32 on the same inputs; then the kernel, plain and library
   (``scaled_dot_product_attention``) times over one pass of 26 layers at
   the serving shape, and per local and global layer at buckets 64 and
   1024 (bf16) and 1024 (f32; DECODE_BUCKETS), with the 1024 bucket under
   cluster sizes 4, 8 and 16, and per qwen2-moe-a2.7b (over 8 layers),
   zamba2-7b (over 6 uses) and llama-3.2-vision-90b layer at bucket 1024
   and whisper-small layer at 448 (bf16).
4. training kernels: the flash-attention forward and its dq and dk/dv
   backward kernels through autograd, at bert-base's shape, at a
   gemma-like one (G 4, KV 1, Dh 256, window, softcap, causal, ragged S
   and T), at gemma3-1b's full local and global layers (B 4, S = T 1024),
   with whole key and query tiles of padding, at qwen2-moe-a2.7b's layer
   (B 4, S = T 1024, KV 16, G 1, Dh 128, causal), at zamba2-7b's shared
   block (B 4 and 2, S = T 1024, KV 32, G 1, Dh 112, causal, and ragged S
   300, T 333 at KV 4), at whisper-small's encoder (B 8, 4 and 2, S = T
   1,500, H 12, G 1, Dh 64, non-causal) and decoder (S = T 448, causal)
   layers, at llama-3.2-vision-90b's self layer (B 4, S = T 1024, H 64
   over KV 8: G 8, Dh 128, causal) and at the paper-bench
   twins' layers (S = T 32, Dh 64: mini-BERT's non-causal H 2, 4, 6 at G 1
   and gemma3-1b smoke's causal G 2 over KV 1, window 8 and none, at each
   batch the twins give them), f32 (1e-5 forward, 5e-5
   + 1e-4 relative gradients) and bf16 (2e-2 + 2e-2 relative), each
   against the plain version in f32 on the same inputs (a bf16 plain
   version's own rounding passes the bf16 tolerance at Dh 64; its share
   is printed, not held), the bf16 kernels' results from their own lse
   also within half an ulp (plus the f32 tolerance) of the plain version
   in f32, the f16 forward likewise on the same draws in f16, and the
   bf16 gradients of two runs bitwise equal; a second derivative through the attention and CE
   kernels raises (first order only), through their plain versions not;
   ``adam_adapt`` at the embedding's 23,440,896 elements, the stacked MLP
   weights' 28,311,552, a ragged size and qwen2-moe's expert stack at
   depth 2, 346,030,080 (rtol 1e-5, sum of squares 1e-4);
   ``weighted_ce`` forward and backward at gemma3-1b's LM loss (the (4,
   1023, 262144) logits view, R 4,092), at R 37, V 5,000 and at the LM
   losses of qwen2-moe-a2.7b (V 151,936), minicpm3-4b (V 73,448),
   rwkv6-1.6b (V 65,536), zamba2-7b (V 32,000) and whisper-small (R 8 x
   447, V 51,865: odd, its rows off 16-byte boundaries), f32,
   bf16 and f16 logits, and at every phase a row can take in a 16-byte
   line (``perf/ce_time.py``: V at each residue modulo 4 and 8, V 1, 3
   and 7, storage offsets 0 and 3; 78 cases) (ce and lse within 1e-5 (1 +
   |ref|); dlogits within 1e-6 + 1e-5 |ref| of the plain version in f32,
   plus half an ulp of the dtype for bf16 and f16; a second launch of each
   bitwise equal to the first);
   ``lion_adapt`` and ``adafactor_adapt`` at bert-base's embedding,
   gemma3-1b's embedding (301,989,888) and a ragged size (as
   ``adam_adapt``); then each kernel's time (per bert-base layer at B 48,
   S 128, bf16; the CE also with bf16 and f16 logits at the same shape,
   the f16 instantiation beside the bf16; the attention kernels also per
   gemma3-1b global and local
   layer over 6 layers in its pattern (5 local, 1 global), per
   qwen2-moe-a2.7b layer over 3 of its 24, per use of zamba2-7b's
   shared block over 3 of its 13, per whisper-small encoder layer over 2
   of its 12 (B 8, non-causal) and decoder layer over 4 (B 8, S 448)
   and per llama-3.2-vision-90b self layer over 2 (B 4) (each layer its
   own inputs; cut from the whole models for the run's time limit), with
   SDPA's
   time under each
   backend that takes the layer (the median of five timings, their range
   beside it) and the tiles the bf16 kernels visit; the
   CE at gemma3-1b's, qwen2-moe's, minicpm3's, rwkv6's, zamba2's and
   whisper-small's shapes in f32; the
   adaptation products at 23.4 M
   elements, ``adam_adapt`` also at the 346 M expert stack) beside its
   plain version's, the library call's and the
   bound (for attention, from the valid (query, key) pairs).
5. serve f32: gemma3-1b at full width and depth in f32, random weights
   from a seed, 8 requests of 300-900 prompt tokens through the
   continuous-batching executor; every status ``ok`` and the tokens equal
   to the serial ``greedy_generate``, request by request.
6. serve bf16: the config's own dtype, 8 requests of 256-960 tokens;
   qps, TTFT/TPOT, memory, and ``flash_decode`` launches = 26 x decode
   steps; a ``torch.profiler`` trace of one decode step goes to DIR, with
   its kernel launches and ``flash_decode``'s share of its device time.
7. train f32: bert-base at full width and depth in f32, F32_PAIRS (1)
   SAMA meta steps, each from one state through the kernels and again with every
   kernel forced to its plain version (``dispatch.plain_everywhere``, a
   context the model never enters), base Adam eps 1e-3 (see
   ``phase_train_f32``): losses within 1e-5, eps and hypergrad_norm within
   2e-3 relative, theta and lam per leaf within 1e-6 + 5% of the step's
   largest update (the tolerances of tests/test_torch_sama.py, where the
   port is held against JAX); one step at the paper's eps 1e-8 reported.
8. train bf16: bert-base in its own dtype, batch 48, seq 128, unroll 2,
   BF16_STEPS (1) meta steps through ``MetaLearner.fit`` on WRENCH-analog data: step wall
   time, samples/s, peak memory, each kernel's launches against L(K+3) +
   L(K+1) forwards, L(K+1) dq and dk/dv and one adam_adapt per theta leaf
   per step, and a profiled step's device time by phase and by kernel.
9. train gemma f32: gemma3-1b at full width and depth in f32, the
   per-sequence LM loss through ``weighted_ce``, batch 2, seq 1024, unroll
   2: phase 7's held step pairs, with K + 3 CE forwards and K + 1
   backwards per kernel step, and one step at eps 1e-8 reported.
10. train gemma bf16: two steps of ``python -m repro_torch.launch.train``'s
   ``main`` at its default arch (gemma3-1b), then 2 meta steps at batch 4,
   seq 1024, unroll 2, meta batch 2 as phase 8 times bert-base, with the
   CE launches (5 forward, 3 backward per step) held as well.
11. Lion and Adafactor: bert-base in f32 with each at the base level,
   phase 7's held step pairs each, one ``lion_adapt`` or
   ``adafactor_adapt`` launch per theta leaf per kernel step.
12. baselines f32: bert-base in f32, batch 16, one meta step of each
   baseline estimator (t1t2, neumann, cg at 1 and at 5 iterations,
   iterdiff) through the kernels and with every kernel plain, from one
   state, held as phase 7 holds SAMA's (warm rows, base Adam eps 1e-3),
   the flash launches of the base unroll and the meta gradient counted,
   the passes that differentiate twice counted under the route reason
   "second order". T1-T2, Neumann and CG at 1 iteration are held on every
   coordinate; for CG at 5 and iterdiff, whose reference can give NaN, a
   NaN or inf is reported and must sit in the same coordinates of both
   steps.
13. Table 2: the six methods of ``python -m
   repro_torch.perf.bench_throughput_memory`` on bert-base in its own
   dtypes, batch 48, seq 128, unroll 2, one line each: wall median and
   range, samples/s, peak memory, device time and busy share, each
   kernel's launches over the measured calls, the (route, reason) counts
   (SAMA none plain; the baselines' plain calls all "second order") and
   whether lam stayed finite; ``BENCH_torch_table2.json`` goes to
   DIR/table2.
14. checkpoint (run right after phase 8, whose learner it takes):
   ``MetaLearner.save``, ``load`` into a fresh learner, every leaf bitwise
   equal, and the next step from both states within phase 7's tolerances.
15. scale (``repro_torch.scale``): (a) ``scale_f32``: bert-base in f32
   with microbatch M = 2, phase 7's held step pairs, launches M x
   phase 7's (one adam_adapt per leaf), and the M = 2 step against M = 1
   from one state reported, not held; (b) ``scale_memory``: gemma3-1b with
   the bf16 policy, batch 4, seq 1024, unroll 2, meta batch 4, M in {1,
   2, 4} (``perf/bench_scale.py``, ``BENCH_torch_scale.json`` in
   DIR/scale): step wall median of 3, peak memory, launches held to M x
   the M = 1 counts; (c) ``scale_plan``: ``plan_microbatch`` at a budget
   between the M = 1 and M = 4 peaks picks the smallest fitting M, its
   candidates non-increasing in peak; (d) ``scale_f16``: gemma3-1b with
   f16 activations and the f16 policy, M = 2, four meta steps with
   loss_scale, meta_skipped and skipped base steps per step, and a linear
   probe at 8,192 classes whose f16 logits launch the CE's f16
   instantiation.
16. dataopt: ``DataOptimizer`` at bert-base on 4,096 WRENCH-analog rows:
   the meta scorer (20 SAMA steps, EMA uncertainty) with its launches
   held to the code's prediction, the scoring pass in rows/s, prune,
   retrain, evaluate, reweighted batches, export and load bitwise, el2n
   and grand, and the scoring losses through the kernels within 2e-2 +
   2e-2 relative of plain_everywhere.
17. distributed (``repro_torch.launch.distributed``): bert-base at full
   width in f32, warm rows, base Adam eps 1e-3 (phase 7's). (a) An NCCL
   group of world size 1 on the card: ``MetaLearner(mesh=,
   schedule="single_sync")``, two meta steps at batch 16, seq 128,
   unroll 2, each bitwise equal to the one-process Engine step, with
   exactly 3 all-reduces (unroll + 1) and their bytes. (b) Two gloo ranks
   sharing the card (``distributed.spawn``): identical shards bitwise equal
   to the one-process step on one shard for both schedules; distinct
   shards (16 rows each) two manual steps held to the in-process
   emulation and two pjit steps to the one-process step on the 32 rows,
   phase 7's tolerances, which must hold the two schedules' first steps
   apart (manual vs pjit in eps or hypergrad_norm beyond them); both ranks'
   states bitwise equal after every step; the census (3 manual, the code's
   count for pjit), bytes and each rank's step walls (a barrier before each
   clock starts; rank 0's references run outside the timed steps), and a
   lone all-reduce of one base bucket per rank; the flash forward, dq,
   dk/dv and adam_adapt launched on every rank. Two processes time-share one card over gloo, which stages each
   all-reduce through the host: not the paper's multi-GPU throughput.
   (c) ``DataOptimizer(mesh=)`` loss and el2n scores on the two ranks
   within 1e-5 relative of the one-device pass.
24. the model axis (``launch.fsdp``; run right after phase 17): four gloo
   ranks spawned on the card once, as phase 17's, the two-rank meshes on
   ranks 0-1. (a) bert-base f32 (phase 17's
   learner) at (data 1, model 2), 32 rows: F32_PAIRS manual and pjit
   steps, each held on rank 0 at phase 7's tolerances against the
   one-process Engine step from the gathered state; (b) the same at (2,
   2), one manual step held against the emulated single-sync step of 2
   data shards; on both, the launches of the flash forward, dq, dk/dv and
   adam_adapt on every rank held to the one-process counts, the model
   group's replicated leaves and metrics bitwise equal (sha256), the data
   group's blocks equal, the data group's K + 1 all-reduces, the census
   per group and kind; at (1, 2) also F32_PAIRS manual steps with phase
   11's Adafactor base, held the same way (its factored statistics summed
   over the model group), adafactor_adapt in place of adam_adapt; (d)
   qwen2-moe-a2.7b's SMOKE model (f32) at (1, 2), 4 rows a data shard:
   one manual step at S 16 (each MoE layer gathers the shard's tokens)
   and one at S 512 (each rank's rows whole dispatch groups, the
   load-balance statistics summed over the group), each held on both
   ranks against the one-process Engine step, its launches equal to that
   step's; (c) gemma3-1b at full width,
   MODEL_AXIS_GEMMA_LAYERS layers, bf16 policy, B 4, S 1024, meta batch 2:
   one manual step at (2, 1), then one at (1, 2) (warm), each rank's peak
   memory and walls (gloo-bound), the CE kernels launched too.
   Phase 4 holds adam_adapt at the blocks' sizes (``_shard_sizes``).
18. moe: qwen2-moe-a2.7b (60 routed experts top-4 and 4 shared, 14.0 B
   parameters). (a) Serving in f32 at full width and depth, random weights
   from a seed, 8 requests of 300-900 tokens on 4 slots, tokens equal to the serial
   ``greedy_generate``; (b) bf16 serving as phase 6, 4 requests (qps, TTFT, TPOT, peak
   memory, ``flash_decode`` launches = 24 x decode steps, a profiled decode
   step); (c) f32 training at full width and depth 2 (1.45 B parameters:
   the step's f32 parameter-sized trees at full depth pass 80 GB), batch
   2, seq 1024, unroll 2: two step pairs as phase 9 (launches held to
   the code's formula) with the (call, token) rows whose chosen experts
   differ between the kernel and the plain step counted: with none the
   pair is held at phase 7's tolerances, with some the losses alone; (d)
   bf16 training at depth 2, batch 4, seq 1024, meta batch 2, 2 meta
   steps as phase 10, the profiled step's device time also within the
   ``apply_moe`` ranges (the MoE layers' forward).
19. mla: minicpm3-4b (multi-head latent attention, 62 layers, 4.07 B
   parameters), as phase 18 with training at depth 4 (0.56 B; cut from
   16, as phase 18's bf16 requests from 16 to 4, for the run's time
   limit): its
   decode and training attention are plain ops in both packages, so no
   ``flash_decode`` or flash attention kernel launches (held at 0); the
   CE and ``adam_adapt`` launches are held.
20. continued pretraining and the paper's experiments: (a) gemma3-1b at
   full width and depth in f32 through ``problems.make_auxiliary_spec(
   model.lm_loss, model.per_example)`` (ft batch 1 + pt batch 1, seq 1024,
   unroll 2, meta batch 1, warm rows, base Adam eps 1e-3): phase 7's
   held step pairs, each kernel step's launches held to 2K + 5 model
   forwards and 2K + 1 backwards (attention with its remat recomputes, the
   CE); (b) in its own dtypes, ft batch 2 + pt batch 2, meta batch 2, 5
   meta steps as phase 10 (wall, tokens/s over K (B_ft + B_pt) S, peak
   memory, busy share, device time by phase, the launches held); (c)
   ``serve.ScoreAPI`` over phase 16's export (4,096 rows): 600 requests of
   the three kinds, all submitted and then drained by one ``run_pending``,
   each answer equal to a direct ``ScoreStore`` lookup, the coalesced
   batches, the drain's requests/s and µs per batch (the API's p50/p99 run
   from submission, so here they are the wait behind the submit loop);
   (d) the seven paper-bench twins
   (``repro_torch.perf.bench_*``) at their JAX ``fast`` sizes, each
   ``BENCH_torch_<name>.json`` in DIR/paper_benches, one line each with
   its rows, claims and kernel launches (the mini-BERT and gemma3 smoke
   twins must launch the attention kernels and ``adam_adapt``, the serving
   twin ``flash_decode``), each signature at which a twin launches the
   attention kernels (B, S, T, KV, G, Dh, causal, window, softcap, dtype)
   one that phases 3 and 4 held against the plain versions;
   ``bench_serve``'s three asserts hold.
21. the recurrent families, as phases 18-19: (a-d) rwkv6-1.6b (RWKV6,
   24 layers, 1.45 B parameters, V 65,536: no attention, its cache all
   state) and (e-h) zamba2-7b (81 Mamba2 blocks, 13 uses of one shared
   attention block, 6.64 B parameters, V 32,000). Each served at full
   size in f32 (8 requests of 16-20 prompt tokens on 4 slots, so slots
   retire and are prefilled again, 8 generated, page 64, max_len 128;
   tokens equal to the serial path) and in bf16 (8 requests), prefill the
   token scan (one decode step per prompt token, flash_decode held to
   zamba2's 13 uses per decode step and per prompt token); trained at full
   width: two f32 step pairs, rwkv6 at depth 12 of 24 (0.79 B) and zamba2
   at 9 (3 leading blocks and one group of 6 with the shared block,
   1.02 B), held at phase 7's tolerances; for rwkv6 (chaotic at rounding
   level at its init) each quantity at the larger of those and 1.5 times
   the spread of three plain steps from theta moved by one ulp; the
   launches held to the formula (no attention kernel for rwkv6, the shared
   block's uses for zamba2); 2 bf16 steps at batch 4, seq 1024, rwkv6 at
   its full 24 layers, zamba2 at 9. Every attention-kernel launch of the
   phase at a signature phases 3 and 4 held.
22. cross-attention: (a-b) whisper-small (audio: 12 encoder and 12
   decoder layers, 263 M parameters, V 51,865) at full size, as phases
   18-19: served in f32 (8 requests of 16-200 prompt tokens, 32
   generated, 4 slots, page 16, max_len 448, its decoder's context;
   tokens equal to the serial path) and bf16 (8 requests: qps, TTFT,
   TPOT, a profiled decode step; flash_decode launches = 12 x decode
   steps), each request cross-attending to the cache's zero ``cross_kv``
   as in the reference; trained at full depth with 1,500 random frames a
   sequence and S 448: two f32 step pairs at batch 2 held at phase 7's
   tolerances, 2 bf16 steps at batch 8, meta batch 4 (wall, samples/s,
   tokens/s over K B S, peak, busy share, device time by phase, launches
   held to the formula with the encoder's 12 layers); (c)
   llama-3.2-vision-90b at full width and 10 of its 100 layers (two
   groups of four self layers and a gated cross layer, 9.62 B
   parameters), its gates nonzero: 4 f32 requests, tokens equal to the
   serial path, and an f32 forward at B 4, S 1024 over random patches
   through the kernels against every kernel plain, logits within 1e-4 +
   1e-4 |ref|. Every attention-kernel launch of the phase at a signature
   phases 3 and 4 held; the kernels line gives each kernel's launches on
   whisper's paths.
23. observability (``repro_torch.obs``; run right after phase 6, whose
   weights and tokens it takes): (a) bert-base in its own dtype, batch 48,
   seq 128, unroll 2: OBS_PAIRS_TRAIN (1) pairs of whole arms, each a
   BF16_STEPS-step ``MetaLearner.fit`` from one copy of the state, obs off
   and on (a JSONL sink, the default monitors, the kernels' routing
   mirrored into the default pipeline; the spans are ``phase_profile``'s,
   below, and ``perf/bench_obs.py`` times a traced loop), the order
   alternating: the metrics and the final theta bitwise equal between the
   arms, the launch and route counts equal; what obs costs, counted
   (``perf/obs_cost.py``: the obs arm's calls replayed on a fresh
   pipeline, and the collector's share) over the off arms' median wall,
   at most OBS_LIMIT (1.03), the walls' ratio and each arm's collections
   beside it; the JSONL passes ``report --validate`` (its report text to
   DIR/obs_report.txt); ``phase_profile`` spans every training phase,
   written as a Chrome trace that parses. (b) Phase 6's requests on
   gemma3-1b, whole ``run()`` calls of an untraced and a traced executor
   (an obs ring, the monitors with the SLO burn rate), OBS_PAIRS_SERVE (1)
   pairs, the order alternating: tokens equal between the arms and to
   phase 6's, every request's timeline rebuilt with one terminal event,
   tracing's counted cost over the untraced median wall at most
   OBS_LIMIT; the always-on flight ring's counted cost reported.
   (c) The same requests with ``hang_deadline_s`` 0.5 and
   ``inject_hang(2.5)``: a postmortem bundle in DIR/flight that validates,
   its state the queue, the lanes and the memory, the tokens again equal.
   ``--observability-only N`` runs phase 23 N times after the build and
   phase 6, and prints how many passed.
25. the last modules (run last): (a) each ``kernels.ops`` function and
   ``kernels.ref`` oracle on CUDA tensors at phase 4's shapes, one launch
   per ops call, held at phase 4's tolerances; ``REPRO_KERNEL_BACKEND=plain``
   and ``backend="plain"`` through the registry raise on a CUDA tensor;
   ``kernels.work``'s tile sizes equal ``tc_tiles``. (b) The bf16
   bert-base (B 48, S 128, K 2) and gemma3-1b (B 4, S 1024, all 26
   layers) SAMA steps attributed by phase (``obs.profile``) on the card
   and on ``meta`` tensors: per-phase FLOPs, bytes and matmul FLOPs, the
   kernels' charges and the modules equal number for number, coverage >=
   0.90; per-phase walls (``phase_profile``) and utilization against 989
   TFLOP/s with the card's name and power limit; (d) beside each, the
   roofline's analytic ``step_flops`` and the whole step's share of the
   peak from either count. (c) ``perf/run.py --only
   kernels,attention,attribution`` into DIR/bench, each twin asserting
   parity before its records.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. The weights and data are random, from seeds; nothing is downloaded.
"""

import argparse
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# the card's rates and graph-replay timing, shared with the perf tools
from repro_torch.perf.timers import HBM_BYTES_PER_S, PEAK_OPS_PER_S, graph_ms  # noqa: E402
# phase 23's count of what observability costs
from repro_torch.perf import obs_cost  # noqa: E402


TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SEED = 0
#: The run must end within 1,200 s, and hosts differ: the same phases have
#: run up to 1.6-1.9 times slower on one H100 host than on another. Each
#: phase keeps its checks, depths and requests; repeats are cut where the
#: time goes (PERF.md section 6 lists each cut):
#: the timed bf16 meta steps of phases 8, 10, 18-19, 20(b), 21, 22 and 23's
#: arms (cut from 10, then from 5 to 2 when phase 24 came, then to 1 when
#: phase 25 came)
BF16_STEPS = 1
#: the held f32 step pairs of phases 7, 9, 11, 15(a), 18-19, 20(a), 21, 22
#: and 24(a) (cut from 3, then from 2 when phase 24 came; phase 21 had 2)
F32_PAIRS = 1
#: the attention kernels' launch signatures that phases 3 and 4 held
#: against the plain versions (_decode_sig, _train_sig); phase 20(d) fails
#: if a twin launches one outside them
CHECKED = {"flash_decode": set(), "flash_attention": set()}


def log(*parts):
    print(*parts, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def median_ms(fn, reps=5, iters=10):
    """``time_ms(fn, iters)`` repeated ``reps`` times: (median, min, max)."""
    times = sorted(time_ms(fn, iters) for _ in range(reps))
    return times[reps // 2], times[0], times[-1]


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is false; this "
                         "script runs only on a CUDA card\n")
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    return smi


#: the libraries whose SASS is searched for tensor-core instructions, the
#: kernels in each whose every instantiation (bf16 and f16, each head dim)
#: must hold some, and which: Hopper's warpgroup HGMMA (wgmma) in the
#: forward, HMMA (mma.sync) in dq and dk/dv
MMA_KERNELS = {"flash_attn_fwd": {"fwd_tc_kernel": "HGMMA"},
               "flash_attn_bwd": {"dq_tc_kernel": "HMMA", "dkv_tc_kernel": "HMMA"}}


def _cuda_tool(name):
    found = shutil.which(name) or os.path.join("/usr/local/cuda/bin", name)
    if not os.path.exists(found):
        raise RuntimeError(f"{name} not found: the build phase reads the kernels' SASS with it")
    return found


def _sass_mma_counts(path):
    """{kernel: {"HMMA": n, "HGMMA": n}}, the tensor-core instructions of
    each kernel in a library's SASS (``cuobjdump -sass``), the names
    demangled by ``cu++filt``."""
    sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        text = line.strip()
        if text.startswith("Function :"):
            fn = text.split(":", 1)[1].strip()
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn is not None:
            for op in ("HMMA", "HGMMA"):
                if op in text:
                    counts[fn][op] += 1
    names = subprocess.run([_cuda_tool("cu++filt")], input="\n".join(counts), capture_output=True,
                           text=True, timeout=60, check=True).stdout.splitlines()
    return dict(zip(names, counts.values()))


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    results = build.build_all()
    secs = time.perf_counter() - t0
    per, ptxas = {}, {}
    for name, path, nvcc_out, done in results:
        per[name] = done
        ptxas[name] = []
        log(f"build: {name} -> {os.path.relpath(path, HERE)} ({done:.2f}s)")
        kernel = ""
        for line in nvcc_out.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1][:90] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas: {kernel}: {line.strip()}")
                ptxas[name].append(f"{kernel}: {line.strip()}")
        if name in MMA_KERNELS:
            counts = _sass_mma_counts(path)
            for fn, n in counts.items():
                log(f"  sass: {name}: HMMA {n['HMMA']} HGMMA {n['HGMMA']}: {fn[:120]}")
            for kernel, op in MMA_KERNELS[name].items():
                tc = {fn: n for fn, n in counts.items() if f"{kernel}<" in fn}
                for dtype in ("__nv_bfloat16", "__half"):
                    if not any(f"<{dtype}," in fn for fn in tc):
                        raise AssertionError(f"{name}: no {kernel}<{dtype}, ...> in its SASS")
                for fn, n in tc.items():
                    if n[op] == 0:
                        raise AssertionError(f"{fn}: no {op} instruction in its SASS")
    log(f"build_seconds: {secs:.2f} (all sources at once)")
    return per, ptxas


# ---------------------------------------------------------------------------
# phase 3: the decode kernel
# ---------------------------------------------------------------------------


#: the cache lengths at which phase 21 serves zamba2-7b (page 64, max_len
#: 128: buckets 64 and 128, prompts prefilled into 64 rows) and the timed
#: bucket, 1024
ZAMBA_DECODE_T = (64, 128, 1024)
#: phase 22's decode cache lengths: whisper-small's buckets at page 16 up to
#: its 448-token context (the serial path's cache), the vision model's up
#: to max_len 128 (its serial cache) and 1024 (the timed bucket)
WHISPER_DECODE_T = (16, 32, 64, 128, 256, 448)
VISION_DECODE_T = (16, 32, 64, 128, 1024)
#: (name, KV, G, Dh, cache lengths): the decode layers of zamba2-7b's shared
#: block (G 1, Dh 112: 16 zero-filled columns in the 128-wide tile),
#: whisper-small's decoder (G 1, Dh 64) and llama-3.2-vision-90b's self
#: layers (H 64 over KV 8: G 8, the kernel's largest group, Dh 128), none
#: with a window or softcap
FAMILY_DECODE = [("zamba2-7b", 32, 1, 112, ZAMBA_DECODE_T),
                 ("whisper-small", 12, 1, 64, WHISPER_DECODE_T),
                 ("llama-3.2-vision-90b", 8, 8, 128, VISION_DECODE_T)]


def _decode_inputs(rng, b, t, dtype, dev, kv=1, g=4, dh=256):
    def mk(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
    return mk((b, 1, kv * g, dh)), mk((b, t, kv, dh)), mk((b, t, kv, dh))


def _decode_sig(q, k, local, window, softcap):
    """(B, T, KV, G, Dh, engaged window, softcap, dtype) of a decode launch."""
    b, _, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    return (b, t, kv, h // kv, dh, int(window or 0) if local else 0, float(softcap or 0.0),
            q.dtype)


def _positions(rng, b, t):
    """Per-lane positions < T, covering pos < 512 and pos >= 512 where T
    allows both."""
    if t <= 512:
        return rng.integers(0, t, size=b)
    if b == 1:
        return np.array([t - 1])
    lo = rng.integers(0, 512, size=b)
    hi = rng.integers(512, t, size=b)
    return np.where(np.arange(b) % 2 == 0, lo, hi)


def _vs_f32(flash_attn, got, q, k, v, pos, local, kw, where):
    """A 2-byte kernel output against the plain version in f32 on the same
    inputs. The kernel works in f32 and rounds once when it stores, so
    each element is within half an ulp of its dtype (eps/2 relative) of
    the f32 result, plus the f32 tolerance. Returns the worst element's
    share of that bound (the check fails above 1)."""
    ref = flash_attn.flash_decode(q.float(), k.float(), v.float(), pos, local,
                                  backend="plain", **kw)
    bound = torch.finfo(got.dtype).eps / 2 * ref.abs() + TOL[torch.float32]
    share = ((got.float() - ref).abs() / bound).max().item()
    if not share <= 1.0:
        raise AssertionError(f"flash_decode {got.dtype} vs plain in f32: {share:.3f} of "
                             f"the half-ulp bound at {where}")
    return share


def phase_kernel_check(dev):
    from repro_torch.kernels import flash_attn

    rng = np.random.default_rng(SEED)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_vs_f32 = 0.0  # share of the half-ulp bound, 2-byte dtypes
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 4, 8):
            for t in (16, 128, 1024, 2048):
                q, k, v = _decode_inputs(rng, b, t, dtype, dev)
                pos = torch.from_numpy(_positions(rng, b, t).astype(np.int32)).to(dev)[:, None]
                for local in (True, False):
                    for softcap in (0.0, 50.0):
                        kw = dict(softcap=softcap, window=512)
                        plain = flash_attn.flash_decode(q, k, v, pos, local, backend="plain", **kw)
                        for n_splits in (1, 3, 7, None):
                            got = flash_attn.flash_decode(q, k, v, pos, local,
                                                          n_splits=n_splits, **kw)
                            torch.cuda.synchronize()
                            if got.dtype != dtype or got.shape != q.shape:
                                raise AssertionError(f"flash_decode returned {got.dtype} "
                                                     f"{tuple(got.shape)}")
                            err = (got.float() - plain.float()).abs().max().item()
                            if not math.isfinite(err) or err > TOL[dtype]:
                                raise AssertionError(
                                    f"flash_decode vs plain: err {err:.3e} > {TOL[dtype]} at "
                                    f"dtype={dtype} B={b} T={t} local={local} "
                                    f"softcap={softcap} n_splits={n_splits}")
                            worst[dtype] = max(worst[dtype], err)
                            if dtype != torch.float32:
                                worst_vs_f32 = max(worst_vs_f32, _vs_f32(
                                    flash_attn, got, q, k, v, pos, local, kw,
                                    f"B={b} T={t} local={local} softcap={softcap} "
                                    f"n_splits={n_splits}"))
                            n += 1
                        CHECKED["flash_decode"].add(_decode_sig(q, k, local, **kw))
    # the kernel's other group sizes, head dims and f16, beyond gemma3-1b
    for kv, g, dh, dtype in [(2, 1, 64, torch.float32), (2, 2, 128, torch.float32),
                             (1, 3, 64, torch.float32), (2, 8, 256, torch.float32),
                             (2, 2, 128, torch.float16), (1, 8, 64, torch.bfloat16)]:
        q, k, v = _decode_inputs(rng, 3, 300, dtype, dev, kv, g, dh)
        pos = torch.tensor([[299], [100], [0]], dtype=torch.int32, device=dev)
        kw = dict(window=64, softcap=30.0)
        plain = flash_attn.flash_decode(q, k, v, pos, True, backend="plain", **kw)
        got = flash_attn.flash_decode(q, k, v, pos, True, **kw)
        err = (got.float() - plain.float()).abs().max().item()
        if not err <= TOL.get(dtype, 2e-2):
            raise AssertionError(f"flash_decode vs plain: err {err:.3e} at KV={kv} G={g} "
                                 f"Dh={dh} {dtype}")
        if dtype != torch.float32:
            worst_vs_f32 = max(worst_vs_f32, _vs_f32(flash_attn, got, q, k, v, pos, True,
                                                     kw, f"KV={kv} G={g} Dh={dh}"))
        CHECKED["flash_decode"].add(_decode_sig(q, k, True, **kw))
        n += 1
    # qwen2-moe-a2.7b's decode layer (H 16 over KV 16, G 1, Dh 128, no
    # window or softcap) at its serving shape
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 4):
            q, k, v = _decode_inputs(rng, b, 1024, dtype, dev, kv=16, g=1, dh=128)
            pos = torch.from_numpy(_positions(rng, b, 1024).astype(np.int32)).to(dev)[:, None]
            plain = flash_attn.flash_decode(q, k, v, pos, False, backend="plain")
            for n_splits in (1, 4, None):
                got = flash_attn.flash_decode(q, k, v, pos, False, n_splits=n_splits)
                err = (got.float() - plain.float()).abs().max().item()
                if not err <= TOL[dtype]:
                    raise AssertionError(f"flash_decode vs plain: err {err:.3e} at the "
                                         f"qwen2-moe layer B={b} {dtype} n_splits={n_splits}")
                worst[dtype] = max(worst[dtype], err)
                if dtype != torch.float32:
                    worst_vs_f32 = max(worst_vs_f32, _vs_f32(
                        flash_attn, got, q, k, v, pos, False, {},
                        f"qwen2-moe B={b} n_splits={n_splits}"))
                n += 1
            CHECKED["flash_decode"].add(_decode_sig(q, k, False, 0, 0.0))
    # the decode layers of FAMILY_DECODE at the batches and cache lengths
    # phases 21-22 serve them at (B 1 for the serial path, 4 slots), against
    # the plain version in f32 on the same inputs, as phase 4 holds the bf16
    # training kernels: the bf16 plain version rounds the scores and
    # probabilities as it goes, and its own distance from the f32 one is
    # printed, not held
    plain16_err = {}
    for fam, kv, g, dh, ts in FAMILY_DECODE:
        plain16_err[fam] = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            for b in (1, 4):
                for t in ts:
                    q, k, v = _decode_inputs(rng, b, t, dtype, dev, kv=kv, g=g, dh=dh)
                    pos = torch.from_numpy(_positions(rng, b, t).astype(np.int32)).to(
                        dev)[:, None]
                    plain = flash_attn.flash_decode(q.float(), k.float(), v.float(), pos,
                                                    False, backend="plain")
                    if dtype != torch.float32:
                        plain16 = flash_attn.flash_decode(q, k, v, pos, False, backend="plain")
                        plain16_err[fam] = max(plain16_err[fam],
                                               (plain16.float() - plain).abs().max().item())
                    for n_splits in (1, None):
                        got = flash_attn.flash_decode(q, k, v, pos, False, n_splits=n_splits)
                        err = (got.float() - plain).abs().max().item()
                        if not err <= TOL[dtype]:
                            raise AssertionError(
                                f"flash_decode vs plain in f32: err {err:.3e} at the {fam} "
                                f"layer B={b} T={t} {dtype} n_splits={n_splits}")
                        worst[dtype] = max(worst[dtype], err)
                        if dtype != torch.float32:
                            worst_vs_f32 = max(worst_vs_f32, _vs_f32(
                                flash_attn, got, q, k, v, pos, False, {},
                                f"{fam} B={b} T={t} n_splits={n_splits}"))
                        n += 1
                    CHECKED["flash_decode"].add(_decode_sig(q, k, False, 0, 0.0))
    # the serving twin's decode layers (perf/bench_serve.py: gemma3-1b smoke,
    # H 2 over KV 1, G 2, Dh 64, window 8 on the local layer, no softcap) at
    # its batches and bucketed cache lengths
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 8):
            for t in (16, 32):
                q, k, v = _decode_inputs(rng, b, t, dtype, dev, kv=1, g=2, dh=64)
                pos = torch.from_numpy(_positions(rng, b, t).astype(np.int32)).to(dev)[:, None]
                for local in (True, False):
                    kw = dict(window=8, softcap=0.0)
                    plain = flash_attn.flash_decode(q, k, v, pos, local, backend="plain", **kw)
                    for n_splits in (1, 2, None):
                        got = flash_attn.flash_decode(q, k, v, pos, local, n_splits=n_splits,
                                                      **kw)
                        err = (got.float() - plain.float()).abs().max().item()
                        if not err <= TOL[dtype]:
                            raise AssertionError(
                                f"flash_decode vs plain: err {err:.3e} at the serving twin's "
                                f"layer B={b} T={t} local={local} {dtype} n_splits={n_splits}")
                        worst[dtype] = max(worst[dtype], err)
                        if dtype != torch.float32:
                            worst_vs_f32 = max(worst_vs_f32, _vs_f32(
                                flash_attn, got, q, k, v, pos, local, kw,
                                f"serving twin B={b} T={t} local={local} n_splits={n_splits}"))
                        n += 1
                    CHECKED["flash_decode"].add(_decode_sig(q, k, local, **kw))
    # the blocks' shares of the visible rows, by the library's own
    # arithmetic, are the ones the CPU tests hold (flash_attn.decode_shares)
    n_shares = 0
    for t, pos, window in zip(rng.integers(1, 4096, 300), rng.integers(0, 5000, 300),
                              rng.integers(0, 1024, 300)):
        for cluster in (1, 3, 7, 8, 16):
            args = (int(pos), int(t), int(window), cluster)
            if flash_attn.decode_kernel_shares(*args) != flash_attn.decode_shares(*args):
                raise AssertionError(f"flash_decode: the library's shares differ from "
                                     f"decode_shares at (pos, T, window, cluster)={args}")
            n_shares += 1
    log(f"kernel_check: flash_decode block shares equal decode_shares in {n_shares} cases")
    log(f"kernel_check: flash_decode at the zamba2-7b, whisper-small and "
        f"llama-3.2-vision-90b layers held against the plain version in f32; the bf16 plain "
        f"version's own max |err| from it {json.dumps(plain16_err)} (not held)")
    log(f"kernel_check: flash_decode vs plain, {n} cases, max_err_f32="
        f"{worst[torch.float32]:.3e} (tol 1e-5), max_err_bf16="
        f"{worst[torch.bfloat16]:.3e} (tol 2e-2); 2-byte dtypes vs plain in f32 "
        f"within {worst_vs_f32:.3f} of the eps/2 relative + 1e-5 bound")
    return worst, worst_vs_f32


#: the buckets of ``decode_time.CASES`` that phase 3 times the layers at: 64
#: (the launch floor) and 1024 (256 and 512 cut for the run's time limit)
DECODE_BUCKETS = (64, 1024)


def phase_kernel_time(dev, cfg, slots, t):
    """One pass over the model's layers (5:1 local:global, each layer its
    own cache, 26 x 4 MB > the 50 MB L2) at the serving shape; then the
    local and the global layer apart at buckets 64 to 1024 in bf16 and
    1024 in f32, each beside SDPA and its bound, and the 1024 bucket under
    several cluster sizes (``repro_torch.perf.decode_time``). Every pass
    must launch one kernel per layer, by the profiler's count."""
    from repro_torch.kernels import flash_attn
    from repro_torch.perf import decode_time

    dtype = torch.bfloat16
    kv, dh = cfg.num_kv_heads, cfg.head_dim
    out = decode_time.time_case(flash_attn, cfg, dev, cfg.layer_kinds, t, dtype, slots=slots,
                                seed=SEED + 1)
    log(f"kernel_time: flash_decode per layer at B={slots} T={t} bf16: kernel_ms="
        f"{out['ms']:.4f} (repeat {out['ms_repeat']:.4f}, eager {out['ms_eager']:.4f}) "
        f"plain_ms={out['plain_ms']:.4f} library_ms={out['library_ms']:.4f} "
        f"bound_ms={out['bound_ms']:.5f} ({out['bound_by']}) "
        f"launches_per_layer={out['launches_per_layer']}")
    torch.cuda.empty_cache()
    out["by_case"] = []
    for kind, bucket, dt in (c for c in decode_time.CASES if c[1] in DECODE_BUCKETS):
        splits = decode_time.SPLITS if (bucket == t and dt == dtype) else ()
        case = decode_time.time_case(flash_attn, cfg, dev, kind, bucket, dt, slots=slots,
                                     seed=SEED + 5, splits=splits)
        log(f"kernel_time: flash_decode {kind} layer B={slots} T={bucket} {case['dtype']}: "
            f"kernel_ms={case['ms']:.5f} (repeat {case['ms_repeat']:.5f}) "
            f"plain_ms={case['plain_ms']:.5f} library_ms={case['library_ms']:.5f} "
            f"bound_ms={case['bound_ms']:.5f} ({case['bound_by']}) "
            f"launches_per_layer={case['launches_per_layer']}"
            + (f" by cluster size {json.dumps(case['ms_by_splits'])}" if splits else ""))
        out["by_case"].append(case)
        torch.cuda.empty_cache()
    # whole launches per call: the profiler has been seen to drop one event
    # of a pass (51 of 52 launches once), never to add one
    out["kernels_per_call"] = round(out["launches_per_layer"])
    for case in [out] + out["by_case"]:
        _one_launch_per_call(case, f"{case['kind']} T={case['T']} {case['dtype']}")
    limit = flash_attn.decode_max_cluster(dh, dtype)
    out["cluster"] = {"global": flash_attn.decode_cluster(t, slots * kv, max_cluster=limit),
                      "local": flash_attn.decode_cluster(min(t, cfg.sliding_window), slots * kv,
                                                         max_cluster=limit),
                      "card_limit": limit}
    log(f"kernel_time: flash_decode cluster sizes at B={slots} T={t}: {out['cluster']}")
    return out


def phase_family_decode_time(dev, cfg, slots=4, t=1024, layers=None):
    """flash_decode per layer of a model whose layers are all global
    (qwen2-moe-a2.7b: H 16 over KV 16, G 1, Dh 128, over 26 layers;
    zamba2-7b: H 32 over KV 32, G 1, Dh 112, over its shared block's 13
    uses; whisper-small: H 12 over KV 12, G 1, Dh 64, over its 12 decoder
    layers at T 448; llama-3.2-vision-90b: H 64 over KV 8, G 8, Dh 128,
    over the 8 self layers of phase 22's 10) at bucket ``t``, bf16, beside
    the plain version, SDPA and the bound (``decode_time.time_case``); one
    launch per call."""
    from repro_torch.kernels import flash_attn
    from repro_torch.perf import decode_time

    kinds = "global" if layers is None else ["global"] * layers
    out = decode_time.time_case(flash_attn, cfg, dev, kinds, t, torch.bfloat16, slots=slots,
                                seed=SEED + 6)
    out["cluster"] = flash_attn.decode_cluster(
        t, slots * cfg.num_kv_heads,
        max_cluster=flash_attn.decode_max_cluster(cfg.head_dim, torch.bfloat16))
    log(f"kernel_time: flash_decode per {cfg.name} layer at B={slots} T={t} bf16: kernel_ms="
        f"{out['ms']:.5f} (repeat {out['ms_repeat']:.5f}, eager {out['ms_eager']:.5f}) "
        f"plain_ms={out['plain_ms']:.5f} library_ms={out['library_ms']:.5f} "
        f"bound_ms={out['bound_ms']:.5f} ({out['bound_by']}) cluster={out['cluster']} "
        f"launches_per_layer={out['launches_per_layer']}")
    _one_launch_per_call(out, f"the {cfg.name} layer")
    return out


def _one_launch_per_call(case, where):
    """Fails unless ``decode_time.time_case``'s pass made one wrapper call
    per layer and the profiler saw one kernel launch per call."""
    if case["calls_per_layer"] != 1 or round(case["launches_per_layer"]) != 1:
        raise AssertionError(f"flash_decode: {case['launches_per_layer']} kernel launches and "
                             f"{case['calls_per_layer']} wrapper calls per layer at {where}, "
                             "not 1")


# ---------------------------------------------------------------------------
# phases 5-6: serving
# ---------------------------------------------------------------------------


def _requests(cfg, n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n)
    return [rng.integers(0, cfg.vocab_size, size=(int(L),)).astype(np.int64) for L in lens]


def _serve(model, params, prompts, gen, scfg):
    """The executor over ``prompts``; every request ``ok`` with ``gen``
    tokens in the vocabulary, and the flash_decode launches held to one per
    attention layer per decode step and, where prefill is the token scan
    (the recurrent families), per prompt token."""
    from repro_torch import serve
    from repro_torch.kernels import dispatch
    from repro_torch.serve import prefill

    ex = serve.ServeExecutor(model, params, scfg)
    ids = [ex.submit(p, max_new_tokens=gen) for p in prompts]
    torch.cuda.synchronize()
    dispatch.reset_launches()  # counts of the main path's run only
    t0 = time.perf_counter()
    stats = ex.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dispatch.launches("flash_decode")
    statuses = [ex.results[i].status for i in ids]
    if statuses != [serve.STATUS_OK] * len(ids):
        raise AssertionError(f"serve statuses {statuses}: every request must be 'ok'")
    for i in ids:
        toks = ex.results[i].tokens
        if len(toks) != gen or not all(0 <= x < model.cfg.vocab_size for x in toks):
            raise AssertionError(f"request {i}: {len(toks)} tokens, expected {gen} in vocab")
    scanned = (sum(len(p) for p in prompts)
               if prefill.default_mode(model.cfg) == "scan" else 0)
    if launches != _gqa_layers(model.cfg) * (stats.steps + scanned):
        raise AssertionError(f"flash_decode launches {launches} != {_gqa_layers(model.cfg)} "
                             f"GQA layers x ({stats.steps} decode steps + {scanned} scanned "
                             "prompt tokens)")
    return ex, ids, stats, launches, wall


def _gqa_layers(cfg):
    """Attention layers (uses of one, for zamba2's shared block) whose
    decode is the flash_decode kernel: every layer but MLA's (plain ops in
    both packages); none in rwkv6; zamba2's n_groups applications of its
    shared block; whisper's decoder layers; the vision model's self layers
    (its cross-attention is plain ops in both packages)."""
    if cfg.family == "ssm" or cfg.use_mla:
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every
    if cfg.family == "vlm":
        return cfg.num_layers - cfg.num_layers // cfg.cross_attn_every
    return cfg.num_layers


def _train_attn_layers(cfg):
    """Layers whose training attention is the flash kernels: the decoding
    ones (``_gqa_layers``) and whisper's bidirectional encoder layers."""
    return _gqa_layers(cfg) + (cfg.encoder_layers if cfg.family == "audio" else 0)


#: phase 5's requests: (count, shortest, longest prompt, gen, page, max_len)
SERVE_F32 = (8, 300, 900, 16, 16, 1024)
#: phase 6's (cut from 16 for the run's time limit)
SERVE_BF16 = (8, 256, 960, 32, 16, 1024)
#: phases 18-19's bf16 requests: the 4 slots full (cut from 8 for the run's
#: time limit; their f32 requests are SERVE_F32's, twice the slots)
FAMILY_SERVE_BF16 = (4, 256, 960, 32, 16, 1024)


def phase_serve_f32(base_cfg, params, dev, tag="serve_f32", sizes=SERVE_F32):
    from repro_torch import serve
    from repro_torch.models import Model

    cfg = base_cfg.replace(dtype="float32")
    model = Model(cfg, device=dev)
    n, lo, hi, gen, page, max_len = sizes
    prompts = _requests(cfg, n, lo, hi, SEED + 2)
    scfg = serve.ServeConfig(slots=4, page_size=page, max_len=max_len, max_new_tokens=gen)
    ex, ids, stats, launches, wall = _serve(model, params, prompts, gen, scfg)
    for i, p in zip(ids, prompts):
        ref = serve.greedy_generate(model, params, torch.as_tensor(p)[None], gen, max_len)
        ref = [int(x) for x in ref[0].cpu()]
        if ex.results[i].tokens != ref:
            raise AssertionError(f"f32 request {i}: continuous {ex.results[i].tokens} "
                                 f"!= serial {ref}")
    log(f"{tag}: {len(ids)} requests ok, tokens equal to serial greedy_generate "
        f"for all; decode_steps={stats.steps} flash_decode_launches={launches} "
        f"wall_s={wall:.3f}")
    return {"requests": len(ids), "decode_steps": stats.steps, "flash_decode_launches": launches,
            "wall_s": wall, "prompt_tokens": sum(len(p) for p in prompts)}


def phase_serve_bf16(cfg, params, dev, out_dir, tag="serve_bf16", sizes=SERVE_BF16):
    from repro_torch import serve
    from repro_torch.models import Model

    model = Model(cfg, device=dev)
    n, lo, hi, gen, page, max_len = sizes
    prompts = _requests(cfg, n, lo, hi, SEED + 3)
    scfg = serve.ServeConfig(slots=4, page_size=page, max_len=max_len, max_new_tokens=gen)
    torch.cuda.reset_peak_memory_stats()
    ex, ids, stats, launches, wall = _serve(model, params, prompts, gen, scfg)
    peak = torch.cuda.max_memory_allocated()
    result = {
        "requests": len(ids), "qps": stats.qps, "wall_s": wall,
        "ttft_p50_ms": stats.ttft.p50_us / 1e3, "ttft_p99_ms": stats.ttft.p99_us / 1e3,
        "tpot_p50_ms": stats.tpot.p50_us / 1e3, "tpot_p99_ms": stats.tpot.p99_us / 1e3,
        "decode_steps": stats.steps, "flash_decode_launches": launches,
        "prompt_tokens": sum(len(p) for p in prompts), "max_memory_allocated": peak,
    }
    # phase 23 holds its arms' tokens to these
    result["tokens_sha256"] = _tokens_digest([ex.results[i].tokens for i in ids])
    log(f"{tag}: " + json.dumps(result))
    result["step_profile"] = profile_step(model, params, scfg, prompts[:4], out_dir,
                                          "decode_step" if tag == "serve_bf16" else tag)
    return result, launches


def _tokens_digest(tokens):
    return hashlib.sha256(json.dumps(tokens).encode()).hexdigest()


# ---------------------------------------------------------------------------
# phase 23: observability
# ---------------------------------------------------------------------------

#: pairs of whole arms, obs off and on, the order alternating. Their walls
#: are reported, not held: on the card's shared hosts the arms' median
#: walls differ by -8% to +8% (training) and -14% to +13% (serving) from
#: run to run while obs costs ~0.1%, so what obs costs is counted
#: (``perf/obs_cost.py``) and held (training's pairs cut from 2 to 1 when
#: phase 25 came)
OBS_PAIRS_TRAIN = 1
OBS_PAIRS_SERVE = 1
#: the reference's bound: obs costs at most 3% of the median wall time
OBS_LIMIT = obs_cost.LIMIT


def _obs_train(cfg, dev, out_dir, batch=48, seq=128, unroll=2, steps=BF16_STEPS):
    """23(a): bert-base bf16 ``fit`` with obs off and on from one state,
    whole arms by turns; obs's counted cost held to OBS_LIMIT."""
    from repro_torch import data, obs, optim, tree
    from repro_torch.kernels import dispatch
    from repro_torch.models import Model
    from repro_torch.obs import report

    model = Model(cfg, device=dev)
    train, meta = _wrench(cfg, seq, 1024, 256, SEED + 230)
    learner = _learner(model, dev, unroll, optim.adam(1e-3))
    it = data.BatchIterator(train, meta, batch_size=batch, meta_batch_size=batch,
                            unroll=unroll, seed=SEED + 231, device=dev)
    batches = [next(it) for _ in range(steps)]
    state0 = learner.state
    learner.step(*batches[0])  # warm
    log_path = os.path.join(out_dir, "obs_train.jsonl")
    replay_path = os.path.join(out_dir, "obs_train_replay.jsonl")
    if os.path.exists(replay_path):
        os.remove(replay_path)

    def arm(on):
        """One arm: ``steps`` steps of ``fit`` from state0; with ``on``, a
        fresh JSONL log of its own (the last one's is kept)."""
        o = None
        if on:
            if os.path.exists(log_path):
                os.remove(log_path)
            o = obs.Obs(sink=obs.JsonlSink(log_path), run_id="chip_smoke_23a")
        learner.state = state0
        dispatch.reset_launches()
        obs.set_default(o)
        try:
            history = learner.fit(iter(batches), steps, log_every=1, obs=o)
        finally:
            obs.set_default(None)
        if o is not None:
            o.close()
        return {"obs": o, "history": history, "theta": tree.tree_leaves(learner.state.theta),
                "launches": dispatch.launch_counts(), "routes": dispatch.route_counts()}

    walls, meters, results = obs_cost.paired_arms(
        {"off": lambda: arm(False), "on": lambda: arm(True)}, OBS_PAIRS_TRAIN,
        sync=torch.cuda.synchronize)
    walls = {a: [w * 1e3 for w in ws] for a, ws in walls.items()}
    for outs in results:
        off, on = outs["off"], outs["on"]
        if on["history"] != off["history"]:
            raise AssertionError(f"23(a): metrics differ: {on['history']} != {off['history']}")
        if not all(torch.equal(a, b) for a, b in zip(on["theta"], off["theta"])):
            raise AssertionError("23(a): final theta not bitwise equal with obs on and off")
        if (on["launches"], on["routes"]) != (off["launches"], off["routes"]):
            raise AssertionError(f"23(a): launches {on['launches']} routes {on['routes']} "
                                 f"!= {off['launches']} {off['routes']}")
    on_obs, on_events = results[-1]["on"]["obs"], list(obs.read_jsonl(log_path))
    cost = obs_cost.train_cost(
        on_obs, on_events,
        lambda: obs.Obs(sink=obs.JsonlSink(replay_path), run_id="chip_smoke_23a"),
        float(np.median(walls["off"])) / 1e3, read_back=lambda o: obs.read_jsonl(o.sink.path))
    os.remove(replay_path)

    o = obs.Obs(sink=obs.JsonlSink(log_path), run_id="chip_smoke_23a")
    learner.obs = o
    learner.state = state0
    spans = learner.phase_profile(*batches[0])
    learner.obs = obs.NULL_OBS
    o.close()
    missing = set(PHASES) - {s.name for s in spans}
    if missing:
        raise AssertionError(f"23(a) phase_profile: no span for {sorted(missing)}")
    trace_path = obs.write_chrome_trace(os.path.join(out_dir, "obs_phase_profile.json"), spans)
    with open(trace_path) as f:
        n_trace = len(json.load(f)["traceEvents"])
    with open(os.path.join(out_dir, "obs_report.txt"), "w") as f, \
            contextlib.redirect_stdout(f):
        rc = report.main([log_path, "--validate"])
    events = list(obs.read_jsonl(log_path))
    if rc != 0 or obs.validate_jsonl(log_path):
        raise AssertionError(f"23(a): {log_path} fails report --validate")
    result = {"pairs": OBS_PAIRS_TRAIN, "steps": steps, "wall_ms_off": walls["off"],
              "wall_ms_on": walls["on"],
              "wall_ratio": float(np.median(walls["on"]) / np.median(walls["off"])),
              "collections": {a: m.as_dict() for a, m in meters.items()},
              "overhead_ratio": cost["ratio"], "limit": OBS_LIMIT, "counted": cost,
              "launches": off["launches"], "jsonl_events": len(events),
              "event_kinds": sorted({e.kind for e in events}),
              "phase_profile_ms": {s.name: s.dur_s * 1e3 for s in spans},
              "chrome_trace_events": n_trace}
    log("obs_train: " + json.dumps(result))
    if cost["ratio"] > OBS_LIMIT:
        raise AssertionError(f"23(a): obs costs {100 * (cost['ratio'] - 1):.3f}% of the wall, "
                             f"over {100 * (OBS_LIMIT - 1):.0f}%")
    return result


def _obs_serve(cfg, params, dev, out_dir, phase6_digest, sizes=SERVE_BF16):
    """23(b-c): phase 6's requests untraced and traced, then under the hang
    watchdog with an injected stall."""
    from repro_torch import obs, serve
    from repro_torch.models import Model
    from repro_torch.obs import flight, report

    model = Model(cfg, device=dev)
    n, lo, hi, gen, page, max_len = sizes
    prompts = _requests(cfg, n, lo, hi, SEED + 3)
    scfg = serve.ServeConfig(slots=4, page_size=page, max_len=max_len, max_new_tokens=gen)

    def traced_obs():
        return obs.make_obs(ring=16384, slo_budget=0.25)

    def executor(o, **knobs):
        ex = serve.ServeExecutor(model, params, dataclasses.replace(scfg, **knobs), obs=o)
        ids = [ex.submit(p, max_new_tokens=gen) for p in prompts]
        return ex, ids

    def arm(traced):
        """One arm: a fresh executor (traced: with a fresh pipeline) and a
        whole ``run()``; its tokens, pipeline, flight ring and stats."""
        o = traced_obs() if traced else None
        ex, ids = executor(o)
        ex.run()
        return {"tokens": [ex.results[i].tokens for i in ids],
                "statuses": [ex.results[i].status for i in ids],
                "obs": o, "flight": ex.flight, "stats": ex.stats()}

    walls, meters, results = obs_cost.paired_arms(
        {"untraced": lambda: arm(False), "traced": lambda: arm(True)}, OBS_PAIRS_SERVE,
        sync=torch.cuda.synchronize)
    walls = {a: [w * 1e3 for w in ws] for a, ws in walls.items()}
    for outs in results:
        for a, out in outs.items():
            if out["statuses"] != [serve.STATUS_OK] * n:
                raise AssertionError(f"23 {a}: statuses {out['statuses']}")
            if _tokens_digest(out["tokens"]) != phase6_digest:
                raise AssertionError(f"23 {a}: tokens differ from phase 6's")
        events = outs["traced"]["obs"].sink.events()
        errors = report.validate_timelines(events)
        timelines = report.serve_timelines(events)
        terminals = [sum(e.name in report.TERMINAL_NAMES for e in evs)
                     for evs in timelines.values()]
        if errors or len(timelines) != n or terminals != [1] * n:
            raise AssertionError(f"23(b): {len(timelines)} timelines, terminals {terminals}, "
                                 f"errors {errors[:3]}")
    ref_tokens = results[-1]["untraced"]["tokens"]
    last = results[-1]["traced"]
    traced_out = {"events": len(events), "health": last["obs"].health.status,
                  "ttft_p50_ms": last["stats"].ttft.p50_us / 1e3,
                  "tpot_p50_ms": last["stats"].tpot.p50_us / 1e3}
    cost = obs_cost.serve_cost(last["obs"], last["flight"], traced_obs,
                               float(np.median(walls["untraced"])) / 1e3,
                               flight_capacity=scfg.flight_capacity,
                               snapshot_every=scfg.flight_snapshot_every)
    ratio = cost["traced"]["ratio"]
    result = {"pairs": OBS_PAIRS_SERVE, "requests": n, "wall_ms_untraced": walls["untraced"],
              "wall_ms_traced": walls["traced"],
              "wall_ratio": float(np.median(walls["traced"]) / np.median(walls["untraced"])),
              "collections": {a: m.as_dict() for a, m in meters.items()},
              "overhead_ratio": ratio, "limit": OBS_LIMIT, "counted": cost["traced"],
              "flight_ring_counted": cost["flight"], **traced_out}
    log("obs_serve: " + json.dumps(result))
    if ratio > OBS_LIMIT:
        raise AssertionError(f"23(b): tracing costs {100 * (ratio - 1):.3f}% of the wall, "
                             f"over {100 * (OBS_LIMIT - 1):.0f}%")

    flight_dir = os.path.join(out_dir, "flight")
    shutil.rmtree(flight_dir, ignore_errors=True)
    ex, ids = executor(None, flight_dir=flight_dir, hang_deadline_s=0.5)
    ex.inject_hang(2.5)
    t0 = time.perf_counter()
    ex.run()
    wall = time.perf_counter() - t0
    if [ex.results[i].tokens for i in ids] != ref_tokens:
        raise AssertionError("23(c): tokens differ from the untraced arm's")
    if not ex.flight.dumps:
        raise AssertionError("23(c): the hang watchdog wrote no bundle")
    bundles = []
    for path in ex.flight.dumps:
        b = flight.load_bundle(path)
        errors = flight.validate_bundle(b)
        if errors or not {"queue", "lanes", "memory"} <= set(b["state"]):
            raise AssertionError(f"23(c) {path}: {errors} state {sorted(b['state'])}")
        bundles.append({"path": os.path.relpath(path, out_dir),
                        "trigger": b["trigger"]["reason"], "events": len(b["events"]),
                        "live_lanes": len(b["state"]["lanes"]),
                        "device_allocated_bytes":
                            b["state"]["memory"].get("device_allocated_bytes")})
    hang = {"wall_s": wall, "bundles": bundles}
    log("obs_hang: " + json.dumps(hang))
    result["hang"] = hang
    return result


def phase_observability(train_cfg, serve_cfg, params, dev, out_dir, phase6_digest):
    """Phase 23: (a) on ``train_cfg`` (bert-base), (b-c) on ``serve_cfg``
    (gemma3-1b) with phase 6's weights, held to phase 6's tokens."""
    t0 = time.perf_counter()
    out = {"train": _obs_train(train_cfg, dev, out_dir)}
    torch.cuda.empty_cache()
    out["serve"] = _obs_serve(serve_cfg, params, dev, out_dir, phase6_digest)
    out["seconds"] = time.perf_counter() - t0
    return out


def profile_step(model, params, scfg, prompts, out_dir, name="decode_step"):
    """A torch.profiler trace of one fused decode step with four live lanes
    (launches here are outside the counted run), written to
    DIR/{name}_trace.json; one flash_decode launch per call, none for MLA."""

    from repro_torch.perf import decode_time
    from repro_torch.serve import ContinuousBatcher, Request

    b = ContinuousBatcher(model, params, scfg)
    for i, p in enumerate(prompts):
        b.admit(Request(id=i, payload={"prompt": p, "max_new_tokens": 64}, submit_t=0.0), 0.0)
    for _ in range(3):  # warm
        b.harvest(b.dispatch())
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):  # the step as the executor runs it, profiler off
        t0 = time.perf_counter()
        b.harvest(b.dispatch())
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = []

    def step():
        t0 = time.perf_counter()
        b.harvest(b.dispatch())
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    # one step profiled; again, up to twice, where the profiler recorded
    # fewer decode launches than the wrapper counted (decode_time)
    prof, calls, _ = decode_time.counted_profile(step, cpu=True)
    wall_ms = wall[-1]
    # device kernels and copies: aten:: rows repeat their kernels' time,
    # and the runtime's own rows (cudaLaunchKernel, Activity Buffer
    # Request) are host calls, not kernels (1,961 cudaLaunchKernel counts
    # in one step once, with 12 us of device time); a model range (SPANS)
    # repeats its kernels' time, as aten:: rows do
    rows = [(e.key, decode_time.device_us(e), e.count) for e in prof.key_averages()
            if decode_time.device_us(e) > 0
            and not e.key.startswith(("aten::", "cuda", "Activity Buffer"))
            and e.key not in SPANS]
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    rows.sort(key=lambda r: -r[1])
    total_dev_ms = sum(r[1] for r in rows) / 1e3
    with open(os.path.join(out_dir, f"{name}_kernels.txt"), "w") as f:
        for key, us, count in rows:
            f.write(f"{us:12.1f} us  {count:5d}x  {key}\n")
    top = [{"name": k[:80], "us": round(us, 1), "count": c} for k, us, c in rows[:12]]
    step_ms = float(np.median(walls))
    decode_rows = [(us, c) for k, us, c in rows if "decode_kernel" in k]
    decode_ms = sum(us for us, _ in decode_rows) / 1e3
    prof_out = {"step_wall_ms": step_ms, "step_wall_ms_all": walls,
                "profiled_wall_ms": wall_ms, "device_ms": total_dev_ms,
                "device_busy_share": total_dev_ms / step_ms,
                "kernel_launches": sum(c for _, _, c in rows),
                "flash_decode_ms": decode_ms,
                "flash_decode_calls": calls,
                "flash_decode_launches": sum(c for _, c in decode_rows),
                "flash_decode_share_of_device": decode_ms / total_dev_ms, "top": top}
    log(("step_profile: " if name == "decode_step" else f"{name}_step_profile: ")
        + json.dumps(prof_out))
    if calls != _gqa_layers(model.cfg) or (
            calls and round(prof_out["flash_decode_launches"] / calls) != 1):
        raise AssertionError(f"flash_decode: {prof_out['flash_decode_launches']} kernel "
                             f"launches in the profiled step for {calls} calls, not one each "
                             f"of {_gqa_layers(model.cfg)}")
    return prof_out


# ---------------------------------------------------------------------------
# phase 4: the training kernels
# ---------------------------------------------------------------------------

#: (name, B, S, T, KV, G, Dh, causal, window, softcap, padded): bert-base's
#: layer, a gemma-like training shape with ragged S and T, gemma3-1b's full
#: local and global layers, padding (keys 64-191 and lane 1's queries 32-95
#: at position -1: whole key and query tiles of both kernels),
#: qwen2-moe-a2.7b's layer (G 1, Dh 128), and the paper-bench twins' layers
#: (perf/bench_*.py), each half of a 64-key tile at Dh 64: mini-BERT at
#: widths 128, 256, 384 (H 2, 4, 6 over as many KV heads, non-causal) at
#: its training and evaluation batches, and gemma3-1b's smoke layers (H 2
#: over KV 1, window 8 on the local one) at bench_cont_pretrain's batches;
#: zamba2-7b's shared attention block (G 1, Dh 112: the 128-wide tiles
#: zero-fill 16 columns) at phase 21's batches (4, and 2: the f32 pairs and
#: the meta batch), and at ragged S and T (partial tiles on both sides);
#: whisper-small's encoder (H 12, G 1, Dh 64, non-causal over its 1,500
#: frames: a partial last 64-key tile) and decoder (causal, S 448) at phase
#: 22's batches (8 and the meta batch 4 in bf16, 2 in the f32 pairs), and
#: llama-3.2-vision-90b's self layer (H 64 over KV 8: G 8, Dh 128) at phase
#: 22's forward
TRAIN_SHAPES = [
    ("bert-base", 48, 128, 128, 12, 1, 64, False, 0, 0.0, False),
    ("gemma-like", 2, 300, 333, 1, 4, 256, True, 128, 50.0, False),
    ("gemma3-1b local", 4, 1024, 1024, 1, 4, 256, True, 512, 0.0, False),
    ("gemma3-1b global", 4, 1024, 1024, 1, 4, 256, True, 0, 0.0, False),
    ("padded", 2, 170, 250, 1, 4, 128, True, 0, 0.0, True),
    ("qwen2-moe-a2.7b", 4, 1024, 1024, 16, 1, 128, True, 0, 0.0, False),
    *((f"mini-bert H{kv} B{b}", b, 32, 32, kv, 1, 64, False, 0, 0.0, False)
      for kv, b in ((2, 16), (2, 32), (2, 128), (4, 16), (6, 16))),
    *((f"gemma3-1b smoke {tag} B{b}", b, 32, 32, 1, 2, 64, True, window, 0.0, False)
      for tag, window in (("local", 8), ("global", 0)) for b in (16, 64, 128)),
    ("zamba2-7b", 4, 1024, 1024, 32, 1, 112, True, 0, 0.0, False),
    ("zamba2-7b B2", 2, 1024, 1024, 32, 1, 112, True, 0, 0.0, False),
    ("zamba2-like ragged", 2, 300, 333, 4, 1, 112, True, 0, 0.0, False),
    *((f"whisper-small encoder B{b}", b, 1500, 1500, 12, 1, 64, False, 0, 0.0, False)
      for b in (8, 4, 2)),
    *((f"whisper-small decoder B{b}", b, 448, 448, 12, 1, 64, True, 0, 0.0, False)
      for b in (8, 4, 2)),
    ("llama-3.2-vision-90b", 4, 1024, 1024, 8, 8, 128, True, 0, 0.0, False),
]
#: the plain forward drops padded keys on its chunked path only (make_mask
#: keeps them, as the JAX reference's does): the padded shape runs it chunked
PADDED_CHUNK = 64
#: (atol, rtol) per dtype: forward, gradients (tests/test_flash_attention.py)
ATTN_TOL = {torch.float32: ((1e-5, 0.0), (5e-5, 1e-4)),
            torch.bfloat16: ((2e-2, 2e-2), (2e-2, 2e-2))}
#: bert-base's embedding, its stacked MLP leaf, a ragged size, and
#: qwen2-moe-a2.7b's (2, 60, 2048, 1408) expert stack at phase 18's depth
ADAM_SIZES = (23_440_896, 28_311_552, 1_000_003, 346_030_080)


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


def _attn_inputs(rng, dev, dtype, b, s, t, kv, g, dh, padded=False):
    q, cot = (_randn(rng, (b, s, kv * g, dh), dtype, dev) for _ in range(2))
    k, v = (_randn(rng, (b, t, kv, dh), dtype, dev) for _ in range(2))
    q_pos = (torch.arange(s, device=dev, dtype=torch.int32) + (t - s))[None].repeat(b, 1)
    kv_pos = torch.arange(t, device=dev, dtype=torch.int32)
    if padded:
        kv_pos[64:192] = -1
        q_pos[1, 32:96] = -1
    return q, k, v, cot, q_pos, kv_pos


def _train_sig(q, k, causal, window, softcap):
    """(B, S, T, KV, G, Dh, causal, engaged window, softcap, dtype) of a
    training-attention launch."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    return (b, s, t, kv, h // kv, dh, bool(causal), int(window), float(softcap), q.dtype)


def _excess(got, ref, atol, rtol):
    """Worst |got - ref| over its allowance atol + rtol |ref| (fails above 1)."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs() / (atol + rtol * ref.abs())).max().item()


def phase_train_kernel_check(dev):
    from repro_torch.kernels import adam_adapt, dispatch, flash_attn

    rng = np.random.default_rng(SEED + 10)
    names = (flash_attn.FWD, flash_attn.DQ, flash_attn.DKV)
    worst = {n: {torch.float32: 0.0, torch.bfloat16: 0.0} for n in names}
    share_vs_f32 = {n: 0.0 for n in names}
    # the bf16 plain version's own distance from the plain in f32, as a
    # share of the bf16 tolerance: observed, not held (a bf16 plain version
    # rounds as it goes; past 1, it cannot be the bf16 kernels' reference)
    plain16_share = {n: 0.0 for n in names}
    f16_share = 0.0  # the f16 forward vs plain in f32, share of its half-ulp bound
    repeats = 0  # shapes whose bf16 gradients two runs gave bitwise equal
    for name, b, s, t, kv, g, dh, causal, window, softcap, padded in TRAIN_SHAPES:
        kw = dict(softcap=softcap, window=window, causal=causal)
        plain_kw = dict(kw, chunk=PADDED_CHUNK if padded else 0)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, cot, q_pos, kv_pos = _attn_inputs(rng, dev, dtype, b, s, t, kv, g, dh,
                                                       padded)

            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out = flash_attn.flash_attention(*leaves, q_pos, kv_pos, True, **plain_kw)
            (out.float() * cot.float()).sum().backward()
            got = [out.detach()] + [x.grad for x in leaves]
            del out, leaves
            # the kernels' two passes in plain versions (the plain forward,
            # flash_attention_bwd_plain from its lse), in f32 on the same
            # inputs: a bf16 plain version rounds as it goes, by more than the
            # bf16 tolerance at the twins' Dh 64 layers (plain16_share)
            plain = flash_attn.flash_attention_plain_vjp(
                *(x.float() for x in (q, k, v)), q_pos, kv_pos, cot.float(), **plain_kw)
            plain16 = (flash_attn.flash_attention_plain_vjp(q, k, v, q_pos, kv_pos, cot,
                                                            **plain_kw)
                       if dtype != torch.float32 else ())
            torch.cuda.synchronize()
            for i, (a, p) in enumerate(zip(got, plain)):
                kname = names[min(i, 2)]
                atol, rtol = ATTN_TOL[dtype][0 if i == 0 else 1]
                if a.dtype != dtype or a.shape != p.shape:
                    raise AssertionError(f"{kname}: {a.dtype} {tuple(a.shape)} at {name}")
                excess = _excess(a, p, atol, rtol)
                if not excess <= 1.0:
                    raise AssertionError(f"{kname} vs plain at {name} {dtype}: {excess:.3f} of "
                                         f"the tolerance (atol {atol}, rtol {rtol})")
                worst[kname][dtype] = max(worst[kname][dtype],
                                          (a.float() - p.float()).abs().max().item())
            for i, (p16, p) in enumerate(zip(plain16, plain)):
                kname = names[min(i, 2)]
                share = _excess(p16, p, *ATTN_TOL[dtype][min(i, 1)])
                plain16_share[kname] = max(plain16_share[kname], share)
            del got, plain, plain16
            if dtype == torch.bfloat16:
                # the bf16 kernels against the plain version in f32 on the
                # same inputs: each result rounded once from f32
                out, lse = flash_attn._fwd_cuda(q, k, v, q_pos, kv_pos, **kw)
                delta = torch.sum(cot.float() * out.float(), dim=-1)
                grads = flash_attn._bwd_cuda(q, k, v, q_pos, kv_pos, lse, delta, cot, **kw)
                # no atomics: a second run gives the same bits
                again = flash_attn._bwd_cuda(q, k, v, q_pos, kv_pos, lse, delta, cot, **kw)
                for kname, a, r in zip(names[1:] + names[2:], grads, again):
                    if not torch.equal(a, r):
                        raise AssertionError(f"{kname} bf16 at {name}: two runs differ in "
                                             f"{int((a != r).sum())} elements")
                repeats += 1
                del again
                ref_out, _ = flash_attn.flash_attention_fwd_plain(
                    q.float(), k.float(), v.float(), q_pos, kv_pos, **plain_kw)
                ref_grads = flash_attn.flash_attention_bwd_plain(
                    q.float(), k.float(), v.float(), q_pos, kv_pos, lse, delta, cot.float(),
                    **kw)
                half_ulp = torch.finfo(torch.bfloat16).eps / 2
                for i, (a, r) in enumerate(zip([out, *grads], [ref_out, *ref_grads])):
                    kname = names[min(i, 2)]
                    atol, rtol = ATTN_TOL[torch.float32][0 if i == 0 else 1]
                    share = _excess(a, r, atol, rtol + half_ulp)
                    if not share <= 1.0:
                        raise AssertionError(f"{kname} bf16 vs plain in f32 at {name}: "
                                             f"{share:.3f} of the half-ulp bound")
                    share_vs_f32[kname] = max(share_vs_f32[kname], share)
                del out, grads, ref_out, ref_grads
                # the f16 forward (its own instantiation) on these values
                # in f16, against the plain forward in f32 on the same
                q16, k16, v16 = (x.half() for x in (q, k, v))
                out16, _ = flash_attn._fwd_cuda(q16, k16, v16, q_pos, kv_pos, **kw)
                ref16, _ = flash_attn.flash_attention_fwd_plain(
                    q16.float(), k16.float(), v16.float(), q_pos, kv_pos, **plain_kw)
                share = _excess(out16, ref16, ATTN_TOL[torch.float32][0][0],
                                torch.finfo(torch.float16).eps / 2)
                if not (out16.dtype == torch.float16 and share <= 1.0):
                    raise AssertionError(f"{names[0]} f16 vs plain in f32 at {name}: {share:.3f} "
                                         f"of the half-ulp bound ({out16.dtype})")
                f16_share = max(f16_share, share)
                del q16, k16, v16, out16, ref16
            if not padded:
                CHECKED["flash_attention"].add(_train_sig(q, k, causal, window, softcap))
            torch.cuda.empty_cache()
    for kname in names:
        log(f"kernel_check: {kname} vs plain in f32 at "
            f"{', '.join(x[0] for x in TRAIN_SHAPES)}, "
            f"max_err_f32={worst[kname][torch.float32]:.3e} "
            f"max_err_bf16={worst[kname][torch.bfloat16]:.3e}; bf16 vs plain in f32 within "
            f"{share_vs_f32[kname]:.3f} of the half-ulp bound; the bf16 plain version vs "
            f"plain in f32 at {plain16_share[kname]:.3f} of the bf16 tolerance (not held)")
    log(f"kernel_check: {names[0]} f16 vs plain in f32 at every shape within {f16_share:.3f} "
        f"of the half-ulp bound")
    log(f"kernel_check: dq, dk, dv bf16 bitwise equal over two runs at {repeats} of "
        f"{len(TRAIN_SHAPES)} shapes")

    rng = np.random.default_rng(SEED + 17)  # its own inputs, whatever the shapes above draw
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)  # the expert stack's, on the card
    adam_worst = 0.0
    # and the blocks phase 24's ranks hold of each sharded leaf
    sizes = ADAM_SIZES + _shard_sizes()
    for n in sizes:
        def draw():
            if n in ADAM_SIZES[:3]:
                return _randn(rng, (n,), torch.float32, dev)
            return _dev_randn(gen, n, dev)

        for t in (1, 7):
            g, gm, m = (draw() * 1e-2 for _ in range(3))
            v = draw().square() * 1e-4
            step = torch.tensor(t, dtype=torch.int32, device=dev)
            lr = torch.tensor(1e-3, device=dev)
            out, ss = adam_adapt.adam_adapt(g, m, v, gm, t=step, lr=lr)
            ref, ref_ss = adam_adapt.adam_adapt(g, m, v, gm, t=step, lr=lr, backend="plain")
            excess = _excess(out, ref, 1e-7, 1e-5)
            ss_rel = abs(ss.item() - ref_ss.item()) / abs(ref_ss.item())
            if not (excess <= 1.0 and ss_rel <= 1e-4):
                raise AssertionError(f"adam_adapt vs plain at N={n} t={t}: out {excess:.3f} of "
                                     f"the tolerance, sum of squares {ss_rel:.2e} relative")
            adam_worst = max(adam_worst, (out - ref).abs().max().item())
            del g, gm, m, v, out, ref
    log(f"kernel_check: adam_adapt vs plain at N in {sizes}, t in (1, 7): "
        f"max_abs_err={adam_worst:.3e} (rtol 1e-5, atol 1e-7; sum of squares rtol 1e-4)")
    dispatch.reset_launches()
    return worst, share_vs_f32, adam_worst


def phase_second_order_check(dev):
    """A second derivative through the CUDA attention and CE kernels raises
    (their backward is first order only: once_differentiable), as the JAX
    package's Pallas path does; the plain route takes one (its ops under
    autograd) and stays finite."""
    from repro_torch.kernels import dispatch, flash_attn, weighted_ce as wce

    rng = np.random.default_rng(SEED + 13)
    q = _randn(rng, (2, 128, 4, 64), torch.bfloat16, dev).requires_grad_(True)
    k, v = (_randn(rng, (2, 128, 1, 64), torch.bfloat16, dev).requires_grad_(True)
            for _ in range(2))
    pos = torch.arange(128, dtype=torch.int32, device=dev)
    x = _randn(rng, (16, 8192), torch.float32, dev).requires_grad_(True)
    t = torch.from_numpy(rng.integers(0, 8192, 16).astype(np.int32)).to(dev)
    cases = {
        "flash_attention": (lambda backend: flash_attn.flash_attention(
            q, k, v, pos[None].expand(2, -1), pos, backend=backend).float().square().sum(),
            (q, k, v)),
        "weighted_ce": (lambda backend: wce.cross_entropy(x, t, backend=backend).square().sum(),
                        (x,)),
    }
    dispatch.reset_launches()
    for name, (loss, leaves) in cases.items():
        grads = torch.autograd.grad(loss(None), leaves, create_graph=True)
        try:
            torch.autograd.grad(sum(g.float().square().sum() for g in grads), leaves)
        except RuntimeError as e:
            log(f"second_order: {name} on the CUDA kernels raises: {str(e).splitlines()[0][:100]}")
        else:
            raise AssertionError(f"{name}: a second derivative through the CUDA kernels "
                                 "returned instead of raising")
        grads = torch.autograd.grad(loss("plain"), leaves, create_graph=True)
        hv = torch.autograd.grad(sum(g.float().square().sum() for g in grads), leaves)
        if not all(torch.isfinite(h.float()).all() for h in hv):
            raise AssertionError(f"{name}: the plain route's second derivative is not finite")
        log(f"second_order: {name} on the plain route: finite")
    dispatch.reset_launches()


def _bound(nbytes, ops, dtype):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def _attn_layers(rng, dev, b, s, kv, g, dh, windows, softcap=0.0, causal=True):
    """One layer's own bf16 inputs at (B, S = T, KV, G, Dh) per entry of
    ``windows`` (its window), each with the forward's lse and delta and
    room for the gradients."""
    from repro_torch.kernels import flash_attn

    layers = []
    for window in windows:
        q, k, v, cot, q_pos, kv_pos = _attn_inputs(rng, dev, torch.bfloat16, b, s, s, kv, g, dh)
        kw = dict(softcap=softcap, window=window, causal=causal)
        out, lse = flash_attn._fwd_cuda(q, k, v, q_pos, kv_pos, **kw)
        delta = torch.sum(cot.float() * out.float(), dim=-1)
        layers.append(dict(q=q, k=k, v=v, cot=cot, q_pos=q_pos, kv_pos=kv_pos, lse=lse,
                           delta=delta, kw=kw, dq=torch.empty_like(q), dk=torch.empty_like(k),
                           dv=torch.empty_like(v)))
    return layers


def _attn_runs(dev, layers):
    """One pass over ``layers`` of: the forward (through its wrapper), dq
    and dk/dv (each through its C entry, so one kernel alone), and the
    plain forward and backward."""
    from repro_torch.kernels import flash_attn

    dq_fn = flash_attn._train_fn("flash_attn_bwd", "flash_attn_dq_launch")
    dkv_fn = flash_attn._train_fn("flash_attn_bwd", "flash_attn_dkv_launch")

    def c_args(x):
        return (x["q"].data_ptr(), x["k"].data_ptr(), x["v"].data_ptr(), x["cot"].data_ptr(),
                x["q_pos"].data_ptr(), x["kv_pos"].data_ptr(), x["lse"].data_ptr(),
                x["delta"].data_ptr())

    def common(x):  # the stream is read at each call: under capture it is the graph's
        b, s, t, kv, g, dh = flash_attn._dims(x["q"], x["k"])
        kw = x["kw"]
        return (b, s, t, kv, g, dh, int(kw["causal"]), kw["window"], kw["softcap"],
                1.0 / math.sqrt(dh), 1, torch.cuda.current_stream(dev).cuda_stream)

    def checked(err, what):
        if err != 0:
            raise RuntimeError(f"{what} launch failed with CUDA error {err}")

    def fwd():
        for x in layers:
            flash_attn._fwd_cuda(x["q"], x["k"], x["v"], x["q_pos"], x["kv_pos"], **x["kw"])

    def dq():
        for x in layers:
            checked(dq_fn(*c_args(x), x["dq"].data_ptr(), *common(x)), "dq")

    def dkv():
        for x in layers:
            checked(dkv_fn(*c_args(x), x["dk"].data_ptr(), x["dv"].data_ptr(), *common(x)), "dkv")

    def plain_fwd():
        for x in layers:
            flash_attn.flash_attention_fwd_plain(x["q"], x["k"], x["v"], x["q_pos"], x["kv_pos"],
                                                 **x["kw"])

    def plain_bwd():
        for x in layers:
            flash_attn.flash_attention_bwd_plain(x["q"], x["k"], x["v"], x["q_pos"], x["kv_pos"],
                                                 x["lse"], x["delta"], x["cot"], **x["kw"])

    return {"fwd": fwd, "dq": dq, "dkv": dkv, "plain_fwd": plain_fwd, "plain_bwd": plain_bwd}


def _attn_bounds(layers):
    """Per-call bounds of the three kernels over ``layers`` (their mean):
    each input read once and each output written once, and the operations
    of the valid (query, key) pairs these positions give (two products in
    the forward, three in dq, four in dk/dv, a multiply and an add each)."""
    from repro_torch.kernels import flash_attn

    nbytes = {"fwd": 0, "dq": 0, "dkv": 0}
    ops = {"fwd": 0, "dq": 0, "dkv": 0}
    for x in layers:
        b, s, t, kv, g, dh = flash_attn._dims(x["q"], x["k"])
        h, item = kv * g, x["q"].element_size()
        act = b * s * h * dh * item           # q, out, dO, dq: (B, S, H, Dh)
        kvb = b * t * kv * dh * item          # k, v, dk, dv: (B, T, KV, Dh)
        rows = b * s * h * 4                  # lse or delta, f32
        pos = b * s * 4 + t * 4
        kw = x["kw"]
        pairs = h * int(flash_attn._tile_valid(x["q_pos"], x["kv_pos"], causal=kw["causal"],
                                               window=kw["window"]).sum())
        for key, nb, flops in (("fwd", act * 2 + kvb * 2 + rows + pos, 4 * pairs * dh),
                               ("dq", act * 3 + kvb * 2 + rows * 2 + pos, 6 * pairs * dh),
                               ("dkv", act * 2 + kvb * 4 + rows * 2 + pos, 8 * pairs * dh)):
            nbytes[key] += nb
            ops[key] += flops
    n = len(layers)
    return {key: _bound(nbytes[key] / n, ops[key] / n, torch.bfloat16) for key in nbytes}


def _log_tiles(layers, where):
    """The tiles the bf16 forward, dq and dk/dv visit over ``layers``: each
    kernel's own walk run alone (``flash_attn.tc_visits``; dk/dv's from the
    key side) beside the count of the ``live_tiles`` rule at the tile sizes
    its library reports, over lanes and KV heads. Fails if the two differ."""
    from repro_torch.kernels import flash_attn

    for kernel in (flash_attn.FWD, flash_attn.DQ, flash_attn.DKV):
        walk = rule = total = 0
        for x in layers:
            _, _, _, kv, g, dh = flash_attn._dims(x["q"], x["k"])
            bq, bk = flash_attn.tc_tiles(kernel, g, dh)
            kw = dict(causal=x["kw"]["causal"], window=x["kw"]["window"])
            live = flash_attn.live_tiles(x["q_pos"], x["kv_pos"], bq, bk, **kw)
            rule += kv * int(live.sum())
            total += kv * live.numel()
            walk += flash_attn.tc_visits(kernel, x["q_pos"], x["kv_pos"], kv, g, dh, **kw)
        if walk != rule:
            raise AssertionError(f"{kernel} {where}: its walk visits {walk} key tiles, the "
                                 f"live_tiles rule keeps {rule}")
        log(f"tiles: {kernel} {where} ({bq} queries x {bk} keys): the kernel's walk visits "
            f"{walk} of {total} tiles ({walk / total:.1%}), as the live_tiles rule keeps")


def _kernel_time_entries(t, bounds, shape):
    from repro_torch.kernels import flash_attn

    out = {}
    for key, name in (("fwd", flash_attn.FWD), ("dq", flash_attn.DQ), ("dkv", flash_attn.DKV)):
        out[name] = {"ms": t[key], "plain_ms": t["plain_fwd" if key == "fwd" else "plain_bwd"],
                     "library_ms": t["lib_fwd" if key == "fwd" else "lib_bwd"],
                     "bound_ms": bounds[key][0], "bound_by": bounds[key][1], "shape": shape}
    # the library backward is timed eagerly: the median of five timings,
    # with their range
    out[flash_attn.DQ]["library_ms_range"] = t["lib_bwd_range"]
    out[flash_attn.DKV]["library_ms_range"] = t["lib_bwd_range"]
    for key, name in (("fwd", flash_attn.FWD), ("dq", flash_attn.DQ), ("dkv", flash_attn.DKV)):
        out[name]["ms_repeat"] = t[f"{key}_repeat"]
    # the plain backward and the library backward each compute dq, dk and
    # dv together: their time stands beside both backward kernels
    out[flash_attn.DQ]["plain_and_library_cover"] = "dq, dk, dv"
    out[flash_attn.DKV]["plain_and_library_cover"] = "dq, dk, dv"
    return out


def phase_train_kernel_time(dev, cfg, batch, seq):
    """Per bert-base layer (one pass over cfg.num_layers layers' own inputs,
    so the 50 MB L2 does not hold them), bf16: the forward, dq and dk/dv
    kernels beside the plain versions and scaled_dot_product_attention;
    and adam_adapt at the embedding's size."""

    import torch.nn.functional as F

    from repro_torch.kernels import adam_adapt, flash_attn

    rng = np.random.default_rng(SEED + 11)
    b, s, h, dh = batch, seq, cfg.num_heads, cfg.head_dim
    kv, g, n = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.num_layers
    layers = _attn_layers(rng, dev, b, s, kv, g, dh, [0] * n, causal=False)
    runs = _attn_runs(dev, layers)
    lib = []
    for x in layers:
        qt, kt, vt = (x[name].transpose(1, 2).contiguous().requires_grad_(True)
                      for name in ("q", "k", "v"))
        out = F.scaled_dot_product_attention(qt, kt, vt)
        lib.append((qt, kt, vt, out, x["cot"].transpose(1, 2).contiguous()))

    def run_lib_fwd():
        with torch.no_grad():
            for qt, kt, vt, _, _ in lib:
                F.scaled_dot_product_attention(qt, kt, vt)

    def run_lib_bwd():
        for qt, kt, vt, out, ct in lib:
            torch.autograd.grad(out, (qt, kt, vt), ct, retain_graph=True)

    t = {key: graph_ms(fn) / n for key, fn in (
        ("fwd", runs["fwd"]), ("dq", runs["dq"]), ("dkv", runs["dkv"]),
        ("plain_fwd", runs["plain_fwd"]), ("plain_bwd", runs["plain_bwd"]),
        ("lib_fwd", run_lib_fwd), ("fwd_repeat", runs["fwd"]), ("dq_repeat", runs["dq"]),
        ("dkv_repeat", runs["dkv"]))}
    # autograd's backward does not capture into a CUDA graph here (it runs on
    # the engine's own thread), so the library backward is timed eagerly, by
    # CUDA events, as the median of five timings: its host cost (a few us per
    # layer) stays in its time
    med, lo, hi = median_ms(run_lib_bwd)
    t["lib_bwd"], t["lib_bwd_range"] = med / n, [lo / n, hi / n]
    shape = {"B": b, "S": s, "T": s, "H": h, "KV": kv, "Dh": dh, "dtype": "bfloat16",
             "causal": False, "layers": n}
    out = _kernel_time_entries(t, _attn_bounds(layers), shape)
    for name in (flash_attn.FWD, flash_attn.DQ, flash_attn.DKV):
        e = out[name]
        lib_range = e.get("library_ms_range")
        log(f"kernel_time: {name} per bert-base layer (B={b} S={s} bf16): ms={e['ms']:.4f} "
            f"plain_ms={e['plain_ms']:.4f} library_ms={e['library_ms']:.4f}"
            + (f" ({lib_range[0]:.4f}-{lib_range[1]:.4f})" if lib_range else "")
            + f" bound_ms={e['bound_ms']:.5f} ({e['bound_by']})")
    _log_tiles(layers, f"over {n} bert-base layers")
    del layers, lib, runs

    step = torch.tensor(3, dtype=torch.int32, device=dev)
    lr = torch.tensor(1e-3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    for n_el in (ADAM_SIZES[0], ADAM_SIZES[3]):
        if n_el == ADAM_SIZES[0]:
            g, m, v, gm = (_randn(rng, (n_el,), torch.float32, dev) for _ in range(4))
        else:
            g, m, v, gm = (_dev_randn(gen, n_el, dev) for _ in range(4))
        v = v.abs()
        adam_ms = graph_ms(lambda: adam_adapt.adam_adapt(g, m, v, gm, t=step, lr=lr))
        adam_plain = graph_ms(lambda: adam_adapt.adam_adapt(g, m, v, gm, t=step, lr=lr,
                                                            backend="plain"))
        adam_ms_2 = graph_ms(lambda: adam_adapt.adam_adapt(g, m, v, gm, t=step, lr=lr))
        bound_ms, bound_by = _bound(20 * n_el, 20 * n_el, torch.float32)
        e = {"ms": adam_ms, "ms_repeat": adam_ms_2, "plain_ms": adam_plain,
             "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
             "shape": {"N": n_el, "dtype": "float32"}}
        if n_el == ADAM_SIZES[0]:
            out["adam_adapt"] = e
        else:  # the expert stack, beside the embedding's entry
            out["adam_adapt"]["qwen2-moe-a2.7b expert stack"] = e
        log(f"kernel_time: adam_adapt at N={n_el}: ms={adam_ms:.4f} (repeat {adam_ms_2:.4f}) "
            f"plain_ms={adam_plain:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
        del g, m, v, gm
    torch.cuda.empty_cache()
    return out


def _sdpa_times(dev, layers, g):
    """One scaled_dot_product_attention call per layer, forward and its
    autograd backward (eager, by CUDA events, each the median of five
    timings of ten passes), under every SDPA backend that takes these
    inputs. K and V are expanded to the query heads outside the timed
    region; a global layer passes is_causal (True unless the layer is
    bidirectional), a local one a boolean causal + window mask. Returns
    {backend: ((fwd ms, min, max), (bwd ms, min, max))} per call."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    lib = []
    for x in layers:
        qt = x["q"].transpose(1, 2).contiguous().requires_grad_(True)
        kt, vt = (x[name].transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
                  .requires_grad_(True) for name in ("k", "v"))
        window = x["kw"]["window"]
        mask = None
        if window:
            qp, kp = x["q_pos"][0][:, None], x["kv_pos"][None, :]
            mask = (kp <= qp) & (qp - kp < window)
        lib.append((qt, kt, vt, mask, x["cot"].transpose(1, 2).contiguous()))
    causal = layers[0]["kw"]["causal"]

    def call(qt, kt, vt, mask):
        if mask is None:
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    times = {}
    for backend in (getattr(SDPBackend, name, None) for name in (
            "FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")):
        if backend is None:  # not in this PyTorch
            continue
        with sdpa_kernel([backend]):
            try:
                outs = [call(*x[:4]) for x in lib]
                torch.cuda.synchronize()
            except RuntimeError:  # this backend does not take these inputs
                continue

            def run_fwd():
                with torch.no_grad():
                    for x in lib:
                        call(*x[:4])

            def run_bwd():
                for (qt, kt, vt, _, ct), out in zip(lib, outs):
                    torch.autograd.grad(out, (qt, kt, vt), ct, retain_graph=True)

            times[backend.name] = tuple(tuple(x / len(lib) for x in median_ms(fn))
                                        for fn in (run_fwd, run_bwd))
            del outs
    if not times:
        raise AssertionError("no scaled_dot_product_attention backend took the layer")
    return times


def phase_layer_attn_time(dev, cfg, batch=4, seq=1024, causal=True, label=None):
    """The forward, dq and dk/dv kernels over one pass of the model's
    layers in its pattern (gemma3-1b: 5:1 local:global, H 4 over KV 1,
    Dh 256, the 512-token window on local layers; qwen2-moe-a2.7b: 24
    global layers, H 16 over KV 16, Dh 128), B 4, S = T 1024 unless given,
    bf16, causal unless not (whisper's encoder), each layer its own inputs
    (beside the 50 MB L2), timed per call
    on each kind of layer (CUDA-graph replay) beside the plain versions and
    scaled_dot_product_attention under each backend that takes the layer;
    the bounds from the valid (query, key) pairs of these positions; the
    tiles the bf16 kernels visit. Returns {kernel: {label (default
    cfg.name): {kind: ..., "ms_per_layer", "bound_ms_per_layer"}}}."""
    from repro_torch.kernels import flash_attn

    label = label or cfg.name
    rng = np.random.default_rng(SEED + 16)
    b, s = batch, seq
    kv, g, dh = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    kinds = cfg.layer_kinds
    present = [kind for kind in ("global", "local") if kind in kinds]
    windows = [cfg.sliding_window if kind == "local" else 0 for kind in kinds]
    layers = _attn_layers(rng, dev, b, s, kv, g, dh, windows,
                          softcap=float(cfg.attn_logit_softcap or 0.0), causal=causal)
    shape = {"B": b, "S": s, "T": s, "H": kv * g, "KV": kv, "Dh": dh, "dtype": "bfloat16",
             "causal": causal, "window": cfg.sliding_window,
             "layers": {kind: kinds.count(kind) for kind in present}}
    per_kind = {}
    for kind in present:
        sel = [x for x, k in zip(layers, kinds) if k == kind]
        n = len(sel)
        runs = _attn_runs(dev, sel)
        t = {key: graph_ms(runs[key]) / n for key in ("fwd", "dq", "dkv", "plain_fwd",
                                                       "plain_bwd")}
        for key in ("fwd", "dq", "dkv"):
            t[f"{key}_repeat"] = graph_ms(runs[key]) / n
        sdpa = _sdpa_times(dev, sel, g)
        fwd_best = min(sdpa, key=lambda name: sdpa[name][0][0])
        bwd_best = min(sdpa, key=lambda name: sdpa[name][1][0])
        t["lib_fwd"], t["lib_bwd"] = sdpa[fwd_best][0][0], sdpa[bwd_best][1][0]
        t["lib_bwd_range"] = list(sdpa[bwd_best][1][1:])
        entries = _kernel_time_entries(t, _attn_bounds(sel), dict(shape, kind=kind))
        for name, e in entries.items():
            e["library_backend"] = fwd_best if name == flash_attn.FWD else bwd_best
            e["library_ms_by_backend"] = {k: v[0 if name == flash_attn.FWD else 1]
                                          for k, v in sdpa.items()}
            e["library_call"] = ("scaled_dot_product_attention, K/V expanded, eager"
                                 + ("" if name == flash_attn.FWD else ", autograd backward"))
            lib_range = e.get("library_ms_range")
            log(f"kernel_time: {name} per {label} {kind} layer (B={b} S={s} bf16): "
                f"ms={e['ms']:.4f} plain_ms={e['plain_ms']:.4f} library_ms={e['library_ms']:.4f}"
                + (f" ({lib_range[0]:.4f}-{lib_range[1]:.4f})" if lib_range else "")
                + f" ({e['library_backend']}) bound_ms={e['bound_ms']:.5f} ({e['bound_by']})")
        _log_tiles(sel, f"over {len(sel)} {label} {kind} layers")
        per_kind[kind] = entries
        del runs
    del layers
    torch.cuda.empty_cache()
    out = {}
    for name in (flash_attn.FWD, flash_attn.DQ, flash_attn.DKV):
        counts = shape["layers"]
        per = {kind: per_kind[kind][name] for kind in present}
        out[name] = {label: {
            **per,
            "ms_per_layer": sum(counts[k] * per[k]["ms"] for k in present) / len(kinds),
            "bound_ms_per_layer": sum(counts[k] * per[k]["bound_ms"] for k in present)
            / len(kinds)}}
    return out


#: (name, B, S, V, sliced): gemma3-1b's LM loss, logits (4, 1024, V) read
#: through the logits[:, :-1] view (R = 4,092), a ragged shape, and the LM
#: losses of qwen2-moe-a2.7b and minicpm3-4b (V not a power of two),
#: rwkv6-1.6b, zamba2-7b and whisper-small (phase 22's batch 8 at S 448; V
#: odd, so every row but the first starts off a 16-byte boundary and the
#: kernels take their scalar loads)
CE_SHAPES = [("gemma3-1b", 4, 1024, 262_144, True), ("ragged", 1, 37, 5_000, False),
             ("qwen2-moe-a2.7b", 4, 1024, 151_936, True), ("minicpm3-4b", 4, 1024, 73_448, True),
             ("rwkv6-1.6b", 4, 1024, 65_536, True), ("zamba2-7b", 4, 1024, 32_000, True),
             ("whisper-small", 8, 448, 51_865, True)]
#: bert-base's embedding, gemma3-1b's embedding, a ragged size
ADAPT_SIZES = (23_440_896, 301_989_888, 1_000_003)


def phase_ce_kernel_check(dev):
    """weighted_ce forward and backward against the plain versions
    (``perf.ce_time.hold``): ce and lse within 1e-5 (1 + |ref|), f32
    dlogits within 1e-6 + 1e-5 |ref|, and bf16 and f16 dlogits within
    (1e-5 + half an ulp of their dtype) |ref| of the plain version in f32
    on the same inputs, plus one step of the dtype's subnormals (2^-24 for
    f16, where most of gemma3-1b's dlogits lie: |dlogits| ~ 4e-8 |g| at lse
    ~ 17, so an absolute term of 1e-6 would leave them unchecked); a second
    launch of each kernel bitwise equal to the first. At CE_SHAPES, then
    at every phase a row takes in a 16-byte line (``ce_time.
    check_alignments``: V at each residue modulo 4 and 8 and below one
    vector, storage offsets 0 and 3), in f32, bf16 and f16."""
    from repro_torch.kernels import dispatch, weighted_ce as wce
    from repro_torch.perf import ce_time

    rng = np.random.default_rng(SEED + 12)
    worst = {"fwd": {}, "bwd": {}}

    def note(key, got):
        worst["fwd"][key] = max(worst["fwd"].get(key, 0.0), got["fwd"])
        worst["bwd"][key] = max(worst["bwd"].get(key, 0.0), got["bwd"])
        worst["bwd"][key + "_share_of_bound"] = max(
            worst["bwd"].get(key + "_share_of_bound", 0.0), got["bwd_share"])

    for name, b, s, v, sliced in CE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))
            x, t, g = ce_time.ce_inputs(gen, dev, b, s, v, dtype, sliced)
            key = str(dtype).replace("torch.", "")
            note(key, ce_time.hold(wce, x, t, g, f"{name} {key}"))
            del x, t, g
            torch.cuda.empty_cache()
    cases, aligned = ce_time.check_alignments(dev, seed=SEED + 12)
    for key, w in aligned.items():
        note(key, w)
    log(f"kernel_check: weighted_ce at {[c[:4] for c in CE_SHAPES]} and {cases} row "
        f"alignments (V in {ce_time.ALIGN_V}, offsets 0 and 3), f32, bf16, f16 logits, "
        f"repeats bitwise: forward max_abs_err {worst['fwd']}, backward {worst['bwd']}")
    dispatch.reset_launches()
    return worst


def _dev_randn(gen, n, dev):
    return torch.randn(n, generator=gen, device=dev, dtype=torch.float32)


def phase_adapt_kernel_check(dev):
    """lion_adapt and adafactor_adapt against their plain versions at
    ADAPT_SIZES: out rtol 1e-5 / atol 1e-7, sum of squares rtol 1e-4."""
    from repro_torch.kernels import adafactor_adapt, dispatch, lion_adapt

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    worst = {"lion_adapt": 0.0, "adafactor_adapt": 0.0}
    for n in ADAPT_SIZES:
        g, m, gm = (_dev_randn(gen, n, dev) * 1e-2 for _ in range(3))
        vhat = _dev_randn(gen, n, dev).square_() * 1e-4
        lr = torch.tensor(1e-3, device=dev)
        for name, fn, args, kw in (
                ("lion_adapt", lion_adapt.lion_adapt, (g, m, gm), dict(lr=lr, b1=0.9,
                                                                      delta=1e-3)),
                ("adafactor_adapt", adafactor_adapt.adafactor_adapt, (vhat, gm),
                 dict(lr=lr, eps=1e-8))):
            out, ss = fn(*args, **kw)
            ref, ref_ss = fn(*args, backend="plain", **kw)
            excess = _excess(out, ref, 1e-7, 1e-5)
            ss_rel = abs(ss.item() - ref_ss.item()) / abs(ref_ss.item())
            if not (excess <= 1.0 and ss_rel <= 1e-4):
                raise AssertionError(f"{name} vs plain at N={n}: out {excess:.3f} of the "
                                     f"tolerance, sum of squares {ss_rel:.2e} relative")
            worst[name] = max(worst[name], (out - ref).abs().max().item())
            del out, ref
        del g, m, gm, vhat
        torch.cuda.empty_cache()
    log(f"kernel_check: lion_adapt, adafactor_adapt vs plain at N in {ADAPT_SIZES}: "
        f"max_abs_err {worst} (rtol 1e-5, atol 1e-7; sum of squares rtol 1e-4)")
    dispatch.reset_launches()
    return worst


#: the previous CE kernels' ms per call (forward, backward) by (shape name,
#: dtype), printed beside this run's: the kernel table of PERF.md section 6
#: (H100 80GB HBM3, 700 W), the kernels that took an unaligned row's scalar
#: loop; quoted, not measured here
CE_BEFORE_MS = {("gemma3-1b", "float32"): (1.447, 3.018),
                ("gemma3-1b", "bfloat16"): (0.8096, 1.5198),
                ("gemma3-1b", "float16"): (0.7577, 1.5180),
                ("qwen2-moe-a2.7b", "float32"): (0.8291, 1.7263),
                ("minicpm3-4b", "float32"): (0.4501, 0.8880),
                ("rwkv6-1.6b", "float32"): (0.3611, 0.7432),
                ("zamba2-7b", "float32"): (0.1824, 0.3643),
                ("whisper-small", "float32"): (0.2765, 1.1332)}


def _ce_times(dev, rng, dtype, shape=CE_SHAPES[0]):
    """weighted_ce forward and backward at an LM loss shape of CE_SHAPES
    (gemma3-1b's (4, 1023, V) view unless ``shape`` names another) with
    ``dtype`` logits (``perf.ce_time.time_shape``): by CUDA-graph replay,
    beside the plain versions, ``F.cross_entropy(reduction="none")`` on the
    same logits (forward; its autograd backward, timed eagerly) and a copy
    of the logits' bytes; the bound from the bytes (the arithmetic is f32
    in every instantiation). The log line carries the earlier kernel's
    time (CE_BEFORE_MS) beside."""
    from repro_torch.kernels import weighted_ce as wce
    from repro_torch.perf import ce_time

    shape_name, b, s, v, _ = shape
    t = ce_time.time_shape(dev, (shape_name, b, s, v), dtype, seed=int(rng.integers(2 ** 31)))
    rows, name = t["R"], t["dtype"]
    layout = {"R": rows, "V": v, "dtype": name, "layout": t["layout"]}
    before = CE_BEFORE_MS.get((shape_name, name), (None, None))
    logits_b = rows * v * (torch.finfo(dtype).bits // 8)
    out = {}
    for kernel, p, nbytes, was in ((wce.FWD, "fwd", logits_b + rows * 12, before[0]),
                                   (wce.BWD, "bwd", 2 * logits_b + rows * 12, before[1])):
        # one exp and about three more operations per logit, in f32
        bound_ms, bound_by = _bound(nbytes, 4 * rows * v, torch.float32)
        ms, ms2, plain, lib = (t[f"{p}_ms"], t[f"{p}_ms_repeat"], t[f"{p}_plain_ms"],
                               t[f"{p}_library_ms"])
        out[kernel] = {"ms": ms, "ms_repeat": ms2, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bound_ms, "bound_by": bound_by, "copy_ms": t["copy_ms"],
                       "shape": layout}
        log(f"kernel_time: {kernel} at R={rows} V={v} {name}: ms={ms:.4f} (repeat "
            f"{ms2:.4f}) plain_ms={plain:.4f} library_ms={lib:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}) share_of_bound={bound_ms / ms:.3f} copy_ms={t['copy_ms']:.4f} "
            f"before_ms={was} (the previous kernels, PERF.md section 6)")
    out[wce.BWD]["library_call"] = "autograd backward of F.cross_entropy, eager"
    return out


def phase_new_kernel_time(dev):
    """weighted_ce forward and backward at gemma3-1b's LM loss shape in
    the main path's dtype (f32 logits), and its f16 instantiation beside
    the bf16 one at the same shape (``_ce_times``), then at the LM loss
    shapes of qwen2-moe, minicpm3, rwkv6 and zamba2 (f32 logits); lion_adapt and
    adafactor_adapt at bert-base's embedding beside their plain versions
    (no library call)."""
    from repro_torch.kernels import adafactor_adapt, lion_adapt, weighted_ce as wce

    rng = np.random.default_rng(SEED + 14)
    out = _ce_times(dev, rng, torch.float32)
    bf16 = _ce_times(dev, rng, torch.bfloat16)
    f16 = _ce_times(dev, rng, torch.float16)
    for kernel in (wce.FWD, wce.BWD):
        f16[kernel]["bf16_ms"] = bf16[kernel]["ms"]
        f16[kernel]["bf16_ms_repeat"] = bf16[kernel]["ms_repeat"]
        out[f"{kernel}_f16"] = f16[kernel]
    # the LM losses of phases 18, 19, 21 and 22, f32 logits
    for shape in CE_SHAPES[2:]:
        for kernel, e in _ce_times(dev, rng, torch.float32, shape).items():
            out[kernel][shape[0]] = e

    n = ADAPT_SIZES[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    gg, m, gm = (_dev_randn(gen, n, dev) for _ in range(3))
    vhat = _dev_randn(gen, n, dev).square_()
    lr = torch.tensor(1e-3, device=dev)
    for name, fn, args, kw, per_el in (
            ("lion_adapt", lion_adapt.lion_adapt, (gg, m, gm), dict(lr=lr), (16, 10)),
            ("adafactor_adapt", adafactor_adapt.adafactor_adapt, (vhat, gm), dict(lr=lr),
             (12, 4))):
        ms = graph_ms(lambda: fn(*args, **kw))
        plain = graph_ms(lambda: fn(*args, backend="plain", **kw))
        ms2 = graph_ms(lambda: fn(*args, **kw))
        bound_ms, bound_by = _bound(per_el[0] * n, per_el[1] * n, torch.float32)
        out[name] = {"ms": ms, "ms_repeat": ms2, "plain_ms": plain, "library_ms": None,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "shape": {"N": n, "dtype": "float32"}}
        log(f"kernel_time: {name} at N={n}: ms={ms:.4f} (repeat {ms2:.4f}) "
            f"plain_ms={plain:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    return out


# ---------------------------------------------------------------------------
# phases 7-8: training
# ---------------------------------------------------------------------------


def _wrench(cfg, seq, n_train, n_meta, seed):
    """WRENCH-analog data at the model's vocabulary (``perf.common.
    wrench_task``, after benchmarks/common.py): majority-vote weak labels on
    train, clean meta labels."""
    from repro_torch.perf.common import wrench_task

    _, train, meta, _ = wrench_task(seed, n_train, n_meta, 0, num_classes=cfg.num_labels,
                                    vocab_size=cfg.vocab_size, seq_len=seq)
    return train, meta


def _warm_batches(train, dev, batch, unroll, seed):
    """(base_batches, meta_batch) for comparing hypergradients: the K base
    batches are row permutations of one set of sequences (noisy labels)
    and the meta batch is the same sequences with their clean labels, so
    every parameter row the meta gradient touches has warm Adam moments at
    the state the adaptation is taken at. On a row first seen in the last
    base batch the exact Adam diagonal is lr a eps / (sqrt(b) |g| + eps)^2,
    ~1/g^2: v and eps then follow the smallest such gradients, whose
    rounding differs between any two implementations (ROADMAP queue 3)."""
    rng = np.random.default_rng(seed)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def batches(i):
        idx = rng.integers(0, len(train["y"]), size=batch)
        perms = np.stack([idx[rng.permutation(batch)] for _ in range(unroll)])
        base = {"tokens": put(train["tokens"][perms]), "y": put(train["y"][perms])}
        meta = {"tokens": put(train["tokens"][idx]), "y": put(train["y_true"][idx])}
        return base, meta

    return batches


def _learner(model, dev, unroll, base_opt, method="sama", **knobs):
    """MetaWeightNet reweighting of the model's per-example loss (the
    classifier's for an encoder, the per-sequence LM loss otherwise),
    ``base_opt`` at the base level, Adam at the meta level; ``knobs`` go
    to ``MetaLearner`` (the estimators' settings)."""
    from repro_torch import api
    from repro_torch.core import problems

    per_example = (model.classifier_per_example if model.cfg.family == "encoder"
                   else model.per_example)
    spec = problems.make_data_optimization_spec(per_example, reweight=True)
    learner = api.MetaLearner(spec, base_opt=base_opt, meta_opt="adam", meta_lr=1e-3,
                              method=method, unroll_steps=unroll, **knobs)
    learner.init(model.init(SEED), problems.init_data_optimization_lam(SEED + 1, device=dev))
    return learner


def _modality(cfg, lead, gen):
    """The batch's other input, random normal f32 on ``gen``'s card: whisper's
    ``frames`` (encoder_seq, d_model), the vision model's ``patches``
    (vision_tokens, vision_dim), per sequence; {} for the other families."""
    if cfg.family == "audio":
        key, shape = "frames", (cfg.encoder_seq, cfg.d_model)
    elif cfg.family == "vlm":
        key, shape = "patches", (cfg.vision_tokens, cfg.vision_dim)
    else:
        return {}
    return {key: torch.randn(tuple(lead) + shape, generator=gen, device=gen.device)}


def _lm_warm_batches(cfg, dev, batch, seq, unroll, seed):
    """(base_batches, meta_batch) of LM token sequences (with their random
    frames or patches, for whisper and the vision model) for comparing
    hypergradients: the K base batches are row permutations of one set of
    sequences and the meta batch is that set (see _warm_batches)."""
    from repro_torch import data

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lm_cfg = data.LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq)

    def batches(i):
        toks = data.lm_batch(lm_cfg, rng, batch)["tokens"]
        perms = np.stack([rng.permutation(batch) for _ in range(unroll)])
        meta = {"tokens": torch.from_numpy(toks).to(dev), **_modality(cfg, (batch,), gen)}
        idx = torch.from_numpy(perms).to(dev)
        return {k: v[idx] for k, v in meta.items()}, meta

    return batches


F32_TOL = {"base_loss": 1e-5, "meta_loss": 1e-5, "eps": 2e-3, "hypergrad_norm": 2e-3}
#: where plain steps from theta moved by one ulp part from the plain step
#: beyond F32_TOL (rwkv6 at its init), the kernel step is held at this many
#: times their largest spread (phase 21)
FLOOR_MARGIN = 1.5


def _diff(got, ref, got_s, ref_s, state, sign_lr=None):
    """Two meta steps from ``state`` compared: per metric, (got, ref,
    relative difference); per theta/lam leaf set, the largest difference,
    its share of 1e-6 + 5% of the largest update, [how many coordinates lie
    beyond that bound, how many there are, how many of those beyond are not
    a sign flip] (with ``sign_lr``, Lion's rate, a flip is a difference
    within the bound of 2 lr (opposite signs) or lr (one sign 0); without
    it, none is), and [non-finite coordinates of got, of ref, and of those
    the ones where the two differ]. A NaN or inf is reported, not caught:
    the differences are taken where both are finite."""
    from repro_torch import tree

    diff = {k: (got[k], ref[k], abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30)) for k in F32_TOL}
    for field in ("theta", "lam"):
        d_max, share, beyond, not_flips, total, nans = 0.0, 0.0, 0, 0, 0, [0, 0, 0]
        for x, y, y0 in zip(tree.tree_leaves(got_s[field]), tree.tree_leaves(ref_s[field]),
                            tree.tree_leaves(getattr(state, field))):
            x = x.to(y.device)  # a leaf kept on the host comes back one at a time
            bad_x, bad_y = ~torch.isfinite(x), ~torch.isfinite(y)
            same = (x == y) | (torch.isnan(x) & torch.isnan(y))
            nans = [nans[0] + int(bad_x.sum()), nans[1] + int(bad_y.sum()),
                    nans[2] + int(((bad_x | bad_y) & ~same).sum())]
            both = ~(bad_x | bad_y)
            total += x.numel()
            if not bool(both.any()):
                continue
            d = (x - y).abs()[both]
            bound = 1e-6 + 0.05 * (y - y0).abs()[both].max().item()
            d_max = max(d_max, d.max().item())
            share = max(share, d.max().item() / bound)
            over = d > bound
            beyond += int(over.sum().item())
            if sign_lr is not None:
                over &= ((d - 2 * sign_lr).abs() > bound) & ((d - sign_lr).abs() > bound)
            not_flips += int(over.sum().item())
        diff[f"{field}_max_abs_diff"], diff[f"{field}_share_of_bound"] = d_max, share
        diff[f"{field}_beyond_bound"] = [beyond, total, not_flips]
        diff[f"{field}_nonfinite"] = nans
    return diff


def _hold(tag, diff, sign_lr=None, nonfinite_ok=False, tol=F32_TOL, share_limit=None):
    """The metrics within F32_TOL; theta and lam per leaf within 1e-6 + 5%
    of the step's largest update. With ``nonfinite_ok`` (the baseline
    estimators, whose reference can give NaN) a metric may instead be
    equal, NaN or inf in both, and the bound holds where both are finite
    with the same non-finite values in the same coordinates; without it
    any non-finite value fails. ``sign_lr`` (Lion) admits
    theta coordinates beyond the bound only where the two steps took
    opposite signs of a momentum vote c that rounding decides: each 2 lr
    (or lr, a sign of 0) apart within the bound, and at most 1e-5 of the
    coordinates. ``tol`` replaces F32_TOL and ``share_limit`` {field: the
    share of the bound it may reach, 1 by default} (phase 21's rounding
    floor, FLOOR_MARGIN times it where it passes phase 7's bounds)."""
    for key, rtol in tol.items():
        got, ref, _ = diff[key]
        if nonfinite_ok and (got == ref or (math.isnan(got) and math.isnan(ref))):
            continue
        if not abs(got - ref) <= rtol * abs(ref) + 1e-7:
            raise AssertionError(f"{tag} {key}: {got!r} vs {ref!r}")
    for field in ("theta", "lam"):
        bad = diff[f"{field}_nonfinite"]
        if bad[2] or (not nonfinite_ok and (bad[0] or bad[1])):
            raise AssertionError(f"{tag} {field}: non-finite coordinates {bad}")
        if diff[f"{field}_share_of_bound"] <= (share_limit or {}).get(field, 1.0):
            continue
        beyond, total, not_flips = diff[f"{field}_beyond_bound"]
        flips_ok = (sign_lr is not None and field == "theta" and not_flips == 0
                    and beyond <= 1e-5 * total)
        if not flips_ok:
            raise AssertionError(
                f"{tag} {field}: {diff[f'{field}_max_abs_diff']:.3e} is "
                f"{diff[f'{field}_share_of_bound']:.2f} of the bound; {beyond} of {total} "
                f"coordinates beyond it, {not_flips} of them no sign flip")


def _step_pair(learner, state, base, meta, counted=(), sign_lr=None, host=False):
    """One meta step from ``state`` through the kernels and with every
    kernel plain. Returns the plain state, their ``_diff``, the kernel
    step's launches of the ``counted`` kernels and the two steps' seconds.
    Only theta and lam of the kernel step are kept while the plain step
    runs, with ``host`` in host memory (a parameter-sized tree off a card
    that is nearly full)."""
    from repro_torch import tree
    from repro_torch.obs.metrics import packed_read
    from repro_torch.kernels import dispatch

    dispatch.reset_launches()
    t0 = time.perf_counter()
    got_s, got = learner.step_fn(state, base, meta)
    got = packed_read(got)
    t1 = time.perf_counter()
    launches = {n: dispatch.launches(n) for n in counted}
    got_s = {"theta": got_s.theta, "lam": got_s.lam}
    if host:
        got_s = tree.tree_map(lambda x: x.cpu(), got_s)
        torch.cuda.empty_cache()
    with dispatch.plain_everywhere():
        ref_s, ref = learner.step_fn(state, base, meta)
        ref = packed_read(ref)
    t2 = time.perf_counter()
    diff = _diff(got, ref, got_s, {"theta": ref_s.theta, "lam": ref_s.lam}, state, sign_lr)
    return ref_s, diff, launches, (t1 - t0, t2 - t1)


def _held_steps(tag, learner, batches, steps, want=None, sign_lr=None, nonfinite_ok=False):
    """``steps`` meta steps, each from one state through the kernels and
    with every kernel plain (dispatch.plain_everywhere, a context the model
    never enters), held by ``_hold`` (``nonfinite_ok`` passed on), with the
    kernel step's launches equal to ``want``; the run goes on from the
    plain step's state (run freely, two f32 trajectories part within a few
    meta steps: ROADMAP queue 3)."""
    state, rows, secs = learner.state, [], [0.0, 0.0]
    for i in range(steps):
        state, diff, launches, (tk, tp) = _step_pair(learner, state, *batches(i),
                                                     tuple(want or ()), sign_lr)
        secs[0] += tk
        secs[1] += tp
        rows.append(diff)
        if want is not None and launches != want:
            raise AssertionError(f"{tag} step {i}: launches {launches} != {want}")
        _hold(f"{tag} step {i}", diff, sign_lr, nonfinite_ok)
    worst = {k: max(r[k][2] for r in rows) for k in F32_TOL}
    for field in ("theta", "lam"):
        for k in (f"{field}_max_abs_diff", f"{field}_share_of_bound"):
            worst[k] = max(r[k] for r in rows)
        worst[f"{field}_beyond_bound"] = max(r[f"{field}_beyond_bound"][0] for r in rows)
    return state, {"steps": steps, "kernels_s": secs[0], "plain_s": secs[1], "per_step": rows,
                   "worst": worst}


def phase_train_f32(base_cfg, dev, batch=16, seq=128, unroll=2, steps=F32_PAIRS):
    """bert-base in f32: _held_steps on WRENCH-analog data with warm rows.

    The checked run's base Adam takes eps = 1e-3, which bounds the
    adaptation diagonal by lr / eps. With the paper's 1e-8, the coordinates
    whose gradient is at rounding level (diagonal ~1e5) make up v, so eps,
    the hypergradient and the nudged theta follow rounding in any two
    implementations; one more step at 1e-8 is measured and reported here,
    not held to a tolerance."""
    from repro_torch import optim
    from repro_torch.models import Model

    cfg = base_cfg.replace(dtype="float32")
    model = Model(cfg, device=dev)
    train, _ = _wrench(cfg, seq, 256, 16, SEED + 20)
    batches = _warm_batches(train, dev, batch, unroll, SEED + 21)
    learner = _learner(model, dev, unroll, optim.adam(1e-3, eps=1e-3))
    _, out = _held_steps("train f32", learner, batches, steps)
    del learner
    learner_8 = _learner(model, dev, unroll, optim.adam(1e-3))
    _, diff_8, _, _ = _step_pair(learner_8, learner_8.state, *batches(0))
    out.update({"batch": batch, "seq": seq, "unroll": unroll, "base_adam_eps": 1e-3,
                "base_adam_eps_1e-8_one_step_not_held": diff_8})
    log("train_f32: " + json.dumps(out))
    return out


def phase_train_gemma_f32(base_cfg, dev, batch=2, seq=1024, unroll=2, steps=F32_PAIRS):
    """gemma3-1b at full width and depth in f32, the per-sequence LM loss
    (weighted_ce over 262,144 tokens), batch 2, seq 1024 (the 512-token
    window masks): _held_steps with base Adam eps 1e-3 on warm rows, and one
    step at eps 1e-8 reported, not held (as phase_train_f32)."""
    from repro_torch import optim, tree
    from repro_torch.models import Model

    cfg = base_cfg.replace(dtype="float32")
    model = Model(cfg, device=dev)
    batches = _lm_warm_batches(cfg, dev, batch, seq, unroll, SEED + 40)
    learner = _learner(model, dev, unroll, optim.adam(1e-3, eps=1e-3))
    want = _lm_want(cfg, unroll, len(tree.tree_leaves(learner.state.theta)))
    _, out = _held_steps("train gemma f32", learner, batches, steps, want)
    del learner
    torch.cuda.empty_cache()
    learner_8 = _learner(model, dev, unroll, optim.adam(1e-3))
    _, diff_8, _, _ = _step_pair(learner_8, learner_8.state, *batches(0))
    del learner_8
    torch.cuda.empty_cache()
    out.update({"batch": batch, "seq": seq, "unroll": unroll, "base_adam_eps": 1e-3,
                "launches_per_step": want, "base_adam_eps_1e-8_one_step_not_held": diff_8})
    log("train_gemma_f32: " + json.dumps(out))
    return out


def phase_train_lion_adafactor(base_cfg, dev, batch=16, seq=128, unroll=2,
                               steps=F32_PAIRS):
    """bert-base in f32 with Lion (lr 1e-4) and Adafactor (lr 1e-3, eps
    1e-3: its diagonal lr / (sqrt(vhat) + eps) has Adam's rounding-level
    coordinates at 1e-8) at the base level: _held_steps, each kernel step
    launching one lion_adapt or adafactor_adapt per theta leaf."""
    from repro_torch import optim, tree
    from repro_torch.kernels import flash_attn
    from repro_torch.models import Model

    cfg = base_cfg.replace(dtype="float32")
    model = Model(cfg, device=dev)
    train, _ = _wrench(cfg, seq, 256, 16, SEED + 50)
    out = {}
    L, K = cfg.num_layers, unroll
    for name, opt, sign_lr in (("lion", optim.lion(1e-4), 1e-4),
                               ("adafactor", optim.adafactor(1e-3, eps=1e-3), None)):
        batches = _warm_batches(train, dev, batch, unroll, SEED + 51)
        learner = _learner(model, dev, unroll, opt)
        leaves = len(tree.tree_leaves(learner.state.theta))
        want = {f"{name}_adapt": leaves, flash_attn.FWD: L * (K + 3) + L * (K + 1),
                flash_attn.DQ: L * (K + 1), flash_attn.DKV: L * (K + 1)}
        _, res = _held_steps(f"train {name}", learner, batches, steps, want, sign_lr)
        res["launches_per_step"] = want
        out[name] = res
        del learner
        torch.cuda.empty_cache()
    log("train_lion_adafactor: " + json.dumps(out))
    return out


BASELINES = ("t1t2", "neumann", "cg", "iterdiff")


def _method_launches(method, cfg, unroll, leaves):
    """Per meta step of the remat encoder: the flash forwards, dq and dk/dv,
    and adam_adapt. SAMA as _train_launches (SAMA-NA without adam_adapt);
    a baseline's unroll takes K forwards and K backwards (each recomputing
    its forward), t1t2, neumann and cg add the meta gradient (one more of
    each) and the meta loss's forward, iterdiff the meta loss's forward
    only: its re-unroll and every Hessian or mixed product are second order
    (dispatch.second_order), on the plain route."""
    from repro_torch.kernels import flash_attn

    if method in ("sama", "sama_na"):
        want = _train_launches(cfg, unroll, leaves)
        want["adam_adapt"] = leaves if method == "sama" else 0
        return want
    L, k = cfg.num_layers, unroll if method == "iterdiff" else unroll + 1
    return {flash_attn.FWD: L * (k + 1) + L * k, flash_attn.DQ: L * k, flash_attn.DKV: L * k,
            "adam_adapt": 0}


def _tiny_gradients(learner, base, b2=0.999):
    """The coordinates of the first base gradient (fresh Adam state, as
    iterdiff's re-unroll starts) where Adam's second moment (1 - b2) g^2
    is 0 in f32: g exactly 0, or so small that its square underflows (of
    the embeddings, the rows the batch reads).
    There sqrt(vhat) sits at 0 and its derivative is infinite, so
    differentiating through it (iterdiff) gives inf or NaN (ROADMAP queue
    3)."""
    from repro_torch import tree
    from repro_torch.core.sama import value_and_grad

    batch = tree.tree_map(lambda x: x[0], base)
    _, g = value_and_grad(learner.spec.base_scalar, 0)(learner.state.theta,
                                                       learner.state.lam, batch)
    # embedding rows the batch does not read are zero by construction, and
    # the gather's transpose drops their cotangent: count the rows it reads
    read = {("embed",): torch.unique(batch["tokens"].long()),
            ("pos_embed",): torch.arange(batch["tokens"].shape[1], device=batch["tokens"].device)}
    out = {"coordinates": 0, "exact_zero": 0, "square_underflows": 0, "leaves_with_either": []}
    for path, x in zip(*reversed(tree.tree_flatten(g))):
        x = x[read[path]] if path in read else x
        zero = int((x == 0).sum())
        under = int(((1.0 - b2) * x * x == 0).sum()) - zero
        out["coordinates"] += x.numel()
        out["exact_zero"] += zero
        out["square_underflows"] += under
        if zero or under:
            out["leaves_with_either"].append(["/".join(path), zero, under])
    return out


def phase_baselines_f32(base_cfg, dev, batch=16, seq=128, unroll=2):
    """bert-base in f32: one meta step of each baseline estimator, through
    the kernels and with every kernel plain, from one state, held as phase
    7 holds SAMA's (warm rows, base Adam eps 1e-3); the kernel step's flash
    launches equal to _method_launches, and its second-order passes counted
    under "second order". T1-T2, Neumann and CG at 1 iteration are held on
    every coordinate, so a wrong meta gradient, CG's input, shows: at
    bert-base the reference's CG diverges from its second iteration on, to
    NaN at 2 iterations as at 5. CG at its default 5 iterations and
    iterdiff (it differentiates sqrt(vhat) at 0) are reports: a NaN or inf
    must sit in the same coordinates of both steps; for iterdiff the first
    base gradient's zero and underflowing coordinates are counted
    (_tiny_gradients)."""
    from repro_torch import optim
    from repro_torch.kernels import dispatch
    from repro_torch.models import Model

    cfg = base_cfg.replace(dtype="float32")
    model = Model(cfg, device=dev)
    train, _ = _wrench(cfg, seq, 256, 16, SEED + 70)
    out = {}
    cases = (("t1t2", {}, False), ("neumann", {}, False), ("cg_iters1", {"cg_iters": 1}, False),
             ("cg", {}, True), ("iterdiff", {}, True))
    for name, knobs, nonfinite_ok in cases:
        method = name.split("_")[0]
        batches = _warm_batches(train, dev, batch, unroll, SEED + 71)
        learner = _learner(model, dev, unroll, optim.adam(1e-3, eps=1e-3), method, **knobs)
        want = {k: v for k, v in _method_launches(method, cfg, unroll, 0).items() if v}
        _, res = _held_steps(f"baselines {name}", learner, batches, 1, want,
                             nonfinite_ok=nonfinite_ok)
        second = dispatch.route_counts().get((dispatch.PLAIN, dispatch.SECOND_ORDER), 0)
        if not second:
            raise AssertionError(f"baselines {name}: no call took the second-order route")
        res.update({"launches_per_step": want, "second_order_routes": second,
                    "held_on_every_coordinate": not nonfinite_ok,
                    "hypergrad_norm_finite": math.isfinite(
                        res["per_step"][0]["hypergrad_norm"][0])})
        if method == "iterdiff":
            res["first_base_gradient"] = _tiny_gradients(learner, batches(0)[0])
        out[name] = res
        log(f"baselines_f32: {name} " + json.dumps(res))
        del learner
        torch.cuda.empty_cache()
    return out


def phase_table2(cfg, dev, out_dir, batch=48, seq=128, unroll=2, warmup=1, repeats=1):
    """Paper Table 2 on the card: the six methods of
    ``repro_torch.perf.bench_throughput_memory`` on bert-base in its own
    dtypes, batch 48, seq 128, unroll 2. Per method one line: wall median
    and range, samples/s, peak memory, device time and busy share, each
    kernel's launches against _method_launches over the measured calls,
    the (route, reason) counts, and whether lam stayed finite (reported, a
    NaN is not caught). SAMA must route nothing plain; each baseline's
    second-order passes must take "second order". Writes
    BENCH_torch_table2.json to ``out_dir``/table2."""
    from repro_torch import tree
    from repro_torch.kernels import dispatch
    from repro_torch.perf import bench_throughput_memory as bench

    rows = {}

    def check(rec):
        x = rec.extra
        m, steps = x["method"], x["steps_counted"]
        leaves = len(tree.tree_leaves(model_leaves))
        want = {k: v * steps for k, v in _method_launches(m, cfg, unroll, leaves).items()}
        got = {k: x["launches"].get(k, 0) for k in want}
        routes = {(r, why): n for r, why, n in x["routes"]}
        t = rec.us_per_step
        row = {"median_ms": t["median_us"] / 1e3, "min_ms": t["min_us"] / 1e3,
               "max_ms": t["max_us"] / 1e3, "samples_per_s": rec.samples_per_s,
               "peak_gb": (rec.memory["per_device"]["peak_bytes"] or 0) / 1e9,
               "device_ms": x["device_ms"], "busy_share": x["device_busy_share"],
               "first_call_s": x["first_call_s"], "launches": got, "steps_counted": steps,
               "second_order_peak_bytes": x["second_order_peak_bytes"],
               "routes": x["routes"], "hypergrad_norm": x["hypergrad_norm"],
               "lam_finite": x["lam_finite"], "seconds": x["bench_s"],
               "profiled_step_seconds": x["profiled_step_s"]}
        rows[m] = row
        log(f"table2: {m} " + json.dumps(row))
        if got != want:
            raise AssertionError(f"table2 {m}: launches {got} != {want}")
        if not x["device_ms"] > 0:
            raise AssertionError(f"table2 {m}: the profiler saw no device time")
        plain = {k: n for k, n in routes.items() if k[0] == dispatch.PLAIN}
        if m in ("sama", "sama_na") and plain:
            raise AssertionError(f"table2 {m}: plain calls {plain}")
        if m in BASELINES and set(plain) != {(dispatch.PLAIN, dispatch.SECOND_ORDER)}:
            raise AssertionError(f"table2 {m}: plain calls {plain}, want second order only")

    from repro_torch.models import transformer

    model_leaves = transformer.init_params(cfg, device="meta")
    t0 = time.perf_counter()
    table_dir = os.path.join(out_dir, "table2")
    os.makedirs(table_dir, exist_ok=True)
    records = bench.run(cfg, batch=batch, seq=seq, unroll=unroll, warmup=warmup,
                        repeats=repeats, device=dev, seed=SEED + 80, trace_dir=table_dir,
                        log=check)
    path = bench.write(table_dir, records, time.perf_counter() - t0)
    log(f"table2: wrote {path}")
    return rows


def phase_checkpoint(cfg, dev, learner, it, out_dir, unroll=2):
    """``MetaLearner.save`` of phase 8's learner, then ``load`` into a fresh
    learner (another init): every leaf bitwise equal, and the next step from
    both states within phase 7's tolerances (_hold)."""
    from repro_torch import optim, tree
    from repro_torch.obs.metrics import packed_read
    from repro_torch.models import Model

    path = os.path.join(out_dir, "checkpoint")
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    learner.save(path)
    t1 = time.perf_counter()
    fresh = _learner(Model(cfg, device=dev), dev, unroll, optim.adam(1e-3))
    fresh.load(path)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    names, saved = tree.flatten_with_keys(learner.state)
    names_r, loaded = tree.flatten_with_keys(fresh.state)
    unequal = [n for n, x, y in zip(names, saved, loaded)
               if x.dtype != y.dtype or x.device != y.device or not torch.equal(x, y)]
    if names != names_r or unequal:
        raise AssertionError(f"checkpoint: leaves differ after load: {unequal[:5]}")
    nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    base, meta = next(it)
    got_s, got = learner.step_fn(learner.state, base, meta)
    ref_s, ref = fresh.step_fn(fresh.state, base, meta)
    diff = _diff(packed_read(got), packed_read(ref), {"theta": got_s.theta, "lam": got_s.lam},
                 {"theta": ref_s.theta, "lam": ref_s.lam}, learner.state)
    _hold("checkpoint next step", diff)
    shutil.rmtree(path)
    out = {"leaves": len(names), "bitwise_equal": True, "bytes": nbytes, "save_s": t1 - t0,
           "load_s": t2 - t1, "step": int(learner.state.step), "next_step": diff}
    log("checkpoint: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phases 15-16: the scale layer and data optimization
# ---------------------------------------------------------------------------


def _scaled_launches(cfg, unroll, leaves, m):
    """Per meta step with M microbatches: every model-sized pass runs once
    per microbatch, so each attention and CE count of the M = 1 step
    (``_train_launches``; K + 3 CE forwards, K + 1 backwards) times M; one
    adam_adapt per theta leaf, as at M = 1 (the product runs once, on the
    accumulated meta gradient)."""
    from repro_torch.kernels import weighted_ce as wce

    want = {k: (v if k == "adam_adapt" else m * v)
            for k, v in _train_launches(cfg, unroll, leaves).items()}
    if cfg.family != "encoder":
        want.update({wce.FWD: m * (unroll + 3), wce.BWD: m * (unroll + 1)})
    return want


def phase_scale_f32(base_cfg, dev, batch=16, seq=128, unroll=2, steps=F32_PAIRS, m=2):
    """15(a): bert-base in f32, policy f32, M = 2: _held_steps (kernels
    against plain_everywhere, base Adam eps 1e-3, phase 7's tolerances)
    with M x phase 7's attention launches; then the M = 2 step against the
    M = 1 step from one state on one batch, reported as relative
    differences, not held (the reference's own f32-exactness property
    fails on the reference: ROADMAP queue 3)."""
    from repro_torch import optim, scale, tree
    from repro_torch.obs.metrics import packed_read
    from repro_torch.models import Model

    cfg = base_cfg.replace(dtype="float32")
    model = Model(cfg, device=dev)
    train, _ = _wrench(cfg, seq, 256, 16, SEED + 90)
    batches = _warm_batches(train, dev, batch, unroll, SEED + 91)
    learner = _learner(model, dev, unroll, optim.adam(1e-3, eps=1e-3),
                       scale=scale.ScaleConfig(microbatch=m))
    want = _scaled_launches(cfg, unroll, len(tree.tree_leaves(learner.state.theta)), m)
    _, out = _held_steps(f"scale f32 M={m}", learner, batches, steps, want)
    learner_1 = _learner(model, dev, unroll, optim.adam(1e-3, eps=1e-3))
    state = learner.state
    base, meta = batches(steps)
    got_s, got = learner.step_fn(state, base, meta)
    ref_s, ref = learner_1.step_fn(state, base, meta)
    vs_m1 = _diff(packed_read(got), packed_read(ref), {"theta": got_s.theta, "lam": got_s.lam},
                  {"theta": ref_s.theta, "lam": ref_s.lam}, state)
    del learner, learner_1, got_s, ref_s
    torch.cuda.empty_cache()
    out.update({"batch": batch, "seq": seq, "unroll": unroll, "microbatch": m,
                "launches_per_step": want, f"m{m}_vs_m1_not_held": vs_m1})
    log("scale_f32: " + json.dumps(out))
    return out


def _scale_bench(cfg, dev, out_dir, meta_batch, ms):
    """The bf16 arms of ``perf/bench_scale.py`` at ``ms``, at the bench's
    sizes; each arm's launches held to steps x ``_scaled_launches`` (an
    arm out of memory is reported, with no launches to hold)."""
    from repro_torch import tree
    from repro_torch.models import transformer
    from repro_torch.perf import bench_scale

    seq, unroll = bench_scale.SEQ, bench_scale.UNROLL
    leaves = len(tree.tree_leaves(transformer.init_params(cfg, device="meta")))
    rows = {}

    def check(rec):
        x = rec.extra
        m, steps = x["microbatch"], x["steps_counted"]
        want = {k: v * steps for k, v in _scaled_launches(cfg, unroll, leaves, m).items()}
        got = {k: x["launches"].get(k, 0) for k in want}
        row = {"policy": x["policy"], "microbatch": m, "meta_batch": meta_batch,
               "out_of_memory": x["out_of_memory"], "steps_counted": steps,
               "launches": got, "launches_predicted": want, "seconds": x["bench_s"]}
        if not x["out_of_memory"]:
            t = rec.us_per_step
            row.update({"step_ms_median": t["median_us"] / 1e3, "step_ms_min": t["min_us"] / 1e3,
                        "step_ms_max": t["max_us"] / 1e3, "samples_per_s": rec.samples_per_s,
                        "tokens_per_s": rec.samples_per_s * seq,
                        "max_memory_allocated": rec.memory["per_device"]["peak_bytes"],
                        "first_call_s": x["first_call_s"]})
            if got != want:
                raise AssertionError(f"scale bf16 M={m}: launches {got} != {want}")
        rows[m] = row
        log("scale_memory: " + json.dumps(row))

    t0 = time.perf_counter()
    records = bench_scale.run(cfg, meta_batch=meta_batch, arms=[("bf16", m) for m in ms],
                              device=dev, seed=SEED + 100, log=check)
    path = bench_scale.write(os.path.join(out_dir, "scale"), records, time.perf_counter() - t0)
    log(f"scale_memory: wrote {path}")
    return rows


def phase_scale_memory(cfg, dev, out_dir):
    """15(b): gemma3-1b with the bf16 policy, batch 4, seq 1024, unroll 2,
    meta batch 4, M in {1, 2, 4}: step wall time (median of 3), peak
    memory and launches per M (``_scale_bench``). If M = 1 does not fit
    the card at meta batch 4, that is reported and the reading is taken at
    meta batch 2, M in {1, 2}."""
    os.makedirs(os.path.join(out_dir, "scale"), exist_ok=True)
    rows = _scale_bench(cfg, dev, out_dir, 4, (1, 2, 4))
    meta_batch = 4
    if rows[1]["out_of_memory"]:
        log("scale_memory: M=1 at meta batch 4 does not fit the card; meta batch 2, M in 1, 2")
        rows = _scale_bench(cfg, dev, out_dir, 2, (1, 2))
        meta_batch = 2
    peaks = [rows[m].get("max_memory_allocated") for m in sorted(rows)]
    if any(p is None for p in peaks):
        raise AssertionError(f"scale_memory: an arm ran out of memory at meta batch "
                             f"{meta_batch}: {peaks}")
    return {"meta_batch": meta_batch, "rows": rows}


def phase_scale_plan(cfg, dev, peaks, meta_batch):
    """15(c): ``scale.plan_microbatch`` for gemma3-1b with the bf16 policy,
    at 15(b)'s sizes and meta batch, at a budget halfway between 15(b)'s
    M = 1 and largest-M peaks. The plan
    must fit, every candidate it measured below its choice must exceed the
    budget (the smallest fitting M), and its candidates' peaks must be
    non-increasing in M; the M that 15(b)'s peaks would pick is reported
    beside it."""
    from repro_torch import scale
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import Model
    from repro_torch.perf.bench_scale import BATCH, SEQ, UNROLL

    model = Model(cfg, device=dev)
    learner = _learner(model, dev, UNROLL, "adam", scale=scale.ScaleConfig(policy="bf16"))
    make_batch = make_batch_fn(cfg, SEQ, dev, np.random.default_rng(SEED + 100))
    base_b, meta_b = make_batch(BATCH, UNROLL), make_batch(meta_batch)
    budget = (peaks[1] + peaks[max(peaks)]) // 2
    t0 = time.perf_counter()
    plan = scale.plan_microbatch(learner.spec, learner.base_opt, learner.meta_opt, learner.cfg,
                                 learner.state, base_b, meta_b, hbm_budget=budget)
    secs = time.perf_counter() - t0
    del learner, base_b, meta_b
    torch.cuda.empty_cache()
    cands = [(m, p) for m, p in plan.candidates]
    out = {"budget_bytes": budget, "microbatch": plan.microbatch, "fits": plan.fits,
           "peak_bytes": plan.peak_bytes, "source": plan.source, "candidates": cands,
           "bench_peaks": peaks, "bench_would_pick": min(
               (m for m, p in peaks.items() if p <= budget), default=None),
           "seconds": secs}
    log("scale_plan: " + json.dumps(out))
    if not plan.fits or plan.peak_bytes > budget or plan.source != "cuda_max_allocated":
        raise AssertionError(f"scale_plan: {out}")
    measured = [p for _, p in cands]
    if any(p is None for p in measured) or measured != sorted(measured, reverse=True):
        raise AssertionError(f"scale_plan: candidates not non-increasing in peak: {cands}")
    if any(p <= budget for m, p in cands if m < plan.microbatch):
        raise AssertionError(f"scale_plan: a smaller M fits: {cands}")
    return out


def phase_scale_f16(base_cfg, dev, batch=4, seq=1024, unroll=2, meta_batch=4, steps=4, m=2):
    """15(d): gemma3-1b with the f16 policy and f16 activations (config
    dtype float16), M = 2, four meta steps: per step loss_scale,
    meta_skipped and the base steps skipped (from the scale's halvings:
    log2(before / after) less the meta gate's, while the scale is above
    its floor), launches held to M x the M = 1 counts. The LM loss casts
    its logits to f32 before the CE (in both packages), so the CE runs its
    f32 instantiation there; the f16 instantiation runs in a linear probe
    over gemma3-1b's 1,152-wide features at 8,192 classes under the same
    policy (two meta steps, M = 2), whose f16 logits take the kernels."""
    from repro_torch import api, scale, tree
    from repro_torch.core import problems
    from repro_torch.obs.metrics import packed_read
    from repro_torch.kernels import dispatch, weighted_ce as wce
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import Model

    cfg = base_cfg.replace(dtype="float16")
    model = Model(cfg, device=dev)
    learner = _learner(model, dev, unroll, "adam", scale=scale.ScaleConfig(policy="f16",
                                                                            microbatch=m))
    make_batch = make_batch_fn(cfg, seq, dev, np.random.default_rng(SEED + 110))
    want = _scaled_launches(cfg, unroll, len(tree.tree_leaves(learner.state.theta)), m)
    want.update({f"{wce.FWD}_f32": want[wce.FWD], f"{wce.BWD}_f32": want[wce.BWD]})
    rows = []
    dispatch.reset_launches()  # counts of this path's run only
    for i in range(steps):
        before = float(learner.state.scale.scale)
        metrics = packed_read(learner.step(make_batch(batch, unroll), make_batch(meta_batch)))
        after = float(learner.state.scale.scale)
        halvings = math.log2(before / after) if after > 0 else float("nan")
        rows.append({"step": i, "loss_scale_before": before, "loss_scale": metrics["loss_scale"],
                     "meta_skipped": metrics["meta_skipped"],
                     "base_skipped": (halvings - metrics["meta_skipped"]
                                      if after > scale.resolve_policy("f16").min_loss_scale
                                      else "at the floor: not derivable"),
                     "good_steps": int(learner.state.scale.good_steps),
                     **{k: metrics[k] for k in ("base_loss", "meta_loss", "hypergrad_norm",
                                                "eps")}})
        log("scale_f16: " + json.dumps(rows[-1]))
    got = {k: dispatch.launches(k) for k in want}
    want = {k: v * steps for k, v in want.items()}
    del learner, model
    torch.cuda.empty_cache()
    if got != want:
        raise AssertionError(f"scale f16: launches {got} != {want}")
    for r in rows:
        if not 1.0 <= r["loss_scale"] <= 2.0 ** 15 or r["meta_skipped"] not in (0.0, 1.0):
            raise AssertionError(f"scale f16: automaton out of range {r}")

    # the f16 CE instantiation on its path: a linear probe at 8,192 classes
    d, classes, pb, probe_steps = cfg.d_model, 8192, 32, 2
    gen = torch.Generator(device=dev).manual_seed(SEED + 111)
    theta = {"w": torch.randn((d, classes), generator=gen, device=dev) * d ** -0.5,
             "b": torch.zeros(classes, device=dev)}
    spec = problems.make_data_optimization_spec(
        problems.softmax_per_example(lambda th, x: x @ th["w"] + th["b"]), reweight=True)
    probe = api.MetaLearner(spec, base_opt="adam", meta_opt="adam", unroll_steps=unroll,
                            scale=scale.ScaleConfig(policy="f16", microbatch=m))
    probe.init(theta, problems.init_data_optimization_lam(SEED + 112, device=dev))

    def probe_batch(lead):
        return {"x": torch.randn(lead + (d,), generator=gen, device=dev),
                "y": torch.randint(0, classes, lead, generator=gen, device=dev,
                                   dtype=torch.int32)}

    probe_want = {f"{wce.FWD}_f16": m * (unroll + 3) * probe_steps,
                  f"{wce.BWD}_f16": m * (unroll + 1) * probe_steps}
    dispatch.reset_launches()  # counts of this path's run only
    probe_rows = [packed_read(probe.step(probe_batch((unroll, pb)), probe_batch((pb,))))
                  for _ in range(probe_steps)]
    probe_got = {k: dispatch.launches(k) for k in probe_want}
    del probe, theta
    torch.cuda.empty_cache()
    out = {"model_dtype": cfg.dtype, "batch": batch, "seq": seq, "unroll": unroll,
           "meta_batch": meta_batch, "microbatch": m, "steps": rows,
           "launches": got, "launches_predicted": want,
           "f16_ce_probe": {"classes": classes, "d": d, "batch": pb, "steps": probe_rows,
                            "launches": probe_got}}
    log("scale_f16_probe: " + json.dumps(out["f16_ce_probe"]))
    if probe_got != probe_want or not all(math.isfinite(r["base_loss"]) for r in probe_rows):
        raise AssertionError(f"scale f16 probe: launches {probe_got} != {probe_want} "
                             f"or a loss not finite: {probe_rows}")
    return out


def phase_dataopt(cfg, dev, out_dir, n=4096, n_meta=512, n_test=512, seq=128, steps=20,
                  unroll=2, batch=32):
    """16: ``DataOptimizer`` at bert-base in its own dtypes on WRENCH-analog
    data: the meta scorer (SAMA, 20 steps, unroll 2, batch and meta batch
    32, EMA uncertainty) with its launches held to the code's prediction
    (the meta steps' as phase 8, plus L attention forwards per scoring
    batch, three scoring passes: at steps 10 and 20 and the final one);
    the scoring pass alone in rows/s; prune(0.3, class-balanced), retrain
    (20 steps), evaluate on a test split; three reweighted batches; export
    and load bitwise; el2n on all rows and grand on 64; the scoring pass's
    per-example losses through the kernels against plain_everywhere on the
    first 256 rows within 2e-2 + 2e-2 relative."""
    from repro_torch import dataopt, tree
    from repro_torch.kernels import dispatch, flash_attn
    from repro_torch.models import Model

    model = Model(cfg, device=dev)
    train, meta = _wrench(cfg, seq, n, n_meta, SEED + 120)
    test, _ = _wrench(cfg, seq, n_test, 1, SEED + 123)
    out, t0 = {}, time.perf_counter()
    opt = dataopt.DataOptimizer(model, train, meta=meta, scorer="meta", steps=steps,
                                unroll=unroll, batch=batch, meta_batch=batch,
                                uncertainty="ema", seed=SEED + 121)
    L, K = cfg.num_layers, unroll
    leaves = len(tree.tree_leaves(model.init(SEED)))
    per_pass = L * math.ceil(n / opt.ctx.batch_size)
    passes = steps // 10 + 1  # score_every 10, and the final pass
    want = {flash_attn.FWD: steps * (L * (K + 3) + L * (K + 1)) + passes * per_pass,
            flash_attn.DQ: steps * L * (K + 1), flash_attn.DKV: steps * L * (K + 1),
            "adam_adapt": steps * leaves}
    dispatch.reset_launches()  # counts of this path's run only
    t1 = time.perf_counter()
    scores = opt.fit_scores()
    out["fit_scores_s"] = time.perf_counter() - t1
    got = {k: dispatch.launches(k) for k in want}
    out.update({"launches": got, "launches_predicted": want})
    if got != want:
        raise AssertionError(f"dataopt: launches {got} != {want}")
    if scores.shape != (n,) or not np.all((scores > 0) & (scores < 1)):
        raise AssertionError(f"dataopt: meta scores {scores.shape} outside (0, 1)")

    pruned, mask = opt.prune(0.3, class_balanced=True)
    theta = opt.retrain(steps=20, mask=mask, batch=batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pe = opt.ctx.per_example_all(theta)
    pass_s = time.perf_counter() - t1
    out.update({"scoring_pass_rows_per_s": n / pass_s, "scoring_pass_s": pass_s,
                "kept": int(mask.sum()), "accuracy": opt.evaluate(theta, test),
                "scores_mean": float(scores.mean()), "scores_std": float(scores.std())})
    first = {k: v[:256] for k, v in train.items()}
    kern = dataopt.score_dataset(model.classifier_per_example, theta, first, device=dev)
    with dispatch.plain_everywhere():
        plain = dataopt.score_dataset(model.classifier_per_example, theta, first, device=dev)
    excess = float(np.max(np.abs(kern.loss - plain.loss) / (2e-2 + 2e-2 * np.abs(plain.loss))))
    out["score_loss_vs_plain_share_of_bound"] = excess
    if not excess <= 1.0 or not np.allclose(kern.loss, pe.loss[:256], rtol=1e-6, atol=1e-6):
        raise AssertionError(f"dataopt: kernel losses vs plain {excess:.3f} of the bound")

    it = opt.reweighted_iterator(batch_size=batch, meta_batch_size=batch, unroll=unroll)
    shapes = [tuple(next(it)[0]["tokens"].shape) for _ in range(3)]
    if shapes != [(unroll, batch, seq)] * 3:
        raise AssertionError(f"dataopt: reweighted batches {shapes}")
    path = opt.export(os.path.join(out_dir, "dataopt_scores"), mask=mask)
    loaded = dataopt.DataOptimizer(model, train, scorer="meta", device=dev).load(path)
    if not np.array_equal(loaded, scores):
        raise AssertionError("dataopt: exported scores do not load back bitwise")

    el2n = dataopt.DataOptimizer(model, train, scorer="el2n", seed=SEED + 124).fit_scores()
    grand = dataopt.DataOptimizer(model, {k: v[:64] for k, v in train.items()},
                                  scorer="grand", seed=SEED + 125).fit_scores()
    for name, s in (("el2n", el2n), ("grand", grand)):
        if not np.all(np.isfinite(s)):
            raise AssertionError(f"dataopt: {name} scores not finite")
    out.update({"el2n_mean": float(el2n.mean()), "grand_mean": float(grand.mean()),
                "n": n, "n_meta": n_meta, "n_test": n_test, "seq": seq, "steps": steps,
                "reweighted_batches": shapes, "seconds": time.perf_counter() - t0})
    del opt, theta
    torch.cuda.empty_cache()
    log("dataopt: " + json.dumps(out))
    out["export_path"] = path
    return out


# ---------------------------------------------------------------------------
# phase 17: the distributed schedules
# ---------------------------------------------------------------------------

def _dist_kernels():
    """The kernels of the training path, held launched on every rank."""
    from repro_torch.kernels import flash_attn

    return (flash_attn.FWD, flash_attn.DQ, flash_attn.DKV, "adam_adapt")


def _digest(state):
    """sha256 over every leaf's bytes: two ranks' states bitwise equal."""
    from repro_torch import tree

    h = hashlib.sha256()
    for x in tree.flatten_with_keys(state)[1]:
        h.update(x.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _bitwise_step(got, ref):
    from repro_torch import tree

    (gs, gm), (rs, rm) = got, ref
    la, lb = tree.flatten_with_keys(gs)[1], tree.flatten_with_keys(rs)[1]
    return (len(la) == len(lb) and all(torch.equal(a, b) for a, b in zip(la, lb))
            and all(torch.equal(gm[k], rm[k]) for k in rm))


def _dist_bert(dev, unroll, mesh=None, schedule="auto"):
    """bert-base in f32 with base Adam eps 1e-3 (phase 7's learner), on a
    mesh with a schedule or, without one, the one-process Engine step."""
    from repro_torch import configs, optim
    from repro_torch.models import Model

    cfg = configs.get_config("bert-base").replace(dtype="float32")
    model = Model(cfg, device=dev)
    knobs = {} if mesh is None else {"mesh": mesh, "schedule": schedule, "model_cfg": cfg}
    return cfg, model, _learner(model, dev, unroll, optim.adam(1e-3, eps=1e-3), **knobs)


def _dist_rank(rank, out_dir, batch, seq, unroll, steps):
    """17(b) and (c) on one of two gloo ranks sharing cuda:0 (spawned: the
    parent holds a CUDA context). Rank 0 also runs the one-process
    references, outside the timed steps: a barrier before each step's
    clock starts keeps rank 1 from timing its wait for rank 0's reference.
    Then each rank times a lone all-reduce of one base bucket (theta's
    elements in f32). Results go to phase17_rank{rank}.pt."""
    from repro_torch import dataopt, tree
    from repro_torch.obs.metrics import packed_read
    from repro_torch.kernels import dispatch
    from repro_torch.launch import distributed as D
    from repro_torch.launch.mesh import make_data_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_data_mesh(device=dev)
    cfg, model, man = _dist_bert(dev, unroll, mesh, "single_sync")
    pj = _learner(model, dev, unroll, man.base_opt, mesh=mesh, schedule="pjit")
    one = _learner(model, dev, unroll, man.base_opt) if rank == 0 else None
    train, _ = _wrench(cfg, seq, 256, 16, SEED + 170)
    state0 = man.state
    out = {"rank": rank, "backend": mesh.backend, "digests": {}}

    # identical shards: both ranks' rows are one 16-row batch
    b16, m16 = _warm_batches(train, dev, batch, unroll, SEED + 171)(0)
    tiled_b = {k: torch.cat([v, v], dim=1) for k, v in b16.items()}
    tiled_m = {k: torch.cat([v, v], dim=0) for k, v in m16.items()}
    ref = one.step_fn(state0, b16, m16) if rank == 0 else None
    for name, learner in (("manual", man), ("pjit", pj)):
        got = learner.step_fn(state0, tiled_b, tiled_m)
        out["digests"][f"identical/{name}"] = _digest(got[0])
        if rank == 0:
            out[f"identical_bitwise/{name}"] = _bitwise_step(got, ref)
        del got
    del ref

    # distinct shards: 32 rows, 16 per rank, phase 7's held step pairs
    # against the emulation (manual) and the one-process 32-row step (pjit)
    batches = _warm_batches(train, dev, 2 * batch, unroll, SEED + 172)
    for name, learner in (("manual", man), ("pjit", pj)):
        state, walls, census, rows, metrics_by_step = state0, [], [], [], []
        launches = dict.fromkeys(_dist_kernels(), 0)
        for i in range(steps):
            base, meta = batches(i)
            torch.cuda.synchronize()
            dispatch.reset_launches()  # the distributed step's own, not the references'
            D.collective("barrier", None, mesh)  # both clocks start together
            t0 = time.perf_counter()
            with D.CollectiveCounter() as counter:
                new, metrics = learner.step_fn(state, base, meta)
                got = packed_read(metrics)
            walls.append(time.perf_counter() - t0)
            launches = {k: n + dispatch.launches(k) for k, n in launches.items()}
            census.append((counter.counts["all-reduce"], counter.bytes["all-reduce"]))
            metrics_by_step.append(got)
            out["digests"][f"{name}/{i}"] = _digest(new)
            if rank == 0:
                if name == "manual":
                    ref_s, ref_m = D.emulate_manual_step(man.spec, man.base_opt, man.meta_opt,
                                                         man.cfg, 2, state, base, meta)
                else:
                    ref_s, ref_m = one.step_fn(state, base, meta)
                diff = _diff(got, packed_read(ref_m), {"theta": new.theta, "lam": new.lam},
                             {"theta": ref_s.theta, "lam": ref_s.lam}, state)
                del ref_s
                _hold(f"distributed {name} step {i}", diff)
                rows.append(diff)
            state = new
        out[name] = {"walls_s": walls, "census": census, "held": rows, "launches": launches,
                     "metrics": metrics_by_step}
    del state, new

    # one base bucket's all-reduce alone, as the schedules make it
    bucket = torch.zeros(sum(x.numel() for x in tree.tree_leaves(state0.theta)),
                         dtype=torch.float32, device=dev)
    out["bucket_bytes"], out["bucket_all_reduce_s"] = bucket.numel() * 4, []
    for _ in range(3):
        torch.cuda.synchronize()
        D.collective("barrier", None, mesh)
        t0 = time.perf_counter()
        D.collective("all-reduce", bucket, mesh)
        torch.cuda.synchronize()
        out["bucket_all_reduce_s"].append(time.perf_counter() - t0)
    del bucket

    # (c) sharded scoring on both ranks; rank 0 holds it against the
    # one-device pass
    theta = state0.theta
    scores = {}
    for scorer in ("loss", "el2n"):
        opt = dataopt.DataOptimizer(model, train, scorer=scorer, theta=theta, batch_size=64,
                                    mesh=mesh)
        scores[scorer] = opt.fit_scores()
        if rank == 0:
            want = dataopt.DataOptimizer(model, train, scorer=scorer, theta=theta,
                                         batch_size=64, device=dev).fit_scores()
            worst = float(np.max(np.abs(scores[scorer] - want)
                                 / (1e-7 + 1e-5 * np.abs(want))))
            out[f"scoring/{scorer}_share_of_bound"] = worst
            if not worst <= 1.0:
                raise AssertionError(f"sharded {scorer} scores: {worst:.3f} of the bound")
        out["digests"][f"scoring/{scorer}"] = hashlib.sha256(scores[scorer].tobytes()).hexdigest()
    torch.save(out, os.path.join(out_dir, f"phase17_rank{rank}.pt"))


def phase_distributed(dev, out_dir, batch=16, seq=128, unroll=2, steps=2):
    """17: the distributed schedules (``launch.distributed``) at bert-base's
    full width in f32, warm rows, base Adam eps 1e-3 (phase 7's setting).
    (a) NCCL, world 1, on cuda:0: ``MetaLearner(mesh=, schedule=
    "single_sync")``, two meta steps at batch 16, seq 128, unroll 2,
    each bitwise equal to the one-process Engine step from the same state,
    with exactly unroll + 1 = 3 all-reduces per step. (b) Two gloo ranks
    sharing cuda:0 (``distributed.spawn``, the spawn start method): with
    identical 16-row shards both schedules bitwise equal to the one-process
    step on one shard; with distinct shards (32 rows) two manual steps
    held to ``emulate_manual_step`` and two pjit steps to the one-process
    step on the 32 rows, phase 7's tolerances, which must hold the two
    schedules' first steps apart; the two ranks' states bitwise equal
    after every step (sha256); the census (3 manual, the code's count for
    pjit, above 3) with bytes and each rank's step walls, beside a lone
    all-reduce of one base bucket; the
    flash forward, dq, dk/dv and adam_adapt launched on every rank. Two
    processes time-share one card and gloo stages each all-reduce through
    the host: this is not the paper's multi-GPU throughput. (c) On the two
    ranks, ``DataOptimizer(mesh=)`` loss and el2n scores within
    tests/test_torch_dataopt.py's f32 tolerance (1e-5 relative) of the
    one-device pass. Phase 24 runs the model axis."""
    import torch.distributed as dist

    from repro_torch.obs.metrics import packed_read
    from repro_torch.kernels import dispatch
    from repro_torch.launch import distributed as D
    from repro_torch.launch import mesh as M

    res = {}
    store_dir = os.path.join(out_dir, "phase17")
    shutil.rmtree(store_dir, ignore_errors=True)
    os.makedirs(store_dir)

    # (a) NCCL, world 1
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store_dir, "nccl"), 1),
                            rank=0, world_size=1)
    try:
        mesh = M.make_data_mesh(device=dev)
        if mesh.backend != "nccl":
            raise AssertionError(f"17(a): the mesh runs {mesh.backend}, not nccl")
        cfg, model, man = _dist_bert(dev, unroll, mesh, "single_sync")
        eng = _learner(model, dev, unroll, man.base_opt)
        train, _ = _wrench(cfg, seq, 256, 16, SEED + 173)
        batches = _warm_batches(train, dev, batch, unroll, SEED + 174)
        state, rows = man.state, []
        launches = dict.fromkeys(_dist_kernels(), 0)
        for i in range(steps):
            base, meta = batches(i)
            dispatch.reset_launches()  # the schedule's step, not the reference's
            with D.CollectiveCounter() as counter:
                got = man.step_fn(state, base, meta)
            launches = {k: n + dispatch.launches(k) for k, n in launches.items()}
            ref = eng.step_fn(state, base, meta)
            ok = _bitwise_step(got, ref)
            rows.append({"bitwise": ok, "all_reduces": counter.counts["all-reduce"],
                         "bytes": counter.bytes["all-reduce"], **packed_read(got[1])})
            if not ok or counter.counts["all-reduce"] != unroll + 1:
                raise AssertionError(f"17(a) step {i}: {rows[-1]}")
            state = got[0]
            del ref
        res["nccl_world1"] = {"steps": rows, "launches": launches}
        if not all(v > 0 for v in res["nccl_world1"]["launches"].values()):
            raise AssertionError(f"17(a): launches {res['nccl_world1']['launches']}")
        del man, eng, state, got, model
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    log("distributed_nccl_world1: " + json.dumps(res["nccl_world1"]))

    # (b), (c): two gloo ranks sharing the card
    t0 = time.perf_counter()
    D.spawn(_dist_rank, 2, (store_dir, batch, seq, unroll, steps), store_dir=store_dir,
            backend="gloo", timeout_s=900)
    ranks = [torch.load(os.path.join(store_dir, f"phase17_rank{r}.pt"), weights_only=False)
             for r in range(2)]
    r0, r1 = ranks
    if r0["digests"] != r1["digests"]:
        bad = [k for k in r0["digests"] if r0["digests"][k] != r1["digests"].get(k)]
        raise AssertionError(f"17(b): the ranks' states differ after {bad}")
    for name in ("manual", "pjit"):
        if not r0[f"identical_bitwise/{name}"]:
            raise AssertionError(f"17(b): {name} on identical shards is not bitwise the "
                                 "one-process step")
        counts = {c for r in ranks for c, _ in r[name]["census"]}
        if name == "manual" and counts != {unroll + 1}:
            raise AssertionError(f"17(b): manual census {counts}")
        if name == "pjit" and (len(counts) != 1 or not min(counts) > unroll + 1):
            raise AssertionError(f"17(b): pjit census {counts}")
        if r0[name]["launches"] != r1[name]["launches"] or not all(
                v > 0 for v in r0[name]["launches"].values()):
            raise AssertionError(f"17(b): {name} launches by rank "
                                 f"{[r[name]['launches'] for r in ranks]}")
    # the held tolerances must tell the schedules apart: from one state and
    # one batch, manual and pjit lie this many F32_TOLs apart
    first = [r0[name]["metrics"][0] for name in ("manual", "pjit")]
    apart = {k: abs(first[0][k] - first[1][k]) / (F32_TOL[k] * abs(first[1][k]))
             for k in ("eps", "hypergrad_norm")}
    if not max(apart.values()) > 1.0:
        raise AssertionError(f"17(b): manual and pjit within the held tolerance {apart}: "
                             "the oracles cannot tell the schedules apart")
    summary = {"manual_vs_pjit_step0_in_tolerances": apart}
    for name in ("manual", "pjit"):
        summary[name] = {
            "all_reduces_per_step": r0[name]["census"][0][0],
            "all_reduce_bytes_per_step": r0[name]["census"][0][1],
            "wall_ms_by_rank": [[1e3 * w for w in r[name]["walls_s"]] for r in ranks],
            "wall_ms_median_by_rank": [1e3 * float(np.median(r[name]["walls_s"][1:]))
                                       for r in ranks],
            "launches_per_rank": [r[name]["launches"] for r in ranks],
            "worst_vs_reference": {k: max(d[k][2] for d in r0[name]["held"])
                                   for k in F32_TOL},
            "theta_share_of_bound": max(d["theta_share_of_bound"] for d in r0[name]["held"]),
            "lam_share_of_bound": max(d["lam_share_of_bound"] for d in r0[name]["held"])}
    res["gloo_2_ranks"] = {
        "backend": r0["backend"], "batch_per_rank": batch, "seq": seq, "unroll": unroll,
        "steps": steps, "identical_shards_bitwise": True, "ranks_bitwise_equal": True,
        **summary, "bucket_bytes": r0["bucket_bytes"],
        "bucket_all_reduce_ms_by_rank": [[1e3 * w for w in r["bucket_all_reduce_s"]]
                                         for r in ranks],
        "seconds": time.perf_counter() - t0,
        "caveat": "two processes time-share one card and gloo stages every all-reduce "
                  "through the host: not the paper's multi-GPU throughput"}
    res["sharded_scoring"] = {k: v for k, v in r0.items() if k.startswith("scoring/")}
    log("distributed_gloo_2_ranks: " + json.dumps(res["gloo_2_ranks"]))
    log("distributed_scoring: " + json.dumps(res["sharded_scoring"]))
    return res


# ---------------------------------------------------------------------------
# phase 24: the model axis (FSDP over the model process group)
# ---------------------------------------------------------------------------

#: gemma3-1b's depth in 24(c) (cut from 26): two ranks of the pure
#: data-parallel (2, 1) mesh share the card there, each holding the whole
#: f32 state (37.0 GB a rank at 12 layers; one rank at all 26 takes 56.5
#: GB, phase 15(b)), and 24(c) runs (1, 2) at the same depth so that the
#: two meshes' peaks compare
MODEL_AXIS_GEMMA_LAYERS = 12
#: phase 24's runs: (case, world, [(mesh shape, learners, meta steps)]), all
#: in one spawn of MODEL_AXIS_WORLD ranks (each rank pays its start-up
#: once), a mesh of two ranks on ranks 0-1 alone.
#: bert-base's four ranks run (2, 2) and then, on ranks 0-1 alone, (1, 2):
#: the manual and pjit schedules with base Adam and the manual one with
#: base Adafactor; qwen2-moe's two ranks run (1, 2), its SMOKE widths at S
#: 16 (each MoE layer gathers the data shard's 64 tokens, one dispatch
#: group) and at S 512 (each rank's 1,024 tokens a whole dispatch group:
#: the load-balance statistics summed over the group); gemma3-1b's two
#: ranks run (2, 1) and then (1, 2), one step each: the first step of a
#: process pays its warm-up (cuBLAS, the kernels' function attributes, the
#: allocator's growth, gloo's connections), so the (1, 2) step's wall is
#: the warm one (repeats cut for the run's time limit)
MODEL_AXIS_WORLD = 4
MODEL_AXIS_RUNS = (("bert", 4, (((2, 2), ("manual",), 1),
                                ((1, 2), ("manual", "pjit", "adafactor"), F32_PAIRS))),
                   ("qwen", 2, (((1, 2), ("gathered", "whole_groups"), 1),)),
                   ("gemma", 2, (((2, 1), ("manual",), 1), ((1, 2), ("manual",), 1))))
#: qwen2-moe's sequence length per learner of 24(d) (4 rows a data shard)
MODEL_AXIS_QWEN_SEQ = {"gathered": 16, "whole_groups": 512}


def _model_axis_layouts():
    """The FSDP layouts phase 24 runs, as (config, model extent): bert-base
    at model extent 2 in 24(a-b), gemma3-1b at MODEL_AXIS_GEMMA_LAYERS
    layers and model extent 2 in 24(c)."""
    from repro_torch import configs

    return [(configs.get_config("bert-base").replace(dtype="float32"), 2),
            (configs.get_config("gemma3-1b").replace(num_layers=MODEL_AXIS_GEMMA_LAYERS), 2)]


def _shard_sizes():
    """The element counts of the blocks phase 24's ranks hold of each
    sharded leaf (from shapes alone, on the meta device), where
    ``adam_adapt`` runs on them: phase 4 holds the kernel at each."""
    from repro_torch import tree
    from repro_torch.launch import sharding
    from repro_torch.models import Model

    sizes = set()
    for cfg, m in _model_axis_layouts():
        shapes = Model(cfg, device="meta").init(SEED)
        mesh = dataclasses.make_dataclass("ShapeMesh", ["shape", "axis_names"])(
            {"data": 1, "model": m}, ("data", "model"))
        _, specs = sharding.param_specs(shapes, mesh, cfg)
        for x, spec in zip(tree.flatten_with_keys(shapes)[1], specs):
            if sharding.model_dim(spec) is not None:
                sizes.add(x.numel() // m)
    return tuple(sorted(sizes))


def _replicated_digest(learner):
    """sha256 over the state's leaves that the layout does not shard
    (theta's and the base optimizer's replicated leaves, Adafactor's
    statistics along a replicated dim, lam, the meta optimizer's state,
    the step): a model group holds them bitwise alike."""
    from repro_torch import tree

    h = hashlib.sha256()
    leaves = tree.flatten_with_keys(learner.state)[1]
    dims = ([None] * len(leaves) if learner.sharding is None
            else learner.sharding.sharded_dims(learner.state))
    for x, dim in zip(leaves, dims):
        if dim is None:
            h.update(x.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _model_axis_learners(case, mesh, schedules, dev, unroll, held):
    """The learners of one phase 24 run on ``mesh``, by name ("manual" and
    "pjit": those schedules with base Adam; "adafactor": the manual
    schedule with base Adafactor; qwen's "gathered" and "whole_groups":
    the manual schedule at MODEL_AXIS_QWEN_SEQ), each as (name, learner,
    the one-process learner of the references (``held``) or None,
    batches(i) -> (base, meta), the kernels held and their launches per
    step (None: the reference step's own))."""
    from repro_torch import configs, optim, scale, tree
    from repro_torch.kernels import weighted_ce as wce
    from repro_torch.launch import train
    from repro_torch.models import Model

    kernels = _dist_kernels()
    if case == "bert":
        cfg, model, man = _dist_bert(dev, unroll, mesh, "single_sync")
        rows, _ = _wrench(cfg, 128, 256, 16, SEED + 240)
        batches = _warm_batches(rows, dev, 32, unroll, SEED + 241)
        want = _train_launches(cfg, unroll, len(tree.tree_leaves(man.state.theta)))
        out = []
        for s in schedules:
            if s == "adafactor":  # phase 11's base: lr 1e-3, eps 1e-3
                opt = optim.adafactor(1e-3, eps=1e-3)
                learner = _learner(model, dev, unroll, opt, mesh=mesh, model_cfg=cfg)
                ks = kernels[:-1] + ("adafactor_adapt",)
                w = {**{k: want[k] for k in kernels[:-1]}, "adafactor_adapt": want["adam_adapt"]}
            else:
                opt = man.base_opt
                learner = man if s == "manual" else _learner(
                    model, dev, unroll, opt, mesh=mesh, schedule=s, model_cfg=cfg)
                ks, w = kernels, want
            one = _learner(model, dev, unroll, opt) if held else None
            out.append((s, learner, one, batches, ks, w))
        return out
    if case == "qwen":
        cfg = configs.get_smoke_config("qwen2-moe-a2.7b")
        model = Model(cfg, device=dev)
        opt = optim.adam(1e-3, eps=1e-3)
        return [(s, _learner(model, dev, unroll, opt, mesh=mesh, model_cfg=cfg),
                 _learner(model, dev, unroll, opt),
                 _lm_warm_batches(cfg, dev, 4, MODEL_AXIS_QWEN_SEQ[s], unroll, SEED + 243),
                 kernels[:-1] + ("adam_adapt", wce.FWD, wce.BWD), None) for s in schedules]
    cfg = configs.get_config("gemma3-1b").replace(num_layers=MODEL_AXIS_GEMMA_LAYERS)
    model = Model(cfg, device=dev)
    learners = [(s, _learner(model, dev, unroll, optim.adam(1e-3), mesh=mesh,
                             schedule={"manual": "single_sync"}.get(s, s), model_cfg=cfg,
                             scale=scale.ScaleConfig(policy="bf16")))
                for s in schedules]
    make_batch = train.make_batch_fn(cfg, 1024, dev, np.random.default_rng(SEED + 242))
    batches = lambda i: (make_batch(4, unroll), make_batch(2))  # noqa: E731
    want = _lm_want(cfg, unroll, len(tree.tree_leaves(learners[0][1].state.theta)))
    return [(s, learner, None, batches, kernels + (wce.FWD, wce.BWD), want)
            for s, learner in learners]


def _model_axis_rank(rank, out_dir, unroll):
    """One rank of phase 24 (spawned, gloo, sharing cuda:0): each case of
    MODEL_AXIS_RUNS and each of its runs (mesh shape, learners, meta
    steps) in turn, its learners made and freed; a mesh of two ranks runs
    on ranks 0-1 alone. "bert": phase 17's bert-base learner (f32, base Adam eps
    1e-3; and phase 11's base Adafactor) on 32 rows, every step held on
    rank 0 against the one-process step from the gathered state (the
    Engine step on the global batch; at a data extent of 2 the emulated
    single-sync step of 2 data shards); at (1, 2) ranks 0-1 alone run.
    "qwen": qwen2-moe-a2.7b's SMOKE model (f32, base Adam eps 1e-3), 4
    rows at MODEL_AXIS_QWEN_SEQ, every step held on every rank against
    the one-process Engine step, whose launches the step's are held to.
    "gemma": gemma3-1b at MODEL_AXIS_GEMMA_LAYERS layers under the bf16
    policy, B 4, S 1024, meta batch 2. Per step: the census per group and
    kind, the wall, the launches (held to the one-process counts) and, for
    bert and qwen, sha256 digests; per run each rank's peak memory; per
    case its seconds. Results to phase24_{case}_rank{rank}.pt."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pair = dist.new_group([0, 1])  # every rank enters it
    for case, world, runs in MODEL_AXIS_RUNS:
        t_case = time.perf_counter()
        _model_axis_case(rank, out_dir, case, world, runs, unroll, dev, pair)
        if rank == 0:
            log(f"model_axis_{case}_seconds: {time.perf_counter() - t_case:.1f}")
    dist.barrier()  # ranks 2-3 stay in the world until ranks 0-1 are done


def _model_axis_case(rank, out_dir, case, world, runs, unroll, dev, pair):
    """One case of phase 24 on this rank (:func:`_model_axis_rank`)."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import distributed as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs.metrics import packed_read

    out = {"rank": rank, "runs": {}}
    for shape, schedules, steps in runs:
        if shape[0] * shape[1] < MODEL_AXIS_WORLD:
            if rank > 1:
                continue
            mesh = make_mesh(shape, ("data", "model"), group=pair, device=dev)
        else:
            mesh = make_mesh(shape, ("data", "model"), device=dev)
        learners = _model_axis_learners(case, mesh, schedules, dev, unroll,
                                        held=case == "qwen" or (case == "bert" and rank == 0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = {"world_rank": mesh.world_rank, "coords": mesh.coords(), "backend": mesh.backend,
               "sharded_leaves": 0 if learners[0][1].sharding is None else len(
                   learners[0][1].sharding.sharded)}
        for name, learner, one, batches, kernels, want in learners:
            state, rows = learner.state, []
            for i in range(steps):
                base, meta = batches(i)
                # the whole state, gathered on every rank (a collective), for
                # the one-process reference
                before = learner.sharding.unshard(state) if case != "gemma" else None
                ref = None
                if want is None:  # the one-process step's launches
                    dispatch.reset_launches()
                    ref = one.step_fn(before, base, meta)
                    want = {k: dispatch.launches(k) for k in kernels}
                torch.cuda.synchronize()
                dispatch.reset_launches()  # the model axis's step only
                D.collective("barrier", None, mesh, over="world")  # the clocks start together
                t0 = time.perf_counter()
                with D.CollectiveCounter() as counter:
                    new, metrics = learner.step_fn(state, base, meta)
                    got = packed_read(metrics)
                wall = time.perf_counter() - t0
                launches = {k: dispatch.launches(k) for k in kernels}
                if launches != {k: want[k] for k in kernels}:
                    raise AssertionError(f"24 {case} {shape} {name} step {i}: launches "
                                         f"{launches} != {want}")
                row = {"wall_s": wall, "metrics": got, "launches": launches,
                       "census": {g: dict(v) for g, v in counter.by_group.items()},
                       "census_bytes": {g: dict(v) for g, v in counter.bytes_by_group.items()}}
                if case != "gemma":
                    full_new = learner.sharding.unshard(new)
                    if one is not None:
                        if ref is not None:
                            ref_s, ref_m = ref
                        elif shape[0] == 1:
                            ref_s, ref_m = one.step_fn(before, base, meta)
                        else:
                            ref_s, ref_m = D.emulate_manual_step(
                                one.spec, one.base_opt, one.meta_opt, one.cfg, shape[0],
                                before, base, meta)
                        diff = _diff(got, packed_read(ref_m),
                                     {"theta": full_new.theta, "lam": full_new.lam},
                                     {"theta": ref_s.theta, "lam": ref_s.lam}, before)
                        _hold(f"model axis {case} {shape} {name} step {i}", diff)
                        row["held"] = diff
                        del ref_s
                    del full_new
                del before, ref
                learner.state = state = new
                if case != "gemma":  # gemma's trees would take seconds to hash on the host
                    row["replicated_digest"] = _replicated_digest(learner)
                    if shape[0] > 1:
                        row["digest"] = _digest(state)
                rows.append(row)
            res[name] = rows
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out["runs"][shape] = res
        del learners, learner, one, state, new
        torch.cuda.empty_cache()
    if rank < world:
        torch.save(out, os.path.join(out_dir, f"phase24_{case}_rank{rank}.pt"))


def _model_axis_checks(tag, shape, ranks, unroll):
    """Phase 24's holds over one run's ranks: a model group's replicated
    leaves and metrics bitwise alike, a data group's blocks alike, the
    data group's K + 1 all-reduces a manual step (K + 4 pjit), the model
    group's gathers."""
    m = shape[1]
    for name, rows in ranks[0].items():
        if not isinstance(rows, list):
            continue
        for i in range(len(rows)):
            for r, res in enumerate(ranks):
                a, b = ranks[r - r % m][name][i], res[name][i]
                if a["metrics"] != b["metrics"] or a.get("replicated_digest") != \
                        b.get("replicated_digest"):
                    raise AssertionError(f"24 {tag} {name} step {i}: rank {r} departs from "
                                         f"its model group's rank {r - r % m}")
                if r >= m and b.get("digest") != ranks[r % m][name][i].get("digest"):
                    raise AssertionError(f"24 {tag} {name} step {i}: the data group of rank "
                                         f"{r} holds other blocks")
                want = unroll + 4 if name == "pjit" else unroll + 1
                if b["census"].get("data", {}).get("all-reduce") != want:
                    raise AssertionError(f"24 {tag} {name}: data census {b['census']}")
                if m > 1 and not b["census"].get("model", {}).get("all-gather"):
                    raise AssertionError(f"24 {tag} {name}: no gather {b['census']}")


def phase_model_axis(dev, out_dir, unroll=2):
    """24: the model mesh axis, FSDP over the model process group
    (``launch.fsdp``): one spawn of MODEL_AXIS_WORLD gloo ranks on cuda:0,
    as phase 17's, its two-rank meshes on ranks 0-1.
    (b) bert-base at full width and depth in f32 (phase 17's learner) on
    four ranks at (2, 2): one manual step on 32 rows held against the
    single-sync step of 2 data shards emulated in one process; the data
    group's ranks hold the same blocks. (a) Then ranks 0-1 at (data 1,
    model 2): F32_PAIRS manual and pjit steps, each held on rank 0 at phase
    7's tolerances against the one-process Engine step on the same 32 rows
    from the gathered state. On both: the flash forward, dq, dk/dv and
    adam_adapt launched on every rank at the one-process counts; the model
    group's replicated leaves bitwise equal (sha256); the census per group
    and kind; at (1, 2) also F32_PAIRS manual steps with an Adafactor base
    (phase 11's: lr 1e-3, eps 1e-3), held the same way. (d) qwen2-moe's
    SMOKE model at (1, 2) at MODEL_AXIS_QWEN_SEQ: a MoE layer's dispatch
    groups and load-balance loss over the whole data shard, gathered or
    summed over the model group, each step held on both ranks against the
    one-process Engine step and launching what it launches. (c) gemma3-1b
    at full width (d_model 1,152, V 262,144) and MODEL_AXIS_GEMMA_LAYERS
    layers under the bf16 policy, B 4, S 1024, meta batch 2, on two
    ranks: one manual step at (2, 1), then one at (1, 2); each rank's peak
    memory and walls; the CE kernels launched too. Ranks time-share one
    card and gloo stages every collective through the host: the walls
    measure gloo, not the schedule."""
    from repro_torch.launch import distributed as D

    store_dir = os.path.join(out_dir, "phase24")
    shutil.rmtree(store_dir, ignore_errors=True)
    os.makedirs(store_dir)
    res = {}
    D.spawn(_model_axis_rank, MODEL_AXIS_WORLD, (store_dir, unroll), store_dir=store_dir,
            backend="gloo", timeout_s=900)
    for case, world, runs in MODEL_AXIS_RUNS:
        ranks = [torch.load(os.path.join(store_dir, f"phase24_{case}_rank{r}.pt"),
                            weights_only=False) for r in range(world)]
        for shape, schedules, steps in runs:
            tag = f"{case}_{shape[0]}x{shape[1]}"
            ran = [r["runs"][shape] for r in ranks if shape in r["runs"]]
            _model_axis_checks(tag, shape, ran, unroll)
            out = {"backend": ran[0]["backend"], "mesh": {"data": shape[0], "model": shape[1]},
                   "unroll": unroll, "sharded_leaves": ran[0]["sharded_leaves"],
                   "max_memory_allocated_by_rank": [r["max_memory_allocated"] for r in ran],
                   "caveat": "gloo-bound: ranks time-share one card and gloo stages every "
                             "collective through the host"}
            for name in schedules:
                rows = ran[0][name]
                out[name] = {
                    "steps": steps,
                    "wall_ms_by_rank": [[1e3 * x["wall_s"] for x in r[name]] for r in ran],
                    "census_per_step": rows[0]["census"],
                    "census_bytes_per_step": rows[0]["census_bytes"],
                    "launches_per_rank": [{k: sum(x["launches"][k] for x in r[name])
                                           for k in rows[0]["launches"]} for r in ran],
                    "metrics": [x["metrics"] for x in rows]}
                if case != "gemma":
                    out[name]["worst_vs_reference"] = {k: max(x["held"][k][2] for x in rows)
                                                       for k in F32_TOL}
                    for field in ("theta", "lam"):
                        out[name][f"{field}_share_of_bound"] = max(
                            x["held"][f"{field}_share_of_bound"] for x in rows)
            res[tag] = out
            log(f"model_axis_{tag}: " + json.dumps(out))
    torch.cuda.empty_cache()
    return res


PHASES = ("base_unroll", "local_terms", "meta_pass", "cd_passes", "finalize", "meta_update")
#: model ranges charged besides the phases (they lie inside them): the MoE
#: layer's forward and its recomputation, not the backward autograd runs
SPANS = ("apply_moe",)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_time_by_phase(trace_path):
    """Device time of a profiled step from its chrome trace: each kernel,
    copy or fill is charged to the innermost engine phase (a
    record_function range on the host) that holds the host call that
    launched it, matched by the trace's correlation ids; where a SPANS
    range occurs, the time launched within it is added as one more key.
    Returns (ms by phase, [(kernel name, (us, count))] by time, total
    device ms)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") in PHASES]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in SPANS]
    by_phase = {name: 0.0 for name in PHASES + ("outside the phases",)}
    in_spans = 0.0
    by_kernel = {}
    total = 0.0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        total += e["dur"]
        us, count = by_kernel.get(e["name"], (0.0, 0))
        by_kernel[e["name"]] = (us + e["dur"], count + 1)
        ts = launched.get(e.get("args", {}).get("correlation"))
        inner = [r for r in ranges if ts is not None and r[0] <= ts <= r[1]]
        name = min(inner, key=lambda r: r[1] - r[0])[2] if inner else "outside the phases"
        by_phase[name] += e["dur"]
        if ts is not None and any(a <= ts <= b for a, b in spans):
            in_spans += e["dur"]
    kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    by_phase = {k: v / 1e3 for k, v in by_phase.items()}
    if spans:
        by_phase["within " + "/".join(SPANS)] = in_spans / 1e3
    return by_phase, kernels, total / 1e3


def _timed_fit(tag, learner, it, steps, want_per_step, out_dir, trace_name, per_step):
    """One warm step, then ``steps`` meta steps through ``MetaLearner.fit``
    (metrics read every step: a sync each) with the launches of the
    kernels in ``want_per_step`` counted from 0 and held to steps x the
    count; step wall times, ``per_step`` units (samples, tokens) per
    second, peak memory; then one more step under torch.profiler (its
    launches outside the count): device time by phase and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.metrics import packed_read
    from repro_torch.kernels import dispatch

    packed_read(learner.step(*next(it)))  # warm: cuBLAS handles, kernel libraries
    stamps = []

    def timed():
        while True:
            stamps.append(time.perf_counter())
            yield next(it)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()  # counts of the main path's run only
    history = learner.fit(timed(), steps=steps, log_every=1)
    stamps.append(time.perf_counter())
    launches = {n: dispatch.launches(n) for n in want_per_step}
    peak = torch.cuda.max_memory_allocated()
    walls = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
    want = {n: steps * w for n, w in want_per_step.items()}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches} != {want}")
    for row in history:
        if not all(math.isfinite(row[k]) for k in ("base_loss", "meta_loss", "hypergrad_norm")):
            raise AssertionError(f"{tag}: non-finite metrics {row}")
    step_ms = float(np.median(walls))
    result = {"steps": steps, "step_ms_median": step_ms, "step_ms_min": min(walls),
              "step_ms_max": max(walls), "step_ms_all": walls,
              **{f"{unit}_per_s": n / step_ms * 1e3 for unit, n in per_step.items()},
              "max_memory_allocated": peak, "launches": launches,
              "launches_per_step": want_per_step,
              "first_and_last_metrics": [history[0], history[-1]]}
    log(f"{tag}: " + json.dumps(result))

    base_b, meta_b = next(it)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        packed_read(learner.step(base_b, meta_b))
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, f"{trace_name}_trace.json")
    prof.export_chrome_trace(trace_path)
    phases, kernels, device_ms = _device_time_by_phase(trace_path)
    with open(os.path.join(out_dir, f"{trace_name}_kernels.txt"), "w") as f:
        for key, (us, count) in kernels:
            f.write(f"{us:12.1f} us  {count:5d}x  {key}\n")
    prof_out = {"profiled_wall_ms": wall_ms, "device_ms": device_ms,
                "device_busy_share": device_ms / step_ms,
                "device_busy_share_of_profiled_step": device_ms / wall_ms,
                "kernel_launches": sum(c for _, (_, c) in kernels),
                "device_ms_by_phase": phases,
                "top": [{"name": k[:80], "ms": us / 1e3, "count": c}
                        for k, (us, c) in kernels[:15]]}
    log(f"{tag}_step_profile: " + json.dumps(prof_out))
    result["step_profile"] = prof_out
    return result


def _train_launches(cfg, unroll, leaves):
    """Per meta step: L(K+3) flash forwards + L(K+1) remat recomputes, L(K+1)
    dq and dk/dv over the L layers of flash attention (none with MLA;
    whisper's encoder and decoder), one adam_adapt per theta leaf."""
    from repro_torch.kernels import flash_attn

    L, K = _train_attn_layers(cfg), unroll
    return {flash_attn.FWD: L * (K + 3) + L * (K + 1), flash_attn.DQ: L * (K + 1),
            flash_attn.DKV: L * (K + 1), "adam_adapt": leaves}


def phase_train_bf16(cfg, dev, out_dir, batch=48, seq=128, unroll=2, steps=BF16_STEPS):
    """bert-base in its own dtype on WRENCH-analog data. Returns the result,
    the learner and its batch iterator (phase 14 saves and loads it)."""
    from repro_torch import data, optim, tree
    from repro_torch.models import Model

    model = Model(cfg, device=dev)
    train, meta = _wrench(cfg, seq, 1024, 256, SEED + 30)
    learner = _learner(model, dev, unroll, optim.adam(1e-3))
    it = data.BatchIterator(train, meta, batch_size=batch, meta_batch_size=batch,
                            unroll=unroll, seed=SEED + 31, device=dev)
    want = _train_launches(cfg, unroll, len(tree.tree_leaves(learner.state.theta)))
    result = _timed_fit("train_bf16", learner, it, steps, want, out_dir, "train_step",
                        {"samples": batch * unroll})
    result.update({"batch": batch, "seq": seq, "unroll": unroll})
    return result, learner, it


def phase_train_gemma_bf16(cfg, dev, out_dir, batch=4, seq=1024, unroll=2,
                           steps=BF16_STEPS):
    """gemma3-1b in its own dtypes (f32 parameters, bf16 activations): two
    steps of the train CLI at its default arch (its JSON lines finite),
    then ``steps`` meta steps at batch 4, seq 1024, unroll 2, meta batch 2
    (the CLI's batch // 2) on the CLI's LM stream. Tokens and samples per
    second count the base batches (K x B sequences of S tokens)."""
    import contextlib
    import io

    from repro_torch import optim, tree
    from repro_torch.launch import train
    from repro_torch.models import Model

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train.main(["--steps", "2", "--log-every", "1"])
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    if [r.get("step") for r in rows] != [0, 1] or not all(
            math.isfinite(r[k]) for r in rows for k in ("base_loss", "meta_loss",
                                                        "hypergrad_norm", "eps")):
        raise AssertionError(f"train CLI (default arch): {rows}")
    log(f"train_cli: default arch {cfg.name}, {time.perf_counter() - t0:.1f}s: "
        + json.dumps(rows))
    torch.cuda.empty_cache()

    model = Model(cfg, device=dev)
    learner = _learner(model, dev, unroll, optim.adam(1e-3))
    make_batch = train.make_batch_fn(cfg, seq, dev, np.random.default_rng(SEED + 60))

    def it():
        while True:
            yield make_batch(batch, unroll), make_batch(max(batch // 2, 1))

    want = _lm_want(cfg, unroll, len(tree.tree_leaves(learner.state.theta)))
    result = _timed_fit("train_gemma_bf16", learner, it(), steps, want, out_dir,
                        "train_gemma_step",
                        {"samples": batch * unroll, "tokens": batch * unroll * seq})
    result.update({"batch": batch, "seq": seq, "unroll": unroll,
                   "meta_batch": max(batch // 2, 1), "cli_rows": rows})
    return result


# ---------------------------------------------------------------------------
# phases 18-19: the moe family (qwen2-moe-a2.7b) and MLA (minicpm3-4b)
# ---------------------------------------------------------------------------


class _RouteRecorder:
    """Records the expert indices of every MoE routing call (the
    ``repro_torch.models.moe.route`` seam) while it is entered."""

    def __init__(self):
        self.idx = []

    def __enter__(self):
        from repro_torch.models import moe

        self._route = route = moe.route

        def recording(cfg, probs, capacity):
            out = route(cfg, probs, capacity)
            self.idx.append(out[0].detach())
            return out

        moe.route = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._route

    def flips(self):
        """The kernel step's calls against the plain step's (the first and
        second half of the record, one step each, call for call):
        [(call, token) rows whose chosen experts differ, rows, calls]."""
        n = len(self.idx) // 2
        if 2 * n != len(self.idx):
            raise AssertionError(f"routing: {len(self.idx)} calls, not two equal steps")
        diff = rows = 0
        for a, b in zip(self.idx[:n], self.idx[n:]):
            a, b = a.sort(-1).values, b.sort(-1).values
            diff += int((a != b).any(-1).sum())
            rows += a[..., 0].numel()
        self.idx = []
        return [diff, rows, n]


def _lm_want(cfg, unroll, leaves):
    from repro_torch.kernels import weighted_ce as wce

    return {wce.FWD: unroll + 3, wce.BWD: unroll + 1, **_train_launches(cfg, unroll, leaves)}


def _rounding_floor(learner, state, base, meta, seed, draws):
    """``draws`` plain steps from ``state``, each with every theta
    coordinate moved by about one f32 ulp (2^-23 relative, normal draws
    from ``seed``): [(metrics, {"theta", "lam"} on the host)]. Beside the
    plain step from ``state`` itself (``_diff``), the spread that rounding
    alone gives the step."""
    from repro_torch import tree
    from repro_torch.obs.metrics import packed_read
    from repro_torch.kernels import dispatch

    gen = torch.Generator(device=state.step.device).manual_seed(seed)
    out = []
    for _ in range(draws):
        theta = tree.tree_map(lambda x: x * (1 + 2.0 ** -23 * torch.randn(
            x.shape, generator=gen, device=x.device)), state.theta)
        with dispatch.plain_everywhere():
            moved, metrics = learner.step_fn(state._replace(theta=theta), base, meta)
        out.append((packed_read(metrics),
                    tree.tree_map(lambda x: x.cpu(), {"theta": moved.theta, "lam": moved.lam})))
        del theta, moved
    return out


def phase_family_train_f32(base_cfg, dev, layers, tag, batch=2, seq=1024, unroll=2,
                           steps=F32_PAIRS,
                           floor_draws=0):
    """Full width, depth ``layers``, f32, the per-sequence LM loss, batch
    2, seq 1024, unroll 2, warm rows, base Adam eps 1e-3: F32_PAIRS step pairs,
    kernels against plain_everywhere from one state, with the launches held
    to the code's formula. A MoE config counts the (call, token) rows whose
    chosen experts differ between the two steps: the router reads inputs
    that differ by rounding, and a token whose k-th and (k+1)-th gate
    probabilities lie within it takes another expert (an O(1) change of its
    output). With none, the pair is held at phase 7's tolerances; with
    some, the line says so and only the losses are held.

    With ``floor_draws`` (rwkv6 in phase 21, whose step at its init is
    chaotic at rounding level: ROADMAP queue 3), each state also takes
    that many plain steps from theta moved by about one ulp
    (``_rounding_floor``), each compared with the plain step as the kernel
    step is (``_diff``): their largest spread is the floor that rounding
    alone sets. Every quantity is then held at the larger of phase 7's
    bound and FLOOR_MARGIN times its floor: where rounding alone moves it
    beyond phase 7's bound, a kernel step can be held no closer than that,
    and is still held."""
    from repro_torch import optim, tree
    from repro_torch.models import Model

    cfg = base_cfg.replace(dtype="float32", num_layers=layers)
    model = Model(cfg, device=dev)
    batches = _lm_warm_batches(cfg, dev, batch, seq, unroll, SEED + 70)
    torch.cuda.reset_peak_memory_stats()
    learner = _learner(model, dev, unroll, optim.adam(1e-3, eps=1e-3))
    want = _lm_want(cfg, unroll, len(tree.tree_leaves(learner.state.theta)))
    n_params = model.num_params(learner.state.theta)
    # the learner lets go of the initial state and the kernel step's theta
    # waits on the host (host=True): at qwen2-moe's width the card holds one
    # state of three parameter-sized trees beside a step's own, with little
    # room to spare for the allocator's split free blocks
    state, learner.state, rows, flips, at_phase7 = learner.state, None, [], [], []
    with _RouteRecorder() as rec:
        for i in range(steps):
            base, meta = batches(i)  # each call draws new batches
            moved = (_rounding_floor(learner, state, base, meta, SEED + 90 + i, floor_draws)
                     if floor_draws else [])
            prev = state
            state, diff, launches, secs = _step_pair(learner, state, base, meta, tuple(want),
                                                     host=True)
            if launches != want:
                raise AssertionError(f"{tag} step {i}: launches {launches} != {want}")
            flip = rec.flips() if cfg.family == "moe" else [0, 0, 0]
            diff["routing_flips"] = flip
            diff["seconds_kernels_plain"] = list(secs)
            flips.append(flip[0])
            tol, limit = F32_TOL, None
            if moved:
                ref = {k: diff[k][1] for k in F32_TOL}
                ref_s = {"theta": state.theta, "lam": state.lam}
                spread = [_diff(m, ref, ms, ref_s, prev) for m, ms in moved]
                floor = {k: max(d[k][2] for d in spread) for k in F32_TOL}
                shares = {f: max(d[f"{f}_share_of_bound"] for d in spread)
                          for f in ("theta", "lam")}
                tol = {k: max(F32_TOL[k], FLOOR_MARGIN * floor[k]) for k in F32_TOL}
                limit = {f: max(1.0, FLOOR_MARGIN * shares[f]) for f in shares}
                diff["rounding_floor"] = {"draws": floor_draws, "rel": floor,
                                          "share_of_bound": shares, "tol": tol,
                                          "share_limit": limit}
                widened = ([k for k in F32_TOL if tol[k] > F32_TOL[k]]
                           + [f for f in limit if limit[f] > 1.0])
                diff["rounding_floor"]["widened"] = widened
                if widened:
                    log(f"{tag} step {i}: plain steps from theta moved by one ulp part from "
                        f"the plain step beyond phase 7's bounds in {widened}: those held at "
                        f"{FLOOR_MARGIN} times that floor, the rest at phase 7's")
            del prev, moved
            at_phase7.append(flip[0] == 0 and not diff.get("rounding_floor", {}).get("widened"))
            if flip[0] == 0:
                _hold(f"{tag} step {i}", diff, tol=tol, share_limit=limit)
            else:
                for key in ("base_loss", "meta_loss"):
                    got, ref, _ = diff[key]
                    if not abs(got - ref) <= F32_TOL[key] * abs(ref) + 1e-7:
                        raise AssertionError(f"{tag} step {i} {key}: {got!r} vs {ref!r} "
                                             f"({flip[0]} routing flips)")
                log(f"{tag} step {i}: {flip[0]} of {flip[1]} routed (call, token) rows chose "
                    f"other experts on the plain route: losses held, theta, lam, eps and "
                    f"hypergrad_norm reported, not held")
            rows.append(diff)
    out = {"layers": layers, "params": n_params, "batch": batch,
           "seq": seq, "unroll": unroll, "base_adam_eps": 1e-3, "launches_per_step": want,
           "routing_flips_per_step": flips,
           "held_at_phase7_bounds": at_phase7,
           "max_memory_allocated": torch.cuda.max_memory_allocated(), "per_step": rows}
    del learner, state
    torch.cuda.empty_cache()
    log(f"{tag}: " + json.dumps(out))
    return out


def phase_family_train_bf16(cfg, dev, out_dir, layers, tag, batch=4, seq=1024, unroll=2,
                            steps=BF16_STEPS):
    """Full width, depth ``layers``, the config's own dtypes (f32
    parameters, bf16 activations): ``steps`` meta steps through
    MetaLearner.fit at batch 4, seq 1024, unroll 2, meta batch 2 (unless
    given) on the train CLI's LM stream, with random frames or patches for
    whisper and the vision model, as phase 10 times gemma3-1b, the launches
    held (``_timed_fit``); the profiled step's device time by phase
    includes the MoE layers' forward share (the ``apply_moe`` range)."""
    from repro_torch import optim, tree
    from repro_torch.launch import train
    from repro_torch.models import Model

    cfg = cfg.replace(num_layers=layers)
    model = Model(cfg, device=dev)
    learner = _learner(model, dev, unroll, optim.adam(1e-3))
    make_batch = train.make_batch_fn(cfg, seq, dev, np.random.default_rng(SEED + 80))
    gen = torch.Generator(device=dev).manual_seed(SEED + 81)

    def draw(b, k=None):  # the CLI's zero frames or patches replaced by random ones
        return {**make_batch(b, k), **_modality(cfg, (k, b) if k else (b,), gen)}

    def it():
        while True:
            yield draw(batch, unroll), draw(max(batch // 2, 1))

    want = _lm_want(cfg, unroll, len(tree.tree_leaves(learner.state.theta)))
    result = _timed_fit(tag, learner, it(), steps, want, out_dir, f"{tag}_step",
                        {"samples": batch * unroll, "tokens": batch * unroll * seq})
    result.update({"layers": layers, "params": model.num_params(learner.state.theta),
                   "batch": batch, "seq": seq, "unroll": unroll,
                   "meta_batch": max(batch // 2, 1)})
    del learner
    torch.cuda.empty_cache()
    return result


def phase_family(cfg, dev, out_dir, layers, tag, serve_sizes=(SERVE_F32, SERVE_BF16),
                 floor_draws=0, seq=1024, bf16_batch=4):
    """Phase 18 (qwen2-moe-a2.7b), 19 (minicpm3-4b) or one half of 21
    (rwkv6-1.6b, zamba2-7b): (a) serving in f32 at full width and depth,
    tokens equal to the serial path; (b) serving in bf16 with qps, TTFT,
    TPOT, peak memory and flash_decode launches (one per attention layer
    per decode step and per scanned prompt token: 24 for qwen2-moe, none
    for MLA's plain decode or rwkv6, zamba2's 13 uses of its shared block);
    (c) and (d) training at full width, f32 step pairs and bf16 timed
    steps, at depth ``layers``: one depth for both, or (f32, bf16), at
    ``seq`` tokens, the bf16 steps at batch ``bf16_batch``.
    ``serve_sizes``: the requests of (a) and (b), as SERVE_F32 and
    SERVE_BF16; ``floor_draws``: phase_family_train_f32's."""
    from repro_torch import tree
    from repro_torch.models import Model

    out = {}
    t0 = time.perf_counter()
    params = Model(cfg, device=dev).init(SEED)
    torch.cuda.synchronize()
    n = sum(x.numel() for x in tree.tree_leaves(params))
    log(f"init: {cfg.name} {n} params f32 in {time.perf_counter() - t0:.2f}s")
    out["serve_f32"] = phase_serve_f32(cfg, params, dev, f"{tag}_serve_f32", serve_sizes[0])
    out["serve_bf16"], out["flash_decode_launches"] = phase_serve_bf16(
        cfg, params, dev, out_dir, f"{tag}_serve_bf16", serve_sizes[1])
    out["params_full_depth"] = n
    del params
    torch.cuda.empty_cache()
    f32_layers, bf16_layers = layers if isinstance(layers, tuple) else (layers, layers)
    out["train_f32"] = phase_family_train_f32(cfg, dev, f32_layers, f"{tag}_train_f32",
                                              seq=seq, floor_draws=floor_draws)
    out["train_bf16"] = phase_family_train_bf16(cfg, dev, out_dir, bf16_layers,
                                                f"{tag}_train_bf16", batch=bf16_batch, seq=seq)
    return out


# ---------------------------------------------------------------------------
# phase 21: the recurrent families, rwkv6-1.6b (ssm) and zamba2-7b (hybrid)
# ---------------------------------------------------------------------------

#: phase 21's requests (as SERVE_F32): twice the 4 slots in each dtype, so
#: that slots retire and are prefilled again over live lanes; prompts of
#: 16-20 tokens (cut from 32-40 for the run's time limit), each one
#: decode step a token through the scan prefill (57-84 and 90-193 ms a
#: token for rwkv6 and zamba2 in bf16, on the host), 8 generated; page 64
#: and max_len 128 keep zamba2's decode at the cache lengths ZAMBA_DECODE_T
#: holds
RECURRENT_SERVE = ((8, 16, 20, 8, 64, 128), (8, 16, 20, 8, 64, 128))
#: training depths at full width, (f32 step pairs, bf16 timed steps). rwkv6's
#: bf16 steps at its full 24 layers, its f32 pairs at 12 (0.79 B: the
#: floor's plain steps take time); zamba2 at 9
#: for both, the 3 leading Mamba blocks and one group of 6 with the shared
#: block (1.02 B: at its full 81 the f32 parameter-sized trees of the step
#: pass 80 GB)
RECURRENT_TRAIN_LAYERS = {"rwkv6-1.6b": (12, 24), "zamba2-7b": (9, 9)}
#: plain steps from theta moved by one ulp per f32 pair: rwkv6's step at its
#: init is chaotic at rounding level; zamba2 is held at phase 7's bounds
RECURRENT_FLOOR_DRAWS = {"rwkv6-1.6b": 3, "zamba2-7b": 0}


def phase_recurrent(cfg, dev, out_dir, tag):
    """21(a-d) rwkv6-1.6b, 21(e-h) zamba2-7b: ``phase_family`` with
    RECURRENT_SERVE's requests, RECURRENT_TRAIN_LAYERS' depths and
    RECURRENT_FLOOR_DRAWS; every signature at which the run launched the
    attention kernels one that phases 3 and 4 held against the plain
    versions (CHECKED)."""
    with _attn_signatures() as seen:
        out = phase_family(cfg, dev, out_dir, RECURRENT_TRAIN_LAYERS[cfg.name], tag,
                           RECURRENT_SERVE, floor_draws=RECURRENT_FLOOR_DRAWS[cfg.name])
    out["attention_signatures"] = _held_signatures(cfg.name, tag, seen)
    return out


def _held_signatures(name, tag, seen):
    """Fails unless every signature in ``seen`` (``_attn_signatures``) is one
    that phases 3 and 4 held against the plain versions (CHECKED); logs and
    returns them."""
    for kernel, sigs in seen.items():
        unchecked = sorted(map(str, sigs - CHECKED[kernel]))
        if unchecked:
            raise AssertionError(f"{name}: {kernel} launched at signatures no check held "
                                 f"against the plain version: {unchecked}")
    out = {k: sorted(map(str, v)) for k, v in seen.items()}
    log(f"{tag}_signatures: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 20: continued pretraining (the auxiliary spec), the score API and
# the paper-bench twins
# ---------------------------------------------------------------------------


def _aux_want(cfg, unroll, leaves):
    """Launches per meta step of the auxiliary spec: a base step runs the
    model on the ft batch and on the pt batch, the meta pass once on the ft
    batch, each central-difference pass on both: 2K + 5 forwards (each one
    CE forward) and 2K + 1 backwards (each one CE backward and, under remat,
    one recomputed forward); one adam_adapt per theta leaf."""
    from repro_torch.kernels import flash_attn, weighted_ce as wce

    L, K = _gqa_layers(cfg), unroll
    fwd, bwd = 2 * K + 5, 2 * K + 1
    return {flash_attn.FWD: L * fwd + L * bwd, flash_attn.DQ: L * bwd, flash_attn.DKV: L * bwd,
            "adam_adapt": leaves, wce.FWD: fwd, wce.BWD: bwd}


def _aux_learner(model, dev, unroll, base_opt):
    """SAMA on ``make_auxiliary_spec(model.lm_loss, model.per_example)``:
    the ft LM loss plus MetaWeightNet-weighted per-sequence pt losses at the
    base level, the ft loss at the meta level; Adam 1e-3 at the meta level."""
    from repro_torch import api
    from repro_torch.core import problems

    spec = problems.make_auxiliary_spec(model.lm_loss, model.per_example)
    learner = api.MetaLearner(spec, base_opt=base_opt, meta_opt="adam", meta_lr=1e-3,
                              method="sama", unroll_steps=unroll)
    learner.init(model.init(SEED), problems.init_data_optimization_lam(SEED + 1, device=dev))
    return learner


def _aux_batches(cfg, dev, batch, seq, unroll, seed):
    """(base_batches, meta_batch) of {"ft", "pt"} token batches: the K ft
    batches are row permutations of the meta batch's sequences (warm Adam
    rows, as _lm_warm_batches); the pt rows alternate the LM stream and
    uniform ("harmful") tokens, as bench_cont_pretrain's auxiliary corpus."""
    from repro_torch import data

    rng = np.random.default_rng(seed)
    lm_cfg = data.LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def batches(i):
        ft = data.lm_batch(lm_cfg, rng, batch)["tokens"]
        pt = data.lm_batch(lm_cfg, rng, unroll * batch)["tokens"].reshape(unroll, batch, seq)
        pt[:, 1::2] = rng.integers(0, cfg.vocab_size, pt[:, 1::2].shape)
        perms = np.stack([rng.permutation(batch) for _ in range(unroll)])
        return ({"ft": {"tokens": put(ft[perms])}, "pt": {"tokens": put(pt)}},
                {"ft": {"tokens": put(ft)}})

    return batches


def phase_cont_pretrain_f32(base_cfg, dev, batch=1, seq=1024, unroll=2, steps=F32_PAIRS):
    """20(a): gemma3-1b at full width and depth in f32 through the auxiliary
    spec, ft batch 1 + pt batch 1, seq 1024, unroll 2, meta batch 1, base
    Adam eps 1e-3 on warm rows: _held_steps (F32_PAIRS step pairs, the kernels
    against plain_everywhere from one state, phase 7's tolerances), the
    kernel step's launches held to _aux_want."""
    from repro_torch import optim, tree
    from repro_torch.models import Model

    cfg = base_cfg.replace(dtype="float32")
    model = Model(cfg, device=dev)
    batches = _aux_batches(cfg, dev, batch, seq, unroll, SEED + 200)
    torch.cuda.reset_peak_memory_stats()
    learner = _aux_learner(model, dev, unroll, optim.adam(1e-3, eps=1e-3))
    want = _aux_want(cfg, unroll, len(tree.tree_leaves(learner.state.theta)))
    _, out = _held_steps("cont_pretrain f32", learner, batches, steps, want)
    out.update({"layers": cfg.num_layers, "batch_ft": batch, "batch_pt": batch, "seq": seq,
                "unroll": unroll, "base_adam_eps": 1e-3, "launches_per_step": want,
                "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del learner
    torch.cuda.empty_cache()
    log("cont_pretrain_f32: " + json.dumps(out))
    return out


def phase_cont_pretrain_bf16(cfg, dev, out_dir, batch=2, seq=1024, unroll=2,
                             steps=BF16_STEPS):
    """20(b): gemma3-1b at full width and depth in its own dtypes (f32
    parameters, bf16 activations) through the auxiliary spec: ft batch 2 +
    pt batch 2 (the four sequences of phase 10's base batch), seq 1024,
    unroll 2, meta batch 2; ``steps`` meta steps through MetaLearner.fit
    (_timed_fit: wall median and range, tokens/s over K (B_ft + B_pt) S,
    peak memory, launches held to _aux_want, a profiled step's device time
    by phase and kernel)."""
    from repro_torch import optim, tree
    from repro_torch.models import Model

    model = Model(cfg, device=dev)
    learner = _aux_learner(model, dev, unroll, optim.adam(1e-3))
    make = _aux_batches(cfg, dev, batch, seq, unroll, SEED + 210)

    def it():
        i = 0
        while True:
            yield make(i)
            i += 1

    want = _aux_want(cfg, unroll, len(tree.tree_leaves(learner.state.theta)))
    result = _timed_fit("cont_pretrain_bf16", learner, it(), steps, want, out_dir,
                        "cont_pretrain_step",
                        {"samples": 2 * batch * unroll, "tokens": 2 * batch * unroll * seq})
    result.update({"layers": cfg.num_layers, "batch_ft": batch, "batch_pt": batch,
                   "seq": seq, "unroll": unroll, "meta_batch": batch})
    del learner
    torch.cuda.empty_cache()
    return result


def phase_score_api(path, n_requests=600, ids_per_request=16, seed=SEED + 220):
    """20(c): ``serve.ScoreAPI`` over phase 16's exported store: requests of
    the three kinds (weights at temperatures 0.5, 1, 4), all submitted,
    then coalesced 64 at a time by one ``run_pending``, each answer equal
    to a direct ``ScoreStore`` lookup. The service numbers are the drain's:
    requests/s and host µs per coalesced batch. The API's own p50/p99 run
    from a request's submission to its answer, so here they are the wait
    in the queue behind the whole submit loop, not the time to serve one
    request."""
    from repro_torch import serve

    store = serve.ScoreStore.load(path, expect_n=4096)
    api = serve.ScoreAPI(store, max_batch=64, queue_depth=n_requests)
    rng = np.random.default_rng(seed)
    asks = [(serve.score_api.KINDS[i % 3], (0.5, 1.0, 4.0)[(i // 3) % 3],
             rng.integers(0, len(store), ids_per_request)) for i in range(n_requests)]
    t0 = time.perf_counter()
    futs = [api.submit(ids, kind=kind, temperature=temp) for kind, temp, ids in asks]
    t1 = time.perf_counter()
    answered = api.run_pending()
    secs = time.perf_counter() - t1
    for (kind, temp, ids), fut in zip(asks, futs):
        want = {"score": lambda: store.lookup(ids), "keep": lambda: store.keep(ids),
                "weight": lambda: store.weight(ids, temp)}[kind]()
        if not np.array_equal(fut.result(), want):
            raise AssertionError(f"score_api: a {kind} answer differs from the store's")
    stats = api.stats()
    out = {"rows": len(store), "requests": n_requests, "ids_per_request": ids_per_request,
           "answered": answered, "batches": stats.batches, "submit_loop_us": (t1 - t0) * 1e6,
           "drain_requests_per_s": answered / secs,
           "drain_us_per_batch": secs * 1e6 / max(stats.batches, 1),
           "submit_to_answer_p50_us": stats.latency.p50_us,
           "submit_to_answer_p99_us": stats.latency.p99_us,
           "shed": [stats.queue.shed_overflow, stats.queue.shed_deadline],
           "scorer": store.meta.get("scorer")}
    if answered != n_requests or stats.batches < math.ceil(n_requests / 64):
        raise AssertionError(f"score_api: {out}")
    log("score_api: " + json.dumps(out))
    return out


#: the paper-bench twins (``repro_torch.perf.bench_*``) and the kernels each
#: must launch on the card
_TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
                  "adam_adapt")
TWINS = {
    "cont_pretrain": _TRAIN_KERNELS,
    "wrench": _TRAIN_KERNELS,
    "ablation": _TRAIN_KERNELS,
    "memory_vs_modelsize": _TRAIN_KERNELS,
    "data_pruning": _TRAIN_KERNELS,
    "biased_regression": (),
    "serve": ("flash_decode",),
}


@contextlib.contextmanager
def _attn_signatures():
    """Yields {"flash_attention": set, "flash_decode": set}, filled inside
    with the signatures (_train_sig, _decode_sig) of every launch of the
    attention kernels: it wraps their CUDA entry points, through which
    every launch goes (a backward follows its forward's signature)."""
    from repro_torch.kernels import flash_attn

    seen = {"flash_attention": set(), "flash_decode": set()}
    fwd, dec = flash_attn._fwd_cuda, flash_attn._flash_decode_cuda

    def fwd_seen(q, k, v, q_pos, kv_pos, *, softcap, window, causal):
        seen["flash_attention"].add(_train_sig(q, k, causal, window, softcap))
        return fwd(q, k, v, q_pos, kv_pos, softcap=softcap, window=window, causal=causal)

    def dec_seen(q, k, v, q_pos, local_flag, *, softcap, window, n_splits):
        seen["flash_decode"].add(_decode_sig(q, k, local_flag is not None and bool(local_flag),
                                             window, softcap))
        return dec(q, k, v, q_pos, local_flag, softcap=softcap, window=window,
                   n_splits=n_splits)

    flash_attn._fwd_cuda, flash_attn._flash_decode_cuda = fwd_seen, dec_seen
    try:
        yield seen
    finally:
        flash_attn._fwd_cuda, flash_attn._flash_decode_cuda = fwd, dec


def phase_paper_benches(out_dir):
    """20(d): every twin at its JAX ``fast`` sizes on the card, its
    ``BENCH_torch_<name>.json`` in DIR/paper_benches; per twin one line with
    its rows, claims, seconds and the kernel launches of its run (counted
    from 0 just before it), each kernel of TWINS launched at least once, and
    every signature at which it launched the attention kernels one that
    phases 3 and 4 held against the plain versions (CHECKED)."""
    import importlib

    from repro_torch.kernels import dispatch

    out_dir = os.path.join(out_dir, "paper_benches")
    out = {}
    for name, kernels in TWINS.items():
        mod = importlib.import_module(f"repro_torch.perf.bench_{name}")
        dispatch.reset_launches()
        t0 = time.perf_counter()
        with _attn_signatures() as seen:
            bench = mod.run(fast=True, device="cuda")
        secs = time.perf_counter() - t0
        launches = dispatch.launch_counts()
        for kernel, sigs in seen.items():
            unchecked = sorted(map(str, sigs - CHECKED[kernel]))
            if unchecked:
                raise AssertionError(f"bench_{name}: {kernel} launched at signatures no "
                                     f"check held against the plain version: {unchecked}")
        path = bench.write(out_dir, fast=True, elapsed_s=secs)
        torch.cuda.empty_cache()
        line = {"bench": name, "seconds": secs, "rows": bench.rows, "claims": bench.claims,
                "launches": launches, "attention_signatures_checked":
                    {k: len(v) for k, v in seen.items()},
                "file": os.path.relpath(path, out_dir)}
        log(f"paper_bench_{name}: " + json.dumps(line))
        missing = [k for k in kernels if not launches.get(k)]
        if missing:
            raise AssertionError(f"bench_{name}: no launch of {missing} on the card")
        out[name] = line
    return out


# ---------------------------------------------------------------------------
# phase 22: cross-attention: whisper-small (audio) and llama-3.2-vision-90b
# ---------------------------------------------------------------------------

#: whisper-small's requests (as SERVE_F32), f32 and bf16: prompts of 16-200
#: tokens, 32 generated, page 16, max_len 448 (its decoder's context), on 4
#: slots, so that slots retire and are prefilled again
WHISPER_SERVE = ((8, 16, 200, 32, 16, 448), (8, 16, 200, 32, 16, 448))
#: the vision model's depth on the card: two groups of four self layers and
#: one gated cross layer (9.62 B parameters, 38.5 GB in f32; its 100 layers
#: are 346 GB); one group would hide a fault in the group loop's indexing
VISION_LAYERS = 10
#: its f32 requests (as SERVE_F32)
VISION_SERVE = (4, 16, 64, 8, 16, 128)
#: its gates, one per group, nonzero: at init they are 0 and each cross
#: layer is the identity
VISION_GATES = {"gate_attn": (0.6, -0.45), "gate_mlp": (-0.5, 0.7)}
#: the f32 forward's (batch, tokens): phase 4's llama-3.2-vision-90b row
VISION_FORWARD = (4, 1024)
#: the forward's logits, kernels against plain: test_torch_model_decode.py's
#: tolerance between the packages, (atol, rtol)
FORWARD_TOL = (1e-4, 1e-4)


def phase_whisper(cfg, dev, out_dir):
    """22(a-b): whisper-small at full size (263 M parameters) through
    ``phase_family``: served in f32 (tokens equal to the serial path) and in
    bf16 (qps, TTFT, TPOT, a profiled decode step; WHISPER_SERVE), every
    request cross-attending to the cache's zero ``cross_kv`` as in the
    reference; trained at full depth with 1,500 random frames a sequence
    and the decoder at S 448: two f32 step pairs at batch 2 held at phase
    7's tolerances, BF16_STEPS bf16 steps at batch 8, meta batch 4. Every
    attention-kernel launch of the phase at a signature phases 3 and 4
    held."""
    with _attn_signatures() as seen:
        out = phase_family(cfg, dev, out_dir, cfg.num_layers, "whisper", WHISPER_SERVE,
                           seq=448, bf16_batch=8)
    out["attention_signatures"] = _held_signatures(cfg.name, "whisper", seen)
    return out


def phase_vision(cfg, dev):
    """22(c): llama-3.2-vision-90b at full width and VISION_LAYERS layers,
    f32, its gates set to VISION_GATES: VISION_SERVE's requests through the
    executor, tokens equal to the serial path; then a forward over random
    tokens and patches (VISION_FORWARD) through the kernels against the same
    forward with every kernel plain, the logits within FORWARD_TOL and the
    forward's flash launches one per self layer. Every attention-kernel
    launch at a signature phases 3 and 4 held."""
    from repro_torch.kernels import dispatch, flash_attn
    from repro_torch.models import Model

    cfg = cfg.replace(num_layers=VISION_LAYERS, dtype="float32")
    model = Model(cfg, device=dev)
    out = {}
    with _attn_signatures() as seen:
        t0 = time.perf_counter()
        params = model.init(SEED)
        for name, gates in VISION_GATES.items():
            params["cross_layers"][name].copy_(torch.tensor(gates))
        torch.cuda.synchronize()
        n = model.num_params(params)
        log(f"init: {cfg.name} at {VISION_LAYERS} layers {n} params f32 in "
            f"{time.perf_counter() - t0:.2f}s; gates {VISION_GATES}")
        out["params"] = n
        out["serve_f32"] = phase_serve_f32(cfg, params, dev, "vision_serve_f32", VISION_SERVE)
        b, s = VISION_FORWARD
        gen = torch.Generator(device=dev).manual_seed(SEED + 220)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev),
                 **_modality(cfg, (b,), gen)}
        with torch.no_grad():
            torch.cuda.synchronize()
            dispatch.reset_launches()  # counts of the forward's run only
            t0 = time.perf_counter()
            got, _ = model.forward(params, batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = dispatch.launches(flash_attn.FWD)
            with dispatch.plain_everywhere():
                ref, _ = model.forward(params, batch)
    atol, rtol = FORWARD_TOL
    if got.shape != (b, s, cfg.vocab_size) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"vision forward: {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    share = _excess(got, ref, atol, rtol)
    if not share <= 1.0:
        raise AssertionError(f"vision forward kernels vs plain: {share:.3f} of {atol} + "
                             f"{rtol} |ref|")
    if launches != _gqa_layers(cfg):
        raise AssertionError(f"vision forward: {launches} flash forwards, not "
                             f"{_gqa_layers(cfg)}")
    out["forward_f32"] = {"batch": b, "tokens": s, "seconds": secs, "launches": launches,
                          "max_abs_err": (got - ref).abs().max().item(),
                          "share_of_tolerance": share,
                          "max_abs_logit": ref.abs().max().item()}
    log("vision_forward_f32: " + json.dumps(out["forward_f32"]))
    del params, got, ref, batch
    torch.cuda.empty_cache()
    out["attention_signatures"] = _held_signatures(cfg.name, "vision", seen)
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 25: the kernel registry, per-phase attribution, the kernel,
# attention and attribution twins, and the roofline's count beside it
# ---------------------------------------------------------------------------

#: the steps phase 25(b) attributes: (arch, batch, seq, meta batch), unroll 2,
#: in the config's own dtypes (bf16 activations)
ATTRIBUTED = (("bert-base", 48, 128, 48), ("gemma3-1b", 4, 1024, 2))


def _card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
    except OSError:
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def phase_registry(dev):
    """25(a): each ``kernels.ops`` function and each ``kernels.ref`` oracle
    on CUDA tensors at phase 4's shapes (bert-base's embedding for the flat
    products; gemma3-1b's LM loss view and the ragged rows for the CE, f32):
    each ops call launches its kernel exactly once and agrees with the
    oracle at phase 4's tolerances; ``REPRO_KERNEL_BACKEND=plain`` (and
    ``backend="plain"`` through the registry) on a CUDA tensor raises; and
    the training kernels' tile sizes that ``kernels.work`` charges equal
    the libraries' own (``flash_attn.tc_tiles``)."""
    from repro_torch.kernels import dispatch, flash_attn, ops, ref, work
    from repro_torch.kernels import weighted_ce as wce
    from repro_torch.perf import ce_time

    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    n = ADAPT_SIZES[0]
    g, m, gm = (_dev_randn(gen, n, dev) * 1e-2 for _ in range(3))
    v = _dev_randn(gen, n, dev).square_() * 1e-4
    lr = 1e-3

    def once(want, fn):
        dispatch.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        if dispatch.launch_counts() != want:
            raise AssertionError(f"expected the launches {want}, got "
                                 f"{dispatch.launch_counts()}")
        return out

    worst = {}
    for name, call, oracle in (
            ("adam_adapt", lambda: ops.adam_adapt_product(g, m, v, gm, t=3, lr=lr),
             lambda: ref.adam_adapt_product(g, m, v, gm, t=3, b1=0.9, b2=0.999, eps=1e-8,
                                            lr=lr)),
            ("lion_adapt", lambda: ops.lion_adapt_product(g, m, gm, lr=lr),
             lambda: ref.lion_adapt_product(g, m, gm, lr=lr)),
            ("adafactor_adapt", lambda: ops.adafactor_adapt_product(v, gm, lr=lr),
             lambda: ref.adafactor_adapt_product(v, gm, lr=lr))):
        out, ss = once({name: 1}, call)
        want, want_ss = oracle()
        excess = _excess(out, want, 1e-7, 1e-5)
        ss_rel = abs(ss.item() - want_ss.item()) / abs(want_ss.item())
        if not (excess <= 1.0 and ss_rel <= 1e-4):
            raise AssertionError(f"ops.{name} vs ref at N={n}: out {excess:.3f} of the "
                                 f"tolerance, sum of squares {ss_rel:.2e} relative")
        worst[name] = (out - want).abs().max().item()
    for shape_name, b, s, vocab, sliced in (CE_SHAPES[0], CE_SHAPES[1]):
        x, t, gg = ce_time.ce_inputs(gen, dev, b, s, vocab, torch.float32, sliced)
        x = x.detach().requires_grad_(True)
        t = t.reshape(x.shape[:-1])
        ce = once({wce.FWD: 1, f"{wce.FWD}_f32": 1}, lambda: ops.cross_entropy(x, t))
        (dx,) = once({wce.BWD: 1, f"{wce.BWD}_f32": 1},
                     lambda: torch.autograd.grad((ce * gg.reshape(ce.shape)).sum(), x))
        x2, t2 = x.detach().reshape(-1, vocab), t.reshape(-1)
        want = ref.cross_entropy(x2, t2)
        want_dx = ref.cross_entropy_grad(x2, t2, gg)
        ce_excess = _excess(ce.reshape(-1), want, 1e-5, 1e-5)
        dx_excess = _excess(dx.reshape(-1, vocab), want_dx, 1e-6, 1e-5)
        if not (ce_excess <= 1.0 and dx_excess <= 1.0):
            raise AssertionError(f"ops.cross_entropy vs ref at {shape_name}: ce "
                                 f"{ce_excess:.3f}, dlogits {dx_excess:.3f} of the tolerance")
        worst[f"cross_entropy {shape_name}"] = max(
            (ce.reshape(-1) - want).abs().max().item(),
            (dx.reshape(-1, vocab) - want_dx).abs().max().item())
        del x, t, gg, ce, dx, x2, want, want_dx
        torch.cuda.empty_cache()
    prev = os.environ.get(dispatch.ENV_VAR)
    os.environ[dispatch.ENV_VAR] = "plain"
    try:
        for call in (lambda: ops.adam_adapt_product(g, m, v, gm, t=3, lr=lr),
                     lambda: dispatch.get_kernel("weighted_ce")(g[:8].reshape(2, 4),
                                                                torch.zeros(2, device=dev))):
            try:
                call()
            except ValueError as e:
                if dispatch.ENV_VAR not in str(e):
                    raise
            else:
                raise AssertionError(f"{dispatch.ENV_VAR}=plain on a cuda tensor did not "
                                     "raise")
    finally:
        if prev is None:
            os.environ.pop(dispatch.ENV_VAR)
        else:
            os.environ[dispatch.ENV_VAR] = prev
    try:
        dispatch.get_kernel("lion_adapt", backend="plain")(g, m, gm)
    except ValueError:
        pass
    else:
        raise AssertionError("backend='plain' through the registry on a cuda tensor did not "
                             "raise")
    tiles = {}
    for kernel, key in ((flash_attn.FWD, "fwd"), (flash_attn.DQ, "dq"),
                        (flash_attn.DKV, "dkv")):
        for grp in (1, 2, 4, 8):
            for dh in (64, 128, 256):
                got, want = flash_attn.tc_tiles(kernel, grp, dh), work.tiles(key, grp, dh)
                if got != want:
                    raise AssertionError(f"{kernel} G={grp} Dh={dh}: the library tiles {got}, "
                                         f"kernels.work charges {want}")
                tiles[f"{key} G{grp} Dh{dh}"] = got
    log(f"registry: ops and ref on cuda tensors, one launch per call, max_abs_err {worst} "
        f"(flat rtol 1e-5 atol 1e-7, sums rtol 1e-4; CE rtol 1e-5 atol 1e-5, dlogits atol "
        f"1e-6); {dispatch.ENV_VAR}=plain and backend='plain' raise on cuda tensors; "
        f"kernels.work's tile sizes equal the libraries' at {len(tiles)} (kernel, G, Dh)")
    dispatch.reset_launches()
    return {"worst": worst}


def _attributed_learner(cfg, dev, batch, seq, meta_batch, unroll=2):
    """The bf16 learner of phases 8 and 10 on its warm batches."""
    from repro_torch import optim
    from repro_torch.models import Model

    model = Model(cfg, device=dev)
    learner = _learner(model, dev, unroll, optim.adam(1e-3))
    if cfg.family == "encoder":
        train, _ = _wrench(cfg, seq, 1024, 256, SEED + 30)
        base, meta = _warm_batches(train, dev, batch, unroll, SEED + 31)(0)
    else:
        base, meta = _lm_warm_batches(cfg, dev, batch, seq, unroll, SEED + 32)(0)
    return learner, base, {k: x[:meta_batch] for k, x in meta.items()}


def phase_attribution(dev, steps=ATTRIBUTED):
    """25(b) and (d): each step of ``steps`` attributed by phase
    (``obs.profile.attribute``) on the card, with each phase's wall from
    ``MetaLearner.phase_profile``'s synced spans and its utilization
    against the peak of the step's compute dtype (one step first, so that
    first-use costs stay out of the spans), then traced on ``meta``
    tensors: per-phase FLOPs, bytes and matmul FLOPs, the kernels' charges
    and the modules must equal the card's number for number (a phase stack
    that the autograd thread cannot see, or a kernel charged differently
    by route, breaks it). Coverage >= 0.90. Beside the counted total, the
    roofline's analytic ``step_flops`` at the same config and shape (its
    meta batch is B / 8, the step's is the given one), and the whole
    step's share of the peak from each count over the sum of the top-level
    phase walls."""
    from repro_torch import configs
    from repro_torch.configs import InputShape
    from repro_torch.obs import profile
    from repro_torch.roofline import analysis

    card_line = _card_line()
    out = {}
    for arch, batch, seq, meta_batch in steps:
        cfg = configs.get_config(arch) if dev.type == "cuda" else configs.get_smoke_config(arch)
        learner, base, meta = _attributed_learner(cfg, dev, batch, seq, meta_batch)
        learner.step_fn(learner.state, base, meta)  # first-use costs out of the spans
        spans = learner.phase_profile(base, meta)
        card = profile.attribute(learner.step_fn, learner.state, base, meta, spans=spans)
        traced = profile.attribute(learner.step_fn, profile.to_meta(learner.state),
                                   profile.to_meta(base), profile.to_meta(meta))
        for ph in set(card["phases"]) | set(traced["phases"]):
            a, b = card["phases"].get(ph, {}), traced["phases"].get(ph, {})
            for key in ("flops", "bytes", "matmul_flops"):
                if a.get(key) != b.get(key):
                    raise AssertionError(f"{arch}: phase {ph} {key} {a.get(key)} on the card, "
                                         f"{b.get(key)} on meta")
        if card["kernels"] != traced["kernels"] or card["modules"] != traced["modules"]:
            raise AssertionError(f"{arch}: kernel charges or modules differ between the card "
                                 f"and meta: {card['kernels']} vs {traced['kernels']}")
        if card["coverage"] < 0.90:
            raise AssertionError(f"{arch}: attribution coverage {card['coverage']:.4f}")
        wall_s = sum(s.dur_s for s in spans if s.depth == 0)
        counts = analysis.param_counts(learner.state.theta)
        analytic = analysis.step_flops(cfg, counts, InputShape(arch, seq, batch, "train"),
                                       "train")
        counted = card["total"]["flops"]
        peak = card["peak_flops"]
        phases = {ph: {k: b.get(k) for k in ("flops", "matmul_flops", "bytes", "wall_us",
                                                "utilization", "peak_live_bytes")}
                  for ph, b in card["phases"].items()}
        row = {"arch": arch, "batch": batch, "seq": seq, "meta_batch": meta_batch,
               "unroll": 2, "card": card_line, "compute_dtype": card["compute_dtype"],
               "peak_flops": peak, "coverage": card["coverage"],
               "top_module": card["top_module"],
               "modules": {k: v["flop_frac"] for k, v in list(card["modules"].items())[:4]},
               "kernels": {k: {"calls": v["calls"], "flops": v["flops"]}
                           for k, v in card["kernels"].items()},
               "phases": phases, "step_wall_s": wall_s, "counted_flops": counted,
               "analytic_step_flops": analytic, "counted_over_analytic": counted / analytic,
               "share_of_peak_counted": counted / wall_s / peak,
               "share_of_peak_analytic": analytic / wall_s / peak,
               "card_equals_meta": True}
        log(f"attribution {arch}: {json.dumps(row)}")
        out[arch] = row
        del learner, base, meta
        torch.cuda.empty_cache()
    return out


def phase_bench_twins(out_dir):
    """25(c): ``perf/run.py --only kernels,attention,attribution`` on the
    card, each twin asserting its parity gates before its records, into
    DIR/bench."""
    from repro_torch.kernels import dispatch
    from repro_torch.perf import run as run_mod

    bench_dir = os.path.join(out_dir, "bench")
    dispatch.reset_launches()
    run_mod.main(["--only", "kernels,attention,attribution", "--json-dir", bench_dir,
                  "--strict"])
    launches = dispatch.launch_counts()
    files = sorted(os.listdir(bench_dir))
    want = ["BENCH_torch_attention.json", "BENCH_torch_attribution.json",
            "BENCH_torch_kernels.json"]
    if [f for f in files if f in want] != want:
        raise AssertionError(f"bench twins wrote {files}")
    rows = {}
    for f in want:
        with open(os.path.join(bench_dir, f)) as fh:
            rows[f] = {r["name"]: r["derived"] for r in json.load(fh)["rows"]}
    log(f"bench_twins: {json.dumps(rows)} launches {json.dumps(launches)}")
    dispatch.reset_launches()
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(HERE, "build", "chip_smoke"),
                    help="directory for the profiler traces of a decode and the training "
                         "steps, the Table 2, scale and paper-bench files and phase 16's "
                         "score export")
    ap.add_argument("--observability-only", type=int, default=0, metavar="N",
                    help="run phase 23 N times after the build and phase 6 (whose weights "
                         "and tokens it takes), log how many runs passed, and stop: exit 0 "
                         "if all did, with no result line")
    args = ap.parse_args()

    t_start = time.perf_counter()
    secs = {}

    def timed(name, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        secs[name] = time.perf_counter() - t0
        log(f"phase {name}: {secs[name]:.1f}s")
        return out

    phase_device()
    from repro_torch import configs
    from repro_torch.kernels import flash_attn, weighted_ce as wce
    from repro_torch.models import Model
    from repro_torch.models.common import tree_flatten

    dev = torch.device("cuda", 0)
    cfg = configs.get_config("gemma3-1b")
    bert = configs.get_config("bert-base")
    build_s, ptxas = timed("build", phase_build)
    if args.observability_only:
        params = Model(cfg, device=dev).init(SEED)
        serve_out, _ = timed("serve_bf16", phase_serve_bf16, cfg, params, dev, args.out)
        runs, passed = args.observability_only, 0
        for k in range(runs):
            try:
                timed("observability", phase_observability, bert, cfg, params, dev, args.out,
                      serve_out["tokens_sha256"])
                passed += 1
            except AssertionError as e:
                log(f"observability run {k + 1}: failed: {e}")
        log(f"observability: {passed} of {runs} runs passed")
        sys.exit(0 if passed == runs else 1)

    # phase 3: the decode kernel
    entry = {"name": "flash_decode", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
             "replaces": "src/repro/kernels/flash_attn.py:490",
             "build_seconds": build_s["flash_decode"], "ptxas": ptxas["flash_decode"]}
    worst, worst_vs_f32 = timed("decode_kernel_check", phase_kernel_check, dev)
    timing = timed("decode_kernel_time", phase_kernel_time, dev, cfg, slots=4, t=1024)
    # "max_abs_err" and "ms" are the keys every kernels line carries; they
    # are the bf16 error and the kernel time, which the serving path's own
    # names max_err_bf16 and kernel_ms repeat; kernels_per_call is the
    # profiler's count over the serving-shape pass
    entry.update({"max_abs_err": worst[torch.bfloat16], "max_err_f32": worst[torch.float32],
                  "max_err_bf16": worst[torch.bfloat16],
                  "bf16_vs_f32_share_of_bound": worst_vs_f32,
                  "kernel_ms": timing["ms"], **timing})
    qwen = configs.get_config("qwen2-moe-a2.7b")
    # 4 of qwen2-moe's 24 layers and 3 of zamba2's 13 uses (cut from 26 and
    # 13, then from 8 and 6 when phase 24 came, for the run's time limit),
    # each with its own cache, together past the 50 MB L2
    entry[qwen.name] = timed("qwen_decode_time", phase_family_decode_time, dev, qwen,
                             layers=4)
    zamba = configs.get_config("zamba2-7b")
    entry[zamba.name] = timed("zamba_decode_time", phase_family_decode_time, dev, zamba,
                              layers=3)
    # phase 22's: whisper-small's 12 decoder layers at its 448-token context,
    # the vision model's 8 self layers of its VISION_LAYERS
    whisper = configs.get_config("whisper-small")
    vision = configs.get_config("llama-3.2-vision-90b")
    entry[whisper.name] = timed("whisper_decode_time", phase_family_decode_time, dev, whisper,
                                t=448, layers=_gqa_layers(whisper))
    entry[vision.name] = timed("vision_decode_time", phase_family_decode_time, dev, vision,
                               layers=_gqa_layers(vision.replace(num_layers=VISION_LAYERS)))

    # phase 4: the training kernels
    t_worst, t_share, adam_worst = timed("train_kernel_check", phase_train_kernel_check, dev)
    timed("second_order_check", phase_second_order_check, dev)
    ce_worst = timed("ce_kernel_check", phase_ce_kernel_check, dev)
    adapt_worst = timed("adapt_kernel_check", phase_adapt_kernel_check, dev)
    t_time = timed("train_kernel_time", phase_train_kernel_time, dev, bert, batch=48, seq=128)
    # the layer timings run over a cut of each model's layers (each with its
    # own inputs, beside the 50 MB L2), for the run's time limit: gemma3-1b's
    # pattern over 6 layers (5 local, 1 global; cut from 12), qwen2-moe's 2 of
    # 24 (cut from 6, then from 3 when phase 24 came)
    for name, e in timed("gemma_attn_time", phase_layer_attn_time, dev,
                         cfg.replace(num_layers=6)).items():
        t_time[name].update(e)
    for name, e in timed("qwen_attn_time", phase_layer_attn_time, dev,
                         qwen.replace(num_layers=2)).items():
        t_time[name].update(e)
    # zamba2-7b: 2 of its shared block's 13 uses (cut from 6, then from 3
    # when phase 24 came), each with its own inputs (117 MB a use, beside
    # the 50 MB L2)
    zamba_uses = zamba.replace(num_layers=2)
    for name, e in timed("zamba_attn_time", phase_layer_attn_time, dev, zamba_uses).items():
        t_time[name].update(e)
    # phase 22's layers, each with its own inputs past the 50 MB L2 (cut
    # from the whole models for the run's time limit; halved when phase 24
    # came): 1 of whisper's 12 encoder layers (B 8, S = T 1,500, non-causal;
    # 129 MB of inputs and gradients), 2 of its 12 decoder layers (B 8, S
    # 448; 39 MB each), 1 of the vision model's self layers (B 4, S 1024,
    # G 8, Dh 128; its q alone 67 MB)
    for tag, c, label, kw in (
            ("whisper_enc_attn_time", whisper.replace(num_layers=1), "whisper-small encoder",
             dict(batch=8, seq=1500, causal=False)),
            ("whisper_dec_attn_time", whisper.replace(num_layers=2), "whisper-small decoder",
             dict(batch=8, seq=448)),
            ("vision_attn_time", vision.replace(num_layers=1), vision.name,
             dict(batch=4, seq=1024))):
        for name, e in timed(tag, phase_layer_attn_time, dev, c, label=label, **kw).items():
            t_time[name].update(e)
    t_time.update(timed("new_kernel_time", phase_new_kernel_time, dev))
    train_entries = []
    for name, source, replaces in (
            (flash_attn.FWD, "flash_attn_fwd", "src/repro/kernels/flash_attn.py:118"),
            (flash_attn.DQ, "flash_attn_bwd", "src/repro/kernels/flash_attn.py:253"),
            (flash_attn.DKV, "flash_attn_bwd", "src/repro/kernels/flash_attn.py:282"),
            ("adam_adapt", "adam_adapt", "src/repro/kernels/adam_adapt.py:30"),
            (wce.FWD, "weighted_ce", "src/repro/kernels/weighted_ce.py:28"),
            (wce.BWD, "weighted_ce", "src/repro/kernels/weighted_ce.py:60"),
            ("lion_adapt", "lion_adapt", "src/repro/kernels/lion_adapt.py:28"),
            ("adafactor_adapt", "adafactor_adapt", "src/repro/kernels/adafactor_adapt.py:26")):
        e = {"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{source}.cu", "replaces": replaces,
             "build_seconds": build_s[source]}
        if name == flash_attn.FWD:
            e["design"] = ("bf16/f16: wgmma (HGMMA), K and V by TMA into a 4-stage mbarrier "
                           "ring, one producer warp, two consumer warpgroups (csrc/hopper.cuh); "
                           "f32: the CUDA cores")
        if name == "adam_adapt":
            e["max_abs_err"] = adam_worst
        elif name in adapt_worst:
            e["max_abs_err"] = adapt_worst[name]
        elif name in (wce.FWD, wce.BWD):
            w = ce_worst["fwd" if name == wce.FWD else "bwd"]
            e.update({"max_abs_err": max(w["float32"], w["bfloat16"]),
                      "max_err_f32": w["float32"], "max_err_bf16_logits": w["bfloat16"],
                      "max_err_f16_logits": w["float16"]})
            if name == wce.BWD:
                e["bf16_vs_f32_share_of_bound"] = w["bfloat16_share_of_bound"]
                e["f16_vs_f32_share_of_bound"] = w["float16_share_of_bound"]
        else:
            e.update({"max_abs_err": t_worst[name][torch.bfloat16],
                      "max_err_f32": t_worst[name][torch.float32],
                      "max_err_bf16": t_worst[name][torch.bfloat16],
                      "bf16_vs_f32_share_of_bound": t_share[name]})
        e.update(t_time[name])
        train_entries.append(e)
    by_name = {e["name"]: e for e in train_entries}

    # phases 5-6: serving
    t0 = time.perf_counter()
    params = Model(cfg, device=dev).init(SEED)
    torch.cuda.synchronize()
    log(f"init: gemma3-1b {sum(x.numel() for x in tree_flatten(params)[0])} params f32 "
        f"in {time.perf_counter() - t0:.2f}s")
    timed("serve_f32", phase_serve_f32, cfg, params, dev)
    serve_out, launches = timed("serve_bf16", phase_serve_bf16, cfg, params, dev, args.out)
    entry["launches"] = launches
    entry["serve_bf16"] = serve_out
    # phase 23: the observability layer, on phase 6's weights and tokens
    obs_out = timed("observability", phase_observability, bert, cfg, params, dev, args.out,
                    serve_out["tokens_sha256"])
    log(f"observability: {obs_out['seconds']:.1f}s; obs overhead ratios (counted): train "
        f"{obs_out['train']['overhead_ratio']:.6f}, serve "
        f"{obs_out['serve']['overhead_ratio']:.6f} (limit {OBS_LIMIT}); wall ratios: train "
        f"{obs_out['train']['wall_ratio']:.4f}, serve {obs_out['serve']['wall_ratio']:.4f}")
    del params
    torch.cuda.empty_cache()

    # phases 7-8: training bert-base
    timed("train_f32", phase_train_f32, bert, dev)
    torch.cuda.empty_cache()
    bert_out, bert_learner, bert_it = timed("train_bf16", phase_train_bf16, bert, dev, args.out)
    # phase 14 takes phase 8's learner
    timed("checkpoint", phase_checkpoint, bert, dev, bert_learner, bert_it, args.out)
    del bert_learner, bert_it
    torch.cuda.empty_cache()

    # phases 9-11: training gemma3-1b, and Lion and Adafactor bases
    timed("train_gemma_f32", phase_train_gemma_f32, cfg, dev)
    torch.cuda.empty_cache()
    gemma_out = timed("train_gemma_bf16", phase_train_gemma_bf16, cfg, dev, args.out)
    torch.cuda.empty_cache()
    la_out = timed("train_lion_adafactor", phase_train_lion_adafactor, bert, dev)
    torch.cuda.empty_cache()

    # phases 12-13: the baseline estimators, and the paper's Table 2
    timed("baselines_f32", phase_baselines_f32, bert, dev)
    torch.cuda.empty_cache()
    timed("table2", phase_table2, bert, dev, args.out)
    torch.cuda.empty_cache()

    # phase 15: precision policies, microbatching and the planner; phase 16:
    # data optimization
    timed("scale_f32", phase_scale_f32, bert, dev)
    mem = timed("scale_memory", phase_scale_memory, cfg, dev, args.out)
    peaks = {m: r["max_memory_allocated"] for m, r in mem["rows"].items()}
    timed("scale_plan", phase_scale_plan, cfg, dev, peaks, meta_batch=mem["meta_batch"])
    f16_out = timed("scale_f16", phase_scale_f16, cfg, dev)
    torch.cuda.empty_cache()
    dataopt_out = timed("dataopt", phase_dataopt, bert, dev, args.out)
    torch.cuda.empty_cache()

    # phase 17: the distributed schedules (NCCL world 1, two gloo ranks)
    dist_out = timed("distributed", phase_distributed, dev, args.out)
    for name, n in dist_out["gloo_2_ranks"]["manual"]["launches_per_rank"][0].items():
        by_name[name]["launches_distributed_per_rank"] = n
        by_name[name]["launches_distributed_path"] = (
            "distributed manual, each of 2 gloo ranks (2 meta steps)")

    # phase 24: the model axis (FSDP over the model process group), on the
    # card phase 17 has left
    axis_out = timed("model_axis", phase_model_axis, dev, args.out)
    for tag, out in axis_out.items():
        for learner in ("manual", "adafactor", "gathered", "whole_groups"):
            for name, n in out.get(learner, {}).get("launches_per_rank", [{}])[0].items():
                by_name[name][f"launches_model_axis_{tag}_{learner}_per_rank"] = n

    # phases 18-19: the moe family and MLA at full width (training at a cut
    # depth: the f32 parameter-sized trees of the step at full depth pass 80 GB;
    # minicpm3 at 4 layers and 4 bf16 requests each, for the run's time limit;
    # 8 f32 requests on the 4 slots, so that slots retire and are refilled)
    fam = {}
    for tag, arch, layers in (("moe", "qwen2-moe-a2.7b", 2), ("mla", "minicpm3-4b", 4)):
        fam[tag] = timed(tag, phase_family, configs.get_config(arch), dev, args.out, layers,
                         tag, (SERVE_F32, FAMILY_SERVE_BF16))
        torch.cuda.empty_cache()
    entry["launches_moe_serve_bf16"] = fam["moe"]["flash_decode_launches"]
    entry["launches_mla_serve_bf16"] = fam["mla"]["flash_decode_launches"]
    for name, e in by_name.items():
        for tag, out in fam.items():
            if name in out["train_bf16"]["launches"]:
                e[f"launches_{tag}_train_bf16"] = out["train_bf16"]["launches"][name]

    # phase 20: continued pretraining through the auxiliary spec at full
    # width (f32 pairs, bf16 timed steps), the score API over phase 16's
    # export, and the paper-bench twins
    timed("cont_pretrain_f32", phase_cont_pretrain_f32, cfg, dev)
    torch.cuda.empty_cache()
    cp_out = timed("cont_pretrain_bf16", phase_cont_pretrain_bf16, cfg, dev, args.out)
    torch.cuda.empty_cache()
    timed("score_api", phase_score_api, dataopt_out["export_path"])
    twins = timed("paper_benches", phase_paper_benches, args.out)
    entry["launches_bench_serve"] = twins["serve"]["launches"]["flash_decode"]
    for name, e in by_name.items():
        if name in cp_out["launches"]:
            e["launches_cont_pretrain_bf16"] = cp_out["launches"][name]
        e["launches_paper_benches"] = {t: out["launches"].get(name, 0)
                                       for t, out in twins.items()}

    # launches: each kernel's count from this slice's main path (the gemma3-1b
    # bf16 run) where it runs there, else from the run that drives it (the
    # Lion and Adafactor kernel steps); the bert-base run's counts beside them,
    # and those of phases 18-19's bf16 runs
    for name, e in by_name.items():
        if name in gemma_out["launches"]:
            e["launches"] = gemma_out["launches"][name]
            e["launches_path"] = f"train_gemma_bf16 ({BF16_STEPS} meta steps)"
        else:
            base = name.replace("_adapt", "")
            e["launches"] = la_out[base]["launches_per_step"][name] * la_out[base]["steps"]
            e["launches_path"] = f"train_lion_adafactor {base} (kernel steps)"
        if name in bert_out["launches"]:
            e["launches_train_bf16_bert"] = bert_out["launches"][name]
        if not e["launches"] >= 1:
            raise AssertionError(f"{name}: no launch on its path")
    # the CE kernels' f16 instantiation: its checks and times from phase 4,
    # its launches from phase 15(d)'s f16 linear probe
    for kernel in (wce.FWD, wce.BWD):
        w = ce_worst["fwd" if kernel == wce.FWD else "bwd"]
        e = {"name": f"{kernel}_f16", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/weighted_ce.cu",
             "replaces": by_name[kernel]["replaces"], "build_seconds": build_s["weighted_ce"],
             "max_abs_err": w["float16"], **t_time[f"{kernel}_f16"],
             "launches": f16_out["f16_ce_probe"]["launches"][f"{kernel}_f16"],
             "launches_path": "scale_f16 probe (f16 policy, 8,192 classes, 2 meta steps)"}
        if kernel == wce.BWD:
            e["f16_vs_f32_share_of_bound"] = w["float16_share_of_bound"]
        if not e["launches"] >= 1:
            raise AssertionError(f"{e['name']}: no launch on its path")
        train_entries.append(e)
    # phase 21: the recurrent families at full width (training at the
    # depths of RECURRENT_TRAIN_LAYERS)
    rec = {}
    for tag, arch in (("rwkv", "rwkv6-1.6b"), ("zamba", "zamba2-7b")):
        rec[tag] = timed(tag, phase_recurrent, configs.get_config(arch), dev, args.out, tag)
        torch.cuda.empty_cache()
    for tag, out in rec.items():
        entry[f"launches_{tag}_serve_bf16"] = out["flash_decode_launches"]
        for name, e in by_name.items():
            if name in out["train_bf16"]["launches"]:
                e[f"launches_{tag}_train_bf16"] = out["train_bf16"]["launches"][name]

    # phase 22: cross-attention: whisper-small at full size, llama-3.2-vision-90b
    # at full width and VISION_LAYERS layers
    whisper_out = timed("whisper", phase_whisper, whisper, dev, args.out)
    torch.cuda.empty_cache()
    vision_out = timed("vision", phase_vision, vision, dev)
    torch.cuda.empty_cache()
    # whisper's paths: every kernel of them launched (the Lion and Adafactor
    # products are not on them)
    entry["launches_whisper_serve_bf16"] = whisper_out["flash_decode_launches"]
    entry["launches_vision_serve_f32"] = vision_out["serve_f32"]["flash_decode_launches"]
    by_name[flash_attn.FWD]["launches_vision_forward_f32"] = vision_out["forward_f32"]["launches"]
    for name, e in by_name.items():
        e["launches_whisper_train_bf16"] = whisper_out["train_bf16"]["launches"].get(name, 0)
    on_path = [entry["launches_whisper_serve_bf16"]] + [
        by_name[n]["launches_whisper_train_bf16"] for n in by_name
        if n not in ("lion_adapt", "adafactor_adapt")]
    if not min(on_path) >= 1:
        raise AssertionError(f"whisper-small: a kernel of its path did not launch: {on_path}")

    # phase 25: the kernel registry on the card, per-phase attribution of the
    # bf16 bert-base and gemma3-1b steps held against their meta traces, the
    # kernel, attention and attribution twins, the roofline's count beside
    torch.cuda.empty_cache()
    log(f"phase 25 starts with {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated")
    timed("registry", phase_registry, dev)
    timed("attribution", phase_attribution, dev)
    timed("bench_twins", phase_bench_twins, args.out)

    log(f"phase_seconds: {json.dumps(secs)} total {time.perf_counter() - t_start:.1f}s")
    log(json.dumps({"kernels": [entry] + train_entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
