#!/usr/bin/env python3
"""On-card smoke run of the ``repro_torch`` port: SpMV, SpMM, LM serving
and training (dense, MoE, the recurrent rwkv6 and zamba2, the
encoder-decoder whisper and the prefix-LM paligemma), data-parallel
training, tensor- and expert-parallel training and serving and the
vocab-sharded decode embedding on simulated meshes, the graph apps and
concurrent query serving on the H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's main paths — ``SpMV.from_coo(..., backend="cuda")``
then ``.matvec(x)`` and ``.matvec_many(xs)``, and ``SpMM.from_coo(...,
backend="cuda")`` then ``.matmat(B)`` — on two SuiteSparse analogues at
their published sizes (``sparse/generators.py``), LM serving
(``repro_torch.serve.engine.generate``) at the published widths, and the
entry points of the three standalone kernels at real sizes, and fails
(non-zero exit, no result line) if any phase fails:

1. device: CUDA present; prints the card's name and power limit on a line
   of their own, as ``nvidia-smi`` gives them;
2. build: compiles every kernel source of ``src/repro_torch`` with ``nvcc``
   for ``sm_90a`` into ``build/repro_torch`` (one ``nvcc`` per source, all
   at once) and prints the times and the compiler's register/spill report;
3. stage-A kernel phases: every window / dense-slice launch of both
   matrices, fused and per-class, coalesced and not, bitwise against the
   kernel's plain torch version on the card, for add and mul on float32
   and min and max on int32, at ``D`` 1 (``x`` a vector), 16 (a dense
   ``(n, 16)`` operand: trailing lane axes) and 32 (the SpMV endpoint's
   ``max_batch``, the lane count of phase 8's served batches);
4. main paths: ``matvec`` and ``matmat`` (``D = 16``) with ``fused=True``
   and ``coalesce`` False and True, against a float64 numpy ``np.add.at``
   oracle (max rel err <= 1e-5) and bitwise against the port's ``"torch"``
   backend; ``matvec_many`` on the pwtk analogue (``S = 8``) bitwise
   against 8 ``matvec`` calls; the launch counters, zeroed just before each
   run and read just after, must show every kernel the lowering names;
5. standalone kernels, each bitwise against its plain version on the card
   and each driven once through its entry point with the counters zeroed:
   ``segment_reduce_op`` on the pwtk plan's own blocks and combined terms
   (op_flag 7 and FULL_REDUCE; add/mul f32, min/max i32, add f64; ``D`` 1
   and 16), ``gather_vload_op`` on the webbase plan's window blocks (``ls``
   1, 2, 4 and 32, and stream; f32 and i32; ``D`` 1 and 16) and
   ``row_gather_op`` at the token dispatch of one qwen3-moe-235b-a22b layer
   (4,096 tokens of ``d_model`` 4,096 plus a zero row, top-8 of 128
   experts, so 32,768 row ids sorted by expert; bf16 and f32); the timed
   ``gather_vload`` cases (the fused section at ``D`` 1 and 16 in f32, and
   16 in bf16) are also held bitwise to their plain version and to
   ``torch.take``;
6. LM serving (``[lm]``): ``repro_torch.serve.engine.generate`` (greedy) on
   granite-3-2b, whole (40 layers, 2.53 B parameters), on qwen3-moe-235b-a22b
   at full width cut to 4 of its 94 layers (128 experts, top 8), and on
   rwkv6-3b (32 layers, 2.70 B parameters, 4 WKV chunks of 32 in the
   prefill) and zamba2-1.2b (38 Mamba2 layers and the weight-tied attention
   block after every 6th; 1.10 B parameters), each batch 4, prompt 128, 8
   steps; and on whisper-small (12 encoder layers over 1,500 frames and 12
   decoder layers with cross attention; 0.29 B parameters) and
   paligemma-3b (18 layers, 256 patch tokens in front of the prompt under
   the prefix-LM mask; 2.51 B parameters), each whole, batch 4, prompt
   128, 16 steps; bf16 weights, whisper's frames and paligemma's patch
   embeddings (standard normal float32, the stubbed frontends' inputs)
   drawn from ``SEED``; the parameter counts of the recurrent,
   encoder-decoder and vlm models must equal the reference's.  The MoE
   layers' dispatch and combine
   run on the ``row_gather`` kernel: its launches in the run (two per MoE
   layer and forward) are counted, every one is held bitwise to the plain
   version on the same rows, and the whole run repeated on the plain row
   gather gives bitwise the same tokens, final logits and cache.  Prints
   prefill ms, decode ms per step, tokens/s and peak memory, a profiler
   breakdown of a prefill and a decode step (device busy, idle share,
   kernel launches, top kernels), and ``row_gather`` at the prefill's
   dispatch and combine beside ``index_select``.  Then, in float32, decode
   == forward for each model (prompt 8, 4 decoded tokens, batch 2; the MoE
   dropless, ``capacity_factor`` = experts) at ``tests/test_serve.py``'s
   ``rtol=2e-2, atol=2e-3``; zamba2's over all 38 layers (the 2 after the
   last shared block included): in float64 on the same weights at that
   rule, and in float32 (decode == forward, and each against the float64
   forward) at twice it, ``HYBRID_DECODE_TOL``; whisper's with all 1,500
   frames; paligemma's with all 256 patch tokens, in float64 on the same
   weights at that rule (its float32 rounding alone passes the bound), and
   in float32 its decode no farther from the float64 forward than
   ``VLM_ROUNDING`` times its float32 forward.  Then the sliding windows
   and kimi-k2's experts at the published widths: gemma3-27b whole (62
   layers, 52 of them local with a window of 1,024, 10 global; 27.0 B
   parameters) at prompt 1,152 and h2o-danube-3-4b whole (24 layers,
   window 4,096; 3.84 B) at prompt 4,224, each past its window so the
   rings wrap in prefill and in decode, and kimi-k2-1t-a32b at 1 of its 61
   layers (384 experts, top 8, an untied vocabulary of 163,840; 19.4 B),
   prompt 128, its row gathers held and timed as qwen3-moe's; batch 4, 8
   steps, each parameter count equal to the reference's; their float32
   decode == forward at gemma3's 7 layers (a global layer after five local
   ones) past its window, danube's 4 layers past its window (held as
   paligemma's, in float64 on the same weights: its float32 rounding
   alone passes the bound), kimi's layer at 128 of its experts (dropless;
   top 8 and every width kept);
7. graph apps: ``BFS``, ``SSSP`` (the case's weights, uniform in 0.1-1.0),
   ``ConnectedComponents`` (on the symmetrized edges) and ``PageRank`` (20
   iterations, damping 0.85) through ``from_edges(..., backend="cuda",
   lane_width=128, fused=True)`` on the soc-Pokec analogue
   (``G.graph_case("powerlaw", 1632803, avg_deg=19)``, ~30.9M edges, not
   cut), each run with both drivers and held bitwise (state and
   ``ConvergenceReport``) to the ``"torch"`` backend on the same plan and
   to ``scipy.sparse.csgraph``: BFS levels equal to
   ``shortest_path(unweighted=True)``, SSSP within 1e-5 relative of
   float64 Dijkstra, CC's partition and min labels equal to
   ``connected_components``, PageRank within 1e-5 (max abs error over max
   rank) of a float64 power iteration; ``run_multi`` with 8 sources
   (``D = 8`` on the kernels) row for row bitwise ``run``; the stage-A
   counters, zeroed before each run, must grow on every ``"cuda"`` run.
   Per app it prints the plan build time, the fallback share of blocks, the
   sweeps, end-to-end ms with each driver, device ms per sweep, the idle
   share and the top kernels under ``torch.profiler``;
8. serving: ``repro_torch.serve.query.QueryEngine`` over three endpoints,
   all ``backend="cuda"``, ``lane_width=128``, ``fused=True``, reusing the
   graph phase's BFS and SSSP apps and the pwtk ``coalesce=True`` SpMV (so
   BFS and SSSP run the window kernel, SpMV the dense-slice one): 32 BFS and
   16 SSSP requests (sources drawn with ``SEED``, ``max_batch`` 8) and 256
   float32 SpMV vectors (``max_batch`` 32), each from 4 client threads after
   ``warmup``, all submitted at once (a saturation burst).  Every request
   served (no shed, deadline or other error), the breaker closed, the
   endpoint warm in ``health()``, every response bitwise its sequential
   ``run`` / ``matvec``, every served batch's rows bitwise the same
   payloads as one batch through the ``"torch"`` backend on the same plan,
   and the stage-A counters, zeroed before the traffic, grown during it.
   Prints the batch sizes seen, wall s, peak QPS, p50 and p99 ms of a
   request's time in the burst, and the wall time of the same requests
   served one by one; ``matvec_many`` of ``S = 9`` on pwtk in device ms at
   ``bucket=True`` (16 lane columns) and ``bucket=False``; and runs
   ``python -m repro_torch.launch.serve_queries --check 32`` once in a
   child process on the webbase-1M analogue (256 requests), which must
   serve all and find its 32 sampled responses bitwise those of a
   ``"torch"`` build;
9. tuned path: ``SpMV.from_coo(..., backend="auto", tune_cache_dir=...)`` on
   both matrices, the tuner's RuntimeWarnings turned into failures: every
   measured candidate (label, predicted us, the model before its backend's
   scale, measured us) and the winner
   are printed, at least one ``cuda`` candidate must be measured, none
   disqualified or rejected by the oracle, the winner's ``matvec`` within
   1e-5 of the float64 oracle, and a rebuild on the same cache a hit with
   no measurement and the same choice; the winner is timed beside the fixed
   ``backend="cuda"`` build.  ``backend="segsum"`` on both matrices within
   1e-5 of the oracle (its float sum is atomic on the card, so not bitwise
   the torch backend's).  Two ``plan_cache_dir`` builds of webbase-1M, the
   second a hit with a bitwise-equal result (skipped, with a line saying
   so, where the optional msgpack does not import).  ``BFS.from_edges(...,
   backend="auto")`` on the soc-Pokec analogue with the resident driver,
   its levels equal to scipy's, timed beside a fixed ``backend="segsum"``
   BFS (also equal to scipy's) with the model's prediction of every
   candidate of the space.  ``report()`` of each tuned app: its
   launch count equals the lowered tree's and its JSON parses;
10. timings: ``matvec``, ``matvec_many`` and ``matmat`` end to end (host
   clock around the call and a synchronize, median of 20) and in device
   time (CUDA events around back-to-back calls queued behind a spin kernel,
   so launch overhead leaves no gaps; median of 5 such measurements); a
   ``torch.profiler`` breakdown of device time by kernel; each kernel's
   device time beside its bound (each distinct input word read once, each
   output word written once), its plain version's and, where one PyTorch
   call computes the same function, that call's time (``index_select`` for
   ``row_gather``, ``take`` for ``gather_vload``), and for ``row_gather``
   the time the card takes to write its output alone; and cuSPARSE's SpMV and
   SpMM (``torch.sparse_csr_tensor(...) @ x``) as end-to-end yardsticks;
   the ``"mul_all"`` dense-slice time at ``D = 16`` beside the number of
   its design before the ``"add_all"`` combine (``PERF.md``);
11. card tests: the ``cuda``-marked tests of ``tests/test_torch_cuda.py``
   (every kernel bitwise against its plain version at the edges of the
   ladder's shapes), in three shares (the tests of index 0-11, 12-39 and
   40-49 modulo 50, sized to the work beside each), each in a child
   process while this one does untimed work: beside phases 3-4's checks,
   beside ``[dryrun]`` and the graph phase's generation and plan builds,
   and beside the
   ``[shard]`` phase's graph builds; each is joined before the next timed
   work;
12. sharded execution (``[shard]``, run after the tuned path): simulated
   meshes (every shard on the one card: ``shards=k, simulate_mesh=True``
   for SpMV and SpMM, ``mesh=make_shard_mesh(k, device=..., simulate=True)``
   for the graph apps),
   ``backend="torch"`` and ``"segsum"`` (the sharded path takes no kernel,
   as the reference's Pallas kernels are single-device).  On pwtk:
   ``SpMV.matvec`` at 2 and 4 shards with both backends (torch bitwise the
   single-device torch backend, both within 1e-5 of the float64 oracle),
   ``SpMM.matmat`` at ``D = 16`` and 4 shards with add and min (bitwise the
   single-device torch backend), ``backend="auto", shards=2`` (both shard
   counts measured, the winner within 1e-5), ``backend="cuda"`` with
   ``shards=2`` and ``matvec_many`` on a sharded SpMV raising.  On
   soc-Pokec at 4 shards: BFS, SSSP and PageRank through
   ``from_edges(mesh=...)`` on the edges sorted by destination, which cut
   into several non-empty shards (CC's symmetrized edges cut into one
   non-empty shard whatever their order, so a CC cell runs no all-gather
   across shards: ``tests/test_torch_shard.py`` holds sharded CC), each
   with both drivers bitwise the single-device torch run on the same plan
   (states, sweeps and flags), ``run_multi`` on the sharded BFS raising.
   The
   counters, zeroed before each sharded run, must stay 0.  Prints the host
   seconds of ``ir.lower`` + ``partition_plan``, device ms per call or per
   resident sweep beside the single-device torch backend's, end-to-end ms
   per run and the peak memory of each run.

13. LM training (``[train]``, run after ``[lm]``):
   ``repro_torch.train.loop.Trainer.run()`` at the published widths, bf16
   weights and ``synth_batch`` data from ``SEED``, ``remat="full"``, the
   launcher's AdamW schedule (lr 3e-3, warmup ``steps // 10 + 1``), no
   checkpoint inside the timed runs.  granite-3-2b whole (40 layers, 2.53 B
   parameters), batch 8, seq 512, 4 steps; qwen3-moe-235b-a22b at full
   width cut to 1 of its 94 layers (3.73 B parameters, 44.7 GB with the
   float32 moments), batch 4, seq 128 (one dispatch group of 512 tokens,
   ``C = 40``), 6 steps; zamba2-1.2b whole, batch 8, seq 512 (two SSD
   chunks of 256), 6 steps; rwkv6-3b whole, batch 4, seq 256 (eight WKV
   chunks of 32; ~34 GB with the float32 moments), 3 steps; whisper-small
   and paligemma-3b whole, batch 8, seq 512 (whisper's encoder over 1,500
   frames, paligemma's layers over 256 + 512 positions), 6 steps.  Before
   its run
   the MoE model does one loss + backward on the kernel path, every
   ``row_gather`` launch (forward, recompute, backward: 6 a layer) held
   bitwise to the plain gather, then the same on the plain gather: the
   losses bitwise, every gradient leaf within ``TRAIN_GRAD_TOL``, every
   token row's embedding gradient and the experts' gradients non-zero.
   Each run: every loss finite, the last below the first, the
   ``row_gather`` count 6 a layer and step (0 for the dense and recurrent
   models); prints each step's loss, the median step ms of steps 2 on (host
   clock), tokens/s, ``6 N tokens`` per second as a share of the bf16 dense
   peak (counted per stack: whisper's encoder parameters over ``batch x
   enc_len`` frames, paligemma's layers over ``batch x (num_prefix +
   seq)`` positions; see :func:`train_flops`), the peak memory above what
   earlier phases hold, a profiled step,
   and ``row_gather`` at the backward of the dispatch beside
   ``index_select``.  Resume: granite-3-2b at full width cut to 2 layers, 6
   steps straight against 3 steps with an async checkpoint and a fresh
   ``Trainer`` resumed to 6: parameters and moments bitwise equal or within
   ``TRAIN_GRAD_TOL`` (the line says which), with the checkpoint's bytes
   and its save and restore seconds.

14. data parallel (``[dp]``, run after ``[train]``): ``Trainer(mesh=...,
   rules=default_rules(mesh)).run()`` on simulated meshes (every shard on
   the one card), the parameters and AdamW moments ``Sharded`` pieces
   (FSDP over ``data``), one ``LM`` replica a shard refilled by an
   all-gather each step, the gradients reduce-scattered in float32.
   granite-3-2b whole, bf16, 2 shards, batch 8 x 512, 4 steps: losses
   finite, the last below the first; step ms, tokens/s, peak memory, a
   device's share of the parameters and moments, the device busy ms of
   the all-gather and of the reduce-scatter, and a profiled step.  With
   8-bit AdamW moments (ROADMAP item 23: ``q`` and ``s`` of the flat
   stacked leaf, their blocks over ``data``; the gradients reduce-scattered
   in that flat order, the new values exchanged into the pieces): the same
   granite cell, 6 steps, and qwen3-moe at 1 layer (its 6 ``row_gather`` a
   step counted, its peak beside the float32 cell's); granite in float32
   at 4 layers, its moments after step 1, dequantized, at the dense rule
   of one device's 8-bit update on the same summed gradients (unclipped),
   ``q`` equal but across a rounding boundary.
   qwen3-moe-235b-a22b at full width cut to 1 layer, bf16, 2 shards, batch
   4 x 128, 4 steps (one dispatch group of 512 tokens across both
   replicas): 6 ``row_gather`` launches a step counted, step 1's loss at
   the tests' dense rule (``rtol=1e-4, atol=1e-5`` x scale) and its grad
   norm at ``BF16_NORM_RULE`` of one device's.  In float32 at full width
   (granite-3-2b cut to 4 layers): the state after step 1 at 2 shards
   against one device on the same rows as 2 microbatches, every moment
   and weight within the dense rule of its leaf's scale, steps 1-2's
   loss and grad norm at the dense rule, and against one device on the
   whole batch step 1's loss and grad norm, and every weight as AdamW's
   first step on its own run's moments (where the moments part is
   printed by leaf); an elastic restart (granite-3-2b at 2 layers,
   float32: 3 steps at 2 shards with an async checkpoint, a fresh
   single-device Trainer resumed to 6, against 6 straight at 2 shards,
   each resumed step at the dense rule).  qwen3-moe-235b-a22b at 4 layers
   decoding 16 greedy steps with ``decode_embed="psum"`` on a simulated
   (1, 4) mesh: tokens, next logits and cache ``torch.equal`` to the
   gather decode's, 4 ``row_gather`` launches a decode step for the
   lookup (each held bitwise to the plain gather) counted with the MoE
   layers', and the lookup timed beside the whole table's gather,
   ``index_select`` and its bytes bound.

15. the dry run's reckoning (``[dryrun]``, run after ``[dp]``; host work,
   no device): ``repro_torch.launch.dryrun.reckon`` held against what the
   card measured in this call.  A device's ``argument_bytes`` of the
   ``[dp]`` granite cell equal the bytes its pieces hold (parameters,
   AdamW state, batch), with float32 and with 8-bit moments, exactly; the
   reckoned collective bytes equal those ``DataParallel`` counted in one
   step of each, exactly; the traced ``[train]`` granite step's flops
   equal ``FlopCounterMode`` over that step on the card, exactly; its
   reckoned peak of temporaries is printed beside
   ``torch.cuda.max_memory_allocated`` above the step's arguments, as a
   ratio.  Over model pieces (run after ``[tp]``): for the float32
   granite (2, 2) cell, the qwen3-moe (1, 2) train cell and the 8-bit
   granite (2, 2) cell, ``reckon`` traces one data replica's program over
   its pieces; its collectives (the data axis's and the model axis's)
   equal those ``DataParallel`` counted in one step, its argument bytes
   what device 0 holds, and its flops over every device of the mesh
   ``FlopCounterMode`` over one step on the card, exactly.

16. tensor and expert parallel (``[tp]``, run after ``[dp]``): simulated
   ``(data, model)`` meshes with the default rules (``heads``,
   ``heads_flat``, ``kv_heads``, ``mlp``, ``experts``, ``router_experts``
   and ``vocab`` over ``model``; ``launch/tensor_parallel.py``), each cell
   against one device in the same call, bf16 at seed 0 with the
   launcher's schedule and ``remat="full"`` unless said.
   ``Trainer.run()`` on (1, 2): granite-3-2b whole, batch 8 x 512, 4
   steps (its vocabulary of 49,155 whole in each piece) and
   qwen3-moe-235b-a22b at 1 layer, 4 x 128, 4 steps (64 of 128 experts, 2
   of 4 kv heads and half the vocabulary a piece; 12 ``row_gather`` a
   step in the experts and 2 in the lookup counted); rwkv6-3b at 4
   layers, 4 x 256, zamba2-1.2b at 7 (the shared block once), 8 x 512,
   whisper-small at 4 + 4 and paligemma-3b at 4, 8 x 512, 3 steps each
   (the lookup's 2 ``row_gather`` a step counted, none for whisper's
   vocabulary of 51,865, whole in each piece), held against 2 steps on
   one device in this phase where no ``[train]`` cell matches: losses
   finite, the last below the first (but qwen3-moe's), step 1's loss and
   grad norm at ``BF16_NORM_RULE`` of one device's (for the family cells,
   where one device's own bf16 value lies past that bound from the same
   step in float32, no farther from float32's than ``TP_ROUNDING`` times
   one device's), and for the family cells step 1 again with a planted
   fault (``PLANTED_LEAF``: piece 1's block of the last layer's mixer
   output projection zeroed) read beside those bounds.  float32 on (2, 2), 1 step: granite at 4 layers, rwkv6
   at 2 and zamba2 at 7, both moments of every leaf at the dense rule
   against one device on the same rows as 2 microbatches, every weight
   as AdamW's first step on its own moments.
   ``engine.generate`` over ``ModelPieces`` on (1, 2): gemma-7b whole
   (vocabulary 256,000, 16 heads and the GeGLU ``d_ff`` of 24,576 cut in
   two), batch 4, prompt 128, 8 greedy steps: at least
   ``TP_TOKENS_MIN`` (0.75) of the greedy tokens equal one device's, the
   prefill's and first decode step's bf16 logits no farther from the same
   weights in float32 than ``TP_ROUNDING`` (1.25) times one device's bf16
   logits, and farther with a planted fault (piece 1's share of the last
   layer's attention dropped); in float32 at 2 layers, the tokens equal
   and those logits at ``LM_TOL``.  rwkv6-3b, zamba2-1.2b, whisper-small
   (1,500 frames) and paligemma-3b (256 patches) alike, whole in bf16
   and at 2 layers (whisper 2 + 2) in float32, batch 4, prompt 128, 4
   greedy steps, the planted fault (``PLANTED_LEAF``) read beside the
   bf16 logits' bound (``PLANTED_SERVE`` says where it must pass it);
   rwkv6's and paligemma's bf16 tokens at ``TP_TOKENS_MIN``, zamba2's
   and whisper's not held (bf16 rounding picks them: their agreement
   with the same weights' float32 tokens is printed); in float32 the
   tokens equal, zamba2's logits at ``HYBRID_DECODE_TOL``, paligemma's
   no farther from float64 than ``VLM_ROUNDING`` times one device's.  Every row gather of
   the serving cells' lookup (one a piece in each prefill and decode
   step) is counted and held bitwise to the plain version.  Each cell
   prints step or decode ms beside one device's, tokens/s, the
   collectives counted a step (count and bytes), the device time of its
   sums and gathers over the pieces (replayed back to back, CUDA events),
   a profiled step (launches, idle share), peak memory and a device's
   bytes.

17. 8-bit AdamW moments over model pieces (``[tp]``, run after phase 16;
   ``q`` and ``s`` of the flat stacked leaf, their blocks over ``data``
   alone, so every model replica of a data index updates the same run of
   blocks, assembled from its data replica's pieces): float32 granite-3-2b
   at 4 layers on (2, 2), 2 steps, unclipped: each step's weights and
   ``q`` / ``s`` bitwise one device's 8-bit ``adamw.update`` from the same
   state on the gradients the step assembled, every model replica's ``q``
   / ``s`` bitwise alike; bf16 qwen3-moe-235b-a22b at 1 layer on (1, 2),
   4 x 128, 4 steps through ``Trainer.run()``: losses finite, every row
   gather held bitwise to the plain version and counted (12 in the expert
   pieces and 2 in the lookup a step).  Each prints a device's bytes of
   moments and the collectives a step.

The build phase prints, per kernel, the registers, stack and spilled bytes
of the compiler's report.  The line before the last is the kernels JSON
line; the last line is ``{"ok": true, "device": {...}}``.  (The tuner's
``CUDA_SCALE`` is read by ``python -m repro_torch.tune.calibrate``.)
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
REL_ERR_LIMIT = 1e-5
CARD_TESTS_S = 900             # time limit of a share of the card tests
# the card tests run as 3 shares, each in a child process (2 CPU threads)
# while this one does untimed work: share 0 beside the checks of phases
# 3-4, share 1 beside [dryrun]'s host work and the graph phase's
# generation and plan builds, share 2 beside the [shard] phase's graph
# builds (a share's wait is logged).  Share i takes the tests whose index
# modulo 50 lies in its slots, sized to the untimed work beside it (~50,
# ~170 and ~95 s on the H100's host: shares of 51, 106 and 47 s before
# slots 40-41 moved to share 1)
CARD_TEST_SLOTS = ((0, 12), (12, 42), (42, 50))
CARD_TEST_SHARES = len(CARD_TEST_SLOTS)
# beside a host-clock reading taken while a share runs: such a reading is
# not comparable with one taken with the card and the CPU to this process
BESIDE_TESTS = "host clock, beside a share of the card tests"
SEMIRINGS = (("add", np.float32), ("mul", np.float32), ("min", np.int32),
             ("max", np.int32))
# the two SuiteSparse analogues of the paper's evaluation
MATRICES = {
    "pwtk": dict(kind="banded", n=217918, band=26),        # Boeing/pwtk
    "webbase-1M": dict(kind="power_law", n=1000005, avg_deg=3),
}
SPMM_D = 16                    # SpMM's dense operand is (n, SPMM_D)
MANY_S = 8                     # vectors of the matvec_many run
# segment_reduce cases on the pwtk blocks: (reduce, dtype)
SEGMENT_CASES = (("add", np.float32), ("mul", np.float32),
                 ("min", np.int32), ("max", np.int32), ("add", np.float64))
GATHER_LS = (1, 2, 4, 32)      # window counts of the gather_vload phase
# one MoE layer of src/repro/configs/qwen3_moe_235b_a22b.py
MOE = dict(tokens=4096, d_model=4096, num_experts=128, top_k=8, d_tile=512)
# the soc-Pokec analogue (SNAP soc-Pokec: 1,632,803 nodes, 30,622,564
# edges), named among the paper's graphs in sparse/generators.py
GRAPH = dict(kind="powerlaw", n=1632803, avg_deg=19)
GRAPH_S = 8                    # sources of the run_multi runs (D = 8)
PAGERANK_ITERS = 20
# the [serve] phase: concurrent queries through repro_torch.serve.query over
# the graph phase's BFS / SSSP apps and the pwtk coalesce=True SpMV
SERVE = {"bfs": dict(requests=32, threads=4, max_batch=8),
         "sssp": dict(requests=16, threads=4, max_batch=8),
         "spmv": dict(requests=256, threads=4, max_batch=32)}
SERVE_BUCKET_S = 9             # matvec_many S of the bucket=True/False timing
# the launcher's child run: the webbase-1M analogue's generator and size
LAUNCHER_ARGS = ["--app", "spmv", "--nodes", "1000005", "--avg-deg", "3",
                 "--requests", "256", "--threads", "4", "--check", "32",
                 "--json", "build/serve.json"]
LAUNCHER_S = 600               # time limit of the launcher's child run
# the [lm] phase: LM serving through repro_torch.serve.engine at the
# published widths, weights from SEED; "layers" cuts the depth
LM_CELLS = (     # decode steps halved for the [tp] phase's time
    dict(arch="granite-3-2b", layers=None, batch=4, prompt=128, steps=8),
    dict(arch="qwen3-moe-235b-a22b", layers=4, batch=4, prompt=128,
         steps=8),
    dict(arch="rwkv6-3b", layers=None, batch=4, prompt=128, steps=8),
    dict(arch="zamba2-1.2b", layers=None, batch=4, prompt=128, steps=8),
    # 1,500 encoder frames; 256 patch tokens in front of the prompt
    dict(arch="whisper-small", layers=None, batch=4, prompt=128, steps=16),
    dict(arch="paligemma-3b", layers=None, batch=4, prompt=128, steps=16),
    # sliding windows and kimi-k2's 384 experts at the published widths:
    # gemma3-27b whole (52 local layers, window 1,024, 10 global; 54.0 GB
    # of weights) and h2o-danube-3-4b whole (window 4,096), each prompt
    # past the window, so the rings wrap in prefill and in decode;
    # kimi-k2 at 1 of 61 layers (38.8 GB).  "check" cuts the float32
    # decode == forward check (LM_CHECK's prompt and depth; kimi's experts:
    # its one layer whole is 77.5 GB in float32; "float64": held against
    # the same weights in float64, as paligemma is)
    *(dict(arch=arch, layers=layers, batch=4, prompt=prompt, steps=8,
           check=check)
      for arch, layers, prompt, check in (
          ("gemma3-27b", None, 1152, dict(layers=7, prompt=1032)),
          ("h2o-danube-3-4b", None, 4224, dict(layers=4, prompt=4100,
                                               float64=True)),
          ("kimi-k2-1t-a32b", 1, 128, dict(num_experts=128)))),
)
# the JAX package's parameter count of each whole model of the recurrent,
# encoder-decoder, vlm and sliding-window cells, and of kimi-k2 cut to 1 layer
# ("name@layers") (jax.eval_shape of its init_model at the published
# config; tests/test_torch_lm_cells.py holds them to the reference)
REFERENCE_PARAMS = {"rwkv6-3b": 2695825920, "zamba2-1.2b": 1104937856,
                    "whisper-small": 294683904,
                    "paligemma-3b": 2508662784,
                    "gemma3-27b": 27008319744,
                    "h2o-danube-3-4b": 3838959360,
                    "kimi-k2-1t-a32b@1": 19378623488}
LM_CHECK = dict(batch=2, prompt=8, decoded=4)  # decode == forward, float32
LM_TOL = dict(rtol=2e-2, atol=2e-3)            # tests/test_serve.py
# zamba2's float32 readings (Smoke.hybrid_decode_check): at full width its
# float32 forward alone lies 1.047 of LM_TOL's bound from the float64
# forward of the same weights (H100, PERF.md), so float32 decode and
# forward, each that far from it, are held at twice LM_TOL
HYBRID_DECODE_TOL = dict(rtol=2 * LM_TOL["rtol"], atol=2 * LM_TOL["atol"])
# paligemma's float32 rounding alone passes LM_TOL's bound, and so does
# h2o-danube-3-4b's past its window (Smoke.float64_decode_check; danube's
# float32 decode == forward read 1.864 of the bound on the H100): their
# float32 decode is held to lie no farther from the float64 forward than
# VLM_ROUNDING times their float32 forward does
VLM_ROUNDING = 2.0
# the [train] phase: LM training through repro_torch.train.loop.Trainer at
# the published widths, weights and data from SEED; "layers" cuts the depth
TRAIN_CELLS = (
    dict(arch="granite-3-2b", layers=None, batch=8, seq=512, steps=4),
    dict(arch="qwen3-moe-235b-a22b", layers=1, batch=4, seq=128, steps=6),
    # two SSD chunks of 256 a layer; eight WKV chunks of 32
    dict(arch="zamba2-1.2b", layers=None, batch=8, seq=512, steps=6),
    dict(arch="rwkv6-3b", layers=None, batch=4, seq=256, steps=3),
    dict(arch="whisper-small", layers=None, batch=8, seq=512, steps=6),
    dict(arch="paligemma-3b", layers=None, batch=8, seq=512, steps=6),
)
TRAIN_RESUME = dict(arch="granite-3-2b", layers=2, batch=8, seq=512,
                    steps=6, first=3)
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense, tensor cores
# the [dp] phase: data-parallel training on simulated meshes (every shard on
# the one card) with the default rules, and the psum decode embedding over a
# simulated (1, model) mesh; widths published, "layers" cuts the depth
DP_CELLS = (
    dict(arch="granite-3-2b", layers=None, batch=8, seq=512, steps=4,
         shards=2, compare=0),
    # its first step's loss and grad norm held to one device's
    dict(arch="qwen3-moe-235b-a22b", layers=1, batch=4, seq=128, steps=4,
         shards=2, compare=1),
    # 8-bit AdamW moments under the mesh (the flat reduce-scatter and the
    # exchange of ROADMAP item 23)
    dict(arch="granite-3-2b", layers=None, batch=8, seq=512, steps=6,
         shards=2, compare=0, q8=True),
    dict(arch="qwen3-moe-235b-a22b", layers=1, batch=4, seq=128, steps=4,
         shards=2, compare=0, q8=True),
)
# float32: one 8-bit data-parallel step against one device's 8-bit update
# on the same summed gradients (unclipped, as tests/test_torch_dp.py)
DP_Q8_STATE = dict(arch="granite-3-2b", layers=4, batch=8, seq=512,
                   shards=2)
# float32, where the dense rule applies: in bf16 each replica's gradient is
# rounded to 8 bits before the float32 reduce-scatter, where one device
# rounds the whole batch's once (2^-9 of a gradient, past the rule's 1e-4);
# the resume in float32 too
DP_STATE = dict(arch="granite-3-2b", layers=4, batch=8, seq=512, steps=2,
                shards=2)
DP_RESUME = dict(arch="granite-3-2b", layers=2, batch=8, seq=512, steps=6,
                 first=3, shards=2)
DP_DECODE = dict(arch="qwen3-moe-235b-a22b", layers=4, batch=4, prompt=128,
                 steps=16, model=4)
# the planted fault of a cell (tp_planted): piece 1's block of the last
# layer's mixer output projection (attention, time mix or SSD) zeroed, so
# its share of that layer's sum is dropped.  True: the fault must break
# the cell's bounds (a train cell's step-1 loss or grad norm bound, a
# serving cell's logits bound in the prefill and the first decode step);
# "read": printed beside them, not held, where it lies within bf16
# rounding's reach, so that the cell checks only that it runs and its
# float32 cells are the correctness check.  On the H100, step 1 with the
# fault reads (loss; grad norm, of its bound): rwkv6 4.80; 12.76, zamba2
# 0.87; 0.79, whisper 0.25; 6.57, paligemma 8.42; 41.40.  Served, over
# one device's distance from float32 (prefill; decode; 1.25 the bound):
# rwkv6 2.408; 2.099, zamba2 0.971; 1.073, whisper 0.839; 1.044,
# paligemma 1.061; 0.965 (the sound pieces 1.059; 0.926, 0.967; 1.073,
# 0.817; 1.014, 1.152; 0.913)
PLANTED_LEAF = {"dense": ("attn", "wo"), "vlm": ("attn", "wo"),
                "ssm": ("time_mix", "wo"), "hybrid": ("mamba", "out_proj"),
                "encdec": ("self_attn", "wo")}
# the [tp] phase: tensor and expert parallel over a simulated (data, model)
# mesh (every piece on the one card), default rules, each cell against one
# device in the same call; widths published, "layers" cuts the depth
TP_TRAIN = (
    dict(arch="granite-3-2b", layers=None, batch=8, seq=512, steps=4,
         data=1, model=2),
    dict(arch="qwen3-moe-235b-a22b", layers=1, batch=4, seq=128, steps=4,
         data=1, model=2),
    # the ssm, hybrid, encdec and vlm families, depth cut for time (zamba2's
    # shared block runs once, after layer 6; whisper 4 + 4 layers), each
    # held against 2 steps on one device in this phase
    dict(arch="rwkv6-3b", layers=4, batch=4, seq=256, steps=3, data=1,
         model=2, planted=True),
    dict(arch="zamba2-1.2b", layers=7, batch=8, seq=512, steps=3, data=1,
         model=2, planted="read"),
    dict(arch="whisper-small", layers=4, batch=8, seq=512, steps=3, data=1,
         model=2, planted=True),
    dict(arch="paligemma-3b", layers=4, batch=8, seq=512, steps=3, data=1,
         model=2, planted=True),
)
# float32, every weight and moment after step 1 against one device on the
# same rows as 2 microbatches
TP_STATES = (
    dict(arch="granite-3-2b", layers=4, batch=8, seq=512, steps=1, data=2,
         model=2),
    dict(arch="rwkv6-3b", layers=2, batch=4, seq=256, steps=1, data=2,
         model=2),
    dict(arch="zamba2-1.2b", layers=7, batch=8, seq=512, steps=1, data=2,
         model=2),
)
# 8-bit AdamW moments over model pieces (q and s of the flat stacked leaf,
# their blocks over data alone, so every model replica of a data index
# updates the same run): float32 granite on (2, 2), each step's weights and
# q / s bitwise one device's 8-bit update on the same gradients
# (unclipped); bf16 qwen3-moe at 1 layer on (1, 2), its expert pieces' and
# vocab pieces' row gathers held bitwise
TP_Q8_STATE = dict(arch="granite-3-2b", layers=4, batch=8, seq=512,
                   steps=2, data=2, model=2)
TP_Q8_TRAIN = dict(arch="qwen3-moe-235b-a22b", layers=1, batch=4, seq=128,
                   steps=4, data=1, model=2)
# at random init the bf16 logits of zamba2-1.2b and whisper-small lie ~120
# and ~160 from the same weights' float32 logits at a scale of ~415 and
# ~250 (one device and the pieces alike, H100), so bf16 rounding, not the
# model, picks their greedy tokens: one device's equal the float32 tokens
# on 0.125 and 0.0625 of them.  No token check is possible there: their
# bf16 tokens are printed, not held, and their float32 cells hold the
# tokens equal
BF16_TOKENS_UNHELD = ("zamba2-1.2b", "whisper-small")
PLANTED_SERVE = {"rwkv6-3b": True, "zamba2-1.2b": "read",
                 "whisper-small": "read", "paligemma-3b": "read"}
# the four families served whole in bf16 (whisper's 1,500 frames,
# paligemma's 256 patches) and at 2 layers (whisper 2 + 2) in float32
FAMILY_ARCHS = ("rwkv6-3b", "zamba2-1.2b", "whisper-small", "paligemma-3b")
TP_SERVE = (
    dict(arch="gemma-7b", layers=None, batch=4, prompt=128, steps=8,
         model=2, float32=False, planted=True),
    dict(arch="gemma-7b", layers=2, batch=4, prompt=128, steps=8,
         model=2, float32=True),
    *(dict(arch=arch, layers=None, batch=4, prompt=128, steps=4, model=2,
           float32=False, planted=PLANTED_SERVE[arch],
           tokens=arch not in BF16_TOKENS_UNHELD)
      for arch in FAMILY_ARCHS),
    *(dict(arch=arch, layers=2, batch=4, prompt=128, steps=4, model=2,
           float32=True)
      for arch in FAMILY_ARCHS),
)
# bf16 logits over model pieces round each piece's partial sum apart from
# one device's whole product: held as no farther from the same weights'
# float32 logits than TP_ROUNDING times one device's bf16 logits are.  On
# the H100 gemma-7b's pieces read 0.985 / 1.083 of one device's distance
# (prefill / first decode step); with piece 1's share of one layer's
# attention output dropped they read 5.79 / 2.39 / 1.30 (layers 0 / 14 /
# 27, prefill).  The last layer's fault is planted in every run
# (tp_planted) and must break the bound.
TP_ROUNDING = 1.25
# bf16 greedy tokens over the pieces equal to one device's: one row of the
# four may part at a near tie, and then keeps parting
TP_TOKENS_MIN = 0.75
# tests/test_torch_train.py's rule for a data-parallel step against one
# device's: atol times the value's scale (at least 1)
DENSE_RULE = dict(rtol=1e-4, atol=1e-5)
# a bf16 data-parallel gradient is each replica's bf16 gradient summed in
# float32, one device's the whole batch's rounded to bf16 once: an element
# may part by 2^-9 of its replicas' parts, so a bf16 gradient norm is held
# at 2^-8 of it.  [tp]'s family cells (no [train] cell of their depth)
# also take step 1 in float32: where one device's own bf16 value lies past
# this bound from float32's (H100: rwkv6's grad norm 0.73 %, zamba2's 12.9
# %, whisper's 1.27 % and its loss 0.53 %), the pieces' is held no farther
# from float32's than TP_ROUNDING times one device's (they read 0.06,
# 0.92, 0.47 and 0.19 of it)
BF16_NORM_RULE = dict(rtol=2.0 ** -8, atol=0.0)
# kernel-path vs plain-path gradients of one bf16 loss + backward: the
# gathers are bitwise, but the token-id gather's backward (an index
# accumulate) may sum in another order on the card, and bf16 keeps 8 bits
TRAIN_GRAD_TOL = dict(rtol=2e-2, atol=2e-3)    # atol times the leaf's scale
# the [shard] phase: simulated meshes (every shard on the one card) over the
# pwtk analogue and the soc-Pokec analogue; shard counts per run
SHARD = dict(spmv=(2, 4), spmm=4, tune=2, graph=4)
# the "mul_all" dense slice at D = 16 on pwtk before the kernels gained the
# "add_all" combine (PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W)
PARENT_DENSE_D16_MS = 0.6030
SOURCES = {
    "unroll_spmv.window":
        "src/repro_torch/kernels/unroll_spmv/csrc/stage_a.cu",
    "unroll_spmv.dense_slice":
        "src/repro_torch/kernels/unroll_spmv/csrc/stage_a.cu",
    "segment_reduce":
        "src/repro_torch/kernels/segment_reduce/csrc/segment_reduce.cu",
    "gather_vload":
        "src/repro_torch/kernels/gather_vload/csrc/gather_vload.cu",
    "row_gather": "src/repro_torch/kernels/moe_dispatch/csrc/row_gather.cu",
}
REPLACES = {
    "unroll_spmv.window":
        "src/repro/kernels/unroll_spmv/kernel.py:135 (class_stage_a; "
        "gpu_stage_a :357)",
    "unroll_spmv.dense_slice":
        "src/repro/kernels/unroll_spmv/kernel.py:255 (coalesced_stage_a)",
    "segment_reduce":
        "src/repro/kernels/segment_reduce/kernel.py:52 (segment_reduce)",
    "gather_vload": "src/repro/kernels/gather_vload/kernel.py:37 "
                    "(gather_vload)",
    "row_gather": "src/repro/kernels/moe_dispatch/kernel.py:27 (row_gather)",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def cell_seconds(phase: str, what: str):
    """Log the host seconds of one cell of a phase (``[cell]`` lines split
    a ``[phase]`` line's time)."""
    t0 = time.perf_counter()
    yield
    log(f"[cell] {phase} {what} {time.perf_counter() - t0:.1f} s")


def host_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """End-to-end time of one call as a caller sees it: median over
    ``reps`` of the host clock around ``fn`` and a synchronize."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, reps: int = 20, repeats: int = 5,
              sleep_cycles: int = 200_000_000) -> float:
    """Device time of one call, the median of ``repeats`` measurements:
    each puts CUDA events around ``reps`` back-to-back calls, enqueued
    behind a spin kernel so the host's launch overhead never leaves the
    card idle between them.  The launch queue holds about a thousand
    kernels and blocks the host when full, so a call of many small kernels
    is measured again with fewer repeats until the whole batch fits behind
    the spin."""
    import torch
    fn()
    torch.cuda.synchronize()
    samples = []
    while len(samples) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()
        end.synchronize()
        if not covered and reps > 1:
            reps = max(1, reps // 4)
            continue
        if not covered:
            log("[time] note: the host could not keep ahead of the card; "
                "this device time includes launch gaps")
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def profile_breakdown(fn, reps: int = 5, warm: bool = False):
    """Device time per call under ``torch.profiler``: (wall ms, device-busy
    ms, top kernels as (name, ms, launches), kernel launches) per call, or
    None when the profiler records no device activity; one call first,
    unprofiled, unless ``warm`` (the caller ran the same work just
    before).  Wall time includes the
    profiler's own overhead, so the idle share it implies is an upper
    bound.  The device events are summed from the profiler's raw event
    list: ``key_averages()`` builds the whole event tree first, which for
    a train step of tens of thousands of launches takes longer than the
    steps it profiles."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ns, count = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), count + 1)
    busy_ms = sum(ns for ns, _ in by_name.values()) / 1e6 / reps
    if busy_ms <= 0:
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return wall_ms, busy_ms, [(name[:70], ns / 1e6 / reps, count // reps)
                              for name, (ns, count) in top], \
        sum(count for _, count in by_name.values()) // reps


def log_profile(tag: str, what: str, fn, reps: int = 5,
                warm: bool = False) -> None:
    prof = profile_breakdown(fn, reps, warm)
    if prof is None:
        log(f"[profile] {tag} {what}: no device time recorded (not "
            "measured)")
        return
    wall_ms, busy_ms, top, launches = prof
    log(f"[profile] {tag} {what}: device busy {busy_ms:.4f} ms of "
        f"{wall_ms:.4f} ms wall per call under the profiler (idle share <= "
        f"{1 - busy_ms / wall_ms:.3f}); {launches} kernel launches per call")
    for kname, kms, kcount in top:
        log(f"[profile]   {kms:.4f} ms in {kcount} launches: {kname}")


def make_matrix(G, spec):
    if spec["kind"] == "banded":
        return G.banded(spec["n"], band=spec["band"])
    return G.power_law(spec["n"], avg_deg=spec["avg_deg"])


def data_for(m, dtype, d: int | None = None, seed=SEED):
    """Values (nnz,) and a dense operand, (n,) or (n, d), from a seed."""
    rng = np.random.default_rng(seed)
    shape = (m.shape[1],) if d is None else (m.shape[1], d)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return (rng.integers(-5, 6, m.nnz).astype(dtype),
                rng.integers(-5, 6, shape).astype(dtype))
    return (rng.standard_normal(m.nnz).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


def add_at_oracle(m, vals, x) -> np.ndarray:
    """float64 ``np.add.at`` product, one column at a time."""
    v = vals.astype(np.float64)
    x2 = x.reshape(x.shape[0], -1).astype(np.float64)
    out = np.zeros((m.shape[0], x2.shape[1]), np.float64)
    for c in range(x2.shape[1]):
        np.add.at(out[:, c], m.rows, v * x2[m.cols, c])
    return out.reshape((m.shape[0],) + x.shape[1:])


def tol_ratio(got, want, tol):
    """(max abs err, the worst error over ``tol``'s bound ``atol + rtol *
    |want|``, all finite and within it)."""
    err = np.abs(got - want)
    ratio = float((err / (tol["atol"] + tol["rtol"] * np.abs(want))).max())
    return float(err.max()), ratio, bool(np.isfinite(got).all()
                                         and ratio <= 1.0)


def same_bits(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return torch.equal(a.view(view[a.element_size()]),
                       b.view(view[b.element_size()]))


def same_host_bits(a, b) -> bool:
    """``same_bits`` of two numpy arrays."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


def max_abs_diff(a, b) -> float:
    """0.0 exactly when the two agree bit for bit; else the max abs
    difference of the finite words, ``inf`` when only non-finite words
    differ."""
    if same_bits(a, b):
        return 0.0
    diff = (a.double() - b.double()).abs()
    diff = diff[~diff.isnan()]
    return float(diff.max()) if diff.numel() and diff.max() > 0 \
        else float("inf")


def ptxas_report(build_log: str) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, stack bytes, spill store + load bytes) per
    kernel of an ``nvcc -Xptxas -v`` log; the ladder kernels' mangled names
    are shortened to body, type, reduce, lanes per thread and index, the
    row copy's to word size and index policy."""
    out, name, stack, spill = [], "?", 0, 0
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            short = re.search(r"(rows|cols)_kernelI([fid])Li(\d)ELi(\d+)E"
                              r"\w*?((?:Dense|Window|Rows)Index)", name)
            copy = re.search(r"copy_rows_kernelI(h|t|j|5uint2|5uint4)"
                             r"\w*?(IdRows|WindowLanes)", name)
            if short:
                body, ty, red, lanes, index = short.groups()
                red = ("add", "mul", "max", "min")[int(red)]
                name = f"{body}_kernel<{ty}, {red}, L={lanes}, {index}>"
            elif copy:
                word, rows = copy.groups()
                word = {"h": "1 B", "t": "2 B", "j": "4 B", "5uint2": "8 B",
                        "5uint4": "16 B"}[word]
                name = f"copy_rows_kernel<{word} words, {rows}>"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2)) + int(m.group(3))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((name, int(m.group(1)), stack, spill))
            stack = spill = 0
    return out


def bound(nbytes: float, nops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def train_flops(cfg, n_enc: int, n_rest: int, batch: int,
                seq: int) -> tuple[int, str]:
    """``6 N tokens`` of one train step, counted per stack: each stack's
    parameters times the positions it sees (``n_enc``, the encoder's
    layers and norm, over the ``batch x enc_len`` frames; ``n_rest``, all
    the others, over the tokens, after the patch prefix for vlm) ->
    (FLOP, how it was counted)."""
    if cfg.family == "encdec":
        return 6 * (n_enc * batch * cfg.enc_len + n_rest * batch * seq), (
            f"6 x ({n_enc} encoder x {batch} x {cfg.enc_len} frames + "
            f"{n_rest} decoder and embedding x {batch} x {seq} tokens)")
    from repro_torch.models.lm import prefix_slots
    pos = prefix_slots(cfg) + seq
    return 6 * n_rest * batch * pos, f"6 x {n_rest} x {batch} x {pos} " + (
        f"positions ({pos - seq} patches + {seq} tokens)"
        if pos > seq else "tokens")


def sharded_leaves(tree):
    """The leaves of a tree of dicts and lists (``Sharded`` pieces in the
    data-parallel state)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from sharded_leaves(v)
    else:
        yield tree


def launch_bytes_ops(cm, d: int = 1) -> tuple[int, int]:
    """Least bytes a stage-A launch must move and the operations it must
    do, from this launch's metadata, for a gathered operand of ``d``
    columns: each distinct input word read once, each output word written
    once (see the kernel source's header).  Of ``x`` that is the distinct
    rows the launch's lanes read, however many lanes share one; of the
    window ids, those some lane of the block selects."""
    import torch
    from repro_torch.core import ir
    la = cm.launch
    bc, n = cm.seg.shape
    lanes = bc * n
    lane = torch.arange(n, device=cm.seg.device)
    if la.gather == ir.COALESCED:
        local = cm.local is not None
        idx = cm.starts.long()[:, None] + (cm.local.long() if local else lane)
        per_lane = 3 if local else 2             # (local_off,) seg, value
        head = bc * 4                            # starts
    elif la.stream:
        idx = cm.win[:, :1].long() * n + lane
        per_lane = 2                             # seg, value
        head = bc * 4                            # window 0's id
    else:
        slot = cm.slot.long()
        idx = torch.gather(cm.win.long(), 1, slot) * n + cm.off.long()
        per_lane = 4                             # slot, off, seg, value
        used = torch.zeros(cm.win.shape, dtype=torch.bool,
                           device=cm.win.device).scatter_(1, slot, True)
        head = int(used.sum()) * 4               # the window ids selected
    if cm.full is not None:
        head += bc * 4
    x_rows = int(torch.unique(idx).numel())
    steps = max(la.op_flag, 0)
    if la.op_flag < 0 or cm.full is not None:
        steps = max(steps, int(np.ceil(np.log2(max(n, 2)))))
    ops = lanes * d * (1 + steps)             # combine + ladder steps
    return (head + lanes * per_lane * 4 + lanes * d * 4 + x_rows * d * 4,
            ops)


def run_launch_both(K, ir, cm, xd, elem, reduce):
    """One launch through its kernel and its plain version on the card;
    returns the kernel's name and both outputs."""
    la = cm.launch
    s = slice(la.start, la.stop)
    kw = dict(op=la.op_flag, reduce=reduce, full_flags=cm.full)
    if la.gather == ir.COALESCED:
        key = "unroll_spmv.dense_slice"
        args = (cm.starts, [xd], [elem[s]], cm.local, cm.seg)
        return key, K.dense_slice_stage_a(*args, **kw), \
            K.dense_slice_stage_a_plain(*args, **kw)
    key = "unroll_spmv.window"
    args = (cm.win, [xd], [elem[s]], cm.slot, cm.off, cm.seg)
    kw["stream"] = la.stream
    return key, K.window_stage_a(*args, **kw), \
        K.window_stage_a_plain(*args, **kw)


class Smoke:
    """The phases, in order; ``run`` drives them all."""

    def __init__(self, dev, card: str, kind: str):
        import torch
        from repro_torch.core import engine as eng
        from repro_torch.core import graphs, ir
        from repro_torch.core.apps import PageRank, SpMV
        from repro_torch.core.plan import CostModel, build_plan
        from repro_torch.core.seed import spmv_seed
        from repro_torch.core.spmm import SpMM
        from repro_torch.kernels import build
        from repro_torch.kernels.gather_vload import kernel as GV
        from repro_torch.kernels.gather_vload import ops as gv_ops
        from repro_torch.kernels.moe_dispatch import kernel as RG
        from repro_torch.kernels.moe_dispatch import ops as rg_ops
        from repro_torch.kernels.segment_reduce import kernel as SR
        from repro_torch.kernels.segment_reduce import ops as sr_ops
        from repro_torch.kernels.unroll_spmv import kernel as K
        from repro_torch.kernels.unroll_spmv import ops
        from repro_torch.sparse import generators as G
        self.torch, self.eng, self.ir, self.ops, self.G = torch, eng, ir, ops, G
        self.SpMV, self.SpMM = SpMV, SpMM
        self.graphs, self.PageRank = graphs, PageRank
        self.CostModel, self.build_plan, self.spmv_seed = \
            CostModel, build_plan, spmv_seed
        self.build, self.K, self.SR, self.GV, self.RG = build, K, SR, GV, RG
        self.sr_op = sr_ops.segment_reduce_op
        self.gv_op = gv_ops.gather_vload_op
        self.rg_op = rg_ops.row_gather_op
        self.dev, self.card, self.kind = dev, card, kind
        self.tag = f"[{card}]"
        # each kernel's launch counter, by the name the kernels line uses
        self.wrappers = {
            "unroll_spmv.window": K.window_stage_a,
            "unroll_spmv.dense_slice": K.dense_slice_stage_a,
            "segment_reduce": SR.segment_reduce,
            "gather_vload": GV.gather_vload,
            "row_gather": RG.row_gather}
        self.main_counts = {k: 0 for k in self.wrappers}
        self.max_err = {k: 0.0 for k in self.wrappers}
        self.compared = {k: 0 for k in self.wrappers}
        self.line = {}
        self.mats, self.plans = {}, {}
        self.card_procs = []        # (share, start time, Popen)
        self.tests_ran = False      # a share ran during the current phase
        # what [dryrun] holds its reckoning against, by 8-bit moments or not:
        # the [dp] granite cell's bytes a device holds and one step's counted
        # collectives; the [train] granite step's flops and peak
        self.dp_held, self.dp_counted, self.dp_peaks = {}, {}, {}
        self.train_measured = None
        # and the [tp] cells': name -> cfg, spec, mesh, opt override, one
        # step's counted collectives, the bytes a device holds, and one
        # step's flops under FlopCounterMode on the card
        self.tp_measured = {}
        # the [train] cells' metrics and step ms, which [tp] compares with
        self.train_readings = {}

    # ------------------------------------------------------------ helpers
    def zero_counts(self) -> None:
        for fn in self.wrappers.values():
            fn.launches = 0

    def read_counts(self, main_path: bool = True) -> dict:
        """The counts since ``zero_counts``; a main-path run's go into the
        kernels line.  A tuned build's do not: its measurement calls each
        candidate as often as its timing needs."""
        self.torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in self.wrappers.items()}
        if main_path:
            for k, c in counts.items():
                self.main_counts[k] += c
        return counts

    def held(self, key: str, got, want, what: str) -> None:
        """Record one kernel-vs-plain comparison; fail unless bitwise."""
        self.torch.cuda.synchronize()
        err = max_abs_diff(got, want)
        self.max_err[key] = max(self.max_err[key], err)
        self.compared[key] += 1
        check(err == 0.0, f"{key} differs from its plain version ({what}; "
              f"max abs err {err})")

    def kernel_entry(self, key, ms, plain_ms, nbytes, nops, library_ms):
        bound_ms, by = bound(nbytes, nops)
        self.line[key] = {
            "name": key, "route": "cuda", "source": SOURCES[key],
            "replaces": REPLACES[key], "launches": self.main_counts[key],
            "max_abs_err": self.max_err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms}

    # ------------------------------------------------------------- phases
    def card_tests_early(self) -> None:
        self.start_card_tests(0)

    def build_kernels(self) -> None:
        libs = {"unroll_spmv": self.K.library,
                "segment_reduce": self.SR.library,
                "gather_vload": self.GV.library,
                "row_gather": self.RG.library}
        t0 = time.perf_counter()
        self.build.build_all(libs.values())
        log(f"[build] {len(libs)} kernel libraries ready in "
            f"{time.perf_counter() - t0:.2f} s (one nvcc each, in parallel)")
        for name, lib in libs.items():
            kernels = ptxas_report(lib.build_log)
            regs = [k[1] for k in kernels] or [0]
            log(f"[build] {name}: nvcc {lib.build_seconds:.2f} s, "
                f"{len(kernels)} kernels, {min(regs)}-{max(regs)} registers, "
                f"{sum(k[3] > 0 for k in kernels)} with spills")
            for kname, nregs, stack, spill in kernels:
                log(f"[build]   {kname}: {nregs} registers, {stack} B stack, "
                    f"{spill} B spilled")

    def make_plans(self) -> None:
        for name, spec in MATRICES.items():
            t0 = time.perf_counter()
            m = self.mats[name] = make_matrix(self.G, spec)
            t1 = time.perf_counter()
            p = self.plans[name] = self.build_plan(
                self.spmv_seed(), {"row": m.rows, "col": m.cols},
                m.shape[0], m.shape[1], self.CostModel(lane_width=128))
            fb = sum(c.num_blocks for c in p.classes if c.ls_flag == 0)
            log(f"[matrix] {name}: {m.shape[0]} rows, {m.nnz} nnz, "
                f"{p.num_blocks} blocks ({fb} gather-fallback, "
                f"{fb / p.num_blocks:.4f}), {p.stats.num_classes} classes; "
                f"generate {t1 - t0:.2f} s, build_plan "
                f"{time.perf_counter() - t1:.2f} s{self.beside_tests()}")
            for fused in (True, False):
                t = self.ir.lower(p, backend="cuda", fused=fused,
                                  coalesce=True)
                log(f"[matrix] {name}: cuda fused={fused} coalesce=True -> "
                    f"{len(t.launches)} launches, coalesced fraction "
                    f"{self.ir.coalesced_fraction(t):.4f}; torch form "
                    f"{self.ir.coalesce_stats(p, fused=fused)}")

    def kernel_launches(self, plan, fused, coalesce):
        tree = self.ir.lower(plan, backend="cuda", fused=fused,
                             coalesce=coalesce)
        return [cm for cm in self.ops.stage_launch_meta(plan, tree.launches,
                                                        self.dev)
                if cm.launch.gather != self.ir.FALLBACK]

    def stage_a_phase(self) -> None:
        """Every kernel launch of both matrices against its plain version,
        at D = 1, D = SPMM_D and the SpMV endpoint's max_batch."""
        torch = self.torch
        for name, plan in self.plans.items():
            lowerings = {(f, c): self.kernel_launches(plan, f, c)
                         for f in (True, False) for c in (False, True)}
            for d in (1, SPMM_D, SERVE["spmv"]["max_batch"]):
                for reduce, dtype in SEMIRINGS:
                    vals, x = data_for(self.mats[name], dtype,
                                       None if d == 1 else d)
                    xd = torch.as_tensor(x, device=self.dev)
                    elem = self.eng.reorder_elementwise(
                        plan, vals, reduce=reduce, device=self.dev)
                    for (fused, coalesce), metas in lowerings.items():
                        for cm in metas:
                            key, got, want = run_launch_both(
                                self.K, self.ir, cm, xd, elem, reduce)
                            self.held(key, got, want, f"{name} D={d} fused="
                                      f"{fused} coalesce={coalesce} {reduce}/"
                                      f"{np.dtype(dtype).name} launch "
                                      f"[{cm.launch.start}, {cm.launch.stop})"
                                      f" op={cm.launch.op_flag}")
                        log(f"[kernels] {name} D={d} fused={fused} "
                            f"coalesce={coalesce} {reduce}/"
                            f"{np.dtype(dtype).name}: {len(metas)} kernel "
                            "launches bitwise equal to the plain versions")

    def check_named(self, app, counts, what) -> None:
        """Each stage-A kernel the lowering names was launched."""
        ir = self.ir
        named = {"unroll_spmv.dense_slice" if la.gather == ir.COALESCED
                 else "unroll_spmv.window"
                 for la in app._run.tree.launches if la.gather != ir.FALLBACK}
        for k in named:
            check(counts[k] > 0, f"{k} named by the lowering of {what} but "
                  "never launched")

    def product_run(self, name, coalesce, d):
        """One main-path run: ``matvec`` (d None) or ``matmat`` (d columns),
        held to the float64 oracle and bitwise to the torch backend."""
        torch = self.torch
        m = self.mats[name]
        vals, x = data_for(m, np.float32, d)
        xd = torch.as_tensor(x, device=self.dev)
        oracle = add_at_oracle(m, vals, x)
        t0 = time.perf_counter()
        if d is None:
            app = self.SpMV.from_coo(m.rows, m.cols, vals, m.shape,
                                     backend="cuda", fused=True,
                                     coalesce=coalesce, device=self.dev)
            call = app.matvec
        else:
            app = self.SpMM.from_coo(m.rows, m.cols, vals, m.shape,
                                     backend="cuda", fused=True,
                                     coalesce=coalesce, device=self.dev)
            call = app.matmat
        build_s = time.perf_counter() - t0
        what = f"{name} coalesce={coalesce} " + \
            ("matvec" if d is None else f"matmat D={d}")
        self.zero_counts()
        y = call(xd)
        counts = self.read_counts()
        self.check_named(app, counts, what)
        check(tuple(y.shape) == oracle.shape and y.dtype == torch.float32,
              f"{what}: bad output {tuple(y.shape)} {y.dtype}")
        yh = y.cpu().numpy()
        check(bool(np.isfinite(yh).all()), f"{what}: non-finite output")
        rel = float(np.abs(yh - oracle).max() / np.abs(oracle).max())
        check(rel <= REL_ERR_LIMIT, f"{what}: rel err {rel:.3e} vs the "
              "float64 oracle")
        torch_run = self.eng.make_executor(
            app.plan, {"value": vals}, backend="torch", fused=True,
            coalesce=coalesce, device=self.dev)
        y_torch = torch_run({"x": xd}, torch.zeros_like(y))
        check(same_bits(y, y_torch), f"{what}: cuda backend differs from "
              "the torch backend")
        log(f"[main] {what} fused=True: {len(app._run.tree.launches)} "
            f"launches, kernel launches "
            f"{ {k: c for k, c in counts.items() if c} }, max rel err vs "
            f"float64 oracle {rel:.3e}, bitwise equal to the torch backend; "
            f"from_coo {build_s:.2f} s{self.beside_tests()}")
        return dict(matrix=name, coalesce=coalesce, d=d, app=app, call=call,
                    x=xd, vals=vals, counts=counts, rel_err=rel,
                    torch_run=torch_run, build_s=build_s)

    def main_paths(self) -> None:
        self.runs = [self.product_run(name, coalesce, d)
                     for d in (None, SPMM_D) for name in self.mats
                     for coalesce in (False, True)]
        for r in self.runs:
            if r["matrix"] == "webbase-1M" and not r["coalesce"]:
                check(r["counts"]["unroll_spmv.window"] > 0,
                      "window kernel not launched on webbase-1M "
                      "coalesce=False")
            if r["matrix"] == "pwtk" and r["coalesce"]:
                check(r["counts"]["unroll_spmv.dense_slice"] > 0,
                      "dense-slice kernel not launched on pwtk coalesce=True")

    def matvec_many_phase(self) -> None:
        torch = self.torch
        run = self.run_of("pwtk", True, None)
        app = run["app"]
        xs = torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
            (MANY_S, app.shape[1])).astype(np.float32), device=self.dev)
        self.zero_counts()
        ys = app.matvec_many(xs)
        counts = self.read_counts()
        self.check_named(app, counts, "pwtk matvec_many")
        check(tuple(ys.shape) == (MANY_S, app.shape[0]),
              f"matvec_many: bad output {tuple(ys.shape)}")
        for i in range(MANY_S):
            check(same_bits(ys[i], app.matvec(xs[i])),
                  f"matvec_many row {i} differs from matvec(xs[{i}])")
        many_ms = host_ms(lambda: app.matvec_many(xs))
        many_dev = device_ms(lambda: app.matvec_many(xs))
        loop_ms = host_ms(lambda: [app.matvec(xs[i]) for i in range(MANY_S)])
        log(f"[main] pwtk coalesce=True matvec_many S={MANY_S}: kernel "
            f"launches {counts['unroll_spmv.dense_slice']} dense-slice, "
            f"rows bitwise equal to {MANY_S} matvec calls")
        log(f"[time] {self.tag} pwtk coalesce=True matvec_many S={MANY_S}: "
            f"{many_ms:.4f} ms end to end, {many_dev:.4f} ms of device time; "
            f"{MANY_S} separate matvec calls {loop_ms:.4f} ms end to end")

    def run_of(self, name, coalesce, d):
        return next(r for r in self.runs if r["matrix"] == name
                    and r["coalesce"] == coalesce and r["d"] == d)

    def main_timings(self) -> None:
        torch = self.torch
        for r in self.runs:
            app, xd, call = r["app"], r["x"], r["call"]
            what = f"{r['matrix']} coalesce={r['coalesce']} " + \
                ("matvec" if r["d"] is None else f"matmat D={r['d']}")
            y0 = torch.zeros((app.shape[0],) + tuple(xd.shape[1:]),
                             device=self.dev)
            stage_a = app._run.sweep_body.stage_a
            r["ms"] = host_ms(lambda: call(xd))
            r["dev_ms"] = device_ms(lambda: call(xd))
            r["stage_a_dev_ms"] = device_ms(lambda: stage_a({"x": xd}))
            r["torch_ms"] = host_ms(lambda: r["torch_run"]({"x": xd}, y0))
            log(f"[time] {self.tag} {what}: cuda {r['ms']:.4f} ms end to "
                f"end, {r['dev_ms']:.4f} ms of device time (stage A "
                f"{r['stage_a_dev_ms']:.4f} ms); torch backend "
                f"{r['torch_ms']:.4f} ms end to end")
            log_profile(self.tag, what, lambda: call(xd))
        for name, m in self.mats.items():
            indptr = np.r_[0, np.cumsum(np.bincount(m.rows,
                                                    minlength=m.shape[0]))]
            for d in (None, SPMM_D):
                vals, x = data_for(m, np.float32, d)
                a_csr = torch.sparse_csr_tensor(
                    torch.as_tensor(indptr, device=self.dev),
                    torch.as_tensor(m.cols, device=self.dev),
                    torch.as_tensor(vals, device=self.dev), size=m.shape)
                xd = torch.as_tensor(x, device=self.dev)
                y_lib = (a_csr @ xd).cpu().numpy()
                y_ref = self.run_of(name, False, d)["call"](xd).cpu().numpy()
                check(np.allclose(y_lib, y_ref, rtol=1e-4, atol=1e-4),
                      f"cuSPARSE disagrees with the port on {name} D={d}")
                lib_dev = device_ms(lambda: a_csr @ xd)
                lib_host = host_ms(lambda: a_csr @ xd)
                what = "SpMV" if d is None else f"SpMM D={d}"
                log(f"[time] {self.tag} {name}: cuSPARSE {what} "
                    f"(torch.sparse_csr_tensor @ x, the yardstick) "
                    f"{lib_dev:.4f} ms of device time, {lib_host:.4f} ms end "
                    "to end")

    def stage_a_kernel_times(self, key, name, coalesce, d):
        """The kernel's launches of one main-path call, timed as a sequence,
        beside the plain versions and the bound."""
        torch, K, ir = self.torch, self.K, self.ir
        run = self.run_of(name, coalesce, d)
        app, xd = run["app"], run["x"]
        plan = app.plan
        elem = self.eng.reorder_elementwise(plan, run["vals"],
                                            device=self.dev)
        metas = [cm for cm in app._run.sweep_body.stage_a.launch_meta
                 if cm.launch.gather != ir.FALLBACK
                 and (cm.launch.gather == ir.COALESCED)
                 == (key == "unroll_spmv.dense_slice")]
        lanes = torch.empty((plan.num_blocks, plan.lane_width)
                            + tuple(xd.shape[1:]), device=self.dev)

        def run_all(plain=False):
            for cm in metas:
                s = slice(cm.launch.start, cm.launch.stop)
                if not plain:
                    self.ops.run_launch(plan, cm, [xd], [elem[s]],
                                        out=lanes[s])
                elif cm.launch.gather == ir.COALESCED:
                    lanes[s] = K.dense_slice_stage_a_plain(
                        cm.starts, [xd], [elem[s]], cm.local, cm.seg,
                        op=cm.launch.op_flag, reduce="add",
                        full_flags=cm.full)
                else:
                    lanes[s] = K.window_stage_a_plain(
                        cm.win, [xd], [elem[s]], cm.slot, cm.off, cm.seg,
                        op=cm.launch.op_flag, stream=cm.launch.stream,
                        reduce="add", full_flags=cm.full)

        ms = device_ms(run_all)
        plain_ms = device_ms(lambda: run_all(plain=True), reps=3)
        nbytes = nops = 0
        for cm in metas:
            b, o = launch_bytes_ops(cm, 1 if d is None else d)
            nbytes += b
            nops += o
        return dict(ms=ms, plain_ms=plain_ms, nbytes=nbytes, nops=nops,
                    launches=len(metas), main=run["counts"][key])

    def stage_a_timings(self) -> None:
        representative = {"unroll_spmv.window": ("webbase-1M", False),
                          "unroll_spmv.dense_slice": ("pwtk", True)}
        for key, (name, coalesce) in representative.items():
            for d in (None, SPMM_D):
                t = self.stage_a_kernel_times(key, name, coalesce, d)
                bound_ms, by = bound(t["nbytes"], t["nops"])
                what = "matvec" if d is None else f"matmat D={d}"
                log(f"[time] {self.tag} {key} on {name} coalesce={coalesce} "
                    f"{what}: {t['launches']} launches/call (main-path "
                    f"counter {t['main']}), {t['ms']:.4f} ms vs bound "
                    f"{bound_ms:.4f} ms ({t['nbytes']} B at "
                    f"{HBM_BYTES_PER_S:.3g} B/s; {t['nops']} ops), "
                    f"{bound_ms / t['ms']:.3f} of the bound; plain version "
                    f"{t['plain_ms']:.4f} ms; no single PyTorch call "
                    "computes it")
                if key == "unroll_spmv.dense_slice" and d == SPMM_D:
                    log(f"[time] {self.tag} {key} \"mul_all\" D={d}: "
                        f"{t['ms']:.4f} ms with the \"add_all\" form in the "
                        f"kernel, {PARENT_DENSE_D16_MS:.4f} ms before it "
                        "(PERF.md, an earlier call)")
                if d is None:           # the kernels line keeps matvec's
                    self.kernel_entry(key, t["ms"], t["plain_ms"],
                                      t["nbytes"], t["nops"], None)

    def segment_reduce_phase(self) -> None:
        torch, SR = self.torch, self.SR
        m, plan = self.mats["pwtk"], self.plans["pwtk"]
        seg = torch.as_tensor(plan.seg_ids, device=self.dev)
        gidx = torch.as_tensor(plan.gather_idx, device=self.dev).long()
        b, n = seg.shape
        main = None
        for reduce, dtype in SEGMENT_CASES:
            for d in (1, SPMM_D):
                vals, x = data_for(m, dtype, None if d == 1 else d)
                elem = self.eng.reorder_elementwise(plan, vals, reduce=reduce,
                                                    device=self.dev)
                xg = torch.as_tensor(x, device=self.dev)[gidx]
                term = elem * xg if d == 1 else elem[..., None] * xg
                for op in (7, -1):
                    got = SR.segment_reduce(term, seg, op, reduce)
                    want = SR.segment_reduce_plain(term, seg, op, reduce)
                    self.held("segment_reduce", got, want,
                              f"pwtk blocks D={d} op={op} {reduce}/"
                              f"{np.dtype(dtype).name}")
                log(f"[kernels] segment_reduce pwtk blocks ({b} x {n}) D={d} "
                    f"{reduce}/{np.dtype(dtype).name}: op_flag 7 and "
                    "FULL_REDUCE bitwise equal to the plain version")
                if (reduce, dtype) == ("add", np.float32):
                    timing = self.segment_reduce_time(term, seg)
                    if d == SPMM_D:
                        main = term
                del term, xg, elem
        self.zero_counts()
        out = self.sr_op(main, seg, 7, "add")
        counts = self.read_counts()
        check(counts["segment_reduce"] == 1 and out.shape == main.shape,
              f"segment_reduce_op launched {counts['segment_reduce']} "
              "kernels, expected 1")
        self.kernel_entry("segment_reduce", *timing, None)   # D = 16's

    def segment_reduce_time(self, term, seg):
        SR = self.SR
        ms = device_ms(lambda: SR.segment_reduce(term, seg, 7, "add"))
        plain_ms = device_ms(
            lambda: SR.segment_reduce_plain(term, seg, 7, "add"), reps=3)
        es = term.element_size()
        nbytes = 2 * term.numel() * es + seg.numel() * 4
        nops = term.numel() * 7
        bound_ms, by = bound(nbytes, nops)
        log(f"[time] {self.tag} segment_reduce pwtk blocks "
            f"{tuple(term.shape)} float32 add op_flag 7: {ms:.4f} ms vs "
            f"bound {bound_ms:.4f} ms ({nbytes} B; {nops} ops), "
            f"{bound_ms / ms:.3f} of the bound; plain version "
            f"{plain_ms:.4f} ms; no single PyTorch call computes it")
        return ms, plain_ms, nbytes, nops

    def gather_cases(self):
        """(metadata, ls, stream) of the webbase plan's window blocks: its
        launches of ls 1, 2, 4 and 32 per class and fused (the fused section
        runs at the section-wide ls 32), and the ls-1 launches once more in
        stream mode (window 0 copied); and the fused section's metadata."""
        ir, plan = self.ir, self.plans["webbase-1M"]
        cases, section = [], None
        for fused in (False, True):
            for cm in self.kernel_launches(plan, fused, False):
                la = cm.launch
                if la.gather == ir.COALESCED or la.ls_flag not in GATHER_LS:
                    continue
                cases.append((cm, la.ls_flag, la.stream))
                if la.ls_flag == 1 and not la.stream:
                    cases.append((cm, 1, True))
                if fused and (section is None or cm.seg.shape[0]
                              > section.seg.shape[0]):
                    section = cm
        return cases, section

    def gather_vload_phase(self) -> None:
        torch, GV, ir = self.torch, self.GV, self.ir
        m, plan = self.mats["webbase-1M"], self.plans["webbase-1M"]
        n = plan.lane_width
        cases, cm = self.gather_cases()
        seen = {(ls, stream) for _, ls, stream in cases}
        for ls in GATHER_LS:
            check((ls, False) in seen, f"no webbase window launch of ls {ls}")
        check((1, True) in seen, "no stream gather_vload case")
        views = {}
        for dtype in (np.float32, np.int32):
            for d in (1, SPMM_D):
                _, x = data_for(m, dtype, None if d == 1 else d)
                xd = torch.as_tensor(x, device=self.dev)
                view = self.eng._pad_gathered(plan, xd).contiguous()
                views[dtype, d] = view
                for cm, ls, stream in cases:
                    got = GV.gather_vload(view, cm.win, cm.slot, cm.off,
                                          ls=ls, stream=stream)
                    want = GV.gather_vload_plain(view, cm.win, cm.slot,
                                                 cm.off, ls=ls, stream=stream)
                    self.held("gather_vload", got, want,
                              f"webbase blocks ls={ls} stream={stream} D={d} "
                              f"{np.dtype(dtype).name}")
                log(f"[kernels] gather_vload webbase window blocks D={d} "
                    f"{np.dtype(dtype).name}: {len(cases)} launches (ls "
                    f"{sorted({c[1] for c in cases})}, stream) bitwise equal "
                    "to the plain version")
        # the entry point on the fused section (ls 32), float32, D = 1
        check(cm is not None and cm.launch.ls_flag == max(GATHER_LS),
              "no fused webbase window section of ls 32")
        ls = max(GATHER_LS)
        views[torch.bfloat16, SPMM_D] = \
            views[np.float32, SPMM_D].to(torch.bfloat16)
        for dtype, d in ((np.float32, 1), (np.float32, SPMM_D),
                         (torch.bfloat16, SPMM_D)):
            view = views[dtype, d]
            if d == 1:
                self.zero_counts()
                out = self.gv_op(view, cm.win, cm.slot, cm.off, ls)
                counts = self.read_counts()
                check(counts["gather_vload"] == 1
                      and out.shape == cm.slot.shape,
                      f"gather_vload_op launched {counts['gather_vload']} "
                      "kernels, expected 1")
            else:
                self.held("gather_vload", GV.gather_vload(
                    view, cm.win, cm.slot, cm.off, ls=ls),
                    GV.gather_vload_plain(view, cm.win, cm.slot, cm.off,
                                          ls=ls),
                    f"webbase fused section D={d} {view.dtype}")
            rows = (torch.gather(cm.win.long(), 1, cm.slot.long()) * n
                    + cm.off.long())
            flat = view.reshape((-1,) + tuple(view.shape[2:]))
            if d == 1:
                lib = lambda: torch.take(flat, rows)      # noqa: E731
            else:
                elems = (rows[..., None] * d
                         + torch.arange(d, device=self.dev))
                lib = lambda: torch.take(flat, elems)     # noqa: E731
            check(same_bits(lib(), GV.gather_vload(view, cm.win, cm.slot,
                                                   cm.off, ls=ls)),
                  "torch.take disagrees with gather_vload")
            ms = device_ms(lambda: GV.gather_vload(view, cm.win, cm.slot,
                                                   cm.off, ls=ls))
            plain_ms = device_ms(lambda: GV.gather_vload_plain(
                view, cm.win, cm.slot, cm.off, ls=ls), reps=3)
            lib_ms = device_ms(lib)
            used = torch.zeros(cm.win.shape, dtype=torch.bool,
                               device=self.dev).scatter_(1, cm.slot.long(),
                                                         True)
            lanes, es = cm.slot.numel(), view.element_size()
            nbytes = (int(used.sum()) * 4 + lanes * 8
                      + int(torch.unique(rows).numel()) * d * es
                      + lanes * d * es)
            bound_ms, _ = bound(nbytes)
            log(f"[time] {self.tag} gather_vload webbase fused section "
                f"({cm.slot.shape[0]} blocks, ls {ls}) {view.dtype} D={d}: "
                f"{ms:.4f} ms vs bound {bound_ms:.4f} ms ({nbytes} B), "
                f"{bound_ms / ms:.3f} of the bound; plain version "
                f"{plain_ms:.4f} ms; torch.take on the flat view "
                f"(yardstick) {lib_ms:.4f} ms")
            if d == 1:
                self.kernel_entry("gather_vload", ms, plain_ms, nbytes, 0.0,
                                  lib_ms)

    def moe_row_ids(self) -> np.ndarray:
        """Token ids of one MoE layer's dispatch, sorted by expert as
        ``models/moe.py`` sorts them: top-k of random router logits."""
        rng = np.random.default_rng(SEED)
        t, e, k = MOE["tokens"], MOE["num_experts"], MOE["top_k"]
        logits = rng.standard_normal((t, e)).astype(np.float32)
        eidx = np.argsort(-logits, axis=1, kind="stable")[:, :k]
        order = np.argsort(eidx.reshape(-1), kind="stable")
        return ((np.arange(t * k) // k)[order]).astype(np.int32)

    def row_gather_phase(self) -> None:
        torch, RG = self.torch, self.RG
        t, dm, dtile = MOE["tokens"], MOE["d_model"], MOE["d_tile"]
        ids = torch.as_tensor(self.moe_row_ids(), device=self.dev)
        rng = np.random.default_rng(SEED + 2)
        x = torch.as_tensor(rng.standard_normal((t, dm)).astype(np.float32),
                            device=self.dev)
        srcs = {}
        for dtype in (torch.bfloat16, torch.float32):
            src = torch.cat([x.to(dtype), torch.zeros((1, dm), dtype=dtype,
                                                      device=self.dev)])
            srcs[dtype] = src
            got = RG.row_gather(src, ids, d_tile=dtile)
            self.held("row_gather", got, RG.row_gather_plain(src, ids),
                      f"qwen3-moe dispatch {dtype}")
            log(f"[kernels] row_gather qwen3-moe-235b-a22b dispatch "
                f"({ids.numel()} rows of {dm}, {dtype}): bitwise equal to the "
                "plain version")
        self.zero_counts()
        out = self.rg_op(srcs[torch.bfloat16], ids, dtile)
        counts = self.read_counts()
        check(counts["row_gather"] == 1 and out.shape == (ids.numel(), dm),
              f"row_gather_op launched {counts['row_gather']} kernels, "
              "expected 1")
        distinct = int(torch.unique(ids).numel())
        for dtype, src in srcs.items():
            ms = device_ms(lambda: RG.row_gather(src, ids, d_tile=dtile))
            plain_ms = device_ms(lambda: RG.row_gather_plain(src, ids))
            lib_ms = device_ms(lambda: torch.index_select(src, 0, ids))
            check(same_bits(torch.index_select(src, 0, ids),
                            RG.row_gather(src, ids, d_tile=dtile)),
                  "index_select disagrees with row_gather")
            es = src.element_size()
            nbytes = ids.numel() * 4 + (distinct + ids.numel()) * dm * es
            bound_ms, _ = bound(nbytes)
            out = torch.empty((ids.numel(), dm), dtype=dtype, device=self.dev)
            write_ms = device_ms(out.zero_)
            log(f"[time] {self.tag} row_gather qwen3-moe dispatch {dtype} "
                f"({ids.numel()} x {dm}, d_tile {dtile}): {ms:.4f} ms vs "
                f"bound {bound_ms:.4f} ms ({nbytes} B), {bound_ms / ms:.3f} "
                f"of the bound; plain version {plain_ms:.4f} ms; "
                f"index_select (yardstick) {lib_ms:.4f} ms; writing the "
                f"output alone (Tensor.zero_) {write_ms:.4f} ms")
            del out
            if dtype == torch.bfloat16:
                self.kernel_entry("row_gather", ms, plain_ms, nbytes, 0.0,
                                  lib_ms)

    # ---------------------------------------------------------- LM serving
    def lm_config(self, spec):
        """The spec's arch, its depth cut to ``spec["layers"]`` (an
        encoder-decoder's encoder too)."""
        from repro_torch.configs import get_config
        cfg = get_config(spec["arch"])
        if not spec["layers"]:
            return cfg
        if cfg.family == "encdec":
            cfg = cfg.replace(enc_layers=spec["layers"])
        return cfg.replace(num_layers=spec["layers"])

    def lm_phase(self) -> None:
        """LM serving at full width (see the module docstring, phase
        6)."""
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products
        t0 = time.perf_counter()
        with torch.inference_mode():
            for spec in LM_CELLS:
                cfg = self.lm_config(spec)
                with cell_seconds("[lm]", cfg.name):
                    self.lm_serve(cfg, spec)
                    self.lm_decode_check(cfg, spec.get("check", {}))
        log(f"[lm] phase in {time.perf_counter() - t0:.1f} s")

    @staticmethod
    def reference_params(cfg):
        """``REFERENCE_PARAMS``'s count of ``cfg`` where it has one: the
        published config whole ("name") or cut in depth ("name@layers"),
        in any dtype; None for any other change."""
        from repro_torch.configs import get_config
        pub = get_config(cfg.name)
        if cfg.replace(num_layers=pub.num_layers,
                       param_dtype=pub.param_dtype,
                       compute_dtype=pub.compute_dtype) != pub:
            return None
        return REFERENCE_PARAMS.get(
            cfg.name if cfg.num_layers == pub.num_layers
            else f"{cfg.name}@{cfg.num_layers}")

    def lm_model(self, cfg):
        torch = self.torch
        from repro_torch.models import lm
        gen = torch.Generator(self.dev).manual_seed(SEED)
        t0 = time.perf_counter()
        model = lm.init_model(cfg, generator=gen, device=self.dev)
        torch.cuda.synchronize()
        n = sum(p.numel() for p in model.parameters())
        nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
        want = self.reference_params(cfg)
        check(want in (None, n), f"{cfg.name}: {n} parameters, the "
              f"reference has {want}")
        log(f"[lm] {cfg.name} ({cfg.num_layers} layers, d {cfg.d_model}, "
            f"{str(cfg.param_dtype)[6:]}): {n} parameters"
            f"{' (the reference count)' if want else ''}, {nbytes} B, init "
            f"{time.perf_counter() - t0:.2f} s")
        return model, gen

    @staticmethod
    def lm_batch(cfg, tokens, gen) -> dict:
        """``tokens`` with the stubbed frontends' inputs drawn from
        ``gen``, as ``repro_torch.launch.serve`` draws them: paligemma's
        patch embeddings, whisper's frames."""
        from repro_torch.launch.serve import frontend_inputs
        return {"tokens": tokens,
                **frontend_inputs(cfg, tokens.shape[0], gen)}

    def lm_serve(self, cfg, spec) -> None:
        """Greedy generation through ``engine.generate``: the kernel
        launches of the run counted, every row gather held bitwise to its
        plain version, the run repeated on the plain row gather (tokens,
        final logits and cache bitwise), then timed."""
        torch, RG = self.torch, self.RG
        from repro_torch.models import lm
        from repro_torch.models import moe as MOE
        from repro_torch.serve import engine
        b, s, steps = spec["batch"], spec["prompt"], spec["steps"]
        base = torch.cuda.memory_allocated()    # held by earlier phases
        log(f"[lm] {cfg.name}: {base} B held by earlier phases, "
            f"{torch.cuda.mem_get_info()[0]} B free on the card")
        torch.cuda.reset_peak_memory_stats()
        model, gen = self.lm_model(cfg)
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                               device=self.dev, dtype=torch.int32)
        batch = self.lm_batch(cfg, tokens, gen)
        pl = lm.prefix_slots(cfg)
        max_len = pl + s + steps + 4
        is_moe = cfg.family == "moe"
        calls, gathers = [0], []    # the first dispatch and combine kept

        def checked(src, ids, d_tile=512):
            got = RG.row_gather(src, ids, d_tile)
            what = ("dispatch", "combine")[calls[0] % 2]
            calls[0] += 1
            self.held("row_gather", got, RG.row_gather_plain(src, ids),
                      f"{cfg.name} {what} {tuple(ids.shape)} of "
                      f"{tuple(src.shape)}")
            if len(gathers) < 2:
                gathers.append((what, src, ids))
            return got

        def run(gather):
            """One greedy run with ``gather`` as the layers' row gather;
            the final logits are those of one more step."""
            MOE.row_gather = gather
            try:
                t0 = time.perf_counter()
                self.zero_counts()
                out, cache = engine.generate(model, cfg, batch, steps,
                                             max_len)
                counts = self.read_counts()
                first_s = time.perf_counter() - t0
                logits, _ = lm.decode_step(model, cfg, cache, out[:, -1:],
                                           pl + s + steps - 1, pl)
            finally:
                MOE.row_gather = RG.row_gather
            return out, logits, cache, counts, first_s

        out, logits, cache, counts, first_s = run(checked)
        want = 2 * cfg.num_layers * steps if is_moe else 0
        check(counts["row_gather"] == want, f"{cfg.name}: row_gather "
              f"launched {counts['row_gather']} times, expected {want}")
        check(tuple(out.shape) == (b, steps) and out.dtype == torch.int32
              and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              f"{cfg.name}: bad tokens {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(logits).all()),
              f"{cfg.name}: non-finite logits")
        what = {"vlm": f" after {pl} patch tokens", "encdec": f", "
                f"{cfg.enc_len} encoder frames"}.get(cfg.family, "")
        log(f"[lm] {cfg.name} generate (batch {b}, prompt {s}{what}, {steps} "
            f"greedy steps): first call {first_s:.2f} s, kernel launches "
            f"{ {k: c for k, c in counts.items() if c} }, tokens[0][:12] "
            f"{out[0, :12].tolist()}")
        if is_moe:
            log(f"[lm] {cfg.name}: all {calls[0]} row gathers of the run "
                "(a dispatch and a combine per MoE layer and forward) "
                "bitwise equal to the plain version")
            p_out, p_logits, p_cache, _, _ = run(RG.row_gather_plain)
            check(torch.equal(out, p_out) and same_bits(logits, p_logits)
                  and all(same_bits(cache[k], p_cache[k]) for k in cache),
                  f"{cfg.name}: the run on the plain row gather differs")
            log(f"[lm] {cfg.name}: the same run on the plain row gather has "
                "bitwise the same tokens, final logits and cache")
            del p_out, p_logits, p_cache
        peak = torch.cuda.max_memory_allocated() - base
        # no warm-up: the checked run above warmed every path timed here
        prefill_ms = host_ms(lambda: engine.prefill(model, cfg, batch,
                                                    max_len), 0, 2)
        gen_ms = host_ms(lambda: engine.generate(model, cfg, batch, steps,
                                                 max_len), 0, 1)
        decode_ms = (gen_ms - prefill_ms) / (steps - 1)
        log(f"[time] {self.tag} {cfg.name} serve batch {b} prompt {s}: "
            f"prefill {prefill_ms:.4f} ms, decode {decode_ms:.4f} ms per "
            f"step of {b} tokens ((generate - prefill) / {steps - 1}), "
            f"generate {gen_ms:.4f} ms for {b * steps} tokens = "
            f"{b * steps / gen_ms * 1e3:.1f} tokens/s; peak memory {peak} B "
            f"(above the {base} B held before the model)")
        log_profile(self.tag, f"{cfg.name} prefill (batch {b}, {s} tokens)",
                    lambda: engine.prefill(model, cfg, batch, max_len),
                    1, warm=True)
        log_profile(self.tag, f"{cfg.name} decode step (batch {b})",
                    lambda: lm.decode_step(model, cfg, cache, out[:, -1:],
                                           pl + s + steps - 1, pl),
                    1, warm=True)
        if is_moe:
            for what, src, ids in gathers:
                self.lm_gather_time(cfg, f"prefill {what}", src, ids)
        del model, cache, gathers
        torch.cuda.empty_cache()

    def lm_gather_time(self, cfg, what, src, ids) -> None:
        torch, RG = self.torch, self.RG
        ms = device_ms(lambda: RG.row_gather(src, ids))
        plain_ms = device_ms(lambda: RG.row_gather_plain(src, ids))
        lib_ms = device_ms(lambda: torch.index_select(src, 0, ids))
        check(same_bits(torch.index_select(src, 0, ids),
                        RG.row_gather(src, ids)),
              "index_select disagrees with row_gather")
        distinct = int(torch.unique(ids).numel())
        nbytes = ids.numel() * 4 + (distinct + ids.numel()) * \
            src.shape[1] * src.element_size()
        bound_ms, _ = bound(nbytes)
        log(f"[time] {self.tag} row_gather {cfg.name} {what} "
            f"({ids.numel()} rows of {tuple(src.shape)} {src.dtype}): "
            f"{ms:.4f} ms vs bound {bound_ms:.4f} ms ({nbytes} B), "
            f"{bound_ms / ms:.3f} of the bound; plain version "
            f"{plain_ms:.4f} ms; index_select (yardstick) {lib_ms:.4f} ms")
        if what == "prefill dispatch":
            self.kernel_entry("row_gather", ms, plain_ms, nbytes, 0.0, lib_ms)

    def lm_decode_check(self, cfg, cut) -> None:
        """decode == forward (``tests/test_serve.py``'s rule) in float32;
        MoE in the dropless regime, where no capacity couples tokens.
        ``cut`` (a cell's "check") sets the depth, the experts and the
        prompt, and with "float64" it goes on as vlm does.  The hybrid
        family goes on to :meth:`hybrid_decode_check`, vlm to
        :meth:`float64_decode_check`."""
        torch = self.torch
        from repro_torch.models import lm
        cfg = cfg.replace(num_layers=cut.get("layers", cfg.num_layers),
                          num_experts=cut.get("num_experts",
                                              cfg.num_experts))
        if cfg.family == "moe":
            cfg = cfg.replace(capacity_factor=float(cfg.num_experts))
        f32 = cfg.replace(param_dtype=torch.float32,
                          compute_dtype=torch.float32)
        b, n = LM_CHECK["batch"], LM_CHECK["decoded"]
        s = cut.get("prompt", LM_CHECK["prompt"])
        model, gen = self.lm_model(f32)
        toks = torch.randint(0, cfg.vocab_size, (b, s + n), generator=gen,
                             device=self.dev, dtype=torch.int32)
        batch = self.lm_batch(f32, toks, gen)
        got, want = self.decode_vs_forward(model, f32, batch, s)
        if cfg.family == "hybrid":
            self.hybrid_decode_check(model, cfg, toks, got, want)
        elif cfg.family == "vlm" or cut.get("float64"):
            self.float64_decode_check(model, cfg, batch, got, want, s)
        else:
            err, ratio, ok = tol_ratio(got, want, LM_TOL)
            check(ok, f"{cfg.name}: decode differs from forward in float32 "
                  f"(max abs err {err}, {ratio:.3f} of the bound)")
            note = {"moe": f", {cfg.num_experts} experts, dropless",
                    "vlm": f", after {cfg.num_prefix} patch tokens",
                    "encdec": f", {cfg.enc_len} encoder "
                    "frames"}.get(cfg.family, "")
            if cfg.window:
                note += (f", {cfg.num_layers} layers of kinds "
                         f"{''.join(map(str, lm.layer_kinds(cfg)))}, "
                         f"window {cfg.window}")
            log(f"[lm] {cfg.name} float32 decode == forward (prompt {s}, "
                f"{n} decoded, batch {b}{note}): max abs err {err:.3e}, "
                f"{ratio:.3f} of the bound of rtol {LM_TOL['rtol']}, atol "
                f"{LM_TOL['atol']} (logits' scale "
                f"{float(np.abs(want).max()):.1f})")
        del model
        torch.cuda.empty_cache()

    def hybrid_decode_check(self, model, cfg, toks, got32, fwd32) -> None:
        """zamba2 over all its layers (the trailing ones after the last
        shared block included).  The same weights in float64 (the scan in
        float64 too; the cache's SSD state stays float32, as the reference
        defines it) give the yardstick: float64 decode == forward at
        ``LM_TOL``; float32 decode == forward, and each of the float32
        decode and forward against the float64 forward, at
        ``HYBRID_DECODE_TOL``, every reading also as a share of
        ``LM_TOL``'s bound."""
        torch = self.torch
        f64 = cfg.replace(param_dtype=torch.float64,
                          compute_dtype=torch.float64)
        model.double()
        got64, fwd64 = self.decode_vs_forward(model, f64, {"tokens": toks})
        held = {"float64 decode == forward": (got64, fwd64, LM_TOL),
                "float32 forward vs float64 forward": (
                    fwd32, fwd64, HYBRID_DECODE_TOL),
                "float32 decode vs float64 forward": (
                    got32, fwd64, HYBRID_DECODE_TOL),
                "float32 decode == forward": (got32, fwd32,
                                              HYBRID_DECODE_TOL)}
        where = (f"prompt {LM_CHECK['prompt']}, {LM_CHECK['decoded']} "
                 f"decoded, batch {LM_CHECK['batch']}, {cfg.num_layers} "
                 f"layers: the shared block after every "
                 f"{cfg.shared_attn_every}th, then "
                 f"{cfg.num_layers % cfg.shared_attn_every} trailing layers")
        for what, (got, want, tol) in held.items():
            err, ratio, ok = tol_ratio(got, want, tol)
            lm_ratio = tol_ratio(got, want, LM_TOL)[1]
            check(ok, f"{cfg.name}: {what} fails (max abs err {err}, "
                  f"{ratio:.3f} of the bound)")
            log(f"[lm] {cfg.name} {what} ({where}): max abs err {err:.3e}, "
                f"{ratio:.3f} of the bound of rtol {tol['rtol']}, atol "
                f"{tol['atol']} ({lm_ratio:.3f} of LM_TOL's; logits' scale "
                f"{float(np.abs(want).max()):.1f})")

    def float64_decode_check(self, model, cfg, batch, got32, fwd32,
                             s=LM_CHECK["prompt"]) -> None:
        """paligemma with all its patch tokens, and h2o-danube-3-4b past
        its window.  Their float32 rounding alone passes ``LM_TOL``'s
        bound: a tied embedding gives each token's own logit a scale of
        hundreds to thousands (paligemma's scaled by sqrt(d_model)), and an
        absolute error of that scale's float32 rounding lands on the logits
        near 0 (on the CPU at full width and depth, ``d_ff`` 2048 and a
        vocabulary of 8192, paligemma's reference float32 forward lies 36.6
        of the bound from a float64 one, the port's 25.7; danube at
        ``reduced()`` widths and its 4,096 window, the reference's 0.739,
        the port's 0.094).  So the same weights in float64 (the attention
        scores and softmax stay float32, as ``attention._sdpa`` defines
        them) give the yardstick: float64 decode == forward at ``LM_TOL``;
        the float32 decode no farther from the float64 forward than
        ``VLM_ROUNDING`` times the float32 forward is; every reading also
        as a share of ``LM_TOL``'s bound."""
        torch = self.torch
        from repro_torch.models import lm
        f64 = cfg.replace(param_dtype=torch.float64,
                          compute_dtype=torch.float64)
        model.double()
        got64, fwd64 = self.decode_vs_forward(model, f64, batch, s)
        where = (f"prompt {s}, {batch['tokens'].shape[1] - s} decoded, "
                 f"batch {batch['tokens'].shape[0]}, " + (
                     f"after {cfg.num_prefix} patch tokens"
                     if cfg.family == "vlm" else
                     f"{cfg.num_layers} layers of kinds "
                     f"{''.join(map(str, lm.layer_kinds(cfg)))}, window "
                     f"{cfg.window}"))
        errs = {}
        for what, got, want in (
                ("float64 decode == forward", got64, fwd64),
                ("float32 forward vs float64 forward", fwd32, fwd64),
                ("float32 decode vs float64 forward", got32, fwd64),
                ("float32 decode == forward", got32, fwd32)):
            err, ratio, ok = tol_ratio(got, want, LM_TOL)
            errs[what] = err
            if what.startswith("float64"):
                check(ok, f"{cfg.name}: {what} fails (max abs err {err}, "
                      f"{ratio:.3f} of the bound)")
            log(f"[lm] {cfg.name} {what} ({where}): max abs err {err:.3e}, "
                f"{ratio:.3f} of the bound of rtol {LM_TOL['rtol']}, atol "
                f"{LM_TOL['atol']} (logits' scale "
                f"{float(np.abs(want).max()):.1f})")
        own = errs["float32 forward vs float64 forward"]
        dec = errs["float32 decode vs float64 forward"]
        check(dec <= VLM_ROUNDING * own, f"{cfg.name}: the float32 decode "
              f"lies {dec} from the float64 forward, more than "
              f"{VLM_ROUNDING} x the float32 forward's {own}")
        log(f"[lm] {cfg.name} float32 decode's distance from the float64 "
            f"forward {dec / own:.3f} of the float32 forward's (held <= "
            f"{VLM_ROUNDING})")

    def decode_vs_forward(self, model, cfg, batch, s=LM_CHECK["prompt"]):
        """Prefill of ``s`` tokens (after vlm's patch prefix; whisper's
        frames in the encoder) and decode of the rest against the forward
        over all of ``batch["tokens"]``: the decoded logits and the
        forward's at the same positions, as numpy arrays."""
        from repro_torch.models import lm
        from repro_torch.serve import engine
        toks = batch["tokens"]
        n = toks.shape[1] - s
        pl = lm.prefix_slots(cfg)
        full, _ = lm.forward(model, cfg, batch)
        cache, last = engine.prefill(model, cfg, dict(batch,
                                                      tokens=toks[:, :s]),
                                     pl + s + n + 4)
        steps = [last[:, -1]]
        for i in range(s, s + n):
            logits, cache = lm.decode_step(model, cfg, cache,
                                           toks[:, i:i + 1], pl + i, pl)
            steps.append(logits[:, 0])
        return self.torch.stack(steps, 1).cpu().numpy(), \
            full[:, s - 1:].cpu().numpy()

    # -------------------------------------------------------- LM training
    def train_config(self, spec):
        from repro_torch.train import loop
        from repro_torch.optim import adamw
        return loop.TrainConfig(
            steps=spec["steps"], batch=spec["batch"], seq=spec["seq"],
            ckpt_every=spec["steps"] + 1, ckpt_dir=str(
                ROOT / "build" / "train_ckpt" / spec["arch"]),
            log_every=1, seed=SEED, opt=adamw.AdamWConfig(
                lr=3e-3, warmup_steps=spec["steps"] // 10 + 1,
                total_steps=spec["steps"]))   # the launcher's schedule

    def train_phase(self) -> None:
        """LM training at full width (see the module docstring, phase
        13)."""
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.perf_counter()
        shutil.rmtree(ROOT / "build" / "train_ckpt", ignore_errors=True)
        for spec in TRAIN_CELLS:
            cfg = self.lm_config(spec)
            with cell_seconds("[train]", cfg.name):
                if cfg.family == "moe":
                    self.train_gradients(cfg, spec)
                self.train_run(cfg, spec)
        with cell_seconds("[train]", "resume"):
            self.train_resume(self.lm_config(TRAIN_RESUME))
        shutil.rmtree(ROOT / "build" / "train_ckpt", ignore_errors=True)
        log(f"[train] phase in {time.perf_counter() - t0:.1f} s")

    def train_batch(self, cfg, spec, step=0):
        from repro_torch.data.pipeline import synth_batch
        return {k: self.torch.as_tensor(v, device=self.dev)
                for k, v in synth_batch(cfg, spec["batch"], spec["seq"],
                                        step, SEED).items()}

    def train_gradients(self, cfg, spec) -> None:
        """One loss + backward on the kernel path, every row gather
        (forward, recompute, backward) held bitwise to its plain version,
        then the same on the plain row gather: losses bitwise, every
        gradient leaf within ``TRAIN_GRAD_TOL``; the token rows' and the
        experts' gradients non-zero."""
        torch, RG = self.torch, self.RG
        from repro_torch.models import lm
        from repro_torch.models import moe as MOE
        model, _ = self.lm_model(cfg)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        batch = self.train_batch(cfg, spec)
        calls, backward = [0], []

        def checked(src, ids, d_tile=512):
            got = RG.row_gather(src, ids, d_tile)
            calls[0] += 1
            self.held("row_gather", got, RG.row_gather_plain(src, ids),
                      f"{cfg.name} train {tuple(ids.shape)} of "
                      f"{tuple(src.shape)}")
            if torch._C._current_graph_task_id() != -1:  # in the backward
                backward.append((src, ids))
            return got

        def loss_and_grads(gather):
            MOE.row_gather = gather
            try:
                loss, _ = lm.loss_fn(model, cfg, batch)
                loss.backward()
            finally:
                MOE.row_gather = RG.row_gather
            grads = {k: p.grad for k, p in params.items()}
            for p in params.values():
                p.grad = None
            return loss.detach(), grads

        self.zero_counts()
        loss, grads = loss_and_grads(checked)
        counts = self.read_counts(main_path=False)
        # a dispatch and a combine per layer in the forward, in the
        # backward's recompute (remat "full") and as the backward's gathers
        want = 6 * cfg.num_layers
        check(counts["row_gather"] == calls[0] == want and
              len(backward) == 4 * cfg.num_layers,
              f"{cfg.name}: {counts['row_gather']} row gathers in a loss + "
              f"backward ({len(backward)} during the backward), expected "
              f"{want} ({4 * cfg.num_layers} during the backward)")
        p_loss, p_grads = loss_and_grads(RG.row_gather_plain)
        check(same_bits(loss, p_loss), f"{cfg.name}: the loss on the plain "
              f"row gather differs ({float(loss)} vs {float(p_loss)})")
        worst, bitwise = 0.0, 0
        for k, g in grads.items():
            w = p_grads[k].float()
            scale = max(1.0, float(w.abs().max()))
            err = float((g.float() - w).abs().max())
            worst = max(worst, err / scale)
            bitwise += same_bits(g, p_grads[k])
            check(torch.allclose(g.float(), w, rtol=TRAIN_GRAD_TOL["rtol"],
                                 atol=TRAIN_GRAD_TOL["atol"] * scale),
                  f"{cfg.name}: gradient {k} on the kernel path differs from "
                  f"the plain path's (max abs err {err}, scale {scale})")
        rows = grads["embed"][batch["tokens"].long().unique()].float()
        check(bool((rows.abs().amax(dim=1) > 0).all()),
              f"{cfg.name}: a token row's embedding gradient is zero")
        for k, g in grads.items():
            if ".moe.w_" in k:
                check(bool(g.abs().amax() > 0), f"{cfg.name}: {k} has a "
                      "zero gradient on the kernel path")
        log(f"[train] {cfg.name} loss + backward (batch {spec['batch']}, seq "
            f"{spec['seq']}, remat {cfg.remat}): {calls[0]} row gathers "
            f"({len(backward)} during the backward: its recompute's and its "
            "own) each bitwise equal to the "
            f"plain version; loss {float(loss):.6f} bitwise the plain path's; "
            f"{bitwise} of {len(grads)} gradient leaves bitwise, the rest "
            f"within rtol {TRAIN_GRAD_TOL['rtol']}, atol "
            f"{TRAIN_GRAD_TOL['atol']} x scale (worst {worst:.3e} of the "
            "scale); every token row's embedding gradient and the experts' "
            "gradients non-zero")
        src, ids = backward[-1]
        del model, params, grads, p_grads, batch, rows
        torch.cuda.empty_cache()
        self.lm_gather_time(cfg, "train backward of the dispatch", src, ids)
        del src, ids, backward
        torch.cuda.empty_cache()

    def train_run(self, cfg, spec) -> None:
        """``Trainer.run()`` for ``spec["steps"]`` steps, the kernel counts
        zeroed before and read after; then a profiled step."""
        torch = self.torch
        from repro_torch.train import loop
        tc = self.train_config(spec)
        base = torch.cuda.memory_allocated()    # held by earlier phases
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        t0 = time.perf_counter()
        out = loop.Trainer(cfg, tc, device=self.dev).run()
        wall = time.perf_counter() - t0
        counts = self.read_counts()
        peak = torch.cuda.max_memory_allocated() - base
        model, metrics = out["params"], out["metrics"]
        losses = [m["loss"] for m in metrics]
        check(len(losses) == spec["steps"] and all(np.isfinite(losses)),
              f"{cfg.name}: train losses {losses}")
        check(losses[-1] < losses[0], f"{cfg.name}: the last loss "
              f"{losses[-1]} is not below the first {losses[0]}")
        per_step = 6 * cfg.num_layers if cfg.family == "moe" else 0
        check(counts["row_gather"] == per_step * spec["steps"],
              f"{cfg.name}: row_gather launched {counts['row_gather']} times "
              f"in {spec['steps']} steps, expected {per_step} a step")
        n = sum(p.numel() for p in model.parameters())
        n_enc = sum(p.numel() for name, p in model.named_parameters()
                    if name.startswith("enc_"))
        tokens = spec["batch"] * spec["seq"]
        step_ms = statistics.median(m["step_time"] for m in metrics[1:]) * 1e3
        self.train_readings[cfg.name, cfg.num_layers, spec["batch"],
                            spec["seq"]] = (metrics, step_ms)
        flops, counted = train_flops(cfg, n_enc, n - n_enc, spec["batch"],
                                     spec["seq"])
        log(f"[train] {cfg.name} ({cfg.num_layers} layers, {n} parameters, "
            f"remat {cfg.remat}) Trainer.run {spec['steps']} steps in "
            f"{wall:.2f} s: losses {[round(x, 4) for x in losses]}; kernel "
            f"launches { {k: c for k, c in counts.items() if c} } "
            f"({per_step} row_gather a step)")
        log(f"[time] {self.tag} {cfg.name} train batch {spec['batch']} seq "
            f"{spec['seq']}: step {step_ms:.4f} ms (median of steps 2-"
            f"{spec['steps']}, host clock), {tokens / step_ms * 1e3:.1f} "
            f"tokens/s, 6 N tokens / step = {flops / step_ms * 1e3:.4e} "
            f"FLOP/s ({counted}) = "
            f"{flops / step_ms * 1e3 / BF16_OPS_PER_S:.4f} of the "
            f"bf16 dense peak; first step {metrics[0]['step_time'] * 1e3:.1f} "
            f"ms; peak memory {peak} B (above the {base} B held before)")
        step_fn = loop.make_train_step(cfg, tc.opt)
        batch = self.train_batch(cfg, spec, spec["steps"])
        state = [out["opt"]]

        def one_step():
            state[0], _ = step_fn(model, state[0], batch)
        log_profile(self.tag, f"{cfg.name} train step (batch "
                    f"{spec['batch']}, seq {spec['seq']})", one_step, reps=1,
                    warm=True)
        if spec is TRAIN_CELLS[0]:          # for [dryrun]
            from torch.utils.flop_counter import FlopCounterMode
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            with FlopCounterMode(display=False) as fc:
                one_step()
            torch.cuda.synchronize()
            self.train_measured = dict(
                cfg=cfg, spec=spec, flops=fc.get_total_flops(),
                peak=torch.cuda.max_memory_allocated() - before)
        del out, model, state, batch
        torch.cuda.empty_cache()

    def train_resume(self, cfg) -> None:
        """Run A: ``steps`` straight; run B: ``first`` steps with an async
        checkpoint, then a fresh Trainer resumed to ``steps``: final
        parameters and moments equal (bitwise, or within a tolerance)."""
        torch = self.torch
        from repro_torch.checkpoint import checkpoint as ck
        from repro_torch.models import params as pr
        from repro_torch.train import loop
        spec = TRAIN_RESUME
        root = ROOT / "build" / "train_ckpt"
        tc = dataclasses.replace(self.train_config(spec), log_every=spec[
            "steps"], ckpt_dir=str(root / "straight"))
        self.zero_counts()
        a = loop.Trainer(cfg, tc, device=self.dev).run()
        b_dir = str(root / "resumed")
        first = dataclasses.replace(tc, steps=spec["first"],
                                    ckpt_every=spec["first"],
                                    async_ckpt=True, ckpt_dir=b_dir)
        b1 = loop.Trainer(cfg, first, device=self.dev).run()
        check(ck.latest_step(b_dir) == spec["first"],
              f"no checkpoint at step {spec['first']} in {b_dir}")
        nbytes = sum(f.stat().st_size for f in (
            Path(b_dir) / f"step_{spec['first']:08d}").iterdir())
        t0 = time.perf_counter()
        ck.save(str(root / "timed"), spec["first"],
                loop.train_state(b1["params"], b1["opt"]), block=True)
        write_s = time.perf_counter() - t0
        skeleton = {"params": pr.stacked_map(lambda _: None, pr.stack_tree(
            b1["params"].tree())), "opt": b1["opt"]}
        t0 = time.perf_counter()
        ck.restore(b_dir, spec["first"], skeleton)
        restore_s = time.perf_counter() - t0
        del b1
        b = loop.Trainer(cfg, dataclasses.replace(tc, ckpt_dir=b_dir),
                         device=self.dev).run()
        self.read_counts()
        check([m["step"] for m in b["metrics"]] ==
              list(range(spec["first"], spec["steps"])),
              f"the resumed run ran steps {[m['step'] for m in b['metrics']]}")
        pairs = list(zip(a["params"].parameters(), b["params"].parameters()))
        pairs += list(zip(pr.leaves_like(a["opt"], a["opt"]),
                          pr.leaves_like(b["opt"], b["opt"])))
        bitwise = all(same_bits(x, y) for x, y in pairs)
        worst = 0.0
        for x, y in pairs:
            x, y = x.detach().float(), y.detach().float()
            scale = max(1.0, float(x.abs().max()))
            worst = max(worst, float((x - y).abs().max()) / scale)
            check(bool(torch.allclose(x, y, rtol=TRAIN_GRAD_TOL["rtol"],
                                      atol=TRAIN_GRAD_TOL["atol"] * scale)),
                  "the resumed run's state differs from the straight run's")
        log(f"[train] {cfg.name} ({cfg.num_layers} layers) resume: "
            f"{spec['steps']} steps straight vs {spec['first']} + a fresh "
            f"Trainer resumed to {spec['steps']}: parameters and moments "
            f"{'bitwise equal' if bitwise else 'NOT bitwise equal'} (worst "
            f"{worst:.3e} of the scale, within rtol {TRAIN_GRAD_TOL['rtol']}"
            f", atol {TRAIN_GRAD_TOL['atol']} x scale); checkpoint {nbytes} "
            f"B, a blocking save {write_s:.2f} s, restore {restore_s:.2f} s "
            f"(msgpack{', zstd' if ck._zstd is not None else ', raw'})")
        del a, b
        torch.cuda.empty_cache()

    # ------------------------------------------------------- data parallel
    def dp_phase(self) -> None:
        """Data-parallel training and the vocab-sharded decode embedding on
        simulated meshes (see the module docstring, phase 14)."""
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.perf_counter()
        shutil.rmtree(ROOT / "build" / "dp_ckpt", ignore_errors=True)
        for spec in DP_CELLS:
            with cell_seconds("[dp]", f"{spec['arch']}"
                              f"{' 8-bit' if spec.get('q8') else ''}"):
                self.dp_train(self.lm_config(spec), spec)
        for what, fn, spec in (("8-bit state", self.dp_q8_state, DP_Q8_STATE),
                               ("state", self.dp_state, DP_STATE),
                               ("resume", self.dp_resume, DP_RESUME)):
            with cell_seconds("[dp]", what):
                fn(self.float32(self.lm_config(spec)))
        with cell_seconds("[dp]", "psum decode"):
            self.dp_decode(self.lm_config(DP_DECODE))
        shutil.rmtree(ROOT / "build" / "dp_ckpt", ignore_errors=True)
        log(f"[dp] phase in {time.perf_counter() - t0:.1f} s")

    def dp_mesh(self, data: int, model: int = 1):
        """A simulated ``data x model`` mesh on the card and its default
        rules."""
        from repro_torch.launch import sharding as sh
        from repro_torch.launch.mesh import ShardMesh
        mesh = ShardMesh(devices=(self.dev,) * (data * model), data=data,
                         model=model, simulated=True)
        return mesh, sh.Shd(mesh, sh.default_rules(mesh))

    def float32(self, cfg):
        t = self.torch.float32
        return cfg.replace(param_dtype=t, compute_dtype=t)

    @staticmethod
    def dense_rule(what, got, want, rule=DENSE_RULE) -> float:
        """Hold ``got`` to ``want`` at ``rule`` (by default the tests'
        dense rule); returns the share of the bound used."""
        allowed = rule["atol"] * max(1.0, abs(want)) + rule["rtol"] * \
            abs(want)
        err = abs(got - want)
        check(err <= allowed, f"{what}: {got!r} vs {want!r} (abs err {err}, "
              f"allowed {allowed} by rtol {rule['rtol']}, atol "
              f"{rule['atol']} x scale)")
        return err / allowed

    def dp_single_steps(self, cfg, spec, tc, n: int) -> list:
        """The first ``n`` steps on one device from the Trainer's start
        (its seed, schedule and batches): their metrics."""
        if not n:
            return []
        torch = self.torch
        from repro_torch.models import lm
        from repro_torch.optim import adamw
        from repro_torch.train import loop
        gen = torch.Generator(self.dev).manual_seed(tc.seed)
        model = lm.init_model(cfg, generator=gen, device=self.dev)
        step_fn = loop.make_train_step(cfg, tc.opt)
        state = adamw.init(model.tree(), tc.opt)
        out = []
        for i in range(n):
            state, m = step_fn(model, state, self.train_batch(cfg, spec, i))
            out.append({k: float(v) for k, v in m.items()})
        del model, state
        torch.cuda.empty_cache()
        return out

    def dp_train(self, cfg, spec) -> None:
        """``Trainer.run()`` at ``spec["shards"]`` simulated shards with the
        default rules: losses finite (the dense model's last below its
        first), the MoE row gathers counted, the first ``compare`` steps'
        loss at the dense rule and grad norm at ``BF16_NORM_RULE`` of the
        same steps on one device; then, for the dense model, the
        all-gather, the reduce-scatter and a whole step under the
        profiler.  (The dense rule holds the float32 state in
        :meth:`dp_state`.)"""
        torch = self.torch
        from repro_torch.train import loop
        k, q8 = spec["shards"], spec.get("q8", False)
        tc = self.train_config(spec)
        tc = dataclasses.replace(tc, ckpt_dir=str(
            ROOT / "build" / "dp_ckpt" / spec["arch"]),
            opt=dataclasses.replace(tc.opt, quantize_moments=q8))
        single = self.dp_single_steps(cfg, spec, tc, spec["compare"])
        mesh, shd = self.dp_mesh(k)
        base = torch.cuda.memory_allocated()    # held by earlier phases
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        t0 = time.perf_counter()
        out = loop.Trainer(cfg, tc, mesh=mesh, rules=shd.rules).run()
        wall = time.perf_counter() - t0
        counts = self.read_counts()
        peak = torch.cuda.max_memory_allocated() - base
        metrics, dp = out["metrics"], out["data_parallel"]
        losses = [m["loss"] for m in metrics]
        check(len(losses) == spec["steps"] and all(np.isfinite(losses)),
              f"{cfg.name} dp: train losses {losses}")
        if cfg.family != "moe":
            check(losses[-1] < losses[0], f"{cfg.name} dp: the last loss "
                  f"{losses[-1]} is not below the first {losses[0]}")
        per_step = 6 * cfg.num_layers if cfg.family == "moe" else 0
        check(counts["row_gather"] == per_step * spec["steps"],
              f"{cfg.name} dp: row_gather launched {counts['row_gather']} "
              f"times in {spec['steps']} steps, expected {per_step} a step")
        held = []
        for i, want in enumerate(single):
            for key, rule, name in (("loss", DENSE_RULE, "the dense rule"),
                                    ("grad_norm", BF16_NORM_RULE,
                                     "the bf16 rule")):
                share = self.dense_rule(f"{cfg.name} dp step {i + 1} {key}",
                                        metrics[i][key], want[key], rule)
                note = f"{share:.3f} of {name}'s bound"
                if rule is not DENSE_RULE:
                    dense = abs(metrics[i][key] - want[key]) / (
                        DENSE_RULE["atol"] * max(1.0, abs(want[key])) +
                        DENSE_RULE["rtol"] * abs(want[key]))
                    note += f", {dense:.3f} of the dense rule's"
                held.append(f"step {i + 1} {key} {metrics[i][key]!r} vs one "
                            f"device {want[key]!r} ({note})")
        held = ", ".join(held)
        whole = sum(x.numel() * x.element_size() for x in
                    out["params"].parameters())
        piece = sum(t.pieces[0].numel() * t.pieces[0].element_size()
                    for t in sharded_leaves(dp.params))
        moments = sum(t.pieces[0].numel() * t.pieces[0].element_size()
                      for key in ("m", "v")
                      for t in sharded_leaves(out["opt"][key]))
        self.dp_peaks[(cfg.name, q8)] = peak
        if spec["arch"] == DP_CELLS[0]["arch"]:     # for [dryrun]
            from repro_torch.launch import dryrun as dr
            from repro_torch.launch import sharding as sh
            batch = self.train_batch(cfg, spec)
            pl = sh.batch_sharding(shd, batch)
            self.dp_held[q8] = dr.held_bytes(
                dp.tree(), out["opt"],
                {key: pl[key].split(v) for key, v in batch.items()})
        f32_peak = self.dp_peaks.get((cfg.name, False)) if q8 else None
        tokens = spec["batch"] * spec["seq"]
        step_ms = statistics.median(m["step_time"] for m in metrics[1:]) * 1e3
        log(f"[dp] {cfg.name} ({cfg.num_layers} layers) Trainer.run on a "
            f"simulated {k}-shard mesh, default rules, "
            f"{'8-bit' if q8 else 'float32'} moments: {spec['steps']} steps "
            f"in {wall:.2f} s, losses {[round(x, 4) for x in losses]}; kernel "
            f"launches { {n: c for n, c in counts.items() if c} } "
            f"({per_step} row_gather a step); {held or 'no step compared'}"
            f"; a device's pieces {piece} B of {whole} B of parameters, "
            f"moments {moments} B")
        log(f"[time] {self.tag} {cfg.name} dp train ({k} simulated shards) "
            f"batch {spec['batch']} seq {spec['seq']}: step {step_ms:.4f} ms "
            f"(median of steps 2-{spec['steps']}, host clock), "
            f"{tokens / step_ms * 1e3:.1f} tokens/s; first step "
            f"{metrics[0]['step_time'] * 1e3:.1f} ms; peak memory {peak} B "
            f"(above the {base} B held before)"
            + (f"; 8-bit moments (the float32 cell: {f32_peak} B)"
               if q8 else ""))
        if cfg.family != "moe":
            self.dp_collectives(cfg, spec, tc, dp, shd)
        del out, dp
        torch.cuda.empty_cache()

    def dp_collectives(self, cfg, spec, tc, dp, shd) -> None:
        """Device busy ms of the all-gather and of the reduce-scatter (the
        gradients of one real backward, put back before each call), and a
        whole data-parallel step, under the profiler (float32 moments);
        then one more step whose collectives ``DataParallel`` counts, for
        ``[dryrun]``."""
        torch = self.torch
        from repro_torch.optim import adamw
        from repro_torch.train import loop
        k, q8 = len(dp.devices), tc.opt.quantize_moments
        batch = self.train_batch(cfg, spec, spec["steps"])
        if not q8:           # the float32 cell times the collectives
            self.dp_collective_times(cfg, spec, dp, shd, batch)
        step_fn = loop.make_train_step(cfg, tc.opt, shd=shd)
        state = [adamw.init(dp.tree(), tc.opt, shd=shd)]

        def one_step():
            state[0], _ = step_fn(dp, state[0], batch)
        if not q8:
            log_profile(self.tag, f"{cfg.name} dp train step ({k} simulated "
                        f"shards, batch {spec['batch']}, seq {spec['seq']})",
                        one_step, reps=1, warm=True)
        dp.reset_collectives()
        one_step()
        self.dp_counted[q8] = {c: dict(v) for c, v in dp.collectives.items()}
        del state
        torch.cuda.empty_cache()

    def dp_collective_times(self, cfg, spec, dp, shd, batch) -> None:
        torch = self.torch
        from repro_torch.launch import sharding as sh
        from repro_torch.train import loop
        nbytes = sum(x.numel() * x.element_size() for x in
                     dp.models[0].parameters())
        k = len(dp.devices)
        dp.gather()
        for m in dp.models:
            m.requires_grad_(True)
        placements = sh.batch_sharding(shd, batch)
        place = {key: placements[key].split(v) for key, v in batch.items()}
        mbs, split = dp.rows(place, 0, spec["batch"])
        loss, _ = loop._replica_loss(dp.models, cfg, mbs, split)
        loss.backward()
        params = [p for m in dp.models for p in m.parameters()]
        grads = [p.grad for p in params]

        def reduce_scatter():
            for p, g in zip(params, grads):
                p.grad = g
            dp.reduce_scatter(split)
        for what, fn, moved in (
                ("all-gather", dp.gather, 2 * k * nbytes),
                ("reduce-scatter", reduce_scatter,
                 k * nbytes + 4 * nbytes // grads[0].element_size())):
            prof = profile_breakdown(fn, reps=2)
            busy = "not measured" if prof is None else f"{prof[1]:.4f} ms"
            bound_ms, _ = bound(moved)
            log(f"[time] {self.tag} {cfg.name} dp {what} ({k} simulated "
                f"shards, {nbytes} B of parameters): device busy {busy} a "
                f"call, {prof[3] if prof else 'n/a'} kernel launches, wall "
                f"{prof[0] if prof else float('nan'):.4f} ms under the "
                f"profiler; its bytes ({moved} B read and written) at the "
                f"card's rate {bound_ms:.4f} ms")
        del grads, params, loss, mbs, place
        for p in (p for m in dp.models for p in m.parameters()):
            p.grad = None
        torch.cuda.empty_cache()

    def dp_q8_state(self, cfg) -> None:
        """One data-parallel step with 8-bit moments (float32, unclipped)
        against one device's 8-bit AdamW update on the same summed
        gradients, from the same weights: the moments dequantized at the
        dense rule of each leaf's scale, ``q`` equal but across a rounding
        boundary (at most 1 apart; the count printed), the weights at the
        dense rule."""
        torch = self.torch
        from repro_torch.models import lm
        from repro_torch.models import params as pr
        from repro_torch.optim import adamw
        from repro_torch.train import loop
        spec = DP_Q8_STATE
        oc = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=2,
                               clip_norm=1e9, quantize_moments=True)

        def init():
            gen = torch.Generator(self.dev).manual_seed(SEED)
            return lm.init_model(cfg, generator=gen, device=self.dev)
        one, (mesh, shd) = init(), self.dp_mesh(spec["shards"])
        dp = loop.DataParallel(init(), shd)
        state = adamw.init(dp.tree(), oc, shd=shd)
        seen, update = {}, adamw.update

        def spy(params, grads, st, c):
            seen["grads"] = pr.stacked_map(
                lambda g: g.join().reshape(-1), grads)
            return update(params, grads, st, c)
        adamw.update = spy
        try:
            state, _ = loop.make_train_step(cfg, oc, shd=shd)(
                dp, state, self.train_batch(cfg, spec))
        finally:
            adamw.update = update
        ones = pr.stack_tree(one.tree())

        def whole(g, leaf):
            shape = pr.stacked_shape(leaf)
            t = g[:math.prod(shape)].reshape(shape)
            return [t[i] for i in range(shape[0])] \
                if isinstance(leaf, list) else t
        grads = pr.stacked_map(whole, seen.pop("grads"), ones)
        per_layer = {k: ([pr.stacked_map(lambda x, i=i: x[i], v)
                          for i in range(cfg.num_layers)]
                         if k == "layers" else v) for k, v in grads.items()}
        st1, _ = update(one.tree(), per_layer, adamw.init(one.tree(), oc),
                        oc)
        dp.gather(replicas=1)
        worst, flips, n = 0.0, 0, 0
        for key in ("m", "v"):
            for leaf_one, leaf_dp in zip(
                    pr.leaves_like(ones, st1[key]),
                    pr.leaves_like(ones, state[key])):
                q1, s1 = leaf_one["q"], leaf_one["s"]
                q2, s2 = leaf_dp["q"].join(), leaf_dp["s"].join()
                dq = (q1.int() - q2.int()).abs()
                check(int(dq.max()) <= 1, f"8-bit dp {key}: q apart by "
                      f"{int(dq.max())}")
                flips += int((dq > 0).sum())
                n += q1.numel()
                want, got = q1.float() * s1, q2.float() * s2
                scale = max(1.0, float(want.abs().max()))
                err = float((got - want).abs().max())
                allowed = DENSE_RULE["atol"] * scale
                check(bool(((got - want).abs() <= allowed +
                            DENSE_RULE["rtol"] * want.abs()).all()),
                      f"8-bit dp {key}: dequantized moments {err} apart "
                      f"(scale {scale})")
                worst = max(worst, err / allowed)
        wmax = 0.0
        for (name, p1), p2 in zip(one.named_parameters(),
                                  dp.models[0].parameters()):
            p1, p2 = p1.detach(), p2.detach()
            scale = max(1.0, float(p1.abs().max()))
            err = float((p1 - p2).abs().max())
            check(err <= DENSE_RULE["atol"] * scale + DENSE_RULE["rtol"] *
                  float(p1.abs().max()), f"8-bit dp weight {name}: {err}")
            wmax = max(wmax, err / (DENSE_RULE["atol"] * scale))
        log(f"[dp] {cfg.name} ({cfg.num_layers} layers, float32) 8-bit "
            f"moments at {spec['shards']} simulated shards, step 1 vs one "
            f"device's 8-bit update on the same summed gradients "
            f"(unclipped): q apart in {flips} of {n} elements (by 1 at "
            f"most), dequantized moments at {worst:.3g} and weights at "
            f"{wmax:.3g} of the dense rule's atol")
        del one, dp, state, st1, grads, per_layer
        torch.cuda.empty_cache()

    def dryrun_phase(self) -> None:
        """The dry run's reckoning against this call's readings (see the
        module docstring, phase 15); host work, so the second share of the
        card tests starts here (the graph phase joins it)."""
        from repro_torch.launch import dryrun as dr
        from repro_torch.launch import sharding as sh
        from repro_torch.launch.mesh import ShardMesh
        from repro_torch.launch.step_analysis import COLLECTIVES
        self.start_card_tests(1)
        t0 = time.perf_counter()
        for q8 in (False, True):
            spec = next(c for c in DP_CELLS if c.get("q8", False) == q8
                        and c["arch"] == DP_CELLS[0]["arch"])
            cfg = self.lm_config(spec)
            mesh, shd = self.dp_mesh(spec["shards"])
            rec = dr.reckon(cfg, "train", {"seq_len": spec["seq"],
                                           "global_batch": spec["batch"]},
                            mesh, shd.rules,
                            {"quantize_moments": True} if q8 else None,
                            trace=False)
            held, counted = self.dp_held[q8], self.dp_counted[q8]
            check(rec["arguments"] == held, f"[dryrun] {cfg.name} "
                  f"{'8-bit' if q8 else 'float32'}: reckoned argument bytes "
                  f"{rec['arguments']} vs held {held}")
            want = {c: rec["collectives"][c] for c in COLLECTIVES}
            check(want == counted, f"[dryrun] {cfg.name}: reckoned "
                  f"collectives {want} vs counted {counted}")
            moved = {c: (v["count"], v["bytes"])
                     for c, v in counted.items() if v["count"]}
            log(f"[dryrun] {cfg.name} dp cell ({spec['shards']} simulated "
                f"shards, batch {spec['batch']} x {spec['seq']}, "
                f"{'8-bit' if q8 else 'float32'} moments): argument bytes "
                f"{rec['memory']['argument_bytes']} = held {held} exactly; "
                f"collectives a step reckoned = counted {moved} "
                f"exactly ({rec['collectives']['total_bytes']} B)")
        m = self.train_measured
        mesh = ShardMesh(devices=(self.dev,), data=1)
        t1 = time.perf_counter()
        rec = dr.reckon(m["cfg"], "train", {"seq_len": m["spec"]["seq"],
                                            "global_batch":
                                            m["spec"]["batch"]},
                        mesh, sh.default_rules(mesh))
        traced = rec["traced"]
        check(traced["flops"] == m["flops"], f"[dryrun] {m['cfg'].name} "
              f"train step: traced flops {traced['flops']} vs the card's "
              f"FlopCounterMode {m['flops']}")
        log(f"[dryrun] {m['cfg'].name} train step (batch "
            f"{m['spec']['batch']} x {m['spec']['seq']}, one device): traced "
            f"on fake tensors in {time.perf_counter() - t1:.1f} s"
            f"{self.beside_tests() or ' (host clock)'}, "
            f"flops {traced['flops']} = the card's FlopCounterMode exactly; "
            f"reckoned peak of temporaries {traced['peak_bytes']} B vs "
            f"torch.cuda.max_memory_allocated above the arguments "
            f"{m['peak']} B: ratio {traced['peak_bytes'] / m['peak']:.4f}; "
            f"bytes accessed (the proxy) {traced['memory_bytes']} B")
        self.dryrun_pieces()
        log(f"[dryrun] phase in {time.perf_counter() - t0:.1f} s")

    def dryrun_pieces(self) -> None:
        """The dry run's trace of one data replica's program over its
        model pieces against the ``[tp]`` cells (:meth:`tp_measure`): the
        reckoned collectives (the data axis's and the model axis's) equal
        the counted ones, the reckoned argument bytes equal what device 0
        holds, and the traced flops over every device of the mesh equal
        ``FlopCounterMode`` over the same step on the card, exactly."""
        from repro_torch.launch import dryrun as dr
        from repro_torch.launch.step_analysis import COLLECTIVES
        t0 = time.perf_counter()
        for name, mm in self.tp_measured.items():
            spec, cfg = mm["spec"], mm["cfg"]
            t1 = time.perf_counter()
            rec = dr.reckon(cfg, "train", {"seq_len": spec["seq"],
                                           "global_batch": spec["batch"]},
                            mm["mesh"], mm["rules"],
                            dataclasses.asdict(mm["opt"]))
            what = f"[dryrun] {name} ({spec['data']}, {spec['model']})"
            check(rec["arguments"] == mm["held"], f"{what}: reckoned "
                  f"argument bytes {rec['arguments']} vs held {mm['held']}")
            want = {c: rec["collectives"][c] for c in COLLECTIVES}
            check(want == mm["counted"], f"{what}: reckoned collectives "
                  f"{want} vs counted {mm['counted']}")
            traced = rec["traced"]
            check(traced["mesh_flops"] == mm["flops"], f"{what}: traced "
                  f"flops over the mesh {traced['mesh_flops']} vs the "
                  f"card's FlopCounterMode {mm['flops']}")
            moved = {c: (v["count"], v["bytes"])
                     for c, v in mm["counted"].items() if v["count"]}
            log(f"{what} train step (batch {spec['batch']} x "
                f"{spec['seq']}, {cfg.num_layers} layers, "
                f"{'8-bit' if mm['opt'].quantize_moments else 'float32'} "
                f"moments): one data replica's {spec['model']} pieces "
                f"traced in {time.perf_counter() - t1:.1f} s; argument "
                f"bytes {rec['memory']['argument_bytes']} = held exactly; "
                f"collectives a step reckoned = counted {moved} exactly; "
                f"flops over the mesh {traced['mesh_flops']} = the card's "
                f"FlopCounterMode exactly; device 0: flops "
                f"{rec['cost']['flops']}, bytes accessed "
                f"{rec['cost']['bytes_accessed']}, peak of temporaries "
                f"{rec['memory']['temp_bytes']} B")
        check(len(self.tp_measured) == 3, f"[dryrun] the [tp] cells "
              f"measured: {sorted(self.tp_measured)}")
        log(f"[dryrun] the [tp] cells in {time.perf_counter() - t0:.1f} s")

    def dp_state(self, cfg) -> None:
        """The state after step 1 at ``shards`` simulated shards against
        one device's from the same start (float32, the launcher's
        schedule).  Against one device taking the shards' rows as
        ``shards`` microbatches, the same sums in the same order (a
        replica's gradient and a microbatch's differ by the exact factor
        ``shards`` of their loss denominators): both moments and the
        weights leaf for leaf at the dense rule of each leaf's own scale,
        and steps 1 and 2's loss and grad norm at the dense rule.  Against
        one device on the whole batch, step 1's loss and grad norm at the
        dense rule, and every weight AdamW's first step on its own run's
        moments (:meth:`dp_state_breakdown`); where the moments part is
        printed by leaf, beside how far one device's logits of the same
        weights part when its rows are cut into the shards' blocks (the
        products over the whole batch round otherwise)."""
        torch = self.torch
        from repro_torch.launch import sharding as sh
        from repro_torch.models import lm
        from repro_torch.models import params as pr
        from repro_torch.optim import adamw
        from repro_torch.train import loop
        spec = DP_STATE
        k = spec["shards"]
        tc = self.train_config(spec)
        mesh, shd = self.dp_mesh(k)
        runs = {}            # name -> (model or DataParallel, step, state)
        for name, s, micro in (("one device", None, 1),
                               (f"one device, {k} microbatches", None, k),
                               ("shards", shd, 1)):
            gen = torch.Generator(self.dev).manual_seed(tc.seed)
            model = lm.init_model(cfg, generator=gen, device=self.dev)
            holder = model if s is None else loop.DataParallel(model, s)
            runs[name] = [holder, loop.make_train_step(
                cfg, tc.opt, shd=s, microbatches=micro),
                adamw.init(holder.tree(), tc.opt), []]

        def leaves(run) -> dict:
            """Both moments' leaves and every weight, each flat in the
            stacked layout's order, by (kind, path)."""
            out = {}

            def walk(kind, tree, path=""):
                if isinstance(tree, dict):
                    for key in sorted(tree):
                        walk(kind, tree[key], f"{path}/{key}")
                    return
                parts = tree if isinstance(tree, list) else [tree]
                out[kind, path] = torch.cat([
                    (x.join() if isinstance(x, sh.Sharded) else x)
                    .detach().reshape(-1) for x in parts])
            for key in ("m", "v"):
                walk(key, run[2][key])
            walk("w", pr.stack_tree(run[0].tree()))
            return out

        def diff(a, b) -> dict:
            """Per leaf: (elements past the dense rule of the leaf's scale,
            the worst error over that scale, the mask of those past)."""
            out = {}
            for key, x in a.items():
                y = b[key]
                scale = float(x.abs().max())
                err = (x - y).abs()
                past = err > DENSE_RULE["atol"] * scale + \
                    DENSE_RULE["rtol"] * x.abs()
                out[key] = (int(past.sum()), float(err.max()) /
                            max(scale, 1e-30), past)
            return out
        one, micro, dp = runs.values()
        with torch.no_grad():      # the same weights, the rows whole or cut
            batch = self.train_batch(cfg, spec, 0)
            whole = lm.forward(one[0], cfg, batch)[0]
            n = spec["batch"] // k
            cut = torch.cat([lm.forward(one[0], cfg, {
                key: v[r * n:(r + 1) * n] for key, v in batch.items()})[0]
                for r in range(k)])
            logit_gap = float((whole - cut).abs().max())
            logit_max = float(whole.abs().max())
            del whole, cut
        for i in range(spec["steps"]):
            batch = self.train_batch(cfg, spec, i)
            for run in runs.values():
                run[2], m = run[1](run[0], run[2], batch)
                run[3].append({key: float(v) for key, v in m.items()})
            if i == 0:               # the state after step 1
                la, lb, lc = leaves(micro), leaves(dp), leaves(one)
                d_micro, d_one = diff(la, lb), diff(lc, lb)
                breakdown = self.dp_state_breakdown(
                    cfg.name, d_one, lc, lb, tc.opt, dp[3][0]["lr"])
                total = sum(x.numel() for x in lb.values())
                del la, lb, lc
        bad = sum(n for n, _, _ in d_micro.values())
        worst = max(w for _, w, _ in d_micro.values())
        check(bad == 0, f"{cfg.name} dp state: {bad} of {total} moment and "
              f"weight elements after step 1 differ from one "
              f"device's on {k} microbatches past the dense rule of their "
              f"leaf's scale (worst {worst:.3e} of it)")
        shares = [self.dense_rule(f"{cfg.name} dp state step {i + 1} {key} "
                                  f"vs {k} microbatches", dp[3][i][key],
                                  micro[3][i][key])
                  for i in range(spec["steps"])
                  for key in ("loss", "grad_norm")]
        shares += [self.dense_rule(f"{cfg.name} dp state step 1 {key} vs one"
                                   " device", dp[3][0][key], one[3][0][key])
                   for key in ("loss", "grad_norm")]
        log(f"[dp] {cfg.name} ({cfg.num_layers} layers, float32) the state "
            f"after step 1 at {k} simulated shards vs one device from the "
            f"same start; steps 1-{spec['steps']} losses "
            f"{[m['loss'] for m in dp[3]]}, grad norms "
            f"{[m['grad_norm'] for m in dp[3]]}; vs one device on {k} "
            "microbatches (the same rows) "
            f"{[m['loss'] for m in micro[3]]}, "
            f"{[m['grad_norm'] for m in micro[3]]}: every moment and weight "
            f"within the dense rule of its leaf's scale (worst {worst:.3e} "
            f"of it); vs one device on the whole batch "
            f"{[m['loss'] for m in one[3]]}, "
            f"{[m['grad_norm'] for m in one[3]]}: step 1's loss and grad "
            f"norm held; {max(shares):.3f} of the dense rule's bound at most "
            "on the held metrics")
        log(f"[dp] {cfg.name} dp state vs one device on the whole batch, "
            f"of {total} elements: {breakdown}; one device's logits of the "
            f"same weights on the whole batch and on its {k} row blocks "
            f"part by {logit_gap!r} at most (largest |logit| "
            f"{logit_max!r})")
        del runs, one, micro, dp
        torch.cuda.empty_cache()

    def dp_state_breakdown(self, name, d_one, one, dp, opt, lr) -> str:
        """Where the shards' state after step 1 parts from one device's on
        the whole batch past the dense rule: per kind (m, v, weights) the
        elements past it and the leaf of the worst error; for the first
        moment, the largest step gradient ``g = m / (1 - b1)`` past it over
        its leaf's largest; for the weights, how many of those past it
        have a ``g`` that changes sign between the runs, and the largest
        ``min(|g_one|, |g_dp|)`` of the others, over ``eps`` and over the
        leaf's largest.  Held: every weight is AdamW's first step from the
        same start on its own run's moments, ``w_one - w_dp = -lr (u_one -
        u_dp)`` with ``u = (m / c1) / (sqrt(v / c2) + eps)``, at the dense
        rule of the leaf's scale: the weights part only where the
        gradients do."""
        torch = self.torch
        c1, c2 = 1 - opt.b1, 1 - opt.b2          # step 1's corrections
        kinds, held = {}, 0.0
        for (kind, path), (n, worst, past) in d_one.items():
            k = kinds.setdefault(kind, dict(past=0, worst=0.0, leaf=None,
                                            flips=0, same=0.0, rel=0.0))
            k["past"] += n
            if worst > k["worst"]:
                k["worst"], k["leaf"] = worst, path
            if kind == "m" and n:
                k["rel"] = max(k["rel"], float(
                    one["m", path][past].abs().max() /
                    one["m", path].abs().max()))
            if kind != "w":
                continue

            def u(run):
                return (run["m", path] / c1) / (
                    torch.sqrt(run["v", path] / c2) + opt.eps)
            w = one["w", path]
            resid = (w - dp["w", path] + lr * (u(one) - u(dp))).abs()
            allowed = DENSE_RULE["atol"] * float(w.abs().max()) + \
                DENSE_RULE["rtol"] * w.abs()
            share = float((resid / allowed).max())
            check(share <= 1.0, f"{name} dp state: the weights {path} after "
                  f"step 1 are not AdamW's step on their own run's moments "
                  f"at the dense rule ({share:.3f} of its bound)")
            held = max(held, share)
            if not n:
                continue
            ga = one["m", path][past] / c1
            gb = dp["m", path][past] / c1
            flip = torch.sign(ga) != torch.sign(gb)
            k["flips"] += int(flip.sum())
            small = torch.minimum(ga.abs(), gb.abs())[~flip]
            if small.numel():
                top = float(small.max())
                k["same"] = max(k["same"], top / opt.eps)
                k["rel"] = max(k["rel"], top / float(
                    one["m", path].abs().max() / c1))
        out = []
        for kind, k in kinds.items():
            text = (f"{kind}: {k['past']} past the rule, worst "
                    f"{k['worst']:.3e} of its leaf's scale at {k['leaf']}")
            if kind == "m":
                text += (f", |g| at most {k['rel']:.3e} of its leaf's "
                         f"largest there")
            if kind == "w":
                text += (f", of them {k['flips']} whose gradient changes "
                         f"sign, the others' min |g| at most "
                         f"{k['same']:.3e} eps ({k['rel']:.3e} of their "
                         f"leaf's largest gradient); every weight AdamW's "
                         f"step on its own run's moments ({held:.3f} of the "
                         f"dense rule's bound at most)")
            out.append(text)
        return "; ".join(out)

    def dp_resume(self, cfg) -> None:
        """Elastic restart: 6 steps straight at ``shards`` simulated shards
        against ``first`` steps there with an async checkpoint and a fresh
        single-device Trainer resumed to 6, on ``shards`` microbatches (the
        shards' rows, as in :meth:`dp_state`): the resumed steps the right
        ones, their losses and grad norms at the dense rule."""
        from repro_torch.checkpoint import checkpoint as ck
        from repro_torch.train import loop
        spec = DP_RESUME
        root = ROOT / "build" / "dp_ckpt" / "resume"
        mesh, shd = self.dp_mesh(spec["shards"])
        tc = dataclasses.replace(self.train_config(spec), log_every=spec[
            "steps"], ckpt_dir=str(root / "straight"))
        self.zero_counts()
        a = loop.Trainer(cfg, tc, mesh=mesh, rules=shd.rules).run()
        b_dir = str(root / "resumed")
        loop.Trainer(cfg, dataclasses.replace(
            tc, steps=spec["first"], ckpt_every=spec["first"],
            async_ckpt=True, ckpt_dir=b_dir), mesh=mesh,
            rules=shd.rules).run()
        check(ck.latest_step(b_dir) == spec["first"],
              f"no checkpoint at step {spec['first']} in {b_dir}")
        b = loop.Trainer(cfg, dataclasses.replace(
            tc, ckpt_dir=b_dir, microbatches=spec["shards"]),
            device=self.dev).run()
        self.read_counts()
        got, want = b["metrics"], a["metrics"][spec["first"]:]
        check([m["step"] for m in got] ==
              list(range(spec["first"], spec["steps"])),
              f"the resumed run ran steps {[m['step'] for m in got]}")
        shares = [self.dense_rule(f"{cfg.name} resumed step {m['step'] + 1} "
                                  f"{key}", m[key], w[key])
                  for m, w in zip(got, want) for key in ("loss", "grad_norm")]
        log(f"[dp] {cfg.name} ({cfg.num_layers} layers, float32) elastic "
            f"restart: {spec['first']} steps on {spec['shards']} simulated "
            f"shards, checkpointed, a fresh Trainer resumed on one device "
            f"({spec['shards']} microbatches: the shards' rows, see dp_state)"
            f" to {spec['steps']}: steps {[m['step'] + 1 for m in got]} "
            f"losses {[m['loss'] for m in got]} vs "
            f"{[m['loss'] for m in want]} straight on {spec['shards']} "
            f"shards, grad norms {[m['grad_norm'] for m in got]} vs "
            f"{[m['grad_norm'] for m in want]}: within the dense rule "
            f"({max(shares):.3f} of its bound at most)")
        del a, b
        self.torch.cuda.empty_cache()

    def dp_decode(self, cfg) -> None:
        """Greedy decoding with ``decode_embed="psum"`` over a simulated
        ``(1, model)`` mesh: tokens, the next logits and the cache equal
        (``torch.equal``) to the gather decode's; the row gathers counted
        (the MoE layers' and ``model`` a decode step for the lookup),
        the lookup's held to the plain gather; then the lookup timed."""
        torch, RG = self.torch, self.RG
        from repro_torch.models import layers as L
        from repro_torch.models import lm
        from repro_torch.serve import engine
        spec = DP_DECODE
        b, s, steps, mn = spec["batch"], spec["prompt"], spec["steps"], \
            spec["model"]
        mesh, shd = self.dp_mesh(1, mn)
        pcfg = cfg.replace(decode_embed="psum")
        model, gen = self.lm_model(cfg)
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                               device=self.dev, dtype=torch.int32)
        batch = {"tokens": tokens}
        max_len = s + steps + 4
        out, cache = engine.generate(model, cfg, batch, steps, max_len)
        logits, _ = lm.decode_step(model, cfg, cache, out[:, -1:],
                                   s + steps - 1)
        calls = [0]

        def checked(src, ids, d_tile=512):
            got = RG.row_gather(src, ids, d_tile)
            calls[0] += 1
            self.held("row_gather", got, RG.row_gather_plain(src, ids),
                      f"{cfg.name} psum lookup {tuple(ids.shape)} of "
                      f"{tuple(src.shape)}")
            return got
        L.row_gather = checked
        try:
            self.zero_counts()
            p_out, p_cache = engine.generate(model, pcfg, batch, steps,
                                             max_len, shd=shd)
            counts = self.read_counts()
            p_logits, _ = lm.decode_step(model, pcfg, p_cache, p_out[:, -1:],
                                         s + steps - 1, shd=shd)
        finally:
            L.row_gather = RG.row_gather
        want = 2 * cfg.num_layers * steps + mn * (steps - 1)
        check(counts["row_gather"] == want, f"{cfg.name} psum decode: "
              f"row_gather launched {counts['row_gather']} times, expected "
              f"{want}")
        check(calls[0] == mn * steps, f"{cfg.name} psum decode: "
              f"{calls[0]} lookup gathers, expected {mn * steps}")
        check(torch.equal(out, p_out) and torch.equal(logits, p_logits)
              and all(torch.equal(cache[key], p_cache[key]) for key in cache),
              f"{cfg.name}: the psum decode differs from the gather decode")
        placed = shd.place(model.embed, ("vocab", "embed"))
        views = all(p.data_ptr() == model.embed[j * p.shape[0]].data_ptr()
                    for j, p in enumerate(placed.pieces))
        log(f"[dp] {cfg.name} ({cfg.num_layers} layers) psum decode on a "
            f"simulated (1, {mn}) mesh (batch {b}, prompt {s}, {steps} greedy "
            f"steps): tokens, next logits and cache equal (torch.equal) to "
            f"the gather decode's; kernel launches "
            f"{ {n: c for n, c in counts.items() if c} } ({mn} row_gather a "
            f"decode step for the lookup, each held bitwise to the plain "
            f"gather); table pieces {'views' if views else 'copies'} of "
            f"{tuple(placed.pieces[0].shape)}")
        ids = p_out[:, -1:]
        ms = device_ms(lambda: L.embed_lookup_psum(model.embed, ids,
                                                   cfg.compute_dtype, shd))
        gather_ms = device_ms(lambda: L.embed_lookup(model.embed, ids,
                                                     cfg.compute_dtype))
        flat = ids.reshape(-1).long()
        lib_ms = device_ms(lambda: torch.index_select(model.embed, 0, flat))
        es = model.embed.element_size()
        nbytes = ids.numel() * 4 + 2 * ids.numel() * cfg.d_model * es
        bound_ms, _ = bound(nbytes)
        log(f"[time] {self.tag} {cfg.name} psum embedding lookup ({b} tokens "
            f"over {mn} vocab pieces of {tuple(placed.pieces[0].shape)}): "
            f"{ms:.4f} ms vs bound {bound_ms:.6f} ms ({nbytes} B: the ids, "
            f"one row a token, the output); the gather lookup {gather_ms:.4f}"
            f" ms; index_select (yardstick) {lib_ms:.4f} ms")
        del model, cache, p_cache, placed
        torch.cuda.empty_cache()

    # ------------------------------------------------- tensor parallel
    def tp_phase(self) -> None:
        """Tensor and expert parallel over simulated ``(data, model)``
        meshes (see the module docstring, phase 16)."""
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.perf_counter()
        shutil.rmtree(ROOT / "build" / "tp_ckpt", ignore_errors=True)
        for spec in TP_TRAIN:
            with cell_seconds("[tp]", f"{spec['arch']} train"):
                self.tp_train(self.lm_config(spec), spec)
        for spec in TP_STATES:
            with cell_seconds("[tp]", f"{spec['arch']} state"):
                self.tp_state(self.float32(self.lm_config(spec)), spec)
        for spec in TP_SERVE:
            cfg = self.lm_config(spec)
            with cell_seconds("[tp]", f"{spec['arch']} serve "
                              f"{'float32' if spec['float32'] else 'bf16'}"):
                self.tp_serve(self.float32(cfg) if spec["float32"] else cfg,
                              spec)
        shutil.rmtree(ROOT / "build" / "tp_ckpt", ignore_errors=True)
        log(f"[tp] phase in {time.perf_counter() - t0:.1f} s")

    def tp_sums(self, fn):
        """Run ``fn`` once, recording every sum over the model pieces it
        makes: -> (the sums as (kind, shape, dtype, pieces), fn's
        result)."""
        from repro_torch.launch import tensor_parallel as tp
        seen, record = [], tp.Group.record

        def spy(group, kind, t):
            seen.append((kind, tuple(t.shape), t.dtype, len(group)))
            record(group, kind, t)
        tp.Group.record = spy
        try:
            out = fn()
        finally:
            tp.Group.record = record
        return seen, out

    def tp_sum_busy(self, sums) -> str:
        """The device ms of a step's collectives over the model pieces,
        replayed: each all-reduce a sum of ``pieces`` tensors of its shape
        and dtype (``pieces - 1`` additions), each all-gather the
        concatenation of ``pieces`` blocks of its last dimension, all back
        to back behind a spin kernel and timed with CUDA events
        (:func:`device_ms`), all-reduces and all-gathers apart.  The
        profiler is not used here: on these replays it recorded a varying
        share of the additions, and in some runs none."""
        torch = self.torch
        bufs = {}
        for kind, shape, dtype, m in sums:
            part = shape if kind == "all-reduce" else \
                shape[:-1] + (shape[-1] // m,)
            if (part, dtype) not in bufs:
                bufs[part, dtype] = [torch.ones(part, dtype=dtype,
                                                device=self.dev)
                                     for _ in range(m)]
        calls = {"all-reduce": [], "all-gather": []}
        for kind, shape, dtype, m in sums:
            part = shape if kind == "all-reduce" else \
                shape[:-1] + (shape[-1] // m,)
            calls[kind].append((bufs[part, dtype], m))
        check(bool(calls["all-reduce"]), "no sum over the model pieces was "
              "recorded")

        def replay(kind):
            def run():          # as tensor_parallel.reduce_out / all_gather
                for parts, m in calls[kind]:
                    if kind == "all-reduce":
                        out = parts[0]
                        for p in parts[1:m]:
                            out = out + p
                    else:
                        torch.cat(parts[:m], dim=-1)
            return run
        notes = []
        for kind, what in (("all-reduce", "summed"),
                           ("all-gather", "gathered")):
            if not calls[kind]:
                continue
            ms = device_ms(replay(kind), reps=5, repeats=3)
            check(ms > 0, f"the {kind}s over the model pieces took {ms} ms")
            nbytes = sum(math.prod(parts[0].shape) * parts[0].element_size()
                         * (1 if kind == "all-reduce" else m)
                         for parts, m in calls[kind])
            notes.append(f"{kind} device time {ms:.4f} ms a step for "
                         f"{nbytes} B {what} ({len(calls[kind])} calls)")
        del bufs, calls
        torch.cuda.empty_cache()
        return "; ".join(notes) + " (replayed back to back, CUDA events)"

    def tp_checked(self, cfg, fn, run: str = "a step") -> dict:
        """Run ``fn`` with every row gather of the MoE layers and of the
        vocab pieces' lookup held bitwise to its plain version -> the
        first gather of each call site (the expert piece's dispatch and
        combine, the lookup) as ``{what: (src, ids)}``, and ``fn``'s
        result under ``"result"``; ``run`` names ``fn`` in the log."""
        RG = self.RG
        from repro_torch.models import layers as L
        from repro_torch.models import moe as MOE
        kept, calls = {}, [0]

        def site(names):
            seen = [0]

            def checked(src, ids, d_tile=512):
                got = RG.row_gather(src, ids, d_tile)
                self.held("row_gather", got, RG.row_gather_plain(src, ids),
                          f"{cfg.name} tp {names[0]} {tuple(ids.shape)} of "
                          f"{tuple(src.shape)}")
                if seen[0] < len(names):
                    kept[names[seen[0]]] = (src.detach(), ids)
                seen[0] += 1
                calls[0] += 1
                return got
            return checked
        MOE.row_gather = site(("expert piece dispatch",
                               "expert piece combine"))
        L.row_gather = site(("vocab piece lookup",))
        try:
            kept["result"] = fn()
        finally:
            MOE.row_gather, L.row_gather = RG.row_gather, RG.row_gather
        log(f"[tp] {cfg.name}: all {calls[0]} row gathers of {run} held "
            "bitwise to the plain version")
        return kept

    @staticmethod
    def tp_counted(collectives, steps: int = 1) -> str:
        return ", ".join(f"{k} {v['count'] // steps} ({v['bytes'] // steps}"
                         " B)" for k, v in collectives.items()
                         if v["count"])

    def tp_train(self, cfg, spec) -> None:
        """``Trainer.run()`` on a simulated ``(data, model)`` mesh with the
        default rules against the same steps on one device: losses
        finite (the dense model's last below its first), step 1's loss
        and grad norm at ``BF16_NORM_RULE``, the pieces' shapes those of
        the rules (a vocabulary the model axis does not divide whole), the
        row gathers counted (an MoE layer's 6 a piece and dispatch group,
        the lookup's one a piece); step ms,
        tokens/s, the counted collectives a step, the sums' device busy, a
        profiled step, peak memory and a device's bytes."""
        torch = self.torch
        from repro_torch.models import moe as MOE
        from repro_torch.train import loop
        d, m = spec["data"], spec["model"]
        tc = dataclasses.replace(self.train_config(spec), ckpt_dir=str(
            ROOT / "build" / "tp_ckpt" / spec["arch"]))
        # one device: the [train] cell of this call of the same model,
        # batch and seed (its step 1 has the same lr at any length), else
        # its first 2 steps here
        key = (cfg.name, cfg.num_layers, spec["batch"], spec["seq"])
        single, single_ms = self.train_readings[key] \
            if key in self.train_readings else \
            self.tp_one_device(cfg, spec, tc)
        source = "the [train] cell" if key in self.train_readings else \
            "2 steps in this phase"
        mesh, shd = self.dp_mesh(d, m)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        t0 = time.perf_counter()
        out = loop.Trainer(cfg, tc, mesh=mesh, rules=shd.rules).run()
        wall = time.perf_counter() - t0
        counts = self.read_counts()
        peak = torch.cuda.max_memory_allocated() - base
        metrics, dp = out["metrics"], out["data_parallel"]
        losses = [x["loss"] for x in metrics]
        check(len(losses) == spec["steps"] and all(np.isfinite(losses)),
              f"{cfg.name} tp: train losses {losses}")
        if cfg.family != "moe":
            check(losses[-1] < losses[0], f"{cfg.name} tp: the last loss "
                  f"{losses[-1]} is not below the first {losses[0]}")
        groups = MOE._group_count(spec["batch"] * spec["seq"],
                                  cfg.moe_group_size)
        per_step = 6 * m * groups * cfg.num_layers \
            if cfg.family == "moe" else 0
        if cfg.vocab_size % m == 0:     # each piece's lookup of its rows
            per_step += d * m
        check(counts["row_gather"] == per_step * spec["steps"],
              f"{cfg.name} tp: row_gather launched {counts['row_gather']} "
              f"times in {spec['steps']} steps, expected {per_step} a step")
        # the same step in float32 where no [train] cell matches: where one
        # device's own bf16 rounding passes BF16_NORM_RULE's bound from it
        wide = None if key in self.train_readings else \
            self.tp_one_device(self.float32(cfg), spec, tc, steps=1)[0][0]
        bad = self.tp_train_planted(cfg, spec, tc, shd) \
            if spec.get("planted") else None
        held, seen = [], []
        for key in ("loss", "grad_norm"):
            got, want = metrics[0][key], single[0][key]
            dense = abs(got - want) / (
                DENSE_RULE["atol"] * max(1.0, abs(want)) +
                DENSE_RULE["rtol"] * abs(want))
            note = (f"step 1 {key} {got!r} vs one device {want!r} "
                    f"({dense:.3f} of the dense rule's bound, ")
            if wide is not None and abs(want - wide[key]) > \
                    BF16_NORM_RULE["rtol"] * abs(wide[key]):
                d_tp, d_one = abs(got - wide[key]), abs(want - wide[key])
                check(d_tp <= TP_ROUNDING * d_one, f"{cfg.name} tp step 1 "
                      f"{key}: {got!r} lies {d_tp} from float32's "
                      f"{wide[key]!r}, past {TP_ROUNDING} x one device's "
                      f"{d_one}")
                note += (f"one device's bf16 rounding "
                         f"{d_one / abs(wide[key]):.3e} of float32's "
                         f"{wide[key]!r}, past the bf16 rule: the pieces "
                         f"{d_tp / d_one:.3f} of one device's distance, "
                         f"held at {TP_ROUNDING}")
                if bad is not None:
                    ratio = abs(bad[key] - wide[key]) / d_one
                    seen.append(ratio > TP_ROUNDING)
                    note += f"; the planted fault {ratio:.3f}"
            else:
                share = self.dense_rule(f"{cfg.name} tp step 1 {key}", got,
                                        want, BF16_NORM_RULE)
                note += f"{share:.3f} of the bf16 rule's"
                if bad is not None:
                    ratio = abs(bad[key] - want) / (
                        BF16_NORM_RULE["rtol"] * abs(want))
                    seen.append(ratio > 1.0)
                    note += f"; the planted fault {ratio:.3f} of it"
            held.append(note + ")")
        if bad is not None:
            check(spec["planted"] != True or any(seen),  # noqa: E712
                  f"{cfg.name} tp step 1 with the planted fault (piece 1's "
                  f"last-layer mixer output dropped) passes every bound: "
                  f"{', '.join(held)}")
            held.append("the planted fault (piece 1's block of the last "
                        "layer's mixer output projection zeroed) " + (
                            "must pass a bound" if spec["planted"] is True
                            else "read, not held: this cell checks that "
                            "the steps run, the float32 cells and the CPU "
                            "tests that the cut is right"))
        shapes = self.tp_piece_shapes(cfg, dp.models[0], m)
        nbytes = sum(t.pieces[0].numel() * t.pieces[0].element_size()
                     for t in sharded_leaves(dp.params))
        moments = sum(t.pieces[0].numel() * t.pieces[0].element_size()
                      for key in ("m", "v")
                      for t in sharded_leaves(out["opt"][key]))
        whole = sum(x.numel() * x.element_size() for x in
                    out["params"].parameters())
        tokens = spec["batch"] * spec["seq"]
        step_ms = statistics.median(x["step_time"] for x in metrics[1:]) \
            * 1e3
        log(f"[tp] {cfg.name} ({cfg.num_layers} layers) Trainer.run on a "
            f"simulated ({d}, {m}) mesh, default rules: {spec['steps']} "
            f"steps in {wall:.2f} s, losses {[round(x, 4) for x in losses]}"
            f" (one device, {source}: "
            f"{[round(x['loss'], 4) for x in single]}); "
            f"{', '.join(held)}; kernel launches "
            f"{ {n: c for n, c in counts.items() if c} } ({per_step} "
            f"row_gather a step); a piece's shapes {shapes}; collectives "
            f"counted a step: {self.tp_counted(dp.collectives, spec['steps'])}"
            f"; a device holds {nbytes} B of {whole} B of parameters and "
            f"{moments} B of moments")
        log(f"[time] {self.tag} {cfg.name} tp train ({d}, {m}) batch "
            f"{spec['batch']} seq {spec['seq']}: step {step_ms:.4f} ms "
            f"(median of steps 2-{spec['steps']}, host clock), "
            f"{tokens / step_ms * 1e3:.1f} tokens/s; one device "
            f"{single_ms:.4f} ms ({source}), "
            f"{tokens / single_ms * 1e3:.1f} tokens/s "
            f"({step_ms / single_ms:.3f}x); peak memory {peak} B (above "
            f"the {base} B held before)")
        if spec is TP_TRAIN[1]:
            self.tp_measure(f"bf16 {cfg.name}", cfg, spec, shd, dp,
                            out["opt"], tc.opt, {
                                c: {k: n // spec["steps"] for k, n in
                                    v.items()}
                                for c, v in dp.collectives.items()})
        step_fn = loop.make_train_step(cfg, tc.opt, shd=shd)
        state = [out["opt"]]
        batch = self.train_batch(cfg, spec, spec["steps"])
        with torch.no_grad():      # the whole weights gathered at the end
            for p in out["params"].parameters():
                p.data = p.data.new_empty(0)
        del out
        torch.cuda.empty_cache()

        def one_step():
            state[0], _ = step_fn(dp, state[0], batch)
        gathers = self.tp_checked(cfg, lambda: self.tp_sums(one_step))
        sums, _ = gathers.pop("result")
        log(f"[tp] {cfg.name} sums over the model pieces a step: "
            f"{self.tp_sum_busy(sums)}")
        for what, (src, ids) in gathers.items():
            self.lm_gather_time(cfg, f"tp {what}", src, ids)
        log_profile(self.tag, f"{cfg.name} tp train step (({d}, {m}) "
                    f"simulated, batch {spec['batch']}, seq {spec['seq']})",
                    one_step, reps=1, warm=True)
        del state, dp
        gc.collect()
        torch.cuda.empty_cache()

    def tp_measure(self, name, cfg, spec, shd, dp, state, opt,
                   counted) -> None:
        """For ``[dryrun]``: a ``[tp]`` cell's one step's counted
        collectives, the bytes device 0 holds of a step's arguments, and
        the flops of one more step under ``FlopCounterMode`` on the card
        (the whole simulated mesh's)."""
        torch = self.torch
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.launch import dryrun as dr
        from repro_torch.launch import sharding as sh
        from repro_torch.train import loop
        batch = self.train_batch(cfg, spec, spec["steps"])
        pl = sh.batch_sharding(shd, batch)
        held = dr.held_bytes(dp.tree(), state,
                             {k: pl[k].split(v) for k, v in batch.items()})
        step_fn = loop.make_train_step(cfg, opt, shd=shd)
        with FlopCounterMode(display=False) as fc:
            step_fn(dp, state, batch)
        torch.cuda.synchronize()
        self.tp_measured[name] = dict(
            cfg=cfg, spec=spec, mesh=shd.mesh, rules=shd.rules, opt=opt,
            counted=counted, held=held, flops=fc.get_total_flops())

    def tp_q8_phase(self) -> None:
        """8-bit AdamW moments over model pieces (see the module
        docstring, phase 17)."""
        t0 = time.perf_counter()
        self.tp_q8_state(self.float32(self.lm_config(TP_Q8_STATE)),
                         TP_Q8_STATE)
        self.tp_q8_train(self.lm_config(TP_Q8_TRAIN), TP_Q8_TRAIN)
        log(f"[tp] 8-bit phase in {time.perf_counter() - t0:.1f} s")

    @staticmethod
    def moment_bytes(opt_state) -> int:
        """The bytes of AdamW moments device 0 holds."""
        return sum(t.pieces[0].numel() * t.pieces[0].element_size()
                   for key in ("m", "v")
                   for t in sharded_leaves(opt_state[key]))

    def tp_q8_state(self, cfg, spec) -> None:
        """float32, 8-bit moments on a simulated ``(data, model)`` mesh,
        unclipped: each step's new weights and ``q`` / ``s`` bitwise one
        device's 8-bit ``adamw.update`` from the same weights and moments
        on the gradients the step assembled, and every model replica's
        ``q`` / ``s`` bitwise alike."""
        torch = self.torch
        from repro_torch.models import lm
        from repro_torch.models import params as pr
        from repro_torch.optim import adamw
        from repro_torch.train import loop
        d, m = spec["data"], spec["model"]
        oc = adamw.AdamWConfig(lr=3e-3, warmup_steps=1,
                               total_steps=spec["steps"], clip_norm=1e9,
                               quantize_moments=True)
        mesh, shd = self.dp_mesh(d, m)
        gen = torch.Generator(self.dev).manual_seed(SEED)
        dp = loop.DataParallel(lm.init_model(cfg, generator=gen,
                                             device=self.dev), shd)
        state = adamw.init(dp.tree(), oc, shd=shd)
        step_fn = loop.make_train_step(cfg, oc, shd=shd)
        seen, update = {}, adamw.update

        def spy(params, grads, st, c):
            seen["grads"] = pr.stacked_map(
                lambda g: g.join().reshape(-1), grads)
            return update(params, grads, st, c)

        def per_layer(g, leaf):
            """A flat stacked gradient as the leaf's per-layer tensors."""
            shape = pr.stacked_shape(leaf)
            t = g[:math.prod(shape)].reshape(shape)
            return [t[i] for i in range(shape[0])] \
                if isinstance(leaf, list) else t

        def joined(tree):
            return pr.tree_map(lambda x: x.join(), tree)
        apart, n_el, t0 = 0, 0, time.perf_counter()
        for i in range(spec["steps"]):
            before = joined(dp.tree())
            st1 = {"step": state["step"].clone(),
                   **{k: pr.stacked_map(lambda x: x.join(), state[k])
                      for k in ("m", "v")}}
            dp.reset_collectives()
            adamw.update = spy
            try:
                state, _ = step_fn(dp, state, self.train_batch(cfg, spec, i))
            finally:
                adamw.update = update
            counted = {c: dict(v) for c, v in dp.collectives.items()}
            stacked = pr.stacked_map(per_layer, seen.pop("grads"),
                                     pr.stack_tree(before))
            grads = {k: ([pr.stacked_map(lambda x, i=i: x[i], v)
                          for i in range(cfg.num_layers)]
                         if k == "layers" else v)
                     for k, v in stacked.items()}
            st1, _ = update(before, grads, st1, oc)
            for a, b in zip(sharded_leaves(joined(dp.tree())),
                            sharded_leaves(before)):
                apart += int((a != b).sum())
                n_el += a.numel()
            for key in ("m", "v"):
                for x, want in zip(sharded_leaves(state[key]),
                                   sharded_leaves(st1[key])):
                    apart += int((x.join() != want).sum())
                    n_el += want.numel()
                    for n, piece in enumerate(x.pieces):
                        apart += int((piece != x.pieces[n - n % m]).sum())
        check(apart == 0, f"{cfg.name} tp 8-bit: {apart} of {n_el} weight "
              f"and moment elements part from one device's 8-bit update "
              f"on the same gradients, or between model replicas")
        log(f"[tp] {cfg.name} ({cfg.num_layers} layers, float32) 8-bit "
            f"moments on a simulated ({d}, {m}) mesh, {spec['steps']} "
            f"steps in {time.perf_counter() - t0:.2f} s (unclipped): each "
            f"step's weights and q / s bitwise one device's 8-bit update "
            f"from the same state on the gradients the step assembled "
            f"({n_el} elements), every model replica's q / s bitwise "
            f"alike; a device holds {self.moment_bytes(state)} B of "
            f"moments; collectives counted a step: "
            f"{self.tp_counted(counted)}")
        self.tp_measure("8-bit granite", cfg, spec, shd, dp, state, oc,
                        counted)
        del dp, state, st1, before, grads
        gc.collect()
        torch.cuda.empty_cache()

    def tp_q8_train(self, cfg, spec) -> None:
        """bf16, 8-bit moments: ``Trainer.run()`` on a simulated ``(data,
        model)`` mesh, every row gather of the run held bitwise to the
        plain version and counted (the expert pieces' 6 a piece and
        dispatch group, the vocab pieces' lookup), losses finite."""
        torch = self.torch
        from repro_torch.models import moe as MOE
        from repro_torch.train import loop
        d, m = spec["data"], spec["model"]
        tc = self.train_config(spec)
        tc = dataclasses.replace(tc, ckpt_dir=str(
            ROOT / "build" / "tp_ckpt" / spec["arch"]),
            opt=dataclasses.replace(tc.opt, quantize_moments=True))
        mesh, shd = self.dp_mesh(d, m)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        t0 = time.perf_counter()
        out = self.tp_checked(cfg, lambda: loop.Trainer(
            cfg, tc, mesh=mesh, rules=shd.rules).run(),
            "the 8-bit run")["result"]
        wall = time.perf_counter() - t0
        counts = self.read_counts()
        peak = torch.cuda.max_memory_allocated() - base
        losses = [x["loss"] for x in out["metrics"]]
        check(len(losses) == spec["steps"] and all(np.isfinite(losses)),
              f"{cfg.name} tp 8-bit: train losses {losses}")
        groups = MOE._group_count(spec["batch"] * spec["seq"],
                                  cfg.moe_group_size)
        per_step = 6 * m * groups * cfg.num_layers + (
            d * m if cfg.vocab_size % m == 0 else 0)
        check(counts["row_gather"] == per_step * spec["steps"],
              f"{cfg.name} tp 8-bit: row_gather launched "
              f"{counts['row_gather']} times in {spec['steps']} steps, "
              f"expected {per_step} a step")
        step_ms = statistics.median(
            x["step_time"] for x in out["metrics"][1:]) * 1e3
        log(f"[tp] {cfg.name} ({cfg.num_layers} layers) Trainer.run with "
            f"8-bit moments on a simulated ({d}, {m}) mesh: {spec['steps']} "
            f"steps in {wall:.2f} s, losses {[round(x, 4) for x in losses]}"
            f"; kernel launches { {n: c for n, c in counts.items() if c} } "
            f"({per_step} row_gather a step); a device holds "
            f"{self.moment_bytes(out['opt'])} B of moments; collectives "
            f"counted a step: "
            f"{self.tp_counted(out['data_parallel'].collectives, spec['steps'])}")
        log(f"[time] {self.tag} {cfg.name} tp train 8-bit ({d}, {m}) batch "
            f"{spec['batch']} seq {spec['seq']}: step {step_ms:.4f} ms "
            f"(median of steps 2-{spec['steps']}, host clock); peak memory "
            f"{peak} B (above the {base} B held before)")
        del out
        gc.collect()
        torch.cuda.empty_cache()

    def tp_one_device(self, cfg, spec, tc, steps: int = 2):
        """The Trainer's first ``steps`` steps on one device (its seed,
        schedule and batches) -> (their metrics, the last step's ms, host
        clock to the metrics read back)."""
        torch = self.torch
        from repro_torch.models import lm
        from repro_torch.optim import adamw
        from repro_torch.train import loop
        gen = torch.Generator(self.dev).manual_seed(tc.seed)
        model = lm.init_model(cfg, generator=gen, device=self.dev)
        step_fn = loop.make_train_step(cfg, tc.opt)
        state = adamw.init(model.tree(), tc.opt)
        out, ms = [], 0.0
        for i in range(steps):
            batch = self.train_batch(cfg, spec, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(model, state, batch)
            out.append({k: float(v) for k, v in metrics.items()})
            ms = (time.perf_counter() - t0) * 1e3
        del model, state
        torch.cuda.empty_cache()
        return out, ms

    def tp_piece_shapes(self, cfg, piece, m: int) -> dict:
        """A model piece's shapes of the leaves the rules cut over ``m``
        pieces (a dimension ``m`` does not divide whole in every piece),
        checked -> {leaf: shape}."""
        d, layer = cfg.d_model, piece["layers"][0]

        def cut(n):
            return n // m if n % m == 0 else n
        got = {"embed": piece["embed"]}
        want = {"embed": (cut(cfg.vocab_size), d)}
        if cfg.family == "ssm":
            got.update(wr=layer["time_mix"]["wr"],
                       ffn_wk=layer["channel_mix"]["wk"])
            want.update(wr=(d, cut(d)), ffn_wk=(d, cut(cfg.d_ff)))
        elif cfg.family == "hybrid":
            mb = layer["mamba"]
            width = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
            got.update(in_proj=mb["in_proj"], conv_w=mb["conv_w"],
                       a_log=mb["a_log"], out_proj=mb["out_proj"])
            want.update(in_proj=(d, cut(width)),
                        conv_w=(mb["conv_w"].shape[0],
                                cut(cfg.d_inner + 2 * cfg.ssm_state)),
                        a_log=(cut(cfg.ssm_heads),),
                        out_proj=(cut(cfg.d_inner), d))
        else:
            attn = layer["self_attn" if cfg.family == "encdec" else "attn"]
            got.update(wq=attn["wq"], wk=attn["wk"])
            want.update(wq=(d, cut(cfg.num_heads), cfg.head_dim),
                        wk=(d, cut(cfg.num_kv_heads), cfg.head_dim))
            if cfg.family == "moe":
                got["w_up"] = layer["moe"]["w_up"]
                want["w_up"] = (cut(cfg.num_experts),) + tuple(
                    layer["moe"]["w_up"].shape[1:])
            else:
                got["w_gate"] = layer["mlp"]["w_gate"]
                want["w_gate"] = (d, cut(cfg.d_ff))
            if cfg.family == "encdec":
                got["cross_wk"] = layer["cross_attn"]["wk"]
                want["cross_wk"] = want["wk"]
        shapes = {k: tuple(v.shape) for k, v in got.items()}
        check(shapes == want, f"{cfg.name} tp: a piece's shapes {shapes}, "
              f"the rules' {want}")
        return shapes

    def tp_state(self, cfg, spec) -> None:
        """float32: the state after step 1 on a simulated ``(data,
        model)`` mesh against one device on the same rows as ``data``
        microbatches, from the same start: both moments of every leaf at
        the dense rule of its scale, every weight as AdamW's first step on
        its own run's moments (and how many part from one device's past
        the dense rule, printed), step 1's loss and grad norm at the dense
        rule."""
        d, m = spec["data"], spec["model"]
        o = self.train_config(spec).opt
        r = self.tp_state_numbers(cfg, spec)
        past, total, worst, adam_worst = r["past"], r["total"], \
            r["worst"], r["adam_worst"]
        omet, tmet = r["one"], r["pieces"]
        parted, flips, g_max = r["parted"], r["flips"], r["g_max"]
        check(past == 0, f"{cfg.name} tp state: {past} of {total} moment "
              f"elements and weights past the dense rule (moments vs one "
              f"device on {d} microbatches, worst {worst:.3e} of a leaf's "
              f"scale; weights vs AdamW's step on their own moments, worst "
              f"{adam_worst:.3e})")
        shares = [self.dense_rule(f"{cfg.name} tp state step 1 {key}",
                                  tmet[key], omet[key])
                  for key in ("loss", "grad_norm")]
        log(f"[tp] {cfg.name} ({cfg.num_layers} layers, float32) the state "
            f"after step 1 on a simulated ({d}, {m}) mesh vs one device on "
            f"the same rows as {d} microbatches: every moment within the "
            f"dense rule of its leaf's scale (worst {worst:.3e} of it), "
            f"every weight AdamW's first step on its own moments (worst "
            f"{adam_worst:.3e}); {parted} of the weights part from one "
            f"device's past the dense rule, {flips} of them where the "
            f"step's gradient changes sign, the rest with |g| <= "
            f"{g_max:.3e} ({g_max / o.eps:.1f} eps: AdamW's step "
            f"lr g / (|g| + eps) is steep there); "
            f"loss {tmet['loss']!r} vs {omet['loss']!r}, grad norm "
            f"{tmet['grad_norm']!r} vs {omet['grad_norm']!r} "
            f"({max(shares):.3f} of the dense rule's bound at most); "
            f"collectives counted: {r['counted']}")
        gc.collect()
        self.torch.cuda.empty_cache()

    def tp_state_numbers(self, cfg, spec) -> dict:
        """:meth:`tp_state`'s two runs and their comparison (every tensor
        freed on return) -> its numbers."""
        torch = self.torch
        from repro_torch.launch import sharding as sh
        from repro_torch.models import lm
        from repro_torch.models import params as pr
        from repro_torch.optim import adamw
        from repro_torch.train import loop
        d, m = spec["data"], spec["model"]
        tc = self.train_config(spec)
        mesh, shd = self.dp_mesh(d, m)
        batch = self.train_batch(cfg, spec, 0)


        def flat(tree) -> dict:
            """Every leaf of a stacked tree (``Sharded`` pieces joined) as
            one flat float64 tensor, by path (no recursive closure: its
            cycle would keep the tensors alive until a collection)."""
            out, todo = {}, [("", tree)]
            while todo:
                path, t = todo.pop()
                if isinstance(t, dict):
                    todo.extend((f"{path}/{k}", v) for k, v in t.items())
                    continue
                parts = t if isinstance(t, list) else [t]
                out[path] = torch.cat([
                    (x.join() if isinstance(x, sh.Sharded) else x)
                    .detach().reshape(-1).to(torch.float64) for x in parts])
            return out

        def init():
            gen = torch.Generator(self.dev).manual_seed(tc.seed)
            return lm.init_model(cfg, generator=gen, device=self.dev)
        w0 = flat(pr.stack_tree(init().tree()))
        runs = {}
        for name, s, micro in ((f"one device, {d} microbatches", None, d),
                               ("pieces", shd, 1)):
            holder = init() if s is None else loop.DataParallel(init(), s)
            state = adamw.init(holder.tree(), tc.opt)
            state, metrics = loop.make_train_step(
                cfg, tc.opt, shd=s, microbatches=micro)(holder, state,
                                                        batch)
            runs[name] = ({key: flat(state[key]) for key in ("m", "v")},
                          flat(pr.stack_tree(holder.tree())),
                          {k: float(v) for k, v in metrics.items()},
                          holder, state)
        (om, ow, omet, _, _), (tm, tw, tmet, dp, tstate) = runs.values()
        counted = {c: dict(v) for c, v in dp.collectives.items()}
        o = tc.opt
        lr = float(adamw.schedule(o, 1))
        worst, past, parted, total = 0.0, 0, 0, 0
        for kind in ("m", "v"):
            for path, x in om[kind].items():
                y = tm[kind][path]
                scale = max(float(x.abs().max()), 1.0)
                err = (y - x).abs()
                past += int((err > DENSE_RULE["atol"] * scale +
                             DENSE_RULE["rtol"] * x.abs()).sum())
                worst = max(worst, float(err.max()) / scale)
                total += x.numel()
        adam_worst, flips, g_max = 0.0, 0, 0.0
        for path, w in w0.items():
            want = w - lr * ((tm["m"][path] / (1 - o.b1)) / (
                torch.sqrt(tm["v"][path] / (1 - o.b2)) + o.eps) +
                o.weight_decay * w)
            scale = max(float(want.abs().max()), 1.0)
            err = (tw[path] - want).abs()
            past += int((err > DENSE_RULE["atol"] * scale +
                         DENSE_RULE["rtol"] * want.abs()).sum())
            adam_worst = max(adam_worst, float(err.max()) / scale)
            x = ow[path]
            apart = (tw[path] - x).abs() > DENSE_RULE["atol"] * \
                max(float(x.abs().max()), 1.0) + DENSE_RULE["rtol"] * x.abs()
            parted += int(apart.sum())
            flips += int((apart & (tm["m"][path] * om["m"][path] <= 0))
                         .sum())
            g = torch.minimum(tm["m"][path].abs(), om["m"][path].abs())[
                apart] / (1 - o.b1)
            if g.numel():
                g_max = max(g_max, float(g.max()))
            total += w.numel()
        if spec is TP_STATES[0]:
            self.tp_measure("float32 granite", cfg, spec, shd, dp, tstate,
                            tc.opt, counted)
        return dict(past=past, total=total, worst=worst,
                    adam_worst=adam_worst, parted=parted, flips=flips,
                    g_max=g_max, one=omet, pieces=tmet,
                    counted=self.tp_counted(counted))

    def tp_serve(self, cfg, spec) -> None:
        """``engine.generate`` over ``ModelPieces`` on a simulated (1,
        model) mesh against one device in the same call (whisper's frames
        and paligemma's patch prefix drawn as the launcher draws them),
        every row gather of the pieces' lookup counted (one a piece in the
        prefill and in each decode step) and held bitwise to its plain
        version: float32, the tokens equal and the prefill's and first
        decode step's logits at ``LM_TOL`` (zamba2 at
        ``HYBRID_DECODE_TOL``; paligemma, whose float32 rounding alone
        passes ``LM_TOL``, no farther from the same weights in float64
        than ``VLM_ROUNDING`` times one device's); bf16, at least
        ``TP_TOKENS_MIN`` of the greedy tokens equal (where ``tokens``
        holds them), those logits' distance printed, and the logits held
        against the same weights in float32 (:meth:`tp_rounding`, with
        the planted fault's logits beside them where ``planted``: with
        ``planted=True`` they must fail the same bound); the pieces'
        shapes those of the rules;
        decode ms a step and tokens/s beside one device's, the collectives
        a decode step, their device time, a profiled decode step, peak
        memory and a piece's bytes."""
        torch = self.torch
        from repro_torch.launch import tensor_parallel as tp
        from repro_torch.models import lm
        from repro_torch.serve import engine
        b, s, steps, m = spec["batch"], spec["prompt"], spec["steps"], \
            spec["model"]
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model, gen = self.lm_model(cfg)
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                               device=self.dev, dtype=torch.int32)
        batch = self.lm_batch(cfg, tokens, gen)
        pl = lm.prefix_slots(cfg)
        pos, max_len = pl + s, pl + s + steps + 4
        mesh, shd = self.dp_mesh(1, m)
        mp = tp.ModelPieces(model, shd)

        def serve():
            with torch.inference_mode():
                want, _ = engine.generate(model, cfg, batch, steps, max_len)
                got, _ = engine.generate(mp, cfg, batch, steps, max_len)
                cache1, last1 = engine.prefill(model, cfg, batch, max_len)
                cache2, last2 = engine.prefill(mp, cfg, batch, max_len)
                tok = want[:, :1]
                dec1, _ = lm.decode_step(model, cfg, cache1, tok, pos, pl)
                mp.reset_collectives()
                dec2, _ = lm.decode_step(mp, cfg, cache2, tok, pos, pl)
            return want, got, tok, last1, last2, dec1, dec2
        self.zero_counts()
        gathers = self.tp_checked(cfg, serve, "the serving run")
        counts = self.read_counts()
        want, got, tok, last1, last2, dec1, dec2 = gathers.pop("result")
        same = float((want == got).float().mean())
        counted = self.tp_counted(mp.collectives)
        # the two generate calls' prefill and decode steps, one prefill
        # and one decode step more: a lookup a piece in each
        lookups = m * (steps + 2) if cfg.vocab_size % m == 0 else 0
        check(counts["row_gather"] == lookups, f"{cfg.name} tp serve: "
              f"row_gather launched {counts['row_gather']} times, expected "
              f"{lookups} ({m} a prefill or decode step over the pieces)")
        for what, (src, ids) in gathers.items():
            self.lm_gather_time(cfg, f"tp {what} (prefill)", src, ids)
        del gathers
        logits = {"prefill": (last2.float().cpu().numpy(),
                              last1.float().cpu().numpy()),
                  "first decode step": (dec2.float().cpu().numpy(),
                                        dec1.float().cpu().numpy())}
        del last1, last2, dec1, dec2
        rule = HYBRID_DECODE_TOL if cfg.family == "hybrid" else LM_TOL
        held = spec["float32"] and cfg.family != "vlm"
        errs = []
        for what, (x, y) in logits.items():
            err, ratio, ok = tol_ratio(x, y, rule)
            check(ok or not held, f"{cfg.name} tp serve: the {what}'s "
                  f"logits differ from one device's (max abs err {err}, "
                  f"{ratio:.3f} of the bound)")
            errs.append(f"{what} {err:.3e} ({ratio:.3f} of the bound)")
        least = 1.0 if spec["float32"] else TP_TOKENS_MIN
        tokens_held = spec.get("tokens", True)
        check(same >= least or not tokens_held, f"{cfg.name} tp serve: "
              f"{same:.4f} of the greedy tokens equal one device's, below "
              f"{least}")
        piece = mp.groups[0].trees[0]
        shapes = self.tp_piece_shapes(cfg, piece, m)
        nbytes = sum(t.numel() * t.element_size()
                     for t in sharded_leaves(piece))
        held_at = f"held at {least}" if tokens_held else (
            "not held: bf16 rounding, not the model, picks these tokens; "
            "the float32 cell holds them equal")
        log(f"[tp] {cfg.name} ({cfg.num_layers} layers, "
            f"{str(cfg.param_dtype)[6:]}) generate over ModelPieces on a "
            f"simulated (1, {m}) mesh (batch {b}, prompt {s}"
            f"{f' after {pl} patch tokens' if pl else ''}, {steps} greedy "
            f"steps): {same:.4f} of the tokens equal one device's ("
            f"{held_at}); logits vs one device's at rtol "
            f"{rule['rtol']}, atol {rule['atol']}{'' if held else ' (read)'}: {', '.join(errs)};"
            f" a piece's shapes {shapes}, {nbytes} B; collectives a decode "
            f"step: {counted}")
        peak = torch.cuda.max_memory_allocated() - base
        timed = {}
        with torch.inference_mode():
            # one prefill and 3 decode steps, no warm-up: the checked
            # serving run above warmed every path
            for name, p in (("one device", model), ("pieces", mp)):
                prefill_ms = host_ms(lambda: engine.prefill(
                    p, cfg, batch, max_len), 0, 1)
                cache, _ = engine.prefill(p, cfg, batch, max_len)
                decode_ms = host_ms(lambda: lm.decode_step(
                    p, cfg, cache, tok, pos, pl), 0, 3)
                timed[name] = (prefill_ms, decode_ms, b / decode_ms * 1e3)
                del cache
        (p1, d1, t1), (p2, d2, t2) = timed.values()
        log(f"[time] {self.tag} {cfg.name} tp serve (1, {m}) batch {b} "
            f"prompt {s}: prefill {p2:.4f} ms, decode {d2:.4f} ms a step "
            f"(a decode step at position {pos}, median of 3), "
            f"{t2:.1f} tokens/s; one device prefill {p1:.4f} ms, decode "
            f"{d1:.4f} ms a step, {t1:.1f} tokens/s ({d2 / d1:.3f}x a "
            f"decode step); peak memory {peak} B (above the {base} B held "
            f"before, the model and its pieces)")
        with torch.inference_mode():
            cache, _ = engine.prefill(mp, cfg, batch, max_len)
            sums, _ = self.tp_sums(lambda: lm.decode_step(
                mp, cfg, cache, tok, pos, pl))
            log(f"[tp] {cfg.name} collectives over the model pieces a "
                f"decode step: {self.tp_sum_busy(sums)}")
            log_profile(self.tag, f"{cfg.name} tp decode step ((1, {m}) "
                        f"simulated, batch {b})",
                        lambda: lm.decode_step(mp, cfg, cache, tok, pos, pl),
                        reps=1, warm=True)
        planted = self.tp_planted(mp, cfg, batch, max_len, tok) \
            if spec.get("planted") else None
        del mp, cache
        torch.cuda.empty_cache()
        if not spec["float32"]:
            self.tp_rounding(model, cfg, batch, max_len, tok, logits,
                             torch.float32, TP_ROUNDING, planted,
                             spec.get("planted") is True,
                             None if tokens_held else (want, got, steps))
        elif cfg.family == "vlm":
            self.tp_rounding(model, cfg, batch, max_len, tok, logits,
                             torch.float64, VLM_ROUNDING)
        del model
        gc.collect()
        torch.cuda.empty_cache()

    @staticmethod
    def planted_leaf(tree, cfg):
        """The leaf of a piece's parameter ``tree`` that the planted fault
        zeroes: its last layer's mixer output projection
        (``PLANTED_LEAF``)."""
        mixer, name = PLANTED_LEAF[cfg.family]
        return tree["layers"][-1][mixer][name]

    def tp_planted(self, mp, cfg, batch, max_len, tok) -> dict:
        """The prefill's and first decode step's logits over the pieces
        with the planted fault: piece 1's block of the last layer's mixer
        output projection zeroed (so its share of that layer's sum is
        dropped), then restored."""
        torch = self.torch
        from repro_torch.models import lm
        from repro_torch.serve import engine
        leaf = self.planted_leaf(mp.groups[0].trees[1], cfg)
        saved = leaf.clone()
        pl = lm.prefix_slots(cfg)
        try:
            with torch.no_grad():
                leaf.zero_()
            with torch.inference_mode():
                cache, last = engine.prefill(mp, cfg, batch, max_len)
                dec, _ = lm.decode_step(mp, cfg, cache, tok,
                                        pl + batch["tokens"].shape[1], pl)
        finally:
            with torch.no_grad():
                leaf.copy_(saved)
        return {"prefill": last.float().cpu().numpy(),
                "first decode step": dec.float().cpu().numpy()}

    def tp_train_planted(self, cfg, spec, tc, shd) -> dict:
        """Step 1 of the Trainer's run (its seed and first batch) over the
        pieces with the planted fault (piece 1's block of the last
        layer's mixer output projection zeroed) -> its metrics."""
        torch = self.torch
        from repro_torch.models import lm
        from repro_torch.optim import adamw
        from repro_torch.train import loop
        gen = torch.Generator(self.dev).manual_seed(tc.seed)
        model = lm.init_model(cfg, generator=gen, device=self.dev)
        dp = loop.DataParallel(model, shd)
        with torch.no_grad():
            self.planted_leaf(dp.params, cfg).pieces[1].zero_()
        state = adamw.init(dp.tree(), tc.opt, shd=shd)
        step_fn = loop.make_train_step(cfg, tc.opt, shd=shd)
        _, metrics = step_fn(dp, state, self.train_batch(cfg, spec, 0))
        out = {k: float(v) for k, v in metrics.items()}
        del model, dp, state
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def tp_rounding(self, model, cfg, batch, max_len, tok, logits, dtype,
                    factor: float, planted=None, must_break: bool = False,
                    tokens=None) -> None:
        """The logits over the pieces against the same weights in the wider
        ``dtype`` (the model converted in place): each no farther from
        them than ``factor`` times one device's logits are; those of
        :meth:`tp_planted`, where given, printed beside them and, with
        ``must_break``, held farther.  With ``tokens`` (one device's and
        the pieces' greedy tokens, and their steps) the share of each
        equal to the wider dtype's greedy tokens is printed."""
        torch = self.torch
        from repro_torch.models import lm
        from repro_torch.serve import engine
        wide = cfg.replace(param_dtype=dtype, compute_dtype=dtype)
        with torch.no_grad():
            for p in model.parameters():
                p.data = p.data.to(dtype)
        pl = lm.prefix_slots(cfg)
        with torch.inference_mode():
            cache, last = engine.prefill(model, wide, batch, max_len)
            dec, _ = lm.decode_step(model, wide, cache, tok,
                                    pl + batch["tokens"].shape[1], pl)
            if tokens is not None:
                one, pieces, steps = tokens
                ref, _ = engine.generate(model, wide, batch, steps, max_len)
                a_one = float((one == ref).float().mean())
                a_tp = float((pieces == ref).float().mean())
                log(f"[tp] {cfg.name} greedy tokens equal to the same "
                    f"weights' {str(dtype)[6:]} tokens: over the pieces "
                    f"{a_tp:.4f}, one device {a_one:.4f} (read, not held: "
                    f"bf16 rounding picks them)")
        notes = []
        narrow = str(cfg.param_dtype)[6:]
        for what, ref in (("prefill", last), ("first decode step", dec)):
            ref = ref.double().cpu().numpy()
            x, y = logits[what]
            d_tp, d_one = (float(np.abs(z - ref).max()) for z in (x, y))
            check(d_tp <= factor * d_one, f"{cfg.name} tp serve: the "
                  f"{what}'s {narrow} logits over the pieces lie {d_tp} from "
                  f"{str(dtype)[6:]}, past {factor} x one device's {d_one}")
            note = ""
            if planted is not None:
                d_bad = float(np.abs(planted[what] - ref).max())
                check(d_bad > factor * d_one or not must_break,
                      f"{cfg.name} tp serve: with "
                      f"the planted fault the {what}'s logits lie {d_bad} "
                      f"from {str(dtype)[6:]}, within {factor} x one "
                      f"device's {d_one}: the bound cannot see it")
                note = f", the planted fault {d_bad / d_one:.3f}"
            notes.append(f"{what} {d_tp:.4g} vs one device's {d_one:.4g} "
                         f"({d_tp / d_one:.3f} of it{note}; logits' scale "
                         f"{float(np.abs(ref).max()):.1f})")
        fault = "" if planted is None else (
            ", the planted fault (piece 1's share of the last layer's "
            "mixer output dropped) " + ("past it" if must_break else
                                        "read, not held: within bf16 "
                                        "rounding's reach, this cell checks "
                                        "that serving runs and its float32 "
                                        "cell that the cut is right"))
        log(f"[tp] {cfg.name} {narrow} logits' largest distance from the "
            f"same weights in {str(dtype)[6:]}: over the pieces "
            f"{', '.join(notes)}; held at {factor} x one device's{fault}")
        del cache

    # ------------------------------------------------------- graph apps
    def graph_phase(self) -> None:
        """The four graph apps on the soc-Pokec analogue (see the module
        docstring, phase 7): the graph and the four plans are made while
        the second share of the card tests (started by ``[dryrun]``)
        runs, which is joined before anything is timed."""
        from scipy.sparse import csr_matrix
        t0 = time.perf_counter()
        c = self.G.graph_case(GRAPH["kind"], GRAPH["n"],
                              avg_deg=GRAPH["avg_deg"])
        log(f"[graph] soc-Pokec analogue: {c.num_nodes} nodes, "
            f"{c.num_edges} edges; generate {time.perf_counter() - t0:.2f} s "
            f"({BESIDE_TESTS})")
        n = c.num_nodes
        adj = csr_matrix((np.ones(c.num_edges), (c.src, c.dst)),
                         shape=(n, n))
        # the GRAPH_S nodes of most out-edges (run() starts at the first)
        sources = np.argsort(-np.bincount(c.src, minlength=n),
                             kind="stable")[:GRAPH_S]
        apps = {"bfs": (self.graphs.BFS, (c.src, c.dst, n), {}),
                "sssp": (self.graphs.SSSP, (c.src, c.dst, c.weight, n),
                         {"weight": np.asarray(c.weight, np.float32)}),
                "cc": (self.graphs.ConnectedComponents, (c.src, c.dst, n),
                       {}),
                "pagerank": (self.PageRank, (c.src, c.dst, n), {})}
        built = {}
        for name, (cls, edges, static) in apps.items():
            t1 = time.perf_counter()
            built[name] = (cls.from_edges(
                *edges, lane_width=128, backend="cuda", fused=True,
                device=self.dev), time.perf_counter() - t1, static)
        self.join_card_tests()
        self.graph_apps, self.graph_results = {}, {}
        for name, (app, build_s, static) in built.items():
            self.graph_app(name, app, build_s, static, c, adj, sources)
        self.graph = (c, adj, sources)

    def graph_app(self, name, app, build_s, static, c, adj, sources) -> None:
        torch, ir = self.torch, self.ir
        plan = app.plan
        fb = sum(k.num_blocks for k in plan.classes if k.ls_flag == 0)
        torch_app = dataclasses.replace(app, _run=self.eng.make_executor(
            plan, static, backend="torch", fused=True, device=self.dev))
        kernels = {"unroll_spmv.dense_slice" if la.gather == ir.COALESCED
                   else "unroll_spmv.window"
                   for la in app._run.tree.launches
                   if la.gather != ir.FALLBACK}
        log(f"[graph] {name}: {plan.nnz} edges in {plan.num_blocks} blocks, "
            f"fallback share {fb / max(plan.num_blocks, 1):.4f}, "
            f"{len(app._run.tree.launches)} launches per sweep; from_edges "
            f"(validation, build_plan, staging) {build_s:.2f} s "
            f"({BESIDE_TESTS})")
        pagerank = name == "pagerank"

        def run(a, driver):
            a.driver = driver
            if pagerank:
                return a.run(iters=PAGERANK_ITERS), None
            out = a.run() if name == "cc" else a.run(int(sources[0]))
            return out, a.convergence

        results = {}
        for backend, a in (("cuda", app), ("torch", torch_app)):
            for driver in ("resident", "host"):
                if backend == "torch" and driver == "host":
                    continue
                self.zero_counts()
                out, report = run(a, driver)
                counts = self.read_counts()
                if backend == "cuda":
                    for k in kernels:
                        check(counts[k] > 0, f"{name} {driver}: {k} named "
                              "by the lowering but never launched")
                results[backend, driver] = (out, report, counts)
        out, report, counts = results["cuda", "resident"]
        for key, (o, r, _) in results.items():
            check(same_bits(o, out) and r == report, f"{name}: {key} "
                  "differs from the cuda resident run")
        self.graph_oracle(name, out.cpu().numpy(), c, adj, sources[0])
        launched = {k: v for k, v in counts.items() if v}
        sweeps = PAGERANK_ITERS if pagerank else report.sweeps
        log(f"[graph] {name}: {report or f'{PAGERANK_ITERS} iterations'}; "
            f"kernel launches {launched} per run; cuda == torch backend "
            "bitwise, resident == host bitwise, oracle held")
        if name in ("bfs", "sssp"):
            self.graph_multi(name, app, torch_app, sources)
        # for [serve] and [shard]
        self.graph_apps[name] = (app, torch_app, static)
        self.graph_results[name] = results["torch", "resident"][:2]
        e2e = {}
        for driver in ("resident", "host"):
            app.driver = driver
            e2e[driver] = host_ms(lambda: run(app, driver), warmup=1, reps=3)
        state = out if not pagerank else torch.full(
            (app.num_nodes,), 1.0 / app.num_nodes, device=self.dev)
        sweep_ms = device_ms(
            (lambda: app._step(state)) if pagerank
            else (lambda: app.sweep(state)), reps=5, repeats=3)
        log(f"[time] {self.tag} graph {name}: {sweeps} sweeps; "
            f"{e2e['resident']:.4f} ms end to end with the resident driver, "
            f"{e2e['host']:.4f} ms with the host driver; {sweep_ms:.4f} ms of "
            f"device time per sweep ({sweeps * sweep_ms:.4f} ms for the "
            f"sweeps); build {build_s:.2f} s ({BESIDE_TESTS})")
        app.driver = "resident"
        log_profile(self.tag, f"graph {name} resident run",
                    lambda: run(app, "resident"))

    def graph_multi(self, name, app, torch_app, sources) -> None:
        """``run_multi`` of GRAPH_S sources with both drivers: rows bitwise
        ``run``, and bitwise the torch backend's."""
        app.driver = torch_app.driver = "resident"
        self.zero_counts()
        multi = app.run_multi(sources)
        counts = self.read_counts()
        check(sum(counts.values()) > 0, f"{name} run_multi: no kernel launch")
        report = app.convergence
        check(same_bits(multi, torch_app.run_multi(sources)),
              f"{name} run_multi: cuda differs from the torch backend")
        for i, s in enumerate(sources):
            check(same_bits(multi[i], app.run(int(s))),
                  f"{name} run_multi row {i} differs from run({s})")
        app.driver = "host"
        self.zero_counts()
        host = app.run_multi(sources)
        self.read_counts()
        check(same_bits(multi, host) and app.convergence == report,
              f"{name} run_multi: the host driver differs from the resident")
        app.driver = "resident"
        ms = host_ms(lambda: app.run_multi(sources), warmup=1, reps=3)
        log(f"[graph] {name} run_multi S={len(sources)}: {report}; rows "
            f"bitwise equal to run(), to the host driver and to the torch "
            f"backend; kernel "
            f"launches {counts['unroll_spmv.window']} window, "
            f"{counts['unroll_spmv.dense_slice']} dense-slice")
        log(f"[time] {self.tag} graph {name} run_multi S={len(sources)}: "
            f"{ms:.4f} ms end to end (resident driver)")

    def graph_oracle(self, name, got, c, adj, source) -> None:
        """Hold one app's result to scipy.sparse.csgraph / a float64 power
        iteration."""
        from scipy.sparse import csgraph, csr_matrix
        n = c.num_nodes
        if name == "bfs":
            hops = csgraph.shortest_path(adj, method="D", unweighted=True,
                                         indices=int(source))
            want = np.where(np.isinf(hops), -1, hops).astype(np.int32)
            check(np.array_equal(got, want), "bfs levels differ from "
                  "scipy shortest_path(unweighted=True)")
        elif name == "sssp":
            # parallel edges: keep the least weight per (src, dst) pair
            order = np.lexsort((c.weight, c.dst, c.src))
            s, d, w = c.src[order], c.dst[order], c.weight[order]
            first = np.ones(s.size, bool)
            first[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
            m = csr_matrix((w[first].astype(np.float64),
                            (s[first], d[first])), shape=(n, n))
            want = csgraph.shortest_path(m, method="D", indices=int(source))
            fin = np.isfinite(want)
            check(np.array_equal(np.isfinite(got), fin),
                  "sssp: reachable set differs from Dijkstra")
            rel = float(np.max(np.abs(got[fin] - want[fin])
                               / np.maximum(np.abs(want[fin]), 1e-30)))
            check(rel <= REL_ERR_LIMIT, f"sssp: rel err {rel:.3e} vs "
                  "float64 Dijkstra")
            log(f"[graph] sssp: max rel err vs float64 Dijkstra {rel:.3e}")
        elif name == "cc":
            ncomp, comp = csgraph.connected_components(adj, directed=False)
            mins = np.full(ncomp, n, np.int64)
            np.minimum.at(mins, comp, np.arange(n))
            check(np.array_equal(got, mins[comp]), "cc labels differ from "
                  "the min node id of scipy's components")
            log(f"[graph] cc: {ncomp} components, labels equal to scipy's")
        else:
            deg = np.bincount(c.src, minlength=n).astype(np.float64)
            inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
            push = csr_matrix((np.ones(c.num_edges), (c.dst, c.src)),
                              shape=(n, n))
            rank = np.full(n, 1.0 / n)
            for _ in range(PAGERANK_ITERS):
                rank = (1 - 0.85) / n + 0.85 * (push @ (rank * inv)
                                                + rank[deg == 0].sum() / n)
            err = float(np.abs(got - rank).max() / np.abs(rank).max())
            check(err <= REL_ERR_LIMIT, f"pagerank: err {err:.3e} vs the "
                  "float64 power iteration")
            log(f"[graph] pagerank: max abs err / max rank vs float64 "
                f"power iteration {err:.3e}")

    # ------------------------------------------------------------ serving
    def serve_phase(self) -> None:
        """Concurrent queries through ``QueryEngine`` (see the module
        docstring, phase 8)."""
        torch = self.torch
        from repro_torch.serve import query as Q
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED)
        n = self.graph[0].num_nodes
        for name in ("bfs", "sssp"):
            app, torch_app, _ = self.graph_apps[name]
            spec = SERVE[name]
            make = getattr(Q, f"{name}_endpoint")
            sources = [int(s) for s in rng.integers(0, n, spec["requests"])]
            self.serve_endpoint(Q, make(app, max_batch=spec["max_batch"]),
                                make(torch_app), app, sources, app.run, spec)
        spec = SERVE["spmv"]
        pwtk = self.run_of("pwtk", True, None)
        torch_pwtk = dataclasses.replace(
            pwtk["app"], _run=pwtk["torch_run"], _y0={},
            _batched_shapes=set())
        pwtk = pwtk["app"]
        xs = list(rng.standard_normal((spec["requests"], pwtk.shape[1]))
                  .astype(np.float32))
        self.serve_endpoint(
            Q, Q.spmv_endpoint(pwtk, max_batch=spec["max_batch"]),
            Q.spmv_endpoint(torch_pwtk), pwtk, xs,
            lambda x: pwtk.matvec(torch.as_tensor(x, device=self.dev)), spec)
        self.bucket_timing(pwtk)
        self.serve_launcher()
        log(f"[serve] phase done in {time.perf_counter() - t0:.1f} s")

    def serve_endpoint(self, Q, ep, plain, app, payloads, one, spec) -> None:
        """Warm one endpoint, serve ``payloads`` from ``spec["threads"]``
        client threads, hold every response bitwise to the sequential call
        ``one(payload)``, which is then timed on its own, and every served
        batch bitwise to the same payloads as one batch of ``plain``, the
        endpoint over the ``"torch"`` backend on the same plan."""
        import collections
        import threading
        what = f"{ep.name} ({len(payloads)} requests, {spec['threads']} " \
               f"client threads, max_batch {ep.max_batch})"
        batches = []                        # the payloads of each batch

        def recorded(batch):
            batches.append(list(batch))
            return ep.batch_fn(batch)
        engine = Q.QueryEngine([dataclasses.replace(ep, batch_fn=recorded)],
                               queue_capacity=len(payloads))
        responses = [None] * len(payloads)
        errors = []
        lock = threading.Lock()

        def client(idx):
            tickets = []
            for i in idx:
                try:
                    tickets.append((i, engine.submit(ep.name, payloads[i])))
                except Q.ServeError as e:
                    with lock:
                        errors.append(e)
            for i, t in tickets:
                try:
                    responses[i] = t.result(600)
                except Exception as e:      # noqa: BLE001 - checked below
                    with lock:
                        errors.append(e)

        with engine:
            t0 = time.perf_counter()
            engine.warmup(ep.name, payloads[0], batch=ep.max_batch)
            warm_s = time.perf_counter() - t0
            chunks = [range(i, len(payloads), spec["threads"])
                      for i in range(spec["threads"])]
            threads = [threading.Thread(target=client, args=(c,))
                       for c in chunks]
            del batches[:]
            self.zero_counts()
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(900)
            wall = time.perf_counter() - t0
            counts = self.read_counts()
            health = engine.health()
        check(not any(th.is_alive() for th in threads),
              f"serve {what}: a client thread never finished")
        check(not errors, f"serve {what}: {len(errors)} requests failed, "
              f"first: {errors[:1]!r}")
        check(all(r is not None for r in responses),
              f"serve {what}: a request got no response")
        check(health["breaker"]["state"] == "closed",
              f"serve {what}: breaker {health['breaker']}")
        check(health["endpoints"][ep.name]["warm"],
              f"serve {what}: health() does not report the endpoint warm")
        self.check_named(app, counts, f"serve {what}")
        sizes = dict(sorted(collections.Counter(
            r.batch_size for r in responses).items()))
        lat = sorted(r.total_s * 1e3 for r in responses)
        p50 = lat[len(lat) // 2]
        p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
        self.torch.cuda.synchronize()
        seq, sweeps = [], []
        t0 = time.perf_counter()
        for p in payloads:
            seq.append(one(p).cpu().numpy())
            sweeps.append(getattr(app, "convergence", None))
        seq_s = time.perf_counter() - t0
        sweeps = [c.sweeps for c in sweeps if c is not None]
        for i, (r, want) in enumerate(zip(responses, seq)):
            check(same_host_bits(r.value, want),
                  f"serve {what}: response {i} (batch of {r.batch_size}) "
                  "differs from its sequential call")
        # a payload's response, by identity (an int source may repeat; its
        # responses are then equal, as held just above)
        by_payload = {id(p): r.value for p, r in zip(payloads, responses)}
        check(sum(map(len, batches)) == len(payloads),
              f"serve {what}: {sum(map(len, batches))} payloads in the "
              f"recorded batches, {len(payloads)} submitted")
        for b, batch in enumerate(batches):
            want = plain.batch_fn(batch).cpu().numpy()
            for j, p in enumerate(batch):
                check(same_host_bits(by_payload[id(p)], want[j]),
                      f"serve {what}: batch {b} (of {len(batch)}) row {j} "
                      "differs from the torch backend on the same batch")
        served = len(responses)
        log(f"[serve] {what}: all {served} served, each bitwise equal to its "
            f"sequential call and, in each of the {len(batches)} served "
            f"batches, to the torch backend on the same batch; breaker "
            f"closed, endpoint warm; kernel launches during the traffic "
            f"{ {k: c for k, c in counts.items() if c} }; batch sizes seen "
            f"{sizes}; {health['counters']}")
        log(f"[time] {self.tag} serve {ep.name}, saturation burst (all "
            f"{served} requests submitted at once): {served} served in "
            f"{wall:.4f} s wall, peak {served / wall:.4f} QPS; a request's "
            f"time in the burst (its place in the queue) p50 {p50:.4f} ms, "
            f"p99 {p99:.4f} ms (warmup {warm_s:.2f} s)")
        log(f"[time] {self.tag} serve {ep.name}: the same {served} requests "
            f"one by one (each call and its host copy) {seq_s:.4f} s, "
            f"{served / seq_s:.4f} QPS; at full-batch saturation batching "
            f"{'pays' if wall < seq_s else 'does not pay'} on this card "
            f"(batched / sequential wall {wall / seq_s:.4f})"
            + (f"; sweeps per run {min(sweeps)}-{max(sweeps)}, mean "
               f"{statistics.mean(sweeps):.2f}" if sweeps else ""))

    def bucket_timing(self, app) -> None:
        """One ``matvec_many`` of ``S = SERVE_BUCKET_S`` on pwtk, padded up
        the bucket ladder and not: bitwise equal rows, device ms of each."""
        torch = self.torch
        xs = torch.as_tensor(np.random.default_rng(SEED + 3).standard_normal(
            (SERVE_BUCKET_S, app.shape[1])).astype(np.float32),
            device=self.dev)
        padded = app.matvec_many(xs, bucket=True)
        check(same_bits(padded, app.matvec_many(xs, bucket=False)),
              "matvec_many bucket=False differs from bucket=True")
        ms = {b: device_ms(lambda: app.matvec_many(xs, bucket=b))
              for b in (True, False)}
        log(f"[time] {self.tag} pwtk coalesce=True matvec_many "
            f"S={SERVE_BUCKET_S}: bucket=True (S padded to "
            f"{self.graphs.bucket_size(SERVE_BUCKET_S)}) {ms[True]:.4f} ms "
            f"of device time, bucket=False (the endpoints') {ms[False]:.4f} "
            "ms; rows bitwise equal")

    def serve_launcher(self) -> None:
        """``python -m repro_torch.launch.serve_queries`` once in a child
        process (the kernels are already built in ``build/``)."""
        out = ROOT / "build" / "serve.json"
        out.unlink(missing_ok=True)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve_queries",
             *LAUNCHER_ARGS], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=LAUNCHER_S)
        child_s = time.perf_counter() - t0
        for line in proc.stdout.strip().splitlines()[-8:]:
            log(f"[serve] child: {line}")
        if proc.returncode != 0:
            for line in proc.stderr.strip().splitlines()[-20:]:
                log(f"[serve] child: {line}")
        check(proc.returncode == 0, "the serve_queries launcher failed "
              f"(exit {proc.returncode})")
        summary = json.loads(out.read_text())
        check(summary["served"] == summary["requests"] == 256
              and not any(summary["errors"].values())
              and summary["health"]["breaker"]["state"] == "closed",
              f"serve_queries: served {summary['served']} of "
              f"{summary['requests']}, errors {summary['errors']}")
        check(summary["check"]["checked"] == summary["check"]["bitwise"]
              == 32, f"serve_queries: {summary['check']} of the sampled "
              "responses against the torch build")
        log(f"[time] {self.tag} serve_queries {' '.join(LAUNCHER_ARGS)}: "
            f"{summary['served']} served, {summary['qps']:.4f} QPS, p50 "
            f"{summary['p50_ms']:.4f} ms, p99 {summary['p99_ms']:.4f} ms; "
            f"child process {child_s:.2f} s in all (start, generate, plan, "
            "warm-up, traffic)")

    # ------------------------------------------------------- tuned path
    def tuned(self, build, what):
        """One ``backend="auto"`` build, its tuner's RuntimeWarnings turned
        into failures (a disqualified or oracle-rejected candidate must
        not pass silently); returns the app and its build seconds."""
        import warnings
        t0 = time.perf_counter()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)
                app = build()
        except RuntimeWarning as w:
            fail(f"{what}: the tuner warned: {w}")
        self.torch.cuda.synchronize()
        return app, time.perf_counter() - t0

    def log_tuning(self, what, result, build_s, counts) -> None:
        from repro_torch.tune import cost as tcost
        for m in sorted(result.measurements,
                        key=lambda m: m.predicted_us):
            unscaled = m.predicted_us / tcost.backend_scale(
                m.candidate, result.platform)
            log(f"[tune] {self.tag} {what} candidate {m.candidate.label}: "
                f"predicted {m.predicted_us:.2f} us (model before its "
                f"backend's scale {unscaled:.2f}), measured "
                f"{m.us_per_call:.2f} us, ok={m.ok}")
        log(f"[tune] {self.tag} {what}: winner {result.best.label} "
            f"({result.best_us:.2f} us) of {result.num_measured} measured, "
            f"picked by {result.picked_by}; tuner wall time (plan builds, "
            f"candidate builds, oracle, measurement) {build_s:.2f} s; "
            f"kernel launches while tuning "
            f"{ {k: c for k, c in counts.items() if c} }")

    def check_tuning(self, what, result) -> None:
        bad = [m.candidate.label for m in result.measurements
               if not m.ok or not np.isfinite(m.us_per_call)]
        check(not bad, f"{what}: candidates disqualified or rejected by "
              f"the oracle: {bad}")
        check(result.picked_by == "measurement" and not result.cache_hit,
              f"{what}: a cold build was not picked by measurement")

    def check_report(self, what, app) -> None:
        rep = app.report()
        check(rep.totals["launches"] == len(app._run.tree.launches),
              f"{what}: report() counts {rep.totals['launches']} launches, "
              f"the tree has {len(app._run.tree.launches)}")
        parsed = json.loads(rep.to_json())
        check(parsed["hlo"] is None and parsed["tuning"] is not None,
              f"{what}: report() JSON lacks its tuning or has an hlo")
        log(f"[report] {what}: backend {rep.backend}, totals "
            f"{rep.totals}, passes {list(rep.passes)}")

    def tune_phase(self) -> None:
        """The tuned entry path (see the module docstring, phase 9)."""
        import shutil
        torch = self.torch
        from repro_torch import tune as T
        cache = ROOT / "build" / "chip_smoke" / "tune_cache"
        shutil.rmtree(cache, ignore_errors=True)
        for name, m in self.mats.items():
            vals, x = data_for(m, np.float32)
            xd = torch.as_tensor(x, device=self.dev)
            oracle = add_at_oracle(m, vals, x)
            what = f"{name} SpMV backend=auto"

            def build():
                return self.SpMV.from_coo(
                    m.rows, m.cols, vals, m.shape, backend="auto",
                    tune_cache_dir=str(cache), device=self.dev)
            self.zero_counts()
            app, build_s = self.tuned(build, what)
            counts = self.read_counts(main_path=False)
            res = app.tuning
            self.log_tuning(what, res, build_s, counts)
            self.check_tuning(what, res)
            check(any(mm.candidate.backend == "cuda"
                      for mm in res.measurements),
                  f"{what}: no cuda candidate was measured")
            check(counts["unroll_spmv.window"]
                  + counts["unroll_spmv.dense_slice"] > 0,
                  f"{what}: tuning launched no stage-A kernel")
            self.zero_counts()
            y = app.matvec(xd)
            win_counts = self.read_counts()
            yh = y.cpu().numpy()
            rel = float(np.abs(yh - oracle).max() / np.abs(oracle).max())
            check(bool(np.isfinite(yh).all()) and rel <= REL_ERR_LIMIT,
                  f"{what}: winner's rel err {rel:.3e} vs the float64 "
                  "oracle")
            before = T.measurement_count()
            warm, warm_s = self.tuned(build, what + " (warm)")
            check(T.measurement_count() == before and warm.tuning.cache_hit
                  and warm.tuning.best == res.best,
                  f"{what}: the warm rebuild measured again or changed its "
                  "choice")
            self.check_report(what, app)
            fixed = self.run_of(name, False, None)["app"]
            win_dev = device_ms(lambda: app.matvec(xd))
            fixed_dev = device_ms(lambda: fixed.matvec(xd))
            win_host = host_ms(lambda: app.matvec(xd))
            fixed_host = host_ms(lambda: fixed.matvec(xd))
            log(f"[tune] {what}: winner's matvec rel err vs float64 oracle "
                f"{rel:.3e}, kernel launches "
                f"{ {k: c for k, c in win_counts.items() if c} }; warm "
                f"rebuild {warm_s:.2f} s, a cache hit with 0 measurements")
            log(f"[time] {self.tag} {what}: winner {res.best.label} "
                f"{win_dev:.4f} ms of device time, {win_host:.4f} ms end to "
                f"end; fixed backend=cuda (coalesce=False) {fixed_dev:.4f} "
                f"ms of device time, {fixed_host:.4f} ms end to end")
            self.segsum_run(name, m, vals, xd, oracle)
        self.plan_cache_run()
        self.tuned_bfs(cache)

    def segsum_run(self, name, m, vals, xd, oracle) -> None:
        """``backend="segsum"``: one scatter_reduce_, whose float sum
        accumulates in float64 by atomics in no fixed order on the card,
        so it is held to the oracle, not bitwise to the torch backend."""
        app = self.SpMV.from_coo(m.rows, m.cols, vals, m.shape,
                                 backend="segsum", device=self.dev)
        yh = app.matvec(xd).cpu().numpy()
        rel = float(np.abs(yh - oracle).max() / np.abs(oracle).max())
        check(bool(np.isfinite(yh).all()) and rel <= REL_ERR_LIMIT,
              f"{name} segsum: rel err {rel:.3e} vs the float64 oracle")
        ms = device_ms(lambda: app.matvec(xd))
        log(f"[time] {self.tag} {name} SpMV backend=segsum matvec: {ms:.4f} "
            f"ms of device time; rel err vs float64 oracle {rel:.3e} (its "
            "float sum is a float64 atomic one, so it is not bitwise equal "
            "to the torch backend)")

    def plan_cache_run(self) -> None:
        """Two builds through ``plan_cache_dir``: the second is a hit and
        gives a bitwise-equal result.  Needs the optional msgpack."""
        import shutil
        try:
            import msgpack  # noqa: F401
        except ImportError:
            log("[plancache] skipped: the optional msgpack package does not "
                "import on this machine, so plan_cache_dir builds the plan "
                "each time (planio needs msgpack to serialize plans)")
            return
        from repro_torch.obs import metrics
        cache = ROOT / "build" / "chip_smoke" / "plan_cache"
        shutil.rmtree(cache, ignore_errors=True)
        m = self.mats["webbase-1M"]
        vals, x = data_for(m, np.float32)
        xd = self.torch.as_tensor(x, device=self.dev)
        ys, times = [], []
        for _ in range(2):
            hits = metrics.value("plan_cache.hits")
            t0 = time.perf_counter()
            app = self.SpMV.from_coo(m.rows, m.cols, vals, m.shape,
                                     backend="cuda", plan_cache_dir=str(cache),
                                     device=self.dev)
            times.append(time.perf_counter() - t0)
            ys.append((metrics.value("plan_cache.hits") - hits,
                       app.matvec(xd)))
        check(ys[0][0] == 0 and ys[1][0] == 1,
              "plan cache: the second build was not a hit")
        check(same_bits(ys[0][1], ys[1][1]),
              "plan cache: the cached plan's result differs")
        log(f"[plancache] webbase-1M backend=cuda: cold build {times[0]:.2f} "
            f"s, warm build (cache hit) {times[1]:.2f} s, results bitwise "
            "equal")

    def tuned_bfs(self, cache) -> None:
        c, adj, sources = self.graph
        what = "soc-Pokec BFS backend=auto"
        self.zero_counts()
        app, build_s = self.tuned(lambda: self.graphs.BFS.from_edges(
            c.src, c.dst, c.num_nodes, backend="auto",
            tune_cache_dir=str(cache), driver="resident", device=self.dev),
            what)
        self.log_tuning(what, app.tuning, build_s,
                        self.read_counts(main_path=False))
        self.check_tuning(what, app.tuning)
        self.zero_counts()
        levels = app.run(int(sources[0]))
        counts = self.read_counts()
        self.graph_oracle("bfs", levels.cpu().numpy(), c, adj, sources[0])
        self.check_report(what, app)
        log(f"[tune] {what}: {app.convergence}; levels equal to scipy's; "
            f"kernel launches {({k: v for k, v in counts.items() if v})}")
        self.bfs_ranking(app.tuning)
        segsum = self.graphs.BFS.from_edges(
            c.src, c.dst, c.num_nodes, backend="segsum", driver="resident",
            device=self.dev)
        self.graph_oracle("bfs", segsum.run(int(sources[0])).cpu().numpy(),
                          c, adj, sources[0])
        ms = host_ms(lambda: app.run(int(sources[0])), warmup=1, reps=3)
        seg_ms = host_ms(lambda: segsum.run(int(sources[0])), warmup=1,
                         reps=3)
        log(f"[time] {self.tag} {what}: winner {app.tuning.best.label} "
            f"{ms:.4f} ms end to end (resident driver); fixed "
            f"backend=segsum {seg_ms:.4f} ms end to end "
            f"({segsum.convergence.sweeps} sweeps, levels equal to scipy's)")

    def bfs_ranking(self, result) -> None:
        """The cost model's prediction for every candidate of the tuned
        BFS's space, in its order (the top 4 are the ones measured)."""
        from repro_torch import tune as T
        from repro_torch.core.seed import bfs_seed
        space = T.candidate_space(bfs_seed(), platform=result.platform)
        ranked = T.rank_candidates(space, result.features, result.platform)
        log(f"[tune] {self.tag} soc-Pokec BFS model ranking (us per "
            f"{self.graphs._TUNE_RUN_SWEEPS} sweeps): " + "; ".join(
                f"{i + 1}. {c.label} {us:.2f}"
                for i, (c, us) in enumerate(ranked)))

    # ---------------------------------------------------------- sharding
    def shard_phase(self) -> None:
        """Sharded execution on a simulated mesh (see the module
        docstring, phase 12).  The sharded path runs the ``torch`` and
        ``segsum`` backends only (the kernels are single-device, as the
        reference's Pallas ones), so its runs launch no kernel."""
        import shutil
        torch = self.torch
        t0 = time.perf_counter()
        cache = ROOT / "build" / "chip_smoke" / "shard_plans"
        shutil.rmtree(cache, ignore_errors=True)
        self.shard_products(str(cache))
        self.shard_raises()
        self.shard_tuned(str(cache))
        # the three builds while the last share of the card tests runs
        self.start_card_tests(2)
        built = {name: self.shard_build(name)
                 for name in ("bfs", "sssp", "pagerank")}
        self.join_card_tests()
        for name, parts in built.items():
            self.shard_graph(name, parts)
        del built
        # nothing after this phase reads the graph phase's apps
        self.graph_apps = self.graph_results = self.shard_pwtk = None
        torch.cuda.empty_cache()
        log(f"[shard] phase done in {time.perf_counter() - t0:.1f} s")

    def sim(self, k) -> dict:
        return dict(shards=k, simulate_mesh=True, device=self.dev)

    def partition_s(self, plan, k):
        """Host seconds of ``ir.lower`` + ``ir.partition_plan`` of a torch
        lowering into ``k`` shards, and the rows per shard."""
        t0 = time.perf_counter()
        parts = self.ir.partition_plan(self.ir.lower(plan, backend="torch"),
                                       k)
        return time.perf_counter() - t0, [p.num_rows for p in parts]

    def peak_run(self, fn):
        """``fn()`` and its peak device bytes above what was held before
        it.  Unreachable executors (closures that refer to themselves) are
        collected first, so nothing held before is freed during ``fn``."""
        torch = self.torch
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    def shard_run(self, what, fn):
        """:meth:`peak_run` of one sharded call with the counters zeroed
        before it: it must launch no kernel."""
        self.zero_counts()
        out, peak = self.peak_run(fn)
        counts = self.read_counts()
        check(not any(counts.values()), f"{what}: the sharded path launched "
              f"kernels {counts}")
        return out, peak

    def shard_products(self, cache) -> None:
        """pwtk ``matvec`` at each ``SHARD["spmv"]`` count with the torch
        and segsum backends, and ``matmat`` D = SPMM_D at
        ``SHARD["spmm"]`` shards with add and min."""
        torch = self.torch
        m = self.mats["pwtk"]
        single = self.run_of("pwtk", False, None)
        vals, xd = single["vals"], single["x"]
        y0 = torch.zeros(m.shape[0], device=self.dev)
        singles = {"torch": single["torch_run"],
                   "segsum": self.eng.make_executor(
                       self.plans["pwtk"], {"value": vals}, backend="segsum",
                       device=self.dev)}
        want, single_peak = self.peak_run(
            lambda: singles["torch"]({"x": xd}, y0))
        oracle = add_at_oracle(m, vals, xd.cpu().numpy())
        single_ms = {b: device_ms(lambda: run({"x": xd}, y0))
                     for b, run in singles.items()}
        log(f"[time] {self.tag} shard pwtk SpMV single-device: torch "
            f"backend {single_ms['torch']:.4f} ms, segsum "
            f"{single_ms['segsum']:.4f} ms of device time per matvec; torch "
            f"peak memory {single_peak} B above what was held before the "
            "call")
        for k in SHARD["spmv"]:
            sec, rows = self.partition_s(self.plans["pwtk"], k)
            log(f"[shard] pwtk k={k}: ir.lower + partition_plan {sec:.3f} s "
                f"on the host; rows per shard {rows}")
            for backend in ("torch", "segsum"):
                what = f"pwtk SpMV {backend} shards={k}"
                t1 = time.perf_counter()
                app = self.SpMV.from_coo(m.rows, m.cols, vals, m.shape,
                                         backend=backend,
                                         plan_cache_dir=cache, **self.sim(k))
                build_s = time.perf_counter() - t1
                y, peak = self.shard_run(what, lambda: app.matvec(xd))
                check(len(app._shard_parts) == k and app.mesh.simulated,
                      f"{what}: not built on a {k}-shard simulated mesh")
                yh = y.cpu().numpy()
                rel = float(np.abs(yh - oracle).max() / np.abs(oracle).max())
                check(bool(np.isfinite(yh).all()) and rel <= REL_ERR_LIMIT,
                      f"{what}: rel err {rel:.3e} vs the float64 oracle")
                if backend == "torch":
                    check(same_bits(y, want), f"{what}: differs from the "
                          "single-device torch backend")
                ms = device_ms(lambda: app.matvec(xd))
                log(f"[shard] {what}: rel err vs float64 oracle {rel:.3e}"
                    + (", bitwise equal to the single-device torch backend"
                       if backend == "torch" else " (atomic float sums: "
                       "held to the oracle)") + f"; from_coo {build_s:.2f} s")
                log(f"[time] {self.tag} shard {what}: {ms:.4f} ms of device "
                    f"time per matvec (single-device {backend} "
                    f"{single_ms[backend]:.4f} ms); peak memory {peak} B "
                    "above what was held before the call")
                if backend == "torch" and k == max(SHARD["spmv"]):
                    self.shard_pwtk = app           # for shard_raises
        k = SHARD["spmm"]
        single = self.run_of("pwtk", False, SPMM_D)
        vals, bd = single["vals"], single["x"]
        for reduce in ("add", "min"):
            what = f"pwtk SpMM D={SPMM_D} {reduce} shards={k}"
            if reduce == "add":
                y0 = torch.zeros((m.shape[0], SPMM_D), device=self.dev)

                def one():
                    return single["torch_run"]({"x": bd}, y0)
            else:
                one = functools.partial(self.SpMM.from_coo(
                    m.rows, m.cols, vals, m.shape, reduce=reduce,
                    plan_cache_dir=cache, device=self.dev).matmat, bd)
            want, single_peak = self.peak_run(one)
            app = self.SpMM.from_coo(m.rows, m.cols, vals, m.shape,
                                     reduce=reduce, plan_cache_dir=cache,
                                     **self.sim(k))
            y, peak = self.shard_run(what, lambda: app.matmat(bd))
            check(same_bits(y, want) and bool(y.isfinite().all()),
                  f"{what}: differs from the single-device torch backend")
            ms = device_ms(lambda: app.matmat(bd))
            single_ms = device_ms(one)
            log(f"[shard] {what}: bitwise equal to the single-device torch "
                "backend")
            log(f"[time] {self.tag} shard {what}: {ms:.4f} ms of device time "
                f"per matmat (single-device torch backend {single_ms:.4f} "
                f"ms); peak memory {peak} B above what was held before the "
                f"call (single-device {single_peak} B)")

    def shard_raises(self) -> None:
        """What the sharded path refuses, as the reference does."""
        m = self.mats["pwtk"]
        vals = data_for(m, np.float32)[0]
        try:
            self.SpMV.from_coo(m.rows, m.cols, vals, m.shape, backend="cuda",
                               **self.sim(2))
            fail("SpMV backend=cuda shards=2 did not raise")
        except ValueError as e:
            check("single-device" in str(e), f"cuda shards=2 raised {e!r}")
        xs = self.torch.zeros((2, m.shape[1]), device=self.dev)
        try:
            self.shard_pwtk.matvec_many(xs)
            fail("matvec_many on a sharded SpMV did not raise")
        except NotImplementedError:
            pass
        log("[shard] SpMV backend=cuda shards=2 raises ValueError (the "
            "kernels are single-device); matvec_many on a sharded SpMV "
            "raises NotImplementedError")

    def shard_tuned(self, cache) -> None:
        """``backend="auto", shards=SHARD["tune"]`` on pwtk: one measured
        candidate per shard count at least, the winner within 1e-5."""
        m = self.mats["pwtk"]
        single = self.run_of("pwtk", False, None)
        vals, xd = single["vals"], single["x"]
        oracle = add_at_oracle(m, vals, xd.cpu().numpy())
        k = SHARD["tune"]
        what = f"pwtk SpMV backend=auto shards={k}"
        self.zero_counts()
        app, build_s = self.tuned(lambda: self.SpMV.from_coo(
            m.rows, m.cols, vals, m.shape, backend="auto",
            plan_cache_dir=cache, **self.sim(k)), what)
        res = app.tuning
        self.log_tuning(what, res, build_s, self.read_counts(main_path=False))
        self.check_tuning(what, res)
        counts = {mm.candidate.shards for mm in res.measurements}
        check(counts == {1, k}, f"{what}: measured shard counts {counts}")
        yh = app.matvec(xd).cpu().numpy()
        rel = float(np.abs(yh - oracle).max() / np.abs(oracle).max())
        check(bool(np.isfinite(yh).all()) and rel <= REL_ERR_LIMIT,
              f"{what}: winner's rel err {rel:.3e} vs the float64 oracle")
        log(f"[shard] {what}: measured shard counts {sorted(counts)}, winner "
            f"{res.best.label}, rel err vs float64 oracle {rel:.3e}")

    def shard_build(self, name):
        """Build one soc-Pokec app at ``SHARD["graph"]`` shards and its
        single-device torch twin on the same plan (see
        :meth:`shard_graph`) -> (mesh, sharded, single, how, build s)."""
        eng = self.eng
        from repro_torch.launch.mesh import make_shard_mesh
        app, torch_app, _ = self.graph_apps[name]
        c = self.graph[0]
        k = SHARD["graph"]
        mesh = make_shard_mesh(k, device=self.dev, simulate=True)
        if name == "bfs":       # SSSP and PageRank have the same edges
            sec, rows = self.partition_s(app.plan, k)
            log(f"[shard] soc-Pokec: the graph phase's source-sorted plan "
                f"cuts into rows per shard {rows} (ir.lower + "
                f"partition_plan {sec:.3f} s, {BESIDE_TESTS})")
        pagerank = name == "pagerank"
        t0 = time.perf_counter()
        order = self.dst_order()
        src, dst = c.src[order], c.dst[order]
        cls = self.PageRank if pagerank else getattr(self.graphs,
                                                     name.upper())
        args = (src, dst, c.weight[order], c.num_nodes) \
            if name == "sssp" else (src, dst, c.num_nodes)
        sharded = cls.from_edges(*args, backend="torch", mesh=mesh,
                                 device=self.dev)
        static = {"weight": np.asarray(c.weight[order], np.float32)} \
            if name == "sssp" else {}
        single = dataclasses.replace(
            sharded, _run=eng.make_executor(sharded.plan, static,
                                            backend="torch",
                                            device=self.dev),
            mesh=None, _shard_parts=(), _shard_step=None)
        how = "from_edges on destination-sorted edges"
        return mesh, sharded, single, how, time.perf_counter() - t0

    def shard_graph(self, name, built) -> None:
        """One soc-Pokec app at ``SHARD["graph"]`` shards with both drivers.

        Rows shard only where no block writes across a cut
        (``ir.legal_cuts``), and a plan's blocks follow the edge list's
        order.  The graph phase's edges are sorted by source, so their
        blocks write all over the destination range and every plan cuts
        into one full shard and empty ones; the phase prints that
        partition, then builds BFS, SSSP and PageRank through
        ``from_edges(mesh=...)`` on the same edges sorted by destination
        (a destination-major edge list, what a row-sharded engine is fed)
        and checks that each cuts into two non-empty shards at least.
        Each sharded run, with either driver, must equal bitwise (state
        and ConvergenceReport) the single-device torch backend on the same
        plan; BFS and SSSP (exact min) must also equal the graph phase's
        runs, PageRank must hold against the float64 power iteration."""
        torch, eng = self.torch, self.eng
        mesh, sharded, single, how, build_s = built
        app, torch_app, _ = self.graph_apps[name]
        c, adj, sources = self.graph
        k = SHARD["graph"]
        pagerank = name == "pagerank"
        rows = [p.num_rows for p in sharded._shard_parts]
        live = sum(r > 0 for r in rows)
        check(sharded.mesh is mesh and len(rows) == k
              and live >= 2,
              f"{name} shards={k}: rows per shard {rows}")

        def run(a, driver):
            a.driver = driver
            if pagerank:
                return a.run(iters=PAGERANK_ITERS), None
            out = a.run(int(sources[0]))
            return out, a.convergence

        (want, want_report), single_peak = self.peak_run(
            lambda: run(single, "resident"))
        if not pagerank:
            check(same_bits(want, self.graph_results[name][0])
                  and want_report == self.graph_results[name][1],
                  f"{name}: the single-device run on {how} differs from "
                  "the graph phase's")
        else:
            self.graph_oracle(name, want.cpu().numpy(), c, adj, sources[0])
        peaks, e2e = {}, {}
        for driver in ("resident", "host"):
            (out, report), peaks[driver] = self.shard_run(
                f"{name} shards={k} {driver}", lambda: run(sharded, driver))
            check(same_bits(out, want) and report == want_report,
                  f"{name} shards={k} {driver}: differs from the "
                  "single-device torch backend")
            e2e[driver] = host_ms(lambda: run(sharded, driver), warmup=1,
                                  reps=3)
        single_e2e = host_ms(lambda: run(single, "resident"), warmup=1,
                             reps=3)
        if name == "bfs":
            try:
                sharded.run_multi(sources[:2])
                fail("run_multi on a sharded BFS did not raise")
            except NotImplementedError:
                log("[shard] run_multi on a sharded BFS raises "
                    "NotImplementedError")
        state = want if not pagerank else torch.full(
            (app.num_nodes,), 1.0 / app.num_nodes, device=self.dev)
        one_sweep = {"pagerank": lambda a: a._step(state)}.get(
            name, lambda a: a.sweep(state))
        single_ms = device_ms(lambda: one_sweep(single), reps=5, repeats=3)
        src_ms = (
            "; on the source-sorted plan "
            f"{device_ms(lambda: one_sweep(torch_app), reps=5, repeats=3):.4f}"
            " ms")
        step = sharded._shard_step
        pieces = eng.pad_rows(state, step.widths, step.padded_width,
                              step.devices)
        shard_ms = device_ms(lambda: step(pieces), reps=5, repeats=3)
        sweeps = PAGERANK_ITERS if pagerank else report.sweeps
        log(f"[shard] {name} shards={k} ({how}, built in {build_s:.2f} s, "
            f"{BESIDE_TESTS}; "
            f"rows per shard {rows}): "
            f"{report or f'{PAGERANK_ITERS} iterations'}; resident and host "
            "drivers bitwise equal to the single-device torch backend on "
            "the same plan, sweeps and flags equal")
        log(f"[time] {self.tag} shard {name} shards={k}: {sweeps} sweeps; "
            f"{e2e['resident']:.4f} ms end to end with the resident driver, "
            f"{e2e['host']:.4f} ms with the host driver (single-device "
            f"torch backend {single_e2e:.4f} ms, resident); "
            f"{shard_ms:.4f} ms of device time per resident sweep "
            f"(single-device {single_ms:.4f} ms{src_ms}); peak memory above "
            f"what was held before the run {peaks['resident']} B resident, "
            f"{peaks['host']} B host (single-device resident "
            f"{single_peak} B)")

    def dst_order(self) -> np.ndarray:
        """The soc-Pokec edges' order sorted by destination (then source),
        computed once."""
        if getattr(self, "_dst_order", None) is None:
            c = self.graph[0]
            self._dst_order = np.lexsort((c.src, c.dst))
        return self._dst_order

    def start_card_tests(self, share: int) -> None:
        """Start share ``share`` of the ``cuda``-marked tests of
        ``tests/test_torch_cuda.py`` (the tests in its ``CARD_TEST_SLOTS``,
        :func:`pytest_collection_modifyitems`) in a child process on this
        card; the kernels are already built."""
        lo, hi = CARD_TEST_SLOTS[share]
        proc = subprocess.Popen(
            [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
             "no:cacheprovider", "-p", "chip_smoke",
             "tests/test_torch_cuda.py"], cwd=ROOT, env=dict(
                os.environ, PYTHONPATH=os.pathsep.join(
                    (str(ROOT), str(ROOT / "src"))),
                CHIP_SMOKE_TESTS=f"{lo}-{hi}/50",
                OMP_NUM_THREADS="2"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.card_procs.append((share, time.perf_counter(), proc))
        self.tests_ran = True

    def beside_tests(self) -> str:
        """A host-clock reading's note while a share of the card tests
        runs."""
        return f" ({BESIDE_TESTS})" if self.card_procs else ""

    def join_card_tests(self) -> None:
        """Wait for the started shares of the card tests (before any timed
        work) and fail unless each passed."""
        t0 = time.perf_counter()
        try:
            for share, started, proc in self.card_procs:
                out, _ = proc.communicate(timeout=CARD_TESTS_S)
                lines = out.strip().splitlines()
                if proc.returncode != 0:
                    for line in lines[-40:]:
                        log(f"[tests]   {line}")
                check(proc.returncode == 0, "tests/test_torch_cuda.py failed "
                      f"on the card (share {share} of {CARD_TEST_SHARES}, "
                      f"pytest exit {proc.returncode})")
                lo, hi = CARD_TEST_SLOTS[share]
                log(f"[tests] tests/test_torch_cuda.py on the card, the "
                    f"tests of index {lo}-{hi - 1} modulo 50 (share "
                    f"{share}): "
                    f"{lines[-1] if lines else '?'} "
                    f"({time.perf_counter() - started:.1f} s since its start; "
                    f"waited {time.perf_counter() - t0:.1f} s for it)")
        finally:
            self.stop_card_tests()

    def stop_card_tests(self) -> None:
        for _, _, proc in self.card_procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        self.card_procs = []

    def run(self) -> None:
        t0 = time.perf_counter()
        try:
            for phase in (self.build_kernels, self.card_tests_early,
                          self.make_plans, self.stage_a_phase,
                          self.main_paths, self.join_card_tests,
                          self.matvec_many_phase, self.segment_reduce_phase,
                          self.gather_vload_phase, self.row_gather_phase,
                          self.lm_phase, self.train_phase, self.dp_phase,
                          self.tp_phase, self.tp_q8_phase,
                          self.dryrun_phase, self.graph_phase,
                          self.serve_phase, self.tune_phase,
                          self.shard_phase, self.main_timings,
                          self.stage_a_timings):
                t1, self.tests_ran = time.perf_counter(), bool(
                    self.card_procs)
                phase()
                beside = self.tests_ran or self.card_procs
                log(f"[phase] {phase.__name__} "
                    f"{time.perf_counter() - t1:.1f} s"
                    f"{f' ({BESIDE_TESTS})' if beside else ''}")
        finally:
            self.stop_card_tests()
        for key, c in self.compared.items():
            check(c > 0, f"{key} was never compared with its plain version")
            check(self.main_counts[key] > 0,
                  f"{key} was never launched on its main path")
        for key, entry in self.line.items():
            entry["launches"] = self.main_counts[key]
        log(f"[done] all phases in {time.perf_counter() - t0:.1f} s")
        log(json.dumps({"kernels": [self.line[k] for k in self.wrappers]}))


def pytest_collection_modifyitems(config, items):
    """A pytest hook, for ``-p chip_smoke``: with
    ``CHIP_SMOKE_TESTS=lo-hi/n`` keep the collected tests whose index
    modulo ``n`` lies in ``[lo, hi)``."""
    share = os.environ.get("CHIP_SMOKE_TESTS")
    if share:
        span, n = share.split("/")
        lo, hi = map(int, span.split("-"))
        keep = [lo <= k % int(n) < hi for k in range(len(items))]
        config.hook.pytest_deselected(items=[
            t for t, k in zip(items, keep) if not k])
        items[:] = [t for t, k in zip(items, keep) if k]


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.core.spmm  # noqa: F401
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script ({e})")
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"[device] {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {card}")
    Smoke(dev, card, kind).run()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
