#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per source, all in parallel), runs the first launches of
   K2, K1, the three-pass TF32 K6 and both tensor-core K6 routes at MLA's
   head dims (192, 128) in a child process (``chip_smoke.py --probe``)
   under a time limit, and holds each kernel against its plain
   PyTorch version on the card at several shapes: the counting kernels as
   exact integers (ragged sizes, phantom edges, the shapes the main path
   gives them at the paper's full Table-1 sizes; K1 — the live-grid count
   on K2's int8 tensor-core tile, a batch a launch — also on views of a
   padded buffer, a batch of views, rows that break TMA's 16-byte rule,
   and FNA.5's 4,472 rows of its 8,192 bucket as the main path gives them;
   K2 also all ones past 2³¹ and a ring whose rows break TMA's rule), flash attention
   (K6: at (D, Dv) = (64, 64), (128, 128) and MLA's (192, 128) the wgmma
   kernel for bf16 and the three-pass TF32 kernel for f32, at other head
   dims the FMA kernel — also MLA's smoke (24, 16), V padded by the wrapper
   — and timed at DeepSeek-V2-Lite's prefill shape beside the FMA kernel
   and SDPA)
   and EmbeddingBag (K7) within the reference kernel tests'
   tolerances, at Yi-6B's and AutoInt's full widths among others. The plain
   versions' float32 products run in true float32 (PyTorch's TF32 off,
   asserted). Times each kernel, its plain
   version and, where one exists, a single PyTorch call computing the same
   function (``library_ms``; the port never calls it). K1 is timed at
   FNA.5's view and at its bucket (``at_bucket_shape``). The per-edge closure
   (K5) is timed beside K3 at K3's shape and at the hybrid stream's; K2 at
   FNA.5's ring visit and at FB107x9's (``at_fb107x9_shape``).
2. Serves the Table-1 graphs at full scale (DSJC.1/.5/.9, FB107, FNA.5, NY),
   the FB107 family scaled to n = 17,199, and 16 small graphs through
   ``TriangleServer(device="cuda").serve``.
3. Forces each of dense, ring, bitset_ring, sparse, mapreduce and stream
   (``Resources(max_stages=4)``) on those large graphs — the paper's
   dynamic pipeline against MapReduce, and the two-phase stream ingest —
   and requires every method to give the same count as every other and as
   the plain path (the plain PyTorch dense count on the card up to
   n = 16384, a host numpy count beyond).
4. Streams: ``TriangleCounter(device="cuda").count_stream`` with the
   planner's sizing over shuffled, ragged edge blocks of FNA.5, NY and
   FB107x9 (each equal to the resident count); ``count_windowed`` with a
   window of 4 over 8 epochs of FB107x9 and FNA.5 (each equal to the
   resident bitset-ring count of the last 4 epochs' edges); and a session
   checkpointed halfway (unbounded, and windowed mid-epoch), spilled to
   ``.npz``, restored on a fresh counter and finished, bit-identical to an
   uninterrupted session.
5. [hybrid] The degree-aware hybrid stream state: YT, a Chung-Lu power-law
   stream (alpha 0.85, seed 0) with SNAP com-Youtube's n = 1,134,890 and
   m = 2,987,624 edge draws, through ``count_stream`` with the planner's own
   (hybrid) plan — its n²/8 bitset would be 161 GB — equal to the host
   oracle, ``state_bytes`` equal to ``predicted_bytes``, one K5, two K4 and
   one K3 launch per block; FNA.5 (every vertex a hub, 1.49e10 triangles)
   and FB107x9 (hub slots for exactly the vertices that reach the tail
   capacity) under hand-built hybrid plans, equal to the dense stream and
   the resident count; a hybrid FB107x9 session checkpointed halfway,
   spilled, restored and finished; and a plan with too few hub slots,
   which must raise at ``finalize``.
6. [serve streams] The serving tier's streams (``serve.sessions``) on a
   card the earlier phases emptied: (a) ``TriangleServer.serve_streams``
   over shuffled ragged streams of the Table-1 graphs and FB107x9, all
   sessions interleaved round-robin, once synchronously and once with
   ``prefetch_depth=2`` (and the adaptive block sizer), each count equal to
   the resident one, K3 and K4 twice a block; (b) NY-size sessions opened
   under ``Resources.detect()`` until one queues (8.73 GB bitsets, then
   hybrid states, beside the card's ingest reserve), every one fed its
   whole stream at ``SERVE_BLOCK`` rows a block (some with FB107x9's edges
   mapped onto NY's ids, against ``host_count``), and a close that admits
   the queued one; (c) a priority-1 open that preempts an 8.73 GB session
   to the host tier, readmitted at its close with every state array equal
   on the card to a session fed the same edges without a break (the
   checkpoint's and the restore's walls printed); (d) at FB107x9's size a
   ``CheckpointStore`` spilling to ``.npz`` and raising
   ``BackpressureError`` past its disk budget, and deadlines on an injected
   clock (parked, a late exact close, then cancelled); (e) a YT-size
   session admitted as hybrid and counted to [hybrid]'s count with one K5,
   two K4 and one K3 a block (or, should its plan lose endpoints, the
   exact-count refusal raising); (f) on a multiplexer over a one-card mesh
   of ``MESH_STAGES`` stages, NY-size sessions opened until one queues and
   then a seeded mixed order of priority-0 and priority-1 opens,
   preemptions and closes — mesh sessions (opened under a four-stage
   plan), bitsets and hybrid ones the planner sizes — every active session
   fed a block after each change, no out-of-memory error, under the
   allocator settings the multiplexer makes itself.
7. [ring mesh] The dynamic pipeline's ring on ``make_ring_mesh(4,
   devices=[cuda:0] * 4)``, each stage on its own CUDA stream: (a)
   ``TriangleCounter(mesh=)`` with ring and bitset_ring forced on every
   graph where [compare] forces them, each count repeated 20 times back to
   back, all equal to ``run_sequential``'s and the resident count, S² K2 or
   K3 launches a count; the pipeline alone 20 times queued without a
   synchronisation; FNA.5's and FB107x9's walls at S = 2, 4, 8 beside the
   stage chain's (printed, no claim); (b) ``TriangleServer(mesh=)``'s
   ``serve_streams`` of FNA.5, NY and FB107x9, each under the planner's
   plan at four stages
   (counts = resident, ``on_mesh``, K3 and K4 twice a shard a block), and
   the same interleave by hand with every shard ``torch.equal`` to the
   emulated sharded state fed the same blocks (NY: 8.73 GB in four 2.18 GB
   shards); (c) FB107x9's window of 4 over 8 epochs on the mesh equal to
   [stream]'s; (d) a mesh checkpoint restored on an emulated counter and
   the reverse, bit-identical to an uninterrupted session, no new ingest
   key; (e) the multiplexer on the one-card mesh charging a four-stage NY
   session's four shards in full, and planning NY at ring width 1 without
   a plan, beside ``admit_session``'s verdicts.
8. [cluster] The cluster tier (``serve.cluster``) with worker processes
   sharing the card, each given half of the card's free memory (read after
   this process emptied its cache, less ``CLUSTER_MARGIN``) as its share:
   (a) two workers behind ``ClusterServer.serve_streams`` over (6)'s
   streams of the Table-1 graphs and FB107x9, each count equal to the
   resident one, K3 and K4 twice a block in the workers, the wall printed
   beside (6)'s in-process one; (b) NY-size sessions opened through the
   router until it raises ``BackpressureError`` (``checkpoint_every_bytes
   =None``), none queued on a worker, the router's ledger and each
   worker's ``bytes_in_use`` equal to ``worker_admission``'s predictions
   (the card's reserve included), each worker queueing one more asked past
   the router; every session fed NY's stream and closed to NY's count, one
   NY checkpoint spilled and timed; (c) an FB107x9 session migrated
   mid-stream onto a worker that served its block shape: exact count, no
   new ingest key, the evict and restore walls printed; (d) a worker
   SIGKILLed mid-stream, its sessions resurrected on the survivor from a
   checkpoint plus the journal and by a full replay, exact counts; (e) one
   worker of ``MESH_STAGES`` stages on the one card, which advertises
   ``mesh_devices = 0``: NY-size sessions placed to the router's refusal
   at ring width 1, verdict for verdict its own, and an FB107x9 count. The
   workers' kernel launches (their ``stats`` replies) join the main path's.
9. [lm] Yi-6B at full width and depth (32 layers, d_model 4,096, 32/4
   heads, d_ff 11,008, vocab 64,000; f32 weights drawn on the card from a
   seeded generator): ``LMServer.generate`` on 8 seeded prompts of 256 to
   1,024 tokens, 4 to a batch, 32 new tokens each; the same batches through
   ``prefill(use_flash=True)`` (the tf32x3 K6 once per layer, the other K6
   routes never) and ``decode_step``,
   whose last-token logits must agree with the server's chunked-attention
   prefill within 1e-3 of the largest logit; and ``prefill`` of a prompt
   less its last token plus one ``decode_step`` against ``forward`` of the
   whole prompt. The Yi-6B smoke config on the card against the CPU port.
   [lm bf16] The same with bf16 weights (12.12 GB, norm scales f32): the
   server, its chunked prefill timed as time to first token, and the flash
   prefill (the wgmma K6 once per layer, the other K6 routes never) and decode steps
   with a bf16 KV cache. The flash prefill's last-token logits must lie no
   farther from f32 arithmetic on the same weights than twice the chunked
   prefill's distance (FlashAttention's own accuracy test); their distance
   from the chunked prefill's is printed against 2e-2 of the largest logit,
   and where the two paths part, layer by layer.
10. [recsys] AutoInt at its full config (3.9M-row table): ``ctr_logits`` and
   ``retrieval_scores`` (100,000 candidates) on 16,384 seeded rows, and
   ``lookup_multihot(use_kernel=True)`` (K7) on 16,384 × 39 bags of 8 ids
   against ``use_kernel=False``; the smoke config on the card against the
   CPU port.
11. [lm deepseek] DeepSeek-V2-Lite (``configs/deepseek_v2_lite_16b.py``:
   27 layers, d_model 2,048, 16 heads, MLA with kv_lora 512 and nope 128 /
   rope 64 / v 128, 64 routed experts top-6 plus 2 shared, the first layer
   dense): (a) both DeepSeek smoke configs (V2-Lite's and V2 236B's, the
   one with q-LoRA) in f32 on the card against the CPU port, chunked and
   flash prefill and 8 decode steps within 1e-3 of the largest logit; (c)
   f32 at full width and ``DS_REDUCED_LAYERS`` layers (reduced: all 27
   would be 62.8 GB) through [lm]'s checks (server, flash prefill within
   1e-3 of the chunked one, forward); (b) bf16 at full width and depth,
   31.41 GB of weights drawn on the card: [lm bf16]'s checks (the server on
   the same 8 prompts, the flash prefill launching the wgmma K6 at head
   dims (192, 128) once per layer, decode, the flash prefill no farther from f32
   arithmetic — one f32 layer on the card at a time — than twice the
   chunked one), the share of (token, MoE layer) routed expert sets that
   differ between the flash and chunked paths, and one MLA and one MoE
   layer at full width against f32 arithmetic from the same bf16 inputs
   (routing equal as integers) within 2e-2 of the largest value.
12. Profiles one planner-chosen count of FNA.5 and of NY, one planner-chosen
   ``count_stream`` of NY and of YT, (a)'s interleaved ``serve_streams``,
   one Yi-6B flash prefill plus 32 decode steps in f32 and in bf16, and one
   DeepSeek-V2-Lite bf16 flash prefill plus 8 decode steps (with its
   device-to-host copies: each MoE layer reads its group sizes once), with
   ``torch.profiler``: host wall,
   device busy time, the device's idle share. Each window opens with marker
   kernels, and a profile counts only when it is consistent (a marker
   survived the profiler's loss of a session's first records, device busy
   above 0, CUDA kernel rows at least the port's launches in the run, a
   host-to-device copy row for each count); an inconsistent one is profiled
   again with four times the markers, and the third raises.
13. [train] Training (``train/``, ``launch/train.py``): (a) the yi_6b,
   deepseek_v2_lite_16b and autoint smoke configs, 3 train steps on the card
   and on the CPU port from the same weights, losses and every parameter
   and moment leaf within 1e-4 (relative, a leaf by its norm); (b) Yi-6B at
   full width cut to ``TRAIN_YI_LAYERS`` layers in f32 (reduced: all 32
   with gradients and moments would need 97.0 GB), 10 steps of 4 × 1,024
   tokens from ``LMTokenPipeline`` with remat and a 512-token chunked
   cross-entropy: every loss finite, the last below the first, and on
   step 0 remat + chunked cross-entropy equal to the plain loss within
   1e-5 and its gradient norm within 1e-4; step wall, tokens/s and peak
   memory printed; (c) DeepSeek-V2-Lite at full width, its dense layer and
   one MoE layer of 64 experts, 3 steps: aux above 0 and a nonzero router
   gradient; (d) AutoInt at its full 3.9M-row table, 20 steps of 16,384-row
   ``RecsysPipeline`` batches, the first batch's loss lower after them;
   (e) ``train_lm`` on the yi_6b smoke config, 8 steps against 4, a
   restore and 4 (rtol 1e-4), its card-written checkpoint restored on the
   CPU bit for bit; (f) outside the launch window, after one train step of
   the yi_6b and autoint smoke configs no weight requires grad, and the
   flash forward (K6) and K7's lookup run and equal a fresh model's loaded
   with the trained weights.
14. [ring attention] ``ring_attention`` at ``RING_ATTN`` (Yi-6B's attention
   width, S 16,384, f32, causal), on the stage chain and on
   ``make_ring_mesh(n, devices=[cuda:0] * n)`` for n = 2, 4, 8, each
   within rtol 2e-4, atol 2e-5 of ``chunked_attention`` on the card, TF32
   off; the walls printed beside the tf32x3 K6's on the same inputs.

15. [gnn] The GNNs (``models/gnn``, ``graphs/sampler.py``, the GNN train
   step): (a) the smoke configs of GIN (node, graph and sampled batches),
   GraphCast, DimeNet and MACE on the card and on the CPU port from the
   same weights (through ``convert``): the loss, every gradient leaf, and
   the parameters and moments after one ``make_gnn_train_step`` step within
   1e-4 (relative, a leaf by its norm); (b) GIN at its full config (5
   layers, d 64) at ``full_graph_sm`` (2,708 nodes, 5,278 drawn pairs both
   ways, 1,433 features), 10 steps, and at ``molecule`` as graph
   classification (128 graphs of 30 atoms, 64 edges each), 10 steps: every
   loss finite, the median step wall and peak memory printed; (c) GIN on
   ``minibatch_lg`` (232,965 nodes, 114,615,892 Chung-Lu edges drawn on
   the card into a host CSR, 602 features) through ``NeighborSampler`` at
   fanout (15, 10), 1,024 seeds a batch: the host sampler's wall apart
   from the card's step wall; (d) GraphCast at its full config (16 layers,
   d 512, 227 vars) on ``full_graph_sm``'s graph: forward, ``mse_loss``, 3
   steps; (e) DimeNet (6 blocks, d 128) and MACE (2 layers, d 128, l_max 2)
   at ``molecule`` (phantom-padded edges, graph ids, DimeNet's triplets):
   energies, ``mse_loss``, 3 steps each, and MACE's site energies (each
   atom its own graph) invariant on the card under a rotation plus
   translation (2e-3 of the molecule's largest site energy + 2e-4) and a
   node permutation (1e-4 of it); (f) GIN at ``ogb_products`` (2,449,029
   nodes, 61,859,140 Chung-Lu edges, 100 features): a forward and 2 steps,
   with their peaks; (g) the partitioned engine (``models/gnn/
   distributed.py``) on one-card meshes ``make_ring_mesh(S, devices=
   [cuda:0] * S)``: (g1) the four smoke configs at S = 1, 2, 4 on the
   reference test's graph, the loss and every gradient leaf within 1e-4
   (a leaf by its norm) of the single-device model on the card (DimeNet
   at S = 1; at S = 4, whose partition drops the triplets that cross
   shards as the reference's does, against the CPU port's partitioned
   loss); (g2) GIN at its full config at ``ogb_products`` ((f)'s graph,
   nodes padded to a multiple of 4 as the reference's dryrun cell pads
   them, relabelled by a seeded permutation where the busiest dst shard
   would hold over ``GNN_SKEW`` times E/S edges) through
   ``make_distributed_gnn_train_step`` at S = 4: its first loss within
   1e-4 of the single-device model's on the same weights, 2 steps, their
   walls and peak beside (f)'s; (g3) GraphCast and MACE at full width,
   ``compute_dtype`` bf16, at S = 4, after reckoning ``ogb_products`` for
   both (neither fits the card), on ``full_graph_sm``'s graph and
   ``molecule``: every matrix product of the bf16 loss on bf16 operands,
   the loss within ``GNN_BF16_REL`` of f32 and at least ``GNN_BF16_FLOOR``
   (and ``GNN_BF16_NOISE`` times two f32 runs' gap) away from it, 2 steps,
   the weights still float32.
16. [data-model mesh] The ``("data", "model")`` mesh (``launch.Mesh``,
   ``launch.sharding``, ``models.moe.moe_apply_ep``, the mesh LM steps) on
   one-card meshes ``make_local_mesh(data=, model=, devices=[cuda:0] *
   k)``: (a) the yi_6b and deepseek_v2_lite_16b smoke configs on (2, 4),
   (1, 4) and (4, 2) meshes, one ``make_lm_train_step(mesh=,
   seq_parallel=True, grad_specs=lm_param_specs(...))`` step and one
   ``make_lm_prefill(mesh=, seq_parallel=True)`` each against the CPU
   port's same call on the same weights (loss rtol 2e-5, logits 1e-5 of
   the largest, parameter and moment leaves 1e-4 by their norm), Yi's also
   against the card's plain step; (b) one DeepSeek-V2-Lite MoE layer at
   full width (64 experts, D 2,048, F 1,408, top-6) on 4 x 1,024 tokens on
   a (2, 4) mesh, f32 and bf16: at the default capacity against the CPU
   port's ``moe_apply_ep`` (1 x 1,024 tokens in bf16), the dropped share
   printed; at capacity E/k, where nothing drops, against the card's
   ``moe_apply`` (data rows routed differently by the two computations
   are left out and counted); (c) DeepSeek-V2-Lite bf16 at full depth:
   the mesh prefill on 4 x 1,024 tokens beside the single-device prefill
   on the same model (walls, peaks, finite logits) and each MoE layer's
   dropped share; (d) DeepSeek-V2-Lite at full width cut to 2 layers, f32,
   the mesh train step: its first loss on 2 x 256 tokens within 1e-4 of
   the CPU port's, then 3 steps of 4 x 1,024 (walls, tokens/s, peak).
17. [dryrun] The dry run on the production mesh (``launch.dryrun``,
   ``hlo_analysis``, ``analytic``): (a) ``run_cell`` on ``DRY_CELLS``, one
   cell a family, on the (16, 16) mesh of meta coordinates (nothing
   allocated): each ``ok``, its GiB a device and its three roofline terms
   at the H100's rates printed beside ``analytic``; (b) the triangle cell at
   ``dense_64k`` (n 65,536, density 0.3) realised on the card: U drawn from
   ``DRY_SEED`` in row chunks, the ring of ``DRY_RING_STAGES`` stages of one
   card (``make_ring_mesh(8, devices=[cuda:0] * 8)``, uint8 blocks of 4.29
   GB) with S² K2 launches, the stage chain with S² more and K1's count of
   the same U, the three equal as int64 (past 2³¹), the wall beside the dry
   run's roofline of the same cell on the same mesh shape and K2's int8
   bound; the count also equal to cuBLAS's (``torch._int_mm`` of U's row
   chunks with U, masked by U, summed in int64: no code of K1 or K2), and
   the ring's densest visit, one K2 launch whose sum passes 2³¹, equal to
   K2's plain version; (c) DeepSeek-V2-Lite bf16 at full depth prefilling 4 x 1,024
   tokens on the one-card (2, 4) mesh and Yi-6B at full width, 8 layers,
   f32, one train step of 4 x 1,024 tokens on a (1, 1) mesh of the card,
   both built by ``lm_cell``: the FLOPs counted on the card equal the meta
   count, and on (1, 1) the arguments on the card equal the dry run's
   argument bytes; the peak allocated beside the predicted peak.
18. [examples] Each ``examples/torch_*.py`` on the card in its own process
   (all six at once, their small arguments in ``EXAMPLES``), after the
   slices' windows and outside the main path's: each exits 0, which each
   does only when its own counts or losses check out.

Phases 2 to 11 are the main path: every kernel's launch count is set to 0
before them and must be above 0 after them. Phases 13 to 16 are later
slices' paths, each driven with the counts set to 0 just before it and
read just after: none reaches a hand-written kernel (the reference trains
through chunked attention and the plain lookup, K6 and K7 have no
backward, the reference's GNNs, the partitioned engine included, reach no
Pallas kernel, and neither do its mesh steps and its EP), so their counts
must stay 0. Phase 17 has its own window too, in which K2 launches exactly
2·S² times (the ring and the chain of (b)), K1 once, and nothing else,
besides the one K2 launch held against its plain version. Any
mismatch or exception exits non-zero. ``python3 chip_smoke.py --train``
runs phases 13 to 16 alone, ``--dryrun`` phase 17 alone, ``--examples``
phase 18 alone.
The last three lines are the ``kernels`` JSON line, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Imports nothing of JAX
and nothing of the reference package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
TABLE1 = ("DSJC.1", "DSJC.5", "DSJC.9", "FB107", "FNA.5", "NY")
METHODS = ("dense", "ring", "bitset_ring", "sparse", "mapreduce", "stream")
# Beside Table 1: the FB107 family (power-law, Facebook-ego-like) scaled to
# n = 17,199 — a graph past the plain dense path's reach (n > 16384) that has
# triangles, so every method's count there is held against the host oracle.
LARGE = ("FB107", 9.0)
LARGE_NAME = "FB107x9"
GRAPHS = TABLE1 + (LARGE_NAME,)
# Methods not run: FNA.5 is complete at full scale, so MapReduce's Round I at
# dmax 4471 needs ~40 GB per node batch, and the sparse path 10M searches of
# 8192 ids; FB107x9's hub (dmax 5074, padded to 8192) puts MapReduce's node
# batch of 256 rows at 256·8192² pairs, past the card's memory.
NOT_RUN = {"FNA.5": {"sparse", "mapreduce"}, LARGE_NAME: {"mapreduce"}}
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): int8 tensor ops, the
# device memory rate, FP32 on the CUDA cores, and bf16 and TF32 on the tensor
# cores. One copy, the port's src/repro_torch/launch/hlo_analysis.py (also
# the dry run's); a directory holding chip_smoke.py alone skips the import,
# and main() says what is missing.
SRC = os.path.join(HERE, "src")
if os.path.isdir(os.path.join(SRC, "repro_torch")):
    sys.path.insert(0, SRC)
    from repro_torch.launch.hlo_analysis import HBM_BW as PEAK_BYTES  # noqa: E402
    from repro_torch.launch.hlo_analysis import PEAK_F32_FLOPS, PEAK_INT8_OPS  # noqa: E402
    from repro_torch.launch.hlo_analysis import PEAK_FLOPS as PEAK_BF16_FLOPS  # noqa: E402
    from repro_torch.launch.hlo_analysis import PEAK_TF32_FLOPS  # noqa: E402
# The f32 tensor-core K6 does each product as three TF32 passes
TF32X3_PASSES = 3
# K6's routes (ops.kernel_route) and the kernel each launches
K6_ROUTES = {"fma": "flash_attention", "wgmma": "flash_attention_wgmma",
             "tf32x3": "flash_attention_tf32x3"}
# Yi-6B's attention at a long prefill: K6 is timed at this shape.
YI_ATTN = dict(b=1, hq=32, hkv=4, s=8192, d=128)
# DeepSeek-V2-Lite's MLA flash prefill: K6 at head dims (nope + rope, v) =
# (192, 128), 16 heads (as many kv heads), the LM phase's 4 prompts of
# 1,024 tokens. Checked through the tensor-core routes, with the ragged S
# and the smoke configs' (24, 16) (the FMA route, V padded by the wrapper)
# beside it, and timed.
DS_ATTN = dict(b=4, h=16, s=1024, d=192, dv=128)
DS_ATTN_CHECKS = ((4, 16, 1024, 192, 128), (4, 16, 127, 192, 128), (2, 4, 200, 24, 16))
# K2 against its plain version (each with and without the upper-triangular
# skip): ragged single tiles, several output tiles and contraction slices
K2_SHAPES = ((64, 64, 64), (100, 70, 130), (33, 1, 17), (512, 2048, 2048),
             (300, 513, 129), (129, 8200, 130), (200, 300, 9000))
# The first launches of K2, K1 and the tensor-core K6 routes run in a child
# process under this limit: a wrong mbarrier parity hangs the card rather
# than failing
PROBE_TIMEOUT_S = 180
# [profile] profiles a run again while its device rows disagree with the
# port's launches or lack its copies, this many times in all, then raises
PROFILE_TRIES = 3
# Marker kernels (torch.cuda._sleep's spin_kernel) that lead each profiled
# window: on the card the profiler drops the first few device records of a
# session, more of them the longer the process has run (PERF.md §6),
# so a window counts only when one of its markers survives. Four times as
# many on each retry.
PROFILE_MARKERS = 64
# Cycles of torch.cuda._sleep's spin kernel per millisecond, at an SM clock
# of 2 GHz, above the H100's maximum (1,980 MHz): a spin lasts at least as
# many milliseconds as asked
SPIN_CYCLES_PER_MS = 2_000_000
# time_ms queues its runs behind a spin this long: longer than the host
# takes to launch 50 runs of the quickest kernels (tens of µs each)
TIME_SPIN_MS = 20
# Long sequences of K6's sweep at D = 128 (many full key tiles, a ragged
# last), f32 and bf16
K6_LONG_S = (4097, 8192)
# K6 against its plain version at that shape: 1e-4 absolute in f32; in bf16
# that plus one bf16 ulp of the output (7 stored mantissa bits) plus 2^-8 of
# attention_ref(q, k, |v|) for the probabilities the wgmma kernel rounds to
# bf16 before P·V, elementwise.
F32_LONG_TOL = 1e-4
BF16_ULP = 2.0**-7
BF16_P_ROUND = 2.0**-8
# The [lm] flash prefill's last-token logits against the server's chunked
# prefill, as a fraction of the largest logit. bfloat16: both paths round P
# and the attention output to bf16 at different places over 32 layers of
# bf16 residual adds; bf16 keeps 8 significant bits (relative 2^-9 a
# rounding), and 2e-2 lets about ten such roundings line up. In float32 this
# is the gate; in bfloat16 it is printed beside the gate of
# ``bf16_logits_check``, since each bf16 path alone lies about 2e-2 of the
# largest logit from f32 arithmetic on the same weights (PERF.md).
LOGITS_REL = {"float32": 1e-3, "bfloat16": 2e-2}
# [lm deepseek] (c): DeepSeek-V2-Lite in f32 at full width is cut to this
# depth (its first, dense layer and three MoE layers): all 27 f32 layers
# would take 62.8 GB beside the Yi-6B models the phase runs next to
DS_REDUCED_LAYERS = 4
# [profile]: decode steps profiled after DeepSeek-V2-Lite's flash prefill
DS_PROFILE_STEPS = 8
# [serve streams] (b) and (c): every NY-size session runs this block size
# (the bitset ingest's (n, W) delta table is the same at any block; the
# hybrid sessions' block-local packing grows with B²)
SERVE_BLOCK = 8192
# [ring mesh]: the stages of the mesh, all on the one card
MESH_STAGES = 4
# [cluster]: the card's free memory left to this process beside the workers'
# shares (each worker's own CUDA context is inside its share, charged by its
# multiplexer's reserve)
CLUSTER_MARGIN = 1 << 30
# [cluster] (b): hybrid NY-size sessions fed a whole stream (the others one
# block; each hybrid block costs ~10 ms of ingest)
CLUSTER_HYBRIDS_FED = 4
# [ring mesh] (a) repeats each resident mesh count this many times back to
# back, with no synchronisation between them: a missing event between the
# stages' streams shows as counts that differ
MESH_REPEATS = 20
# [ring mesh] (a) prints the walls of the mesh and of the stage chain at
# these ring widths (the paper's Figures 12-13 question, on one card)
MESH_WIDTHS = (2, 4, 8)
# YT: SNAP com-Youtube's size (n nodes, m edge draws), the edges drawn by a
# Chung-Lu power law (the reference's tests/test_hybrid_stream.py generator)
YT = dict(n=1_134_890, m=2_987_624, alpha=0.85, seed=0)
# [train] (b): Yi-6B trains at full width cut to this depth, f32: 1.91 B
# parameters, 30.5 GB with gradients and AdamW moments (all 32 layers would
# need 97.0 GB, past the card's 80 GB); batches of TRAIN_BATCH rows of
# TRAIN_SEQ tokens from LMTokenPipeline, every block rematerialised and the
# cross-entropy TRAIN_CE_CHUNK tokens at a time
TRAIN_YI_LAYERS = 8
TRAIN_BATCH = 4
TRAIN_SEQ = 1024
TRAIN_CE_CHUNK = 512
TRAIN_STEPS = 10
# [train] (c): DeepSeek-V2-Lite at full width cut to its dense first layer
# and one MoE layer of 64 experts (1.09 B parameters, 17.4 GB with moments)
TRAIN_DS_LAYERS = 2
TRAIN_DS_STEPS = 3
# [train] (d): AutoInt at its full 3.9M-row table, RecsysPipeline batches
TRAIN_RECSYS_ROWS = 16_384
TRAIN_RECSYS_STEPS = 20
# [train] (a): the smoke configs' card-vs-CPU gate, relative: losses, and
# each parameter leaf by its norm (|| card - cpu || <= 1e-4 || cpu ||)
TRAIN_REL = 1e-4
# [ring attention]: Yi-6B's attention width at a long sequence, f32, causal
RING_ATTN = dict(b=1, h=32, s=16_384, d=128)
RING_WIDTHS = (2, 4, 8)
# [gnn]: the four GNN families at their published configs, on graphs of
# configs/shapes.py's GNN_SHAPES sizes drawn from GNN_SEED (nothing is
# downloaded). GIN takes GNN_GIN_STEPS steps, GraphCast, DimeNet and MACE
# GNN_GNN_STEPS; minibatch_lg draws GNN_MB_BATCHES sampled batches, a step
# each. minibatch_lg's d_feat is 0 in the shape: its n and m are Reddit's,
# so its features are Reddit's 602 wide; its CSR (and ogb_products' edges)
# are Chung-Lu draws with weights i^-GNN_ALPHA. GIN on molecule reads a
# one-hot of the GNN_SPECIES species DimeNet and MACE embed; a molecule's
# edges are its GNN_MOL_PAIRS nearest atom pairs both ways (the shape's 64),
# the batch's edges padded by GNN_MOL_PAD phantom edges.
GNN_SEED = 0
GNN_GIN_STEPS = 10
GNN_GNN_STEPS = 3
GNN_MB_BATCHES = 3
GNN_MB_FEAT = 602
GNN_ALPHA = 0.5
GNN_SPECIES = 16
GNN_MOL_PAIRS = 32
GNN_MOL_PAD = 128
# [gnn] (a): the smoke configs' card-vs-CPU gate, as [train] (a)'s
GNN_REL = 1e-4
# [gnn] (e): MACE's invariances on the card, the reference test's bounds
GNN_ROTATION = dict(rtol=2e-3, atol=2e-4)
GNN_PERMUTATION_RTOL = 1e-4
# [gnn] (g): the partitioned engine (models/gnn/distributed.py) on one-card
# meshes of these widths at the smoke configs, and at GNN_MESH_STAGES
# stages at full width; a graph whose busiest dst shard holds more than
# GNN_SKEW times E/S edges is relabelled by a permutation drawn from
# GNN_SEED first (partition_edges_by_dst pads every shard to the busiest)
GNN_MESH_WIDTHS = (1, 2, 4)
GNN_MESH_STAGES = 4
GNN_SKEW = 1.1
# (g2): the first distributed loss against the single-device model's on the
# same weights and graph, relative
GNN_MESH_REL = 1e-4
# (g3), bf16 (compute_dtype) against f32 on the same weights: GraphCast's
# loss relative; MACE's energy error |sqrt(L_bf16) - sqrt(L_f32)| as a share
# of the sum of its site energies' magnitudes: its loss is the square of a
# sum of site energies, each from products of three bf16 CG factors whose
# sums of up to ~10 terms round at every add (2^-9 each), so bf16 lands
# several percent off (4% at the smoke config on the CPU, 8.9% at d 32)
GNN_BF16_REL = {"graphcast": 2e-2, "mace": 0.25}
# and, in the same units, the least that gap may be: every weight and input
# rounded to bf16 (2^-9 relative each) moved the loss by 5.5e-4 to 6.3e-4
# (GraphCast) and 0.56 % to 1.02 % (MACE) on the card, while a float32 path
# run twice parts only by the order of its atomic adds. The gap must also be
# GNN_BF16_NOISE times the gap between two f32 runs, and every matrix
# product of the bf16 loss must take bf16 operands (utils.MatmulDtypes)
GNN_BF16_FLOOR = {"graphcast": 1e-5, "mace": 1e-5}
GNN_BF16_NOISE = 10
# [data-model mesh]: one-card ("data", "model") meshes (launch.make_local_mesh
# with devices=[cuda:0] * k). (a) the smoke configs on DM_SMOKE_MESHES, a
# batch of DM_SMOKE_BATCH, each train step and prefill against the CPU
# port's same call: loss rtol DM_LOSS_REL, logits within DM_LOGIT_REL of
# the largest, parameter and moment leaves within TRAIN_REL (a leaf by its
# norm)
DM_SMOKE_MESHES = ((2, 4), (1, 4), (4, 2))
DM_SMOKE_BATCH = (4, 32)
DM_LOSS_REL = 2e-5
DM_LOGIT_REL = 1e-5
# (b) one DeepSeek-V2-Lite MoE layer at full width on DM_MESH, DM_TOKENS
# tokens (4 x 1,024); the CPU port's EP on DM_CPU_TOKENS[dtype] of them (bf16
# matmuls on the host are slow); outputs within DM_EP_REL[dtype] of the
# largest, data rows whose routing the two devices pick differently left out
# and counted
DM_MESH = (2, 4)
DM_TOKENS = 4 * 1024
DM_CPU_TOKENS = {"float32": 4 * 1024, "bfloat16": 1024}
DM_EP_REL = {"float32": 2e-5, "bfloat16": 2e-2}
# (c) the bf16 model at full depth, a mesh prefill of DM_PREFILL (batch, seq)
DM_PREFILL = (4, 1024)
# (d) DeepSeek-V2-Lite at full width cut to TRAIN_DS_LAYERS, f32: the first
# mesh step against the CPU port's on DM_TRAIN_CHECK (batch, seq) within
# TRAIN_REL, then DM_TRAIN_STEPS timed steps of TRAIN_BATCH x TRAIN_SEQ
DM_TRAIN_CHECK = (2, 256)
DM_TRAIN_STEPS = 3
# [dryrun]: (a) the dry run's sweep, one cell a family, on the (16, 16) mesh of
# meta coordinates (no card; python -m repro_torch.launch.dryrun's run_cell)
DRY_CELLS = (("yi_6b", "train_4k"), ("deepseek_v2_lite_16b", "decode_32k"),
             ("gin_tu", "ogb_products"), ("autoint", "serve_bulk"), ("triangle", "dense_64k"))
# (b) the triangle cell realised on the card at dense_64k (n 65,536, density
# 0.3): U drawn from DRY_SEED on the card, a one-card ring of DRY_RING_STAGES
# stages (uint8 blocks of 4.29 GB in all), S² K2 visits
DRY_RING_STAGES = 8
DRY_SEED = 29
# rows of U a chunk in cuBLAS's independent count of (b) (an int32 product of
# 4,096 x 65,536 is 1.07 GB)
DRY_CHECK_ROWS = 4096
# (c) the LM cells realised on the card, each counted there and on meta:
# DeepSeek-V2-Lite bf16 at full depth prefilling DRY_LM_TOKENS (batch, seq)
# on the one-card DM_MESH, and Yi-6B at full width cut to TRAIN_YI_LAYERS,
# f32, one train step of DRY_LM_TOKENS on a (1, 1) mesh of the card
DRY_LM_TOKENS = (4, 1024)
# [examples]: each examples/torch_*.py on the card, its arguments, within
# EXAMPLE_TIMEOUT_S, all at once in their own processes
EXAMPLES = (("torch_quickstart.py",), ("torch_pipeline_vs_mapreduce.py",),
            ("torch_windowed_stream.py",), ("torch_serve_lm.py",),
            ("torch_train_lm.py", "--size", "tiny", "--steps", "30", "--batch", "4",
             "--seq", "32"),
            ("torch_ring_attention_500k.py",))
EXAMPLE_TIMEOUT_S = 300
# Issue rates outside the tensor cores, per SM per clock, for compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput): 32-bit integer add and bitwise logic 64, population count 16.
# Times this card's SM count and maximum SM clock, read at run time.
INT32_PER_SM_CLK = 64
POPC_PER_SM_CLK = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, *, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, CUDA events. A spin
    kernel of ``TIME_SPIN_MS`` runs first, so the host queues the runs while
    the card spins and the events time the card alone, also for a kernel
    that takes less time than its launch's host work."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(TIME_SPIN_MS * SPIN_CYCLES_PER_MS))
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def forward_u(g, n: int, device):
    """Strictly upper triangular uint8 U (n, n) of ``g`` under degree order."""
    import numpy as np
    import torch

    from repro_torch.graphs.formats import degree_order

    rank = degree_order(g)
    ru, rv = rank[g.edges[:, 0]], rank[g.edges[:, 1]]
    lo = torch.from_numpy(np.minimum(ru, rv).astype(np.int64)).to(device)
    hi = torch.from_numpy(np.maximum(ru, rv).astype(np.int64)).to(device)
    u = torch.zeros((n, n), dtype=torch.uint8, device=device)
    u[lo, hi] = 1
    return u


def host_count(g, chunk: int = 1 << 24) -> int:
    """Triangles of ``g`` counted on the host in numpy, by code of its own:
    orient every edge from the lower to the higher (degree, id), pair the
    out-edges of each node into wedges, and look each wedge's closing edge
    up among the sorted edge keys. Wedges go ``chunk`` at a time."""
    import numpy as np

    n = g.n_nodes
    e = g.edges.astype(np.int64)
    deg = np.bincount(e.ravel(), minlength=n)
    rank = np.empty(n, np.int64)
    rank[np.lexsort((np.arange(n), deg))] = np.arange(n)
    a, b = rank[e[:, 0]], rank[e[:, 1]]
    keys = np.unique(np.minimum(a, b) * n + np.maximum(a, b))
    lo, hi = keys // n, keys % n  # rows in order, each row's heads ascending
    row_end = np.searchsorted(lo, lo, side="right")
    later = row_end - np.arange(len(keys)) - 1  # out-edges after each one
    ends = np.cumsum(later)
    total, first = 0, 0
    while first < len(keys):
        last = max(int(np.searchsorted(ends, ends[first] - later[first] + chunk,
                                       side="right")), first + 1)
        cnt = later[first:last]
        src = np.repeat(np.arange(first, last), cnt)
        step = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt) + 1
        wedge = hi[src] * n + hi[src + step]
        pos = np.minimum(np.searchsorted(keys, wedge), len(keys) - 1)
        total += int((keys[pos] == wedge).sum())
        first = last
    return total


def plain_count(g) -> int:
    """The plain path: Σ U⊙(U·U) by the plain PyTorch version on the card
    where U fits (n ≤ 16384), else the host oracle ``host_count``."""
    from repro_torch.kernels.triangle_count.ref import triangle_count_ref

    if g.n_nodes <= 16384:
        return int(triangle_count_ref(forward_u(g, g.n_nodes, DEVICE)))
    return host_count(g)


def int_rates() -> tuple[float, float]:
    """This card's 32-bit integer and population-count issue rates, per
    second: the per-SM rates times its SM count and maximum SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    log(f"  issue rates from {sms} SMs at a maximum SM clock of {mhz:g} MHz")
    per_s = sms * mhz * 1e6
    return INT32_PER_SM_CLK * per_s, POPC_PER_SM_CLK * per_s


# --------------------------------------------------------------------------
# Phase 1: every kernel against its plain version on the card
# --------------------------------------------------------------------------
def check_kernels(graphs: dict) -> dict:
    import torch

    from repro_torch.api import bucket
    from repro_torch.core.triangle_pipeline import (
        build_bitset_ring_operands,
        build_dense_ring_operands,
        count_triangles_ring,
    )
    from repro_torch.core.triangle_ref import count_triangles_brute
    from repro_torch.graphs import generators as small_gen
    from repro_torch.kernels.bitset_count.ops import bitset_edge_count, bitset_pair_count
    from repro_torch.kernels.bitset_count.ref import (
        bitset_edge_count_ref,
        bitset_pair_count_ref,
    )
    from repro_torch.kernels.triangle_count.ops import (
        _sm_count,
        live_grid_size,
        masked_matmul_sum,
        masked_matmul_sum_ops,
        split_plan,
        triangle_count,
    )
    from repro_torch.kernels.triangle_count.ref import (
        TILE,
        masked_matmul_sum_ref,
        triangle_count_ref,
    )

    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = {}

    def rand01(*shape, p):
        return (torch.rand(*shape, generator=gen) < p).to(torch.uint8).to(DEVICE)

    def agree(name, shape, got, want):
        got, want = [int(x) for x in got.reshape(-1)], [int(x) for x in want.reshape(-1)]
        err = max(abs(a - b) for a, b in zip(got, want))
        log(f"  {name:20s} {str(shape):30s} kernel={got[:4]} plain={want[:4]} "
            f"{'match' if err == 0 else 'MISMATCH'}")
        if err != 0:
            raise AssertionError(f"{name} {shape}: kernel {got} != plain {want}")
        return err

    fna = graphs["FNA.5"]
    n_b = bucket(fna.n_nodes)  # 8192, as the dense path pads it
    # ---- K1: live-grid triangle count (K2's int8 wgmma tile, a batch a launch) ----
    n = fna.n_nodes
    fna_u = forward_u(fna, n_b, DEVICE)  # the dense path's bucket; its corner is FNA.5
    pad = rand01(8, 1024, 1024, p=0.3).triu(1)
    cases = [rand01(n_, n_, p=0.3).triu(1) for n_ in (1, 63, 100, 257, 1000)]
    cases += [rand01(16, 512, 512, p=0.5).triu(1),
              pad[0, :129, :129], pad[1, :1000, :1000],  # views of a padded buffer
              pad[:, :700, :700],                        # a batch of views
              pad[:3, :300, :300].contiguous(),          # rows of 300 bytes: the copy path
              fna_u, fna_u[:n, :n]]                      # the bucket, and the main path's view
    err = 0
    for u in cases:
        err = max(err, agree("triangle_count_live", tuple(u.shape), triangle_count(u),
                             triangle_count_ref(u)))
        err = max(err, agree("  (full-grid K2)", tuple(u.shape),
                             triangle_count(u, live_grid=False), triangle_count_ref(u)))
    if int(triangle_count(fna_u[:n, :n])) != math.comb(n, 3):
        raise AssertionError("FNA.5 is complete: K1 must count C(n, 3)")
    del cases, pad
    timed = {}
    for label, u in (("view", fna_u[:n, :n]), ("bucket", fna_u)):
        m = u.shape[0]
        uc = u.contiguous()  # _int_mm takes dense operands; copied outside the timing
        u8 = uc.view(torch.int8)
        agree("  (library _int_mm)", tuple(u.shape), (torch._int_mm(u8, u8) * uc).sum(),
              triangle_count_ref(u))
        # operations: 2·C(m, 3), the live multiply-adds of a strictly upper
        # U; the kernel's tiles do 2·128³ for each live block triple
        nb = -(-m // TILE)
        slice_, items = split_plan(m, m, m, True, _sm_count(0))
        timed[label] = dict(
            shape=[m, m],
            ms=time_ms(lambda: triangle_count(u), reps=50),
            plain_ms=time_ms(lambda: triangle_count_ref(u), reps=3),
            library_ms=time_ms(lambda: (torch._int_mm(u8, u8) * uc).sum(), reps=3),
            bound=(2 * math.comb(m, 3) / PEAK_INT8_OPS, (m * m + 8) / PEAK_BYTES),
            live_block_bound_ms=2 * TILE**3 * live_grid_size(nb) / PEAK_INT8_OPS * 1e3,
            work_items=items, slice=slice_)
        t = timed[label]
        log(f"  triangle_count_live at FNA.5's {label} {t['shape']}: kernel {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.3f} ms, _int_mm + mask + sum {t['library_ms']:.4f} ms, "
            f"bound {max(t['bound']) * 1e3:.4f} ms (live block triples "
            f"{t['live_block_bound_ms']:.4f}), {items} work items of up to {slice_} chunks")
        del uc, u8
    big = timed["bucket"]
    rows["triangle_count_live"] = dict(
        timed["view"], max_abs_err=err,
        at_bucket_shape=dict(
            shape=big["shape"], ms=big["ms"], plain_ms=big["plain_ms"],
            library_ms=big["library_ms"], bound_ms=max(big["bound"]) * 1e3,
            bound_by="operations" if big["bound"][0] >= big["bound"][1] else "bytes",
            live_block_bound_ms=big["live_block_bound_ms"]))
    del fna_u
    torch.cuda.empty_cache()

    # ---- K2: masked matmul-sum (int8 wgmma fed by TMA) ----
    err = 0
    for (R, K, N) in K2_SHAPES:
        a, b, m = rand01(R, K, p=0.4), rand01(K, N, p=0.4), rand01(R, N, p=0.5)
        for up in (False, True):
            err = max(err, agree(f"masked_matmul_sum{'(up)' if up else ''}", (R, K, N),
                                 masked_matmul_sum(a, b, m, upper_triangular=up),
                                 masked_matmul_sum_ref(a, b, m, upper_triangular=up)))
    # all ones: the count R·K·N = 3.4e10 is past 2³¹, against its closed form
    R, K, N = 2048, 2048, 8192
    a, b, m = (torch.ones(s, dtype=torch.uint8, device=DEVICE) for s in ((R, K), (K, N), (R, N)))
    err = max(err, agree("masked_matmul_sum", ("ones", R, K, N), masked_matmul_sum(a, b, m),
                         torch.tensor(R * K * N)))
    del a, b, m
    # a ring whose n_pad (24) breaks TMA's 16-byte row rule: every visit
    # takes the wrapper's copy path, and the ring's count equals the brute one
    tiny = small_gen.gnp(20, 0.5, seed=0)
    part, blocks = build_dense_ring_operands(tiny, 3, pad_to=8, device=DEVICE)
    R = part.rows_per_stage
    if part.n_pad % 16 == 0:
        raise AssertionError(f"the copy-path ring has n_pad {part.n_pad}, a multiple of 16")
    for s_ in range(3):
        for k in range(3):
            cols = blocks[s_][:, k * R:(k + 1) * R]
            err = max(err, agree("masked_matmul_sum", ("ring", R, R, part.n_pad, s_, k),
                                 masked_matmul_sum(cols, blocks[k], blocks[s_]),
                                 masked_matmul_sum_ref(cols, blocks[k], blocks[s_])))
    err = max(err, agree("  (ring count)", ("n_pad", part.n_pad),
                         torch.tensor(count_triangles_ring(tiny, n_stages=3, device=DEVICE)),
                         torch.tensor(count_triangles_brute(tiny))))
    # the ring's own operands, one (stage, block) visit over 4 stages: FNA.5
    # (timed as in earlier PRs) and FB107x9 (n = 17,199, the [compare] ring's
    # largest visit)
    timed = {}
    for name in ("FNA.5", LARGE_NAME):
        g = graphs[name]
        pad_to = bucket(-(-g.n_nodes // 4), minimum=8)
        part, blocks = build_dense_ring_operands(g, 4, pad_to=pad_to, device=DEVICE)
        R, n_pad = part.rows_per_stage, part.n_pad
        u_s, u_k = blocks[0], blocks[1]
        cols = u_s[:, R:2 * R]
        err = max(err, agree("masked_matmul_sum", (name, "ring", R, R, n_pad),
                             masked_matmul_sum(cols, u_k, u_s),
                             masked_matmul_sum_ref(cols, u_k, u_s)))
        c8, k8 = cols.contiguous().view(torch.int8), u_k.view(torch.int8)
        ops = masked_matmul_sum_ops(R, R, n_pad)  # 2·R·K·N, the op's flop formula
        big = name == LARGE_NAME
        timed[name] = dict(
            shape=[R, R, n_pad],
            ms=time_ms(lambda: masked_matmul_sum(cols, u_k, u_s), reps=10 if big else 50),
            plain_ms=time_ms(lambda: masked_matmul_sum_ref(cols, u_k, u_s), reps=1 if big else 3),
            library_ms=time_ms(lambda: (torch._int_mm(c8, k8) * u_s).sum(), reps=3),
            bound=(ops / PEAK_INT8_OPS, (R * R + 2 * R * n_pad + 8) / PEAK_BYTES))
        log(f"  masked_matmul_sum at {name}'s ring visit {timed[name]['shape']}: "
            f"kernel {timed[name]['ms']:.4f} ms, plain {timed[name]['plain_ms']:.3f} ms, "
            f"_int_mm + mask + sum {timed[name]['library_ms']:.4f} ms, bound "
            f"{max(timed[name]['bound']) * 1e3:.4f} ms")
        del blocks, u_s, u_k, cols, c8, k8
        torch.cuda.empty_cache()
    big = timed[LARGE_NAME]
    rows["masked_matmul_sum"] = dict(
        timed["FNA.5"], max_abs_err=err,
        at_fb107x9_shape=dict(
            shape=big["shape"], ms=big["ms"], plain_ms=big["plain_ms"],
            library_ms=big["library_ms"], bound_ms=max(big["bound"]) * 1e3,
            bound_by="operations" if big["bound"][0] >= big["bound"][1] else "bytes"))

    # ---- K3: bitset edge count ----
    err = 0
    for (npad, w, nb) in ((64, 2, 32), (128, 4, 57), (96, 1, 16), (1000, 100, 5000),
                          (4096, 33, 200_001)):
        masks = torch.randint(-2**31, 2**31 - 1, (npad, w), generator=gen,
                              dtype=torch.int64).to(torch.int32).to(DEVICE)
        e = torch.randint(0, npad, (nb, 2), generator=gen, dtype=torch.int32)
        e[torch.rand(nb, generator=gen) < 0.2, 0] = npad + 3  # phantom edges
        e[torch.rand(nb, generator=gen) < 0.1, 1] = npad      # clamped v
        e = e.to(DEVICE)
        err = max(err, agree("bitset_edge_count", (npad, w, nb),
                             bitset_edge_count(masks, e), bitset_edge_count_ref(masks, e)))
    # the bitset ring's own operands: FNA.5 over 4 stages
    pad_to = bucket(-(-fna.n_nodes // 4), minimum=8)
    edge_block = bucket(-(-fna.n_edges // 4), minimum=128)
    part, masks, edges = build_bitset_ring_operands(
        fna, 4, pad_to=pad_to, edge_block=edge_block, device=DEVICE)
    m0, e1 = masks[0], edges[1]
    err = max(err, agree("bitset_edge_count", ("ring",) + tuple(m0.shape) + tuple(e1.shape),
                         bitset_edge_count(m0, e1), bitset_edge_count_ref(m0, e1)))
    w = m0.shape[1]
    real = int((e1[:, 0] < m0.shape[0]).sum())
    # Operations: per word of every real edge an AND and an add on the
    # integer pipe and a popcount on its own, slower pipe. Bytes: the edge
    # block once, and both W-word rows of every real edge — the table is
    # read only through these gathers (at the memory rate; rows that L2
    # serves could come faster, a rate not measured here).
    int_rate, popc_rate = int_rates()
    words = real * w
    log(f"  bitset_edge_count bound inputs: {real} real edges of {e1.shape[0]}, W={w}")
    nbytes = e1.numel() * 4 + real * 2 * w * 4 + 8
    rows["bitset_edge_count"] = dict(
        shape=list(m0.shape) + list(e1.shape), max_abs_err=err,
        ms=time_ms(lambda: bitset_edge_count(m0, e1), reps=10),
        plain_ms=time_ms(lambda: bitset_edge_count_ref(m0, e1), reps=2),
        library_ms=None,
        bound=(max(2 * words / int_rate, words / popc_rate), nbytes / PEAK_BYTES))
    rows["bitset_edge_count_per_edge"] = check_per_edge(gen, agree, m0, e1, rows,
                                                        int_rate, popc_rate)
    del masks, edges, m0, e1

    # ---- K4: bitset pair count (two tables) ----
    def rand_words(*shape):
        x = torch.randint(-2**31, 2**31 - 1, shape, generator=gen, dtype=torch.int64)
        x[:, 0] |= -2**31  # bit 31 set in the first word of every row
        return x.to(torch.int32).to(DEVICE)

    err = 0
    for (npad, w, nb) in ((64, 1, 31), (96, 2, 57), (700, 33, 5001), (4472, 140, 200_003)):
        a, b = rand_words(npad, w), rand_words(npad, w)
        e = torch.randint(0, npad, (nb, 2), generator=gen, dtype=torch.int32)
        e[torch.rand(nb, generator=gen) < 0.2, 0] = npad + 3  # phantom edges
        e[torch.rand(nb, generator=gen) < 0.1, 1] = npad      # clamped v
        e = e.to(DEVICE)
        for x, y in ((a, b), (b, a)):  # a != b: both orders
            err = max(err, agree("bitset_pair_count", (npad, w, nb),
                                 bitset_pair_count(x, y, e), bitset_pair_count_ref(x, y, e)))
    # the main path's largest shape: NY's adjacency and the delta of one of
    # its planner-sized blocks, as the stream ingest hands them to K4
    adj, delta, ek = ny_block_operands(graphs["NY"])
    shape = ["NY"] + list(adj.shape) + list(ek.shape)
    for x, y in ((adj, delta), (delta, adj)):
        err = max(err, agree("bitset_pair_count", tuple(shape),
                             bitset_pair_count(x, y, ek), bitset_pair_count_ref(x, y, ek)))
    n, w = adj.shape
    # the mesh ingest's shard of the same block ([ring mesh] (b)): stage 1
    # of MESH_STAGES owns words [ws, 2·ws) of every row, and K3 and K4 run
    # on that (n, ws) slice
    ws = -(-w // MESH_STAGES)
    a1, d1 = adj[:, ws:2 * ws].contiguous(), delta[:, ws:2 * ws].contiguous()
    shard = ("NY shard 1 of", MESH_STAGES, n, ws) + tuple(ek.shape)
    agree("bitset_edge_count", shard, bitset_edge_count(a1, ek), bitset_edge_count_ref(a1, ek))
    for x, y in ((a1, d1), (d1, a1)):
        err = max(err, agree("bitset_pair_count", shard, bitset_pair_count(x, y, ek),
                             bitset_pair_count_ref(x, y, ek)))
    del a1, d1
    real = int((ek[:, 0] < n).sum())
    words = real * w
    log(f"  bitset_pair_count bound inputs: {real} real edges of {ek.shape[0]}, W={w}")
    rows["bitset_pair_count"] = dict(
        shape=shape[1:], max_abs_err=err,
        ms=time_ms(lambda: bitset_pair_count(adj, delta, ek), reps=10),
        plain_ms=time_ms(lambda: bitset_pair_count_ref(adj, delta, ek), reps=2),
        library_ms=None,
        bound=(max(2 * words / int_rate, words / popc_rate),
               (ek.numel() * 4 + real * 2 * w * 4 + 8) / PEAK_BYTES))
    del adj, delta, ek
    torch.cuda.empty_cache()
    rows.update(check_attention(gen))
    rows["embedding_bag"] = check_embedding_bag(gen)
    return rows


def check_per_edge(gen, agree, m_k3, e_k3, rows: dict, int_rate: float,
                   popc_rate: float) -> dict:
    """K5 against its plain version as exact integers: ragged B, phantom u
    and real u with phantom v; K3's timed operands; and the hybrid stream's
    shape at YT, a (2B, W) = (16,384 × 35,466) table closed over edges
    (e, B + e), one in ten dead (the phantom id 2B). Timed beside K3 at both
    timed shapes; bound by bytes: both W-word rows of every real edge and
    the edges at the memory rate."""
    import torch

    from repro_torch.kernels.bitset_count.ops import (
        bitset_edge_count,
        bitset_edge_count_per_edge,
    )
    from repro_torch.kernels.bitset_count.ref import bitset_edge_count_per_edge_ref

    def bound(masks, e):
        w = masks.shape[1]
        real = int((e[:, 0] < masks.shape[0]).sum())
        words = real * w
        return real, (max(2 * words / int_rate, words / popc_rate),
                      (e.numel() * 4 + real * 2 * w * 4 + 8) / PEAK_BYTES)

    err = 0
    for (npad, w, nb) in ((64, 2, 31), (96, 1, 16), (1000, 100, 5001), (700, 257, 20_000)):
        masks = torch.randint(-2**31, 2**31 - 1, (npad, w), generator=gen,
                              dtype=torch.int64).to(torch.int32).to(DEVICE)
        e = torch.randint(0, npad, (nb, 2), generator=gen, dtype=torch.int32)
        e[torch.rand(nb, generator=gen) < 0.2, 0] = npad + 3  # phantom edges
        e[torch.rand(nb, generator=gen) < 0.1, 1] = npad      # real u, phantom v
        e[0] = torch.tensor([1, npad])
        e = e.to(DEVICE)
        err = max(err, agree("bitset_edge_count_per_edge", (npad, w, nb),
                             bitset_edge_count_per_edge(masks, e),
                             bitset_edge_count_per_edge_ref(masks, e)))
    err = max(err, agree("bitset_edge_count_per_edge", ("K3's",) + tuple(m_k3.shape)
                         + tuple(e_k3.shape), bitset_edge_count_per_edge(m_k3, e_k3),
                         bitset_edge_count_per_edge_ref(m_k3, e_k3)))
    real, (ops_s, bytes_s) = bound(m_k3, e_k3)
    at_k3 = dict(shape=list(m_k3.shape) + list(e_k3.shape), real_edges=real,
                 ms=time_ms(lambda: bitset_edge_count_per_edge(m_k3, e_k3), reps=5),
                 k3_ms=rows["bitset_edge_count"]["ms"], bound_ms=max(ops_s, bytes_s) * 1e3)
    b, w = 8192, -(-YT["n"] // 32)
    table = torch.randint(-2**31, 2**31 - 1, (2 * b, w), generator=torch.Generator(
        device=DEVICE).manual_seed(5), dtype=torch.int32, device=DEVICE)
    ar = torch.arange(b, dtype=torch.int32)
    dead = torch.rand(b, generator=gen) < 0.1
    e = torch.where(dead[:, None], 2 * b, torch.stack([ar, ar + b], 1)).to(torch.int32)
    e = e.to(DEVICE)
    err = max(err, agree("bitset_edge_count_per_edge", ("YT", 2 * b, w, b),
                         bitset_edge_count_per_edge(table, e),
                         bitset_edge_count_per_edge_ref(table, e)))
    agree("  (K3, same operands)", ("YT", 2 * b, w, b), bitset_edge_count(table, e),
          bitset_edge_count_per_edge_ref(table, e))
    real, bnd = bound(table, e)
    log(f"  bitset_edge_count_per_edge bound inputs: {real} real edges of {b}, W={w}; at "
        f"K3's shape {at_k3['real_edges']} real edges, W={m_k3.shape[1]}")
    row = dict(shape=[2 * b, w, b], max_abs_err=err, library_ms=None, bound=bnd,
               ms=time_ms(lambda: bitset_edge_count_per_edge(table, e), reps=10),
               k3_ms=time_ms(lambda: bitset_edge_count(table, e), reps=10),
               plain_ms=time_ms(lambda: bitset_edge_count_per_edge_ref(table, e), reps=2),
               at_k3_shape=at_k3)
    log(f"  bitset_edge_count_per_edge: YT shape {row['ms']:.4f} ms (K3 {row['k3_ms']:.4f} "
        f"ms, bound {max(bnd) * 1e3:.4f} ms); K3's shape {at_k3['ms']:.4f} ms (K3 "
        f"{at_k3['k3_ms']:.4f} ms, bound {at_k3['bound_ms']:.4f} ms)")
    del table
    torch.cuda.empty_cache()
    return row


def close(got, want, tol: float) -> tuple[float, bool]:
    """(max |got - want|, whether |got - want| <= tol + tol·|want| holds
    everywhere): the rtol = atol = tol test of the reference's kernel
    tests (``np.testing.assert_allclose``), in float32."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return float(diff.max()), bool((diff <= tol + tol * want.abs()).all())


def check_attention(gen) -> dict:
    """K6 on its three routes against its plain version. The sweep: f32 and
    bf16, Hq/Hkv in {4/4, 8/2, 32/4}, D in {16, 64, 128}, S in {1, 127, 200,
    1000}, causal and full, within 2e-5 (f32) and 3e-2 (bf16) — the
    reference kernel test's tolerances — plus f32 and bf16 at D = 128,
    Hq/Hkv = 8/2, S in ``K6_LONG_S``, within ``F32_LONG_TOL`` (f32) and
    3e-2 (bf16); at D = 64 and 128 bf16 must take the wgmma kernel and f32
    the tf32x3 kernel, every other case the FMA kernel. Then at Yi-6B's
    width (``YI_ATTN``): f32 through the tf32x3 kernel and through the FMA
    kernel within ``F32_LONG_TOL``; bf16 through the wgmma kernel within
    ``F32_LONG_TOL`` + 2^-7·|want| + 2^-8·attention_ref(q, k, |v|),
    elementwise. Times each tensor-core route there beside its plain
    version, SDPA and the FMA kernel on the same inputs (the route's
    "before"), and again at the LM's prefill shape (4 × 1,024 tokens), where
    f32 is also held within 2e-5. Returns each kernel's row by its registry
    name (the FMA kernel's at ``YI_ATTN`` in f32)."""
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def run(q, k, v, causal=True):
        """flash_attention, checking that it launched its route once."""
        before = launch_counts()
        out = ops.flash_attention(q, k, v, causal=causal)
        want_route = ops.kernel_route(q.dtype, q.shape[-1], v.shape[-1])
        after = launch_counts()
        for route, name in K6_ROUTES.items():
            if after[name] - before[name] != (route == want_route):
                raise AssertionError(f"flash_attention {q.dtype} D={q.shape[-1]} "
                                     f"Dv={v.shape[-1]}: launched {name} "
                                     f"{after[name] - before[name]} times")
        return out

    def fma(q, k, v):
        return ops._launch_fma(q, k, v, True)

    def qkv(b, hq, hkv, s, d, dtype):
        return tuple(torch.randn(b, h, s, d, generator=gen).to(dtype).to(DEVICE)
                     for h in (hq, hkv, hkv))

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                enable_gqa=True)

    cases = [(dtype, 2, hq, hkv, s, d) for dtype in (torch.float32, torch.bfloat16)
             for hq, hkv in ((4, 4), (8, 2), (32, 4)) for d in (16, 64, 128)
             for s in (1, 127, 200, 1000)]
    cases += [(dtype, 1, 8, 2, s, 128) for dtype in (torch.float32, torch.bfloat16)
              for s in K6_LONG_S]
    worst = dict.fromkeys(K6_ROUTES, 0.0)
    n = dict.fromkeys(K6_ROUTES, 0)
    for dtype, b, hq, hkv, s, d in cases:
        tol = 3e-2 if dtype == torch.bfloat16 else 2e-5 if s <= 1000 else F32_LONG_TOL
        q, k, v = qkv(b, hq, hkv, s, d, dtype)
        route = ops.kernel_route(dtype, d)
        for causal in (True, False):
            err, ok = close(run(q, k, v, causal), attention_ref(q, k, v, causal=causal), tol)
            n[route] += 1
            if not ok:
                raise AssertionError(
                    f"flash_attention ({route}) {dtype} B={b} Hq={hq} Hkv={hkv} D={d} S={s} "
                    f"causal={causal}: max abs err {err}, not within rtol = atol = {tol}")
            worst[route] = max(worst[route], err)
        del q, k, v
    log(f"  flash_attention      {n['fma']} cases through the FMA kernel (D = 16), "
        f"{n['tf32x3']} through the tf32x3 kernel (f32 at D = 64, 128) and {n['wgmma']} "
        f"through the wgmma kernel (bf16 at D = 64, 128) match within rtol = atol = 2e-5 "
        f"(f32; {F32_LONG_TOL:g} at S = {', '.join(map(str, K6_LONG_S))}) and 3e-2 (bf16): "
        f"max abs err FMA {worst['fma']:.3e}, tf32x3 {worst['tf32x3']:.3e}, wgmma "
        f"{worst['wgmma']:.3e}")
    torch.cuda.empty_cache()

    b, hq, hkv, s, d = (YI_ATTN[x] for x in ("b", "hq", "hkv", "s", "d"))
    flops = 4 * b * hq * d * s * (s + 1) / 2
    peaks = {"tf32x3": PEAK_TF32_FLOPS / TF32X3_PASSES, "wgmma": PEAK_BF16_FLOPS}
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        route = ops.kernel_route(dtype, d)
        q, k, v = qkv(b, hq, hkv, s, d, dtype)
        want = attention_ref(q, k, v).float()
        if dtype == torch.float32:
            limit, text = F32_LONG_TOL, f"{F32_LONG_TOL:g}"
        else:
            # one bf16 rounding of the output (2^-7 of |want|), and the first-
            # order bound of storing each unnormalised probability in bf16
            # before P·V (relative 2^-9 each, twice for l): 2^-8 of Σ p|v| / l
            limit = (F32_LONG_TOL + BF16_ULP * want.abs()
                     + BF16_P_ROUND * attention_ref(q, k, v.abs()).float())
            text = f"{F32_LONG_TOL:g} + 2^-7 |want| + 2^-8 attention_ref(q, k, |v|)"
        errs = {}
        checks = [(K6_ROUTES[route], run)]
        if dtype == torch.float32:
            checks.append(("flash_attention", fma))
        for name, fn in checks:
            diff = (fn(q, k, v).float() - want).abs()
            errs[name] = float(diff.max())
            ratio = float((diff / limit).max())
            log(f"  flash_attention      Yi-6B width {tuple(q.shape)} kv {tuple(k.shape)} "
                f"{dtype} ({name}): max abs err {errs[name]:.3e}, max |diff| / limit "
                f"{ratio:.3f} (limit {text})")
            if not ratio <= 1.0:
                raise AssertionError(f"{name} at Yi-6B's width, {dtype}: max |diff| / limit "
                                     f"{ratio} > 1 (max abs err {errs[name]})")
            del diff
        del want, limit
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        peak = peaks[route]
        row = rows[K6_ROUTES[route]] = dict(
            shape=[b, hq, hkv, s, d], dtype=str(dtype).removeprefix("torch."),
            max_abs_err=max(worst[route], errs[K6_ROUTES[route]]), match=True,
            ms=time_ms(lambda: ops.flash_attention(q, k, v), reps=20),
            plain_ms=time_ms(lambda: attention_ref(q, k, v), reps=2),
            library_ms=time_ms(lambda: sdpa(q, k, v), reps=5 if route == "tf32x3" else 20),
            bound=(flops / peak, nbytes / PEAK_BYTES))
        # the FMA kernel on the same inputs: this route's "before"
        before_ms = time_ms(lambda: fma(q, k, v), reps=3)
        if route == "tf32x3":
            rows["flash_attention"] = dict(
                row, max_abs_err=max(worst["fma"], errs["flash_attention"]), ms=before_ms,
                bound=(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES))
            row.update(fma_f32_ms=before_ms, fma_bound_ms=flops / PEAK_F32_FLOPS * 1e3)
        else:
            row["fma_bf16_ms"] = before_ms
        log(f"  flash_attention      {dtype} at Yi-6B's width: {route} {row['ms']:.4f} ms, "
            f"FMA kernel {before_ms:.4f} ms, SDPA {row['library_ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {flops / peak * 1e3:.4f} ms"
            + (f" (FMA pipes {flops / PEAK_F32_FLOPS * 1e3:.4f} ms)" if route == "tf32x3"
               else ""))
        del q, k, v
        torch.cuda.empty_cache()

    # both tensor-core routes at the LM's prefill shape: 4 prompts of 1,024
    # tokens, f32 held within 2e-5
    pre_flops = 4 * 4 * hq * d * 1024 * 1025 / 2
    for dtype in (torch.float32, torch.bfloat16):
        route = ops.kernel_route(dtype, d)
        q, k, v = qkv(4, hq, hkv, 1024, d, dtype)
        peak = peaks[route]
        pre = dict(shape=[4, hq, hkv, 1024, d],
                   ms=time_ms(lambda: ops.flash_attention(q, k, v), reps=50),
                   library_ms=time_ms(lambda: sdpa(q, k, v), reps=50),
                   bound_ms=pre_flops / peak * 1e3)
        if route == "tf32x3":
            err, ok = close(run(q, k, v), attention_ref(q, k, v), 2e-5)
            if not ok:
                raise AssertionError(f"flash_attention (tf32x3) at the LM's prefill shape: max "
                                     f"abs err {err}, not within rtol = atol = 2e-5")
            pre.update(max_abs_err=err, fma_ms=time_ms(lambda: fma(q, k, v), reps=10),
                       fma_bound_ms=pre_flops / PEAK_F32_FLOPS * 1e3)
        rows[K6_ROUTES[route]]["at_prefill_shape"] = pre
        log(f"  flash_attention      {dtype} at the LM's prefill shape {tuple(q.shape)}: "
            f"{route} {pre['ms']:.4f} ms, SDPA {pre['library_ms']:.4f} ms, bound "
            f"{pre['bound_ms']:.4f} ms"
            + (f"; FMA kernel {pre['fma_ms']:.4f} ms (bound {pre['fma_bound_ms']:.4f} ms), "
               f"max abs err {pre['max_abs_err']:.3e}" if route == "tf32x3" else ""))
        del q, k, v
        torch.cuda.empty_cache()
    mla = check_attention_mla(gen, run)
    for dtype, one in mla.items():
        rows[K6_ROUTES[one["route"]]]["at_deepseek_shape"] = one
    rows["flash_attention"]["at_deepseek_shape"] = {
        dtype: dict(ms=one["fma_ms"], bound_ms=one["fma_bound_ms"])
        for dtype, one in mla.items()}
    return rows


def check_attention_mla(gen, run) -> dict:
    """K6 at MLA's head dims (``DS_ATTN_CHECKS``, (D, Dv) with v unpadded):
    causal, f32 and bf16, within the reference kernel test's 2e-5 (f32) and
    3e-2 (bf16) of its plain version, each call one launch of the route
    ``ops.kernel_route`` names (``run``): the tensor-core routes at
    (192, 128), the FMA route (v padded by the wrapper) at (24, 16). Then
    timed at DeepSeek-V2-Lite's prefill shape (``DS_ATTN``) in both dtypes:
    the route's kernel, the FMA kernel on the same inputs with v padded to
    D (the route's "before": the path that pads v), SDPA (on v as it is,
    and padded), the plain version. Bounds: the work the function needs,
    2·B·H·(D + Dv)·S(S+1)/2 FLOPs, on the route's own units; and the count
    with v padded, 4·B·H·D·S(S+1)/2. Returns the rows by dtype."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def qkv(b, h, s, d, dv, dtype):
        return tuple(torch.randn(b, h, s, w, generator=gen).to(dtype).to(DEVICE)
                     for w in (d, d, dv))

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    for dtype in (torch.float32, torch.bfloat16):
        tol = 2e-5 if dtype == torch.float32 else 3e-2
        worst = {}
        for b, h, s, d, dv in DS_ATTN_CHECKS:
            route = ops.kernel_route(dtype, d, dv)
            q, k, v = qkv(b, h, s, d, dv, dtype)
            got = run(q, k, v)
            err, ok = close(got, attention_ref(q, k, v), tol)
            if not ok or got.shape != (b, h, s, dv):
                raise AssertionError(f"flash_attention ({route}) {dtype} B={b} H={h} S={s} "
                                     f"D={d} Dv={dv}: max abs err {err}, not within rtol = "
                                     f"atol = {tol} (or shape {tuple(got.shape)})")
            worst[route] = max(worst.get(route, 0.0), err)
            del q, k, v, got
        log(f"  flash_attention      MLA head dims (D, Dv) "
            f"{[(c[3], c[4]) for c in DS_ATTN_CHECKS]} (S {[c[2] for c in DS_ATTN_CHECKS]}), "
            f"{dtype}, causal, v unpadded: within rtol = atol = {tol:g}, max abs err "
            + ", ".join(f"{r} {e:.3e}" for r, e in worst.items()))
    b, h, s, d, dv = (DS_ATTN[x] for x in ("b", "h", "s", "d", "dv"))
    flops = 2 * b * h * (d + dv) * s * (s + 1) / 2
    padded = 4 * b * h * d * s * (s + 1) / 2
    peaks = {"tf32x3": PEAK_TF32_FLOPS / TF32X3_PASSES, "wgmma": PEAK_BF16_FLOPS}
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        route = ops.kernel_route(dtype, d, dv)
        q, k, v = qkv(b, h, s, d, dv, dtype)
        v_pad = F.pad(v, (0, d - dv))
        err, ok = close(run(q, k, v), attention_ref(q, k, v), 2e-5 if route == "tf32x3"
                        else 3e-2)
        nbytes = (2 * q.numel() + k.numel() + 2 * v.numel()) * q.element_size()
        row = out[str(dtype).removeprefix("torch.")] = dict(
            shape=[b, h, h, s, d, dv], route=route, max_abs_err=err, gflop=flops / 1e9,
            padded_gflop=padded / 1e9,
            ms=time_ms(lambda: ops.flash_attention(q, k, v), reps=50),
            fma_ms=time_ms(lambda: ops._launch_fma(q, k, v_pad, True), reps=10),
            plain_ms=time_ms(lambda: attention_ref(q, k, v), reps=3),
            library_ms=time_ms(lambda: sdpa(q, k, v), reps=20),
            library_padded_ms=time_ms(lambda: sdpa(q, k, v_pad), reps=20),
            bound_ms=flops / peaks[route] * 1e3, padded_bound_ms=padded / peaks[route] * 1e3,
            fma_bound_ms=padded / PEAK_F32_FLOPS * 1e3,
            bytes_bound_ms=nbytes / PEAK_BYTES * 1e3)
        log(f"  flash_attention      {dtype} at DeepSeek-V2-Lite's prefill shape q "
            f"{tuple(q.shape)} v {tuple(v.shape)} ({flops / 1e9:.2f} GFLOP; padded "
            f"{padded / 1e9:.2f}): {route} {row['ms']:.4f} ms (max abs err {err:.3e}), FMA "
            f"kernel on v padded {row['fma_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms (v "
            f"padded {row['library_padded_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms; "
            f"bound {row['bound_ms']:.4f} ms on the {route} route's units (padded count "
            f"{row['padded_bound_ms']:.4f} ms), FMA pipes {row['fma_bound_ms']:.4f} ms, "
            f"{row['bytes_bound_ms']:.4f} ms by bytes")
        if not ok:
            raise AssertionError(f"flash_attention ({route}) at DeepSeek-V2-Lite's prefill "
                                 f"shape, {dtype}: max abs err {err}")
        del q, k, v, v_pad
        torch.cuda.empty_cache()
    return out


def check_embedding_bag(gen) -> dict:
    """K7 against its plain version: f32 and bf16, ragged bags (several L,
    30% padding, any id >= V pads), an all-padding bag, ids at V - 1 and V,
    within 1e-6 (f32) and 3e-2 (bf16); then timed at AutoInt's full table
    (V = 39 * 100,000, D = 16, f32) on 16,384 * 39 bags of L = 8."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    def bags(v, n, l, pad=0.3):
        ids = torch.randint(0, v, (n, l), generator=gen, dtype=torch.int32)
        ids[torch.rand(n, l, generator=gen) < pad] = v
        if n > 2 and l:
            ids[0] = v + 7            # an all-padding bag (any id >= V)
            ids[1, 0], ids[2, -1] = v - 1, v
        return ids.to(DEVICE)

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in worst:
        tol = 1e-6 if dtype == torch.float32 else 3e-2
        for (v, d, n, l) in ((64, 16, 8, 4), (256, 128, 4, 10), (1000, 32, 16, 3),
                             (100, 13, 7, 5), (5000, 16, 100_000, 17), (7, 8, 5, 1)):
            table = torch.randn(v, d, generator=gen).to(dtype).to(DEVICE)
            ids = bags(v, n, l)
            got = embedding_bag(table, ids)
            err, ok = close(got, embedding_bag_ref(table, ids), tol)
            if not ok or got[0].any():
                raise AssertionError(f"embedding_bag {dtype} V={v} D={d} N={n} L={l}: max abs "
                                     f"err {err}, not within rtol = atol = {tol}, or padding "
                                     "summed")
            worst[dtype] = max(worst[dtype], err)
    cfg = get_config("autoint")
    v, d = cfg.n_sparse * cfg.vocab_per_field, cfg.embed_dim
    table = (torch.randn(v, d, generator=gen) * 0.01).to(DEVICE)
    ids = bags(v, 16_384 * cfg.n_sparse, 8)
    err, ok = close(embedding_bag(table, ids), embedding_bag_ref(table, ids), 1e-6)
    if not ok:
        raise AssertionError(f"embedding_bag at AutoInt's table: max abs err {err}, not "
                             "within rtol = atol = 1e-6")
    worst[torch.float32] = max(worst[torch.float32], err)
    real = int(((ids >= 0) & (ids < v)).sum())
    log(f"  embedding_bag        match within rtol = atol = 1e-6 (f32) and 3e-2 (bf16): "
        f"max abs err f32 {worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e}; "
        f"AutoInt table {v}x{d} f32, "
        f"{ids.shape[0]} bags of {ids.shape[1]}, {real} real ids")
    nbytes = real * d * 4 + ids.numel() * 4 + ids.shape[0] * d * 4
    safe, weights = ids.clamp(max=v - 1), (ids < v).to(table.dtype)
    row = dict(
        shape=[v, d, ids.shape[0], ids.shape[1]], max_abs_err=worst[torch.float32], match=True,
        ms=time_ms(lambda: embedding_bag(table, ids), reps=20),
        plain_ms=time_ms(lambda: embedding_bag_ref(table, ids), reps=3),
        library_ms=time_ms(lambda: torch.nn.functional.embedding_bag(
            safe, table, mode="sum", per_sample_weights=weights), reps=10),
        bound=(real * d / PEAK_F32_FLOPS, nbytes / PEAK_BYTES))
    del table, ids, safe, weights
    torch.cuda.empty_cache()
    return row


def ny_block_operands(g):
    """(adjacency, delta, phantom edges) of the last planner-sized block of
    a seeded shuffle of ``g``'s edges, after every earlier block has been
    ingested: K4's operands at the main path's largest shape."""
    import numpy as np
    import torch

    from repro_torch.api import GraphStats, Resources, plan
    from repro_torch.core import streaming

    stats = GraphStats(n_nodes=g.n_nodes, n_edges=0, replication_factor=0, max_degree=0,
                       max_fwd_degree=0, edges_in_memory=False)
    bs = plan(stats, Resources.detect(DEVICE)).block_size  # the planner's stream block
    e = g.edges[np.random.default_rng(7).permutation(g.n_edges)]
    last = max(len(e) // bs - 1, 0) * bs  # the start of the last full block
    state = streaming.init_state(g.n_nodes, device=DEVICE)
    for i in range(0, last, bs):
        streaming.ingest_block(state, e[i:i + bs])
    adj, n = state["adj"], g.n_nodes
    block = torch.from_numpy(np.ascontiguousarray(e[last:last + bs])).to(DEVICE)
    keep, lo, hi = streaming._canonical_live(block, n)
    live = keep & (streaming._stage_seen(adj, lo, hi, 0) == 0)
    idx, bits = streaming._delta_bits(n, adj.shape[1], lo, hi, live, 0)
    delta = streaming._delta_table(n, adj.shape[1], idx, bits)
    return adj, delta, streaming._phantom_edges(lo, hi, live, n)


# --------------------------------------------------------------------------
# Phases 2 and 3: the main path
# --------------------------------------------------------------------------
def serve_phase(graphs: dict, small: list) -> None:
    import torch

    from repro_torch.core.triangle_ref import count_triangles_brute
    from repro_torch.kernels import launch_counts
    from repro_torch.serve import TriangleServer

    server = TriangleServer(device=DEVICE)
    names = list(GRAPHS) + [f"small[{i}]" for i in range(len(small))]
    requests = [graphs[n] for n in GRAPHS] + small
    before = launch_counts()["triangle_count_live"]
    t0 = time.perf_counter()
    results = server.serve(requests)
    counts = [r.item() for r in results]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"  served {len(requests)} requests in {wall:.3f} s (host wall, synchronized)")
    dense_calls, batches = 0, set()
    for name, g, r, c in zip(names, requests, results, counts):
        log(f"  {name:10s} n={g.n_nodes:7d} m={g.n_edges:9d} method={r.plan.method:11s} "
            f"stages={r.plan.n_stages} count={c:13d} host_launch_s={r.wall_s:.4f}"
            + (" batched" if r.stats.get("batched") else ""))
        if r.stats.get("batched"):
            batches.add(id(r.stats["cache"]))  # one stats dict per batch call
        else:
            dense_calls += r.plan.method == "dense"
    # every dense count and every batch is exactly one live-grid launch
    k1 = launch_counts()["triangle_count_live"] - before
    if k1 != dense_calls + len(batches):
        raise AssertionError(f"live-grid launches {k1} != {dense_calls} dense counts "
                             f"+ {len(batches)} batches")
    for name, g, c in zip(names[len(GRAPHS):], small, counts[len(GRAPHS):]):
        want = count_triangles_brute(g)
        if c != want:
            raise AssertionError(f"{name}: served {c} != brute {want}")
    graphs["_served"] = dict(zip(GRAPHS, counts[:len(GRAPHS)]))


def comparison_phase(graphs: dict) -> None:
    from repro_torch.api import GraphStats, Resources, TriangleCounter, plan
    from repro_torch.kernels import launch_counts

    res = dataclasses.replace(Resources.detect(DEVICE), max_stages=4)
    counter = TriangleCounter(res, device=DEVICE)
    header = "  graph    " + "".join(f"{m:>20s}" for m in METHODS)
    log(header)
    for name in GRAPHS:
        g = graphs[name]
        stats = GraphStats.from_graph(g)
        t0 = time.perf_counter()
        want = plain_count(g)
        plain_s = time.perf_counter() - t0
        if stats.n_edges == stats.n_nodes * (stats.n_nodes - 1) // 2 \
                and want != math.comb(stats.n_nodes, 3):
            raise AssertionError(f"{name}: plain path {want} != C(n,3) of a complete graph")
        cells = []
        for method in METHODS:
            if method in NOT_RUN.get(name, ()):
                cells.append("not run")
                continue
            p = plan(stats, res, allow={method})
            if p.predicted_bytes > res.memory_bytes:
                cells.append("does not fit")
                continue
            k0 = launch_counts()
            t0 = time.perf_counter()
            r = counter.count(g, plan=p)
            c = r.item()
            dt = time.perf_counter() - t0
            k1 = launch_counts()
            if c != want:
                raise AssertionError(f"{name} {method}: {c} != plain path {want}")
            if method == "dense" and k1["triangle_count_live"] == k0["triangle_count_live"]:
                raise AssertionError(f"{name} dense did not launch the live-grid kernel")
            if method == "ring" and k1["masked_matmul_sum"] - k0["masked_matmul_sum"] \
                    != p.n_stages ** 2:
                raise AssertionError(f"{name} ring did not launch S² masked matmul-sums")
            if method == "bitset_ring" and k1["bitset_edge_count"] \
                    - k0["bitset_edge_count"] != p.n_stages ** 2:
                raise AssertionError(f"{name} bitset_ring did not launch S² edge counts")
            if method == "stream":
                check_stream_launches(f"{name} stream", k0, k1, r.stats["n_blocks"], 2, 2)
            cells.append(f"{dt * 1e3:.1f} ms S={p.n_stages}")
        served = graphs["_served"][name]
        if served != want:
            raise AssertionError(f"{name}: served {served} != plain path {want}")
        log(f"  {name:8s} " + "".join(f"{c:>20s}" for c in cells)
            + f"   count={want} (plain path {plain_s:.2f} s)")


def check_stream_launches(label: str, k0: dict, k1: dict, blocks: int, per_k3: int,
                          per_k4: int) -> None:
    """A stream on the card launches K3 ``per_k3`` and K4 ``per_k4`` times
    per block: (pre, dd) and the two mixed closures, once per epoch age in
    a window."""
    for name, per in (("bitset_edge_count", per_k3), ("bitset_pair_count", per_k4)):
        got = k1[name] - k0[name]
        if got != per * blocks:
            raise AssertionError(f"{label}: {name} launched {got} times, not "
                                 f"{per} x {blocks} blocks")


def ragged(e, rng, typical: int):
    """``e`` cut into blocks of ragged sizes around ``typical`` rows."""
    import numpy as np

    cuts = np.cumsum(rng.integers(1, 2 * typical, size=len(e) // typical + 2))
    return np.split(e, cuts[cuts < len(e)])


def stream_phase(graphs: dict) -> list:
    """Unbounded and windowed streams through the counter's entry points,
    and sessions checkpointed, spilled and restored. Returns the table rows
    of the unbounded streams."""
    import numpy as np
    import torch

    from repro_torch.api import GraphStats, Resources, SessionCheckpoint, TriangleCounter, plan
    from repro_torch.convert import graph_from_arrays
    from repro_torch.core import streaming
    from repro_torch.kernels import launch_counts

    counter = TriangleCounter(device=DEVICE)
    rng = np.random.default_rng(12)
    table = []
    for name in ("FNA.5", "NY", LARGE_NAME):
        g = graphs[name]
        blocks = ragged(g.edges[rng.permutation(g.n_edges)], rng, 50_000)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k0 = launch_counts()
        t0 = time.perf_counter()
        r = counter.count_stream(g.n_nodes, blocks)
        c = r.item()
        wall = time.perf_counter() - t0
        k1 = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if c != graphs["_served"][name]:
            raise AssertionError(f"{name}: streamed {c} != resident {graphs['_served'][name]}")
        nb = r.stats["n_blocks"]
        check_stream_launches(f"{name} count_stream", k0, k1, nb, 2, 2)
        row = dict(graph=name, n=g.n_nodes, m=g.n_edges, feeds=len(blocks), blocks=nb,
                   block_size=r.stats["block_size"], wall_ms=wall * 1e3, count=c,
                   k3=k1["bitset_edge_count"] - k0["bitset_edge_count"],
                   k4=k1["bitset_pair_count"] - k0["bitset_pair_count"],
                   state_bytes=r.stats["state_bytes"], peak_bytes=peak)
        table.append(row)
        log(f"  count_stream {name:8s} {len(blocks)} ragged feeds -> {nb} blocks of "
            f"{r.stats['block_size']}: count={c} wall={wall * 1e3:.3f} ms "
            f"K3={row['k3']} K4={row['k4']} state={row['state_bytes']} B "
            f"peak_allocated={peak} B")

    res = dataclasses.replace(Resources.detect(DEVICE), max_stages=4)
    window, n_epochs = 4, 8
    for name in (LARGE_NAME, "FNA.5"):
        g = graphs[name]
        epochs = np.array_split(g.edges[rng.permutation(g.n_edges)], n_epochs)
        k0 = launch_counts()
        t0 = time.perf_counter()
        feeds = [ragged(ep, rng, 20_000) for ep in epochs]
        r = counter.count_windowed(g.n_nodes, feeds, window=window)
        c = r.item()
        wall = time.perf_counter() - t0
        k1 = launch_counts()
        live = graph_from_arrays(g.n_nodes, np.concatenate(epochs[-window:]))
        want = counter.count(live, plan=plan(GraphStats.from_graph(live), res,
                                             allow={"bitset_ring"})).item()
        if c != want:
            raise AssertionError(f"{name}: window count {c} != resident recount {want}")
        check_stream_launches(f"{name} count_windowed", k0, k1, r.stats["n_blocks"],
                              window + 1, 2 * window)
        graphs.setdefault("_windowed", {})[name] = (feeds, c)  # [ring mesh] (c)
        log(f"  count_windowed {name:8s} window={window} of {n_epochs} epochs: "
            f"count={c} (resident bitset-ring recount {want}) blocks={r.stats['n_blocks']} "
            f"of {r.stats['block_size']} wall={wall * 1e3:.3f} ms")

    # checkpoints: halfway through an unbounded session, and mid-epoch in a
    # windowed one; spilled, restored on a fresh counter, finished
    g = graphs[LARGE_NAME]
    e = g.edges[rng.permutation(g.n_edges)]
    epochs = np.array_split(e, n_epochs)
    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("unbounded", "windowed"):
            if kind == "unbounded":
                ops = [("feed", b) for b in ragged(e, rng, 20_000)]
                cut, kw = len(ops) // 2, {}
            else:  # cut in the middle of epoch 5, after the window has slid
                ops, kw = [], {"window": window}
                for t, ep in enumerate(epochs):
                    ops += [("advance", None)] * (t > 0)
                    feeds = [("feed", b) for b in ragged(ep, rng, 3_000)]
                    if t == window + 1:
                        cut = len(ops) + len(feeds) // 2
                    ops += feeds

            def run(session, todo):
                for op, b in todo:
                    if op == "feed":
                        session.feed(b)
                    else:
                        session.advance()
                return session

            whole = run(counter.open_stream(g.n_nodes, **kw), ops)
            first = run(counter.open_stream(g.n_nodes, **kw), ops[:cut])
            ck = first.checkpoint()
            path = os.path.join(tmp, f"{kind}.npz")
            ck.spill(path)
            spilled = ck.disk_bytes
            rest = run(TriangleCounter(device=DEVICE).restore_stream(
                SessionCheckpoint.from_file(path)), ops[cut:])
            a, b = whole.finalize().item(), rest.finalize().item()
            sa, sb = streaming.snapshot_state(whole.state), streaming.snapshot_state(rest.state)
            same = all(np.array_equal(sa[k], sb[k]) and sa[k].dtype == sb[k].dtype
                       for k in sa) and sorted(sa) == sorted(sb)
            if a != b or not same:
                raise AssertionError(f"{kind} session restored from a checkpoint: count {b} "
                                     f"vs {a}, state arrays equal: {same}")
            log(f"  checkpoint {kind:9s} {LARGE_NAME}: cut after {cut} of {len(ops)} ops, "
                f"{ck.nbytes} B snapshot, {spilled} B spilled; restored count {b} = "
                f"uninterrupted {a}, every state array bit-identical ({sorted(sa)})")
    return table


# --------------------------------------------------------------------------
# Phase 5: the degree-aware hybrid stream state (main path too)
# --------------------------------------------------------------------------
def yt_stream():
    """(raw edge draws, simple graph) of YT: ``m`` Chung-Lu draws of both
    endpoints from weights i^-alpha over n nodes, seeded; the draws keep
    their duplicates and self-loops (the stream drops them), the graph is
    their canonical simple edge set (what the host oracle counts)."""
    import numpy as np

    from repro_torch.graphs.formats import canonical_edges

    n, m = YT["n"], YT["m"]
    rng = np.random.default_rng(YT["seed"])
    w = np.arange(1, n + 1, dtype=np.float64) ** -YT["alpha"]
    w /= w.sum()
    e = np.stack([rng.choice(n, m, p=w), rng.choice(n, m, p=w)], 1).astype(np.int32)
    return e, canonical_edges(e, n)


def hybrid_plan(n: int, hubs: int, cap: int, block: int = 8192):
    from repro_torch.api import Plan, Resources, backend_exec_flags
    from repro_torch.core.streaming import hybrid_state_nbytes

    return Plan(method="stream", block_size=block, state_layout="hybrid", hub_slots=hubs,
                tail_capacity=cap, hub_threshold=cap,
                predicted_bytes=hybrid_state_nbytes(n, hubs, cap),
                **backend_exec_flags(Resources.detect(DEVICE)),
                reason="hand-built hybrid plan (chip_smoke.py)")


def check_hybrid_launches(label: str, k0: dict, k1: dict, blocks: int) -> None:
    """A hybrid stream launches K5 once (``pre``), K4 twice (``mixed``) and
    K3 once (``dd``) per block."""
    for name, per in (("bitset_edge_count_per_edge", 1), ("bitset_pair_count", 2),
                      ("bitset_edge_count", 1)):
        got = k1[name] - k0[name]
        if got != per * blocks:
            raise AssertionError(f"{label}: {name} launched {got} times, not "
                                 f"{per} x {blocks} blocks")


def hybrid_phase(graphs: dict, stream_table: list) -> list:
    """The hybrid stream state, as the module docstring says. Returns the
    table rows; leaves YT's blocks and count in ``graphs`` for the profile."""
    import numpy as np
    import torch

    from repro_torch.api import GraphStats, Resources, SessionCheckpoint, TriangleCounter, plan
    from repro_torch.core import streaming
    from repro_torch.kernels import launch_counts

    counter = TriangleCounter(device=DEVICE)
    res = Resources.detect(DEVICE)
    table = []
    t0 = time.perf_counter()
    raw, g = yt_stream()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = host_count(g)
    log(f"  YT: n={g.n_nodes} draws={len(raw)} simple edges={g.n_edges} triangles={want} "
        f"(drawn in {gen_s:.1f} s, host oracle {time.perf_counter() - t0:.1f} s)")
    sparse = plan(GraphStats.from_graph(g), res, allow={"sparse"})
    if sparse.predicted_bytes <= res.memory_bytes:
        resident = counter.count(g, plan=sparse).item()
        if resident != want:
            raise AssertionError(f"YT: resident sparse count {resident} != host {want}")
        log(f"  YT resident sparse count on the card: {resident}")
    else:
        log(f"  YT resident sparse count: does not fit ({sparse.predicted_bytes} B predicted "
            f"of {res.memory_bytes} B); the host oracle is the reference")
    rng = np.random.default_rng(14)
    blocks = ragged(raw, rng, 50_000)
    graphs["_yt"] = (g.n_nodes, blocks, want)
    rows = [("YT", g.n_nodes, blocks, want, None, None)]
    plans = {}
    for name, hubs, cap in (("FNA.5", graphs["FNA.5"].n_nodes, 32), (LARGE_NAME, None, 32)):
        gx = graphs[name]
        if hubs is None:  # exactly the vertices whose degree reaches the tail capacity
            hubs = int((np.bincount(gx.edges.ravel(), minlength=gx.n_nodes) >= cap).sum())
        dense = next(r["count"] for r in stream_table if r["graph"] == name)
        if dense != graphs["_served"][name]:
            raise AssertionError(f"{name}: dense stream {dense} != resident")
        plans[name] = hybrid_plan(gx.n_nodes, hubs, cap)
        rows.append((name, gx.n_nodes, ragged(gx.edges[rng.permutation(gx.n_edges)], rng,
                                              20_000), dense, plans[name], hubs))
    for name, n, feeds, want_n, p, hubs in rows:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k0 = launch_counts()
        t0 = time.perf_counter()
        session = counter.open_stream(n, plan=p)  # count_stream, with the close traced
        for f in feeds:
            session.feed(f)
        # the close's one read of lost brings the hub slots used
        r, counters = traced_counters(session.finalize)
        c = r.item()
        wall = time.perf_counter() - t0
        del session
        k1 = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if r.plan.state_layout != "hybrid":
            raise AssertionError(f"{name}: the stream ran state_layout="
                                 f"{r.plan.state_layout!r}, not hybrid")
        if c != want_n or (name != "YT" and c != graphs["_served"][name]):
            raise AssertionError(f"{name}: hybrid stream {c} != {want_n}")
        if r.stats["state_bytes"] != r.plan.predicted_bytes:
            raise AssertionError(f"{name}: state bytes {r.stats['state_bytes']} != planned")
        nb = r.stats["n_blocks"]
        check_hybrid_launches(f"{name} hybrid count_stream", k0, k1, nb)
        used = counters["hybrid.hubs_used"]
        if hubs is not None and used != hubs:  # every slot taken by the end
            raise AssertionError(f"{name}: {used} of {hubs} hub slots used")
        row = dict(graph=name, n=n, feeds=len(feeds), blocks=nb,
                   block_size=r.stats["block_size"], hub_slots=r.plan.hub_slots,
                   tail_capacity=r.plan.tail_capacity, hubs_used=used, wall_ms=wall * 1e3,
                   count=c, state_bytes=r.stats["state_bytes"], peak_bytes=peak,
                   planner_chosen=p is None)
        table.append(row)
        log(f"  count_stream {name:8s} hybrid ({'planner' if p is None else 'hand-built'}: "
            f"H={r.plan.hub_slots} C={r.plan.tail_capacity} B={r.plan.block_size}) "
            f"{len(feeds)} ragged feeds -> {nb} blocks: count={c} wall={wall * 1e3:.3f} ms "
            f"hubs used={used} lost=0 state={row['state_bytes']} B "
            f"(predicted {r.plan.predicted_bytes} B) peak_allocated={peak} B")

    # a hybrid session on FB107x9 checkpointed halfway, spilled, restored on a
    # fresh counter and finished; the plan with too few hub slots raises
    g = graphs[LARGE_NAME]
    p = plans[LARGE_NAME]
    e = g.edges[rng.permutation(g.n_edges)]
    feeds = ragged(e, rng, 20_000)
    cut = len(feeds) // 2
    whole = counter.open_stream(g.n_nodes, plan=p)
    kept = counter.open_stream(g.n_nodes, plan=p)
    for b in feeds:
        whole.feed(b)
    for b in feeds[:cut]:
        kept.feed(b)
    ck = kept.checkpoint()
    with tempfile.TemporaryDirectory() as tmp:
        ck.spill(os.path.join(tmp, "hybrid.npz"))
        rest = TriangleCounter(device=DEVICE).restore_stream(SessionCheckpoint.from_file(ck.path))
    for b in feeds[cut:]:
        kept.feed(b)
        rest.feed(b)
    a, b_, k = whole.finalize().item(), rest.finalize().item(), kept.finalize().item()
    sa, sb = streaming.snapshot_state(kept.state), streaming.snapshot_state(rest.state)
    same = sorted(sa) == sorted(sb) and all(
        np.array_equal(sa[x], sb[x]) and sa[x].dtype == sb[x].dtype for x in sa)
    if not (a == b_ == k == graphs["_served"][LARGE_NAME]) or not same:
        raise AssertionError(f"hybrid session restored from a checkpoint: count {b_} vs "
                             f"uninterrupted {a}, state arrays equal: {same}")
    log(f"  checkpoint hybrid {LARGE_NAME}: cut after {cut} of {len(feeds)} feeds, "
        f"{ck.nbytes} B snapshot, {ck.disk_bytes} B spilled; restored count {b_} = "
        f"uninterrupted {a}; every state array equal to the session that kept going")
    lossy = hybrid_plan(g.n_nodes, p.hub_slots // 2, p.tail_capacity)
    s = counter.open_stream(g.n_nodes, plan=lossy)
    for b in feeds:
        s.feed(b)
    try:
        s.finalize()
    except RuntimeError as err:
        log(f"  lossy plan (H={lossy.hub_slots}): finalize raised: {err}")
    else:
        raise AssertionError("a hybrid session with too few hub slots finalized")
    return table


# --------------------------------------------------------------------------
# Phase 6: the serving tier's streams (main path too)
# --------------------------------------------------------------------------
def feed_round_robin(mux, feeds: dict, part: slice = slice(None)) -> None:
    """Feed each session of ``feeds`` (sid -> ragged blocks) the blocks of
    ``part``, one block a session in turn, through ``mux`` (a multiplexer,
    or a cluster router and its global session ids)."""
    todo = {sid: blocks[part] for sid, blocks in feeds.items()}
    for j in range(max((len(b) for b in todo.values()), default=0)):
        for sid, blocks in todo.items():
            if j < len(blocks):
                mux.feed(sid, blocks[j])


def timed_sync(fn):
    """(result, synchronised host wall in s) of ``fn()``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def traced_counters(fn):
    """(result, the tracer's counters) of ``fn()``, run with the tracer on;
    the tracer is off and empty again afterwards, also when ``fn`` raises."""
    from repro_torch import tracing

    tracing.enable()
    try:
        return fn(), tracing.drain()[1]
    finally:
        tracing.disable()
        tracing.drain()


def serve_streams_phase(graphs: dict) -> dict:
    """[serve streams]: many bitset and hybrid sessions on one card through
    ``StreamMultiplexer`` (module docstring, 6). Returns the summary;
    leaves (a)'s requests in ``graphs`` for the profile."""
    import gc

    import numpy as np
    import torch

    from repro_torch.api import (
        BackpressureError,
        Resources,
        StreamSession,
        TriangleCounter,
        planner,
    )
    from repro_torch.core import streaming
    from repro_torch.graphs.formats import canonical_edges
    from repro_torch.kernels import launch_counts
    from repro_torch.serve import StreamMultiplexer, TriangleServer

    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"  allocated at the start: {torch.cuda.memory_allocated()} B of {total} B")
    summary = {}

    # (a) every Table-1 graph and FB107x9 at once, sync and prefetched
    rng = np.random.default_rng(20)
    reqs = [(graphs[nm].n_nodes,
             ragged(graphs[nm].edges[rng.permutation(graphs[nm].n_edges)], rng, 50_000))
            for nm in GRAPHS]
    graphs["_serve_streams"] = reqs
    runs = {}
    for label, kw in (("sync", {}), ("prefetch_depth=2", {"prefetch_depth": 2,
                                                          "adaptive_block": True})):
        server = TriangleServer(device=DEVICE, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k0 = launch_counts()
        res, wall = timed_sync(lambda: server.serve_streams(reqs))
        counts = [r.item() for r in res]
        k1 = launch_counts()
        for nm, c in zip(GRAPHS, counts):
            if c != graphs["_served"][nm]:
                raise AssertionError(f"serve_streams {label} {nm}: {c} != resident "
                                     f"{graphs['_served'][nm]}")
        blocks = sum(r.stats["n_blocks"] for r in res)
        check_stream_launches(f"serve_streams {label}", k0, k1, blocks, 2, 2)
        runs[label] = dict(wall_ms=wall * 1e3, peak_bytes=torch.cuda.max_memory_allocated(),
                           blocks=blocks, counts=counts,
                           plan_block={nm: r.plan.block_size for nm, r in zip(GRAPHS, res)},
                           final_block={nm: r.stats["block_size"] for nm, r in zip(GRAPHS, res)})
        log(f"  (a) serve_streams {label}: {len(reqs)} sessions interleaved, {blocks} blocks, "
            f"wall={wall * 1e3:.3f} ms peak_allocated={runs[label]['peak_bytes']} B "
            f"K3={k1['bitset_edge_count'] - k0['bitset_edge_count']} "
            f"K4={k1['bitset_pair_count'] - k0['bitset_pair_count']}; block sizes "
            + ", ".join(f"{nm} {runs[label]['plan_block'][nm]}->{runs[label]['final_block'][nm]}"
                        for nm in GRAPHS))
        del server, res
    if runs["sync"]["counts"] != runs["prefetch_depth=2"]["counts"]:
        raise AssertionError("prefetched counts differ from the synchronous ones")
    summary["a"] = runs

    # (b) NY-size sessions opened until one queues; (c) a priority-1 open
    # preempts one of them at full state size
    ny, fb = graphs["NY"], graphs[LARGE_NAME]
    n = ny.n_nodes
    perm = np.random.default_rng(21).permutation(n)[:fb.n_nodes].astype(np.int32)
    mixed = canonical_edges(np.concatenate([ny.edges, perm[fb.edges]]), n)
    t0 = time.perf_counter()
    want_mixed = host_count(mixed)
    log(f"  NY + FB107x9 mapped onto NY's ids by a seeded permutation: m={mixed.n_edges}, "
        f"{want_mixed} triangles (host oracle, {time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(22)
    ny_feeds = ragged(ny.edges[rng.permutation(ny.n_edges)], rng, 50_000)
    mixed_feeds = ragged(mixed.edges[rng.permutation(mixed.n_edges)], rng, 50_000)
    res = Resources.detect(DEVICE)
    mux = StreamMultiplexer(TriangleCounter(res, device=DEVICE), block_size=SERVE_BLOCK)
    k0 = launch_counts()
    sids = []
    while not sids or mux.status(sids[-1]) == "active":
        sids.append(mux.open(n))
    queued = sids.pop()
    layout = {sid: mux._recs[sid].plan.state_layout for sid in sids}
    dense = [sid for sid in sids if layout[sid] == "bitset"]
    hybrid = [sid for sid in sids if layout[sid] == "hybrid"]
    reserve, pinned = mux.reserve_bytes, mux.bytes_in_use
    log(f"  (b) Resources.detect() budget {res.memory_bytes} B: {len(sids)} NY-size sessions "
        f"admitted ({len(dense)} bitset of {mux.state_bytes_of(dense[0])} B, {len(hybrid)} "
        f"hybrid of {min((mux.state_bytes_of(s) for s in hybrid), default=0)}-"
        f"{max((mux.state_bytes_of(s) for s in hybrid), default=0)} B) before one queued; "
        f"pinned {mux.bytes_in_use} B + reserve {reserve} B = "
        f"{mux.bytes_in_use + reserve} B")
    if len(dense) < 2 or mux.bytes_in_use + reserve > res.memory_bytes:
        raise AssertionError("the card's admission overcommits or admits too few bitsets")
    mixed_sids = {dense[0], dense[1], queued} | set(hybrid[:1])
    feeds = {sid: mixed_feeds if sid in mixed_sids else ny_feeds for sid in sids + [queued]}
    half = {sid: len(b) // 2 for sid, b in feeds.items()}
    torch.cuda.reset_peak_memory_stats()
    _, wall_1 = timed_sync(lambda: feed_round_robin(
        mux, {sid: b[:half[sid]] for sid, b in feeds.items()}))
    # (c) the victim is the oldest bitset session: lowest priority, largest state
    victim, twin = dense[0], dense[1]
    ck_wall, restore_wall = [], []
    plain_ckpt, plain_restore = StreamSession.checkpoint, TriangleCounter.restore_stream

    def timed_ckpt(session):
        ck, wall = timed_sync(lambda: plain_ckpt(session))
        ck_wall.append(wall)
        return ck

    def timed_restore(counter, ck):
        session, wall = timed_sync(lambda: plain_restore(counter, ck))
        restore_wall.append(wall)
        return session

    StreamSession.checkpoint = timed_ckpt
    try:
        hi, open_wall = timed_sync(lambda: mux.open(n, priority=1))
    finally:
        StreamSession.checkpoint = plain_ckpt
    if (mux.status(victim), mux.status(hi), mux.store.where(victim)) != \
            ("preempted", "active", "host"):
        raise AssertionError(f"priority-1 open: victim {mux.status(victim)}, "
                             f"new {mux.status(hi)}")
    parked = mux.store.host_bytes
    _, wall_2 = timed_sync(lambda: feed_round_robin(
        mux, {sid: b[half[sid]:] for sid, b in feeds.items()}))
    feed_round_robin(mux, {hi: mixed_feeds})
    TriangleCounter.restore_stream = timed_restore
    try:
        r_hi, close_wall = timed_sync(lambda: mux.close(hi))
    finally:
        TriangleCounter.restore_stream = plain_restore
    if mux.status(victim) != "active" or r_hi.item() != want_mixed:
        raise AssertionError(f"after the priority-1 close: victim {mux.status(victim)}, "
                             f"count {r_hi.item()} != {want_mixed}")
    for sid in (victim, twin):  # ingest the tails the buffers still hold
        session = mux._recs[sid].session
        tail = session.flush_ready()
        if tail is not None:
            session.ingest_ready(tail)
    a, b = mux._recs[victim].session.state, mux._recs[twin].session.state
    same = sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    del session, a, b  # hold no state past its close: the queued session needs the memory
    if not same:
        raise AssertionError("the restored session's state differs from its twin's")
    log(f"  (c) priority-1 open preempted session {victim}: checkpoint (tail ingest + D2H) "
        f"{ck_wall[0] * 1e3:.1f} ms of the open's {open_wall * 1e3:.1f} ms, {parked} B "
        f"parked in the host tier; readmitted at the priority-1 close: restore (H2D) "
        f"{restore_wall[0] * 1e3:.1f} ms of the close's {close_wall * 1e3:.1f} ms (with "
        f"the replay of its buffered feeds); every state array equal on the card to "
        f"session {twin}'s, fed the same edges without a break")
    results = {hi: (r_hi.item(), r_hi.stats["n_blocks"], r_hi.plan.state_layout)}
    for sid in [twin, queued] + [s for s in sids if s != twin]:
        kind = mux._recs[sid].plan.state_layout
        r = mux.close(sid)
        results[sid] = (r.item(), r.stats["n_blocks"], kind)
        if sid == twin and mux.status(queued) != "active":
            raise AssertionError("closing a session did not admit the queued one")
    torch.cuda.synchronize()
    k1 = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for sid, (c, _, _) in results.items():
        want = want_mixed if sid in mixed_sids | {hi} else graphs["_served"]["NY"]
        if c != want:
            raise AssertionError(f"NY-size session {sid}: {c} != {want}")
    nb = {kind: sum(v[1] for v in results.values() if v[2] == kind)
          for kind in ("bitset", "hybrid")}
    want_k = {"bitset_edge_count": 2 * nb["bitset"] + nb["hybrid"],
              "bitset_pair_count": 2 * (nb["bitset"] + nb["hybrid"]),
              "bitset_edge_count_per_edge": nb["hybrid"]}
    for name, w in want_k.items():
        if k1[name] - k0[name] != w:
            raise AssertionError(f"(b) {name} launched {k1[name] - k0[name]} times, not {w}")
    if peak + planner._CARD_FIXED_BYTES > res.memory_bytes:
        raise AssertionError(f"peak {peak} B past the budget less the fixed share")
    log(f"  (b) every admitted session fed its whole stream ({wall_1 + wall_2:.1f} s of "
        f"feeds), no out-of-memory error; {len(mixed_sids)} mixed sessions counted "
        f"{want_mixed} = host oracle, the others NY's {graphs['_served']['NY']}; closing "
        f"session {twin} admitted the queued session {queued}, which finished; "
        f"{nb['bitset']} bitset + {nb['hybrid']} hybrid blocks, launches as per block; "
        f"peak allocated {peak} B of the card's {total} B")
    summary["b"] = dict(budget=res.memory_bytes, admitted=len(sids), bitset=len(dense),
                        hybrid=len(hybrid), reserve=reserve, pinned=pinned,
                        peak_bytes=peak, total_bytes=total, feed_s=wall_1 + wall_2,
                        blocks=nb)
    summary["c"] = dict(state_bytes=parked, checkpoint_ms=ck_wall[0] * 1e3,
                        open_ms=open_wall * 1e3, restore_ms=restore_wall[0] * 1e3,
                        close_ms=close_wall * 1e3)
    del mux
    gc.collect()
    torch.cuda.empty_cache()

    # (d) spill and backpressure, then deadlines, at FB107x9's size
    counter = TriangleCounter(device=DEVICE)
    rng = np.random.default_rng(23)
    fb_feeds = [ragged(fb.edges[rng.permutation(fb.n_edges)], rng, 20_000) for _ in range(3)]
    fb_state = 4 * fb.n_nodes * (-(-fb.n_nodes // 32))
    probe = counter.open_stream(fb.n_nodes)
    probe.feed(fb.edges)
    with tempfile.TemporaryDirectory() as tmp:
        ck = probe.checkpoint()
        ck.spill(os.path.join(tmp, "probe.npz"))
        disk = ck.disk_bytes
        ck.discard()
        del probe, ck
        mux = StreamMultiplexer(counter, checkpoint_budget_bytes=int(1.5 * fb_state),
                                spill_dir=tmp, spill_budget_bytes=int(1.5 * disk))
        trio = [mux.open(fb.n_nodes) for _ in range(3)]
        feed_round_robin(mux, dict(zip(trio, fb_feeds)))
        mux.preempt(trio[0])
        mux.preempt(trio[1])
        where = [mux.store.where(s) for s in trio[:2]]
        try:
            mux.preempt(trio[2])
        except BackpressureError as err:
            refused = str(err)
        else:
            raise AssertionError("a third checkpoint fitted a disk budget of one")
        if where != ["disk", "host"] or mux.status(trio[2]) != "active" \
                or [mux.store.where(s) for s in trio[:2]] != where:
            raise AssertionError(f"spill tiers {where}, third {mux.status(trio[2])}")
        stats = mux.sched_stats
        counts = [mux.close(s).item() for s in trio]
        if counts != [graphs["_served"][LARGE_NAME]] * 3 or os.listdir(tmp) != []:
            raise AssertionError(f"spilled sessions counted {counts}")
    log(f"  (d) FB107x9 sessions of {fb_state} B: host budget {int(1.5 * fb_state)} B, "
        f"disk budget {int(1.5 * disk)} B (a {disk} B spill): the second preemption spilled "
        f"the first ({stats['spill_raw_bytes']} B raw, {stats['spill_disk_bytes']} B on disk, "
        f"ratio {stats['spill_compression']}), the third raised BackpressureError "
        f"({refused[:60]}...) and stayed active; all three counted {counts[0]}")
    now = [0.0]
    mux = StreamMultiplexer(counter, clock=lambda: now[0])
    idle, later = mux.open(fb.n_nodes, deadline_s=10), mux.open(fb.n_nodes, deadline_s=10)
    feed_round_robin(mux, {idle: fb_feeds[0], later: fb_feeds[1][:2]})
    now[0] = 16.0
    mux.reap()
    parked = [mux.status(s) for s in (idle, later)]
    r_idle = mux.close(idle)
    now[0] = 30.0
    mux.reap()
    r_later = mux.close(later)
    if parked != ["preempted", "preempted"] or r_idle.item() != graphs["_served"][LARGE_NAME] \
            or not (r_later.stats["cancelled"] and r_later.stats["expired"]):
        raise AssertionError(f"deadlines: {parked}, late close {r_idle.item()}, "
                             f"{r_later.stats}")
    log(f"  (d) deadlines of 10 s on an injected clock: idle at 16 s both parked; the late "
        f"close counted {r_idle.item()} from the host snapshot; idle again at 30 s the other "
        f"was cancelled (expired); expirations {mux.sched_stats['expirations']}")
    summary["d"] = dict(spill_disk_bytes=stats["spill_disk_bytes"],
                        spill_raw_bytes=stats["spill_raw_bytes"],
                        spill_compression=stats["spill_compression"])
    del mux, counter
    gc.collect()
    torch.cuda.empty_cache()

    # (e) a YT-size session admitted as hybrid under the detected budget
    n_yt, yt_blocks, want_yt = graphs["_yt"]
    mux = StreamMultiplexer(TriangleCounter(res, device=DEVICE))
    # the multiplexer's own verdict (card reserve included), as open() takes it
    verdict, _ = mux._admission(n_yt, mux.bytes_in_use, None,
                                preempt=mux.policy == "fair", block_size=mux.block_size)
    sid = mux.open(n_yt)
    rec = mux._recs[sid]
    p = rec.plan
    if (verdict.action != "admit-hybrid" or mux.status(sid) != "active"
            or p.state_layout != "hybrid"
            or (p.hub_slots, p.tail_capacity) != (verdict.plan.hub_slots,
                                                  verdict.plan.tail_capacity)):
        raise AssertionError(f"YT: {verdict.action} {mux.status(sid)} {p.state_layout}")
    session = rec.session
    k0 = launch_counts()
    _, wall = timed_sync(lambda: feed_round_robin(mux, {sid: yt_blocks}))
    plan_txt = (f"(e) YT admitted as {verdict.action} (H={p.hub_slots} C={p.tail_capacity} "
                f"B={p.block_size}")
    try:  # the close's one read of lost brings the hub slots used
        r, counters = traced_counters(lambda: mux.close(sid))
    except RuntimeError as err:
        # only the exact-count refusal of a plan that really lost endpoints
        # (close ingests the tail block first, so read the counter after it)
        lost = streaming.hybrid_lost(session.state)
        if lost == 0 or not re.search(r"dropped \d+ edge endpoint", str(err)):
            raise
        mux.kill(sid)
        log(f"  {plan_txt}) lost {lost} endpoints; close raised the exact-count "
            f"refusal: {err}")
        summary["e"] = dict(action=verdict.action, hub_slots=p.hub_slots, lost=lost)
    else:
        used = counters["hybrid.hubs_used"]
        c = r.item()
        k1 = launch_counts()
        if c != want_yt:
            raise AssertionError(f"YT through the multiplexer: {c} != {want_yt}")
        check_hybrid_launches("YT multiplexed", k0, k1, r.stats["n_blocks"])
        log(f"  {plan_txt}, {r.stats['state_bytes']} B charged): {len(yt_blocks)} feeds "
            f"-> {r.stats['n_blocks']} blocks in {wall * 1e3:.1f} ms, count {c} = host oracle, "
            f"hubs used {used}, lost 0; K5/K4/K3 1/2/1 a block")
        summary["e"] = dict(action=verdict.action, hub_slots=p.hub_slots,
                            state_bytes=r.stats["state_bytes"], wall_ms=wall * 1e3,
                            blocks=r.stats["n_blocks"], count=c, lost=0)
    del session, rec
    del mux
    gc.collect()
    torch.cuda.empty_cache()
    summary["f"] = mixed_admission(graphs, res)
    return summary


def mixed_admission(graphs: dict, res) -> dict:
    """[serve streams] (f): NY-size sessions opened on a multiplexer over a
    one-card mesh of ``MESH_STAGES`` stages until one queues, then a seeded
    mixed order of opens (priority 0 and 1), preemptions and closes; after
    every change each active session is fed one block of ``SERVE_BLOCK``
    rows of its own cursor into NY's shuffled edges. The first two opens
    and the ``mesh`` ones run a ``MESH_STAGES``-stage plan on the mesh; the
    planner sizes the rest, bitsets and then hybrids near the budget. An
    out-of-memory error raises; the pinned bytes and the reserve stay
    within the budget after every change. The script sets no allocator
    option: the multiplexer's first admission turns the allocator's
    expandable segments on, which the phase checks."""
    import gc

    import numpy as np
    import torch

    from repro_torch.api import TriangleCounter
    from repro_torch.launch import make_ring_mesh
    from repro_torch.serve import StreamMultiplexer

    ny = graphs["NY"]
    n = ny.n_nodes
    mesh = make_ring_mesh(MESH_STAGES, devices=[torch.device(DEVICE, 0)] * MESH_STAGES)
    mux = StreamMultiplexer(TriangleCounter(res, device=DEVICE, mesh=mesh),
                            block_size=SERVE_BLOCK)
    ring = stream_plan(n, res, MESH_STAGES)
    rng = np.random.default_rng(24)
    edges = ny.edges[rng.permutation(ny.n_edges)]
    cursor, kinds, log_ops = {}, set(), []
    torch.cuda.reset_peak_memory_stats()

    def changed(op: str) -> None:
        if mux.bytes_in_use + mux.reserve_bytes > res.memory_bytes:
            raise AssertionError(f"(f) after {op}: {mux.bytes_in_use} B pinned + "
                                 f"{mux.reserve_bytes} B reserve past the budget")
        for sid in list(mux._recs):
            if mux.status(sid) != "active":
                continue
            p = mux._recs[sid].plan
            kinds.add((p.state_layout, p.n_stages))
            pos = cursor.get(sid, 0)
            mux.feed(sid, edges[pos:pos + SERVE_BLOCK])
            cursor[sid] = (pos + SERVE_BLOCK) % len(edges)
        log_ops.append(op)

    sids = []
    t0 = time.perf_counter()
    while not sids or mux.status(sids[-1]) == "active":
        sids.append(mux.open(n, plan=ring if len(sids) < 2 else None))
        changed("open")
    filled = len(sids) - 1
    alloc_conf = {v: os.environ.get(v) for v in ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF")}
    expandable = None
    if DEVICE == "cuda":  # the card's allocator; a CPU rehearsal has none
        expandable = sum(seg["is_expandable"] for seg in torch.cuda.memory_snapshot())
        if "expandable" in str(alloc_conf) or not expandable:
            raise AssertionError(f"(f) allocator: {alloc_conf}, {expandable} expandable "
                                 "segments after the multiplexer's first admissions")
    order = ["open1"] + list(rng.permutation(
        ["open1", "mesh1", "preempt", "close", "close", "close", "open0", "open0"]))
    for op in order:
        live = [s for s in sids if mux.status(s) != "closed"]
        active = [s for s in live if mux.status(s) == "active"]
        if op.startswith(("open", "mesh")):
            sids.append(mux.open(n, priority=int(op[-1]),
                                 plan=ring if op.startswith("mesh") else None))
        elif op == "preempt":
            mux.preempt(active[int(rng.integers(len(active)))])
        else:
            mux.close(live[int(rng.integers(len(live)))])
        changed(op)
    # parked and queued sessions first: their closes free no device memory,
    # so nothing is restored only to be closed
    for sid in sorted(sids, key=lambda s: mux.status(s) == "active"):
        if mux.status(sid) != "closed":
            mux.close(sid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    want = {("bitset", MESH_STAGES), ("hybrid", 1), ("bitset", 1)}
    if not want <= kinds:
        raise AssertionError(f"(f) session kinds {sorted(kinds)} lack {sorted(want - kinds)}")
    log(f"  (f) mixed order on a {MESH_STAGES}-stage one-card mesh: {filled} NY-size "
        f"sessions admitted before one queued ({expandable} expandable allocator segments "
        f"by then, no allocator option set), then {' '.join(order)}, one block fed to "
        f"every active session after each change; kinds (layout, stages) "
        f"{sorted(kinds)}; sched {mux.sched_stats}; peak allocated {peak} B of the "
        f"{res.memory_bytes} B budget; no out-of-memory error; {wall:.1f} s")
    out = dict(filled=filled, order=order, kinds=sorted(kinds), peak_bytes=peak,
               sched=mux.sched_stats, wall_s=wall, expandable_segments=expandable)
    del mux
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phase 7: the dynamic pipeline's ring on a mesh of one card's streams
# --------------------------------------------------------------------------
def ring_operands(g, method: str, n_stages: int):
    """(spec, resident, stream) of a forced ``method`` ring over
    ``n_stages`` stages, padded as ``TriangleCounter`` pads them."""
    from repro_torch.api import bucket
    from repro_torch.core.triangle_pipeline import (
        bitset_ring_spec,
        build_bitset_ring_operands,
        build_dense_ring_operands,
        dense_ring_spec,
    )

    pad_to = bucket(max(-(-g.n_nodes // n_stages), 1), minimum=8)
    if method == "ring":
        part, blocks = build_dense_ring_operands(g, n_stages, pad_to=pad_to, device=DEVICE)
        return dense_ring_spec(part.rows_per_stage), blocks, blocks
    edge_block = bucket(max(-(-g.n_edges // n_stages), 1), minimum=128)
    _, masks, edges = build_bitset_ring_operands(g, n_stages, pad_to=pad_to,
                                                 edge_block=edge_block, device=DEVICE)
    return bitset_ring_spec(), masks, edges


def stream_plan(n: int, res, n_stages: int, window: int = 0):
    """The planner's stream plan for ``n`` nodes under ``res``, at
    ``n_stages`` stages."""
    from repro_torch.api import GraphStats, plan

    stats = GraphStats(n_nodes=n, n_edges=0, replication_factor=0, max_degree=0,
                       max_fwd_degree=0, edges_in_memory=False)
    return dataclasses.replace(plan(stats, res, window_epochs=window), n_stages=n_stages)


def ring_mesh_phase(graphs: dict) -> dict:
    """[ring mesh]: the dynamic pipeline's ring and the mesh ingests on a
    mesh of ``MESH_STAGES`` stages of the one card, each stage on its own
    CUDA stream (module docstring, 7). Returns the summary."""
    import gc

    import numpy as np
    import torch

    from repro_torch.api import GraphStats, Resources, TriangleCounter, admit_session, plan
    from repro_torch.core import streaming
    from repro_torch.core.dynamic_pipeline import DynamicPipeline, run_sequential
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import make_ring_mesh
    from repro_torch.serve import StreamMultiplexer, TriangleServer

    gc.collect()
    torch.cuda.empty_cache()
    S = MESH_STAGES
    card = torch.device(DEVICE, 0)
    mesh = make_ring_mesh(S, devices=[card] * S)
    detected = Resources.detect(DEVICE)
    summary = {}
    k_phase = launch_counts()

    # (a) the resident rings, forced as [compare] forces them
    res = dataclasses.replace(detected, max_stages=S)
    meshed, chain = TriangleCounter(res, device=DEVICE, mesh=mesh), TriangleCounter(res, device=DEVICE)
    kernel = {"ring": "masked_matmul_sum", "bitset_ring": "bitset_edge_count"}
    rows, walls = [], []
    for name in GRAPHS:
        g = graphs[name]
        want = graphs["_served"][name]
        stats = GraphStats.from_graph(g)
        for method in ("ring", "bitset_ring"):
            p = plan(stats, res, allow={method})
            if p.predicted_bytes > res.memory_bytes:
                log(f"  (a) {name:8s} {method:11s} does not fit, as in [compare]")
                continue
            if p.n_stages != S or not meshed.mesh_matches(p.n_stages):
                raise AssertionError(f"(a) {name} {method}: a plan of {p.n_stages} stages")
            r_chain = chain.count(g, plan=p)
            k0 = launch_counts()
            outs, wall = timed_sync(lambda: [meshed.count(g, plan=p)
                                             for _ in range(MESH_REPEATS)])
            k1 = launch_counts()
            counts = [o.item() for o in outs]
            launched = k1[kernel[method]] - k0[kernel[method]]
            if set(counts) != {want} or r_chain.item() != want:
                raise AssertionError(f"(a) {name} {method}: mesh counts {sorted(set(counts))}, "
                                     f"chain {r_chain.item()}, resident {want}")
            if launched != MESH_REPEATS * S * S:
                raise AssertionError(f"(a) {name} {method}: {kernel[method]} launched "
                                     f"{launched} times, not {MESH_REPEATS} x {S * S}")
            if outs[0].stats["cache"]["key"] != r_chain.stats["cache"]["key"]:
                raise AssertionError(f"(a) {name} {method}: the mesh's cache key differs")
            del outs
            # the pipeline alone on the counter's operands, MESH_REPEATS runs
            # queued back to back (the counter's own upload waits for the card)
            spec, resident, stream = ring_operands(g, method, S)
            pipe = DynamicPipeline(mesh)
            totals, pipe_wall = timed_sync(lambda: [pipe.run(spec, resident, stream)
                                                    for _ in range(MESH_REPEATS)])
            if {int(t) for t in totals} != {want}:
                raise AssertionError(f"(a) {name} {method}: queued pipeline runs counted "
                                     f"{sorted({int(t) for t in totals})}, not {want}")
            row = dict(graph=name, method=method, count=want,
                       count_ms=wall * 1e3 / MESH_REPEATS,
                       pipeline_ms=pipe_wall * 1e3 / MESH_REPEATS, launches=launched)
            rows.append(row)
            log(f"  (a) {name:8s} {method:11s} S={S}: {MESH_REPEATS} mesh counts = chain = "
                f"resident {want}; {kernel[method]} {launched} = {MESH_REPEATS} x S²; "
                f"{row['count_ms']:.1f} ms a count, {row['pipeline_ms']:.2f} ms a queued "
                f"pipeline run (synchronized walls)")
            del totals, resident, stream
            if name not in ("FNA.5", LARGE_NAME):
                continue
            for width in MESH_WIDTHS:  # the paper's Figures 12-13 question
                spec, resident, stream = ring_operands(g, method, width)
                pipe = DynamicPipeline(make_ring_mesh(width, devices=[card] * width))
                t_mesh, t_chain = [], []
                for _ in range(3):
                    got, t = timed_sync(lambda: int(pipe.run(spec, resident, stream)))
                    t_mesh.append(t)
                    got_chain, t = timed_sync(
                        lambda: int(run_sequential(spec, resident, stream, width)))
                    t_chain.append(t)
                    if got != want or got_chain != want:
                        raise AssertionError(f"(a) {name} {method} S={width}: {got}, "
                                             f"{got_chain} != {want}")
                walls.append(dict(graph=name, method=method, stages=width,
                                  mesh_ms=sorted(t_mesh)[1] * 1e3,
                                  chain_ms=sorted(t_chain)[1] * 1e3))
                log(f"      {name:8s} {method:11s} S={width}: mesh {walls[-1]['mesh_ms']:.3f} "
                    f"ms, chain {walls[-1]['chain_ms']:.3f} ms (medians of 3, operands "
                    f"built, synchronized)")
                del resident, stream
            torch.cuda.empty_cache()
    summary["a"] = dict(counts=rows, walls=walls)
    del meshed, chain
    gc.collect()
    torch.cuda.empty_cache()

    # (b) mesh streams through TriangleServer(mesh=): serve_streams, then
    # the same interleave by hand to hold every shard against the emulated
    # sharded state fed the same blocks
    names = ("FNA.5", "NY", LARGE_NAME)
    rng = np.random.default_rng(30)
    feeds = {nm: ragged(graphs[nm].edges[rng.permutation(graphs[nm].n_edges)], rng, 50_000)
             for nm in names}
    server = TriangleServer(device=DEVICE, mesh=mesh)
    ring = {nm: stream_plan(graphs[nm].n_nodes, detected, S) for nm in names}
    k0 = launch_counts()
    results, wall = timed_sync(lambda: server.serve_streams(
        [(graphs[nm].n_nodes, feeds[nm], ring[nm]) for nm in names]))
    k1 = launch_counts()
    for nm, r in zip(names, results):
        if r.item() != graphs["_served"][nm] or not r.stats["on_mesh"] \
                or r.plan.n_stages != S:
            raise AssertionError(f"(b) serve_streams {nm}: {r.item()} (resident "
                                 f"{graphs['_served'][nm]}), on_mesh {r.stats['on_mesh']}, "
                                 f"{r.plan.n_stages} stages")
    blocks = sum(r.stats["n_blocks"] for r in results)
    check_stream_launches("(b) serve_streams on the mesh", k0, k1, blocks, 2 * S, 2 * S)
    log(f"  (b) TriangleServer(mesh=).serve_streams: {', '.join(names)} interleaved, "
        f"{blocks} blocks in {wall * 1e3:.1f} ms, each count = resident, on_mesh, "
        f"K3 and K4 2 x {S} shards a block")
    del results
    sids = {nm: server.open_stream(graphs[nm].n_nodes, plan=ring[nm]) for nm in names}
    feed_round_robin(server.streams, {sids[nm]: feeds[nm] for nm in names})
    emulated = TriangleCounter(detected, device=DEVICE)
    ny_bytes = None
    for nm in names:
        session = server.streams._recs[sids[nm]].session
        tail = session.flush_ready()
        if tail is not None:
            session.ingest_ready(tail)
        twin = emulated.open_stream(graphs[nm].n_nodes, plan=session.plan,
                                    block_size=session.block_size)
        for b in feeds[nm]:
            twin.feed(b)
        tail = twin.flush_ready()
        if tail is not None:
            twin.ingest_ready(tail)
        shards, flat = session.state["adj"], twin.state["adj"]
        same = len(shards) == S and all(torch.equal(shards[i], flat[i]) for i in range(S)) \
            and torch.equal(session.state["count"], twin.state["count"])
        if not same or int(session.state["count"]) != graphs["_served"][nm]:
            raise AssertionError(f"(b) {nm}: the mesh shards differ from the emulated state")
        shard_bytes = [x.nbytes for x in shards]
        if nm == "NY":
            ny_bytes = dict(state=session.state_bytes, shards=shard_bytes,
                            charged=server.streams.state_bytes_of(sids[nm]))
            if session.state_bytes != sum(shard_bytes) or ny_bytes["charged"] != sum(shard_bytes):
                raise AssertionError(f"(b) NY's mesh session: {ny_bytes}")
        log(f"  (b) {nm:8s} {session.n_blocks} blocks of {session.block_size}: every one of "
            f"its {S} shards ({shard_bytes[0]} B each, {sum(shard_bytes)} B charged) "
            f"torch.equal on the card to the emulated sharded state fed the same blocks")
        del session, twin, shards, flat
    for nm in names:
        server.close_stream(sids[nm])
    summary["b"] = dict(blocks=blocks, wall_ms=wall * 1e3, ny=ny_bytes)
    del server
    gc.collect()
    torch.cuda.empty_cache()

    # (c) a window of 4 over 8 epochs of FB107x9 on the mesh, against the
    # count [stream] took of the same feeds
    g = graphs[LARGE_NAME]
    window_feeds, want = graphs["_windowed"][LARGE_NAME]
    window = 4
    meshed = TriangleCounter(detected, device=DEVICE, mesh=mesh)
    p = stream_plan(g.n_nodes, detected, S, window)
    k0 = launch_counts()
    r, wall = timed_sync(lambda: meshed.count_windowed(g.n_nodes, window_feeds, plan=p))
    k1 = launch_counts()
    if r.item() != want or not r.stats["on_mesh"]:
        raise AssertionError(f"(c) {LARGE_NAME} window on the mesh: {r.item()} != {want}")
    check_stream_launches("(c) the mesh window", k0, k1, r.stats["n_blocks"],
                          (window + 1) * S, 2 * window * S)
    log(f"  (c) count_windowed {LARGE_NAME} window={window} of 8 epochs on the mesh: "
        f"{r.item()} = [stream]'s count, {r.stats['n_blocks']} blocks in {wall * 1e3:.1f} ms, "
        f"K3 {window + 1} and K4 {2 * window} a shard a block")
    summary["c"] = dict(count=r.item(), blocks=r.stats["n_blocks"], wall_ms=wall * 1e3)

    # (d) checkpoints across the mesh and the emulated sharding, both ways
    rng = np.random.default_rng(31)
    ops = ragged(g.edges[rng.permutation(g.n_edges)], rng, 20_000)
    cut = len(ops) // 2
    p = stream_plan(g.n_nodes, detected, S)
    emulated = TriangleCounter(detected, device=DEVICE)

    def run(session, todo):
        for b in todo:
            session.feed(b)
        return session

    whole = run(meshed.open_stream(g.n_nodes, plan=p), ops)
    run(emulated.open_stream(g.n_nodes, plan=p), ops).finalize()  # every emulated key seen
    a = whole.finalize().item()
    want_arrays = streaming.snapshot_state(whole.state)
    del whole
    for first, second, label in ((meshed, emulated, "mesh -> emulated"),
                                 (emulated, meshed, "emulated -> mesh")):
        ck = run(first.open_stream(g.n_nodes, plan=p), ops[:cut]).checkpoint()
        keys = streaming.ingest_trace_count()
        rest = run(second.restore_stream(ck), ops[cut:])
        b = rest.finalize().item()
        got = streaming.snapshot_state(rest.state)
        same = sorted(got) == sorted(want_arrays) and all(
            np.array_equal(got[k], want_arrays[k]) and got[k].dtype == want_arrays[k].dtype
            for k in got)
        new_keys = streaming.ingest_trace_count() - keys
        if a != b or not same or new_keys:
            raise AssertionError(f"(d) {label}: count {b} vs {a}, arrays equal {same}, "
                                 f"{new_keys} new ingest keys")
        log(f"  (d) {label}: {LARGE_NAME} checkpointed after {cut} of {len(ops)} feeds "
            f"({ck.nbytes} B, arrays {ck.arrays['adj'].shape}), restored and finished: "
            f"count {b} = uninterrupted {a}, every array bit-identical, no new ingest key")
        del rest, ck
    del meshed, emulated
    gc.collect()
    torch.cuda.empty_cache()

    # (e) admission on the same-card mesh
    ny = graphs["NY"]
    mux = StreamMultiplexer(TriangleCounter(detected, device=DEVICE, mesh=mesh))
    sid = mux.open(ny.n_nodes, plan=stream_plan(ny.n_nodes, detected, S))
    rec = mux._recs[sid]
    w = -(-ny.n_nodes // 32)
    shard = 4 * ny.n_nodes * -(-w // S)
    planner_whole = admit_session(ny.n_nodes, detected)
    per_stage = admit_session(ny.n_nodes, dataclasses.replace(
        detected, memory_bytes=int(1.2 * shard), n_devices=S))
    if rec.plan.n_stages != S or mux.bytes_in_use != S * shard \
            or mux.state_bytes_of(sid) != S * shard or per_stage.state_bytes != shard:
        raise AssertionError(f"(e) NY on the mesh: {rec.plan.n_stages} stages, "
                             f"{mux.bytes_in_use} B in use, not {S} x {shard} B")
    # without a plan the planner never picks the ring on one card: ring width 1
    planned = mux.open(ny.n_nodes)
    width1 = (mux._recs[planned].plan.n_stages, mux.state_bytes_of(planned))
    if width1 != (1, planner_whole.state_bytes) or planner_whole.action != "admit-dense":
        raise AssertionError(f"(e) NY planned on the mesh: {width1}, {planner_whole.action}")
    mux.close(planned)
    log(f"  (e) StreamMultiplexer on the {S}-stage one-card mesh, Resources.detect(): NY "
        f"opened under a {S}-stage plan on {rec.plan.n_stages} stages, bytes_in_use "
        f"{S * shard} B = {S} x {shard} B shards (reserve {mux.reserve_bytes} B); "
        f"NY opened without a plan: {width1[0]} stage, {width1[1]} B; admit_session's verdict: "
        f"{planner_whole.action} {planner_whole.state_bytes} B at the detected budget, "
        f"{per_stage.action} {per_stage.state_bytes} B a stage at {int(1.2 * shard)} B "
        f"over {S} devices (the reference's charge on any matching mesh)")
    summary["e"] = dict(bytes_in_use=S * shard, shard_bytes=shard, width1=width1,
                        reserve_bytes=mux.reserve_bytes, admit_session=planner_whole.action,
                        per_stage_verdict=[per_stage.action, per_stage.state_bytes])
    mux.close(sid)
    del rec, mux
    gc.collect()
    torch.cuda.empty_cache()
    k_end = launch_counts()
    summary["launches"] = {k: k_end[k] - k_phase[k] for k in
                           ("masked_matmul_sum", "bitset_edge_count", "bitset_pair_count")}
    log(f"  launches in [ring mesh] (mesh and chain): {summary['launches']}")
    return summary


# --------------------------------------------------------------------------
# Phases 8 and 9: the LM and the recsys paths (main path too)
# --------------------------------------------------------------------------
def check_launch_deltas(label: str, k0: dict, k1: dict, want: dict) -> None:
    """Each kernel of ``want`` launched exactly ``want[name]`` times from
    the counts ``k0`` to ``k1``."""
    for name, w in want.items():
        got = k1.get(name, 0) - k0.get(name, 0)
        if got != w:
            raise AssertionError(f"{label}: {name} launched {got} times, not {w}")


def worker_launches(router) -> dict:
    """Kernel launches the router's live workers counted in their own
    processes (their ``stats`` replies), summed by kernel."""
    out: dict = {}
    for st in router.stats()["workers"]:
        for name, k in st.get("launches", {}).items():
            out[name] = out.get(name, 0) + k
    return out


def fill_router(router, n: int, block_size: int | None = None) -> tuple:
    """Open sessions of ``n`` nodes (at ``block_size``) through ``router``
    until it refuses one with ``BackpressureError``; recompute, worker by
    worker, what
    ``worker_admission`` predicts for each in turn. Returns (gids, the
    predictions by gid, the refusal). Fails unless the router's ledger and
    every worker's own ``bytes_in_use`` equal the predictions' sums, no
    worker holds a queued session, and each worker, asked past the router
    for one more, queues it itself."""
    from repro_torch.api import BackpressureError, WorkerLoad, worker_admission

    gids = []
    while True:
        try:
            gids.append(router.open(n, block_size=block_size))
        except BackpressureError as err:
            refused = str(err)
            break
    used = [0] * len(router.workers)
    placed = [[] for _ in router.workers]
    predicted = {}
    for gid in gids:
        wi = router.worker_of(gid)
        w = router.workers[wi]
        block = block_size or w.block_size
        adm = worker_admission(n, WorkerLoad(w.resources, charged_bytes=used[wi],
                                             mesh_devices=w.mesh_devices,
                                             sessions=tuple(placed[wi]),
                                             block_size=block))
        if not adm.admitted:
            raise AssertionError(f"session {gid} placed on worker {wi}, which "
                                 f"worker_admission refuses: {adm.reason}")
        used[wi] += adm.state_bytes
        placed[wi].append((n, dataclasses.replace(
            adm.plan, block_size=int(block or adm.plan.block_size))))
        predicted[gid] = adm
    stats = router.stats()["workers"]
    pinned = [st["bytes_in_use"] for st in stats]
    if router.charged_bytes() != used or pinned != used:
        raise AssertionError(f"ledger {router.charged_bytes()}, workers' own "
                             f"{pinned}, predictions {used}")
    statuses = {router.status(g) for g in gids}
    if statuses != {"active"} or any(st["n_queued"] for st in stats):
        raise AssertionError(f"router-placed sessions {statuses}, queued "
                             f"{[st['n_queued'] for st in stats]}")
    for wi, w in enumerate(router.workers):
        reply, _ = w.rpc({"op": "open", "n_nodes": n, "block_size": block_size})
        w.rpc({"op": "close", "sid": reply["sid"]})
        if reply["status"] != "queued":
            raise AssertionError(f"worker {wi} admitted ({reply['status']}) the "
                                 f"session the router refused: {refused}")
    return gids, predicted, refused


def timed_rpcs(worker, walls: dict) -> None:
    """Record the host wall of each of ``worker``'s RPCs in ``walls`` (op ->
    list of s); ``del worker.rpc`` undoes it."""
    plain = worker.rpc

    def rpc(header, arrays=None):
        t0 = time.perf_counter()
        out = plain(header, arrays)
        walls.setdefault(header["op"], []).append(time.perf_counter() - t0)
        return out

    worker.rpc = rpc


def cluster_phase(graphs: dict, in_process_ms: float) -> dict:
    """[cluster]: the cluster tier with worker processes sharing the card
    (module docstring, 8). ``in_process_ms`` is [serve streams] (a)'s
    synchronous wall of the same requests. Returns the summary, with the
    workers' kernel launches under ``launches``."""
    import gc

    import numpy as np
    import torch

    from repro_torch.api import WorkerLoad, worker_admission
    from repro_torch.serve.cluster import ClusterRouter
    from repro_torch.serve.serve_loop import ClusterServer

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    share = (free - CLUSTER_MARGIN) // 2
    log(f"  free {free} B of {total} B after the parent's empty_cache: two workers of "
        f"{share} B each, {CLUSTER_MARGIN} B left to this process")
    summary = {"free_bytes": free, "share_bytes": share}
    launches: dict = {}

    def add(counts: dict) -> None:
        for name, k in counts.items():
            launches[name] = launches.get(name, 0) + k

    served = graphs["_served"]
    fb, ny = graphs[LARGE_NAME], graphs["NY"]
    rng = np.random.default_rng(30)
    fb_feeds = ragged(fb.edges[rng.permutation(fb.n_edges)], rng, 20_000)
    ny_feeds = ragged(ny.edges[rng.permutation(ny.n_edges)], rng, 50_000)
    spec = {"memory_bytes": share, "device": DEVICE}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with ClusterServer([spec, spec], checkpoint_dir=tmp,
                           checkpoint_every_bytes=None) as srv:
            router = srv.router
            summary["spawn_s"] = time.perf_counter() - t0
            log(f"  two workers ready in {summary['spawn_s']:.1f} s (pids "
                f"{[w.pid for w in router.workers]})")

            # (a) the Table-1 graphs and FB107x9 through ClusterServer.serve_streams,
            # on the fresh workers and again on warm ones
            reqs = graphs["_serve_streams"]
            walls_a = []
            for label in ("fresh workers", "warm workers"):
                k0 = worker_launches(router)
                t0 = time.perf_counter()
                res = srv.serve_streams(reqs)
                walls_a.append((time.perf_counter() - t0) * 1e3)
                counts = [r.item() for r in res]
                for nm, c in zip(GRAPHS, counts):
                    if c != served[nm]:
                        raise AssertionError(f"[cluster] (a) {nm}: {c} != resident "
                                             f"{served[nm]}")
                blocks = sum(r.stats["n_blocks"] for r in res)
                check_stream_launches("[cluster] (a)", k0, worker_launches(router),
                                      blocks, 2, 2)
                homes = {nm: r.stats["worker"] for nm, r in zip(GRAPHS, res)}
                if set(homes.values()) != {0, 1}:
                    raise AssertionError(f"[cluster] (a) not spread over both workers: "
                                         f"{homes}")
                plan_block = {nm: r.plan.block_size for nm, r in zip(GRAPHS, res)}
                log(f"  (a) ClusterServer.serve_streams, {label}: {len(reqs)} sessions on "
                    f"2 workers ({homes}), {blocks} blocks ({plan_block}: each worker plans "
                    f"within its share), every count = resident; wall {walls_a[-1]:.3f} ms "
                    f"against [serve streams] (a)'s in-process {in_process_ms:.3f} ms")
            summary["a"] = dict(wall_ms=walls_a, in_process_ms=in_process_ms,
                                blocks=blocks, homes=homes, plan_block=plan_block)
            del res

            # (b) NY-size sessions through the router until it refuses one
            k0 = worker_launches(router)
            t0 = time.perf_counter()
            gids, predicted, refused = fill_router(router, ny.n_nodes, SERVE_BLOCK)
            fill_s = time.perf_counter() - t0
            layout = {g: predicted[g].plan.state_layout for g in gids}
            kinds = {k: sum(v == k for v in layout.values()) for k in ("bitset", "hybrid")}
            log(f"  (b) {len(gids)} NY-size sessions placed ({kinds['bitset']} bitset, "
                f"{kinds['hybrid']} hybrid; ledger {router.charged_bytes()} B = Σ "
                f"worker_admission = each worker's bytes_in_use, none queued) in "
                f"{fill_s:.1f} s before BackpressureError ({refused[:70]}...); each "
                f"worker, asked past the router, queued the next one")
            # every bitset and CLUSTER_HYBRIDS_FED hybrid sessions take a whole
            # stream (the first of each kind FB107x9's edges on NY's ids), the
            # other hybrids NY's first block: any part of NY has no triangle
            bitsets = [g for g in gids if layout[g] == "bitset"]
            hybrids = [g for g in gids if layout[g] == "hybrid"]
            perm = rng.permutation(ny.n_nodes)[:fb.n_nodes].astype(np.int32)
            fb_on_ny = [perm[b] for b in fb_feeds]
            mixed = set(bitsets[:1] + hybrids[:1])
            feeds = {g: fb_on_ny if g in mixed else ny_feeds
                     for g in bitsets + hybrids[:CLUSTER_HYBRIDS_FED]}
            feeds.update({g: ny_feeds[:1] for g in hybrids[CLUSTER_HYBRIDS_FED:]})
            want = {g: served[LARGE_NAME] if g in mixed else served["NY"] for g in gids}
            t0 = time.perf_counter()
            feed_round_robin(router, feeds, slice(0, len(ny_feeds) // 2))
            ny_spill = {}
            if bitsets:
                t1 = time.perf_counter()
                path = router.checkpoint(bitsets[-1])
                ny_spill = dict(checkpoint_s=time.perf_counter() - t1,
                                disk_bytes=os.path.getsize(path),
                                state_bytes=predicted[bitsets[-1]].state_bytes)
                log(f"  (b) one NY checkpoint (snapshot + compressed spill of "
                    f"{ny_spill['state_bytes']} B): {ny_spill['checkpoint_s']:.1f} s, "
                    f"{ny_spill['disk_bytes']} B on disk")
            feed_round_robin(router, feeds, slice(len(ny_feeds) // 2, None))
            results = {g: router.close(g) for g in gids}
            feed_s = time.perf_counter() - t0
            nb = {k: sum(r.stats["n_blocks"] for g, r in results.items() if layout[g] == k)
                  for k in ("bitset", "hybrid")}
            bad = {g: (r.item(), want[g]) for g, r in results.items()
                   if r.item() != want[g]}
            if bad or router.charged_bytes() != [0, 0]:
                raise AssertionError(f"[cluster] (b) counts (got, want) {bad}, "
                                     f"ledger {router.charged_bytes()}")
            k1 = worker_launches(router)
            want_k = {"bitset_edge_count": 2 * nb["bitset"] + nb["hybrid"],
                      "bitset_pair_count": 2 * (nb["bitset"] + nb["hybrid"]),
                      "bitset_edge_count_per_edge": nb["hybrid"]}
            check_launch_deltas("[cluster] (b) in the workers", k0, k1, want_k)
            log(f"  (b) {len(feeds) - len(hybrids[CLUSTER_HYBRIDS_FED:])} sessions fed a "
                f"whole stream ({len(mixed)} FB107x9's edges on NY's ids, counted "
                f"{served[LARGE_NAME]}; the others NY's, counted {served['NY']}), the "
                f"other {len(hybrids[CLUSTER_HYBRIDS_FED:])} hybrids one block, no "
                f"out-of-memory error; {feed_s:.1f} s of feeds and closes; {nb['bitset']} "
                f"bitset + {nb['hybrid']} hybrid blocks of {SERVE_BLOCK} rows, K3/K4/K5 in "
                f"the workers as per block")
            summary["b"] = dict(sessions=len(gids), **kinds, fill_s=fill_s, feed_s=feed_s,
                                blocks=nb, ny_spill=ny_spill)
            del results

            # (c) an FB107x9 session migrated mid-stream onto a warm worker
            s1 = router.open(fb.n_nodes, block_size=SERVE_BLOCK)
            s2 = router.open(fb.n_nodes, block_size=SERVE_BLOCK)
            src, dst = router.worker_of(s2), router.worker_of(s1)
            if src == dst:
                raise AssertionError("[cluster] (c) both sessions on one worker")
            half = len(fb_feeds) // 2
            feed_round_robin(router, {s1: fb_feeds, s2: fb_feeds[:half]})
            before = router.workers[dst].rpc({"op": "stats"})[0]["ingest_traces"]
            walls: dict = {}
            for i in (src, dst):
                timed_rpcs(router.workers[i], walls)
            t0 = time.perf_counter()
            router.migrate(s2, to=dst)
            migrate_s = time.perf_counter() - t0
            for i in (src, dst):
                del router.workers[i].rpc
            feed_round_robin(router, {s2: fb_feeds[half:]})
            new_keys = router.workers[dst].rpc({"op": "stats"})[0]["ingest_traces"] - before
            r1, r2 = router.close(s1), router.close(s2)
            if (r1.item(), r2.item()) != (served[LARGE_NAME],) * 2 or new_keys != 0 \
                    or r2.stats["worker"] != dst:
                raise AssertionError(f"[cluster] (c) counts {r1.item()}, {r2.item()}, "
                                     f"{new_keys} new ingest keys on the target")
            log(f"  (c) FB107x9 session migrated mid-stream worker {src} -> {dst}: evict "
                f"(checkpoint + spill) {walls['evict'][0] * 1e3:.1f} ms, restore "
                f"{walls['restore'][0] * 1e3:.1f} ms, {migrate_s * 1e3:.1f} ms in all; "
                f"count {r2.item()} exact, 0 new ingest keys on the warm target")
            summary["c"] = dict(evict_ms=walls["evict"][0] * 1e3,
                                restore_ms=walls["restore"][0] * 1e3,
                                migrate_ms=migrate_s * 1e3)

            # (d) SIGKILL a worker mid-stream: its sessions resurrect on the survivor
            a, b, c = (router.open(fb.n_nodes, block_size=SERVE_BLOCK) for _ in range(3))
            victim = router.worker_of(a)
            if router.worker_of(c) != victim or router.worker_of(b) == victim:
                raise AssertionError("[cluster] (d) unexpected placement")
            feed_round_robin(router, {a: fb_feeds[:half], b: fb_feeds[:half], c: fb_feeds[:half]})
            router.checkpoint(a)  # a: checkpoint + journal; c: the journal alone
            add(router.workers[victim].rpc({"op": "stats"})[0]["launches"])
            router.workers[victim].proc.kill()
            t0 = time.perf_counter()
            router.feed(a, fb_feeds[half])  # the failure detector: a's worker is gone
            failover_s = time.perf_counter() - t0
            feed_round_robin(router, {a: fb_feeds[half + 1:], b: fb_feeds[half:],
                                 c: fb_feeds[half:]})
            st = router.stats()
            got = [router.close(g).item() for g in (a, b, c)]
            if got != [served[LARGE_NAME]] * 3 or st["worker_deaths"] != 1 \
                    or st["resurrections"] != 2 or st["workers"][victim] != {"alive": False}:
                raise AssertionError(f"[cluster] (d) counts {got}, stats {st}")
            log(f"  (d) worker {victim} SIGKILLed mid-stream: its two sessions resurrected "
                f"on the survivor (one from its checkpoint + journal, one by a full "
                f"replay) in {failover_s * 1e3:.1f} ms; all three counted {got[0]}")
            summary["d"] = dict(failover_ms=failover_s * 1e3)
            add(worker_launches(router))

        # (e) one worker of MESH_STAGES stages on the one card
        gc.collect()
        free_e = torch.cuda.mem_get_info()[0]
        one_card = f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE
        with ClusterRouter([{"memory_bytes": free_e - CLUSTER_MARGIN, "devices": MESH_STAGES,
                             "device": one_card}],
                           checkpoint_dir=tmp, checkpoint_every_bytes=None) as router:
            w = router.workers[0]
            if (w.mesh_devices, w.resources.n_devices, w.resources.max_stages) != \
                    (0, MESH_STAGES, MESH_STAGES):
                raise AssertionError(f"[cluster] (e) hello: mesh_devices {w.mesh_devices}, "
                                     f"{w.resources}")
            gids, predicted, _ = fill_router(router, ny.n_nodes, SERVE_BLOCK)
            retaken, used, placed = 0, 0, []
            for g in gids:  # the verdicts had the mesh's width been advertised
                wide = worker_admission(ny.n_nodes, WorkerLoad(
                    w.resources, charged_bytes=used, mesh_devices=MESH_STAGES,
                    sessions=tuple(placed), block_size=SERVE_BLOCK))
                retaken += wide.admitted and wide.plan.n_stages > 1
                used += predicted[g].state_bytes
                placed.append((ny.n_nodes, dataclasses.replace(predicted[g].plan,
                                                               block_size=SERVE_BLOCK)))
            widths = {router.close(g).plan.n_stages for g in gids}
            g = router.open(fb.n_nodes, block_size=SERVE_BLOCK)
            feed_round_robin(router, {g: fb_feeds})
            r = router.close(g)
            if widths != {1} or r.item() != served[LARGE_NAME] or r.plan.n_stages != 1:
                raise AssertionError(f"[cluster] (e) widths {widths}, FB107x9 "
                                     f"{r.item()} at {r.plan.n_stages} stages")
            log(f"  (e) a worker of {MESH_STAGES} stages on one card advertises "
                f"mesh_devices=0: {len(gids)} NY-size sessions placed, every one at ring "
                f"width 1 and verdict for verdict the worker's own ({retaken} of them a "
                f"{MESH_STAGES}-stage plan had the mesh's width been advertised); FB107x9 "
                f"counted {r.item()} there")
            summary["e"] = dict(sessions=len(gids), retaken=retaken)
            add(worker_launches(router))
    summary["launches"] = launches
    log(f"  kernel launches in the workers: {launches}")
    return summary


def logits_agree(label: str, got, want, rel: float = 1e-3) -> float:
    """max |got - want| <= rel * max |want|, both finite; returns the ratio."""
    import torch

    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{label}: logits are not finite")
    diff = float((got - want).abs().max())
    top = float(want.abs().max())
    log(f"  {label}: max |diff| {diff:.3e}, max |logit| {top:.3e}, ratio {diff / top:.3e} "
        f"(<= {rel:g})")
    if not diff <= rel * top:
        raise AssertionError(f"{label}: max |diff| {diff} > {rel} * {top}")
    return diff / top


def k6_head_dims(cfg) -> tuple[int, int]:
    """The head dims (D, Dv) the LM's flash prefill hands K6: MLA's
    (nope + rope, v), else the config's head dim twice."""
    m = cfg.mla
    return (m.nope_head_dim + m.rope_head_dim, m.v_head_dim) if m else (cfg.hd, cfg.hd)


def smoke_on_card(arch: str, decode_steps: int = 8) -> None:
    """``arch``'s smoke config in f32 on the card against the CPU port on
    the same weights: the chunked and the flash prefill, then
    ``decode_steps`` greedy decode steps from the flash prefill's cache,
    each step's logits within 1e-3 of the largest."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tf

    small = get_smoke(arch)
    m_dev = tf.init_params(torch.Generator(device=DEVICE).manual_seed(1), small, device=DEVICE)
    m_cpu = tf.Transformer(small, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_dev.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, small.vocab, (2, 33)))
    s_max = 33 + decode_steps
    for flash in (False, True):
        a, c_dev = tf.prefill(m_dev, small, toks.to(DEVICE), s_max, use_flash=flash, chunk_q=16)
        b, c_cpu = tf.prefill(m_cpu, small, toks, s_max, use_flash=flash, chunk_q=16)
        logits_agree(f"{small.name} {'flash' if flash else 'chunked'} prefill, card vs CPU "
                     "port", a.cpu(), b)
    ratio, tok = 0.0, b.argmax(-1, keepdim=True)
    for step in range(decode_steps):
        a, _ = tf.decode_step(m_dev, small, c_dev, tok.to(DEVICE), 33 + step)
        b, _ = tf.decode_step(m_cpu, small, c_cpu, tok, 33 + step)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{small.name} decode step {step}: logits are not finite")
        ratio = max(ratio, float((a.cpu() - b).abs().max() / b.abs().max()))
        tok = b.argmax(-1, keepdim=True)
    log(f"  {small.name} {decode_steps} decode steps, card vs CPU port: max |diff| / max "
        f"|logit| {ratio:.3e} (<= 0.001)")
    if not ratio <= 1e-3:
        raise AssertionError(f"{small.name} decode steps on the card: {ratio} > 1e-3")


def lm_phase(arch: str = "yi_6b", dtype: str = "float32", n_prompts: int = 8,
             lengths=(256, 1024), max_batch: int = 4, new_tokens: int = 32,
             cfg=None) -> dict:
    """The LM path at full width in ``dtype`` (float32 or bfloat16): the
    server, the flash prefill and decode, and (float32) forward, as the
    module docstring says; ``cfg`` replaces the arch's full config (a depth
    cut). Returns what the profile phase reuses (the model and one batch)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention.ops import kernel_route
    from repro_torch.models import transformer as tf
    from repro_torch.serve import LMServer, ServeConfig

    wdtype = getattr(torch, dtype)
    if dtype == "float32" and cfg is None:
        smoke_on_card(arch)
    cfg = cfg or get_config(arch)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # by earlier phases (the f32 model in bf16's pass)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tf.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg, wdtype,
                           device=DEVICE)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}"
        + (f", MLA {cfg.mla}" if cfg.mla else "") + (f", MoE {cfg.moe}" if cfg.moe else "")
        + f": {cfg.n_params()} params, {n_bytes} B of {dtype} weights (norm scales"
        + (" and routers" if cfg.moe else "") + " float32) drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(13)
    lens = rng.integers(lengths[0], lengths[1] + 1, n_prompts)
    lens[0] = lengths[1]
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in lens]
    log(f"  prompts: {sorted(int(n) for n in lens)} tokens, {max_batch} to a batch")

    # (a) the server (its KV cache is float32 whatever the weights, as the
    # reference server's)
    server = LMServer(model, cfg, ServeConfig(max_batch=max_batch, max_new_tokens=new_tokens))
    t0 = time.perf_counter()
    out_a = server.generate(prompts)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if [o.shape for o in out_a] != [(new_tokens,)] * n_prompts or any(
            ((o < 0) | (o >= cfg.vocab)).any() for o in out_a):
        raise AssertionError("LMServer.generate: wrong shapes or token ids out of range")
    log(f"  generate: {n_prompts} prompts x {new_tokens} tokens in {gen_s:.3f} s (host wall, "
        f"synchronized): {n_prompts * new_tokens / gen_s:.2f} tokens/s")

    # (b) the same batches through the flash prefill and decode_step (a KV
    # cache in the weights' dtype); the server's own prefill (chunked
    # attention) recomputed for its logits and timed: that is the served
    # path's time to first token
    route = K6_ROUTES[kernel_route(wdtype, *k6_head_dims(cfg))]
    k6 = launch_counts()
    agree, flash_ms, ttft_ms, decode_ms, ratios, kept = 0, [], [], [], [], []
    batch0 = None
    for i in range(0, n_prompts, max_batch):
        group = prompts[i:i + max_batch]
        plen = max(len(p) for p in group)
        tokens = np.zeros((len(group), plen), np.int32)
        for j, p in enumerate(group):
            tokens[j, plen - len(p):] = p
        tokens = torch.from_numpy(tokens).to(DEVICE)
        batch0 = batch0 if batch0 is not None else tokens
        s_max = plen + new_tokens
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, _ = tf.prefill(model, cfg, tokens, s_max, chunk_q=min(512, plen))
        torch.cuda.synchronize()
        ttft_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        got, cache = tf.prefill(model, cfg, tokens, s_max, cache_dtype=wdtype, use_flash=True)
        torch.cuda.synchronize()
        flash_ms.append((time.perf_counter() - t0) * 1e3)
        if dtype == "float32":
            ratios.append(logits_agree(f"batch {i // max_batch} (plen {plen}): flash prefill "
                                       "vs the server's chunked prefill", got, want,
                                       LOGITS_REL[dtype]))
        else:  # held to f32 arithmetic below, once this pass's peak is read
            kept.append((tokens, s_max, got, want))
        tok = got.argmax(-1, keepdim=True)
        gen = [tok]
        t0 = time.perf_counter()
        for step in range(new_tokens - 1):
            logits, cache = tf.decode_step(model, cfg, cache, tok, plen + step)
            tok = logits.argmax(-1, keepdim=True)
            gen.append(tok)
        out_b = torch.cat(gen, 1).cpu().numpy()
        decode_ms.append((time.perf_counter() - t0) * 1e3 / (new_tokens - 1))
        agree += int(sum((out_b[j] == out_a[i + j]).sum() for j in range(len(group))))
        del cache
    after = launch_counts()
    n_batches = len(flash_ms)
    for name in K6_ROUTES.values():
        want_n = cfg.n_layers * n_batches if name == route else 0
        if after[name] - k6[name] != want_n:
            raise AssertionError(f"{dtype} flash prefills launched {name} "
                                 f"{after[name] - k6[name]} times, not {want_n}")
    k6 = after[route] - k6[route]
    log(f"  greedy tokens equal between the server and the flash path: {agree} of "
        f"{n_prompts * new_tokens}")
    log(f"  K6 launches: {k6} of {route} (head dims {k6_head_dims(cfg)}) = {cfg.n_layers} layers "
        f"x {n_batches} flash prefills (none of the other routes)")
    for i, (c, f, d) in enumerate(zip(ttft_ms, flash_ms, decode_ms)):
        log(f"  batch {i}: time to first token {c:.3f} ms (the server's prefill, chunked "
            f"attention, as generate runs it); the flash prefill (K6) {f:.3f} ms; decode "
            f"{d:.3f} ms per token (host wall per step)")

    if dtype == "float32":
        # prefill of all but the last token plus one decode step == forward
        t = torch.from_numpy(prompts[0][None].astype(np.int64)).to(DEVICE)
        last, cache = tf.prefill(model, cfg, t[:, :-1], t.shape[1], use_flash=True)
        step, _ = tf.decode_step(model, cfg, cache, t[:, -1:], t.shape[1] - 1)
        full, _ = tf.forward(model, cfg, t, use_flash=True)
        logits_agree("prefill(tokens[:, :-1]) vs forward[:, -2]", last, full[:, -2])
        logits_agree("prefill + decode_step vs forward[:, -1]", step, full[:, -1])
        del cache, full
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    log(f"  peak allocated by this pass {peak} B ({n_bytes} B of {dtype} weights; {held} B "
        "held by earlier phases not counted)")
    extra = {}
    if dtype == "bfloat16":
        extra["bf16_logits"] = bf16_logits_check(model, cfg, kept)
        del kept
        extra["parting_layers"] = parting_layers(model, cfg, batch0)
        ratios = [r["flash_vs_f32"] / r["chunked_vs_f32"] for r in extra["bf16_logits"]]
    return dict(model=model, cfg=cfg, batch=batch0, new_tokens=new_tokens, cache_dtype=wdtype,
                summary=dict(config=cfg.name, n_layers=cfg.n_layers, dtype=dtype,
                             generate_s=gen_s,
                             tokens_per_s=n_prompts * new_tokens / gen_s,
                             ttft_ms=ttft_ms, flash_prefill_ms=flash_ms,
                             decode_ms_per_token=decode_ms, peak_bytes=peak,
                             weight_bytes=n_bytes, k6_route=route, k6_launches=k6,
                             tokens_equal=agree, logit_ratio=max(ratios), **extra))


def f32_prefill_logits(model, cfg, tokens, chunk_q: int):
    """The last-token logits of the chunked prefill in f32 arithmetic on
    ``model``'s (bf16) weights — every bf16 value is an f32 value — with
    one layer's f32 copy on the card at a time: a whole f32 copy of
    DeepSeek-V2-Lite would take 62.8 GB. The same operations as
    ``prefill`` of an f32 model, less the cache it fills."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import rms_norm, rotary_cos_sin

    x = model.embed[tokens.long()].float()
    cos, sin = rotary_cos_sin(torch.arange(tokens.shape[1], device=x.device), tf._rope_dim(cfg),
                              cfg.rope_theta)
    for blk in model.layers:
        b32 = tf.Block(cfg, torch.float32, moe_layer=blk.moe_layer, device=DEVICE)
        b32.load_state_dict(blk.state_dict())
        x, _ = tf._block(cfg, b32, x, cos, sin, use_flash=False, chunk_q=chunk_q)
        del b32
    x = rms_norm(x[:, -1:], model.final_norm, cfg.norm_eps)
    return x[:, 0] @ model.unembed.float()


def bf16_logits_check(model, cfg, kept: list) -> list:
    """The bf16 flash prefill's last-token logits held to f32 arithmetic on
    the same (bf16) weights (:func:`f32_prefill_logits`): no farther from
    it than twice the distance of the server's bf16 chunked prefill — the
    accuracy test of FlashAttention's own suite (a kernel's error against
    an f32 reference at most twice that of a plain implementation in the
    same dtype), as a fraction of the largest logit. The two bf16 paths'
    distance from each other is printed beside it against
    ``LOGITS_REL["bfloat16"]``: both are about 2e-2 of the largest logit
    from f32 arithmetic at Yi-6B, so that distance is bf16's own noise
    floor there (PERF.md). Returns the three distances per batch."""
    import torch

    out = []
    for i, (tokens, s_max, got, want) in enumerate(kept):
        plen = tokens.shape[1]
        exact = f32_prefill_logits(model, cfg, tokens, min(512, plen))
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"bf16 batch {i}: logits are not finite")
        top = float(exact.abs().max())
        f_err = float((got - exact).abs().max()) / top
        c_err = float((want - exact).abs().max()) / top
        pair = float((got - want).abs().max()) / float(want.abs().max())
        log(f"  batch {i} (plen {plen}), bf16: max |logit - f32 arithmetic| / max |logit|: "
            f"flash prefill {f_err:.3e}, the server's chunked prefill {c_err:.3e} (flash must "
            f"be <= 2x chunked: {f_err / c_err:.3f}x); flash vs chunked {pair:.3e} ("
            f"{'within' if pair <= LOGITS_REL['bfloat16'] else 'above'} "
            f"{LOGITS_REL['bfloat16']:g})")
        if not f_err <= 2 * c_err:
            raise AssertionError(f"bf16 batch {i}: the flash prefill is {f_err / c_err:.3f}x "
                                 "as far from f32 arithmetic as the chunked prefill (> 2x)")
        out.append(dict(flash_vs_f32=f_err, chunked_vs_f32=c_err, flash_vs_chunked=pair))
        del exact
    torch.cuda.empty_cache()
    return out


def parting_layers(model, cfg, tokens) -> dict:
    """Where the bf16 flash and chunked paths part: max |x_flash - x_chunked|
    / max |x_chunked| of the residual stream after each layer, each path
    fed its own previous output (batch 0); and, at each MoE layer, the
    share of tokens whose set of routed experts differs between the two."""
    import torch

    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import rms_norm, rotary_cos_sin

    full = attn.mla_full if tf._is_mla(cfg) else attn.gqa_full
    chunk = min(512, tokens.shape[1])

    def layer(blk, x, flash):
        h = x + full(blk.attn, cfg, rms_norm(x, blk.ln1.to(x.dtype), cfg.norm_eps), cos, sin,
                     use_flash=flash, chunk_q=chunk)
        experts = None
        if blk.moe_layer:
            z = rms_norm(h, blk.ln2.to(h.dtype), cfg.norm_eps)
            experts = moe.route(blk.moe, cfg, z.reshape(-1, z.shape[-1]))[2].sort(-1).values
        return tf._ffn(cfg, blk, h)[0], experts

    with torch.no_grad():
        xc = xf = model.embed[tokens.long()]
        cos, sin = rotary_cos_sin(torch.arange(tokens.shape[1], device=xc.device),
                                  tf._rope_dim(cfg), cfg.rope_theta)
        out, flips = [], []
        for blk in model.layers:
            xc, ec = layer(blk, xc, False)
            xf, ef = layer(blk, xf, True)
            out.append(float((xf - xc).abs().max() / xc.abs().max()))
            if ec is not None:
                flips.append(int((ec != ef).any(-1).sum()))
    log("  bf16 residual stream, flash vs chunked, per layer (batch 0): "
        + " ".join(f"{r:.2e}" for r in out))
    n_tok = tokens.numel()
    share = sum(flips) / (n_tok * len(flips)) if flips else 0.0
    if flips:
        log(f"  routed expert sets that differ between the flash and the chunked path (batch 0, "
            f"{n_tok} tokens x {len(flips)} MoE layers): {sum(flips)}, share {share:.4e}; per "
            "layer " + " ".join(map(str, flips)))
    return dict(residual=out, expert_sets_differing=flips, expert_set_share=share)


def deepseek_phase(arch: str = "deepseek_v2_lite_16b") -> dict:
    """[lm deepseek], as the module docstring says: (a) both DeepSeek smoke
    configs on the card against the CPU port; (c) f32 at full width and
    ``DS_REDUCED_LAYERS`` layers through ``lm_phase``; (b) bf16 at full
    width and depth through ``lm_phase`` (server, flash prefill on the wgmma
    K6 once per layer, decode, the flash prefill held to f32 arithmetic,
    routing flips), then one MLA and one MoE layer against f32 arithmetic
    from the same bf16 inputs (:func:`deepseek_layers`). Returns (b)'s
    ``lm_phase`` result for [profile], with (c)'s summary and the layer
    checks in its summary."""
    import torch

    from repro_torch.configs import get_config

    for small in ("deepseek_v2_lite_16b", "deepseek_v2_236b"):
        smoke_on_card(small)
    cut = dataclasses.replace(get_config(arch), n_layers=DS_REDUCED_LAYERS)
    log(f"  (c) f32, full width, {cut.n_layers} of {get_config(arch).n_layers} layers "
        f"({cut.moe.n_dense_layers} dense + {cut.n_layers - cut.moe.n_dense_layers} MoE): "
        "reduced, an f32 copy of all 27 would take 62.8 GB")
    reduced = lm_phase(arch, "float32", cfg=cut)
    del reduced["model"], reduced["batch"]
    torch.cuda.empty_cache()
    log(f"  (b) bf16, full width and depth ({get_config(arch).n_layers} layers)")
    full = lm_phase(arch, "bfloat16")
    full["summary"]["layers"] = deepseek_layers(full["model"], full["cfg"], full["batch"])
    full["summary"]["reduced_f32"] = reduced["summary"]
    return full


def deepseek_layers(model, cfg, tokens) -> dict:
    """One MLA and one MoE layer of the bf16 model at full width, each
    against its plain version in f32 arithmetic on the same weights from
    the same bf16 inputs (layer 1 of batch 0, after the dense layer 0):
    MLA with the flash path (the wgmma K6 at head dims (192, 128)) against f32
    chunked attention, the MoE with its routing equal as integers (both
    route ``x.float() @ router`` from the same values), each within
    ``LOGITS_REL["bfloat16"]`` of the largest |value|."""
    import torch

    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import rms_norm, rotary_cos_sin

    chunk = min(512, tokens.shape[1])
    cos, sin = rotary_cos_sin(torch.arange(tokens.shape[1], device=tokens.device),
                              tf._rope_dim(cfg), cfg.rope_theta)
    x, _ = tf._block(cfg, model.layers[0], model.embed[tokens.long()], cos, sin,
                     use_flash=False, chunk_q=chunk)
    blk = model.layers[1]
    xn = rms_norm(x, blk.ln1.to(x.dtype), cfg.norm_eps)
    a32 = attn.MLA(cfg, torch.float32, device=DEVICE)
    a32.load_state_dict(blk.attn.state_dict())
    got = attn.mla_full(blk.attn, cfg, xn, cos, sin, use_flash=True)
    want = attn.mla_full(a32, cfg, xn.float(), cos, sin, chunk_q=chunk)
    out = dict(mla=float((got.float() - want).abs().max() / want.abs().max()))
    z = rms_norm(x + got, blk.ln2.to(x.dtype), cfg.norm_eps).reshape(-1, cfg.d_model)
    m32 = moe.MoE(cfg, torch.float32, device=DEVICE)
    m32.load_state_dict(blk.moe.state_dict())
    if not torch.equal(moe.route(blk.moe, cfg, z)[2], moe.route(m32, cfg, z.float())[2]):
        raise AssertionError("MoE layer 1: bf16 and f32 copies route the same values apart")
    y, aux = moe.moe_apply(blk.moe, cfg, z)
    y32, aux32 = moe.moe_apply(m32, cfg, z.float())
    out["moe"] = float((y.float() - y32).abs().max() / y32.abs().max())
    out["moe_aux"] = [float(aux), float(aux32)]
    log(f"  layer 1 at full width, {tuple(xn.shape)} bf16 against f32 arithmetic from the same "
        f"inputs: MLA (flash, wgmma K6) max |diff| / max |value| {out['mla']:.3e}; MoE (routing "
        f"equal) {out['moe']:.3e}, aux {out['moe_aux'][0]:.6f} vs {out['moe_aux'][1]:.6f} (<= "
        f"{LOGITS_REL['bfloat16']:g})")
    if not max(out["mla"], out["moe"]) <= LOGITS_REL["bfloat16"]:
        raise AssertionError(f"a full-width layer in bf16 is farther than "
                             f"{LOGITS_REL['bfloat16']} from f32 arithmetic: {out}")
    del a32, m32
    torch.cuda.empty_cache()
    return out


def recsys_phase(arch: str = "autoint", rows: int = 16_384, n_cand: int = 100_000,
                 bag_len: int = 8) -> dict:
    """AutoInt at its full config on the card, as the module docstring says."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import launch_counts
    from repro_torch.models.recsys import autoint, embedding

    small = get_smoke(arch)
    m_dev = autoint.init_params(torch.Generator(device=DEVICE).manual_seed(2), small,
                                device=DEVICE)
    m_cpu = autoint.AutoInt(small, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_dev.state_dict().items()})
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, small.vocab_per_field,
                                                             (64, small.n_sparse)))
    logits_agree(f"{small.name} ctr_logits, card vs CPU port",
                 autoint.ctr_logits(m_dev, small, ids.to(DEVICE)).cpu(),
                 autoint.ctr_logits(m_cpu, small, ids), rel=1e-5)
    del m_dev, m_cpu

    cfg = get_config(arch)
    model = autoint.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                                device=DEVICE)
    rng = np.random.default_rng(21)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_per_field, (rows, cfg.n_sparse))
                           ).to(DEVICE)
    cands = torch.from_numpy(rng.standard_normal((n_cand, cfg.embed_dim)).astype(np.float32)
                             ).to(DEVICE)
    bags = rng.integers(0, cfg.vocab_per_field, (rows, cfg.n_sparse, bag_len))
    bags[rng.random(bags.shape) < 0.3] = cfg.vocab_per_field
    bags = torch.from_numpy(bags.astype(np.int32)).to(DEVICE)
    torch.cuda.synchronize()
    out = {}
    with torch.no_grad():  # serving: no graph, whatever the weights' flags
        for name, run, shape in (
                ("ctr_logits", lambda: autoint.ctr_logits(model, cfg, ids), (rows,)),
                ("retrieval_scores", lambda: autoint.retrieval_scores(model, cfg, ids, cands),
                 (rows, n_cand)),
                ("lookup_multihot", lambda: embedding.lookup_multihot(model.table, cfg, bags,
                                                                      use_kernel=True),
                 (rows, cfg.n_sparse, cfg.embed_dim))):
            t0 = time.perf_counter()
            y = run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if tuple(y.shape) != shape or not torch.isfinite(y).all():
                raise AssertionError(f"{name}: shape {tuple(y.shape)} (want {shape}) or not "
                                     "finite")
            log(f"  {name:16s} {tuple(y.shape)} finite, {wall:.3f} ms (host wall, "
                "synchronized)")
            out[name] = (y, wall)
        k7 = launch_counts()["embedding_bag"]
        plain = embedding.lookup_multihot(model.table, cfg, bags, use_kernel=False)
        k7 = launch_counts()["embedding_bag"] - k7
    err, ok = close(out["lookup_multihot"][0], plain, 1e-6)
    log(f"  lookup_multihot use_kernel=True vs False: max abs err {err:.3e} (within rtol = "
        f"atol = 1e-6: {ok}); the plain path launched K7 {k7} times")
    if not ok or k7:
        raise AssertionError(f"lookup_multihot: max abs err {err}, not within rtol = atol = "
                             "1e-6, or the plain path launched K7")
    return {name: wall for name, (_, wall) in out.items()}


# --------------------------------------------------------------------------
# Phases 13 and 14: training and ring attention (their own launch window)
# --------------------------------------------------------------------------
def leaf_rel(got: dict, want: dict) -> float:
    """The largest over the named tensors of || got - want || / || want ||."""
    import torch

    worst = 0.0
    for name, w in want.items():
        g = got[name].detach().cpu().float()
        w = w.detach().cpu().float()
        worst = max(worst, float(torch.linalg.vector_norm(g - w)
                                 / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)))
    return worst


def train_card_vs_cpu(label: str, m_dev, m_cpu, step_dev, step_cpu, batches) -> dict:
    """The same train step on the card and on the CPU port from the same
    weights, one batch a step: the losses and every parameter and moment
    leaf within ``TRAIN_REL`` (relative)."""
    from repro_torch.train import optimizer as opt

    s_dev, s_cpu = opt.init_state(m_dev), opt.init_state(m_cpu)
    losses = []
    for batch in batches:
        m_dev, s_dev, a = step_dev(m_dev, s_dev, batch)
        m_cpu, s_cpu, b = step_cpu(m_cpu, s_cpu, batch)
        losses.append((float(a["loss"]), float(b["loss"])))
    loss_rel = max(abs(a - b) / abs(b) for a, b in losses)
    p_rel = leaf_rel(dict(m_dev.named_parameters()), dict(m_cpu.named_parameters()))
    m_rel = max(leaf_rel(s_dev[k], s_cpu[k]) for k in ("m", "v"))
    log(f"  {label}: {len(losses)} steps, losses card {[a for a, _ in losses]} / CPU "
        f"{[b for _, b in losses]}; worst loss rel {loss_rel:.3e}, parameter leaf rel "
        f"{p_rel:.3e}, moment leaf rel {m_rel:.3e} (<= {TRAIN_REL:g})")
    if not (loss_rel <= TRAIN_REL and p_rel <= TRAIN_REL and m_rel <= TRAIN_REL):
        raise AssertionError(f"{label}: the card and the CPU port part: loss {loss_rel}, "
                             f"parameters {p_rel}, moments {m_rel} > {TRAIN_REL}")
    return {"losses": losses, "loss_rel": loss_rel, "param_rel": p_rel, "moment_rel": m_rel}


def train_smoke_configs() -> dict:
    """[train] (a): yi_6b's and deepseek_v2_lite_16b's smoke configs (3
    steps of ``make_lm_train_step``, remat and chunked cross-entropy on)
    and AutoInt's (3 steps of ``make_recsys_train_step``) on the card
    against the CPU port from the same weights."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import LMTokenPipeline, RecsysPipeline
    from repro_torch.models import transformer as tf
    from repro_torch.models.recsys import autoint
    from repro_torch.train import steps

    out = {}
    for arch in ("yi_6b", "deepseek_v2_lite_16b"):
        small = get_smoke(arch)
        m_dev = tf.init_params(torch.Generator(device=DEVICE).manual_seed(5), small,
                               device=DEVICE)
        m_cpu = tf.Transformer(small, device="cpu")
        m_cpu.load_state_dict({k: v.cpu() for k, v in m_dev.state_dict().items()})
        pipe = LMTokenPipeline(small, 2, 33, seed=7)
        step = steps.make_lm_train_step(small, chunk_q=16, remat=True, ce_chunk=8)
        out[arch] = train_card_vs_cpu(f"{small.name} train steps, card vs CPU port", m_dev,
                                      m_cpu, step, step, [pipe.batch_at(i) for i in range(3)])
    small = get_smoke("autoint")
    m_dev = autoint.init_params(torch.Generator(device=DEVICE).manual_seed(6), small,
                                device=DEVICE)
    m_cpu = autoint.AutoInt(small, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_dev.state_dict().items()})
    step = steps.make_recsys_train_step(small)
    pipe = RecsysPipeline(small, 64, seed=8)
    out["autoint"] = train_card_vs_cpu(f"{small.name} train steps, card vs CPU port", m_dev,
                                       m_cpu, step, step, [pipe.batch_at(i) for i in range(3)])
    return out


def timed_steps(label: str, step, model, state, batches, sync) -> tuple[list, list]:
    """Run ``step`` over ``batches``; (losses, synchronised walls in ms).
    Every loss must be finite."""
    losses, walls = [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))  # reads the loss: a synchronisation
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"{label}: step {i} loss {losses[-1]} is not finite")
    log(f"  {label}: losses {losses}")
    log(f"  {label}: step walls (ms) {walls}")
    return losses, walls


def train_phase() -> dict:
    """[train], as the module docstring says: (a) the smoke configs against
    the CPU port, (b) Yi-6B at full width, (c) DeepSeek-V2-Lite's MoE, (d)
    AutoInt at its full table, (e) ``train_lm``'s restart and a card-written
    checkpoint restored on the CPU."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMTokenPipeline, RecsysPipeline
    from repro_torch.launch.train import train_lm, train_state_tree
    from repro_torch.models import transformer as tf
    from repro_torch.models.recsys import autoint
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.utils import tree_leaves

    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    out = {"a": train_smoke_configs()}

    # (b) Yi-6B at full width, TRAIN_YI_LAYERS layers, f32
    cfg = dataclasses.replace(get_config("yi_6b"), n_layers=TRAIN_YI_LAYERS)
    model = tf.init_params(torch.Generator(device=DEVICE).manual_seed(10), cfg, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    pipe = LMTokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batch0 = pipe.batch_at(0)
    params = list(model.requires_grad_(True).parameters())

    def loss_and_norm(**kw):
        t0 = time.perf_counter()
        with torch.enable_grad():
            loss = tf.loss_fn(model, cfg, batch0, **kw)
            grads = torch.autograd.grad(loss, params)
        norm = float(opt.global_norm(grads))
        del grads
        return float(loss.detach()), norm, (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    l_r, n_r, w_r = loss_and_norm(remat=True, ce_chunk=TRAIN_CE_CHUNK)
    l_f, n_f, w_f = loss_and_norm(remat=False)
    peak_full = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {cfg.name} x{TRAIN_YI_LAYERS} layers ({n_params:,} parameters) step 0: remat + "
        f"chunked CE loss {l_r!r}, grad norm {n_r!r} ({w_r:.1f} ms); no remat, full CE loss "
        f"{l_f!r}, grad norm {n_f!r} ({w_f:.1f} ms); peak {peak_full:.2f} GB")
    if not (abs(l_r - l_f) <= 1e-5 * abs(l_f) and abs(n_r - n_f) <= 1e-4 * n_f):
        raise AssertionError(f"{cfg.name}: remat + chunked CE (loss {l_r}, norm {n_r}) and the "
                             f"plain loss (loss {l_f}, norm {n_f}) part")
    state = opt.init_state(model)
    step = steps.make_lm_train_step(cfg, remat=True, ce_chunk=TRAIN_CE_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    losses, walls = timed_steps(f"{cfg.name} x{TRAIN_YI_LAYERS}", step, model, state,
                                [pipe.batch_at(i) for i in range(TRAIN_STEPS)], sync)
    peak = torch.cuda.max_memory_allocated() / 1e9
    med = float(np.median(walls[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"  {cfg.name} x{TRAIN_YI_LAYERS}: step wall median of steps 2-{TRAIN_STEPS} "
        f"{med:.3f} ms, {tokens / med * 1e3:.1f} tokens/s, peak allocated {peak:.2f} GB")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: the loss did not fall ({losses[0]} -> {losses[-1]})")
    out["b"] = {"params": n_params, "losses": losses, "walls_ms": walls, "median_ms": med,
                "tokens_per_s": tokens / med * 1e3, "peak_gb": peak,
                "peak_step0_checks_gb": peak_full, "step0": {
                    "remat_chunked": [l_r, n_r, w_r], "plain": [l_f, n_f, w_f]}}
    del model, state, params, step
    torch.cuda.empty_cache()

    # (c) DeepSeek-V2-Lite at full width, its dense layer and one MoE layer
    cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b"), n_layers=TRAIN_DS_LAYERS)
    model = tf.init_params(torch.Generator(device=DEVICE).manual_seed(11), cfg, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    pipe = LMTokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=1)
    batch0 = pipe.batch_at(0)
    router = model.layers[-1].moe.router
    with torch.no_grad():
        _, aux = tf.hidden(model, cfg, torch.as_tensor(batch0["tokens"], device=DEVICE))
    model.requires_grad_(True)
    with torch.enable_grad():
        (g_router,) = torch.autograd.grad(
            tf.loss_fn(model, cfg, batch0, remat=True, ce_chunk=TRAIN_CE_CHUNK), [router])
    aux, g_norm = float(aux), float(g_router.norm())
    log(f"  {cfg.name} x{TRAIN_DS_LAYERS} layers ({n_params:,} parameters): aux {aux!r}, "
        f"router gradient norm {g_norm!r}")
    if not (aux > 0 and g_norm > 0):
        raise AssertionError(f"{cfg.name}: aux {aux} or router gradient {g_norm} is 0")
    state = opt.init_state(model)
    step = steps.make_lm_train_step(cfg, remat=True, ce_chunk=TRAIN_CE_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    losses, walls = timed_steps(f"{cfg.name} x{TRAIN_DS_LAYERS}", step, model, state,
                                [pipe.batch_at(i) for i in range(TRAIN_DS_STEPS)], sync)
    out["c"] = {"params": n_params, "aux": aux, "router_grad_norm": g_norm, "losses": losses,
                "walls_ms": walls, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model, state, step, router, g_router
    torch.cuda.empty_cache()

    # (d) AutoInt at its full table
    cfg = get_config("autoint")
    model = autoint.init_params(torch.Generator(device=DEVICE).manual_seed(12), cfg,
                                device=DEVICE)
    pipe = RecsysPipeline(cfg, TRAIN_RECSYS_ROWS, seed=0)
    batches = [pipe.batch_at(i) for i in range(TRAIN_RECSYS_STEPS)]
    with torch.no_grad():  # the first batch's loss before and after: no batch noise
        before = float(autoint.bce_loss(model, cfg, batches[0]))
    state = opt.init_state(model)
    step = steps.make_recsys_train_step(cfg)
    losses, walls = timed_steps(f"{cfg.name} ({cfg.n_sparse * cfg.vocab_per_field:,} rows)",
                                step, model, state, batches, sync)
    with torch.no_grad():
        after = float(autoint.bce_loss(model, cfg, batches[0]))
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"  {cfg.name}: the first batch's loss {before!r} before the steps, {after!r} after; "
        f"mean step loss of the first 5 steps {first!r}, of the last 5 {last!r}; step wall "
        f"median {float(np.median(walls[1:])):.3f} ms")
    if not after < before:
        raise AssertionError(f"{cfg.name}: the loss did not fall ({before} -> {after})")
    out["d"] = {"losses": losses, "first_batch_loss": [before, after], "walls_ms": walls,
                "median_ms": float(np.median(walls[1:]))}
    del model, state, step
    torch.cuda.empty_cache()

    # (e) train_lm: 8 steps against 4 + restore + 4, and the card's checkpoint on the CPU
    kw = dict(steps=8, batch=2, seq=16, log_every=100, device=DEVICE)
    full = train_lm("yi_6b", **kw)
    with tempfile.TemporaryDirectory() as tmp:
        train_lm("yi_6b", **{**kw, "steps": 4}, ckpt_dir=tmp, ckpt_every=4)
        resumed = train_lm("yi_6b", **kw, ckpt_dir=tmp, ckpt_every=4)
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"], full["losses"][4:]))
        like = train_state_tree(resumed["model"], resumed["opt_state"], resumed["model"].cfg)
        got = CheckpointManager(tmp).restore(8, like, device="cpu")
        flat = list(zip(tree_leaves(got), tree_leaves(like)))
        exact = all(a.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in flat)
    log(f"  train_lm yi_6b smoke: losses 4-7 resumed {resumed['losses']} / uninterrupted "
        f"{full['losses'][4:]} (rel {rel:.3e} <= 1e-4); the card's step-8 checkpoint "
        f"restored on the CPU, {len(flat)} leaves bit-identical: {exact}")
    if not (rel <= 1e-4 and exact and len(resumed["losses"]) == 4):
        raise AssertionError(f"train_lm: the resumed run parts ({rel}) or the checkpoint "
                             "restored on the CPU differs")
    out["e"] = {"loss_rel": rel, "leaves": len(flat)}
    return out


def ring_attention_phase() -> tuple[dict, tuple]:
    """[ring attention]: ``ring_attention`` at ``RING_ATTN`` (f32, causal)
    sequential and on ``make_ring_mesh(n, devices=[cuda:0] * n)`` for n in
    ``RING_WIDTHS``, each against ``chunked_attention`` on the same inputs
    (rtol 2e-4, atol 2e-5, the reference test's tolerance), with TF32 off.
    Returns the walls and the inputs (for the K6 wall beside them)."""
    import torch

    from repro_torch.launch import make_ring_mesh
    from repro_torch.models.chunked_attention import chunked_attention
    from repro_torch.models.ring_attention import ring_attention

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on: ring attention is held to f32 arithmetic")
    b, h, s, d = (RING_ATTN[k] for k in ("b", "h", "s", "d"))
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=DEVICE) for _ in range(3))
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)

    def wall(fn):
        fn()  # warm-up (the stages' streams, the allocator's pools)
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    out = {}
    with torch.no_grad():
        want, out["chunked_ms"] = wall(lambda: chunked_attention(q, k, v, causal=True,
                                                                 chunk_q=1024))
        log(f"  chunked_attention (B {b}, H {h}, S {s}, D {d}, f32, causal): "
            f"{out['chunked_ms']:.3f} ms")
        for n in RING_WIDTHS:
            for label, mesh in (("sequential", None),
                                ("mesh", make_ring_mesh(n, devices=[DEVICE] * n))):
                got, ms = wall(lambda: ring_attention(q, k, v, n_stages=n, mesh=mesh))
                diff = (got - want).abs()
                err = float(diff.max())
                ok = bool((diff <= 2e-5 + 2e-4 * want.abs()).all()) and \
                    bool(torch.isfinite(got).all())
                log(f"  ring_attention {label:10s} {n} stages: {ms:.3f} ms, max abs err "
                    f"{err:.3e} against chunked_attention (rtol 2e-4, atol 2e-5: {ok})")
                if not ok:
                    raise AssertionError(f"ring attention {label} at {n} stages: max abs "
                                         f"err {err}")
                out[f"{label}_{n}"] = {"ms": ms, "max_abs_err": err}
                del got, diff
    return out, (q, k, v)


def serve_after_train() -> dict:
    """After one train step the flash forward (K6) and K7's lookup run on
    the card and equal a fresh model's loaded with the trained weights;
    every weight's ``requires_grad`` is as the step found it (ROADMAP.md
    C1). Outside the launch windows: these are serving launches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import LMTokenPipeline, RecsysPipeline
    from repro_torch.models import transformer as tf
    from repro_torch.models.recsys import autoint, embedding
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps

    cfg = get_smoke("yi_6b")
    model = tf.init_params(torch.Generator(device=DEVICE).manual_seed(13), cfg, device=DEVICE)
    batch = LMTokenPipeline(cfg, 2, 32, seed=13).batch_at(0)
    steps.make_lm_train_step(cfg, chunk_q=16)(model, opt.init_state(model), batch)
    lm_flags = any(p.requires_grad for p in model.parameters())
    tokens = torch.as_tensor(batch["tokens"], device=DEVICE)
    fresh = tf.Transformer(cfg, device=DEVICE)
    fresh.load_state_dict(model.state_dict())
    got, _ = tf.forward(model, cfg, tokens, use_flash=True, chunk_q=16)
    want, _ = tf.forward(fresh, cfg, tokens, use_flash=True, chunk_q=16)
    lm_equal = torch.equal(got, want) and not got.requires_grad

    rcfg = get_smoke("autoint")
    rmodel = autoint.init_params(torch.Generator(device=DEVICE).manual_seed(14), rcfg,
                                 device=DEVICE)
    steps.make_recsys_train_step(rcfg)(rmodel, opt.init_state(rmodel),
                                       RecsysPipeline(rcfg, 64, seed=14).batch_at(0))
    rec_flags = any(p.requires_grad for p in rmodel.parameters())
    bags = torch.as_tensor(np.random.default_rng(14).integers(
        0, rcfg.vocab_per_field + 3, (64, rcfg.n_sparse, 4)), device=DEVICE)
    rfresh = autoint.AutoInt(rcfg, device=DEVICE)
    rfresh.load_state_dict(rmodel.state_dict())
    got = embedding.lookup_multihot(rmodel.table, rcfg, bags, use_kernel=True)
    rec_equal = torch.equal(got, embedding.lookup_multihot(rfresh.table, rcfg, bags,
                                                           use_kernel=True))
    log(f"  after a train step (C1): weights requiring grad: LM {lm_flags}, AutoInt "
        f"{rec_flags}; the flash forward equals a fresh model's: {lm_equal}; K7's lookup "
        f"equals a fresh model's: {rec_equal}")
    if lm_flags or rec_flags or not (lm_equal and rec_equal):
        raise AssertionError("serving after a train step fails or differs (C1)")
    return {"lm_equal": lm_equal, "recsys_equal": rec_equal}


def ring_attention_beside_k6(out: dict, qkv) -> None:
    """The tf32x3 K6 on [ring attention]'s inputs, its wall printed beside
    the rings' (no claim: a comparison launch, outside the launch window)."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention, kernel_route

    q, k, v = qkv
    with torch.no_grad():
        route = kernel_route(q.dtype, q.shape[-1]) if DEVICE == "cuda" else "plain"
        got = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    out["k6"] = {"route": route, "ms": ms}
    log(f"  K6 ({route}) on the same inputs: {ms:.3f} ms, finite: "
        f"{bool(torch.isfinite(got).all())} (printed beside the rings, no claim)")


# --------------------------------------------------------------------------
# Phase 15: the GNNs (their own launch window)
# --------------------------------------------------------------------------
def gnn_shapes() -> dict:
    """configs/shapes.py's GNN_SHAPES by name."""
    from repro_torch.configs.shapes import GNN_SHAPES

    return {s.name: s for s in GNN_SHAPES}


def gnn_pairs(n: int, pairs: int, rng):
    """``pairs`` uniform node pairs u != v, both ways: (2 · pairs, 2) int32."""
    import numpy as np

    from repro_torch.models.gnn.common import bidirect

    u = rng.integers(0, n, pairs)
    v = (u + rng.integers(1, n, pairs)) % n
    return bidirect(np.stack([u, v], 1).astype(np.int32))


def gnn_molecules(shape, rng) -> dict:
    """A batch of ``shape.batch_graphs`` molecules of ``shape.n_nodes`` atoms:
    positions N(0, 1.5²) per axis, species in [0, GNN_SPECIES), each
    molecule's ``shape.n_edges // 2`` nearest atom pairs both ways, the
    batch's edges padded with GNN_MOL_PAD phantom edges, graph ids, and
    DimeNet's triplets from ``build_triplets`` over the real edges."""
    import numpy as np

    from repro_torch.models.gnn.common import pad_edges
    from repro_torch.models.gnn.dimenet import build_triplets

    n_at, n_mol, pairs = shape.n_nodes, shape.batch_graphs, shape.n_edges // 2
    pos = (rng.standard_normal((n_mol, n_at, 3)) * 1.5).astype(np.float32)
    iu, ju = np.triu_indices(n_at, 1)
    near = np.argsort(np.linalg.norm(pos[:, iu] - pos[:, ju], axis=-1), axis=1,
                      kind="stable")[:, :pairs]
    off = (np.arange(n_mol) * n_at)[:, None]
    src, dst = iu[near] + off, ju[near] + off
    edges = np.concatenate([np.stack([src, dst], -1), np.stack([dst, src], -1)],
                           axis=1).reshape(-1, 2).astype(np.int32)
    n = n_mol * n_at
    z = rng.integers(0, GNN_SPECIES, n).astype(np.int32)
    return {"z": z, "pos": pos.reshape(n, 3), "real_edges": edges,
            "edges": pad_edges(edges, len(edges) + GNN_MOL_PAD, n),
            "triplets": build_triplets(edges, n), "n_graphs": n_mol,
            "graph_ids": np.repeat(np.arange(n_mol), n_at).astype(np.int32),
            "target": rng.standard_normal(n_mol).astype(np.float32)}


def gnn_chung_lu(n: int, m: int, gen):
    """``m`` directed edges (src, dst) on the card, each endpoint drawn with
    weight i^-GNN_ALPHA over n nodes (two int64 (m,) tensors)."""
    import torch

    w = torch.arange(1, n + 1, dtype=torch.float64, device=DEVICE) ** -GNN_ALPHA
    cdf = torch.cumsum(w, 0) / w.sum()
    return [torch.searchsorted(cdf, torch.rand(m, dtype=torch.float64, generator=gen,
                                               device=DEVICE)).clamp_(max=n - 1)
            for _ in range(2)]


def gnn_csr(n: int, m: int, gen):
    """A host CSR (indptr int64 (n + 1,), indices int32 (m,)) of ``m``
    Chung-Lu edges, drawn and sorted on the card."""
    import torch

    src, dst = gnn_chung_lu(n, m, gen)
    src, order = torch.sort(src)
    indices = dst[order].to(torch.int32).cpu().numpy()
    del dst, order
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=DEVICE)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    return indptr.cpu().numpy(), indices


def gnn_block_dicts(mb) -> list:
    """A ``MiniBatch``'s blocks as ``forward_sampled`` takes them, innermost
    hop first (host numpy; ``gnn_loss`` moves them to the model's device)."""
    return [{"src_idx": blk.src_nodes, "dst_index": blk.dst_index, "mask": blk.mask,
             "n_dst": len(blk.nodes)} for blk in reversed(mb.blocks)]


def gnn_smoke_cases(rng) -> list:
    """[gnn] (a)'s cases: (label, arch, init keyword, batch) at the smoke
    configs, small graphs from ``rng``."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.configs.shapes import GraphShape
    from repro_torch.graphs import generators, to_csr
    from repro_torch.graphs.sampler import NeighborSampler
    from repro_torch.models.gnn.common import pad_edges

    n_classes = get_smoke("gin_tu").n_classes
    edges = pad_edges(gnn_pairs(40, 60, rng), 127, 40)
    mols = gnn_molecules(GraphShape("molecule-smoke", 8, 16, batch_graphs=4), rng)
    g = generators.powerlaw(200, m_per_node=5, seed=GNN_SEED)
    mb = NeighborSampler(*to_csr(g), [5, 3, 2], seed=GNN_SEED).sample(np.arange(16))
    return [
        ("gin nodes", "gin_tu", {"d_in": 8},
         {"x": rng.standard_normal((40, 8)).astype(np.float32), "edges": edges,
          "labels": rng.integers(0, n_classes, 40)}),
        ("gin graphs", "gin_tu", {"d_in": GNN_SPECIES},
         {"x": np.eye(GNN_SPECIES, dtype=np.float32)[mols["z"]], "edges": mols["edges"],
          "graph_ids": mols["graph_ids"], "n_graphs": mols["n_graphs"],
          "labels": rng.integers(0, n_classes, mols["n_graphs"])}),
        ("gin sampled", "gin_tu", {"d_in": 8},
         {"x": rng.standard_normal((g.n_nodes, 8)).astype(np.float32),
          "blocks": gnn_block_dicts(mb), "labels": rng.integers(0, n_classes, 16)}),
        ("graphcast", "graphcast", {},
         {"x": rng.standard_normal((40, 11)).astype(np.float32), "edges": edges,
          "target": rng.standard_normal((40, 11)).astype(np.float32)}),
        ("dimenet", "dimenet", {}, {k: mols[k] for k in (
            "z", "pos", "edges", "triplets", "graph_ids", "n_graphs", "target")}),
        ("mace", "mace", {}, {k: mols[k] for k in (
            "z", "pos", "edges", "graph_ids", "n_graphs", "target")}),
    ]


def gnn_init(arch: str, cfg, gen, **kw):
    from repro_torch.models.gnn import dimenet, gin, graphcast, mace

    return {"gin_tu": gin, "graphcast": graphcast, "dimenet": dimenet,
            "mace": mace}[arch].init_params(gen, cfg, **kw, device=DEVICE)


def gnn_loss_and_grads(model, cfg, batch, loss_fn=None) -> tuple[float, dict]:
    """``loss_fn(model, batch)`` (``gnn_loss`` by default) and its gradient by
    parameter name."""
    import torch

    from repro_torch.train.steps import gnn_loss

    named = dict(model.named_parameters())
    model.requires_grad_(True)
    try:
        loss = (loss_fn or (lambda m, b: gnn_loss(m, cfg, b)))(model, batch)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                    materialize_grads=True)
    finally:
        model.requires_grad_(False)
    return float(loss.detach()), dict(zip(named, grads))


def gnn_card_vs_cpu() -> dict:
    """[gnn] (a): each smoke case on the card and on the CPU port from the
    same weights (the card's, through ``convert``): the loss, every gradient
    leaf, and the parameters and moments after one ``make_gnn_train_step``
    step within GNN_REL (relative, a leaf by its norm)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.convert import gnn_params_from_numpy, gnn_params_to_numpy
    from repro_torch.train import optimizer as opt
    from repro_torch.train.steps import make_gnn_train_step

    out = {}
    for label, arch, kw, batch in gnn_smoke_cases(np.random.default_rng(GNN_SEED)):
        cfg = get_smoke(arch)
        m_dev = gnn_init(arch, cfg, torch.Generator(device=DEVICE).manual_seed(GNN_SEED), **kw)
        m_cpu = gnn_params_from_numpy(gnn_params_to_numpy(m_dev, cfg), cfg, device="cpu")
        (l_dev, g_dev), (l_cpu, g_cpu) = (gnn_loss_and_grads(m, cfg, batch)
                                          for m in (m_dev, m_cpu))
        loss_rel, grad_rel = abs(l_dev - l_cpu) / abs(l_cpu), leaf_rel(g_dev, g_cpu)
        step = make_gnn_train_step(cfg)
        s_dev, s_cpu = opt.init_state(m_dev), opt.init_state(m_cpu)
        step(m_dev, s_dev, batch)
        step(m_cpu, s_cpu, batch)
        p_rel = leaf_rel(dict(m_dev.named_parameters()), dict(m_cpu.named_parameters()))
        m_rel = max(leaf_rel(s_dev[k], s_cpu[k]) for k in ("m", "v"))
        log(f"  {cfg.name} {label}: loss card {l_dev!r} / CPU {l_cpu!r} (rel {loss_rel:.3e}); "
            f"gradient leaf rel {grad_rel:.3e}; after one step parameter leaf rel "
            f"{p_rel:.3e}, moment leaf rel {m_rel:.3e} (<= {GNN_REL:g})")
        if not max(loss_rel, grad_rel, p_rel, m_rel) <= GNN_REL:
            raise AssertionError(f"[gnn] {label}: the card and the CPU port part: loss "
                                 f"{loss_rel}, gradients {grad_rel}, parameters {p_rel}, "
                                 f"moments {m_rel} > {GNN_REL}")
        out[label] = {"loss_rel": loss_rel, "grad_rel": grad_rel, "param_rel": p_rel,
                      "moment_rel": m_rel}
    return out


def gnn_steps(label: str, cfg, model, batch, n_steps: int, sync) -> dict:
    """``n_steps`` of ``make_gnn_train_step`` on one batch: every loss finite;
    the losses, walls, their median past the first, and the peak memory."""
    import numpy as np
    import torch

    from repro_torch.train import optimizer as opt
    from repro_torch.train.steps import make_gnn_train_step

    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    losses, walls = timed_steps(label, make_gnn_train_step(cfg), model,
                                opt.init_state(model), [batch] * n_steps, sync)
    out = {"losses": losses, "walls_ms": walls, "median_ms": float(np.median(walls[1:])),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "held_gb": held}
    log(f"  {label}: step wall median of steps 2-{n_steps} {out['median_ms']:.3f} ms, peak "
        f"allocated {out['peak_gb']:.2f} GB ({held:.2f} GB held before the steps: the model, "
        "the batch, and what earlier phases keep)")
    return out


def gnn_energies(fwd, model, cfg, mol: dict, **over) -> "torch.Tensor":
    import torch

    b = {**mol, **over}
    args = [torch.as_tensor(b[k], device=DEVICE) for k in ("z", "pos", "edges")]
    if "triplets" in b:
        args.append(torch.as_tensor(b["triplets"], device=DEVICE))
    with torch.no_grad():
        return fwd(model, cfg, *args, graph_ids=torch.as_tensor(b["graph_ids"], device=DEVICE),
                   n_graphs=b["n_graphs"])


def gnn_phase() -> dict:
    """[gnn], as the module docstring says: (a) the smoke configs on the card
    against the CPU port; (b) GIN at full_graph_sm and molecule; (c) GIN's
    sampled mini-batches at minibatch_lg; (d) GraphCast; (e) DimeNet and
    MACE at molecule, MACE's invariances; (f) GIN at ogb_products."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.graphs.sampler import NeighborSampler
    from repro_torch.models.gnn import dimenet, gin, graphcast, mace
    from repro_torch.models.gnn.common import pad_edges
    from repro_torch.train.steps import gnn_loss, make_gnn_train_step
    from repro_torch.train import optimizer as opt

    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    shapes, rng = gnn_shapes(), np.random.default_rng(GNN_SEED)
    gen = torch.Generator(device=DEVICE).manual_seed(GNN_SEED)
    out = {"a": gnn_card_vs_cpu()}

    # (b) GIN at full_graph_sm (node classification) and molecule (graphs)
    cfg, sh = get_config("gin_tu"), shapes["full_graph_sm"]
    edges = gnn_pairs(sh.n_nodes, sh.n_edges // 2, rng)
    batch = {"x": torch.randn((sh.n_nodes, sh.d_feat), generator=gen, device=DEVICE),
             "edges": torch.as_tensor(edges, device=DEVICE),
             "labels": torch.randint(0, cfg.n_classes, (sh.n_nodes,), generator=gen,
                                     device=DEVICE)}
    model = gin.init_params(gen, cfg, sh.d_feat, device=DEVICE)
    out["b"] = {"full_graph_sm": gnn_steps(
        f"{cfg.name} at full_graph_sm ({sh.n_nodes:,} nodes, {len(edges):,} edges, "
        f"{sh.d_feat:,} features)", cfg, model, batch, GNN_GIN_STEPS, sync)}
    mol_shape = shapes["molecule"]
    mols = gnn_molecules(mol_shape, rng)
    model = gin.init_params(gen, cfg, GNN_SPECIES, device=DEVICE)
    batch = {"x": torch.as_tensor(np.eye(GNN_SPECIES, dtype=np.float32)[mols["z"]],
                                  device=DEVICE),
             "edges": torch.as_tensor(mols["edges"], device=DEVICE),
             "graph_ids": torch.as_tensor(mols["graph_ids"], device=DEVICE),
             "n_graphs": mols["n_graphs"],
             "labels": torch.as_tensor(rng.integers(0, cfg.n_classes, mols["n_graphs"]),
                                       device=DEVICE)}
    out["b"]["molecule"] = gnn_steps(
        f"{cfg.name} at molecule ({mols['n_graphs']} graphs of {mol_shape.n_nodes} atoms, "
        f"{len(mols['real_edges']):,} edges)", cfg, model, batch, GNN_GIN_STEPS, sync)
    del model, batch

    # (c) GIN's sampled mini-batches at minibatch_lg
    sh = shapes["minibatch_lg"]
    t0 = time.perf_counter()
    indptr, indices = gnn_csr(sh.n_nodes, sh.n_edges, gen)
    csr_ms = (time.perf_counter() - t0) * 1e3
    sampler = NeighborSampler(indptr, indices, list(sh.fanout), seed=GNN_SEED)
    x = torch.randn((sh.n_nodes, GNN_MB_FEAT), generator=gen, device=DEVICE)
    model = gin.init_params(gen, cfg, GNN_MB_FEAT, device=DEVICE)
    state, step = opt.init_state(model), make_gnn_train_step(cfg)
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    sample_ms, step_ms, losses, sizes = [], [], [], []
    for _ in range(GNN_MB_BATCHES):
        seeds = rng.choice(sh.n_nodes, sh.batch_nodes, replace=False)
        t0 = time.perf_counter()
        mb = sampler.sample(seeds)
        sample_ms.append((time.perf_counter() - t0) * 1e3)
        sizes.append([len(blk.nodes) for blk in mb.blocks] + [len(mb.input_nodes)])
        batch = {"x": x, "blocks": gnn_block_dicts(mb),
                 "labels": rng.integers(0, cfg.n_classes, sh.batch_nodes)}
        t0 = time.perf_counter()
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"[gnn] (c): a sampled step's loss {losses[-1]} is not finite")
    out["c"] = {"csr_ms": csr_ms, "sample_ms": sample_ms, "step_ms": step_ms,
                "losses": losses, "block_sizes": sizes,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "held_gb": held}
    log(f"  {cfg.name} at minibatch_lg ({sh.n_nodes:,} nodes, {sh.n_edges:,} edges drawn "
        f"on the card into a host CSR in {csr_ms:.1f} ms; {GNN_MB_FEAT} features): "
        f"{GNN_MB_BATCHES} batches of {sh.batch_nodes:,} seeds at fanout {sh.fanout}, "
        f"(dst nodes per hop, input nodes) {sizes}; host sampler walls (ms) {sample_ms}; "
        f"card step walls (ms) {step_ms}; losses {losses}; peak allocated "
        f"{out['c']['peak_gb']:.2f} GB ({held:.2f} GB held before the steps)")
    del sampler, indptr, indices, x, model, state, batch
    torch.cuda.empty_cache()

    # (d) GraphCast on full_graph_sm's graph
    cfg, sh = get_config("graphcast"), shapes["full_graph_sm"]
    batch = {"x": torch.randn((sh.n_nodes, cfg.n_vars), generator=gen, device=DEVICE),
             "edges": torch.as_tensor(edges, device=DEVICE),
             "target": torch.randn((sh.n_nodes, cfg.n_vars), generator=gen, device=DEVICE)}
    model = graphcast.init_params(gen, cfg, device=DEVICE)
    with torch.no_grad():
        t0 = time.perf_counter()
        pred = graphcast.forward(model, cfg, batch["x"], batch["edges"])
        sync()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        loss0 = float(gnn_loss(model, cfg, batch))
    if pred.shape != (sh.n_nodes, cfg.n_vars) or not bool(torch.isfinite(pred).all()):
        raise AssertionError(f"[gnn] (d): GraphCast's forward {tuple(pred.shape)} is not "
                             "finite or misshaped")
    log(f"  {cfg.name} ({cfg.n_layers} layers, d {cfg.d_hidden}, {cfg.n_vars} vars): forward "
        f"{fwd_ms:.3f} ms, mse_loss {loss0!r}")
    out["d"] = {"forward_ms": fwd_ms, "mse_loss": loss0, **gnn_steps(
        f"{cfg.name} at full_graph_sm's graph", cfg, model, batch, GNN_GNN_STEPS, sync)}
    del model, batch, pred

    # (e) DimeNet and MACE at molecule; MACE's invariances on the card
    out["e"] = {}
    for arch, mod in (("dimenet", dimenet), ("mace", mace)):
        cfg = get_config(arch)
        model = mod.init_params(gen, cfg, GNN_SPECIES, device=DEVICE)
        keys = ("z", "pos", "edges", "graph_ids", "n_graphs", "target") + (
            ("triplets",) if arch == "dimenet" else ())
        batch = {k: mols[k] for k in keys}
        energies = gnn_energies(mod.forward_energy, model, cfg, batch)
        with torch.no_grad():
            loss0 = float(gnn_loss(model, cfg, batch))
        if energies.shape != (mols["n_graphs"],) or not bool(torch.isfinite(energies).all()):
            raise AssertionError(f"[gnn] (e): {cfg.name}'s energies are not finite or "
                                 "misshaped")
        log(f"  {cfg.name}: {mols['n_graphs']} energies in [{float(energies.min())!r}, "
            f"{float(energies.max())!r}], mse_loss {loss0!r}"
            + (f", {int((mols['triplets'][:, 0] < len(mols['real_edges'])).sum()):,} "
               f"real triplets of {len(mols['triplets']):,}" if arch == "dimenet" else ""))
        out["e"][arch] = {"mse_loss": loss0, **gnn_steps(
            f"{cfg.name} at molecule", cfg, model, batch, GNN_GNN_STEPS, sync)}
    # each atom's site energy (every atom its own graph id), held to its
    # molecule's largest: at these random weights site energies reach ~1e10
    # and a site or a molecule's sum can cancel to ~1e-2 (CPU rehearsal), so a
    # bound relative to the value itself would measure float32 rounding
    n = len(mols["z"])
    sites = {"graph_ids": np.arange(n, dtype=np.int32), "n_graphs": n}
    e0 = gnn_energies(mace.forward_energy, model, cfg, batch, **sites).cpu().numpy()
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    pos_r = (mols["pos"].astype(np.float64) @ q.T + rng.normal(size=(1, 3))).astype(np.float32)
    e_rot = gnn_energies(mace.forward_energy, model, cfg, batch, pos=pos_r,
                         **sites).cpu().numpy()
    perm = rng.permutation(n)
    inv = np.argsort(perm)
    e_perm = gnn_energies(mace.forward_energy, model, cfg, batch, z=mols["z"][perm],
                          pos=mols["pos"][perm], **sites,
                          edges=pad_edges(inv[mols["real_edges"]].astype(np.int32),
                                          len(mols["edges"]), n)).cpu().numpy()[inv]
    scale = np.abs(e0).reshape(mols["n_graphs"], -1).max(1)[mols["graph_ids"]]
    rot_err = float(np.max(np.abs(e_rot - e0) / (GNN_ROTATION["atol"]
                                                  + GNN_ROTATION["rtol"] * scale)))
    perm_err = float(np.max(np.abs(e_perm - e0) / scale))
    log(f"  {cfg.name} on the card, {n:,} site energies (|E| in [{float(np.abs(e0).min())!r}, "
        f"{float(np.abs(e0).max())!r}]): a rotation + translation moves them by "
        f"{float(np.max(np.abs(e_rot - e0)))!r} at most ({rot_err:.3f} of the bound, rtol "
        f"{GNN_ROTATION['rtol']:g} of the molecule's largest, atol {GNN_ROTATION['atol']:g}); "
        f"a node permutation by {perm_err:.3e} of the molecule's largest (<= "
        f"{GNN_PERMUTATION_RTOL:g})")
    if not (rot_err <= 1.0 and perm_err <= GNN_PERMUTATION_RTOL):
        raise AssertionError(f"[gnn] (e): MACE is not invariant on the card (rotation "
                             f"{rot_err} of its bound, permutation {perm_err})")
    out["e"]["mace"].update(rotation_of_bound=rot_err, permutation_rel=perm_err)
    del model, batch
    torch.cuda.empty_cache()

    # (f) GIN at ogb_products: one (E, 64) f32 message tensor is 15.8 GB;
    # layer 0's (E, 100) gather and its masked copy 49.5 GB (PERF.md §6)
    cfg, sh = get_config("gin_tu"), shapes["ogb_products"]
    src, dst = gnn_chung_lu(sh.n_nodes, sh.n_edges, gen)
    batch = {"x": torch.randn((sh.n_nodes, sh.d_feat), generator=gen, device=DEVICE),
             "edges": torch.stack([src, dst], 1),
             "labels": torch.randint(0, cfg.n_classes, (sh.n_nodes,), generator=gen,
                                     device=DEVICE)}
    del src, dst
    model = gin.init_params(gen, cfg, sh.d_feat, device=DEVICE)
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits = gin.logits_nodes(model, cfg, batch["x"], batch["edges"])
        sync()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_peak = torch.cuda.max_memory_allocated() / 1e9
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("[gnn] (f): GIN's logits at ogb_products are not finite")
    del logits
    log(f"  {cfg.name} at ogb_products ({sh.n_nodes:,} nodes, {sh.n_edges:,} edges, "
        f"{sh.d_feat} features): forward {fwd_ms:.3f} ms, peak allocated {fwd_peak:.2f} GB "
        f"({held:.2f} GB held before it)")
    out["f"] = {"forward_ms": fwd_ms, "forward_peak_gb": fwd_peak, **gnn_steps(
        f"{cfg.name} at ogb_products", cfg, model, batch, 2, sync)}
    del model, batch
    torch.cuda.empty_cache()
    out["g"] = gnn_mesh_phase(gen, sync)
    return out


def gnn_mesh(n_stages: int):
    from repro_torch.launch import make_ring_mesh

    return make_ring_mesh(n_stages, devices=[DEVICE] * n_stages)


def gnn_mesh_smoke(rng) -> dict:
    """(g1): each family's smoke config on one-card meshes of
    GNN_MESH_WIDTHS stages, on the reference test's graph (gnp(64, 0.2,
    seed=1) both ways): the loss and every gradient leaf against the
    single-device model on the card, same weights, within GNN_REL (a leaf by
    its norm); DimeNet (whose partition drops the triplets that cross
    shards, as the reference's does) at one stage, and at GNN_MESH_STAGES
    against the CPU port's partitioned loss."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.convert import gnn_params_from_numpy, gnn_params_to_numpy
    from repro_torch.graphs import generators
    from repro_torch.launch import make_ring_mesh
    from repro_torch.models.gnn import distributed as D
    from repro_torch.models.gnn.common import bidirect, pad_edges
    from repro_torch.models.gnn.dimenet import build_triplets

    n = 64
    edges = bidirect(generators.gnp(n, 0.2, seed=1).edges)
    plain = pad_edges(edges, len(edges) + 8, n)
    out = {}
    for arch, kw in (("gin_tu", {"d_in": 8}), ("graphcast", {}), ("mace", {}),
                     ("dimenet", {})):
        cfg = get_smoke(arch)
        model = gnn_init(arch, cfg, torch.Generator(device=DEVICE).manual_seed(GNN_SEED), **kw)
        feats = {"gin": lambda: {"x": rng.standard_normal((n, 8)).astype(np.float32),
                                 "labels": rng.integers(0, cfg.n_classes, n)},
                 "graphcast": lambda: {
                     "x": rng.standard_normal((n, cfg.n_vars)).astype(np.float32),
                     "target": rng.standard_normal((n, cfg.n_vars)).astype(np.float32)}}.get(
            cfg.family, lambda: {"z": rng.integers(0, 4, n),
                                 "pos": (rng.normal(size=(n, 3)) * 2.0).astype(np.float32),
                                 "target": np.array([0.5], np.float32)})()
        builder = D._BUILDERS[cfg.family]
        widths = GNN_MESH_WIDTHS if cfg.family != "dimenet" else (1, GNN_MESH_STAGES)
        for s in widths:
            part, e_loc = D.partition_edges_by_dst(edges, n, s)
            batch = {**feats, "edges": part}
            if cfg.family == "dimenet":
                batch["triplets"] = build_triplets(part, n)
            loss, grads = gnn_loss_and_grads(model, cfg, batch,
                                             builder(model, cfg, gnn_mesh(s)))
            if cfg.family == "dimenet" and s > 1:
                m_cpu = gnn_params_from_numpy(gnn_params_to_numpy(model, cfg), cfg,
                                              device="cpu")
                want, want_g = gnn_loss_and_grads(
                    m_cpu, cfg, batch, builder(m_cpu, cfg, make_ring_mesh(s, devices=["cpu"] * s)))
                what = "the CPU port's partitioned loss"
            else:
                want, want_g = gnn_loss_and_grads(
                    model, cfg, {**batch, "edges": part if cfg.family == "dimenet" else plain})
                what = "the single-device model"
            loss_rel, grad_rel = abs(loss - want) / abs(want), leaf_rel(grads, want_g)
            log(f"  (g1) {cfg.name} on {s} stage(s) of the card (e_loc {e_loc}): loss {loss!r} "
                f"against {what}'s {want!r} (rel {loss_rel:.3e}), gradient leaf rel "
                f"{grad_rel:.3e} (<= {GNN_REL:g})")
            if not max(loss_rel, grad_rel) <= GNN_REL:
                raise AssertionError(f"[gnn] (g1) {cfg.name} at S={s}: loss {loss_rel}, "
                                     f"gradients {grad_rel} > {GNN_REL} from {what}")
            out[f"{cfg.family} S={s}"] = {"loss": loss, "want": want, "loss_rel": loss_rel,
                                          "grad_rel": grad_rel}
    return out


def gnn_relabelled_chung_lu(n: int, m: int, n_stages: int, gen) -> tuple:
    """(g2)'s graph: [gnn] (f)'s Chung-Lu draw (``gnn_chung_lu``) over ``n``
    nodes, reckoned for ``partition_edges_by_dst`` over ``n_stages`` dst
    shards of n // n_stages rows: where the busiest shard holds more than
    GNN_SKEW · m / n_stages edges, the nodes are relabelled by a random
    permutation (a Chung-Lu graph all the same). Returns (src, dst, the
    reckoning)."""
    import torch

    src, dst = gnn_chung_lu(n, m, gen)
    rows = n // n_stages

    def busiest(d):
        return int(torch.bincount(torch.clamp(d // rows, max=n_stages - 1),
                                  minlength=n_stages).max())

    drawn = busiest(dst)
    reck = {"edges": m, "per_shard_mean": m / n_stages, "busiest_as_drawn": drawn,
            "relabelled": drawn > GNN_SKEW * m / n_stages}
    if reck["relabelled"]:
        perm = torch.randperm(n, generator=gen, device=DEVICE)
        src, dst = perm[src], perm[dst]
        reck["busiest_relabelled"] = busiest(dst)
    return src, dst, reck


def gnn_mesh_phase(gen, sync) -> dict:
    """[gnn] (g), the partitioned engine on one-card meshes: (g1) the smoke
    configs against the single-device models; (g2) GIN at its full config
    at ogb_products through ``make_distributed_gnn_train_step`` at
    GNN_MESH_STAGES stages, its first loss against the single-device
    model's; (g3) GraphCast and MACE at full width in bf16 on the shapes
    [gnn] runs them, against f32, after reckoning ogb_products for both."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.gnn import distributed as D
    from repro_torch.models.gnn import gin
    from repro_torch.models.gnn.mace import _paths
    from repro_torch.train import optimizer as opt
    from repro_torch.train.steps import gnn_loss
    from repro_torch.utils import MatmulDtypes

    rng = np.random.default_rng(GNN_SEED)
    out = {"g1": gnn_mesh_smoke(rng)}
    S = GNN_MESH_STAGES
    mesh = gnn_mesh(S)

    # (g2) GIN at ogb_products, nodes padded to a multiple of S as the
    # reference's dryrun cell pads them
    cfg, sh = get_config("gin_tu"), gnn_shapes()["ogb_products"]
    n = -(-sh.n_nodes // S) * S
    t0 = time.perf_counter()
    src, dst, reck = gnn_relabelled_chung_lu(n, sh.n_edges, S, gen)
    edges = torch.stack([src, dst], 1).to(torch.int32)
    del src, dst
    batch = {"x": torch.randn((n, sh.d_feat), generator=gen, device=DEVICE),
             "edges": edges,
             "labels": torch.randint(0, cfg.n_classes, (n,), generator=gen, device=DEVICE)}
    model = gin.init_params(gen, cfg, sh.d_feat, device=DEVICE)
    with torch.no_grad():
        single = float(gnn_loss(model, cfg, batch))
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    part, e_loc = D.partition_edges_by_dst(edges.cpu().numpy(), n, S)
    part_ms = (time.perf_counter() - t1) * 1e3
    batch["edges"] = torch.as_tensor(part, device=DEVICE)
    del edges, part
    reck.update(e_loc=e_loc, slots=S * e_loc, partition_ms=part_ms,
                setup_s=time.perf_counter() - t0)
    log(f"  (g2) {cfg.name} at ogb_products ({sh.n_nodes:,} nodes padded to {n:,}, "
        f"{sh.n_edges:,} Chung-Lu edges, {sh.d_feat} features) on {S} stages of the card: "
        f"busiest dst shard as drawn {reck['busiest_as_drawn']:,} edges against E/S "
        f"{sh.n_edges / S:,.0f}; relabelled {reck['relabelled']} "
        f"(busiest after: {reck.get('busiest_relabelled', 'n/a')}); e_loc {e_loc:,}, "
        f"S·e_loc {S * e_loc:,} slots; host partition {part_ms:.1f} ms")
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    step = D.make_distributed_gnn_train_step(cfg, mesh)
    losses, walls = timed_steps(f"(g2) {cfg.name} at ogb_products, {S} stages", step, model,
                                opt.init_state(model), [batch] * 2, sync)
    peak = torch.cuda.max_memory_allocated() / 1e9
    rel = abs(losses[0] - single) / abs(single)
    log(f"  (g2) first partitioned loss {losses[0]!r} against the single-device model's "
        f"{single!r} (rel {rel:.3e}, <= {GNN_MESH_REL:g}); step walls {walls} ms, peak "
        f"allocated {peak:.2f} GB ({held:.2f} GB held before the steps) beside [gnn] (f)'s "
        "single-device step (867 ms, 53.07 GB, PERF.md §6)")
    if not rel <= GNN_MESH_REL:
        raise AssertionError(f"[gnn] (g2): the partitioned loss {losses[0]} parts from the "
                             f"single-device loss {single} by {rel} > {GNN_MESH_REL}")
    out["g2"] = {**reck, "single_loss": single, "losses": losses, "loss_rel": rel,
                 "walls_ms": walls, "peak_gb": peak, "held_gb": held}
    del model, batch, step
    torch.cuda.empty_cache()

    # (g3) GraphCast and MACE in bf16; first the reckoning at ogb_products
    e_og = -(-2 * sh.n_edges // (S * 8)) * (S * 8)  # the dryrun cell's edges
    gc_cfg, mc_cfg = get_config("graphcast"), get_config("mace")
    chunk, c = e_og // 8, mc_cfg.d_hidden
    dims = [2 * l + 1 for l in range(mc_cfg.l_max + 1)]
    reckon = {
        "graphcast_edge_state_gb": e_og * gc_cfg.d_hidden * 2 / 1e9,
        "graphcast_saved_edge_carries_gb": gc_cfg.n_layers * e_og * gc_cfg.d_hidden * 2 / 1e9,
        # one edge chunk of 8: the radial weights of every path, the source
        # gathers of every l1, and the widest path's message
        "mace_chunk_gb": chunk * c * 2 * (len(_paths(mc_cfg.l_max)) + sum(dims)
                                          + max(dims)) / 1e9}
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9 if DEVICE == "cuda" \
        else float("inf")
    fits = {"graphcast": reckon["graphcast_saved_edge_carries_gb"] < card_gb,
            "mace": reckon["mace_chunk_gb"] < card_gb}
    log(f"  (g3) reckoned at ogb_products ({e_og:,} edges, the dryrun cell's, bf16): "
        f"GraphCast's edge state {reckon['graphcast_edge_state_gb']:.1f} GB and its "
        f"{gc_cfg.n_layers} checkpointed edge carries "
        f"{reckon['graphcast_saved_edge_carries_gb']:.1f} GB; MACE's working set of one "
        f"edge chunk of 8 (radial weights of {len(_paths(mc_cfg.l_max))} paths, the source "
        f"gathers, the widest message) {reckon['mace_chunk_gb']:.1f} GB; the card holds "
        f"{card_gb:.1f} GB: fits {fits}. Both run on the shapes [gnn] runs them "
        "(full_graph_sm's graph, molecule)")
    out["g3"] = {"reckoning": reckon, "fits_ogb_products": fits}
    shapes = gnn_shapes()
    fg, mol_shape = shapes["full_graph_sm"], shapes["molecule"]
    gc_batch = {"x": torch.randn((fg.n_nodes, gc_cfg.n_vars), generator=gen, device=DEVICE),
                "target": torch.randn((fg.n_nodes, gc_cfg.n_vars), generator=gen,
                                      device=DEVICE)}
    gc_batch["edges"] = D.partition_edges_by_dst(gnn_pairs(fg.n_nodes, fg.n_edges // 2, rng),
                                                 fg.n_nodes, S)[0]
    mols = gnn_molecules(mol_shape, rng)
    mc_batch = {"z": mols["z"], "pos": mols["pos"],
                "edges": D.partition_edges_by_dst(mols["real_edges"], len(mols["z"]), S)[0],
                "target": np.array([mols["target"].sum()], np.float32)}
    for arch, cfg, batch, kw in (("graphcast", gc_cfg, gc_batch, {}),
                                 ("mace", mc_cfg, mc_batch, {"n_species": GNN_SPECIES})):
        model = gnn_init(arch, cfg, gen, **kw)
        builder = D._BUILDERS[cfg.family]
        with torch.no_grad():
            l32 = float(builder(model, cfg, mesh)(model, batch))
            l32_again = float(builder(model, cfg, mesh)(model, batch))
            with MatmulDtypes() as mm:
                l16 = float(builder(model, cfg, mesh, compute_dtype=torch.bfloat16)(model, batch))
        operands = sorted({str(d) for pair in mm.seen for d in pair})
        if not mm.seen or operands != ["torch.bfloat16"]:
            raise AssertionError(f"[gnn] (g3) {cfg.name}: the bf16 loss ran {len(mm.seen)} "
                                 f"matrix products on operands {operands}")
        if arch == "graphcast":
            err, what = abs(l16 - l32) / abs(l32), "of the f32 loss"
            noise = abs(l32_again - l32) / abs(l32)
        else:
            from repro_torch.models.gnn import mace

            with torch.no_grad():
                sites = mace.forward_energy(
                    model, cfg, torch.as_tensor(mols["z"], device=DEVICE),
                    torch.as_tensor(mols["pos"], device=DEVICE),
                    torch.as_tensor(mols["edges"], device=DEVICE),
                    graph_ids=torch.arange(len(mols["z"]), device=DEVICE),
                    n_graphs=len(mols["z"]))
            scale = float(sites.abs().sum())
            err, what = abs(math.sqrt(l16) - math.sqrt(l32)) / scale, \
                f"of Σ|site energy| ({scale!r})"
            noise = abs(math.sqrt(l32_again) - math.sqrt(l32)) / scale
        floor = max(GNN_BF16_FLOOR[arch], GNN_BF16_NOISE * noise)
        log(f"  (g3) {cfg.name} on {S} stages, compute_dtype bf16: loss {l16!r} against f32 "
            f"{l32!r}: {err:.3e} {what} (<= {GNN_BF16_REL[arch]:g}, >= {floor:.3e}: "
            f"{GNN_BF16_FLOOR[arch]:g} and {GNN_BF16_NOISE} x the {noise:.3e} between two f32 "
            f"runs); {len(mm.seen)} matrix products, every one on bf16 operands")
        if not (math.isfinite(l16) and floor <= err <= GNN_BF16_REL[arch]):
            raise AssertionError(f"[gnn] (g3) {cfg.name}: bf16 {l16} against f32 {l32}: "
                                 f"{err} outside [{floor}, {GNN_BF16_REL[arch]}]")
        held = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        step = D.make_distributed_gnn_train_step(cfg, mesh, compute_dtype=torch.bfloat16)
        losses, walls = timed_steps(f"(g3) {cfg.name} bf16, {S} stages", step, model,
                                    opt.init_state(model), [batch] * 2, sync)
        if not all(p.dtype == torch.float32 for p in model.parameters()):
            raise AssertionError(f"[gnn] (g3) {cfg.name}: a bf16 step changed a weight's dtype")
        out["g3"][arch] = {"f32_loss": l32, "f32_noise": noise, "bf16_loss": l16, "err": err,
                           "bf16_matmuls": len(mm.seen), "losses": losses,
                           "walls_ms": walls, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "held_gb": held}
        log(f"  (g3) {cfg.name}: peak allocated {out['g3'][arch]['peak_gb']:.2f} GB "
            f"({held:.2f} GB held before the steps)")
        del model, step
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# [data-model mesh]: the ("data", "model") mesh on one card
# --------------------------------------------------------------------------
def dm_mesh(data: int, model: int, device=None):
    from repro_torch.launch import make_local_mesh

    return make_local_mesh(data=data, model=model, devices=[device or DEVICE] * (data * model))


def dm_smoke(sync) -> dict:
    """(a): yi_6b's and deepseek_v2_lite_16b's smoke configs on each of
    DM_SMOKE_MESHES: one ``make_lm_train_step(mesh=, seq_parallel=True,
    grad_specs=)`` step and one ``make_lm_prefill(mesh=, seq_parallel=True)``
    on the card against the CPU port's same call on the same weights; Yi's
    also against the card's plain step (the mesh changes nothing on a dense
    model)."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.convert import lm_param_shapes
    from repro_torch.data.pipeline import LMTokenPipeline
    from repro_torch.launch import lm_param_specs
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps

    out = {}
    for arch in ("yi_6b", "deepseek_v2_lite_16b"):
        small = get_smoke(arch)
        base = tf.init_params(torch.Generator(device=DEVICE).manual_seed(21), small,
                              device=DEVICE)
        weights = {k: v.cpu() for k, v in base.state_dict().items()}
        batch = LMTokenPipeline(small, *DM_SMOKE_BATCH, seed=9).batch_at(0)

        def copy(device):
            m = tf.Transformer(small, device=device)
            m.load_state_dict(weights)
            return m

        def one_step(device, mesh, hints=True):
            m = copy(device)
            kw = dict(seq_parallel=True, grad_specs=lm_param_specs(
                lm_param_shapes(m, small), mesh)) if (hints and mesh is not None) else {}
            state = opt.init_state(m)
            step = steps.make_lm_train_step(small, chunk_q=16, mesh=mesh, **kw)
            _, state, met = step(m, state, batch)
            return float(met["loss"]), m, state

        for shape in DM_SMOKE_MESHES:
            label = f"{small.name} on a {shape} mesh"
            md, mc = dm_mesh(*shape), dm_mesh(*shape, device="cpu")
            l_dev, m_dev, s_dev = one_step(DEVICE, md)
            l_cpu, m_cpu, s_cpu = one_step("cpu", mc)
            loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
            p_rel = leaf_rel(dict(m_dev.named_parameters()), dict(m_cpu.named_parameters()))
            m_rel = max(leaf_rel(s_dev[k], s_cpu[k]) for k in ("m", "v"))
            prefill = {d: steps.make_lm_prefill(small, DM_SMOKE_BATCH[1] + 4, chunk_q=16,
                                                mesh=mesh, seq_parallel=True)
                       (copy(d), batch["tokens"])[0].cpu()
                       for d, mesh in ((DEVICE, md), ("cpu", mc))}
            logit_rel = float((prefill[DEVICE] - prefill["cpu"]).abs().max()
                              / prefill["cpu"].abs().max())
            sync()
            log(f"  (a) {label}, card vs CPU port: loss {l_dev!r} / {l_cpu!r} (rel "
                f"{loss_rel:.3e} <= {DM_LOSS_REL:g}), parameter leaf rel {p_rel:.3e}, moment "
                f"leaf rel {m_rel:.3e} (<= {TRAIN_REL:g}); prefill logits {logit_rel:.3e} of "
                f"the largest (<= {DM_LOGIT_REL:g})")
            if not (loss_rel <= DM_LOSS_REL and p_rel <= TRAIN_REL and m_rel <= TRAIN_REL
                    and logit_rel <= DM_LOGIT_REL):
                raise AssertionError(f"[data-model mesh] (a) {label}: the card and the CPU "
                                     f"port part: loss {loss_rel}, parameters {p_rel}, moments "
                                     f"{m_rel}, logits {logit_rel}")
            row = {"loss": [l_dev, l_cpu], "loss_rel": loss_rel, "param_rel": p_rel,
                   "moment_rel": m_rel, "logit_rel": logit_rel}
            if small.moe is None:  # a dense model: the mesh and the plain step agree
                l_plain, m_plain, _ = one_step(DEVICE, None)
                plain_rel = max(abs(l_dev - l_plain) / abs(l_plain),
                                leaf_rel(dict(m_dev.named_parameters()),
                                         dict(m_plain.named_parameters())))
                log(f"  (a) {label}: the card's mesh step against its plain step {plain_rel:.3e}")
                if not plain_rel <= DM_LOSS_REL:
                    raise AssertionError(f"[data-model mesh] (a) {label}: the mesh step parts "
                                         f"from the plain step by {plain_rel}")
                row["plain_rel"] = plain_rel
            out[f"{arch} {shape}"] = row
    return out


def dm_row_routing(p, cfg, x, n_rows: int):
    """top_i as the EP routes x: each data row on its own (a (T, k) tensor)."""
    import torch

    from repro_torch.models import moe

    with torch.no_grad():
        return torch.cat([moe.route(p, cfg, r)[2] for r in x.chunk(n_rows)])


def dm_rows_agree(label: str, got, want, route_got, route_want, n_rows: int,
                  rel: float) -> dict:
    """``got`` against ``want`` (T, D) data row by data row, within ``rel`` of
    the largest |want|; a row whose routing (top-k ids, in order) the two
    computations picked differently is left out (and counted): one flipped
    slot moves its token's output and, past capacity, the positions of the
    row's later slots. At least one row must be compared."""
    import torch

    got, want = got.float().cpu(), want.float().cpu()
    same = [torch.equal(a, b) for a, b in zip(route_got.cpu().chunk(n_rows),
                                              route_want.cpu().chunk(n_rows))]
    kept = [r for r, ok in enumerate(same) if ok]
    scale = float(want.abs().max())
    err = max((float((g - w).abs().max()) for r, (g, w) in
               enumerate(zip(got.chunk(n_rows), want.chunk(n_rows))) if r in kept),
              default=float("nan")) / scale
    log(f"  {label}: {len(kept)} of {n_rows} data rows routed alike, max |diff| {err:.3e} of "
        f"the largest output (<= {rel:g})")
    if not kept or not err <= rel:
        raise AssertionError(f"[data-model mesh] {label}: {err} > {rel} over rows {kept}")
    return {"rows_compared": len(kept), "rows": n_rows, "rel": err}


def dm_moe_layer(sync) -> dict:
    """(b): one DeepSeek-V2-Lite MoE layer at full width (64 experts, D
    2,048, F 1,408, top-6, 2 shared) on DM_TOKENS tokens on a DM_MESH mesh,
    in f32 and in bf16: at the default capacity against the CPU port's
    ``moe_apply_ep`` (the dropped share printed), at capacity E/k (nothing
    can drop) against the card's ``moe_apply``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("deepseek_v2_lite_16b")
    e, k = cfg.moe.n_routed, cfg.moe.top_k
    gen = torch.Generator(device=DEVICE).manual_seed(22)
    p32 = moe.moe_init(gen, cfg, device=DEVICE)
    x32 = torch.randn(DM_TOKENS, cfg.d_model, generator=gen, device=DEVICE)
    md, mc = dm_mesh(*DM_MESH), dm_mesh(*DM_MESH, device="cpu")
    rows = DM_MESH[0]
    out = {}
    for dtype in ("float32", "bfloat16"):
        wdt = getattr(torch, dtype)
        p = moe.MoE(cfg, wdt, device=DEVICE)
        p.load_state_dict(p32.state_dict())
        x = x32.to(wdt)
        res = {}
        with torch.no_grad():
            for label, cf in (("default", 1.25), ("E/k", e / k)):
                moe.moe_apply_ep(p, cfg, x, mesh=md, capacity_factor=cf)  # warm-up
                sync()
                t0 = time.perf_counter()
                y, aux = moe.moe_apply_ep(p, cfg, x, mesh=md, capacity_factor=cf)
                sync()
                wall = (time.perf_counter() - t0) * 1e3
                dropped = moe.ep_dropped(p, cfg, x, mesh=md, capacity_factor=cf)
                cap = moe.ep_capacity(DM_TOKENS // rows, cfg, cf)
                if not bool(torch.isfinite(y).all()):
                    raise AssertionError(f"[data-model mesh] (b) {dtype} {label}: not finite")
                log(f"  (b) {dtype}, capacity factor {cf:g} (cap {cap} a row and expert): EP "
                    f"wall {wall:.3f} ms, aux {float(aux)!r}, dropped share {dropped!r}")
                row = {"capacity_factor": cf, "cap": cap, "ep_ms": wall, "dropped": dropped,
                       "aux": float(aux)}
                if label == "default":
                    n = DM_CPU_TOKENS[dtype]
                    pc = moe.MoE(cfg, wdt, device="cpu")
                    pc.load_state_dict({a: b.cpu() for a, b in p.state_dict().items()})
                    xc = x[:n].cpu()
                    t0 = time.perf_counter()
                    want, _ = moe.moe_apply_ep(pc, cfg, xc, mesh=mc, capacity_factor=cf)
                    host_s = time.perf_counter() - t0
                    got, _ = moe.moe_apply_ep(p, cfg, x[:n], mesh=md, capacity_factor=cf)
                    row["cpu"] = dm_rows_agree(
                        f"(b) {dtype} EP on {n} tokens, card vs CPU port ({host_s:.1f} s on "
                        "the host)", got, want, dm_row_routing(p, cfg, x[:n], rows),
                        dm_row_routing(pc, cfg, xc, rows), rows, DM_EP_REL[dtype])
                    row["cpu"]["host_s"] = host_s
                    del pc
                else:
                    if dropped:
                        raise AssertionError(f"[data-model mesh] (b) {dtype}: {dropped} of the "
                                             "slots dropped at capacity E/k")
                    moe.moe_apply(p, cfg, x)  # warm-up
                    sync()
                    t0 = time.perf_counter()
                    want, _ = moe.moe_apply(p, cfg, x)
                    sync()
                    row["moe_apply_ms"] = (time.perf_counter() - t0) * 1e3
                    row["plain"] = dm_rows_agree(
                        f"(b) {dtype} EP at capacity E/k against moe_apply on the card "
                        f"({row['moe_apply_ms']:.3f} ms)", y, want,
                        dm_row_routing(p, cfg, x, rows), moe.route(p, cfg, x)[2], rows,
                        DM_EP_REL[dtype])
                res[label] = row
        out[dtype] = res
        del p
    return out


def dm_prefill_full(sync) -> dict:
    """(c): DeepSeek-V2-Lite bf16 at full width and depth, nothing else
    held: ``make_lm_prefill(mesh=DM_MESH, seq_parallel=True)`` on
    DM_PREFILL tokens beside the single-device prefill on the same model
    and tokens (walls after a warm-up of each, peaks), and each MoE layer's
    dropped share in the mesh prefill."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.train import steps

    cfg = get_config("deepseek_v2_lite_16b")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 1e9
    model = tf.init_params(torch.Generator(device=DEVICE).manual_seed(23), cfg, torch.bfloat16,
                           device=DEVICE)
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    b, s = DM_PREFILL
    tokens = torch.from_numpy(np.random.default_rng(24).integers(1, cfg.vocab, (b, s)))
    mesh = dm_mesh(*DM_MESH)
    runs = {"single": steps.make_lm_prefill(cfg, s, chunk_q=1024),
            "mesh": steps.make_lm_prefill(cfg, s, chunk_q=1024, mesh=mesh, seq_parallel=True)}
    out, logits = {"weights_gb": n_bytes / 1e9, "held_gb": held}, {}
    drops = []
    ep = tf.moe_apply_ep

    def recording(p, c, x, **kw):  # the share each MoE layer drops, read before it runs
        drops.append(moe.ep_dropped(p, c, x, **kw))
        return ep(p, c, x, **kw)

    for label, run in runs.items():
        run(model, tokens)  # warm-up
        sync()
        torch.cuda.reset_peak_memory_stats()
        tf.moe_apply_ep = recording
        try:
            drops.clear()
            t0 = time.perf_counter()
            logits[label], cache = run(model, tokens)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            tf.moe_apply_ep = ep
        del cache
        peak = torch.cuda.max_memory_allocated() / 1e9
        finite = bool(torch.isfinite(logits[label]).all())
        out[label] = {"wall_ms": wall, "peak_gb": peak, "finite": finite}
        log(f"  (c) {cfg.name} bf16 ({n_bytes / 1e9:.2f} GB of weights), {label} prefill of "
            f"{b} x {s} tokens: wall {wall:.3f} ms (the drop counting's syncs included on the "
            f"mesh), peak allocated {peak:.2f} GB, logits finite {finite}")
        if not finite:
            raise AssertionError(f"[data-model mesh] (c) the {label} prefill's logits")
    # the mesh prefill again without counting drops: its wall alone
    sync()
    t0 = time.perf_counter()
    runs["mesh"](model, tokens)
    sync()
    out["mesh"]["wall_uncounted_ms"] = (time.perf_counter() - t0) * 1e3
    out["mesh"]["dropped_by_layer"] = list(drops)
    dist = float((logits["mesh"] - logits["single"]).abs().max()
                 / logits["single"].abs().max())
    out["mesh_vs_single_rel"] = dist
    log(f"  (c) mesh prefill wall without the drop counting {out['mesh']['wall_uncounted_ms']:.3f}"
        f" ms; dropped share by MoE layer (cap {moe.ep_capacity(b * s // DM_MESH[0], cfg, 1.25)}"
        f" a row and expert): {[round(d, 5) for d in drops]}; mesh logits part from the "
        f"single-device ones by {dist:.3e} of the largest (the drops)")
    if len(drops) != cfg.n_layers - cfg.moe.n_dense_layers:
        raise AssertionError(f"[data-model mesh] (c) {len(drops)} MoE layers ran on the mesh")
    del model, logits
    torch.cuda.empty_cache()
    return out


def dm_train(sync) -> dict:
    """(d): DeepSeek-V2-Lite at full width cut to TRAIN_DS_LAYERS layers,
    f32, ``make_lm_train_step(mesh=DM_MESH, seq_parallel=True,
    grad_specs=lm_param_specs(...))``: the first step's loss on a
    DM_TRAIN_CHECK batch against the CPU port's same step on the same
    weights, then DM_TRAIN_STEPS timed steps of TRAIN_BATCH x TRAIN_SEQ."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_param_shapes
    from repro_torch.data.pipeline import LMTokenPipeline
    from repro_torch.launch import lm_param_specs
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps

    cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b"), n_layers=TRAIN_DS_LAYERS)
    model = tf.init_params(torch.Generator(device=DEVICE).manual_seed(25), cfg, device=DEVICE)
    md, mc = dm_mesh(*DM_MESH), dm_mesh(*DM_MESH, device="cpu")
    specs = lm_param_specs(lm_param_shapes(model, cfg), md)
    check = LMTokenPipeline(cfg, *DM_TRAIN_CHECK, seed=2).batch_at(0)
    cpu = tf.Transformer(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    first = {}
    for label, m, mesh in (("card", model, md), ("cpu", cpu, mc)):
        step = steps.make_lm_train_step(cfg, remat=True, ce_chunk=TRAIN_CE_CHUNK, mesh=mesh,
                                        seq_parallel=True, grad_specs=specs)
        t0 = time.perf_counter()
        _, _, met = step(m, opt.init_state(m), check)
        first[label] = (float(met["loss"]), (time.perf_counter() - t0) * 1e3)
    del cpu
    rel = abs(first["card"][0] - first["cpu"][0]) / abs(first["cpu"][0])
    log(f"  (d) {cfg.name} x{TRAIN_DS_LAYERS} f32 on a {DM_MESH} mesh, first step on "
        f"{DM_TRAIN_CHECK}: loss card {first['card'][0]!r} / CPU port {first['cpu'][0]!r} "
        f"(rel {rel:.3e} <= {TRAIN_REL:g}; the CPU step took {first['cpu'][1]:.0f} ms)")
    if not rel <= TRAIN_REL:
        raise AssertionError(f"[data-model mesh] (d) first loss {rel} > {TRAIN_REL}")
    model = tf.init_params(torch.Generator(device=DEVICE).manual_seed(25), cfg, device=DEVICE)
    pipe = LMTokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=1)
    state = opt.init_state(model)
    step = steps.make_lm_train_step(cfg, remat=True, ce_chunk=TRAIN_CE_CHUNK, mesh=md,
                                    seq_parallel=True, grad_specs=specs)
    torch.cuda.reset_peak_memory_stats()
    losses, walls = timed_steps(f"(d) {cfg.name} x{TRAIN_DS_LAYERS} on a {DM_MESH} mesh", step,
                                model, state, [pipe.batch_at(i) for i in range(DM_TRAIN_STEPS)],
                                sync)
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = sorted(walls[1:])[len(walls[1:]) // 2]
    log(f"  (d) step walls {walls} ms: {tokens / med * 1e3:.1f} tokens/s at the median of "
        f"steps 2-{DM_TRAIN_STEPS}, peak allocated {peak:.2f} GB (beside [train] (c)'s "
        "single-device steps)")
    del model, state, step
    torch.cuda.empty_cache()
    return {"first_loss": first, "first_rel": rel, "losses": losses, "walls_ms": walls,
            "tokens_per_s": tokens / med * 1e3, "peak_gb": peak}


def dm_mesh_phase() -> dict:
    """[data-model mesh], as the module docstring says: (a) the smoke
    configs against the CPU port, (b) one full-width MoE layer, (c) the
    bf16 model's mesh prefill at full depth, (d) the 2-layer f32 mesh
    train step."""
    import torch

    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    out = {}
    for key, run in (("a", dm_smoke), ("b", dm_moe_layer), ("c", dm_prefill_full),
                     ("d", dm_train)):
        t0 = time.perf_counter()
        out[key] = run(sync)
        log(f"  ({key}) done in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# [dryrun]: the dry run on the production mesh, and its cells on the card
# --------------------------------------------------------------------------
def dryrun_sweep() -> dict:
    """(a): DRY_CELLS through ``launch.dryrun.run_cell`` on the (16, 16)
    mesh of meta coordinates: each must come back ``ok``; its GiB a device,
    dominant term and three terms at the H100's rates beside ``analytic``."""
    from repro_torch.configs.shapes import shapes_for
    from repro_torch.launch import dryrun

    out = {}
    for arch, name in DRY_CELLS:
        shape = next(s for s in shapes_for(arch) if s.name == name)
        rec = dryrun.run_cell(arch, shape, out_dir=os.path.join(HERE, "results", "dryrun"),
                              verbose=False)
        if not rec["ok"]:
            raise AssertionError(f"[dryrun] (a) {arch} x {name}: {rec['error']}\n"
                                 f"{rec['traceback']}")
        rl, ana, mem = rec["roofline"], rec["analytic"], rec["memory"]
        log(f"  (a) {arch} x {name} x pod_16x16: {mem['peak_bytes_per_device'] / 2**30:.2f} "
            f"GiB/device, dominant {rl['dominant']}: compute {rl['compute_s']:.4e} s, memory "
            f"{rl['memory_s']:.4e} s, collective {rl['collective_s']:.4e} s; analytic compute "
            f"{ana['compute_s']:.4e} s, memory {ana['memory_s']:.4e} s (counted FLOPs / analytic "
            f"{rl['global_flops'] / ana['flops']:.4f}); built {rec['build_s']} s, counted "
            f"{rec['count_s']} s")
        out[f"{arch}/{name}"] = {k: rec[k] for k in ("memory", "roofline", "analytic", "counted",
                                                     "build_s", "count_s", "wall_s")}
    return out


def dryrun_triangle(sync) -> dict:
    """(b): the triangle cell at dense_64k realised on the card: U drawn
    from DRY_SEED in row chunks, the ring of DRY_RING_STAGES stages of one
    card through ``DynamicPipeline`` (S² K2 launches), the stage chain
    (``run_sequential``, S² more) and K1's ``triangle_count`` of the same U
    (one launch), all three equal as int64 and to cuBLAS's count of the same
    U (``_int_mm`` over row chunks, the mask, an int64 sum: no code of K1 or
    K2); the ring's densest visit on K2 against its plain version; the wall
    beside the dry run's roofline for the same cell and mesh and K2's int8
    bound. Returns the comparison's launch in ``compare_launches``."""
    import torch

    from repro_torch.configs.shapes import shapes_for
    from repro_torch.core.dynamic_pipeline import run_sequential
    from repro_torch.core.triangle_pipeline import dense_ring_spec
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.triangle_count.ops import masked_matmul_sum, triangle_count
    from repro_torch.kernels.triangle_count.ref import masked_matmul_sum_ref
    from repro_torch.launch import analytic, dryrun, hlo_analysis, make_ring_mesh

    shape = next(s for s in shapes_for("triangle") if s.name == "dense_64k")
    s_n = DRY_RING_STAGES
    gen = torch.Generator(device=DEVICE).manual_seed(DRY_SEED)
    t0 = time.perf_counter()
    cell = dryrun.triangle_cell("triangle", shape, make_ring_mesh(s_n, devices=[DEVICE] * s_n),
                                generator=gen)
    sync()
    draw_s = time.perf_counter() - t0
    blocks = cell.args[0]
    rows, n_pad = blocks.shape[1], blocks.shape[2]
    k0 = launch_counts()
    t0 = time.perf_counter()
    ring = int(cell.run())
    sync()
    ring_ms = (time.perf_counter() - t0) * 1e3
    k1 = launch_counts()
    t0 = time.perf_counter()
    chain = int(run_sequential(dense_ring_spec(rows), blocks, blocks, s_n))
    sync()
    chain_ms = (time.perf_counter() - t0) * 1e3
    k2 = launch_counts()
    t0 = time.perf_counter()
    live = int(triangle_count(blocks.reshape(n_pad, n_pad)))
    sync()
    k1_ms = (time.perf_counter() - t0) * 1e3
    k3 = launch_counts()
    want = {"masked_matmul_sum": s_n * s_n}
    for label, a, b, need in (("ring", k0, k1, want), ("chain", k1, k2, want),
                              ("K1", k2, k3, {"triangle_count_live": 1})):
        got = {n: b[n] - a[n] for n in b if b[n] != a[n]}
        if got != need:
            raise AssertionError(f"[dryrun] (b) the {label} launched {got}, want {need}")
    log(f"  (b) dense_64k (n {shape.n_nodes:,}, density {shape.density}) on a one-card ring of "
        f"{s_n} stages, uint8 blocks {tuple(blocks.shape)} ({blocks.numel() / 1e9:.2f} GB, drawn "
        f"in {draw_s:.2f} s): ring {ring:,} ({ring_ms:.1f} ms, {s_n * s_n} K2), chain "
        f"{chain:,} ({chain_ms:.1f} ms, {s_n * s_n} K2), K1 {live:,} ({k1_ms:.1f} ms, 1 launch)")
    # cuBLAS's int8 product of the same U, a row chunk at a time: Σ (U·U) ⊙ U
    t0 = time.perf_counter()
    u = blocks.reshape(n_pad, n_pad)
    cublas = 0
    for r0 in range(0, n_pad, DRY_CHECK_ROWS):
        part = torch._int_mm(u[r0:r0 + DRY_CHECK_ROWS].view(torch.int8), u.view(torch.int8))
        cublas += int(part.mul_(u[r0:r0 + DRY_CHECK_ROWS]).sum(dtype=torch.int64))
        del part
    cublas_ms = (time.perf_counter() - t0) * 1e3
    log(f"  (b) cuBLAS's count of the same U (_int_mm over {DRY_CHECK_ROWS:,}-row chunks, "
        f"masked, summed in int64): {cublas:,} ({cublas_ms:.1f} ms)")
    if not ring == chain == live == cublas:
        raise AssertionError(f"[dryrun] (b) counts differ: ring {ring}, chain {chain}, K1 {live}, "
                             f"cuBLAS {cublas}")
    if ring <= 2**31:
        raise AssertionError(f"[dryrun] (b) {ring} triangles: dense_64k should pass 2^31")
    # the densest visit (stage 0 visited by stage 1's block) on K2 against its
    # plain version: one launch whose own sum passes 2^31
    visit = (blocks[0][:, rows:2 * rows], blocks[1], blocks[0])
    k4 = launch_counts()
    got = int(masked_matmul_sum(*visit))
    compare = {n: v - k4[n] for n, v in launch_counts().items() if v != k4[n]}
    plain = int(masked_matmul_sum_ref(*visit))
    log(f"  (b) the densest visit, ({rows:,}x{rows:,})·({rows:,}x{n_pad:,}) ⊙ ({rows:,}x{n_pad:,}): "
        f"K2 {got:,}, plain version {plain:,} (max abs err {abs(got - plain)})")
    if got != plain or compare != {"masked_matmul_sum": 1}:
        raise AssertionError(f"[dryrun] (b) the densest visit: K2 {got} ({compare}), plain {plain}")
    if got <= 2**31:
        raise AssertionError(f"[dryrun] (b) the densest visit's {got} should pass 2^31")
    # the dry run of the same cell on the same mesh shape, on meta
    meta = dryrun.triangle_cell("triangle", shape, make_ring_mesh(s_n, devices=["meta"] * s_n))
    counts = dryrun.count_cell(meta)
    rl = hlo_analysis.roofline_from_counts(
        counts.flops * meta.scale, counts.bytes_accessed * meta.scale,
        hlo_analysis.collective_stats(meta.collectives), s_n,
        hlo_analysis.peak_ops(meta.ops_dtype))
    ana = analytic.analytic_cell("triangle", "dense_64k")
    int8_s = rl.global_flops / hlo_analysis.PEAK_INT8_OPS
    log(f"  (b) the dry run of the cell on {s_n} stages: {rl.global_flops:.4e} operations "
        f"(analytic {ana['flops']:.4e}), {rl.global_bytes_accessed:.4e} bytes; per stage compute "
        f"{rl.compute_s:.4e} s (int8 peak), memory {rl.memory_s:.4e} s, collective "
        f"{rl.collective_s:.4e} s; on one card the {s_n} stages add up: int8 bound "
        f"{int8_s:.4f} s at {hlo_analysis.PEAK_INT8_OPS / 1e12:.0f} TOPS, memory "
        f"{rl.global_bytes_accessed / hlo_analysis.HBM_BW:.4f} s; the ring's wall "
        f"{ring_ms / 1e3:.4f} s is {ring_ms / 1e3 / int8_s:.2f}x the int8 bound")
    del cell, blocks, u, visit
    return {"count": ring, "ring_ms": ring_ms, "chain_ms": chain_ms, "k1_ms": k1_ms,
            "cublas_count": cublas, "cublas_ms": cublas_ms, "densest_visit": got,
            "compare_launches": compare, "draw_s": draw_s, "ops": rl.global_flops,
            "analytic_ops": ana["flops"], "int8_bound_s": int8_s, "roofline": rl.as_dict()}


def _card_bytes(tree) -> int:
    from repro_torch.utils import bytes_of, tree_leaves

    return sum(bytes_of(dict(x.named_parameters())) if hasattr(x, "named_parameters")
               else bytes_of(x) for x in tree_leaves(tree))


def dryrun_lm(sync) -> dict:
    """(c): two LM cells built by ``launch.dryrun.lm_cell`` on the card and
    on meta, each counted by ``dryrun.count_cell``: the card's FLOPs must
    equal the meta count; on the (1, 1) mesh the arguments on the card
    (parameters, AdamW state, batch) must equal the dry run's argument
    bytes; the peak allocated beside the predicted peak."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import LMShape
    from repro_torch.launch import dryrun

    b, s = DRY_LM_TOKENS
    yi = dataclasses.replace(get_config("yi_6b"), n_layers=TRAIN_YI_LAYERS)
    cases = (("deepseek_v2_lite_16b", LMShape("prefill_4x1024", s, b, "prefill"), DM_MESH,
              torch.bfloat16, None),
             ("yi_6b", LMShape("train_4x1024", s, b, "train"), (1, 1), torch.float32, yi))
    out = {}
    for arch, shape, (data, model), dtype, cfg in cases:
        label = f"{arch}{'' if cfg is None else f' x{cfg.n_layers}'} {shape.kind}"
        meta = dryrun.lm_cell(arch, shape, dm_mesh(data, model, "meta"), dtype=dtype, cfg=cfg)
        want = dryrun.count_cell(meta)
        del meta
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        card = dryrun.lm_cell(arch, shape, dm_mesh(data, model), dtype=dtype, cfg=cfg,
                              generator=torch.Generator(device=DEVICE).manual_seed(DRY_SEED))
        sync()
        args_on_card = _card_bytes(card.args)
        torch.cuda.reset_peak_memory_stats()
        got = dryrun.count_cell(card)
        sync()
        peak = torch.cuda.max_memory_allocated() - held
        coords = data * model
        temp = want.peak_live_bytes // card.spread
        predicted = (card.argument_bytes + card.output_bytes + temp - card.alias_bytes) * coords
        log(f"  (c) {label} ({dtype}) on a one-card ({data}, {model}) mesh: FLOPs card "
            f"{got.flops:,} / meta {want.flops:,}; bytes accessed card {got.bytes_accessed:.4e} / "
            f"meta {want.bytes_accessed:.4e}; arguments on the card {args_on_card:,} B, the dry "
            f"run's {card.argument_bytes:,} B a coordinate x {coords}; peak allocated "
            f"{peak / 1e9:.2f} GB against the predicted {predicted / 1e9:.2f} GB "
            f"({coords} coordinates' peaks; ratio {peak / predicted:.3f}); counted on the card "
            f"in {got.seconds:.1f} s, on meta in {want.seconds:.1f} s")
        if got.flops != want.flops:
            raise AssertionError(f"[dryrun] (c) {label}: the card's FLOPs {got.flops} are not "
                                 f"the meta count {want.flops}")
        if coords == 1 and args_on_card != card.argument_bytes:
            raise AssertionError(f"[dryrun] (c) {label}: {args_on_card} argument bytes on the "
                                 f"card, the dry run predicts {card.argument_bytes}")
        out[label] = {"flops": got.flops, "meta_flops": want.flops,
                      "bytes_accessed": got.bytes_accessed,
                      "meta_bytes_accessed": want.bytes_accessed,
                      "argument_bytes_card": args_on_card,
                      "argument_bytes_per_coordinate": card.argument_bytes,
                      "peak_gb": peak / 1e9, "predicted_peak_gb": predicted / 1e9,
                      "count_s": got.seconds, "meta_count_s": want.seconds}
        del card
        torch.cuda.empty_cache()
    return out


def dryrun_phase() -> dict:
    """[dryrun], as the module docstring says, in its own launch window: (a)
    the sweep's cells on the meta production mesh, (b) the triangle cell
    realised at dense_64k, (c) two LM cells realised, their FLOPs held to
    the meta counts. The window must see S² K2 launches for the ring and S²
    for the chain, one K1 launch, and nothing else."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    log(f"[dryrun] the dry run on the production mesh (launch.dryrun): {len(DRY_CELLS)} cells "
        f"on the meta (16, 16) mesh; the triangle cell at dense_64k on a one-card ring of "
        f"{DRY_RING_STAGES} stages against the chain and K1; DeepSeek-V2-Lite's bf16 prefill on "
        f"{DM_MESH} and Yi-6B x{TRAIN_YI_LAYERS}'s f32 train step on (1, 1), counted on the card "
        "and on meta")
    torch.cuda.empty_cache()
    reset_launch_counts()
    out = {}
    for key, run in (("a", lambda _: dryrun_sweep()), ("b", dryrun_triangle),
                     ("c", dryrun_lm)):
        t0 = time.perf_counter()
        out[key] = run(sync)
        log(f"  ({key}) done in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    sync()
    compare = out["b"]["compare_launches"]  # K2 against its plain version: not the path's
    launched = {name: k - compare.get(name, 0) for name, k in launch_counts().items()
                if k - compare.get(name, 0)}
    want = {"masked_matmul_sum": 2 * DRY_RING_STAGES**2, "triangle_count_live": 1}
    log(f"[dryrun] kernel launches in this window: {launched} (want {want}), besides "
        f"{compare} comparing K2 with its plain version")
    if launched != want:
        raise AssertionError(f"[dryrun] launched {launched}, want {want}")
    out["launches"] = launched
    log(f"[dryrun] done in {time.perf_counter() - t_phase:.1f} s")
    return out


def examples_phase() -> dict:
    """[examples]: each ``examples/torch_*.py`` on the card (EXAMPLES' small
    arguments), every one in its own process, all at once, each within
    EXAMPLE_TIMEOUT_S; each must exit 0 (each asserts its own counts)."""
    import shutil

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    procs = []
    t0 = time.perf_counter()
    try:
        for name, *args in EXAMPLES:
            extra = ["--ckpt-dir", ckpt] if name == "torch_train_lm.py" else []
            procs.append((name, subprocess.Popen(
                [sys.executable, os.path.join(HERE, "examples", name), *args, *extra,
                 "--device", DEVICE],
                env=env, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        out, failed = {}, []
        for name, proc in procs:
            try:
                text, _ = proc.communicate(timeout=max(1.0, EXAMPLE_TIMEOUT_S
                                                       - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                proc.kill()
                text, _ = proc.communicate()
                text += f"\n(killed after {EXAMPLE_TIMEOUT_S} s)"
            lines = text.strip().splitlines()
            log(f"  {name} (exit {proc.returncode}): " + " | ".join(lines[-3:]))
            out[name] = {"rc": proc.returncode, "tail": lines[-3:]}
            if proc.returncode != 0:
                failed.append(name)
                for line in lines[-30:]:
                    log(f"    {line}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(ckpt, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    if failed:
        raise AssertionError(f"[examples] failed on the card: {failed}")
    return out


# --------------------------------------------------------------------------
# Phase 9: where the time of one count goes (after the main path's counts)
# --------------------------------------------------------------------------
def profile_phase(graphs: dict) -> None:
    """One planner-chosen count of each of the two largest Table-1 graphs,
    one planner-chosen ``count_stream`` of NY and of YT (the hybrid
    state), and [serve streams] (a)'s interleaved serve, under
    ``torch.profiler``
    after a warm-up run: host wall, device busy time (every kernel, copy
    and fill), the device's idle share of the wall, the peak of allocated
    device memory, and the host and device operations that take the most
    time."""
    import numpy as np
    import torch

    from repro_torch.api import TriangleCounter
    from repro_torch.serve import TriangleServer

    counter = TriangleCounter(device=DEVICE)
    for name in ("FNA.5", "NY"):
        g = graphs[name]
        p = counter.plan_for(g)
        profile_one(f"{name} method={p.method}", lambda: counter.count(g, plan=p),
                    graphs["_served"][name])
    g = graphs["NY"]
    e = g.edges[np.random.default_rng(5).permutation(g.n_edges)]
    blocks = [e[i:i + 50_000] for i in range(0, len(e), 50_000)]
    profile_one("NY count_stream (planner-sized)",
                lambda: counter.count_stream(g.n_nodes, blocks), graphs["_served"]["NY"])
    n, blocks, want = graphs["_yt"]
    profile_one("YT count_stream (planner-chosen hybrid)",
                lambda: counter.count_stream(n, blocks), want)
    server = TriangleServer(device=DEVICE)
    reqs = graphs["_serve_streams"]
    profile_one(f"serve_streams of {len(reqs)} interleaved sessions (sync)",
                lambda: torch.stack([r.count for r in server.serve_streams(reqs)]).sum(),
                sum(graphs["_served"][name] for name in GRAPHS))


def profile_lm(lm: dict, steps: int | None = None) -> dict:
    """One flash prefill of the LM phase's first batch plus ``steps``
    (default ``new_tokens``) decode steps under ``torch.profiler``, after a
    warm-up run: host wall, device busy time, idle share, the largest
    device items, and the device-to-host copies (each MoE layer reads its
    group sizes to the host once a call)."""
    import torch

    from repro_torch.models import transformer as tf

    model, cfg, tokens = lm["model"], lm["cfg"], lm["batch"]
    n = steps or lm["new_tokens"]

    def run():
        logits, cache = tf.prefill(model, cfg, tokens, tokens.shape[1] + n,
                                   cache_dtype=lm["cache_dtype"], use_flash=True)
        tok = logits.argmax(-1, keepdim=True)
        for step in range(n):
            logits, cache = tf.decode_step(model, cfg, cache, tok, tokens.shape[1] + step)
            tok = logits.argmax(-1, keepdim=True)
        return tok.cpu()

    run()
    torch.cuda.synchronize()
    label = (f"{cfg.name} {lm['summary']['dtype']} flash prefill {tuple(tokens.shape)} + {n} "
             "decode steps")
    p = profiled(label, run, need_h2d=False)
    d2h = sum(e.count for e in p["dev_rows"] if "dtoh" in e.key.lower())
    if cfg.moe and d2h != (cfg.n_layers - cfg.moe.n_dense_layers) * (n + 1) + 1:
        raise AssertionError(f"{cfg.name}: {d2h} device-to-host copies in a prefill and {n} "
                             "decode steps, not one a MoE layer a call plus the tokens")
    log(f"  {label}: wall={p['wall_ms']:.3f} ms device_busy={p['busy_ms']:.3f} ms "
        f"device_idle_share={1 - p['busy_ms'] / p['wall_ms']:.4f} d2h_copies={d2h} "
        f"peak_allocated={p['peak']} B {p['check']}")
    top_dev = sorted(p["dev_rows"], key=lambda e: -e.self_device_time_total)[:8]
    log("    device: " + "; ".join(f"{e.key[:90]} {e.self_device_time_total / 1e3:.3f} ms "
                                   f"x{e.count}" for e in top_dev))
    return dict(wall_ms=p["wall_ms"], busy_ms=p["busy_ms"],
                idle_share=1 - p["busy_ms"] / p["wall_ms"], decode_steps=n, d2h_copies=d2h,
                peak_bytes=p["peak"])


def profile_one(label: str, run, want: int) -> None:
    import torch
    from torch.autograd import DeviceType

    run().item()
    torch.cuda.synchronize()
    # every profiled run here is a resident count or a stream over host
    # edge blocks: its operands reach the card by host-to-device copies
    p = profiled(label, lambda: run().item(), need_h2d=True)
    if p["result"] != want:
        raise AssertionError(f"{label}: profiled count {p['result']} != served {want}")
    events, wall_ms, busy_ms = p["events"], p["wall_ms"], p["busy_ms"]
    ops_ms = sum(e.self_cpu_time_total for e in events
                 if e.device_type == DeviceType.CPU) / 1e3
    log(f"  {label}: wall={wall_ms:.3f} ms device_busy={busy_ms:.3f} ms "
        f"device_idle_share={1 - busy_ms / wall_ms:.4f} host_in_torch_ops={ops_ms:.3f} ms "
        f"host_outside_torch_ops={wall_ms - ops_ms:.3f} ms peak_allocated={p['peak']} B "
        f"{p['check']}")
    top_dev = sorted(p["dev_rows"], key=lambda e: -e.self_device_time_total)[:8]
    top_host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:5]
    log("    device: " + "; ".join(f"{e.key[:90]} {e.self_device_time_total / 1e3:.3f} ms "
                                   f"x{e.count}" for e in top_dev))
    log("    host:   " + "; ".join(f"{e.key[:48]} {e.self_cpu_time_total / 1e3:.3f} ms "
                                   f"x{e.count}" for e in top_host))


def profiled(label: str, run, *, need_h2d: bool) -> dict:
    """``run()`` under ``torch.profiler`` (CPU + CUDA), profiled again (up
    to ``PROFILE_TRIES`` in all) until the profile is consistent. Each
    window opens with ``PROFILE_MARKERS`` marker kernels, synchronised
    before the run starts. The profiler drops the first records of a
    session, so a profile is consistent when at least one marker survives
    (no record of the run itself was dropped), the device busy time is
    above 0, there are at least as many CUDA kernel rows (device rows that
    are neither a memcpy nor a memset) as the port's kernels launched in
    the run, and, where ``need_h2d``, a host-to-device memcpy row. Each
    retry is logged with its reason; the last inconsistent profile raises,
    so no idle share is printed from lost device events. Returns the run's
    result, its host wall, the device busy time of the run's rows (device
    rows carry the device time once; a host op's own device time repeats
    that of the kernels it launched), the key averages, those device rows,
    the peak allocated memory and the ``check`` text printed on the
    profile line. The markers are outside the wall and the device rows;
    their launches (a few µs each) are among the host rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import launch_counts

    def is_copy(e):
        return any(w in e.key.lower() for w in ("memcpy", "memset"))

    markers = PROFILE_MARKERS
    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k0 = launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(markers):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        k1 = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        port = sum(k1[name] - k0[name] for name in k1)
        events = prof.key_averages()
        dev_all = [e for e in events if e.device_type == DeviceType.CUDA]
        kept = sum(e.count for e in dev_all if "spin_kernel" in e.key)
        dev_rows = [e for e in dev_all if "spin_kernel" not in e.key]
        busy_ms = sum(e.self_device_time_total for e in dev_rows) / 1e3
        kernel_rows = sum(e.count for e in dev_rows if not is_copy(e))
        h2d = any(is_copy(e) and "htod" in e.key.lower() for e in dev_rows)
        faults = ([] if kept else [f"all {markers} leading markers lost"]) \
            + ([] if busy_ms > 0 else ["device busy 0"]) \
            + ([] if kernel_rows >= port else [f"{kernel_rows} kernel rows < {port} port "
                                               "launches"]) \
            + ([] if h2d or not need_h2d else ["no host-to-device memcpy row"])
        if not faults:
            return dict(result=result, wall_ms=wall_ms, busy_ms=busy_ms, events=events,
                        dev_rows=dev_rows, peak=peak,
                        check=f"device_rows={kernel_rows} port_launches={port} tries={tries} "
                              f"markers_lost={markers - kept}/{markers}")
        log(f"  {label}: inconsistent profile, try {tries} of {PROFILE_TRIES}: "
            f"{'; '.join(faults)} ({markers - kept} of {markers} markers lost; device rows: "
            + ", ".join(f"{e.key[:40]} x{e.count}" for e in dev_rows[:6]) + ")")
        markers *= 4
    raise AssertionError(f"{label}: {PROFILE_TRIES} inconsistent profiles in a row "
                         f"({'; '.join(faults)}): the profiler lost device events")


def probe_k2() -> int:
    """``chip_smoke.py --probe``, first part: K2's first launches, at small shapes and
    at FNA.5's ring-visit shape, against its plain version. The full run
    starts this in a child process under a time limit, so that a kernel
    that never ends is killed with its process instead of holding the card."""
    import torch

    from repro_torch.kernels import _build, launch_counts
    from repro_torch.kernels.triangle_count.ops import masked_matmul_sum
    from repro_torch.kernels.triangle_count.ref import masked_matmul_sum_ref

    for line in _build.build_all(["triangle_count_sm90"], verbose=True)[
            "triangle_count_sm90"].splitlines():
        if any(w in line.lower() for w in ("registers", "spill", "error", "warning")):
            print(f"probe build: {line.strip()}", flush=True)
    gen = torch.Generator(device="cpu").manual_seed(1)
    for (R, K, N) in ((64, 64, 64), (100, 70, 130), (300, 513, 129), (2048, 2048, 8192)):
        a, b, m = ((torch.rand(*s, generator=gen) < 0.4).to(torch.uint8).to(DEVICE)
                   for s in ((R, K), (K, N), (R, N)))
        for up in (False, True):
            got = int(masked_matmul_sum(a, b, m, upper_triangular=up))
            torch.cuda.synchronize()
            want = int(masked_matmul_sum_ref(a, b, m, upper_triangular=up))
            print(f"probe masked_matmul_sum{'(up)' if up else ''} {(R, K, N)}: kernel={got} "
                  f"plain={want} {'match' if got == want else 'MISMATCH'}", flush=True)
            if got != want:
                return 1
    print(f"probe launches: {launch_counts()['masked_matmul_sum']}", flush=True)
    return 0


def probe_k1() -> int:
    """``chip_smoke.py --probe``, second part: K1's first launches (the
    live-grid count on K2's tile, a batch a launch) against its plain
    version: single matrices, views of a padded buffer, a batch of views, a
    batch whose rows break TMA's rule (the copy path), and the whole buffer."""
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.triangle_count.ops import triangle_count
    from repro_torch.kernels.triangle_count.ref import triangle_count_ref

    gen = torch.Generator(device="cpu").manual_seed(3)
    buf = (torch.rand(4, 1024, 1024, generator=gen) < 0.3).to(torch.uint8).to(DEVICE).triu(1)
    cases = [buf[0, :n, :n] for n in (1, 63, 128, 129, 1000)]
    cases += [buf[:, :700, :700], buf[:, :300, :300].contiguous(), buf]
    for u in cases:
        got = triangle_count(u).reshape(-1).tolist()
        torch.cuda.synchronize()
        want = triangle_count_ref(u).reshape(-1).tolist()
        print(f"probe triangle_count_live {tuple(u.shape)} strides {u.stride()}: kernel={got} "
              f"plain={want} {'match' if got == want else 'MISMATCH'}", flush=True)
        if got != want:
            return 1
    print(f"probe launches: {launch_counts()['triangle_count_live']}", flush=True)
    return 0


def probe_k6_tf32x3() -> int:
    """``chip_smoke.py --probe``, third part: the three-pass TF32 K6's
    first launches, at small and ragged shapes, causal and full, against its
    plain version within the reference kernel test's 2e-5."""
    import torch

    from repro_torch.kernels import _build, launch_counts
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    name = "flash_attention_tf32x3_sm90"
    for line in _build.build_all([name], verbose=True)[name].splitlines():
        if any(w in line.lower() for w in ("registers", "spill", "error", "warning")):
            print(f"probe build: {line.strip()}", flush=True)
    gen = torch.Generator(device="cpu").manual_seed(2)
    for (b, hq, hkv, s, d) in ((1, 4, 4, 1, 64), (2, 4, 2, 63, 64), (1, 8, 2, 129, 128),
                               (2, 4, 1, 300, 128), (1, 32, 4, 1024, 128)):
        q, k, v = (torch.randn(b, h, s, d, generator=gen).to(DEVICE) for h in (hq, hkv, hkv))
        for causal in (True, False):
            got = flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err, ok = close(got, attention_ref(q, k, v, causal=causal), 2e-5)
            print(f"probe flash_attention tf32x3 {(b, hq, hkv, s, d)} causal={causal}: max abs "
                  f"err {err:.3e} {'match' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                return 1
    print(f"probe launches: {launch_counts()['flash_attention_tf32x3']}", flush=True)
    return 0


def probe_k6_mla() -> int:
    """``chip_smoke.py --probe``, fourth part: the first launches of both
    tensor-core K6 routes at MLA's head dims (D 192, Dv 128), bf16 on the
    wgmma kernel and f32 on the tf32x3 kernel, at small and ragged shapes,
    causal and full, then at DeepSeek-V2-Lite's prefill shape, against the
    plain version within 3e-2 (bf16) and 2e-5 (f32)."""
    import torch

    from repro_torch.kernels import _build, launch_counts
    from repro_torch.kernels.flash_attention.ops import flash_attention, kernel_route
    from repro_torch.kernels.flash_attention.ref import attention_ref

    name = "flash_attention_sm90"
    for line in _build.build_all([name], verbose=True)[name].splitlines():
        if any(w in line.lower() for w in ("registers", "spill", "error", "warning")):
            print(f"probe build: {line.strip()}", flush=True)
    gen = torch.Generator(device="cpu").manual_seed(4)
    for dtype, tol in ((torch.bfloat16, 3e-2), (torch.float32, 2e-5)):
        for (b, hq, hkv, s) in ((1, 2, 2, 1), (2, 4, 2, 63), (1, 4, 4, 127), (2, 4, 1, 200),
                                (4, 16, 16, 1024)):
            q, k = (torch.randn(b, h, s, 192, generator=gen).to(dtype).to(DEVICE)
                    for h in (hq, hkv))
            v = torch.randn(b, hkv, s, 128, generator=gen).to(dtype).to(DEVICE)
            for causal in (True, False):
                got = flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err, ok = close(got, attention_ref(q, k, v, causal=causal), tol)
                print(f"probe flash_attention {kernel_route(dtype, 192, 128)} "
                      f"{(b, hq, hkv, s, 192, 128)} causal={causal}: max abs err {err:.3e} "
                      f"{'match' if ok else 'MISMATCH'}", flush=True)
                if not ok or got.shape != (b, hq, s, 128):
                    return 1
    counts = launch_counts()
    print(f"probe launches: {counts['flash_attention_wgmma']} wgmma, "
          f"{counts['flash_attention_tf32x3']} tf32x3", flush=True)
    return 0


def slice_phases() -> tuple[dict, dict, dict, dict]:
    """[train], [ring attention], [gnn] and [data-model mesh], each driven
    with the launch counts set to 0 just before it and read just after: no
    such path reaches a hand-written kernel (the reference trains through
    chunked attention and the plain lookup, its ring attention is two
    einsums, its GNNs' message passing is segment sums outside any Pallas
    kernel, and its mesh steps run chunked attention and an EP of einsums
    and segment sums), so every count must stay 0. Then the tf32x3 K6 on
    the ring's inputs, outside the windows, and serving after a train step
    (C1)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.empty_cache()
    results = []
    for label, run in (("train", train_phase), ("ring attention", ring_attention_phase),
                       ("gnn", gnn_phase), ("data-model mesh", dm_mesh_phase)):
        t0 = time.perf_counter()
        log(f"[{label}] " + {
            "train": "the smoke configs on the card against the CPU port; Yi-6B at full "
                     f"width, {TRAIN_YI_LAYERS} layers, f32, {TRAIN_STEPS} steps; "
                     f"DeepSeek-V2-Lite at full width, {TRAIN_DS_LAYERS} layers (its MoE); "
                     "AutoInt at its full table; train_lm's restart and checkpoint",
            "ring attention": f"ring_attention at {RING_ATTN}, f32, causal, sequential and "
                              f"on one-card meshes of {RING_WIDTHS} stages, against "
                              "chunked_attention",
            "gnn": "the GNN smoke configs on the card against the CPU port; GIN, GraphCast, "
                   "DimeNet and MACE at their full configs on GNN_SHAPES' sizes (GIN at "
                   "full_graph_sm, molecule, minibatch_lg through the sampler and "
                   "ogb_products); MACE's invariances; the partitioned engine on one-card "
                   "meshes (GIN at ogb_products on 4 stages)",
            "data-model mesh": f"one-card ('data', 'model') meshes: the smoke configs' mesh "
                               f"train and prefill steps on {DM_SMOKE_MESHES} against the CPU "
                               f"port; a full-width DeepSeek-V2-Lite MoE layer expert-parallel "
                               f"on {DM_MESH} in f32 and bf16; the bf16 model's mesh prefill at "
                               f"full depth; its 2-layer f32 mesh train step"}[label])
        reset_launch_counts()
        results.append(run())
        torch.cuda.synchronize()
        launched = {name: k for name, k in launch_counts().items() if k}
        log(f"[{label}] kernel launches on this path: {launched or 'none'} (it reaches no "
            f"hand-written kernel)")
        if launched:
            raise AssertionError(f"[{label}] launched {launched}: the path should reach no "
                                 "hand-written kernel")
        log(f"[{label}] done in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    train, (ring, qkv), gnn, dm = results
    ring_attention_beside_k6(ring, qkv)
    del qkv
    train["serve_after_train"] = serve_after_train()
    torch.cuda.empty_cache()
    return train, ring, gnn, dm


def main() -> int:
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found — run it from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False) — this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 3
    from repro_torch.graphs import datasets
    from repro_torch.graphs import generators as gen
    from repro_torch.kernels import _build, kernels, launch_counts, reset_launch_counts

    # the plain versions and the chunked attention must run in true f32
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmuls would run in TF32: the plain versions "
                             "need true float32")

    if sys.argv[1:] == ["--probe"]:
        return probe_k2() or probe_k1() or probe_k6_tf32x3() or probe_k6_mla()
    if sys.argv[1:] == ["--train"]:  # [train], [ring attention], [gnn], [data-model mesh]
        log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        _build.build_all(["flash_attention_tf32x3_sm90", "flash_attention", "embedding_bag"],
                         verbose=True)
        train, ring, gnn, dm = slice_phases()
        log("[train summary] " + json.dumps(train))
        log("[ring attention summary] " + json.dumps(ring))
        log("[gnn summary] " + json.dumps(gnn))
        log("[data-model mesh summary] " + json.dumps(dm))
        return 0
    if sys.argv[1:] == ["--dryrun"]:  # [dryrun] alone
        log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        _build.build_all(["triangle_count_sm90"], verbose=True)
        log("[dryrun summary] " + json.dumps(dryrun_phase()))
        return 0
    if sys.argv[1:] == ["--examples"]:  # [examples] alone
        log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        _build.build_all(verbose=True)  # once here, not in six processes at once
        log("[examples summary] " + json.dumps(examples_phase()))
        return 0
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    log(f"[build] {len(logs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line.lower() for w in ("registers", "spill", "error", "warning")):
                log(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    log(f"[probe] the first launches of K2, K1, the tf32x3 K6 and both tensor-core K6 "
        f"routes at MLA's head dims in a child process, "
        f"limited to {PROBE_TIMEOUT_S} s")
    try:
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--probe"],
                               capture_output=True, text=True, timeout=PROBE_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"the probe did not finish in {PROBE_TIMEOUT_S} s (killed): "
                             "a kernel that never ends, such as a wrong mbarrier "
                             f"parity\n{e.stdout or ''}{e.stderr or ''}") from None
    for line in (child.stdout + child.stderr).splitlines():
        log(f"  {line}")
    if child.returncode != 0:
        raise AssertionError(f"the probe exited {child.returncode}")
    log(f"[probe] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    graphs = {name: datasets.load(name, scale=1.0) for name in TABLE1}
    graphs[LARGE_NAME] = datasets.load(*LARGE)
    small = [gen.gnp(64 + 28 * i + (i % 3) * 5, 0.3 + 0.02 * i, seed=100 + i)
             for i in range(16)]
    log(f"[graphs] Table-1 at full scale, {LARGE_NAME} and 16 small graphs generated in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[kernels] each kernel against its plain version on the card (exact integers)")
    rows = check_kernels(graphs)
    log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")

    reset_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    log(f"[serve] TriangleServer(device='cuda').serve on Table-1, {LARGE_NAME} "
        "and 16 small graphs")
    serve_phase(graphs, small)
    log(f"[serve] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("[compare] dynamic pipeline vs MapReduce, every method forced "
        "(Resources(max_stages=4)); wall = host + device per count")
    comparison_phase(graphs)
    log(f"[compare] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("[stream] count_stream, count_windowed and checkpointed sessions on the card")
    table = stream_phase(graphs)
    log(f"[stream] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("[hybrid] the degree-aware hybrid stream state on the card: YT through the "
        "planner's own plan, FNA.5 and FB107x9 through hand-built plans, a restored "
        "session, a lossy plan")
    hybrid_table = hybrid_phase(graphs, table)
    log(f"[hybrid] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("[serve streams] StreamMultiplexer on the card: the Table-1 graphs interleaved (sync "
        "and prefetched), NY-size sessions to the detected budget, a preemption at full "
        "state size, spill and deadlines at FB107x9's size, a YT-size hybrid session, a "
        "mixed order of opens, preemptions and closes on a one-card mesh")
    serve_streams = serve_streams_phase(graphs)
    log(f"[serve streams] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log(f"[ring mesh] the dynamic pipeline's ring and the mesh ingests on {MESH_STAGES} "
        "stages of the one card, a CUDA stream each: resident rings, mesh streams, a "
        "window, checkpoints across layouts, admission")
    ring_mesh = ring_mesh_phase(graphs)
    log(f"[ring mesh] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("[cluster] ClusterServer / ClusterRouter over worker processes sharing the card: "
        "the Table-1 streams, NY-size sessions to the router's refusal, a migration, a "
        "SIGKILLed worker, a worker of four stages on the one card")
    cluster = cluster_phase(graphs, serve_streams["a"]["sync"]["wall_ms"])
    log(f"[cluster] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("[lm] Yi-6B at full width and depth, f32 weights: LMServer.generate, flash prefill "
        "(tf32x3 K6) + decode_step, forward")
    lm = lm_phase()
    log(f"[lm] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("[lm bf16] Yi-6B at full width and depth, bf16 weights: LMServer.generate, flash "
        "prefill (wgmma K6) + decode_step with a bf16 cache, held to f32 arithmetic")
    lm_bf16 = lm_phase(dtype="bfloat16")
    log(f"[lm bf16] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("[recsys] AutoInt at its full config: ctr_logits, retrieval_scores, "
        "lookup_multihot through K7")
    recsys = recsys_phase()
    log(f"[recsys] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("[lm deepseek] DeepSeek-V2-Lite (MLA, DeepSeekMoE): the smoke configs on the card "
        f"against the CPU port; f32 at full width and {DS_REDUCED_LAYERS} layers; bf16 at full "
        "width and depth: LMServer.generate, flash prefill (the wgmma K6 at head dims (192, "
        "128)) + decode_step, one MLA and one MoE layer against f32 arithmetic")
    lm_ds = deepseek_phase()
    log(f"[lm deepseek] done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    launches = launch_counts()  # the main path ends here
    for name, k in cluster.pop("launches").items():  # counted in the workers
        launches[name] += k
    log(f"[main path] kernel launches (this process and the [cluster] workers): {launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    t0 = time.perf_counter()
    log("[profile] one planner-chosen count each, a NY and a YT count_stream, the interleaved "
        "serve_streams, a Yi-6B flash prefill + decode in f32 and in bf16, and a "
        f"DeepSeek-V2-Lite bf16 flash prefill + {DS_PROFILE_STEPS} decode steps, "
        "torch.profiler (CPU + CUDA)")
    for one, steps in ((lm_ds, DS_PROFILE_STEPS), (lm, None), (lm_bf16, None)):
        one["summary"]["profile"] = profile_lm(one, steps)
        del one["model"], one["batch"]  # the counts' peaks below exclude the LM's weights
    torch.cuda.empty_cache()
    profile_phase(graphs)
    log(f"[profile] done in {time.perf_counter() - t0:.1f} s")
    del graphs
    train, ring, gnn, dm = slice_phases()
    dry = dryrun_phase()
    t0 = time.perf_counter()
    log("[examples] each examples/torch_*.py on the card, in its own process "
        "(outside the main path's launch window)")
    examples = examples_phase()
    log(f"[examples] done in {time.perf_counter() - t0:.1f} s")

    out = []
    for name, k in kernels().items():
        r = rows[name]
        ops_ms, bytes_ms = (t * 1e3 for t in r["bound"])
        out.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(str(_build.sources()[k.library]), HERE),
            "replaces": {
                "triangle_count_live": "src/repro/kernels/triangle_count/triangle_count.py:162",
                "masked_matmul_sum": "src/repro/kernels/triangle_count/triangle_count.py:79",
                "bitset_edge_count": "src/repro/kernels/bitset_count/bitset_count.py:139",
                "bitset_pair_count": "src/repro/kernels/bitset_count/bitset_count.py:110",
                "bitset_edge_count_per_edge":
                    "src/repro/kernels/bitset_count/bitset_count.py:86",
                "flash_attention":
                    "src/repro/kernels/flash_attention/flash_attention.py:62",
                "flash_attention_wgmma":
                    "src/repro/kernels/flash_attention/flash_attention.py:62",
                "flash_attention_tf32x3":
                    "src/repro/kernels/flash_attention/flash_attention.py:62",
                "embedding_bag": "src/repro/kernels/embedding_bag/embedding_bag.py:32",
            }[name],
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "dryrun_launches": dry["launches"].get(name, 0),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": r["library_ms"],
            # exact for the counting kernels; the float kernels' checks raise
            # unless every case is within its tolerance
            "match": r.get("match", r["max_abs_err"] == 0),
            "kernel_ms": r["ms"], "shape": r["shape"],
            **({k: r[k] for k in ("k3_ms", "at_k3_shape", "dtype", "fma_bf16_ms",
                                  "fma_f32_ms", "fma_bound_ms", "at_prefill_shape",
                                  "at_deepseek_shape",
                                  "at_fb107x9_shape", "at_bucket_shape",
                                  "live_block_bound_ms", "work_items", "slice")
                 if k in r}),
        })
        log(f"  bound of {name}: operations {ops_ms:.6f} ms, bytes {bytes_ms:.6f} ms")
    log("[stream table] " + json.dumps(table))
    log("[hybrid table] " + json.dumps(hybrid_table))
    log("[serve streams summary] " + json.dumps(serve_streams))
    log("[ring mesh summary] " + json.dumps(ring_mesh))
    log("[cluster summary] " + json.dumps(cluster))
    log("[lm summary] " + json.dumps(lm["summary"]))
    log("[lm bf16 summary] " + json.dumps(lm_bf16["summary"]))
    log("[lm deepseek summary] " + json.dumps(lm_ds["summary"]))
    log("[recsys summary] " + json.dumps(recsys))
    log("[train summary] " + json.dumps(train))
    log("[ring attention summary] " + json.dumps(ring))
    log("[gnn summary] " + json.dumps(gnn))
    log("[data-model mesh summary] " + json.dumps(dm))
    log("[dryrun summary] " + json.dumps(dry))
    log("[examples summary] " + json.dumps(examples))
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
