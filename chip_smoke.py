#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` and print
   the card's name and power limit;
2. the trap kernel (a warp per row) against its plain version on the card
   (bit-equal): the main path's 2048 x 40 traps, 1000 and 77 rows, one
   row, 64, 65 and 80 traps, 13 traps of 5 genes, and a population that
   starts 3 bytes off 16; then the sum order's edges (``ordered_sum``,
   XLA's windows of 32): 100, 200, 1000 and 1025 traps;
2b. the F15 kernel (row tiles, each group's rotation by a bulk copy)
   against its plain version (bit-equal) at (10000, 1000, m 50), Fig. 4's
   shape, at (1000, 1000, 50) and at (256, 200, 20); at its edges (n = 1,
   7, one tile, one tile + 1, a whole wave of tiles + 1; m = 7 and 13, the
   scalar route; m = 64; D = 40,000, where a tile is one row); at the
   shapes whose rows it cannot stage, one launch each, through the route
   the wrapper picks (z gathered from device memory at D 60,000 and 51,950,
   m 50, and at m 169; the sliced route at m 200, 500 and 1000, D 1000,
   and at m 2000, slices that start the sum order's windows); the sum
   order past 64 terms (m 65 and 100) and past 32 groups (100 groups of
   10); and at every rows per tile that phase 6 sweeps, whose shared
   memory the kernel and the wrapper must count alike;
3. the binary generation kernel against its plain version on the card,
   every selection x crossover x fused eval, at 8 islands of 256 x 160
   with pop_size drawn in [128, 256]; then at its edges (n not a multiple
   of the CTAs per island, L not a multiple of 4, islands off 16 bytes,
   all-masked and all-tied fitness, a tile under 16 bytes, the largest
   island that routes untiled; clusters of 1, 3, 5, 8 and 16 CTAs through
   n; fused trap at 100, 200 and 1025 traps) (bit-equal);
3b. the float generation kernel against its plain version, every
   selection x {two_point, uniform, blend} x {none, rastrigin, sphere,
   f15}, at 8 islands of 256 x 1000 with pop_size drawn in [128, 256] and
   the problem's fitness; then with fused F15 at its edges (m = 7 and 13,
   n not a multiple of the rows per block, all-masked and all-tied
   fitness, 365 x 1000; 4, 2 and 1 rows per block through L; m 65 and
   100, 100 groups of 10), and the fused rastrigin and sphere sums at L =
   65, 100, 1000 and 2000, one launch each (bit-equal);
3c. the tiled generation kernel (each block drawing its rows' plan) and,
   under roulette, the roulette-CDF kernel against their plain versions
   (bit-equal, genes, fitness and CDF): binary 2 x 2048 x 160 with fused
   trap, every selection x {two_point, uniform}; roulette at 1 x 4200 x
   160; binary 1 x 2048 x 256, two-point, no eval; float 1 x 10,000 x
   1000, every selection x blend x {none, f15}; the tiled path's F15 at
   m = 7 and 50; the kernel's edges (rows off its 16-byte pack, 1003 f32
   and 157 int8, populations 4 and 5 bytes off 16, 3 elite rows over
   blocks of 1, 2 and 8 rows, pop_size below n) against the plain version
   and the untiled kernels; the fused rastrigin and sphere sums at L =
   1000 and 2000; the CDF kernel alone at its edges (1, 63, 64,
   65, 127, 4096, 4097, 10,000, 16,384, 16,385 and 40,000 lanes, masked
   lanes at segments' ends, all-masked and all-tied islands, 8 x 256,
   islands off 16 bytes), bit-equal to ``common.roulette_cdf`` and
   non-decreasing; then the tiled kernel against the untiled
   ones at the main paths' shapes, and three rows per block giving
   identical bits;
4. the main path: ``run_fused`` at the paper's configuration (trap 40x4,
   max_pop 256, min_pop 128, 100 generations per epoch, pool topology,
   8 islands, 5 epochs, W²) through the kernels, then again through the
   plain versions from the same seed: islands, pool and stats must be
   equal, and both of its kernels must have been launched; a step
   profile, with the generation kernel's own device time per generation;
4b. the paper's F15 path (D 1000, m 50, the shipped constants, blend
   crossover, sigma 0.3, otherwise as in 4): 2 epochs through the kernels
   and through the plain versions from the same seed, which must be equal,
   then a timed 5-epoch kernel run; both of its kernels must launch;
4c. both paths under ``impl="pallas_tiled"`` (paper-8 5 epochs, paper-f15-8
   2 epochs): equal to the ``impl="pallas"`` runs from the same seed, the
   tiled kernel launched and neither the CDF kernel nor the untiled ones
   (tournament: one launch a generation); a step
   profile of each, then evals/s of both impls in turns (pallas, tiled,
   tiled, pallas, 5 epochs each) on both paths;
4d. Fig. 4's row (``benchmarks/fig4_f15.py``): one fused generation+F15
   step of a 10,000 x 1000 population through ``impl="pallas"``, which
   routes it to the tiled kernel (one launch) and then the F15 kernel;
   bit-equal to the plain version, timed as ms per 10,000 evaluations;
5. the trap kernel run at 132 islands (one block per SM), 3 epochs;
6. each kernel's time at the main paths' shapes against its bound, the
   generation kernels' launch shapes and times without their fused eval;
   the tiled kernel at Fig. 4's shape and at paper-8's (in turns with the
   untiled binary kernel), each against the untiled kernel's work, the
   CDF kernel at 10,000 lanes, the tiled kernel's swept rows per block
   against the heuristic's, and the ptxas report of both; F15 at the
   island batch and at Fig. 4's shape against ``bound_of`` and against the
   no-FMA contract's FP32 issue floor (its term's instructions counted in
   the kernel's SASS), its launch shape, the sweep of rows per tile at
   Fig. 4's shape, its gathered and sliced routes at 2048 rows (D 60,000;
   m 200 and 1000) against ``bound_of`` and the plain version; trap at the
   main path's shape against its bound; the ptxas report of both;
   ``torch.cumsum`` of the masked weights beside the CDF kernel, and
   both scan orders' (left to right, segmented) distance from an f64 sum;
7a. the WKV6 kernel through ``kernels/rwkv6/ops.wkv`` against both plain
   chunked versions (``wkv_chunked``, the reference's form, and
   ``wkv_subchunked``, the kernel's) and the sequential recurrence, with
   r, k, v and u in f32 and in bf16: the four shapes of
   ``tests/test_kernels.py`` (S = 37 through the padding), the state-carry
   composition, and the serve shape (4, 1024, 40, 64) with RWKV's decays
   and with strong ones; its time at the serve shape as the prefill calls
   it (bf16 through ops.wkv) and on f32 inputs, against its bound and both
   plain versions' times; the ptxas report of the serve shape's kernels;
7b. the model-land path: rwkv6-3b at its published size (32 layers,
   d 2560, bf16, random weights from the seed with the decay and mixing
   LoRAs drawn too) served by ``launch.serve.generate``: a prefill of 4 x
   1024 tokens through the kernel (one launch per layer, none in decode),
   32 greedy tokens; the prefill through the plain recurrence must agree:
   layer by layer from the same input, in f32 end to end (the same
   weights), and in bf16 end to end within fixed limits; prefill and
   decode rates, a device profile of each, peak memory;
8a. the flash-attention kernels against their plain version
   (``kernels/flash_attention/ref.attention``): the five shapes of
   ``tests/test_kernels.py``, the shapes phase 14's prefills give the
   kernel (``FLASH_SERVED``) and the yi-9b serve shape (4, 2048, 32 heads
   over 4, 128), in bf16 (the bf16 tensor-core kernel, ``flash_tc.cu``)
   and in f32 (the 3xTF32 tensor-core kernel, ``flash_3xtf32.cu``); the
   f32 kernel also at its edges (non-causal, Sq > Sk, keys off its tiles,
   MQA, strided views and views 4 bytes off 16); each kernel's time at the
   serve shape in its dtype against its bound (the f32 kernel's in 3xTF32
   on the TF32 tensor cores, beside the CUDA-core bound of f32
   operations), the plain version's and SDPA's (a yardstick the port never
   calls), with both kernels' build times and ptxas reports;
8b. the dense path: yi-9b at its published size (48 layers, d 4096, GQA
   32 / 4, bf16, random weights from the seed) served by
   ``launch.serve.generate``: a prefill of 4 x 2048 tokens through the
   tensor-core flash kernel (one launch per layer, none in decode), 32
   greedy tokens; the prefill through the plain (q-chunked) attention must
   agree: each layer's attention output from the same bf16 input, an f32
   twin of the whole model end to end (through the 3xTF32 kernel, one
   launch per layer), and the bf16 model end to end within fixed limits;
   prefill and decode rates, a device profile of each, peak memory;
9a. the classic path (``impl="jnp"``, ``EAConfig()``'s defaults, the
   operators of ``core/ga.py`` in plain PyTorch on the card, the fitness
   through the trap kernel): paper-8 for 5 epochs through ``run_fused``
   and through the host loop ``run_experiment``, which must be equal; one
   epoch on the card equal to the same epoch on the CPU; evals/s beside
   phase 4's ``impl="pallas"``, and a step profile;
9b. the float classic path, paper-f15-8 (blend, gaussian sigma 0.3, the
   fitness through the F15 kernel) for 2 epochs; the initial islands and
   one generation step from the run's final state held against the CPU
   within the CPU tests' float tolerances; a step profile;
9c. every topology x acceptance policy (5 x 4) at paper-8 width, 3 epochs
   of 10 generations, under ``impl="pallas"`` with the counter ledger:
   each equal to the same run under ``impl="pallas_ref"`` (islands, pool,
   stats, harvest), each ledger balanced (delivered = accepted +
   rejected);
9d. the ``ea`` command (``python -m repro_torch.launch.evolve ea`` with no
   ``--device``) in a subprocess: exit 0 and the reference's final line;
10a. the asynchronous runtime at paper-8 width (``run_fused_async``,
   ``AsyncConfig(min_rate=0.25, max_rate=1.0, staleness=3,
   churn_fraction=0.25)``, 8 islands, 10 ticks, W²; depth cut as phase 4
   cuts it): ``impl="pallas"``, ``pallas_tiled`` and ``pallas_ref`` equal
   bit for bit under the fire masks (islands, pool, stats, ``AsyncState``,
   the counter ledger); the degenerate ``AsyncConfig()`` equals
   ``run_fused`` (3 ticks); ``run_experiment_async`` equals
   ``run_fused_async``; paper-f15-8 over 2 ticks under the three impls,
   equal; then one ``[main]`` epoch against one ``[async-main]`` tick in
   turns (main, async, async, main): kernels, fires, device busy and wall
   per epoch or tick, busy share and evals/s;
10b. durability on the card: ``snapshot_every=2`` runs (sync and async, 4
   epochs) equal their one-segment runs; the ``ea --fused --runtime async
   --snapshot-every 2 --w2`` command in a child process killed by SIGKILL
   once its second snapshot has landed, then ``--resume`` in a fresh process,
   whose final snapshot must equal the uninterrupted run's leaf for leaf;
   a resume at 12 islands from the 8-island snapshot, whose joiners take
   uuids 8-11, never go down and fire;
10c. the ``ea --runtime async`` command on the card by default, the host
   loop and ``--fused``, in subprocesses: exit 0 and the reference's final
   line;
11a. the host tier at paper-8 width: ``run_experiment`` (5 epochs, W²)
   with ``HostBridge(PoolServer(capacity=256, seed=8191), pull=4)``, the
   server and the device pool down for epochs 2 and 3, under
   ``impl="pallas"``, ``pallas_tiled`` and ``pallas_ref``: equal bit for
   bit (islands, pool, stats rows, the bridge's counts, the server's
   entries and stats), the kernels launched; the same for paper-f15-8
   over 2 epochs;
11b. over the wire: ``python -m repro_torch.server --port 0 --spool DIR``
   in a child process; the paper-8 run bridged to its URL (experiment
   seed 1, one shard) equals the in-process run with PoolServer(seed=8191);
   then the async runtime's host loop (8 ticks, the paper-8 async
   configuration) with ``AsyncHostBridge(url, cursor_id=...)`` while 256
   ``AsyncWireClient`` volunteers on a second thread GET, hill-climb (the
   plain trap on the host CPU) and PUT against 2 shards; the server is
   killed by SIGKILL after tick 4 and restarted with ``--resume`` on the
   same port before tick 6: no (shard, seq) reaches the device pool
   twice, and the cursor ledger balances (delivered + dropped = the seqs
   the cursor covers); ``/metricz``'s p50 and p99 per verb;
11c. ``[main]`` against ``[bridge-main]`` (one epoch plus a HostBridge
   sync) in turns (main, bridge, bridge, main): wall, kernels, busy share
   and synchronizing host reads per epoch; against a slowed-server double
   (each verb sleeps 200 ms) AsyncHostBridge.sync never waits (each call
   under 50 ms) and HostBridge's epoch grows by its five verbs;
11d. the commands: ``ea --bridge`` (sync and ``--runtime async``), the
   ``volunteer_sim`` sync demo, its ``--runtime async --trace T --obs-json
   O``, then ``python -m repro_torch.obs T --obs O``: each exits 0;
12a. the sharded drivers on the one card: 2 ranks of 4 islands sharing
   it (gloo with every collective's tensors copied to the host), paper-8
   depth cut to 2 epochs: ``run_sharded``, ``run_fused_sharded`` (stats,
   counters) and ``run_fused_sharded_async`` (phase 10a's
   ``AsyncConfig``) under ``impl="pallas"`` and ``"pallas_ref"``, each
   pair bit-equal, the generation kernel launched on every rank, every
   rank's pool replica and global islands equal to rank 0's; the other
   four topologies for 2 epochs; paper-f15-8 for 2 epochs (both of its
   kernels launched on every rank); ``[main]`` (rank 0 alone, 8 islands)
   and ``[sharded]`` epochs in turns (main, sharded, sharded, main): wall
   per epoch, evals/s, collectives and their host time per epoch;
12b. a world of one rank at cuda:0: the fused driver over NCCL equals it
   over a gloo group with host copies bit for bit; then whether NCCL takes
   2 ranks on one card (printed: refused or accepted);
12c. ``ea --sharded --shards 2 --fused --w2 --snapshot-every 1`` in a
   child process group killed by SIGKILL once its first snapshot has
   landed, then ``--resume`` in a fresh one: its final snapshot equals the
   uninterrupted run's (12a's world ran it) leaf for leaf; the killed
   snapshot resumed by ``--shards 4`` runs to the end with the 8 islands;
13a. training at the published size: ``launch/train.py``'s ``train`` of
   minicpm-2b (40 layers, d 2304, 2.7 B parameters, bf16 with the f32
   master, random weights from the seed), batch 8 x seq 512, remat per
   layer, the WSD schedule at lr 3e-3, 6 steps: every step's ce, gnorm
   and lr finite; ms per step (CUDA events, the median of 5 after one
   warm step), tokens/s, peak memory, the share of the dense bf16 peak
   that 6 N tokens a step make; two more steps, the second profiled
   (launches, device busy against the first's wall, the largest kernels);
13b. the card against the CPU: smoke minicpm-2b and rwkv6-3b in f32 from
   the same state and batches, 5 steps each, ce, gnorm and final
   parameters within ``CARD_CPU_TOL``; ``train`` for 6 steps with a
   checkpoint at 3, the last checkpoint removed and ``resume``: bit for
   bit the uninterrupted run (both archs); one step of a bf16 reduced
   minicpm-2b, its params its f32 master rounded;
13c. rwkv6-3b at full width with its depth cut to 4 layers, batch 8 x seq
   512, 3 steps through the plain sequential WKV under autograd: finite
   ce and gnorm, ms per step, peak memory;
13d. the ``pbt`` command (``evolve.main(["pbt"])``, the reference's
   defaults: 4 members, 5 epochs of 20 steps) on the card: its lines and
   best member, the pool's puts = members x epochs; then
   ``examples/evolve_lm.py``'s epoch with the pool killed: the member
   trains on and ``migrate`` returns False;
13e. ``make_train_step(use_flash=True)`` and ``(use_rwkv_kernel=True)``
   raise; the flash and WKV wrappers raise on CUDA inputs that require
   grad under grad mode and launch under ``torch.no_grad``;
14. the other model families served through ``launch.serve.generate``
   with random weights from the seed (``FAMILY_CELLS``): olmoe-1b-7b (16
   layers, 64 experts top 8; 4 x 1024 prompts, whose MoE runs two
   ``SEQ_CHUNK`` slices), hymba-1.5b (32 layers, 128 meta tokens; 4 x
   1920 prompts, S = 2048) and seamless-m4t-large-v2 (24 + 24 layers,
   ``src_embed`` 4 x 512 frames; 4 x 512 prompts) at their published
   sizes, 32 new tokens; llama-3.2-vision-90b (10 of 100 layers, the
   cross gates set to ``FAMILY_GATE``) and dbrx-132b (2 of 40 layers) at
   full width, 4 x 512 prompts, 16 new tokens. Each cell: the flash kernel
   launched once per causal, unwindowed self-attention layer of the
   prefill and nothing else; prefill and decode timed after a warm-up;
   the flash route against the plain route layer by layer from the same
   input and end to end (``FAMILY_LAYER_TOL``, ``FAMILY_BF16_TOL``), the
   MoE cells' routing sets that differ between the routes counted; a
   profile of the prefill and of a decode step. Then olmoe's f32 prefill
   at full width, 2 layers, on the card against the port on the CPU:
   expert indices, positions, keep and ``dropped_frac`` equal, logits
   within ``OLMOE_F32_TOL``;
15. model land on a (data, model) mesh (``sharding_phases``): the flash
   and WKV kernels at the local-head shapes the mesh gives them
   (``MESH_FLASH_SHAPE``, ``MESH_WKV_SHAPE``) against their plain
   versions, timed beside their bounds; the one-rank runs below; then 2
   ranks sharing the card (gloo with host copies): 15a yi-9b at its
   published size served on (1, 2) under the serve rules (prefill with
   the flash kernel on each rank's 16 q and 2 kv heads, ``MESH_NEW``
   greedy decode steps), its logits within ``DENSE_BF16_TOL`` of the
   one-rank prefill, each rank's peak memory beside what the rules give
   it; 15c rwkv6-3b's prefill on (1, 2) (the WKV kernel on 20 local
   heads) within phase 7b's bf16 limits of the one-rank prefill; 15b
   olmoe-1b-7b at full width, ``MESH_TRAIN_LAYERS`` layers, trained
   ``MESH_TRAIN_STEPS`` steps on (1, 2) (expert parallelism, 32 local
   experts, and the heads) and on (2, 1) (data parallel, ZeRO-1), ce and
   gnorm within ``MESH_TRAIN_TOL`` of the one-rank run; 15d a world of one
   rank over NCCL: a (1, 1) mesh equals the mesh-less train, prefill and
   decode steps bit for bit; 15e ``python -m repro_torch.launch.dryrun
   --arch yi-9b --shape decode_32k`` in a subprocess (its own fake group
   of 256), its per-rank GiB against the card's memory;
16. the invariant analyzer (``analysis_phase``): ``python -m
   repro_torch.analysis --selfcheck``, then the lint of ``src/repro_torch``,
   ``chip_smoke.py`` and ``tests/test_torch_*.py`` against
   ``analysis_baseline_torch.json``, both in subprocesses (no finding and no
   stale entry), and the static kernel, topology and policy registrations
   equal to the registries the phases above ran on the card; the
   ``[analysis] findings 0, suppressed N, stale 0, S s`` line;
17. one JSON line with each kernel's launches, time, plain time, bound and
   library time, then the last line: ``{"ok": true, "device": {...}}``.

It imports the port only (``src/repro_torch``), never JAX or the reference.
Run times are wall clock around work that ends in
``torch.cuda.synchronize()``; kernel and plain-version times are CUDA
events around back-to-back calls (:func:`event_ms`).
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 2016
# Bounds of the card (NVIDIA H100 SXM data sheet, at the 700 W limit):
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# int32 operations: each of an SM's 4 schedulers issues one warp
# instruction (32 lanes) per clock, whether it goes to the integer ALU pipe
# (add, shift, logic) or as an IMAD to the FMA pipe, so at most 128 int32
# operations per SM per clock. At the clock of the f32 figure, which counts
# each of 128 FMA lanes as two operations, that is half of it.
INT32_OPS_PER_S = F32_OPS_PER_S / 2
# int32 operations of one Threefry-2x32 draw in generation.cu, counted as
# the compiled code runs it: only x0 is returned, a rotate by a constant is
# one funnel shift, and the salt word's key add, its first rotate and each
# injection's k + c are the same for every draw of a thread. So: the
# counter's key add; round 1's add and xor; rounds 2-19 of (add, shift,
# xor); round 20's add (its x1 is dead); 4 injections of 2 adds; the last
# injection's add to x0.
THREEFRY_OPS = 1 + 2 + 18 * 3 + 1 + 4 * 2 + 1
# int32 operations of a child gene besides its draws, read from phase 2 of
# generation.cu at their least: its counter, the mutation test (an integer
# compare of the bits against the rate's threshold) and the flip; on a row
# whose crossover gate is on, two cut compares and the select (two-point)
# or one compare and the select (uniform).
GENE_OPS = 3
CROSS_OPS = {"two_point": 3, "uniform": 2}
# A Box-Muller draw keeps the second word too: round 20's rotate and xor
# and the last injection's add to x1.
THREEFRY2_OPS = THREEFRY_OPS + 3
# f32 operations of the float generation, counted at their least from
# generation_float.cu (an FMA counts two, a transcendental one): a blended
# gene (sub and two FMAs), a mutated gene (1 - u1, log, -2 *, sqrt,
# 2 pi *, cos, r * cos, two int-to-float scalings, the FMA) and the clip
# of a child gene.
BLEND_F32 = 5
NORMAL_F32 = 11
CLIP_F32 = 2
# f32 operations per gene of an F15 row besides its rotation: z - o, the
# term (r * r, 2 pi * r, cos, 10 *, -, +) and its add to the sum.
F15_GENE_F32 = 8
# the F15 kernel's rows per tile that phase 6 times at Fig. 4's shape (and
# phase 2b holds bit-equal), beside the wrapper's choice
F15_SWEEP_ROWS = (8, 16, 20, 26, 32, 38, 44)
# phase 2b: (tag, n, D, m) of the F15 shapes whose rows the tiled route
# cannot stage; phase 6 times those at n = 2048
F15_ROUTE_CASES = (("gathered", 2048, 60000, 50), ("gathered", 7, 51950, 50),
                   ("gathered m 169", 333, 1014, 169),
                   ("sliced", 2048, 1000, 200), ("sliced", 2048, 1000, 1000),
                   ("sliced", 1, 1000, 1000), ("sliced", 45, 1000, 500),
                   ("sliced", 300, 2000, 2000))
TIMED_CALLS = 50
# head start of the timed windows: the card spins this long while the host
# enqueues the calls (the spin is counted in clock cycles; 2 GHz is above
# the H100's boost clock, so the spin lasts at least this long)
HEAD_START_S = 0.2
SPIN_CYCLES_PER_S = 2.0e9
# the paper's published CPU times for 10,000 F15 evaluations, in ms
# (2015; benchmarks/fig4_f15.py PAPER_MS)
PAPER_FIG4_MS = {"java": 991.0, "js_node": 1234.0}
# the WKV6 cases of phase 7a: (B, S, H, hd, chunk, decays); the first four
# are tests/test_kernels.py's, the last two the serve shape
WKV_CASES = [(2, 64, 3, 16, 32, "rwkv"), (1, 128, 2, 64, 32, "rwkv"),
             (2, 37, 1, 8, 32, "rwkv"), (1, 32, 4, 32, 8, "rwkv"),
             (4, 1024, 40, 64, 32, "rwkv"), (4, 1024, 40, 64, 32, "strong")]
# w = exp(-exp(U(lo, hi))): RWKV's range (test_kernels.py) and strong decays
WKV_DECAYS = {"rwkv": (-4.0, 1.0), "strong": (2.0, 4.0)}
# the reference's kernel tolerance; with strong decays the chunk's cumsum
# of log w reaches about -1760, where an f32 ulp is 1.2e-4, so the
# pairwise exponents of the chunked form carry that much error
WKV_TOL = {"rwkv": dict(atol=1e-3, rtol=2e-3),
           "strong": dict(atol=1e-2, rtol=2e-3)}
# phase 7b: the rwkv6-3b serve cell
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 1024, 32
# kernel route against plain route at full size, relative L2. In f32 (the
# served weights in f32, activations f32) the WKV is the only difference:
# last-position logits and the wkv states of all layers within 1e-3. In
# bf16, layer by layer from the same input, each layer's output within
# 1e-2 (the routes' f32 y rounds to bf16 apart now and then) and its wkv
# state within 1e-5. End to end in bf16, bf16 rounding of the WKV output
# is amplified through 32 random layers: on an H100 (PERF.md) the
# routes lay 0.1414 (logits) and 0.1138 (states) apart, while the bf16
# plain route lay 0.2744 and 0.2221 from the f32 plain route. The limits
# sit between those readings.
SERVE_F32_TOL = 1e-3
SERVE_LAYER_TOL = {"out": 1e-2, "state": 1e-5}
SERVE_BF16_TOL = {"logits": 0.2, "state": 0.17}
# bf16 tensor cores, dense (the H100 SXM data sheet): the bound of the
# bf16 flash-attention row, whose work the tensor-core kernel does
BF16_OPS_PER_S = 989e12
# TF32 tensor cores, dense (the same data sheet): the WKV kernel's products
# run in 3xTF32, three TF32 products for each f32-grade one (two where one
# operand is exact in tf32, as a bf16 v is), counted as such in wkv_work
TF32_OPS_PER_S = 495e12
# phase 8a: (B, S, H, Kv, hd), tests/test_kernels.py's five shapes, the
# shapes phase 14's prefills give the kernel, and the yi-9b serve shape
# last (the one 8a times); the reference's tolerances (atol, rtol)
FLASH_SERVED = [(4, 1024, 16, 16, 128),     # olmoe-1b-7b, MHA, qk-norm
                (4, 2048, 25, 5, 64),       # hymba-1.5b's global layers
                (4, 512, 16, 16, 64),       # seamless-m4t-large-v2 decoder
                (4, 512, 64, 8, 128),       # llama-3.2-vision-90b
                (4, 512, 48, 8, 128)]       # dbrx-132b
FLASH_CASES = [(1, 64, 4, 4, 16), (2, 96, 8, 2, 32), (1, 64, 4, 1, 16),
               (1, 50, 4, 2, 16), (2, 64, 6, 3, 64), *FLASH_SERVED,
               (4, 2048, 32, 4, 128)]
FLASH_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
# phase 8a: the f32 kernel's edges, (B, Sq, Sk, H, Kv, hd, causal, view):
# non-causal with keys off its 32-key tiles, Sq > Sk causal, MQA and GQA
# 8:1 at hd 128, one q tile at hd 16, and views 4 bytes off 16
FLASH_F32_EDGES = [(2, 200, 333, 4, 1, 128, False, "contiguous"),
                   (1, 300, 130, 4, 2, 128, True, "contiguous"),
                   (2, 256, 256, 8, 1, 128, True, "contiguous"),
                   (2, 100, 100, 4, 2, 16, True, "contiguous"),
                   (2, 150, 97, 8, 2, 32, True, "offset4"),
                   (2, 150, 97, 8, 2, 32, False, "offset4")]
# phase 8b: the yi-9b serve cell
DENSE_BATCH, DENSE_PROMPT, DENSE_NEW = 4, 2048, 32
# kernel route against plain route, relative L2, set before the first run
# of this phase. Layer by layer from the same bf16 input: the CUDA-core
# kernel then kept p in f32 where the plain route rounds it to bf16 (2^-9
# relative, about 1e-3 on the weighted sum), then both round the output to
# bf16: predicted 2e-3 to 5e-3, limit 1e-2 (phase 7b's). The tensor-core
# kernel rounds p to bf16 as the plain route does; the limits stay. The
# f32 twin (the same weights in f32, all 48 layers) differs in summation
# order only: predicted 1e-6 to 1e-4 on last-position logits, limit 1e-3.
# End to end
# in bf16 the per-layer differences were predicted to grow through 48
# random layers, as phase 7b's do through 32, to 0.05-0.3 (first limit
# 0.3). On an H100 (PERF.md) they grew far less: 2.1135e-2 on logits,
# beside 3.2793e-3 layer by layer, 4.2144e-6 in f32, and 1.8980e-2 between
# the bf16 and the f32 plain routes. The limit is now 5e-2: about 2.4
# times the reading, and the kernel route no farther from the plain one
# than 2.6 times bf16's own distance from f32.
DENSE_LAYER_TOL = 1e-2
DENSE_F32_TOL = 1e-3
DENSE_BF16_TOL = 5e-2
# phase 9b: the float classic path on the card against the CPU, the float
# tolerances of tests/test_torch_evolve.py (genes; fitness relative and
# absolute); integer fields exact
GENE_ATOL, FIT_RTOL, FIT_ATOL = 2e-6, 2e-4, 1e-3
# phase 10: ticks of the async runs at paper-8, steps of each turn of the
# [main] / [async-main] comparison, ticks of the killed and resumed command
ASYNC_TICKS = 10
PROFILE_TICKS = 2
KILL_TICKS = 12
# phase 11: the bridged runs' epochs and the epochs their device pool and
# in-process server are down; the wire experiment's seed (its one shard's
# PoolServer seed is 8191 times it); the wire run's ticks, the tick after
# whose sync the server is SIGKILLed and the tick before whose sync it is
# back (--resume); the wire volunteers and their pause between PUTs; the
# slow-server double's sleep per verb, the longest AsyncHostBridge.sync it
# may cause, and its epochs
BRIDGE_EPOCHS = 5
BRIDGE_DOWN = (2, 3)
WIRE_SEED = 1
WIRE_TICKS = 8
WIRE_KILL = (4, 6)
VOLUNTEERS = 256
VOLUNTEER_PAUSE_S = 0.5
SLOW_VERB_S = 0.2
SLOW_SYNC_MAX_MS = 50.0
SLOW_EPOCHS = 3
# phase 12: ranks sharing the card, paper-8 epochs of each sharded run and
# of each turn of the [main] / [sharded] comparison, epochs of the killed
# and resumed ea --sharded command, and the seconds that bound each
# spawned world (every collective and the whole world)
SHARD_RANKS = 2
SHARD_EPOCHS = 2
SHARD_TURN_EPOCHS = 2
SHARD_KILL_EPOCHS = 4
SHARD_TIMEOUT = 600.0
# Phase 13: training. 13a trains minicpm-2b at its published size for
# TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens (the first a warm
# step, the median of the others timed); 13c rwkv6-3b at full width cut to
# RWKV_TRAIN_LAYERS layers; 13b the smoke configs for CARD_CPU_STEPS steps
# on the card and on the CPU, held to CARD_CPU_TOL (ce and gnorm relative,
# parameters absolute: card against CPU, other sum orders; RWKV6's LoRA
# factors start at zero, so their first gradients are sums of near-zero
# terms whose signs the order flips, and Adam makes a flipped sign a step
# of about lr); 13d the pbt command at the reference's defaults.
TRAIN_STEPS = 6
TRAIN_BATCH, TRAIN_SEQ = 8, 512
RWKV_TRAIN_LAYERS = 4
RWKV_TRAIN_STEPS = 3
CARD_CPU_STEPS = 5
CARD_CPU_TOL = {"minicpm-2b": dict(ce=1e-5, gnorm=1e-4, params=1e-5),
                "rwkv6-3b": dict(ce=1e-5, gnorm=1e-3, params=1e-3)}
# dense bf16 tensor-core peak of the card (H100 SXM data sheet)
BF16_FLOPS_PER_S = 989e12
# Phase 14: the other model families served through launch/serve's
# generate with random weights from SEED. Each cell: (arch, layers (None:
# the published depth), batch, prompt tokens, new tokens). dbrx-132b
# (131.6 B parameters, 263 GB in bf16) and llama-3.2-vision-90b (87.7 B,
# 175 GB) do not fit one 80 GB card: both run at full width with their
# depth cut, dbrx to 2 of 40 layers, the vision model to 10 of 100 (two
# superblocks of 4 self-attention and 1 gated cross-attention layers).
# hymba's prompt of 1920 makes S = 2048 with its 128 meta tokens.
FAMILY_CELLS = [("olmoe-1b-7b", None, 4, 1024, 32),
                ("hymba-1.5b", None, 4, 1920, 32),
                ("seamless-m4t-large-v2", None, 4, 512, 32),
                ("llama-3.2-vision-90b", 10, 4, 512, 16),
                ("dbrx-132b", 2, 4, 512, 16)]
# seamless's source frames (the stub frontend's embeddings, B x 512 x d)
FAMILY_SRC_LEN = 512
# the vision cells' cross gates (zero at init: tanh(0) = 0 and a cross
# layer would add nothing)
FAMILY_GATE = 0.7
# Limits of the flash route against the plain route, relative L2, set
# before this phase's first run. Layer by layer from the same bf16 input
# each flash layer's attention output within 1e-2, phase 8b's limit
# (yi-9b read 3.3e-3 there). End to end, last-position logits: phase 8b's
# 5e-2 where the prefill has no router (hymba's three flash layers,
# seamless's decoder, the vision model's eight); a router turns a bf16
# difference into another top-k choice now and then, which moves that
# token's output by a whole expert's share, so the MoE cells get 0.2
# (olmoe, 16 layers of top-8) and 0.1 (dbrx, 2 layers of top-4). The
# routing sets that differ between the routes are counted and printed.
# The first run (H100, 700 W) read hymba at 5.8674e-2 against its first
# limit of 5e-2, each of its flash layers within 3.5754e-3: 3 flash
# layers' bf16 differences grow through 32 layers of attention and SSM
# heads. Its limit is now about twice that reading (8b's is 2.4 times
# its), and hymba also runs an f32 twin (the same weights in f32): there
# the routes differ in the f32 kernel's sum order only, within
# FAMILY_F32_TOL (8b's f32 limit), and the bf16 plain route's own
# distance from the f32 plain route is printed beside the bf16 reading.
FAMILY_LAYER_TOL = 1e-2
FAMILY_BF16_TOL = {"olmoe-1b-7b": 0.2, "hymba-1.5b": 0.12,
                   "seamless-m4t-large-v2": 5e-2,
                   "llama-3.2-vision-90b": 5e-2, "dbrx-132b": 0.1}
FAMILY_TWIN = ("hymba-1.5b",)
FAMILY_F32_TOL = 1e-3
# olmoe's f32 prefill at full width cut to 2 layers, 1 x 512 tokens, on
# the card (the 3xTF32 flash kernel) against the port on the CPU: the
# routing equal, the last-position logits within 1e-4 relative L2 (the
# f32 twin of phase 8b read 4.2e-6 between the routes on the card alone)
OLMOE_F32_LAYERS = 2
OLMOE_F32_TOL = 1e-4
# phase 15: model land on a (data, model) mesh of ranks that share the
# card (gloo with host copies; NCCL refuses two ranks on one card, 12b).
# 15a serves yi-9b at DENSE_BATCH x DENSE_PROMPT on (1, 2), MESH_NEW
# decode steps; its last-position logits are held to the one-rank
# prefill's at DENSE_BF16_TOL. 15b trains olmoe-1b-7b at full width, its
# depth cut to MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS steps of
# MESH_TRAIN_BATCH x MESH_TRAIN_SEQ on (1, 2) (32 local experts, the
# heads split) and on (2, 1) (data parallel, ZeRO-1), each held to the
# one-rank run. The limits, set before the first run: on (1, 2) the
# function is the one-rank one (one data rank routes every token with the
# global capacity), apart by the bf16 rounding of the ranks' partial sums:
# ce within 2e-2 absolute, gnorm within 5e-2 relative; on (2, 1) each
# data rank routes its own rows with its own capacity, so other tokens
# drop (the reference's test_moe_ep.py allows 0.05 on the loss between
# the routes): ce within 5e-2, gnorm within 0.1. 15c prefills rwkv6-3b at
# SERVE_BATCH x SERVE_PROMPT on (1, 2), the WKV kernel on 20 local heads,
# held to the one-rank prefill at phase 7b's bf16 limits
# (SERVE_BF16_TOL). 15d: a (1, 1) mesh over NCCL equals the mesh-less
# steps bit for bit (yi-9b at full width, MESH_EQUAL_LAYERS layers).
MESH_RANKS = 2
MESH_NEW = 8
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS = 4, 3
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 4, 256
MESH_TRAIN_TOL = {(1, 2): dict(ce=2e-2, gnorm=5e-2),
                  (2, 1): dict(ce=5e-2, gnorm=0.1)}
MESH_EQUAL_LAYERS = 2
MESH_TIMEOUT = 900.0
# 15c's f32 twin: the weights and activations in f32, the ranks' partial
# sums in f32, held to the one-rank f32 prefill at SERVE_F32_TOL (a head
# placed or merged wrongly moves a whole head's output, far beyond it).
# The dry run (python -m repro_torch.launch.dryrun --mesh ...) of 15a's
# and 15b's cells, run beside them on the host, against each rank's
# measured peak: its per-rank bytes count the same allocations (the
# blocks, the inputs, the step's live temporaries) but not the caching
# allocator's rounding or cuBLAS's workspaces, and it frees a temporary
# when its Python object dies, so it may read a little above or below:
# within MESH_DRY_TOL relative of the peak, set before the first run.
MESH_DRY_TOL = 0.25
MESH_DRY_CELLS = {
    "15a (1, 2)": ["--mesh", "1x2", "--arch", "yi-9b", "--shape",
                   "prefill_32k", "--batch", str(DENSE_BATCH), "--seq",
                   str(DENSE_PROMPT)],
    **{f"15b {shape}": ["--mesh", f"{shape[0]}x{shape[1]}", "--arch",
                        "olmoe-1b-7b", "--shape", "train_4k", "--batch",
                        str(MESH_TRAIN_BATCH), "--seq", str(MESH_TRAIN_SEQ),
                        "--layers", str(MESH_TRAIN_LAYERS), "--accum", "1"]
       for shape in ((1, MESH_RANKS), (MESH_RANKS, 1))}}
# the local-head shapes phase 15 gives the kernels: yi-9b's 32 query and
# 4 kv heads over 2 ranks, rwkv6-3b's 40 heads over 2
MESH_FLASH_SHAPE = (DENSE_BATCH, DENSE_PROMPT, 16, 2, 128)
MESH_WKV_SHAPE = (SERVE_BATCH, SERVE_PROMPT, 20, 64)


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def event_ms(fn, reps: int) -> float:
    """Time per call of ``fn`` by CUDA events around ``reps`` calls. The
    card first spins for :data:`HEAD_START_S`, while the host enqueues all
    the calls, so the events time the device running them back to back
    rather than the host's enqueue rate."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(HEAD_START_S * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def generation_work(seed, size, fit, spec, n_isl: int, n: int):
    """(bytes, int32 operations) that one generation kernel call needs on
    these inputs: each input read once and each output written once, and
    the Threefry draws and per-gene work of its child rows. Which rows cross
    over depends on the data, so the gate is read from the plain version's
    plan. The per-row work besides the draws (the randint modulo, the
    tournament compares) is left out: under 0.5 % of the count."""
    from repro_torch.kernels.ga.common import selection_plan
    if spec.selection != "tournament":
        raise ValueError("the bound is derived for tournament selection")
    length, children = spec.length, n - spec.elite
    gated = int(selection_plan(seed, fit, size, spec, n).gate.sum().item())
    row_draws = 2 * spec.tournament_k + 1 + (
        2 if spec.crossover == "two_point" else 0)
    draws = (n_isl * children * (row_draws + length)
             + (gated * length if spec.crossover == "uniform" else 0))
    ops = (draws * THREEFRY_OPS + n_isl * children * length * GENE_OPS
           + gated * length * CROSS_OPS[spec.crossover])
    fused = spec.fused_eval is not None
    nbytes = (2 * n_isl * n * length + (2 if fused else 1) * 4 * n_isl * n
              + 2 * 8 * n_isl + 4 * n_isl)
    return nbytes, ops


def plan_draws(spec) -> int:
    """Threefry draws of one child row's plan: k per tournament, two
    tournaments, the gate, and two cuts under two-point crossover."""
    return 2 * spec.tournament_k + 1 + (
        2 if spec.crossover == "two_point" else 0)


def cdf_work(n_isl: int, n: int):
    """(bytes, f32 operations) of the roulette-CDF kernel: the fitness and
    sizes read once and the (I, n) CDF written once; per lane the weight's
    subtract and add, the segment's running sum's add and the carry's
    add."""
    return 4 * n_isl * n + 4 * n_isl + 4 * n_isl * n, 4 * n_isl * n


def float_generation_work(seed, size, fit, spec, consts, n_isl: int,
                          n: int):
    """(bytes, int32 operations, f32 operations) that one float generation
    kernel call (untiled, or the tiled kernel, which draws the same plan)
    needs on these inputs. The gated rows and the mutation hits (each a
    Box-Muller draw) are read from the plain version's draws on the same
    counters."""
    from repro_torch import rand
    from repro_torch.kernels.ga import common
    if spec.selection != "tournament":
        raise ValueError("the bound is derived for tournament selection")
    length, children = spec.length, n - spec.elite
    gated = int(common.selection_plan(seed, fit, size, spec,
                                      n).gate.sum().item())
    k0 = seed[:, 0].reshape(-1, 1, 1)
    k1 = seed[:, 1].reshape(-1, 1, 1)
    hits = int(rand.bernoulli(k0, k1, (children, length), spec.mutation_rate,
                              common.SALT_MUTATE).sum().item())
    genes = n_isl * children * length
    draws = (n_isl * children * plan_draws(spec) + genes
             + (gated * length if spec.crossover != "two_point" else 0))
    int_ops = draws * THREEFRY_OPS + hits * THREEFRY2_OPS + genes * GENE_OPS
    f32_ops = (hits * NORMAL_F32 + genes * CLIP_F32
               + (gated * length * BLEND_F32
                  if spec.crossover == "blend" else 0))
    # the population in and out, the seed words and sizes, the fitness in,
    # and a fused fitness out
    nbytes = (2 * 4 * n_isl * n * length + 2 * 8 * n_isl + 4 * n_isl
              + 4 * n_isl * n + (4 * n_isl * n if spec.fused_eval else 0))
    ev = spec.eval_spec or {}
    if ev.get("eval") == "f15":
        groups, m = int(ev["n_groups"]), int(ev["m"])
        f32_ops += n_isl * n * (groups * m * m * 2 + length * F15_GENE_F32)
        nbytes += consts_bytes(consts)
    return nbytes, int_ops, f32_ops


def consts_bytes(consts) -> int:
    return sum(t.numel() * t.element_size() for t in consts.values())


def f15_work(consts, rows: int):
    """(bytes, f32 operations) of the F15 kernel on ``rows`` rows: the
    population read once, the constants once, the values written once;
    the rotation's multiply-adds (two operations each) and the per-gene
    work."""
    groups, m, _ = consts["M"].shape
    dim = groups * m
    nbytes = rows * dim * 4 + consts_bytes(consts) + rows * 4
    return nbytes, rows * (groups * m * m * 2 + dim * F15_GENE_F32)


def bound_of(nbytes: int, int_ops: int = 0, f32_ops: int = 0,
             bf16_ops: int = 0, tf32_ops: int = 0):
    """(bound in ms, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over their rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (int_ops / INT32_OPS_PER_S + f32_ops / F32_OPS_PER_S
             + bf16_ops / BF16_OPS_PER_S + tf32_ops / TF32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def build_report(source: str):
    """(the build log's header of ``source``, with its compile time, and
    [(template arguments, ptxas's register and spill lines)] of each kernel
    compiled from it), or None when the library was built before this
    run."""
    from repro_torch import _build
    entry = next((e for e in _build.BUILD_LOG
                  if e.startswith(f"== {source} ")), None)
    if entry is None:
        return None
    out, arg, spill = [], None, ""
    for line in entry.splitlines():
        if "Compiling entry function" in line:
            arg = ",".join(re.findall(r"Li(\d+)E", line)) or "?"
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and arg is not None:
            out.append((arg, f"{line.split(':', 1)[1].strip()}; {spill}"))
    return entry.splitlines()[0], out


def f15_term_instructions():
    """(instructions per Rastrigin term in the F15 kernel's SASS, the terms
    counted), by ``cuobjdump -sass`` of the kernel's object: the fast path
    (each ``@!P`` branch forward taken, so the slow argument reduction is
    skipped) from the first multiply by f32(2 pi) that starts a cosf (a
    multiply by 2 / pi next) until every cosf begun on it has reached its
    term's last add (+ 10), over the cosf begun; the compiler interleaves a
    micro-tile's terms. None where the tool, the object or the pattern is
    missing."""
    from repro_torch import _build
    obj = _build.BUILD_DIR / f"f15-{_build.library_path().stem}.o"
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not (obj.exists() and os.path.exists(tool)):
        return None
    sass = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                          text=True).stdout
    body = next((sec for sec in sass.split("Function : ")[1:]
                 if "f15_kernel" in sec.split("\n", 1)[0]), "")
    ops = [(int(a, 16), ins.split()) for a, ins in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", body)]
    at = {a: i for i, (a, _) in enumerate(ops)}

    def starts_cos(i):
        return (ops[i][1][0] == "FMUL"
                and any(t.startswith("6.28318548") for t in ops[i][1])
                and any(any(t.startswith("0.63661974") for t in nxt)
                        for _, nxt in ops[i + 1:i + 3]))

    k = next((i for i in range(len(ops)) if ops[i][1] and starts_cos(i)),
             None)
    if k is None:
        return None
    n = begun = ended = 0
    while k < len(ops) and n < 5000:
        addr, ins = ops[k]
        n += 1
        pred = ins[0] if ins[0].startswith("@") else ""
        op = ins[1] if pred else ins[0]
        begun += any(t.startswith("0.63661974") for t in ins)
        ended += op == "FADD" and ins[-1] == "10"
        if begun and ended == begun:
            break
        target = (int(ins[-1], 16) if op.startswith("BRA")
                  and ins[-1].startswith("0x") else -1)
        k = (at[target] if pred.startswith("@!") and target > addr
             and target in at else k + 1)
    if not begun or ended != begun:
        return None
    return round(n / begun), begun


def step_profile(tag: str, islands, problem, cfg, steps: int = 20,
                 kernel: str = ""):
    """Where a generation's time goes: its CUDA kernels (profiler) against
    the wall time of the same steps run unprofiled, and the device time of
    the kernels whose name holds ``kernel`` on a line of its own."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import island as island_lib

    def generations(state):
        for _ in range(steps):
            state = island_lib.generation_step(state, problem, cfg)
        torch.cuda.synchronize()

    generations(islands)
    t = time.perf_counter()
    generations(islands)
    step_wall_us = (time.perf_counter() - t) / steps * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        generations(islands)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    log(f"[{tag}] generation step: {step_wall_us:.1f} us wall per "
        f"generation (unprofiled, {steps} steps)")
    if not dev_events:
        log(f"[{tag}] device kernels per generation: not measured (the "
            "profiler saw no device events)")
        return
    busy_us = sum(e.device_time for e in dev_events) / steps
    by_name = {}
    for e in dev_events:
        cnt, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (cnt + 1, us + e.device_time)
    log(f"[{tag}] device kernels per generation: "
        f"{len(dev_events) / steps}; device busy {busy_us:.1f} us per "
        f"generation = {busy_us / step_wall_us:.3f} of the wall time")
    if kernel:
        own = [(cnt, us) for name, (cnt, us) in by_name.items()
               if kernel in name]
        log(f"[{tag}] {kernel}: "
            f"{sum(us for _, us in own) / steps:.2f} us per generation, "
            f"{sum(cnt for cnt, _ in own) / steps} launches per generation "
            f"(profiled)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (cnt, us) in top:
        log(f"[{tag}]   {us / steps:9.2f} us/gen  {cnt / steps:6.1f} "
            f"launches/gen  {name[:90]}")
    # the host's side (profiled, so inflated alike on every path): the
    # operators that take the most of its own time
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:6]:
        log(f"[{tag}]   host {e.self_cpu_time_total / steps:9.2f} us/gen "
            f"self  {e.count / steps:6.1f} calls/gen  {e.key[:60]}")


def same_run(tag: str, a, b):
    """Fail unless two (islands, pool, epochs, stats) results are equal."""
    import torch
    for what, x, y in (("islands", a[0], b[0]), ("pool", a[1], b[1]),
                       ("stats", a[3], b[3])):
        for name, u, v in zip(x._fields, x, y):
            if not torch.equal(u, v):
                fail(f"{tag}: {what}.{name} differs between the kernel run "
                     f"and the plain run")
    if int(a[2]) != int(b[2]):
        fail(f"{tag}: epoch counts differ")


def wkv_work(b: int, h: int, seq: int, d: int, chunk: int, elem: int):
    """(bytes, f32 operations, TF32 tensor-core operations) of one WKV call.
    Bytes: r, k, v (B, S, H, D) of ``elem`` bytes each, w read and y
    written in f32, u (H, D) and s0 read and s_out written once. Work, per
    chunk of T tokens and head (K = V = D), in the least form the kernel
    knows, the intra term exact only inside sub-chunks of 8 (ref.SUB). On
    the CUDA cores: 8 per (t, k) for log, cumsum, L_prev, r~ and k^ (a
    transcendental counts one); 5 per (pair, k) for the exact pairs; 3 per
    (row, k) for r and k scaled to each sub-chunk's end; 3TK for the bonus
    diagonal; K exps and KV products for the decay of S. On the tensor
    cores, 2 per multiply-add: r~ S and k^T v (TKV each), a v over its
    lower triangle and diagonal, and a's off-diagonal blocks; each in
    3xTF32 at three TF32 products, two where v is exact in tf32 (bf16)."""
    t, k, sub = chunk, d, 8
    v_passes = 2 if elem == 2 else 3
    n_sub = t // sub
    exact_pairs = n_sub * sub * (sub - 1) // 2
    # rows of a below each sub-chunk q but its last, against its 8 columns
    below = [t - sub * (q + 1) for q in range(n_sub - 1)]
    f32_per = (8 * t * k + 5 * exact_pairs * k
               + 3 * k * sum(rows + sub for rows in below)
               + 3 * t * k + k + k * k)
    tc_per = (3 * 2 * t * k * k                        # r~ S
              + v_passes * 2 * t * k * k               # k^T v
              + v_passes * 2 * (t * (t + 1) // 2) * k  # a v
              + 3 * 2 * sub * sum(below) * k)          # a off the diagonal
    rows = b * seq * h * d
    nbytes = (3 * elem + 2 * 4) * rows + elem * h * d + 2 * 4 * b * h * d * d
    heads_chunks = b * h * (seq // chunk)
    return nbytes, heads_chunks * f32_per, heads_chunks * tc_per


def flash_work(q, k, causal: bool = True):
    """(bytes, operations) of one attention call: q, k, v read once and o
    written once; the two products (2 operations per multiply-add) over the
    visible (row, key) pairs only, S(S + 1) / 2 per head when causal with
    Sq = Sk. The softmax's exps and sums are left out (under 1 % of it)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    nbytes = q.element_size() * (2 * b * sq * h * hd + 2 * b * sk * kv * hd)
    pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
             else sq * sk)
    return nbytes, 4 * b * h * hd * pairs


def wkv_inputs(gen, b, s, h, hd, decays, dev):
    """r, k, v ~ N(0, 1), w = exp(-exp(U(lo, hi))), u ~ 0.5 N(0, 1), s0 ~
    0.1 N(0, 1), as tests/test_kernels.py draws them, in the model's
    layout on the card."""
    import torch
    lo, hi = WKV_DECAYS[decays]
    r, k, v = (torch.randn(b, s, h, hd, generator=gen) for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand(b, s, h, hd, generator=gen)
                             * (hi - lo) + lo))
    u = torch.randn(h, hd, generator=gen) * 0.5
    s0 = torch.randn(b, h, hd, hd, generator=gen) * 0.1
    return [a.to(dev) for a in (r, k, v, w, u, s0)]


def rel_l2(a, b) -> float:
    """||a - b|| / ||b||, in f32."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def randomize_decay_lora(model, gen, layout=None) -> None:
    """Draw ``mix_B``, ``decay_B`` (0.1 N(0, 1)) and ``decay_base``
    (U(-5, 1)) of every layer, as the CPU tests do: the init leaves them
    zero, so a served model would never run the mixing LoRA or a varying
    decay. With ``layout`` (a model of this rank's blocks) each is drawn
    whole and cut to the rank's block, so the blocks are those of the
    one-rank model."""
    import torch
    names = {id(p): n for n, p in model.named_parameters()}
    with torch.no_grad():
        for layer in model.segments[0]:
            tm = layer[0].mixer
            for p, draw in ((tm.mix_B, "normal"), (tm.decay_B, "normal"),
                            (tm.decay_base, "uniform")):
                name = names[id(p)]
                shape = p.shape if layout is None else layout.shapes[name]
                x = torch.empty(shape, dtype=torch.float32, device=p.device)
                if draw == "normal":
                    x.normal_(0.0, 0.1, generator=gen)
                else:
                    x.uniform_(-5.0, 1.0, generator=gen)
                if layout is not None:
                    x = layout.local(name, x)
                p.copy_(x.to(p.dtype))


def device_profile(tag: str, fn, card: str, top: int = 6):
    """Device time of one call of ``fn`` by kernel (profiler), against the
    wall time of the same call unprofiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        log(f"[{tag}] device time: not measured (the profiler saw no "
            f"device events); wall {wall_ms:.3f} ms, {card}")
        return
    by_name = {}
    for e in dev_events:
        cnt, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (cnt + 1, us + e.device_time)
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    log(f"[{tag}] wall {wall_ms:.3f} ms (unprofiled); device busy "
        f"{busy_ms:.3f} ms = {busy_ms / wall_ms:.3f} of it; "
        f"{len(dev_events)} kernels; {card}")
    for name, (cnt, us) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][1])[:top]:
        log(f"[{tag}]   {us / 1e3:9.3f} ms {us / 1e3 / busy_ms:6.3f} of "
            f"busy  {cnt:5d} launches  {name[:90]}")
    copies = [(cnt, us) for name, (cnt, us) in by_name.items()
              if "copy" in name.lower()]
    log(f"[{tag}] copy and cast kernels (names with 'copy'): "
        f"{sum(c for c, _ in copies)} launches, "
        f"{sum(us for _, us in copies) / 1e3:.3f} ms")


def loop_profile(tag: str, step, steps: int, card: str):
    """Device kernels and busy time per call of ``step`` (profiler), the
    calls' wall time measured unprofiled by the caller."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        log(f"[{tag}] device kernels: not measured (the profiler saw no "
            f"device events); {card}")
        return None, None
    return (len(dev_events) / steps,
            sum(e.device_time for e in dev_events) / steps)


def async_phases(problem, f_problem, f_cfg, card: str):
    """Phases 10a-10c: the asynchronous runtime and its durability on the
    card (see the module docstring)."""
    import shutil
    import signal

    import numpy as np
    import torch
    from repro_torch import convert, kernels, rand
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.core import (AsyncConfig, EAConfig, MigrationConfig,
                                  make_f15, make_trap, run_experiment_async,
                                  run_fused, run_fused_async)
    from repro_torch.core.async_migration import async_step
    from repro_torch.core.evolution import epoch_step
    from repro_torch.runtime.elastic import NEVER_CHURN

    def same(tag, a, b, what):
        for name, u, v in zip(a._fields, a, b):
            if not torch.equal(u, v):
                fail(f"{tag}: {what}.{name} differs")

    def same_async(tag, a, b):
        """Two run_fused_async results (islands, pool, ticks, stats,
        astate[, harvest]) equal."""
        for what, i in (("islands", 0), ("pool", 1), ("stats", 3),
                        ("astate", 4)):
            same(tag, a[i], b[i], what)
        if int(a[2]) != int(b[2]):
            fail(f"{tag}: tick counts differ")
        if len(a) > 5 and a[5] != b[5]:
            fail(f"{tag}: the counter ledgers differ: {a[5]} against {b[5]}")

    # ---- 10a: the async runtime at paper-8 width -------------------------
    cfg = EAConfig(impl="pallas", max_pop=256, min_pop=128,
                   generations_per_epoch=100)
    if cfg != dataclasses.replace(EAConfig(), impl="pallas"):
        fail(f"paper-8's configuration is not EAConfig()'s: {cfg}")
    mig = MigrationConfig(topology="pool")
    acfg = AsyncConfig(min_rate=0.25, max_rate=1.0, staleness=3,
                       churn_fraction=0.25)
    ticks = ASYNC_TICKS

    def run(prob, c, n_ticks, a=acfg, **kw):
        t = time.perf_counter()
        out = run_fused_async(prob, c, mig, a, n_islands=8,
                              max_ticks=n_ticks, rng=SEED, w2=True,
                              return_stats=True, return_astate=True,
                              return_obs=True, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    run(problem, cfg, 1)                            # warm-up, not counted
    kernels.reset_launches()
    a_run, a_wall = run(problem, cfg, ticks)
    a_launches = dict(kernels.LAUNCHES)
    if min(a_launches["trap_fitness"], a_launches["generation"]) <= 0:
        fail(f"async paper-8: a kernel of the path never launched: "
             f"{a_launches}")
    a_isl, _, _, a_stats, a_ast, a_obs = a_run
    a_evals = int(a_isl.evaluations.sum())
    fires = a_ast.fires.tolist()
    tot = a_obs["totals"]
    if tot["delivered"] != tot["accepted"] + tot["rejected"] or \
            tot["fired"] > 8 * ticks or not bool(
                torch.isfinite(a_isl.best_fitness).all()):
        fail(f"async paper-8: ledger {tot} or best fitness out of order")
    log(f"[async-main] paper-8 run_fused_async impl=pallas, {acfg}: 8 "
        f"islands x {ticks} ticks: {a_evals} evaluations in {a_wall:.3f} s "
        f"= {a_evals / a_wall:.1f} evals/s; fires per island {fires}; "
        f"churn down-ticks {tot['churn_down']}; launches {a_launches}; "
        f"ledger {tot}")
    kernels.reset_launches()
    t_run, _ = run(problem, dataclasses.replace(cfg, impl="pallas_tiled"),
                   ticks)
    t_launches = dict(kernels.LAUNCHES)
    if t_launches["generation_tiled"] <= 0 or t_launches["generation"]:
        fail(f"async paper-8 tiled: launches {t_launches}")
    same_async("async paper-8 pallas_tiled vs pallas", t_run, a_run)
    kernels.reset_launches()
    r_run, r_wall = run(make_trap(40, 4),
                        dataclasses.replace(cfg, impl="pallas_ref"), ticks)
    if max(kernels.LAUNCHES.values()):
        fail(f"async paper-8 plain run launched {dict(kernels.LAUNCHES)}")
    same_async("async paper-8 pallas_ref vs pallas", r_run, a_run)
    log(f"[async-main] impl=pallas == pallas_tiled == pallas_ref under the "
        f"fire masks (islands, pool, stats, AsyncState, ledger); tiled "
        f"launches {t_launches}; the plain run took {r_wall:.3f} s")
    # the degenerate config is the sync driver
    d_run, _ = run(problem, cfg, 3, a=AsyncConfig())
    s_run = run_fused(problem, cfg, mig, n_islands=8, max_epochs=3,
                      rng=SEED, w2=True, return_stats=True, return_obs=True)
    for what, i in (("islands", 0), ("pool", 1), ("stats", 3)):
        same("degenerate async vs run_fused", d_run[i], s_run[i], what)
    if int(d_run[2]) != int(s_run[2]) or d_run[5] != s_run[4]:
        fail("degenerate async vs run_fused: ticks or ledger differ")
    # the host loop reaches the fused driver's state
    t = time.perf_counter()
    h = run_experiment_async(problem, cfg, mig, acfg, n_islands=8,
                             max_ticks=ticks, rng=SEED, w2=True)
    h_wall = time.perf_counter() - t
    same("run_experiment_async vs run_fused_async", h.islands, a_isl,
         "islands")
    same("run_experiment_async vs run_fused_async", h.pool, a_run[1], "pool")
    same("run_experiment_async vs run_fused_async", h.astate, a_ast,
         "astate")
    a_np = convert.to_numpy(a_stats)
    for row, st in enumerate(h.stats):
        for name in st._fields:
            if getattr(st, name) != getattr(a_np, name)[row]:
                fail(f"run_experiment_async stats row {row} {name} differs "
                     f"from run_fused_async's")
    log(f"[async-main] degenerate AsyncConfig() == run_fused (3 ticks: "
        f"islands, pool, stats, ledger); run_experiment_async == "
        f"run_fused_async (islands, pool, AsyncState, every stats row) in "
        f"{h_wall:.3f} s, total fires {h.total_fires}")
    # paper-f15-8 over 2 ticks: the float kernels under the fire masks
    f_runs = {}
    for impl in ("pallas", "pallas_tiled", "pallas_ref"):
        prob = f_problem if impl != "pallas_ref" else make_f15()
        kernels.reset_launches()
        f_runs[impl], f_wall = run(prob, dataclasses.replace(f_cfg,
                                                             impl=impl), 2)
        f_launches = dict(kernels.LAUNCHES)
        want = {"pallas": ("f15", "generation_float"),
                "pallas_tiled": ("generation_tiled", "f15"),
                "pallas_ref": ()}[impl]
        if any(f_launches[k] <= 0 for k in want) or (
                not want and max(f_launches.values())):
            fail(f"async paper-f15-8 {impl}: launches {f_launches}")
        log(f"[async-f15-main] paper-f15-8 impl={impl}: 8 islands x 2 ticks "
            f"in {f_wall:.3f} s; launches {f_launches}; fires "
            f"{f_runs[impl][4].fires.tolist()}")
    for impl in ("pallas_tiled", "pallas_ref"):
        same_async(f"async paper-f15-8 {impl} vs pallas", f_runs[impl],
                   f_runs["pallas"])
    log("[async-f15-main] impl=pallas == pallas_tiled == pallas_ref "
        "(islands, pool, stats, AsyncState, ledger)")

    # one epoch of [main] against one tick of [async-main], in turns
    def loop(async_rt):
        st = {"isl": a_isl, "pool": a_run[1], "ast": a_ast,
              "key": rand.key(SEED + 7, device=a_isl.pop.device),
              "t": torch.tensor(ticks, dtype=torch.int32,
                                device=a_isl.pop.device)}

        def step():
            st["key"], k = rand.split(st["key"], 2)
            st["t"] = st["t"] + 1
            if async_rt:
                st["isl"], st["pool"], st["ast"] = async_step(
                    st["isl"], st["pool"], st["ast"], k, problem, cfg, mig,
                    acfg, True, tick=st["t"])
            else:
                st["isl"], st["pool"] = epoch_step(
                    st["isl"], st["pool"], k, problem, cfg, mig, True,
                    epoch=st["t"])
        return st, step

    loops = {"main": loop(False), "async-main": loop(True)}
    walls = {k: [] for k in loops}
    evals = {k: 0 for k in loops}
    fired = {k: 0 for k in loops}
    for tag in ("main", "async-main", "async-main", "main"):
        st, step = loops[tag]
        e0, f0 = int(st["isl"].evaluations.sum()), int(st["ast"].fires.sum())
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(PROFILE_TICKS):
            step()
        torch.cuda.synchronize()
        walls[tag].append((time.perf_counter() - t) / PROFILE_TICKS)
        evals[tag] += int(st["isl"].evaluations.sum()) - e0
        fired[tag] += (int(st["ast"].fires.sum()) - f0 if tag != "main"
                       else 8 * PROFILE_TICKS)
    for tag in ("main", "async-main"):
        wall_s = sum(walls[tag]) / len(walls[tag])
        n_steps = 2 * PROFILE_TICKS
        rate = evals[tag] / (wall_s * n_steps)
        per, busy = loop_profile(tag, loops[tag][1], 1, card)
        unit = "epoch" if tag == "main" else "tick"
        if per is None:
            continue
        log(f"[{tag}] in turns (main, async, async, main; {PROFILE_TICKS} "
            f"{unit}s each): {per:.0f} device kernels per {unit} "
            f"({per / cfg.generations_per_epoch:.1f} per generation); "
            f"{fired[tag] / n_steps:.2f} fires per {unit}; device busy "
            f"{busy:.1f} us of {wall_s * 1e6:.1f} us wall per {unit} = "
            f"{busy / (wall_s * 1e6):.3f}; {rate:.1f} evals/s "
            f"({evals[tag] / max(fired[tag], 1):.0f} evaluations per fired "
            f"island-epoch); {card}")

    # ---- 10b: durability on the card -------------------------------------
    snaps = os.path.join(ROOT, "build", "chip_smoke_snapshots")
    shutil.rmtree(snaps, ignore_errors=True)
    seg_cfg = dict(n_islands=8, rng=SEED, w2=True, return_stats=True,
                   return_obs=True)
    mono = run_fused(problem, cfg, mig, max_epochs=4, **seg_cfg)
    segd = run_fused(problem, cfg, mig, max_epochs=4, snapshot_every=2,
                     snapshot_dir=os.path.join(snaps, "sync"), **seg_cfg)
    for what, i in (("islands", 0), ("pool", 1), ("stats", 3)):
        same("segmented run_fused vs one segment", segd[i], mono[i], what)
    a_mono, _ = run(problem, cfg, 4)
    a_seg, _ = run(problem, cfg, 4, snapshot_every=2,
                   snapshot_dir=os.path.join(snaps, "async"))
    same_async("segmented run_fused_async vs one segment", a_seg, a_mono)
    log(f"[durable] snapshot_every=2: segmented == one segment, sync and "
        f"async (4 epochs/ticks at paper-8); snapshots "
        f"{sorted(os.listdir(os.path.join(snaps, 'async')))}")
    # kill -9 after the second snapshot lands, then --resume
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH"))
        if p))
    kill_dir = os.path.join(snaps, "killed")
    cmd = [sys.executable, "-m", "repro_torch.launch.evolve", "ea",
           "--problem", "trap", "--islands", "8",
           "--epochs", str(KILL_TICKS), "--impl", "pallas", "--fused",
           "--runtime", "async", "--churn", "0.25", "--w2",
           "--snapshot-every", "2", "--snapshot-dir", kill_dir]
    t = time.perf_counter()
    child = subprocess.Popen(cmd, env=env, cwd=ROOT,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE)
    second = os.path.join(kill_dir, "step_00000004")
    while not os.path.isdir(second) and child.poll() is None and \
            time.perf_counter() - t < 600:
        time.sleep(0.02)
    if child.poll() is not None:
        fail(f"the child ended (rc {child.returncode}) before it was "
             f"killed: {child.stderr.read()[-2000:]}")
    child.send_signal(signal.SIGKILL)
    child.wait()
    child.stderr.close()
    left = sorted(os.listdir(kill_dir))
    proc = subprocess.run(cmd + ["--resume"], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=600)
    if proc.returncode != 0:
        fail(f"--resume: rc {proc.returncode}: {proc.stderr[-2000:]}")
    # the command's run in this process, uninterrupted: make_problem
    # ("trap") is trap 40x4 with its plain fitness, seed 0; W² keeps the
    # run going to its last tick (without it paper-8 stops at tick 4)
    whole = os.path.join(snaps, "whole")
    run_fused_async(make_trap(40, 4), cfg, mig, acfg, n_islands=8,
                    max_ticks=KILL_TICKS, rng=0, w2=True, snapshot_every=2,
                    snapshot_dir=whole)
    last = latest_step(whole)
    got, want = restore(kill_dir), restore(whole)
    if latest_step(kill_dir) != last or sorted(got) != sorted(want) or any(
            not np.array_equal(got[k], want[k]) for k in want):
        fail("kill -9 + --resume: the resumed run's final snapshot differs "
             "from the uninterrupted run's")
    log(f"[durable] ea --fused --runtime async --w2 --snapshot-every 2, "
        f"{KILL_TICKS} ticks, killed "
        f"by SIGKILL after step 4 landed (left {left}), then --resume in a "
        f"fresh process: final snapshot (step {last}, "
        f"{len(want)} leaves) == the uninterrupted run's, in "
        f"{time.perf_counter() - t:.1f} s; {proc.stdout.strip()}")
    # an elastic resume: 12 islands from the 8-island async snapshot
    g = run_fused_async(problem, cfg, mig, acfg, n_islands=12, max_ticks=8,
                        rng=SEED, w2=True, return_stats=True,
                        return_astate=True, return_obs=True,
                        snapshot_dir=os.path.join(snaps, "async"),
                        resume=True)
    g_ast, g_obs = g[4], g[5]
    if g[0].pop.shape[0] != 12 or int(g[2]) != 8 or \
            sorted(g[0].uuid.tolist()) != list(range(12)) or \
            g_ast.down_start[8:].tolist() != [NEVER_CHURN] * 4 or \
            any(g_obs["churn_down"][8:]) or min(g_ast.fires[8:].tolist()) \
            <= 0:
        fail(f"elastic resume at 12: uuids {g[0].uuid.tolist()}, down "
             f"{g_ast.down_start.tolist()}, fires {g_ast.fires.tolist()}")
    log(f"[durable] resume at 12 islands from the 8-island snapshot (tick "
        f"4 -> 8): joiners uuids 8-11, never down (down_start "
        f"{NEVER_CHURN}), fires {g_ast.fires.tolist()}, rate "
        f"{[round(x, 6) for x in g_ast.rate.tolist()]}")
    shutil.rmtree(snaps, ignore_errors=True)

    # ---- 10c: the ea command with --runtime async, on the card -----------
    for extra, pattern in (
            ([], r"success=(True|False) evals_to_solution=(None|\d+) "
                 r"wall=\d+\.\ds fires=\d+"),
            (["--fused"], r"final best=[0-9.]+ epochs=[12]")):
        cmd = [sys.executable, "-m", "repro_torch.launch.evolve", "ea",
               "--problem", "trap", "--islands", "8", "--epochs", "2",
               "--runtime", "async"] + extra
        t = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              cwd=ROOT, timeout=600)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines or not re.fullmatch(
                pattern, lines[-1]):
            fail(f"ea --runtime async {extra}: rc {proc.returncode}, "
                 f"stdout {lines[-3:]}, stderr {proc.stderr[-2000:]}")
        log(f"[ea] {' '.join(cmd[3:])}: rc 0 in "
            f"{time.perf_counter() - t:.1f} s; {' | '.join(lines[-3:])}")


class SlowServer:
    """A test double of the host pool server: each verb sleeps
    ``SLOW_VERB_S`` before the in-process PoolServer answers, as a slow
    network would."""

    VERBS = ("put", "get_random", "get_since", "get_best", "reset", "stats")

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name not in self.VERBS:
            return attr

        def slow(*args, **kw):
            time.sleep(SLOW_VERB_S)
            return attr(*args, **kw)
        return slow


def host_phases(paths, card: str, device=None):
    """Phases 11a-11d: the host and server tier (see the module
    docstring). ``paths``: (tag, kernel problem, plain problem, EAConfig,
    epochs) of paper-8, then paper-f15-8; 11b and 11c run the first.
    ``device`` None is the card."""
    import asyncio
    import shutil
    import signal
    import threading
    import urllib.request

    import numpy as np
    import torch
    from repro_torch import kernels, rand
    from repro_torch.core import (AsyncConfig, AsyncHostBridge, HostBridge,
                                  MigrationConfig, PoolServer, make_trap,
                                  run_experiment)
    from repro_torch.core import pool as pool_lib
    from repro_torch.core.async_migration import async_step, init_async_state
    from repro_torch.core.evolution import epoch_step
    from repro_torch.core.island import init_islands
    from repro_torch.server import AsyncWireClient, RemotePoolServer, wire

    def sync():
        if device is None:
            torch.cuda.synchronize()

    problem, cfg = paths[0][1], paths[0][3]
    mig = MigrationConfig(topology="pool")

    def bridged(prob, c, epochs, bridge, server=None):
        """run_experiment at paper-8 width with ``bridge``; the device
        pool down for BRIDGE_DOWN epochs, and ``server`` (in process)
        killed for them too."""
        def up(epoch):
            alive = epoch not in BRIDGE_DOWN
            if server is not None:
                server.revive() if alive else server.kill()
            return alive
        sync()
        t = time.perf_counter()
        res = run_experiment(prob, c, mig, n_islands=8, max_epochs=epochs,
                             rng=SEED, w2=True, server_up=up,
                             host_bridge=bridge, device=device)
        sync()
        return res, time.perf_counter() - t

    def entries_of(srv):
        if isinstance(srv, PoolServer):
            srv.revive()
        got, _, _ = srv.get_since(-1, limit=1 << 20)
        return [(e.seq, e.uuid, e.fitness, e.genome.tobytes())
                for e in got]

    def server_stats(srv):
        st = srv.stats()
        return {k: st[k] for k in ("size", "puts", "rejected", "experiment",
                                   "best_fitness")}

    def same_bridged(tag, a, b):
        (ra, ba, sa), (rb, bb, sb) = a, b
        for what, x, y in (("islands", ra.islands, rb.islands),
                           ("pool", ra.pool, rb.pool)):
            for name, u, v in zip(x._fields, x, y):
                if not torch.equal(u, v):
                    fail(f"{tag}: {what}.{name} differs")
        if ra.epochs != rb.epochs or len(ra.stats) != len(rb.stats) or any(
                not all(np.array_equal(u, v) for u, v in zip(p, q))
                for p, q in zip(ra.stats, rb.stats)):
            fail(f"{tag}: the stats rows differ")
        if ba.stats() != bb.stats():
            fail(f"{tag}: bridge counts {ba.stats()} against {bb.stats()}")
        if sa != sb:
            fail(f"{tag}: the servers' entries or stats differ")

    # ---- 11a: the bridged host loop at paper-8 width ----------------------
    for tag, k_problem, p_problem, c0, epochs in paths:
        wanted = ({"pallas": ("generation_float", "f15"),
                   "pallas_tiled": ("generation_tiled", "f15")}
                  if k_problem.genome.kind == "float" else
                  {"pallas": ("trap_fitness", "generation"),
                   "pallas_tiled": ("generation_tiled",)})
        runs = {}
        for impl in ("pallas", "pallas_tiled", "pallas_ref"):
            server = PoolServer(capacity=256, seed=8191 * WIRE_SEED)
            bridge = HostBridge(server, pull=4)
            kernels.reset_launches()
            res, wall = bridged(p_problem if impl == "pallas_ref"
                                else k_problem,
                                dataclasses.replace(c0, impl=impl), epochs,
                                bridge, server)
            launches = dict(kernels.LAUNCHES)
            want = wanted.get(impl, ())
            if any(launches[k] <= 0 for k in want) or (
                    not want and max(launches.values())) or (
                    impl == "pallas_tiled" and launches["generation"]
                    + launches["generation_float"]):
                fail(f"bridged {tag} {impl}: launches {launches}")
            st = bridge.stats()
            if st["lost"] <= 0 or st["pulled"] <= 0 or st["pushed"] <= 0:
                fail(f"bridged {tag} {impl}: bridge counts {st}")
            runs[impl] = (res, bridge,
                          (entries_of(server), server_stats(server)))
            log(f"[bridge] {tag} run_experiment impl={impl}, HostBridge("
                f"PoolServer(capacity=256, seed={8191 * WIRE_SEED}), pull=4)"
                f", server and device pool down epochs {BRIDGE_DOWN}: 8 "
                f"islands x {res.epochs} epochs in {wall:.3f} s; bridge "
                f"{st}; server {server_stats(server)}; launches {launches}")
        for impl in ("pallas_tiled", "pallas_ref"):
            same_bridged(f"bridged {tag} {impl} vs pallas", runs[impl],
                         runs["pallas"])
        log(f"[bridge] {tag}: impl=pallas == pallas_tiled == pallas_ref "
            f"(islands, pool, stats rows, bridge counts, the server's "
            f"entries and stats)")
        if k_problem is problem:
            main_run = runs["pallas"]

    # ---- 11b: over the wire --------------------------------------------
    spool = os.path.join(ROOT, "build", "chip_smoke_spool")
    shutil.rmtree(spool, ignore_errors=True)
    os.makedirs(spool)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH"))
        if p))
    children, logs = [], []

    def start_server(port=0, resume=False):
        logs.append(open(os.path.join(spool, f"server{len(logs)}.err"), "w"))
        child = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.server", "--port", str(port),
             "--spool", spool] + (["--resume"] if resume else []),
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=logs[-1],
            text=True)
        children.append(child)
        line = child.stdout.readline()
        m = re.search(r"listening on (http://\S+)", line)
        if not m:
            fail(f"python -m repro_torch.server did not start: {line!r}")
        return child, m.group(1)

    try:
        child, url = start_server()
        admin = RemotePoolServer(url, experiment="bridge",
                                 client_id="chip-admin")
        admin.create(capacity=256, shards=1, seed=WIRE_SEED)
        local = PoolServer(capacity=256, seed=8191 * WIRE_SEED)
        l_bridge = HostBridge(local, pull=4)
        l_res, l_wall = bridged(problem, cfg, BRIDGE_EPOCHS, l_bridge)
        w_bridge = HostBridge(url, pull=4, experiment="bridge")
        w_res, w_wall = bridged(problem, cfg, BRIDGE_EPOCHS, w_bridge)
        same_bridged("wire-bridged paper-8 vs in-process",
                     (w_res, w_bridge, (entries_of(admin),
                                        server_stats(admin))),
                     (l_res, l_bridge, (entries_of(local),
                                        server_stats(local))))
        w_bridge.server.close()
        log(f"[wire] paper-8 bridged over the wire (python -m "
            f"repro_torch.server, experiment seed {WIRE_SEED}, one shard) "
            f"== in process (PoolServer(seed={8191 * WIRE_SEED})): islands, "
            f"pool, stats rows, bridge {w_bridge.stats()}, the server's "
            f"{len(entries_of(admin))} entries and stats; {w_wall:.3f} s "
            f"against {l_wall:.3f} s in process")

        # the async host loop, 256 wire volunteers, a SIGKILL and --resume
        admin.experiment = "volunteers"
        admin.create(capacity=1024, shards=2, seed=WIRE_SEED)
        port = int(url.rsplit(":", 1)[1])
        vol_problem = make_trap(40, 4)   # the plain version, on the host
        stop = threading.Event()
        vol = {"puts": 0, "lost": 0, "throttled": 0}

        def volunteers():
            async def one(i):
                rng = np.random.default_rng(i)
                c = AsyncWireClient(url, experiment="volunteers",
                                    client_id=f"volunteer-{i}", timeout=5.0)
                try:
                    while not stop.is_set():
                        items = await c.get_random(1)
                        g = (wire.decode_genome(items[0]).copy() if items
                             else rng.integers(0, 2, 160).astype(np.int8))
                        g[rng.integers(0, g.size, 4)] = 1  # hill-climb
                        f = float(vol_problem.evaluate(
                            vol_problem.consts, torch.from_numpy(g[None]))[0])
                        if await c.put_batch([(g, f, 1000 + i)]) is not None:
                            vol["puts"] += 1
                        await asyncio.sleep(VOLUNTEER_PAUSE_S)
                finally:
                    vol["lost"] += c.lost
                    vol["throttled"] += c.throttled
                    await c.aclose()

            async def fleet():
                await asyncio.gather(*(one(i) for i in range(VOLUNTEERS)))
            asyncio.run(fleet())

        fleet = threading.Thread(target=volunteers, daemon=True)
        fleet.start()
        acfg = AsyncConfig(min_rate=0.25, max_rate=1.0, staleness=3,
                           churn_fraction=0.25)
        dev = torch.device("cuda") if device is None else torch.device(
            device)
        k_init, key = rand.split(rand.key(SEED, device=dev), 2)
        islands = init_islands(k_init, 8, problem, cfg, device=dev)
        pool = pool_lib.pool_init(mig.pool_capacity, problem.genome,
                                  device=dev)
        astate = init_async_state(rand.fold_in(k_init, 7), 8, acfg,
                                  WIRE_TICKS, problem.genome)
        bridge = AsyncHostBridge(url, pull=64, cursor_id="chip-bridge",
                                 experiment="volunteers")
        seen, drained, inner = [], {"n": 0, "dropped": 0, "cursor": None}, \
            bridge.server.get_since

        def recording(seq, limit=64, cursor_id=None):
            got, cursor, dropped = inner(seq, limit=limit,
                                         cursor_id=cursor_id)
            seen.extend((e.shard, e.seq) for e in got)
            drained["n"] += len(got)
            drained["dropped"] += dropped
            drained["cursor"] = list(cursor)
            return got, cursor, dropped
        bridge.server.get_since = recording
        sync_ms = []
        t_run = time.perf_counter()
        for t in range(1, WIRE_TICKS + 1):
            key, k = rand.split(key, 2)
            islands, pool, astate = async_step(
                islands, pool, astate, k, problem, cfg, mig, acfg, True,
                tick=t)
            if t == WIRE_KILL[1]:
                # no drain in flight while the server comes back
                pool = bridge.flush(pool)
                child, url2 = start_server(port, resume=True)
                if url2 != url:
                    fail(f"the resumed server listens on {url2}, not {url}")
            sync()
            t0 = time.perf_counter()
            pool = bridge.sync(pool, t)
            sync_ms.append((time.perf_counter() - t0) * 1e3)
            if t == WIRE_KILL[0]:
                pool = bridge.flush(pool)    # nothing in flight at the kill
                child.send_signal(signal.SIGKILL)
                child.wait()
        pool = bridge.flush(pool)
        sync()
        run_s = time.perf_counter() - t_run
        stop.set()
        fleet.join(timeout=60)
        pool = bridge.flush(bridge.sync(pool, WIRE_TICKS + 1))
        bridge.close()
        st = bridge.stats()
        cursor = drained["cursor"]
        if len(seen) != len(set(seen)):
            fail(f"a (shard, seq) reached the device pool twice: "
                 f"{len(seen) - len(set(seen))} repeats")
        if cursor is None or drained["n"] + drained["dropped"] != sum(
                c + 1 for c in cursor):
            fail(f"the cursor ledger does not balance: {drained['n']} "
                 f"delivered + {drained['dropped']} dropped against cursor "
                 f"{cursor}")
        if st["lost"] <= 0 or st["pulled"] <= 0 or vol["puts"] <= 0 or \
                st["dropped"] != drained["dropped"]:
            fail(f"wire async run: bridge {st}, volunteers {vol}")
        if fleet.is_alive():
            fail("the volunteers' thread did not stop")
        with urllib.request.urlopen(f"{url}/metricz?format=json",
                                    timeout=10) as resp:
            metricz = json.loads(resp.read())
        lat = {v: (round(d["p50_ms"], 3), round(d["p99_ms"], 3), d["count"])
               for v, d in metricz["latency"].items()}
        log(f"[wire] run_experiment_async's loop, {WIRE_TICKS} ticks at "
            f"paper-8 width, AsyncHostBridge(url, pull=64, cursor_id) + "
            f"{VOLUNTEERS} AsyncWireClient volunteers (GET, hill-climb on "
            f"the host CPU, PUT, {VOLUNTEER_PAUSE_S} s pause) against 2 "
            f"shards; server SIGKILLed after tick {WIRE_KILL[0]}, restarted "
            f"with --resume on port {port} before tick {WIRE_KILL[1]}'s "
            f"sync: {run_s:.3f} s; bridge {st}; volunteers {vol}; "
            f"{len(seen)} (shard, seq) delivered, none twice; cursor "
            f"{cursor}: {drained['n']} delivered + {drained['dropped']} "
            f"dropped = {sum(c + 1 for c in cursor)} seqs covered; sync "
            f"calls max {max(sync_ms):.3f} ms")
        log(f"[wire] /metricz after the restart (p50 ms, p99 ms, count): "
            f"{lat}; {card}")
    finally:
        for c in children:
            if c.poll() is None:
                c.send_signal(signal.SIGTERM)
                try:
                    c.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    c.kill()
                    c.wait()
            c.stdout.close()
        for f in logs:
            f.close()

    # ---- 11c: [bridge-main], and a bridge against a slow server ----------
    islands0, pool0 = main_run[0].islands, main_run[0].pool

    def loop(bridge):
        st = {"isl": islands0, "pool": pool0, "e": BRIDGE_EPOCHS,
              "key": rand.key(SEED + 11, device=islands0.pop.device)}

        def step():
            st["key"], k = rand.split(st["key"], 2)
            st["e"] += 1
            st["isl"], st["pool"] = epoch_step(
                st["isl"], st["pool"], k, problem, cfg, mig, True,
                epoch=st["e"])
            if bridge is not None:
                st["pool"] = bridge.sync(st["pool"], st["e"])
        return st, step

    def host_reads(step):
        import warnings
        sync()
        if device is not None:
            step()
            return None
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message).lower() for w in caught)

    loops = {"main": loop(None), "bridge-main": loop(
        HostBridge(PoolServer(capacity=256, seed=1), pull=4))}
    walls = {k: [] for k in loops}
    for tag in ("main", "bridge-main", "bridge-main", "main"):
        _, step = loops[tag]
        sync()
        t = time.perf_counter()
        for _ in range(PROFILE_TICKS):
            step()
        sync()
        walls[tag].append((time.perf_counter() - t) / PROFILE_TICKS)
    reads = {tag: host_reads(loops[tag][1]) for tag in loops}
    for tag in loops:
        wall_s = sum(walls[tag]) / len(walls[tag])
        per, busy = (loop_profile(tag, loops[tag][1], 1, card)
                     if device is None else (None, None))
        log(f"[{tag}] in turns (main, bridge, bridge, main; "
            f"{PROFILE_TICKS} epochs each): wall {wall_s * 1e3:.3f} ms per "
            f"epoch; "
            + (f"{per:.0f} device kernels, busy {busy:.1f} us = "
               f"{busy / (wall_s * 1e6):.3f} of the wall; "
               if per is not None else "device kernels not measured; ")
            + f"host reads (synchronizing calls) per epoch {reads[tag]}; "
            f"{card}")
    # a server whose every verb takes SLOW_VERB_S: the async bridge's sync
    # never waits on it, the blocking bridge's epoch grows
    slow_async = AsyncHostBridge(SlowServer(PoolServer(capacity=256,
                                                       seed=1)), pull=4)
    slow_sync = HostBridge(SlowServer(PoolServer(capacity=256, seed=1)),
                           pull=4)
    grow = {}
    for tag, bridge in (("async", slow_async), ("sync", slow_sync)):
        st, step = loop(bridge)
        calls = []
        for _ in range(SLOW_EPOCHS):
            st["key"], k = rand.split(st["key"], 2)
            st["e"] += 1
            st["isl"], st["pool"] = epoch_step(
                st["isl"], st["pool"], k, problem, cfg, mig, True,
                epoch=st["e"])
            sync()
            t0 = time.perf_counter()
            st["pool"] = bridge.sync(st["pool"], st["e"])
            calls.append((time.perf_counter() - t0) * 1e3)
        grow[tag] = calls
    slow_async.flush(pool0)
    slow_async.close()
    if max(grow["async"]) >= SLOW_SYNC_MAX_MS:
        fail(f"AsyncHostBridge.sync waited on a slow server: "
             f"{grow['async']} ms")
    log(f"[bridge-slow] every verb sleeps {SLOW_VERB_S * 1e3:.0f} ms: "
        f"AsyncHostBridge.sync {[round(x, 3) for x in grow['async']]} ms "
        f"(longest under {SLOW_SYNC_MAX_MS} ms), HostBridge.sync "
        f"{[round(x, 3) for x in grow['sync']]} ms added to each epoch "
        f"(bridge {slow_sync.stats()}); {card}")

    # ---- 11d: the commands ----------------------------------------------
    trace = os.path.join(spool, "trace.json")
    obs = os.path.join(spool, "obs.json")
    dev_flag = [] if device is None else ["--device", device]
    for args, pattern in (
            (["repro_torch.launch.evolve", "ea", "--problem", "trap",
              "--islands", "8", "--epochs", "2", "--bridge"] + dev_flag,
             r"success=.* bridge=\{'pushed': \d+, 'pulled': \d+, "
             r"'lost': \d+\}"),
            (["repro_torch.launch.evolve", "ea", "--problem", "trap",
              "--islands", "8", "--epochs", "2", "--bridge", "--runtime",
              "async"] + dev_flag,
             r"success=.* bridge=\{.*'dropped': \d+\} fires=\d+"),
            (["repro_torch.launch.volunteer_sim"] + dev_flag,
             r"  worker 3: work_scale=0\.\d+ <- straggler.*"),
            (["repro_torch.launch.volunteer_sim", "--runtime", "async",
              "--churn", "0.4", "--ticks", "10", "--trace", trace,
              "--obs-json", obs] + dev_flag,
             r"wrote Chrome trace \(\d+ events\) -> .*"),
            (["repro_torch.obs", trace, "--obs", obs],
             r"  delivery_rate=.*")):
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m"] + args,
                              capture_output=True, text=True, env=env,
                              cwd=ROOT, timeout=600)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines or not re.fullmatch(
                pattern, lines[-1]):
            fail(f"python -m {' '.join(args)}: rc {proc.returncode}, stdout "
                 f"{lines[-3:]}, stderr {proc.stderr[-2000:]}")
        log(f"[host-cmd] python -m {' '.join(args[:1] + args[1:4])} ...: rc "
            f"0 in {time.perf_counter() - t:.1f} s; {' | '.join(lines[-2:])}")
    shutil.rmtree(spool, ignore_errors=True)


def _digest(tree) -> str:
    """sha256 of every tensor of a (nested) result, in order."""
    import hashlib

    import torch
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, torch.Tensor):
            h.update(str((x.dtype, tuple(x.shape))).encode())
            h.update(x.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
        elif isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                walk(x[k])
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        else:
            h.update(repr(x).encode())
    walk(tree)
    return h.hexdigest()


def _first_difference(a, b, path="") -> str:
    """The first field where two results differ ('' when none)."""
    import torch
    if isinstance(a, torch.Tensor):
        return "" if torch.equal(a, b) and a.dtype == b.dtype else path
    if isinstance(a, dict):
        for k in a:
            d = _first_difference(a[k], b[k], f"{path}.{k}")
            if d:
                return d
        return ""
    if isinstance(a, (tuple, list)):
        names = getattr(a, "_fields", range(len(a)))
        for n, u, v in zip(names, a, b):
            d = _first_difference(u, v, f"{path}.{n}")
            if d:
                return d
        return ""
    return "" if a == b else path


def _sharded_rank_12a(group, kill_epochs, whole_dir):
    """Phase 12a on one rank of the card's shared world (see the module
    docstring): the three drivers under the kernels and the plain
    versions, the other topologies, paper-f15-8, [main] and [sharded]
    epochs in turns, and the uninterrupted run of 12c's command."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import (AcceptanceConfig, AsyncConfig, EAConfig,
                                  MigrationConfig, make_f15, make_problem,
                                  make_trap, run_fused)
    from repro_torch.core.sharded import (run_fused_sharded,
                                          run_fused_sharded_async,
                                          run_sharded)
    per = 8 // group.world
    mig = MigrationConfig(topology="pool")
    acfg = AsyncConfig(min_rate=0.25, max_rate=1.0, staleness=3,
                       churn_fraction=0.25)
    paper = dict(max_pop=256, min_pop=128, generations_per_epoch=100)
    cfg = {i: EAConfig(impl=i, **paper) for i in ("pallas", "pallas_ref")}
    trap = {"pallas": make_trap(40, 4, impl="pallas"),
            "pallas_ref": make_trap(40, 4)}
    out = {"rank": group.rank, "backend": group.name, "runs": {}}

    def timed(fn):
        torch.cuda.synchronize()
        group.barrier()
        calls, host = group.calls, group.host_s
        kernels.reset_launches()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return res, {"wall": wall, "calls": group.calls - calls,
                     "host_s": group.host_s - host,
                     "launches": dict(kernels.LAUNCHES)}

    def record(tag, res, info, epochs):
        # the collectives of the driver's final gather of the global
        # state: the islands' fields, the counters' and the async rows'
        end = len(res[0]) + sum(len(x) for x in res[4:5]
                                if hasattr(x, "_fields"))
        end += 6 if isinstance(res[-1], dict) else 0
        info.update(digest=_digest(res[:2]), pool=res[1], epochs=epochs,
                    evals=int(res[0].evaluations.sum()), end=end)
        out["runs"][tag] = info
        return res

    drivers = {
        "run_sharded": lambda p, c, t=None, e=SHARD_EPOCHS: run_sharded(
            group, p, c, MigrationConfig(topology=t or "pool"), per, e,
            rng=SEED, w2=True),
        "run_fused_sharded": lambda p, c, t=None, e=SHARD_EPOCHS:
            run_fused_sharded(group, p, c, MigrationConfig(
                topology=t or "pool"), per, e, rng=SEED, w2=True,
                return_stats=True, return_obs=True),
        "run_fused_sharded_async": lambda p, c, t=None, e=SHARD_EPOCHS:
            run_fused_sharded_async(group, p, c, mig, acfg, per, e,
                                    rng=SEED, w2=True, return_stats=True,
                                    return_astate=True, return_obs=True),
    }
    # warm-up (the library's load, the first launches), not recorded
    run_fused_sharded(group, trap["pallas"], cfg["pallas"], mig, per, 1,
                      rng=SEED + 1, w2=True)
    for name, drive in drivers.items():
        k_res, k_info = timed(lambda: drive(trap["pallas"], cfg["pallas"]))
        p_res, p_info = timed(lambda: drive(trap["pallas_ref"],
                                            cfg["pallas_ref"]))
        k_info["same_as_plain"] = _first_difference(k_res, p_res) or "equal"
        k_info["plain_wall"] = p_info["wall"]
        k_info["plain_launches"] = p_info["launches"]
        record(name, k_res, k_info, SHARD_EPOCHS)
    for topo in ("ring", "torus", "random_graph", "broadcast_best"):
        res, info = timed(lambda: drivers["run_fused_sharded"](
            trap["pallas"], cfg["pallas"], topo, 2))
        record(f"topology {topo}", res, info, 2)
    f_cfg = EAConfig(impl="pallas", crossover="blend", mutation_sigma=0.3,
                     **paper)
    res, info = timed(lambda: drivers["run_fused_sharded"](
        make_f15(impl="pallas", device=group.device), f_cfg, None, 2))
    record("paper-f15-8", res, info, 2)
    # [main] (rank 0 alone, 8 islands) and [sharded] epochs in turns
    turns = []
    for tag in ("main", "sharded", "sharded", "main"):
        if tag == "main":
            res, info = timed(lambda: run_fused(
                trap["pallas"], cfg["pallas"], mig, n_islands=8,
                max_epochs=SHARD_TURN_EPOCHS, rng=SEED, w2=True,
                device=group.device) if group.rank == 0 else None)
            group.barrier()
            evals = int(res[0].evaluations.sum()) if res else 0
        else:
            res, info = timed(lambda: run_fused_sharded(
                group, trap["pallas"], cfg["pallas"], mig, per,
                SHARD_TURN_EPOCHS, rng=SEED, w2=True))
            evals = int(res[0].evaluations.sum())
            # the final gather of the islands is not the epochs'
            info["calls"] -= len(res[0])
        turns.append((tag, info["wall"], evals, info["calls"],
                      info["host_s"]))
    out["turns"] = turns
    # 12c's command run here uninterrupted: make_problem("trap") (trap 40x4,
    # the plain fitness), EAConfig(impl="pallas"), seed 0, W², one
    # snapshot an epoch
    run_fused_sharded(group, make_problem("trap"), EAConfig(impl="pallas"),
                      MigrationConfig(topology="pool",
                                      acceptance=AcceptanceConfig()),
                      per, kill_epochs, rng=0, w2=True, snapshot_every=1,
                      snapshot_dir=whole_dir)
    return out


def _sharded_rank_12b(group):
    """Phase 12b: one rank at cuda:0, the fused driver over NCCL and over
    a gloo group of the same rank with host copies."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import EAConfig, MigrationConfig, make_trap
    from repro_torch.core.sharded import ShardGroup, run_fused_sharded
    gloo = ShardGroup.from_default(device=group.device,
                                   pg=dist.new_group(backend="gloo"))
    cfg = EAConfig(impl="pallas", max_pop=256, min_pop=128,
                   generations_per_epoch=100)
    out = {}
    for g in (group, gloo):
        g.barrier()   # NCCL sets its communicator up at the first call
        g.calls, g.host_s = 0, 0.0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = run_fused_sharded(g, make_trap(40, 4, impl="pallas"), cfg,
                                MigrationConfig(topology="pool"), 8, 2,
                                rng=SEED, w2=True, return_stats=True,
                                return_obs=True)
        torch.cuda.synchronize()
        out[g.name] = {"res": res, "wall": time.perf_counter() - t,
                       "calls": g.calls, "host_s": g.host_s}
    a, b = out[group.name]["res"], out[gloo.name]["res"]
    out["same"] = _first_difference(a, b) or "equal"
    for v in out.values():
        if isinstance(v, dict):
            v.pop("res")
    return out


def _sharded_rank_barrier(group):
    group.barrier()
    return group.name


def sharded_phases(card: str):
    """Phases 12a-12c: the sharded drivers on the card (see the module
    docstring)."""
    import shutil
    import signal

    import numpy as np
    import torch
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.core.sharded import spawn

    snaps = os.path.join(ROOT, "build", "chip_smoke_sharded")
    shutil.rmtree(snaps, ignore_errors=True)
    os.makedirs(snaps)
    whole = os.path.join(snaps, "whole")

    # ---- 12a: 2 ranks sharing the card, gloo with host copies ------------
    t = time.perf_counter()
    ranks = spawn(_sharded_rank_12a, SHARD_RANKS, "gloo", "cuda",
                  timeout=SHARD_TIMEOUT, args=(SHARD_KILL_EPOCHS, whole))
    log(f"[sharded] 12a: {SHARD_RANKS} ranks on one card, backend "
        f"{ranks[0]['backend']}, in {time.perf_counter() - t:.1f} s; {card}")
    zero = ranks[0]["runs"]
    for tag, info in zero.items():
        for r in ranks[1:]:
            other = r["runs"][tag]
            if other["digest"] != info["digest"] or not all(
                    torch.equal(u, v) for u, v in zip(other["pool"],
                                                      info["pool"])):
                fail(f"sharded {tag}: rank {r['rank']}'s islands or pool "
                     f"replica differ from rank 0's")
        gen = "generation_float" if tag == "paper-f15-8" else "generation"
        for r in ranks:
            if r["runs"][tag]["launches"][gen] <= 0:
                fail(f"sharded {tag}: rank {r['rank']} launched no {gen} "
                     f"kernel: {r['runs'][tag]['launches']}")
        if tag == "paper-f15-8" and min(
                r["runs"][tag]["launches"]["f15"] for r in ranks) <= 0:
            fail("sharded paper-f15-8: a rank launched no f15 kernel")
        epochs = info["epochs"]
        line = (f"[sharded] {tag}: {epochs} epochs of {SHARD_RANKS} x "
                f"{8 // SHARD_RANKS} islands in {info['wall']:.3f} s, "
                f"{info['wall'] / epochs:.4f} s per epoch, "
                f"{info['evals'] / info['wall']:.1f} evals/s; collectives "
                f"(rank 0) {info['calls']}, {info['end']} of them the final "
                f"gather: {(info['calls'] - info['end']) / epochs:.1f} per "
                f"epoch; their host time {1e3 * info['host_s']:.3f} ms in "
                f"the run; launches (rank 0) {info['launches']}")
        if "same_as_plain" in info:
            if info["same_as_plain"] != "equal":
                fail(f"sharded {tag}: the kernel run differs from the plain "
                     f"run at {info['same_as_plain']}")
            if max(info["plain_launches"].values()) != 0:
                fail(f"sharded {tag}: the plain run launched a kernel")
            line += (f"; == plain run (impl=pallas_ref, "
                     f"{info['plain_wall']:.3f} s, no launch), every rank's "
                     f"pool replica == rank 0's")
        log(line + f"; {card}")
    turns = ranks[0]["turns"]
    rate = {tag: [e / w for t_, w, e, _, _ in turns if t_ == tag]
            for tag in ("main", "sharded")}
    for tag, wall, evals, calls, host in turns:
        log(f"[sharded] turn {tag}: {SHARD_TURN_EPOCHS} epochs, {evals} "
            f"evaluations in {wall:.3f} s = {evals / wall:.1f} evals/s, "
            f"{wall / SHARD_TURN_EPOCHS:.4f} s per epoch, collectives "
            f"{calls / SHARD_TURN_EPOCHS:.1f} and "
            f"{1e3 * host / SHARD_TURN_EPOCHS:.3f} ms host per epoch; {card}")
    log(f"[sharded] evals/s in turns (main, sharded, sharded, main): "
        f"[sharded] / [main] = "
        f"{sum(rate['sharded']) / sum(rate['main']):.3f}; {card}")

    # ---- 12b: world 1, NCCL at cuda:0 against gloo with host copies ------
    t = time.perf_counter()
    one = spawn(_sharded_rank_12b, 1, "nccl", "cuda:0",
                timeout=SHARD_TIMEOUT)[0]
    if one["same"] != "equal":
        fail(f"world 1: NCCL and gloo with host copies differ at "
             f"{one['same']}")
    log(f"[sharded] 12b: world 1 at cuda:0, nccl == gloo+host bit for bit "
        f"(islands, pool, stats, counters; 2 epochs of 8 islands): "
        + "; ".join(f"{k} {v['wall']:.3f} s, {v['calls']} collectives, "
                    f"{1e3 * v['host_s']:.3f} ms host"
                    for k, v in one.items() if isinstance(v, dict))
        + f", in {time.perf_counter() - t:.1f} s; {card}")
    t = time.perf_counter()
    try:
        spawn(_sharded_rank_barrier, 2, "nccl", "cuda:0", timeout=90)
        verdict = "accepted"
    except (RuntimeError, TimeoutError) as e:
        tail = [ln for ln in str(e).splitlines() if ln.strip()][-1]
        verdict = f"refused ({tail.strip()[:200]})"
    log(f"[sharded] NCCL with 2 ranks on one card: {verdict}, in "
        f"{time.perf_counter() - t:.1f} s")

    # ---- 12c: ea --sharded --fused, SIGKILL after its first snapshot,
    # --resume, and the snapshot resumed on 4 ranks ----------------------
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH"))
        if p))
    kill_dir = os.path.join(snaps, "killed")

    def ea(shards: int, snapshot_dir: str):
        return [sys.executable, "-m", "repro_torch.launch.evolve", "ea",
                "--problem", "trap", "--islands", "8", "--epochs",
                str(SHARD_KILL_EPOCHS), "--impl", "pallas", "--fused",
                "--w2", "--sharded", "--shards", str(shards),
                "--snapshot-every", "1", "--snapshot-dir", snapshot_dir,
                "--timeout", str(SHARD_TIMEOUT)]

    cmd = ea(SHARD_RANKS, kill_dir)
    t = time.perf_counter()
    child = subprocess.Popen(cmd, env=env, cwd=ROOT, start_new_session=True,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE)
    first = os.path.join(kill_dir, "step_00000001")
    while not os.path.isdir(first) and child.poll() is None and \
            time.perf_counter() - t < SHARD_TIMEOUT:
        time.sleep(0.02)
    if child.poll() is not None:
        fail(f"ea --sharded ended (rc {child.returncode}) before it was "
             f"killed: {child.stderr.read()[-2000:]}")
    os.killpg(child.pid, signal.SIGKILL)
    child.wait()
    child.stderr.close()
    left = sorted(s for s in os.listdir(kill_dir) if s.startswith("step_"))
    if f"step_{SHARD_KILL_EPOCHS:08d}" in left:
        fail(f"ea --sharded reached its last snapshot before the kill: {left}")
    elastic = os.path.join(snaps, "elastic")
    shutil.copytree(kill_dir, elastic)
    proc = subprocess.run(cmd + ["--resume"], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=SHARD_TIMEOUT)
    if proc.returncode != 0:
        fail(f"ea --sharded --resume: rc {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    last = latest_step(whole)
    got, want = restore(kill_dir), restore(whole)
    if latest_step(kill_dir) != last or sorted(got) != sorted(want) or any(
            not np.array_equal(got[k], want[k]) for k in want):
        fail("ea --sharded: kill -9 + --resume: the final snapshot differs "
             "from the uninterrupted run's")
    log(f"[sharded] 12c: ea --sharded --shards {SHARD_RANKS} --fused --w2, "
        f"{SHARD_KILL_EPOCHS} epochs, killed by SIGKILL after step 1 landed "
        f"(left {left}), --resume in a fresh process: final snapshot (step "
        f"{last}, {len(want)} leaves) == the uninterrupted run's, in "
        f"{time.perf_counter() - t:.1f} s; "
        f"{' | '.join(proc.stdout.strip().splitlines()[-2:])}")
    t = time.perf_counter()
    proc = subprocess.run(ea(4, elastic) + ["--resume"], capture_output=True,
                          text=True, env=env, cwd=ROOT,
                          timeout=SHARD_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines or not lines[-1].endswith(
            f"epochs={SHARD_KILL_EPOCHS}") or "[sharded x4 fused" not in \
            lines[-2]:
        fail(f"ea --sharded --shards 4 --resume: rc {proc.returncode}, "
             f"{lines[-2:]}, {proc.stderr[-2000:]}")
    final = restore(elastic)
    if final["islands::pop"].shape[0] != 8:
        fail(f"the 4-rank resume holds {final['islands::pop'].shape[0]} "
             f"islands")
    log(f"[sharded] 12c: the 2-rank snapshot (step {left[-1]}) resumed on "
        f"4 ranks of 2 islands, to step {latest_step(elastic)} in "
        f"{time.perf_counter() - t:.1f} s; {' | '.join(lines[-2:])}")


def training_phases(card: str):
    """Phases 13a-13e: training on the card (see the module docstring)."""
    import contextlib
    import io
    import math
    import shutil
    import statistics

    import torch
    from repro_torch import convert, kernels
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.launch import evolve
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_mod
    from repro_torch.models import Model
    from repro_torch.optim import make_schedule

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()

    def finite(tag, metrics):
        for k in ("ce", "grad_norm", "lr"):
            if not bool(torch.isfinite(metrics[k])):
                fail(f"{tag}: {k} is {float(metrics[k])}")

    # ---- 13a: minicpm-2b at its published size -----------------------------
    cfg = get_config("minicpm-2b")
    n_params = Model(cfg, device="meta").param_count()
    ends, ms_seen = [], []

    def on_step(i, state, metrics):
        finite(f"13a step {i}", metrics)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)

    # what the earlier phases still hold counts in the peak: print both
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state, losses = train_mod.train(
            "minicpm-2b", smoke=False, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
            seq=TRAIN_SEQ, lr=3e-3, seed=SEED, log_every=1, device="cuda",
            on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    for line in buf.getvalue().splitlines():
        log(f"[train-main] {line}")
    peak = torch.cuda.max_memory_allocated()
    for a, b in zip(ends, ends[1:]):
        ms_seen.append(a.elapsed_time(b))
    step_ms = statistics.median(ms_seen)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6.0 * n_params * tokens
    log(f"[train-main] minicpm-2b published size ({n_params:,} parameters, "
        f"40 layers, d 2304, bf16 with the f32 master), batch "
        f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, remat layer, wsd lr 3e-3: "
        f"{TRAIN_STEPS} steps in {wall:.1f} s (the weights' draw "
        f"included); ce {[round(x, 4) for x in losses]}")
    log(f"[train-main] ms per step {step_ms:.3f} (median of "
        f"{len(ms_seen)} after one warm step, CUDA events; each "
        f"{[round(x, 3) for x in ms_seen]}); tokens/s "
        f"{tokens / step_ms * 1e3:.1f}; peak memory {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated; {(peak - held) / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB held before 13a); model FLOPs 6 N tokens = "
        f"{flops:.4g} a "
        f"step = {flops / (step_ms / 1e3) / 1e12:.1f} TFLOP/s = "
        f"{flops / (step_ms / 1e3) / BF16_FLOPS_PER_S:.3f} of the dense "
        f"bf16 peak (989 TFLOP/s); {card}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"13a: ce {losses}")
    # two more steps: one unprofiled, one profiled (launches, busy share)
    step = steps_lib.make_train_step(
        Model(cfg, device="meta"),
        schedule=make_schedule(cfg.schedule, 3e-3, TRAIN_STEPS, 2))
    batch = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, SEED,
                        device=dev).batch_for_step(TRAIN_STEPS)
    # (the step updates the state in place: each call is one more step)
    device_profile("train-main", lambda: step(state, batch), card)
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 13b: the card against the CPU, smoke f32 ------------------------
    for arch in ("minicpm-2b", "rwkv6-3b"):
        tol = CARD_CPU_TOL[arch]
        scfg = get_config(arch, smoke=True)
        init = steps_lib.init_train_state(Model(
            scfg, device="cpu", generator=torch.Generator().manual_seed(SEED)))
        states = {"cpu": convert.to_device(init, "cpu"),
                  "cuda": convert.to_device(init, dev)}
        sched = make_schedule(scfg.schedule, 3e-3, 10, 2)
        worst = dict(ce=0.0, gnorm=0.0)
        step = steps_lib.make_train_step(Model(scfg, device="meta"),
                                         schedule=sched)
        for i in range(CARD_CPU_STEPS):
            ms = {}
            for d in ("cpu", "cuda"):
                b = SyntheticLM(scfg.vocab_size, 64, 8, SEED,
                                device=d).batch_for_step(i)
                states[d], ms[d] = step(states[d], b)
            finite(f"13b {arch}", ms["cuda"])
            for k, key in (("ce", "ce"), ("gnorm", "grad_norm")):
                rel = abs(float(ms["cuda"][key]) - float(ms["cpu"][key])) / (
                    abs(float(ms["cpu"][key])))
                worst[k] = max(worst[k], rel)
        dp = max((states["cuda"].params[k].cpu() - v).abs().max().item()
                 for k, v in states["cpu"].params.items())
        log(f"[train-cpu] {arch} smoke f32, {CARD_CPU_STEPS} steps from the "
            f"same state and batches: card against CPU, ce {worst['ce']:.3g} "
            f"(tolerance {tol['ce']}), gnorm {worst['gnorm']:.3g} "
            f"({tol['gnorm']}) relative at worst, final parameters "
            f"{dp:.3g} ({tol['params']}) absolute")
        if worst["ce"] > tol["ce"] or worst["gnorm"] > tol["gnorm"] \
                or dp > tol["params"]:
            fail(f"13b: {arch} on the card differs from the CPU beyond the "
                 f"tolerance: {worst}, parameters {dp}")
    # a resume equals the uninterrupted run, bit for bit
    ckpts = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(ckpts, ignore_errors=True)
    for arch in ("minicpm-2b", "rwkv6-3b"):
        kw = dict(smoke=True, steps=6, batch=8, seq=64, ckpt_every=3,
                  verbose=False, device="cuda", seed=SEED)
        whole, losses = train_mod.train(
            arch, ckpt_dir=os.path.join(ckpts, arch, "whole"), **kw)
        part = os.path.join(ckpts, arch, "part")
        train_mod.train(arch, ckpt_dir=part, **kw)
        shutil.rmtree(os.path.join(part, "step_00000006"))
        resumed, tail = train_mod.train(arch, ckpt_dir=part, resume=True,
                                        **kw)
        same = tail == losses[3:] and all(
            torch.equal(a[k], b[k])
            for a, b in ((whole.params, resumed.params),
                         (whole.opt.m, resumed.opt.m),
                         (whole.opt.v, resumed.opt.v)) for k in a)
        log(f"[train-resume] {arch} smoke, 6 steps with a checkpoint at 3: "
            f"the resumed run equals the uninterrupted one bit for bit: "
            f"{same}")
        if not same:
            fail(f"13b: {arch}'s resumed run differs from the uninterrupted "
                 f"run")
    shutil.rmtree(ckpts, ignore_errors=True)
    # the master path: a bf16 reduced model, one step
    bcfg = get_config("minicpm-2b").reduced(param_dtype=torch.bfloat16,
                                             activation_dtype=torch.bfloat16)
    bstate = steps_lib.init_train_state(Model(bcfg, device=dev))
    bstep = steps_lib.make_train_step(
        Model(bcfg, device="meta"),
        schedule=make_schedule("constant", 3e-3, 1))
    bstate, bm = bstep(bstate, SyntheticLM(bcfg.vocab_size, 64, 8, SEED,
                                           device=dev).batch_for_step(0))
    finite("13b bf16", bm)
    ok = bstate.opt.master is not None and all(
        torch.equal(p, bstate.opt.master[k].to(torch.bfloat16))
        and bstate.opt.master[k].dtype == torch.float32
        for k, p in bstate.params.items())
    log(f"[train-bf16] minicpm-2b reduced in bf16, one step: ce "
        f"{float(bm['ce']):.4f} gnorm {float(bm['grad_norm']):.4f}; f32 "
        f"master kept, the bf16 params its rounding: {ok}")
    if not ok:
        fail("13b: the bf16 step's params are not its f32 master rounded")
    del bstate, bstep

    # ---- 13c: rwkv6-3b at full width, depth cut --------------------------
    rcfg = dataclasses.replace(get_config("rwkv6-3b"),
                               n_layers=RWKV_TRAIN_LAYERS)
    rmodel = Model(rcfg, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(SEED))
    randomize_decay_lora(rmodel, torch.Generator(device=dev).manual_seed(
        SEED))
    rstate = steps_lib.init_train_state(rmodel)
    rmodel.to_empty(device="meta")
    rstep = steps_lib.make_train_step(rmodel, schedule=make_schedule(
        "cosine", 3e-3, RWKV_TRAIN_STEPS, 1))
    rdata = SyntheticLM(rcfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, SEED,
                        device=dev)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    r_ms = []
    for i in range(RWKV_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        rstate, rm = rstep(rstate, rdata.batch_for_step(i))
        finite(f"13c step {i}", rm)
        torch.cuda.synchronize()
        r_ms.append((time.perf_counter() - t) * 1e3)
        log(f"[train-rwkv] step {i} ce={float(rm['ce']):.4f} "
            f"gnorm={float(rm['grad_norm']):.3f} lr={float(rm['lr']):.2e}")
    log(f"[train-rwkv] rwkv6-3b at full width (d 2560, 40 heads of 64, "
        f"d_ff 8960, vocab 65,536, bf16), depth cut from 32 to "
        f"{RWKV_TRAIN_LAYERS} layers, batch {TRAIN_BATCH} x seq {TRAIN_SEQ},"
        f" the plain sequential WKV under autograd: ms per step (wall) "
        f"{[round(x, 1) for x in r_ms]} (the first a warm step); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ("
        f"{held / 2**30:.2f} GiB held before the steps: the state and what "
        f"earlier phases hold); {card}")
    del rstate, rstep, rmodel
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 13d: the pbt command on the card --------------------------------
    t = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ctrl = evolve.main(["pbt"])
    for line in buf.getvalue().splitlines():
        log(f"[pbt] {line}")
    puts = ctrl.pool.stats()["puts"]
    n_members, n_epochs = 4, 5
    log(f"[pbt] evolve pbt at the reference's defaults ({n_members} "
        f"members, {n_epochs} epochs of 20 steps, batch 8 x seq 64, smoke "
        f"minicpm-2b) on the card in {time.perf_counter() - t:.1f} s: pool "
        f"puts {puts}, exploits "
        f"{sum(h['exploited'] for h in ctrl.history)}")
    if puts != n_members * n_epochs:
        fail(f"13d: {puts} pool puts, want {n_members * n_epochs}")
    # examples/evolve_lm.py's dead-pool epoch
    ctrl.pool.kill()
    pcfg = get_config("minicpm-2b", smoke=True)
    pdata = SyntheticLM(pcfg.vocab_size, 64, 8, device=dev)
    m = ctrl.members[0]
    stats = ctrl.train_epoch(m, (pdata.batch_for_step(s) for s in range(10)),
                             pdata.batch_for_step(99_999))
    migrated = ctrl.migrate(m)
    log(f"[pbt] member 0 epoch with dead pool: val={stats['val_loss']:.4f} "
        f"migrated={migrated} (expected False)")
    if migrated or not math.isfinite(stats["val_loss"]):
        fail("13d: a dead pool's migrate must return False")

    # ---- 13e: the kernels refuse autograd ----------------------------------
    for flag in ("use_flash", "use_rwkv_kernel"):
        try:
            steps_lib.make_train_step(Model(pcfg, device="meta"),
                                      schedule=make_schedule("constant",
                                                             1e-3, 1),
                                      **{flag: True})
        except NotImplementedError as e:
            log(f"[train-kernels] make_train_step({flag}=True) raises: "
                f"{str(e)[:80]}...")
        else:
            fail(f"13e: make_train_step({flag}=True) did not raise")
    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, r, kk, vv = (torch.randn(1, 64, 2, 64, generator=g, device=dev)
                          for _ in range(6))
    w = torch.rand(1, 64, 2, 64, generator=g, device=dev) * 0.5 + 0.4
    u = torch.randn(2, 64, generator=g, device=dev)
    s0 = torch.zeros(1, 2, 64, 64, device=dev)
    for name, call, x in (
            ("flash_attention",
             lambda: flash_ops.flash_attention(q, k, v, scale=0.125), q),
            ("wkv", lambda: wkv_ops.wkv(r, kk, vv, w, u, s0), r)):
        x.requires_grad_(True)
        try:
            call()
        except RuntimeError as e:
            log(f"[train-kernels] {name} on a CUDA input that requires grad "
                f"raises: {str(e)[:80]}...")
        else:
            fail(f"13e: {name} launched on an input that requires grad")
        before = kernels.LAUNCHES[name]
        with torch.no_grad():
            call()
        torch.cuda.synchronize()
        if kernels.LAUNCHES[name] != before + 1:
            fail(f"13e: {name} did not launch under no_grad")
        log(f"[train-kernels] {name} under torch.no_grad launches")
        x.requires_grad_(False)


def _flash_eligible(plan) -> int:
    """Blocks whose prefill attention goes through the flash kernel:
    causal self-attention (``attn`` or hymba's) without a window."""
    return sum(seg.n for seg in plan for bc in seg.pattern
               if bc.mixer in ("attn", "hybrid") and bc.window == 0)


def _flash_layer_check(model, batch):
    """Each flash-eligible layer's attention output through the kernel
    against the plain route, from the same input (the blocks run in
    train mode through the flash route between them): (worst relative
    L2, layers compared)."""
    import torch
    from repro_torch.models import attention, transformer
    from repro_torch.models.common import rmsnorm
    cfg = model.cfg
    worst, n = 0.0, 0
    with torch.inference_mode():
        cross_src = model._cross_source(batch, True)
        x = model._embed(batch["tokens"])
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        for si, seg in enumerate(model.plan):
            for layer in model.segments[si]:
                for bc, block in zip(seg.pattern, layer):
                    p = block.tree()
                    if bc.mixer in ("attn", "hybrid") and bc.window == 0:
                        ap = (p["mixer"]["attn"] if bc.mixer == "hybrid"
                              else p["mixer"])
                        h = rmsnorm(p["ln1"]["scale"], x, cfg.norm_eps)
                        o_k, _ = attention.attend(ap, cfg, h, positions=pos,
                                                  use_flash=True)
                        o_p, _ = attention.attend(ap, cfg, h, positions=pos)
                        worst = max(worst, rel_l2(o_k, o_p))
                        n += 1
                    x, _, _ = transformer.block_apply(
                        bc, cfg, p, x, mode="train", positions=pos,
                        cross_src=cross_src, use_flash=True)
    return worst, n


def _routing_diff(a, b):
    """(token, layer) routing sets that differ between two recordings of
    the same prefill, and the sets compared."""
    diff = total = 0
    for ra, rb in zip(a, b):
        sa = ra.experts.sort(-1).values
        sb = rb.experts.sort(-1).values
        diff += int((sa != sb).any(-1).sum().item())
        total += sa.shape[0]
    return diff, total


def family_phases(card: str):
    """Phase 14: olmoe-1b-7b, hymba-1.5b and seamless-m4t-large-v2 served
    at their published sizes, llama-3.2-vision-90b and dbrx-132b at full
    width with their depth cut (FAMILY_CELLS); then olmoe's f32 prefill on
    the card against the CPU."""
    import copy

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model, moe

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    # the SSM scan's fused multiply-add on the card (models.common.fma is
    # torch.addcmul there) against rand.fma's exact emulation: random
    # triples, products that cancel the addend, tiny addends
    from repro_torch import rand
    from repro_torch.models.common import fma
    g = torch.Generator(device=dev).manual_seed(SEED)
    fa, fb, fc = (torch.randn(1 << 24, generator=g, device=dev)
                  for _ in range(3))
    differ = sum(int((fma(fa, fb, c) != rand.fma(fa, fb, c)).sum().item())
                 for c in (fc, -(fa * fb) * (1 + 2 ** -20 * fc), fc * 1e-8))
    log(f"[family] fma on the card (torch.addcmul) against rand.fma: "
        f"{differ} of {3 << 24} results differ")
    if differ:
        fail("torch.addcmul on the card is not a fused multiply-add")
    del fa, fb, fc
    for arch, layers, batch, prompt, new in FAMILY_CELLS:
        t_cell = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        tag = f"[family] {arch}"
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        model = build_model(cfg, dev, gen)
        if cfg.family == "vlm":
            with torch.no_grad():
                for seg in model.segments:
                    for layer in seg:
                        for block in layer:
                            if "gate" in block.mixer.tree():
                                block.mixer.gate.fill_(FAMILY_GATE)
        torch.cuda.synchronize()
        cut = (f"depth cut to {layers} of {get_config(arch).n_layers} "
               f"layers" if layers is not None else "published size")
        log(f"{tag}: {model.param_count()} parameters ({cut}; d "
            f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} of "
            f"{cfg.hd}, d_ff {cfg.d_ff}, experts {cfg.n_experts} top "
            f"{cfg.experts_per_token}, vocab {cfg.vocab_size}, "
            f"{cfg.param_dtype}) drawn in {time.perf_counter() - t:.2f} s")
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                                generator=gen, device=dev)
        extra = {}
        if cfg.n_encoder_layers:
            extra["src_embed"] = torch.randn(
                (batch, FAMILY_SRC_LEN, cfg.d_model), generator=gen,
                device=dev).to(cfg.activation_dtype)
        if cfg.family == "vlm":
            extra["vision_embed"] = torch.randn(
                (batch, cfg.vision_seq, cfg.d_model), generator=gen,
                device=dev).to(cfg.activation_dtype)
        b = dict(extra, tokens=prompts)
        generate(model, prompts, 2, **extra)           # warm-up
        kernels.reset_launches()
        toks, times = generate(model, prompts, new, **extra)
        launches = dict(kernels.LAUNCHES)
        want = _flash_eligible(model.plan)
        others = {k: n for k, n in launches.items()
                  if k != "flash_attention" and n}
        if launches["flash_attention"] != want or others:
            fail(f"{arch}: the served prefill should launch the flash "
                 f"kernel {want} times and nothing else: {launches}")
        if toks.shape != (batch, new) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{arch}: served tokens of shape {tuple(toks.shape)} or "
                 f"out of range")
        steps = times["decode_steps"]
        n_prompt = batch * prompt
        src = (f", source {FAMILY_SRC_LEN} frames" if cfg.n_encoder_layers
               else "")
        log(f"{tag} generate: prefill {batch} x {prompt} (+"
            f"{cfg.n_meta_tokens} meta tokens{src}) in "
            f"{times['prefill_s'] * 1e3:.3f} ms = "
            f"{n_prompt / times['prefill_s']:.1f} tokens/s; decode {steps} "
            f"steps in {times['decode_s'] * 1e3:.3f} ms = "
            f"{times['decode_s'] / steps * 1e3:.3f} ms per step = "
            f"{batch * steps / times['decode_s']:.1f} tokens/s; launches "
            f"{launches}; sample {toks[0, :8].tolist()}; peak device "
            f"memory {torch.cuda.max_memory_allocated()} B; {card}")
        # the prefill through each route, the routings recorded
        budget = prompt + new
        with moe.recording() as r_k:
            logits_k, caches, xkv = make_prefill_step(
                model, max_seq=budget, use_flash=True)(b)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with moe.recording() as r_p:
            logits_p, _, _ = make_prefill_step(model, max_seq=budget)(b)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        finite = bool(torch.isfinite(logits_k).all()) and bool(
            torch.isfinite(logits_p).all())
        e2e = rel_l2(logits_k, logits_p)
        layer_err, n_layers = _flash_layer_check(model, b)
        routing = ""
        if cfg.is_moe:
            d, total = _routing_diff(r_k, r_p)
            routing = (f"; routing sets that differ between the routes: "
                       f"{d} of {total} (token, layer) pairs")
        limit = FAMILY_BF16_TOL[arch]
        same_next = (logits_k.argmax(-1) == logits_p.argmax(-1)).float()
        log(f"{tag} flash route against the plain route: each of "
            f"{n_layers} flash layers' attention output from the same input"
            f" within relative L2 {layer_err:.4e} (limit {FAMILY_LAYER_TOL})"
            f"; last-position logits {e2e:.4e} (limit {limit}); next token "
            f"equal in {same_next.mean().item():.2f} of rows; finite "
            f"{finite}; plain prefill {plain_ms:.1f} ms{routing}; {card}")
        del r_k, r_p
        twin_err = 0.0
        if arch in FAMILY_TWIN:
            twin = build_model(dataclasses.replace(
                cfg, param_dtype=torch.float32,
                activation_dtype=torch.float32), "meta").to_empty(device=dev)
            with torch.no_grad():
                for p16, p32 in zip(model.parameters(), twin.parameters()):
                    p32.copy_(p16.float())
            kernels.reset_launches()
            tw_k, _, _ = make_prefill_step(twin, max_seq=budget,
                                           use_flash=True)(b)
            tw_launches = kernels.LAUNCHES["flash_attention"]
            tw_p, _, _ = make_prefill_step(twin, max_seq=budget)(b)
            twin_err = rel_l2(tw_k, tw_p)
            own = rel_l2(logits_p, tw_p)
            log(f"{tag} the f32 twin ({tw_launches} launches of the f32 "
                f"kernel): flash route against plain route, last-position "
                f"logits {twin_err:.4e} (limit {FAMILY_F32_TOL}); the bf16 "
                f"plain route against the f32 plain route {own:.4e} "
                f"(bf16's own distance, no gate); {card}")
            if tw_launches != want:
                fail(f"{arch}: the f32 twin's prefill launched the flash "
                     f"kernel {tw_launches} times, want {want}")
            del twin, tw_k, tw_p
            gc.collect()
            torch.cuda.empty_cache()
        del logits_p
        decode = make_decode_step(model)
        tok = logits_k.argmax(-1)[:, None]
        index = prompt + cfg.n_meta_tokens
        device_profile(f"family-{arch}-prefill", lambda: make_prefill_step(
            model, max_seq=budget, use_flash=True)(b), card)
        device_profile(f"family-{arch}-decode", lambda: decode(
            {"token": tok, "index": index, "caches": caches,
             "cross_kvs": xkv}), card)
        if not finite or layer_err > FAMILY_LAYER_TOL or e2e > limit \
                or n_layers != want or twin_err > FAMILY_F32_TOL:
            fail(f"{arch}: the flash route and the plain route disagree "
                 f"beyond the stated limits, or non-finite values")
        del model, caches, xkv, decode, logits_k, b, extra, prompts, toks
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{tag}: cell in {time.perf_counter() - t_cell:.1f} s")

    # olmoe in f32 at full width, 2 layers: the card against the CPU
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"),
                              n_layers=OLMOE_F32_LAYERS,
                              param_dtype=torch.float32,
                              activation_dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    card_model = build_model(cfg, dev, gen)
    cpu_model = copy.deepcopy(card_model).to("cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, moe.SEQ_CHUNK),
                           generator=gen, device=dev)
    with moe.recording() as r_card:
        l_card, _, _ = card_model.prefill({"tokens": tokens},
                                          use_flash=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with moe.recording() as r_cpu:
        l_cpu, _, _ = cpu_model.prefill({"tokens": tokens.cpu()})
    cpu_s = time.perf_counter() - t
    same = all(torch.equal(a.experts.cpu(), c.experts)
               and torch.equal(a.position.cpu(), c.position)
               and torch.equal(a.keep.cpu(), c.keep)
               for a, c in zip(r_card, r_cpu)) and len(r_card) == len(r_cpu)
    drop_card = [1.0 - r.keep.float().mean().item() for r in r_card]
    drop_cpu = [1.0 - r.keep.float().mean().item() for r in r_cpu]
    f32_err = rel_l2(l_card.cpu(), l_cpu)
    log(f"[family] olmoe-1b-7b f32, {OLMOE_F32_LAYERS} layers at full width,"
        f" 1 x {moe.SEQ_CHUNK} tokens, card against CPU: expert indices, "
        f"positions and keep equal in all {len(r_card)} layers: {same}; "
        f"dropped_frac card {drop_card} CPU {drop_cpu}; last-position "
        f"logits relative L2 {f32_err:.4e} (limit {OLMOE_F32_TOL}); the "
        f"CPU prefill {cpu_s:.2f} s; {card}")
    if not same or drop_card != drop_cpu or f32_err > OLMOE_F32_TOL:
        fail("olmoe f32 prefill: the card's routing or logits differ from "
             "the CPU's")
    del card_model, cpu_model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 15: model land across ranks
# ---------------------------------------------------------------------------
def _olmoe_cut():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("olmoe-1b-7b"),
                               n_layers=MESH_TRAIN_LAYERS)


def _tree_bytes(tree) -> int:
    import torch
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0


def _yi_serve(dev, mesh=None):
    """yi-9b at its published size from SEED: a prefill of DENSE_BATCH x
    DENSE_PROMPT through the flash kernel and MESH_NEW greedy decode
    steps, on one device or on ``mesh`` (this rank's blocks)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import partition
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import build_model
    cfg = get_config("yi-9b")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kw = {}
    if mesh is None:
        model = build_model(cfg, dev, gen)
    else:
        # the rank draws its blocks alone: the whole model is never here
        model = partition.build_local(cfg, mesh, "serve", dev, gen)
        kw = dict(mesh=mesh, batch=DENSE_BATCH)
    build_peak = torch.cuda.max_memory_allocated()
    prompts = torch.randint(0, cfg.vocab_size, (DENSE_BATCH, DENSE_PROMPT),
                            generator=gen, device=dev)
    budget = DENSE_PROMPT + MESH_NEW
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    prefill = steps_lib.make_prefill_step(model, max_seq=budget,
                                          use_flash=True, **kw)
    decode = steps_lib.make_decode_step(
        model, **(dict(kw, max_seq=budget) if kw else {}))
    group = None if mesh is None else mesh.group("model")

    def collectives():
        return (0, 0.0) if group is None else (group.calls, group.host_s)

    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    prefill({"tokens": prompts})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    pre_launches = dict(kernels.LAUNCHES)
    c0 = collectives()
    t = time.perf_counter()
    logits, caches, _ = prefill({"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    c1 = collectives()
    kernels.reset_launches()
    tok = logits.argmax(-1)[:, None]
    toks = [tok]
    t = time.perf_counter()
    for step in range(MESH_NEW):
        d_logits, caches = decode({"token": tok,
                                   "index": DENSE_PROMPT + step,
                                   "caches": caches})
        tok = d_logits.argmax(-1)[:, None]
        toks.append(tok)
    torch.cuda.synchronize()
    c2 = collectives()
    out = {"logits": logits.float().cpu(),
           "collectives": (c1[0] - c0[0], c1[1] - c0[1], c2[0] - c1[0],
                           c2[1] - c1[1]),
           "tokens": torch.cat(toks, 1).cpu(),
           "prefill_s": prefill_s, "first_s": first_s,
           "decode_s": time.perf_counter() - t,
           "launches": pre_launches, "decode_launches": dict(kernels.LAUNCHES),
           "held": held + _tree_bytes(caches), "weights": held,
           "peak": torch.cuda.max_memory_allocated(),
           "build_peak": build_peak,
           "finite": bool(torch.isfinite(d_logits).all())}
    del model, caches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rwkv_prefill(dev, mesh=None, f32=False):
    """rwkv6-3b at its published size from SEED (the decay and mixing
    LoRAs drawn too): a prefill of SERVE_BATCH x SERVE_PROMPT through the
    WKV kernel, on one device or on ``mesh``; ``f32``: the weights and
    activations in f32 (the f32 kernel)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import partition
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import build_model
    cfg = get_config("rwkv6-3b")
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                                  activation_dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kw, layout = {}, None
    if mesh is None:
        model = build_model(cfg, dev, gen)
    else:
        model = partition.build_local(cfg, mesh, "serve", dev, gen)
        layout = partition.param_layout(model, mesh, "serve")
        kw = dict(mesh=mesh, batch=SERVE_BATCH)
    randomize_decay_lora(model, gen, layout)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, caches, _ = steps_lib.make_prefill_step(
        model, use_rwkv_kernel=True, **kw)({"tokens": prompts})
    torch.cuda.synchronize()
    out = {"logits": logits.float().cpu(), "wkv": caches[0][0]["wkv"].cpu(),
           "launches": dict(kernels.LAUNCHES),
           "prefill_s": time.perf_counter() - t}
    del model, caches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _olmoe_train(dev, mesh=None):
    """olmoe-1b-7b at full width, MESH_TRAIN_LAYERS layers, from SEED:
    MESH_TRAIN_STEPS steps of the synthetic data; one device or
    ``mesh`` (the train rules). Returns the metrics per step."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import partition
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import build_model, moe
    from repro_torch.optim import make_schedule
    cfg = _olmoe_cut()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = SyntheticLM(cfg.vocab_size, MESH_TRAIN_SEQ, MESH_TRAIN_BATCH, SEED,
                       device=dev)
    schedule = make_schedule(cfg.schedule, 3e-3, MESH_TRAIN_STEPS, 1)
    ep = False
    if mesh is None:
        model = build_model(cfg, dev, gen)
        state = steps_lib.init_train_state(model)
        step = steps_lib.make_train_step(model, schedule=schedule)
    else:
        model = partition.build_local(cfg, mesh, "train", dev, gen)
        layout = partition.param_layout(model, mesh, "train")
        state = steps_lib.local_train_state(dict(model.named_parameters()),
                                            layout)
        step = steps_lib.make_train_step(model, schedule=schedule,
                                         mesh=mesh, mode="train")
        ep = moe.ep_applies(cfg, layout.shards(), MESH_TRAIN_BATCH)
    build_peak = torch.cuda.max_memory_allocated()
    model.to_empty(device="meta")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    t = time.perf_counter()
    for i in range(MESH_TRAIN_STEPS):
        batch = data.batch_for_step(i)
        if mesh is not None:
            batch = steps_lib.shard_batch(batch, mesh, "train")
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    out = {"metrics": metrics, "wall": time.perf_counter() - t, "ep": ep,
           "peak": torch.cuda.max_memory_allocated(),
           "build_peak": build_peak,
           "held": _tree_bytes(state.params) + _tree_bytes(state.opt)}
    del state, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_rank_15(group):
    """15a, 15c and 15b on this rank of the world (see the module
    docstring)."""
    from repro_torch.launch.mesh import Mesh
    dev = group.device
    out = {"backend": group.name, "rank": group.rank}
    mesh = Mesh((1, MESH_RANKS), ("data", "model")).bind(group)
    out["15a"] = _yi_serve(dev, mesh)
    out["15c"] = _rwkv_prefill(dev, mesh)
    out["15c_f32"] = _rwkv_prefill(dev, mesh, f32=True)
    out["15b"] = {}
    for shape in ((1, MESH_RANKS), (MESH_RANKS, 1)):
        m = Mesh(shape, ("data", "model")).bind(group)
        out["15b"][shape] = _olmoe_train(dev, m)
    return out


def _mesh_rank_15d(group):
    """15d: on a (1, 1) mesh over NCCL, the train step (2 steps), the
    prefill and 3 decode steps of yi-9b at full width cut to
    MESH_EQUAL_LAYERS layers, against the mesh-less steps: bit for
    bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import partition
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.optim import make_schedule
    dev = group.device
    cfg = dataclasses.replace(get_config("yi-9b"), n_layers=MESH_EQUAL_LAYERS)
    mesh = Mesh((1, 1), ("data", "model")).bind(group)

    def fresh():
        return build_model(cfg, dev, torch.Generator(device=dev).manual_seed(
            SEED))

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen,
                         device=dev)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    schedule = make_schedule("constant", 3e-3, 10)
    diffs = []
    # train: two steps each way from the same weights
    model = fresh()
    plain = steps_lib.init_train_state(model)
    plain = steps_lib.TrainState({k: v.clone() for k, v in
                                  plain.params.items()}, plain.opt)
    layout = partition.param_layout(model, mesh, "train")
    meshed = steps_lib.local_train_state(dict(partition.build_local(
        cfg, mesh, "train", dev, torch.Generator(device=dev).manual_seed(
            SEED)).named_parameters()), layout)
    model.to_empty(device="meta")
    step_p = steps_lib.make_train_step(model, schedule=schedule)
    step_m = steps_lib.make_train_step(model, schedule=schedule, mesh=mesh)
    for i in range(2):
        plain, mp = step_p(plain, batch)
        meshed, mm = step_m(meshed, batch)
        for k in ("ce", "grad_norm", "loss"):
            if not torch.equal(mp[k], mm[k]):
                diffs.append(f"train step {i} {k}")
    for k, v in plain.params.items():
        if not torch.equal(v, meshed.params[k]):
            diffs.append(f"train parameter {k}")
    for k, v in plain.opt.m.items():
        if not torch.equal(v, meshed.opt.m[k]):
            diffs.append(f"train moment {k}")
    del plain, meshed, model
    gc.collect()
    torch.cuda.empty_cache()
    # serve: the prefill (flash kernel) and 3 decode steps each way
    runs = []
    for use_mesh in (False, True):
        model = fresh()
        kw = {}
        if use_mesh:
            steps_lib.shard_model(model, partition.param_layout(
                model, mesh, "serve"))
            kw = dict(mesh=mesh, batch=2)
        pre = steps_lib.make_prefill_step(model, max_seq=520,
                                          use_flash=True, **kw)
        dec = steps_lib.make_decode_step(
            model, **(dict(kw, max_seq=520) if kw else {}))
        logits, caches, _ = pre({"tokens": toks})
        outs = [logits]
        tok = logits.argmax(-1)[:, None]
        for s in range(3):
            logits, caches = dec({"token": tok, "index": 512 + s,
                                  "caches": caches})
            tok = logits.argmax(-1)[:, None]
            outs.append(logits)
        runs.append((outs, caches))
        del model
    for i, (a, b) in enumerate(zip(runs[0][0], runs[1][0])):
        if not torch.equal(a, b):
            diffs.append(f"serve logits {i}")
    for k in ("k", "v", "pos"):
        if not torch.equal(runs[0][1][0][0][k], runs[1][1][0][0][k]):
            diffs.append(f"serve cache {k}")
    return {"diffs": diffs, "backend": group.name}


def sharding_phases(card: str):
    """Phase 15: model land across ranks (see the module docstring)."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.core.sharded import spawn
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    from repro_torch.kernels.rwkv6 import rwkv6 as wkv_k
    from repro_torch import compat

    import glob
    import math

    t15 = time.perf_counter()
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    # 15e starts first, on the host (a fake group of 256: its own process)
    out_dir = os.path.join(ROOT, "build", "chip_smoke_dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH"))
        if p))
    dry_cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               "yi-9b", "--shape", "decode_32k", "--out", out_dir]
    dry = subprocess.Popen(dry_cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    # the dry run of 15a's and 15b's cells, held to their measured peaks
    cell_dry = {}
    for name, cargs in MESH_DRY_CELLS.items():
        cdir = os.path.join(out_dir, re.sub(r"\W+", "_", name))
        cell_dry[name] = (cdir, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *cargs,
             "--out", cdir], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    result = {}
    log(f"[mesh] f32 products of the served tensor-parallel regions: "
        f"{compat.f32_product_route(dev)} (torch {torch.__version__})")

    # ---- the kernels at the local-head shapes ----------------------------
    gen = torch.Generator().manual_seed(SEED)
    b, s, h, kv, hd = MESH_FLASH_SHAPE
    q = torch.randn(b, s, h, hd, generator=gen).to(dev, torch.bfloat16)
    k, v = (torch.randn(b, s, kv, hd, generator=gen).to(dev, torch.bfloat16)
            for _ in range(2))
    scale = hd ** -0.5
    got = fa_k.flash_attention_kernel(q, k, v, scale=scale, causal=True)
    want = fa_ref.attention(q, k, v, causal=True, scale=scale)
    atol, rtol = FLASH_TOL["bfloat16"]
    err = (got.float() - want.float()).abs().max().item()
    if not (bool(torch.isfinite(got).all()) and torch.allclose(
            got.float(), want.float(), atol=atol, rtol=rtol)):
        fail(f"flash at the local-head shape {MESH_FLASH_SHAPE}: max_abs_err"
             f" {err} beyond atol {atol} rtol {rtol}")
    ms = event_ms(lambda: fa_k.flash_attention_kernel(
        q, k, v, scale=scale, causal=True), TIMED_CALLS)
    plain_ms = event_ms(lambda: fa_ref.attention(q, k, v, causal=True,
                                                 scale=scale), 3)
    tq, tk, tv = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    sdpa_ms = event_ms(lambda: F.scaled_dot_product_attention(
        tq, tk, tv, is_causal=True, scale=scale, enable_gqa=True),
        TIMED_CALLS)
    nbytes, ops = flash_work(q, k)
    bound, by = bound_of(nbytes, bf16_ops=ops)
    result["flash"] = dict(ms=ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                           bound=bound, by=by, err=err)
    log(f"[mesh] flash at yi-9b's local heads on 2 ranks {MESH_FLASH_SHAPE} "
        f"bf16 causal: max_abs_err {err} against ref.attention (atol {atol}"
        f" rtol {rtol}); {ms:.4f} ms per call, bound {bound:.4f} ms ({by}), "
        f"{ms / bound:.2f} times it; SDPA {sdpa_ms:.4f} ms; plain "
        f"{plain_ms:.3f} ms; {card}")
    del q, k, v, got, want, tq, tk, tv
    b, s, h, hd = MESH_WKV_SHAPE
    args = wkv_inputs(gen, b, s, h, hd, "rwkv", dev)
    bf = [args[0].bfloat16(), args[1].bfloat16(), args[2].bfloat16(),
          args[3], args[4].bfloat16(), args[5]]
    got = wkv_ops.wkv(*bf)
    r, k, v, w, u, s0 = bf
    want = wkv_ref.wkv_chunked(
        *(a.float().transpose(1, 2).reshape(b * h, s, hd)
          for a in (r, k, v, w)),
        u.float()[None].expand(b, h, hd).reshape(b * h, hd),
        s0.reshape(b * h, hd, hd), chunk=wkv_k.CHUNK)
    want = (want[0].reshape(b, h, s, hd).transpose(1, 2),
            want[1].reshape(b, h, hd, hd))
    tol = WKV_TOL["rwkv"]
    werr = max((a - c).abs().max().item() for a, c in zip(got, want))
    if not all(bool(torch.isfinite(a).all()) and torch.allclose(a, c, **tol)
               for a, c in zip(got, want)):
        fail(f"WKV at the local-head shape {MESH_WKV_SHAPE}: max_abs_err "
             f"{werr} beyond {tol}")
    wms = event_ms(lambda: wkv_ops.wkv(*bf), TIMED_CALLS)
    wplain_ms = event_ms(lambda: wkv_k._plain(*bf, wkv_k.CHUNK), 3)
    wbytes, wf32, wtc = wkv_work(b, h, s, hd, wkv_k.CHUNK, 2)
    wbound, wby = bound_of(wbytes, f32_ops=wf32, tf32_ops=wtc)
    result["wkv"] = dict(ms=wms, plain_ms=wplain_ms, bound=wbound, by=wby,
                         err=werr)
    log(f"[mesh] WKV at rwkv6-3b's local heads on 2 ranks {MESH_WKV_SHAPE} "
        f"bf16 r, k, v: max_abs_err {werr} against wkv_chunked ({tol}); "
        f"{wms:.4f} ms per call, bound {wbound:.4f} ms ({wby}), "
        f"{wms / wbound:.2f} times it; plain {wplain_ms:.3f} ms; {card}")
    del args, bf, got, want

    # ---- the one-rank runs the ranks are held to ---------------------------
    one_yi = _yi_serve(dev)
    one_rwkv = _rwkv_prefill(dev)
    one_rwkv32 = _rwkv_prefill(dev, f32=True)
    one_olmoe = _olmoe_train(dev)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 15a-15c on 2 ranks sharing the card -------------------------------
    t = time.perf_counter()
    ranks = spawn(_mesh_rank_15, MESH_RANKS, "gloo", "cuda",
                  timeout=MESH_TIMEOUT)
    log(f"[mesh] 15a-15c: {MESH_RANKS} ranks on one card, backend "
        f"{ranks[0]['backend']}, in {time.perf_counter() - t:.1f} s; {card}")
    # 15a
    yi = [r["15a"] for r in ranks]
    for r, info in enumerate(yi):
        if info["launches"].get("flash_attention") != 48 or \
                info["decode_launches"].get("flash_attention"):
            fail(f"15a rank {r}: flash launches {info['launches']} in the "
                 f"prefill, {info['decode_launches']} in decode")
        if not torch.equal(info["logits"], yi[0]["logits"]):
            fail(f"15a: rank {r}'s logits differ from rank 0's")
    y_rel = rel_l2(yi[0]["logits"], one_yi["logits"])
    y_same = (yi[0]["logits"].argmax(-1) == one_yi["logits"].argmax(-1)
              ).float().mean().item()
    log(f"[mesh] 15a yi-9b served on (1, 2), the serve rules: prefill "
        f"{DENSE_BATCH} x {DENSE_PROMPT} (flash on 16 q and 2 kv heads a "
        f"rank, 48 launches a rank) in {yi[0]['prefill_s'] * 1e3:.1f} ms "
        f"(the rank's first call {yi[0]['first_s'] * 1e3:.1f} ms), "
        f"{MESH_NEW} decode steps in {yi[0]['decode_s'] * 1e3:.1f} ms; "
        f"one rank: {one_yi['prefill_s'] * 1e3:.1f} and "
        f"{one_yi['decode_s'] * 1e3:.1f} ms; last-position logits relative "
        f"L2 {y_rel:.4e} from the one-rank prefill (limit {DENSE_BF16_TOL})"
        f", next token equal in {y_same:.2f} of rows; finite "
        f"{all(i['finite'] for i in yi)}; {card}")
    pc, ph, dc, dh = yi[0]["collectives"]
    log(f"[mesh] 15a rank 0's collectives over model: prefill {pc} "
        f"({ph * 1e3:.1f} ms of host, its wait for the device and the other "
        f"rank included, of {yi[0]['prefill_s'] * 1e3:.1f} ms), decode "
        f"{dc} in {MESH_NEW} steps ({dh * 1e3:.1f} ms of "
        f"{yi[0]['decode_s'] * 1e3:.1f} ms)")
    log(f"[mesh] 15a greedy tokens (row 0): 2 ranks "
        f"{yi[0]['tokens'][0].tolist()}, one rank "
        f"{one_yi['tokens'][0].tolist()}")
    for r, info in enumerate(yi):
        log(f"[mesh] 15a rank {r}: peak device memory {info['peak']} B "
            f"({info['peak'] / 2**30:.2f} GiB) beside {info['held']} B "
            f"({info['held'] / 2**30:.2f} GiB) the rules give it (its "
            f"blocks of the weights and the caches); while it drew its "
            f"blocks {info['build_peak']} B "
            f"({info['build_peak'] / 2**30:.2f} GiB, its weights "
            f"{info['weights'] / 2**30:.2f} GiB); one rank "
            f"{one_yi['peak'] / 2**30:.2f} GiB beside "
            f"{one_yi['held'] / 2**30:.2f} GiB, "
            f"{one_yi['build_peak'] / 2**30:.2f} GiB while it drew the "
            f"model")
        if info["build_peak"] >= one_yi["weights"]:
            fail(f"15a rank {r}: {info['build_peak']} B while drawing its "
                 f"blocks, not below the whole model's "
                 f"{one_yi['weights']} B")
    if y_rel > DENSE_BF16_TOL or not all(i["finite"] for i in yi):
        fail(f"15a: the (1, 2) prefill's logits lie {y_rel} from the "
             f"one-rank prefill's (limit {DENSE_BF16_TOL})")
    # 15c
    rw = [r["15c"] for r in ranks]
    for r, info in enumerate(rw):
        if info["launches"].get("wkv") != 32:
            fail(f"15c rank {r}: WKV launches {info['launches']}")
    c_logits = rel_l2(rw[0]["logits"], one_rwkv["logits"])
    c_state = rel_l2(torch.cat([i["wkv"] for i in rw], dim=2),
                     one_rwkv["wkv"])
    log(f"[mesh] 15c rwkv6-3b prefill on (1, 2) ({SERVE_BATCH} x "
        f"{SERVE_PROMPT}, the WKV kernel on 20 local heads, 32 launches a "
        f"rank) in {rw[0]['prefill_s'] * 1e3:.1f} ms (one rank "
        f"{one_rwkv['prefill_s'] * 1e3:.1f} ms): last-position logits "
        f"relative L2 {c_logits:.4e} (limit {SERVE_BF16_TOL['logits']}), "
        f"the ranks' wkv states of layer 0..31 put together {c_state:.4e} "
        f"(limit {SERVE_BF16_TOL['state']}) from the one-rank prefill; "
        f"{card}")
    if c_logits > SERVE_BF16_TOL["logits"] or \
            c_state > SERVE_BF16_TOL["state"]:
        fail("15c: the (1, 2) rwkv6-3b prefill lies beyond phase 7b's "
             "limits from the one-rank prefill")
    rw32 = [r["15c_f32"] for r in ranks]
    for r, info in enumerate(rw32):
        if info["launches"].get("wkv") != 32:
            fail(f"15c f32 rank {r}: WKV launches {info['launches']}")
    f_logits = rel_l2(rw32[0]["logits"], one_rwkv32["logits"])
    f_state = rel_l2(torch.cat([i["wkv"] for i in rw32], dim=2),
                     one_rwkv32["wkv"])
    log(f"[mesh] 15c f32 twin (weights and activations f32, the f32 WKV "
        f"kernel on 20 local heads) on (1, 2) in "
        f"{rw32[0]['prefill_s'] * 1e3:.1f} ms (one rank "
        f"{one_rwkv32['prefill_s'] * 1e3:.1f} ms): last-position logits "
        f"relative L2 {f_logits:.4e}, wkv states {f_state:.4e} from the "
        f"one-rank f32 prefill (limit {SERVE_F32_TOL}); {card}")
    if max(f_logits, f_state) > SERVE_F32_TOL:
        fail("15c: the (1, 2) f32 rwkv6-3b prefill lies beyond "
             "SERVE_F32_TOL from the one-rank f32 prefill")
    # 15b
    one_ce = [m["ce"] for m in one_olmoe["metrics"]]
    one_gn = [m["grad_norm"] for m in one_olmoe["metrics"]]
    log(f"[mesh] 15b olmoe-1b-7b full width, {MESH_TRAIN_LAYERS} layers, "
        f"one rank: ce {[round(x, 5) for x in one_ce]}, gnorm "
        f"{[round(x, 5) for x in one_gn]}, {one_olmoe['wall']:.2f} s, peak "
        f"{one_olmoe['peak'] / 2**30:.2f} GiB")
    for shape, tol in MESH_TRAIN_TOL.items():
        runs = [r["15b"][shape] for r in ranks]
        for r, info in enumerate(runs):
            if info["metrics"] != runs[0]["metrics"]:
                fail(f"15b {shape}: rank {r} reports other metrics")
        ce = [m["ce"] for m in runs[0]["metrics"]]
        gn = [m["grad_norm"] for m in runs[0]["metrics"]]
        d_ce = max(abs(a - c) for a, c in zip(ce, one_ce))
        d_gn = max(abs(a - c) / c for a, c in zip(gn, one_gn))
        finite = all(math.isfinite(x) for x in ce + gn)
        how = ("ZeRO-1 over data" if shape[0] > 1
               else "heads and experts over model")
        log(f"[mesh] 15b {shape} ({'EP, ' if runs[0]['ep'] else ''}"
            f"{how}): ce {[round(x, 5) for x in ce]}, gnorm "
            f"{[round(x, 5) for x in gn]}; from one rank: ce {d_ce:.4e} "
            f"(limit {tol['ce']}), gnorm {d_gn:.4e} relative (limit "
            f"{tol['gnorm']}); {runs[0]['wall']:.2f} s; peak per rank "
            f"{[round(i['peak'] / 2**30, 2) for i in runs]} GiB beside the "
            f"state the rules give it "
            f"{[round(i['held'] / 2**30, 2) for i in runs]} GiB, while it "
            f"drew its blocks "
            f"{[round(i['build_peak'] / 2**30, 2) for i in runs]} GiB; "
            f"{card}")
        if not finite or d_ce > tol["ce"] or d_gn > tol["gnorm"]:
            fail(f"15b {shape}: beyond the limits from the one-rank run")
        if shape == (1, MESH_RANKS) and not runs[0]["ep"]:
            fail("15b (1, 2): expert parallelism did not apply")

    # ---- 15d: a (1, 1) mesh over NCCL == the mesh-less steps --------------
    t = time.perf_counter()
    one = spawn(_mesh_rank_15d, 1, "nccl", "cuda:0", timeout=MESH_TIMEOUT)[0]
    if one["diffs"]:
        fail(f"15d: the (1, 1) mesh differs from the mesh-less steps: "
             f"{one['diffs'][:8]}")
    log(f"[mesh] 15d: a (1, 1) mesh over {one['backend']} equals the "
        f"mesh-less steps bit for bit: 2 train steps (metrics, parameters, "
        f"moments), the flash prefill and 3 decode steps (logits, caches); "
        f"yi-9b full width, {MESH_EQUAL_LAYERS} layers, in "
        f"{time.perf_counter() - t:.1f} s")

    # ---- the dry run of 15a's and 15b's cells against their peaks --------
    measured = {"15a (1, 2)": yi[0]["peak"],
                **{f"15b {shape}": ranks[0]["15b"][shape]["peak"]
                   for shape in ((1, MESH_RANKS), (MESH_RANKS, 1))}}
    for name, (cdir, proc) in cell_dry.items():
        stdout, stderr = proc.communicate(timeout=MESH_TIMEOUT)
        recs = sorted(glob.glob(os.path.join(cdir, "*.json")))
        if proc.returncode != 0 or len(recs) != 1:
            fail(f"the dry run of {name}: rc {proc.returncode}, "
                 f"{stdout[-1000:]} {stderr[-2000:]}")
        with open(recs[0]) as f:
            rec = json.load(f)
        dry_b, peak = rec["peak_bytes_per_device"], measured[name]
        off = (dry_b - peak) / peak
        log(f"[mesh] dry run of {name} ({' '.join(MESH_DRY_CELLS[name])}):"
            f" {dry_b / 2**30:.2f} GiB a rank (arguments "
            f"{rec['argument_bytes'] / 2**30:.2f} + temporaries "
            f"{rec['temp_bytes'] / 2**30:.2f}) against rank 0's measured "
            f"peak {peak / 2**30:.2f} GiB: {off:+.4f} relative (limit "
            f"{MESH_DRY_TOL}); {card}")
        if abs(off) > MESH_DRY_TOL:
            fail(f"the dry run of {name} reads {dry_b} B a rank, "
                 f"{off:+.4f} from the measured peak {peak} B")

    # ---- 15e: the dry run of one production cell ---------------------------
    stdout, stderr = dry.communicate(timeout=MESH_TIMEOUT)
    lines = [ln for ln in stdout.strip().splitlines() if ln]
    if dry.returncode != 0 or not any(ln.startswith("[ok]") and "fits" in ln
                                      for ln in lines):
        fail(f"15e: {' '.join(dry_cmd[1:])}: rc {dry.returncode}, "
             f"{lines[-3:]}, {stderr[-2000:]}")
    for ln in lines:
        log(f"[mesh] 15e {ln}")
    log(f"[mesh] phase 15 in {time.perf_counter() - t15:.1f} s")
    return result


ANALYSIS_PATHS = ("src/repro_torch", "chip_smoke.py", "tests/test_torch_*.py")
ANALYSIS_BASELINE = "analysis_baseline_torch.json"
ANALYSIS_SUMMARY = re.compile(r"repro-lint: (\d+) finding\(s\), (\d+) "
                              r"suppressed, (\d+) stale")


def analysis_phase(card: str) -> None:
    """Phase 16: the port's invariant analyzer (``python -m
    repro_torch.analysis``) in subprocesses — its self-check, then the lint
    of :data:`ANALYSIS_PATHS` against the committed baseline, which must
    report no finding and no stale entry — and its static registry matrix
    against the registries this process imported and ran on the card."""
    import glob
    import torch

    from repro_torch.analysis.engine import collect_python_files
    from repro_torch.analysis.passes.registry import collect_registrations
    from repro_torch.analysis.symbols import load_project
    from repro_torch.core import acceptance as acc_lib
    from repro_torch.core import migration as mig_lib
    from repro_torch.kernels.ga.registry import registered_kernels

    t16 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", *args], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=600)

    check = cli("--selfcheck")
    if check.returncode != 0:
        fail(f"analysis --selfcheck exited {check.returncode}: "
             f"{check.stdout}{check.stderr}")
    log(f"[analysis] {check.stdout.strip()}")
    paths = [p for pat in ANALYSIS_PATHS
             for p in sorted(glob.glob(os.path.join(ROOT, pat)))]
    lint = cli("--baseline", ANALYSIS_BASELINE,
               *(os.path.relpath(p, ROOT) for p in paths))
    summary = ANALYSIS_SUMMARY.search(lint.stdout + lint.stderr)
    if lint.returncode != 0 or summary is None:
        fail(f"analysis lint exited {lint.returncode}:\n{lint.stdout}"
             f"{lint.stderr}")
    found, suppressed, stale = (int(g) for g in summary.groups())
    if found or stale:
        fail(f"analysis: {found} findings, {stale} stale baseline entries:"
             f"\n{lint.stdout}")

    # the static registry matrix against the runtime registries, after the
    # phases above dispatched the pallas impls on the card
    if not torch.cuda.is_available():
        fail("analysis: the registry check needs the card")
    project = load_project(collect_python_files(
        [os.path.join(ROOT, "src", "repro_torch")], root=ROOT))
    regs = collect_registrations(project)
    static = {r.key for r in regs if r.family == "kernel"}
    runtime = set(registered_kernels())
    if static != runtime:
        fail(f"analysis: static kernel matrix != runtime registry: only "
             f"static {sorted(static - runtime)}, only runtime "
             f"{sorted(runtime - static)}")
    for family, table in (("topology", mig_lib.TOPOLOGIES),
                          ("acceptance", acc_lib.ACCEPTANCE_POLICIES)):
        names = {r.key[0] for r in regs if r.family == family}
        if names != set(table):
            fail(f"analysis: static {family} set {sorted(names)} != "
                 f"runtime {sorted(table)}")
    if not set(acc_lib.ACCEPTANCE_POLICIES) <= set(acc_lib.HOST_MIRRORED):
        fail("analysis: a registered policy has no host mirror")
    impls = sorted({k[2] for k in runtime})
    if not {"pallas", "pallas_tiled", "pallas_ref"} <= set(impls):
        fail(f"analysis: the kernel impls are not all registered: {impls}")
    log(f"[analysis] registry: {len(runtime)} kernel cells (impls "
        f"{', '.join(impls)}), {len(mig_lib.TOPOLOGIES)} topologies, "
        f"{len(acc_lib.ACCEPTANCE_POLICIES)} policies: static == runtime")
    log(f"[analysis] findings {found}, suppressed {suppressed}, stale "
        f"{stale}, {time.perf_counter() - t16:.2f} s "
        f"({len(collect_python_files(paths, root=ROOT))} files; card {card})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from torch.nn import functional as F
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import importlib

    from repro_torch import _build, convert, kernels, rand
    from repro_torch.core import (AcceptanceConfig, EAConfig, MigrationConfig,
                                  available_acceptance_policies,
                                  available_topologies, make_f15,
                                  make_rastrigin, make_sphere, make_trap,
                                  run_experiment, run_fused)
    from repro_torch.core import island as island_lib
    from repro_torch.core.problems import default_f15_consts
    from repro_torch.kernels.ga import autotune as _autotune
    from repro_torch.kernels.ga import get_kernel
    from repro_torch.kernels.ga import ref as gen_ref
    from repro_torch.kernels.ga.common import GenerationSpec
    from repro_torch.kernels.rastrigin import f15 as f15_k
    from repro_torch.kernels.rastrigin import ref as f15_ref
    from repro_torch.kernels.trap import ref as trap_ref
    from repro_torch.kernels.trap import trap as trap_k
    gen_k = importlib.import_module("repro_torch.kernels.ga.generation")

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)

    # ---- 1: build, identify the card -------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {len(_build.sources())} sources -> "
        f"{_build.library_path().relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for entry in _build.BUILD_LOG:
        for line in entry.splitlines():
            if line.startswith("==") or "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)

    # ---- 2: trap kernel against its plain version ------------------------
    consts = {"a": 1.0, "b": 2.0, "z": 3.0, "l": 4}
    trap_err = 0.0
    # (n, traps, l, bytes the population starts off 16): the main path's
    # batch, one row, 64 and 65 traps (two rounds of a warp's 32 lanes),
    # rows of 65 bytes, and an (n, L) view of a flat buffer 3 bytes in;
    # then ordered_sum's windows past 64 traps (100, 200, 1000) and its
    # second level (1025 traps: 33 windows)
    for n, n_traps, l, off in ((8 * 256, 40, 4, 0), (1000, 40, 4, 0),
                               (77, 8, 4, 0), (1, 40, 4, 0), (2048, 80, 4, 0),
                               (2048, 64, 4, 0), (2048, 65, 4, 0),
                               (1000, 13, 5, 0), (1000, 40, 4, 3),
                               (2048, 100, 4, 0), (2048, 200, 4, 0),
                               (1000, 1000, 4, 0), (257, 1025, 4, 0)):
        flat = (torch.rand(off + n * n_traps * l, generator=gen) < 0.5).to(
            torch.int8).to(dev)
        pop = flat[off:].view(n, n_traps * l)
        got = trap_k.trap_fitness(dict(consts, l=l), pop, n_traps=n_traps)
        torch.cuda.synchronize()
        want = trap_ref.trap_fitness(pop, n_traps=n_traps, l=l, a=1.0, b=2.0,
                                     z=3.0)
        err = (got - want).abs().max().item()
        log(f"[trap] ({n}, {n_traps} x {l}) base {pop.data_ptr() % 16} off "
            f"16 bit-equal={torch.equal(got, want)} max_abs_err={err}")
        if not torch.equal(got, want):
            fail(f"trap kernel differs from its plain version at "
                 f"({n}, {n_traps} x {l}, base +{off})")
        if (n, n_traps, off) == (8 * 256, 40, 0):
            trap_err = err

    # ---- 2b: F15 kernel against its plain version -----------------------
    f15_consts = convert.f15_consts_from_numpy(default_f15_consts(), dev)

    def random_f15_consts(dim, m):
        groups = dim // m
        q, _ = torch.linalg.qr(torch.randn(groups, m, m, generator=gen,
                                           dtype=torch.float64))
        return {"o": (torch.rand(dim, generator=gen) * 10 - 5).to(dev),
                "perm": torch.randperm(dim, generator=gen).to(
                    torch.int32).to(dev),
                "M": q.to(torch.float32).contiguous().to(dev)}

    def f15_check(tag, c, x, shape=None):
        """The kernel (at the wrapper's launch shape, or at ``shape``)
        against the plain version on x: bit-equal, or fail."""
        got = (f15_k.f15(c, x) if shape is None
               else f15_k.launch(c, x, shape))
        torch.cuda.synchronize()
        want = f15_ref.f15(c, x)
        err = (got - want).abs().max().item()
        diff = int((got != want).sum().item())
        if shape is None:
            shape = f15_k.card_shape(*x.shape, c["M"].shape[1], dev)
        route = (f"sliced, {shape.cols} columns per slice" if shape.cols
                 else f"{shape.groups} groups per batch"
                 + (", z gathered" if shape.gather else ""))
        log(f"[f15] {tag} ({x.shape[0]}, {x.shape[1]}, m {c['M'].shape[1]}) "
            f"{shape.rows} rows per tile, {route}, grid {shape.grid}: "
            f"bit-equal={diff == 0} differing rows={diff} max_abs_err={err}")
        if diff:
            fail(f"F15 kernel differs from its plain version at {tag} "
                 f"{tuple(x.shape)}: {diff} rows")
        return err

    # the shapes of the paths, then the kernel's edges: n of one row, 7,
    # one tile and one row more, a whole wave of tiles and one row more;
    # odd m (the scalar route) and m = 64; a D so wide a tile is one row;
    # ordered_sum's windows past 64 terms of a group (m 65, 100) and past
    # 32 groups (100 groups of 10); then the shapes whose rows it cannot
    # stage, one launch each: z gathered from device memory (D 60,000 and
    # 51,950 at m 50; m 169 at D 6 x 169) and the sliced route (m 200, 500
    # and 1000 at D 1000, slices that start ordered_sum's windows: m 1000
    # at 512 columns in slices of 500 and 500; one row; a ragged last tile)
    fig4_shape = f15_k.card_shape(10000, 1000, 50, dev)
    f15_err = 0.0
    f15_routes = {}
    for tag, rows_n, dim, m in (
            ("paths", 10000, 1000, 50), ("paths", 1000, 1000, 50),
            ("paths", 256, 200, 20), ("edge", 1, 1000, 50),
            ("edge", 7, 1000, 50), ("one tile", fig4_shape.rows, 1000, 50),
            ("one tile + 1", fig4_shape.rows + 1, 1000, 50),
            ("a wave + 1", fig4_shape.grid * fig4_shape.rows + 1, 1000, 50),
            ("odd m", 1000, 91, 7), ("odd m", 1000, 91, 13),
            ("m 64", 1000, 1024, 64), ("wide", 5, 40000, 50),
            ("sum order m 65", 1000, 130, 65),
            ("sum order m 100", 1000, 300, 100),
            ("sum order 100 groups", 1000, 1000, 10)) \
            + F15_ROUTE_CASES:
        c = f15_consts if (dim, m) == (1000, 50) else random_f15_consts(dim,
                                                                        m)
        x = (torch.rand(rows_n, dim, generator=gen) * 10 - 5).to(dev)
        shape = f15_k.card_shape(rows_n, dim, m, dev)
        before = kernels.LAUNCHES["f15"]
        err = f15_check(tag, c, x)
        if kernels.LAUNCHES["f15"] != before + 1:
            fail(f"F15 at {tag} ({rows_n}, {dim}, m {m}): not one launch")
        if tag == "wide" and shape.rows != 1:
            fail("F15 at D 40000: the tile is not one row")
        if tag.startswith("gathered") != shape.gather \
                or tag.startswith("sliced") != (shape.cols > 0):
            fail(f"F15 at ({rows_n}, {dim}, m {m}) took another route than "
                 f"{tag}: {shape}")
        if tag.startswith(("gathered", "sliced")):
            smem = _build.library().f15_smem_bytes(
                shape.rows, dim, m, shape.groups, shape.cols,
                int(shape.gather))
            if smem != shape.smem:
                fail(f"F15 {tag} shared memory: the kernel counts {smem} "
                     f"bytes, the wrapper {shape.smem}")
            if rows_n == 2048:
                f15_routes[(dim, m)] = (c, x, shape)
        if rows_n == 10000:
            f15_err, f15_fig4 = err, (c, x)
    # every tile height phase 6 sweeps, at Fig. 4's shape, and the kernel's
    # shared memory against the wrapper's count
    for rows in F15_SWEEP_ROWS:
        shape = f15_k.card_shape(10000, 1000, 50, dev, rows=rows)
        smem = _build.library().f15_smem_bytes(rows, 1000, 50, shape.groups,
                                               0, 0)
        if smem != shape.smem:
            fail(f"F15 shared memory: the kernel counts {smem} bytes, the "
                 f"wrapper {shape.smem}")
        f15_check("sweep", *f15_fig4, shape)

    # ---- 3: generation kernel against its plain version ------------------
    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    n_isl, n, length = 8, 256, 160
    fused_specs = {
        "none": None,
        "trap": (("a", 1.0), ("b", 2.0), ("eval", "trap"), ("l", 4),
                 ("z", 3.0)),
        "onemax": (("eval", "onemax"),),
        "royal_road": (("eval", "royal_road"), ("r", 8)),
    }
    main_inputs = None
    gen_err = 0.0
    for selection in ("tournament", "roulette"):
        for crossover in ("two_point", "uniform"):
            for fname, fused in fused_specs.items():
                spec = GenerationSpec(
                    kind="binary", length=length, elite=2,
                    selection=selection, tournament_k=2, crossover=crossover,
                    crossover_rate=0.9, mutation_rate=1.0 / length,
                    mutation_sigma=0.3, fused_eval=fused)
                pop = (torch.rand(n_isl, n, length, generator=gen) < 0.5).to(
                    torch.int8).to(dev)
                fit = (torch.randn(n_isl, n, generator=gen) * 10).to(dev)
                size = torch.randint(128, 257, (n_isl,), generator=gen,
                                     dtype=torch.int32).to(dev)
                seed = torch.randint(0, 2**32, (n_isl, 2), generator=gen,
                                     dtype=torch.int64).to(dev)
                got = gen_k.generation_kernel(seed, size, pop, fit, spec)
                torch.cuda.synchronize()
                want = gen_ref.generation(seed, size, pop, fit, spec)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                rows = int((got[0] != want[0]).any(-1).sum().item())
                err = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip(got, want))
                fit_eq = len(got) == 1 or torch.equal(got[1], want[1])
                log(f"[generation] {selection}/{crossover}/{fname}: "
                    f"pop bit-equal={rows == 0} differing rows={rows} "
                    f"fitness equal={fit_eq} max_abs_err={err}")
                # bit equality in every case, roulette included: the kernel
                # and the plain version both scan its f32 CDF left to right
                if rows or not fit_eq:
                    fail(f"generation kernel differs: {selection}/"
                         f"{crossover}/{fname}, {rows} rows")
                if (selection, crossover, fname) == ("tournament",
                                                     "two_point", "trap"):
                    main_inputs = (seed, size, pop, fit, spec)
                    gen_err = err

    def edge_case(kind, n_isl, n, length, fitness, offset=0):
        """seed, size, pop and fit of an edge case on the card. fitness:
        "random" (normal, -inf lanes and a run of ties), "tied" (one value),
        "masked" (pop_size 0 and 1 on the first islands, every lane -inf
        on the last). offset: pop starts that many bytes into its buffer."""
        if kind == "binary":
            host = (torch.rand(n_isl, n, length, generator=gen) < 0.5).to(
                torch.int8)
        else:
            host = torch.rand(n_isl, n, length, generator=gen) * 10 - 5
        pop = torch.empty(offset + host.numel(), dtype=host.dtype,
                          device=dev)[offset:].view(host.shape).copy_(host)
        fit = torch.randn(n_isl, n, generator=gen) * 10
        size = torch.randint(max(1, n // 2), n + 1, (n_isl,), generator=gen,
                             dtype=torch.int32)
        if fitness == "random":
            fit[:, 1:4] = float("-inf")
            fit[:, 5:9] = fit[:, 10:11]
        elif fitness == "tied":
            fit[:] = 2.5
        else:
            size[0], size[1 % n_isl] = 0, 1
            fit[-1] = float("-inf")
        seed = torch.randint(0, 2**32, (n_isl, 2), generator=gen,
                             dtype=torch.int64)
        return seed.to(dev), size.to(dev), pop, fit.to(dev)

    # the binary kernel at its edges; it runs min(16, n) CTAs per island,
    # so n = 1, 3, 5 and 8 run clusters of 1, 3, 5 and 8 CTAs and the rest
    # 16: n not a multiple of 16 (CTAs with fewer rows or none), L not a
    # multiple of 4 or 16, islands off 16 bytes (odd n * L, odd starts),
    # all-masked and all-tied fitness, a tile under 16 bytes, 4 elite rows
    # over several CTAs, and the largest island at L = 160 that routes
    # untiled
    binary_edges = [
        (3, 250, 160, "trap", "random", 0, 2),
        (3, 100, 157, "onemax", "tied", 0, 2),
        (4, 37, 39, "royal_road3", "masked", 1, 2),
        (2, 61, 13, "none", "random", 3, 4),
        (2, 3, 4, "onemax", "masked", 5, 2),
        (2, 5, 40, "trap", "tied", 0, 1),
        (3, 8, 40, "trap", "tied", 1, 2),
        (3, 1, 40, "onemax", "masked", 3, 1),
        (2, 1227, 160, "trap", "random", 0, 2),
        (2, 64, 400, "trap", "random", 0, 2),
        (2, 64, 800, "trap", "tied", 0, 2),
        (2, 32, 4100, "trap", "random", 0, 2),
    ]
    edge_evals = dict(fused_specs, royal_road3=(("eval", "royal_road"),
                                                ("r", 3)))
    for n_e, n_r, l_e, fname, fitness, offset, elite in binary_edges:
        for selection, crossover in (("tournament", "two_point"),
                                     ("roulette", "uniform")):
            spec = GenerationSpec(
                kind="binary", length=l_e, elite=elite, selection=selection,
                tournament_k=3, crossover=crossover, crossover_rate=0.9,
                mutation_rate=0.05, mutation_sigma=0.3,
                fused_eval=edge_evals[fname])
            args = edge_case("binary", n_e, n_r, l_e, fitness, offset)
            want = as_tuple(gen_ref.generation(*args, spec))
            got = as_tuple(gen_k.generation_kernel(*args, spec))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"generation kernel differs at the edge {n_e}x{n_r}x"
                     f"{l_e} {fname} {fitness} offset {offset} elite "
                     f"{elite} {selection}/{crossover}, "
                     f"{gen_k.cluster_size(n_r)} CTAs per island")
            log(f"[generation] edge {n_e}x{n_r}x{l_e} {fname}, {fitness} "
                f"fitness, pop at byte {offset}, elite {elite}, {selection}/"
                f"{crossover}: bit-equal at {gen_k.cluster_size(n_r)} CTAs "
                f"per island")

    # ---- 3b: float generation kernel against its plain version -----------
    f_len = 1000
    float_problems = {"none": make_rastrigin(f_len),
                      "rastrigin": make_rastrigin(f_len),
                      "sphere": make_sphere(f_len),
                      "f15": make_f15(device=dev)}
    float_inputs = None
    float_err = 0.0
    for selection in ("tournament", "roulette"):
        for crossover in ("two_point", "uniform", "blend"):
            for fname, prob in float_problems.items():
                g = prob.genome
                spec = GenerationSpec(
                    kind="float", length=f_len, elite=2,
                    selection=selection, tournament_k=2, crossover=crossover,
                    crossover_rate=0.9, mutation_rate=1.0 / f_len,
                    mutation_sigma=0.3, low=g.low, high=g.high,
                    fused_eval=(None if fname == "none"
                                else tuple(sorted(prob.fused.items()))))
                pop = (torch.rand(n_isl, n, f_len, generator=gen)
                       * (g.high - g.low) + g.low).to(dev)
                fit = prob.evaluate(prob.consts, pop.reshape(-1, f_len)
                                    ).reshape(n_isl, n)
                size = torch.randint(128, 257, (n_isl,), generator=gen,
                                     dtype=torch.int32).to(dev)
                seed = torch.randint(0, 2**32, (n_isl, 2), generator=gen,
                                     dtype=torch.int64).to(dev)
                got = gen_k.generation_kernel(seed, size, pop, fit, spec,
                                              prob.consts)
                torch.cuda.synchronize()
                want = gen_ref.generation(seed, size, pop, fit, spec,
                                          prob.consts)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                genes = int((got[0] != want[0]).sum().item())
                err = max((a - b).abs().max().item()
                          for a, b in zip(got, want))
                fit_eq = len(got) == 1 or torch.equal(got[1], want[1])
                log(f"[generation_float] {selection}/{crossover}/{fname}: "
                    f"pop bit-equal={genes == 0} differing genes={genes} "
                    f"fitness equal={fit_eq} max_abs_err={err}")
                if genes or not fit_eq:
                    fail(f"float generation kernel differs: {selection}/"
                         f"{crossover}/{fname}, {genes} genes")
                if (selection, crossover, fname) == ("tournament", "blend",
                                                     "f15"):
                    float_inputs = (seed, size, pop, fit, spec, prob.consts)
                    float_err = err

    # the float kernel with fused F15 at its edges: n not a multiple of the
    # rows, m = 7 and 13 (not a multiple of the tail's 4 columns),
    # all-masked and all-tied fitness, the largest island at L = 1000 that
    # routes untiled, and genomes wide enough that the wrapper takes 2 rows
    # per block (L = 7300) and 1 (L = 14600); then ordered_sum's windows
    # past 64 terms of a group (m 65, 100) and past 32 groups (100 of 10)
    smem_limit = gen_k.max_smem_bytes(0)
    for n_e, n_r, l_e, m_e, fitness, elite in (
            (3, 250, 91, 7, "random", 2), (2, 61, 91, 13, "tied", 4),
            (4, 37, 35, 7, "masked", 2), (2, 365, 1000, 50, "random", 2),
            (2, 9, 7300, 50, "tied", 2), (2, 5, 14600, 50, "masked", 2),
            (2, 64, 130, 65, "random", 2), (2, 64, 300, 100, "random", 2),
            (2, 64, 1000, 10, "random", 2)):
        c_e = random_f15_consts(l_e, m_e)
        for selection in ("tournament", "roulette"):
            spec = GenerationSpec(
                kind="float", length=l_e, elite=elite, selection=selection,
                tournament_k=2, crossover="blend", crossover_rate=0.9,
                mutation_rate=0.05, mutation_sigma=0.3, low=-5.0, high=5.0,
                fused_eval=(("eval", "f15"), ("m", m_e),
                            ("n_groups", l_e // m_e)))
            args = edge_case("float", n_e, n_r, l_e, fitness)
            want = as_tuple(gen_ref.generation(*args, spec, c_e))
            got = as_tuple(gen_k.generation_kernel(*args, spec, c_e))
            torch.cuda.synchronize()
            rows = gen_k.float_rows(n_r, l_e, elite, smem_limit)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"float generation kernel differs at the edge "
                     f"{n_e}x{n_r}x{l_e} m {m_e} {fitness} elite {elite} "
                     f"{selection}, {rows} rows per block")
            log(f"[generation_float] edge {n_e}x{n_r}x{l_e} F15 m {m_e}, "
                f"{fitness} fitness, elite {elite}, {selection}/blend: "
                f"bit-equal at {rows} rows per block")

    # the fused rastrigin and sphere sums past 64 genes (ordered_sum's
    # windows; 2000 genes: 63 windows, their sums windowed again), one
    # launch each
    for l_s in (65, 100, 1000, 2000):
        for prob in (make_rastrigin(l_s), make_sphere(l_s)):
            g = prob.genome
            spec = GenerationSpec(
                kind="float", length=l_s, elite=2, selection="tournament",
                tournament_k=2, crossover="blend", crossover_rate=0.9,
                mutation_rate=0.05, mutation_sigma=0.3, low=g.low,
                high=g.high, fused_eval=tuple(sorted(prob.fused.items())))
            args = edge_case("float", 2, 64, l_s, "random")
            before = kernels.LAUNCHES["generation_float"]
            got = as_tuple(gen_k.generation_kernel(*args, spec))
            torch.cuda.synchronize()
            want = as_tuple(gen_ref.generation(*args, spec))
            if kernels.LAUNCHES["generation_float"] != before + 1:
                fail(f"float generation at {prob.name}: not one launch")
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"float generation kernel's fused {prob.name} differs "
                     f"from its plain version")
            log(f"[generation_float] sum order {prob.name} 2x64x{l_s}: "
                f"bit-equal, one launch")

    # ---- 3c: the tiled kernel and the roulette-CDF kernel -----------------
    def random_case(kind, n_isl, n, length, selection, crossover, fused,
                    sizes=None, fit=None, elite=2):
        spec = GenerationSpec(
            kind=kind, length=length, elite=elite, selection=selection,
            tournament_k=2, crossover=crossover, crossover_rate=0.9,
            mutation_rate=1.0 / length, mutation_sigma=0.3,
            fused_eval=fused)
        if kind == "binary":
            pop = (torch.rand(n_isl, n, length, generator=gen) < 0.5).to(
                torch.int8).to(dev)
        else:
            pop = (torch.rand(n_isl, n, length, generator=gen) * 10 - 5).to(
                dev)
        if fit is None:
            fit = (torch.randn(n_isl, n, generator=gen) * 10).to(dev)
        size = (torch.full((n_isl,), n, dtype=torch.int32) if sizes is None
                else torch.randint(sizes[0], sizes[1] + 1, (n_isl,),
                                   generator=gen, dtype=torch.int32)).to(dev)
        seed = torch.randint(0, 2**32, (n_isl, 2), generator=gen,
                             dtype=torch.int64).to(dev)
        return (seed, size, pop, fit), spec

    def tiled_check(tag, args, spec, consts=None, rows=None):
        """The tiled kernel (and, under roulette, the CDF kernel) against
        the plain version; fail unless bit-equal. Returns the kernel's
        output and its largest difference."""
        got = as_tuple(tiling_k.generation_tiled(*args, spec, tile_pop=rows,
                                                 consts=consts))
        torch.cuda.synchronize()
        want = as_tuple(gen_ref.generation(*args, spec, consts))
        genes = int((got[0] != want[0]).sum().item())
        fit_eq = len(got) == 1 or torch.equal(got[1], want[1])
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        cdf_eq = True
        if spec.selection == "roulette":
            c_seed, c_size, _, c_fit = args
            got_c = torch.empty_like(c_fit)
            tiling_k.launch_cdf(c_size, c_fit, got_c)   # uncounted
            want_c = common.roulette_cdf(common.masked_fitness(c_fit,
                                                               c_size))
            cdf_eq = torch.equal(got_c, want_c)
            cdf_errs.append((got_c - want_c).abs().max().item())
        log(f"[tiled] {tag}: pop bit-equal={genes == 0} differing genes="
            f"{genes} fitness equal={fit_eq}"
            + (f" CDF equal={cdf_eq}" if spec.selection == "roulette" else "")
            + f" max_abs_err={err}")
        if genes or not fit_eq or not cdf_eq:
            fail(f"tiled kernel differs from its plain version: {tag}")
        return got, err

    tiling_k = importlib.import_module("repro_torch.kernels.ga.tiling")
    from repro_torch.kernels.ga import common
    trap_fused = fused_specs["trap"]
    tiled_err = 0.0
    cdf_errs = []
    # these checks launch the CDF kernel through the tiled path only; the
    # comparison's own launches are uncounted
    kernels.reset_launches()
    for selection in ("tournament", "roulette"):
        for crossover in ("two_point", "uniform"):
            args, spec = random_case("binary", 2, 2048, 160, selection,
                                     crossover, trap_fused, (1024, 2048))
            _, err = tiled_check(f"binary 2x2048x160 trap {selection}/"
                                 f"{crossover}", args, spec)
            tiled_err = max(tiled_err, err)
    # roulette above the reference's 4096-lane selection block
    args, spec = random_case("binary", 1, 4200, 160, "roulette", "two_point",
                             trap_fused, (4000, 4200))
    _, err = tiled_check("binary 1x4200x160 trap roulette/two_point", args,
                         spec)
    tiled_err = max(tiled_err, err)
    args, spec = random_case("binary", 1, 2048, 256, "tournament",
                             "two_point", None)
    tiled_check("binary 1x2048x256 (the reference's roofline shape)", args,
                spec)
    f15_fused = tuple(sorted(float_problems["f15"].fused.items()))
    tiled_fig4 = None
    for selection in ("tournament", "roulette"):
        for fname, fused in (("none", None), ("f15", f15_fused)):
            args, spec = random_case("float", 1, 10000, 1000, selection,
                                     "blend", fused)
            got, err = tiled_check(
                f"float 1x10000x1000 {selection}/blend/{fname}", args, spec,
                consts=f15_consts if fused else None)
            tiled_err = max(tiled_err, err)
            if (selection, fname) == ("tournament", "none"):
                tiled_fig4 = (args, spec, got[0])
    # the kernel's edges: rows off the 16-byte pack (1003 f32, 157 int8)
    # and a population 4 or 5 bytes off 16 (the scalar route), and rows on
    # it at offset 0 (the 16-byte route); 3 elite rows over blocks of 1 and
    # 2 rows; pop_size below n; against the plain version and the untiled
    # kernels
    for kind, l_e, crossover, fname, offset in (
            ("float", 1003, "blend", "rastrigin", 0),
            ("binary", 157, "uniform", "onemax", 0),
            ("float", 1000, "blend", "sphere", 1),
            ("binary", 160, "two_point", "trap", 5),
            ("float", 1000, "blend", "sphere", 0),
            ("binary", 160, "two_point", "trap", 0)):
        fused = (fused_specs[fname] if kind == "binary"
                 else (("eval", fname),))
        for selection in ("tournament", "roulette"):
            args, spec = random_case(kind, 2, 37, l_e, selection, crossover,
                                     fused, (20, 36), elite=3)
            pop_e = args[2]
            pop_e = torch.empty(offset + pop_e.numel(), dtype=pop_e.dtype,
                                device=dev)[offset:].view(
                                    pop_e.shape).copy_(pop_e)
            args = (args[0], args[1], pop_e, args[3])
            untiled = as_tuple(gen_k.generation_kernel(*args, spec))
            for rows in (1, 2, 8):
                got, err = tiled_check(
                    f"edge {kind} 2x37x{l_e} {fname} {selection}/{crossover}"
                    f", elite 3, {rows} rows per block, offset {offset}",
                    args, spec, rows=rows)
                if not all(torch.equal(a, b) for a, b in zip(got, untiled)):
                    fail(f"tiled kernel differs from the untiled one at the "
                         f"edge {kind} L {l_e} {selection}, {rows} rows")
                tiled_err = max(tiled_err, err)
    # the fused rastrigin and sphere sums past 64 genes in ordered_sum's
    # windows (2000 genes: their sums windowed again), 2 rows per block
    for l_s in (1000, 2000):
        for fname in ("rastrigin", "sphere"):
            args, spec = random_case("float", 2, 37, l_s, "tournament",
                                     "blend", (("eval", fname),), (20, 36))
            _, err = tiled_check(f"sum order float 2x37x{l_s} {fname}",
                                 args, spec, rows=2)
            tiled_err = max(tiled_err, err)
    log(f"[tiled] roulette cases: {kernels.LAUNCHES['roulette_cdf']} "
        f"launches of the CDF kernel by the tiled path, each bit-equal to "
        f"the plain CDF (max_abs_err {max(cdf_errs)})")
    # the CDF kernel's edges (uncounted launches): one lane, a segment's
    # edges, the reference's 4096-lane block, Fig. 4's 10,000 lanes, the
    # kernel's 16,384-lane chunk and three chunks; masked lanes at every
    # segment's end, an all-masked island, an island of tied fitness, 8
    # islands of 256 lanes; an island off 16 bytes (the 4-byte route)
    cdf_edges = [(1, n_e, "random") for n_e in
                 (1, 63, 64, 65, 127, 4096, 4097, 10000, 16384, 16385,
                  40000)]
    cdf_edges += [(3, 4200, "segment-ends"), (3, 1000, "all-masked"),
                  (3, 10000, "tied"), (8, 256, "random"), (3, 999, "islands-off-16")]
    for n_isl_e, n_e, fitness in cdf_edges:
        e_fit = torch.randn(n_isl_e, n_e, generator=gen) * 10
        e_size = torch.randint(max(1, n_e // 2), n_e + 1, (n_isl_e,),
                               generator=gen, dtype=torch.int32)
        if fitness == "segment-ends":
            e_fit[:, 63::64] = float("-inf")
            e_fit[:, 4030:4096] = float("-inf")
        elif fitness == "all-masked":
            e_fit[0] = float("-inf")
            e_size[1] = 0
        elif fitness == "tied":
            e_fit[:] = 2.5
        e_fit, e_size = e_fit.to(dev), e_size.to(dev)
        got_c = torch.empty_like(e_fit)
        tiling_k.launch_cdf(e_size, e_fit, got_c)   # uncounted
        want_c = common.roulette_cdf(common.masked_fitness(e_fit, e_size))
        cdf_eq = torch.equal(got_c, want_c)
        rising = bool((got_c[:, 1:] >= got_c[:, :-1]).all())
        cdf_errs.append((got_c - want_c).abs().max().item())
        log(f"[tiled] CDF edge {n_isl_e}x{n_e} {fitness}: bit-equal="
            f"{cdf_eq} non-decreasing={rising}")
        if not (cdf_eq and rising):
            fail(f"the CDF kernel differs from the plain CDF or decreases at"
                 f" {n_isl_e}x{n_e} {fitness}")
    # the tiled path's F15 (the tiled kernel, then the F15 kernel and its
    # register-blocked tail) at m = 7 and 50
    for m_e, groups in ((7, 143), (50, 20)):
        c_e = random_f15_consts(m_e * groups, m_e)
        fused = (("eval", "f15"), ("m", m_e), ("n_groups", groups))
        args, spec = random_case("float", 2, 1003, m_e * groups,
                                 "tournament", "blend", fused)
        got, err = tiled_check(f"float 2x1003x{m_e * groups} tournament/"
                               f"blend/f15 m {m_e}", args, spec, consts=c_e)
        untiled = as_tuple(gen_k.generation_kernel(*args, spec, c_e))
        if not all(torch.equal(a, b) for a, b in zip(got, untiled)):
            fail(f"tiled F15 path differs from the untiled kernel at m {m_e}")
        tiled_err = max(tiled_err, err)
    # the tiled kernel equals the untiled ones at the main paths' shapes
    for tag, inputs in (("binary 8x256x160 trap", main_inputs + (None,)),
                        ("float 8x256x1000 f15", float_inputs)):
        *args, spec, u_consts = inputs
        untiled = as_tuple(gen_k.generation_kernel(*args, spec, u_consts))
        tiled = as_tuple(tiling_k.generation_tiled(*args, spec,
                                                   consts=u_consts))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(tiled, untiled))
        log(f"[tiled] {tag}: tiled == untiled kernel (genes and fitness) "
            f"{same}")
        if not same:
            fail(f"tiled kernel differs from the untiled one: {tag}")
    # any rows per block give the same bits
    args, spec, base = tiled_fig4
    for rows in (1, 7, 32):
        other = tiling_k.generation_tiled(*args, spec, tile_pop=rows)
        torch.cuda.synchronize()
        log(f"[tiled] float 1x10000x1000, {rows} rows per block: identical "
            f"to the autotuned rows {torch.equal(other, base)}")
        if not torch.equal(other, base):
            fail(f"tiled kernel output depends on the rows per block ({rows})")

    # ---- 4: the main path at the paper's configuration -------------------
    cfg = EAConfig(impl="pallas", max_pop=256, min_pop=128,
                   generations_per_epoch=100)
    mig = MigrationConfig(topology="pool")
    problem = make_trap(40, 4, impl="pallas")

    def drive(problem, cfg, n_islands, max_epochs, seed):
        t = time.perf_counter()
        out = run_fused(problem, cfg, mig, n_islands=n_islands,
                        max_epochs=max_epochs, rng=seed, w2=True,
                        return_stats=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    drive(problem, cfg, 8, 1, SEED + 1)              # warm-up, not counted
    kernels.reset_launches()
    run, wall = drive(problem, cfg, 8, 5, SEED)
    islands, pool, epochs, stats = run
    launches = dict(kernels.LAUNCHES)
    evals = int(islands.evaluations.sum().item())
    log(f"[main] kernels: 8 islands x 5 epochs: {evals} evaluations in "
        f"{wall:.3f} s = {evals / wall:.1f} evals/s, {wall / 5:.4f} s per "
        f"epoch; launches {launches}; best "
        f"{islands.best_fitness.max().item()}")
    if min(launches["trap_fitness"], launches["generation"]) <= 0:
        fail(f"a kernel of the main path was never launched: {launches}")

    ref_cfg = EAConfig(impl="pallas_ref", max_pop=256, min_pop=128,
                       generations_per_epoch=100)
    kernels.reset_launches()
    r_run, r_wall = drive(make_trap(40, 4), ref_cfg, 8, 5, SEED)
    r_evals = int(r_run[0].evaluations.sum().item())
    log(f"[main] plain: {r_evals} evaluations in {r_wall:.3f} s = "
        f"{r_evals / r_wall:.1f} evals/s; launches {dict(kernels.LAUNCHES)}")
    if max(kernels.LAUNCHES.values()) != 0:
        fail("the plain run launched a kernel")
    same_run("main path", run, r_run)
    log(f"[main] kernel run == plain run: islands, pool, stats "
        f"({convert.to_numpy(stats).best_fitness.tolist()} best per epoch)")
    if not bool(torch.isfinite(islands.best_fitness).all()):
        fail("non-finite best fitness")
    step_profile("main", islands, problem, cfg,
                 kernel="::generation_kernel(")

    # ---- 4b: the paper's F15 path ----------------------------------------
    f_cfg = EAConfig(impl="pallas", max_pop=256, min_pop=128,
                     generations_per_epoch=100, crossover="blend",
                     mutation_sigma=0.3)
    f_problem = make_f15(impl="pallas")
    f_kernels = ("f15", "generation_float")
    kernels.reset_launches()
    f_run, f_wall = drive(f_problem, f_cfg, 8, 2, SEED)
    log(f"[f15-main] kernels: 8 islands x 2 epochs in {f_wall:.3f} s; "
        f"launches {dict(kernels.LAUNCHES)}")
    if min(kernels.LAUNCHES[k] for k in f_kernels) <= 0:
        fail(f"a kernel of the F15 path was never launched: "
             f"{dict(kernels.LAUNCHES)}")
    kernels.reset_launches()
    fr_run, fr_wall = drive(make_f15(), EAConfig(
        impl="pallas_ref", max_pop=256, min_pop=128,
        generations_per_epoch=100, crossover="blend", mutation_sigma=0.3),
        8, 2, SEED)
    log(f"[f15-main] plain: 8 islands x 2 epochs in {fr_wall:.3f} s; "
        f"launches {dict(kernels.LAUNCHES)}")
    if max(kernels.LAUNCHES.values()) != 0:
        fail("the plain F15 run launched a kernel")
    same_run("F15 path", f_run, fr_run)
    log(f"[f15-main] kernel run == plain run: islands, pool, stats "
        f"({convert.to_numpy(f_run[3]).best_fitness.tolist()} best per "
        f"epoch)")
    kernels.reset_launches()
    (f_isl, _, _, _), f_wall5 = drive(f_problem, f_cfg, 8, 5, SEED)
    f_launches = dict(kernels.LAUNCHES)
    f_evals = int(f_isl.evaluations.sum().item())
    log(f"[f15-main] kernels: 8 islands x 5 epochs: {f_evals} evaluations "
        f"in {f_wall5:.3f} s = {f_evals / f_wall5:.1f} evals/s, "
        f"{f_wall5 / 5:.4f} s per epoch; launches {f_launches}; best "
        f"{f_isl.best_fitness.max().item()}")
    if min(f_launches[k] for k in f_kernels) <= 0:
        fail(f"a kernel of the F15 path was never launched: {f_launches}")
    if not bool(torch.isfinite(f_isl.best_fitness).all()):
        fail("non-finite best fitness on the F15 path")
    step_profile("f15-main", f_isl, f_problem, f_cfg,
                 kernel="generation_float_kernel")

    # ---- 4c: both paths under impl="pallas_tiled" --------------------------
    def tiled_launches_ok(tag, launches):
        """Under tournament the tiled kernel is a generation's one launch:
        no CDF kernel, no untiled kernel."""
        if launches["generation_tiled"] <= 0 or max(
                launches["roulette_cdf"], launches["generation"],
                launches["generation_float"]) != 0:
            fail(f"{tag}: want the tiled kernel alone, got {launches}")

    t_cfg = dataclasses.replace(cfg, impl="pallas_tiled")
    drive(problem, t_cfg, 8, 1, SEED + 1)   # warm-up, autotune sweep
    kernels.reset_launches()
    t_run, t_wall = drive(problem, t_cfg, 8, 5, SEED)
    t_launches = dict(kernels.LAUNCHES)
    tiled_launches_ok("paper-8 pallas_tiled", t_launches)
    same_run("paper-8 pallas_tiled vs pallas", t_run, run)
    t_evals = int(t_run[0].evaluations.sum().item())
    log(f"[tiled-main] paper-8 pallas_tiled: {t_evals} evaluations in "
        f"{t_wall:.3f} s = {t_evals / t_wall:.1f} evals/s (pallas "
        f"{evals / wall:.1f}); launches {t_launches}; islands, pool, stats "
        f"== the pallas run")
    step_profile("tiled-main", t_run[0], problem, t_cfg)

    tf_cfg = dataclasses.replace(f_cfg, impl="pallas_tiled")
    drive(f_problem, tf_cfg, 8, 1, SEED + 1)   # warm-up, autotune sweep
    kernels.reset_launches()
    tf_run, tf_wall = drive(f_problem, tf_cfg, 8, 2, SEED)
    tf_launches = dict(kernels.LAUNCHES)
    tiled_launches_ok("paper-f15-8 pallas_tiled", tf_launches)
    if tf_launches["f15"] <= 0:
        fail(f"paper-f15-8 pallas_tiled: the F15 kernel never launched: "
             f"{tf_launches}")
    same_run("paper-f15-8 pallas_tiled vs pallas", tf_run, f_run)
    tf_evals = int(tf_run[0].evaluations.sum().item())
    f2_evals = int(f_run[0].evaluations.sum().item())
    log(f"[tiled-f15-main] paper-f15-8 pallas_tiled: 8 islands x 2 epochs: "
        f"{tf_evals} evaluations in {tf_wall:.3f} s = "
        f"{tf_evals / tf_wall:.1f} evals/s (pallas, first 2-epoch run: "
        f"{f2_evals / f_wall:.1f}; 5 epochs: {f_evals / f_wall5:.1f}); "
        f"launches {tf_launches}; islands, pool, stats == the pallas run")
    step_profile("tiled-f15-main", tf_run[0], f_problem, tf_cfg)

    # evals/s of both impls in turns (pallas, tiled, tiled, pallas), 5
    # epochs each: one call's host spread between runs is wider than the
    # difference a single pair of runs could show
    for tag, prob, p_cfg, p_tiled in (("paper-8", problem, cfg, t_cfg),
                                      ("paper-f15-8", f_problem, f_cfg,
                                       tf_cfg)):
        rates = []
        for c in (p_cfg, p_tiled, p_tiled, p_cfg):
            (isl, _, _, _), w = drive(prob, c, 8, 5, SEED)
            rates.append(f"{c.impl} {isl.evaluations.sum().item() / w:.1f}")
        log(f"[tiled-turns] {tag} evals/s in turns: " + "; ".join(rates))

    # ---- 4d: Fig. 4's row: one fused generation+F15 step, 10,000 x 1000 ---
    fig4_problem = float_problems["f15"]
    fig4_cfg = EAConfig(max_pop=10000, min_pop=8, crossover="blend",
                        mutation_sigma=0.3)
    g4 = fig4_problem.genome
    fig4_pop = (torch.rand(1, 10000, f_len, generator=gen)
                * (g4.high - g4.low) + g4.low).to(dev)
    fig4_fit = fig4_problem.evaluate(fig4_problem.consts,
                                     fig4_pop[0])[None]
    fig4_args = (rand.key(1, device=dev)[None], fig4_pop, fig4_fit,
                 torch.tensor([10000], dtype=torch.int32, device=dev),
                 fig4_cfg, g4, fig4_problem.fused)
    fig4_kern = get_kernel("generation_eval", "float", "pallas")

    def fig4_call():
        return fig4_kern(*fig4_args, consts=fig4_problem.consts)

    fig4_call()                              # warm-up, autotune sweep
    torch.cuda.synchronize()
    kernels.reset_launches()
    fig4_out = fig4_call()
    torch.cuda.synchronize()
    fig4_launches = dict(kernels.LAUNCHES)
    want_launches = {"generation_tiled": 1, "roulette_cdf": 0, "f15": 1,
                     "generation_float": 0, "generation": 0}
    if any(fig4_launches[k] != v for k, v in want_launches.items()):
        fail(f"Fig. 4's row did not take the tiled path: {fig4_launches}")
    fig4_want = get_kernel("generation_eval", "float", "pallas_ref")(
        *fig4_args, consts=fig4_problem.consts)
    fig4_eq = all(torch.equal(a, b) for a, b in zip(fig4_out, fig4_want))
    fig4_err = max((a - b).abs().max().item()
                   for a, b in zip(fig4_out, fig4_want))
    log(f"[fig4] generation_eval float pallas at 1x10000x1000 (F15, blend, "
        f"sigma 0.3): launches {fig4_launches}; bit-equal to the plain "
        f"version {fig4_eq} (max_abs_err {fig4_err})")
    if not fig4_eq:
        fail("Fig. 4's row differs from its plain version")
    if not bool(torch.isfinite(fig4_out[1]).all()):
        fail("Fig. 4's row: non-finite fitness")
    fig4_step_ms = event_ms(fig4_call, TIMED_CALLS)
    log(f"[fig4] {fig4_step_ms:.4f} ms per 10,000 evaluations (one fused "
        f"generation+F15 step, CUDA events, {card}); the paper's published "
        f"2015 CPU figures for 10,000 F15 evaluations "
        f"(benchmarks/fig4_f15.py): Java {PAPER_FIG4_MS['java']} ms, "
        f"Node {PAPER_FIG4_MS['js_node']} ms")
    # the same row under roulette selection, a path of its own: the CDF
    # kernel, then the tiled kernel, then F15
    rl_args = fig4_args[:4] + (dataclasses.replace(
        fig4_cfg, selection="roulette"),) + fig4_args[5:]

    def roulette_call():
        return fig4_kern(*rl_args, consts=fig4_problem.consts)

    roulette_call()                          # warm-up, autotune sweep
    torch.cuda.synchronize()
    kernels.reset_launches()
    rl_out = roulette_call()
    torch.cuda.synchronize()
    rl_launches = dict(kernels.LAUNCHES)
    want_launches = {"generation_tiled": 1, "roulette_cdf": 1, "f15": 1,
                     "generation_float": 0, "generation": 0}
    if any(rl_launches[k] != v for k, v in want_launches.items()):
        fail(f"Fig. 4's row under roulette did not take the tiled path: "
             f"{rl_launches}")
    rl_want = get_kernel("generation_eval", "float", "pallas_ref")(
        *rl_args, consts=fig4_problem.consts)
    rl_eq = all(torch.equal(a, b) for a, b in zip(rl_out, rl_want))
    log(f"[fig4] the same row under roulette: launches {rl_launches}; "
        f"bit-equal to the plain version {rl_eq}")
    if not rl_eq:
        fail("Fig. 4's row under roulette differs from its plain version")
    if not bool(torch.isfinite(rl_out[1]).all()):
        fail("Fig. 4's row under roulette: non-finite fitness")

    # ---- 5: one block per SM ---------------------------------------------
    drive(problem, cfg, 132, 1, SEED + 2)            # warm-up
    (w_isl, _, _, _), w_wall = drive(problem, cfg, 132, 3, SEED)
    w_evals = int(w_isl.evaluations.sum().item())
    log(f"[wide] kernels: 132 islands x 3 epochs: {w_evals} evaluations in "
        f"{w_wall:.3f} s = {w_evals / w_wall:.1f} evals/s, "
        f"{w_wall / 3:.4f} s per epoch; {w_evals / w_wall / (evals / wall):.2f}"
        f" times paper-8's evals/s, {w_wall / 3 / (wall / 5):.2f} times its "
        f"wall per epoch")

    # ---- 6: kernel times at the main-path shapes --------------------------
    seed, size, pop, fit, spec = main_inputs
    flat = pop.reshape(-1, length)
    def trap_call():
        return trap_k.trap_fitness(consts, flat, n_traps=40)

    def gen_call():
        return gen_k.generation_kernel(seed, size, pop, fit, spec)

    f_seed, f_size, f_pop, f_fit, f_spec, f_consts = float_inputs

    def float_call():
        return gen_k.generation_kernel(f_seed, f_size, f_pop, f_fit, f_spec,
                                       f_consts)

    # the F15 path's own F15 calls score a whole batch of islands at once
    f15_x = f_pop.reshape(-1, f_len)

    trap_ms = event_ms(trap_call, TIMED_CALLS)
    trap_plain_ms = event_ms(lambda: trap_ref.trap_fitness(
        flat, n_traps=40, l=4, a=1.0, b=2.0, z=3.0), 10)
    gen_ms = event_ms(gen_call, TIMED_CALLS)
    gen_plain_ms = event_ms(lambda: gen_ref.generation(seed, size, pop, fit,
                                                       spec), 5)
    float_ms = event_ms(float_call, TIMED_CALLS)
    float_plain_ms = event_ms(lambda: gen_ref.generation(
        f_seed, f_size, f_pop, f_fit, f_spec, f_consts), 3)
    f15_ms = event_ms(lambda: f15_k.f15(f15_consts, f15_x), TIMED_CALLS)
    f15_plain_ms = event_ms(lambda: f15_ref.f15(f15_consts, f15_x), 5)
    fig4_c, fig4_x = f15_fig4
    fig4_ms = event_ms(lambda: f15_k.f15(fig4_c, fig4_x), TIMED_CALLS)
    fig4_plain_ms = event_ms(lambda: f15_ref.f15(fig4_c, fig4_x), 3)
    # the rotation alone as one batched product (TF32 off), the yardstick
    # for a later redesign; no single PyTorch call computes F15
    groups, m, _ = fig4_c["M"].shape
    zg = f15_ref.shift_permute(fig4_x, fig4_c["o"], fig4_c["perm"]).reshape(
        -1, groups, m).transpose(0, 1).contiguous()
    bmm_ms = event_ms(lambda: torch.bmm(zg, fig4_c["M"]), TIMED_CALLS)
    # the tiled kernel (one launch under tournament) at Fig. 4's 10,000 x
    # 1000 (tournament, blend, no fused eval), against the untiled float
    # kernel's work: it draws the same plan
    (t_seed, t_size, t_pop, t_fit), t_spec, _ = tiled_fig4
    t_n = t_pop.shape[1]
    tiled_ms = event_ms(lambda: tiling_k.child_kernel(
        t_seed, t_size, t_pop, t_fit, t_spec), TIMED_CALLS)
    tiled_plain_ms = event_ms(lambda: gen_ref.generation(
        t_seed, t_size, t_pop, t_fit, t_spec), 3)
    # the gather of both parents by one PyTorch call each: the yardstick of
    # the tiled kernel's bytes (the port does not call it)
    t_plan = common.selection_plan(t_seed, t_fit, t_size, t_spec, t_n)
    gather_ms = event_ms(lambda: (
        torch.index_select(t_pop[0], 0, t_plan.idx_a[0]),
        torch.index_select(t_pop[0], 0, t_plan.idx_b[0])), TIMED_CALLS)
    tl_bytes, tl_int, tl_f32 = float_generation_work(
        t_seed, t_size, t_fit, t_spec, None, 1, t_n)
    tiled_bound, tiled_by = bound_of(tl_bytes, tl_int, tl_f32)
    t_rows = tiling_k.max_rows(f_len, t_spec, gen_k.max_smem_bytes(0))
    log(f"[kernels] generation_tiled at 1x{t_n}x{f_len} (tournament, blend,"
        f" one launch): {tiled_ms * 1e3:.2f} us, plain "
        f"{tiled_plain_ms * 1e3:.1f} us, bound {tiled_bound * 1e3:.3f} us "
        f"({tiled_by}: {tl_bytes} B, {tl_int} int32 ops, {tl_f32} f32 ops), "
        f"{tiled_ms / tiled_bound:.2f} times it; index_select of both "
        f"parents {gather_ms * 1e3:.2f} us; rows per block "
        f"{_autotune.load_cache().get(torch.cuda.get_device_name(), {})}"
        f" (shared memory holds {t_rows})")
    # the CDF kernel at Fig. 4's 10,000 lanes (roulette only)
    cdf_ms = event_ms(lambda: tiling_k.roulette_cdf(t_size, t_fit),
                      TIMED_CALLS)
    cdf_plain_ms = event_ms(lambda: common.roulette_cdf(
        common.masked_fitness(t_fit, t_size)), 3)
    cdf_bytes, cdf_ops = cdf_work(1, t_n)
    cdf_bound, cdf_by = bound_of(cdf_bytes, f32_ops=cdf_ops)
    # the library's prefix sum over the same masked weights (made once,
    # outside the timed calls); its parallel scan rounds otherwise than the
    # segmented order (common.prefix_sum) that is the kernel's bit contract
    t_masked = common.masked_fitness(t_fit, t_size)
    t_valid = torch.isfinite(t_masked)
    t_lo = torch.where(t_valid, t_masked, float("inf")).amin(-1,
                                                             keepdim=True)
    t_weights = torch.where(t_valid, torch.where(t_valid, t_masked, 0.0)
                            - t_lo + 1e-6, 0.0)
    cumsum_ms = event_ms(lambda: torch.cumsum(t_weights, -1), TIMED_CALLS)
    t_cdf = tiling_k.roulette_cdf(t_size, t_fit)
    cumsum_err = (torch.cumsum(t_weights, -1) - t_cdf).abs().max().item()
    log(f"[kernels] roulette_cdf at (1, {t_n}): {cdf_ms * 1e3:.2f} us, plain"
        f" {cdf_plain_ms * 1e3:.1f} us, bound {cdf_bound * 1e3:.4f} us "
        f"({cdf_by}: {cdf_bytes} B, {cdf_ops} f32 ops); torch.cumsum of the "
        f"masked weights {cumsum_ms * 1e3:.2f} us (another rounding: at most"
        f" {cumsum_err:.4e} from the kernel's segmented sum), "
        f"{cdf_ms / cumsum_ms:.2f} times the library's time ({card})")
    # each order's largest distance from the f64 sum of the same weights,
    # by the plain versions: the left-to-right scan (the order the
    # segmented one replaced) and the segmented one
    exact = torch.cumsum(t_weights.double(), -1)
    serial = torch.empty_like(t_weights)
    acc = torch.zeros_like(t_weights[:, 0])
    for j in range(t_n):
        acc = acc + t_weights[:, j]
        serial[:, j] = acc
    log(f"[kernels] roulette_cdf at (1, {t_n}), largest distance from the "
        f"f64 cumsum (total {exact[0, -1].item():.6e}): left-to-right "
        f"{(serial.double() - exact).abs().max().item():.6e}, segmented "
        f"{(common.prefix_sum(t_weights).double() - exact).abs().max().item():.6e}"
        f", the kernel {(t_cdf.double() - exact).abs().max().item():.6e}")
    # the tiled kernel at paper-8's shape (8 x 256 x 160, fused trap), the
    # shape of its 500 launches in 4c, against the untiled binary kernel's
    # work and time (the same work), in turns
    m_bytes, m_ops = generation_work(seed, size, fit, spec, n_isl, n)
    tiled_main_bound, tiled_main_by = bound_of(m_bytes, int_ops=m_ops)
    m_turns = [event_ms(lambda: tiling_k.child_kernel(seed, size, pop, fit,
                                                      spec), TIMED_CALLS)
               if which == "tiled" else event_ms(gen_call, TIMED_CALLS)
               for which in ("tiled", "untiled", "untiled", "tiled")]
    tiled_main_ms = (m_turns[0] + m_turns[3]) / 2
    log(f"[kernels] at paper-8's ({n_isl}, {n}, {length}) fused trap, in "
        f"turns: generation_tiled {m_turns[0] * 1e3:.2f} / "
        f"{m_turns[3] * 1e3:.2f} us, generation (untiled) "
        f"{m_turns[1] * 1e3:.2f} / {m_turns[2] * 1e3:.2f} us; bound "
        f"{tiled_main_bound * 1e3:.4f} us ({tiled_main_by}), the tiled kernel"
        f" {tiled_main_ms / tiled_main_bound:.1f} times it")
    # the swept rows per block against the heuristic's, in turns (swept,
    # heuristic, heuristic, swept) at both shapes: whether the sweep earns
    # its keep
    for tag, r_args in (
            ("paper-8 8x256x160 trap", (seed, size, pop, fit, spec)),
            ("Fig. 4 1x10000x1000", (t_seed, t_size, t_pop, t_fit,
                                     t_spec))):
        r_isl, r_n, r_len = r_args[2].shape
        r_spec = r_args[-1]
        cap = tiling_k.max_rows(r_len, r_spec, gen_k.max_smem_bytes(0))
        swept = min(_autotune.best_tiles(r_n, r_len, r_spec.kind,
                                         n_islands=r_isl, spec=r_spec)[0],
                    cap)
        rule = min(_autotune.heuristic_rows(r_len), cap)
        turns = []
        for rows in (swept, rule, rule, swept):
            turns.append(event_ms(lambda: tiling_k.child_kernel(
                *r_args, rows), TIMED_CALLS))
        log(f"[autotune] {tag}: swept {swept} rows per block "
            f"{turns[0] * 1e3:.2f} / {turns[3] * 1e3:.2f} us, heuristic "
            f"{rule} rows {turns[1] * 1e3:.2f} / {turns[2] * 1e3:.2f} us "
            f"(in turns, CUDA events, {card})")
        sweep = _autotune.load_cache().get(torch.cuda.get_device_name(),
                                           {}).get(_autotune.shape_key(
                                               r_n, r_len, r_spec.kind,
                                               r_isl, r_spec), {})
        log(f"[autotune] {tag}: sweep ms per rows per block "
            f"{sweep.get('sweep_ms')}")
    for source in ("generation_tiled.cu", "roulette_cdf.cu"):
        report = build_report(source)
        if report is not None:
            head, regs = report
            log(f"[tiled] build {head}")
            for arg, line in regs:
                log(f"[tiled]   ptxas <{arg}>: {line}")
    log(f"[kernels] events per call: trap {trap_ms * 1e3:.2f} us, plain "
        f"{trap_plain_ms * 1e3:.1f} us; generation {gen_ms * 1e3:.2f} us, "
        f"plain {gen_plain_ms * 1e3:.1f} us; generation_float "
        f"{float_ms * 1e3:.2f} us, plain {float_plain_ms * 1e3:.1f} us; f15 "
        f"({f15_x.shape[0]}, {f_len}) {f15_ms * 1e3:.2f} us, plain "
        f"{f15_plain_ms * 1e3:.1f} us")
    # where the time goes inside each kernel: the same call without its
    # fused eval (the plan and the children alone)
    bare_ms = event_ms(lambda: gen_k.generation_kernel(
        seed, size, pop, fit, dataclasses.replace(spec, fused_eval=None)),
        TIMED_CALLS)
    f_bare_ms = event_ms(lambda: gen_k.generation_kernel(
        f_seed, f_size, f_pop, f_fit,
        dataclasses.replace(f_spec, fused_eval=None)), TIMED_CALLS)
    log(f"[kernels] without the fused eval: generation {bare_ms * 1e3:.2f} "
        f"us (with trap {gen_ms * 1e3:.2f}), generation_float "
        f"{f_bare_ms * 1e3:.2f} us (with F15 {float_ms * 1e3:.2f}) ({card})")
    log(f"[kernels] launch shapes: generation ({n_isl}, {n}, {length}) "
        f"{gen_k.cluster_size(n)} CTAs per island; generation_float "
        f"({n_isl}, {n}, {f_len}) "
        f"{gen_k.float_rows(n, f_len, f_spec.elite, gen_k.max_smem_bytes(0))}"
        f" rows per block")
    rows_n = flat.shape[0]
    trap_bytes = rows_n * length + 4 * rows_n
    trap_ops = rows_n * length + rows_n * 40 * 6
    trap_bound, trap_by = bound_of(trap_bytes, f32_ops=trap_ops)
    gen_bytes, gen_ops = generation_work(seed, size, fit, spec, n_isl, n)
    gen_bound, gen_by = bound_of(gen_bytes, int_ops=gen_ops)
    log(f"[kernels] generation work: {gen_bytes} B, {gen_ops} int32 ops "
        f"({THREEFRY_OPS} per draw) -> bound {gen_bound * 1e3:.4f} us; "
        f"kernel at {gen_ms / gen_bound:.1f} times its bound")
    fl_bytes, fl_int, fl_f32 = float_generation_work(
        f_seed, f_size, f_fit, f_spec, f_consts, n_isl, n)
    float_bound, float_by = bound_of(fl_bytes, fl_int, fl_f32)
    log(f"[kernels] generation_float work: {fl_bytes} B, {fl_int} int32 "
        f"ops, {fl_f32} f32 ops -> bound {float_bound * 1e3:.4f} us; kernel "
        f"at {float_ms / float_bound:.1f} times its bound")
    f15_bytes, f15_ops = f15_work(f15_consts, f15_x.shape[0])
    f15_bound, f15_by = bound_of(f15_bytes, f32_ops=f15_ops)
    fig4_bytes, fig4_ops = f15_work(fig4_c, fig4_x.shape[0])
    fig4_bound, _ = bound_of(fig4_bytes, f32_ops=fig4_ops)
    log(f"[kernels] f15 work at ({f15_x.shape[0]}, {f_len}): {f15_bytes} B, "
        f"{f15_ops} f32 ops -> bound {f15_bound * 1e3:.4f} us; kernel at "
        f"{f15_ms / f15_bound:.1f} times its bound")
    log(f"[kernels] f15 at Fig. 4's ({fig4_x.shape[0]}, {f_len}): "
        f"{fig4_ms * 1e3:.2f} us, plain {fig4_plain_ms * 1e3:.1f} us, bound "
        f"{fig4_bound * 1e3:.3f} us ({fig4_bytes} B, {fig4_ops} f32 ops); "
        f"the rotation alone by torch.bmm (TF32 off) {bmm_ms * 1e3:.2f} us")
    # the no-FMA contract's FP32 issue floor: two instructions per
    # multiply-add and the term's instructions (from the kernel's SASS) per
    # gene, over every lane of the card at its maximum SM clock
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    term = f15_term_instructions()
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * 128
    log(f"[f15] SASS: {'not measured' if term is None else term[0]} "
        f"instructions per term on cosf's fast path (over "
        f"{0 if term is None else term[1]} terms); {lanes} FP32 lanes at "
        f"{sm_mhz:.0f} MHz")
    for tag, c, x, ms in (("island batch", f15_consts, f15_x, f15_ms),
                          ("Fig. 4", fig4_c, fig4_x, fig4_ms)):
        rows_x, dim_x = x.shape
        groups_x, m_x, _ = c["M"].shape
        rot = 2 * rows_x * groups_x * m_x * m_x
        issue = rot + (0 if term is None else term[0] * rows_x * dim_x)
        floor_us = issue / (lanes * sm_mhz * 1e6) * 1e6
        w_bytes, w_ops = f15_work(c, rows_x)
        b_ms, _ = bound_of(w_bytes, f32_ops=w_ops)
        shape = f15_k.card_shape(rows_x, dim_x, m_x, dev)
        log(f"[f15] {tag} ({rows_x}, {dim_x}, m {m_x}): {ms * 1e3:.2f} us; "
            f"bound_of {b_ms * 1e3:.3f} us (the FMA rate); FP32 issue floor "
            f"{floor_us:.3f} us ({rot} rotation + "
            f"{'no' if term is None else issue - rot} term instructions), "
            f"the kernel {ms * 1e3 / floor_us:.2f} times it; {shape.rows} "
            f"rows per tile, {shape.groups} groups per batch, grid "
            f"{shape.grid}, {shape.smem} B shared memory, "
            f"{-(-rows_x // shape.rows)} tiles ({card})")
    # rows per tile at Fig. 4's shape: the wrapper's choice and the sweep,
    # in turns (choice, sweep, choice)
    f15_turns = [fig4_ms]
    for rows in F15_SWEEP_ROWS:
        shape = f15_k.card_shape(10000, 1000, 50, dev, rows=rows)
        t_ms = event_ms(lambda: f15_k.launch(fig4_c, fig4_x, shape),
                        TIMED_CALLS)
        log(f"[f15] sweep at (10000, 1000, m 50): {rows} rows per tile, "
            f"{shape.groups} groups per batch, grid {shape.grid}: "
            f"{t_ms * 1e3:.2f} us")
    f15_turns.append(event_ms(lambda: f15_k.f15(fig4_c, fig4_x),
                              TIMED_CALLS))
    log(f"[f15] the wrapper's choice {fig4_shape.rows} rows per tile: "
        f"{f15_turns[0] * 1e3:.2f} / {f15_turns[1] * 1e3:.2f} us, before "
        f"and after the sweep")
    # the routes for rows the tiled route cannot stage, at the island
    # batch's 2048 rows: z gathered (D 60,000), sliced (m 200 and 1000)
    for (dim_r, m_r), (c, x, shape) in sorted(f15_routes.items()):
        r_ms = event_ms(lambda: f15_k.f15(c, x), 10)
        r_plain_ms = event_ms(lambda: f15_ref.f15(c, x), 1)
        w_bytes, w_ops = f15_work(c, x.shape[0])
        r_bound, r_by = bound_of(w_bytes, f32_ops=w_ops)
        route = (f"sliced, {shape.cols} columns per slice" if shape.cols
                 else f"z gathered, {shape.groups} groups per batch")
        log(f"[f15] route at ({x.shape[0]}, {dim_r}, m {m_r}): {r_ms:.4f} "
            f"ms, plain {r_plain_ms:.3f} ms, bound_of {r_bound:.4f} ms "
            f"({r_by}, the FMA rate), {r_ms / r_bound:.1f} times it; "
            f"{route}, {shape.rows} rows per tile, grid {shape.grid}, "
            f"{shape.smem} B shared memory ({card})")
    log(f"[trap] at ({rows_n}, {length}): {trap_ms * 1e3:.3f} us, plain "
        f"{trap_plain_ms * 1e3:.1f} us, bound {trap_bound * 1e3:.4f} us "
        f"({trap_by}), {trap_ms / trap_bound:.1f} times it; "
        f"{-(-rows_n // 8)} blocks of 8 warps, a warp per row ({card})")
    for source in ("f15.cu", "trap.cu"):
        report = build_report(source)
        if report is not None:
            head, regs = report
            log(f"[f15] build {head}")
            for arg, line in regs:
                log(f"[f15]   ptxas <{arg}>: {line}")

    # ---- 7a: the WKV6 kernel against its plain versions ------------------
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    from repro_torch.kernels.rwkv6 import rwkv6 as wkv_k

    def wkv_max_err(got, want):
        return max((a - b).abs().max().item() for a, b in zip(got, want))

    def wkv_close(got, want, tol):
        return all(torch.allclose(a, b, **tol) for a, b in zip(got, want))

    def wkv_plain(fn, args, chunk):
        """A plain chunked version (kernel layout) on the model's layout,
        S padded as ops.wkv pads it, on the same values in f32."""
        r, k, v, w, u, s0 = args
        b, seq, h, hd = r.shape
        pad = (-seq) % chunk
        r, k, v = (F.pad(a.float(), (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
        y, st = fn(*(a.transpose(1, 2).reshape(b * h, seq + pad, hd)
                     for a in (r, k, v, w)),
                   u.float()[None].expand(b, h, hd).reshape(b * h, hd),
                   s0.reshape(b * h, hd, hd), chunk=chunk)
        return (y.reshape(b, h, seq + pad, hd).transpose(1, 2)[:, :seq],
                st.reshape(b, h, hd, hd))

    # every case with r, k, v and u in f32 and in bf16 (the served model's
    # types), each held against both chunked forms and the recurrence on
    # the same values
    wkv_err = 0.0
    for b, s, h, hd, chunk, decays in WKV_CASES:
        args = wkv_inputs(gen, b, s, h, hd, decays, dev)
        for dtype in (torch.float32, torch.bfloat16):
            r, k, v, w, u, s0 = args
            case = [r.to(dtype), k.to(dtype), v.to(dtype), w, u.to(dtype), s0]
            got = wkv_ops.wkv(*case, chunk=chunk)
            torch.cuda.synchronize()
            chunked = wkv_plain(wkv_ref.wkv_chunked, case, chunk)
            sub = wkv_plain(wkv_ref.wkv_subchunked, case, chunk)
            seq = wkv_ref.wkv(*(a.float() for a in case[:5]), s0)
            tol = WKV_TOL[decays]
            finite = all(bool(torch.isfinite(t).all()) for t in got)
            ok = finite and all(wkv_close(got, want, tol)
                                for want in (chunked, sub, seq))
            err_c, err_u, err_s = (wkv_max_err(got, want)
                                   for want in (chunked, sub, seq))
            log(f"[wkv] ({b}, {s}, {h}, {hd}) chunk {chunk}, {decays} "
                f"decays, {str(dtype)[6:]} r, k, v, u: max_abs_err {err_c} "
                f"against wkv_chunked, {err_u} against wkv_subchunked, "
                f"{err_s} against the sequential recurrence (|y| <= "
                f"{got[0].abs().max().item():.1f}); finite {finite}; within "
                f"atol {tol['atol']} rtol {tol['rtol']}: {ok}")
            if not ok:
                fail(f"WKV kernel differs from its plain versions at ({b}, "
                     f"{s}, {h}, {hd}), {decays} decays, {dtype}")
            if decays == "rwkv":
                wkv_err = max(wkv_err, err_c)
        if (s, decays) == (SERVE_PROMPT, "rwkv"):
            wkv_serve = args
    # the state carried across two calls equals one call (S 64 in halves)
    r, k, v, w, u, s0 = wkv_inputs(gen, 1, 64, 2, 16, "rwkv", dev)
    whole = wkv_ops.wkv(r, k, v, w, u, s0)
    y1, s1 = wkv_ops.wkv(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u, s0)
    y2, s2 = wkv_ops.wkv(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:], u, s1)
    halves = (torch.cat([y1, y2], 1), s2)
    log(f"[wkv] state carry (1, 64, 2, 16) in two halves: max_abs_err "
        f"{wkv_max_err(halves, whole)} against one call")
    if not wkv_close(halves, whole, WKV_TOL["rwkv"]):
        fail("WKV kernel: the state carried across calls differs")
    # the serve shape: as the prefill calls it (bf16 r, k, v and u in the
    # model's layout, through ops.wkv), and the kernel alone on f32 inputs
    sr, sk, sv, sw, su, ss0 = wkv_serve
    s_b, s_len, s_h, s_hd = sr.shape
    bf_args = [sr.bfloat16(), sk.bfloat16(), sv.bfloat16(), sw,
               su.bfloat16(), ss0]
    wkv_ms = event_ms(lambda: wkv_ops.wkv(*bf_args), TIMED_CALLS)
    wkv_f32_ms = event_ms(lambda: wkv_k.wkv_kernel(*wkv_serve),
                          TIMED_CALLS)
    # the plain version (the wrapper's CPU route, wkv_chunked) and the
    # kernel's own form in plain PyTorch, on the card
    wkv_plain_ms = event_ms(lambda: wkv_k._plain(*bf_args, wkv_k.CHUNK), 3)
    wkv_sub_ms = event_ms(lambda: wkv_plain(
        wkv_ref.wkv_subchunked, bf_args, wkv_k.CHUNK), 3)
    wkv_bytes, wkv_f32_n, wkv_tc_n = wkv_work(s_b, s_h, s_len, s_hd,
                                              wkv_k.CHUNK, 2)
    wkv_bound, wkv_by = bound_of(wkv_bytes, f32_ops=wkv_f32_n,
                                 tf32_ops=wkv_tc_n)
    log(f"[wkv] at the serve shape ({s_b}, {s_len}, {s_h}, {s_hd}), chunk "
        f"{wkv_k.CHUNK}, one CTA per head: bf16 r, k, v through ops.wkv (as "
        f"the prefill calls it) {wkv_ms:.4f} ms per call; f32 r, k, v "
        f"{wkv_f32_ms:.4f} ms; the plain version (wkv_chunked) "
        f"{wkv_plain_ms:.3f} ms, wkv_subchunked {wkv_sub_ms:.3f} ms; bound "
        f"{wkv_bound:.4f} ms ({wkv_by}: {wkv_bytes} B = "
        f"{wkv_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; {wkv_f32_n} f32 ops "
        f"and {wkv_tc_n} TF32 tensor-core ops = "
        f"{(wkv_f32_n / F32_OPS_PER_S + wkv_tc_n / TF32_OPS_PER_S) * 1e3:.4f}"
        f" ms), {wkv_ms / wkv_bound:.2f} times it; no single PyTorch call "
        f"computes WKV6; {card}")
    wkv_build = build_report("wkv.cu")
    if wkv_build is not None:
        log(f"[wkv] build: {wkv_build[0]}")
        for arg, regs in wkv_build[1]:
            if arg == f"{s_hd},{wkv_k.CHUNK}":   # hd, chunk
                log(f"[wkv]   <{arg}>: {regs}")

    # ---- 7b: rwkv6-3b served at full size ----------------------------------
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import attention, build_model, transformer
    from repro_torch.models.common import rmsnorm
    lm_cfg = get_config("rwkv6-3b")
    lm_gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = build_model(lm_cfg, dev, lm_gen)
    randomize_decay_lora(model, lm_gen)
    torch.cuda.synchronize()
    log(f"[serve] rwkv6-3b: {model.param_count()} parameters ({lm_cfg.n_layers}"
        f" layers, d {lm_cfg.d_model}, {lm_cfg.n_heads} heads of "
        f"{lm_cfg.hd}, d_ff {lm_cfg.d_ff}, vocab {lm_cfg.vocab_size}, "
        f"{lm_cfg.param_dtype}) drawn in {time.perf_counter() - t:.2f} s")
    prompts = torch.randint(0, lm_cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=lm_gen, device=dev)
    generate(model, prompts, 2)                      # warm-up, not counted
    kernels.reset_launches()
    toks, times = generate(model, prompts, SERVE_NEW)
    serve_launches = dict(kernels.LAUNCHES)
    others = {k: n for k, n in serve_launches.items() if k != "wkv" and n}
    if serve_launches["wkv"] != lm_cfg.n_layers or others:
        fail(f"the served prefill should launch the WKV kernel once per "
             f"layer and nothing else: {serve_launches}")
    if toks.shape != (SERVE_BATCH, SERVE_NEW) or not bool(
            ((toks >= 0) & (toks < lm_cfg.vocab_size)).all()):
        fail(f"served tokens: shape {tuple(toks.shape)} or out of range")
    n_prompt = SERVE_BATCH * SERVE_PROMPT
    steps = times["decode_steps"]
    log(f"[serve] generate: prefill {SERVE_BATCH} x {SERVE_PROMPT} in "
        f"{times['prefill_s'] * 1e3:.3f} ms = "
        f"{n_prompt / times['prefill_s']:.1f} tokens/s; decode {steps} "
        f"steps in {times['decode_s'] * 1e3:.3f} ms = "
        f"{times['decode_s'] / steps * 1e3:.3f} ms per step = "
        f"{SERVE_BATCH * steps / times['decode_s']:.1f} tokens/s; launches "
        f"{serve_launches}; {card}")
    log(f"[serve] sample: {toks[0, :12].tolist()}; peak device memory of "
        f"the weights and one generate {torch.cuda.max_memory_allocated()} "
        f"B ({card})")
    # the prefill through each route, and decode alone
    kernels.reset_launches()
    logits_k, caches_k, _ = make_prefill_step(model,
                                              use_rwkv_kernel=True)(
        {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_launches = kernels.LAUNCHES["wkv"]
    kernels.reset_launches()
    decode = make_decode_step(model)
    tok, caches = logits_k.argmax(-1)[:, None], caches_k
    for step in range(4):
        logits_d, caches = decode({"token": tok, "index": SERVE_PROMPT + step,
                                   "caches": caches})
        tok = logits_d.argmax(-1)[:, None]
    torch.cuda.synchronize()
    decode_launches = kernels.LAUNCHES["wkv"]
    t = time.perf_counter()
    logits_p, caches_p, _ = make_prefill_step(model,
                                              use_rwkv_kernel=False)(
        {"tokens": prompts})
    torch.cuda.synchronize()
    plain_prefill_s = time.perf_counter() - t
    if (prefill_launches, decode_launches, kernels.LAUNCHES["wkv"]) != (
            lm_cfg.n_layers, 0, 0):
        fail(f"WKV launches: prefill {prefill_launches}, decode "
             f"{decode_launches}, plain prefill {kernels.LAUNCHES['wkv']}")
    state_k, state_p = caches_k[0][0]["wkv"], caches_p[0][0]["wkv"]
    rel_logits, rel_state = rel_l2(logits_k, logits_p), rel_l2(state_k,
                                                               state_p)
    finite = all(bool(torch.isfinite(t).all()) for t in (
        logits_k, state_k, logits_d))
    same_next = (logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean()
    log(f"[serve] bf16 prefill through the kernel against the plain "
        f"recurrence: last-position logits relative L2 {rel_logits:.4e} "
        f"(limit {SERVE_BF16_TOL['logits']}) "
        f"(max abs {(logits_k - logits_p).abs().max().item():.4f} of "
        f"{logits_p.abs().max().item():.3f}), wkv states of all "
        f"{lm_cfg.n_layers} layers {rel_state:.4e} (limit "
        f"{SERVE_BF16_TOL['state']}); next token equal in "
        f"{same_next.item():.2f} of rows; finite {finite}; WKV launches "
        f"prefill {prefill_launches}, decode 0; plain prefill "
        f"{plain_prefill_s * 1e3:.1f} ms")
    # layer by layer from the same input: the routes differ in the WKV only
    layer_out = layer_state = 0.0
    with torch.inference_mode():
        x = model._embed(prompts)
        for layer in model.segments[0]:
            p, bc = layer[0].tree(), model.plan[0].pattern[0]
            out_k, c_k, _ = transformer.block_apply(
                bc, lm_cfg, p, x, mode="prefill", use_rwkv_kernel=True)
            out_p, c_p, _ = transformer.block_apply(
                bc, lm_cfg, p, x, mode="prefill", use_rwkv_kernel=False)
            layer_out = max(layer_out, rel_l2(out_k, out_p))
            layer_state = max(layer_state, rel_l2(c_k["wkv"], c_p["wkv"]))
            x = out_k
    # the f32 twin: the same weights, f32 parameters and activations
    twin = build_model(dataclasses.replace(
        lm_cfg, param_dtype=torch.float32, activation_dtype=torch.float32),
        "meta").to_empty(device=dev)
    with torch.no_grad():
        for p16, p32 in zip(model.parameters(), twin.parameters()):
            p32.copy_(p16.float())
    tw_logits_k, tw_caches_k, _ = make_prefill_step(
        twin, use_rwkv_kernel=True)(
        {"tokens": prompts})
    tw_logits_p, tw_caches_p, _ = make_prefill_step(twin)(
        {"tokens": prompts})
    f32_logits = rel_l2(tw_logits_k, tw_logits_p)
    f32_state = rel_l2(tw_caches_k[0][0]["wkv"], tw_caches_p[0][0]["wkv"])
    bf16_logits = rel_l2(logits_p, tw_logits_p)
    bf16_state = rel_l2(state_p, tw_caches_p[0][0]["wkv"])
    log(f"[serve] layer by layer from the same input (bf16): each layer's "
        f"output within relative L2 {layer_out:.4e}, its wkv state within "
        f"{layer_state:.4e}; the f32 twin, kernel against plain: logits "
        f"{f32_logits:.4e}, wkv states {f32_state:.4e}; the bf16 plain "
        f"route against the f32 plain route: logits {bf16_logits:.4e}, wkv "
        f"states {bf16_state:.4e} (bf16's own distance, no gate)")
    if not finite or layer_out > SERVE_LAYER_TOL["out"] \
            or layer_state > SERVE_LAYER_TOL["state"] \
            or max(f32_logits, f32_state) > SERVE_F32_TOL \
            or rel_logits > SERVE_BF16_TOL["logits"] \
            or rel_state > SERVE_BF16_TOL["state"]:
        fail("rwkv6-3b prefill: the kernel route and the plain route "
             "disagree beyond the stated tolerances, or non-finite values")
    del twin, tw_caches_k, tw_caches_p, caches_p, logits_p, caches
    device_profile("serve-prefill", lambda: make_prefill_step(
        model, use_rwkv_kernel=True)({"tokens": prompts}), card)
    device_profile("serve-decode", lambda: decode(
        {"token": tok, "index": SERVE_PROMPT, "caches": caches_k}), card)

    # free rwkv6-3b before the dense phases
    del model, decode, caches_k, logits_k, logits_d, tok, wkv_serve, bf_args
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 8a: the flash-attention kernels against their plain version ----
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref
    for source in ("flash_tc.cu", "flash_3xtf32.cu"):
        report = build_report(source)
        if report is None:
            log("[flash] the kernel library was built before this run: no "
                "build time or ptxas report")
            break
        log(f"[flash] build {report[0]} (the sources compile in parallel)")
        for hd_, line in report[1]:
            log(f"[flash] ptxas, {source} at hd {hd_}: {line}")
    flash_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for (b, s, h, kv, hd), dtype in itertools.product(
            FLASH_CASES, (torch.float32, torch.bfloat16)):
        q, k, v = (torch.randn(shape, generator=gen).to(dtype).to(dev)
                   for shape in ((b, s, h, hd), (b, s, kv, hd),
                                 (b, s, kv, hd)))
        scale = 1.0 / hd ** 0.5
        got = fa_k.flash_attention_kernel(q, k, v, scale=scale, causal=True)
        torch.cuda.synchronize()
        want = fa_ref.attention(q, k, v, causal=True, scale=scale)
        atol, rtol = FLASH_TOL[str(dtype).split(".")[-1]]
        err = (got.float() - want.float()).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        ok = finite and torch.allclose(got.float(), want.float(), atol=atol,
                                       rtol=rtol)
        log(f"[flash] ({b}, {s}, {h}, {kv}, {hd}) {dtype}: max_abs_err "
            f"{err} against ref.attention (|o| <= "
            f"{want.float().abs().max().item():.3f}); finite {finite}; "
            f"within atol {atol} rtol {rtol}: {ok}")
        if not ok:
            fail(f"flash kernel differs from its plain version at ({b}, {s}, "
                 f"{h}, {kv}, {hd}) {dtype}")
        flash_err[dtype] = max(flash_err[dtype], err)
        if (b, s, h, kv, hd) == FLASH_CASES[-1]:
            serve_qkv = (q, k, v)
    # the f32 kernel's edges: (B, Sq, Sk, H, Kv, hd, causal, view)
    for b, sq, sk, h, kv, hd, causal, view in FLASH_F32_EDGES:
        q, k, v = (torch.randn(shape, generator=gen).to(dev)
                   for shape in ((b, sq, h, hd + 1), (b, sk, kv, hd + 1),
                                 (b, sk, kv, hd + 1)))
        # "offset4": views of wider rows, 4 bytes off 16 with odd strides
        # (the kernel's 4-byte loads); else contiguous tensors
        q, k, v = ((a[..., 1:] if view == "offset4" else
                    a[..., :hd].contiguous()) for a in (q, k, v))
        got = fa_k.flash_attention_kernel(q, k, v, scale=hd ** -0.5,
                                          causal=causal)
        want = fa_ref.attention(q, k, v, causal=causal, scale=hd ** -0.5)
        atol, rtol = FLASH_TOL["float32"]
        err = (got - want).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, atol=atol, rtol=rtol)
        log(f"[flash] f32 edge ({b}, {sq}, {sk}, {h}, {kv}, {hd}) causal "
            f"{causal} {view}: max_abs_err {err}; within atol {atol} rtol "
            f"{rtol}: {ok}")
        if not ok:
            fail(f"the f32 flash kernel differs from its plain version at "
                 f"({b}, {sq}, {sk}, {h}, {kv}, {hd}, {causal}, {view})")
        flash_err[torch.float32] = max(flash_err[torch.float32], err)
    q, k, v = serve_qkv
    # the serve shape (the last case): each kernel, the plain version and
    # SDPA on the same values, in bf16 and in f32
    f_scale = 1.0 / q.shape[-1] ** 0.5
    flash = {}
    for dtype in (torch.bfloat16, torch.float32):
        fq, fk, fv = (a.to(dtype) for a in (q, k, v))
        sq_, sk_, sv_ = (a.transpose(1, 2).contiguous() for a in (fq, fk, fv))
        ms = event_ms(lambda: fa_k.flash_attention_kernel(
            fq, fk, fv, scale=f_scale, causal=True), TIMED_CALLS)
        plain_ms = event_ms(lambda: fa_ref.attention(
            fq, fk, fv, causal=True, scale=f_scale), 3)
        sdpa_ms = event_ms(lambda: F.scaled_dot_product_attention(
            sq_, sk_, sv_, is_causal=True, scale=f_scale, enable_gqa=True),
            TIMED_CALLS)
        nbytes, ops = flash_work(fq, fk)
        if dtype == torch.bfloat16:
            bound, by = bound_of(nbytes, bf16_ops=ops)
            what = "bf16, the tensor-core kernel (flash_tc.cu)"
            also = ""
        else:
            # three TF32 products for each f32-grade one
            bound, by = bound_of(nbytes, tf32_ops=3 * ops)
            what = ("f32, both products in 3xTF32 on the tensor cores "
                    "(flash_3xtf32.cu)")
            cc_bound, _ = bound_of(nbytes, f32_ops=ops)
            also = (f"; the f32 CUDA cores' bound for the same work "
                    f"{cc_bound:.4f} ms, the kernel {ms / cc_bound:.2f} "
                    f"times it")
        flash[dtype] = dict(ms=ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                            bound=bound, by=by)
        log(f"[flash] at the serve shape {tuple(fq.shape)} q, "
            f"{tuple(fk.shape)} k and v, causal, {what}: {ms:.4f} ms per "
            f"call = {ops / ms / 1e9:.1f} TFLOP/s over the visible pairs; "
            f"bound {bound:.4f} ms ({by}: {nbytes} B, {ops} ops"
            f"{', x3 on the TF32 tensor cores' if also else ''}), "
            f"{ms / bound:.2f} times it{also}; SDPA (is_causal, enable_gqa, "
            f"in {str(dtype).split('.')[-1]}; never called by the port) "
            f"{sdpa_ms:.4f} ms, the kernel {ms / sdpa_ms:.2f} times it; "
            f"ref.attention {plain_ms:.3f} ms; {card}")
    del q, k, v, got, want, fq, fk, fv, sq_, sk_, sv_, serve_qkv

    # ---- 8b: yi-9b served at full size -----------------------------------
    d_cfg = get_config("yi-9b")
    d_gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    dense = build_model(d_cfg, dev, d_gen)
    torch.cuda.synchronize()
    log(f"[dense] yi-9b: {dense.param_count()} parameters ({d_cfg.n_layers}"
        f" layers, d {d_cfg.d_model}, {d_cfg.n_heads} heads over "
        f"{d_cfg.n_kv_heads} of {d_cfg.hd}, d_ff {d_cfg.d_ff}, vocab "
        f"{d_cfg.vocab_size}, {d_cfg.param_dtype}) drawn in "
        f"{time.perf_counter() - t:.2f} s")
    d_prompts = torch.randint(0, d_cfg.vocab_size, (DENSE_BATCH,
                                                    DENSE_PROMPT),
                              generator=d_gen, device=dev)
    generate(dense, d_prompts, 2)                    # warm-up, not counted
    kernels.reset_launches()
    d_toks, d_times = generate(dense, d_prompts, DENSE_NEW)
    dense_launches = dict(kernels.LAUNCHES)
    others = {k: n for k, n in dense_launches.items()
              if k != "flash_attention" and n}
    if dense_launches["flash_attention"] != d_cfg.n_layers or others:
        fail(f"the served prefill should launch the flash kernel once per "
             f"layer and nothing else: {dense_launches}")
    if d_toks.shape != (DENSE_BATCH, DENSE_NEW) or not bool(
            ((d_toks >= 0) & (d_toks < d_cfg.vocab_size)).all()):
        fail(f"served tokens: shape {tuple(d_toks.shape)} or out of range")
    n_prompt = DENSE_BATCH * DENSE_PROMPT
    steps = d_times["decode_steps"]
    log(f"[dense] generate: prefill {DENSE_BATCH} x {DENSE_PROMPT} in "
        f"{d_times['prefill_s'] * 1e3:.3f} ms = "
        f"{n_prompt / d_times['prefill_s']:.1f} tokens/s; decode {steps} "
        f"steps in {d_times['decode_s'] * 1e3:.3f} ms = "
        f"{d_times['decode_s'] / steps * 1e3:.3f} ms per step = "
        f"{DENSE_BATCH * steps / d_times['decode_s']:.1f} tokens/s; "
        f"launches {dense_launches}; {card}")
    log(f"[dense] sample: {d_toks[0, :12].tolist()}; peak device memory of "
        f"the weights and one generate {torch.cuda.max_memory_allocated()} "
        f"B ({card})")
    # the prefill through each route, and decode alone
    budget = DENSE_PROMPT + DENSE_NEW
    kernels.reset_launches()
    d_logits_k, d_caches_k, _ = make_prefill_step(
        dense, max_seq=budget, use_flash=True)({"tokens": d_prompts})
    torch.cuda.synchronize()
    prefill_launches = kernels.LAUNCHES["flash_attention"]
    kernels.reset_launches()
    t = time.perf_counter()
    d_logits_p, _, _ = make_prefill_step(dense, max_seq=budget)(
        {"tokens": d_prompts})
    torch.cuda.synchronize()
    d_plain_prefill_s = time.perf_counter() - t
    plain_launches = kernels.LAUNCHES["flash_attention"]
    d_decode = make_decode_step(dense)
    d_tok = d_logits_k.argmax(-1)[:, None]
    for step in range(4):
        d_logits_d, d_caches_k = d_decode(
            {"token": d_tok, "index": DENSE_PROMPT + step,
             "caches": d_caches_k})
        d_tok = d_logits_d.argmax(-1)[:, None]
    torch.cuda.synchronize()
    decode_launches = kernels.LAUNCHES["flash_attention"]
    if (prefill_launches, plain_launches, decode_launches) != (
            d_cfg.n_layers, 0, 0):
        fail(f"flash launches: prefill {prefill_launches}, plain prefill "
             f"{plain_launches}, decode {decode_launches}")
    d_finite = all(bool(torch.isfinite(t).all()) for t in (
        d_logits_k, d_logits_p, d_logits_d))
    d_rel = rel_l2(d_logits_k, d_logits_p)
    d_same = (d_logits_k.argmax(-1) == d_logits_p.argmax(-1)).float().mean()
    log(f"[dense] bf16 prefill through the flash kernel against the plain "
        f"(q-chunked) attention: last-position logits relative L2 "
        f"{d_rel:.4e} (limit {DENSE_BF16_TOL}) (max abs "
        f"{(d_logits_k - d_logits_p).abs().max().item():.4f} of "
        f"{d_logits_p.abs().max().item():.3f}); next token equal in "
        f"{d_same.item():.2f} of rows; finite {d_finite}; flash launches "
        f"prefill {prefill_launches}, plain prefill 0, decode 0; plain "
        f"prefill {d_plain_prefill_s * 1e3:.1f} ms")
    # layer by layer from the same input: the routes differ in attention
    d_layer = 0.0
    d_bc = dense.plan[0].pattern[0]
    with torch.inference_mode():
        x = dense._embed(d_prompts)
        pos = torch.arange(DENSE_PROMPT, dtype=torch.int32, device=dev)
        for layer in dense.segments[0]:
            p = layer[0].tree()
            h = rmsnorm(p["ln1"]["scale"], x, d_cfg.norm_eps)
            o_k, _ = attention.attend(p["mixer"], d_cfg, h, positions=pos,
                                      use_flash=True)
            o_p, _ = attention.attend(p["mixer"], d_cfg, h, positions=pos)
            d_layer = max(d_layer, rel_l2(o_k, o_p))
            x, _, _ = transformer.block_apply(d_bc, d_cfg, p, x,
                                              mode="train", positions=pos,
                                              use_flash=True)
        del x, h, o_k, o_p
    # the f32 twin: the same weights, f32 parameters and activations, all
    # 48 layers (35.3 GB beside the 17.7 GB of bf16 weights)
    del d_caches_k
    twin = build_model(dataclasses.replace(
        d_cfg, param_dtype=torch.float32, activation_dtype=torch.float32),
        "meta").to_empty(device=dev)
    with torch.no_grad():
        for p16, p32 in zip(dense.parameters(), twin.parameters()):
            p32.copy_(p16.float())
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    tw_k, _, _ = make_prefill_step(twin, use_flash=True)(
        {"tokens": d_prompts})
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t) * 1e3
    f32_launches = kernels.LAUNCHES["flash_attention"]
    if f32_launches != d_cfg.n_layers:
        fail(f"the f32 twin's prefill should launch the flash kernel once "
             f"per layer: {f32_launches}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    tw_p, _, _ = make_prefill_step(twin)({"tokens": d_prompts})
    torch.cuda.synchronize()
    twin_plain_ms = (time.perf_counter() - t) * 1e3
    log(f"[dense] the f32 twin's prefill ({DENSE_BATCH} x {DENSE_PROMPT}, "
        f"its first): {twin_ms:.1f} ms through the 3xTF32 flash kernel "
        f"({f32_launches} launches, {flash[torch.float32]['ms']:.4f} ms "
        f"each at the serve shape in 8a), {twin_plain_ms:.1f} ms through "
        f"the plain (q-chunked) attention ({card})")
    d_f32 = rel_l2(tw_k, tw_p)
    d_bf16_f32 = rel_l2(d_logits_p, tw_p)
    log(f"[dense] layer by layer from the same input (bf16): each layer's "
        f"attention output within relative L2 {d_layer:.4e} (limit "
        f"{DENSE_LAYER_TOL}); the f32 twin ({d_cfg.n_layers} layers, "
        f"{f32_launches} launches of the f32 kernel), flash against plain: "
        f"logits {d_f32:.4e} (limit {DENSE_F32_TOL}); the "
        f"bf16 plain "
        f"route against the f32 plain route: logits {d_bf16_f32:.4e} "
        f"(bf16's own distance, no gate); peak device memory "
        f"{torch.cuda.max_memory_allocated()} B ({card})")
    if not d_finite or d_layer > DENSE_LAYER_TOL or d_f32 > DENSE_F32_TOL \
            or d_rel > DENSE_BF16_TOL:
        fail("yi-9b prefill: the flash route and the plain route disagree "
             "beyond the stated tolerances, or non-finite values")
    del twin, tw_k, tw_p
    gc.collect()
    torch.cuda.empty_cache()
    _, d_caches, _ = make_prefill_step(dense, max_seq=budget,
                                       use_flash=True)(
        {"tokens": d_prompts})
    device_profile("dense-prefill", lambda: make_prefill_step(
        dense, max_seq=budget, use_flash=True)({"tokens": d_prompts}), card)
    device_profile("dense-decode", lambda: d_decode(
        {"token": d_tok, "index": DENSE_PROMPT, "caches": d_caches}), card)

    # ---- 9a: the classic path (impl="jnp"), paper-8 ------------------------
    # EAConfig()'s defaults are the paper's (max_pop 256, min_pop 128, 100
    # generations per epoch, tournament k 2, two-point, elite 2); only the
    # fitness goes through the trap kernel, as the classic path evaluates
    # every generation's population by problem.evaluate
    classic = EAConfig()
    if (classic.impl, classic.max_pop, classic.min_pop,
            classic.generations_per_epoch) != ("jnp", 256, 128, 100):
        fail(f"EAConfig() is not the paper's classic configuration: "
             f"{classic}")
    gen_kernels = ("generation", "generation_float", "generation_tiled",
                   "roulette_cdf")
    drive(problem, classic, 8, 1, SEED + 1)          # warm-up, not counted
    kernels.reset_launches()
    c_run, c_wall = drive(problem, classic, 8, 5, SEED)
    c_launches = dict(kernels.LAUNCHES)
    c_evals = int(c_run[0].evaluations.sum().item())
    if c_launches["trap_fitness"] <= 0 or max(c_launches[k]
                                              for k in gen_kernels):
        fail(f"classic paper-8: want the trap kernel and no generation "
             f"kernel, got {c_launches}")
    if not bool(torch.isfinite(c_run[0].best_fitness).all()):
        fail("classic paper-8: non-finite best fitness")
    log(f"[classic-main] paper-8 impl=jnp run_fused: 8 islands x 5 epochs: "
        f"{c_evals} evaluations in {c_wall:.3f} s = {c_evals / c_wall:.1f} "
        f"evals/s (impl=pallas, phase 4: {evals / wall:.1f}); launches "
        f"{c_launches}; best per epoch "
        f"{convert.to_numpy(c_run[3]).best_fitness.tolist()}")
    kernels.reset_launches()
    t = time.perf_counter()
    res = run_experiment(problem, classic, mig, n_islands=8, max_epochs=5,
                         rng=SEED, w2=True)
    torch.cuda.synchronize()
    e_wall = time.perf_counter() - t
    e_launches = dict(kernels.LAUNCHES)
    if e_launches["trap_fitness"] <= 0:
        fail(f"classic paper-8 run_experiment: no trap launch {e_launches}")
    for what, x, y in (("islands", res.islands, c_run[0]),
                       ("pool", res.pool, c_run[1])):
        for name, u, v in zip(x._fields, x, y):
            if not torch.equal(u, v):
                fail(f"classic paper-8: run_experiment's {what}.{name} "
                     f"differs from run_fused's")
    c_stats = convert.to_numpy(c_run[3])
    for row, st in enumerate(res.stats):
        for name in st._fields:
            if getattr(st, name) != getattr(c_stats, name)[row]:
                fail(f"classic paper-8: run_experiment's stats row {row} "
                     f"{name} differs from run_fused's")
    log(f"[classic-main] run_experiment == run_fused (islands, pool, every "
        f"stats row); run_experiment {res.evaluations} evaluations in "
        f"{e_wall:.3f} s = {res.evaluations / e_wall:.1f} evals/s")
    # one epoch on the card and on the host's CPU from the same seed
    (g1_isl, g1_pool, _, g1_st), _ = drive(problem, classic, 8, 1, SEED)
    t = time.perf_counter()
    h1 = run_fused(make_trap(40, 4, impl="pallas"), classic, mig,
                   n_islands=8, max_epochs=1, rng=SEED, w2=True,
                   return_stats=True, device="cpu")
    h_wall = time.perf_counter() - t
    for what, x, y in (("islands", g1_isl, h1[0]), ("pool", g1_pool, h1[1]),
                       ("stats", g1_st, h1[3])):
        for name, u, v in zip(x._fields, x, y):
            u = u.cpu()
            same = (torch.allclose(u, v, rtol=1e-6, atol=0)
                    if name == "mean_best" else torch.equal(u, v))
            if not same:
                fail(f"classic paper-8, one epoch: the card's {what}.{name} "
                     f"differs from the CPU's")
    log(f"[classic-main] one epoch on the card == one epoch on the CPU "
        f"(islands, pool, stats; mean_best within 1e-6 relative; the CPU "
        f"epoch took {h_wall:.1f} s)")
    step_profile("classic-main", c_run[0], problem, classic)

    # ---- 9b: the float classic path, paper-f15-8 --------------------------
    f_classic = EAConfig(crossover="blend", mutation_sigma=0.3)
    kernels.reset_launches()
    cf_run, cf_wall = drive(f_problem, f_classic, 8, 2, SEED)
    cf_launches = dict(kernels.LAUNCHES)
    cf_evals = int(cf_run[0].evaluations.sum().item())
    if cf_launches["f15"] <= 0 or max(cf_launches[k] for k in gen_kernels):
        fail(f"classic paper-f15-8: want the F15 kernel and no generation "
             f"kernel, got {cf_launches}")
    if not bool(torch.isfinite(cf_run[0].pop).all()
                and torch.isfinite(cf_run[0].best_fitness).all()):
        fail("classic paper-f15-8: non-finite genes or best fitness")
    log(f"[classic-f15-main] paper-f15-8 impl=jnp run_fused: 8 islands x 2 "
        f"epochs: {cf_evals} evaluations in {cf_wall:.3f} s = "
        f"{cf_evals / cf_wall:.1f} evals/s (impl=pallas, phase 4b: "
        f"{f_evals / f_wall5:.1f}); launches {cf_launches}; best per epoch "
        f"{convert.to_numpy(cf_run[3]).best_fitness.tolist()}")
    # against the CPU within tests/test_torch_evolve.py's float tolerances:
    # the initial islands from the seed, then one generation step from the
    # card's final state (F15's cos rounds differently on the card and the
    # CPU, so a longer run parts where a tournament meets two rows whose
    # fitness lies within that rounding)
    h_problem = make_f15(impl="pallas", device="cpu")
    k_init = rand.split(rand.key(SEED, device=dev), 2)[0]
    starts = (island_lib.init_islands(k_init, 8, f_problem, f_classic),
              island_lib.init_islands(k_init.cpu(), 8, h_problem, f_classic,
                                      device="cpu"))
    steps = (island_lib.generation_step(cf_run[0], f_problem, f_classic),
             island_lib.generation_step(
                 type(cf_run[0])(*(t.cpu() for t in cf_run[0])), h_problem,
                 f_classic))
    f_err = {}
    for what, (u_isl, v_isl) in (("init", starts), ("step", steps)):
        for name, u, v in zip(u_isl._fields, u_isl, v_isl):
            u = u.cpu()
            if name in ("pop", "best_genome"):
                ok = torch.allclose(u, v, rtol=0, atol=GENE_ATOL)
            elif name in ("fitness", "best_fitness"):
                ok = torch.allclose(u, v, rtol=FIT_RTOL, atol=FIT_ATOL)
            else:
                ok = torch.equal(u, v)
            if u.dtype.is_floating_point:
                d = (u - v).abs()
                f_err[f"{what}.{name}"] = float(
                    torch.where(torch.isfinite(d), d, 0.0).max())
            if not ok:
                fail(f"classic paper-f15-8: {what} {name} on the card and "
                     f"on the CPU disagree beyond the stated tolerances")
    log(f"[classic-f15-main] the card against the CPU (genes atol "
        f"{GENE_ATOL}, fitness rtol {FIT_RTOL} atol {FIT_ATOL}, the rest "
        f"exact): initial islands and one generation step agree; largest "
        f"differences {f_err}")
    step_profile("classic-f15-main", cf_run[0], f_problem, f_classic)

    # ---- 9c: every topology x acceptance policy under impl="pallas" -------
    t9c = time.perf_counter()
    short = EAConfig(impl="pallas", max_pop=256, min_pop=128,
                     generations_per_epoch=10)
    short_ref = dataclasses.replace(short, impl="pallas_ref")
    ledger = {}
    for topo, pol in itertools.product(available_topologies(),
                                       available_acceptance_policies()):
        m = MigrationConfig(topology=topo, acceptance=AcceptanceConfig(
            policy=pol, epsilon=2.0 if pol == "dedup" else 0.0))
        kernels.reset_launches()
        k_out = run_fused(problem, short, m, n_islands=8, max_epochs=3,
                          rng=SEED, w2=True, return_stats=True,
                          return_obs=True)
        torch.cuda.synchronize()
        p_launches = dict(kernels.LAUNCHES)
        if p_launches["generation"] <= 0:
            fail(f"{topo} x {pol}: the generation kernel never launched: "
                 f"{p_launches}")
        r_out = run_fused(make_trap(40, 4), short_ref, m, n_islands=8,
                          max_epochs=3, rng=SEED, w2=True, return_stats=True,
                          return_obs=True)
        same_run(f"{topo} x {pol}", k_out[:4], r_out[:4])
        tot = k_out[4]["totals"]
        if k_out[4] != r_out[4] or tot["delivered"] != (
                tot["accepted"] + tot["rejected"]) or tot["fired"] != 24:
            fail(f"{topo} x {pol}: the ledger differs from the plain run's "
                 f"or does not balance: {k_out[4]} against {r_out[4]}")
        ledger[f"{topo}/{pol}"] = (tot["delivered"], tot["accepted"])
    log(f"[engine] 5 topologies x 4 policies, paper-8 width, 3 epochs of 10 "
        f"generations, impl=pallas == impl=pallas_ref (islands, pool, stats,"
        f" harvest), ledgers balanced, in {time.perf_counter() - t9c:.1f} s;"
        f" (delivered, accepted): {ledger}")

    # ---- 9d: the ea command, on the card by default ---------------------
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH"))
        if p))
    t = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.evolve", "ea",
           "--problem", "trap", "--islands", "8", "--epochs", "2"]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=600)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines or not re.fullmatch(
            r"success=(True|False) evals_to_solution=(None|\d+) "
            r"wall=\d+\.\ds", lines[-1]):
        fail(f"the ea command: rc {proc.returncode}, stdout {lines[-3:]}, "
             f"stderr {proc.stderr[-2000:]}")
    log(f"[ea] {' '.join(cmd[1:])}: rc 0 in {time.perf_counter() - t:.1f} s"
        f"; {' | '.join(lines[-3:])}")

    # ---- 10: the asynchronous runtime and its durability ------------------
    t10 = time.perf_counter()
    async_phases(problem, f_problem, f_cfg, card)
    log(f"[async] phases 10a-10c in {time.perf_counter() - t10:.1f} s")

    # ---- 11: the host and server tier ------------------------------------
    t11 = time.perf_counter()
    host_phases([("paper-8", problem, make_trap(40, 4), cfg, BRIDGE_EPOCHS),
                 ("paper-f15-8", f_problem, make_f15(), f_cfg, 2)], card)
    log(f"[host] phases 11a-11d in {time.perf_counter() - t11:.1f} s")

    # ---- 12: the sharded drivers -----------------------------------------
    t12 = time.perf_counter()
    sharded_phases(card)
    log(f"[sharded] phases 12a-12c in {time.perf_counter() - t12:.1f} s")

    # ---- 13: training ----------------------------------------------------
    t13 = time.perf_counter()
    training_phases(card)
    log(f"[train] phases 13a-13e in {time.perf_counter() - t13:.1f} s")

    # ---- 14: the other model families served ----------------------------
    t14 = time.perf_counter()
    family_phases(card)
    log(f"[family] phase 14 in {time.perf_counter() - t14:.1f} s")

    # ---- 15: model land across ranks ---------------------------------------
    mesh_kernels = sharding_phases(card)

    # ---- 16: the invariant analyzer ----------------------------------------
    analysis_phase(card)

    result = {"kernels": [
        {"name": "trap_fitness", "route": "cuda",
         "source": "src/repro_torch/kernels/trap/csrc/trap.cu",
         "replaces": "src/repro/kernels/trap/trap.py:33",
         "launches": launches["trap_fitness"], "max_abs_err": trap_err,
         "ms": trap_ms, "plain_ms": trap_plain_ms, "bound_ms": trap_bound,
         "bound_by": trap_by, "library_ms": None},
        {"name": "generation", "route": "cuda",
         "source": "src/repro_torch/kernels/ga/csrc/generation.cu",
         "replaces": "src/repro/kernels/ga/generation.py:58",
         "launches": launches["generation"], "max_abs_err": gen_err,
         "ms": gen_ms, "plain_ms": gen_plain_ms, "bound_ms": gen_bound,
         "bound_by": gen_by, "library_ms": None},
        {"name": "generation_float", "route": "cuda",
         "source": "src/repro_torch/kernels/ga/csrc/generation_float.cu",
         "replaces": "src/repro/kernels/ga/generation.py:58",
         "launches": f_launches["generation_float"],
         "max_abs_err": float_err, "ms": float_ms,
         "plain_ms": float_plain_ms, "bound_ms": float_bound,
         "bound_by": float_by, "library_ms": None},
        {"name": "f15", "route": "cuda",
         "source": "src/repro_torch/kernels/rastrigin/csrc/f15.cu",
         "replaces": "src/repro/kernels/rastrigin/rastrigin.py:50",
         "launches": f_launches["f15"], "max_abs_err": f15_err,
         "ms": f15_ms, "plain_ms": f15_plain_ms, "bound_ms": f15_bound,
         "bound_by": f15_by, "library_ms": None},
        {"name": "generation_tiled", "route": "cuda",
         "source": "src/repro_torch/kernels/ga/csrc/generation_tiled.cu",
         "replaces": "src/repro/kernels/ga/tiling.py:133",
         "launches": fig4_launches["generation_tiled"],
         "max_abs_err": tiled_err, "ms": tiled_ms,
         "plain_ms": tiled_plain_ms, "bound_ms": tiled_bound,
         "bound_by": tiled_by, "library_ms": gather_ms},
        {"name": "roulette_cdf", "route": "cuda",
         "source": "src/repro_torch/kernels/ga/csrc/roulette_cdf.cu",
         "replaces": "src/repro/kernels/ga/tiling.py:168",
         "launches": rl_launches["roulette_cdf"],
         "max_abs_err": max(cdf_errs),
         "ms": cdf_ms, "plain_ms": cdf_plain_ms, "bound_ms": cdf_bound,
         "bound_by": cdf_by, "library_ms": cumsum_ms},
        {"name": "wkv", "route": "cuda",
         "source": "src/repro_torch/kernels/rwkv6/csrc/wkv.cu",
         "replaces": "src/repro/kernels/rwkv6/rwkv6.py:88",
         "launches": serve_launches["wkv"], "max_abs_err": wkv_err,
         "ms": wkv_ms, "plain_ms": wkv_plain_ms, "bound_ms": wkv_bound,
         "bound_by": wkv_by, "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/flash_tc.cu",
         "replaces":
             "src/repro/kernels/flash_attention/flash_attention.py:74",
         "launches": dense_launches["flash_attention"],
         "max_abs_err": flash_err[torch.bfloat16],
         "ms": flash[torch.bfloat16]["ms"],
         "plain_ms": flash[torch.bfloat16]["plain_ms"],
         "bound_ms": flash[torch.bfloat16]["bound"],
         "bound_by": flash[torch.bfloat16]["by"],
         "library_ms": flash[torch.bfloat16]["sdpa_ms"]},
        {"name": "flash_attention_f32", "route": "cuda",
         "source":
             "src/repro_torch/kernels/flash_attention/csrc/flash_3xtf32.cu",
         "replaces":
             "src/repro/kernels/flash_attention/flash_attention.py:74",
         "launches": f32_launches,
         "max_abs_err": flash_err[torch.float32],
         "ms": flash[torch.float32]["ms"],
         "plain_ms": flash[torch.float32]["plain_ms"],
         "bound_ms": flash[torch.float32]["bound"],
         "bound_by": flash[torch.float32]["by"],
         "library_ms": flash[torch.float32]["sdpa_ms"]},
    ]}
    log(f"[kernels] shapes: trap ({rows_n}, {length}); generation "
        f"({n_isl}, {n}, {length}) fused trap, tournament, two_point; "
        f"generation_float ({n_isl}, {n}, {f_len}) fused f15, tournament, "
        f"blend; f15 ({f15_x.shape[0]}, {f_len}, m 50); generation_tiled "
        f"(1, {t_n}, {f_len}) tournament, blend, no eval, launches from Fig."
        f" 4's row (4d), library_ms index_select of both parents; "
        f"roulette_cdf (1, {t_n}), launches from Fig. 4's row under "
        f"roulette (4d), library_ms torch.cumsum of the masked weights "
        f"(another rounding than the kernel's segmented sum); wkv "
        f"({SERVE_BATCH}, "
        f"{SERVE_PROMPT}, {lm_cfg.n_heads}, 64) bf16 through ops.wkv, "
        f"launches from one rwkv6-3b prefill (7b); "
        f"flash_attention (4, 2048, 32 over 4, 128) bf16 causal, launches "
        f"from one yi-9b prefill (8b), library_ms SDPA; flash_attention_f32 "
        f"the same in f32 (3xTF32), launches from the f32 twin's prefill "
        f"(8b), bound in 3xTF32 on the TF32 tensor cores, library_ms SDPA "
        f"in f32; "
        f"card {card}")
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
