"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:

1. build: compile the seven CUDA sources of ``src/repro_torch/csrc`` (one
   nvcc each, in parallel) and print the card's name and power limit;
2. kernel parity: run one warm STAR epoch at full TPC-C widths (the main
   path's configuration below) while recording the arguments of the first
   main-path call of every kernel wrapper; then run each kernel on those
   arguments and hold the result bit-equal against its plain PyTorch
   version run on the CPU (tolerance 0: every value is an integer), time
   both on the card with CUDA events, and compute the kernel's bound.
   The index probe is held in its three launch configurations: single-
   master (``locate_index_ops``) and partitioned (``step_index_ops``) on
   their recorded calls, bare (``scan_window``) at both shapes, then on
   crafted indexes (every slot SENTINEL, full segments, ragged caps) and
   ops (keys past every key, partitions and IX_ID out of range, strided
   op slices).  The OCC round is held in Silo mode, in Calvin mode (with
   a read-lock array), without claims and without an index, its lock
   arrays all B after each call.  torch.profiler counts one kernel a call
   of every probe configuration and of the round, and each call's aten
   operators and host time are reported.  index_merge is held at both
   recorded shapes (partitioned and
   single-master), in shared memory and in global scratch, and on
   crafted batches (ties, double deletes, overflow, empty segments, empty
   batches, ragged caps, a large sort); both shapes are timed beside the
   stable argsort and gathers the card path ran before it until the
   kernel sorted its own inserts, and torch.profiler counts the kernels
   one call launches (at most two).  thomas_merge is held on the epoch's
   single-master log through ``thomas_apply_batch`` (the log's flattened
   views, no copy), through the bare entry on the same stream, and on
   crafted streams (K = 0, every row -1, one row under one TID, stale
   TIDs, TIDs at 2^32 - 1, word copies, two calls back to back);
   torch.profiler counts one kernel a call of ``thomas_apply_batch``;
3. engine parity: the full-mix configuration of
   benchmarks/fig11_throughput.py (P=4, 4,000 items, 100 customers a
   district, order ring 128, 512 transactions an epoch) for 3 epochs on
   the card with the kernels and on the CPU with the plain versions:
   master, replica and indexes bit-equal after every epoch;
4. main path: P=16 warehouses at the spec's widths (100,000 items, 3,000
   customers a district, 10 districts; order ring 256, the most the
   orders_by_cust key layout holds), the full mix, 2,048 transactions an
   epoch, 16 OCC rounds: 4 measured epochs after the warm one, with
   ``replica_consistent()`` at every fence, every kernel launched (the
   probe in both phases) and every lock array the executor handed to the
   round all B after the epochs; then one more epoch under
   ``torch.profiler`` for the card's busy time;
8. the service path (run after phase 4): ``TxnService`` over a
   ``StarEngine`` on the card, in the three scenarios of
   examples/serve_txn.py on YCSB at the paper's scale (16 partitions x
   200,000 records, 10 int32 columns, 10 ops, 90/10 read/write, 10 %
   cross-partition), 2.0 s each with 32 slots a partition and 32 master
   lanes: steady Poisson at 1,500 txn/s with the WAL on (4 workers, a
   checkpoint every 4 epochs), then ``recover_full`` on the card
   bit-equal to the committed state; bursty over Zipf(0.9) at 1,000
   txn/s; overload at 30,000 txn/s with queue caps 64/128, shedding,
   its queues within the caps.  ``replica_consistent()`` at every fence,
   ``occ_round`` and ``thomas_merge`` launched in each.  The steady
   scenario's epochs up to its 8th non-empty batch are replayed through a
   fresh engine on the card and one on the CPU: master and replica
   bit-equal and the commit masks equal (to the service run's too).
   Then TPC-C's full mix at phase 4's scale through the service for 3.0 s
   with the consume feedback, all four STAR kernels launched and the
   probe in both phases, and its epochs up to the 4th non-empty batch
   replayed the same way, indexes included (so the probe, index_merge,
   occ_round and thomas_merge are held against their plain versions at
   the service's shapes); and the fig11 configuration for 5 epochs with
   the WAL,
   ``recover_full`` on the card bit-equal, indexes included;
9. the read path (run after phase 8): phase 8's TPC-C service run again,
   with the read tier (``ReadTier(max_staleness_epochs=2,
   sec_refresh_every=2)``, fig12's knobs) and the analytics lane; then 4
   more epochs of 512 transactions on the same engine whose read-only
   transactions are offered to the read lane after their fence and
   served at bound 2 (freshness 0 and 1).  ``replica_consistent()`` at
   every fence, the views' committed projection equal to the master
   snapshot's ``VIEW_COLS`` at every fence and each fence's stamp equal
   to ``recompute`` of that fence's committed values; 0 stale reads,
   reads served mid-epoch, every read within the bound; the first 4
   distinct (replica, epoch) snapshots served in each part equal to
   their fence, every group served from them equal to ``reference_read``
   and to the CPU executor on a host copy; the lanes' own launches of
   ``scan_window`` (at most one an index a group) and ``thomas_merge``
   (one a views merge) counted from 0, and the first call of each held
   bit-equal to its plain version on the CPU and timed (the new call
   shapes); the snapshot copy timed a view and the dirty gate's host
   copy a slab;
10. the cluster path (run after phase 9): 4 simulated nodes over phase
   4's configuration (4 partitions a node, physical secondary copies, 4
   stream slabs).  A ``ClusterStarEngine`` and a ``StarEngine`` fed the
   same batches (two ``TPCCState``s from one seed, each with its consume
   feedback), 1 warm and 4 measured epochs: commit counts equal,
   ``consistent()`` at every fence, the partial and full copies and every
   index segment bit-equal to the single-host master after every epoch;
   the cluster's new call shapes (the secondary replay's
   ``index_merge`` with rolled ``part_ids``, the scatter-back
   ``thomas_merge`` into the partial and into the secondary copy) held
   bit-equal to their plain versions and timed.  Then one
   ``ClusterRuntime`` with the per-node WAL through the three recovery
   cases at full width — a partial node killed at a fence
   (PHASE_SWITCHING), node 0 killed mid-stream at slab 1
   (FALLBACK_DIST_CC: its block restored from the physical secondary
   copy, the full copy rebuilt from the partials), nodes 0-2 killed
   (UNAVAILABLE: ``recover_full`` on the card reloads records and
   indexes) — bit-equal to a ``StarEngine`` run without a failure after
   every epoch, each slab applied once; the fig11 cluster (ppn = 1) on
   the card and the CPU across a mid-stream kill, every copy bit-equal
   after every epoch; and ``ClusterTxnService`` over the full-width
   runtime (examples/serve_cluster.py's shape: TPC-C at 1,500 txn/s for
   3.0 s, ``AdmissionConfig(64, 64, node_queue_cap=96)``, both of phase
   9's lanes) with node 2 killed mid-run: one recovery, copies
   consistent at every fence, the per-node commits summing to the
   engine's, 0 stale reads, the views' stamps equal to ``recompute`` at
   every fence.  It prints a ``cluster_path`` JSON line, and each STAR
   kernel row gains ``cluster_launches`` (the service run) and
   ``cluster_engine_launches`` (the 4 measured epochs);
5. LM kernel parity: Hymba-1.5B at its published widths and depth in
   bf16, random weights from a seed, serves 8 requests of 2,048 tokens
   plus 2 new ones through ``ServeEngine.generate`` while the first call
   of each LM kernel wrapper is recorded; both flash-attention
   configurations are first held against their plain version on a sweep
   of small shapes (f32 and bf16, every (q/k, v) head dim pair: 16, 32,
   64, 80, 128 and MLA's (96, 64), the decode configuration at the four
   it takes, ragged lengths, causal,
   windowed and bidirectional masks, regular and padded head maps, rings
   with empty slots, fully masked rows); rmsnorm first on a sweep
   (1 to 16,384 rows, widths 1,600 to 12,288, bf16 and f32, with and
   without a residual, both forms of the kernel), then timed at the decode
   shape alone and in a chain that mirrors a decode block; then
   rmsnorm (bf16), flash
   attention (bf16, prefill and decode, unexpanded K/V with the head map)
   and the SSD scan (f32; first on a sweep of small shapes at 1e-4: P,
   N, chunk, heads, ragged lengths, weak and strong decay, Mamba2-130M's
   widths) are held against their plain versions on the
   recorded card inputs, each within the tolerance stated at its check,
   and timed beside one PyTorch call that computes the same function where
   there is one (SDPA needs K/V expanded to every query head: that
   gather's time is reported beside it and left out of its figure);
6. serve parity: Hymba at full width, depth cut to 2 layers, float32, the
   same weights on the card and the CPU: one 2,048-token prompt, then 8
   decode steps with the same token fed to both; every logit within
   ``TOL_SERVE``;
7. serve path: ``ServeEngine.generate`` on the full model, 8 x 2,048
   prompt tokens and 64 decode steps, after an untimed one: 3 timed runs
   (the median by total time is reported, all three beside it), the LM
   kernels' launch counts from the first (rmsnorm's also where its
   prefill ends); then a prefill, and a prefill
   with 8 decode steps, under ``torch.profiler`` for where the time goes.

12. more configs served (run after phase 7): GLM-4-9B (partial RoPE),
   StarCoder2-7B (prompts of 6,144 tokens past its 4,096 window: the
   window mask in prefill, the ring's slot reuse in decode; 36 heads
   padded to 48 over 6 kv heads) and DBRX-132B (MoE, 16 experts top-4,
   DBRX_LAYERS of its 40 layers: the most that leave 8 GB of the card
   free), each at full width: first 2 layers in float32, card against
   CPU (a prompt, then decode steps; every logit within ``TOL_SERVE``),
   then a bf16 ``generate`` with random weights (SERVE_CONFIGS: batch,
   prompt, new tokens), one untimed and CONFIG_RUNS timed, each model
   freed before the next is built; flash attention and rmsnorm must be
   launched once a layer a step.  It prints a ``serve_configs`` JSON line.

11. train path: first both backward kernels (the port's own: the JAX
   package differentiates its XLA attention and RMSNorm) against autograd
   through their plain versions run in float32 on the card: rmsnorm's on
   a sweep (1 to 16,384 rows, widths 1,024 to 12,288, bf16 and f32, with
   and without the residual), flash's on a sweep of small prefill shapes
   (every head dim pair, masks, the padded head map, rows that see no
   key) and
   at three training shapes (Granite-MoE's 8 x 2,048 x 16 over 8 heads,
   Hymba's prefill with its window and padded heads, D = 128), each in
   bf16 and in f32 at batch 1; both timed at the train path's shapes
   beside their plain version, the library call and the bound.  Then
   Granite-MoE at full width and 2 layers in f32: 3 ``Trainer`` steps on
   the card and on the CPU from one state (routing, losses, gradient
   norms, parameters).  Then Granite-3.0-1B-A400M at full width and depth
   in bf16, 8 x 2,048 tokens a step: 2 untimed and 12 timed steps (the
   loss must fall; launches of the four LM kernels a step), a revert to
   the fence and a disk checkpoint round trip (both bit-equal), the
   replication report, one profiled step and one split by hand.  It
   prints a ``train_path`` JSON line; the kernels line gains the two
   backward rows and the forward rows' launches a training step.

13. Hymba trains (run after phase 11): the SSD scan's backward kernel
   (the port's own) against autograd through its plain version run in
   float64 (the float32 sequential recurrence drifts past the bound): a
   sweep of small shapes (P, N, heads up to 50, with and without the
   final state's gradient, weak and strong decay, ragged lengths; a
   state no block holds refused), each on the chunk-start states the
   forward kernel hands over and on states computed inside the wrapper,
   then Hymba's training shape (400 rows x 2,048 tokens) with the rows
   of one batch element held to float64, every case called twice and
   held bit-equal; timed beside the plain version and the bound.  The
   rmsnorm backward is timed at Hymba's widths (1,600 with and without
   the residual, 3,200) beside its bound and ``F.rms_norm``'s backward.
   Then Hymba at full width and 2 layers in f32:
   3 ``Trainer`` steps card against CPU.  Then Hymba-1.5B at full width
   and depth in bf16, 8 x 2,048 tokens a step: 2 untimed and 8 timed
   steps (the loss must fall; launches of the SSD, flash-attention and
   rmsnorm kernels and their backward kernels a step), a revert to the
   fence (bit-equal) and one profiled step.  It prints a
   ``train_path_hymba`` JSON line; the kernels line gains the SSD
   backward's row.

14. MLA and the modality frontends (run after phase 13), each model at
   full width and depth in bf16 with random weights, freed before the
   next: first the flash kernels at the new shapes (MiniCPM3's expanded
   MLA, 8 x 2,048 x 48 heads at q/k 96 and v 64, causal; HuBERT's
   encoder, 16 x 1,024 x 16 heads of 80, bidirectional; each forward
   and backward held to its plain version, timed by CUDA events and by
   torch.profiler beside the plain version, SDPA and the bound).  Then
   MiniCPM3-4B: 2 layers f32 card against CPU (a prompt and decode
   steps, the logits within ``TOL_SERVE``; ``loss_fn`` and every
   parameter's gradient, the backward kernel at (96, 64)), then a bf16
   ``generate`` of 8 x 2,048 + 64 tokens (prefill through the kernel
   once a layer; decode in MLA's absorbed form, no attention kernel).
   InternVL2-26B: 2 layers f32 card against CPU with its 256 patch
   embeddings before the prompt, then ``prefill`` on 8 x (256 patches +
   1,792 tokens) and 64 ``decode_step`` calls.  HuBERT-XLarge: the
   encoder on 16 x 1,024 frames, ``loss_fn``'s gradients card against
   CPU (2 layers f32), then training at 16 x 1,024 frames a step as
   phase 13 trains (the loss must fall; the revert bit-equal).  Each
   generate and the encode run once untimed, then PHASE14_RUNS (2)
   times.  It prints an ``mla_frontends`` JSON line; the flash rows gain
   ``new_shapes``.

15. Several processes (run after phase 14): 4 processes on the one card
   (``launch.mesh.spawn``, start method ``spawn``, the kernels already
   built by this process), gloo over CUDA tensors.  (a) Phase 10's
   cluster cell with each node a process (``ClusterRuntime(...,
   distributed=True)``): 7 epochs of 2,048 transactions with each
   node's write-ahead log, the master killed mid-stream at epoch 3
   (FALLBACK_DIST_CC), node 2 at epoch 6 (PHASE_SWITCHING), nodes 0-2 at
   epoch 7 (UNAVAILABLE, reloaded from the logs); ``replica_consistent()``
   at every fence on every rank; every copy and index segment after each
   epoch bit-equal (sha256 of each rank's blocks, where they lie) to a
   single-process ``ClusterStarEngine`` on the card fed the batches the
   master ran (run here while the ranks go on to (b)); no collective in any partitioned phase; each rank's first
   scatter-back ``thomas_merge`` and secondary-replay ``index_merge``
   call held to its plain version.  (b) Granite-3.0-1B-A400M with its
   experts over ``model`` = 4 (8 a rank): 2 layers f32 logits against
   the same rank without the mesh (``TOL_DIST_F32``), then a bf16
   ``generate`` of 8 x 2,048 + 64, the tokens equal on every rank.  (c)
   Its bf16 ``Trainer`` at full width, 2 of 24 layers, on mesh (data 2,
   model 2), 2 steps, ``reshard`` to (4, 1) (the whole state equal
   across it, bit for bit), 1 step; the loss falls; at least 8 GB stay free.  It
   prints txn/s, the fence split (tail ship, ``all_reduce``), the real
   bytes an epoch, ``t_recovery_s`` a case and each rank's launches by
   kernel, and a ``dist_path`` JSON line; each kernel row gains
   ``dist_launches`` (by part and rank).  A failing rank fails the
   phase; the ranks are killed at the spec's deadline.

Before phase 2 it times the least kernel, a one-element ``fill_``, by
torch.profiler (the launch floor).

Kernel times are device times: CUDA events around a call enqueued while
a spin kernel keeps the card busy, so the wrapper's host time is not
counted; the median of 20 calls (5 for the slow plain versions of the LM
kernels).  Bounds are the larger of bytes over 3.35 TB/s (each input read
once, each output written once, counting what this run's inputs need)
and operations over the card's peak rate for their type: int32 16.7 T/s,
float32 67 TFLOP/s outside the tensor cores, TF32 495 TFLOP/s (the SSD
scan's 3xTF32 products count three times), bf16 989 TFLOP/s.

``python3 chip_smoke.py --ab PARENT`` compares two checkouts on one card
in one call instead: PARENT is a directory holding another checkout's
``src/repro_torch`` (the parent commit unpacked with ``git archive``, for
example).  It runs phase 4's measured epochs and profiled epoch, phase
7's generate (prefill and decode) and the SSD kernel on its recorded prefill arguments, with
each tree's kernels, in four processes: parent, this tree, this tree,
parent.  Each process also times the probe (both phases), the OCC round
and ``thomas_apply_batch`` through the executors' wrappers on the
arguments its warm epoch recorded, and rmsnorm at the decode shape:
device time by CUDA events and by torch.profiler, kernels, aten
operators and host time a call, and the decode chain of
:func:`norm_chain`; and rmsnorm at the prefill shape and at the row
counts of RMS_AB_ROWS (D = 1,600) by CUDA events; both backward
kernels (flash attention's and rmsnorm's) at the train path's shapes,
and the SSD backward at Hymba's training shape (as a training step
calls it, and with the states computed inside), by CUDA events and by
torch.profiler; and the bf16 flash prefill at every head dim pair by
CUDA events.  It prints the card's name and
power limit, then one ``AB {...}`` JSON line a process.

``python3 chip_smoke.py --dist`` runs phase 15 alone (after the build)
and prints its figures on one line.

``python3 chip_smoke.py --lanes N`` runs phase 8's TPC-C service run
instead, in N pairs without and with phase 9's read tier and analytics
lane (order alternating, one untimed run first), and prints the card's
name and power limit and one ``LANES {...}`` JSON line a run.

It prints the build time, the ``nvidia-smi`` name and power limit, one
JSON line of kernels (with each STAR kernel's launches in every service
run, by the read path's lanes and on the cluster path), one of main-path
figures, one of service-path figures, one of read-path figures, one of
cluster-path figures, one of serve-path figures, one of the phase-12
configs, one of train-path figures, one of Hymba's train path, one of
phase 14's, one of phase 15's and, last, the ``{"ok": true, "device": ...}`` line.  It needs one CUDA
card and the repository around it; without either it exits non-zero and
prints no result.
"""
import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

H100_BYTES_PER_S = 3.35e12       # HBM3 rate of an H100 SXM (data sheet)
H100_INT32_OPS_PER_S = 16.7e12   # 132 SMs x 64 INT32 lanes x 1.98 GHz
H100_MAX_CLOCK_HZ = 1.98e9
MAIN = dict(n_partitions=16, n_items=100_000, cust_per_district=3_000,
            order_ring=256, mix="full", delivery_gen_lag=2048)
MAIN_TXNS, MAIN_EPOCHS, MAX_ROUNDS = 2048, 4, 16
H100_BF16_FLOPS = 989e12         # dense tensor cores (data sheet)
H100_F32_FLOPS = 67e12           # float32 outside the tensor cores
H100_TF32_FLOPS = 495e12         # dense tensor cores (data sheet)
SERVE_ARCH = "hymba-1.5b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 2048, 64
PARITY_LAYERS, PARITY_DECODE, PROFILE_STEPS = 2, 8, 8
SERVE_RUNS = 3                   # measured generates; the median is reported
TOL_BF16_NORM = 1e-2             # reasons beside each check
TOL_F32_NORM = 1e-6              # tests/test_kernels.py's rmsnorm bound
RMS_CHAIN = 32                   # decode blocks in rmsnorm's timed chain
# rmsnorm's sweep: rows (with csrc/rmsnorm.cu's REG_ROWS, the most rows
# its register form takes, and one more) by widths: Hymba's d_model and
# d_inner, one not a multiple of 8, the widest
RMS_SWEEP_ROWS = (1, 8, 64, 65, 16384)
RMS_SWEEP_WIDTHS = (1600, 3200, 1601, 12288)
RMS_AB_ROWS = (8, 32, 64, 65, 128, 256, 1024, 4096, 16384)   # --ab timings
TOL_BF16_FLASH = 2e-2
TOL_F32_FLASH = 1e-5
TOL_SSD = 1e-3
TOL_SSD_SWEEP = 1e-4             # tests/test_kernels.py's SSD bound
TOL_SERVE = 1e-3
FIG11 = dict(n_partitions=4, n_items=4000, cust_per_district=100,
             order_ring=128, mix="full", delivery_gen_lag=512)
FIG11_TXNS, FIG11_EPOCHS = 512, 3
# phase 8: the service path (examples/serve_txn.py's scenarios)
YCSB_P = 16                      # x 200,000 records (the module's default)
SERVICE_S, SERVICE_TPCC_S = 2.0, 3.0
SERVICE_SLOTS, SERVICE_LANES = 32, 32
SERVICE_TPCC_RATE = 1500.0
SERVICE_REPLAY = 8               # steady batches replayed card vs CPU
SERVICE_TPCC_REPLAY = 4          # tpcc_full batches replayed card vs CPU
SERVICE_WAL_EPOCHS = 5           # fig11 epochs logged for index recovery
# phase 9: the read tier and the analytics lane (fig12's read-tier knobs)
READ_K, READ_REFRESH = 2, 2      # staleness bound, replica view cadence
READ_SNAPSHOTS = 4               # distinct (replica, epoch) snapshots checked
READ_DIRECT_EPOCHS = 4           # epochs whose reads serve after the fence
READ_DIRECT_TXNS = 512
# phase 10: the cluster (4 simulated nodes over phase 4's configuration)
CLUSTER_NODES, CLUSTER_SLABS = 4, 4
CLUSTER_EPOCHS = 4                # measured, after one warm epoch
CLUSTER_RECOVERY_EPOCHS = 5       # kills at epochs 2, 3 (slab 1) and 5
CLUSTER_KILL_EPOCH = 6            # the service run's kill (node 2)
# phase 11: the train path (Granite-3.0-1B-A400M, full width and depth)
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_BATCH, TRAIN_SEQ = 8, 2048          # 16,384 tokens a step
TRAIN_WARM, TRAIN_TIMED = 2, 12           # untimed, then timed steps
TRAIN_EPOCH = 4                           # steps an epoch (a fence)
TRAIN_LR, TRAIN_WARMUP = 3e-4, 4
# card against CPU: full width, depth cut to 2 layers, float32
TRAIN_PARITY_LAYERS, TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 2, 256
TRAIN_PARITY_STEPS = 3
TOL_TRAIN_LOSS = 1e-4                     # relative; reasons at the check
TOL_TRAIN_GNORM = 1e-3
TOL_ROUTE_GAP = 1e-5                      # a routing flip needs a tie
TOL_TRAIN_PARAM_Q = 1e-6                  # each leaf's 99.9 % quantile
# the backward kernels' sweeps and shapes
RMS_BWD_ROWS = (1, 64, 65, 16384)
RMS_BWD_WIDTHS = (1024, 1600, 1601, 12288)
# on max |kernel - plain| / max |plain| of each gradient: bf16 outputs
# round to 2^-9 and flash rounds P and dS to bf16 before their products
# (as the forward rounds P), so the error scales with the tensor's
# largest element; float32: both in float32, sums in another order
TOL_BF16_BWD = 2e-2
TOL_F32_BWD = 1e-5
# phase 12: more configs served at full width, bf16, random weights:
# (arch, layers (None: the config's), batch, prompt tokens, generated)
DBRX_LAYERS = 9                   # of 40: the most that leave >= 8 GB free
SERVE_CONFIGS = (
    ("glm4-9b", None, 8, 2048, 64),
    ("starcoder2-7b", None, 2, 6144, 64),     # past the 4,096 window
    ("dbrx-132b", DBRX_LAYERS, 8, 2048, 16),
)
CONFIG_RUNS = 3                   # timed generates a config, after one
# card against CPU, 2 layers f32 at full width: prompt tokens (past
# starcoder2's window, so that decode reuses ring slots) and decode steps
CONFIG_PARITY_PROMPT = {"glm4-9b": 512, "starcoder2-7b": 4160,
                        "dbrx-132b": 256}
CONFIG_PARITY_DECODE = 3
# phase 13: Hymba-1.5B trains (full width and depth, bf16)
HYMBA_ARCH = "hymba-1.5b"
HYMBA_BATCH, HYMBA_SEQ = 8, 2048          # 16,384 tokens a step
HYMBA_WARM, HYMBA_TIMED = 2, 8
# the SSD backward against its plain version in float64, on max |kernel -
# plain| / max |plain| of each gradient (the float32 sequential recurrence
# itself drifts past 1e-4, as for TOL_SSD_SWEEP)
TOL_SSD_BWD = 1e-4
SSD_BWD_P, SSD_BWD_N, SSD_BWD_HEADS = (16, 32, 64), (8, 16, 32), (1, 3, 50)
# phase 14: MLA and the modality frontends, full width and depth, bf16
MLA_ARCH, AUDIO_ARCH, VISION_ARCH = ("minicpm3-4b", "hubert-xlarge",
                                     "internvl2-26b")
MLA_BATCH, MLA_PROMPT, MLA_GEN = 8, 2048, 64
# MiniCPM3's bf16 training step that counts the (96, 64) backward's
# launches: full width, depth cut (its 62 layers and AdamW's state would
# not leave the rest of phase 14 its time)
MLA_TRAIN_LAYERS = 2
VISION_BATCH, VISION_TEXT, VISION_GEN = 8, 1792, 64   # after 256 patches
AUDIO_BATCH, AUDIO_FRAMES = 16, 1024   # ~20 s of audio a row at 50 a second
AUDIO_WARM, AUDIO_TIMED = HYMBA_WARM, HYMBA_TIMED
# timed generates (encodes) a config, after an untimed one: 2, not
# CONFIG_RUNS, to keep the whole script under 1,100 s on a slow host
PHASE14_RUNS = 2
# card against CPU, 2 layers f32 at full width: MiniCPM3's prompt, the
# text after InternVL2's patches, and loss_fn's batch
MLA_PARITY_PROMPT, VISION_PARITY_TEXT = 512, 256
GRAD_PARITY_BATCH, GRAD_PARITY_SEQ = 2, 128
# on max |card - CPU| / max |CPU| of each parameter's gradient: float32
# on both sides, sums in another order (tests/test_torch_train.py holds
# the port to the JAX package's gradients at the same bound)
TOL_GRAD_PARITY = 1e-4
# phase 15: 4 processes over torch.distributed on the one card (gloo over
# CUDA tensors): (a) phase 10's cluster with one process a node, the WAL
# and three kills (the master mid-stream at epoch 3: FALLBACK_DIST_CC;
# node 2 at epoch 6: PHASE_SWITCHING; nodes 0-2 at epoch 7: UNAVAILABLE,
# reloaded from the ranks' logs); (b) Granite-3.0-1B-A400M served with its
# experts over model = 4; (c) its bf16 training step on (data 2, model 2)
# at full width, depth cut to 2 of 24 layers (4 processes share the card
# and gloo moves every gradient and the resharded state through host
# memory: 8 layers took 8.1-11.0 s a step and 51.9 s to reshard), 2 steps,
# then reshard to (4, 1) and 1 step, at lr 1e-3 without warm-up so that 3
# steps move the loss
DIST_SPEC = dict(
    main=MAIN, txns=MAIN_TXNS, epochs=8, ckpt_every=3,
    kills=[(0, 3, 1), (2, 6, None), (0, 7, None), (1, 7, None),
           (2, 7, None)],
    want_cases=["FALLBACK_DIST_CC", "PHASE_SWITCHING", "UNAVAILABLE"],
    half_write=[8], service_s=2.0, service_kill_after=3,
    arch=TRAIN_ARCH, smoke=False, parity_prompt=256,
    batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN,
    train_layers=2, train_batch=TRAIN_BATCH, train_seq=TRAIN_SEQ,
    train_steps=(2, 1), train_lr=1e-3, need_cuda=True, deadline_s=480)
# on max |mesh - one process| / max |one process| of the 2-layer float32
# logits: the MoE outputs are summed over the 4 ranks in another order
# (float32 all_reduce against one index_add)
TOL_DIST_F32 = 1e-5
# the pl.pallas_call site of each TPU kernel
REPLACES = {
    "scan_window": "src/repro/kernels/occ/kernel.py:129",
    "occ_round": "src/repro/kernels/occ/kernel.py:421",
    "index_merge": "src/repro/kernels/index_merge/kernel.py:170",
    "thomas_merge": "src/repro/kernels/thomas_merge/kernel.py:77",
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:30",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:92",
    "mamba2_ssd": "src/repro/kernels/mamba2_ssd/kernel.py:75",
    # the port's own backward kernels: no TPU kernel; the JAX package
    # differentiates these functions in XLA
    "rmsnorm.backward": "src/repro/models/layers.py:18",
    "flash_attention.backward": "src/repro/models/attention.py:61",
    "mamba2_ssd.backward": "src/repro/models/mamba2.py:63",
}
SOURCE = {
    "scan_window": "src/repro_torch/csrc/scan_window.cu",
    "occ_round": "src/repro_torch/csrc/occ_round.cu",
    "index_merge": "src/repro_torch/csrc/index_merge.cu",
    "thomas_merge": "src/repro_torch/csrc/thomas_merge.cu",
    "rmsnorm": "src/repro_torch/csrc/rmsnorm.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "mamba2_ssd": "src/repro_torch/csrc/ssd.cu",
    "rmsnorm.backward": "src/repro_torch/csrc/rmsnorm.cu",
    "flash_attention.backward": "src/repro_torch/csrc/flash_attention.cu",
    "mamba2_ssd.backward": "src/repro_torch/csrc/ssd.cu",
}


# occ_round_pallas's three pallas_call sites (lock build, install,
# validate), all replaced by the one cooperative kernel
REPLACES_ROUND = ["src/repro/kernels/occ/kernel.py:174",
                  "src/repro/kernels/occ/kernel.py:301",
                  "src/repro/kernels/occ/kernel.py:421"]


class Failure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise Failure(what)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def tree_map(fn, x):
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(fn, v) for v in x)
    return fn(x)


def tree_leaves(x):
    if isinstance(x, dict):
        return [y for v in x.values() for y in tree_leaves(v)]
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in tree_leaves(v)]
    return [x]


def to(x, device):
    import torch
    return tree_map(lambda t: t.detach().to(device, copy=True)
                    if isinstance(t, torch.Tensor) else t, x)


def equal(a, b):
    import torch
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.shape == y.shape
                    and torch.equal(x.cpu(), y.cpu())):
                return False
        elif x != y:
            return False
    return True


def max_abs_err(a, b):
    """Largest absolute difference between the tensors of two equal-shaped
    trees (as int64: every kernel output is an integer or a flag)."""
    import torch
    errs = [int((x.cpu().long() - y.cpu().long()).abs().max())
            for x, y in zip(tree_leaves(a), tree_leaves(b))
            if isinstance(x, torch.Tensor) and x.numel()]
    return max(errs, default=0)


def cuda_ms(fn, reps=20, warm=3, setup=None):
    """Median device time of ``fn()`` in ms: CUDA events around each call,
    with the card kept busy by a spin kernel while the host enqueues the
    call, so that the Python wrapper's host time between the events does
    not count.  ``setup()`` (untimed) runs before each call."""
    import torch
    for _ in range(warm):
        if setup is not None:
            setup()
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # spin at least twice as long as one host enqueue of fn takes, at the
    # card's top clock (a lower clock spins longer)
    cycles = int(2 * H100_MAX_CLOCK_HZ * (time.perf_counter() - t0)) + 10**6
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


class Recorder:
    """Wraps kernel wrappers so that the first main-path call of each is
    recorded (a copy of its arguments, taken before the call: some kernels
    update their inputs in place)."""

    def __init__(self):
        self.calls = {}
        self._undo = []

    def wrap(self, module, name, key_of):
        orig = getattr(module, name)

        def wrapper(*args, **kw):
            key = key_of(*args, **kw)
            if key is not None and key not in self.calls:
                dev = next(t.device for t in tree_leaves(args)
                           if hasattr(t, "device"))
                self.calls[key] = to((args, kw), dev)
            return orig(*args, **kw)

        setattr(module, name, wrapper)
        self._undo.append((module, name, orig))

    def restore(self):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo = []


def mk_engine(cfg_kw, seed, device, **kw):
    import numpy as np
    from repro_torch.core.engine import StarEngine
    from repro_torch.db import tpcc
    cfg = tpcc.TPCCConfig(**cfg_kw)
    state = tpcc.TPCCState(cfg)
    init = tpcc.init_values(cfg, np.random.default_rng(seed), state=state)
    eng = StarEngine(cfg.n_partitions, cfg.rows_per_partition, init_val=init,
                     indexes=tpcc.index_specs(cfg), max_rounds=MAX_ROUNDS,
                     device=device, **kw)
    return cfg, state, eng


def same_store(a, b):
    """Two stores (or state dicts) bit-equal, records and indexes."""
    from repro_torch.convert import to_numpy_state
    import numpy as np
    x, y = to_numpy_state(a), to_numpy_state(b)
    return (np.array_equal(x["val"], y["val"])
            and np.array_equal(x["tid"], y["tid"])
            and all(np.array_equal(i[f], j[f])
                    for i, j in zip(x["indexes"], y["indexes"])
                    for f in ("key", "prow", "tid")))


# ---------------------------------------------------------------------------
# phase 2: kernels at main-path shapes
# ---------------------------------------------------------------------------
def wrap_occ(rec):
    """Record the first call of the probe in each phase and of the OCC
    round, where the executors call them."""
    from repro_torch.core import partitioned, single_master
    rec.wrap(partitioned, "step_index_ops", lambda *a, **k: "step_index_ops")
    rec.wrap(single_master, "locate_index_ops",
             lambda *a, **k: "locate_index_ops")
    rec.wrap(single_master, "occ_round", lambda *a, **k: "occ_round")


def record_warm_epoch(eng, batch):
    """Run ``batch`` through ``eng`` with the kernel wrappers recorded."""
    from repro_torch.core import replication
    from repro_torch.core.ops import IDX_OPS
    from repro_torch.kernels.index_merge import ops as im_ops
    rec = Recorder()
    wrap_occ(rec)
    P = eng.P
    # the first merge of each shape: (P, P*K) in the partitioned phase,
    # (P, B*K) in the single-master one
    rec.wrap(im_ops, "index_merge_cuda",
             lambda key, prow, tid, dk, ik, ip, it:
             "index_merge/part" if ik.shape[1] <= P * IDX_OPS
             else "index_merge/sm")
    rec.wrap(replication, "thomas_apply_batch",
             lambda *a, **k: "thomas_apply_batch")
    try:
        m = eng.run_epoch(batch)
    finally:
        rec.restore()
    return m, rec.calls


def sort_gather(ik, ip, it):
    """What the card path ran before each index_merge launch until the
    kernel sorted its own inserts: a stable argsort and three gathers."""
    import torch
    o = torch.argsort(ik, dim=1, stable=True)
    return ik.gather(1, o), ip.gather(1, o), it.gather(1, o)


def window_whole(spin, tail):
    """Whether a profiled window of :func:`device_kernels` holds every
    kernel of its body, from its kernels in time order (True for a spin):
    a spin recorded on each side of the body's kernels, or with none of
    them, more spins than either side alone holds (``tail`` + 1 before,
    ``tail`` after)."""
    kern = [i for i, sp in enumerate(spin) if not sp]
    if not kern:
        return sum(spin) > tail + 1
    return any(spin[:kern[0]]) and any(spin[kern[-1] + 1:])


def device_kernels(body):
    """torch.profiler's kernels for ``body()``: {name: (device µs, count)}.
    Spin kernels run before the body (a long one, then as many short ones
    as after it) and after it (32, 256, 1,024, 2,048, then 4,096 short
    ones) inside the profiled window and are left out.  They witness the
    window: the profiler loses records at its ends (the first record in
    a fresh process; in a long one, up to a third of the lead, the whole
    tail with the body's last kernels, the whole window, where it once
    counted 0 for the three kernels of a wrapper call, or the first ~90
    records whatever the lead's length, the whole lead and a third of a
    150-kernel body).  A window is whole
    when a spin before its first body kernel and one after its last were
    recorded (with no body kernel: more spins than either side alone
    holds; :func:`window_whole` judges); else it runs again with a longer
    lead and more spins on each side, and a fifth lost window in a row
    fails the run (a chip run of the whole script lost 16 windows, one of
    them twice in a row)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def spins(n):
        for _ in range(n):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    for lead, tail in ((0.02, 32), (0.2, 256), (1.0, 1024), (1.0, 2048),
                       (2.0, 4096)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(int(lead * H100_MAX_CLOCK_HZ))
            spins(tail)
            body()
            torch.cuda.synchronize()
            spins(tail)
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        spin = ["spin_kernel" in e.name for e in evs]
        kern = [i for i, sp in enumerate(spin) if not sp]
        out = {}
        for i in kern:
            us, n = out.get(evs[i].name, (0.0, 0))
            out[evs[i].name] = (us + evs[i].time_range.elapsed_us(), n + 1)
        if window_whole(spin, tail):
            return out
        print(f"torch.profiler: a window with a {lead * 1e3:.0f} ms lead "
              f"recorded {sum(spin)} of its {2 * tail + 1} spins and "
              f"{len(kern)} other kernels, without a spin on each side of "
              f"them", flush=True)
    raise Failure("torch.profiler lost records of five windows in a row")


def kernels_in(fn):
    """Kernels the card ran for one ``fn()``, from torch.profiler."""
    return sum(n for _, n in device_kernels(fn).values())


def prof_ms(fn, reps=50, setup=None):
    """torch.profiler over ``reps`` calls of ``fn()`` after a warm one,
    each call synchronised: (the card's kernel time a call in ms, kernels
    a call).  Unlike :func:`cuda_ms` it leaves out the gaps between
    launches.  ``setup()`` runs before each call; the kernels it launches
    (found by profiling it alone) are left out."""
    import torch
    skip = set(device_kernels(setup)) if setup is not None else set()
    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            if setup is not None:
                setup()
            fn()
            torch.cuda.synchronize()
    per = device_kernels(calls)
    us = sum(t for k, (t, _) in per.items() if k not in skip)
    n = sum(c for k, (_, c) in per.items() if k not in skip)
    return us / reps / 1e3, n / reps


def aten_calls(fn):
    """The aten operators one ``fn()`` dispatches on the host, outermost
    ones only (torch.profiler, CPU activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.name.startswith("aten::") and e.cpu_parent is None)


def host_us(fn, reps=200):
    """Host time of one ``fn()`` in µs, the mean of ``reps`` calls enqueued
    back to back (the card runs behind)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def call_figures(fn, setup=None):
    """Device time (CUDA events and profiler), kernels, aten operators and
    host time of one call of a kernel wrapper."""
    pm, n = prof_ms(fn, setup=setup)
    return {"ms": cuda_ms(fn, setup=setup), "prof_ms": pm,
            "prof_kernels_per_call": n, "kernels_per_call": kernels_in(fn),
            "aten_calls": aten_calls(fn), "host_us": host_us(fn)}


def max_cap(index):
    """The longest segment of an index list (the bare probe's bound)."""
    return max(ix["key"].shape[1] for ix in index)


def probe_cases(dev):
    """The probe's three configurations on crafted indexes and ops, each
    bit-equal to its plain version on the CPU: an index whose every slot
    is SENTINEL, full segments (no SENTINEL), ragged caps (2,880, 1, 33)
    with empty and full partitions; queries at live keys, one below and
    one past a partition's keys, SENTINEL, the lowest int32, partitions
    outside [0, P), IX_ID outside the index list, every kind; and the
    executors' strided op slices.  Returns the case names."""
    import torch
    from repro_torch.core.ops import IX_EXPECT, IX_HI, IX_ID, IX_LO
    from repro_torch.kernels.occ import ops as occ_ops
    from repro_torch.kernels.occ import ref as occ_ref
    from repro_torch.storage.index import SCAN_L
    from repro_torch.storage.index import SENTINEL as S
    gen = torch.Generator().manual_seed(23)
    P, B, K, C = 4, 64, 12, 10
    i32 = torch.int32

    def rint(lo, hi):
        return int(torch.randint(lo, hi, (1,), generator=gen))

    def table(cap, fills):
        key = torch.full((P, cap), S, dtype=i32)
        tid = torch.zeros((P, cap), dtype=torch.int64)
        for p, n in enumerate(fills):
            local = torch.randperm(1 << 16, generator=gen)[:n].sort().values
            key[p, :n] = ((p << 24) | local).to(i32)
            tid[p, :n] = torch.randint(0, 1 << 32, (n,), generator=gen)
        return {"key": key, "prow": torch.zeros((P, cap), dtype=i32),
                "tid": tid}

    def ops(index, rows):
        kinds = torch.randint(0, 10, (rows, K), generator=gen, dtype=i32)
        delta = torch.randint(-50, 50, (rows, K, C), generator=gen,
                              dtype=i32)
        n = len(index)
        for r in range(rows):
            for k in range(K):
                i, part = rint(-2, n + 2), rint(-1, P + 2)
                seg = index[i if 0 <= i < n else 0]["key"][
                    min(max(part, 0), P - 1)]
                live = seg[seg != S]
                c = rint(0, 7)
                if c == 0 and live.numel():
                    v = int(live[rint(0, live.numel())])
                elif c == 1 and live.numel():
                    v = int(live[-1]) + 1
                elif c == 2 and live.numel():
                    v = int(live[0]) - 1
                elif c == 3:
                    v = S
                elif c == 4:
                    v = -(1 << 31)
                elif c == 5:
                    v = part << 24
                else:
                    v = rint(-(1 << 30), 1 << 30)
                pos = int(torch.searchsorted(seg, torch.tensor(v, dtype=i32)))
                nxt = int(seg[pos]) if pos < seg.numel() else v
                delta[r, k, IX_LO] = v
                delta[r, k, IX_HI] = max(min(v + rint(-2, 1 << 12), S),
                                         -(1 << 31))
                delta[r, k, IX_EXPECT] = nxt if rint(0, 2) else v
                delta[r, k, IX_ID] = i
        return kinds, delta

    def strided(kinds, delta):
        """the same ops as slices of wider op arrays, on the card"""
        wk = torch.cat([kinds, kinds[:, :5]], 1).to(dev)
        wd = torch.cat([delta, delta[:, :5]], 1).to(dev)
        return wk[:, :K], wd[:, :K]

    indexes = {
        "ragged": [table(2880, [0, 1, 1500, 2880]), table(1, [0, 1, 1, 0]),
                   table(33, [33, 0, 32, 33])],
        "empty": [table(2880, [0] * P), table(1, [0] * P),
                  table(33, [0] * P)],
        "full": [table(33, [33] * P), table(2880, [2880] * P)],
    }
    names = []
    for name, index in indexes.items():
        di = to(index, dev)
        kinds, delta = ops(index, B)
        want = occ_ref.locate_index_ops_plain(index, kinds, delta, 1000)
        check(equal(occ_ops.locate_index_ops(di, *to((kinds, delta), dev),
                                             1000), want),
              f"probe case {name}: single-master differs")
        check(equal(occ_ops.locate_index_ops(di, *strided(kinds, delta),
                                             1000), want),
              f"probe case {name}: single-master on strided ops differs")
        pk, pd = kinds[:P], delta[:P]
        want = occ_ref.step_index_ops_plain(index, pk, pd)
        check(equal(occ_ops.step_index_ops(di, *to((pk, pd), dev)), want),
              f"probe case {name}: partitioned differs")
        check(equal(occ_ops.step_index_ops(di, *strided(pk, pd)), want),
              f"probe case {name}: partitioned on strided ops differs")
        for cfg, build, a, ns in (
                ("sm", occ_ref.sm_probe_args, (kinds, delta), SCAN_L + 1),
                ("part", occ_ref.part_probe_args, (pk, pd), 1)):
            *flat, _, n_iters = build(index, *a)
            want = occ_ref.scan_window_plain(*flat, n_slots=ns,
                                             n_iters=n_iters)
            got = occ_ops.scan_window(*to(flat, dev), n_slots=ns,
                                      max_cap=max_cap(index))
            check(equal(got, want), f"probe case {name}: bare ({cfg}) "
                  f"differs")
        names += [f"{name}/{c}" for c in ("single_master",
                                           "single_master_strided",
                                           "partitioned",
                                           "partitioned_strided",
                                           "bare_sm", "bare_part")]
    torch.cuda.synchronize()
    print(f"probe: {len(names)} crafted cases bit-equal")
    return names


def probe_checks(calls, dev, report):
    """The probe's three launch configurations on the main path's recorded
    arguments: single-master (the row's figures), partitioned and bare at
    both phases' shapes, each bit-equal to its plain version on the CPU
    and one kernel a call; then the crafted cases."""
    import torch
    from repro_torch.core.ops import IX_ID, is_index_kind
    from repro_torch.kernels.occ import ops as occ_ops
    from repro_torch.kernels.occ import ref as occ_ref
    from repro_torch.storage.index import SCAN_L
    cpu = torch.device("cpu")
    L1 = SCAN_L + 1

    def work(index, kinds, delta, sel, n_slots, out_bytes):
        """bytes and operations: each op's kind and 4 delta words read and
        its outputs written; a selected op's search (the keys of a binary
        search) and window (keys and TIDs)"""
        Q = kinds.numel()
        n_sel = int(sel.sum())
        lg = max(ix["key"].shape[1] for ix in index).bit_length()
        return (Q * (4 + 16 + out_bytes) + n_sel * (4 * lg + 12 * n_slots),
                Q * 4 + n_sel * (lg + 8 * n_slots))

    (index, kinds, delta, n_rows), _ = calls["locate_index_ops"]
    iid = delta[..., IX_ID].cpu()
    sel_sm = (is_index_kind(kinds.cpu()) & (iid >= 0)
              & (iid < len(index)))
    nb, no = work(index, kinds, delta, sel_sm, L1, 4 + 8 + 1 + L1 * 13)
    row = report("scan_window", occ_ops.locate_index_ops,
                 occ_ref.locate_index_ops_plain,
                 (index, kinds, delta, n_rows), {}, nbytes=nb, nops=no)
    a = to((index, kinds, delta, n_rows), dev)
    row["single_master"] = dict(
        call_figures(lambda: occ_ops.locate_index_ops(*a)),
        queries=kinds.numel(), selected=int(sel_sm.sum()))
    sm_args = (index, kinds, delta)

    (pindex, pk, pd), _ = calls["step_index_ops"]
    got = occ_ops.step_index_ops(*to((pindex, pk, pd), dev))
    want = occ_ref.step_index_ops_plain(*to((pindex, pk, pd), cpu))
    check(equal(got, want), "probe (partitioned) differs from its plain "
          "version")
    piid = pd[..., IX_ID].cpu()
    sel_p = (piid >= 0) & (piid < len(pindex))
    nb, no = work(pindex, pk, pd, sel_p, 1, 1 + 8)
    a = to((pindex, pk, pd), dev)
    row["partitioned"] = dict(
        call_figures(lambda: occ_ops.step_index_ops(*a)),
        queries=pk.numel(), selected=int(sel_p.sum()),
        max_abs_err=max_abs_err(got, want),
        plain_ms=cuda_ms(lambda: occ_ref.step_index_ops_plain(*a)),
        bound_ms=max(nb / H100_BYTES_PER_S, no / H100_INT32_OPS_PER_S) * 1e3)

    # the bare configuration (segment_scan's) on both phases' probes: the
    # queries of every op, flat segments built by the plain glue
    row["bare"] = {}
    for cfg, build, args, ns in (
            ("single_master", occ_ref.sm_probe_args, sm_args, L1),
            ("partitioned", occ_ref.part_probe_args, (pindex, pk, pd), 1)):
        *flat, _, n_iters = build(*to(args, cpu))
        want = occ_ref.scan_window_plain(*flat, n_slots=ns, n_iters=n_iters)
        fd = to(flat, dev)
        mc = max_cap(args[0])
        got = occ_ops.scan_window(*fd, n_slots=ns, max_cap=mc)
        check(equal(got, want), f"probe (bare, {cfg} shape) differs from "
              f"its plain version")
        row["bare"][cfg] = dict(
            call_figures(lambda: occ_ops.scan_window(
                *fd, n_slots=ns, max_cap=mc)),
            queries=int(flat[2].numel()), n_slots=ns)
    for cfg, fig in [("single_master", row["single_master"]),
                     ("partitioned", row["partitioned"])] + [
            (f"bare {c}", f) for c, f in row["bare"].items()]:
        check(fig["kernels_per_call"] == 1, f"probe ({cfg}): "
              f"{fig['kernels_per_call']} kernels a call")
    row["kernels_per_call"] = 1
    row["crafted_cases"] = probe_cases(dev)


def round_checks(calls, dev, report):
    """The OCC round on the main path's recorded arguments, Silo (the
    row's figures) and Calvin, bit-equal to its plain version on the CPU
    with the lock arrays all B after it, one kernel a call; then rounds
    with no claims and without an index, in both modes."""
    import torch
    from repro_torch.kernels.occ import ops as occ_ops
    from repro_torch.kernels.occ import ref as occ_ref
    cpu = torch.device("cpu")

    def plain(*a, ix=None, has_claim=None, deterministic=False, lock=None,
              rlock=None):
        out = occ_ref.occ_round_plain(*a, lock,
                                      rlock if deterministic else None,
                                      ix=ix, has_claim=has_claim)
        return (a[0], a[1], *out)

    def with_locks(fn):
        """fn's outputs, then its lock arrays as they are after it"""
        return lambda *a, **k: (*fn(*a, **k), k.get("lock"), k.get("rlock"))

    def checked_round(what, args, kw):
        got = with_locks(occ_ops.occ_round)(*to(args, dev), **to(kw, dev))
        torch.cuda.synchronize()
        want = with_locks(plain)(*to(args, cpu), **to(kw, cpu))
        check(equal(got, want), f"occ_round ({what}) differs from its plain "
              f"version")
        B = args[2].shape[0]
        for t in got[-2:]:
            check(t is None or bool((t == B).all()),
                  f"occ_round ({what}): a lock entry is not B after it")

    args, kw = calls["occ_round"]
    val, tidw, rows, kind, delta_v, wmask, amask, active = args[:8]
    ix, has_claim = kw["ix"], kw["has_claim"]
    B, M = rows.shape
    N, C = val.shape
    K, L = ix["scan_addr"].shape[1], ix["scan_addr"].shape[2]
    v0, t0 = val.to(dev), tidw.to(dev)

    def reset(a):
        """Restore the tables the round installs into."""
        a[0].copy_(v0)
        a[1].copy_(t0)
    n_claim = int(has_claim.sum())
    n_scan = int(ix["scan_valid"].sum())
    n_w = int(wmask.sum())
    # claims: masks read, an atomic and a release a claim; validate: the
    # ops, masks, rows' values, TIDs and locks, the index claims and scan
    # slots (a flag each, address, lock word and TID where it is set),
    # the outputs; install: the winners' values and TIDs written
    nbytes = (B * M * 2 + B * K + (n_w + n_claim) * 8
              + B * M * (4 + 4 + 4 * C) + B * (1 + 8)
              + B * M * (4 * C + 8 + 4) + n_claim * (4 + 8 + 4)
              + B * K * L + n_scan * (4 + 8 + 4)
              + B * (1 + 8) + B * M * (4 * C + 1)
              + n_w * (4 * C + 8))
    nops = B * M * (2 * C + 8) + (n_claim + n_scan) * 4 + (n_w + n_claim) * 2
    row = report("occ_round", with_locks(occ_ops.occ_round),
                 with_locks(plain), args, kw, nbytes=nbytes, nops=nops,
                 reset=reset)
    row["replaces_sites"] = REPLACES_ROUND
    a, k = to(args, dev), to(kw, dev)
    row["silo"] = call_figures(lambda: occ_ops.occ_round(*a, **k),
                               setup=lambda: reset(a))
    kc = dict(kw, deterministic=True, rlock=torch.full_like(kw["lock"], B))
    checked_round("Calvin", args, kc)
    kcd = to(kc, dev)
    row["calvin"] = call_figures(lambda: occ_ops.occ_round(*a, **kcd),
                                 setup=lambda: reset(a))
    for mode in ("silo", "calvin"):
        n = row[mode]["kernels_per_call"]
        check(n == 1, f"occ_round ({mode}): {n} kernels a call")
    row["kernels_per_call"] = 1

    # crafted: a round with no claims; a round without an index
    cases = []
    off = torch.zeros_like(wmask)
    quiet = (*args[:5], off, off, torch.zeros_like(active), *args[8:])
    for det in (False, True):
        mode = "calvin" if det else "silo"
        kq = dict(kw, has_claim=torch.zeros_like(has_claim),
                  deterministic=det, rlock=torch.full_like(kw["lock"], B))
        checked_round(f"{mode}, no claims", quiet, kq)
        lk = torch.full((N + 1,), B, dtype=torch.int32)
        kn = dict(kw, ix=None, has_claim=None, deterministic=det, lock=lk,
                  rlock=lk.clone())
        checked_round(f"{mode}, no index", args, kn)
        cases += [f"{mode}/no_claims", f"{mode}/no_index"]
    row["crafted_cases"] = cases
    print(f"occ_round: Silo and Calvin bit-equal, lock arrays all B, "
          f"{len(cases)} crafted rounds")


def index_merge_cases(dev):
    """index_merge on crafted batches, bit-equal to the plain version on
    the CPU, each through the shared-memory and the global-scratch path
    (``smem_limit=0``) and through the public wrapper: insert keys tied
    with distinct payloads (stability), inserts equal to existing keys,
    double deletes, overflow, empty and all-SENTINEL segments, Kd or Ki 0
    or 1, caps that are not a multiple of the 512-slot tile, negative
    keys, and a sort of 4,500 live inserts.  Returns the case names."""
    import torch
    from repro_torch.kernels.index_merge.ops import (index_merge,
                                                     index_merge_cuda)
    from repro_torch.kernels.index_merge.ref import index_merge_unsorted_plain
    from repro_torch.storage.index import SENTINEL as S
    gen = torch.Generator().manual_seed(21)
    i32 = torch.int32

    def rnd(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=i32)

    def segs(fill, cap, space, lo=0):
        """sorted segments of distinct keys in [lo, lo + space), fill[p]
        live keys in segment p, the rest canonical free slots"""
        key = torch.full((len(fill), cap), S, dtype=i32)
        for p, n in enumerate(fill):
            ks = torch.randperm(space, generator=gen)[:n].sort().values
            key[p, :n] = (ks + lo).to(i32)
        live = key != S
        prow = torch.where(live, rnd(0, 1 << 20, key.shape), 0)
        tid = torch.where(live, torch.randint(0, 1 << 32, key.shape,
                                              generator=gen), 0)
        return key, prow, tid

    def batch(ik, dk):
        """payloads for inserts ik: prow = a distinct number a column"""
        P, Ki = ik.shape
        ip = torch.arange(P * Ki, dtype=i32).reshape(P, Ki) + 7
        it = torch.randint(0, 1 << 32, (P, Ki), generator=gen)
        live = ik != S
        return dk, ik, torch.where(live, ip, 0), torch.where(live, it, 0)

    def masked(x, frac):
        return torch.where(torch.rand(x.shape, generator=gen) < frac, x, S)

    cases = {}
    # ties: 64 inserts a segment over 6 keys, some of them existing
    k, p, t = segs([100, 150, 40], 300, 400)
    cases["ties"] = (k, p, t, *batch(rnd(0, 6, (3, 64)),
                                     masked(rnd(0, 400, (3, 20)), 0.5)))
    # inserts equal to existing keys (side="right": existing first)
    k, p, t = segs([120, 200, 60], 300, 1000)
    ik = k.gather(1, rnd(0, 60, (3, 48)).long())
    cases["equal_existing"] = (k, p, t, *batch(masked(ik, 0.8),
                                               rnd(0, 1000, (3, 10))))
    # double deletes: existing keys deleted twice, absent keys, masked
    k, p, t = segs([250, 90, 299], 300, 2000)
    dk = k.gather(1, rnd(0, 90, (3, 40)).long())
    dk = torch.cat([dk, dk[:, :15], rnd(0, 2000, (3, 10))], 1)
    cases["double_deletes"] = (k, p, t, *batch(
        masked(rnd(0, 2000, (3, 30)), 0.5), masked(dk, 0.9)))
    # overflow: n_live + n_ins > cap
    k, p, t = segs([295, 300, 10], 300, 5000)
    cases["overflow"] = (k, p, t, *batch(rnd(0, 5000, (3, 60)),
                                         masked(rnd(0, 5000, (3, 8)), 0.5)))
    # an empty segment, all-SENTINEL inserts, all-SENTINEL deletes
    k, p, t = segs([0, 80, 80], 300, 500)
    ik = rnd(0, 500, (3, 32))
    ik[1] = S
    dk = k.gather(1, rnd(0, 80, (3, 12)).long())
    dk[2] = S
    cases["empty_and_sentinel"] = (k, p, t, *batch(ik, dk))
    # Kd or Ki 0 and 1 (the reference pads those itself)
    k, p, t = segs([30, 5], 40, 100)
    for nd, ni in ((0, 9), (7, 0), (1, 1), (0, 0)):
        dk = k.gather(1, rnd(0, 5, (2, nd)).long())
        cases[f"kd{nd}_ki{ni}"] = (k, p, t, *batch(rnd(0, 100, (2, ni)),
                                                   dk))
    # caps around the tile: 5, 256, 513 slots
    for cap in (5, 256, 513):
        k, p, t = segs([cap // 2, cap - 1], cap, 4 * cap)
        cases[f"cap{cap}"] = (k, p, t, *batch(
            masked(rnd(0, 4 * cap, (2, 24)), 0.7),
            k.gather(1, rnd(0, cap // 2 + 1, (2, 6)).long())))
    # negative keys and a large sort (4,500 live inserts of 5,000)
    k, p, t = segs([2000, 3500], 8000, 1 << 20, lo=-(1 << 19))
    cases["large_sort"] = (k, p, t, *batch(
        masked(rnd(-(1 << 19), 1 << 19, (2, 5000)), 0.9),
        k.gather(1, rnd(0, 2000, (2, 300)).long())))
    for name, case in cases.items():
        want = index_merge_unsorted_plain(*case)
        a = to(case, dev)
        for lim in (None, 0):
            kw = {} if lim is None else {"smem_limit": lim}
            check(equal(index_merge_cuda(*a, **kw), want),
                  f"index_merge case {name} (smem_limit={lim}) differs "
                  f"from its plain version")
        check(equal(index_merge(*a), want),
              f"index_merge case {name}: the wrapper differs")
    print(f"index_merge: {len(cases)} crafted cases bit-equal, in shared "
          f"memory and in global scratch")
    return list(cases)


def kernel_checks(calls, dev):
    """Parity, timing and bound of every kernel on its recorded arguments.
    Returns {name: report} (launches filled in later)."""
    import torch
    from repro_torch.kernels.index_merge import ops as im_ops
    from repro_torch.kernels.index_merge.ops import index_merge_cuda
    from repro_torch.kernels.index_merge.ref import index_merge_unsorted_plain
    cpu = torch.device("cpu")
    out = {}

    def report(name, kernel, plain, args, kw, nbytes, nops,
               plain_is_library=False, reset=None):
        """kernel/plain: callables on (*args, **kw) -> result tree; the
        kernel on copies on the card, the plain version on copies on the
        CPU.  ``plain_is_library``: the plain version is itself the one
        PyTorch call that computes the function, so its time is also the
        library time.  ``reset(args)`` restores inputs a call updates in
        place before each timed call."""
        got = kernel(*to(args, dev), **to(kw, dev))
        torch.cuda.synchronize()
        want = plain(*to(args, cpu), **to(kw, cpu))
        check(equal(got, want), f"{name}: kernel differs from its plain "
              f"version")
        err = max_abs_err(got, want)
        ka, pa, kd = to(args, dev), to(args, dev), to(kw, dev)
        ms = cuda_ms(lambda: kernel(*ka, **kd),
                     setup=reset and (lambda: reset(ka)))
        plain_ms = cuda_ms(lambda: plain(*pa, **kd),
                           setup=reset and (lambda: reset(pa)))
        lib_ms = plain_ms if plain_is_library else None
        pm = prof_ms(lambda: kernel(*ka, **kd),
                     setup=reset and (lambda: reset(ka)))[0]
        bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
        bound_ops = nops / H100_INT32_OPS_PER_S * 1e3
        out[name] = {
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": ms, "prof_ms": pm, "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": lib_ms, "bytes": int(nbytes), "ops": int(nops)}
        return out[name]

    # -- the probe and the round: every configuration on its recorded
    # arguments, the crafted cases, one kernel a call
    probe_checks(calls, dev, report)
    round_checks(calls, dev, report)

    # -- index_merge at both phases' shapes, inserts unsorted as the
    # executors hand them over; the scratch path on the same arguments
    im = {}
    for key in ("index_merge/part", "index_merge/sm"):
        args, kw = calls[key]
        want = index_merge_unsorted_plain(*to(args, cpu))
        check(equal(index_merge_cuda(*to(args, dev)), want),
              f"{key} differs from its plain version")
        check(equal(index_merge_cuda(*to(args, dev), smem_limit=0), want),
              f"{key} (global scratch) differs from its plain version")
        P, cap = args[0].shape
        Kd, Ki = args[3].shape[1], args[4].shape[1]
        lg = max(cap, Ki).bit_length()
        im[key] = dict(args=args, nbytes=P * cap * 16 * 2
                       + P * (Kd * 4 + Ki * 16 + 4),
                       nops=P * (Kd + Ki + 2 * cap) * lg * 3,
                       shape=[P, cap, Kd, Ki])
    sm = im["index_merge/sm"]
    report("index_merge", index_merge_cuda, index_merge_unsorted_plain,
           sm["args"], {}, nbytes=sm["nbytes"], nops=sm["nops"])
    row = out["index_merge"]
    for key, r in im.items():
        a = to(r["args"], dev)
        ms = cuda_ms(lambda: index_merge_cuda(*a))
        sg = cuda_ms(lambda: sort_gather(*a[4:]))
        b = max(r["nbytes"] / H100_BYTES_PER_S,
                r["nops"] / H100_INT32_OPS_PER_S) * 1e3
        n = kernels_in(lambda: im_ops.index_merge(*a))
        check(n <= 2, f"{key}: one call launched {n} kernels")
        row[key.split("/")[1]] = {"shape_P_cap_Kd_Ki": r["shape"], "ms": ms,
                                  "bound_ms": b, "sort_gather_ms": sg,
                                  "kernels_per_call": n}
    row["kernels_per_call"] = row["sm"]["kernels_per_call"]
    row["crafted_cases"] = index_merge_cases(dev)

    # -- thomas_merge on the epoch's single-master value stream, read in
    # place, then through the bare entry and on crafted streams
    thomas_checks(calls, dev, report)
    return out


def thomas_cases(dev):
    """thomas_merge on crafted streams, each bit-equal to its plain version
    on the CPU: an empty stream (K = 0), every row -1, every write to one
    row under one TID (the last wins), TIDs at or below the rows' (none
    wins), TIDs at 2^32 - 1, an odd C and a C of 20 (word copies), and two
    calls back to back on one table.  Returns the case names."""
    import torch
    from repro_torch.kernels.thomas_merge.ops import thomas_merge
    from repro_torch.kernels.thomas_merge.ref import thomas_merge_plain
    gen = torch.Generator().manual_seed(29)
    N, C, K = 4096, 10, 3000
    i32 = torch.int32
    val = torch.randint(-99, 99, (N, C), generator=gen, dtype=i32)
    tid = torch.randint(0, 1000, (N,), generator=gen)
    tid[:8] = 2**32 - 2
    vals = torch.randint(-2**31, 2**31 - 1, (K, C), generator=gen, dtype=i32)

    def rows(hi, n=K):
        return torch.randint(-1, hi, (n,), generator=gen, dtype=i32)

    def tids(lo, hi, n=K):
        return torch.randint(lo, hi, (n,), generator=gen)
    top = tids(0, 2)
    top = torch.where(top == 1, 2**32 - 1, 2**32 - 2)
    cases = {
        "empty": (val, tid, rows(N, 0), vals[:0], tids(0, 9, 0)),
        "all skipped": (val, tid, torch.full((K,), -1, dtype=i32), vals,
                        tids(0, 2000)),
        "one row, one TID": (val, tid, torch.full((K,), 77, dtype=i32), vals,
                             torch.full((K,), 5000)),
        "stale": (val, tid, rows(N), vals, tids(0, 1)),
        "top TID": (val, tid, rows(16), vals, top),
        "odd C": (val[:, :3].contiguous(), tid, rows(64),
                  vals[:, :3].contiguous(), tids(0, 1500)),
        "many writes a row": (val, tid, rows(40), vals, tids(0, 1500)),
        "wide C": (val.repeat(1, 2), tid, rows(N), vals.repeat(1, 2),
                   tids(0, 1500)),
    }
    for what, (v, t, r, wv, wt) in cases.items():
        want = thomas_merge_plain(v.clone(), t.clone(), r, wv, wt)
        got = thomas_merge(*to((v, t, r, wv, wt), dev))
        torch.cuda.synchronize()
        check(equal(got, want), f"thomas_merge {what}: kernel differs from "
              f"its plain version")
    got = thomas_merge(*to(cases["one row, one TID"], dev))
    check(got[0][77].tolist() == vals[-1].tolist() and int(got[1][77]) == 5000,
          "thomas_merge: of equal TIDs the last write did not win")
    # back to back on one table: the second call sees the first's table,
    # not its scratch
    a, b = cases["many writes a row"], cases["top TID"]
    want = thomas_merge_plain(val.clone(), tid.clone(), *a[2:])
    want = thomas_merge_plain(*want, *b[2:])
    d = to((val, tid), dev)
    thomas_merge(*d, *to(a[2:], dev))
    got = thomas_merge(*d, *to(b[2:], dev))
    torch.cuda.synchronize()
    check(equal(got, want), "thomas_merge: two calls back to back differ "
          "from the plain version")
    return list(cases) + ["back to back"]


def thomas_checks(calls, dev, report):
    """thomas_merge on the warm epoch's single-master log as the engine
    hands it to ``thomas_apply_batch`` (the log's flattened views), then
    through the bare entry on the same stream, then on crafted streams;
    one kernel a call under torch.profiler, and the aten operators and
    host time of ``thomas_apply_batch``."""
    import torch
    from repro_torch.core import replication
    from repro_torch.kernels.thomas_merge.ops import thomas_merge
    from repro_torch.kernels.thomas_merge.ref import thomas_merge_plain
    (val, tidw, lg), _ = calls["thomas_apply_batch"]
    C = val.shape[1]
    log = to({k: lg[k] for k in ("row", "val", "tid")}, dev)
    # the stream the kernel reads: the log's flattened views
    args = (val, tidw, lg["row"].reshape(-1), lg["val"].reshape(-1, C),
            lg["tid"].reshape(-1))
    wrows = args[2]
    Kw = wrows.numel()
    a_dev = to(args, dev)
    thomas_merge(*a_dev)
    n_win = int((a_dev[1] != tidw).sum())
    n_live = int((wrows >= 0).sum())
    tid0 = tidw.to(dev)

    def reset(a):
        """Restore the TID column (values rewritten are the same)."""
        a[1].copy_(tid0)
    # every row id; a live write's TID and its row's TID; a winner's
    # values read and written and its TID written
    row = report("thomas_merge", thomas_merge, thomas_merge_plain, args, {},
                 nbytes=Kw * 4 + n_live * (8 + 8)
                 + n_win * (4 * C + 4 * C + 8),
                 nops=Kw + n_live * 3, reset=reset)
    # the log as the engine hands it over, through thomas_apply_batch
    check(equal(replication.thomas_apply_batch(*to((val, tidw), dev), log),
                thomas_merge_plain(*to(args, torch.device("cpu")))),
          "thomas_apply_batch differs from the plain version")
    row["crafted_cases"] = thomas_cases(dev)
    n = kernels_in(lambda: replication.thomas_apply_batch(a_dev[0], a_dev[1],
                                                          log))
    check(n == 1, f"thomas_apply_batch: one call launched {n} kernels")
    fig = call_figures(
        lambda: replication.thomas_apply_batch(a_dev[0], a_dev[1], log),
        setup=lambda: reset(a_dev))
    row.update(log_shape=list(lg["row"].shape), writes=Kw, live=n_live,
               winners=n_win, kernels_per_call=n,
               apply_batch={k: fig[k] for k in ("prof_kernels_per_call",
                                                "aten_calls", "host_us")})


def profile_epoch(eng, cfg, state):
    """One more main-path epoch under torch.profiler: the card's busy time
    (sum of kernel self times) against the epoch's wall time, and the
    kernels that take most of it.  Runs after the measured epochs, so its
    overhead touches none of their numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.db import tpcc
    b = tpcc.make_batch(cfg, state, MAIN_TXNS, seed=MAIN_EPOCHS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = eng.run_epoch(b)
        wall = time.perf_counter() - t0
    check(eng.replica_consistent(), "profiled epoch: replica diverged")
    tpcc.apply_consume_feedback(state, b, m)
    rows = []
    for e in prof.key_averages():
        # device-side events only: a CPU op's self device time repeats
        # the time of the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(us for us, _, _ in rows) / 1e6
    if busy == 0:
        return {"wall_s": wall, "device_busy_s": "not measured"}
    return {"wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall,
            "top_kernels": [[k[:80], us / 1e3, n] for us, k, n in rows[:10]]}


# ---------------------------------------------------------------------------
# phase 8: the online transaction service on the card
# ---------------------------------------------------------------------------
STAR_KERNELS = ("scan_window", "occ_round", "index_merge", "thomas_merge")


def by_kernel(counts):
    """Launch counts summed per kernel over its launch configurations
    (``<name>.<config>``)."""
    return {k: sum(n for c, n in counts.items()
                   if c == k or c.startswith(k + ".")) for k in STAR_KERNELS}


def serve_checked(svc, duration_s, feedback_state=None):
    """``svc.run(duration_s)`` with ``replica_consistent()`` checked at
    every fence and every batch run recorded (a copy, with the epoch's
    commit masks), the kernels' launch counts set to 0 just before and
    read just after.  Returns (summary with the engine's epoch split over
    the run added, records, launches by configuration,
    kernel_launch_counts() over the run)."""
    import copy
    import torch
    from repro_torch.kernels import _build
    from repro_torch.obs.trace import kernel_launch_counts
    eng = svc.engine
    run_epoch = eng.run_epoch
    records = []

    def checked(batch, ingest=None):
        b = copy.deepcopy(batch)
        m = run_epoch(batch, ingest=ingest)
        check(eng.replica_consistent(), f"service: replica diverged at "
              f"fence {eng.committed_epoch}")
        records.append((b, {k: m[k].copy() for k in ("p_committed",
                                                     "c_committed")}))
        return m
    eng.run_epoch = checked
    split = ("part_time_s", "sm_time_s", "fence_time_s", "epochs")
    stats0 = {f: getattr(eng.stats, f) for f in split}
    torch.cuda.synchronize()
    before = kernel_launch_counts()
    _build.reset_launch_counts()
    try:
        out = svc.run(duration_s=duration_s)
    finally:
        eng.run_epoch = run_epoch
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    after = kernel_launch_counts()
    wrapper = {k: after[k] - before.get(k, 0) for k in after
               if after[k] != before.get(k, 0)}
    for c in svc.clients:
        if hasattr(c, "shutdown"):
            c.shutdown()
    # the engine's split of the run's epochs (warm-up included: its
    # epochs run inside svc.run before the clock starts)
    out["engine_split"] = {f: getattr(eng.stats, f) - stats0[f]
                           for f in split}
    return out, records, launches, wrapper


def service_figures(out, launches, wrapper, wall):
    keys = ("throughput_txn_s", "p50_ms", "p99_ms", "p999_ms", "mean_ms",
            "committed", "user_aborted", "epochs", "offered", "admitted",
            "shed", "backpressured", "rerouted", "starved_requeues",
            "max_part_depth", "max_master_depth", "ingest_overlap_s",
            "epoch_time_s", "engine_split")
    fig = {k: out[k] for k in keys}
    fig.update(wall_s=wall, launches=launches,
               launches_by_kernel=by_kernel(launches),
               kernel_launch_counts=wrapper)
    return fig


def replay_card_vs_cpu(records, make, n, what, dev):
    """A service run's batches, the warm-up's empty ones included, up to
    its ``n``-th non-empty one, replayed through a fresh engine on the card
    and one on the CPU (``make(device)`` builds each): master and replica
    bit-equal after every epoch, indexes included, the commit masks equal
    to each other and to the service run's."""
    import copy
    import numpy as np
    live = np.cumsum([b["n_single"] + b["n_cross"] > 0 for b, _ in records])
    check(live.size and live[-1] >= n, f"{what}: the service formed only "
          f"{int(live[-1]) if live.size else 0} non-empty batches")
    upto = int(np.searchsorted(live, n)) + 1
    sides = [make(d) for d in (dev, "cpu")]
    for i, (b, want) in enumerate(records[:upto]):
        ms = [e.run_epoch(copy.deepcopy(b)) for e in sides]
        g, h = sides
        check(same_store(g.store, h.store)
              and same_store(g.replica_store, h.replica_store),
              f"{what} replay: card and CPU differ after epoch {i}")
        for k in ("p_committed", "c_committed"):
            check(np.array_equal(ms[0][k], ms[1][k])
                  and np.array_equal(ms[0][k], want[k]),
                  f"{what} replay: {k} differs at epoch {i}")
    print(f"service replay: {what}'s first {upto} epochs ({n} non-empty) "
          f"bit-equal on the card and the CPU")
    return n


def service_path(dev):
    """Phase 8: ``TxnService`` on the card — the three scenarios of
    examples/serve_txn.py on YCSB at the paper's scale (the steady one
    with durability, then ``recover_full`` on the card), and TPC-C's full
    mix at the main path's scale, each of the steady and TPC-C runs'
    batches replayed card against CPU.  Returns (figures, {kernel:
    launches by run})."""
    import tempfile
    from pathlib import Path as _P
    import torch
    from repro_torch.core.engine import StarEngine
    from repro_torch.db import tpcc, ycsb
    from repro_torch.db.wal import Durability, recover_full
    from repro_torch.service import (AdmissionConfig, OpenLoopClient,
                                     TPCCSource, TxnService, YCSBSource)
    base = ycsb.YCSBConfig(n_partitions=YCSB_P)
    skew = ycsb.YCSBConfig(n_partitions=YCSB_P, zipf_theta=0.9)
    print(f"service path: YCSB P={base.n_partitions} x "
          f"{base.records_per_partition} records, {ycsb.C} int32 columns, "
          f"{ycsb.M} ops, cross {base.cross_ratio}; slots "
          f"{SERVICE_SLOTS}, lanes {SERVICE_LANES}")
    figures, launches = {}, {}
    wal = {}
    for name, cfg, rate, process, caps in (
            ("steady", base, 1500.0, "poisson", (256, 512)),
            ("burst_zipf", skew, 1000.0, "bursty", (256, 512)),
            ("overload", base, 30_000.0, "poisson", (64, 128))):
        tmp = tempfile.TemporaryDirectory() if name == "steady" else None
        dur = (Durability(tmp.name, n_workers=4, checkpoint_every=4)
               if tmp else None)
        eng = StarEngine(cfg.n_partitions, cfg.records_per_partition,
                         durability=dur, device=dev)
        client = OpenLoopClient(YCSBSource(cfg, seed=1), rate_txn_s=rate,
                                process=process, seed=7)
        svc = TxnService(eng, [client], AdmissionConfig(*caps, "shed"),
                         slots_per_partition=SERVICE_SLOTS,
                         master_lanes=SERVICE_LANES)
        t0 = time.perf_counter()
        out, records, ln, wr = serve_checked(svc, SERVICE_S)
        fig = service_figures(out, ln, wr, time.perf_counter() - t0)
        fig.update(offered_rate_txn_s=rate, process=process,
                   part_cap=caps[0], master_cap=caps[1])
        figures[name] = fig
        launches[f"ycsb_{name}"] = fig["launches_by_kernel"]
        print(f"service {name}: {out['throughput_txn_s']:.1f} txn/s, p50 "
              f"{out['p50_ms']:.2f} p99 {out['p99_ms']:.2f} ms, "
              f"{out['committed']} committed in {out['epochs']} epochs, "
              f"shed {out['shed']}, launches {fig['launches_by_kernel']}")
        check(out["committed"] > 0, f"service {name}: nothing committed")
        for k in ("occ_round", "thomas_merge"):
            check(fig["launches_by_kernel"][k] > 0,
                  f"service {name}: {k} never launched")
        if name == "overload":
            check(out["shed"] > 0, "overload: nothing shed")
            check(out["max_part_depth"] <= caps[0]
                  and out["max_master_depth"] <= caps[1],
                  "overload: a queue grew past its cap")
        if dur is not None:
            d = _P(tmp.name)
            dur.close()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rv, rt, rix, e_c = recover_full(d, device=dev)
            torch.cuda.synchronize()
            t_rec = time.perf_counter() - t0
            snap = eng.store.snapshot
            check(rix is None and torch.equal(rv, snap["val"])
                  and torch.equal(rt, snap["tid"]),
                  "recover_full on the card differs from the committed "
                  "state")
            wal = {"entries": dur.entries_logged,
                   "checkpoints": dur.checkpoints,
                   "wal_bytes": sum(f.stat().st_size
                                    for f in d.glob("wal_*.log")),
                   "checkpoint_bytes": sum(f.stat().st_size
                                           for f in d.glob("ckpt_*")),
                   "recovered_from_epoch": e_c,
                   "committed_epoch": eng.committed_epoch,
                   "recover_full_s": t_rec}
            print(f"durability: {wal['entries']} entries, "
                  f"{wal['wal_bytes']} log bytes, {wal['checkpoints']} "
                  f"checkpoints; recover_full on the card in {t_rec:.3f} s "
                  f"bit-equal to the committed state")
            tmp.cleanup()
            steady = records
        del eng, svc, records
        torch.cuda.empty_cache()
    replayed = {"ycsb_steady": replay_card_vs_cpu(
        steady, lambda d: StarEngine(base.n_partitions,
                                     base.records_per_partition, device=d),
        SERVICE_REPLAY, "steady", dev)}
    del steady

    # TPC-C's full mix through the service at the main path's scale
    cfg, state, eng = mk_engine(MAIN, 0, dev)
    client = OpenLoopClient(TPCCSource(cfg, state=state, seed=2),
                            rate_txn_s=SERVICE_TPCC_RATE)
    svc = TxnService(eng, [client], AdmissionConfig(256, 512, "shed"),
                     slots_per_partition=SERVICE_SLOTS,
                     master_lanes=SERVICE_LANES,
                     feedback=lambda b, m: tpcc.apply_consume_feedback(
                         state, b, m))
    t0 = time.perf_counter()
    out, records, ln, wr = serve_checked(svc, SERVICE_TPCC_S)
    fig = service_figures(out, ln, wr, time.perf_counter() - t0)
    fig.update(offered_rate_txn_s=SERVICE_TPCC_RATE,
               index_overflow=eng.stats.index_overflow,
               consume_skips=eng.stats.consume_skips)
    figures["tpcc_full"] = fig
    launches["tpcc_full"] = fig["launches_by_kernel"]
    print(f"service tpcc_full: {out['throughput_txn_s']:.1f} txn/s, p50 "
          f"{out['p50_ms']:.2f} p99 {out['p99_ms']:.2f} ms, "
          f"{out['committed']} committed in {out['epochs']} epochs, "
          f"launches {fig['launches_by_kernel']}")
    check(out["committed"] > 0, "service tpcc_full: nothing committed")
    for k in STAR_KERNELS:
        check(fig["launches_by_kernel"][k] > 0,
              f"service tpcc_full: {k} never launched")
    for c in ("scan_window.partitioned", "scan_window.single_master"):
        check(ln.get(c, 0) > 0 and wr.get(c, 0) > 0,
              f"service tpcc_full: {c} never launched")
    del eng, svc
    torch.cuda.empty_cache()
    # the TPC-C batches replayed card against CPU: the probe in both
    # phases, index_merge, occ_round with the index and thomas_merge held
    # against their plain versions at the service's shapes
    replayed["tpcc_full"] = replay_card_vs_cpu(
        records, lambda d: mk_engine(MAIN, 0, d)[2], SERVICE_TPCC_REPLAY,
        "tpcc_full", dev)
    del records
    torch.cuda.empty_cache()

    # the WAL with the ordered indexes: recover_full replays the index
    # chunks on the card through index_merge
    with tempfile.TemporaryDirectory() as d:
        dur = Durability(d, n_workers=2, checkpoint_every=3)
        cfg, state, eng = mk_engine(FIG11, 0, dev, durability=dur)
        for ep in range(SERVICE_WAL_EPOCHS):
            b = tpcc.make_batch(cfg, state, FIG11_TXNS, seed=ep)
            tpcc.apply_consume_feedback(state, b, eng.run_epoch(b))
        dur.close()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rv, rt, rix, e_c = recover_full(d, device=dev)
        torch.cuda.synchronize()
        t_rec = time.perf_counter() - t0
        check(same_store({"val": rv, "tid": rt, "indexes": rix},
                         eng.store.snapshot),
              "recover_full (TPC-C, indexes) on the card differs from the "
              "committed state")
        wal["tpcc_indexes"] = {"epochs": SERVICE_WAL_EPOCHS,
                               "recovered_from_epoch": e_c,
                               "entries": dur.entries_logged,
                               "recover_full_s": t_rec}
        print(f"durability with indexes: {SERVICE_WAL_EPOCHS} fig11 "
              f"epochs, recover_full on the card from epoch {e_c} in "
              f"{t_rec:.3f} s bit-equal, indexes included")
        del eng
    return {"ycsb": {"n_partitions": base.n_partitions,
                     "records_per_partition": base.records_per_partition,
                     "cols": ycsb.C, "ops": ycsb.M,
                     "cross_ratio": base.cross_ratio},
            "slots_per_partition": SERVICE_SLOTS,
            "master_lanes": SERVICE_LANES, "duration_s": SERVICE_S,
            "tpcc_duration_s": SERVICE_TPCC_S, "scenarios": figures,
            "wal": wal, "replayed_card_vs_cpu": replayed}, launches


# ---------------------------------------------------------------------------
# phase 9: the read tier and the analytics lane
# ---------------------------------------------------------------------------
def shape_figures(kernel, plain, args, kw, nbytes, nops, reset=None):
    """One recorded call of a kernel wrapper at a new call shape: bit-equal
    to its plain version on CPU copies, both timed on the card (CUDA
    events; the kernel also by torch.profiler, one kernel a call), the
    bound from this call's bytes and operations."""
    import torch
    cpu = torch.device("cpu")
    dev = next(t.device for t in tree_leaves(args) if hasattr(t, "device"))
    got = kernel(*to(args, dev), **kw)
    torch.cuda.synchronize()
    want = plain(*to(args, cpu), **kw)
    ka, pa = to(args, dev), to(args, dev)
    setup_k = reset and (lambda: reset(ka))
    setup_p = reset and (lambda: reset(pa))
    bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound_ops = nops / H100_INT32_OPS_PER_S * 1e3
    return {"equal": equal(got, want), "max_abs_err": max_abs_err(got, want),
            "ms": cuda_ms(lambda: kernel(*ka, **kw), setup=setup_k),
            "prof_ms": prof_ms(lambda: kernel(*ka, **kw), setup=setup_k)[0],
            "kernels_per_call": kernels_in(lambda: kernel(*ka, **kw)),
            "plain_ms": cuda_ms(lambda: plain(*pa, **kw), setup=setup_p),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations", "library_ms": None,
            "bytes": int(nbytes), "ops": int(nops)}


def read_kernel_checks(calls, kernels):
    """The read executor's first ``scan_window`` call and the views' first
    ``thomas_merge`` call (phase 9's new call shapes), each against its
    plain version and timed; the figures go into the kernels' rows."""
    from repro_torch.kernels.occ import ref as occ_ref
    from repro_torch.kernels.occ.ops import scan_window
    from repro_torch.kernels.thomas_merge.ops import thomas_merge
    from repro_torch.kernels.thomas_merge.ref import thomas_merge_plain

    (fk, ft, q, base, cap), kw = calls["read/scan_window"]
    Q, ns = int(q.numel()), kw["n_slots"]
    lg = int(kw["max_cap"]).bit_length()

    def plain_probe(*a, n_slots, max_cap):
        return occ_ref.scan_window_plain(
            *a, n_slots=n_slots, n_iters=int(max_cap).bit_length() + 1)
    # each query's key, segment start and length read, its position and
    # window (keys and TIDs) written, the keys of its binary search read
    fig = shape_figures(scan_window, plain_probe, (fk, ft, q, base, cap),
                        kw, nbytes=Q * (12 + 4 + 12 * ns + 4 * lg),
                        nops=Q * (4 + lg + 8 * ns))
    check(fig.pop("equal"), "read executor's scan_window call differs from "
          "its plain version")
    check(fig["kernels_per_call"] == 1, f"read scan_window: "
          f"{fig['kernels_per_call']} kernels a call")
    fig.update(queries=Q, n_slots=ns, segment=int(kw["max_cap"]),
               table_slots=int(fk.numel()))
    kernels["scan_window"]["read_executor"] = fig

    (val, tidw, rows, vals, tids), _ = calls["views/thomas_merge"]
    C, Kw = int(val.shape[1]), int(rows.numel())
    a_dev = to((val, tidw, rows, vals, tids), val.device)
    thomas_merge(*a_dev)
    n_win = int((a_dev[1] != tidw).sum())
    n_live = int((rows >= 0).sum())
    tid0 = tidw.clone()

    def reset(a):
        """Restore the TID column (values rewritten are the same)."""
        a[1].copy_(tid0)
    fig = shape_figures(thomas_merge, thomas_merge_plain,
                        (val, tidw, rows, vals, tids), {},
                        nbytes=Kw * 4 + n_live * (8 + 8)
                        + n_win * (4 * C + 4 * C + 8),
                        nops=Kw + n_live * 3, reset=reset)
    check(fig.pop("equal"), "views' thomas_merge call differs from its "
          "plain version")
    check(fig["kernels_per_call"] == 1, f"views thomas_merge: "
          f"{fig['kernels_per_call']} kernels a call")
    fig.update(rows=int(val.shape[0]), cols=C, writes=Kw, live=n_live,
               winners=n_win)
    kernels["thomas_merge"]["views_master"] = fig


def read_path(dev, kernels):
    """Phase 9: TPC-C's full mix at phase 4's scale through ``TxnService``
    with the read tier (bound 2, the replica view refreshed every 2nd
    fence) and the analytics lane, at phase 8's rate for phase 8's
    duration; then ``READ_DIRECT_EPOCHS`` epochs on the same engine whose
    read-only transactions are served after their fence at bound 2.  At
    every fence: ``replica_consistent()``, the views' committed projection
    equal to the master snapshot's ``VIEW_COLS``, and (after the run) the
    stamped aggregates equal to ``recompute`` of that fence's committed
    values.  The first ``READ_SNAPSHOTS`` distinct (replica, epoch)
    snapshots served in each part: each retained snapshot equal to its
    fence, and each group's outputs equal to ``reference_read`` and to the
    CPU executor on a host copy.  Returns the ``read_path`` figures; the
    STAR kernels' rows gain ``read_launches`` and the new call shapes."""
    import numpy as np
    import torch
    from repro_torch.changelog import VIEW_COLS, AnalyticsLane
    from repro_torch.changelog import views as views_mod
    from repro_torch.db import tpcc
    from repro_torch.kernels import _build
    from repro_torch.reads import (ReadTier, SnapshotReadExecutor,
                                   reference_read)
    from repro_torch.reads import executor as ex_mod
    from repro_torch.storage.engine import FIELDS
    from repro_torch.service import (AdmissionConfig, AdmissionController,
                                     OpenLoopClient, TPCCSource, TxnService)
    cfg, state, eng = mk_engine(MAIN, 0, dev)
    tier = ReadTier(max_staleness_epochs=READ_K,
                    sec_refresh_every=READ_REFRESH)
    lane = AnalyticsLane(cfg)
    views = lane.views
    client = OpenLoopClient(TPCCSource(cfg, state=state, seed=2),
                            rate_txn_s=SERVICE_TPCC_RATE)
    svc = TxnService(eng, [client], AdmissionConfig(256, 512, "shed"),
                     slots_per_partition=SERVICE_SLOTS,
                     master_lanes=SERVICE_LANES,
                     feedback=lambda b, m: tpcc.apply_consume_feedback(
                         state, b, m), read_tier=tier, analytics=lane)
    print(f"read path: TPC-C P={cfg.n_partitions} with ReadTier(k={READ_K}"
          f", sec_refresh_every={READ_REFRESH}) and AnalyticsLane at "
          f"{SERVICE_TPCC_RATE:.0f} txn/s for {SERVICE_TPCC_S} s")

    # the lanes' own launches (the executor's probes, the views' merges),
    # and their first calls recorded
    lane_launches = {k: 0 for k in STAR_KERNELS}
    rec = Recorder()

    def count(module, name, kernel):
        orig = getattr(module, name)

        def counted(*a, **k):
            n0 = _build.launch_counts().get(kernel, 0)
            out = orig(*a, **k)
            lane_launches[kernel] += _build.launch_counts().get(kernel, 0) \
                - n0
            return out
        setattr(module, name, counted)
        rec._undo.append((module, name, orig))
    count(ex_mod, "scan_window", "scan_window")
    count(views_mod, "thomas_apply", "thomas_merge")
    rec.wrap(ex_mod, "scan_window", lambda *a, **k: "read/scan_window")
    rec.wrap(views_mod, "thomas_apply", lambda *a, **k: "views/thomas_merge")

    # every fence: the replica, the views' committed projection; the
    # committed values kept (on the card) for recompute after the run
    fences = {}
    run_epoch = eng.run_epoch

    def fenced(batch, ingest=None):
        m = run_epoch(batch, ingest=ingest)
        e = eng.committed_epoch
        check(eng.replica_consistent(), f"read path: replica diverged at "
              f"fence {e}")
        if views.attached:
            snap = eng.store.snapshot
            check(torch.equal(views._c_proj,
                              snap["val"][..., list(VIEW_COLS)])
                  and torch.equal(views._c_ptid, snap["tid"]),
                  f"read path: the views' committed projection differs "
                  f"from the master snapshot at fence {e}")
            stamp_e, aggs = views.latest()
            check(stamp_e == e, f"read path: views stamped {stamp_e} at "
                  f"fence {e}")
            fences[e] = (aggs, snap["val"].clone())
        return m
    eng.run_epoch = fenced

    # every served group: freshness within the bound; the first
    # READ_SNAPSHOTS distinct snapshots of each part kept with the groups
    # served from them (their inputs copied before the pool reuses them)
    part = {"name": "service"}
    kept = {}
    freshness = []
    serve = tier.serve

    def served(admission, now_s=0.0, limit=None, mid_epoch=False):
        res = serve(admission, now_s, limit, mid_epoch)
        pool = admission.pool
        for r in res:
            freshness.append(r["freshness"])
            check(r["freshness"] <= (0 if mid_epoch else READ_K),
                  f"read path: a read served at freshness {r['freshness']}")
            key = (part["name"], r["replica"], r["epoch"])
            mine = [k for k in kept if k[0] == part["name"]]
            if key not in kept and len(mine) >= READ_SNAPSHOTS:
                continue
            ent = tier.catalog.entries[r["replica"]]
            snap = next(s for e, s, _ in ent.snaps if e == r["epoch"])
            sl = r["slots"]
            kept.setdefault(key, (snap, []))[1].append((
                ent.row_of_partition[pool.home[sl].astype(np.int64)],
                pool.row[sl].copy(), pool.kind[sl].copy(),
                pool.delta[sl].copy(), r["out"]))
        return res
    tier.serve = served

    # the lanes' host time outside the executor (which its stats time):
    # the views' stream callbacks, the catalog's stamps, the query mix
    lane_s = {}

    def timed(obj, name, key):
        f = getattr(obj, name)

        def t(*a, **k):
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                lane_s[key] = lane_s.get(key, 0.0) + time.perf_counter() - t0
        setattr(obj, name, t)
    for name in ("on_slab", "on_master", "on_commit"):
        timed(views, name, f"views.{name}")
    timed(tier, "observe_epoch", "reads.observe_epoch")
    timed(lane, "serve", "analytics.serve")
    split = ("part_time_s", "sm_time_s", "fence_time_s", "epochs")
    stats0 = {f: getattr(eng.stats, f) for f in split}

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out = svc.run(duration_s=SERVICE_TPCC_S)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        run_launches = by_kernel(_build.launch_counts())
        read_launches = dict(lane_launches)
        lane_host_s = dict(lane_s)
        engine_split = {f: getattr(eng.stats, f) - stats0[f] for f in split}
        merges, batches = views.master_merges, tier.stats.batches
        for c in svc.clients:
            if hasattr(c, "shutdown"):
                c.shutdown()
        print(f"read path service: {out['throughput_txn_s']:.1f} write "
              f"txn/s p50 {out['p50_ms']:.2f} p99 {out['p99_ms']:.2f} ms; "
              f"{out['read_served']} reads ({out['read_mid_epoch_served']} "
              f"mid-epoch) p50 {out['read_p50_ms']:.2f} p99 "
              f"{out['read_p99_ms']:.2f} ms; {out['epochs']} epochs; "
              f"lane launches {read_launches}")

        # reads served after their fence at bound READ_K: the epochs'
        # read-only transactions offered to the read lane after each fence
        part["name"] = "after_fence"
        direct = {"epochs": READ_DIRECT_EPOCHS, "txns": READ_DIRECT_TXNS,
                  "offered": 0, "served": 0, "by_freshness": {}}
        served0, fallbacks0 = tier.stats.served, tier.stats.fallbacks
        for ep in range(READ_DIRECT_EPOCHS):
            raw = tpcc.make_raw(cfg, state, READ_DIRECT_TXNS,
                                np.random.default_rng(900 + ep))
            batch = tpcc.make_batch(cfg, state, 0, raw=raw)
            m = eng.run_epoch(batch)
            tpcc.apply_consume_feedback(state, batch, m)
            tier.observe_epoch(eng, m)
            lane.serve(eng.committed_epoch)
            sel = np.nonzero(raw["read_only"])[0]
            if not sel.size:
                continue
            adm = AdmissionController(cfg.n_partitions,
                                      cfg.rows_per_partition,
                                      max_ops=raw["rows"].shape[1],
                                      n_cols=raw["deltas"].shape[2],
                                      read_lane=True)
            req = {k: raw[k][sel] for k in ("parts", "rows", "kinds",
                                            "deltas", "user_abort", "home",
                                            "read_only")}
            n = sel.size
            req.update(txn_id=np.arange(n, dtype=np.int64),
                       tenant=np.zeros(n, np.int32), arrival_s=np.zeros(n))
            check(not adm.offer(req, 0.0).any(), "read path: the read "
                  "lane refused a read")
            direct["offered"] += n
            for r in tier.serve(adm):
                f = r["freshness"]
                direct["by_freshness"][f] = \
                    direct["by_freshness"].get(f, 0) + int(r["slots"].size)
        direct["served"] = tier.stats.served - served0
        direct["fallbacks"] = tier.stats.fallbacks - fallbacks0
        check(direct["served"] + direct["fallbacks"] == direct["offered"]
              and direct["served"] > 0, "read path: reads after the fence "
              "were dropped or none served")
    finally:
        # drop the instance attributes the wrappers were set as: a bound
        # method put back on its own object would keep it (and the
        # snapshots it holds) alive in a reference cycle
        rec.restore()
        for obj, names in ((eng, ("run_epoch",)), (tier, ("serve",
                                                          "observe_epoch")),
                           (lane, ("serve",)),
                           (views, ("on_slab", "on_master", "on_commit"))):
            for n in names:
                vars(obj).pop(n, None)

    s = tier.stats
    check(s.stale_violations == 0, f"read path: {s.stale_violations} "
          f"stale reads")
    check(out["read_mid_epoch_served"] > 0, "read path: no read served "
          "mid-epoch")
    check(max(freshness) <= READ_K, "read path: a read past the bound")
    for k in ("scan_window", "thomas_merge"):
        check(read_launches[k] > 0, f"read path: the lanes never launched "
              f"{k}")
    n_idx = len(eng.store.indexes)
    check(read_launches["scan_window"] <= batches * n_idx,
          "read path: more than one probe launch per index per group")
    check(read_launches["thomas_merge"] == merges, "read path: the views' "
          "master merges are not one launch each")
    for k, row in kernels.items():
        row["read_launches"] = read_launches.get(k, 0)

    # the stamps against recompute of each fence's committed values
    for e, (aggs, val) in sorted(fences.items()):
        want = views.recompute(val)
        check(all(np.array_equal(aggs[k], want[k])
                  and aggs[k].dtype == want[k].dtype for k in want),
              f"read path: the views' stamp differs from recompute at "
              f"fence {e}")
    # the kept snapshots: each equal to its fence, each group's outputs
    # equal to reference_read and the CPU executor on a host copy
    cpu_exec = SnapshotReadExecutor()
    n_groups = 0
    for (pn, rid, e), (snap, groups) in kept.items():
        check(e not in fences or torch.equal(snap["val"], fences[e][1]),
              f"read path: the retained snapshot {rid}@{e} changed after "
              f"its fence")
        host = {"val": snap["val"].cpu(), "tid": snap["tid"].cpu(),
                "idx": [{f: ix[f].cpu() for f in FIELDS}
                        for ix in snap["idx"]]}
        for arow, rows, kinds, deltas, got in groups:
            want = reference_read(host, arow, rows, kinds, deltas)
            cpu = cpu_exec.run(host, arow, rows, kinds, deltas)
            check(equal(got, cpu) and all(
                np.array_equal(got[k].cpu().numpy(), want[k])
                for k in want), f"read path: a group served from "
                  f"{rid}@{e} differs from reference_read")
            n_groups += 1
    check(sum(1 for k in kept if k[0] == "service") > 0
          and sum(1 for k in kept if k[0] == "after_fence") > 0,
          "read path: no snapshot kept in one of the parts")

    # the new call shapes against their plain versions, timed
    read_kernel_checks(rec.calls, kernels)

    # a fence's snapshot copies: one view's arrays cloned, timed
    view = eng.read_views()[0]
    arrays = [view["val"], view["tid"]] + [ix[f] for ix in view["idx"]
                                           for f in FIELDS]
    copy_ms = cuda_ms(lambda: [a.clone() for a in arrays], reps=10)
    view_bytes = sum(a.numel() * a.element_size() for a in arrays)
    n_fences = len(fences)
    copies = tier.catalog.stamp_copies
    n_obs = 1 + out["epochs"] + READ_DIRECT_EPOCHS   # observe_epoch calls
    # the dirty gate's host copy of a slab's write set
    M = client.source.M
    w = torch.zeros((cfg.n_partitions, SERVICE_SLOTS, M), dtype=torch.bool,
                    device=dev)
    gate_us = host_us(lambda: w.any(2).any(1).cpu().numpy(), reps=50)
    fig = {k: out[k] for k in (
        "read_served", "read_txn_s", "read_p50_ms", "read_p99_ms",
        "read_fallbacks", "read_max_freshness", "read_mid_epoch_served",
        "read_mid_epoch_deferred", "read_serve_time_s",
        "read_stale_violations", "read_by_replica", "ingest_overlap_s",
        "epoch_time_s", "epochs", "committed", "user_aborted",
        "analytics_q_p50_ms", "analytics_q_p99_ms", "analytics_serves",
        "analytics_mv_slabs", "analytics_mv_writes")}
    fig.update(
        write_txn_s=out["throughput_txn_s"], write_p50_ms=out["p50_ms"],
        write_p99_ms=out["p99_ms"], write_p999_ms=out["p999_ms"],
        read_post_fence_served=out["read_served"]
        - out["read_mid_epoch_served"],
        read_batches=batches, wall_s=wall, offered_rate_txn_s=SERVICE_TPCC_RATE,
        duration_s=SERVICE_TPCC_S, max_staleness_epochs=READ_K,
        sec_refresh_every=READ_REFRESH,
        launches_by_kernel=run_launches, read_launches=read_launches,
        lane_host_s=lane_host_s, engine_split=engine_split,
        views_master_merges=merges, fences_checked=n_fences,
        snapshots_checked=len(kept), groups_checked=n_groups,
        after_fence=direct,
        snapshot_copy={"bytes_per_view": view_bytes,
                       "ms_per_view": copy_ms, "copies": copies,
                       "observed_fences": n_obs,
                       "bytes_per_fence": tier.catalog.stamp_bytes / n_obs,
                       "ms_per_fence": copy_ms * copies / n_obs,
                       "retain": tier.catalog.retain},
        dirty_gate_host_us=gate_us)
    print(f"read path: {n_fences} fences checked (views = master "
          f"VIEW_COLS, stamps = recompute), {len(kept)} snapshots and "
          f"{n_groups} groups bit-equal to reference_read; after the fence "
          f"{direct['served']} of {direct['offered']} reads served "
          f"{direct['by_freshness']}; snapshot copy {view_bytes} bytes "
          f"{copy_ms:.3f} ms a view")
    del eng, svc, tier, lane, views, fences, kept, rec, client
    gc.collect()
    torch.cuda.empty_cache()
    return fig


# ---------------------------------------------------------------------------
# phase 10: the STAR cluster on the card
# ---------------------------------------------------------------------------
def mk_cluster(cfg_kw, seed, device, runtime=False, **kw):
    """A TPC-C cluster at ``cfg_kw`` over ``CLUSTER_NODES`` simulated
    nodes with physical secondary copies: the engine, or (``runtime``) a
    ``ClusterRuntime`` around it.  Returns (cfg, state, engine or
    runtime)."""
    import numpy as np
    from repro_torch.cluster import ClusterRuntime
    from repro_torch.core.cluster import ClusterStarEngine
    from repro_torch.db import tpcc
    cfg = tpcc.TPCCConfig(**cfg_kw)
    state = tpcc.TPCCState(cfg)
    init = tpcc.init_values(cfg, np.random.default_rng(seed), state=state)
    cls = ClusterRuntime if runtime else ClusterStarEngine
    c = cls(CLUSTER_NODES, cfg.n_partitions, cfg.rows_per_partition,
            init_val=init, indexes=tpcc.index_specs(cfg),
            max_rounds=MAX_ROUNDS, n_slabs=CLUSTER_SLABS, device=device,
            **kw)
    return cfg, state, c


def copy_state(eng, which):
    """One copy of a cluster engine ("part", "full" or "sec") as a state
    dict for :func:`same_store`."""
    return {"val": getattr(eng, f"{which}_val"),
            "tid": getattr(eng, f"{which}_tid"),
            "indexes": getattr(eng, f"{which}_idx")}


def same_as_star(eng, star):
    """The cluster's partial and full copies, records and every index
    segment, bit-equal to the single-host engine's master (compared where
    they lie, on the card)."""
    import torch
    want = [star.store.val, star.store.tid] + [
        ix[f] for ix in star.store.indexes for f in ("key", "prow", "tid")]
    for w in ("part", "full"):
        st = copy_state(eng, w)
        got = [st["val"], st["tid"]] + [
            ix[f] for ix in st["indexes"] for f in ("key", "prow", "tid")]
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            return False
    return True


def span_split(tracer):
    """Seconds by span name over a tracer's events."""
    out = {}
    for e in tracer.events():
        if e["dur_s"] is not None:
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur_s"]
    return out


def cluster_kernel_checks(calls, kernels):
    """The cluster's new call shapes against their plain versions, timed:
    the secondary replay's ``index_merge`` (rolled ``part_ids``) and the
    single-master stream's two scatter-back ``thomas_merge`` calls (the
    partial copy through ``thomas_apply_batch``, the secondary copy with
    its rows remapped home-major)."""
    from repro_torch.kernels.index_merge.ops import index_merge_cuda
    from repro_torch.kernels.index_merge.ref import index_merge_unsorted_plain
    from repro_torch.kernels.thomas_merge.ops import thomas_merge
    from repro_torch.kernels.thomas_merge.ref import thomas_merge_plain

    args, _ = calls["cluster/sec_replay"]
    P, cap = args[0].shape
    Kd, Ki = args[3].shape[1], args[4].shape[1]
    lg = max(cap, Ki).bit_length()
    fig = shape_figures(index_merge_cuda, index_merge_unsorted_plain, args,
                        {}, nbytes=P * cap * 16 * 2
                        + P * (Kd * 4 + Ki * 16 + 4),
                        nops=P * (Kd + Ki + 2 * cap) * lg * 3)
    check(fig.pop("equal"), "cluster: the secondary replay's index_merge "
          "differs from its plain version")
    check(fig["kernels_per_call"] <= 2, f"cluster sec replay index_merge: "
          f"{fig['kernels_per_call']} kernels a call")
    fig["shape_P_cap_Kd_Ki"] = [P, cap, Kd, Ki]
    kernels["index_merge"]["cluster_sec_replay"] = fig

    (val, tidw, slog), _ = calls["cluster/part_scatter"]
    C = val.shape[1]
    part = (val, tidw, slog["row"].reshape(-1), slog["val"].reshape(-1, C),
            slog["tid"].reshape(-1))
    sec, _ = calls["cluster/sec_scatter"]
    for key, args in (("cluster_part_scatter", part),
                      ("cluster_sec_scatter", sec)):
        val, tidw, rows = args[0], args[1], args[2]
        Kw = int(rows.numel())
        a = to(args, val.device)
        thomas_merge(*a)
        n_win = int((a[1] != tidw).sum())
        n_live = int((rows >= 0).sum())
        tid0 = tidw.clone()

        def reset(x, tid0=tid0):
            """Restore the TID column (values rewritten are the same)."""
            x[1].copy_(tid0)
        fig = shape_figures(thomas_merge, thomas_merge_plain, args, {},
                            nbytes=Kw * 4 + n_live * (8 + 8)
                            + n_win * (4 * C + 4 * C + 8),
                            nops=Kw + n_live * 3, reset=reset)
        check(fig.pop("equal"), f"cluster: the {key} thomas_merge call "
              f"differs from its plain version")
        check(fig["kernels_per_call"] == 1, f"cluster {key}: "
              f"{fig['kernels_per_call']} kernels a call")
        fig.update(rows=int(val.shape[0]), cols=int(C), writes=Kw,
                   live=n_live, winners=n_win)
        kernels["thomas_merge"][key] = fig


def record_cluster_epoch(eng, batch):
    """Run ``batch`` through the cluster engine with the first call of
    each new shape recorded: the secondary replay's index_merge, the
    scatter-back merges into the partial and the secondary copies."""
    from repro_torch.core import replication
    from repro_torch.core.ops import IDX_OPS
    from repro_torch.kernels.index_merge import ops as im_ops
    rec = Recorder()
    ctx = {"sec": False}
    orig = replication.apply_index_ops

    def flagged(*a, part_ids=None, **k):
        ctx["sec"] = part_ids is not None
        try:
            return orig(*a, part_ids=part_ids, **k)
        finally:
            ctx["sec"] = False
    replication.apply_index_ops = flagged
    rec._undo.append((replication, "apply_index_ops", orig))
    P = eng.P
    # the slab replay's merges are (P, P*K); the index rounds' (P, B*K)
    rec.wrap(im_ops, "index_merge_cuda",
             lambda key, prow, tid, dk, ik, ip, it:
             "cluster/sec_replay" if ctx["sec"]
             and ik.shape[1] <= P * IDX_OPS else None)
    rec.wrap(replication, "thomas_apply_batch",
             lambda *a, **k: "cluster/part_scatter")
    rec.wrap(replication, "thomas_apply",
             lambda *a, **k: "cluster/sec_scatter")
    try:
        m = eng.run_epoch(batch)
    finally:
        rec.restore()
    return m, rec.calls


def cluster_path(dev, kernels):
    """Phase 10: the STAR cluster on the card — ``CLUSTER_NODES`` simulated
    nodes over phase 4's P = 16 TPC-C at full width with physical
    secondary copies.  Engine parity against a ``StarEngine`` fed the
    same batches; the cluster's new kernel call shapes against their
    plain versions; the three recovery cases at full width; the fig11
    cluster card against CPU across a mid-stream kill; and
    ``ClusterTxnService`` with both lanes over the full-width runtime with
    a node killed mid-run.  Returns the ``cluster_path`` figures; the STAR
    kernels' rows gain ``cluster_launches``."""
    import copy
    import tempfile
    from collections import Counter
    import numpy as np
    import torch
    from repro_torch.changelog import AnalyticsLane
    from repro_torch.cluster import ClusterTxnService
    from repro_torch.core.fault import FaultInjector, RecoveryCase
    from repro_torch.db import tpcc
    from repro_torch.db.wal import Durability
    from repro_torch.kernels import _build
    from repro_torch.obs import trace as obs
    from repro_torch.reads import ReadTier
    from repro_torch.service import (AdmissionConfig, OpenLoopClient,
                                     TPCCSource)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    fig = {"nodes": CLUSTER_NODES, "n_slabs": CLUSTER_SLABS,
           "txns_per_epoch": MAIN_TXNS}

    # ---- engine parity: the cluster and a StarEngine on the same batches
    cfg, st_c, eng = mk_cluster(MAIN, 0, dev)
    _, st_s, star = mk_engine(MAIN, 0, dev)
    print(f"cluster path: {CLUSTER_NODES} nodes x {eng.ppn} partitions, "
          f"P={cfg.n_partitions}, {CLUSTER_SLABS} slabs, secondary copies "
          f"{eng.secondary}")

    def both(seed, first=False, tracer=None):
        """One epoch on each engine; the cluster's alone is timed, counted
        and (``tracer``) traced."""
        bc = tpcc.make_batch(cfg, st_c, MAIN_TXNS, seed=seed)
        bs = tpcc.make_batch(cfg, st_s, MAIN_TXNS, seed=seed)
        calls = None
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        old = obs.set_tracer(tracer) if tracer is not None else None
        t0 = time.perf_counter()
        try:
            if first:
                mc, calls = record_cluster_epoch(eng, bc)
            else:
                mc = eng.run_epoch(bc)
        finally:
            wall = time.perf_counter() - t0
            if tracer is not None:
                obs.set_tracer(old)
        launches = _build.launch_counts()
        ms = star.run_epoch(bs)
        tpcc.apply_consume_feedback(st_c, bc, mc)
        tpcc.apply_consume_feedback(st_s, bs, ms)
        e = eng.epoch - 1
        check(mc["committed_single"] == ms["committed_single"]
              and mc["committed_cross"] == ms["committed_cross"],
              f"cluster: commit counts differ from the StarEngine's at "
              f"epoch {e}")
        check(eng.consistent(), f"cluster: copies diverged at fence {e}")
        check(same_as_star(eng, star), f"cluster: copies differ from the "
              f"StarEngine's master at epoch {e}")
        return mc, wall, launches, calls

    _, _, _, calls = both(3000, first=True)
    tracer = obs.Tracer(enabled=True)
    engine_launches = {}
    rows = []
    for ep in range(CLUSTER_EPOCHS):
        mc, wall, ln, _ = both(3001 + ep, tracer=tracer)
        for k, n in ln.items():
            engine_launches[k] = engine_launches.get(k, 0) + n
        rows.append((mc, wall))
        print(f"cluster epoch {eng.epoch - 1}: committed "
              f"{mc['committed_single']}+{mc['committed_cross']} wall "
              f"{wall:.4f}s t_part={mc['t_part_s']:.4f}s "
              f"t_sm={mc['t_sm_s']:.4f}s, bit-equal to the StarEngine")
    spans = span_split(tracer)
    committed = sum(m["committed_single"] + m["committed_cross"]
                    for m, _ in rows)
    wall = sum(w for _, w in rows)
    fig["engine"] = {
        "epochs": CLUSTER_EPOCHS, "committed": committed, "wall_s": wall,
        "committed_txn_per_s": committed / wall,
        "epoch_walls": [w for _, w in rows],
        "split_s": {
            "partitioned": spans.get("engine.partitioned", 0.0),
            "fence1": spans.get("fence.tail_ship", 0.0)
            + spans.get("fence.psum", 0.0),
            "single_master": spans.get("engine.single_master", 0.0),
            "fence2_replay_drain": spans.get("engine.fence", 0.0),
            "replay_drain": spans.get("fence.replay_drain", 0.0)},
        "replica_s": {k: spans.get(k, 0.0) for k in (
            "replica.replay_full", "replica.replay_secondary",
            "replica.scatter_back", "changelog.commit")},
        "op_bytes_overlapped": sum(m["op_bytes_overlapped"] for m, _ in rows),
        "op_bytes_fence": sum(m["op_bytes_fence"] for m, _ in rows),
        "node_committed": eng.node_committed.tolist(),
        "launches": engine_launches,
        "launches_by_kernel": by_kernel(engine_launches)}
    for k in STAR_KERNELS:
        check(fig["engine"]["launches_by_kernel"][k] > 0,
              f"cluster engine: {k} never launched")
    print(f"cluster engine: {committed} committed in {wall:.3f} s, "
          f"{committed / wall:.1f} txn/s; split {fig['engine']['split_s']}")
    del eng, star, st_c, st_s
    gc.collect()
    torch.cuda.empty_cache()
    cluster_kernel_checks(calls, kernels)
    del calls
    part_s = {"engine_parity": time.perf_counter() - t_phase}
    tp = time.perf_counter()

    # ---- recovery at full width: the three cases, one runtime with the
    # per-node WAL, a StarEngine fed the same batches without a failure
    inj = FaultInjector()
    inj.schedule_kill(2, epoch=2)                  # a partial node
    inj.schedule_kill(0, epoch=3, slab=1)          # the master, mid-stream
    for n in (0, 1, 2):                            # no full replica, no
        inj.schedule_kill(n, epoch=5)              # complete partial set
    tmp = tempfile.TemporaryDirectory()
    # a checkpoint at epoch 3: the reload replays epoch 4's logs
    dur = Durability(tmp.name, n_workers=CLUSTER_NODES, checkpoint_every=3)
    cfg, st_c, rt = mk_cluster(MAIN, 1, dev, runtime=True, injector=inj,
                               durability=dur)
    _, st_s, star = mk_engine(MAIN, 1, dev)
    cases = []
    for ep in range(CLUSTER_RECOVERY_EPOCHS):
        bc = tpcc.make_batch(cfg, st_c, MAIN_TXNS, seed=4000 + ep)
        bs = tpcc.make_batch(cfg, st_s, MAIN_TXNS, seed=4000 + ep)
        mc = rt.run_epoch(bc)
        ms = star.run_epoch(bs)
        tpcc.apply_consume_feedback(st_c, bc, mc)
        tpcc.apply_consume_feedback(st_s, bs, ms)
        check(rt.replica_consistent(), f"cluster recovery: copies diverged "
              f"at fence {rt.committed_epoch}")
        check(same_as_star(rt.eng, star), f"cluster recovery: copies "
              f"differ from the StarEngine's after epoch {ep + 1}")
        ev = mc.get("recovery")
        if ev is not None:
            cases.append({"epoch": ev.epoch, "failed": list(ev.failed),
                          "case": ev.case.name, "run_mode": ev.run_mode,
                          "t_recovery_s": ev.t_recovery_s,
                          "slabs_discarded": ev.slabs_discarded,
                          "aborted_at_slab": ev.aborted_at_slab,
                          "restored_from_secondary":
                          list(ev.restored_from_secondary),
                          "reloaded_from_disk": ev.reloaded_from_disk})
            print(f"cluster recovery: epoch {ev.epoch} nodes "
                  f"{list(ev.failed)} {ev.case.name} in "
                  f"{ev.t_recovery_s:.4f} s, then bit-equal to the "
                  f"StarEngine")
    want = [RecoveryCase.PHASE_SWITCHING.name,
            RecoveryCase.FALLBACK_DIST_CC.name, RecoveryCase.UNAVAILABLE.name]
    check([c["case"] for c in cases] == want, f"cluster recovery: cases "
          f"{[c['case'] for c in cases]}, expected {want}")
    check(cases[1]["slabs_discarded"] >= 1
          and cases[1]["restored_from_secondary"] == [0],
          "cluster recovery: the mid-stream kill discarded no slab or did "
          "not restore node 0 from its secondary copy")
    check(cases[2]["reloaded_from_disk"], "cluster recovery: UNAVAILABLE "
          "did not reload from the WAL")
    check(max(Counter(rt.eng.slab_ledger).values()) == 1,
          "cluster recovery: a slab applied twice")
    fig["recovery"] = {"epochs": CLUSTER_RECOVERY_EPOCHS, "cases": cases,
                       "wal_entries": dur.entries_logged,
                       "wal_checkpoints": dur.checkpoints}
    dur.close()
    tmp.cleanup()
    del rt, star, st_c, st_s, dur
    gc.collect()
    torch.cuda.empty_cache()
    part_s["recovery"] = time.perf_counter() - tp
    tp = time.perf_counter()

    # ---- card against CPU: the fig11 cluster (ppn = 1) across a kill
    sides = []
    for d in (dev, "cpu"):
        inj = FaultInjector()
        inj.schedule_kill(1, epoch=2, slab=1)
        sides.append(mk_cluster(FIG11, 0, d, runtime=True, injector=inj))
    for ep in range(FIG11_EPOCHS):
        ms = []
        for c, st, r in sides:
            b = tpcc.make_batch(c, st, FIG11_TXNS, seed=ep)
            ms.append(r.run_epoch(b))
            tpcc.apply_consume_feedback(st, b, ms[-1])
        (_, _, g), (_, _, h) = sides
        check(all(same_store(copy_state(g.eng, w), copy_state(h.eng, w))
                  for w in ("part", "full", "sec")),
              f"cluster card vs CPU: copies differ after epoch {ep}")
        check(g.replica_consistent() and h.replica_consistent(),
              f"cluster card vs CPU: copies diverged at epoch {ep}")
        check(all(np.array_equal(ms[0][k], ms[1][k])
                  for k in ("p_committed", "c_committed")),
              f"cluster card vs CPU: commit masks differ at epoch {ep}")
    check(all(len(r.coordinator.events) == 1 for _, _, r in sides),
          "cluster card vs CPU: the kill was not recovered on both")
    print(f"cluster card vs CPU: {FIG11_EPOCHS} fig11 epochs on "
          f"{CLUSTER_NODES} nodes across a mid-stream kill, partial, full "
          f"and secondary copies bit-equal")
    fig["card_vs_cpu"] = {"config": "fig11", "epochs": FIG11_EPOCHS,
                          "case": sides[0][2].coordinator.events[0].case.name}
    del sides
    part_s["card_vs_cpu"] = time.perf_counter() - tp
    tp = time.perf_counter()

    # ---- the entry point: ClusterTxnService over the full-width runtime
    inj = FaultInjector()
    inj.schedule_kill(2, epoch=CLUSTER_KILL_EPOCH)
    cfg, state, rt = mk_cluster(MAIN, 0, dev, runtime=True, injector=inj)
    tier = ReadTier(max_staleness_epochs=READ_K,
                    sec_refresh_every=READ_REFRESH)
    lane = AnalyticsLane(cfg)
    views = lane.views
    client = OpenLoopClient(TPCCSource(cfg, state=state, seed=2),
                            rate_txn_s=SERVICE_TPCC_RATE)
    svc = ClusterTxnService(rt, [client],
                            AdmissionConfig(64, 64, node_queue_cap=96),
                            slots_per_partition=SERVICE_SLOTS,
                            master_lanes=SERVICE_LANES,
                            feedback=lambda b, m: tpcc.apply_consume_feedback(
                                state, b, m), read_tier=tier, analytics=lane)
    fences = {}
    run_epoch = rt.run_epoch

    def fenced(batch, ingest=None):
        m = run_epoch(batch, ingest=ingest)
        e = rt.committed_epoch
        check(rt.replica_consistent(), f"cluster service: copies diverged "
              f"at fence {e}")
        if views.attached:
            stamp_e, aggs = views.latest()
            check(stamp_e == e, f"cluster service: views stamped {stamp_e} "
                  f"at fence {e}")
            fences[e] = (aggs, rt.committed_state()[0].clone(),
                         "recovery" in m)
        return m
    rt.run_epoch = fenced
    print(f"cluster service: TPC-C at {SERVICE_TPCC_RATE:.0f} txn/s for "
          f"{SERVICE_TPCC_S} s, both lanes, node 2 killed at epoch "
          f"{CLUSTER_KILL_EPOCH}")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out = svc.run(duration_s=SERVICE_TPCC_S)
    finally:
        vars(rt).pop("run_epoch", None)
    svc_wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    svc_launches = _build.launch_counts()
    client.shutdown()
    check(rt.replica_consistent(), "cluster service: copies diverged")
    check(out["recoveries"] == 1, f"cluster service: {out['recoveries']} "
          f"recoveries")
    check(sum(out["node_committed"]) == rt.stats.committed_single,
          "cluster service: node_committed does not sum to the committed "
          "single-partition transactions")
    check(tier.stats.stale_violations == 0, "cluster service: stale reads")
    by = by_kernel(svc_launches)
    for k in STAR_KERNELS:
        check(by[k] > 0, f"cluster service: {k} never launched")
    after = False
    n_checked = 0
    for e, (aggs, val, rec) in sorted(fences.items()):
        after = after or rec
        want_aggs = views.recompute(val)
        check(all(np.array_equal(aggs[k], want_aggs[k]) for k in want_aggs),
              f"cluster service: the views' stamp differs from recompute at "
              f"fence {e}")
        n_checked += after
    check(n_checked > 0, "cluster service: no fence after the recovery")
    ev = svc.recovery_events[0]
    fig["service"] = {k: out[k] for k in (
        "throughput_txn_s", "p50_ms", "p99_ms", "p999_ms", "committed",
        "epochs", "offered", "admitted", "shed", "node_committed",
        "node_fence_wait_s", "node_queue_depth_max", "node_shed",
        "recoveries", "recovery_latency_s", "op_bytes_overlapped",
        "op_bytes_fence", "slabs_shipped", "slabs_discarded", "read_served",
        "read_p50_ms", "read_p99_ms", "read_stale_violations",
        "analytics_serves", "epoch_time_s", "ingest_overlap_s")}
    n_obs = 1 + out["epochs"]
    fig["service"].update(
        wall_s=svc_wall, offered_rate_txn_s=SERVICE_TPCC_RATE,
        duration_s=SERVICE_TPCC_S, kill={"node": 2,
                                         "epoch": CLUSTER_KILL_EPOCH,
                                         "case": ev.case.name,
                                         "t_recovery_s": ev.t_recovery_s},
        fences_checked=len(fences), fences_after_recovery=int(n_checked),
        launches=svc_launches, launches_by_kernel=by,
        snapshot_bytes_per_fence=tier.catalog.stamp_bytes / n_obs,
        snapshot_stamps=tier.catalog.stamp_copies, observed_fences=n_obs)
    for k, row in kernels.items():
        row["cluster_launches"] = by.get(k, 0)
        row["cluster_engine_launches"] = \
            fig["engine"]["launches_by_kernel"].get(k, 0)
    print(f"cluster service: {out['throughput_txn_s']:.1f} txn/s p50 "
          f"{out['p50_ms']:.2f} p99 {out['p99_ms']:.2f} ms, "
          f"{out['committed']} committed in {out['epochs']} epochs, "
          f"recovery {ev.case.name} in {ev.t_recovery_s:.4f} s, "
          f"{out['read_served']} reads, node_committed "
          f"{out['node_committed']}, launches {by}")
    del rt, svc, tier, lane, views, fences, client
    gc.collect()
    torch.cuda.empty_cache()
    part_s["service"] = time.perf_counter() - tp
    fig["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    fig["wall_s"] = time.perf_counter() - t_phase
    fig["part_wall_s"] = part_s
    print(f"cluster path: {fig['wall_s']:.1f} s ({part_s}), peak device "
          f"memory {fig['peak_memory_bytes'] / 1e9:.3f} GB")
    return fig


# ---------------------------------------------------------------------------
# phases 5-7: the LM serving path (Hymba-1.5B)
# ---------------------------------------------------------------------------
def allclose_err(got, want, tol):
    """(max abs difference of two tensor trees, whether every element is
    within ``tol + tol * |want|``): each tolerance is atol = rtol."""
    import torch
    err = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.float(), w.float()
        check(g.shape == w.shape, f"shape {tuple(g.shape)} vs "
              f"{tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), "non-finite output")
        d = (g - w).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
        if not bool((d <= tol + tol * w.abs()).all()):
            return err, False
    return err, True


def record_generate(eng, prompts, n):
    """``eng.generate(prompts, n)`` with the first main-path call of each
    LM kernel wrapper recorded (a copy of its arguments)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import layers, mamba2
    rec = Recorder()

    def norm_key(x, w, residual=None, **kw):
        """norm2 at prefill and decode shapes; gate_norm at prefill."""
        T = x.numel() // x.shape[-1]
        if residual is not None:
            return "rmsnorm/prefill" if T > SERVE_BATCH else "rmsnorm/decode"
        if x.shape[-1] == eng.cfg.d_inner and T > SERVE_BATCH:
            return "rmsnorm/gate"
        return None
    rec.wrap(layers, "rmsnorm", norm_key)
    rec.wrap(fa_ops, "attention", lambda q, *a, **k:
             "flash/prefill" if q.shape[1] > 1 else "flash/decode")
    rec.wrap(mamba2, "ssd", lambda *a, **k: "ssd")
    try:
        eng.generate(prompts, n)
    finally:
        rec.restore()
    return rec.calls


def flash_sweep(fa_ops, attention_ref, dev):
    """Both flash-attention configurations against their plain version on
    small shapes that reach every branch of the kernel: f32 (1e-5: both
    sum in f32, in another order) and bf16 (2e-2), every (q/k, v) head
    dim pair (decode only at the pairs it takes: one head dim, a power of
    two), lengths
    that are not multiples of the 64-row tiles, causal, windowed and
    bidirectional masks, a regular GQA map and Hymba's padded one (32
    query heads over 7 kv heads), more query heads on one kv head than a
    decode pass keeps (16 over 1), rings with empty slots, rows that see
    no key (the mean of v), decode over one and several slot splits."""
    import torch
    gen = torch.Generator().manual_seed(11)
    hymba = [min(h // 5, 6) for h in range(32)]

    def ring(Sk, pos):
        """slot positions of a ring of Sk slots after writing 0..pos"""
        sp = torch.full((Sk,), -1, dtype=torch.int32)
        for p in range(max(0, pos + 1 - Sk), pos + 1):
            sp[p % Sk] = p
        return sp
    ar = lambda n, off=0: torch.arange(off, off + n, dtype=torch.int32)
    # (B, H, Hkv, kv_head, q_pos, k_pos, causal, window)
    cases = [
        (2, 4, 2, None, ar(100), ar(100), True, None),
        (1, 32, 7, hymba, ar(150), ar(150), True, 40),
        (2, 4, 2, None, ar(70), ar(130), False, None),
        # keys start at 10 and some slots are empty: queries 0-9 see none
        (1, 32, 7, hymba, ar(70),
         torch.where(ar(130) % 7 == 3, -1, ar(130, 10)), True, 48),
        (3, 8, 2, None, ar(1, 299), ring(300, 299), True, None),
        (2, 32, 7, hymba, ar(1, 1500), ring(1000, 1500), True, 256),
        (2, 16, 1, None, ar(1, 50), ring(64, 50), True, 24),
        (2, 32, 7, hymba, ar(1, 5), ar(200, 10), True, None),  # sees none
        (1, 8, 4, None, ar(1, 10), ring(90, 80), False, None),
    ]
    worst = {}
    for dtype, tol in ((torch.float32, TOL_F32_FLASH),
                       (torch.bfloat16, TOL_BF16_FLASH)):
        for D, DV in fa_ops.HEAD_DIM_PAIRS:
            for B, H, Hkv, kvh, qp, kp, causal, window in cases:
                Sq, Sk = qp.shape[0], kp.shape[0]
                if Sq == 1 and (D != DV or D not in fa_ops.DECODE_HEAD_DIMS):
                    continue
                q, k, v = (torch.randn((B, S, n, d), generator=gen).to(
                    dev, dtype) for S, n, d in ((Sq, H, D), (Sk, Hkv, D),
                                                (Sk, Hkv, DV)))
                args = (q, k, v, qp.to(dev), kp.to(dev))
                kw = dict(causal=causal, window=window, kv_head=kvh)
                got = fa_ops.attention(*args, **kw)
                want = attention_ref(*args, **kw)
                torch.cuda.synchronize()
                err, ok = allclose_err(got, want, tol)
                what = (f"flash sweep {dtype} D={D}/{DV} B={B} H={H}/{Hkv} "
                        f"Sq={Sq} Sk={Sk} causal={causal} window={window}")
                check(ok, f"{what}: kernel differs from its plain version "
                      f"by {err} (tolerance {tol})")
                key = f"{str(dtype)[6:]} {'decode' if Sq == 1 else 'prefill'}"
                worst[key] = max(worst.get(key, 0.0), err)
    print("flash sweep: " + ", ".join(f"{k} max abs err {e:.3g}"
                                      for k, e in worst.items()))
    return worst


def ssd_sweep(ssd, ssd_ref, dev):
    """The SSD kernel against its plain version on small shapes at
    TOL_SSD_SWEEP: P in {16, 32, 64} x N in {8, 16, 128} x chunk in
    {16, 64, 256} x heads in {1, 3}, each with S = chunk + 37 (not a
    multiple of the chunk) and logd near 0 (-|n|/100), as in
    tests/test_kernels.py (-|n|/5) and strongly negative (-4|n| - 1), so
    every block width (P 16, 32, 64) and both forms of C's fragments (N up
    to 32 in registers, N 128 from shared memory); an unaligned shape
    (P 6, N 5: the 4-byte copy path); N 256 (the one-stage load ring); and
    Mamba2-130M's widths (P 64, N 128) at 2,048 tokens; a 16 x 512 state,
    which no block holds, must be refused.  The
    plain version runs in float64 on the same inputs: its float32
    sequential recurrence drifts from float64 by more than the bound over
    a few hundred weakly decaying steps, more than the kernel does, so in
    float32 it could not tell a fault from its own rounding.  Returns the
    largest difference."""
    import torch
    gen = torch.Generator().manual_seed(13)
    decays = {"near0": (0.01, 0.0), "moderate": (0.2, 0.0),
              "strong": (4.0, 1.0)}
    cases = [(P, N, chunk, heads, d, chunk + 37)
             for P in (16, 32, 64) for N in (8, 16, 128)
             for chunk in (16, 64, 256) for heads in (1, 3) for d in decays]
    cases += [(6, 5, 16, 1, "moderate", 77),
              (32, 256, 64, 1, "moderate", 101),
              (64, 128, 256, 1, "moderate", 2048)]
    worst = 0.0
    for P, N, chunk, heads, d, S in cases:
        BH = 6
        scale, shift = decays[d]
        xdt = torch.randn((BH, S, P), generator=gen)
        logd = -(torch.randn((BH, S), generator=gen).abs() * scale + shift)
        Bv, Cv = (torch.randn((BH // heads, S, N), generator=gen)
                  for _ in range(2))
        args = [t.to(dev) for t in (xdt, logd, Bv, Cv)]
        got = ssd(*args, chunk=chunk, heads=heads)
        want = ssd_ref(*[t.double() for t in args], heads=heads)
        torch.cuda.synchronize()
        err, ok = allclose_err(got, want, TOL_SSD_SWEEP)
        check(ok, f"ssd sweep P={P} N={N} chunk={chunk} heads={heads} "
              f"logd {d} S={S}: kernel differs from its plain "
              f"version by {err} (tolerance {TOL_SSD_SWEEP})")
        worst = max(worst, err)
    big = [t.to(dev) for t in (torch.zeros((1, 8, 16)), torch.zeros((1, 8)),
                               torch.zeros((1, 8, 512)),
                               torch.zeros((1, 8, 512)))]
    try:
        ssd(*big, chunk=8)
        refused = False
    except RuntimeError:
        refused = True
    check(refused, "ssd: a 16 x 512 state, which no block holds, ran")
    print(f"ssd sweep: {len(cases)} shapes, max abs err {worst:.3g} "
          f"(tolerance atol = rtol = {TOL_SSD_SWEEP})")
    return worst


def rmsnorm_sweep(dev):
    """rmsnorm against its plain version on the same card inputs at T in
    RMS_SWEEP_ROWS (1 to 16,384, with the kernel's threshold between its
    two forms and one row past it) x D in RMS_SWEEP_WIDTHS, bf16
    (TOL_BF16_NORM) and float32 (TOL_F32_NORM), with and without a
    residual: both forms of the kernel, the register form at 1 to 4
    vectors a thread and the shared-memory form in both vector widths
    (D = 1,601 is not a multiple of 8) and past 48 KB of shared memory
    (D = 12,288).  Returns the largest difference by dtype."""
    import torch
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    gen = torch.Generator().manual_seed(17)
    worst = {}
    n = 0
    for dtype, tol in ((torch.bfloat16, TOL_BF16_NORM),
                       (torch.float32, TOL_F32_NORM)):
        for T in RMS_SWEEP_ROWS:
            for D in RMS_SWEEP_WIDTHS:
                x, r = (torch.randn((T, D), generator=gen).to(dev, dtype)
                        for _ in range(2))
                w = torch.randn((D,), generator=gen).to(dev, dtype)
                for res in (r, None):
                    got = rmsnorm(x, w, res)
                    want = rmsnorm_ref(x, w, res)
                    torch.cuda.synchronize()
                    err, ok = allclose_err(got, want, tol)
                    check(ok, f"rmsnorm sweep {dtype} T={T} D={D} "
                          f"residual={res is not None}: kernel differs from "
                          f"its plain version by {err} (tolerance {tol})")
                    key = str(dtype)[6:]
                    worst[key] = max(worst.get(key, 0.0), err)
                    n += 1
                del x, r, w, got, want
    torch.cuda.empty_cache()
    print(f"rmsnorm sweep: {n} cases, " + ", ".join(
        f"{k} max abs err {e:.3g}" for k, e in worst.items()))
    return worst


def norm_chain(rmsnorm, y, s, w, W, eps):
    """RMS_CHAIN Hymba decode blocks' worth of the norm, an (8 x D) x (D x
    D) matmul and the norm again, each on the one before it; ``rmsnorm``
    None: the matmuls alone."""
    for _ in range(RMS_CHAIN):
        if rmsnorm is not None:
            y, s = rmsnorm(y, w, s, eps=eps)
        y = y @ W
        if rmsnorm is not None:
            y, s = rmsnorm(y, w, s, eps=eps)
    return y


def rmsnorm_decode(call):
    """rmsnorm at the decode shape (the recorded norm2 call: T = 8, D =
    1,600, bf16, with a residual): device time by CUDA events and by
    torch.profiler, and a chain that mirrors one Hymba decode block (the
    norm, an (8 x 1,600) x (1,600 x 1,600) bf16 matmul, the norm again,
    RMS_CHAIN times; beside it the same matmuls alone) by CUDA events; the
    wrapper's kernels, aten operators and host time a call; beside the
    bound and F.rms_norm."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    (x, w, r), kw = call
    T, D = x.numel() // x.shape[-1], x.shape[-1]
    eps = kw.get("eps", 1e-5)
    x2, r2 = x.reshape(T, D), r.reshape(T, D)
    gen = torch.Generator(device=x.device).manual_seed(19)
    W = (torch.randn((D, D), generator=gen, device=x.device)
         / D ** 0.5).to(x.dtype)
    out = {"rows": T, "width": D,
           "bound_ms": x.element_size() * (4 * T * D + D)
           / H100_BYTES_PER_S * 1e3,
           "chain_ms": cuda_ms(lambda: norm_chain(rmsnorm, x2, r2, w, W,
                                                  eps)),
           "chain_matmuls_only_ms": cuda_ms(lambda: norm_chain(
               None, x2, r2, w, W, eps))}
    out.update(call_figures(lambda: rmsnorm(x, w, r, **kw)))
    s = (x.float() + r.float()).to(x.dtype)
    out.update(rms_norm_ms=cuda_ms(lambda: F.rms_norm(s, (D,), w, eps)),
               add_rms_norm_ms=cuda_ms(lambda: F.rms_norm(x + r, (D,), w,
                                                          eps)))
    return out


def lm_kernel_checks(calls):
    """Parity (against the plain version on the same card inputs), timing
    and bound of the three LM kernels on their recorded arguments."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         visible)
    from repro_torch.kernels.mamba2_ssd.ops import ssd
    from repro_torch.kernels.mamba2_ssd.ref import ssd_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    def report(name, kernel, plain, args, kw, tol, nbytes, nflops, rate,
               library=None):
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        err, ok = allclose_err(got, want, tol)
        check(ok, f"{name}: kernel differs from its plain version by {err} "
              f"(tolerance {tol})")
        del got, want
        ms = cuda_ms(lambda: kernel(*args, **kw))
        plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=5)
        lib_ms = None if library is None else cuda_ms(library)
        b_bytes = nbytes / H100_BYTES_PER_S * 1e3
        b_ops = nflops / rate * 1e3
        return {"name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name], "launches": 0,
                "max_abs_err": err, "tolerance": tol, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
                "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                "library_ms": lib_ms, "bytes": int(nbytes),
                "flops": int(nflops)}

    rows = {}
    # -- rmsnorm, residual form at the prefill shape (norm2: T=16,384,
    # D=1,600).  bf16: the outputs may differ by one rounding step of
    # bf16 (2^-8 relative) where the two sums of squares, taken in another
    # order, straddle a rounding boundary: tolerance 1e-2.
    (x, w, r), kw = calls["rmsnorm/prefill"]
    T, D = x.numel() // x.shape[-1], x.shape[-1]
    es = x.element_size()
    rows["rmsnorm"] = report(
        "rmsnorm", rmsnorm, rmsnorm_ref, (x, w, r), kw, TOL_BF16_NORM,
        nbytes=es * (4 * T * D + D), nflops=5 * T * D, rate=H100_F32_FLOPS)
    # no single PyTorch call adds the residual and normalises: F.rms_norm
    # is timed on the pre-added sum (half the bytes) and after its add
    eps = kw.get("eps", 1e-5)
    s = (x.float() + r.float()).to(x.dtype)
    rows["rmsnorm"].update(
        library_note="none: no single call adds the residual and normalises",
        rms_norm_ms=cuda_ms(lambda: F.rms_norm(s, (D,), w, eps)),
        add_rms_norm_ms=cuda_ms(lambda: F.rms_norm(x + r, (D,), w, eps)))
    del s
    # the other two forms on the path: no residual (gate_norm, D=3,200)
    # and the decode shape (T=8), where most of its launches are
    for key in ("rmsnorm/gate", "rmsnorm/decode"):
        args, kw = calls[key]
        err, ok = allclose_err(rmsnorm(*args, **kw), rmsnorm_ref(*args, **kw),
                               TOL_BF16_NORM)
        check(ok, f"{key}: kernel differs from its plain version by {err}")
    rows["rmsnorm"]["sweep_max_abs_err"] = rmsnorm_sweep(x.device)
    rows["rmsnorm"]["decode"] = rmsnorm_decode(calls["rmsnorm/decode"])
    # -- flash attention.  bf16 in, f32 scores and sums; the kernel rounds
    # the unnormalised probabilities to bf16 and the plain version the
    # normalised ones: tolerance 2e-2, tests/test_kernels.py's bf16 bound.
    # K and V are the unexpanded (B, Sk, 7, 64) tensors, read through the
    # head map; bytes count them once, operations the visible pairs.
    sweep = flash_sweep(fa_ops, attention_ref,
                        calls["flash/prefill"][0][0].device)

    def flash_row(key, name):
        (q, k, v, qp, kp), kw = calls[key]
        B, Sq, H, D = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        mask = visible(qp, kp, causal=kw["causal"], window=kw["window"])
        pairs = int(mask.sum())
        idx = torch.tensor(kw["kv_head"], device=q.device)
        qt = q.transpose(1, 2)

        def expand():
            return (k.index_select(2, idx).transpose(1, 2),
                    v.index_select(2, idx).transpose(1, 2))
        kt, vt = expand()
        row = report(
            name, fa_ops.attention, attention_ref, (q, k, v, qp, kp), kw,
            TOL_BF16_FLASH,
            nbytes=q.element_size() * (2 * B * Sq * H * D + 2 * B * Sk * Hkv
                                       * D) + 4 * (Sq + Sk + H),
            nflops=4 * B * H * pairs * D, rate=H100_BF16_FLOPS,
            library=lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
        row["expand_ms"] = cuda_ms(expand)
        return row
    rows["flash_attention"] = flash_row("flash/prefill", "flash_attention")
    rows["flash_attention"]["sweep_max_abs_err"] = sweep
    dec = flash_row("flash/decode", "flash_attention")
    rows["flash_attention"]["decode"] = {
        k: dec[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                            "bound_ms", "bound_by", "library_ms",
                            "expand_ms", "bytes", "flops")}

    # -- ssd.  f32 throughout; the kernel's chunked sums (3xTF32 products)
    # against the sequential recurrence over 2,048 steps: tolerance 1e-3;
    # first a sweep of small shapes at tests/test_kernels.py's 1e-4.
    sweep = ssd_sweep(ssd, ssd_ref, calls["ssd"][0][0].device)
    (xdt, logd, Bv, Cv), kw = calls["ssd"]
    BH, S, P = xdt.shape
    N, heads = Bv.shape[-1], kw["heads"]

    def ssd_flops(Q):
        """flops of the chunked scan at chunk Q: the pairs on or below
        each chunk's diagonal (C B^T and the product with X) and the
        state's two products"""
        pairs = Q * (Q + 1) // 2
        return BH * (S // Q) * (2 * pairs * (N + P) + 4 * Q * P * N)
    nbytes = 4 * (2 * BH * S * P + BH * S + 2 * (BH // heads) * S * N
                  + BH * P * N)
    # the kernel runs chunks of at most 64 tokens, each product as three
    # TF32 products
    flops = ssd_flops(min(kw["chunk"], 64))
    rows["mamba2_ssd"] = report(
        "mamba2_ssd", ssd, lambda *a, chunk, heads: ssd_ref(*a, heads=heads),
        (xdt, logd, Bv, Cv), kw, TOL_SSD, nbytes=nbytes, nflops=3 * flops,
        rate=H100_TF32_FLOPS)
    # the earlier float32-SIMT design's yardstick: the requested chunk's
    # products in f32 FMAs
    rows["mamba2_ssd"].update(
        bound_f32_simt_ms=max(nbytes / H100_BYTES_PER_S,
                              ssd_flops(kw["chunk"]) / H100_F32_FLOPS) * 1e3,
        sweep_max_abs_err=sweep)
    return rows


def profile_device(fn):
    """Run ``fn()`` under torch.profiler: (wall s, {kernel: (device ms,
    calls)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            per[e.key[:80]] = (us / 1e3, e.count)
    return wall, per


def timed_generate(eng, prompts, gen, runs, name,
                   first=contextlib.nullcontext):
    """Phases 7 and 12: one untimed ``eng.generate(prompts, 2)`` (the
    first prefill after the allocator's cache was emptied pays for its
    allocations), then ``runs`` timed generates of ``gen`` tokens, each
    from zeroed stats and launch counts.  The first timed one runs inside
    ``first()``; its output is checked (shape, type, vocabulary) and its
    launch counts are returned with the figures: prefill s and decode ms
    a step, each the median over the runs, and every run's pair."""
    import dataclasses
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serve.engine import ServeStats
    eng.generate(prompts, 2)
    stats = []
    for i in range(runs):
        eng.stats = ServeStats()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        with first() if i == 0 else contextlib.nullcontext():
            out = eng.generate(prompts, gen)
        if i == 0:
            counts = _build.launch_counts()
            check(tuple(out.shape) == (prompts.shape[0], gen)
                  and out.dtype == torch.int32,
                  f"{name}: output shape or type")
            check(bool(((out >= 0) & (out < eng.cfg.vocab_size)).all()),
                  f"{name}: a token outside the vocabulary")
        stats.append(dataclasses.replace(eng.stats))
    pre_s = statistics.median(r.prefill_s for r in stats)
    step_s = statistics.median(r.decode_s / r.decode_steps for r in stats)
    st = stats[0]
    return counts, {
        "prefill_s": pre_s, "prefill_tokens_per_s": st.prefill_tokens / pre_s,
        "decode_ms_per_step": step_s * 1e3,
        "decode_tokens_per_s": st.decoded_tokens / st.decode_steps / step_s,
        "runs": [[r.prefill_s, r.decode_s / r.decode_steps * 1e3]
                 for r in stats]}


def serve_path(dev):
    """Phases 5-7.  Returns (kernel rows, serve_path figures)."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import ServeEngine
    expand = fa_ref.expand_kv

    # ---- 5. LM kernels on the serve path's own arguments ---------------
    t0 = time.perf_counter()
    cfg = get_arch(SERVE_ARCH)
    eng = ServeEngine(cfg, LM(cfg, seed=0, device=dev), device=dev,
                      max_len=SERVE_PROMPT + SERVE_GEN)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev, dtype=torch.int32)
    calls = record_generate(eng, prompts, 2)
    print(f"serve warm-up: {cfg.name}, {SERVE_BATCH} x {SERVE_PROMPT} "
          f"tokens + 2, in {time.perf_counter() - t0:.1f} s (set-up "
          f"included)")
    rows = lm_kernel_checks(calls)
    del calls
    torch.cuda.empty_cache()
    print("LM kernel parity, max abs err (tolerance atol = rtol): " +
          ", ".join(f"{k} {r['max_abs_err']:.3g} ({r['tolerance']})"
                    for k, r in rows.items()))

    # ---- 6. serve parity, card against CPU ------------------------------
    t0 = time.perf_counter()
    worst = config_parity(dev, SERVE_ARCH, SERVE_PROMPT, PARITY_DECODE)
    print(f"serve parity: {PARITY_LAYERS}-layer full-width {cfg.name}, f32,"
          f" prefill {SERVE_PROMPT} + {PARITY_DECODE} decode steps: max "
          f"logit difference {worst:.3g} (tol {TOL_SERVE}) in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- 7. the serve path, measured ------------------------------------
    expansions = []          # calls of the plain version's K/V expansion
    at_prefill = []          # the counts where the first prefill ends

    @contextlib.contextmanager
    def first():
        # the counts where this generate's prefill ends, at its first
        # synchronise; any K/V expansion of the plain version
        sync = eng._sync

        def marked_sync():
            sync()
            if not at_prefill:
                at_prefill.append(_build.launch_counts())
        eng._sync = marked_sync
        fa_ref.expand_kv = lambda *a, **k: expansions.append(1) or expand(
            *a, **k)
        try:
            yield
        finally:
            vars(eng).pop("_sync", None)
            fa_ref.expand_kv = expand
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts, timed = timed_generate(eng, prompts, SERVE_GEN, SERVE_RUNS,
                                   "serve", first)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    need = {"flash_attention.prefill": L,
            "flash_attention.decode": L * SERVE_GEN,
            "mamba2_ssd": L,
            "rmsnorm": (5 * L + 1) * (SERVE_GEN + 1)}
    for k, n in need.items():
        check(counts.get(k, 0) >= n, f"serve: {k} launched "
              f"{counts.get(k, 0)} times, expected >= {n}")
    for k in ("flash_attention.prefill", "flash_attention.decode"):
        check(counts.get(k, 0) == need[k], f"serve: {k} launched "
              f"{counts.get(k, 0)} times, expected one a layer a step")
    check(not expansions, "serve: K/V were expanded on the serve path")
    rows["rmsnorm"]["launches"] = counts.get("rmsnorm", 0)
    n_pre = at_prefill[0].get("rmsnorm", 0)
    rows["rmsnorm"]["launches_prefill"] = n_pre
    rows["rmsnorm"]["launches_decode"] = rows["rmsnorm"]["launches"] - n_pre
    rows["mamba2_ssd"]["launches"] = counts.get("mamba2_ssd", 0)
    fl = rows["flash_attention"]
    fl["decode"]["launches"] = counts.get("flash_attention.decode", 0)
    fl["prefill_launches"] = counts.get("flash_attention.prefill", 0)
    fl["launches"] = fl["prefill_launches"] + fl["decode"]["launches"]
    for pre_s, dec_ms in timed["runs"]:
        print(f"serve: {SERVE_BATCH} x {SERVE_PROMPT} prefill in "
              f"{pre_s:.3f} s, {SERVE_GEN} decode steps at {dec_ms:.2f} ms "
              f"a step")

    # where the time goes: a prefill alone, then a prefill and 8 decode
    # steps, under the profiler; decode = the difference
    pw, pre = profile_device(lambda: eng.generate(prompts, 0))
    dw, both = profile_device(lambda: eng.generate(prompts, PROFILE_STEPS))
    dec = {k: ((ms - pre.get(k, (0, 0))[0]) / PROFILE_STEPS,
               (n - pre.get(k, (0, 0))[1]) / PROFILE_STEPS)
           for k, (ms, n) in both.items()}

    def top(per, wall_ms):
        busy = sum(ms for ms, _ in per.values())
        return {"wall_ms": wall_ms, "device_busy_ms": busy,
                "busy_share": busy / wall_ms if wall_ms else None,
                "top_kernels": [[k, ms, n] for k, (ms, n) in sorted(
                    per.items(), key=lambda kv: -kv[1][0])[:8]]}
    figures = {
        "arch": cfg.name, "dtype": cfg.dtype, "batch": SERVE_BATCH,
        "prompt_len": SERVE_PROMPT, "gen": SERVE_GEN, **timed,
        "peak_mem_gb": peak / 1e9, "launches": {
            k: counts.get(k, 0) for k in need},
        "parity_max_logit_err": worst,
        "profiled_prefill": top(pre, pw * 1e3),
        "profiled_decode_step": top(dec, (dw - pw) / PROFILE_STEPS * 1e3)}
    del eng
    torch.cuda.empty_cache()
    return rows, figures


# ---------------------------------------------------------------------------
# phase 12: more configs served (GLM-4-9B, StarCoder2-7B, DBRX-132B)
# ---------------------------------------------------------------------------
def config_parity(dev, name, prompt_len, n_decode, patches=0):
    """``name`` at full width, depth cut to PARITY_LAYERS, float32: one
    prompt of ``prompt_len`` tokens (after ``patches`` image patch
    embeddings, for a vision config) and ``n_decode`` decode steps on the
    card (kernels) and on the CPU (plain versions), the same weights
    (drawn on the card, copied to the CPU) and the same token fed to both
    at each step; every logit within TOL_SERVE.  Returns the largest
    logit difference.  Phases 6, 12 and 14."""
    import torch
    from repro_torch.models import transformer as tf
    cfg, card, cpu = card_and_cpu(dev, name)
    g = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, prompt_len),
                                     generator=g, dtype=torch.int32)}
    if patches:
        batch["patch_embeds"] = torch.randn(
            (1, patches, cfg.frontend_dim), generator=g).to(torch.bfloat16)
    alloc = patches + prompt_len + n_decode
    worst = 0.0
    with torch.inference_mode():
        lc, cc = tf.prefill(cpu, batch, cfg, alloc_len=alloc)
        lg, cg = tf.prefill(card, {k: v.to(dev) for k, v in batch.items()},
                            cfg, alloc_len=alloc)
        for step in range(n_decode + 1):
            err, ok = allclose_err(lg.cpu(), lc, TOL_SERVE)
            worst = max(worst, err)
            check(ok, f"{name} parity: card and CPU logits differ by {err} "
                  f"at step {step} (tolerance {TOL_SERVE})")
            if step == n_decode:
                break
            tok = lc[:, -1].argmax(-1)[:, None].to(torch.int32)
            lc, cc = tf.decode_step(cpu, cc, tok, cfg)
            lg, cg = tf.decode_step(card, cg, tok.to(dev), cfg)
    del card, cpu, cc, cg
    gc.collect()
    torch.cuda.empty_cache()
    return worst


class PatchServe:
    """``generate(prompts, n)`` and ``stats`` as ``ServeEngine`` has them,
    for a vision config, whose serving engine takes tokens only:
    ``transformer.prefill`` on the fixed ``patch_embeds`` (B, P,
    frontend_dim) before the prompts, then greedy ``decode_step`` calls.
    :func:`timed_generate` times it as it times an engine."""

    def __init__(self, cfg, model, patch_embeds, max_len):
        from repro_torch.serve.engine import ServeStats
        self.cfg, self.model, self.max_len = cfg, model, max_len
        self.patch_embeds = patch_embeds
        self.stats = ServeStats()

    def generate(self, prompts, n_tokens):
        import torch
        from repro_torch.models import transformer as tf
        B, S = prompts.shape
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, cache = tf.prefill(
                self.model, {"tokens": prompts,
                             "patch_embeds": self.patch_embeds},
                self.cfg, alloc_len=self.max_len)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            outs = []
            for _ in range(n_tokens):
                outs.append(tok)
                logits, cache = tf.decode_step(self.model, cache, tok,
                                               self.cfg)
                tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
        check(cache["pos"] == self.patch_embeds.shape[1] + S + n_tokens,
              f"{self.cfg.name}: the cache ends at {cache['pos']}")
        st = self.stats
        st.prefill_s += t1 - t0
        st.prefill_tokens += B * (self.patch_embeds.shape[1] + S)
        st.decode_s += time.perf_counter() - t1
        st.decode_steps += n_tokens
        st.decoded_tokens += B * n_tokens
        return torch.cat(outs, dim=1)


def serve_config(dev, name, layers, batch, prompt_len, gen, need=None,
                 runs=CONFIG_RUNS, patches=0):
    """``ServeEngine.generate`` on ``name`` at full width (``layers`` of
    its depth, or all), bf16, random weights, through
    :func:`timed_generate` (``runs`` timed generates); with ``patches``,
    a vision config's :class:`PatchServe` on that many random patch
    embeddings a request before the ``prompt_len`` tokens.  The
    peak is this config's alone: the model before it was freed and the
    peak reset before this one was built.  ``need``: the launches of each
    kernel in the first timed generate (a GQA block's by default)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import ServeEngine
    full = get_arch(name)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, seed=0, device=dev)
    gen_ = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen_, device=dev, dtype=torch.int32)
    if patches:
        pe = torch.randn((batch, patches, cfg.frontend_dim), generator=gen_,
                         device=dev).to(torch.bfloat16)
        eng = PatchServe(cfg, model, pe, patches + prompt_len + gen)
    else:
        eng = ServeEngine(cfg, model, device=dev, max_len=prompt_len + gen)
    del model
    setup_s = time.perf_counter() - t0
    counts, timed = timed_generate(eng, prompts, gen, runs, name)
    memory = memory_figures(dev, torch.cuda.max_memory_allocated())
    L = cfg.n_layers
    if need is None:
        need = {"flash_attention.prefill": L,
                "flash_attention.decode": L * gen,
                "rmsnorm": (2 * L + 1) * (gen + 1)}
    for k, n in need.items():
        check(counts.get(k, 0) == n, f"{name}: {k} launched "
              f"{counts.get(k, 0)} times, expected {n}")
    fig = {
        "arch": name, "source": full.source, "layers": L,
        "layers_of": full.n_layers, "d_model": cfg.d_model,
        "params": cfg.n_params(), "active_params": cfg.n_active_params(),
        "dtype": cfg.dtype, "batch": batch, "patches": patches,
        "prompt_len": prompt_len, "gen": gen, "window": cfg.sliding_window,
        "setup_s": setup_s, **timed, **memory,
        "launches": {k: counts.get(k, 0) for k in sorted(counts)}}
    del eng, prompts
    gc.collect()
    torch.cuda.empty_cache()
    return fig


def serve_configs_phase(dev, rows):
    """Phase 12: each of SERVE_CONFIGS checked card against CPU (2 layers,
    f32), then served at full width in bf16.  Adds each config's launches
    to the flash-attention and rmsnorm rows; returns the serve_configs
    figures."""
    t0 = time.perf_counter()
    out = {}
    for name, layers, batch, prompt_len, gen in SERVE_CONFIGS:
        t1 = time.perf_counter()
        err = config_parity(dev, name, CONFIG_PARITY_PROMPT[name],
                            CONFIG_PARITY_DECODE)
        parity_s = time.perf_counter() - t1
        fig = serve_config(dev, name, layers, batch, prompt_len, gen)
        fig.update(parity_max_logit_err=err, parity_tolerance=TOL_SERVE,
                   parity_layers=PARITY_LAYERS,
                   parity_prompt=CONFIG_PARITY_PROMPT[name],
                   parity_decode=CONFIG_PARITY_DECODE, parity_s=parity_s)
        out[name] = fig
        print(f"serve {name}: {fig['layers']} of {fig['layers_of']} layers, "
              f"{batch} x {prompt_len} prefill {fig['prefill_s']:.3f} s, "
              f"decode {fig['decode_ms_per_step']:.1f} ms a step, peak "
              f"{fig['peak_mem_gb']:.2f} GB; parity {err:.3g}", flush=True)
        launches = fig["launches"]
        rows["flash_attention"].setdefault("serve_configs_launches", {})[
            name] = (launches.get("flash_attention.prefill", 0)
                     + launches.get("flash_attention.decode", 0))
        rows["rmsnorm"].setdefault("serve_configs_launches", {})[name] = \
            launches.get("rmsnorm", 0)
    return {"configs": out, "phase_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 11: the train path
# ---------------------------------------------------------------------------
def grad_err(got, want):
    """max |got - want| / max |want| over the tensors of two trees (each
    tensor on its own scale), float32; fails on a non-finite value."""
    import torch
    worst = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.float(), w.float()
        check(g.shape == w.shape, f"shape {tuple(g.shape)} vs "
              f"{tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), "non-finite gradient")
        scale = float(w.abs().max()) or 1.0
        worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def same_bits(a, b, what):
    """Fails unless two calls' outputs are the same bit for bit (the
    backward kernels use no float atomics: their sums run in a fixed
    order)."""
    import torch
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        same = x.shape == y.shape and torch.equal(
            x.contiguous().view(torch.uint8),
            y.contiguous().view(torch.uint8))
        check(same, f"{what}: two calls on the same inputs differ")


def rmsnorm_grad_plain(dy, dres, x, w, r, eps=1e-5):
    """(dx, dw) by autograd through the plain rmsnorm in float32."""
    import torch
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
    y, s = rmsnorm_ref(xf, wf, None if r is None else r.float(), eps)
    if r is None or dres is None:
        return torch.autograd.grad(y, (xf, wf), dy.float())
    return torch.autograd.grad((y, s), (xf, wf), (dy.float(), dres.float()))


def flash_grad_plain(do, q, k, v, q_pos, k_pos, **kw):
    """(dq, dk, dv) by autograd through the plain attention in float32."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    out = attention_ref(*leaves, q_pos, k_pos, **kw)
    return torch.autograd.grad(out, leaves, do.float())


def rmsnorm_bwd_sweep(dev):
    """The rmsnorm backward kernel against autograd through its plain
    version (float32) at RMS_BWD_ROWS x RMS_BWD_WIDTHS, bf16 and float32,
    with and without the residual: both vector widths (1,601 is not a
    multiple of 8), one row, rows past the grid's blocks, the widest row;
    each case twice, the two calls bit-identical.  Returns the worst error
    by dtype."""
    import torch
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_backward
    gen = torch.Generator(device=dev).manual_seed(23)
    worst, n = {}, 0
    for dtype, tol in ((torch.bfloat16, TOL_BF16_BWD),
                       (torch.float32, TOL_F32_BWD)):
        for T in RMS_BWD_ROWS:
            for D in RMS_BWD_WIDTHS:
                x, r, dy, dres = (torch.randn((T, D), generator=gen,
                                              device=dev).to(dtype)
                                  for _ in range(4))
                w = torch.randn((D,), generator=gen, device=dev).to(dtype)
                for rr, dr in ((r, dres), (None, None)):
                    got = rmsnorm_backward(dy, dr, x, w, rr)
                    same_bits(got, rmsnorm_backward(dy, dr, x, w, rr),
                              f"rmsnorm backward {dtype} T={T} D={D}")
                    want = rmsnorm_grad_plain(dy, dr, x, w, rr)
                    torch.cuda.synchronize()
                    err = grad_err(got, want)
                    check(err <= tol, f"rmsnorm backward {dtype} T={T} "
                          f"D={D} residual={rr is not None}: kernel differs "
                          f"from its plain version by {err} (tolerance "
                          f"{tol})")
                    key = str(dtype)[6:]
                    worst[key] = max(worst.get(key, 0.0), err)
                    n += 1
                del x, r, dy, dres, w, got, want
    torch.cuda.empty_cache()
    print(f"rmsnorm backward sweep: {n} cases, " + ", ".join(
        f"{k} max rel err {e:.3g}" for k, e in worst.items()))
    return worst


def flash_bwd_sweep(dev):
    """The flash backward kernel against autograd through the plain
    version on small prefill shapes: f32 and bf16, every (q/k, v) head dim
    pair, ragged
    lengths, causal, windowed and bidirectional masks, a regular GQA map
    and Hymba's padded one, empty key slots, rows that see no key (their
    gradient reaches every v row, dO / Sk, and no q or k) and a head where
    no row sees a key; each case twice, the two calls bit-identical."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    gen = torch.Generator(device=dev).manual_seed(29)
    hymba = [min(h // 5, 6) for h in range(32)]
    ar = lambda n, off=0: torch.arange(off, off + n, dtype=torch.int32)
    cases = [
        (2, 4, 2, None, ar(100), ar(100), True, None),
        (1, 32, 7, hymba, ar(150), ar(150), True, 40),
        (2, 4, 2, None, ar(70), ar(130), False, None),
        # keys start at 10 and some slots are empty: queries 0-9 see none
        (1, 32, 7, hymba, ar(70),
         torch.where(ar(130) % 7 == 3, -1, ar(130, 10)), True, 48),
        (2, 16, 1, None, ar(64), ar(64), True, 24),
        (1, 8, 4, None, ar(33), ar(90, 40), False, 20),
        (2, 4, 2, None, ar(5), ar(40, 10), True, None),    # none sees any
    ]
    worst = {}
    for dtype, tol in ((torch.float32, TOL_F32_BWD),
                       (torch.bfloat16, TOL_BF16_BWD)):
        for D, DV in fa.HEAD_DIM_PAIRS:
            for B, H, Hkv, kvh, qp, kp, causal, window in cases:
                Sq, Sk = qp.shape[0], kp.shape[0]
                q, do, k, v = (torch.randn(shape, generator=gen,
                                           device=dev).to(dtype)
                               for shape in ((B, Sq, H, D), (B, Sq, H, DV),
                                             (B, Sk, Hkv, D),
                                             (B, Sk, Hkv, DV)))
                qp, kp = qp.to(dev), kp.to(dev)
                kw = dict(causal=causal, window=window, kv_head=kvh)
                o, lse = fa._forward(q, k, v, qp, kp, causal, window, None,
                                     kvh, True)
                got = fa.attention_backward(do, q, k, v, o, lse, qp, kp,
                                            **kw)
                same_bits(got, fa.attention_backward(do, q, k, v, o, lse, qp,
                                                     kp, **kw),
                          f"flash backward sweep {dtype} D={D}/{DV} Sq={Sq}")
                want = flash_grad_plain(do, q, k, v, qp, kp, **kw)
                torch.cuda.synchronize()
                err = grad_err(got, want)
                check(err <= tol, f"flash backward sweep {dtype} D={D}/{DV} "
                      f"B={B} H={H}/{Hkv} Sq={Sq} Sk={Sk} causal={causal} "
                      f"window={window}: kernel differs from its plain "
                      f"version by {err} (tolerance {tol})")
                key = str(dtype)[6:]
                worst[key] = max(worst.get(key, 0.0), err)
    print("flash backward sweep: " + ", ".join(
        f"{k} max rel err {e:.3g}" for k, e in worst.items()))
    return worst


def flash_bwd_shape(dev, B, S, H, Hkv, D, window, kv_head, gen):
    """The flash backward kernel at one training shape: bf16 at batch B
    and float32 at batch 1, every request held against the plain version
    on that request alone, two calls bit-identical.  Returns (bf16
    inputs, bf16 max abs error, bf16 error, f32 error)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    kw = dict(causal=True, window=window, kv_head=kv_head)
    errs = []
    for dtype, b in ((torch.bfloat16, B), (torch.float32, 1)):
        q, do = (torch.randn((b, S, H, D), generator=gen, device=dev)
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((b, S, Hkv, D), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        o, lse = fa._forward(q, k, v, pos, pos, True, window, None, kv_head,
                             True)
        got = fa.attention_backward(do, q, k, v, o, lse, pos, pos, **kw)
        same_bits(got, fa.attention_backward(do, q, k, v, o, lse, pos, pos,
                                             **kw),
                  f"flash backward {dtype} B={b} S={S} H={H}/{Hkv} D={D}")
        err = abs_err = 0.0
        for i in range(b):
            one = slice(i, i + 1)
            want = flash_grad_plain(do[one], q[one], k[one], v[one], pos,
                                    pos, **kw)
            mine = [g[one] for g in got]
            err = max(err, grad_err(mine, want))
            abs_err = max(abs_err, *(float((g.float() - t).abs().max())
                                     for g, t in zip(mine, want)))
            del want, mine
        tol = TOL_BF16_BWD if dtype == torch.bfloat16 else TOL_F32_BWD
        check(err <= tol, f"flash backward {dtype} B={b} S={S} H={H}/{Hkv} "
              f"D={D} window={window}: kernel differs from its plain "
              f"version by {err} (tolerance {tol})")
        errs.append(err)
        if dtype == torch.bfloat16:
            keep, keep_abs = (q, k, v, o, lse, do, pos, kw), abs_err
        del got
    return keep, keep_abs, errs[0], errs[1]


def backward_kernel_rows(dev):
    """Phase 11, step 1: both backward kernels against autograd through
    their plain versions (sweeps, then the training shapes), and timed at
    the train path's shapes beside the plain version, the library call
    and the bound.  Returns {name: kernel row}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_backward
    rms_sweep = rmsnorm_bwd_sweep(dev)
    fl_sweep = flash_bwd_sweep(dev)
    rows = {}
    # -- rmsnorm backward at the train path's shape: 16,384 x 1,024 bf16,
    # the residual form (norm2 of every layer)
    cfg = get_arch(TRAIN_ARCH)
    T, D = TRAIN_BATCH * TRAIN_SEQ, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(31)
    x, r, dy, dres = (torch.randn((T, D), generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in range(4))
    w = torch.randn((D,), generator=gen, device=dev).to(torch.bfloat16)
    got = rmsnorm_backward(dy, dres, x, w, r)
    same_bits(got, rmsnorm_backward(dy, dres, x, w, r),
              "rmsnorm backward at the train shape")
    want = rmsnorm_grad_plain(dy, dres, x, w, r)
    err = grad_err(got, want)
    check(err <= TOL_BF16_BWD, f"rmsnorm backward at the train shape: "
          f"{err} (tolerance {TOL_BF16_BWD})")
    abs_err = max(float((g.float() - v).abs().max())
                  for g, v in zip(got, want))
    del got, want
    s = (x.float() + r.float()).to(x.dtype).requires_grad_()
    wl = w.detach().clone().requires_grad_()
    ys = F.rms_norm(s, (D,), wl, 1e-5)
    # x, r, dy, dres in and dx (= d(residual)) out; w in and dw out
    nbytes = 2 * (5 * T * D + 2 * D)
    b_bytes = nbytes / H100_BYTES_PER_S * 1e3
    b_ops = 12 * T * D / H100_F32_FLOPS * 1e3
    fig = call_figures(lambda: rmsnorm_backward(dy, dres, x, w, r))
    rows["rmsnorm.backward"] = {
        "name": "rmsnorm.backward", "route": "cuda",
        "source": SOURCE["rmsnorm.backward"],
        "replaces": REPLACES["rmsnorm.backward"],
        "replaces_note": "no TPU kernel: the port's own backward of "
                         "rmsnorm_pallas (src/repro/kernels/rmsnorm/"
                         "kernel.py:30); the JAX package differentiates "
                         "layers.rms_norm in XLA",
        "launches": 0, "max_abs_err": abs_err, "max_rel_err": err,
        "tolerance": TOL_BF16_BWD, "ms": fig["ms"], "prof_ms": fig["prof_ms"],
        "kernels_per_call": fig["kernels_per_call"],
        "plain_ms": cuda_ms(lambda: rmsnorm_grad_plain(dy, dres, x, w, r),
                            reps=5),
        "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            ys, (s, wl), dy, retain_graph=True)),
        "library_note": "F.rms_norm's autograd backward on the pre-added "
                        "sum (no d(residual) input)",
        "shape": [T, D], "sweep_max_rel_err": rms_sweep,
        "bytes": nbytes, "host_us": fig["host_us"]}
    del x, r, dy, dres, w, s, wl, ys
    torch.cuda.empty_cache()
    # -- flash backward at three shapes: Granite-MoE's training shape,
    # Hymba's prefill shape (window 1,024, 32 padded heads over 7 kv
    # heads through kv_index_map) and D = 128 (Granite-8B's head dim)
    hymba = get_arch("hymba-1.5b")
    shapes = {
        "granite-moe train": (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads,
                              cfg.n_kv_heads, cfg.d_head, None, None),
        "hymba prefill": (TRAIN_BATCH, TRAIN_SEQ, hymba.n_heads_padded,
                          hymba.n_kv_heads_padded, hymba.d_head,
                          hymba.sliding_window, hymba.kv_index_map()),
        "D=128": (TRAIN_BATCH, TRAIN_SEQ, 32, 8, 128, None, None)}
    errs, keep = {}, None
    for name, (B, S, H, Hkv, Dh, window, kvh) in shapes.items():
        inputs, e_abs, e16, e32 = flash_bwd_shape(dev, B, S, H, Hkv, Dh,
                                                  window, kvh, gen)
        errs[name] = {"bf16": e16, "float32": e32}
        if keep is None:
            keep, abs_err = inputs, e_abs
        del inputs
        torch.cuda.empty_cache()
    print("flash backward at the training shapes, every request, max rel "
          "err: " + json.dumps(errs))
    q, k, v, o, lse, do, pos, kw = keep
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    pairs = B * H * S * (S + 1) // 2
    flops = 5 * 2 * pairs * Dh           # five products of the forward's size
    # q, o, dO in and dQ out; k, v in and dK, dV out; the LSE in (f32)
    nbytes = 2 * (4 * B * S * H * Dh + 4 * B * S * Hkv * Dh) + 4 * B * H * S
    b_bytes = nbytes / H100_BYTES_PER_S * 1e3
    b_ops = flops / H100_BF16_FLOPS * 1e3
    fig = call_figures(lambda: fa.attention_backward(do, q, k, v, o, lse, pos,
                                                     pos, **kw))
    idx = torch.tensor(fa.head_map(H, Hkv), device=dev)
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.index_select(2, idx).transpose(1, 2).detach().requires_grad_()
    vt = v.index_select(2, idx).transpose(1, 2).detach().requires_grad_()
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    rows["flash_attention.backward"] = {
        "name": "flash_attention.backward", "route": "cuda",
        "source": SOURCE["flash_attention.backward"],
        "replaces": REPLACES["flash_attention.backward"],
        "replaces_note": "no TPU kernel: the port's own backward of "
                         "flash_attention_pallas (src/repro/kernels/"
                         "flash_attention/kernel.py:92); the JAX package "
                         "differentiates chunked_attention in XLA",
        "launches": 0, "max_abs_err": abs_err,
        "max_rel_err": errs["granite-moe train"]["bf16"],
        "tolerance": TOL_BF16_BWD, "ms": fig["ms"], "prof_ms": fig["prof_ms"],
        "kernels_per_call": fig["kernels_per_call"],
        "plain_ms": cuda_ms(lambda: flash_grad_plain(do, q, k, v, pos, pos,
                                                     **kw), reps=5),
        "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True)),
        "library_note": "SDPA's backward (is_causal) on K/V expanded to "
                        "every query head",
        "shape": [B, S, H, Hkv, Dh], "flops": flops, "bytes": nbytes,
        "shapes_max_rel_err": errs, "sweep_max_rel_err": fl_sweep,
        "host_us": fig["host_us"],
        "forward_with_lse_ms": cuda_ms(lambda: fa._forward(
            q, k, v, pos, pos, True, None, None, None, True)),
        "forward_ms": cuda_ms(lambda: fa.attention(q, k, v, pos, pos,
                                                   causal=True))}
    del q, k, v, o, lse, do, qt, kt, vt, ot, dot, keep
    torch.cuda.empty_cache()
    return rows


def route_recorder(moe_lib, log, side):
    """Wrap ``moe.route`` so that each call appends (``side[0]``, expert
    ids, the gap between each token's k-th and (k+1)-th gate) to ``log``;
    returns the undo."""
    import torch
    orig = moe_lib.route

    def route(router, x_flat, cfg):
        out = orig(router, x_flat, cfg)
        with torch.no_grad():
            gates = torch.softmax(x_flat.float() @ router, dim=-1)
            top = torch.topk(gates, cfg.top_k + 1, dim=-1).values
            log.append((side[0], out[1].cpu(),
                        (top[:, -2] - top[:, -1]).cpu()))
        return out
    moe_lib.route = route
    return lambda: setattr(moe_lib, "route", orig)


def train_parity(dev, arch=TRAIN_ARCH):
    """Phase 11, step 2 (and phase 13's, with ``arch`` Hymba): ``arch``
    at full width, depth cut to
    TRAIN_PARITY_LAYERS, float32 (no TF32 anywhere), TRAIN_PARITY_STEPS
    ``Trainer`` steps on the card (kernels) and on the CPU (plain
    versions) from the same parameters and batches.  For a MoE the
    routing ids are
    compared first: a token routed otherwise on the two sides must have a
    tie (its k-th and (k+1)-th gates within TOL_ROUTE_GAP).  Then the
    losses (TOL_TRAIN_LOSS relative: float32 sums in another order), the
    gradient norms (TOL_TRAIN_GNORM) and the parameters, leaf by leaf.
    Adam's normalised step moves a coordinate by up to lr whatever the
    size of its gradient, so a coordinate whose gradient is at the noise
    level can move by up to lr a step in either direction on the two
    sides: every coordinate is held to 2 x the sum of the steps' learning
    rates, which only a non-finite or runaway update can break.  The
    gate that catches a wrong gradient is each leaf's 99.9 % quantile of
    |card - CPU| <= TOL_TRAIN_PARAM_Q (1.3 % of the first step's lr):
    where a gradient is well above the noise, float32 sums in another
    order change its step by ~1e-6 of lr, while a wrong gradient moves
    most coordinates of its leaf by ~lr."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.models import moe as moe_lib
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_arch(arch),
                              n_layers=TRAIN_PARITY_LAYERS, dtype="float32")
    moe = cfg.block == "attn_moe"
    tcfg = TrainerConfig(seq_len=TRAIN_PARITY_SEQ, batch=TRAIN_PARITY_BATCH,
                         steps_per_epoch=TRAIN_EPOCH,
                         hp=AdamWConfig(lr=TRAIN_LR,
                                        warmup_steps=TRAIN_WARMUP))
    cpu = Trainer(cfg, tcfg, device="cpu")
    card = Trainer(cfg, tcfg, device=dev)
    card.load_state(cpu.params, cpu.opt_state)
    log, side = [], ["cpu"]
    undo = route_recorder(moe_lib, log, side) if moe else (lambda: None)
    try:
        for _ in range(TRAIN_PARITY_STEPS):
            side[0] = "cpu"
            cpu.run(1)
            side[0] = "card"
            card.run(1)
    finally:
        undo()
    out = {"arch": arch, "layers": TRAIN_PARITY_LAYERS,
           "batch": TRAIN_PARITY_BATCH, "seq": TRAIN_PARITY_SEQ,
           "steps": TRAIN_PARITY_STEPS}
    if moe:
        sides = {t: [(i, g) for d, i, g in log if d == t]
                 for t in ("cpu", "card")}
        check(len(sides["cpu"]) == len(sides["card"]) > 0,
              "train parity: route calls differ in number")
        flips, worst_gap = 0, 0.0
        for (ic, gc_), (ig, _) in zip(sides["cpu"], sides["card"]):
            bad = (ic != ig).any(-1)
            flips += int(bad.sum())
            if bad.any():
                worst_gap = max(worst_gap, float(gc_[bad].max()))
        check(worst_gap <= TOL_ROUTE_GAP, f"train parity: {flips} tokens "
              f"routed otherwise on the card, with a gate gap up to "
              f"{worst_gap} (a tie is <= {TOL_ROUTE_GAP})")
        out.update(route_calls=len(sides["cpu"]), routing_flips=flips,
                   worst_flip_gap=worst_gap)
    for key, tol in (("loss", TOL_TRAIN_LOSS), ("grad_norm",
                                                TOL_TRAIN_GNORM)):
        a = [m[key] for m in cpu.metrics_history]
        b = [m[key] for m in card.metrics_history]
        rel = max(abs(x - y) / max(abs(x), 1e-12) for x, y in zip(a, b))
        check(rel <= tol, f"train parity: {key} card {b} vs CPU {a} "
              f"(relative {rel}, tolerance {tol})")
        out[f"{key}_cpu"], out[f"{key}_card"] = a, b
        out[f"{key}_max_rel_err"] = rel
    lr_sum = sum(TRAIN_LR * min(1.0, (t + 1) / TRAIN_WARMUP)
                 for t in range(TRAIN_PARITY_STEPS))
    bound = 2 * lr_sum
    worst, worst_q, worst_leaf = 0.0, 0.0, None
    for k, p in cpu.params.items():
        d = (card.params[k].detach().cpu() - p.detach()).abs().reshape(-1)
        worst = max(worst, float(d.max()))
        # every coordinate of the leaf, sorted: torch.quantile takes at
        # most 2^24 elements
        q = float(d.sort().values[min(d.numel() - 1,
                                      int(0.999 * d.numel()))])
        if q >= worst_q:
            worst_q, worst_leaf = q, k
    check(worst <= bound, f"train parity: parameters differ by {worst} "
          f"(bound {bound} = 2 x the steps' learning rates)")
    check(worst_q <= TOL_TRAIN_PARAM_Q, f"train parity: {worst_leaf}'s "
          f"99.9 % quantile of |card - CPU| is {worst_q} (tolerance "
          f"{TOL_TRAIN_PARAM_Q})")
    out.update(param_max_abs_err=worst, param_bound=bound,
               param_leaf_p999_abs_err=worst_q, param_p999_leaf=worst_leaf,
               param_p999_tolerance=TOL_TRAIN_PARAM_Q)
    del cpu, card
    torch.cuda.empty_cache()
    return out


def state_digest(tr):
    """(float64 sum, int64 sum of the raw bits) of every parameter and
    optimizer-state tensor, in a fixed order: equal digests of equal
    shapes are what a bit-equal state gives."""
    import torch
    from repro_torch.train.star_dp import tree_leaves
    out = []
    for t in tree_leaves({"p": tr.params, "o": tr.opt_state}):
        t = t.detach()
        bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        out.append((float(t.double().sum()), int(bits.long().sum())))
    return out


def same_as_commit(tr):
    """Whether the live state equals the committed snapshot bit for bit."""
    import torch
    from repro_torch.train.star_dp import tree_leaves
    c = tr.commit_log.committed
    live = tree_leaves({"p": tr.params, "o": tr.opt_state})
    snap = tree_leaves({"p": c.params, "o": c.opt_state})
    return len(live) == len(snap) and all(
        torch.equal(a.detach(), b) for a, b in zip(live, snap))


def check_revert(tr, what):
    """Run ``tr`` to its next fence, two steps past it, then
    ``inject_failure``: the state must be bit-equal to the fence's.
    Returns (fence step, the state's digest there, revert s)."""
    import torch
    tr.run(tr.tcfg.steps_per_epoch - tr.step % tr.tcfg.steps_per_epoch)
    fence_step = tr.step
    digest = state_digest(tr)
    check(same_as_commit(tr), f"{what}: the fence's snapshot differs from "
          f"the live state")
    tr.run(2)
    check(state_digest(tr) != digest, f"{what}: two steps left the state "
          f"as it was")
    t0 = time.perf_counter()
    back = tr.inject_failure()
    torch.cuda.synchronize()
    revert_s = time.perf_counter() - t0
    check(back == fence_step and same_as_commit(tr)
          and state_digest(tr) == digest,
          f"{what}: the revert is not bit-equal to the committed epoch")
    return fence_step, digest, revert_s


def timed_training(dev, arch, batch, seq, warm, timed, need):
    """``Trainer`` on ``arch`` at full width and depth in bf16, ``batch`` x
    ``seq`` tokens a step, remat as the config says: ``warm`` untimed
    steps, then ``timed`` timed ones, the launch counts and the peak
    memory reset between.  The loss must be finite and fall (the mean of
    the first 4 timed steps against the last 4), and each kernel of
    ``need`` must launch exactly that many times a step.  Returns (the
    trainer, the figures every train path prints)."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_arch(arch)
    t0 = time.perf_counter()
    tr = Trainer(cfg, TrainerConfig(
        seq_len=seq, batch=batch, steps_per_epoch=TRAIN_EPOCH,
        hp=AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)), device=dev)
    setup_s = time.perf_counter() - t0
    tr.run(warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    tr.run(timed)
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = tr.metrics_history[warm:]
    losses = [m["loss"] for m in tr.metrics_history]
    tl = [m["loss"] for m in hist]
    check(all(x == x and abs(x) != float("inf") for x in losses),
          f"{arch} train: a non-finite loss in {losses}")
    first, last = (statistics.mean(tl[:4]), statistics.mean(tl[-4:]))
    check(last < first, f"{arch} train: the loss did not fall ({tl})")
    per_step = {k: counts.get(k, 0) / timed for k in need}
    for k, n in need.items():
        check(per_step[k] == n, f"{arch} train: {k} launched {per_step[k]} "
              f"times a step, expected {n}")
    step_s = [m["step_s"] for m in hist]
    med = statistics.median(step_s)
    tokens = batch * seq
    return tr, {
        "arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
        "batch": batch, "seq": seq, "tokens_per_step": tokens,
        "remat": cfg.remat, "lr": TRAIN_LR, "warmup_steps": TRAIN_WARMUP,
        "steps_per_epoch": TRAIN_EPOCH, "setup_s": setup_s,
        "step_ms_median": med * 1e3, "step_ms_min": min(step_s) * 1e3,
        "step_ms_max": max(step_s) * 1e3,
        "step_ms": [t * 1e3 for t in step_s],
        "tokens_per_s": tokens / med,
        "train_mfu": 6 * cfg.n_active_params() * tokens / med / H100_BF16_FLOPS,
        "train_mfu_note": "6 x n_active_params x tokens / step s / 989e12: "
                          "attention's and the scan's FLOPs and remat's "
                          "recompute left out",
        "n_active_params": cfg.n_active_params(), "n_params": cfg.n_params(),
        "peak_mem_gb": peak / 1e9, "losses": losses,
        "loss_first4_mean": first, "loss_last4_mean": last,
        "launches_per_step": per_step}


def profiled_step(tr, top):
    """One ``tr`` step under torch.profiler: wall, device busy time and
    its ``top`` kernels."""
    wall, per = profile_device(lambda: tr.run(1))
    busy = sum(ms for ms, _ in per.values())
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "busy_share": busy / (wall * 1e3),
            "top_kernels": [[k, ms, n] for k, (ms, n) in sorted(
                per.items(), key=lambda kv: -kv[1][0])[:top]]}


def train_path(dev, rows):
    """Phase 11, step 3: ``Trainer`` on Granite-3.0-1B-A400M at full width
    and depth in bf16, TRAIN_BATCH x TRAIN_SEQ tokens a step, remat as the
    config says.  Returns the train_path figures; sets the train path's
    launches a step on ``rows`` (the four LM kernel rows)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs.base import ShapeCell, get_arch
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import transformer as tf
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.star_dp import EpochCommitLog
    cfg = get_arch(TRAIN_ARCH)
    L = cfg.n_layers
    # remat: every block's forward kernels run again in the backward (the
    # final norm is outside the blocks: once)
    need = {"flash_attention.prefill": 2 * L, "flash_attention.backward": L,
            "rmsnorm": 4 * L + 1, "rmsnorm.backward": 2 * L + 1}
    tr, figures = timed_training(dev, TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ,
                                 TRAIN_WARM, TRAIN_TIMED, need)
    per_step = figures["launches_per_step"]
    # -- the trainer's state against the dry run at this cell, (1, 1)
    rec = dryrun.cell_record(cfg, ShapeCell("phase11", "train", TRAIN_SEQ,
                                            TRAIN_BATCH),
                             AbstractMesh((1, 1), ("data", "model")))
    have = {"params": sum(t.numel() * t.element_size()
                          for t in tr.params.values()),
            "opt_state": sum(t.numel() * t.element_size()
                             for t in tree_leaves(tr.opt_state))}
    want = {k: rec["mem"]["bytes_per_rank"][k] for k in have}
    check(have == want, f"train: the trainer holds {have} bytes, the dry "
          f"run says {want}")
    figures["dryrun_bytes"] = {"trainer": have, "dryrun": want,
                               "equal": have == want}
    # -- revert: to the fence at step 16, two steps past it, then back
    fence_step, digest, revert_s = check_revert(tr, "train")
    # -- checkpoint at the fence, two steps, restore from disk
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tr.tcfg.checkpoint_dir = ckdir
        t0 = time.perf_counter()
        path = save_checkpoint(ckdir, tr.step, tr.params, tr.opt_state,
                               {"epoch": tr.step // TRAIN_EPOCH})
        save_s = time.perf_counter() - t0
        ck_bytes = sum(f.stat().st_size for f in path.iterdir())
        tr.run(2)
        t0 = time.perf_counter()
        meta = tr.restore_from_disk()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(meta["step"] == fence_step and state_digest(tr) == digest
              and same_as_commit(tr),
              "train: the state restored from disk is not bit-equal to the "
              "checkpoint")
    finally:
        tr.tcfg.checkpoint_dir = None
        shutil.rmtree(ckdir, ignore_errors=True)
    # -- hybrid replication accounting on a gradient
    rep = tr.replication_report()
    # -- one step under the profiler, then one split by hand
    prof = profiled_step(tr, 10)
    batch = {k: v.to(dev) for k, v in make_batch(
        cfg, "train", TRAIN_SEQ, TRAIN_BATCH, seed=tr.step).items()}
    split = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = tf.loss_fn(tr.model, batch, cfg)
    torch.cuda.synchronize()
    split["forward_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grads = torch.autograd.grad(loss, list(tr.params.values()))
    torch.cuda.synchronize()
    split["backward_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    adamw_update(tr.params, dict(zip(tr.params, grads)), tr.opt_state,
                 tr.tcfg.hp)
    torch.cuda.synchronize()
    split["optimizer_s"] = time.perf_counter() - t0
    del grads, loss
    t0 = time.perf_counter()
    EpochCommitLog(1).maybe_fence(0, tr.params, tr.opt_state)
    torch.cuda.synchronize()
    split["fence_snapshot_s"] = time.perf_counter() - t0
    split.update(checkpoint_save_s=save_s, checkpoint_restore_s=restore_s,
                 revert_s=revert_s)
    rows.setdefault("flash_attention", {})[
        "train_prefill_launches_per_step"] = per_step[
            "flash_attention.prefill"]
    rows.setdefault("rmsnorm", {})["train_launches_per_step"] = per_step[
        "rmsnorm"]
    rows["flash_attention.backward"]["launches"] = \
        per_step["flash_attention.backward"]
    rows["rmsnorm.backward"]["launches"] = per_step["rmsnorm.backward"]
    figures.update(
        revert_to_step=fence_step, checkpoint_bytes=ck_bytes,
        replication_value_bytes=rep.value_bytes,
        replication_op_bytes=rep.op_bytes, split=split,
        profiled_step=prof, straggler_events=tr.straggler_events,
        fences=tr.commit_log.fences)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return figures


def train_phase(dev, rows):
    """Phase 11: the backward kernels, card against CPU, the full model.
    Adds the two backward kernels' rows to ``rows``; returns the
    train_path figures."""
    t0 = time.perf_counter()
    rows.update(backward_kernel_rows(dev))
    print("backward kernels: " + ", ".join(
        f"{k} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, library "
        f"{r['library_ms']:.4f})" for k, r in rows.items()
        if k.endswith(".backward")), flush=True)
    parity = train_parity(dev)
    print(f"train parity: {json.dumps(parity)}", flush=True)
    figures = train_path(dev, rows)
    figures["parity"] = parity
    figures["phase_s"] = time.perf_counter() - t0
    print(f"train path: {figures['step_ms_median']:.1f} ms a step, "
          f"{figures['tokens_per_s']:.0f} tokens/s, peak "
          f"{figures['peak_mem_gb']:.2f} GB, phase "
          f"{figures['phase_s']:.1f} s", flush=True)
    return figures


# ---------------------------------------------------------------------------
# phase 13: Hymba trains (the SSD scan's backward kernel)
# ---------------------------------------------------------------------------
def ssd_bwd_inputs(gen, BH, S, P, N, heads, decay, dev, hf=True):
    """dy, dh_final (or None), xdt, logd, Bv, Cv on ``dev``, float32."""
    import torch
    scale, shift = {"weak": (0.01, 0.0), "strong": (4.0, 1.0),
                    "hymba": (None, None)}[decay]
    xdt = torch.randn((BH, S, P), generator=gen)
    if scale is None:       # dt = softplus(.), A = -1: logd = -dt
        logd = -torch.nn.functional.softplus(torch.randn((BH, S),
                                                         generator=gen))
        xdt = xdt * 0.7
    else:
        logd = -(torch.randn((BH, S), generator=gen).abs() * scale + shift)
    Bv, Cv = (torch.randn((BH // heads, S, N), generator=gen)
              for _ in range(2))
    dy = torch.randn((BH, S, P), generator=gen)
    dhf = torch.randn((BH, P, N), generator=gen) if hf else None
    return [None if t is None else t.to(dev)
            for t in (dy, dhf, xdt, logd, Bv, Cv)]


def ssd_bwd_sweep(dev):
    """The SSD backward kernel against autograd through its plain version
    run in float64 (the float32 sequential recurrence drifts past the
    bound): P in SSD_BWD_P x N in SSD_BWD_N x heads in SSD_BWD_HEADS, with
    and without dh_final, weak and strong decay, S ragged (not a multiple
    of the kernel's 64-token chunks, one to four chunks); Mamba2-130M's N
    = 128 (N in groups of 32 columns); a state no block holds (N = 512)
    must be refused.  Every case runs on both routes, the chunk-start
    states computed inside ``ssd_backward`` (called twice) and handed
    over from the forward kernel as the autograd Function does, and the
    three results are held bit-equal.  Returns the largest relative
    error."""
    import torch
    from repro_torch.kernels.mamba2_ssd.ops import _forward, ssd_backward
    from repro_torch.kernels.mamba2_ssd.ref import ssd_backward_ref
    gen = torch.Generator().manual_seed(19)
    cases = [(P, N, heads, hf, d)
             for P in SSD_BWD_P for N in SSD_BWD_N for heads in SSD_BWD_HEADS
             for hf in (False, True) for d in ("weak", "strong")]
    cases.append((64, 128, 1, True, "weak"))
    worst = 0.0
    for i, (P, N, heads, hf, d) in enumerate(cases):
        S = (37, 100, 203)[i % 3]
        BH = 2 * heads
        args = ssd_bwd_inputs(gen, BH, S, P, N, heads, d, dev, hf)
        got = ssd_backward(*args, heads=heads)
        same_bits(got, ssd_backward(*args, heads=heads),
                  f"ssd backward P={P} N={N} heads={heads}")
        states = _forward(*args[2:], 64, heads, states=True)[2]
        same_bits(got, ssd_backward(*args, heads=heads, states=states),
                  f"ssd backward P={P} N={N} heads={heads}, states from "
                  f"the forward")
        want = ssd_backward_ref(*[None if t is None else t.double()
                                  for t in args], heads=heads)
        err = grad_err(got, want)
        check(err <= TOL_SSD_BWD, f"ssd backward sweep P={P} N={N} "
              f"heads={heads} dh_final={hf} logd {d} S={S}: {err} "
              f"(tolerance {TOL_SSD_BWD})")
        worst = max(worst, err)
    big = ssd_bwd_inputs(gen, 1, 8, 16, 512, 1, "weak", dev)
    try:
        ssd_backward(*big)
        refused = False
    except ValueError:
        refused = True
    check(refused, "ssd backward: a 16 x 512 state, which no block holds, "
          "ran")
    print(f"ssd backward sweep: {len(cases)} shapes, max rel err "
          f"{worst:.3g} (tolerance {TOL_SSD_BWD}), each twice bit-equal",
          flush=True)
    return worst, len(cases)


def ssd_bwd_row(dev):
    """Phase 13, step 1: the SSD backward kernel on its sweep, then at
    Hymba's training shape (HYMBA_BATCH x 50 heads, HYMBA_SEQ tokens, P =
    64, N = 16, one group of 50 heads a batch row): the whole shape on
    the kernel on the chunk-start states of the forward kernel, as a
    training step calls it, twice (bit-equal, and equal to a call that
    computes the states inside), the rows of the first batch element
    against the plain version in float64; timed by CUDA events and by
    torch.profiler beside the plain version in float32 and the bound.
    Returns the kernel row."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.mamba2_ssd.ops import (_forward, ssd,
                                                    ssd_backward)
    from repro_torch.kernels.mamba2_ssd.ref import ssd_backward_ref
    sweep, n_cases = ssd_bwd_sweep(dev)
    cfg = get_arch(HYMBA_ARCH)
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    BH, S, G = HYMBA_BATCH * H, HYMBA_SEQ, HYMBA_BATCH
    gen = torch.Generator().manual_seed(23)
    dy, _, xdt, logd, Bv, Cv = ssd_bwd_inputs(gen, BH, S, P, N, H, "hymba",
                                              dev, hf=False)
    hst = _forward(xdt, logd, Bv, Cv, 64, H, states=True)[2]
    got = ssd_backward(dy, None, xdt, logd, Bv, Cv, heads=H, states=hst)
    same_bits(got, ssd_backward(dy, None, xdt, logd, Bv, Cv, heads=H,
                                states=hst),
              "ssd backward at the training shape")
    same_bits(got, ssd_backward(dy, None, xdt, logd, Bv, Cv, heads=H),
              "ssd backward at the training shape, states inside")
    want = ssd_backward_ref(dy[:H].double(), None, xdt[:H].double(),
                            logd[:H].double(), Bv[:1].double(),
                            Cv[:1].double(), heads=H)
    first = (got[0][:H], got[1][:H], got[2][:1], got[3][:1])
    err = grad_err(first, want)
    check(err <= TOL_SSD_BWD, f"ssd backward at the training shape: {err} "
          f"(tolerance {TOL_SSD_BWD})")
    abs_err = max(float((g.double() - w).abs().max())
                  for g, w in zip(first, want))
    del got, want, first
    torch.cuda.empty_cache()
    fig = call_figures(lambda: ssd_backward(dy, None, xdt, logd, Bv, Cv,
                                            heads=H, states=hst))
    whole = call_figures(lambda: ssd_backward(dy, None, xdt, logd, Bv, Cv,
                                              heads=H))
    # bytes: xdt, logd, B, C, dy read once; dxdt, dlogd, dB, dC written
    nbytes = 4 * (3 * BH * S * P + 2 * BH * S + 4 * G * S * N)
    # operations the function needs, per row and token on the P x N state:
    # six products of two operations an element (h's update, g's update,
    # and the contractions for dxdt, dB, dC and dlogd), at the float32
    # rate of the tensor cores (3xTF32, as row mamba2_ssd is bounded)
    flops = 12 * BH * S * P * N
    # what this kernel issues: its m16n8k8 products (2 * 16 * 8 * 8
    # operations each) over the tiles it computes, three TF32 products
    # each, in blocks of 64 state rows (csrc/ssd.cu, BWD_PB)
    kernel_flops = (3 * 2048 * ssd_bwd_products(64, N) * BH * -(-P // 64)
                    * -(-S // 64))
    b_bytes = nbytes / H100_BYTES_PER_S * 1e3
    b_ops = 3 * flops / H100_TF32_FLOPS * 1e3
    row = {
        "name": "mamba2_ssd.backward", "route": "cuda",
        "source": SOURCE["mamba2_ssd.backward"],
        "replaces": REPLACES["mamba2_ssd.backward"],
        "replaces_note": "no TPU kernel: the port's own backward of "
                         "ssd_pallas (src/repro/kernels/mamba2_ssd/"
                         "kernel.py:75); the JAX package differentiates "
                         "the chunked scan of src/repro/models/mamba2.py:"
                         "63-118 in XLA",
        "launches": 0, "max_abs_err": abs_err, "max_rel_err": err,
        "tolerance": TOL_SSD_BWD, "ms": fig["ms"], "prof_ms": fig["prof_ms"],
        "kernels_per_call": fig["kernels_per_call"],
        "plain_ms": cuda_ms(lambda: ssd_backward_ref(
            dy, None, xdt, logd, Bv, Cv, heads=H), reps=3, warm=1),
        "plain_note": "autograd through the sequential recurrence, float32",
        "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "bound_bytes_ms": b_bytes, "bound_tf32x3_ops_ms": b_ops,
        "kernel_tf32x3_ops_ms": kernel_flops / H100_TF32_FLOPS * 1e3,
        "library_ms": None,
        "library_note": "none: no PyTorch call computes the SSD scan or "
                        "its gradient",
        "shape": [BH, S, P, N, H], "bytes": nbytes, "flops": flops,
        "kernel_flops": kernel_flops,
        "prof_kernels_per_call": fig["prof_kernels_per_call"],
        "sweep_max_rel_err": sweep, "sweep_cases": n_cases,
        "host_us": fig["host_us"],
        "states_inside": {k: whole[k] for k in ("ms", "prof_ms",
                                                "kernels_per_call")},
        "forward_ms": cuda_ms(lambda: ssd(xdt, logd, Bv, Cv, chunk=256,
                                          heads=H)),
        "forward_with_states_ms": cuda_ms(lambda: _forward(
            xdt, logd, Bv, Cv, 64, H, states=True)),
        "forward_prof_ms": prof_ms(lambda: ssd(xdt, logd, Bv, Cv, chunk=256,
                                               heads=H))[0],
        "forward_with_states_prof_ms": prof_ms(lambda: _forward(
            xdt, logd, Bv, Cv, 64, H, states=True))[0]}
    del dy, xdt, logd, Bv, Cv
    torch.cuda.empty_cache()
    return row


def ssd_bwd_products(PB, N):
    """m16n8k8 products (each run as three TF32 products) that
    ``ssd_bwd_kernel`` issues for one (row, block of PB state rows,
    64-token chunk): on the 20 of 32 tiles of a 64 x 64 chunk on or below
    its diagonal, M^T (both halves), dX, Z^T and Z; on all of N, the
    state parts of dX, dB and dC; dB's and dC's own products; the G
    update."""
    n8, pk, tri = -(-N // 8), PB // 8, 20
    return (2 * tri * n8 + tri * pk + 4 * n8 * pk + 2 * tri * pk
            + 2 * 4 * pk * n8 + 2 * tri * n8 + (PB // 16) * n8 * 8)


def rmsnorm_bwd_hymba(dev):
    """Row 7b at Hymba's widths (measured, not changed): the rmsnorm
    backward at HYMBA_BATCH x HYMBA_SEQ rows in bf16, at d_model (1,600:
    norm2's residual form and norm1's plain form) and at the SSM's inner
    width (3,200: the gate norm): against autograd through its plain
    version, by CUDA events and torch.profiler beside its bound (bytes)
    and ``F.rms_norm``'s autograd backward on the pre-added sum.  Returns
    {form: figures}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_backward
    cfg = get_arch(HYMBA_ARCH)
    T = HYMBA_BATCH * HYMBA_SEQ
    gen = torch.Generator(device=dev).manual_seed(37)
    out = {}
    for D, res in ((cfg.d_model, True), (cfg.d_model, False),
                   (cfg.n_ssm_heads * cfg.ssm_head_dim, False)):
        x, dy, r, dres = (torch.randn((T, D), generator=gen, device=dev)
                          .to(torch.bfloat16) for _ in range(4))
        if not res:
            r = dres = None
        w = torch.randn((D,), generator=gen, device=dev).to(torch.bfloat16)
        got = rmsnorm_backward(dy, dres, x, w, r)
        err = grad_err(got, rmsnorm_grad_plain(dy, dres, x, w, r))
        check(err <= TOL_BF16_BWD, f"rmsnorm backward at {T} x {D}: {err} "
              f"(tolerance {TOL_BF16_BWD})")
        del got
        s = (x if r is None else (x.float() + r.float()).to(x.dtype))
        s = s.detach().requires_grad_()
        wl = w.detach().clone().requires_grad_()
        ys = F.rms_norm(s, (D,), wl, 1e-5)
        # x (and r, d(residual)) and dy in, dx out; w in and dw out
        nbytes = 2 * ((5 if res else 3) * T * D + 2 * D)
        fig = call_figures(lambda: rmsnorm_backward(dy, dres, x, w, r))
        out[f"{T}x{D}" + (" residual" if res else "")] = {
            "ms": fig["ms"], "prof_ms": fig["prof_ms"],
            "kernels_per_call": fig["kernels_per_call"],
            "max_rel_err": err,
            "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes,
            "plain_ms": cuda_ms(lambda: rmsnorm_grad_plain(dy, dres, x, w, r),
                                reps=5),
            "library_ms": cuda_ms(lambda: torch.autograd.grad(
                ys, (s, wl), dy, retain_graph=True))}
        del x, dy, r, dres, w, s, wl, ys
        torch.cuda.empty_cache()
    return out


def hymba_train_path(dev, rows):
    """Phase 13, step 3: ``Trainer`` on Hymba-1.5B at full width and depth
    in bf16, HYMBA_BATCH x HYMBA_SEQ tokens a step, remat as the config
    says: HYMBA_WARM untimed and HYMBA_TIMED timed steps (the loss must
    fall), launches a step of the LM kernels, then a revert to the fence
    (bit-equal) and one step under torch.profiler.  Returns the
    train_path_hymba figures."""
    import torch
    from repro_torch.configs.base import get_arch
    L = get_arch(HYMBA_ARCH).n_layers
    # remat: every block's forward kernels run again in the backward; a
    # block has five norms (norm1, the two branch norms, norm2, the SSD
    # gate's), the final norm is outside the blocks
    need = {"mamba2_ssd": 2 * L, "mamba2_ssd.backward": L,
            "flash_attention.prefill": 2 * L, "flash_attention.backward": L,
            "rmsnorm": 10 * L + 1, "rmsnorm.backward": 5 * L + 1}
    tr, figures = timed_training(dev, HYMBA_ARCH, HYMBA_BATCH, HYMBA_SEQ,
                                 HYMBA_WARM, HYMBA_TIMED, need)
    per_step = figures["launches_per_step"]
    fence_step, _, revert_s = check_revert(tr, "hymba train")
    rows["mamba2_ssd.backward"]["launches"] = per_step["mamba2_ssd.backward"]
    rows["mamba2_ssd"]["train_launches_per_step"] = per_step["mamba2_ssd"]
    rows["flash_attention"]["hymba_train_prefill_launches_per_step"] = \
        per_step["flash_attention.prefill"]
    rows["flash_attention.backward"]["hymba_train_launches_per_step"] = \
        per_step["flash_attention.backward"]
    rows["rmsnorm"]["hymba_train_launches_per_step"] = per_step["rmsnorm"]
    rows["rmsnorm.backward"]["hymba_train_launches_per_step"] = \
        per_step["rmsnorm.backward"]
    figures.update(
        revert_to_step=fence_step, revert_s=revert_s,
        profiled_step=profiled_step(tr, 12), fences=tr.commit_log.fences,
        straggler_events=tr.straggler_events)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return figures


def hymba_train_phase(dev, rows):
    """Phase 13: the SSD backward kernel, Hymba card against CPU, the full
    Hymba-1.5B.  Adds the SSD backward's row to ``rows``; returns the
    train_path_hymba figures."""
    t0 = time.perf_counter()
    rows["mamba2_ssd.backward"] = ssd_bwd_row(dev)
    r = rows["mamba2_ssd.backward"]
    print(f"ssd backward at {r['shape']}: {r['ms']:.4f} ms events, "
          f"{r['prof_ms']:.4f} ms profiler, {r['kernels_per_call']} "
          f"kernels a call (bound {r['bound_ms']:.4f}, plain "
          f"{r['plain_ms']:.1f}), max rel err {r['max_rel_err']:.3g}",
          flush=True)
    rms = rmsnorm_bwd_hymba(dev)
    rows["rmsnorm.backward"]["hymba_widths"] = rms
    print("rmsnorm backward at Hymba's widths: " + json.dumps(rms),
          flush=True)
    parity = train_parity(dev, HYMBA_ARCH)
    print(f"hymba train parity: {json.dumps(parity)}", flush=True)
    figures = hymba_train_path(dev, rows)
    figures["parity"] = parity
    figures["phase_s"] = time.perf_counter() - t0
    print(f"hymba train path: {figures['step_ms_median']:.1f} ms a step, "
          f"{figures['tokens_per_s']:.0f} tokens/s, peak "
          f"{figures['peak_mem_gb']:.2f} GB, phase "
          f"{figures['phase_s']:.1f} s", flush=True)
    return figures


# ---------------------------------------------------------------------------
# phase 14: MLA (MiniCPM3-4B) and the frontends (InternVL2-26B, HuBERT-
# XLarge), through the flash kernel at head dims (96, 64) and 80
# ---------------------------------------------------------------------------
def card_and_cpu(dev, name):
    """``name`` at full width, depth cut to PARITY_LAYERS, float32, on the
    card (weights drawn there) and on the CPU (the same weights)."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_arch(name), n_layers=PARITY_LAYERS,
                              dtype="float32")
    card = tf.LM(cfg, seed=0, device=dev)
    cpu = tf.LM(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()},
                        assign=True)
    return cfg, card, cpu


def grad_parity(dev, name):
    """``loss_fn`` and the gradient of every parameter on ``name`` at full
    width, PARITY_LAYERS layers, float32 (remat as the config says), on
    GRAD_PARITY_BATCH x GRAD_PARITY_SEQ of ``make_batch``'s train inputs:
    card (the forward and backward kernels) against CPU (plain versions).
    The loss within TOL_TRAIN_LOSS relative, each gradient within
    TOL_GRAD_PARITY of its largest element.  Returns the figures and the
    card run's launch counts."""
    import torch
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import param_grads
    from repro_torch.models import transformer as tf
    cfg, card, cpu = card_and_cpu(dev, name)
    batch = make_batch(cfg, "train", GRAD_PARITY_SEQ, GRAD_PARITY_BATCH,
                       seed=7)
    out = {}
    for side, model, b in (("card", card, {k: v.to(dev) for k, v in
                                           batch.items()}),
                           ("cpu", cpu, batch)):
        model.requires_grad_(True)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        loss, _ = tf.loss_fn(model, b, cfg)
        grads = param_grads(loss, dict(model.named_parameters()), cfg)
        torch.cuda.synchronize()
        out[side] = (float(loss), {k: g.detach().cpu() for k, g in
                                   grads.items()}, _build.launch_counts())
    (lg, gg, counts), (lc, gc_, _) = out["card"], out["cpu"]
    rel = abs(lg - lc) / max(abs(lc), 1e-12)
    check(rel <= TOL_TRAIN_LOSS, f"{name} grad parity: loss card {lg} vs "
          f"CPU {lc} (relative {rel}, tolerance {TOL_TRAIN_LOSS})")
    check(set(gg) == set(gc_), f"{name} grad parity: parameters differ")
    worst, leaf = 0.0, None
    for k in gc_:
        e = grad_err(gg[k], gc_[k])
        if e >= worst:
            worst, leaf = e, k
    check(worst <= TOL_GRAD_PARITY, f"{name} grad parity: {leaf}'s gradient "
          f"differs by {worst} of its largest element (tolerance "
          f"{TOL_GRAD_PARITY})")
    L = PARITY_LAYERS
    for k, n in (("flash_attention.prefill", 2 * L if cfg.remat else L),
                 ("flash_attention.backward", L)):
        check(counts.get(k, 0) == n, f"{name} grad parity: {k} launched "
              f"{counts.get(k, 0)} times on the card, expected {n}")
    del card, cpu, out, gg, gc_
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": L, "batch": GRAD_PARITY_BATCH, "seq": GRAD_PARITY_SEQ,
            "loss_card": lg, "loss_cpu": lc, "loss_rel_err": rel,
            "grad_max_rel_err": worst, "grad_worst_leaf": leaf,
            "grad_tolerance": TOL_GRAD_PARITY,
            "launches": {k: counts.get(k, 0) for k in sorted(counts)}}


def mla_train_step(dev):
    """MiniCPM3-4B's ``Trainer`` at full width, MLA_TRAIN_LAYERS layers,
    bf16, MLA_BATCH x MLA_PROMPT tokens a step: one untimed step, then one
    from zeroed launch counts, whose loss must be finite and whose flash
    launches must be one (96, 64) backward and the forward (twice under
    remat) a layer.  Returns its step ms and launches."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_arch(MLA_ARCH), n_layers=MLA_TRAIN_LAYERS)
    tr = Trainer(cfg, TrainerConfig(seq_len=MLA_PROMPT, batch=MLA_BATCH),
                 device=dev)
    tr.run(1)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    tr.run(1)
    counts = _build.launch_counts()
    m = tr.metrics_history[-1]
    L = cfg.n_layers
    check(m["loss"] == m["loss"] and abs(m["loss"]) != float("inf"),
          f"{MLA_ARCH} train: loss {m['loss']}")
    for k, n in (("flash_attention.prefill", 2 * L if cfg.remat else L),
                 ("flash_attention.backward", L)):
        check(counts.get(k, 0) == n, f"{MLA_ARCH} train: {k} launched "
              f"{counts.get(k, 0)} times, expected {n}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": L, "batch": MLA_BATCH, "seq": MLA_PROMPT,
            "dtype": cfg.dtype, "loss": m["loss"], "step_ms":
            m["step_s"] * 1e3,
            "launches": {k: counts.get(k, 0) for k in sorted(counts)}}


def mla_latent_copy_ms(dev, decode_ms):
    """The float32 copies of the latent cache that ``mla_decode`` makes in
    every layer at every step (``c_kv.float()``, ``k_rope.float()``), at
    the serving shape (MLA_BATCH x (MLA_PROMPT + MLA_GEN) slots), timed
    alone by CUDA events; times the layers, and its share of the measured
    ``decode_ms`` a step."""
    import torch
    from repro_torch.configs.base import get_arch
    cfg = get_arch(MLA_ARCH)
    S = MLA_PROMPT + MLA_GEN
    c_kv, k_rope = (torch.randn((MLA_BATCH, S, w), device=dev).to(
        torch.bfloat16) for w in (cfg.kv_lora_rank, cfg.qk_rope_head_dim))
    ms = cuda_ms(lambda: (c_kv.float(), k_rope.float()))
    del c_kv, k_rope
    return {"layer_ms": ms, "step_ms": ms * cfg.n_layers,
            "share_of_decode_step": ms * cfg.n_layers / decode_ms}


def memory_figures(dev, peak):
    """The peak allocated and reserved since the last reset, the card's
    memory and what was free at the reserved peak (GB)."""
    import torch
    total = torch.cuda.mem_get_info(dev)[1]
    reserved = torch.cuda.max_memory_reserved()
    return {"peak_mem_gb": peak / 1e9, "peak_reserved_gb": reserved / 1e9,
            "card_gb": total / 1e9, "free_at_peak_gb": (total - reserved)
            / 1e9}


def encode_audio(dev):
    """HuBERT-XLarge's encoder at full width and depth, bf16, random
    weights: ``transformer.forward`` on AUDIO_BATCH x AUDIO_FRAMES frames
    under inference_mode, one untimed, then PHASE14_RUNS timed, the
    launches of the first counted from 0; the logits finite, of the
    padded vocabulary, the pad columns masked.  Returns the figures."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as tf
    cfg = get_arch(AUDIO_ARCH)
    B, T = AUDIO_BATCH, AUDIO_FRAMES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = tf.LM(cfg, seed=0, device=dev)
    frames = torch.randn((B, T, cfg.frontend_dim), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             3)).to(torch.bfloat16)

    @torch.inference_mode()
    def encode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = tf.forward(model, {"frames": frames}, cfg)[0]
        torch.cuda.synchronize()
        return logits, time.perf_counter() - t0
    encode()
    times = []
    for i in range(PHASE14_RUNS):
        _build.reset_launch_counts()
        logits, dt = encode()
        if i == 0:
            counts = _build.launch_counts()
            V = cfg.vocab_size
            check(tuple(logits.shape) == (B, T, cfg.padded_vocab),
                  f"{AUDIO_ARCH}: logits shape {tuple(logits.shape)}")
            check(bool(torch.isfinite(logits[..., :V]).all())
                  and bool((logits[..., V:] < -1e29).all()),
                  f"{AUDIO_ARCH}: a non-finite logit or an unmasked pad")
        times.append(dt)
        del logits
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    for k, m in (("flash_attention.prefill", L), ("rmsnorm", 2 * L + 1)):
        check(counts.get(k, 0) == m, f"{AUDIO_ARCH} encode: {k} launched "
              f"{counts.get(k, 0)} times, expected {m}")
    enc = statistics.median(times)
    fig = {"arch": cfg.name, "source": cfg.source, "layers": L,
           "d_model": cfg.d_model, "params": cfg.n_params(),
           "dtype": cfg.dtype, "batch": B, "frames": T, "encode_s": enc,
           "encode_frames_per_s": B * T / enc, "runs_s": times,
           **memory_figures(dev, peak),
           "launches": {k: counts.get(k, 0) for k in sorted(counts)}}
    del model, frames
    gc.collect()
    torch.cuda.empty_cache()
    return fig


def train_audio(dev):
    """HuBERT-XLarge trains at full width and depth in bf16, AUDIO_BATCH x
    AUDIO_FRAMES frames a step, with phase 11's optimizer and fence: the
    loss falls over AUDIO_TIMED timed steps, each kernel launches its
    count a step, and the revert to the fence is bit-equal."""
    import torch
    from repro_torch.configs.base import get_arch
    L = get_arch(AUDIO_ARCH).n_layers
    # remat: the forward kernels run again in the backward; norm1 and
    # norm2 a block, the final norm outside
    need = {"flash_attention.prefill": 2 * L, "flash_attention.backward": L,
            "rmsnorm": 4 * L + 1, "rmsnorm.backward": 2 * L + 1}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr, fig = timed_training(dev, AUDIO_ARCH, AUDIO_BATCH, AUDIO_FRAMES,
                             AUDIO_WARM, AUDIO_TIMED, need)
    fig.update(memory_figures(dev, torch.cuda.max_memory_allocated()))
    fence_step, _, revert_s = check_revert(tr, f"{AUDIO_ARCH} train")
    fig.update(revert_to_step=fence_step, revert_s=revert_s,
               fences=tr.commit_log.fences)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return fig


def flash_shape_rows(dev):
    """The flash kernels at phase 14's shapes, bf16, each held to its
    plain version (forward 2e-2, backward 2e-2 of each gradient's largest
    element, two calls bit-equal), timed by CUDA events and by
    torch.profiler beside the plain version, SDPA on the same inputs and
    the bound: MLA's prefill and backward at MLA_BATCH x MLA_PROMPT x 48
    heads, (96, 64), causal; HuBERT's encoder and its backward at
    AUDIO_BATCH x AUDIO_FRAMES x 16 heads x 80, bidirectional.  Returns
    ({shape: forward figures}, {shape: backward figures})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    mla, audio = get_arch(MLA_ARCH), get_arch(AUDIO_ARCH)
    shapes = {
        "mla": (MLA_BATCH, MLA_PROMPT, mla.n_heads_padded,
                mla.qk_nope_head_dim + mla.qk_rope_head_dim,
                mla.v_head_dim, True),
        "hubert": (AUDIO_BATCH, AUDIO_FRAMES, audio.n_heads, audio.d_head,
                   audio.d_head, False)}
    gen = torch.Generator(device=dev).manual_seed(37)
    fwd, bwd = {}, {}
    for key, (B, S, H, DK, DV, causal) in shapes.items():
        q, k, do, v = (torch.randn((B, S, H, d), generator=gen, device=dev)
                       .to(torch.bfloat16) for d in (DK, DK, DV, DV))
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        base = {"shape": [B, S, H, DK, DV], "causal": causal,
                "launches": 0}
        # -- forward
        call = lambda: fa.attention(q, k, v, pos, pos, causal=causal)
        got = call()
        want = attention_ref(q, k, v, pos, pos, causal=causal)
        torch.cuda.synchronize()
        err, ok = allclose_err(got, want, TOL_BF16_FLASH)
        check(ok, f"flash {key} prefill: kernel differs from its plain "
              f"version by {err} (tolerance {TOL_BF16_FLASH})")
        del got, want
        flops = 2 * pairs * (DK + DV)
        nbytes = 2 * B * S * H * (2 * DK + 2 * DV) + 8 * S
        fig = call_figures(call)
        b_bytes = nbytes / H100_BYTES_PER_S * 1e3
        b_ops = flops / H100_BF16_FLOPS * 1e3
        fwd[key] = dict(base, max_abs_err=err, tolerance=TOL_BF16_FLASH,
                        ms=fig["ms"], prof_ms=fig["prof_ms"],
                        kernels_per_call=fig["kernels_per_call"],
                        plain_ms=cuda_ms(lambda: attention_ref(
                            q, k, v, pos, pos, causal=causal), reps=3),
                        bound_ms=max(b_bytes, b_ops),
                        bound_by="bytes" if b_bytes >= b_ops
                        else "operations",
                        library_ms=cuda_ms(
                            lambda: F.scaled_dot_product_attention(
                                qt.detach(), kt.detach(), vt.detach(),
                                is_causal=causal)),
                        library_note="SDPA on the same inputs", flops=flops,
                        bytes=nbytes)
        # -- backward
        o, lse = fa._forward(q, k, v, pos, pos, causal, None, None, None,
                             True)
        bcall = lambda: fa.attention_backward(do, q, k, v, o, lse, pos, pos,
                                              causal=causal)
        got = bcall()
        same_bits(got, bcall(), f"flash {key} backward")
        err = abs_err = 0.0
        for i in range(B):
            one = slice(i, i + 1)
            want = flash_grad_plain(do[one], q[one], k[one], v[one], pos,
                                    pos, causal=causal)
            mine = [g[one] for g in got]
            err = max(err, grad_err(mine, want))
            abs_err = max(abs_err, *(float((g.float() - w).abs().max())
                                     for g, w in zip(mine, want)))
            del want, mine
        check(err <= TOL_BF16_BWD, f"flash {key} backward: kernel differs "
              f"from its plain version by {err} (tolerance {TOL_BF16_BWD})")
        del got
        flops = 2 * pairs * (3 * DK + 2 * DV)
        # q, k, dq, dk (DK); v, o, dO, dv (DV); the LSE in float32
        nbytes = 2 * B * S * H * (4 * DK + 4 * DV) + 4 * B * H * S
        fig = call_figures(bcall)
        b_bytes = nbytes / H100_BYTES_PER_S * 1e3
        b_ops = flops / H100_BF16_FLOPS * 1e3
        dot = do.transpose(1, 2)
        bwd[key] = dict(base, max_abs_err=abs_err, max_rel_err=err,
                        tolerance=TOL_BF16_BWD, ms=fig["ms"],
                        prof_ms=fig["prof_ms"],
                        kernels_per_call=fig["kernels_per_call"],
                        plain_ms=cuda_ms(lambda: flash_grad_plain(
                            do, q, k, v, pos, pos, causal=causal), reps=3),
                        bound_ms=max(b_bytes, b_ops),
                        bound_by="bytes" if b_bytes >= b_ops
                        else "operations",
                        library_ms=cuda_ms(lambda: torch.autograd.grad(
                            ot, (qt, kt, vt), dot, retain_graph=True)),
                        library_note="SDPA's backward on the same inputs",
                        flops=flops, bytes=nbytes)
        del q, k, v, do, o, lse, qt, kt, vt, ot, dot
        torch.cuda.empty_cache()
    return fwd, bwd


def mla_frontends_phase(dev, rows):
    """Phase 14: the flash kernels at the new shapes; MiniCPM3-4B checked
    card against CPU (serve and loss_fn's gradients, 2 layers f32), one
    bf16 training step at MLA_TRAIN_LAYERS layers (the (96, 64)
    backward's launches on a model path), served, and its latent cache's
    f32 copies timed; InternVL2-26B checked with patches and served with them;
    HuBERT-XLarge checked (loss_fn's gradients), encoding and training.
    Adds the new shapes to the flash rows; returns the mla_frontends
    figures."""
    import torch
    from repro_torch.configs.base import get_arch
    t0 = time.perf_counter()
    fwd, bwd = flash_shape_rows(dev)
    rows["flash_attention"]["new_shapes"] = fwd
    rows["flash_attention.backward"]["new_shapes"] = bwd
    print("flash at phase 14's shapes: " + json.dumps(
        {f"{k} {d}": [r["ms"], r["prof_ms"], r["bound_ms"], r["library_ms"]]
         for d, rs in (("forward", fwd), ("backward", bwd))
         for k, r in rs.items()}), flush=True)
    out = {}
    # -- MiniCPM3-4B
    mla = get_arch(MLA_ARCH)
    L = mla.n_layers
    t1 = time.perf_counter()
    err = config_parity(dev, MLA_ARCH, MLA_PARITY_PROMPT,
                        CONFIG_PARITY_DECODE)
    grads = grad_parity(dev, MLA_ARCH)
    parity_s = time.perf_counter() - t1
    train = mla_train_step(dev)
    # MLA decodes in the absorbed form: no attention kernel; a block's
    # norms: norm1, q_norm, kv_norm, norm2
    fig = serve_config(dev, MLA_ARCH, None, MLA_BATCH, MLA_PROMPT, MLA_GEN,
                       need={"flash_attention.prefill": L,
                             "flash_attention.decode": 0,
                             "rmsnorm": (4 * L + 1) * (MLA_GEN + 1)},
                       runs=PHASE14_RUNS)
    fig.update(parity_max_logit_err=err, parity_tolerance=TOL_SERVE,
               parity_prompt=MLA_PARITY_PROMPT, grad_parity=grads,
               parity_s=parity_s, train_step=train,
               latent_f32_copy=mla_latent_copy_ms(
                   dev, fig["decode_ms_per_step"]))
    out[MLA_ARCH] = fig
    fwd["mla"]["launches"] = fig["launches"]["flash_attention.prefill"]
    bwd["mla"]["launches"] = train["launches"]["flash_attention.backward"]
    bwd["mla"]["launches_of"] = (f"a bf16 training step of {MLA_ARCH} at "
                                 f"{MLA_TRAIN_LAYERS} of {L} layers")
    print(f"serve {MLA_ARCH}: {MLA_BATCH} x {MLA_PROMPT} prefill "
          f"{fig['prefill_s']:.3f} s, decode {fig['decode_ms_per_step']:.1f}"
          f" ms a step, peak {fig['peak_mem_gb']:.2f} GB; parity {err:.3g},"
          f" gradients {grads['grad_max_rel_err']:.3g}; a bf16 train step "
          f"at {MLA_TRAIN_LAYERS} layers {train['step_ms']:.1f} ms; the "
          f"latent cache's f32 copies "
          f"{fig['latent_f32_copy']['step_ms']:.3f} ms a decode step",
          flush=True)
    # -- InternVL2-26B
    vis = get_arch(VISION_ARCH)
    t1 = time.perf_counter()
    err = config_parity(dev, VISION_ARCH, VISION_PARITY_TEXT,
                        CONFIG_PARITY_DECODE, patches=vis.n_patches)
    parity_s = time.perf_counter() - t1
    fig = serve_config(dev, VISION_ARCH, None, VISION_BATCH, VISION_TEXT,
                       VISION_GEN, runs=PHASE14_RUNS, patches=vis.n_patches)
    fig.update(parity_max_logit_err=err, parity_tolerance=TOL_SERVE,
               parity_patches=vis.n_patches, parity_text=VISION_PARITY_TEXT,
               parity_s=parity_s)
    out[VISION_ARCH] = fig
    print(f"serve {VISION_ARCH}: {VISION_BATCH} x ({vis.n_patches} patches "
          f"+ {VISION_TEXT}) prefill {fig['prefill_s']:.3f} s, decode "
          f"{fig['decode_ms_per_step']:.1f} ms a step, peak "
          f"{fig['peak_mem_gb']:.2f} GB; parity {err:.3g}", flush=True)
    # -- HuBERT-XLarge
    enc = encode_audio(dev)
    grads = grad_parity(dev, AUDIO_ARCH)
    train = train_audio(dev)
    out[AUDIO_ARCH] = {"encode": enc, "grad_parity": grads, "train": train}
    fwd["hubert"]["launches"] = enc["launches"]["flash_attention.prefill"]
    fwd["hubert"]["train_launches_per_step"] = train["launches_per_step"][
        "flash_attention.prefill"]
    bwd["hubert"]["launches"] = train["launches_per_step"][
        "flash_attention.backward"]
    print(f"{AUDIO_ARCH}: encode {AUDIO_BATCH} x {AUDIO_FRAMES} frames in "
          f"{enc['encode_s']:.3f} s; train {train['step_ms_median']:.1f} ms"
          f" a step, {train['tokens_per_s']:.0f} frames/s, mfu "
          f"{train['train_mfu']:.3f}, peak {train['peak_mem_gb']:.2f} GB; "
          f"gradients {grads['grad_max_rel_err']:.3g}", flush=True)
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 14: {out['phase_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phase 15: several processes over torch.distributed (4 ranks, one card)
# ---------------------------------------------------------------------------
def digest(tensors):
    """sha256 of tensors' (or numpy arrays') bytes, in order."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for t in tensors:
        a = t if isinstance(t, np.ndarray) else t.contiguous().cpu().numpy()
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def copy_digests(val, tid, idx, sl=slice(None)):
    """The digest of one copy's rows ``sl``: records, TID words, every
    index segment."""
    return digest([val[sl], tid[sl]] + [ix[f][sl] for ix in idx
                                        for f in ("key", "prow", "tid")])


def rank_digests(eng):
    """Each copy one rank of ``DistClusterStarEngine`` holds, digested
    where it lies: its primary block, its secondary copy, the master's
    full copy."""
    out = {"part": copy_digests(eng.part_val, eng.part_tid, eng.part_idx)}
    if eng.secondary:
        out["sec"] = copy_digests(eng.sec_val, eng.sec_tid, eng.sec_idx)
    if eng.is_master:
        out["full"] = copy_digests(eng.full_val, eng.full_tid, eng.full_idx)
    return out


def single_digests(eng, rank):
    """:func:`rank_digests` of node ``rank`` on a single-process
    ``ClusterStarEngine`` (node n's rows of its copies)."""
    sl = eng.node_slice(rank)
    out = {"part": copy_digests(eng.part_val, eng.part_tid, eng.part_idx,
                                sl)}
    if eng.secondary:
        out["sec"] = copy_digests(eng.sec_val, eng.sec_tid, eng.sec_idx, sl)
    if rank == 0:
        out["full"] = copy_digests(eng.full_val, eng.full_tid, eng.full_idx)
    return out


def launch_mark(dev):
    """Start counting launches: the card's (``_build``'s counts, reset);
    on the CPU, a rehearsal's, the wrappers' dispatches to their plain
    versions (``obs.trace``), from this mark."""
    from repro_torch.kernels import _build
    from repro_torch.obs import trace
    if dev.type == "cuda":
        _build.reset_launch_counts()
        return None
    return trace.kernel_launch_counts()


def launches_since(dev, mark):
    from repro_torch.kernels import _build
    from repro_torch.obs import trace
    if dev.type == "cuda":
        return _build.launch_counts()
    now = trace.kernel_launch_counts()
    return {k: n - mark.get(k, 0) for k, n in now.items()
            if n - mark.get(k, 0)}


def dev_sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dist_inputs(cfg, state, spec, ep):
    """Epoch ``ep``'s batch (seeded) and its two read offers: the draw's
    read-only transactions, half offered at the epoch's fence (served
    there), half after that round (served by the next epoch's mid-epoch
    round, or deferred to its fence).  In the spec's ``half_write`` epochs
    the nodes of the first half of the partitions write nothing, so their
    reads serve mid-epoch."""
    import numpy as np
    from repro_torch.db import tpcc
    from repro_torch.service.clients import read_lane_request, without_writers
    raw = tpcc.make_raw(cfg, state, spec["txns"],
                        np.random.default_rng(5000 + ep))
    if ep + 1 in spec["half_write"]:
        raw = without_writers(state, raw, range(cfg.n_partitions // 2))
    batch = tpcc.make_batch(cfg, state, 0, raw=raw)
    sel = np.nonzero(raw["read_only"])[0]
    h = sel.size // 2
    return batch, (read_lane_request(raw, sel[:h]),
                   read_lane_request(raw, sel[h:]))


def group_digest(r, mid_epoch):
    """One read group, digested: replica, snapshot epoch, freshness, round,
    slots and every output."""
    return (r["replica"], int(r["epoch"]), int(r["freshness"]), mid_epoch,
            digest([r["slots"]] + [r["out"][k] for k in sorted(r["out"])]))


def lanes(cfg, rt):
    """Phase 15 (a)'s read tier, analytics lane and admission controller
    over the runtime ``rt`` (the master's, or the single-process
    reference's), in the order both build them."""
    from repro_torch.changelog import AnalyticsLane
    from repro_torch.db import tpcc
    from repro_torch.reads import ReadTier
    from repro_torch.service import AdmissionController
    tier = ReadTier(max_staleness_epochs=READ_K,
                    sec_refresh_every=READ_REFRESH)
    lane = AnalyticsLane(cfg)
    lane.ensure_attached(rt)
    tier.observe_epoch(rt)
    tier.attach_changelog(rt.changelog)
    adm = AdmissionController(cfg.n_partitions, cfg.rows_per_partition,
                              max_ops=tpcc.M, n_cols=tpcc.C, read_lane=True)
    return tier, lane, adm


def lanes_epoch(dev, rt, tier, lane, adm, batch, offers, after=None):
    """One epoch of phase 15 (a) as the master and the single-process
    reference run it: the epoch with a mid-epoch read round in its ingest
    hook, ``after(metrics)`` (the master's collective checks), the
    catalog's fence stamp, the first offer served at the fence, the
    second offered, the analytics lane's round.  Returns (metrics, figures:
    the groups' digests, the views' stamp digest, the rounds' times)."""
    got = {"groups": [], "t_mid_s": 0.0, "mid_groups": 0}

    def mid_epoch():
        t0 = time.perf_counter()
        res = tier.serve(adm, mid_epoch=True)
        got["t_mid_s"] += time.perf_counter() - t0
        got["mid_groups"] += len(res)
        got["groups"] += [group_digest(r, True) for r in res]
    t0 = time.perf_counter()
    m = rt.run_epoch(batch, ingest=mid_epoch)
    dev_sync(dev)
    got["t_epoch_s"] = time.perf_counter() - t0
    if after is not None:
        after(m)
    t0 = time.perf_counter()
    tier.observe_epoch(rt, m)
    t1 = time.perf_counter()
    adm.offer(offers[0], 0.0)
    res = tier.serve(adm)
    t2 = time.perf_counter()
    got.update(t_stamp_s=t1 - t0, t_fence_s=t2 - t1, fence_groups=len(res))
    got["groups"] += [group_digest(r, False) for r in res]
    adm.offer(offers[1], 0.0)
    lane.serve(rt.committed_epoch)
    e, aggs = lane.views.latest()
    got["stamp"] = (int(e), digest([aggs[k] for k in sorted(aggs)]))
    return m, got


def dist_cluster(rank, dev, spec, work):
    """Phase 15 (a) on one rank: the TPC-C cluster of phase 10 with this
    rank one node, the per-node WAL, the spec's kills and both lanes on
    the master; the other ranks run ``follow``, answering the read rounds
    from their own secondary snapshots.  The master saves the batches and
    read offers it ran and each epoch's read groups and views' stamp,
    digested; every rank checks ``replica_consistent()`` at every fence
    and digests its copies after each epoch.  Then a ``serve_cluster``
    run with both lanes (``spec["service_s"]``), node 2 killed."""
    import pickle
    import numpy as np
    from repro_torch.cluster import ClusterRuntime, ClusterTxnService
    from repro_torch.cluster.service import serve_cluster
    from repro_torch.core import replication
    from repro_torch.core.fault import FaultInjector
    from repro_torch.db import tpcc
    from repro_torch.db.wal import Durability
    from repro_torch.kernels import _build
    from repro_torch.kernels.index_merge import ops as im_ops
    from repro_torch.kernels.index_merge.ref import index_merge_unsorted_plain
    from repro_torch.kernels.thomas_merge.ops import thomas_merge
    from repro_torch.kernels.thomas_merge.ref import thomas_merge_plain
    from repro_torch.reads.executor import SnapshotReadExecutor
    from repro_torch.service import AdmissionConfig, OpenLoopClient, TPCCSource
    t_set = time.perf_counter()
    cfg = tpcc.TPCCConfig(**spec["main"])
    state = tpcc.TPCCState(cfg)
    # the master holds the initial table and forms the batches
    init = (tpcc.init_values(cfg, np.random.default_rng(0), state=state)
            if rank == 0 else None)
    inj = FaultInjector()
    for node, ep, slab in spec["kills"]:
        inj.schedule_kill(node, epoch=ep, slab=slab)
    dur = Durability(Path(work) / "wal", n_workers=4,
                     checkpoint_every=spec["ckpt_every"], worker=rank)
    rt = ClusterRuntime(4, cfg.n_partitions, cfg.rows_per_partition,
                        init_val=init if rank == 0 else None,
                        indexes=tpcc.index_specs(cfg), max_rounds=MAX_ROUNDS,
                        n_slabs=CLUSTER_SLABS, injector=inj, durability=dur,
                        device=dev, distributed=True)
    eng = rt.eng
    # the first scatter-back merge and secondary-replay index_merge this
    # rank launches, recorded to hold against their plain versions
    rec = Recorder()
    flag = {"sec": False}
    orig_replay = replication.replay_partitioned

    def replay(*a, part_ids=None, **k):
        flag["sec"] = part_ids is not None
        try:
            return orig_replay(*a, part_ids=part_ids, **k)
        finally:
            flag["sec"] = False
    replication.replay_partitioned = replay
    rec._undo.append((replication, "replay_partitioned", orig_replay))
    rec.wrap(im_ops, "index_merge_cuda",
             lambda *a, **k: "sec_replay" if flag["sec"] else None)
    rec.wrap(replication, "thomas_apply",
             lambda *a, **k: "scatter_back")
    rows, digests, events = [], [], []
    bytes0 = dict(eng.net_bytes)
    first_read = {}

    def after(m):
        """Every rank, after each epoch (the master in step)."""
        nonlocal bytes0
        ok = rt.replica_consistent()
        check(ok, f"rank {rank}: replicas diverged at fence "
              f"{rt.committed_epoch}")
        digests.append(rank_digests(eng))
        nb = {k: eng.net_bytes[k] - bytes0[k] for k in bytes0}
        bytes0 = dict(eng.net_bytes)
        if len(digests) == 1:
            rec.restore()
        ev = m.get("recovery")
        if ev is not None:
            events.append({"epoch": ev.epoch, "failed": list(ev.failed),
                           "case": ev.case.name, "run_mode": ev.run_mode,
                           "t_recovery_s": ev.t_recovery_s,
                           "aborted_at_slab": ev.aborted_at_slab,
                           "slabs_discarded": ev.slabs_discarded,
                           "restored_from_secondary":
                           list(ev.restored_from_secondary),
                           "reloaded_from_disk": ev.reloaded_from_disk})
        rows.append({"epoch": len(digests),
                     "committed": m["committed_single"]
                     + m["committed_cross"],
                     "failure": ev is not None,
                     "half_write": len(digests) in spec["half_write"],
                     "t_part_s": m["t_part_s"], "t_sm_s": m["t_sm_s"],
                     "t_tail_ship_s": m["t_tail_ship_s"],
                     "t_allreduce_s": m["t_allreduce_s"],
                     "net_bytes": nb,
                     "collectives_in_partitioned_phase":
                     m["collectives_in_partitioned_phase"]})
    setup_s = time.perf_counter() - t_set
    dev_sync(dev)
    mark = launch_mark(dev)
    t_run = time.perf_counter()
    out = {"rank": rank, "setup_s": setup_s}
    if rank == 0:
        tier, lane, adm = lanes(cfg, rt)
        inputs, reads = [], []
        for ep in range(spec["epochs"]):
            b, offers = dist_inputs(cfg, state, spec, ep)
            inputs.append(pickle.dumps((b, offers)))
            m, got = lanes_epoch(dev, rt, tier, lane, adm, b, offers, after)
            tpcc.apply_consume_feedback(state, b, m)
            rows[-1].update(wall_s=got["t_epoch_s"],
                            t_mid_round_s=got["t_mid_s"],
                            mid_groups=got["mid_groups"],
                            t_stamp_s=got["t_stamp_s"],
                            t_fence_round_s=got["t_fence_s"],
                            fence_groups=got["fence_groups"])
            reads.append({"groups": got["groups"], "stamp": got["stamp"]})
        rt.stop_followers()
        out.update(reads=reads, remote=json.loads(json.dumps(
            rt.read_peers.stats)), fence_rounds=rt.read_peers.rounds, tier={
                f: getattr(tier.stats, f) for f in (
                    "served", "batches", "fallbacks", "stale_violations",
                    "replicas_removed", "max_freshness_served",
                    "mid_epoch_served", "mid_epoch_deferred")},
            by_replica=tier.catalog.serves_by_replica())
        with open(Path(work) / "inputs.pkl", "wb") as fh:
            pickle.dump(inputs, fh)
    else:
        host = eng._read_host()
        run = host.executor.run

        def recorded(snap, *args):
            res = run(snap, *args)
            if not first_read:
                first_read.update(
                    snap=to({k: v for k, v in snap.items() if k != "ready"},
                            "cpu"), args=args, out=to(res, "cpu"))
            return res
        host.executor.run = recorded
        rt.follow(after)
        host.executor.run = run
    run_s = time.perf_counter() - t_run
    launches = launches_since(dev, mark)
    rec.restore()
    # the recorded calls against their plain versions (not counted)
    plain = {}
    for key, (kernel, ref) in {"scatter_back": (thomas_merge,
                                                thomas_merge_plain),
                               "sec_replay": (im_ops.index_merge_cuda,
                                              index_merge_unsorted_plain)
                               }.items():
        if key not in rec.calls:
            continue
        args, kw = rec.calls[key]
        got = kernel(*to(args, dev), **kw)
        want = ref(*to(args, "cpu"), **kw)
        plain[key] = equal(got, want)
        check(plain[key], f"rank {rank}: the {key} kernel call differs "
              "from its plain version")
    if first_read:
        # the first group this rank served, on the plain scan_window
        want = SnapshotReadExecutor().run(first_read["snap"],
                                          *first_read["args"])
        plain["remote_read"] = equal(first_read["out"], want)
        check(plain["remote_read"], f"rank {rank}: its first read group "
              "differs from the plain executor's")
    host = eng.read_host
    out.update(run_s=run_s, rows=rows, events=events, launches=launches,
               launches_by_kernel=by_kernel(launches), plain_checks=plain,
               calls=dict(eng.comm.calls), digests=digests,
               node_committed=eng.node_committed.tolist(),
               partitioned_collectives=eng.partitioned_collectives,
               read_host={"groups": host.groups, "reads": host.reads,
                          "serve_s": host.serve_s,
                          "launches": dict(host.launches),
                          "ring": sorted(host.ring)} if host else None)

    # ---- the service with both lanes, node 2 killed
    inj.schedule_kill(2, epoch=rt.epoch + spec["service_kill_after"])
    svc_fig = {}

    def consistent(m):
        check(rt.replica_consistent(), f"rank {rank}: the service's copies "
              f"diverged at fence {rt.committed_epoch}")

    def make_service(runtime):
        fences = svc_fig["fences"] = {}
        run_epoch = runtime.run_epoch
        views = lane.views

        def fenced(batch, ingest=None):
            m = run_epoch(batch, ingest=ingest)
            consistent(m)
            stamp_e, aggs = views.latest()
            check(stamp_e == rt.committed_epoch, f"dist service: views "
                  f"stamped {stamp_e} at fence {rt.committed_epoch}")
            fences[stamp_e] = (aggs, rt.committed_state()[0].clone())
            return m
        runtime.run_epoch = fenced
        client = OpenLoopClient(TPCCSource(cfg, state=state, seed=2),
                                rate_txn_s=SERVICE_TPCC_RATE)
        svc_fig["client"] = client
        return ClusterTxnService(
            runtime, [client], AdmissionConfig(64, 64, node_queue_cap=96),
            slots_per_partition=SERVICE_SLOTS, master_lanes=SERVICE_LANES,
            feedback=lambda b, m: tpcc.apply_consume_feedback(state, b, m),
            read_tier=tier, analytics=lane)
    dev_sync(dev)
    if dev.type == "cuda":
        _build.reset_launch_counts()
    remote0 = json.loads(json.dumps(rt.read_peers.stats)) if rank == 0 \
        else None
    groups0 = eng.read_host.groups if eng.read_host else 0
    t0 = time.perf_counter()
    svc, summ = serve_cluster(rt, make_service, on_epoch=consistent,
                              duration_s=spec["service_s"])
    dev_sync(dev)
    svc_wall = time.perf_counter() - t0
    vars(rt).pop("run_epoch", None)
    check(rt.replica_consistent(), f"rank {rank}: the service's copies "
          "diverged")
    if svc is not None:
        svc_fig["client"].shutdown()
        svc_launches = (_build.launch_counts() if dev.type == "cuda"
                        else {})
        check(summ["recoveries"] == 1, f"dist service: "
              f"{summ['recoveries']} recoveries")
        check(sum(summ["node_committed"]) == rt.stats.committed_single,
              "dist service: node_committed does not sum to the committed "
              "single-partition transactions")
        check(tier.stats.stale_violations == 0, "dist service: stale reads")
        by = by_kernel(svc_launches)
        if dev.type == "cuda":
            for k in STAR_KERNELS:
                check(by[k] > 0, f"dist service: {k} never launched")
        for e, (aggs, val) in sorted(svc_fig["fences"].items()):
            want = lane.views.recompute(val)
            check(all(np.array_equal(aggs[k], want[k]) for k in want),
                  f"dist service: the views' stamp differs from recompute "
                  f"at fence {e}")
        ev = svc.recovery_events[0]
        out["service"] = {k: summ[k] for k in (
            "throughput_txn_s", "p50_ms", "p99_ms", "committed", "epochs",
            "offered", "admitted", "shed", "recoveries", "read_served",
            "read_p50_ms", "read_p99_ms", "read_stale_violations",
            "read_mid_epoch_served", "read_mid_epoch_deferred",
            "analytics_serves", "node_committed")}
        out["service"].update(
            duration_s=spec["service_s"], wall_s=svc_wall,
            kill={"node": 2, "epoch": ev.epoch, "case": ev.case.name,
                  "t_recovery_s": ev.t_recovery_s},
            fences_checked=len(svc_fig["fences"]),
            launches_by_kernel=by,
            remote={m: {k: v - remote0[m][k] for k, v in st.items()}
                    for m, st in rt.read_peers.stats.items()})
    host = eng.read_host
    out["service_host_groups"] = host.groups - groups0 if host else 0
    out.update(partitioned_collectives=eng.partitioned_collectives,
               wal_entries=dur.entries_logged)
    dur.close()
    return out


def dist_serve(rank, dev, spec):
    """Phase 15 (b) on one rank: Granite-3.0-1B-A400M with its experts over
    ``model`` = 4; a 2-layer float32 copy's logits against the same rank's
    single-process run, then the bf16 model at full width and depth
    generating ``batch`` x ``prompt`` + ``gen`` tokens."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine
    mesh = make_host_mesh(1, 4)
    cfg = get_arch(spec["arch"], smoke=spec["smoke"])
    gen = torch.Generator(device="cpu").manual_seed(11)
    out = {}
    # ---- 2 layers, float32: logits with and without the mesh
    pcfg = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    model = tf.LM(pcfg, seed=0, device=dev)
    toks = torch.randint(0, pcfg.vocab_size, (2, spec["parity_prompt"]),
                         generator=gen).to(dev)
    V = pcfg.vocab_size                       # past it: the -1e30 padding
    with torch.inference_mode():
        one = tf.forward(model, {"tokens": toks}, pcfg)[0][..., :V]
        tf.keep_local_experts(model, mesh)
        ep = tf.forward(model, {"tokens": toks}, pcfg, mesh=mesh)[0][..., :V]
    err = float((ep - one).abs().max() / one.abs().max())
    out["parity_f32_rel_err"] = err
    check(err <= TOL_DIST_F32, f"rank {rank}: 2-layer f32 logits with "
          f"experts over model = 4 differ from one process by {err:.3e}")
    del model, one, ep
    # ---- full width and depth, bf16
    t0 = time.perf_counter()
    model = tf.keep_local_experts(tf.LM(cfg, seed=0, device=dev), mesh)
    e_loc = model.layers[0].moe["w_up"].shape[0]
    check(e_loc == cfg.n_experts // 4, f"rank {rank}: holds {e_loc} experts")
    eng = ServeEngine(cfg, model, device=dev,
                      max_len=spec["prompt"] + spec["gen"], mesh=mesh)
    prompts = torch.randint(0, cfg.vocab_size, (spec["batch"],
                                                spec["prompt"]),
                            generator=gen).to(dev)
    eng.generate(prompts[:, :128], 4)                  # warm
    setup_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dev_sync(dev)
    mark = launch_mark(dev)
    s0 = dict(vars(eng.stats))
    t0 = time.perf_counter()
    toks_out = eng.generate(prompts, spec["gen"])
    wall = time.perf_counter() - t0
    launches = launches_since(dev, mark)
    st = {k: v - s0[k] for k, v in vars(eng.stats).items()}
    # every rank generated the same tokens
    every = [torch.empty_like(toks_out) for _ in range(4)]
    dist.all_gather(every, toks_out)
    same = all(torch.equal(t, toks_out) for t in every)
    check(same, f"rank {rank}: ranks generated different tokens")
    B, S, G = spec["batch"], spec["prompt"], spec["gen"]
    out.update(
        arch=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers, batch=B,
        prompt=S, gen=G, experts_per_rank=e_loc, setup_s=setup_s,
        wall_s=wall, prefill_s=st["prefill_s"],
        prefill_tokens_per_s=B * S / st["prefill_s"],
        decode_ms_per_step=st["decode_s"] / max(st["decode_steps"], 1) * 1e3,
        decode_tokens_per_s=B * G / st["decode_s"],
        tokens_equal_across_ranks=same, launches=launches,
        peak_mem_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                     if dev.type == "cuda" else None))
    del eng, model
    return out


def dist_train(rank, dev, spec):
    """Phase 15 (c) on one rank: a bf16 ``Trainer`` at full width (depth
    cut to ``spec["train_layers"]``) on mesh (data 2, model 2), then
    ``reshard`` to (4, 1) and further steps: the state bit-equal across the
    reshard, the loss finite and falling."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def whole(tr):
        """The state, whole, as copies on the device."""
        p, o = tr.state()
        return [p[k].detach().clone() for k in sorted(p)] + [
            o[s][k].clone() for s in ("master", "m", "v") for k in sorted(o[s])]

    cfg = dataclasses.replace(get_arch(spec["arch"], smoke=spec["smoke"]),
                              n_layers=spec["train_layers"])
    t0 = time.perf_counter()
    tr = Trainer(cfg, TrainerConfig(
        seq_len=spec["train_seq"], batch=spec["train_batch"],
        steps_per_epoch=TRAIN_EPOCH,
        hp=AdamWConfig(lr=spec["train_lr"], warmup_steps=1)),
        device=dev, mesh=make_host_mesh(2, 2))
    setup_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mark = launch_mark(dev)
    free = []
    steps = []
    for shape, n in ((None, spec["train_steps"][0]),
                     ((4, 1), spec["train_steps"][1])):
        reshard = None
        if shape is not None:
            before = whole(tr)
            t1 = time.perf_counter()
            tr.reshard(make_host_mesh(*shape))
            dev_sync(dev)
            reshard_s = time.perf_counter() - t1
            same = all(x.dtype == y.dtype and torch.equal(x, y)
                       for x, y in zip(before, whole(tr)))
            del before
            check(same, f"rank {rank}: the state changed across the "
                  "reshard")
            reshard = {"to": list(shape), "s": reshard_s, "bit_equal": same}
        for _ in range(n):
            tr.run(1)
            if dev.type == "cuda":
                free.append(torch.cuda.mem_get_info(dev)[0])
        steps.append({"mesh": list(tr.mesh.shape.values()),
                      "reshard": reshard})
    launches = launches_since(dev, mark)
    losses = [m["loss"] for m in tr.metrics_history]
    step_s = [m["step_s"] for m in tr.metrics_history]
    check(all(x == x and abs(x) != float("inf") for x in losses),
          f"rank {rank}: a non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"rank {rank}: the loss did not fall "
          f"({losses})")
    return {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
            "batch": spec["train_batch"], "seq": spec["train_seq"],
            "setup_s": setup_s, "losses": losses,
            "step_ms": [t * 1e3 for t in step_s], "meshes": steps,
            "launches": launches,
            "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                            if dev.type == "cuda" else None),
            "min_free_gb": min(free) / 1e9 if free else None}


def dist_rank(rank, world, dev, spec, work):
    """One rank of phase 15: (a), then (b), then (c); a failed check
    raises, which fails the phase."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if spec["need_cuda"] and dev.type != "cuda":
        raise RuntimeError(f"rank {rank}: no card")
    out = {"cluster": dist_cluster(rank, dev, spec, work)}
    if rank == 0:
        (Path(work) / "cluster_done").touch()
    out["serve"] = dist_serve(rank, dev, spec)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["train"] = dist_train(rank, dev, spec)
    return out


def dist_reference(dev, spec, work):
    """The single-process ``ClusterRuntime`` on ``dev`` with phase 15 (a)'s
    kills, its own WAL and both lanes, fed the batches and read offers the
    master ran: after each epoch, each node's :func:`single_digests`, and
    the epoch's read groups and views' stamp, digested."""
    import pickle
    import numpy as np
    from repro_torch.cluster import ClusterRuntime
    from repro_torch.core.fault import FaultInjector
    from repro_torch.db import tpcc
    from repro_torch.db.wal import Durability
    cfg = tpcc.TPCCConfig(**spec["main"])
    state = tpcc.TPCCState(cfg)
    init = tpcc.init_values(cfg, np.random.default_rng(0), state=state)
    inj = FaultInjector()
    for node, ep, slab in spec["kills"]:
        inj.schedule_kill(node, epoch=ep, slab=slab)
    dur = Durability(Path(work) / "wal_reference", n_workers=4,
                     checkpoint_every=spec["ckpt_every"])
    rt = ClusterRuntime(4, cfg.n_partitions, cfg.rows_per_partition,
                        init_val=init, indexes=tpcc.index_specs(cfg),
                        max_rounds=MAX_ROUNDS, n_slabs=CLUSTER_SLABS,
                        injector=inj, durability=dur, device=dev)
    tier, lane, adm = lanes(cfg, rt)
    with open(Path(work) / "inputs.pkl", "rb") as fh:
        inputs = [pickle.loads(x) for x in pickle.load(fh)]
    digests, reads = [], []
    for b, offers in inputs:
        _, got = lanes_epoch(dev, rt, tier, lane, adm, b, offers)
        digests.append([single_digests(rt.eng, r) for r in range(4)])
        reads.append({"groups": got["groups"], "stamp": got["stamp"]})
    dur.close()
    return digests, reads


def dryrun_phase(dev, train):
    """The dry run (``launch/dryrun.py``) of every config x ``SHAPES`` cell
    on both production meshes, with this card's memory as the fit limit;
    ``train`` is phase 11's figures, whose trainer's bytes were held to
    the dry run's at phase 11's own cell.  Returns the ``dryrun``
    figures."""
    import torch
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    limit = torch.cuda.get_device_properties(dev).total_memory
    check(limit == dryrun.FIT_LIMIT_BYTES, f"dryrun: the card has {limit} "
          f"bytes, FIT_LIMIT_BYTES says {dryrun.FIT_LIMIT_BYTES}")
    recs = dryrun.run_all(meshes=(False, True), echo=lambda line: None)
    ok = [r for r in recs if r["status"] == "ok"]
    check(len(recs) == 80 and len(ok) == 64, f"dryrun: {len(recs)} records, "
          f"{len(ok)} applicable")
    by_mesh = {}
    for r in ok:
        m = by_mesh.setdefault("pod2x16x16" if r["multi_pod"] else
                               "pod16x16", {"max_held_bytes": 0})
        if r["mem"]["held_bytes"] > m["max_held_bytes"]:
            m.update(max_held_bytes=r["mem"]["held_bytes"],
                     at=f"{r['arch']} x {r['shape']}")
    fig = {"records": len(recs), "applicable": len(ok),
           "skipped": len(recs) - len(ok), "limit_bytes": limit,
           "fit": sum(r["mem"]["fits"] for r in ok),
           "fit_whole_params": sum(r["mem"]["fits_whole_params"]
                                   for r in ok),
           "fit_only_with_split": sorted({
               f"{r['arch']} x {r['shape']}" for r in ok
               if r["mem"]["fits"] and not r["mem"]["fits_whole_params"]}),
           "by_mesh": by_mesh,
           "bottleneck": {b: sum(r["roofline"]["bottleneck"] == b
                                 for r in ok) for b in ("compute", "memory")},
           "phase11_trainer": train["dryrun_bytes"],
           "wall_s": time.perf_counter() - t0}
    print(f"dryrun: {fig['records']} cells, {fig['applicable']} applicable, "
          f"{fig['fit']} fit in {limit} bytes ({fig['fit_whole_params']} "
          f"with every parameter whole; only with the split: "
          f"{fig['fit_only_with_split']}); phase 11's trainer bytes equal "
          f"the dry run's: {fig['phase11_trainer']['equal']}")
    return fig


def dist_phase(dev, kernels, spec=None):
    """Phase 15: 4 processes on the one card, gloo over CUDA tensors
    (``launch.mesh``'s rule: NCCL refuses two ranks on one GPU), the
    kernels built by the parent before the spawn.  (a) the STAR cluster
    with one process a node, bit-equal to the single-process engine on
    the card; (b) Granite-3.0-1B-A400M served with experts over model =
    4; (c) a bf16 training step on (data 2, model 2), reshard to (4, 1),
    further steps.  Returns the ``dist_path`` figures; each kernel row
    gains ``dist_launches`` (by rank and sub-phase)."""
    import tempfile
    import threading
    import torch
    from repro_torch.launch.mesh import spawn
    spec = dict(DIST_SPEC if spec is None else spec)
    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory()
    work = Path(tmp.name)
    box = {}

    def ranks():
        try:
            box["res"] = spawn(dist_rank, 4, args=(spec, str(work)),
                               device=dev.type, timeout_s=spec["deadline_s"],
                               workdir=work / "spawn", threads=2)
        except BaseException as e:         # re-raised below
            box["err"] = e

    th = threading.Thread(target=ranks)
    th.start()
    ref = None
    try:
        # the reference runs while the ranks serve and train, so that it
        # does not share the card with the cluster's timed epochs
        while th.is_alive() and not (work / "cluster_done").exists():
            time.sleep(0.2)
        if (work / "cluster_done").exists():
            t0 = time.perf_counter()
            ref, ref_reads = dist_reference(dev, spec, work)
            ref_s = time.perf_counter() - t0
    finally:
        th.join()
    if "err" in box:
        raise box["err"]
    res = box["res"]
    a = [r["cluster"] for r in res]
    got = [[r["digests"][e] for r in a] for e in range(spec["epochs"])]
    check(ref is not None and ref == got, "phase 15: the cluster's copies "
          "differ from the single-process engine's after epochs "
          f"{[e + 1 for e, (x, y) in enumerate(zip(ref or [], got)) if x != y]}")
    reads = a[0]["reads"]
    bad = [e + 1 for e, (x, y) in enumerate(zip(ref_reads, reads))
           if x != y]
    check(len(reads) == len(ref_reads) and not bad, "phase 15: the read "
          f"groups or views' stamps differ from one process's at epochs "
          f"{bad}")
    for r in a:
        check(all(x["collectives_in_partitioned_phase"] == 0
                  for x in r["rows"]) and r["partitioned_collectives"] == 0,
              f"rank {r['rank']}: a collective in a partitioned phase")
        need = STAR_KERNELS if r["rank"] == 0 else ("scan_window",
                                                     "index_merge",
                                                     "thomas_merge")
        for k in need:
            check(r["launches_by_kernel"][k] > 0, f"rank {r['rank']}: {k} "
                  "never launched in the cluster run")
        check(r["plain_checks"].get("scatter_back") is True,
              f"rank {r['rank']}: no scatter-back merge held to its plain "
              "version")
        host = r["read_host"]
        if host is not None and host["groups"]:
            check(host["launches"].get("scan_window", 0) > 0
                  and r["plain_checks"].get("remote_read") is True,
                  f"rank {r['rank']}: its read groups launched no "
                  "scan_window or differ from the plain executor's")
    remote = a[0]["remote"]
    served_remote = sum(r["read_host"]["groups"] for r in a[1:])
    check(served_remote > 0 and remote["mid_epoch"]["groups"] > 0
          and served_remote == remote["fence"]["groups"]
          + remote["mid_epoch"]["groups"], "phase 15: the other ranks "
          f"served {served_remote} groups, the master sent {remote}")
    check(a[0]["tier"]["stale_violations"] == 0, "phase 15: stale reads")
    want = [c for c in spec["want_cases"]]
    got = [e["case"] for e in a[0]["events"]]
    check(got == want, f"phase 15: recovery cases {got}, expected {want}")
    ok_rows = [x for x in a[0]["rows"][1:] if not x["failure"]
               and not x["half_write"]]
    committed = sum(x["committed"] for x in ok_rows)
    wall = sum(x["wall_s"] for x in ok_rows)
    mean = lambda k: statistics.mean(x[k] for x in ok_rows)
    per_epoch_bytes = {k: statistics.mean(x["net_bytes"][k] for x in ok_rows)
                       for k in ok_rows[0]["net_bytes"]}
    rows0 = a[0]["rows"]
    mid = [x for x in rows0 if x["mid_groups"]]
    lanes_fig = {
        "tier": a[0]["tier"], "by_replica": a[0]["by_replica"],
        "remote": remote, "fence_rounds_opened": a[0]["fence_rounds"],
        "groups_by_rank": {r["rank"]: r["read_host"]["groups"]
                           for r in a[1:]},
        "read_lane_launches_by_rank": {r["rank"]: r["read_host"]["launches"]
                                       for r in a[1:]},
        "fence_round_ms": [x["t_fence_round_s"] * 1e3 for x in rows0],
        "fence_round_groups": [x["fence_groups"] for x in rows0],
        "stamp_ms": [x["t_stamp_s"] * 1e3 for x in rows0],
        "mid_epoch_round_ms": [x["t_mid_round_s"] * 1e3 for x in rows0],
        "mid_epoch_groups": [x["mid_groups"] for x in rows0],
        "fence_round_ms_mean": mean("t_fence_round_s") * 1e3,
        "mid_epoch_round_ms_serving": [x["t_mid_round_s"] * 1e3
                                       for x in mid],
        "groups_equal_epochs": len(ref_reads)}
    cluster = {
        "config": "phase 10's: TPC-C full mix, P=16 at the spec's widths",
        "nodes": 4, "processes": 4, "txns_per_epoch": spec["txns"],
        "epochs": spec["epochs"], "kills": spec["kills"],
        "half_write_epochs": spec["half_write"],
        "measured_epochs": [x["epoch"] for x in ok_rows],
        "committed_txn_per_s": committed / wall,
        "epoch_wall_s": [x["wall_s"] for x in rows0],
        "t_part_s_mean": mean("t_part_s"), "t_sm_s_mean": mean("t_sm_s"),
        "fence_tail_ship_ms_mean": mean("t_tail_ship_s") * 1e3,
        "fence_allreduce_ms_mean": mean("t_allreduce_s") * 1e3,
        "net_bytes_per_epoch": per_epoch_bytes,
        "recoveries": a[0]["events"], "lanes": lanes_fig,
        "service": a[0]["service"],
        "bit_equal_epochs": len(ref), "reference_s": ref_s,
        "launches_by_rank": {r["rank"]: r["launches_by_kernel"] for r in a},
        "calls_by_rank": {r["rank"]: r["calls"] for r in a},
        "node_committed": a[0]["node_committed"],
        "setup_s": a[0]["setup_s"], "run_s": a[0]["run_s"]}
    print(f"dist cluster: 4 processes, both lanes, {committed} committed in "
          f"{wall:.3f} s over epochs {cluster['measured_epochs']}: "
          f"{cluster['committed_txn_per_s']:.2f} txn/s; fence: tail ship "
          f"{cluster['fence_tail_ship_ms_mean']:.3f} ms, all_reduce "
          f"{cluster['fence_allreduce_ms_mean']:.3f} ms; bytes an epoch "
          f"{per_epoch_bytes}; copies, read groups and stamps bit-equal to "
          f"one process over {len(ref)} epochs")
    print(f"dist cluster reads: {a[0]['tier']}, by replica "
          f"{a[0]['by_replica']}; groups served by rank "
          f"{lanes_fig['groups_by_rank']}, their launches "
          f"{lanes_fig['read_lane_launches_by_rank']}; remote {remote}")
    print(f"dist cluster read rounds: fence ms "
          f"{[round(x, 3) for x in lanes_fig['fence_round_ms']]} (groups "
          f"{lanes_fig['fence_round_groups']}), mid-epoch ms "
          f"{[round(x, 3) for x in lanes_fig['mid_epoch_round_ms']]} "
          f"(groups {lanes_fig['mid_epoch_groups']})")
    for e in a[0]["events"]:
        print(f"dist cluster recovery: epoch {e['epoch']} nodes "
              f"{e['failed']} {e['case']} t_recovery_s "
              f"{e['t_recovery_s']:.4f}")
    for r in a:
        print(f"dist cluster rank {r['rank']} launches: "
              f"{r['launches_by_kernel']}")
    svc = a[0]["service"]
    print(f"dist service: {svc['throughput_txn_s']:.1f} txn/s p50 "
          f"{svc['p50_ms']:.2f} p99 {svc['p99_ms']:.2f} ms, "
          f"{svc['committed']} committed in {svc['epochs']} epochs, "
          f"{svc['read_served']} reads ({svc['read_mid_epoch_served']} "
          f"mid-epoch), {svc['analytics_serves']} analytics rounds, "
          f"recovery {svc['kill']}, stamps checked at "
          f"{svc['fences_checked']} fences; remote {svc['remote']}")
    b = [r["serve"] for r in res]
    serve = dict(b[0], launches_by_rank={i: x["launches"]
                                         for i, x in enumerate(b)},
                 parity_f32_rel_err_by_rank=[x["parity_f32_rel_err"]
                                             for x in b])
    serve.pop("launches")
    print(f"dist serve: {serve['arch']} bf16 experts over model=4 "
          f"({serve['experts_per_rank']} a rank): prefill "
          f"{serve['prefill_s']:.3f} s, decode "
          f"{serve['decode_ms_per_step']:.2f} ms/step, 2-layer f32 rel err "
          f"{max(serve['parity_f32_rel_err_by_rank']):.3e}; launches "
          f"{serve['launches_by_rank']}")
    c = [r["train"] for r in res]
    train = dict(c[0], launches_by_rank={i: x["launches"]
                                         for i, x in enumerate(c)},
                 peak_mem_gb_by_rank=[x["peak_mem_gb"] for x in c],
                 min_free_gb=min((x["min_free_gb"] for x in c
                                  if x["min_free_gb"] is not None),
                                 default=None))
    train.pop("launches")
    if dev.type == "cuda":
        check(train["min_free_gb"] >= 8.0, f"phase 15 train: "
              f"{train['min_free_gb']:.1f} GB left free")
    print(f"dist train: {train['arch']} {train['layers']} layers bf16 on "
          f"{[s['mesh'] for s in train['meshes']]}: losses "
          f"{[round(x, 4) for x in train['losses']]}, step ms "
          f"{[round(x, 1) for x in train['step_ms']]}, reshard "
          f"{train['meshes'][1]['reshard']}, min free "
          f"{train['min_free_gb']} GB")
    for k, row in kernels.items():
        row["dist_launches"] = {
            part: {i: by_row(x["launches"], kernels)[k]
                   for i, x in enumerate(xs)}
            for part, xs in (("cluster", a), ("serve", b), ("train", c))}
        if k in STAR_KERNELS:
            # of the cluster's: the read lane's groups each rank served
            row["dist_launches"]["read_lane"] = {
                r["rank"]: r["read_host"]["launches"].get(k, 0)
                for r in a[1:]}
    for part, xs, need in (("serve", b, ("rmsnorm", "flash_attention")),
                           ("train", c, ("rmsnorm", "flash_attention",
                                         "rmsnorm.backward",
                                         "flash_attention.backward"))):
        for i, x in enumerate(xs):
            for k in need:
                if k in kernels:
                    check(by_row(x["launches"], kernels)[k] > 0,
                          f"phase 15 {part}: rank {i} never launched {k}")
    tmp.cleanup()
    fig = {"processes": 4, "backend": "gloo (CUDA tensors, one card)",
           "cluster": cluster, "serve": serve, "train": train,
           "wall_s": time.perf_counter() - t_phase}
    print(f"dist path: {fig['wall_s']:.1f} s")
    return fig


def by_row(counts, rows):
    """Launch counts by kernel row: a launch configuration
    (``<name>.<config>``) counts for its kernel's row unless it is a row
    of its own (the backward kernels)."""
    return {k: sum(n for c, n in counts.items()
                   if c == k or (c.startswith(k + ".") and c not in rows))
            for k in rows}


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if argv[:1] == ["--ab-side"] and len(argv) == 2:
        root = Path(argv[1]).resolve()
    elif argv[:1] in (["--ab"], ["--lanes"]) and len(argv) == 2:
        pass
    elif argv == ["--dist"]:
        pass
    elif argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    if argv[:1] == ["--ab"]:
        return ab(root, Path(argv[1]).resolve())
    sys.path.insert(0, str(root / "src"))
    if argv[:1] == ["--lanes"]:
        return lanes_ab(torch.device("cuda", 0), int(argv[1]))
    if argv == ["--dist"]:
        return dist_alone(torch.device("cuda", 0))
    if argv:
        ab_side(root, torch.device("cuda", 0))
        return 0
    return run(torch.device("cuda", 0))


def dist_alone(dev):
    """``--dist``: phase 15 alone (the kernels built first), its figures
    on one line."""
    import torch
    from repro_torch.kernels import _build
    _build.build_all()
    print(nvidia_smi())
    rows = {k: {} for k in STAR_KERNELS + (
        "rmsnorm", "flash_attention", "rmsnorm.backward",
        "flash_attention.backward")}
    fig = dist_phase(dev, rows)
    fig["device"] = torch.cuda.get_device_name(0)
    print(json.dumps({"dist_path": fig, "dist_launches": {
        k: r["dist_launches"] for k, r in rows.items()}}))
    return 0


def launch_floor(dev):
    """The card's time for the least kernel, a one-element ``fill_``: (ms
    a launch by torch.profiler, ms by CUDA events as :func:`cuda_ms`
    times every kernel here)."""
    import torch
    x = torch.zeros(1, device=dev)

    def fill():
        x.fill_(1.0)
    return prof_ms(fill, reps=200)[0], cuda_ms(fill)


def run(dev):
    import torch
    from repro_torch.kernels import _build

    name = torch.cuda.get_device_name(0)
    # float32 stays float32 on the card (the plain versions' products)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # ---- 1. build + device ----------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {len(_build.SOURCES)} CUDA sources in "
          f"{time.perf_counter() - t0:.1f} s")
    smi = nvidia_smi()
    print(smi)

    floor, floor_ev = launch_floor(dev)
    print(f"launch floor: a one-element fill_ kernel takes {floor:.6f} ms "
          f"(torch.profiler), {floor_ev:.6f} ms (CUDA events)")
    kernels, main_path = star_phases(dev)
    main_path.update(device=name, nvidia_smi=smi, launch_floor_prof_ms=floor,
                     launch_floor_events_ms=floor_ev)
    torch.cuda.empty_cache()
    service, svc_launches = service_path(dev)
    service.update(device=name, nvidia_smi=smi)
    for k, row in kernels.items():
        row["service_launches"] = {r: n[k] for r, n in svc_launches.items()}
    torch.cuda.empty_cache()
    reads = read_path(dev, kernels)
    reads.update(device=name, nvidia_smi=smi)
    cluster = cluster_path(dev, kernels)
    cluster.update(device=name, nvidia_smi=smi)
    lm_rows, serve = serve_path(dev)
    lm_rows["rmsnorm"]["decode"].update(launch_floor_prof_ms=floor,
                                        launch_floor_events_ms=floor_ev)
    kernels.update(lm_rows)
    serve.update(device=name, nvidia_smi=smi)
    torch.cuda.empty_cache()
    configs = serve_configs_phase(dev, kernels)
    configs.update(device=name, nvidia_smi=smi)
    train = train_phase(dev, kernels)
    train.update(device=name, nvidia_smi=smi)
    dry = dryrun_phase(dev, train)
    dry.update(device=name, nvidia_smi=smi)
    hymba = hymba_train_phase(dev, kernels)
    hymba.update(device=name, nvidia_smi=smi)
    frontends = mla_frontends_phase(dev, kernels)
    frontends.update(device=name, nvidia_smi=smi)
    dist = dist_phase(dev, kernels)
    dist.update(device=name, nvidia_smi=smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"main_path": main_path}))
    print(json.dumps({"service_path": service}))
    print(json.dumps({"read_path": reads}))
    print(json.dumps({"cluster_path": cluster}))
    print(json.dumps({"serve_path": serve}))
    print(json.dumps({"serve_configs": configs}))
    print(json.dumps({"train_path": train}))
    print(json.dumps({"dryrun": dry}))
    print(json.dumps({"train_path_hymba": hymba}))
    print(json.dumps({"mla_frontends": frontends}))
    print(json.dumps({"dist_path": dist}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def star_phases(dev):
    """Phases 2-4 (the STAR epoch).  Returns (kernel rows, main-path
    figures)."""
    from repro_torch.db import tpcc

    # ---- 2. kernels at main-path shapes ---------------------------------
    t0 = time.perf_counter()
    cfg, state, eng = mk_engine(MAIN, 0, dev)
    print(f"main path: P={cfg.n_partitions} rows/partition="
          f"{cfg.rows_per_partition} index cap={cfg.index_capacity}")
    batches = [tpcc.make_batch(cfg, state, MAIN_TXNS, seed=1000)]
    m, calls = record_warm_epoch(eng, batches[0])
    tpcc.apply_consume_feedback(state, batches[0], m)
    check(eng.replica_consistent(), "warm epoch: replica diverged")
    print(f"warm epoch: committed {m['committed_single']}+"
          f"{m['committed_cross']} in {time.perf_counter() - t0:.1f} s "
          f"(set-up included)")
    kernels = kernel_checks(calls, dev)
    del calls
    print("kernel parity: all bit-equal")

    # ---- 3. engine parity, card vs CPU ----------------------------------
    sides = [mk_engine(FIG11, 0, d) for d in (dev, "cpu")]
    for ep in range(FIG11_EPOCHS):
        ms = []
        for c, st, e in sides:
            b = tpcc.make_batch(c, st, FIG11_TXNS, seed=ep)
            ms.append(e.run_epoch(b))
            tpcc.apply_consume_feedback(st, b, ms[-1])
        (_, _, g), (_, _, h) = sides
        check(same_store(g.store, h.store)
              and same_store(g.replica_store, h.replica_store),
              f"engine parity: card and CPU differ after epoch {ep}")
        check(g.replica_consistent() and h.replica_consistent(),
              f"engine parity: replica diverged at epoch {ep}")
        check(ms[0]["committed_cross"] == ms[1]["committed_cross"],
              "engine parity: commit counts differ")
    print(f"engine parity: {FIG11_EPOCHS} epochs of the fig11 full mix "
          f"bit-equal on the card and the CPU")
    del sides

    # ---- 4. the main path, measured ---------------------------------------
    for ep in range(MAIN_EPOCHS):
        batches.append(tpcc.make_batch(cfg, state, MAIN_TXNS, seed=ep))
    counts, figures = measure_epochs(eng, cfg, state, batches[1:])
    check(figures["lock_arrays_checked"] > 0, "main path: no lock array "
          "reached occ_round")
    for k, row in kernels.items():
        # a kernel's launch configurations count as "<name>.<config>"
        row["launches"] = sum(n for c, n in counts.items()
                              if c == k or c.startswith(k + "."))
        check(row["launches"] > 0, f"main path never launched {k}")
    sw = kernels["scan_window"]
    sw["launches_by_config"] = {c: counts.get(c, 0) for c in (
        "scan_window.partitioned", "scan_window.single_master",
        "scan_window")}
    for c in ("scan_window.partitioned", "scan_window.single_master"):
        check(counts.get(c, 0) > 0, f"main path never launched {c}")
    return kernels, figures


def measure_epochs(eng, cfg, state, batches):
    """Phase 4's measurement: ``batches`` run as epochs, with
    ``replica_consistent()`` at every fence and every lock array the
    executor hands to ``occ_round`` all B after them, then one more epoch
    under torch.profiler.  Returns (the kernels' launch counts over the
    measured epochs, main-path figures)."""
    import torch
    from repro_torch.core import single_master
    from repro_torch.db import tpcc
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    base = {f: getattr(eng.stats, f) for f in
            ("committed_cross", "index_overflow", "consume_skips", "retries",
             "fence_time_s")}

    def measured(f):
        """A stats counter over the measured epochs only."""
        return getattr(eng.stats, f) - base[f]
    # keep the lock arrays the executor hands to occ_round (a tree whose
    # round takes none hands none): each must be all B after the epochs
    held = {}
    orig = single_master.occ_round

    def keep(*a, **k):
        for t in (k.get("lock"), k.get("rlock")):
            if t is not None:
                held[t.data_ptr()] = (t, a[2].shape[0])
        return orig(*a, **k)
    single_master.occ_round = keep
    _build.reset_launch_counts()
    rows = []
    try:
        for b in batches:
            t0 = time.perf_counter()
            m = eng.run_epoch(b)
            wall = time.perf_counter() - t0
            ok = eng.replica_consistent()
            tpcc.apply_consume_feedback(state, b, m)
            rows.append((m, wall, ok))
            print(f"epoch {eng.epoch - 1}: committed "
                  f"{m['committed_single']}+{m['committed_cross']} "
                  f"t_part={m['t_part_s']:.4f}s t_sm={m['t_sm_s']:.4f}s "
                  f"wall={wall:.4f}s index_overflow={m['index_overflow']} "
                  f"consume_skips={measured('consume_skips')} replica={ok}")
            check(ok, "main path: replica diverged at a fence")
    finally:
        single_master.occ_round = orig
    counts = _build.launch_counts()
    n_locks = len(held)
    for t, B in held.values():
        check(bool((t == B).all()), "main path: a lock array is not all B "
              "after the measured epochs")
    del held
    check(measured("committed_cross") > 0, "main path: no cross commit")
    totals = {f: measured(f) for f in base}
    prof = profile_epoch(eng, cfg, state)
    committed = sum(m["committed_single"] + m["committed_cross"]
                    for m, _, _ in rows)
    wall = sum(w for _, w, _ in rows)
    return counts, {
        "epochs": len(batches), "txns_per_epoch": MAIN_TXNS,
        "committed": committed, "committed_txn_per_s": committed / wall,
        "t_part_s": sum(m["t_part_s"] for m, _, _ in rows),
        "t_sm_s": sum(m["t_sm_s"] for m, _, _ in rows),
        "t_fence_s": totals["fence_time_s"], "wall_s": wall,
        "epoch_walls": [w for _, w, _ in rows],
        "index_overflow": totals["index_overflow"],
        "consume_skips": totals["consume_skips"],
        "retries": totals["retries"], "profiled_epoch": prof,
        "lock_arrays_checked": n_locks}


# ---------------------------------------------------------------------------
# --lanes: phase 8's TPC-C service without and with phase 9's lanes
# ---------------------------------------------------------------------------
def tpcc_service(dev, lanes):
    """Phase 8's TPC-C service run on a fresh engine, without or (``lanes``)
    with the read tier and the analytics lane of phase 9, and with no
    check inside the run.  Returns its figures."""
    import torch
    from repro_torch.changelog import AnalyticsLane
    from repro_torch.db import tpcc
    from repro_torch.reads import ReadTier
    from repro_torch.service import (AdmissionConfig, OpenLoopClient,
                                     TPCCSource, TxnService)
    cfg, state, eng = mk_engine(MAIN, 0, dev)
    kw = {}
    if lanes:
        kw = dict(read_tier=ReadTier(max_staleness_epochs=READ_K,
                                     sec_refresh_every=READ_REFRESH),
                  analytics=AnalyticsLane(cfg))
    client = OpenLoopClient(TPCCSource(cfg, state=state, seed=2),
                            rate_txn_s=SERVICE_TPCC_RATE)
    svc = TxnService(eng, [client], AdmissionConfig(256, 512, "shed"),
                     slots_per_partition=SERVICE_SLOTS,
                     master_lanes=SERVICE_LANES,
                     feedback=lambda b, m: tpcc.apply_consume_feedback(
                         state, b, m), **kw)
    split = ("part_time_s", "sm_time_s", "fence_time_s", "epochs")
    stats0 = {f: getattr(eng.stats, f) for f in split}
    torch.cuda.synchronize()
    out = svc.run(duration_s=SERVICE_TPCC_S)
    client.shutdown()
    check(eng.replica_consistent(), "--lanes: replica diverged")
    fig = {k: out.get(k) for k in (
        "throughput_txn_s", "p50_ms", "p99_ms", "committed", "epochs",
        "epoch_time_s", "ingest_overlap_s", "read_served",
        "read_serve_time_s", "read_p50_ms", "read_p99_ms")}
    fig.update(lanes=lanes, engine_split={
        f: getattr(eng.stats, f) - stats0[f] for f in split})
    del svc, eng
    torch.cuda.empty_cache()
    return fig


def lanes_ab(dev, n):
    """``--lanes N``: ``tpcc_service`` in N pairs in one process, without
    and with the lanes, the order alternating (off, on, on, off, ...), so
    that drift of the card or the host shows in the spread.  Prints the
    card's name and power limit, then one ``LANES {...}`` line a run."""
    from repro_torch.kernels import _build
    _build.build_all()
    print(nvidia_smi(), flush=True)
    tpcc_service(dev, True)                  # untimed: first launches
    for i in range(n):
        for lanes in ((False, True) if i % 2 == 0 else (True, False)):
            print("LANES " + json.dumps(tpcc_service(dev, lanes)),
                  flush=True)
    return 0


# ---------------------------------------------------------------------------
# --ab: two checkouts compared on one card in one call
# ---------------------------------------------------------------------------
def ab(root, parent):
    """Runs ``--ab-side`` on the parent's tree and this one, parent,
    change, change, parent, one process each, so that drift of the card
    or the host during the call shows in the spread."""
    print(nvidia_smi(), flush=True)
    for tree in (parent, root, root, parent):
        r = subprocess.run([sys.executable, __file__, "--ab-side",
                            str(tree)])
        if r.returncode:
            return r.returncode
    return 0


def occ_calls(calls, dev):
    """The probe (both phases) and the OCC round through the executors'
    wrappers on their recorded arguments, whatever kernels each tree's
    wrapper launches: device time, kernels, aten operators, host time."""
    from repro_torch.core import partitioned, single_master
    out = {}
    for key, fn in (("step_index_ops", partitioned.step_index_ops),
                    ("locate_index_ops", single_master.locate_index_ops),
                    ("occ_round", single_master.occ_round)):
        args, kw = calls[key]
        a, k = to(args, dev), to(kw, dev)
        out[key] = call_figures(lambda: fn(*a, **k))
    return out


def ab_side(tree, dev):
    """One side of ``--ab``, with this script's phases and the kernels of
    ``tree``'s ``src/repro_torch``: the STAR main path's measured epochs
    and profiled epoch (phase 4, after one untimed epoch whose probe and
    round calls are recorded), the probe and the round on those calls
    (:func:`occ_calls`) and ``thomas_apply_batch`` on the warm epoch's
    single-master log, the serve path's generate (``SERVE_RUNS`` timed
    after one untimed: prefill s and decode ms a step), the SSD kernel
    alone on the arguments that prefill
    gave it, and rmsnorm on its recorded prefill and decode calls, in
    the decode chain of :func:`norm_chain` and at RMS_AB_ROWS rows; and
    both backward kernels at the train path's shapes
    (:func:`train_backward_calls`), the SSD backward
    (:func:`ssd_backward_calls`) and the bf16 flash prefill at every head
    dim pair (:func:`flash_prefill_calls`).  Prints one ``AB {...}`` JSON
    line."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core import replication
    from repro_torch.db import tpcc
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba2_ssd.ops import ssd
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import ServeEngine, ServeStats
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg, state, eng = mk_engine(MAIN, 0, dev)
    b = tpcc.make_batch(cfg, state, MAIN_TXNS, seed=1000)
    rec = Recorder()
    wrap_occ(rec)
    rec.wrap(replication, "thomas_apply_batch",
             lambda *a, **k: "thomas_apply_batch")
    try:
        m = eng.run_epoch(b)
    finally:
        rec.restore()
    tpcc.apply_consume_feedback(state, b, m)
    batches = [tpcc.make_batch(cfg, state, MAIN_TXNS, seed=ep)
               for ep in range(MAIN_EPOCHS)]
    _, out = measure_epochs(eng, cfg, state, batches)
    del eng, state
    out.update(occ_calls(rec.calls, dev))
    args, _ = rec.calls["thomas_apply_batch"]
    val, tidw, log = to(args, dev)
    tid0 = tidw.clone()
    out["thomas_apply_batch"] = call_figures(
        lambda: replication.thomas_apply_batch(val, tidw, log),
        setup=lambda: tidw.copy_(tid0))
    del rec, val, tidw, log
    torch.cuda.empty_cache()
    c = get_arch(SERVE_ARCH)
    se = ServeEngine(c, LM(c, seed=0, device=dev), device=dev,
                     max_len=SERVE_PROMPT + SERVE_GEN)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, c.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev, dtype=torch.int32)
    calls = record_generate(se, prompts, 2)
    args, kw = calls["ssd"]
    (x, w, r), nkw = calls["rmsnorm/decode"]
    T, D = x.numel() // x.shape[-1], x.shape[-1]
    W = (torch.randn((D, D), generator=gen, device=dev) / D ** 0.5).to(
        x.dtype)
    out["rmsnorm_decode"] = call_figures(lambda: rmsnorm(x, w, r, **nkw))
    out["rmsnorm_decode"]["chain_ms"] = cuda_ms(lambda: norm_chain(
        rmsnorm, x.reshape(T, D), r.reshape(T, D), w, W, nkw.get("eps",
                                                                  1e-5)))
    (x, w, r), nkw = calls["rmsnorm/prefill"]
    out["rmsnorm_prefill_ms"] = cuda_ms(lambda: rmsnorm(x, w, r, **nkw))
    # by row count at D = 1,600, where the kernel's forms meet
    by_rows = {}
    for n in RMS_AB_ROWS:
        xs, rs = (torch.randn((n, D), generator=gen, device=dev).to(x.dtype)
                  for _ in range(2))
        by_rows[n] = cuda_ms(lambda: rmsnorm(xs, w, rs, **nkw))
    out["rmsnorm_by_rows_ms"] = by_rows
    del calls, x, w, r, xs, rs
    se.generate(prompts, 2)
    pre, dec = [], []
    for _ in range(SERVE_RUNS):
        se.stats = ServeStats()
        se.generate(prompts, SERVE_GEN)
        pre.append(se.stats.prefill_s)
        dec.append(se.stats.decode_s / se.stats.decode_steps * 1e3)
    out.update(tree=str(tree), prefill_s=pre, decode_ms_per_step=dec,
               ssd_ms=cuda_ms(lambda: ssd(*args, **kw)))
    del se, args, kw
    torch.cuda.empty_cache()
    out.update(train_backward_calls(dev))
    out.update(ssd_backward_calls(dev))
    out.update(flash_prefill_calls(dev))
    print("AB " + json.dumps(out), flush=True)


def flash_prefill_calls(dev):
    """``--ab``: the bf16 flash prefill by CUDA events at every (q/k, v)
    head dim pair of ``ops.HEAD_DIM_PAIRS``, 8 x 2,048 x 16 heads,
    causal (those the pair's model runs: MLA's at 48 heads, HuBERT's 80
    at 16 x 1,024, bidirectional)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    gen = torch.Generator(device=dev).manual_seed(41)
    shapes = {(dk, dv): (8, 2048, 16, True) for dk, dv in fa.HEAD_DIM_PAIRS}
    shapes[(96, 64)] = (MLA_BATCH, MLA_PROMPT, 48, True)
    shapes[(80, 80)] = (AUDIO_BATCH, AUDIO_FRAMES, 16, False)
    out = {}
    for (dk, dv), (B, S, H, causal) in shapes.items():
        q, k, v = (torch.randn((B, S, H, d), generator=gen, device=dev).to(
            torch.bfloat16) for d in (dk, dk, dv))
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        out[f"{dk}x{dv} {B}x{S}x{H} {'causal' if causal else 'full'}"] = \
            cuda_ms(lambda: fa.attention(q, k, v, pos, pos, causal=causal),
                    reps=50)
        del q, k, v
    return {"flash_prefill_ms": out}


def ssd_backward_calls(dev):
    """The SSD backward through the tree's wrapper at Hymba's training
    shape (HYMBA_BATCH x 50 heads, HYMBA_SEQ tokens, P = 64, N = 16):
    ``ssd_backward`` as a training step calls it (on the forward kernel's
    chunk-start states where the tree's wrapper takes them, else as the
    wrapper is), and whole (states computed inside where it takes them):
    :func:`call_figures` of each."""
    import inspect
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.mamba2_ssd import ops
    cfg = get_arch(HYMBA_ARCH)
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gen = torch.Generator().manual_seed(23)
    dy, _, xdt, logd, Bv, Cv = ssd_bwd_inputs(
        gen, HYMBA_BATCH * H, HYMBA_SEQ, P, N, H, "hymba", dev, hf=False)
    whole = call_figures(lambda: ops.ssd_backward(dy, None, xdt, logd, Bv, Cv,
                                                  heads=H))
    step = whole
    if "states" in inspect.signature(ops.ssd_backward).parameters:
        hst = ops._forward(xdt, logd, Bv, Cv, 64, H, states=True)[2]
        step = call_figures(lambda: ops.ssd_backward(
            dy, None, xdt, logd, Bv, Cv, heads=H, states=hst))
    del dy, xdt, logd, Bv, Cv
    torch.cuda.empty_cache()
    return {"ssd_backward": step, "ssd_backward_whole": whole}


def train_backward_calls(dev):
    """Both backward kernels through their wrappers at the train path's
    shapes, with whatever kernels the tree's wrappers launch: flash
    attention's at 8 x 2,048 x 16 / 8 heads x 64 (bf16, causal) and
    rmsnorm's at 16,384 x 1,024 (bf16, the residual form): device time by
    CUDA events and by torch.profiler, kernels, aten operators and host
    time a call (:func:`call_figures`)."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_backward
    cfg = get_arch(TRAIN_ARCH)
    gen = torch.Generator(device=dev).manual_seed(31)
    T, D = TRAIN_BATCH * TRAIN_SEQ, cfg.d_model
    x, r, dy, dres = (torch.randn((T, D), generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in range(4))
    w = torch.randn((D,), generator=gen, device=dev).to(torch.bfloat16)
    out = {"rmsnorm_backward": call_figures(
        lambda: rmsnorm_backward(dy, dres, x, w, r))}
    del x, r, dy, dres, w
    B, S, H, Hkv, Dh = (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads,
                        cfg.d_head)
    q, do = (torch.randn((B, S, H, Dh), generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, Dh), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    o, lse = fa._forward(q, k, v, pos, pos, True, None, None, None, True)
    out["attention_backward"] = call_figures(
        lambda: fa.attention_backward(do, q, k, v, o, lse, pos, pos,
                                      causal=True))
    del q, k, v, o, lse, do
    torch.cuda.empty_cache()
    return out

if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
