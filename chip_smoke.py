#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port ``distributed_tpu_torch``.

Run from the repository root on a machine with one NVIDIA GPU (built for
an H100, ``sm_90a``):

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

0. environment: torch/CUDA versions, the card, its power limit, nvcc,
   whether triton and psutil import;
1. build: the ten hand-written kernel sources from
   ``distributed_tpu_torch/ops/csrc`` (nvcc, one process a source), the
   host pack ``distributed_tpu_torch/native/graphpack.cpp`` and the native
   transition engine ``native/engine.cpp`` (g++), at once, and the build's
   seconds; the registers and spills from ptxas of every instance of the
   flash kernels (K2 and K3 at head dims 64, 128 and 256), K3's
   tensor-core kernels' into the ``flash_bwd`` entry of the kernels line,
   failing if they spill or if ptxas serialised their wgmma (warning
   C7512), and those of every
   instantiation of K7 and K8 (into the ``steal`` and ``amm_drop``
   entries), of K9, K6/K11 (``fleet_scatter_kernel``) and of K12
   (``shuffle_bucket``), failing if one spills;
2. flash attention forward (kernel K2) at seq 8192, 16 heads, head dim
   128 in bf16, causal and not (the tensor-core body), plus f32 at seq
   1024 / head dim 64 (the CUDA-core body), against the plain version on
   the card, with kernel / plain / library times;
2b. flash attention backward (kernel K3) through autograd:
   ``flash_attention(q, k, v).backward(dO)`` at the same widths plus a
   cross-length case (4096 queries against 8192 keys), K2 then K3 once
   each per case; on K2's residuals K3 within ``flash.BWD_TOL`` (+ the
   rounding terms) of the plain backward, bit-identical across two calls
   and to the autograd run, both planted faults (a q-tile left out of
   dK/dV, a k-tile out of dQ) rejected, and the whole autograd path within
   ``flash.E2E_RTOL`` of the plain forward and backward; K3's time beside
   the plain backward's, ``scaled_dot_product_attention``'s backward and
   the bound;
2c. flash attention at other head dims, forward and backward through
   autograd, K2 and K3 on the instance that holds each head dim (64, 128
   or 256): the attention of Phi-2 (32 heads, dim 80, seq 2048, bf16,
   causal), Phi-3-mini (32 heads, dim 96, seq 4096, bf16, causal and not)
   and Gemma 2 9B (16 heads, 8 K/V heads expanded to 16, dim 256, seq
   8192, bf16, causal and not), and the reference's small shapes (dims 8
   and 16 in f32 and bf16, dim 20 in bf16, whose rows the wrapper pads to
   16 bytes, at seq 256, causal and not); each held as phases 2 and 2b
   hold theirs, with K2, K3 and SDPA's forward and backward times (events,
   median of 5) beside the plain versions' and the bounds at the true
   head dim;
3. whole-graph placement (kernel K1): the 1M-task random DAG onto 512
   workers of 2 threads, a uniform fleet and a non-uniform one, through
   ``pack_graph`` and ``place_graph_leveled`` on the card (one launch for
   all waves of a graph), validated, equal bit for bit to the plain
   version on the CPU, and held against the same driver running the
   plain wave on the card;
4. streamed placement: the same graph and fleets through
   ``place_graph_streamed`` as the scheduler's plan path calls it (C++
   pack, chunked pinned uploads of the 11 B/task packed wire, a kernel
   launch per chunk that completes a wave, segmented download, C unpack)
   and the plan's hints; equal bit for bit to the same driver on the CPU,
   ``compact=False`` equal to phase 3's one-shot result, the packed wire
   within the reference's quality gate of the f16 wire; the C++ and numpy
   packs, and the placement wall of both wire formats beside the 250 ms
   north star;
5. the scheduler's placement extension: ``TorchPlacement(sync=True)``'s
   ``_plan_from_arrays``, the planner thread's whole job, on the
   rechunk + tensordot proxy (G = 24: 14,976 tasks) and a 16,384-task
   random DAG, which the router sends to the partitioner (kernel K4), and
   a 32,768-task random DAG, which it sends to the leveled engine (K1),
   on phase 3's two fleets (1,024 and 1,008 lanes); on ``fewlane``, 4
   workers of 4 threads (16 lanes), phase 3's 1M-task DAG and the proxy at
   G = 96 (903,168 tasks), which the router also sends to the
   partitioner; the hints equal the same call on the CPU, K4's labels
   equal its plain version's on the CPU bit for bit, and against the plain
   version on the card the plan costs the same within 1 %; K4's time
   beside its bound and ``chain_ms`` (the in-order add chain the contract
   forces), the plan's wall and hints time; then the 1M-task uniform
   batch through the extension, whose hints must equal phase 4's;
6. the scheduler's periodic device paths at full width, through the
   port's path objects on stand-in workers and keys (the card's machine
   has no ``msgpack``/``cloudpickle`` for a live scheduler): the fleet
   mirror's device view (K6, ``csrc/fleet_scatter.cu``, one launch a view
   with dirty rows) on 512 workers, then grown to 1,000 workers
   (capacity 1,024), with 0, 1, 37 and all rows dirtied between views
   (the view equals the host rows; one full upload at first use and at
   growth, otherwise exactly the dirty rows; each launch equal to the
   plain version on the card bit for bit), a balance cycle on each
   fleet (K7: 8,192 tasks on 32 victims, 8 rounds, fed by the view, equal
   to the plain version on the CPU bit for bit, repeatable, the steals
   replayed against the python criterion), an AMM round (K8: 16,384
   replicated keys on 512 workers, up to 64 rounds, the same drops as the
   plain version on the CPU, the reference's invariants on replay) and a
   rebalance plan (K9, ``csrc/rebalance.cu``, one launch a plan: 262,144
   keys on 512 workers, the invariants, the same moves, counts and memory
   as the CPU run and as the plain version on the card, beside the time
   of the scheduler's host plan on the same keys, and the call's device
   time; then the same keys on 4,096 workers against the plain version on
   the card); each with its time,
   the plain version's time on the card, its bound and its launches (K7
   to K9 also ``chain_ms``, the dependent adds their contract orders,
   and their split by phase from the kernel's own timeline), and no path
   may count a failure; then K6 and K11 against their plain version on the
   card at 0, 1, 37 and every slot of capacities 512 and 1,024 dirty, in
   place and copy-on-write at dw 1 and 2, bit for bit, and a record with
   one dirty row dropped rejected; the view's scatter plan rebuilt only
   with a full upload, and the ring's waits; and K6's 37-row view timed
   whole with its writes through the kernel, through the plain version and
   through a full upload of the same fields (after the same marks and
   refresh) in turns, its host time by step (marks, refresh, and within
   the view the kernel's call, the ring's ``acquire``, the launch with its
   device guard and stream lookup), the kernel alone and the plain version
   in turns on the view's own call, the empty launch and the bound.  Its
   inputs and replays come from
   ``tests/test_torch_periodic_cases.py``;
7. the sharded placement engine (kernel K10, ``csrc/place_shard.cu``)
   with every shard on the one card (``LocalShards``, so K10's run mode:
   one cooperative launch a fused run, the psums in shard order, the
   load, the span and the slice writes inside it): phase 3's 1M-task DAG
   on its two fleets at layouts 1x1, 2x1, 4x2 and 8x1 through
   ``place_graph_leveled_sharded``, one run-mode launch a fused run and
   no step-mode launch on that path; each equal bit for bit to the plain
   shard body on the CPU and repeatable, 1x1 equal to phase 3's one-shot
   K1 result, every layout within ``tests/test_sharded_engine.py``'s gate
   against it; K10's time (the waves, events) in run mode and in step
   mode (the two-launch loop through the explicit pair, whose carry must
   equal the run mode's), the run mode's device idle share, the plain
   body's time on the card, the bound, per-shard upload bytes and the
   walls beside ``place_graph_leveled``'s; then the mirror's workers-axis
   view (K11, the same kernel, one launch a device a view) on 512 workers
   and on 1,000 in a capacity of 1,024 at dw = 1 and 2 (rows equal the
   host's, a fresh cycle uploads nothing, the engine fed by it places as
   fed by the host arrays, 37 dirty rows then one launch equal to the
   plain version on the card with the view handed out before unchanged,
   the plans rebuilt only with a full pack, a 37-row view timed by part
   as phase 6 times K6's, beside the same view through the full pack),
   ``ProcessGroupShards`` on NCCL with a world of one (equal to
   ``LocalShards`` 1x1, in step mode), and ``TorchPlacement`` with an
   explicit 4x2 layout of virtual shards on the 1M uniform batch (hints
   equal a direct ``place_graph_streamed(mesh=...)``, 8 engine shard rows,
   run mode, no failure).  Phase 1 also reports the registers and spills
   of K10's six instantiations and fails if one spills;
8. the device data plane and long context, 8 virtual shards on the card
   (``LocalShards``).  The shuffle (kernel K12, ``csrc/shuffle_bucket.cu``):
   8 x 8,388,608 rows (int32 keys uniform in [0, 2^30), [4] f32 values,
   ~TPC-H lineitem at scale factor 10) through ``shuffle_on_mesh`` and
   ``compact_shuffle_output`` at the default capacity (rows conserved as a
   multiset, every row on ``mix32(key) % 8``, a row moved one shard on
   caught), a synthetic Zipf(1.1) skew over 2,526 key values, picked so that
   its fullest destination exceeds the default capacity (it must raise there,
   and conserve every row at capacity = rows), ``DeviceRun.exchange``
   on 8 ragged partitions of up to 2,097,152 rows (== the CPU run), K12 ==
   its plain version bit for bit on every case and repeated, K12 / plain /
   bound / ``all_to_all`` / ``shuffle_on_mesh`` times, and
   ``maybe_initialize`` on NCCL with a world of one (``ProcessGroupShards``
   == ``LocalShards``), and the ring step (``ppermute``) alone on a shard's
   block of values over that group (a copy, beside its bound in bytes) and
   over ``LocalShards`` (the tensors handed over, nothing copied).  Long context at seq 16,384 (2,048 a shard), 16
   heads, dim 128, bf16, causal and not: ``ring_attention`` (K2 a visible
   block, an f32 lse merge) within ``ring_attention.ring_excess`` of the
   plain ring, a ring with one step left out rejected; ``ulysses_attention``
   within K2's contract of the plain forward on the whole sequence; their
   K2 launches and times beside K2 on the whole sequence and SDPA;
9. long-context training at phase 8's sizes: ``ring_attention(...)`` and
   ``ulysses_attention(...)`` then ``backward`` with a seeded dO, causal and
   not (and Ulysses at a ragged 8 x 1,000 rows): the ring's hand-written
   backward runs K3 on every visible block (36 / 64 launches) from the
   merged lse and O, Ulysses K3 on each head group (8); every shard's ring
   gradients within ``ring_attention.ring_bwd_excess`` of autograd through
   the plain ring, both planted faults (a ring step left out, a block's
   dK/dV left on the wrong shard) rejected, two backward calls
   bit-identical; each Ulysses head group's K3 within ``flash.bwd_excess``
   of the plain backward on its residuals and the autograd gradients equal
   to K3's; ``ProcessGroupShards`` on NCCL with a world of one equal to
   ``LocalShards``; the step, the backward, K3's share (profiler), the
   plain backward, SDPA's backward on the whole sequence and the bound;
10. the round-1 batched placers as torch ops: ``decide_workers``
   sequential on 2,048 ready tasks and parallel on 32,768, onto 512
   workers x 2 threads with ~10 % of rows restricted (assignments equal
   the CPU run bit for bit, and the sequential occupancy; the parallel
   occupancy, whose sums CUDA's ``index_add_`` reorders, within
   ``K1_LOAD_RTOL``), ``place_rootish`` (exact) and
   ``occupancy_after_finish`` on the 32,768, ``place_graph`` (the
   wavefront) on phase 3's DAG and fleets (validated; against the CPU run
   K1's gate: each wave from the CPU run's state agrees >= 0.999 with
   the load within ``K1_LOAD_RTOL`` on untouched workers, end to end
   imbalance and makespan within 1 %, and the whole result equal to the CPU
   run bit for bit: the loads add in task order), ``sharded_decide_workers`` (K15) at 2x1, 4x2
   and 8x1 on 8,192 tasks equal to the single-device parallel assignment;
   each timed beside its CPU run and bound;
11. the host periphery: ``tensor_sizeof`` of a K12 shuffle's output (2^20
   int32 keys and [2^20, 4] f32 values: 4,194,304 and 16,777,216 B); the
   ``"torch"`` wire family on those CUDA tensors (frames equal to the
   card's bytes, ``device: "cuda"`` in the header, loaded back on the card
   bit for bit, bfloat16 refused; dumps and loads ms); the device trace
   (``torch.profiler`` over every thread), in this process after phases
   1-10 as on a long-lived worker, taken once and holding every kernel its
   launches made, of a task on a pool thread made before it (the thread's
   card the same after its launches): K2 at seq 8192 bf16
   under the task's span (the profiler's device-side annotation of the span,
   its launch inside the span, joined by correlation id), and a second K2
   launch after the span not attributed (a reader that attributes by time
   is rejected), K2 traced beside untraced, in 30 timing traces in a row,
   each holding every kernel; ``entry()`` on the card equal to its CPU run bit for
   bit and ``dryrun_multichip(8)`` with every assertion, its ring at the
   reference's head dim 8 (K1, K10, K12, K2
   launches counted); ``join_process_group`` on stand-in workers over NCCL
   at a world of one (a second join creates nothing, a mismatched world
   raises, the group destroyed); the build-info line;
12. the sans-io control plane, the port's own scheduler engine, worker
   state machines and simulator (no JAX package, no ``msgpack``,
   ``cloudpickle`` or ``yaml``): (a) one ``update_graph_core`` of
   ``graphs.random_dag(131_072, seed=0)`` into ``SchedulerState(device=cuda)``
   on the Python engine with 512 workers x 2 threads and
   ``TorchPlacement(sync=True)``, which
   the router sends to the leveled engine (K1): the plan equal to a direct
   ``_plan_from_arrays`` on the same batch, and the plan, the hints left and
   every task's state and worker equal to the same call on the CPU; the
   wall, the plan's share (``state.wall``'s ``kernel.dispatch``), the
   hints' time and K1's; (b) ``ClusterSim(512, nthreads=2,
   use_device_kernels=True)`` on ``SyntheticDag(20 layers x 1000, fanin 2,
   2 layers a chunk)`` with ``TorchPlacement``, the port's own
   ``WorkStealing`` and ``ReduceReplicas`` (an AMM round every 0.1 virtual
   s; the configured 2 s outlasts the run) and the native transition
   engine (``native=True``: the C++ engine, attached and active, must run
   transitions; a Python oracle in its place would give the same digest):
   no key lost, the census clean, a plan a chunk through K4, K6, K7 and K8
   launched, no failure, and the digest, makespan, transition counts and
   device cycles equal to the CPU run, which runs the Python oracle; wall,
   transitions/s, makespan, the engine's transitions and escapes by
   reason, and each kernel's launches and event time.  The CPU runs go in
   two child processes beside the card's;
13. recovery at 12b's fleet (512 workers x 2) with the mirror, K7 and K8
   on the card and the native engine attached, on ``SyntheticDag(6 layers
   x 1000, fanin 2, 2 layers a chunk)``: (a) ``scenario_scheduler_bounce``'s
   shape, durability on and the scheduler bounced mid-graph (snapshot,
   restore, journal-tail replay): the bounce's own checks (the restored
   state's digest and transition counter equal the dead state's), no key
   lost, the census clean, the digest equal to an unbounced same-seed
   twin's, the dead state and its mirror released with the device memory
   it held, a full upload by the new state's mirror and K6, K7 and K8
   launching after the bounce; snapshot, load, restore and tail-replay
   times and the tail's records; (b) the twin's stimulus journal replayed
   (``JournalTrace.replay``) into a fresh sim on the card to the recording
   state's ``state_digest``; (c) the twin's critical path, which must pass
   ``critical_path.check``; (a)-(c) equal to the same runs on the CPU with
   the Python oracle, in a child process started with phase 12's;
14. the port's asyncio servers and client (``scheduler/server.py``,
   ``worker/server.py``, ``client/client.py``; the comm and the wire
   without msgpack): (a) BASELINE config 2 at full width, a
   ``Scheduler(device=cuda)`` with ``TorchPlacement``, 16 one-thread
   ``Worker``s over ``inproc://`` and a ``Client`` under ``bench.py``'s
   overrides with the periodic gate at 16 workers; the timed
   ``tensordot_graph(32)`` (45,056 tasks, with no warm-up graph before it) of 4 x 4 CUDA blocks of seeded small integers: K4 (or K1) and K7
   launched from inside the ``Scheduler``, no device path failing, the
   results equal bit for bit to the same graph on a ``device="cpu"``
   cluster in a child process; the wall, tasks/s, the plan's counters, the
   launches, the native engine's transitions and escapes, the peak device
   memory; (b) ``tensordot_graph(8)`` of 1,024 x 1,024 f32 CUDA blocks on 4
   workers over ``tcp://127.0.0.1``: the ``"torch"`` family's calls and
   bytes > 0 (CUDA tensors cross the wire), the results equal to the CPU
   run bit for bit; bytes moved, transfers and their median time;
15. the deploy layer and the client's extras, each part held bit for bit to
   a ``device="cpu"`` run in a child process: (a) BASELINE config 1 at full
   width, ``bench.py``'s ``cfg_array_sum`` graph (``graphs.array_sum_graph``:
   ``ones((10000, 10000), chunks=1000).sum()``, 100 f64 CUDA blocks of 8 MB
   and a fan-in-8 sum tree) on the port's ``LocalCluster(n_workers=4,
   threads_per_worker=2)`` at its defaults (the sum exactly 1e8; the wall,
   the trivial-task probe, the launches and the peak device memory); (b) the
   same 100 blocks persisted on 4 workers of ``memory_limit`` 100 MB (target
   60 MB) with the RSS thresholds off: every worker spills into its
   ``WorkSpace`` directory, every evicted tensor is dead by weak reference
   and the card holds the fast layers' blocks and less than one block more,
   every block read back comes on ``cuda:0`` all ones, the sum exact, the
   directories gone after ``close()``; keys, bytes and MB/s each way, from
   the workers' spill metrics; (c) BASELINE config 3, ``bench.py``'s ``_run_steal`` (320
   ``slowinc`` of 0.02 s pinned to one of 64 one-thread workers), stealing
   on (K6 and K7 from inside the scheduler, the tasks on more than one
   worker) and off, both walls beside the ideal, then, on the cluster
   with stealing on, ``Client.rebalance()`` of 4,096 single-replica keys
   of uneven sizes held by 16 of the 64 workers (K9 launched once from
   inside the scheduler, its moves those of the CPU plan on the same
   batch, every value unchanged, the imbalance not grown); (d) two ``Nanny``s on a
   tcp scheduler, each spawning a worker process that computes CUDA blocks
   (back through the ``"torch"`` family), the children importing no JAX
   package and no JAX, one worker SIGKILLed, restarted by its nanny and its
   keys recomputed to the same results; spawn and restart times and the
   child's RSS; (e) an actor's CUDA accumulator over 100 ``add`` calls, a
   task gathering 16 CUDA blocks through ``worker_client()`` and
   ``client.get_executor().map`` over 32 inputs.  Phase 15's CPU run starts
   before phase 14, beside phase 14's card runs and its twin, and is read
   once phase 15's card runs are done, so that their host walls measure
   the port alone;
16. the port's shuffle and coordination extensions: (a) BASELINE config 4
   at full width, ``bench.py``'s ``cfg_shuffle``: 10,000,000 rows (an int64
   key in [0, 2^30), an f64 value) in 128 partitions made by a mapped task,
   ``p2p_shuffle_arrays(on="key")`` into 128 outputs on the port's
   ``LocalCluster(n_workers=128, threads_per_worker=1)`` on the card, then a
   mapped ``len``: every row comes out once, in output ``splitmix64(key) %
   128``, each output holding its shards in input-partition order (checked
   against the rows computed again without the cluster); the wall from the
   shuffle call to the gathered sizes, rows/s and the launches of K1, K4,
   K6, K7 and K8 during it; (b) the device shuffle through the cluster at
   phase 8's size: 8 inputs of 8,388,608 rows made on the card,
   ``p2p_shuffle_device`` on ``LocalCluster(n_workers=8)`` with the store's
   mesh on 8 virtual shards of the card, K12 launched 4 times from the
   barrier task, the outputs on the card and equal bit for bit to a direct
   ``shuffle_on_mesh``; (c) an Event, a Lock, a Semaphore, a Queue, a
   Variable and a published dataset carrying a future of a 1,024 x 1,024
   CUDA block from one client to another, each value equal bit for bit;
17. the port's command line, http and ``ws://``: (a) ``SubprocessCluster(
   n_workers=4, nthreads=2)``, every node a process started with ``python
   -m distributed_tpu_torch.cli.*`` at once, the scheduler on the card (the
   CLI's default) and the last worker under ``--nanny``: BASELINE config 1
   at full width with its blocks on the card in the worker processes (the
   sum == 10^8, as numpy's), a random DAG of 2,048 tasks (the placement
   plans it, its gates opened for 4 workers by ``DTPU_*`` overrides in the
   scheduler's environment as a user of the CLI opens them: K1 or K4
   launch in the scheduler's process, read through ``run_on_scheduler``;
   its results == the same DAG on the host) and a
   task that runs ``flash_attention`` (K2) in a worker process at seq 8192,
   16 heads, dim 128, bf16, causal, held there to the plain version by
   ``flash.o_excess``; (b) the same cluster read over http: the
   scheduler's ``/``, ``/metrics``, ``/api/v1/workers``, ``/api/v1/tasks``,
   ``/dashboard`` and ``/workers/<name>/metrics``, and each worker's own
   ``/metrics``, every ``dtpu_build_info`` naming ``backend="cuda"`` and the
   card, and the median of a scrape of the scheduler's ``/metrics``; (c) a
   scheduler and two workers on ``ws://127.0.0.1:0`` in this process: 1,024
   x 1,024 f32 CUDA blocks cross between the workers over ``ws://``, each
   equal bit for bit, with the fetch's median beside phase 14b's over tcp;
18. graft-lint for the port: ``python -m distributed_tpu_torch.analysis
   --format json`` over the tree as shipped, in a child process started
   after phase 1 and read here: no
   finding, no error, no stale baseline entry, exit 0; the rules run, the
   files parsed, the suppressed count and the wall.

Each phase's wall is printed as it ends, and all of them again in one JSON
line.  The last three lines are the card's ``nvidia-smi`` name and power limit,
one JSON object listing the kernels (``flash_fwd``, ``flash_bwd``,
``place_wave``, ``partition``, ``steal``, ``amm_drop``, ``mirror_view``
(K6), ``rebalance``, ``place_shard``, ``mirror_shard_view`` (K11),
``shuffle_bucket``, and the torch routes ``ring_attention``, ``ulysses``,
``ring_attention_bwd``, ``ulysses_bwd``, ``decide_workers``,
``wavefront`` and ``sharded_decide_workers``) with their launches, errors
and times (phase 12's launches added, and kept apart as
``launches_control_plane``, phase 13's as ``launches_recovery``, phase
14's as ``launches_servers``, phase 15's as ``launches_deploy``, phase
16a-c's as ``launches_shuffle`` and K12's of 16b as
``launches_shuffle_ext``, phase 17's as ``launches_cli``), and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import functools
import gc
import hashlib
import inspect
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import weakref
from pathlib import Path

import numpy as np
import torch

# tolerances of the kernels against their plain versions on the card.
# K2's O: flash.O_TOL per element plus u * (P.|V|) / l where the
# tensor-core body rounds P (flash.o_excess states and derives it).
FLASH_TOL_LSE = 1e-3
FAULT_KEYS = 64              # the planted fault drops this many keys from P.V
# K1 sums per-worker loads in task order, as the plain version does on the
# CPU: the kernel must equal that run bit for bit.  The plain version on
# the card sums with CUDA's index_add_ (run in deterministic mode), in its
# own order, so against it a near-tie may flip a task:
K1_MIN_AGREEMENT = 0.999     # per wave, from identical state
K1_LOAD_RTOL = 1e-4          # load error on workers no flipped task touched
QUALITY_RTOL = 0.01          # imbalance and makespan, whole graph
QUALITY_CHOICE_PP = 0.01     # share of each choice, whole graph

# H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}

N_TASKS = 1_000_000
N_WORKERS = 512
THREADS = 2


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps=3, warmup=1):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


# ------------------------------------------------------------ phases 0-1


def phase_env():
    from distributed_tpu_torch.ops import _build

    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"nvidia-smi {smi_line()}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print("nvcc", [ln for ln in nvcc.splitlines() if "release" in ln][-1].strip())
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton absent")
    from distributed_tpu_torch.diagnostics import device_profile

    print(f"torch.profiler profile_all_threads: {device_profile.available()}")
    try:
        import psutil
        print(f"psutil {psutil.__version__}")
    except ImportError:
        print("psutil absent: the workers read an RSS of 0, so the memory manager's spill and "
              "pause thresholds and the nanny's terminate threshold never fire")


K3_TC_KERNELS = ("bwd_dkdv_tc_kernel", "bwd_dq_tc_kernel")
# every kernel of the flash sources whose registers and spills phase 1 prints
FLASH_KERNELS = {"flash_fwd.cu": ("flash_fwd_tc_kernel", "flash_fwd_simt_kernel"),
                 "flash_bwd.cu": K3_TC_KERNELS + ("bwd_dkdv_simt_kernel", "bwd_dq_simt_kernel",
                                                  "bwd_delta_kernel")}


def _ptxas(log, label):
    """{label: {"registers": n, "spill_bytes": stores + loads}} for every
    entry function of the ptxas log that ``label(mangled name)`` names
    (None: skipped)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = label(m[1])
            if cur is not None:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[cur]["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m[1])
    return out


def ptxas_entries(log, names):
    """``_ptxas`` of the flash kernels whose name holds one of ``names``,
    each labelled with its type, its instance's head dim and its causal
    flag."""
    def label(mangled):
        name = next((n for n in names if n in mangled), None)
        if name is None:
            return None
        dtype = ("bf16" if "bfloat16" in mangled else "f16" if "__half" in mangled
                 else "f32" if re.search(name + r"If", mangled) else "?")
        args = [dtype] + re.findall(r"Li(\d+)E", mangled)[:1]
        # the causal flag, then K2's f32 body's head dim taken at compile time
        flags = re.findall(r"Lb([01])E", mangled)
        args += [("full", "causal")[int(f)] for f in flags[:1]]
        args += [("masked", "exact")[int(f)] for f in flags[1:2]]
        return f"{name}<{','.join(args)}>"

    return _ptxas(log, label)


def flash_ptxas(log):
    """{source: ``ptxas_entries`` of every kernel of ``FLASH_KERNELS``}."""
    return {src: ptxas_entries(log.split(f"== {src}", 1)[1].split("\n== ", 1)[0], names)
            for src, names in FLASH_KERNELS.items()}


# the periodic kernels whose registers and spills phase 1 reports:
# source -> kernel; K7 is instantiated per level of XLA's windows, K8 per
# width of its holder lists
PERIODIC_KERNELS = {"steal.cu": "steal_kernel", "amm_drop.cu": "amm_drop_kernel",
                    "rebalance.cu": "rebalance_kernel", "fleet_scatter.cu": "fleet_scatter_kernel"}


def periodic_ptxas(log):
    """{source: _ptxas of its kernel}, each instantiation labelled with its
    template argument (K7's window levels, K8's list entry)."""
    out = {}
    for src, name in PERIODIC_KERNELS.items():
        def label(mangled, name=name):
            if name not in mangled:
                return None
            m = re.search(name + r"I(?:Li(\d+)E|([a-z]))E", mangled)
            arg = m and (m[1] or {"s": "int16", "i": "int32"}.get(m[2], m[2]))
            return f"{name}<{arg}>" if arg else name

        out[src] = _ptxas(log.split(f"== {src}", 1)[1].split("\n== ", 1)[0], label)
    return out


def shard_ptxas(log):
    """_ptxas of K10's six instantiations, labelled with their template
    arguments: the step mode's (uniform fleet, contention launch) and the
    run mode's (uniform fleet)."""
    def label(mangled):
        m = re.search(r"place_shard_kernelILb(\d)ELb(\d)E", mangled)
        if m:
            return f"place_shard_kernel<uniform={m[1]},contend={m[2]}>"
        m = re.search(r"place_shard_run_kernelILb(\d)E", mangled)
        return m and f"place_shard_run_kernel<uniform={m[1]}>"

    return _ptxas(log.split("== place_shard.cu", 1)[1].split("\n== ", 1)[0], label)


SHUFFLE_VEC = {"c": 1, "NS_2U2E": 2, "i": 4, "4int2": 8, "4int4": 16}  # copy bytes by template


def shuffle_ptxas(log):
    """_ptxas of K12's four kernels, the templated ones labelled with their
    copy width in bytes."""
    def label(mangled):
        m = re.search(r"(hist_kernel|scan_kernel|scatter_kernel|tail_kernel)"
                      r"(?:I(4int4|4int2|NS_2U2E|i|c)E)?", mangled)
        if not m:
            return None
        return f"{m[1]}<{SHUFFLE_VEC[m[2]]}>" if m[2] else m[1]

    return _ptxas(log.split("== shuffle_bucket.cu", 1)[1].split("\n== ", 1)[0], label)


def phase_build():
    """Builds everything; returns the registers and spills from ptxas of
    K3's tensor-core kernels and of the periodic kernels (K7, K8), and
    fails where ptxas serialised K3's wgmma (C7512) or any of them
    spills.  Prints those of every instance of the flash kernels (K2 and
    K3 at each head dim of ``flash.HEAD_DIM_INSTANCES``)."""
    from distributed_tpu_torch import native
    from distributed_tpu_torch.ops import _build, flash

    t0 = time.perf_counter()
    # g++ builds the host pack and the transition engine while nvcc builds
    # the kernels
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(lambda: (native.load(), native.load_engine()))
        _build.load()
        host.result()
    print(f"build_s {time.perf_counter() - t0:.2f} ({_build.build_info['path']}, "
          f"{native.library_path()}, "
          f"{native.library_path(native.ENGINE_SOURCE, 'libdtpu_engine')})")
    log = _build.build_info["log"]
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or ln.startswith("==") or "C7512" in ln:
            print("  ptxas", ln.strip())
    if log == "(cached)":
        return {}, {}
    bwd_log = log.split("== flash_bwd.cu", 1)[1].split("\n== ", 1)[0]
    check("C7512" not in bwd_log, "ptxas serialised wgmma in flash_bwd.cu (C7512)")
    k3 = ptxas_entries(bwd_log, K3_TC_KERNELS)
    # two kernels, two types, two causal flags an instance
    want = 8 * len(flash.HEAD_DIM_INSTANCES)
    check(len(k3) == want, f"ptxas reported {len(k3)} K3 tensor-core kernels, not {want}")
    for label, info in k3.items():
        check(info.get("spill_bytes") == 0, f"{label} spills: {info}")
    for src, kernels in flash_ptxas(log).items():
        for label, info in kernels.items():
            print(f"  {src} {label}: {info.get('registers')} registers, "
                  f"{info.get('spill_bytes')} spill bytes")
    periodic = periodic_ptxas(log)
    periodic["place_shard.cu"] = shard_ptxas(log)
    periodic["shuffle_bucket.cu"] = shuffle_ptxas(log)
    for src, kernels in periodic.items():
        check(kernels, f"ptxas reported no kernel of {src}")
        for label, info in kernels.items():
            print(f"  {src} {label}: {info.get('registers')} registers, "
                  f"{info.get('spill_bytes')} spill bytes")
            check(info.get("spill_bytes") == 0, f"{src} {label} spills: {info}")
    return k3, periodic


# ------------------------------------------------------------ phase 2


FLASH_CASES = [
    # (label, seq, heads, head dim, dtype, causal)
    ("bf16_causal", 8192, 16, 128, torch.bfloat16, True),
    ("bf16", 8192, 16, 128, torch.bfloat16, False),
    ("f32_causal", 1024, 16, 64, torch.float32, True),
    ("f32", 1024, 16, 64, torch.float32, False),
]
FLASH_HEADLINE = "bf16_causal"


def _flash_inputs(seq, heads, dim, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(
        torch.randn((seq, heads, dim), generator=g, device="cuda").to(dtype)
        for _ in range(3)
    )


def _flash_bound_ms(seq, heads, dim, dtype, causal):
    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * heads * seq * dim * elem + 4 * heads * seq  # q k v o, lse
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    flops = 4 * heads * dim * pairs
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _drop_keys(qt, kt, vt, causal, scale, o_plain, lse_plain):
    """O of a planted fault: FAULT_KEYS keys in the middle of the sequence
    are left out of P.V but kept in l and lse, as by a kernel that skips
    one k-tile's product."""
    lo = kt.shape[1] // 2 // FAULT_KEYS * FAULT_KEYS
    hi = lo + FAULT_KEYS
    s = (qt.float() * scale) @ kt[:, lo:hi].float().transpose(1, 2)
    if causal:
        qpos = torch.arange(qt.shape[1], device=qt.device)[:, None]
        kpos = torch.arange(lo, hi, device=qt.device)[None, :]
        s = s.masked_fill(qpos < kpos, float("-inf"))
    p = torch.exp(s - lse_plain)
    return (o_plain.float() - p @ vt[:, lo:hi].float()).to(o_plain.dtype)


def phase_flash():
    from distributed_tpu_torch.ops import flash

    inputs = {c[0]: _flash_inputs(c[1], c[2], c[3], c[4], seed=i)
              for i, c in enumerate(FLASH_CASES)}
    # the main path: flash_attention as a user calls it, [seq, heads, dim]
    flash.flash_forward_cuda.launches = 0
    outs = {}
    for label, seq, heads, dim, dtype, causal in FLASH_CASES:
        q, k, v = inputs[label]
        outs[label] = flash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    launches = flash.flash_forward_cuda.launches
    check(launches == len(FLASH_CASES), f"flash kernel launches {launches}")

    results = {}
    for label, seq, heads, dim, dtype, causal in FLASH_CASES:
        q, k, v = inputs[label]
        out = outs[label]
        check(out.shape == q.shape and out.dtype == dtype, f"{label}: output {out.shape} {out.dtype}")
        check(bool(torch.isfinite(out.float()).all()), f"{label}: non-finite output")
        qt, kt, vt = (x.transpose(0, 1).contiguous() for x in (q, k, v))
        scale = 1.0 / dim ** 0.5
        o_k, lse_k = flash.flash_forward_cuda(qt, kt, vt, causal, scale)
        o_p, lse_p = flash.flash_forward_reference(qt, kt, vt, causal, scale)
        u = flash.P_ROUNDOFF.get(dtype, 0.0)
        pv_term = u * flash.pv_rounding_term(qt, kt, vt, causal, scale, lse_p) if u else 0.0
        pv_max = float(pv_term.max().item()) if u else 0.0
        err_o = (o_k.float() - o_p.float()).abs().max().item()
        err_lse = (lse_k - lse_p).abs().max().item()
        excess = max(flash.o_excess(o_k, o_p, pv_term), flash.o_excess(out.transpose(0, 1), o_p, pv_term))
        # the check must reject a kernel that drops one k-tile's product
        fault = _drop_keys(qt, kt, vt, causal, scale, o_p, lse_p)
        fault_err = (fault.float() - o_p.float()).abs().max().item()
        fault_excess = flash.o_excess(fault, o_p, pv_term)
        del o_p, lse_p, fault, pv_term
        body = "tensor cores" if dtype in flash.P_ROUNDOFF else "cuda cores"
        check(excess <= 0.0, f"{label}: O off by {excess} beyond "
              f"(rtol, atol) {flash.O_TOL[dtype]} + u (P|V|)/l (max {pv_max}), max abs err {err_o}")
        check(fault_excess > 0.0, f"{label}: the O check passes a planted fault "
              f"(max abs err {fault_err})")
        check(err_lse <= FLASH_TOL_LSE, f"{label}: lse max abs err {err_lse} > {FLASH_TOL_LSE}")
        ms = cuda_ms(lambda: flash.flash_forward_cuda(qt, kt, vt, causal, scale))
        plain_ms = cuda_ms(lambda: flash.flash_forward_reference(qt, kt, vt, causal, scale))
        qs, ks, vs = qt[None], kt[None], vt[None]
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal, scale=scale))
        bound_ms, bound_by = _flash_bound_ms(seq, heads, dim, dtype, causal)
        results[label] = dict(body=body, max_abs_err=err_o, lse_err=err_lse,
                              o_excess=excess, pv_term_max=pv_max,
                              fault_max_abs_err=fault_err, fault_excess=fault_excess,
                              ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        print(f"flash {label} seq {seq} heads {heads} dim {dim} ({body}): err_o {err_o:.3g} "
              f"u(P|V|)/l max {pv_max:.3g} "
              f"(excess {excess:.3g}; planted fault err {fault_err:.3g} excess "
              f"{fault_excess:.3g}) err_lse {err_lse:.3g} kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {lib_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})")
        torch.cuda.empty_cache()
    head = results[FLASH_HEADLINE]
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "distributed_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "distributed_tpu/ops/flash.py:35",
        "launches": launches,
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "case": FLASH_HEADLINE,
        "cases": results,
    }


# ------------------------------------------------------------ phase 2b


BWD_CASES = [
    # (label, seq, key seq, heads, head dim, dtype, causal)
    ("bf16_causal", 8192, 8192, 16, 128, torch.bfloat16, True),
    ("bf16", 8192, 8192, 16, 128, torch.bfloat16, False),
    ("bf16_cross", 4096, 8192, 16, 128, torch.bfloat16, False),
    ("f32_causal", 1024, 1024, 16, 64, torch.float32, True),
    ("f32", 1024, 1024, 16, 64, torch.float32, False),
]


def _bwd_bound_ms(n, nk, heads, dim, dtype, causal):
    """Five products of 2*D operations per (query, key) pair that the mask
    keeps (no causal offset: query i sees keys 0..i); each of q, k, v, o,
    dO, lse read once and dq, dk, dv written once."""
    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * heads * (n + nk) * dim * elem + 4 * heads * n
    pairs = sum(min(i + 1, nk) for i in range(n)) if causal else n * nk
    flops = 10 * heads * dim * pairs
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_flash_bwd(fwd_entry, k3_ptxas):
    """Phase 2b: ``flash_attention(...)`` on tensors that require grad,
    then ``backward()``, as a user trains through it: K2 then K3.
    ``k3_ptxas``: phase 1's registers and spills of K3's kernels."""
    from distributed_tpu_torch.ops import flash

    card = smi_line()
    inputs = {}
    for i, (label, n, nk, heads, dim, dtype, causal) in enumerate(BWD_CASES):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        inputs[label] = tuple(
            torch.randn((s, heads, dim), generator=g, device="cuda").to(dtype)
            for s in (n, nk, nk, n))  # q k v dO

    # the main path: forward and backward through autograd, [seq, heads, dim]
    flash.flash_forward_cuda.launches = 0
    flash.flash_backward_cuda.launches = 0
    grads = {}
    for label, n, nk, heads, dim, dtype, causal in BWD_CASES:
        q, k, v, do = (x.clone().requires_grad_(j < 3) for j, x in enumerate(inputs[label]))
        flash.flash_attention(q, k, v, causal=causal).backward(do)
        grads[label] = (q.grad, k.grad, v.grad)
    torch.cuda.synchronize()
    k2, k3 = flash.flash_forward_cuda.launches, flash.flash_backward_cuda.launches
    check(k3 == len(BWD_CASES), f"flash backward launches {k3} != {len(BWD_CASES)} backwards")
    check(k2 == len(BWD_CASES), f"flash forward launches {k2} in the autograd path")
    fwd_entry["launches"] += k2
    fwd_entry["launches_autograd"] = k2
    print(f"[{card}] flash autograd main path: K2 launches {k2}, K3 launches {k3} "
          f"(one each per backward)")

    results, err_max = {}, 0.0
    for label, n, nk, heads, dim, dtype, causal in BWD_CASES:
        q, k, v, do = inputs[label]
        for x, gr in zip((q, k, v), grads[label]):
            check(gr.shape == x.shape and gr.dtype == dtype, f"{label}: grad {gr.shape} {gr.dtype}")
            check(bool(torch.isfinite(gr.float()).all()), f"{label}: non-finite gradient")
        qt, kt, vt, dot = (x.transpose(0, 1).contiguous() for x in (q, k, v, do))
        scale = 1.0 / dim ** 0.5
        # identical residuals: K2's O and lse, as the Function saves them
        o, lse = flash.flash_forward_cuda(qt, kt, vt, causal, scale)
        res = (qt, kt, vt, o, lse, dot)
        got = flash.flash_backward_cuda(*res, causal, scale)
        again = flash.flash_backward_cuda(*res, causal, scale)
        check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{label}: two K3 calls differ")
        check(all(torch.equal(a, b.transpose(0, 1)) for a, b in zip(got, grads[label])),
              f"{label}: the autograd path's gradients are not K3's on its residuals")
        plain = flash.flash_backward_reference(*res, causal, scale)
        u = flash.P_ROUNDOFF.get(dtype, 0.0)
        terms = flash.bwd_rounding_terms(*res, causal, scale) if u else None
        excess = flash.bwd_excess(got, plain, terms)
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, plain)]
        fault_a, fault_b = flash.bwd_planted_faults(*res, causal, scale, plain)
        fault_excess = (flash.bwd_excess(fault_a, plain, terms)[1:],
                        flash.bwd_excess(fault_b, plain, terms)[0])
        # end to end: K2 + K3 against the plain forward + backward on the card
        o_p, lse_p = flash.flash_forward_reference(qt, kt, vt, causal, scale)
        e2e_plain = flash.flash_backward_reference(qt, kt, vt, o_p, lse_p, dot, causal, scale)
        e2e = [(a.transpose(0, 1).float() - b.float()).abs().max().item()
               / max(b.float().abs().max().item(), 1e-30)
               for a, b in zip(grads[label], e2e_plain)]
        del fault_a, fault_b, e2e_plain, o_p, lse_p, terms
        rtol, atol = flash.BWD_TOL[dtype]
        check(max(excess) <= 0.0, f"{label}: (dQ, dK, dV) beyond (rtol, atol) ({rtol}, {atol}) "
              f"+ u terms by {excess}, max abs err {errs}")
        check(max(fault_excess[0]) > 0.0, f"{label}: the check passes a q-tile left out of "
              f"dK/dV (excess {fault_excess[0]})")
        check(fault_excess[1] > 0.0, f"{label}: the check passes a k-tile left out of dQ "
              f"(excess {fault_excess[1]})")
        check(max(e2e) <= flash.E2E_RTOL[dtype], f"{label}: end to end off by {e2e} of max "
              f"|grad| > {flash.E2E_RTOL[dtype]}")

        ms = cuda_ms(lambda: flash.flash_backward_cuda(*res, causal, scale))
        plain_ms = cuda_ms(lambda: flash.flash_backward_reference(*res, causal, scale))
        qs, ks, vs = (x[None].requires_grad_() for x in (qt, kt, vt))
        out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                               scale=scale)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dot[None],
                                                     retain_graph=True))
        del out, qs, ks, vs
        bound_ms, bound_by = _bwd_bound_ms(n, nk, heads, dim, dtype, causal)
        body = "tensor cores" if u else "cuda cores"
        err_max = max(err_max, *errs)
        results[label] = dict(body=body, max_abs_err=max(errs), max_abs_err_dq_dk_dv=errs,
                              excess_dq_dk_dv=list(excess),
                              fault_excess_dk_dv=list(fault_excess[0]),
                              fault_excess_dq=fault_excess[1], e2e_rel_err_dq_dk_dv=e2e,
                              ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        print(f"[{card}] flash_bwd {label} seq {n}x{nk} heads {heads} dim {dim} ({body}): "
              f"max abs err dq/dk/dv {[f'{e:.3g}' for e in errs]} excess "
              f"{[f'{e:.3g}' for e in excess]} (planted faults: dk/dv "
              f"{[f'{e:.3g}' for e in fault_excess[0]]}, dq {fault_excess[1]:.3g}); end to end "
              f"{[f'{e:.3g}' for e in e2e]} of max |grad|; kernel_ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})")
        del res, got, again, plain, o, lse
        torch.cuda.empty_cache()
    head = results[FLASH_HEADLINE]
    return {
        "name": "flash_bwd",
        "route": "cuda",
        "source": "distributed_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "distributed_tpu/ops/flash.py:156",
        "launches": k3,
        "max_abs_err": err_max,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "case": FLASH_HEADLINE,
        "cases": results,
        "ptxas": k3_ptxas,
    }


# ------------------------------------------------------------ phase 2c


HEAD_DIM_CASES = [
    # (label, seq, heads, head dim, dtype, causal, K/V heads): the attention
    # of Phi-2, Phi-3-mini and Gemma 2 9B at full width (Gemma's 8 K/V
    # heads expanded to its 16 query heads: the kernels take one head
    # count), then the reference's own small shapes (tests/test_ring_attention.py
    # and its dry run: d = 16 and 8) and a d whose bf16 rows are not 16-byte
    # aligned
    ("phi2_d80_causal", 2048, 32, 80, torch.bfloat16, True, 32),
    ("phi3mini_d96_causal", 4096, 32, 96, torch.bfloat16, True, 32),
    ("phi3mini_d96", 4096, 32, 96, torch.bfloat16, False, 32),
    ("gemma2_d256_causal", 8192, 16, 256, torch.bfloat16, True, 8),
    ("gemma2_d256", 8192, 16, 256, torch.bfloat16, False, 8),
    ("d8_f32_causal", 256, 2, 8, torch.float32, True, 2),
    ("d8_f32", 256, 2, 8, torch.float32, False, 2),
    ("d8_bf16_causal", 256, 2, 8, torch.bfloat16, True, 2),
    ("d8_bf16", 256, 2, 8, torch.bfloat16, False, 2),
    ("d16_f32_causal", 256, 2, 16, torch.float32, True, 2),
    ("d16_f32", 256, 2, 16, torch.float32, False, 2),
    ("d16_bf16_causal", 256, 2, 16, torch.bfloat16, True, 2),
    ("d16_bf16", 256, 2, 16, torch.bfloat16, False, 2),
    ("d20_bf16_causal", 256, 2, 20, torch.bfloat16, True, 2),
    ("d20_bf16", 256, 2, 20, torch.bfloat16, False, 2),
]
HEAD_DIM_REPS = 5  # CUDA-event repetitions of K2, K3 and SDPA


def _head_dim_inputs(i, seq, heads, dim, dtype, kv_heads):
    """q, dO ``[seq, heads, dim]`` and k, v with ``kv_heads`` heads expanded
    to ``heads``, from a seeded generator on the card."""
    g = torch.Generator(device="cuda").manual_seed(200 + i)
    q, do = (torch.randn((seq, heads, dim), generator=g, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((seq, kv_heads, dim), generator=g, device="cuda").to(dtype)
            .repeat_interleave(heads // kv_heads, dim=1) for _ in range(2))
    return q, k, v, do


def phase_flash_head_dims(fwd_entry, bwd_entry):
    """Phase 2c: ``flash_attention(...).backward(dO)`` at head dims other
    than phase 2's, as a user trains through it: K2 then K3 on the
    instance that holds each head dim (``flash.kernel_head_dim``).  Each
    case against the plain versions on the card: K2's O within
    ``flash.O_TOL`` (+ u (P|V|)/l) and its lse within ``FLASH_TOL_LSE``,
    K3 within ``flash.BWD_TOL`` (+ u terms) on K2's residuals and end to
    end within ``flash.E2E_RTOL``, the planted faults of both rejected,
    two calls of each bit-identical; K2, K3, SDPA's forward and backward
    times (events) beside the plain versions' and the bounds at the true
    head dim.  Adds its launches and cases to phase 2's and 2b's entries."""
    from distributed_tpu_torch.ops import flash

    card = smi_line()
    inputs = {c[0]: _head_dim_inputs(i, *c[1:4], c[4], c[6]) for i, c in enumerate(HEAD_DIM_CASES)}
    # the main path: forward and backward through autograd, [seq, heads, dim]
    flash.flash_forward_cuda.launches = 0
    flash.flash_backward_cuda.launches = 0
    grads = {}
    for label, _, _, _, _, causal, _ in HEAD_DIM_CASES:
        q, k, v, do = (x.clone().requires_grad_(j < 3) for j, x in enumerate(inputs[label]))
        flash.flash_attention(q, k, v, causal=causal).backward(do)
        grads[label] = (q.grad, k.grad, v.grad)
    torch.cuda.synchronize()
    k2, k3 = flash.flash_forward_cuda.launches, flash.flash_backward_cuda.launches
    n_cases = len(HEAD_DIM_CASES)
    check(k2 == n_cases and k3 == n_cases, f"head-dim cases: K2 {k2}, K3 {k3} launches for "
          f"{n_cases} forward and backward calls")
    fwd_entry["launches"] += k2
    fwd_entry["launches_head_dims"] = k2
    bwd_entry["launches"] += k3
    bwd_entry["launches_head_dims"] = k3
    print(f"[{card}] head dims main path: K2 launches {k2}, K3 launches {k3} (one each a case)")

    for label, seq, heads, dim, dtype, causal, _ in HEAD_DIM_CASES:
        q, k, v, do = inputs[label]
        for x, gr in zip((q, k, v), grads[label]):
            check(gr.shape == x.shape and gr.dtype == dtype, f"{label}: grad {gr.shape} {gr.dtype}")
            check(bool(torch.isfinite(gr.float()).all()), f"{label}: non-finite gradient")
        qt, kt, vt, dot = (x.transpose(0, 1).contiguous() for x in (q, k, v, do))
        scale = 1.0 / dim ** 0.5
        u = flash.P_ROUNDOFF.get(dtype, 0.0)
        # K2 against the plain forward, twice, and its planted fault
        o, lse = flash.flash_forward_cuda(qt, kt, vt, causal, scale)
        o2, lse2 = flash.flash_forward_cuda(qt, kt, vt, causal, scale)
        check(torch.equal(o, o2) and torch.equal(lse, lse2), f"{label}: two K2 calls differ")
        o_p, lse_p = flash.flash_forward_reference(qt, kt, vt, causal, scale)
        pv_term = u * flash.pv_rounding_term(qt, kt, vt, causal, scale, lse_p) if u else 0.0
        err_o = (o.float() - o_p.float()).abs().max().item()
        err_lse = (lse - lse_p).abs().max().item()
        excess_o = flash.o_excess(o, o_p, pv_term)
        fault_o = flash.o_excess(_drop_keys(qt, kt, vt, causal, scale, o_p, lse_p), o_p, pv_term)
        del pv_term, o2, lse2
        check(excess_o <= 0.0, f"{label}: O off by {excess_o} beyond {flash.O_TOL[dtype]} + u "
              f"(P|V|)/l, max abs err {err_o}")
        check(fault_o > 0.0, f"{label}: the O check passes a planted fault")
        check(err_lse <= FLASH_TOL_LSE, f"{label}: lse max abs err {err_lse} > {FLASH_TOL_LSE}")
        # K3 on K2's residuals against the plain backward, twice, its faults
        res = (qt, kt, vt, o, lse, dot)
        got = flash.flash_backward_cuda(*res, causal, scale)
        again = flash.flash_backward_cuda(*res, causal, scale)
        check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{label}: two K3 calls differ")
        check(all(torch.equal(a, b.transpose(0, 1)) for a, b in zip(got, grads[label])),
              f"{label}: the autograd path's gradients are not K3's on its residuals")
        plain = flash.flash_backward_reference(*res, causal, scale)
        terms = flash.bwd_rounding_terms(*res, causal, scale) if u else None
        excess = flash.bwd_excess(got, plain, terms)
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, plain)]
        fault_a, fault_b = flash.bwd_planted_faults(*res, causal, scale, plain)
        fault_excess = (max(flash.bwd_excess(fault_a, plain, terms)[1:]),
                        flash.bwd_excess(fault_b, plain, terms)[0])
        e2e_plain = flash.flash_backward_reference(qt, kt, vt, o_p, lse_p, dot, causal, scale)
        e2e = [(a.transpose(0, 1).float() - b.float()).abs().max().item()
               / max(b.float().abs().max().item(), 1e-30)
               for a, b in zip(grads[label], e2e_plain)]
        del fault_a, fault_b, e2e_plain, terms, again, o_p, lse_p
        check(max(excess) <= 0.0, f"{label}: (dQ, dK, dV) beyond {flash.BWD_TOL[dtype]} + u terms "
              f"by {excess}, max abs err {errs}")
        check(min(fault_excess) > 0.0, f"{label}: the K3 check passes a planted fault "
              f"(excess dK/dV, dQ {fault_excess})")
        check(max(e2e) <= flash.E2E_RTOL[dtype], f"{label}: end to end off by {e2e} of max "
              f"|grad| > {flash.E2E_RTOL[dtype]}")
        # times: the kernels, the plain versions, SDPA (measured only)
        k2_ms = cuda_ms(lambda: flash.flash_forward_cuda(qt, kt, vt, causal, scale),
                        reps=HEAD_DIM_REPS)
        k3_ms = cuda_ms(lambda: flash.flash_backward_cuda(*res, causal, scale), reps=HEAD_DIM_REPS)
        plain_fwd_ms = cuda_ms(lambda: flash.flash_forward_reference(qt, kt, vt, causal, scale))
        plain_bwd_ms = cuda_ms(lambda: flash.flash_backward_reference(*res, causal, scale))
        qs, ks, vs = (x[None].requires_grad_() for x in (qt, kt, vt))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_fwd_ms = cuda_ms(lambda: sdpa(qs, ks, vs, is_causal=causal, scale=scale),
                             reps=HEAD_DIM_REPS)
        out = sdpa(qs, ks, vs, is_causal=causal, scale=scale)
        lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dot[None],
                                                         retain_graph=True), reps=HEAD_DIM_REPS)
        del out, qs, ks, vs
        fwd_bound, fwd_by = _flash_bound_ms(seq, heads, dim, dtype, causal)
        bwd_bound, bwd_by = _bwd_bound_ms(seq, seq, heads, dim, dtype, causal)
        instance = flash.kernel_head_dim(dim)
        fwd_entry["cases"][label] = dict(
            instance=instance, max_abs_err=err_o, lse_err=err_lse, o_excess=excess_o,
            fault_excess=fault_o, ms=k2_ms, plain_ms=plain_fwd_ms, library_ms=lib_fwd_ms,
            bound_ms=fwd_bound, bound_by=fwd_by)
        bwd_entry["cases"][label] = dict(
            instance=instance, max_abs_err=max(errs), max_abs_err_dq_dk_dv=errs,
            excess_dq_dk_dv=list(excess), fault_excess_dk_dv_dq=list(fault_excess),
            e2e_rel_err_dq_dk_dv=e2e, ms=k3_ms, plain_ms=plain_bwd_ms, library_ms=lib_bwd_ms,
            bound_ms=bwd_bound, bound_by=bwd_by)
        bwd_entry["max_abs_err"] = max(bwd_entry["max_abs_err"], *errs)
        print(f"[{card}] flash {label} seq {seq} heads {heads} dim {dim} (instance {instance}): "
              f"K2 err_o {err_o:.3g} excess {excess_o:.3g} (fault {fault_o:.3g}) err_lse "
              f"{err_lse:.3g}; K3 max abs err {[f'{e:.3g}' for e in errs]} excess "
              f"{[f'{e:.3g}' for e in excess]} (faults {[f'{e:.3g}' for e in fault_excess]}), end "
              f"to end {[f'{e:.3g}' for e in e2e]}; K2 ms {k2_ms:.4f} bound {fwd_bound:.4f} "
              f"({fwd_by}) plain {plain_fwd_ms:.3f} SDPA fwd {lib_fwd_ms:.4f}; K3 ms {k3_ms:.4f} "
              f"bound {bwd_bound:.4f} ({bwd_by}) plain {plain_bwd_ms:.3f} SDPA bwd "
              f"{lib_bwd_ms:.4f} (events, median of {HEAD_DIM_REPS})")
        del res, got, plain, o, lse
        torch.cuda.empty_cache()
    del inputs, grads
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 3


def _fleets():
    uniform = (np.full(N_WORKERS, THREADS, np.int32),
               np.zeros(N_WORKERS, np.float32), np.ones(N_WORKERS, bool))
    running = np.ones(N_WORKERS, bool)
    running[:8] = False
    mixed = (np.full(N_WORKERS, THREADS, np.int32),
             np.random.default_rng(1).uniform(0, 5, N_WORKERS).astype(np.float32),
             running)
    return {"uniform": uniform, "nonuniform": mixed}


@contextlib.contextmanager
def deterministic():
    """Deterministic torch kernels (index_add_ without atomics) inside."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _quality(run, res, running):
    occ = res.occupancy[running]
    share = np.bincount(res.choice, minlength=3) / len(res.choice)
    return dict(imbalance=float(occ.max() / occ.mean()),
                makespan=float(run.spans.sum().item()), share=share)


def _same(a, b):
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("assignment", "choice", "occupancy", "start_time"))


def _lockstep(run, leveled):
    """From the plain version's state before each wave, run the kernel
    on a copy of it and compare: (min agreement, max load error on
    workers untouched by a disagreeing task, disagreeing tasks)."""
    run.reset()
    min_agree, max_err, flips = 1.0, 0.0, 0
    for wave in range(run.packed.n_levels):
        off, f = run.wave_bounds(wave)
        saved = (run.assign.clone(), run.choices.clone(), run.load.clone(), run.spans.clone())
        leveled.place_wave_cuda(run, wave)
        a_k, load_k = run.assign[off:off + f].clone(), run.load.clone()
        for dst, src in zip((run.assign, run.choices, run.load, run.spans), saved):
            dst.copy_(src)
        leveled.place_wave_reference(run, wave)
        a_p = run.assign[off:off + f]
        differ = a_k != a_p
        n_diff = int(differ.sum().item())
        touched = torch.zeros(run.fleet.W, dtype=torch.bool, device=run.device)
        touched[a_k[differ].long()] = True
        touched[a_p[differ].long()] = True
        ok = ~touched
        err = (load_k - run.load)[ok].abs().max().item() if bool(ok.any()) else 0.0
        rel = err / max(run.load.abs().max().item(), 1e-30)
        check(rel <= K1_LOAD_RTOL, f"wave {wave}: load error {err} (rel {rel}) > {K1_LOAD_RTOL}")
        agree = 1.0 - n_diff / f
        check(agree >= K1_MIN_AGREEMENT, f"wave {wave}: agreement {agree} < {K1_MIN_AGREEMENT}")
        min_agree, max_err, flips = min(min_agree, agree), max(max_err, err), flips + n_diff
    return min_agree, max_err, flips


def _k1_bound_ms(packed, W, wire_bytes=16):
    """Least time for the whole graph's waves: each input read once (the
    wire, 16 B/task f16 or 11 B/task packed, the fleet tables), each
    output written once (i32 assign and choice per task, the load, the
    spans); about 40 f32 operations a task (two rounds of three costs,
    two argmins, two sums) plus a W log W sort of the workers per wave."""
    T, L = packed.n, packed.n_levels
    nbytes = wire_bytes * T + 8 * T + 13 * W + 4 * W + 4 * L
    flops = 40 * T + L * W * max(W.bit_length() - 1, 1)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_placement():
    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.ops import leveled

    durations, out_bytes, src, dst = graphs.random_dag(N_TASKS, seed=0)
    fleets = _fleets()

    # the main path: pack_graph + place_graph_leveled as a user calls them
    leveled.place_waves_cuda.launches = 0
    packs, results, pack_ms = {}, {}, {}
    for name, fleet in fleets.items():
        t0 = time.perf_counter()
        packs[name] = leveled.pack_graph(durations, out_bytes, src, dst)
        pack_ms[name] = (time.perf_counter() - t0) * 1e3
        results[name] = leveled.place_graph_leveled(packs[name], *fleet)
    launches = leveled.place_waves_cuda.launches
    n_waves = sum(p.n_levels for p in packs.values())
    check(launches == len(fleets), f"wave kernel launches {launches} != graph runs {len(fleets)}")
    print(f"placement main path: wave kernel launches {launches} (one per graph run) "
          f"over {n_waves} waves")

    entry = None
    for name, fleet in fleets.items():
        packed, res, running = packs[name], results[name], fleet[2]
        leveled.validate_leveled(packed, res, src, dst, running)
        check(np.isfinite(res.start_time).all() and np.isfinite(res.occupancy).all(),
              f"{name}: non-finite result")

        # the kernel against the plain version on the CPU: bit for bit
        t0 = time.perf_counter()
        res_cpu = leveled.place_graph_leveled(packed, *fleet, device="cpu")
        cpu_s = time.perf_counter() - t0
        err = max(float(np.abs(res.occupancy - res_cpu.occupancy).max()),
                  float(np.abs(res.start_time - res_cpu.start_time).max()))
        same = _same(res, res_cpu)
        print(f"placement {name}: kernel vs plain on the CPU ({cpu_s:.1f} s): "
              f"identical {same}, assignment agreement "
              f"{float((res.assignment == res_cpu.assignment).mean()):.6f}, max abs err {err:.3g}")
        check(same, f"{name}: kernel differs from the plain version on the CPU")

        # against the plain version on the card: the quality gate
        run = leveled.LeveledRun(packed, *fleet)
        with deterministic():
            run.run_waves(leveled.place_wave_reference)
        res_p = run.download()
        leveled.validate_leveled(packed, res_p, src, dst, running)
        q_p = _quality(run, res_p, running)
        run.reset()
        run.run_waves()
        res_k = run.download()
        check(_same(res_k, res), f"{name}: two kernel runs differ")
        run.reset()
        run.run_waves(leveled.place_wave_cuda)
        check(_same(run.download(), res), f"{name}: per-wave launches differ from one launch")
        q_k = _quality(run, res_k, running)
        agreement = float((res_k.assignment == res_p.assignment).mean())
        d_imb = abs(q_k["imbalance"] - q_p["imbalance"]) / q_p["imbalance"]
        d_mk = abs(q_k["makespan"] - q_p["makespan"]) / q_p["makespan"]
        d_share = float(np.abs(q_k["share"] - q_p["share"]).max())
        print(f"placement {name}: waves {packed.n_levels} imbalance {q_k['imbalance']:.6f} "
              f"(plain {q_p['imbalance']:.6f}) makespan {q_k['makespan']:.4f} "
              f"(plain {q_p['makespan']:.4f}) choice share {q_k['share'].round(5).tolist()} "
              f"(plain {q_p['share'].round(5).tolist()}) raw agreement {agreement:.6f}")
        check(bool(running[res_k.assignment].all()), f"{name}: task on a stopped worker")
        check(d_imb <= QUALITY_RTOL, f"{name}: imbalance off by {d_imb}")
        check(d_mk <= QUALITY_RTOL, f"{name}: makespan off by {d_mk}")
        check(d_share <= QUALITY_CHOICE_PP, f"{name}: choice share off by {d_share}")

        with deterministic():
            min_agree, load_err, flips = _lockstep(run, leveled)
        print(f"placement {name}: per-wave lockstep with the plain version on the card: "
              f"min agreement {min_agree:.6f} flipped tasks {flips} max load err {load_err:.3g}")

        def whole_graph():
            r = leveled.LeveledRun(packed, *fleet)
            r.run_waves()
            r.codes().cpu(), r.spans.cpu(), r.load.cpu()

        device_ms = cuda_ms(whole_graph, reps=3, warmup=1)
        # where device_ms goes: host staging + upload, waves, download
        upload_ms = cuda_ms(lambda: leveled.LeveledRun(packed, *fleet), reps=3, warmup=1)
        download_ms = cuda_ms(lambda: run.codes().cpu(), reps=3, warmup=1)
        codes = run.codes().cpu().numpy().astype(np.int32)
        spans_h, load_h = run.spans.cpu().numpy(), run.load.cpu().numpy()
        t0 = time.perf_counter()
        leveled._finalize(packed, codes, spans_h, load_h)
        finalize_ms = (time.perf_counter() - t0) * 1e3

        def waves(fn=None):
            run.reset()
            run.run_waves(fn)

        ms = cuda_ms(waves)
        plain_ms = cuda_ms(lambda: waves(leveled.place_wave_reference))
        bound_ms, bound_by = _k1_bound_ms(packed, N_WORKERS)
        print(f"placement {name}: pack_ms {pack_ms[name]:.1f} device_ms {device_ms:.3f} "
              f"(upload_ms {upload_ms:.3f} download_ms {download_ms:.3f}) "
              f"finalize_ms {finalize_ms:.1f} waves {packed.n_levels} kernel_ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})")
        case = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, device_ms=device_ms, upload_ms=upload_ms,
                    download_ms=download_ms, finalize_ms=finalize_ms,
                    pack_ms=pack_ms[name], card_plain_agreement=agreement,
                    card_plain_min_wave_agreement=min_agree,
                    card_plain_load_err=load_err)
        if entry is None:
            entry = {
                "name": "place_wave",
                "route": "cuda",
                "source": "distributed_tpu_torch/ops/csrc/place_wave.cu",
                "replaces": "distributed_tpu/ops/leveled.py:326",
                "launches": launches,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
                "case": name,
                "cases": {},
            }
        entry["cases"][name] = case
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return entry, results


# ------------------------------------------------------------ phase 4


NORTH_STAR_MS = 250.0        # the placement wall at 1M tasks / 512 workers
BANDWIDTH, LATENCY = 100e6, 0.001  # pack_graph's defaults, as phase 3 packs
STREAM_REPS = 3
# the reference's gate for its packed wire against the f16 wire
# (tests/test_leveled_streamed.py:116-122)
PACKED_RTOL, PACKED_ATOL, PACKED_MIN_AGREEMENT = 1.15, 0.05, 0.5


def _streamed_launches(offsets, chunk_rows, T):
    """Launches of the streamed driver: the chunks after which at least
    one more wave's last row has landed."""
    C = min(chunk_rows, T)
    return len(set(((offsets[1:].astype(np.int64) + C - 1) // C).tolist()))


def _result_quality(res, running):
    occ = res.occupancy[running]
    return dict(imbalance=float(occ.max() / occ.mean()), makespan=float(res.spans.sum()),
                share=np.bincount(res.choice, minlength=3) / len(res.choice))


def _median(runs, key):
    return statistics.median(r[key] for r in runs)


def phase_streamed(entry, oneshot):
    """Phase 4: the scheduler's placement path, ``place_graph_streamed`` as
    the leveled branch of ``_plan_from_arrays`` calls it (the packed wire
    on the card), then the plan's hints (``scheduler/plan.py``)."""
    import inspect

    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.ops import leveled
    from distributed_tpu_torch.scheduler import plan

    card = smi_line()
    graph = graphs.random_dag(N_TASKS, seed=0)
    src, dst = graph[2], graph[3]
    fleets = _fleets()
    keys = [f"task-{i}" for i in range(N_TASKS)]
    addrs = [f"tcp://10.1.{w // 256}.{w % 256}:8788" for w in range(N_WORKERS)]
    chunk_rows = inspect.signature(leveled.place_graph_streamed).parameters["chunk_rows"].default

    # the main path, as the scheduler plans a batch
    leveled.place_waves_cuda.launches = 0
    main, hints, hints_ms = {}, {}, {}
    for name, fleet in fleets.items():
        tm = {}
        packed, res = leveled.place_graph_streamed(
            *graph, *fleet, bandwidth=BANDWIDTH, latency=LATENCY, timings=tm)
        t0 = time.perf_counter()
        hints[name] = plan.hints_from_placement(keys, packed, res, addrs)
        hints_ms[name] = (time.perf_counter() - t0) * 1e3
        main[name] = (packed, res, tm)
    torch.cuda.synchronize()
    launches = leveled.place_waves_cuda.launches
    want = sum(_streamed_launches(p.offsets, chunk_rows, N_TASKS) for p, _, _ in main.values())
    check(launches == want, f"streamed wave launches {launches} != chunks completing a wave {want}")
    print(f"[{card}] streamed main path: wave kernel launches {launches} (one per chunk "
          f"that completed a wave, chunks of {chunk_rows} rows)")

    report = {}
    for name, fleet in fleets.items():
        packed, res, tm = main[name]
        running = fleet[2]
        check(tm["fmt"] == "packed", f"{name}: streamed fmt {tm['fmt']} on the card")
        check("fallback" not in tm, f"{name}: the streamed driver fell back")
        check(tm["launches"] == _streamed_launches(packed.offsets, chunk_rows, N_TASKS),
              f"{name}: {tm['launches']} launches")
        leveled.validate_leveled(packed, res, src, dst, running)
        check(np.isfinite(res.start_time).all() and np.isfinite(res.occupancy).all(),
              f"{name}: non-finite result")
        h = hints[name]
        check(len(h) == N_TASKS and set(a for _, a in h.values()) <= set(addrs),
              f"{name}: {len(h)} hints")
        check(sum(f is not None for f, _ in h.values()) == int((res.choice < 2).sum()),
              f"{name}: follow hints differ from the locality choices")

        # the packed run on the card against the same driver on the CPU
        t0 = time.perf_counter()
        _, res_cpu = leveled.place_graph_streamed(
            *graph, *fleet, bandwidth=BANDWIDTH, latency=LATENCY, compact=True, device="cpu")
        cpu_s = time.perf_counter() - t0
        err = max(float(np.abs(res.occupancy - res_cpu.occupancy).max()),
                  float(np.abs(res.start_time - res_cpu.start_time).max()))
        check(_same(res, res_cpu), f"{name}: packed streamed run differs from the CPU run")
        # compact=False on the card against phase 3's one-shot result
        _, exact = leveled.place_graph_streamed(
            *graph, *fleet, bandwidth=BANDWIDTH, latency=LATENCY, compact=False)
        check(_same(exact, oneshot[name]), f"{name}: compact=False differs from the one-shot driver")
        q_p, q_e = _result_quality(res, running), _result_quality(exact, running)
        d_imb = abs(q_p["imbalance"] - q_e["imbalance"]) / q_e["imbalance"]
        d_mk = abs(q_p["makespan"] - q_e["makespan"]) / q_e["makespan"]
        d_share = float(np.abs(q_p["share"] - q_e["share"]).max())
        agreement = float((res.assignment == exact.assignment).mean())
        print(f"[{card}] streamed {name}: packed == CPU plain run ({cpu_s:.1f} s); "
              f"compact=False == one-shot; packed vs f16 wire: imbalance "
              f"{q_p['imbalance']:.6f} / {q_e['imbalance']:.6f}, makespan {q_p['makespan']:.4f} / "
              f"{q_e['makespan']:.4f}, share {q_p['share'].round(5).tolist()} / "
              f"{q_e['share'].round(5).tolist()}, agreement {agreement:.6f}")
        # the packed wire's quantized costs change the plan: held to the
        # reference's own gate for that wire (imbalance, and here makespan,
        # within 15 % + 0.05, over half the assignments equal) and phase
        # 3's choice-share gate.  Phase 3's 1 % on imbalance and makespan
        # does not hold on the non-uniform fleet, for the reference's
        # packed wire either (PERF.md, port slice 3).
        print(f"[{card}] streamed {name}: packed vs f16 wire: imbalance off by {d_imb:.5f}, "
              f"makespan by {d_mk:.5f}, choice share by {d_share:.5f}")
        check(q_p["imbalance"] < q_e["imbalance"] * PACKED_RTOL + PACKED_ATOL,
              f"{name}: packed imbalance {q_p['imbalance']} against {q_e['imbalance']}")
        check(q_p["makespan"] < q_e["makespan"] * PACKED_RTOL + PACKED_ATOL,
              f"{name}: packed makespan {q_p['makespan']} against {q_e['makespan']}")
        check(agreement > PACKED_MIN_AGREEMENT, f"{name}: packed agreement {agreement}")
        check(d_share <= QUALITY_CHOICE_PP, f"{name}: packed choice share off by {d_share}")

        # the host pack: C++ against numpy, in this call
        cpp_ms = []
        for _ in range(STREAM_REPS):
            t0 = time.perf_counter()
            leveled.pack_graph(*graph, bandwidth=BANDWIDTH, latency=LATENCY)
            cpp_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        leveled.pack_graph_numpy(*graph, bandwidth=BANDWIDTH, latency=LATENCY)
        numpy_ms = (time.perf_counter() - t0) * 1e3

        # the placement wall of both wire formats, after the main path's run
        walls = {}
        for fmt, compact in (("packed", "auto"), ("f16", False)):
            runs = []
            for _ in range(STREAM_REPS):
                tm_r = {}
                leveled.place_graph_streamed(*graph, *fleet, bandwidth=BANDWIDTH,
                                             latency=LATENCY, compact=compact, timings=tm_r)
                check(tm_r["fmt"] == fmt, f"{name}: fmt {tm_r['fmt']} != {fmt}")
                runs.append(tm_r)
            walls[fmt] = w = {k: _median(runs, k) for k in (
                "total_s", "topo_s", "fill_wait_s", "encode_s", "upload_ms", "waves_ms",
                "wait_s", "finalize_s")}
            walls[fmt]["total_s_runs"] = [r["total_s"] for r in runs]
            print(f"[{card}] streamed {name} fmt {fmt} (median of {STREAM_REPS}): "
                  f"total_ms {w['total_s'] * 1e3:.2f} topo_ms {w['topo_s'] * 1e3:.2f} "
                  f"fill_wait_ms {w['fill_wait_s'] * 1e3:.2f} encode_ms {w['encode_s'] * 1e3:.2f} "
                  f"upload_ms {w['upload_ms']:.3f} waves_ms {w['waves_ms']:.3f} "
                  f"final_segment_wait_ms {w['wait_s'] * 1e3:.3f} "
                  f"finalize_ms {w['finalize_s'] * 1e3:.2f}: a wall of {w['total_s'] * 1e3:.2f} ms "
                  f"against the {NORTH_STAR_MS:.0f} ms north star")
        print(f"[{card}] streamed {name}: pack_ms C++ {statistics.median(cpp_ms):.2f} "
              f"(runs {[round(x, 2) for x in cpp_ms]}) numpy {numpy_ms:.1f}; main-path run "
              f"total_ms {tm['total_s'] * 1e3:.2f}; hints_ms {hints_ms[name]:.1f}")

        # K1 on the packed wire: the kernel against its plain version
        run = leveled.LeveledRun(packed, *fleet, fmt="packed")

        def waves(fn=None):
            run.reset()
            run.run_waves(fn)

        ms = cuda_ms(waves)
        plain_ms = cuda_ms(lambda: waves(leveled.place_wave_reference), reps=3, warmup=1)
        bound_ms, bound_by = _k1_bound_ms(packed, N_WORKERS, wire_bytes=11)
        print(f"[{card}] place_wave {name}_packed: launches {tm['launches']} max_abs_err {err:.3g} "
              f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})")
        entry["cases"][f"{name}_packed"] = dict(
            launches=tm["launches"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        report[name] = dict(pack_ms_cpp=statistics.median(cpp_ms), pack_ms_numpy=numpy_ms,
                            main_total_ms=tm["total_s"] * 1e3, hints_ms=hints_ms[name],
                            walls=walls, agreement_packed_f16=agreement, cpu_s=cpu_s)
        del run
        torch.cuda.empty_cache()
    entry["launches"] += launches
    entry["launches_streamed"] = launches
    print(json.dumps({"streamed": report, "card": card}))
    return hints["uniform"]


# ------------------------------------------------------------ phase 5


PART_TASKS = 16_384          # the largest graph the router sends to K4 on 1024 lanes
LEVELED_TASKS = 32_768       # bucket 32768 x 1008 or 1024 lanes > DENSE_LIMIT
# one machine's LocalCluster on 16 cores, 4 workers x 4 threads: 16 lanes,
# where the router sends the partitioner up to 1,048,576 tasks
FEW_WORKERS, FEW_THREADS = 4, 4
# the partitioner's plans: (graph, fleet), blockwise96 the proxy at full
# size (903,168 tasks, 2,654,208 edges); phase 5 adds random32768 on the
# 512-worker fleets, which the router sends to the leveled engine
PART_PLANS = [("blockwise24", "uniform"), ("blockwise24", "nonuniform"),
              ("random16384", "uniform"), ("random16384", "nonuniform"),
              ("random1m", "fewlane"), ("blockwise96", "fewlane")]
# K4 adds every score cell and lane load in the reference's order: it must
# equal the plain version on the CPU bit for bit.  The plain version on the
# card sums with CUDA's index_add_ (deterministic mode), in its own order,
# so against it near-ties may move tasks; the plan must then cost about the
# same: comm volume and the heaviest lane's load within 1 %.
K4_RTOL = 0.01
K4_LAUNCHES_PER_PLAN = 1         # all rounds in one cooperative launch
FADD_CYCLES = 4                  # latency of a dependent f32 add on an SM


def partition_fleets():
    """Phase 3's two fleets (1,024 and 1,008 lanes) and ``fewlane`` (16
    lanes, all running, idle), each with its workers' addresses."""
    fleets = _fleets()
    fleets["fewlane"] = (np.full(FEW_WORKERS, FEW_THREADS, np.int32),
                         np.zeros(FEW_WORKERS, np.float32), np.ones(FEW_WORKERS, bool))
    addrs = [f"tcp://10.1.{w // 256}.{w % 256}:8788" for w in range(N_WORKERS)]
    few = [f"tcp://10.2.0.{w}:8788" for w in range(FEW_WORKERS)]
    return fleets, {"uniform": addrs, "nonuniform": addrs, "fewlane": few}


def partition_graph(graphs, g):
    """(durations, out_bytes, src, dst) of phase 5's graph ``g``."""
    if g.startswith("blockwise"):
        return tuple(graphs.blockwise_tensordot(int(g[len("blockwise"):]))[1:])
    n = {"random16384": PART_TASKS, "random32768": LEVELED_TASKS, "random1m": N_TASKS}[g]
    return graphs.random_dag(n, seed=0)


def sm_clock_mhz():
    """The card's highest SM clock, MHz (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip())


def _chain_ms(part, run, sm_mhz):
    """The floor the contract puts under K4's load pass, whatever its
    design: a lane's load is its tasks' durations added in task order, a
    chain of dependent f32 adds.  Per round the fullest lane's chain, at
    FADD_CYCLES an add and the SM clock.  The labels at each round's start
    are the kernel's after that many rounds (equal to the plain version's)."""
    iters, adds = run.iters, 0
    try:
        for r in range(iters):
            run.iters = r
            part.partition_cuda(run)
            adds += int(np.bincount(run.result(), minlength=run.W).max())
    finally:
        run.iters = iters
    part.partition_cuda(run)
    return adds * FADD_CYCLES / (sm_mhz * 1e3)


def _comm_volume(labels, src, dst):
    """Unique (producer, consumer-lane) cross pairs: the peer fetches after
    replica caching (tests/test_partition.py's measure)."""
    cross = labels[src] != labels[dst]
    return len(set(zip(src[cross].tolist(), labels[dst[cross]].tolist())))


def _max_load(labels, durations, W):
    return float(np.bincount(labels, weights=durations, minlength=W).max())


def _k4_bound_ms(run):
    """Least time for the rounds: each input read once (durations, initial
    labels, the edges' two endpoints and weight), the labels written once;
    and the operations these inputs need, not the dense [T, W] form: per
    round an add a task for the loads, an add an edge in each direction
    for the scores, and a compare a lane for the blocked flags and one for
    the first unblocked lane (a task's best lane among those its edges do
    not touch); for each task of the round's parity the bonus (a max and
    an add) and its first maximum over the candidates: a compare for each
    lane its edges touch, its own lane and its first unblocked lane that
    no edge touches (at most one more than its edges)."""
    T, E, W, R = run.T, run.E, run.W, run.iters
    _, _, src, dst = run.host
    deg = np.bincount(src, minlength=T) + np.bincount(dst, minlength=T)
    row_ops = [int(2 * deg[p::2].sum()) + 4 * len(deg[p::2]) for p in (0, 1)]
    nbytes = 3 * 4 * T + 3 * 4 * E
    ops = R * (T + 2 * E + 2 * W) + sum(row_ops[it % 2] for it in range(R))
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_partition(wave_entry, hints_1m):
    """Phase 5: the scheduler's placement extension, ``TorchPlacement``, as
    its planner thread calls it (``_plan_from_arrays``): graphs the router
    sends to the partitioner (kernel K4) and, past DENSE_LIMIT, to the
    leveled engine (K1), whose launches here join ``wave_entry``'s."""
    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.ops import leveled
    from distributed_tpu_torch.ops import partition as part
    from distributed_tpu_torch.scheduler import plan
    from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement

    card = smi_line()
    sm_mhz = sm_clock_mhz()
    fleets, addrs = partition_fleets()
    plans = PART_PLANS + [("random32768", "uniform"), ("random32768", "nonuniform")]
    cases = {g: partition_graph(graphs, g) for g, _ in plans}
    routed = {g: "leveled" if g == "random32768" else "partition" for g in cases}
    keys = {g: [f"{g}-{i}" for i in range(len(c[0]))] for g, c in cases.items()}
    placement = TorchPlacement(sync=True)
    check(placement.device.type == "cuda", f"TorchPlacement on {placement.device}")

    def plan_args(g, f):
        return (keys[g], *cases[g], *fleets[f], addrs[f], BANDWIDTH, LATENCY)

    # the main path, as the planner thread plans each batch
    part.partition_cuda.launches = 0
    leveled.place_waves_cuda.launches = 0
    main, walls = {}, {}
    for g, f in plans:
        t0 = time.perf_counter()
        main[g, f] = placement._plan_from_arrays(*plan_args(g, f))
        torch.cuda.synchronize()
        walls[g, f] = (time.perf_counter() - t0) * 1e3
    k4_launches = part.partition_cuda.launches
    k1_launches = leveled.place_waves_cuda.launches
    n_part = sum(routed[g] == "partition" for g, _ in main)
    n_lev = len(main) - n_part
    check(k4_launches == n_part * K4_LAUNCHES_PER_PLAN,
          f"K4 launches {k4_launches} != {n_part} partitions x {K4_LAUNCHES_PER_PLAN}")
    # below min_stream the streamed driver packs and makes one launch
    check(k1_launches == n_lev, f"K1 launches {k1_launches} != {n_lev} leveled plans")
    check(placement.enabled, "the planner disabled itself")
    wave_entry["launches"] += k1_launches
    wave_entry["launches_extension"] = k1_launches
    print(f"[{card}] placement extension main path: K4 launches {k4_launches} "
          f"({n_part} partitions x {K4_LAUNCHES_PER_PLAN}), K1 launches {k1_launches}")

    cases_out, err_max = {}, 0.0
    for (g, f), hints in main.items():
        durations, out_bytes, src, dst = cases[g]
        nthreads, _, running = fleets[f]
        T = len(durations)
        lanes = [int(w) for w in np.flatnonzero(running)
                 for _ in range(max(int(nthreads[w]), 1))]
        W = len(lanes)
        follows = sum(fk is not None for fk, _ in hints.values())
        check(len(hints) == T, f"{g} {f}: {len(hints)} hints")
        check(set(a for _, a in hints.values()) <= set(addrs[f]), f"{g} {f}: foreign addresses")
        want_route = "partition" if part._bucket(T) * W <= part.DENSE_LIMIT else "leveled"
        check(want_route == routed[g], f"{g} {f}: routed {want_route}, expected {routed[g]}")
        check((follows == 0) == (routed[g] == "partition"), f"{g} {f}: {follows} follow hints")
        t0 = time.perf_counter()
        cpu_hints = TorchPlacement(sync=True, device="cpu")._plan_from_arrays(*plan_args(g, f))
        cpu_s = time.perf_counter() - t0
        check(hints == cpu_hints, f"{g} {f}: hints differ from the CPU run")
        if routed[g] != "partition":
            print(f"[{card}] plan {g} {f}: T {T} lanes {W} -> leveled engine, hints == CPU run, "
                  f"wall_ms {walls[g, f]:.2f}")
            continue

        # K4 against the plain version on the CPU, bit for bit
        weights = (out_bytes[src] / BANDWIDTH + LATENCY).astype(np.float32)
        run = part.PartitionRun(durations, weights, src, dst, W)
        part.partition_cuda(run)
        labels = run.result()
        cpu = part.PartitionRun(durations, weights, src, dst, W, device="cpu")
        part.partition_reference(cpu)
        labels_cpu = cpu.result()
        check(np.array_equal(labels, labels_cpu), f"{g} {f}: K4 labels differ from the CPU run "
              f"({int((labels != labels_cpu).sum())} of {T})")
        load_k = np.bincount(labels, weights=durations.astype(np.float64), minlength=W)
        load_c = np.bincount(labels_cpu, weights=durations.astype(np.float64), minlength=W)
        err = float(np.abs(load_k - load_c).max())
        err_max = max(err_max, err)
        # the plain version on the card, deterministic
        card_run = part.PartitionRun(durations, weights, src, dst, W)
        with deterministic():
            part.partition_reference(card_run)
        labels_p = card_run.result()
        vol_k, vol_p = _comm_volume(labels, src, dst), _comm_volume(labels_p, src, dst)
        vol_b = _comm_volume(part.block_init(durations, W), src, dst)
        ml_k, ml_p = _max_load(labels, durations, W), _max_load(labels_p, durations, W)
        agree = float((labels == labels_p).mean())
        check(abs(vol_k - vol_p) <= K4_RTOL * vol_p, f"{g} {f}: comm volume {vol_k} vs plain {vol_p}")
        check(ml_k <= ml_p * (1 + K4_RTOL), f"{g} {f}: max lane load {ml_k} vs plain {ml_p}")
        check(vol_k < vol_b, f"{g} {f}: comm volume {vol_k} does not beat the blocks' {vol_b}")

        ms = cuda_ms(lambda: part.partition_cuda(run))
        plain_ms = cuda_ms(lambda: part.partition_reference(card_run), reps=5, warmup=1)
        bound_ms, bound_by = _k4_bound_ms(run)
        chain_ms = _chain_ms(part, run, sm_mhz)
        t0 = time.perf_counter()
        plan.hints_from_partition(keys[g], labels, lanes, addrs[f])
        hints_ms = (time.perf_counter() - t0) * 1e3
        plan_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            placement._plan_from_arrays(*plan_args(g, f))
            plan_ms.append((time.perf_counter() - t0) * 1e3)
        avg_load = float(durations.sum()) / W
        print(f"[{card}] partition {g} {f}: T {T} E {len(src)} lanes {W}: labels == CPU run "
              f"({cpu_s:.2f} s), plain on the card agreement {agree:.6f}, comm volume {vol_k} "
              f"(plain {vol_p}, blocks {vol_b}), max lane load / avg {ml_k / avg_load:.4f} "
              f"(plain {ml_p / avg_load:.4f}); K4 kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {bound_ms:.7f} ({bound_by}) chain_ms {chain_ms:.4f}; plan wall_ms main {walls[g, f]:.2f} "
              f"median {statistics.median(plan_ms):.2f} hints_ms {hints_ms:.2f}")
        cases_out[f"{g}_{f}"] = dict(
            T=T, E=len(src), lanes=W, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, chain_ms=chain_ms, comm_volume=vol_k, comm_volume_plain=vol_p,
            comm_volume_blocks=vol_b, max_load_ratio=ml_k / avg_load,
            max_load_ratio_plain=ml_p / avg_load, card_plain_agreement=agree,
            plan_wall_ms_main=walls[g, f], plan_wall_ms=statistics.median(plan_ms),
            hints_ms=hints_ms)
        del run, cpu, card_run
        torch.cuda.empty_cache()

    # the 1M-task uniform batch through the extension: phase 4's hints
    t0 = time.perf_counter()
    hints = placement._plan_from_arrays([f"task-{i}" for i in range(N_TASKS)],
                                        *cases["random1m"], *fleets["uniform"],
                                        addrs["uniform"], BANDWIDTH, LATENCY)
    wall_1m = (time.perf_counter() - t0) * 1e3
    check(hints == hints_1m, "1M-task hints through TorchPlacement differ from phase 4's")
    print(f"[{card}] placement extension 1M tasks uniform: hints == phase 4's, "
          f"_plan_from_arrays wall_ms {wall_1m:.1f}")
    check(placement.enabled, "the planner disabled itself")

    head = cases_out["blockwise24_uniform"]
    return {
        "name": "partition",
        "route": "cuda",
        "source": "distributed_tpu_torch/ops/csrc/partition.cu",
        "replaces": "distributed_tpu/ops/partition.py:271",
        "launches": k4_launches,
        "max_abs_err": err_max,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "case": "blockwise24_uniform",
        "cases": cases_out,
        "plan_1m_wall_ms": wall_1m,
    }


# ------------------------------------------------------------ phase 6


# phase 3's fleet and one of 1,000 workers in a capacity of 1,024, THREADS each
STEAL_FLEETS = (("fleet512", 512), ("fleet1000", 1000))
DIRTY_ROWS = (0, 1, 37, "all")   # rows dirtied between two device views
TIMED_DIRTY = 37
AMM_KEYS, AMM_WORKERS = 16_384, 512
REBALANCE_KEYS, REBALANCE_WORKERS = 262_144, 512
REBALANCE_WIDE = 4_096             # phase 6's second rebalance: the same keys, more workers


class _Replica:
    """The fields of a replicated task that the AMM round reads."""

    def __init__(self, row, nbytes, who_has, waiters, desired):
        self.row, self.nbytes, self.who_has = row, nbytes, who_has
        self.waiters, self.desired = waiters, desired

    def get_nbytes(self):
        return self.nbytes


class _Waiter:
    def __init__(self, ws):
        self.processing_on = ws


class _Manager:
    def __init__(self, state):
        self.state, self.workers_memory = state, {}

    @staticmethod
    def _projected(ws):
        return ws.nbytes


class _Policy:
    """The slice of a ReduceReplicas policy its device round reads."""

    def __init__(self, state):
        self.manager = _Manager(state)

    @staticmethod
    def _desired(ts):
        return ts.desired


def _stand_in_workers(state, n, threads=THREADS):
    """``state``'s first ``n`` stand-in workers, added in slot order."""
    ws_list = list(state.workers.values())
    while len(ws_list) < n:
        i = len(ws_list)
        ws_list.append(state.add_worker(f"tcp://10.3.{i // 256}.{i % 256}:8788", threads))
    for w, ws in enumerate(ws_list):
        check(ws.idx == w, f"worker {w} holds slot {ws.idx}")
    return ws_list[:n]


def _set_fleet(state, ws_list, batch):
    """The mirrored fields of the stand-in workers from a cycle's fleet."""
    for w, ws in enumerate(ws_list):
        ws.nthreads = int(batch.nthreads[w])
        ws.occupancy = float(batch.occ[w])
        if batch.idle[w]:
            state.idle[ws.address] = ws
        else:
            state.idle.pop(ws.address, None)
        state.mirror.mark(ws)


def _view_equals_host(mirror, view):
    from distributed_tpu_torch.scheduler.mirror import DEVICE_FIELDS

    return all(np.array_equal(view[f].cpu().numpy(), getattr(mirror, f)) for f in DEVICE_FIELDS)


def _bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _steal_bound_ms(T, W, rounds):
    """Tasks (victim, key, cost, compute) and fleet (occupancy, threads,
    two flags) read once, the thieves and occupancy written once; per round
    a comparison sort of the tasks and of the thieves and a dozen
    operations a slot for the group sums, criterion and updates."""
    nbytes = 16 * T + 10 * W + 4 * T + 4 * W
    ops = rounds * (T * math.ceil(math.log2(T)) + W * math.ceil(math.log2(W)) + 12 * W)
    return _bound(nbytes, ops)


def _drop_bound_ms(R, W, K, drops_cpu):
    """The replica and exclusion matrices (a byte a cell), sizes, asks and
    memory read once, the drops and memory written once; per round a
    compare a worker for each row that drops (what this run's rows need)
    and an update a worker."""
    nbytes = 2 * R * W + 8 * R + 4 * W + 4 * R * K + 4 * W
    ops = int((drops_cpu >= 0).sum()) * W + K * W
    return _bound(nbytes, ops)


def _rebalance_bound_ms(N, W, rounds, ran, moves):
    """The least work of the function: owners, sizes and flags read once,
    memory in and out, and written once the ``moves`` this run made (a key
    and a recipient each), a count a round and the total; the size sort
    once, then two sorts of the workers in each of the ``ran`` rounds this
    run's data needs (the rounds after the first that moves nothing move
    nothing, whatever they compute)."""
    nbytes = 9 * N + 8 * W + 8 * moves + 4 * rounds + 4
    ops = N * math.ceil(math.log2(N)) + ran * 2 * W * math.ceil(math.log2(W))
    return _bound(nbytes, ops)


def _rebalance_chain_ms(ran, sm_mhz):
    """The floor the contract puts under K9's rounds, whatever its design:
    a round's memories are the last round's less a size plus a size, two
    dependent f32 adds in each of the ``ran`` rounds, at FADD_CYCLES an add
    and the SM clock."""
    return ran * 2 * FADD_CYCLES / (sm_mhz * 1e3)


@contextlib.contextmanager
def rebalance_spy(scheduler=None):
    """Record what a rebalance plan runs, without changing it: the batch
    and the moves (``(keys, senders, recipients)`` arrays) of
    ``plan_moves`` as ``RebalancePath`` calls it, the
    arguments, moves and wall of ``scheduler._rebalance_plan_device`` (an
    attribute of the instance while inside), and the host clock at each
    seam (``t``: plan_moves in, rounds in, rounds out with the card
    synchronised, plan_moves out).  Yields a dict of lists."""
    from distributed_tpu_torch.ops import rebalance
    from distributed_tpu_torch.scheduler import rebalance as path_mod

    seen = {"batches": [], "moves": [], "plans": [], "t": []}
    plan0, rounds0 = path_mod.plan_moves, rebalance.rebalance_rounds

    def plan(batch, *args, **kwargs):
        seen["t"].append(("plan", time.perf_counter()))
        out = plan0(batch, *args, **kwargs)
        seen["t"].append(("plan_end", time.perf_counter()))
        seen["batches"].append(batch)
        seen["moves"].append(out)
        return out

    def rounds(*args, **kwargs):
        seen["t"].append(("rounds", time.perf_counter()))
        out = rounds0(*args, **kwargs)
        if out[0].is_cuda:
            torch.cuda.synchronize(out[0].device)
        seen["t"].append(("rounds_end", time.perf_counter()))
        return out

    path_mod.plan_moves, rebalance.rebalance_rounds = plan, rounds
    if scheduler is not None:
        def plan_device(wss, cand, owner, mem=None):
            t0 = time.perf_counter()
            out = type(scheduler)._rebalance_plan_device(scheduler, wss, cand, owner, mem)
            seen["plans"].append(dict(wss=wss, cand=cand, moves=out,
                                      ms=(time.perf_counter() - t0) * 1e3))
            return out

        scheduler._rebalance_plan_device = plan_device
    try:
        yield seen
    finally:
        path_mod.plan_moves, rebalance.rebalance_rounds = plan0, rounds0
        if scheduler is not None:
            del scheduler._rebalance_plan_device


def plan_split_ms(seen, t0, t1):
    """The pieces of one timed ``plan_device`` call from ``rebalance_spy``'s
    clocks: ``pack`` (the batch built from the keys), ``upload`` (the
    padded inputs to the card), ``rounds`` (the rounds, synchronised),
    ``moves_back`` (the moves read back and mapped to the keys); and
    ``moves_back`` in two: ``read`` (``plan_moves`` after the rounds: the
    moves copied back and cut) and ``objects`` (``plan_device`` after
    ``plan_moves``: its list of key, sender and recipient objects)."""
    t = dict(seen["t"][-4:])
    split = dict(pack=(t["plan"] - t0) * 1e3, upload=(t["rounds"] - t["plan"]) * 1e3,
                 rounds=(t["rounds_end"] - t["rounds"]) * 1e3,
                 moves_back=(t1 - t["rounds_end"]) * 1e3)
    return split, dict(read=(t["plan_end"] - t["rounds_end"]) * 1e3,
                       objects=(t1 - t["plan_end"]) * 1e3)


def spied_plan_split(plan_once, reps=3):
    """``plan_split_ms`` of ``reps`` calls of ``plan_once`` under
    ``rebalance_spy``, each piece's median; and in ``moves_back``'s second
    dict, beside ``read`` and ``objects``, what Python's cyclic collector
    did inside ``objects`` (``objects_gc_ms``, its time; ``objects_gc_runs``
    and ``objects_gc_full``, its runs and those of the oldest generation,
    from ``gc.callbacks``) and ``objects_gc_off``, the same step in
    ``reps`` more calls with the collector disabled."""
    runs = []

    def watch(phase, info):
        now = time.perf_counter()
        if phase == "start":
            runs.append([info["generation"], now, now])
        elif runs:
            runs[-1][2] = now

    def spied():
        with rebalance_spy() as seen:
            t0 = time.perf_counter()
            plan_once()
            t1 = time.perf_counter()
        piece, back = plan_split_ms(seen, t0, t1)
        t_end = dict(seen["t"][-4:])["plan_end"]
        inside = [(g, b - a) for g, a, b in runs if t_end <= a <= t1]
        back.update(objects_gc_ms=sum(d for _, d in inside) * 1e3, objects_gc_runs=len(inside),
                    objects_gc_full=sum(g == 2 for g, _ in inside))
        return piece, back

    gc.callbacks.append(watch)
    try:
        done = [spied() for _ in range(reps)]
    finally:
        gc.callbacks.remove(watch)
    was = gc.isenabled()
    gc.disable()
    try:
        off = [spied()[1]["objects"] for _ in range(reps)]
    finally:
        if was:
            gc.enable()
    split = {k: statistics.median(p[k] for p, _ in done) for k in done[0][0]}
    back = {k: statistics.median(b[k] for _, b in done) for k in done[0][1]}
    back["objects_gc_off"] = statistics.median(off)
    return split, back


def k9_entry(rebalance, batch, dev, sm_mhz, cpu=False):
    """K9 on one rebalance case, as phase 6 checks and times it: the
    kernel against the plain version on the card and against itself, bit
    for bit (``cpu``: also against the plain version's CPU run, and the
    plain version timed on the card); its events ms, the call's device
    time and kernels (profiler), the bound and chain, and its timeline
    split by phase.  ``profile_periodic.py`` times K9 through this too."""
    from distributed_tpu_torch.profile_periodic import kernel_timeline
    from distributed_tpu_torch.profile_waves import kernel_times

    W = len(batch.mem)
    label = f"rebalance {len(batch.nbytes)}x{W}"
    R = rebalance.round_count(batch)
    args = rebalance.padded_inputs(batch, dev)
    got = rebalance.rebalance_rounds_cuda(*args, R).trimmed()
    again = rebalance.rebalance_rounds_cuda(*args, R).trimmed()
    plain = rebalance.compact_rounds(*rebalance.rebalance_rounds_reference(*args, R))
    want = rebalance.compact_rounds(*rebalance.rebalance_rounds_reference(
        *rebalance.padded_inputs(batch, "cpu"), R)) if cpu else None
    for i, name in enumerate(rebalance.Rounds._fields):
        check(torch.equal(again[i], got[i]), f"{label}: two calls of K9 give two {name}")
        check(torch.equal(plain[i], got[i]), f"{label}: K9's {name} differs from the plain version on the card")
        if cpu:
            check(torch.equal(got[i].cpu(), want[i]), f"{label}: K9's {name} differs from the CPU run")
    moves = int(got.total[0])
    check(moves > 0, f"{label}: nothing moved")
    ran = min(R, int((got.counts > 0).sum()) + 1)  # and the round that found nothing
    ref_mem = want.mem if cpu else plain.mem.cpu()
    ms = cuda_ms(lambda: rebalance.rebalance_rounds_cuda(*args, R), reps=5)
    device = kernel_times(torch, lambda: rebalance.rebalance_rounds_cuda(*args, R))
    split = kernel_timeline(
        torch, lambda st: rebalance.rebalance_rounds_cuda(*args, R, stamps=st),
        1 + R * len(rebalance.REBALANCE_PHASES), rebalance.REBALANCE_PHASES)
    check(split["rounds"] == ran, f"{label}: the timeline has {split['rounds']} rounds, {ran} ran")
    bound_ms, bound_by = _rebalance_bound_ms(len(args[0]), W, R, ran, moves)
    out = dict(case=f"{len(batch.nbytes)}x{W}", rounds=R, rounds_ran=ran, moves=moves,
               max_abs_err=float((got.mem.cpu() - ref_mem).abs().max()), ms=ms,
               device_ms=sum(t for t, _ in device.values()),
               device_kernels=sum(n for _, n in device.values()), bound_ms=bound_ms,
               bound_by=bound_by, chain_ms=_rebalance_chain_ms(ran, sm_mhz), phases=split,
               digest=hashlib.blake2b(got.moves.cpu().numpy().tobytes(), digest_size=8).hexdigest())
    if cpu:
        out["plain_ms"] = cuda_ms(lambda: rebalance.rebalance_rounds_reference(*args, R), warmup=1)
    return out


def steal_case(pc, name):
    """Phase 6's balance cycle on fleet ``name``: the batch, and its fleet
    (occupancy, threads, idle, running) as the mirror's device view holds
    it, empty slots (zeros) up to the mirror's capacity, a power of two."""
    i, W = next((i, W) for i, (n, W) in enumerate(STEAL_FLEETS) if n == name)
    batch = pc.steal_cycle(np.random.default_rng(60 + i), W, threads=THREADS)
    cap = 1 << max(W - 1, 7).bit_length()
    fleet = []
    for a, dtype in ((batch.occ, np.float32), (batch.nthreads, np.int32),
                     (batch.idle, bool), (batch.running, bool)):
        buf = np.zeros(cap, dtype)
        buf[:W] = a
        fleet.append(buf)
    return batch, tuple(fleet)


def _padded_steal(stealing, batch, fleet, dev):
    """plan_steals' padded task tensors on ``dev`` with the fleet arrays
    ``fleet`` (occ, nthreads, idle, running)."""
    T = len(batch.task_victim)
    Tp = stealing._bucket(T, floor=64)

    def pad(a, fill, dtype):
        buf = np.full(Tp, fill, dtype)
        buf[:T] = a
        return torch.from_numpy(buf).to(dev)

    return (pad(batch.task_victim, 0, np.int32), pad(batch.task_key, stealing.IMAX, np.int32),
            pad(batch.task_cost, 0, np.float32), pad(batch.task_compute, 0, np.float32),
            *(torch.as_tensor(a).to(dev) for a in fleet))


def _steal_chain_ms(stealing, cpu_args, rounds, sm_mhz):
    """The floor the contract puts under K7's rounds, whatever its design:
    a victim's candidates' compute is summed in slot order, then its
    accepted moves are taken off it in slot order, two chains of dependent
    f32 adds.  Per round the longest run of one victim's candidates plus
    the most moves accepted from one victim, at FADD_CYCLES an add and the
    SM clock.  The rounds are the plain version's on the CPU, run one at a
    time (their composition must equal one run of all of them)."""
    victim, key, cost, compute, occ, nthreads, idle, running = cpu_args
    threads = nthreads.clamp_min(1).to(torch.float32)
    latency = torch.tensor(stealing.LATENCY, dtype=torch.float32)
    W, adds = len(occ), 0
    thieves = torch.full_like(victim, -1)
    for _ in range(rounds):
        usable = key != stealing.IMAX
        primary = torch.where(usable, -(occ / threads)[victim.long()], float("inf"))
        by_key = torch.argsort(key, stable=True)
        order = by_key[torch.argsort(primary[by_key], stable=True)]
        nc = min(int((idle & running).sum()), int(usable.sum()), W)
        slots = order[:nc][usable[order[:nc]]]
        runs = torch.bincount(victim[slots].long(), minlength=W)
        th, occ = stealing.steal_rounds_reference(victim, key, cost, compute, occ, nthreads,
                                                   idle, running, 1)
        moved = th >= 0
        adds += int(runs.max()) + int(torch.bincount(victim[moved].long(), minlength=W).max())
        thieves = torch.where(moved, th, thieves)
        key = torch.where(moved, stealing.IMAX, key)
        idle = idle & ~((occ / threads) > latency)
    th_all, occ_all = stealing.steal_rounds_reference(*cpu_args, rounds)
    check(torch.equal(thieves, th_all) and torch.equal(occ, occ_all),
          "K7's chain: the rounds one at a time differ from one run")
    return adds * FADD_CYCLES / (sm_mhz * 1e3)


def _drop_chain_ms(drops_cpu, sm_mhz):
    """The floor the contract puts under K8's sums, whatever its design: a
    worker's shed bytes are added in row order, a chain of dependent f32
    adds.  Per round the most drops one worker takes, at FADD_CYCLES an
    add and the SM clock."""
    adds = sum(int(np.bincount(col[col >= 0]).max()) for col in drops_cpu.T if (col >= 0).any())
    return adds * FADD_CYCLES / (sm_mhz * 1e3)


def _phase_line(split, phases):
    return " ".join(f"{p} {split[p]['total_ms']:.4f} ({split[p]['median_ms']:.4f})" for p in phases)


# ------------------------------------------- K6 and K11: the mirror's views

FLEET_REPS = 25        # CUDA-event and host-clock repetitions of a view (medians)
PCIE_BYTES_S = 64e9    # PCIe 5.0 x16, one direction (NVIDIA H100 SXM: 128 GB/s both ways)
# (capacity, dirty rows, workers-axis blocks, copy-on-write) the kernel is
# held at against its plain version: K6 on phase 6's 512 workers and at
# growth to a capacity of 1,024, at 0, 1 and every slot dirty; K11 at dw 1
# and 2
FLEET_CASES = (
    (512, 37, 1, False), (1024, 37, 1, False), (1024, 0, 1, False), (1024, 1, 1, False),
    (1024, 1024, 1, False), (1024, 37, 1, True), (1024, 37, 2, True), (1024, 0, 2, True),
    (1024, 1, 2, True), (1024, 1024, 2, True),
)


@contextlib.contextmanager
def fleet_checked(log):
    """Each view's row writes on the main path held against the plain
    version on the card: the same view (``fleet.row_jobs`` /
    ``fleet.part_jobs`` of the kernel's call) goes through
    ``scatter_rows_reference`` on twins of the tensors it writes (each as
    it was, the same source blocks) after the path's own launch; ``log``
    gets (wrapper, jobs, rows, equal) a call that launched.  The twins
    launch no kernel."""
    from distributed_tpu_torch.ops import fleet

    real = {"scatter_rows_cuda": fleet.scatter_rows_cuda, "scatter_blocks_cuda": fleet.scatter_blocks_cuda}

    def wrap(name):
        def checked(plan, arg):
            if name == "scatter_rows_cuda":
                written = plan.groups[0]
                twins = fleet.row_jobs([t.clone() for t in written], plan.hosts, arg)
            else:
                written = [d for p in arg for d in p.dst]
                twins = fleet.part_jobs([p._replace(dst=[torch.empty_like(d) for d in p.dst]) for p in arg],
                                        plan.hosts)
            real[name](plan, arg)
            if len(arg):
                fleet.scatter_rows_reference(twins)
                log.append((name, len(twins), len(twins[0].rows),
                            all(torch.equal(a, t.dst) for a, t in zip(written, twins))))
        return checked

    for name in real:
        setattr(fleet, name, wrap(name))
    try:
        yield log
    finally:
        for name, fn in real.items():
            setattr(fleet, name, fn)


def _fleet_case(fleet, dev, rng, cap, n_dirty, dw, cow):
    """A scatter plan over ``dw`` blocks of ``cap // dw`` slots, one a
    dtype of the mirror's fields, on the card, and one view of it: the
    first ``n_dirty`` slots of a random order dirty with new host values,
    in place (K6) or into new blocks over the old (K11).  Returns the
    plan, the kernel's argument (the rows, or the parts), the tensors it
    writes and the same view on twins for the plain version."""
    rows = np.sort(rng.permutation(cap)[:n_dirty]).astype(np.int32)
    per = cap // dw
    hosts = [rng.integers(0, 100, cap).astype(t) for t in (np.int32, np.float32, np.bool_, np.int8)]
    blocks = [[torch.from_numpy(h[j * per:(j + 1) * per].copy()).to(dev) for h in hosts] for j in range(dw)]
    for h in hosts:
        h[rows] = rng.integers(100, 200, n_dirty).astype(h.dtype)
    plan = fleet.ScatterPlan(blocks, hosts, cow)
    if not cow:
        return plan, rows, plan.groups[0], fleet.row_jobs([t.clone() for t in blocks[0]], hosts, rows)
    parts, twins = [], []
    for j in range(dw):
        mine = rows[(rows >= j * per) & (rows < (j + 1) * per)]
        if len(mine):
            for out in (parts, twins):
                out.append(fleet.Part(j, j * per, mine, [torch.empty_like(b) for b in blocks[j]],
                                      blocks[j]))
    return plan, parts, [d for p in parts for d in p.dst], fleet.part_jobs(twins, hosts)


def fleet_kernel_checks(card, dev):
    """K6 and K11 through a scatter plan against their plain version on
    the card at FLEET_CASES, bit for bit, the source blocks unwritten;
    then a planted fault, a view with one dirty row left out, which the
    check must reject."""
    from distributed_tpu_torch.ops import fleet

    rng = np.random.default_rng(26)
    n_cases = 0
    for cap, n_dirty, dw, cow in FLEET_CASES:
        plan, arg, written, twins = _fleet_case(fleet, dev, rng, cap, n_dirty, dw, cow)
        sources = [b.clone() for g in plan.groups for b in g]
        (fleet.scatter_blocks_cuda if cow else fleet.scatter_rows_cuda)(plan, arg)
        fleet.scatter_rows_reference(twins)
        label = f"{'K11' if cow else 'K6'} cap {cap} dirty {n_dirty} dw {dw}"
        check(all(torch.equal(a, t.dst) for a, t in zip(written, twins)),
              f"{label}: the kernel differs from the plain version")
        check(not cow or all(torch.equal(b, s) for b, s in zip([b for g in plan.groups for b in g], sources)),
              f"{label}: a source block changed")
        n_cases += 1
    plan, rows, written, twins = _fleet_case(fleet, dev, rng, 1024, 37, 1, False)
    fleet.scatter_rows_cuda(plan, rows[1:])
    fleet.scatter_rows_reference(twins)
    check(not all(torch.equal(a, t.dst) for a, t in zip(written, twins)),
          "fleet: a record with a dirty row dropped passed the check")
    print(f"[{card}] fleet kernel: {n_cases} cases == the plain version on the card bit for bit "
          f"(K6 and K11); a dropped row rejected")
    return n_cases


def _medians(parts):
    """The median of each part that ran."""
    return {k: statistics.median(v) for k, v in parts.items() if v}


def _fleet_bound_ms(jobs):
    """The least the view's writes could take: the rows (once a rows array
    that jobs share) and the values once over PCIe, and each value written
    (a K11 job reads and writes its whole block instead) once in device
    memory; the larger, and the bytes that cross PCIe."""
    rows = {id(j.rows): 4 * len(j.rows) for j in jobs}  # int32 in the records
    host = sum(rows.values()) + sum(j.values.nbytes for j in jobs)
    device = sum(j.values.nbytes if j.src is None else 2 * j.dst.numel() * j.dst.element_size()
                 for j in jobs)
    return max(host / PCIE_BYTES_S, device / PEAK_BYTES_S) * 1e3, "bytes", host


def _empty_launch_ms(dev):
    """One launch of the fleet kernel with no job, through a view's own
    launch path (``fleet.launch_empty``), the floor of a view on the card:
    its ms by CUDA events around it, and the host µs of the call alone
    (median of FLEET_REPS in a row, no synchronize between them)."""
    from distributed_tpu_torch.ops import fleet

    ms = cuda_ms(lambda: fleet.launch_empty(dev), reps=FLEET_REPS)
    host = []
    for _ in range(FLEET_REPS):
        t0 = time.perf_counter()
        fleet.launch_empty(dev)
        host.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return ms, statistics.median(host)


@contextlib.contextmanager
def _fleet_swapped(fleet, name, fn):
    real = getattr(fleet, name)
    setattr(fleet, name, fn)
    try:
        yield real
    finally:
        setattr(fleet, name, real)


def _plain_call(fleet, name):
    """The plain version of a planned call of ``fleet.<name>``."""
    if name == "scatter_rows_cuda":
        return lambda plan, rows: fleet.scatter_rows_reference(fleet.row_jobs(plan.groups[0], plan.hosts, rows))
    return lambda plan, parts: fleet.scatter_rows_reference(fleet.part_jobs(parts, plan.hosts))


def _call_jobs(fleet, name, plan, arg):
    return (fleet.row_jobs(plan.groups[0], plan.hosts, arg) if name == "scatter_rows_cuda"
            else fleet.part_jobs(arg, plan.hosts))


def _view_call(fleet, name, view):
    """The plan and argument one call of ``view`` hands to ``fleet.<name>``
    (the mirror's own)."""
    seen = []

    def spy(plan, arg):
        seen.append((plan, arg))
        return real(plan, arg)

    with _fleet_swapped(fleet, name, spy) as real:
        view()
    check(len(seen) == 1, f"{name}: {len(seen)} calls in one view")
    return seen[0]


def _view_turns(fleet, name, view, full_view):
    """The whole view (marks, refresh, rows, writes), CUDA events, with its
    writes through the kernel and through the plain version (in place of
    ``fleet.<name>``), and the same view made through a full upload or
    pack instead (``full_view``), in turns: kernel, plain, full, full,
    plain, kernel."""
    out = {"kernel": [], "plain": [], "full": []}
    for who in ("kernel", "plain", "full", "full", "plain", "kernel"):
        if who == "plain":
            with _fleet_swapped(fleet, name, _plain_call(fleet, name)):
                out[who].append(cuda_ms(view, reps=FLEET_REPS))
            continue
        out[who].append(cuda_ms(view if who == "kernel" else full_view, reps=FLEET_REPS))
    torch.cuda.synchronize()
    return out


#: a view's host steps (label, owner, attribute), each timed on the host
#: clock inside a loop of views (a step timed alone, warm in the caches,
#: costs less): the kernel's call (range check, ring, table, gathers,
#: launch), within it the ring's acquire and the plan's launch, within
#: that the kernels' one launch path (the device guard, the stream lookup
#: and the ctypes call)
FLEET_STEPS = (("call", "fleet", None), ("acquire", "plan", "acquire"), ("launch", "plan", "launch"),
               ("build_launch", "build", "launch"))


def _view_steps(mirror, marks, view, name):
    """A view's host time by step, median µs of FLEET_REPS views in a row,
    each after the marks of the same workers: the marks, ``refresh``, the
    whole view and, within it, FLEET_STEPS (the rest of the view is the
    mirror's own: the wall phase, the dirty set sorted, the parts and the
    trace); and the staging waits of those views."""
    from distributed_tpu_torch.ops import _build, fleet

    owners = {"fleet": fleet, "plan": fleet.ScatterPlan, "build": _build}
    acc = {label: [] for label in ("marks", "refresh", "view", "all", *(s[0] for s in FLEET_STEPS))}

    def timed(label, fn):
        def step(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                acc[label].append((time.perf_counter() - t0) * 1e6)
        return step

    saved = [(owners[o], attr or name, getattr(owners[o], attr or name), label) for label, o, attr in FLEET_STEPS]
    waits = mirror.staging_waits
    try:
        for owner, attr, fn, label in saved:
            setattr(owner, attr, timed(label, fn))
        for _ in range(FLEET_REPS):
            t0 = time.perf_counter()
            marks()
            t1 = time.perf_counter()
            mirror.refresh()
            t2 = time.perf_counter()
            view()
            t3 = time.perf_counter()
            for label, a, b in (("marks", t0, t1), ("refresh", t1, t2), ("view", t2, t3), ("all", t0, t3)):
                acc[label].append((b - a) * 1e6)
        torch.cuda.synchronize()
    finally:
        for owner, attr, fn, _ in saved:
            setattr(owner, attr, fn)
    return _medians(acc), mirror.staging_waits - waits


def _kernel_turns(fleet, name, plan, arg, full):
    """The kernel and the plain version on the view's own call (each call
    writes the same bytes again), and the full upload or pack of the same
    fields alone (``full``, the library's copies), in turns: kernel,
    plain, library, library, plain, kernel."""
    kernel, plain = getattr(fleet, name), _plain_call(fleet, name)
    calls = {"kernel": lambda: kernel(plan, arg), "plain": lambda: plain(plan, arg), "library": full}
    out = {who: [] for who in calls}
    for who in ("kernel", "plain", "library", "library", "plain", "kernel"):
        out[who].append(cuda_ms(calls[who], reps=FLEET_REPS))
    return out


def _fleet_split(card, label, fleet, name, mirror, view, marks, full):
    """A view at TIMED_DIRTY dirty rows timed by part in one call: the view
    through the kernel (``fleet.<name>``), through the plain version and
    through ``full`` (the full upload or pack of the same fields after the
    same marks and refresh, then an event recorded, as a view that writes
    records one), in turns; the host steps, the kernel and the plain
    version alone on the view's own call, the bound and the empty launch."""
    done = torch.cuda.Event()

    def whole():
        marks()
        return view()

    def full_view():
        marks()
        mirror.refresh()
        out = full()
        done.record()
        return out

    plan, arg = _view_call(fleet, name, whole)
    jobs = _call_jobs(fleet, name, plan, arg)
    turns = _view_turns(fleet, name, whole, full_view)
    steps, waits = _view_steps(mirror, marks, view, name)
    alone = _kernel_turns(fleet, name, plan, arg, full)
    empty_ms, empty_host_us = _empty_launch_ms(plan.device)
    bound_ms, bound_by, pcie = _fleet_bound_ms(jobs)
    view_ms, plain_view_ms, full_ms = turns["kernel"], turns["plain"], turns["full"]
    print(f"[{card}] {label}, {TIMED_DIRTY} dirty rows of {len(mirror.state.workers)} workers (capacity "
          f"{mirror.cap}), {len(jobs)} jobs; events ms, the whole view through kernel / plain / full / full / "
          f"plain / kernel: {view_ms[0]:.4f} / {plain_view_ms[0]:.4f} / {full_ms[0]:.4f} / {full_ms[1]:.4f} / "
          f"{plain_view_ms[1]:.4f} / {view_ms[1]:.4f}; host steps, median us of {FLEET_REPS} views: {steps}; "
          f"staging waits {waits} of {FLEET_REPS} views; alone, the kernel {alone['kernel']}, plain "
          f"{alone['plain']}, full upload or pack {alone['library']}; "
          f"empty launch {empty_ms:.4f} ({empty_host_us:.1f} us of host time), bound {bound_ms:.7f} ({bound_by}, {pcie} B over PCIe; "
          f"{plan.nbytes} B of records laid out); plan builds {mirror.plan_builds}, full uploads and packs "
          f"{mirror.full_uploads}")
    return dict(view_ms=view_ms, plain_view_ms=plain_view_ms, full_view_ms=full_ms,
                kernel_turns_ms=alone["kernel"], plain_turns_ms=alone["plain"],
                library_turns_ms=alone["library"], empty_launch_ms=empty_ms, empty_launch_host_us=empty_host_us,
                bound_ms=bound_ms, bound_by=bound_by, pcie_bytes=pcie, record_bytes=plan.nbytes, jobs=len(jobs), steps_us=steps, staging_waits=waits,
                views_timed=FLEET_REPS, plan_builds=mirror.plan_builds, full_uploads=mirror.full_uploads)


def k6_view_split(card, mirror, dev, rng):
    """K6 at TIMED_DIRTY dirty rows of the mirror's fleet, timed by part
    (``_fleet_split``, the view through the full upload as ``full``);
    every field left equal to the host's, and the plan rebuilt only with a
    full upload."""
    from distributed_tpu_torch.ops import fleet
    from distributed_tpu_torch.scheduler.mirror import DEVICE_FIELDS

    ws = rng.choice(list(mirror.state.workers.values()), TIMED_DIRTY, replace=False)
    mirror.device_view()

    def marks():
        for w in ws:
            mirror.mark(w)

    out = _fleet_split(card, "K6 view", fleet, "scatter_rows_cuda", mirror, mirror.device_view, marks,
                       lambda: [torch.from_numpy(getattr(mirror, f)).to(dev) for f in DEVICE_FIELDS])
    check(all(torch.equal(t.cpu(), torch.from_numpy(getattr(mirror, f))) for f, t in mirror._dev.items()),
          "K6: a field on the card differs from the host's after the timed views")
    check(mirror.plan_builds == mirror.full_uploads, f"K6: {mirror.plan_builds} plan builds for "
          f"{mirror.full_uploads} full uploads")
    return out


def k11_view_split(card, mirror, mesh, dev, rng):
    """K11 at TIMED_DIRTY dirty rows over ``mesh``'s workers axis, timed by
    part (``_fleet_split``, the view through the full pack as ``full``);
    every block left equal to the host's, and the plans rebuilt only with
    a full pack."""
    from distributed_tpu_torch.ops import fleet
    from distributed_tpu_torch.scheduler.mirror import SHARDED_FIELDS

    dw = int(mesh.shape["workers"])
    rps = mirror.cap // dw
    ws = rng.choice(list(mirror.state.workers.values()), TIMED_DIRTY, replace=False)
    mirror.sharded_device_view(mesh)

    def marks():
        for w in ws:
            mirror.mark(w)

    out = _fleet_split(card, f"K11 view, dw {dw}", fleet, "scatter_blocks_cuda", mirror,
                       lambda: mirror.sharded_device_view(mesh), marks,
                       lambda: [torch.from_numpy(getattr(mirror, f)[j * rps:(j + 1) * rps].copy()).to(dev)
                                for f in SHARDED_FIELDS for j in range(dw)])
    check(all(torch.equal(torch.cat(mirror._sdev[f]).cpu(), torch.from_numpy(getattr(mirror, f)))
              for f in SHARDED_FIELDS),
          "K11: a block on the card differs from the host's after the timed views")
    check(mirror.plan_builds == mirror.full_uploads, f"K11: {mirror.plan_builds} plan builds for "
          f"{mirror.full_uploads} full packs")
    return out


def _fleet_entry(out):
    """The kernels line's numbers of a view's timing: the medians of the
    kernel's call, the plain version's and the full upload or pack of the
    same fields (the library call: torch's copies) alone, each on the
    view's own rows and fields.  The whole views through each stay under
    their own keys (``view_ms``, ``plain_view_ms``, ``full_view_ms``)."""
    return dict(ms=statistics.median(out["kernel_turns_ms"]), plain_ms=statistics.median(out["plain_turns_ms"]),
                library_ms=statistics.median(out["library_turns_ms"]), bound_ms=out["bound_ms"],
                bound_by=out["bound_by"])


def phase_periodic(ptxas=None):
    """Phase 6: the scheduler's periodic device paths at full width, as the
    port's paths call them: the fleet mirror's device view (K6) feeding a
    balance cycle's plan (K7, ``StealingPath.plan``, what the steal
    executor runs), an AMM round (K8, ``AmmPath.run_device``) and a
    rebalance plan (K9, ``RebalancePath.plan_device``), on stand-in
    workers and keys with the fields those paths read.  ``ptxas``: phase
    1's registers and spills of K7 and K8, put into their entries."""
    from distributed_tpu_torch.ops import amm, fleet, rebalance, stealing
    from distributed_tpu_torch.profile_periodic import kernel_timeline
    from distributed_tpu_torch.scheduler.amm import AmmPath
    from distributed_tpu_torch.scheduler.mirror import DEVICE_FIELDS, TorchMirror
    from distributed_tpu_torch.scheduler.rebalance import RebalancePath
    from distributed_tpu_torch.scheduler.stealing import StealingPath

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_periodic_cases as pc

    card = smi_line()
    sm_mhz = sm_clock_mhz()
    ptxas = ptxas or {}
    # a balance cycle's Jacobi rounds: what the path runs, plan_steals' default
    steal_rounds = inspect.signature(stealing.plan_steals).parameters["rounds"].default
    rng = np.random.default_rng
    steal_cases = {name: steal_case(pc, name) for name, _ in STEAL_FLEETS}
    drop_batch = pc.drop_round(rng(62), AMM_KEYS, AMM_WORKERS)
    reb_batch = pc.rebalance_case(rng(63), REBALANCE_KEYS, REBALANCE_WORKERS)

    # the AMM round's and the rebalance's scheduler stand-ins
    amm_state = pc.StandInState()
    amm_state.mirror = TorchMirror(amm_state)
    amm_ws = _stand_in_workers(amm_state, AMM_WORKERS)
    for w, ws in enumerate(amm_ws):
        ws.nbytes = float(drop_batch.mem[w])
        amm_state.mirror.mark(ws)
    replicas = []
    for r in range(AMM_KEYS):
        held = np.flatnonzero(drop_batch.holders[r])
        busy = np.flatnonzero(drop_batch.excluded[r])
        replicas.append(_Replica(r, float(drop_batch.nbytes[r]), {amm_ws[w] for w in held},
                                 [_Waiter(amm_ws[w]) for w in busy],
                                 len(held) - int(drop_batch.ndrop[r])))
    reb_state = pc.StandInState()
    reb_state.mirror = TorchMirror(reb_state)
    reb_ws = _stand_in_workers(reb_state, REBALANCE_WORKERS)
    for w, ws in enumerate(reb_ws):
        ws.nbytes = float(reb_batch.mem[w])
        reb_state.mirror.mark(ws)
    reb_keys = [_Replica(i, float(b), set(), [], 1) for i, b in enumerate(reb_batch.nbytes)]

    # the main path: every count zeroed just before, read just after
    steal_path = StealingPath()
    amm_path, reb_path = AmmPath(), RebalancePath()
    TorchMirror.launches = 0
    fleet.scatter_rows_cuda.launches = 0
    stealing.steal_rounds_cuda.launches = 0
    amm.drop_rounds_cuda.launches = 0
    rebalance.rebalance_rounds_cuda.launches = 0
    state = pc.StandInState()
    mirror = state.mirror = TorchMirror(state)
    views, seen, thieves, mirror_log, fleet_log = 0, {}, {}, [], []
    with fleet_checked(fleet_log):
        for name, W in STEAL_FLEETS:
            batch = steal_cases[name][0]
            cap0 = mirror.cap
            ws_list = _stand_in_workers(state, W)
            before = mirror.stats()
            _set_fleet(state, ws_list, batch)
            view = mirror.device_view()  # a full upload: no launch of K6
            after = mirror.stats()
            what = "first use" if not before["full_uploads"] else "growth"
            check(what != "growth" or mirror.cap != cap0, f"mirror {name}: no growth past {cap0}")
            mirror_log.append((name, what, after["full_uploads"] - before["full_uploads"],
                               after["rows_uploaded"] - before["rows_uploaded"], _view_equals_host(mirror, view)))
            seen[name] = tuple(getattr(mirror, f).copy() for f in ("occupancy", "nthreads", "idle", "running"))
            fleet_batch = batch._replace(occ=view["occupancy"], nthreads=view["nthreads"],
                                         idle=view["idle"], running=view["running"])
            thieves[name] = steal_path.plan(fleet_batch, mirror.upload_event)
            for n in DIRTY_ROWS:
                pick = ws_list if n == "all" else rng(70 + len(mirror_log)).choice(ws_list, n, replace=False)
                for ws in pick:
                    state.update(ws, np.random.default_rng(ws.idx))
                before = mirror.stats()
                view = mirror.device_view()
                views += n != 0
                after = mirror.stats()
                mirror_log.append((name, f"dirty {n}", after["full_uploads"] - before["full_uploads"],
                                   after["rows_uploaded"] - before["rows_uploaded"],
                                   _view_equals_host(mirror, view)))
    main_path_waits, main_path_builds = mirror.staging_waits, mirror.plan_builds
    suggestions = list(amm_path.run_device(_Policy(amm_state), replicas))
    reb_fv = reb_state.mirror.fleet_view()
    moves = reb_path.plan_device(reb_fv.live_list, reb_keys, reb_batch.owner.tolist(),
                                 reb_fv.nbytes[reb_fv.slots].astype(np.float32, copy=True))
    torch.cuda.synchronize()
    launches = {"mirror_view": fleet.scatter_rows_cuda.launches, "steal": stealing.steal_rounds_cuda.launches,
                "amm_drop": amm.drop_rounds_cuda.launches,
                "rebalance": rebalance.rebalance_rounds_cuda.launches}
    print(f"[{card}] periodic main path: launches {launches}; views that wrote to the card "
          f"{TorchMirror.launches} (full uploads included); paths "
          f"{ {p: q.counters() for p, q in (('stealing', steal_path), ('amm', amm_path), ('rebalance', reb_path))} }")
    check(launches == {"mirror_view": views, "steal": len(STEAL_FLEETS), "amm_drop": 1, "rebalance": 1},
          f"periodic launches {launches}: one a view with dirty rows, a cycle and a plan expected")
    # K6 on the main path: each view's launch against the plain version on the card
    check(len(fleet_log) == views and all(e[0] == "scatter_rows_cuda" and e[3] for e in fleet_log),
          f"K6 on the main path: {fleet_log} against {views} views with dirty rows")
    check(mirror.plan_builds == mirror.full_uploads == 2,
          f"K6's plan built {mirror.plan_builds} times for {mirror.full_uploads} full uploads")
    print(f"[{card}] K6 on the main path: {len(fleet_log)} views (rows {[e[2] for e in fleet_log]}), "
          f"one launch each, == the plain version on the card bit for bit; the plan built "
          f"{mirror.plan_builds} times, as often as the full uploads (first use, growth); "
          f"staging waits {main_path_waits}")
    for label, p in (("stealing", steal_path), ("amm", amm_path), ("rebalance", reb_path)):
        check(p.failures == 0, f"{label} path failures {p.failures}: {p.errors}")

    # K6: the device view against the host rows, and its counters
    for name, what, full, rows, same in mirror_log:
        n = what.split()[-1]
        want_rows = 0 if what in ("first use", "growth") else (
            dict(STEAL_FLEETS)[name] if n == "all" else int(n))
        print(f"[{card}] mirror {name} {what}: full uploads {full}, rows uploaded {rows}, "
              f"view == host {same}")
        check(same, f"mirror {name} {what}: the device view differs from the host rows")
        check(full == (what in ("first use", "growth")), f"mirror {name} {what}: {full} full uploads")
        check(rows == want_rows, f"mirror {name} {what}: {rows} rows uploaded, {want_rows} dirty")
    check([w for _, w, *_ in mirror_log if w in ("first use", "growth")] == ["first use", "growth"],
          f"mirror full uploads at {[w for _, w, *_ in mirror_log]}")
    check(mirror.cap == 1024, f"mirror capacity {mirror.cap}")

    entries = {}
    dev = torch.device("cuda", torch.cuda.current_device())
    # K7: each cycle against the plain version on the CPU on the fleet it saw
    cases_out, err_max = {}, 0.0
    for name, W in STEAL_FLEETS:
        batch = steal_cases[name][0]
        check(all(np.array_equal(a, b) for a, b in zip(seen[name], steal_cases[name][1])),
              f"steal {name}: the mirror's view is not steal_case's fleet")
        T = len(batch.task_victim)
        cpu_args = _padded_steal(stealing, batch, seen[name], "cpu")
        th_cpu, occ_cpu = stealing.steal_rounds_reference(*cpu_args, steal_rounds)
        th_cpu = th_cpu[:T].numpy()
        check(np.array_equal(thieves[name], th_cpu),
              f"steal {name}: K7 thieves differ from the CPU run ({int((thieves[name] != th_cpu).sum())})")
        args = _padded_steal(stealing, batch, seen[name], dev)
        got = stealing.steal_rounds_cuda(*args, steal_rounds)
        again = stealing.steal_rounds_cuda(*args, steal_rounds)
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              f"steal {name}: two calls differ")
        err = float((got[1].cpu() - occ_cpu).abs().max())
        check(err == 0.0 and np.array_equal(got[0][:T].cpu().numpy(), th_cpu),
              f"steal {name}: K7 occupancy differs from the CPU run by {err}")
        n_steals = pc.check_steals(batch, th_cpu)
        check(n_steals > 0, f"steal {name}: no steals on an imbalance")
        with deterministic():
            th_p, occ_p = stealing.steal_rounds_reference(*args, steal_rounds)
        agree = float((th_p[:T] == got[0][:T]).float().mean())
        occ_err_p = float((occ_p - got[1]).abs().max())
        ms = cuda_ms(lambda: stealing.steal_rounds_cuda(*args, steal_rounds))
        plain_ms = cuda_ms(lambda: stealing.steal_rounds_reference(*args, steal_rounds),
                           reps=5, warmup=1)
        bound_ms, bound_by = _steal_bound_ms(len(args[0]), len(args[4]), steal_rounds)
        chain_ms = _steal_chain_ms(stealing, cpu_args, steal_rounds, sm_mhz)
        split = kernel_timeline(
            torch, lambda st: stealing.steal_rounds_cuda(*args, steal_rounds, stamps=st),
            1 + steal_rounds * len(stealing.STEAL_PHASES), stealing.STEAL_PHASES)
        err_max = max(err_max, err)
        print(f"[{card}] steal {name}: T {T} W {len(args[4])} steals {n_steals}: == CPU run, repeat "
              f"identical, replay holds; plain on the card agreement {agree:.6f} occ err {occ_err_p:.3g}; "
              f"K7 kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.7f} ({bound_by}) "
              f"chain_ms {chain_ms:.5f} launches 1 a cycle")
        print(f"[{card}] steal {name} phases, ms over {split['rounds']} rounds (median a round): "
              + _phase_line(split, stealing.STEAL_PHASES))
        cases_out[name] = dict(T=T, W=len(args[4]), steals=n_steals, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by, chain_ms=chain_ms,
                               card_plain_agreement=agree, phases=split)
    head = cases_out["fleet512"]
    entries["steal"] = dict(
        name="steal", route="cuda", source="distributed_tpu_torch/ops/csrc/steal.cu",
        replaces="distributed_tpu/ops/stealing.py:77", launches=launches["steal"],
        max_abs_err=err_max, ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, chain_ms=head["chain_ms"], case="fleet512",
        cases=cases_out, ptxas=ptxas.get("steal.cu"))

    # K8: the round's suggestions against the plain version on the CPU
    got_drops = [(ts.row, ws.idx) for _, ts, (ws,) in suggestions]
    want_drops = amm.plan_drops(drop_batch, device="cpu")
    check(got_drops == want_drops, f"amm: {len(got_drops)} drops differ from the CPU run's {len(want_drops)}")
    rounds = amm.plan_drop_rounds(drop_batch, device="cpu")
    n_drops = pc.check_drops(drop_batch, rounds)
    K = min(int(drop_batch.ndrop.max()), amm.MAX_ROUNDS)
    Kp = stealing._bucket(K, floor=1)
    cpu_t = [torch.from_numpy(np.asarray(a)) for a in drop_batch]
    d_cpu, m_cpu = amm.drop_rounds_reference(*cpu_t, Kp)
    dev_t = [t.to(dev) for t in cpu_t]
    d1, m1 = amm.drop_rounds_cuda(*dev_t, Kp)
    d2, m2 = amm.drop_rounds_cuda(*dev_t, Kp)
    check(torch.equal(d1, d2) and torch.equal(m1, m2), "amm: two calls differ")
    err = float((m1.cpu() - m_cpu).abs().max())
    check(torch.equal(d1.cpu(), d_cpu) and err == 0.0, f"amm: K8 differs from the CPU run ({err})")
    with deterministic():
        d_p, m_p = amm.drop_rounds_reference(*dev_t, Kp)
    agree = float((d_p == d1).float().mean())
    ms = cuda_ms(lambda: amm.drop_rounds_cuda(*dev_t, Kp))
    plain_ms = cuda_ms(lambda: amm.drop_rounds_reference(*dev_t, Kp), reps=3, warmup=1)
    bound_ms, bound_by = _drop_bound_ms(AMM_KEYS, AMM_WORKERS, Kp, d_cpu.numpy())
    chain_ms = _drop_chain_ms(d_cpu.numpy(), sm_mhz)
    split = kernel_timeline(torch, lambda st: amm.drop_rounds_cuda(*dev_t, Kp, stamps=st),
                            2 + Kp * len(amm.DROP_PHASES), amm.DROP_PHASES, first=2)
    print(f"[{card}] amm {AMM_KEYS} keys x {AMM_WORKERS} workers, K {K} (padded {Kp}): {n_drops} drops "
          f"== CPU run, repeat identical, replay holds; plain on the card agreement {agree:.6f}; "
          f"K8 kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.7f} ({bound_by}) "
          f"chain_ms {chain_ms:.5f} launches 1 a plan")
    print(f"[{card}] amm phases, ms over {split['rounds']} rounds (median a round): prologue "
          f"{split['first_ms']:.4f} " + _phase_line(split, amm.DROP_PHASES))
    entries["amm_drop"] = dict(
        name="amm_drop", route="cuda", source="distributed_tpu_torch/ops/csrc/amm_drop.cu",
        replaces="distributed_tpu/ops/amm.py:43", launches=launches["amm_drop"], max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        chain_ms=chain_ms, case=f"{AMM_KEYS}x{AMM_WORKERS}", rounds=K, drops=n_drops,
        card_plain_agreement=agree, phases=split, ptxas=ptxas.get("amm_drop.cu"))

    # K9: the moves against the CPU run; the kernel against the plain version
    # on the CPU and on the card, bit for bit; its time beside theirs and the
    # host plan's
    got_moves = [(ts.row, s.idx, r.idx) for ts, s, r in moves]
    before, after = pc.check_rebalance(reb_batch, got_moves)
    want_moves = rebalance.plan_rebalance(reb_batch, device="cpu")
    check(got_moves == want_moves,
          f"rebalance: {len(got_moves)} moves on the card differ from the CPU run's {len(want_moves)}")
    N = REBALANCE_KEYS
    k9 = k9_entry(rebalance, reb_batch, dev, sm_mhz, cpu=True)
    R, ran, split = k9["rounds"], k9["rounds_ran"], k9["phases"]
    check(k9["moves"] == len(got_moves), f"rebalance: K9 made {k9['moves']} moves, the plan {len(got_moves)}")
    # the same keys on REBALANCE_WIDE workers, where a round ranks the most
    # candidates: no CPU run, to keep the phase short
    wide = k9_entry(rebalance, pc.rebalance_case(rng(63), REBALANCE_KEYS, REBALANCE_WIDE), dev, sm_mhz)
    # the whole plan as the scheduler calls it, median of 3 calls; then 3
    # more under rebalance_spy (which waits for the card after the rounds)
    # for its split into pack, upload, rounds and moves back; and the host
    # plan the gate takes below 512 candidates, on the same keys
    def plan_once():
        return reb_path.plan_device(reb_fv.live_list, reb_keys, reb_batch.owner.tolist(),
                                    reb_fv.nbytes[reb_fv.slots].astype(np.float32, copy=True))

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        plan_once()
        walls.append((time.perf_counter() - t0) * 1e3)
    plan_wall_ms = statistics.median(walls)
    plan_split, moves_back_split = spied_plan_split(plan_once)
    wss, _ = pc.rebalance_fleet(reb_batch)
    t0 = time.perf_counter()
    py_moves = pc.rebalance_plan_python(wss, None)
    python_plan_ms = (time.perf_counter() - t0) * 1e3
    proj = np.asarray(reb_batch.mem, np.float64).copy()
    for ts, snd, rcp in py_moves:
        proj[snd.idx] -= ts.nbytes
        proj[rcp.idx] += ts.nbytes
    py_after = float(proj.max() - proj.min())
    print(f"[{card}] rebalance {N} keys x {REBALANCE_WORKERS} workers, {R} rounds ({ran} ran): "
          f"{len(got_moves)} moves, invariants hold, imbalance {before:.6g} -> {after:.6g}; moves and "
          f"memory == CPU run and == the plain version on the card, repeat identical; K9 kernel_ms "
          f"{k9['ms']:.4f} plain_ms {k9['plain_ms']:.4f} bound_ms {k9['bound_ms']:.7f} "
          f"({k9['bound_by']}) chain_ms {k9['chain_ms']:.5f} launches 1 a plan; the call's device ms "
          f"{k9['device_ms']:.4f} ({k9['device_kernels']} kernels); plan wall ms {plan_wall_ms:.2f} (median of 3; split "
          "under the spy, median of 3: "
          + " ".join(f"{k} {v:.2f}" for k, v in plan_split.items())
          + f", moves_back read {moves_back_split['read']:.2f} objects "
          f"{moves_back_split['objects']:.2f}, of it in the collector "
          f"{moves_back_split['objects_gc_ms']:.2f} ({moves_back_split['objects_gc_runs']} runs, the "
          f"oldest generation {moves_back_split['objects_gc_full']}), objects with the collector off "
          f"{moves_back_split['objects_gc_off']:.2f}); host python plan ms {python_plan_ms:.1f} "
          f"({len(py_moves)} moves, imbalance -> "
          f"{py_after:.6g})")
    print(f"[{card}] rebalance phases, ms over {split['rounds']} rounds (median a round): "
          + _phase_line(split, rebalance.REBALANCE_PHASES))
    print(f"[{card}] rebalance {N} keys x {REBALANCE_WIDE} workers, {wide['rounds']} rounds "
          f"({wide['rounds_ran']} ran): {wide['moves']} moves == the plain version on the card, repeat "
          f"identical; K9 kernel_ms {wide['ms']:.4f} device ms {wide['device_ms']:.4f} bound_ms "
          f"{wide['bound_ms']:.7f} ({wide['bound_by']}) chain_ms {wide['chain_ms']:.5f}; phases, ms over "
          f"{wide['phases']['rounds']} rounds (median a round): "
          + _phase_line(wide["phases"], rebalance.REBALANCE_PHASES))
    entries["rebalance"] = dict(
        name="rebalance", route="cuda", source="distributed_tpu_torch/ops/csrc/rebalance.cu",
        replaces="distributed_tpu/ops/rebalance.py:43", launches=launches["rebalance"],
        library_ms=None, **{k: v for k, v in k9.items() if k != "moves"}, moves=len(got_moves),
        imbalance_before=before, imbalance_after=after, wide=wide,
        plan_wall_ms=plan_wall_ms, plan_split_ms=plan_split, moves_back_split_ms=moves_back_split,
        python_plan_ms=python_plan_ms,
        python_moves=len(py_moves), python_imbalance_after=py_after,
        ptxas=ptxas.get("rebalance.cu"))

    # K6: the kernel against its plain version on the card; the view timed
    # by part beside the plain version, the full upload and the floor
    n_cases = fleet_kernel_checks(card, dev)
    k6 = k6_view_split(card, mirror, dev, rng(80))
    entries["mirror_view"] = dict(
        name="mirror_view", route="cuda", source="distributed_tpu_torch/ops/csrc/fleet_scatter.cu",
        replaces="distributed_tpu/scheduler/mirror.py:356", launches=launches["mirror_view"],
        max_abs_err=0.0, **_fleet_entry(k6),
        case=f"{TIMED_DIRTY} dirty rows, capacity {mirror.cap}", cases_checked=n_cases,
        staging_waits_main_path=main_path_waits, plan_builds_main_path=main_path_builds,
        **{k: v for k, v in k6.items() if k not in ("bound_ms", "bound_by")})
    return [entries[k] for k in ("steal", "amm_drop", "mirror_view", "rebalance")]


# ------------------------------------------------------------ phase 7


# the sharded engine's layouts (tasks x workers), every shard on the one card
SHARD_LAYOUTS = ("1x1", "2x1", "4x2", "8x1")
SHARD_HEADLINE = ("8x1", "nonuniform")
# tests/test_sharded_engine.py's gate against the single-device engine
SHARD_MIN_AGREEMENT = 0.97
SHARD_OCC_RTOL = SHARD_OCC_ATOL = 1e-4
SHARD_START_RTOL = SHARD_START_ATOL = 1e-3
# K11: the mirror's workers-axis view on phase 6's two fleets, dw = 1 and 2
MIRROR_LAYOUTS = ("1x1", "4x2")


def _shard_mesh(partition, layout, device):
    dt, dw = (int(p) for p in layout.split("x"))
    return partition.make_engine_mesh(layout=layout, devices=[device] * (dt * dw))


def _shard_bound_ms(packed, W, D):
    """K1's bound (the f16 wire read once, the codes, fleet, load and spans
    once) plus each wave's two sets of ``[D, W]`` f32 partials, written
    once and read once by the psum; K1's operations plus the psum adds."""
    T, L = packed.n, packed.n_levels
    nbytes = 16 * T + 8 * T + 13 * W + 4 * W + 4 * L + L * 2 * 2 * D * W * 4
    ops = 40 * T + L * W * max(W.bit_length() - 1, 1) + L * 2 * D * W
    return _bound(nbytes, ops)


def _timed_waves(sharded, mesh, packed, fleet, body=None):
    """A ShardedRun with every fused run's tiles shipped up front, a
    function that runs all its waves from a reset carry (no upload, no
    download): what the waves cost on the card, launches and collectives,
    and the shipped plan ``[(Fl, waves, each group's tiles)]``."""
    runs = sharded._plan_runs_sharded(packed.offsets, mesh.size)
    Tp = sharded.sharded_pad(packed.n, runs, packed.offsets, mesh.size)
    host = tuple(np.zeros(Tp, d) for _, d in sharded.TASK_FIELDS)
    for buf, arr in zip(host, (packed.duration_s, packed.heavy_s, packed.heavy2_s,
                               packed.xfer_pref_s, packed.xfer_pref2_s, packed.xfer_all_s)):
        buf[: packed.n] = arr
    Lp = sharded._bucket(packed.n_levels + 1, floor=64)
    run = sharded.ShardedRun(mesh, packed, Tp, Lp, *fleet, body=body)
    plan = []
    for Fl, waves in runs:
        run._ship(host, Fl, waves)
        plan.append((Fl, waves, [dict(g.tiles) for g in run.groups]))

    def waves():
        run.reset()
        for Fl, ws, tiles in plan:
            for g, t in zip(run.groups, tiles):
                g.tiles = t
            run.run_waves(Fl, ws)

    return run, waves, plan


def phase_sharded(oneshot, ptxas=None):
    """Phase 7: the sharded placement engine at full width, every shard on
    the one card (``LocalShards``): the 1M-task DAG on phase 3's fleets at
    1x1, 2x1, 4x2 and 8x1 through ``place_graph_leveled_sharded`` (kernel
    K10 in run mode, one launch a fused run).  Each layout equals the
    plain shard body on the CPU bit for bit and the step mode (two launches
    a wave) on the card, and meets tests/test_sharded_engine.py's gate
    against phase 3's one-shot K1 result (f16 wire), which 1x1 equals bit
    for bit.  Then the mirror's workers-axis view (K11) on 512 workers and
    on 1,000 in a capacity of 1,024 at dw = 1 and 2 feeding the engine,
    ``ProcessGroupShards`` on NCCL with a world of 1, and ``TorchPlacement``
    with an explicit 4x2 layout of virtual shards on the 1M uniform batch.
    ``oneshot``: phase 3's K1 results by fleet (None: placed here, so the
    phase runs alone); ``ptxas``: phase 1's registers and spills of K10."""
    import torch.distributed as dist

    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.ops import fleet as fleet_ops
    from distributed_tpu_torch.ops import leveled, partition, sharded
    from distributed_tpu_torch.profile_sharded import idle_share, k10_launches
    from distributed_tpu_torch.scheduler import plan
    from distributed_tpu_torch.scheduler.mirror import SHARDED_FIELDS, TorchMirror
    from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_periodic_cases as pc

    card = smi_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    t_phase = time.perf_counter()
    graph = graphs.random_dag(N_TASKS, seed=0)
    packed = leveled.pack_graph(*graph, bandwidth=BANDWIDTH, latency=LATENCY)
    fleets = _fleets()
    L = packed.n_levels
    if oneshot is None:
        oneshot = {name: leveled.place_graph_leveled(packed, *fleet) for name, fleet in fleets.items()}

    # the main path: place_graph_leveled_sharded as a user calls it, every count zeroed
    step_pair = (sharded.shard_tentative, sharded.shard_contend)
    sharded.place_shard_cuda.launches = sharded.place_shard_run_cuda.launches = 0
    results, stats, walls, launched = {}, {}, {}, {}
    for name, fleet in fleets.items():
        for layout in SHARD_LAYOUTS:
            st = {}
            counts = sharded.place_shard_run_cuda.launches, sharded.place_shard_cuda.launches
            t0 = time.perf_counter()
            results[layout, name] = sharded.place_graph_leveled_sharded(
                _shard_mesh(partition, layout, dev), packed, *fleet, stats=st)
            walls[layout, name] = (time.perf_counter() - t0) * 1e3
            stats[layout, name] = st
            launched[layout, name] = (sharded.place_shard_run_cuda.launches - counts[0],
                                      sharded.place_shard_cuda.launches - counts[1])
    launches, step_launches = sharded.place_shard_run_cuda.launches, sharded.place_shard_cuda.launches
    n_runs = {layout: len(sharded._plan_runs_sharded(packed.offsets, _shard_mesh(partition, layout, dev).size))
              for layout in SHARD_LAYOUTS}
    # each placement: one run-mode launch a fused run, no step-mode launch
    for (layout, name), took in launched.items():
        check(took == (n_runs[layout], 0),
              f"{layout} {name}: K10 (run, step) launches {took} != ({n_runs[layout]}, 0)")
    want = len(fleets) * sum(n_runs.values())
    check(launches == want and step_launches == 0,
          f"K10 run-mode launches {launches} != {want} (one a fused run) or step-mode launches "
          f"{step_launches} != 0")
    print(f"[{card}] sharded main path: K10 run mode, {launches} launches (one a fused run: "
          f"{n_runs} runs a layout) over {L} waves, step-mode launches {step_launches}, "
          f"{len(SHARD_LAYOUTS)} layouts x {len(fleets)} fleets")

    cases_out, err_max = {}, 0.0
    for name, fleet in fleets.items():
        running = fleet[2]
        k1 = oneshot[name]
        t0 = time.perf_counter()
        leveled.place_graph_leveled(packed, *fleet)
        torch.cuda.synchronize()
        single_wall = (time.perf_counter() - t0) * 1e3
        for layout in SHARD_LAYOUTS:
            res = results[layout, name]
            leveled.validate_leveled(packed, res, graph[2], graph[3], running)
            check(np.isfinite(res.start_time).all() and np.isfinite(res.occupancy).all(),
                  f"{layout} {name}: non-finite result")
            mesh = _shard_mesh(partition, layout, dev)
            t0 = time.perf_counter()
            cpu = sharded.place_graph_leveled_sharded(
                _shard_mesh(partition, layout, "cpu"), packed, *fleet)
            cpu_s = time.perf_counter() - t0
            err = max(float(np.abs(res.occupancy - cpu.occupancy).max()),
                      float(np.abs(res.start_time - cpu.start_time).max()))
            check(_same(res, cpu), f"{layout} {name}: K10 differs from the plain body on the CPU")
            check(_same(sharded.place_graph_leveled_sharded(mesh, packed, *fleet), res),
                  f"{layout} {name}: two K10 runs differ")
            if layout == "1x1":
                check(_same(res, k1), f"1x1 {name}: differs from phase 3's one-shot K1 result")
            flipped = res.assignment != k1.assignment
            agree = 1.0 - float(flipped.mean())
            check(agree > SHARD_MIN_AGREEMENT, f"{layout} {name}: agreement {agree} with K1")
            check(np.allclose(res.start_time, k1.start_time, rtol=SHARD_START_RTOL,
                              atol=SHARD_START_ATOL), f"{layout} {name}: start times outside the gate")
            # occupancy: the gate on every worker no flipped task touched.  On
            # the uniform fleet the reference's own sharded engine moves 2 of
            # the 1M tasks, whose ~0.5 s each is ~1e-3 of a worker's load, so
            # the gate over all workers fails there for the reference too
            touched = np.zeros(len(k1.occupancy), bool)
            touched[res.assignment[flipped]] = touched[k1.assignment[flipped]] = True
            occ_excess = float(np.max(np.abs(res.occupancy - k1.occupancy)
                                      / (SHARD_OCC_ATOL + SHARD_OCC_RTOL * np.abs(k1.occupancy))))
            check(np.allclose(res.occupancy[~touched], k1.occupancy[~touched],
                              rtol=SHARD_OCC_RTOL, atol=SHARD_OCC_ATOL),
                  f"{layout} {name}: occupancy outside the gate on workers no flipped task touched")
            run, waves, _ = _timed_waves(sharded, mesh, packed, fleet)
            check(run.mode == "run", f"{layout} {name}: ShardedRun took {run.mode} mode")
            srun, swaves, _ = _timed_waves(sharded, mesh, packed, fleet, body=step_pair)
            ms = cuda_ms(waves, reps=5, warmup=1)
            step_ms = cuda_ms(swaves, reps=5, warmup=1)
            carry = [getattr(run.replicas[dev], f) for f in ("assign", "choices", "load", "spans")]
            check(all(torch.equal(a, getattr(srun.replicas[dev], f)) for a, f in
                      zip(carry, ("assign", "choices", "load", "spans"))),
                  f"{layout} {name}: run mode and step mode differ")
            idle = idle_share(torch, waves, k10_launches(sharded, waves))
            prun, pwaves, _ = _timed_waves(sharded, mesh, packed, fleet, body=sharded.PLAIN_BODY)
            plain_ms = cuda_ms(pwaves, reps=3, warmup=1)
            del run, srun, prun
            bound_ms, bound_by = _shard_bound_ms(packed, N_WORKERS, mesh.size)
            h2d = [r["h2d_bytes"] for r in stats[layout, name]["shards"]]
            print(f"[{card}] sharded {layout} {name}: == CPU plain ({cpu_s:.1f} s)"
                  f"{', == phase 3 K1' if layout == '1x1' else ''}, agreement with K1 {agree:.6f} "
                  f"({int(flipped.sum())} tasks, {int(touched.sum())} workers touched; occupancy "
                  f"over all workers at {occ_excess:.3f}x the gate); "
                  f"K10 waves ms run mode {ms:.3f} (idle share {idle['idle_share']:.3f}, "
                  f"{idle['traced_idle_share']:.3f} of the traced call's wall) "
                  f"step mode {step_ms:.3f} (== run mode) plain ms {plain_ms:.3f} "
                  f"bound_ms {bound_ms:.4f} ({bound_by}); "
                  f"runs {stats[layout, name]['runs']} h2d_bytes per shard {h2d[0]} (total {sum(h2d)}); "
                  f"wall ms sharded {walls[layout, name]:.1f} single-device {single_wall:.1f}")
            err_max = max(err_max, err)
            cases_out[f"{layout}_{name}"] = dict(
                max_abs_err=err, ms=ms, step_ms=step_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, launches=launched[layout, name][0],
                step_launches=launched[layout, name][1], **idle,
                agreement_k1=agree, flipped_tasks=int(flipped.sum()), occ_gate_excess=occ_excess,
                runs=stats[layout, name]["runs"], h2d_bytes_per_shard=h2d,
                wall_ms=walls[layout, name], single_wall_ms=single_wall, cpu_s=cpu_s)
        torch.cuda.empty_cache()

    # K11: the mirror's workers-axis view on the card feeding the engine, and
    # dirty rows after it (one launch a view); every count zeroed just before
    # and read just after
    TorchMirror.launches = 0
    fleet_ops.scatter_blocks_cuda.launches = 0
    state = pc.StandInState()
    mirror = state.mirror = TorchMirror(state)
    mirror_cases, fleet_log, k11_views = {}, [], 0
    with fleet_checked(fleet_log):
        for fname, W in STEAL_FLEETS:
            ws_list = _stand_in_workers(state, W)
            rng = np.random.default_rng(W)
            for ws in ws_list[::5]:
                ws.occupancy = float(rng.uniform(0, 4))
                mirror.mark(ws)
            for layout in MIRROR_LAYOUTS:
                fv = mirror.fleet_view()
                host = (fv.nthreads.copy(), fv.occupancy.copy(), fv.running.copy())
                mesh = _shard_mesh(partition, layout, dev)
                before = mirror.sharded_stats()
                view = mirror.sharded_device_view(mesh)
                first = mirror.sharded_stats()
                same_rows = all(np.array_equal(torch.cat(view[f]).cpu().numpy(), getattr(mirror, f))
                                for f in SHARDED_FIELDS)
                check(same_rows, f"K11 {fname} {layout}: view rows differ from the host's")
                fresh = mirror.sharded_device_view(mesh)
                after = mirror.sharded_stats()
                check(after["rows_uploaded"] == first["rows_uploaded"]
                      and after["full_packs"] == first["full_packs"],
                      f"K11 {fname} {layout}: a fresh cycle uploaded {after} after {first}")
                got = sharded.place_graph_leveled_sharded(mesh, packed, *host, fleet_dev=fresh)
                ref = sharded.place_graph_leveled_sharded(mesh, packed, *host)
                check(_same(got, ref), f"K11 {fname} {layout}: fleet_dev placement differs from host-fed")
                # TIMED_DIRTY dirty rows: one launch of K11; the view handed out before is unchanged
                held = {f: torch.cat(fresh[f]).clone() for f in SHARDED_FIELDS}
                for ws in rng.choice(ws_list, TIMED_DIRTY, replace=False):
                    ws.occupancy = float(rng.uniform(0, 4))
                    mirror.mark(ws)
                dirty = mirror.sharded_device_view(mesh)
                k11_views += 1
                check(all(np.array_equal(torch.cat(dirty[f]).cpu().numpy(), getattr(mirror, f))
                          for f in SHARDED_FIELDS), f"K11 {fname} {layout}: dirty rows differ from the host's")
                check(all(torch.equal(torch.cat(fresh[f]), held[f]) for f in SHARDED_FIELDS),
                      f"K11 {fname} {layout}: a view handed out changed")
                print(f"[{card}] mirror sharded view {fname} (capacity {mirror.cap}) {layout}: "
                      f"rows == host, full packs {first['full_packs']} (before {before['full_packs']}), "
                      f"fresh cycle rows uploaded {[a - b for a, b in zip(after['rows_uploaded'], first['rows_uploaded'])]}, "
                      f"fleet_dev placement == host-fed; {TIMED_DIRTY} dirty rows: one K11 launch, rows == "
                      f"host, the view handed out unchanged")
                mirror_cases[f"{fname}_{layout}"] = dict(capacity=mirror.cap, n_shards=after["n_shards"],
                                                         full_packs=after["full_packs"],
                                                         rows_uploaded=mirror.sharded_stats()["rows_uploaded"])
    k11_launches = fleet_ops.scatter_blocks_cuda.launches
    check(k11_launches == k11_views == len(fleet_log)
          and all(e[0] == "scatter_blocks_cuda" and e[3] for e in fleet_log),
          f"K11 on the main path: {k11_launches} launches, {k11_views} dirty views, {fleet_log}")
    check(mirror.plan_builds == mirror.full_uploads,
          f"K11's plans built {mirror.plan_builds} times for {mirror.full_uploads} full packs")
    k11_builds, k11_waits = mirror.plan_builds, mirror.staging_waits
    print(f"[{card}] K11 on the main path: {k11_launches} launches, one a dirty view, == the plain "
          f"version on the card bit for bit; views that wrote to the card {TorchMirror.launches}; plans "
          f"built {k11_builds} times, as often as the full packs; staging waits {k11_waits}")
    mesh2 = _shard_mesh(partition, "4x2", dev)
    k11 = k11_view_split(card, mirror, mesh2, dev, np.random.default_rng(81))

    # ProcessGroupShards on NCCL, a world of one, against LocalShards 1x1
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
                            device_id=dev)
    try:
        mesh1 = _shard_mesh(partition, "1x1", dev)
        pg = sharded.ProcessGroupShards(mesh1)
        pg_mode = sharded.shard_mode(pg, [dev])
        counts = sharded.place_shard_run_cuda.launches, sharded.place_shard_cuda.launches
        for name, fleet in fleets.items():
            got = sharded.place_graph_leveled_sharded(mesh1, packed, *fleet, comm=pg)
            check(_same(got, results["1x1", name]), f"NCCL world 1 {name}: differs from LocalShards 1x1")
        took = (sharded.place_shard_run_cuda.launches - counts[0],
                sharded.place_shard_cuda.launches - counts[1])
        check(pg_mode == "step" and took == (0, 2 * L * len(fleets)),
              f"NCCL world 1: mode {pg_mode}, (run, step) launches {took}")
        print(f"[{card}] ProcessGroupShards on NCCL (world 1) == LocalShards 1x1 on both fleets; "
              f"mode {pg_mode} (step launches {took[1]}, two a wave)")
    finally:
        dist.destroy_process_group()

    # the extension: TorchPlacement with an explicit 4x2 layout of virtual shards
    placement = TorchPlacement(sync=True, mesh_enabled=True, mesh_layout="4x2",
                               mesh_shard_devices=[dev] * 8)
    check(placement._mesh == mesh2, "TorchPlacement built another mesh")
    addrs = [f"tcp://10.1.{w // 256}.{w % 256}:8788" for w in range(N_WORKERS)]
    keys = [f"task-{i}" for i in range(N_TASKS)]
    engine = {}
    counts = sharded.place_shard_run_cuda.launches, sharded.place_shard_cuda.launches
    t0 = time.perf_counter()
    hints = placement._plan_from_arrays(keys, *graph, *fleets["uniform"], addrs, BANDWIDTH,
                                        LATENCY, stats=engine)
    ext_ms = (time.perf_counter() - t0) * 1e3
    took = (sharded.place_shard_run_cuda.launches - counts[0],
            sharded.place_shard_cuda.launches - counts[1])
    check(took == (n_runs["4x2"], 0), f"TorchPlacement 4x2: (run, step) launches {took}")
    pk, direct = leveled.place_graph_streamed(*graph, *fleets["uniform"], bandwidth=BANDWIDTH,
                                              latency=LATENCY, mesh=mesh2)
    check(hints == plan.hints_from_placement(keys, pk, direct, addrs),
          "TorchPlacement 4x2 hints differ from the direct place_graph_streamed(mesh=...) call")
    check(len(engine.get("shards", ())) == 8, f"engine shards: {engine.get('shards')}")
    check(placement.enabled, "the planner disabled itself")
    print(f"[{card}] TorchPlacement 4x2 virtual shards, 1M uniform batch: hints == direct "
          f"place_graph_streamed(mesh=...), engine_shards 8 rows, mode run ({took[0]} launches), "
          f"_plan_from_arrays wall_ms {ext_ms:.1f}")
    phase_s = time.perf_counter() - t_phase
    print(f"[{card}] phase 7 s {phase_s:.1f}")

    head = cases_out["_".join(SHARD_HEADLINE)]
    entry = {
        "name": "place_shard",
        "route": "cuda",
        "source": "distributed_tpu_torch/ops/csrc/place_shard.cu",
        "replaces": "distributed_tpu/ops/leveled.py:1140",
        "launches": launches,
        "launches_step": step_launches,
        "mode": "run",
        "max_abs_err": err_max,
        "ms": head["ms"],
        "step_ms": head["step_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "case": "_".join(SHARD_HEADLINE),
        "cases": cases_out,
        "ptxas": ptxas or {},
        "phase_s": phase_s,
    }
    mirror_entry = dict(
        name="mirror_shard_view", route="cuda", source="distributed_tpu_torch/ops/csrc/fleet_scatter.cu",
        replaces="distributed_tpu/scheduler/mirror.py:428", launches=k11_launches, max_abs_err=0.0,
        **_fleet_entry(k11), case=f"{TIMED_DIRTY} dirty rows, dw 2, capacity {mirror.cap}",
        sharded_views=mirror_cases, plan_builds_main_path=k11_builds, staging_waits_main_path=k11_waits,
        **{k: v for k, v in k11.items() if k not in ("bound_ms", "bound_by")})
    return entry, mirror_entry


# ------------------------------------------------------------ phase 8

# the data plane: 8 virtual shards on the card, ~TPC-H lineitem at SF10
# (~60M rows) moved by a dask-dataframe shuffle (merge, set_index)
SHUF_SHARDS = 8
SHUF_ROWS = 8_388_608         # rows a shard: 67,108,864 in all
SHUF_WIDTH = 4                # f32 values a row: 20 B a row with the key
SHUF_RAGGED = 2_097_152       # DeviceRun.exchange's partitions, cut ragged
ZIPF_KEYS = 2_526             # the skewed case's key values: its fullest destination
                              # gets ~27 % of a shard, past the default capacity's 25 %
ZIPF_A = 1.1
# long context: seq 16,384 over 8 shards (2,048 each), 16 heads, dim 128, bf16
LC_SEQ, LC_HEADS, LC_DIM, LC_SHARDS = 16_384, 16, 128, 8


def _shuffle_bound_ms(S, n, width, n_dev, cap, masked=False):
    """Bytes: keys, values (and valid) read once, the send buffers
    (padding included) and sent written once."""
    nbytes = S * n * (4 + 4 * width + (1 if masked else 0))
    nbytes += S * n_dev * (cap * (4 + 4 * width) + 4)
    return nbytes / PEAK_BYTES_S * 1e3, "bytes"


def _routing_ok(ici, parts, n_dev):
    return all(bool((ici._mix32(k) % n_dev == d).all()) for d, (k, _) in enumerate(parts))


def _sorted_rows(keys, vals):
    """The rows in (key, value bits) order: the multiset, comparable bytewise."""
    cols = [keys] + [vals.view(torch.int32)[:, c] for c in range(vals.shape[1])]
    order = torch.arange(keys.shape[0], device=keys.device)
    for col in reversed(cols):
        order = order[torch.argsort(col[order], stable=True)]
    return keys[order], vals[order]


def _same_bytes(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _bucket_vs_plain(ici, kp, vp, valid, n_dev, cap, label):
    """K12 on every shard against the plain version, bit for bit, twice."""
    first = ici.shuffle_bucket_cuda(kp, vp, valid, n_dev, cap)
    again = ici.shuffle_bucket_cuda(kp, vp, valid, n_dev, cap)
    err = 0.0
    for s in range(len(kp)):
        want = ici.shuffle_bucket_reference(kp[s], vp[s], None if valid is None else valid[s],
                                            n_dev, cap)
        for w, a, b in zip(want, (first[0][s], first[1][s], first[2][s]),
                           (again[0][s], again[1][s], again[2][s])):
            check(_same_bytes(w, a), f"{label}: K12 differs from its plain version on shard {s}")
            check(_same_bytes(a, b), f"{label}: K12 does not repeat itself on shard {s}")
        err = max(err, (first[1][s].float() - want[1].float()).abs().max().item())
        del want
    return first, err


def _zipf_keys(n, g, dev):
    """``n`` keys Zipf(a = 1.1) over 1..ZIPF_KEYS, key 1 the busiest
    (inverse CDF on the card): a truncation check, not a deployment's skew."""
    p = torch.arange(1, ZIPF_KEYS + 1, dtype=torch.float64, device=dev) ** -ZIPF_A
    cdf = torch.cumsum(p / p.sum(), 0)
    u = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    return (torch.searchsorted(cdf, u).clamp_max(ZIPF_KEYS - 1) + 1).to(torch.int32)


def phase_data_plane(ptxas=None):
    """Phase 8, the shuffle: K12 and the data plane's main path."""
    from distributed_tpu_torch.ops import comm, ici
    from distributed_tpu_torch.parallel import multihost
    from distributed_tpu_torch.shuffle import device as dshuffle

    dev = torch.device("cuda", 0)
    card = smi_line()
    t_phase = time.perf_counter()
    S, n, n_dev = SHUF_SHARDS, SHUF_ROWS, SHUF_SHARDS
    mesh = ici.make_mesh_1d(S, devices=[dev] * S)
    g = torch.Generator(device=dev).manual_seed(8)
    keys = torch.randint(0, 1 << 30, (S * n,), generator=g, device=dev, dtype=torch.int32)
    vals = torch.rand((S * n, SHUF_WIDTH), generator=g, device=dev)
    zkeys = _zipf_keys(S * n, g, dev)
    cap = ici.default_capacity(n, n_dev)

    # the main path, through the entry points a user calls
    ici.shuffle_bucket_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ko, vo, counts, sent = ici.shuffle_on_mesh(mesh, keys, vals)
    parts = ici.compact_shuffle_output(ko, vo, counts, n_dev)
    torch.cuda.synchronize()
    first_wall = (time.perf_counter() - t0) * 1e3
    zo = ici.shuffle_on_mesh(mesh, zkeys, vals)
    try:
        ici.compact_shuffle_output(zo[0], zo[1], zo[2], n_dev)
        zipf_raised = False
    except ValueError as exc:
        zipf_raised = "truncated" in str(exc)
    zmax = int(torch.stack(zo[3]).max())
    del zo
    zfull = ici.shuffle_on_mesh(mesh, zkeys, vals, capacity=n)
    zparts = ici.compact_shuffle_output(zfull[0], zfull[1], zfull[2], n_dev)
    del zfull
    lengths = [SHUF_RAGGED - SHUF_RAGGED // 56 * i for i in range(S)]  # down to 7/8
    rkeys = [keys[i * n: i * n + m] for i, m in enumerate(lengths)]
    rvals = [vals[i * n: i * n + m] for i, m in enumerate(lengths)]
    run = dshuffle.DeviceRun("phase8", 1, S, S, devices=[dev] * S)
    for i in range(S):
        run.register(i, rkeys[i], rvals[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.exchange()
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = ici.shuffle_bucket_cuda.launches
    check(launches == 16, f"K12 launches on the main path {launches}, expected 16 (4 calls)")

    # the results, by the repo's own means
    check(all(p[0].device == dev for p in parts), "outputs left the card")
    check(sum(len(k) for k, _ in parts) == S * n, "rows lost")
    check(_routing_ok(ici, parts, n_dev), "a row landed off mix32(key) % 8")
    bad = [(k.clone(), v) for k, v in parts]
    bad[1] = (torch.cat([parts[0][0][:1], parts[1][0]]), torch.cat([parts[0][1][:1], parts[1][1]]))
    bad[0] = (parts[0][0][1:], parts[0][1][1:])
    check(not _routing_ok(ici, bad, n_dev), "the routing check passes a row sent one shard on")
    del bad
    out_k = torch.cat([k for k, _ in parts])
    out_v = torch.cat([v for _, v in parts])
    a, b = _sorted_rows(keys, vals), _sorted_rows(out_k, out_v)
    check(_same_bytes(a[0], b[0]) and _same_bytes(a[1], b[1]),
          "the multiset of (key, value) rows changed")
    del a, b, out_k, out_v
    check(zipf_raised, f"the Zipf case did not raise at the default capacity {cap} "
          f"(largest true count {zmax})")
    check(sum(len(k) for k, _ in zparts) == S * n and _routing_ok(ici, zparts, n_dev),
          "the Zipf case at capacity = rows lost or misrouted rows")
    a, b = _sorted_rows(zkeys, vals), _sorted_rows(torch.cat([k for k, _ in zparts]),
                                                     torch.cat([v for _, v in zparts]))
    check(_same_bytes(a[0], b[0]) and _same_bytes(a[1], b[1]), "the Zipf case changed the rows")
    del a, b, zparts
    print(f"[{card}] shuffle {S} x {n} rows, int32 keys in [0, 2^30), [{SHUF_WIDTH}] f32 values, "
          f"capacity {cap}: rows conserved, every row on mix32(key) % {n_dev}, a row moved one "
          f"shard on caught; first call wall_ms {first_wall:.1f}")
    print(f"[{card}] Zipf a={ZIPF_A} over {ZIPF_KEYS} keys: raised at capacity {cap} "
          f"(largest true count {zmax}, {zmax / n:.4f} of a shard); at capacity {n} every row kept")
    cpu = dshuffle.DeviceRun("phase8", 1, S, S, devices=["cpu"] * S)
    for i in range(S):
        cpu.register(i, rkeys[i].cpu(), rvals[i].cpu())
    cpu.exchange()
    for d in range(S):
        check(run.outputs[d][0].device == dev, "DeviceRun output off the card")
        check(_same_bytes(run.outputs[d][0].cpu(), cpu.outputs[d][0])
              and _same_bytes(run.outputs[d][1].cpu(), cpu.outputs[d][1]),
              f"DeviceRun output {d} differs from the CPU run")
    print(f"[{card}] DeviceRun.exchange {S} ragged partitions ({min(lengths)}-{max(lengths)} rows): "
          f"outputs == the CPU run bit for bit; exchange wall_ms {run_ms:.1f}")
    del run, cpu

    # K12 against its plain version, both cases, bit for bit and repeated
    kp, vp = list(keys.split(n)), list(vals.split(n))
    zp = list(zkeys.split(n))
    _, err = _bucket_vs_plain(ici, kp, vp, None, n_dev, cap, "uniform")
    _, zerr = _bucket_vs_plain(ici, zp, vp, None, n_dev, cap, "zipf, default capacity")
    _bucket_vs_plain(ici, zp, vp, None, n_dev, n, "zipf, capacity = rows")
    mask = [torch.rand(n, generator=g, device=dev) < 0.9 for _ in range(S)]
    _bucket_vs_plain(ici, kp, vp, mask, n_dev, cap, "masked")
    print(f"[{card}] K12 == shuffle_bucket_reference bit for bit (uniform, Zipf at both "
          f"capacities, masked), repeated")

    # times
    k12_ms = cuda_ms(lambda: ici.shuffle_bucket_cuda(kp, vp, None, n_dev, cap))
    plain_ms = cuda_ms(lambda: [ici.shuffle_bucket_reference(kp[s], vp[s], None, n_dev, cap)
                                for s in range(S)], reps=3, warmup=1)
    zk12_ms = cuda_ms(lambda: ici.shuffle_bucket_cuda(zp, vp, None, n_dev, n), reps=5)
    sk, sv, sc = ici.shuffle_bucket_cuda(kp, vp, None, n_dev, cap)
    local = comm.LocalShards(mesh)

    def exchange():
        local.all_to_all(sk)
        local.all_to_all(sv)
        local.all_to_all([c[:, None] for c in sc])

    a2a_ms = cuda_ms(exchange)
    # the ring step (the reference's ``_ring_program.local``, ``lax.ppermute``)
    # alone on a shard's block of values: LocalShards hands every shard the
    # tensor its neighbour holds on the same card, moving no bytes
    ring_bytes = vp[0].numel() * vp[0].element_size()
    ppermute_local_ms = cuda_ms(lambda: local.ppermute(vp), reps=5)
    mesh_ms = cuda_ms(lambda: ici.shuffle_on_mesh(mesh, keys, vals), reps=5)
    bound_ms, bound_by = _shuffle_bound_ms(S, n, SHUF_WIDTH, n_dev, cap)
    zbound_ms, _ = _shuffle_bound_ms(S, n, SHUF_WIDTH, n_dev, n)
    del sk, sv, sc
    print(f"[{card}] K12 ms {k12_ms:.4f} plain_ms {plain_ms:.3f} bound_ms {bound_ms:.4f} "
          f"({bound_by}); Zipf at capacity {n}: K12 ms {zk12_ms:.4f} bound_ms {zbound_ms:.4f}; "
          f"all_to_all ms {a2a_ms:.4f}; shuffle_on_mesh ms {mesh_ms:.4f}")

    # ProcessGroupShards on NCCL, a world of one, against LocalShards at one shard
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    check(multihost.maybe_initialize(f"localhost:{port}", 0, 1, local_device_ids=[0]),
          "maybe_initialize did not start a group")
    try:
        check(dist.get_backend() == "nccl" and not multihost.is_multihost(), "NCCL world of one")
        mesh1 = ici.make_mesh_1d(1, devices=[dev])
        got = ici.shuffle_on_mesh(mesh1, kp[0], vp[0], comm=comm.ProcessGroupShards(mesh1))
        want = ici.shuffle_on_mesh(mesh1, kp[0], vp[0])
        check(all(_same_bytes(x[0], y[0]) for x, y in zip(got, want)),
              "ProcessGroupShards (NCCL, world 1) differs from LocalShards")
        ring = ici.ring_exchange(mesh1, kp[0], comm=comm.ProcessGroupShards(mesh1))
        check(_same_bytes(ring[0], kp[0]), "ring_exchange over a world of one moved data")
        # the same ring step on one block over the process group: a world of
        # one copies the block (read once, written once)
        pg = comm.ProcessGroupShards(mesh1)
        ppermute_ms = cuda_ms(lambda: pg.ppermute([vp[0]]), reps=5)
    finally:
        dist.destroy_process_group()
    ppermute_bound_ms = 2 * ring_bytes / PEAK_BYTES_S * 1e3
    print(f"[{card}] maybe_initialize (NCCL, world 1) + ProcessGroupShards == LocalShards at one "
          f"shard: shuffle_on_mesh, ring_exchange")
    print(f"[{card}] ppermute alone on a block of {ring_bytes} B ([{n}, {SHUF_WIDTH}] f32), CUDA "
          f"events, median of 5: ProcessGroupShards (NCCL, world 1, a copy) ms {ppermute_ms:.4f}, "
          f"bound_ms {ppermute_bound_ms:.4f} (bytes: 2 x the block); LocalShards on {S} shards of "
          f"the card (the tensors handed over, nothing copied) ms {ppermute_local_ms:.4f}")
    phase_s = time.perf_counter() - t_phase
    print(f"[{card}] phase 8 shuffle s {phase_s:.1f}")
    return {
        "name": "shuffle_bucket",
        "route": "cuda",
        "source": "distributed_tpu_torch/ops/csrc/shuffle_bucket.cu",
        "replaces": "distributed_tpu/ops/ici.py:57",
        "launches": launches,
        "max_abs_err": max(err, zerr),
        "ms": k12_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "case": f"{S} x {n} rows, 20 B, capacity {cap}",
        "zipf_full_capacity_ms": zk12_ms,
        "zipf_full_capacity_bound_ms": zbound_ms,
        "all_to_all_ms": a2a_ms,
        "ppermute_ms": ppermute_ms,
        "ppermute_bound_ms": ppermute_bound_ms,
        "ppermute_block_bytes": ring_bytes,
        "ppermute_local_ms": ppermute_local_ms,
        "shuffle_on_mesh_ms": mesh_ms,
        "device_run_exchange_ms": run_ms,
        "ptxas": ptxas or {},
        "phase_s": phase_s,
    }


def _plain_whole(flash, q, k, v, causal, scale, heads_at_once=2):
    """The plain forward over the whole sequence and its u (P|V|)/l term,
    a few heads at a time ([H, N, D])."""
    qt, kt, vt = (x.transpose(0, 1).contiguous() for x in (q, k, v))
    o, pv = [], []
    u = flash.P_ROUNDOFF.get(q.dtype, 0.0)
    for h in range(0, qt.shape[0], heads_at_once):
        sl = slice(h, h + heads_at_once)
        o_h, lse_h = flash.flash_forward_reference(qt[sl], kt[sl], vt[sl], causal, scale)
        o.append(o_h)
        pv.append(u * flash.pv_rounding_term(qt[sl], kt[sl], vt[sl], causal, scale, lse_h))
        del lse_h
    return torch.cat(o), torch.cat(pv)


def _ring_missing_a_step(flash, ring_attention, q, k, v, n, causal, scale, step=1):
    """A planted fault: the ring's fold of each shard's visible blocks
    (flash_forward, then ``_merge``) with ring step ``step`` left out."""
    qt, kt, vt = (ring_attention._heads_first(x.chunk(n)) for x in (q, k, v))
    out = []
    for d in range(n):
        o = lse = None
        for s in range(n):
            owner = (d - s) % n
            if s != step and ring_attention._visible(d, owner, causal):
                o_b, lse_b = flash.flash_forward(qt[d], kt[owner], vt[owner],
                                                 causal and owner == d, scale)
                o, lse = ring_attention._merge(o, lse, o_b, lse_b)
        out.append(o)
    return out


def _ulysses_plain(ulysses, flash, mesh, q, k, v, causal, scale):
    """Ulysses with the local attention's plain version: the same two
    all_to_alls around flash_forward_reference on each head group."""
    from distributed_tpu_torch.ops import comm, ici

    local = comm.LocalShards(mesh)
    n = mesh.size
    parts = [ulysses.seq_to_heads(local, ici.local_parts(mesh, local, x), n) for x in (q, k, v)]
    outs = []
    for qh, kh, vh in zip(*parts):
        o, _ = flash.flash_forward_reference(*(x.transpose(0, 1).contiguous() for x in (qh, kh, vh)),
                                             causal, scale)
        outs.append(o.transpose(0, 1))
    return ulysses.heads_to_seq(local, outs, n)


def phase_long_context():
    """Phase 8, long context: ring attention (K2 a block) and Ulysses (K2
    on each head group) on 8 virtual shards."""
    from distributed_tpu_torch.ops import flash, ici, ring_attention, ulysses

    dev = torch.device("cuda", 0)
    card = smi_line()
    t_phase = time.perf_counter()
    dtype = torch.bfloat16
    q, k, v = _flash_inputs(LC_SEQ, LC_HEADS, LC_DIM, dtype, seed=12)
    scale = 1.0 / LC_DIM ** 0.5
    mesh = ici.make_mesh_1d(LC_SHARDS, axis="sp", devices=[dev] * LC_SHARDS)
    cases = (("causal", True), ("full", False))
    ring_out, uly_out = {}, {}
    flash.flash_forward_cuda.launches = 0
    for label, causal in cases:
        ring_out[label] = ring_attention.ring_attention(mesh, q, k, v, causal=causal)
    torch.cuda.synchronize()
    ring_launches = flash.flash_forward_cuda.launches
    n = LC_SHARDS
    check(ring_launches == n * (n + 1) // 2 + n * n, f"ring K2 launches {ring_launches}")
    flash.flash_forward_cuda.launches = 0
    for label, causal in cases:
        uly_out[label] = ulysses.ulysses_attention(mesh, q, k, v, causal=causal)
    torch.cuda.synchronize()
    uly_launches = flash.flash_forward_cuda.launches
    check(uly_launches == 2 * n, f"Ulysses K2 launches {uly_launches}")

    res = {}
    qt, kt, vt = (x.transpose(0, 1).contiguous() for x in (q, k, v))
    for label, causal in cases:
        out = ring_out[label]
        check(all(o.shape == (LC_SEQ // n, LC_HEADS, LC_DIM) and o.dtype == dtype
                  and bool(torch.isfinite(o.float()).all()) for o in out), f"ring {label} output")
        plain = ring_attention.ring_attention_reference(mesh, q, k, v, causal=causal)
        terms = ring_attention.ring_rounding_terms(q, k, v, n, causal, scale)
        excess = max(ring_attention.ring_excess(out[i], plain[i], terms[i]) for i in range(n))
        err = max((out[i].float() - plain[i].float()).abs().max().item() for i in range(n))
        bad = _ring_missing_a_step(flash, ring_attention, q, k, v, n, causal, scale)
        fault = max(ring_attention.ring_excess(bad[i].to(dtype).transpose(0, 1), plain[i], terms[i])
                    for i in range(n))
        del bad, terms, plain
        check(excess <= 0.0, f"ring {label}: beyond the bound by {excess} (max abs err {err})")
        check(fault > 0.0, f"ring {label}: the bound passes a ring with one step left out")
        uo = torch.cat(uly_out[label])
        o_p, pv = _plain_whole(flash, q, k, v, causal, scale)
        uexcess = flash.o_excess(uo.transpose(0, 1), o_p, pv)
        uerr = (uo.transpose(0, 1).float() - o_p.float()).abs().max().item()
        whole, _ = flash.flash_forward_cuda(qt, kt, vt, causal, scale)
        same_as_k2 = torch.equal(uo.transpose(0, 1), whole)
        del o_p, pv
        check(uexcess <= 0.0, f"Ulysses {label}: beyond K2's contract by {uexcess}")
        ring_ms = cuda_ms(lambda: ring_attention.ring_attention(mesh, q, k, v, causal=causal), reps=5)
        ring_plain_ms = cuda_ms(lambda: ring_attention.ring_attention_reference(
            mesh, q, k, v, causal=causal), reps=2, warmup=1)
        uly_ms = cuda_ms(lambda: ulysses.ulysses_attention(mesh, q, k, v, causal=causal), reps=5)
        uly_plain_ms = cuda_ms(lambda: _ulysses_plain(ulysses, flash, mesh, q, k, v, causal, scale),
                               reps=2, warmup=1)
        k2_ms = cuda_ms(lambda: flash.flash_forward_cuda(qt, kt, vt, causal, scale), reps=5)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt[None], kt[None], vt[None], is_causal=causal, scale=scale), reps=5)
        bound_ms, bound_by = _flash_bound_ms(LC_SEQ, LC_HEADS, LC_DIM, dtype, causal)
        res[label] = dict(ring_ms=ring_ms, ring_plain_ms=ring_plain_ms, ring_err=err,
                          ring_excess=excess, ring_fault_excess=fault, ulysses_ms=uly_ms,
                          ulysses_err=uerr, ulysses_excess=uexcess, ulysses_equals_k2=same_as_k2,
                          ulysses_plain_ms=uly_plain_ms, k2_whole_ms=k2_ms, library_ms=lib_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        print(f"[{card}] seq {LC_SEQ} ({n} shards) {LC_HEADS} heads dim {LC_DIM} bf16 {label}: "
              f"ring ms {ring_ms:.3f} (plain ring {ring_plain_ms:.1f}; err {err:.3g}, excess "
              f"{excess:.3g}, a step left out {fault:.3g}); Ulysses ms {uly_ms:.3f} (err {uerr:.3g}, "
              f"excess {uexcess:.3g}, == K2 on the whole sequence: {same_as_k2}; plain "
              f"{uly_plain_ms:.1f}); K2 whole "
              f"sequence ms {k2_ms:.3f}; SDPA ms {lib_ms:.3f}; bound ms {bound_ms:.3f} ({bound_by})")
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[{card}] ring K2 launches {ring_launches}, Ulysses K2 launches {uly_launches}; "
          f"phase 8 long context s {phase_s:.1f}")
    c = res["causal"]

    def entry(name, route_of, launches, ms_key, plain_key, err_key):
        return {
            "name": name,
            "route": "torch",
            "source": f"distributed_tpu_torch/ops/{name}.py",
            "replaces": route_of,
            "launches": launches,
            "max_abs_err": max(r[err_key] for r in res.values()),
            "ms": c[ms_key],
            "plain_ms": c[plain_key],
            "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "case": f"seq {LC_SEQ}, {n} shards, {LC_HEADS} heads, dim {LC_DIM}, bf16, causal",
            "cases": res,
            "phase_s": phase_s,
        }

    return [entry("ring_attention", "distributed_tpu/ops/ring_attention.py:65", ring_launches,
                  "ring_ms", "ring_plain_ms", "ring_err"),
            entry("ulysses", "distributed_tpu/ops/ulysses.py:184", uly_launches,
                  "ulysses_ms", "ulysses_plain_ms", "ulysses_err")]


# ------------------------------------------------------------ phase 9


# CUDA-event repetitions of each phase 9 and 10 time: 5 until phase 14 came
# and the script passed 400 s
LT_REPS = 3
# of phase 9's plain backwards (autograd through the plain ring, the plain
# local backward; ~1 s each): cut from LT_REPS to keep the script near 300 s
# once phase 12 came
LT_PLAIN_REPS = 2
LT_PLAIN_HEADS = 2           # heads a pass of the plain ring's autograd (its saved scores)
ULY_RAGGED = 1_000           # rows a shard of Ulysses' ragged case: a sequence of 8,000
K3_NAMES = ("bwd_delta_kernel", "bwd_dkdv_", "bwd_dq_")


def _leaves(q, k, v):
    return tuple(x.detach().requires_grad_() for x in (q, k, v))


def _train_step(fn, mesh, q, k, v, do, causal, comm=None):
    """Forward then backward into fresh leaves, as a user trains through
    ``fn``: the leaves' gradients."""
    leaves = _leaves(q, k, v)
    out = fn(mesh, *leaves, causal=causal, comm=comm)
    torch.autograd.backward(out, list(do.chunk(len(out))))
    return tuple(x.grad for x in leaves)


def _head_groups(ulysses, mesh, xs):
    """The ``[H / n, N, D]`` head groups Ulysses' local attention gets, for
    each of ``xs`` (no autograd)."""
    from distributed_tpu_torch.ops import comm, ici

    local = comm.LocalShards(mesh)
    with torch.no_grad():
        return [[h.transpose(0, 1).contiguous()
                 for h in ulysses.seq_to_heads(local, ici.local_parts(mesh, local, x), mesh.size)]
                for x in xs]


def _ulysses_checks(flash, ulysses, mesh, q, k, v, do, grads, causal, scale, label):
    """Per head group, K3 on K2's residuals within ``flash.bwd_excess`` of
    the plain backward on the same residuals, and the autograd gradients
    equal to K3's mapped back through ``heads_to_seq``.  Returns (max
    excess, max abs err, the plain residuals for timing)."""
    from distributed_tpu_torch.ops import comm

    local = comm.LocalShards(mesh)
    qh, kh, vh, doh = _head_groups(ulysses, mesh, (q, k, v, do))
    excess, err, k3_grads, plain_res = [], 0.0, [], []
    for qt, kt, vt, dot in zip(qh, kh, vh, doh):
        o, lse = flash.flash_forward_cuda(qt, kt, vt, causal, scale)
        res = (qt, kt, vt, o, lse, dot)
        got = flash.flash_backward_cuda(*res, causal, scale)
        plain = flash.flash_backward_reference(*res, causal, scale)
        terms = flash.bwd_rounding_terms(*res, causal, scale)
        excess.append(max(flash.bwd_excess(got, plain, terms)))
        err = max(err, *((a.float() - b.float()).abs().max().item() for a, b in zip(got, plain)))
        k3_grads.append(got)
        o_p, lse_p = flash.flash_forward_reference(qt, kt, vt, causal, scale)
        plain_res.append((qt, kt, vt, o_p, lse_p, dot))
        del o, lse, plain, terms
    for i, g in enumerate(grads):
        back = torch.cat(ulysses.heads_to_seq(local, [x[i].transpose(0, 1) for x in k3_grads],
                                              mesh.size))
        check(torch.equal(back, g), f"Ulysses {label}: the autograd gradient d{'qkv'[i]} is not "
              f"K3's on its head groups' residuals")
    check(max(excess) <= 0.0, f"Ulysses {label}: a head group beyond K3's contract by {excess}")
    return max(excess), err, plain_res


def phase_long_context_training():
    """Phase 9, long-context training: ring attention and Ulysses forward
    then backward on 8 virtual shards (K2 forward, K3 backward: a visible
    block of the ring, a head group of Ulysses)."""
    from distributed_tpu_torch.ops import comm, flash, ici, ring_attention, ulysses
    from distributed_tpu_torch.parallel import multihost
    from distributed_tpu_torch.profile_waves import kernel_times

    dev = torch.device("cuda", 0)
    card = smi_line()
    t_phase = time.perf_counter()
    dtype = torch.bfloat16
    n = LC_SHARDS
    q, k, v = _flash_inputs(LC_SEQ, LC_HEADS, LC_DIM, dtype, seed=12)
    do = _flash_inputs(LC_SEQ, LC_HEADS, LC_DIM, dtype, seed=13)[0]
    rq, rk, rv, rdo = _flash_inputs(n * ULY_RAGGED, LC_HEADS, LC_DIM, dtype, seed=14) + \
        _flash_inputs(n * ULY_RAGGED, LC_HEADS, LC_DIM, dtype, seed=15)[:1]
    scale = 1.0 / LC_DIM ** 0.5
    mesh = ici.make_mesh_1d(n, axis="sp", devices=[dev] * n)
    cases = (("causal", True), ("full", False))
    ring, uly = ring_attention.ring_attention, ulysses.ulysses_attention

    # the main path: forward and backward through autograd, as a user trains
    flash.flash_forward_cuda.launches = flash.flash_backward_cuda.launches = 0
    ring_grads = {label: _train_step(ring, mesh, q, k, v, do, causal) for label, causal in cases}
    torch.cuda.synchronize()
    ring_k2, ring_k3 = flash.flash_forward_cuda.launches, flash.flash_backward_cuda.launches
    visible = n * (n + 1) // 2 + n * n
    check(ring_k3 == visible, f"ring K3 launches {ring_k3} != {visible} (36 + 64)")
    check(ring_k2 == visible, f"ring K2 launches {ring_k2} != {visible}")
    flash.flash_forward_cuda.launches = flash.flash_backward_cuda.launches = 0
    uly_grads = {label: _train_step(uly, mesh, q, k, v, do, causal) for label, causal in cases}
    uly_grads["ragged"] = _train_step(uly, mesh, rq, rk, rv, rdo, True)
    torch.cuda.synchronize()
    uly_k2, uly_k3 = flash.flash_forward_cuda.launches, flash.flash_backward_cuda.launches
    check(uly_k3 == 3 * n and uly_k2 == 3 * n, f"Ulysses K2 / K3 launches {uly_k2} / {uly_k3} "
          f"!= {n} a training step")
    print(f"[{card}] long-context training main path: ring K2 {ring_k2} / K3 {ring_k3} launches "
          f"(causal + full), Ulysses K2 {uly_k2} / K3 {uly_k3} (causal, full, ragged "
          f"{n} x {ULY_RAGGED})")

    res = {}
    for label, causal in cases:
        grads = ring_grads[label]
        for x, g in zip((q, k, v), grads):
            check(g.shape == x.shape and g.dtype == dtype and bool(torch.isfinite(g.float()).all()),
                  f"ring {label}: gradient {g.shape} {g.dtype}")
        leaves = _leaves(q, k, v)
        out = ring(mesh, *leaves, causal=causal)
        dos = list(do.chunk(n))
        again = torch.autograd.grad(out, leaves, dos, retain_graph=True)
        again2 = torch.autograd.grad(out, leaves, dos, retain_graph=True)
        check(all(torch.equal(a, b) for a, b in zip(again, again2)),
              f"ring {label}: two backward calls differ")
        check(all(torch.equal(a, b) for a, b in zip(again, grads)),
              f"ring {label}: the training step's gradients differ from a backward on its graph")
        o = torch.cat([x.detach() for x in out])
        plain = ring_attention.ring_backward_reference(mesh, q, k, v, do, causal=causal,
                                                       heads_at_once=LT_PLAIN_HEADS)
        terms = ring_attention.ring_bwd_rounding_terms(q, k, v, o, do, n, causal, scale)
        per_shard = [tuple(g.chunk(n)[i] for g in grads) for i in range(n)]
        excess = [ring_attention.ring_bwd_excess(per_shard[i], plain[i], terms[i]) for i in range(n)]
        err = max((a.float() - b.float()).abs().max().item()
                  for i in range(n) for a, b in zip(per_shard[i], plain[i]))
        fault_a, fault_b = ring_attention.ring_bwd_planted_faults(q, k, v, o, do, per_shard, n,
                                                                  causal, scale)
        fault_step = min(max(ring_attention.ring_bwd_excess(fault_a[i], plain[i], terms[i]))
                         for i in range(n))
        fault_home = max(ring_attention.ring_bwd_excess(fault_b[n // 2], plain[n // 2],
                                                        terms[n // 2]))
        del fault_a, fault_b, terms
        worst = max(max(e) for e in excess)
        check(worst <= 0.0, f"ring {label}: beyond ring_bwd_excess by {worst} (max abs err {err})")
        check(fault_step > 0.0, f"ring {label}: the bound passes a ring step left out "
              f"(least excess over the shards {fault_step})")
        check(fault_home > 0.0, f"ring {label}: the bound passes dK/dV left on the wrong shard")

        uexcess, uerr, plain_res = _ulysses_checks(flash, ulysses, mesh, q, k, v, do,
                                                   uly_grads[label], causal, scale, label)
        # times, CUDA events
        step_ms = cuda_ms(lambda: _train_step(ring, mesh, q, k, v, do, causal), reps=LT_REPS)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, dos, retain_graph=True),
                         reps=LT_REPS)
        kt_ = kernel_times(torch, lambda: torch.autograd.grad(out, leaves, dos, retain_graph=True))
        k3_ms = sum(ms for name, (ms, _) in kt_.items() if any(x in name for x in K3_NAMES))
        dev_ms = sum(ms for ms, _ in kt_.values())
        plain_ms = cuda_ms(lambda: ring_attention.ring_backward_reference(
            mesh, q, k, v, do, causal=causal, heads_at_once=LT_PLAIN_HEADS), reps=LT_PLAIN_REPS,
            warmup=1)
        del out, leaves, again, again2, plain
        uleaves = _leaves(q, k, v)
        uout = uly(mesh, *uleaves, causal=causal)
        ustep_ms = cuda_ms(lambda: _train_step(uly, mesh, q, k, v, do, causal), reps=LT_REPS)
        ubwd_ms = cuda_ms(lambda: torch.autograd.grad(uout, uleaves, dos, retain_graph=True),
                          reps=LT_REPS)
        ukt = kernel_times(torch, lambda: torch.autograd.grad(uout, uleaves, dos, retain_graph=True))
        uk3_ms = sum(ms for name, (ms, _) in ukt.items() if any(x in name for x in K3_NAMES))
        uplain_ms = cuda_ms(lambda: [flash.flash_backward_reference(*r, causal, scale)
                                     for r in plain_res], reps=LT_PLAIN_REPS, warmup=1)
        del uout, uleaves, plain_res
        qt, kt, vt, dot = (x.transpose(0, 1).contiguous() for x in (q, k, v, do))
        qs, ks, vs = (x[None].requires_grad_() for x in (qt, kt, vt))
        sdpa = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                                scale=scale)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(sdpa, (qs, ks, vs), dot[None],
                                                     retain_graph=True), reps=LT_REPS)
        del sdpa, qs, ks, vs, qt, kt, vt, dot
        bound_ms, bound_by = _bwd_bound_ms(LC_SEQ, LC_SEQ, LC_HEADS, LC_DIM, dtype, causal)
        res[label] = dict(ring_step_ms=step_ms, ring_bwd_ms=bwd_ms, ring_k3_ms=k3_ms,
                          ring_k3_share=k3_ms / bwd_ms, ring_bwd_device_ms=dev_ms,
                          ring_plain_bwd_ms=plain_ms, ring_err=err, ring_excess=worst,
                          ring_fault_step_excess=fault_step, ring_fault_home_excess=fault_home,
                          ulysses_step_ms=ustep_ms, ulysses_bwd_ms=ubwd_ms, ulysses_k3_ms=uk3_ms,
                          ulysses_k3_share=uk3_ms / ubwd_ms, ulysses_plain_bwd_ms=uplain_ms,
                          ulysses_err=uerr, ulysses_excess=uexcess, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        print(f"[{card}] training seq {LC_SEQ} ({n} shards) {LC_HEADS} heads dim {LC_DIM} bf16 "
              f"{label}: ring step ms {step_ms:.3f}, backward ms {bwd_ms:.3f} (K3 {k3_ms:.3f}, "
              f"{k3_ms / bwd_ms:.0%}; device {dev_ms:.3f}), plain backward ms {plain_ms:.1f}; "
              f"err {err:.3g}, excess {worst:.3g} (a step left out {fault_step:.3g}, dK/dV not "
              f"home {fault_home:.3g}); Ulysses step ms {ustep_ms:.3f}, backward ms {ubwd_ms:.3f} "
              f"(K3 {uk3_ms:.3f}), plain backward ms {uplain_ms:.1f}, err {uerr:.3g}, excess "
              f"{uexcess:.3g}; SDPA backward (whole sequence) ms {lib_ms:.3f}; bound ms "
              f"{bound_ms:.3f} ({bound_by})")
        torch.cuda.empty_cache()
    rexcess, rerr, _ = _ulysses_checks(flash, ulysses, mesh, rq, rk, rv, rdo, uly_grads["ragged"],
                                       True, scale, "ragged")
    print(f"[{card}] Ulysses ragged {n} x {ULY_RAGGED} causal: every head group within K3's "
          f"contract (excess {rexcess:.3g}, err {rerr:.3g}), gradients == K3's")

    # ProcessGroupShards on NCCL, a world of one, against LocalShards at one shard
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    check(multihost.maybe_initialize(f"localhost:{port}", 0, 1, local_device_ids=[0]),
          "maybe_initialize did not start a group")
    try:
        check(dist.get_backend() == "nccl", "NCCL world of one")
        mesh1 = ici.make_mesh_1d(1, axis="sp", devices=[dev])
        part = [x[:LC_SEQ // n] for x in (q, k, v, do)]
        for fn in (ring, uly):
            got = _train_step(fn, mesh1, *part, True, comm=comm.ProcessGroupShards(mesh1))
            want = _train_step(fn, mesh1, *part, True)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"{fn.__name__}: ProcessGroupShards (NCCL, world 1) gradients differ")
    finally:
        dist.destroy_process_group()
    print(f"[{card}] ProcessGroupShards (NCCL, world 1) == LocalShards at one shard: ring and "
          f"Ulysses gradients")
    phase_s = time.perf_counter() - t_phase
    print(f"[{card}] phase 9 long-context training s {phase_s:.1f}")
    c = res["causal"]

    def entry(name, replaces, launches, prefix):
        return {
            "name": name,
            "route": "torch",
            "source": f"distributed_tpu_torch/ops/{prefix}.py",
            "kernel": "flash_bwd (K3)",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r[f"{prefix.split('_')[0]}_err"] for r in res.values()),
            "ms": c[f"{prefix.split('_')[0]}_bwd_ms"],
            "plain_ms": c[f"{prefix.split('_')[0]}_plain_bwd_ms"],
            "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "case": f"backward, seq {LC_SEQ}, {n} shards, {LC_HEADS} heads, dim {LC_DIM}, bf16, "
                    f"causal",
            "cases": res,
            "phase_s": phase_s,
        }

    return [entry("ring_attention_bwd", "distributed_tpu/ops/ring_attention.py:65", ring_k3,
                  "ring_attention"),
            entry("ulysses_bwd", "distributed_tpu/ops/ulysses.py:51", uly_k3, "ulysses")], \
        ring_k2 + uly_k2, ring_k3 + uly_k3


# ------------------------------------------------------------ phase 10


R1_SEQ_TASKS = 2_048         # decide_workers(sequential=True)'s ready tasks
R1_PAR_TASKS = 32_768        # decide_workers(sequential=False)'s ready tasks
R1_SHARD_TASKS = 8_192       # K15's ready tasks
R1_LAYOUTS = ("2x1", "4x2", "8x1")
R1_RESTRICTED = 0.10         # share of rows with worker restrictions
R1_BANDWIDTH = 100e6


def r1_problem(B, W, seed):
    """Host arrays of a batch of ``B`` ready tasks onto ``W`` workers of
    ``THREADS`` threads (workers 0-7 stopped, occupancy uniform in [0, 5)
    s): ~2 dependencies a task (Poisson) from a table of B / 2 keys, each
    key held by 1-3 workers, ~10 % of rows restricted to a quarter of the
    workers."""
    rng = np.random.default_rng(seed)
    D = B // 2
    deg = rng.poisson(2.0, B)
    edge_task = np.repeat(np.arange(B, dtype=np.int32), deg)
    edge_dep = rng.integers(0, D, len(edge_task)).astype(np.int32)
    holders = rng.integers(1, 4, D)
    has = np.zeros((D, W), bool)
    has[np.repeat(np.arange(D), holders), rng.integers(0, W, holders.sum())] = True
    restrict = np.ones((B, W), bool)
    rows = np.flatnonzero(rng.random(B) < R1_RESTRICTED)
    restrict[rows] = rng.random((len(rows), W)) < 0.25
    running = np.ones(W, bool)
    running[:8] = False
    workers = (np.full(W, THREADS, np.int32), rng.uniform(0, 5, W).astype(np.float32),
               rng.uniform(0, 1e9, W).astype(np.float32), running)
    batch = (rng.uniform(0.001, 1.0, B).astype(np.float32), (edge_task, edge_dep),
             rng.uniform(1e3, 1e8, D).astype(np.float32), has, restrict)
    return workers, batch


def _decide_bound_ms(B, W, E, D):
    """Inputs read once (fleet, batch rows, edges, dep sizes, the [D, W]
    replica and [B, W] restriction masks), outputs written once; an add a
    real edge and worker for the missing bytes, ~10 f32 operations a
    (task, worker) for the cost and the three argmin passes."""
    return _bound(13 * W + 5 * B + 8 * E + 4 * D + D * W + B * W + 4 * B + 4 * W,
                     E * W + 10 * B * W)


def _wavefront_bound_ms(T, E, W, waves):
    """The graph's arrays read once (21 B a task, 8 an edge), the fleet,
    assignment / start / wave written once; ~50 f32 operations a task and
    a W log W worker sort a wave."""
    return _bound(21 * T + 8 * E + 13 * W + 12 * T + 4 * W,
                     50 * T + waves * W * max(W.bit_length() - 1, 1))


def _host_ms(fn):
    """Wall milliseconds of one call on the host CPU, and its result."""
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def wave_lockstep(wavefront, graph, fleet, bandwidth=100e6):
    """The wavefront on the card against its CPU run one wave at a time,
    both from the CPU run's carry before the wave (as ``_lockstep`` holds
    K1): (least agreement of a wave's placements, largest load error
    relative to the largest load on the workers no disagreeing task
    touched, tasks that disagreed, waves).  From one state the card differs
    only where ``index_add_``'s atomics reorder a wave's f32 load sums and
    a near-tie flips; run end to end, such a flip reorders the load sort of
    every later wave."""
    dev = graph.duration.device
    gcpu = wavefront.GraphArrays(*(x.cpu() for x in graph))
    nth, occ, run = (torch.as_tensor(x) for x in fleet)
    fl_cpu = (nth.to(torch.int32), occ.to(torch.float32), run.to(torch.bool))
    fl_dev = tuple(x.to(dev) for x in fl_cpu)
    T = gcpu.n
    carry = wavefront._Carry(torch.full((T,), -1, dtype=torch.int32), torch.zeros(T),
                             torch.full((T,), -1, dtype=torch.int32), gcpu.indegree, fl_cpu[1],
                             torch.zeros(()), torch.zeros((), dtype=torch.int32))
    least, worst, flips, waves = 1.0, 0.0, 0, 0
    while True:
        nxt = wavefront._place_chunk(gcpu, *fl_cpu, carry, bandwidth, 1)
        newly = (nxt.assign >= 0) & (carry.assign < 0)
        if not bool(newly.any()):
            return least, worst, flips, waves
        card = wavefront._place_chunk(graph, *fl_dev, wavefront._Carry(*(x.to(dev) for x in carry)),
                                      bandwidth, 1)
        a_k, a_p = card.assign.cpu()[newly], nxt.assign[newly]
        differ = a_k != a_p
        touched = torch.zeros(len(run), dtype=torch.bool)
        touched[a_k[differ].long()] = True
        touched[a_p[differ].long()] = True
        err = (card.load.cpu() - nxt.load)[~touched].abs().max().item() if bool((~touched).any()) \
            else 0.0
        least = min(least, 1.0 - int(differ.sum()) / int(newly.sum()))
        worst = max(worst, err / max(nxt.load.abs().max().item(), 1e-30))
        flips, waves, carry = flips + int(differ.sum()), waves + 1, nxt


def phase_round1():
    """Phase 10, the round-1 batched placers as torch ops on the card, each
    against the same call on the CPU."""
    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.ops import placement, wavefront
    from distributed_tpu_torch.parallel import mesh as pmesh

    dev = torch.device("cuda", 0)
    card = smi_line()
    t_phase = time.perf_counter()
    W = N_WORKERS
    seq_w, seq_b = r1_problem(R1_SEQ_TASKS, W, seed=30)
    par_w, par_b = r1_problem(R1_PAR_TASKS, W, seed=31)
    sh_w, sh_b = r1_problem(R1_SHARD_TASKS, W, seed=32)
    durations, out_bytes, src, dst = graphs.random_dag(N_TASKS, seed=0)
    fleets = _fleets()
    layouts = {lay: pmesh.make_mesh(devices=[dev] * 8, layout=lay) for lay in R1_LAYOUTS}

    def on(w, b, device):
        return (placement.WorkerArrays(*w).to(device),
                placement.build_batch_arrays(*b[:4], restrict=b[4], device=device))

    cards = {"seq": on(seq_w, seq_b, dev), "par": on(par_w, par_b, dev), "shard": on(sh_w, sh_b, dev)}
    graph = wavefront.GraphArrays.from_arrays(durations, out_bytes, src.astype(np.int64),
                                              dst.astype(np.int64), device=dev)

    # the main path: each placer as a user calls it, on the card
    placement.decide_workers.launches = wavefront.place_graph.launches = 0
    pmesh.sharded_decide_workers.launches = 0
    got = {"seq": placement.decide_workers(*cards["seq"], R1_BANDWIDTH, sequential=True),
           "par": placement.decide_workers(*cards["par"], R1_BANDWIDTH, sequential=False)}
    placement.place_rootish.launches = placement.occupancy_after_finish.launches = 0
    got_root = placement.place_rootish(R1_PAR_TASKS, cards["par"][0], max_tasks=R1_PAR_TASKS)
    fin = (par_w[1], par_w[0], got["par"][0], cards["par"][1].duration)
    got_fin = placement.occupancy_after_finish(*fin)
    got_graph = {name: wavefront.place_graph(graph, *fleet) for name, fleet in fleets.items()}
    got_shard = {lay: pmesh.sharded_decide_workers(m, *cards["shard"], R1_BANDWIDTH)
                 for lay, m in layouts.items()}
    torch.cuda.synchronize()
    launches = {"decide_workers": placement.decide_workers.launches,
                "place_rootish": placement.place_rootish.launches,
                "occupancy_after_finish": placement.occupancy_after_finish.launches,
                "wavefront": wavefront.place_graph.launches,
                "sharded_decide_workers": pmesh.sharded_decide_workers.launches}
    check(launches == {"decide_workers": 2, "place_rootish": 1, "occupancy_after_finish": 1,
                       "wavefront": len(fleets), "sharded_decide_workers": len(R1_LAYOUTS)},
          f"round-1 launches {launches}")

    # against the CPU run of the same calls
    cpu = {"seq": on(seq_w, seq_b, "cpu"), "par": on(par_w, par_b, "cpu"), "shard": on(sh_w, sh_b, "cpu")}
    seq_cpu_ms, want_seq = _host_ms(lambda: placement.decide_workers(
        *cpu["seq"], R1_BANDWIDTH, sequential=True, device="cpu"))
    par_cpu_ms, want_par = _host_ms(lambda: placement.decide_workers(
        *cpu["par"], R1_BANDWIDTH, sequential=False, device="cpu"))
    for a, b, what in ((got["seq"][0], want_seq[0], "sequential assignment"),
                       (got["seq"][1], want_seq[1], "sequential occupancy"),
                       (got["par"][0], want_par[0], "parallel assignment")):
        check(torch.equal(a.cpu(), b), f"decide_workers {what} differs from the CPU run")
    occ_err = ((got["par"][1].cpu() - want_par[1]).abs().max()
               / want_par[1].abs().max()).item()
    check(occ_err <= K1_LOAD_RTOL, f"decide_workers parallel occupancy off the CPU run by "
          f"{occ_err} of its largest (index_add_'s atomics reorder its f32 sums)")
    placed = {k: int((v[0] >= 0).sum()) for k, v in got.items()}
    print(f"[{card}] decide_workers on {W} workers x {THREADS}: sequential {R1_SEQ_TASKS} tasks "
          f"({placed['seq']} placed) == CPU run bit for bit (assignment, occupancy); parallel "
          f"{R1_PAR_TASKS} tasks ({placed['par']} placed): assignment == CPU run, occupancy "
          f"within {occ_err:.3g} of its largest")

    # place_rootish (integer ops: exact) and the release of the parallel batch's
    # bookings (an index_add_ of f32: within K1_LOAD_RTOL of the CPU run)
    root_cpu_ms, want_root = _host_ms(lambda: placement.place_rootish(
        R1_PAR_TASKS, cpu["par"][0], max_tasks=R1_PAR_TASKS, device="cpu"))
    check(torch.equal(got_root.cpu(), want_root), "place_rootish differs from the CPU run")
    fin_cpu = (par_w[1], par_w[0], want_par[0], cpu["par"][1].duration)
    fin_cpu_ms, want_fin = _host_ms(lambda: placement.occupancy_after_finish(*fin_cpu,
                                                                              device="cpu"))
    fin_err = ((got_fin.cpu() - want_fin).abs().max() / want_fin.abs().max().clamp(min=1e-30)).item()
    check(fin_err <= K1_LOAD_RTOL, f"occupancy_after_finish off the CPU run by {fin_err}")
    root_ms = cuda_ms(lambda: placement.place_rootish(R1_PAR_TASKS, cards["par"][0],
                                                      max_tasks=R1_PAR_TASKS), reps=LT_REPS)
    fin_ms = cuda_ms(lambda: placement.occupancy_after_finish(*fin), reps=LT_REPS)
    root_bound = _bound(13 * W + 4 * R1_PAR_TASKS, 3 * W + 6 * R1_PAR_TASKS)
    fin_bound = _bound(8 * W + 8 * R1_PAR_TASKS, 3 * R1_PAR_TASKS + 2 * W)
    print(f"[{card}] place_rootish {R1_PAR_TASKS} tasks on {W} workers == CPU run: ms "
          f"{root_ms:.4f} (CPU run {root_cpu_ms:.2f}, bound {root_bound[0]:.6f}); "
          f"occupancy_after_finish of those {R1_PAR_TASKS} bookings within {fin_err:.3g} of the "
          f"CPU run: ms {fin_ms:.4f} (CPU run {fin_cpu_ms:.2f}, bound {fin_bound[0]:.6f})")

    graph_cpu = wavefront.GraphArrays(*(x.cpu() for x in graph))
    wf = {}
    for name, fleet in fleets.items():
        g = got_graph[name]
        wavefront.validate_placement(graph, g, fleet[2])
        cpu_ms, want = _host_ms(lambda: wavefront.place_graph(graph_cpu, *fleet))
        a, b = g.assignment.cpu(), want.assignment
        agree = (a == b).float().mean().item()
        run = fleet[2]
        occ_k, occ_p = g.occupancy.cpu().numpy()[run], want.occupancy.numpy()[run]
        imb_k, imb_p = occ_k.max() / occ_k.mean(), occ_p.max() / occ_p.mean()
        span_k, span_p = g.start_time.max().item(), want.start_time.max().item()
        check(int(g.n_waves) == int(want.n_waves), f"wavefront {name}: waves {int(g.n_waves)} "
              f"!= CPU run's {int(want.n_waves)}")
        least, load_err, flips, waves = wave_lockstep(wavefront, graph, fleet)
        check(waves == int(want.n_waves), f"wavefront {name}: lockstep waves {waves}")
        check(least >= K1_MIN_AGREEMENT, f"wavefront {name}: a wave agrees {least} with the CPU "
              f"run from the same state")
        check(load_err <= K1_LOAD_RTOL, f"wavefront {name}: load error {load_err} on untouched "
              f"workers")
        check(abs(imb_k - imb_p) <= QUALITY_RTOL * imb_p, f"wavefront {name}: imbalance "
              f"{imb_k} against the CPU run's {imb_p}")
        check(abs(span_k - span_p) <= QUALITY_RTOL * span_p, f"wavefront {name}: makespan "
              f"{span_k} against the CPU run's {span_p}")
        check(all(torch.equal(x.cpu(), y) for x, y in zip(g, want)),
              f"wavefront {name}: not the CPU run bit for bit")
        ms = cuda_ms(lambda: wavefront.place_graph(graph, *fleet), reps=LT_REPS, warmup=1)
        bound_ms, bound_by = _wavefront_bound_ms(N_TASKS, len(src), W, int(g.n_waves))
        wf[name] = dict(ms=ms, plain_ms=cpu_ms, agreement=agree, wave_agreement=least,
                        wave_flips=flips, wave_load_err=load_err, imbalance=float(imb_k),
                        occupancy_abs_err=(g.occupancy.cpu() - want.occupancy).abs().max().item(),
                        imbalance_cpu=float(imb_p), makespan=span_k, makespan_cpu=span_p,
                        waves=int(g.n_waves), exact=bool(torch.equal(a, b)), bound_ms=bound_ms,
                        bound_by=bound_by)
        print(f"[{card}] wavefront place_graph {N_TASKS} tasks {name}: validated, {int(g.n_waves)} waves, "
              f"from the CPU run's state each wave agrees >= {least:.6f} ({flips} tasks flipped, "
              f"load error {load_err:.3g}); end to end agreement {agree:.6f} (bit for bit: "
              f"{wf[name]['exact']}), "
              f"imbalance {imb_k:.6g} / CPU {imb_p:.6g}, makespan {span_k:.6g} / CPU "
              f"{span_p:.6g}; ms {ms:.3f} (CPU run {cpu_ms:.1f}) bound_ms {bound_ms:.5f} "
              f"({bound_by})")

    single = placement.decide_workers(*cards["shard"], R1_BANDWIDTH, sequential=False)[0]
    shard_cpu_ms, want_shard = _host_ms(lambda: placement.decide_workers(
        *cpu["shard"], R1_BANDWIDTH, sequential=False, device="cpu"))
    check(torch.equal(single.cpu(), want_shard[0]), "decide_workers (K15's batch) != CPU run")
    sh_ms = {}
    for lay, m in layouts.items():
        check(torch.equal(got_shard[lay], single), f"sharded_decide_workers {lay} != the "
              f"single-device parallel assignment")
        sh_ms[lay] = cuda_ms(lambda: pmesh.sharded_decide_workers(m, *cards["shard"], R1_BANDWIDTH),
                             reps=LT_REPS, warmup=1)
    print(f"[{card}] sharded_decide_workers {R1_SHARD_TASKS} tasks x {W} workers at "
          f"{', '.join(R1_LAYOUTS)} (8 virtual shards) == single-device decide_workers(parallel) "
          f"== CPU run; ms {', '.join(f'{k} {v:.3f}' for k, v in sh_ms.items())}")

    seq_ms = cuda_ms(lambda: placement.decide_workers(*cards["seq"], R1_BANDWIDTH, sequential=True),
                     reps=LT_REPS, warmup=1)
    par_ms = cuda_ms(lambda: placement.decide_workers(*cards["par"], R1_BANDWIDTH,
                                                      sequential=False), reps=LT_REPS, warmup=1)
    E = {k: int(len(b[1][0])) for k, b in (("seq", seq_b), ("par", par_b), ("shard", sh_b))}
    seq_bound = _decide_bound_ms(R1_SEQ_TASKS, W, E["seq"], R1_SEQ_TASKS // 2)
    par_bound = _decide_bound_ms(R1_PAR_TASKS, W, E["par"], R1_PAR_TASKS // 2)
    sh_bound = _decide_bound_ms(R1_SHARD_TASKS, W, E["shard"], R1_SHARD_TASKS // 2)
    print(f"[{card}] decide_workers ms: sequential {seq_ms:.3f} (CPU run {seq_cpu_ms:.1f}, bound "
          f"{seq_bound[0]:.5f} {seq_bound[1]}), parallel {par_ms:.3f} (CPU run {par_cpu_ms:.1f}, "
          f"bound {par_bound[0]:.5f} {par_bound[1]})")
    phase_s = time.perf_counter() - t_phase
    print(f"[{card}] phase 10 round-1 placers s {phase_s:.1f}")

    def entry(name, source, replaces, ms, plain_ms, bound, case, err=0.0, **extra):
        return dict(name=name, route="torch", source=source, replaces=replaces,
                    launches=launches[name], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    plain_device="cpu", bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                    case=case, phase_s=phase_s, **extra)

    head = SHARD_HEADLINE[0]
    return [
        entry("decide_workers", "distributed_tpu_torch/ops/placement.py",
              "distributed_tpu/ops/placement.py:157", seq_ms, seq_cpu_ms, seq_bound,
              f"sequential, {R1_SEQ_TASKS} tasks x {W} workers",
              err=(got["par"][1].cpu() - want_par[1]).abs().max().item(),
              parallel=dict(ms=par_ms, plain_ms=par_cpu_ms, bound_ms=par_bound[0],
                            bound_by=par_bound[1], tasks=R1_PAR_TASKS, occupancy_rel_err=occ_err)),
        entry("place_rootish", "distributed_tpu_torch/ops/placement.py",
              "distributed_tpu/ops/placement.py:213", root_ms, root_cpu_ms, root_bound,
              f"{R1_PAR_TASKS} tasks on {W} workers"),
        entry("occupancy_after_finish", "distributed_tpu_torch/ops/placement.py",
              "distributed_tpu/ops/placement.py:243", fin_ms, fin_cpu_ms, fin_bound,
              f"{R1_PAR_TASKS} finished tasks on {W} workers",
              err=(got_fin.cpu() - want_fin).abs().max().item(), rel_err=fin_err),
        entry("wavefront", "distributed_tpu_torch/ops/wavefront.py",
              "distributed_tpu/ops/wavefront.py:140", wf["nonuniform"]["ms"],
              wf["nonuniform"]["plain_ms"], (wf["nonuniform"]["bound_ms"],
                                             wf["nonuniform"]["bound_by"]),
              f"{N_TASKS} tasks, {W} workers, non-uniform",
              err=max(r["occupancy_abs_err"] for r in wf.values()), cases=wf),
        entry("sharded_decide_workers", "distributed_tpu_torch/parallel/mesh.py",
              "distributed_tpu/parallel/mesh.py:73", sh_ms[head], shard_cpu_ms, sh_bound,
              f"{R1_SHARD_TASKS} tasks x {W} workers, {head}", layouts_ms=sh_ms),
    ]


# ------------------------------------------------------------ phase 11


PERI_SHARDS = 8
PERI_ROWS = 1 << 20             # the device-shuffle output ROADMAP queue 3 sizes: 2^20 rows
PERI_SHARD_ROWS = PERI_ROWS + (1 << 16)  # rows a shard sends: each receives ~2^20 + 2^16
PERI_REPS = 5                   # CUDA-event repetitions of the wire and K2 times
TRACE_ROUNDS = 30               # timing traces in a row, each of which must keep every kernel
TRACE_KEY = "task-k2"
K2_SYMBOL = "flash_fwd_tc_kernel"  # K2's tensor-core body, the bf16 case's kernel


LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")
NS = 1e-3  # a trace's times are microseconds written to the nanosecond


def task_spans(trace: dict, key) -> list[dict]:
    """The spans ``annotate(key)`` left in a ``trace.json`` (loaded), each
    with its thread's ``tid``."""
    name = str(key)
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") == name]


def task_kernels(trace: dict, key) -> list[tuple[dict, dict, dict]]:
    """``(span, launch, kernel)`` for every kernel a task launched.

    The profiler itself ties a kernel to the span open on the thread that
    launched it (CUPTI's external correlation): it writes a
    ``gpu_user_annotation`` with the span's ``External id`` over that
    span's kernels on each stream.  A kernel is the task's when it lies in
    such an interval on its stream and its launch call, found by
    correlation id, was made while the span was open.  The launch's own
    ``tid`` is not read: the profiler maps the runtime's thread handles to
    ids once, and a new thread that gets a finished thread's handle
    inherits its id (torch 2.11 on the card: a second pool thread's launches
    carried the first one's id).  Times are compared within a clock, host
    with host and device with device."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("name", "").startswith(LAUNCH_PREFIXES)}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    out = []
    for span in task_spans(trace, key):
        ext = span["args"]["External id"]
        t0, t1 = span["ts"], span["ts"] + span["dur"]
        on_device = [a for a in events if a.get("cat") == "gpu_user_annotation"
                     and a.get("args", {}).get("External id") == ext]
        for kernel in kernels:
            launch = launches.get(kernel["args"]["correlation"])
            if launch is None or not t0 <= launch["ts"] <= t1:
                continue
            if any((a["pid"], a["tid"]) == (kernel["pid"], kernel["tid"])
                   and a["ts"] - NS <= kernel["ts"]
                   and kernel["ts"] + kernel["dur"] <= a["ts"] + a["dur"] + NS
                   for a in on_device):
                out.append((span, launch, kernel))
    return out


def _k2_launches(trace):
    """K2's launches in the trace, in time order: (launch, kernel) joined by
    correlation id."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    kernels = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "kernel" and K2_SYMBOL in e.get("name", "")}
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and e["args"].get("correlation") in kernels), key=lambda e: e["ts"])
    return [(e, kernels[e["args"]["correlation"]]) for e in launches]


def _attributed_by_time(trace, key):
    """A wrong reader, the planted fault: every K2 kernel that started
    after the task's span opened belongs to the task."""
    (span,) = task_spans(trace, key)
    return [e for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "kernel"
            and K2_SYMBOL in e.get("name", "") and e["ts"] >= span["ts"]]


def _only_the_task_launch(kernels, inside, outside):
    """True when ``kernels`` is K2's kernel of the launch inside the span,
    and not that of the launch after it."""
    corr = sorted(k["args"]["correlation"] for k in kernels)
    return corr == [inside["args"]["correlation"]] and outside["args"]["correlation"] not in corr


def _trace_task(device_profile, flash, q, k, v, scale):
    """Trace one task on a pool thread made before the trace: K2 under its
    span, then a second K2 launch after the span, outside any annotation.
    Returns (the pool thread's id, the trace's path, both outputs).  The
    pool thread's current card is read before and after its launches: a
    wrapper puts back the thread's own."""
    import threading

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        tid = pool.submit(threading.get_native_id).result()
        rep = device_profile.start()
        check(rep["status"] == "OK", f"device_profile.start: {rep}")

        def task():
            before = torch.cuda.current_device()
            with device_profile.annotate(TRACE_KEY):
                o, _ = flash.flash_forward_cuda(q, k, v, True, scale)
            o_after, _ = flash.flash_forward_cuda(q, k, v, True, scale)
            torch.cuda.synchronize()
            check(torch.cuda.current_device() == before,
                  f"a launch moved the pool thread's card from {before} to {torch.cuda.current_device()}")
            return o, o_after

        try:
            outs = pool.submit(task).result()
        finally:
            rep = device_profile.stop()
    check(rep["status"] == "OK" and rep["files"] == [device_profile.TRACE_FILE],
          f"device_profile.stop: {rep}")
    return tid, Path(rep["logdir"]) / device_profile.TRACE_FILE, outs


def _join_world_of_one(join):
    """join_process_group on stand-in workers, NCCL at a world of one:
    (its indices, a second join's, the mismatch's error)."""
    import asyncio
    import os
    import socket
    import types

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_RANK": "0"}
    saved = {name: os.environ.get(name) for name in env}
    os.environ.update(env)

    async def joins():
        loop = asyncio.get_running_loop()
        first = types.SimpleNamespace(loop=loop, jax_device_indices=None)
        second = types.SimpleNamespace(loop=loop, jax_device_indices=None)
        check(await join.join_process_group(first), "the first join created no group")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "NCCL world of one")
        one = torch.ones(1, device="cuda")
        dist.all_reduce(one)
        check(one.item() == 1.0, "all_reduce over the world of one")
        check(not await join.join_process_group(second), "a second join created a group")
        os.environ["WORLD_SIZE"] = "2"
        try:
            await join.join_process_group(types.SimpleNamespace(loop=loop, jax_device_indices=None))
        except RuntimeError as exc:
            refused = str(exc)
        else:
            refused = None
        return first.jax_device_indices, second.jax_device_indices, refused

    try:
        return asyncio.run(joins())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def phase_periphery():
    """Phase 11, the host periphery on the card: sizeof and the wire family
    on a K12 shuffle's output, the device trace of a task on a pool thread
    (K2 under its span; a launch after it not attributed), the NCCL join at
    a world of one, build info, and the entry twin.  Returns the launches of
    K1, K2, K10 and K12 its main path made."""
    import torch.distributed as dist

    from distributed_tpu_torch import entry as twin
    from distributed_tpu_torch.diagnostics import device_profile
    from distributed_tpu_torch.http.build_info import build_info_lines
    from distributed_tpu_torch.ops import flash, ici, leveled, sharded
    from distributed_tpu_torch.protocol.serialize import torch_dumps, torch_loads
    from distributed_tpu_torch.utils.sizeof import tensor_sizeof
    from distributed_tpu_torch.worker import join

    dev = torch.device("cuda", 0)
    card = smi_line()
    t_phase = time.perf_counter()
    check(not dist.is_initialized(), "a process group is up before phase 11")
    counters = {"place_wave": leveled.place_waves_cuda, "flash_fwd": flash.flash_forward_cuda,
                "place_shard": sharded.place_shard_run_cuda, "shuffle_bucket": ici.shuffle_bucket_cuda}
    for fn in counters.values():
        fn.launches = 0
    sharded.place_shard_cuda.launches = 0

    # sizeof and the wire, on a shuffle's output (shard 0's first 2^20 rows)
    g = torch.Generator(device="cuda").manual_seed(11)
    n_in = PERI_SHARDS * PERI_SHARD_ROWS
    keys = torch.randint(0, 1 << 30, (n_in,), generator=g, device=dev, dtype=torch.int32)
    vals = torch.rand((n_in, 4), generator=g, device=dev)
    mesh = ici.make_mesh_1d(PERI_SHARDS, devices=[dev] * PERI_SHARDS)
    ko, vo, counts, _ = ici.shuffle_on_mesh(mesh, keys, vals)
    out_k, out_v = ici.compact_shuffle_output(ko, vo, counts, PERI_SHARDS)[0]
    del keys, vals, ko, vo
    check(out_k.shape[0] >= PERI_ROWS, f"shard 0 received {out_k.shape[0]} rows")
    out_k, out_v = out_k[:PERI_ROWS].contiguous(), out_v[:PERI_ROWS].contiguous()
    sizes = tensor_sizeof(out_k), tensor_sizeof(out_v)
    check(sizes == (4_194_304, 16_777_216), f"tensor_sizeof of the shuffle output: {sizes}")
    wire = {}
    for name, t in (("keys", out_k), ("values", out_v)):
        header, frames = torch_dumps(t)
        host = t.cpu().numpy()
        check(header["device"] == "cuda" and header["dtype"] == host.dtype.str
              and header["shape"] == list(host.shape), f"wire header of the {name}: {header}")
        check(bytes(frames[0]) == host.tobytes(), f"wire frames of the {name} differ from the card's")
        back = torch_loads(header, frames)
        check(back.device == torch.device("cuda", torch.cuda.current_device())
              and back.dtype == t.dtype and torch.equal(back.view(torch.int32), t.view(torch.int32)),
              f"the {name} did not come back on the card bit for bit")
        wire[name] = (header, frames)
    try:
        torch_dumps(out_v.to(torch.bfloat16))
    except TypeError:
        pass
    else:
        raise RuntimeError("torch_dumps took a bfloat16 tensor: numpy cannot hold it")
    dumps_ms = cuda_ms(lambda: torch_dumps(out_v), reps=PERI_REPS)
    loads_ms = cuda_ms(lambda: torch_loads(*wire["values"]), reps=PERI_REPS)
    print(f"[{card}] tensor_sizeof {sizes[0]} / {sizes[1]} B; the wire round trip on the card bit "
          f"for bit; 16 MB values: torch_dumps ms {dumps_ms:.3f}, torch_loads ms {loads_ms:.3f} "
          f"(events, median of {PERI_REPS}); bfloat16 raises in torch_dumps")
    del wire

    # the device trace, in this process after phases 1-10 (a long-lived
    # worker's case): a task on a pool thread made before the trace
    q, k, v = (x.transpose(0, 1).contiguous() for x in _flash_inputs(8192, 16, 128, torch.bfloat16, 5))
    scale = 1.0 / 128 ** 0.5
    k2_before = flash.flash_forward_cuda.launches
    tid, path, (o_task, o_after) = _trace_task(device_profile, flash, q, k, v, scale)
    check(flash.flash_forward_cuda.launches == k2_before + 2, "the traced task made not two K2 launches")
    with open(path) as f:
        trace = json.load(f)
    shutil.rmtree(path.parent)
    # from here on the launches compare and time; they are not counted
    untraced, _ = flash.flash_forward_cuda(q, k, v, True, scale)
    check(torch.equal(o_task, untraced) and torch.equal(o_after, untraced),
          "K2 traced differs from K2 untraced")
    k2_ms = cuda_ms(lambda: flash.flash_forward_cuda(q, k, v, True, scale), reps=PERI_REPS)
    # the timing trace, TRACE_ROUNDS times in a row: each must hold every
    # kernel its launches made (stop()'s status)
    traced = []
    for i in range(TRACE_ROUNDS):
        with tempfile.TemporaryDirectory() as logdir:
            check(device_profile.start(logdir)["status"] == "OK",
                  f"timing trace {i + 1} did not start")
            try:
                traced.append(cuda_ms(lambda: flash.flash_forward_cuda(q, k, v, True, scale),
                                      reps=PERI_REPS))
            finally:
                rep = device_profile.stop()
            check(rep["status"] == "OK", f"timing trace {i + 1} of {TRACE_ROUNDS}: {rep}")
    k2_traced_ms = statistics.median(traced)
    flash.flash_forward_cuda.launches = k2_before + 2
    spans = task_spans(trace, TRACE_KEY)
    check([s["tid"] for s in spans] == [tid], f"task span on {[s['tid'] for s in spans]}, pool {tid}")
    launched = _k2_launches(trace)
    check(len(launched) == 2, f"the trace holds {len(launched)} K2 launches, not the task's two")
    (inside, _), (outside, _) = launched
    (span,) = spans
    check(span["ts"] <= inside["ts"] <= span["ts"] + span["dur"] < outside["ts"],
          "the task's first K2 launch is not inside its span, or its second not after it")
    found = task_kernels(trace, TRACE_KEY)
    check(len(found) == 1 and found[0][1]["name"].startswith("cudaLaunch")
          and K2_SYMBOL in found[0][2]["name"],
          f"task kernels {[(lc['name'], kk['name']) for _, lc, kk in found]}")
    check(_only_the_task_launch([kk for _, _, kk in found], inside, outside),
          "the reader did not attribute exactly the task's K2 launch")
    check(not _only_the_task_launch(_attributed_by_time(trace, TRACE_KEY), inside, outside),
          "the check passed a reader that attributes the launch after the span")
    print(f"[{card}] trace: span {TRACE_KEY!r} on the pool thread {tid}, its "
          f"launch {found[0][1]['name']} (correlation {inside['args']['correlation']}) -> "
          f"{found[0][2]['name'][:60]}...; the launch after the span (correlation "
          f"{outside['args']['correlation']}) not attributed; a time-based reader rejected; "
          f"{TRACE_ROUNDS} timing traces in a row, each whole; K2 bf16 seq 8192 causal ms "
          f"untraced {k2_ms:.3f}, traced {k2_traced_ms:.3f} (events, median of {PERI_REPS}; "
          f"traced: the median of the traces')")

    # the entry twin: K1 on the tiny graph, then the dry run on 8 virtual shards
    fn, args = twin.entry()
    fn_cpu, args_cpu = twin.entry(device="cpu")
    k1 = leveled.place_waves_cuda.launches
    got = [x.cpu() for x in fn(*args)]
    check(leveled.place_waves_cuda.launches == k1 + 1, "entry(): not one K1 launch")
    want = fn_cpu(*args_cpu)
    check(all(a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))
              for a, b in zip(got, want)), "entry() on the card differs from its CPU run")
    before = {name: c.launches for name, c in counters.items()}
    twin.dryrun_multichip(PERI_SHARDS)
    dry = {name: c.launches - before[name] for name, c in counters.items()}
    check(dry["place_wave"] == 1 and dry["place_shard"] >= 1 and dry["shuffle_bucket"] >= 1
          and dry["flash_fwd"] >= 1 and sharded.place_shard_cuda.launches == 0,
          f"dryrun_multichip's launches {dry}")
    launches = {name: c.launches for name, c in counters.items()}
    torch.cuda.synchronize()
    print(f"[{card}] entry() == entry(device='cpu') bit for bit; dryrun_multichip(8) passed, "
          f"its launches {dry}")

    # the join, NCCL at a world of one
    first, second, refused = _join_world_of_one(join)
    check(first == second == [0], f"join indices {first}, {second}")
    check(refused is not None and "already exists" in refused, f"the mismatched join: {refused}")
    check(not dist.is_initialized(), "phase 11's group was left up")
    print(f"[{card}] join_process_group (NCCL, world 1): jax_device_indices {first}, a second "
          f"join created nothing, WORLD_SIZE=2 against it raised")

    # build info
    (info,) = build_info_lines("worker", mesh="False/auto")
    name = torch.cuda.get_device_name(dev)
    check(f'torch="{torch.__version__}"' in info and f'cuda="{torch.version.cuda}"' in info
          and f'device="{name}"' in info and 'backend="cuda"' in info, f"build info: {info}")
    print(info.splitlines()[-1])
    phase_s = time.perf_counter() - t_phase
    print(f"[{card}] phase 11 periphery s {phase_s:.1f}; launches {launches}")
    return launches, dict(dumps_ms=dumps_ms, loads_ms=loads_ms, k2_ms=k2_ms,
                          k2_traced_ms=k2_traced_ms, timing_traces=TRACE_ROUNDS, phase_s=phase_s)


# ------------------------------------------------------------ phase 12


# 12a: one update_graph_core of the port's 1M-task DAG's first 131,072
# tasks (2.6x BASELINE config 2's ~50k-task graph) onto 512 workers x 2
# threads; _bucket(131,072) x 1,024 lanes > DENSE_LIMIT: the leveled engine
CP_TASKS = 131_072
CP_WORKERS, CP_THREADS = N_WORKERS, THREADS
# 12b: the simulator at BASELINE config 5's fleet width, every device path on
SIM_WORKERS, SIM_THREADS = 512, 2
SIM_LAYERS, SIM_WIDTH, SIM_FANIN, SIM_CHUNK = 20, 1000, 2, 2
# virtual seconds between AMM rounds: the configured 2 s outlasts the run
SIM_AMM_INTERVAL = 0.1
# each CPU twin's torch threads (the card's run keeps the other cores) and
# its time limit
CP_CPU_THREADS = 4
CP_TWIN_TIMEOUT_S = 600


def _cp_task():
    """Phase 12's run spec: the scheduler never runs it."""


def _cp_graph(graphs, TaskSpec):
    """12a's batch: ``graphs.random_dag(CP_TASKS, seed=0)`` as run specs
    and their dependency sets."""
    _, _, src, dst = graphs.random_dag(CP_TASKS, seed=0)
    deps = {f"t-{i}": set() for i in range(CP_TASKS)}
    for a, b in zip(src.tolist(), dst.tolist()):
        deps[f"t-{b}"].add(f"t-{a}")
    return {k: TaskSpec(_cp_task) for k in deps}, deps


class _Timed:
    """A function (or method) bracketed by CUDA events.  Its attributes are
    the wrapped function's, so a wrapper that counts its own launches
    (``fn.launches += 1`` through its module's name) keeps counting them."""

    def __init__(self, fn, pairs):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_pairs", pairs)

    def __call__(self, *args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            return self._fn(*args, **kwargs)
        finally:
            end.record()
            self._pairs.append((start, end))

    def __get__(self, obj, owner=None):
        return self if obj is None else functools.partial(self, obj)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


class _EventTimer:
    """Puts :class:`_Timed` in place of ``module.name`` for the block;
    :meth:`ms` sums the bracketed calls' event times after a synchronize."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.pairs = []

    def __enter__(self):
        setattr(self.module, self.name, _Timed(self.fn, self.pairs))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def ms(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def _cp_update_graph(device, tasks, deps):
    """One ``update_graph_core`` of 12a's batch into a fresh
    ``SchedulerState`` on ``device`` with ``TorchPlacement(sync=True)``, on
    the Python engine.  (With the placement attached every
    ``waiting→processing`` escapes the native engine, which ran 1 of
    174,918 transitions of this call on the card and cost its wall 5 s in
    hooks: PERF.md §6.)  Returns the state, the placement, the batch
    arrays the placement planned on, the wall, and the streamed driver's
    timings and the hints' time."""
    from distributed_tpu_torch import config
    from distributed_tpu_torch.scheduler import plan as planning
    from distributed_tpu_torch.scheduler.state import SchedulerState
    from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement

    placement = TorchPlacement(sync=True, device=device)
    with config.set({"scheduler.native-engine.enabled": False}):
        state = SchedulerState(placement=placement, device=device)
    for i in range(CP_WORKERS):
        state.add_worker_state(f"tcp://10.3.{i // 256}.{i % 256}:8788", nthreads=CP_THREADS,
                               memory_limit=2**34, name=f"w{i}")
    captured, timings, hints_s = [], {}, []
    plan_from_arrays, hints_from_placement = planning.plan_from_arrays, planning.hints_from_placement
    engine = placement._plan_from_arrays

    def spy(*args, **kwargs):
        out = engine(*args, **kwargs)
        captured.append((args, dict(out)))
        return out

    def with_timings(*args, **kwargs):
        return plan_from_arrays(*args, timings=timings, **kwargs)

    def timed_hints(*args):
        t0 = time.perf_counter()
        out = hints_from_placement(*args)
        hints_s.append(time.perf_counter() - t0)
        return out

    placement._plan_from_arrays = spy
    planning.plan_from_arrays, planning.hints_from_placement = with_timings, timed_hints
    try:
        t0 = time.perf_counter()
        state.update_graph_core(dict(tasks), {k: set(v) for k, v in deps.items()}, list(tasks),
                                client="cp", stimulus_id="cp-graph")
        if state.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        planning.plan_from_arrays, planning.hints_from_placement = plan_from_arrays, hints_from_placement
        del placement._plan_from_arrays
    return state, placement, captured, wall, timings, sum(hints_s)


def _task_rows(state):
    return {k: (ts.state, ts.processing_on.address if ts.processing_on else None)
            for k, ts in state.tasks.items()}


def _cp_sim(device, native):
    """12b's simulation on ``device``: ``ClusterSim`` with the mirror and
    the steal and AMM paths on, ``TorchPlacement(sync=True)`` attached
    through ``state.placement``, the native transition engine attached
    (``native=True``, built at first use) or the Python oracle
    (``native=False``), run to its end.  Returns the sim and its report,
    wall and digest (taken before the census check, which releases the
    wanted keys)."""
    from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement
    from distributed_tpu_torch.sim import ClusterSim, SyntheticDag
    from distributed_tpu_torch.sim.validate import check_census_clean, check_no_lost_keys

    sim = ClusterSim(SIM_WORKERS, nthreads=SIM_THREADS, seed=0, use_device_kernels=True,
                     native=native, device=device, amm_interval=SIM_AMM_INTERVAL)
    sim.state.placement = TorchPlacement(sync=True, device=device)
    sim.install_digest()
    SyntheticDag(n_layers=SIM_LAYERS, layer_width=SIM_WIDTH, fanin=SIM_FANIN, seed=0,
                 layers_per_chunk=SIM_CHUNK).start(sim)
    t0 = time.perf_counter()
    rep = sim.run()
    if sim.state.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_no_lost_keys(sim)
    digest = sim.digest()
    census = check_census_clean(sim)
    return sim, rep, wall, digest, census


def _blake(obj) -> str:
    return hashlib.blake2b(repr(obj).encode(), digest_size=16).hexdigest()


def _cp_sim_report(sim, rep, wall, digest):
    """What 12b holds the card's run and the CPU run to, and prints."""
    (policy,) = sim.amm.policies
    return dict(digest=digest, wall_s=wall, steal_launches=sim.stealing.device_path().launches,
                amm_launches=policy.device_path().launches,
                plans=sim.state.placement.plans_computed, plan_hits=sim.state.placement.plan_hits,
                **{k: rep[k] for k in ("virtual_makespan_s", "scheduler_transitions",
                                       "worker_transitions", "keys_done", "keys_wanted", "steals")})


def control_plane_cpu(part):
    """One of phase 12's runs with every path on ``device="cpu"`` (the
    plain versions of the kernels), in a child process phase 12 starts
    beside its card runs: ``"a"``, 12a's plan, the hints it left and every
    task's state and worker as digests; ``"b"``, 12b's report, on the
    Python oracle (the card's run is native)."""
    torch.set_num_threads(CP_CPU_THREADS)
    if part == "b":
        sim, rep, s_wall, digest, census = _cp_sim("cpu", native=False)
        return dict(_cp_sim_report(sim, rep, s_wall, digest), census=census["census_clean"])
    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.graph.spec import TaskSpec

    tasks, deps = _cp_graph(graphs, TaskSpec)
    state, placement, captured, wall, _, _ = _cp_update_graph("cpu", tasks, deps)
    ((_, plan),) = captured
    return dict(wall_s=wall, plan=_blake(sorted(plan.items())), n_plan=len(plan),
                left=_blake(sorted(placement.plan.items())), hits=placement.plan_hits,
                rows=_blake(sorted(_task_rows(state).items())), enabled=placement.enabled)


def _twin_report(twin, label):
    out, err = twin.communicate(timeout=CP_TWIN_TIMEOUT_S)
    check(twin.returncode == 0, f"phase 12's CPU run {label} failed ({twin.returncode}):\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def phase_control_plane(dev=None):
    """Phase 12, the sans-io control plane on the card: (a) one
    ``update_graph_core`` of a 131,072-task DAG into the port's
    ``SchedulerState`` with ``TorchPlacement`` (K1 through the leveled
    engine), its plan equal to a direct ``_plan_from_arrays`` call on the
    same batch and to the CPU run, and every task's state and worker equal
    to the CPU run; (b) the port's ``ClusterSim`` at 512 workers with every
    device path on (K4 a chunk through the placement, K6, K7, K8), no key
    lost, the census clean, no failure, and the digest, makespan and
    transition counts equal to the CPU run.  The CPU runs
    (:func:`control_plane_cpu`) go in two child processes started first,
    beside the card's.  Returns each kernel's launches on the two main
    paths and the phase's numbers."""
    card = smi_line()
    dev = torch.device("cuda", torch.cuda.current_device()) if dev is None else dev
    t_phase = time.perf_counter()
    twins = {part: subprocess.Popen(
        [sys.executable, "-c",
         f"import json, chip_smoke as c; print(json.dumps(c.control_plane_cpu({part!r})))"],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in ("a", "b")}
    try:
        launches, numbers = _control_plane_card(card, dev, twins)
    finally:
        for twin in twins.values():
            if twin.poll() is None:
                twin.kill()
                twin.communicate()
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 12 control plane s {numbers['phase_s']:.1f}")
    return launches, numbers


def _control_plane_card(card, dev, twins):
    """Phase 12's card runs, each held to its CPU twin's report."""
    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.graph.spec import TaskSpec
    from distributed_tpu_torch.ops import amm, leveled, partition, stealing
    from distributed_tpu_torch.ops import fleet as fleet_ops
    from distributed_tpu_torch.scheduler.mirror import TorchMirror

    counters = {"place_wave": leveled.place_waves_cuda, "partition": partition.partition_cuda,
                "steal": stealing.steal_rounds_cuda, "amm_drop": amm.drop_rounds_cuda}

    def zero():
        for fn in counters.values():
            fn.launches = 0
        fleet_ops.scatter_rows_cuda.launches = 0

    def read():
        out = {name: fn.launches for name, fn in counters.items()}
        out["mirror_view"] = fleet_ops.scatter_rows_cuda.launches
        return out

    # 12a: the north-star path through update_graph_core
    tasks, deps = _cp_graph(graphs, TaskSpec)
    zero()
    with _EventTimer(leveled, "place_waves_cuda") as t_k1:
        state, placement, captured, wall, timings, hints_s = _cp_update_graph(dev, tasks, deps)
        launches_a = read()
    k1_ms = t_k1.ms()
    check(placement.enabled and placement.plans_computed == 1 and len(captured) == 1,
          f"12a: the placement planned {placement.plans_computed} times, enabled {placement.enabled}")
    check(launches_a["place_wave"] >= 1 and launches_a["partition"] == 0,
          f"12a: launches {launches_a}: the batch must go through K1, not K4")
    # below the streamed driver's min_stream the one-shot driver: one launch
    want_k1 = 1 if timings.get("fallback") else timings.get("launches")
    check(launches_a["place_wave"] == want_k1,
          f"12a: K1 launches {launches_a['place_wave']}, the driver's {want_k1} ({timings})")
    ((args, plan),) = captured  # the hints as planned (decide_worker consumes them)
    check(len(plan) > CP_TASKS // 2, f"12a: {len(plan)} hints for {CP_TASKS} tasks")
    dispatch_s = state.wall.snapshot().get("kernel.dispatch", 0.0)
    rows = _task_rows(state)
    # from here on the launches compare; they are not counted
    direct = placement._plan_from_arrays(*args)
    check(direct == plan, "12a: the plan differs from a direct _plan_from_arrays on its batch")
    n_proc = sum(s == "processing" for s, _ in rows.values())
    card_a = dict(plan=_blake(sorted(plan.items())), n_plan=len(plan),
                  left=_blake(sorted(placement.plan.items())), hits=placement.plan_hits,
                  rows=_blake(sorted(rows.items())), enabled=True)
    print(f"[{card}] 12a update_graph_core {CP_TASKS} tasks onto {CP_WORKERS} x {CP_THREADS}: wall s "
          f"{wall:.3f}, plan (kernel.dispatch) s {dispatch_s:.3f} ({100 * dispatch_s / wall:.1f} %), "
          f"hints s {hints_s:.3f}, K1 event ms {k1_ms:.3f} in {launches_a['place_wave']} launches "
          f"(pack s {timings['topo_s']:.3f}, fmt {timings['fmt']}); {len(plan)} hints == direct call, "
          f"{placement.plan_hits} hit, {n_proc} processing; launches {launches_a}; engine: "
          + (_native_line(state.native.counters()) if state.native is not None else "the Python oracle"))
    del state, placement, tasks, deps, captured, args, direct, rows

    # 12b: the simulator with every device path on
    zero()
    with _EventTimer(partition, "partition_cuda") as t_k4, \
            _EventTimer(stealing, "steal_rounds_cuda") as t_k7, \
            _EventTimer(amm, "drop_rounds_cuda") as t_k8, \
            _EventTimer(TorchMirror, "device_view") as t_k6:
        sim, rep, s_wall, digest, census = _cp_sim(dev, native=True)
        launches_b = read()
    ms_b = {"partition": t_k4.ms(), "steal": t_k7.ms(), "amm_drop": t_k8.ms(), "mirror_view": t_k6.ms()}
    steal_path = sim.stealing.device_path()
    (policy,) = sim.amm.policies
    amm_path = policy.device_path()
    sp = sim.state.placement
    n_chunks = -(-SIM_LAYERS // SIM_CHUNK)
    check(rep["keys_done"] >= rep["keys_wanted"] > 0, f"12b: {rep['keys_done']} of {rep['keys_wanted']}")
    check(census["census_clean"], f"12b: census {census}")
    check(sp.enabled and sp.plans_computed >= n_chunks,
          f"12b: {sp.plans_computed} plans for {n_chunks} chunks, enabled {sp.enabled}")
    check(launches_b["partition"] == sp.plans_computed * K4_LAUNCHES_PER_PLAN,
          f"12b: K4 launches {launches_b['partition']} for {sp.plans_computed} plans")
    check(launches_b["steal"] >= 1 and launches_b["amm_drop"] >= 1 and launches_b["mirror_view"] >= 1,
          f"12b: launches {launches_b}: K6, K7 and K8 must each launch")
    check(launches_b["steal"] == steal_path.launches and launches_b["amm_drop"] == amm_path.launches,
          f"12b: paths {steal_path.counters()} {amm_path.counters()} against launches {launches_b}")
    for label, p in (("stealing", steal_path), ("amm", amm_path)):
        check(p.failures == 0, f"12b: {label} path failures {p.failures}: {p.errors}")
    # a Python oracle in the native engine's place gives the same digest,
    # so the engine must be attached, active and have run transitions
    engine = native_counters(sim.state, "12b")
    card_b = _cp_sim_report(sim, rep, s_wall, digest)
    n_tr = rep["scheduler_transitions"] + rep["worker_transitions"]
    print(f"[{card}] 12b ClusterSim {SIM_WORKERS} x {SIM_THREADS}, SyntheticDag {SIM_LAYERS} x "
          f"{SIM_WIDTH} (fanin {SIM_FANIN}, {SIM_CHUNK} layers a chunk): wall s {s_wall:.3f}, "
          f"{rep['scheduler_transitions']} scheduler + {rep['worker_transitions']} worker transitions "
          f"({n_tr / s_wall:.0f} / s), virtual makespan s {rep['virtual_makespan_s']}, steals "
          f"{rep['steals']}, {sp.plans_computed} plans ({sp.plan_hits} hits); no key lost, census clean, "
          f"digest {digest}; launches {launches_b}, event ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms_b.items()))
    print(f"[{card}] 12b native engine: {_native_line(engine)}; the Python oracle's wall on this card "
          f"(PERF.md §5): 59.0 s, 19,680 transitions / s")
    del sim

    # the CPU twins: the same two runs with every path on the CPU
    cpu_a, cpu_b = _twin_report(twins["a"], "12a"), _twin_report(twins["b"], "12b")
    check(cpu_a.pop("wall_s") > 0 and cpu_a == card_a,
          f"12a: the card's plan, hints or tasks differ from the CPU run's: {card_a} / {cpu_a}")
    c_wall = cpu_b.pop("wall_s")
    card_b.pop("wall_s")
    check(cpu_b.pop("census") and cpu_b == card_b,
          f"12b: the card's run differs from the CPU run: {card_b} / {cpu_b}")
    print(f"[{card}] 12a plan, hints left and every task's state and worker == CPU run; 12b digest, "
          f"makespan, transitions, steals and device cycles == CPU run (CPU run s {c_wall:.3f}, in child "
          f"processes beside the card's)")
    launches = {k: launches_a[k] + launches_b[k] for k in launches_a}
    numbers = dict(
        update_graph_wall_s=wall, update_graph_dispatch_s=dispatch_s, update_graph_hints_s=hints_s,
        update_graph_hints=len(plan), update_graph_hits=card_a["hits"], update_graph_k1_ms=k1_ms,
        update_graph_pack_s=timings["topo_s"], sim_wall_s=s_wall, sim_cpu_wall_s=c_wall,
        sim_transitions_per_s=n_tr / s_wall, sim_makespan_s=rep["virtual_makespan_s"],
        sim_scheduler_transitions=rep["scheduler_transitions"],
        sim_worker_transitions=rep["worker_transitions"], sim_plans=sp.plans_computed,
        sim_event_ms=ms_b, sim_native=engine)
    return launches, numbers


def native_counters(state, label):
    """The native engine's counters on ``state``, failing unless it is
    attached and active and ran transitions: outputs are bit-identical to
    the Python oracle's by contract, so only the counters show it ran."""
    eng = state.native
    check(eng is not None and eng.active(), f"{label}: the native engine is not attached and active")
    counters = eng.counters()
    check(counters["transitions"] > 0, f"{label}: the native engine ran no transition: {counters}")
    return counters


def _native_line(c):
    escapes = {k[len("escape_"):]: v for k, v in c.items() if k.startswith("escape_")}
    return (f"{c['transitions']} transitions in C++, {c['oracle_transitions']} by the oracle, "
            f"{c['escapes']} escapes {escapes}, {c['floods']} floods")


# ------------------------------------------------------------ phase 13


# recovery at 12b's fleet (BASELINE config 5's 512 workers x 2) with the
# mirror, K7 and K8 on the card and the native engine attached; no
# placement, since the reference attaches none to a restored state
REC_LAYERS, REC_WIDTH, REC_CHUNK = 6, 1000, 2
REC_SNAPSHOT_S = 0.05      # virtual seconds between snapshots (the sim's default)
REC_BOUNCE_AT = 0.12       # virtual seconds: mid-graph (the unbounced run ends at 0.232)


def _rec_sim(device, native, *, workload=True, journal=False):
    """Phase 13's sim: ``scenario_scheduler_bounce``'s shape (the digest and
    the transition recorder installed, ``validate=False``) at 12b's fleet
    on ``device``, the stimulus journal on from before the workload if
    ``journal``, and ``SyntheticDag(REC_LAYERS x REC_WIDTH)`` started
    unless ``workload`` is False (a journal's replay target)."""
    from distributed_tpu_torch.sim import ClusterSim, SyntheticDag
    from distributed_tpu_torch.sim.validate import install_recorder

    sim = ClusterSim(SIM_WORKERS, nthreads=SIM_THREADS, seed=0, validate=False, native=native,
                     use_device_kernels=True, device=device, amm_interval=SIM_AMM_INTERVAL)
    sim.install_digest()
    install_recorder(sim)
    if journal:
        sim.journal_start()
    if workload:
        SyntheticDag(n_layers=REC_LAYERS, layer_width=REC_WIDTH, fanin=SIM_FANIN, seed=0,
                     layers_per_chunk=REC_CHUNK).start(sim)
    return sim


@contextlib.contextmanager
def _host_timer(owner, name):
    """Puts a host-clock timer around ``owner.name`` (a module function, a
    method or a static method) for the block; yields ``{"s", "n"}``."""
    raw = owner.__dict__[name] if isinstance(owner, type) else getattr(owner, name)
    fn = getattr(owner, name)
    acc = {"s": 0.0, "n": 0}

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc["s"] += time.perf_counter() - t0
            acc["n"] += 1

    setattr(owner, name, staticmethod(timed) if isinstance(raw, staticmethod) else timed)
    try:
        yield acc
    finally:
        setattr(owner, name, raw)


def _memory_allocated(device):
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(device)


def _bounce_probe(sim, read_launches, info):
    """Wraps the sim's scheduled bounce: the dead state's engine counters,
    the launches, the device memory and the dead mirror's device bytes
    just before it, weak references to the dead state and its mirror, and
    the new state's mirror.  (The dead state lives on until the sim's
    pending events that hold it have run: the caller reads the weak
    references and the memory at the run's end.)"""
    bounce = sim._do_bounce

    def probe():
        old = sim.state
        info["pre_native"] = old.native.counters() if old.native is not None else None
        info["launches"] = read_launches()
        info["refs"] = (weakref.ref(old), weakref.ref(old.mirror))
        info["mirror_bytes"] = sum(t.numel() * t.element_size() for t in old.mirror._dev.values())
        del old
        gc.collect()
        info["memory_before"] = _memory_allocated(sim.device)
        t0 = time.perf_counter()
        bounce()
        info["bounce_s"] = time.perf_counter() - t0
        info["mirror"] = sim.state.mirror

    sim._do_bounce = probe


def recovery_run(device, native, read_launches=lambda: {}):
    """Phase 13's three runs on ``device``: (a) the bounced run (durability
    every ``REC_SNAPSHOT_S``, the scheduler bounced at ``REC_BOUNCE_AT``),
    (b) its unbounced same-seed twin with the stimulus journal on, and the
    twin's critical path; with ``native`` the journal is also replayed into
    a fresh sim set up as the twin was.  Returns what the card and the CPU
    run are held to (``"same"``), and the rest."""
    from distributed_tpu_torch.diagnostics import critical_path as cpath
    from distributed_tpu_torch.diagnostics import flight_recorder
    from distributed_tpu_torch.scheduler import durability
    from distributed_tpu_torch.sim import JournalTrace
    from distributed_tpu_torch.sim.validate import check_census_clean, check_no_lost_keys

    out, bounce = {}, {}
    # (a) the bounce
    sim = _rec_sim(device, native)
    _bounce_probe(sim, read_launches, bounce)
    sim.enable_durability(snapshot_interval=REC_SNAPSHOT_S)
    sim.bounce_scheduler(at=REC_BOUNCE_AT)
    with _host_timer(durability.DurabilityManager, "snapshot") as t_snap, \
            _host_timer(durability, "snapshot_rows") as t_rows, \
            _host_timer(durability, "state_digest") as t_digest, \
            _host_timer(durability, "encode_snapshot") as t_encode, \
            _host_timer(durability.DurabilityManager, "load") as t_load, \
            _host_timer(durability, "restore_state") as t_restore, \
            _host_timer(flight_recorder, "replay_stimulus_trace") as t_tail:
        t0 = time.perf_counter()
        rep = sim.run()
        out["bounce_wall_s"] = time.perf_counter() - t0
    check(sim.counters["scheduler_bounces"] == 1, f"13a: the bounce fired {sim.counters['scheduler_bounces']} times")
    gc.collect()
    bounce["released"] = all(r() is None for r in bounce.pop("refs"))
    bounce["memory_end"] = _memory_allocated(sim.device)
    check_no_lost_keys(sim)
    digest = sim.digest()
    out["post_native"] = native_counters(sim.state, "13a after the bounce") if native else None
    out["launches_end"] = read_launches()
    census = check_census_clean(sim)
    check(census["census_clean"], f"13a: census {census}")
    out.update(bounce=bounce, snapshot=t_snap, rows=t_rows, digest=t_digest, encode=t_encode,
               load=t_load, restore=t_restore, tail=t_tail)
    same = dict(digest=digest, tail_records=sim.counters["bounce_tail_records"],
                snapshots=sim.counters["durability_snapshots"],
                **{k: rep[k] for k in ("virtual_makespan_s", "scheduler_transitions",
                                       "worker_transitions", "keys_done", "steals")})
    del sim

    # (b) the unbounced twin, journaled, and (c) its critical path
    twin = _rec_sim(device, native, journal=True)
    t0 = time.perf_counter()
    twin_rep = twin.run()
    out["twin_wall_s"] = time.perf_counter() - t0
    check_no_lost_keys(twin)
    twin_digest = twin.digest()
    check(twin_digest == digest, f"13a: the bounced run's digest {digest} != the unbounced twin's {twin_digest}")
    out["twin_native"] = native_counters(twin.state, "13b's twin") if native else None
    cp = twin.critical_path()
    check(cp is not None, "13c: no critical path")
    cpath.check(cp)
    records = twin.journal()
    flight_recorder.verify_journal(records)
    recorded = durability.state_digest(twin.state)
    same.update(twin_digest=twin_digest, twin_makespan=twin_rep["virtual_makespan_s"],
                critical_path=_blake(cp), cp_makespan=cp["makespan"], cp_tasks=cp["n_tasks"],
                journal=_blake(records), journal_records=len(records), state_digest=recorded)
    out["cp"] = cp
    census = check_census_clean(twin)
    check(census["census_clean"], f"13b: census {census}")
    del twin
    if native:
        fresh = _rec_sim(device, native, workload=False)
        t0 = time.perf_counter()
        JournalTrace(records).replay(fresh)
        out["replay_s"] = time.perf_counter() - t0
        replayed = durability.state_digest(fresh.state)
        check(replayed == recorded, f"13b: the replayed state's digest {replayed} != the recording's {recorded}")
        out["replay_native"] = native_counters(fresh.state, "13b's replay")
        del fresh
    out["same"] = same
    return out


def recovery_cpu():
    """Phase 13's runs on the CPU with the Python oracle and the kernels'
    plain versions, in a child process beside the card's."""
    torch.set_num_threads(CP_CPU_THREADS)
    out = recovery_run("cpu", native=False)
    return dict(out["same"], bounce_wall_s=out["bounce_wall_s"], twin_wall_s=out["twin_wall_s"])


def start_recovery_twin():
    """Starts :func:`recovery_cpu` in a child process."""
    return subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke as c; print(json.dumps(c.recovery_cpu()))"],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_recovery(twin, dev=None):
    """Phase 13, recovery on the card: (a) a scheduler bounce mid-graph
    (snapshot, restore, journal-tail replay) with the native engine and
    K6, K7 and K8 live; the bounce's own checks (the restored digest and
    transition counter equal the dead state's), no key lost, the census
    clean, the digest equal to the unbounced twin's and to the CPU run's,
    the dead state's device memory released, a full upload by the new
    state's mirror and K7 and K8 launching after the bounce; (b) the twin's
    journal replayed into a fresh state on the card to the recording
    state's digest; (c) the twin's critical path, checked and equal to the
    CPU run's.  ``twin`` is the child process of :func:`recovery_cpu`.
    Returns each kernel's launches on the phase's main path and its
    numbers."""
    from distributed_tpu_torch.ops import amm, stealing
    from distributed_tpu_torch.ops import fleet as fleet_ops
    from distributed_tpu_torch.scheduler.mirror import TorchMirror

    card = smi_line()
    dev = torch.device("cuda", torch.cuda.current_device()) if dev is None else dev
    t_phase = time.perf_counter()
    counters = {"steal": stealing.steal_rounds_cuda, "amm_drop": amm.drop_rounds_cuda}

    def read():
        out = {name: fn.launches for name, fn in counters.items()}
        out["mirror_view"] = fleet_ops.scatter_rows_cuda.launches
        # views that wrote to the card: a full upload or a launch of K6
        out["mirror_views_written"] = TorchMirror.launches
        return out

    for fn in counters.values():
        fn.launches = 0
    fleet_ops.scatter_rows_cuda.launches = 0
    TorchMirror.launches = 0
    out = recovery_run(dev, native=True, read_launches=read)
    launches = read()
    b = out["bounce"]
    ms = {k: 1e3 * out[k]["s"] for k in ("snapshot", "rows", "digest", "encode", "load", "restore",
                                         "tail")}
    check(b.get("pre_native") and b["pre_native"]["transitions"] > 0,
          f"13a: the native engine ran no transition before the bounce: {b.get('pre_native')}")
    check(b["released"], "13a: the dead state or its mirror is still referenced at the run's end")
    # the new state's mirror holds what the dead one held: more memory at
    # the end than before the bounce means the dead state kept its tensors
    check(b["mirror_bytes"] > 0 and b["memory_end"] <= b["memory_before"],
          f"13a: device memory {b['memory_before']} B before the bounce (the dead mirror's "
          f"{b['mirror_bytes']} B), {b['memory_end']} B at the run's end")
    mirror = b["mirror"]
    after = {k: out["launches_end"][k] - b["launches"][k] for k in b["launches"]}
    check(mirror.full_uploads >= 1 and after["mirror_views_written"] >= 1 and after["steal"] >= 1
          and after["amm_drop"] >= 1,
          f"13a: after the bounce {after} launches, the new mirror's full uploads {mirror.full_uploads}")
    same, cp = out["same"], out["cp"]
    walls = (out["bounce_wall_s"], out["twin_wall_s"], out["replay_s"])
    n_snap = out["snapshot"]["n"]
    print(f"[{card}] 13a bounce at {REC_BOUNCE_AT} virtual s of SyntheticDag {REC_LAYERS} x {REC_WIDTH} on "
          f"{SIM_WORKERS} x {SIM_THREADS}: wall s {walls[0]:.3f}; snapshots "
          f"{n_snap} ({ms['snapshot']:.1f} ms in all: rows {ms['rows']:.1f}, encode "
          f"{ms['encode']:.1f}; state digests {ms['digest']:.1f} ms in {out['digest']['n']} calls), load "
          f"{ms['load']:.1f} ms, restore "
          f"{ms['restore']:.1f} ms, tail replay {ms['tail']:.1f} ms of {same['tail_records']} records, "
          f"the bounce {1e3 * b['bounce_s']:.1f} ms; digest {same['digest']} == the unbounced twin's; "
          f"device memory {b['memory_before']} B before the bounce (the dead mirror's {b['mirror_bytes']} B), "
          f"{b['memory_end']} B at the run's end, the dead state released; "
          f"after the bounce launches {after}, the new mirror's full uploads {mirror.full_uploads}; "
          f"native before: {_native_line(b['pre_native'])}; after: {_native_line(out['post_native'])}")
    print(f"[{card}] 13b journal of the twin: {same['journal_records']} records, replayed in "
          f"{walls[2]:.3f} s into a fresh sim == the recording state's digest "
          f"{same['state_digest'][:16]}; replay native: {_native_line(out['replay_native'])}; twin wall s "
          f"{walls[1]:.3f}")
    print(f"[{card}] 13c critical path: makespan {cp['makespan']}, {cp['n_tasks']} tasks, attribution "
          f"{ {k: round(v, 6) for k, v in cp['attribution'].items()} }")
    del out, mirror
    cpu = _twin_report(twin, "13")
    c_walls = (cpu.pop("bounce_wall_s"), cpu.pop("twin_wall_s"))
    check(cpu == same, f"13: the card's runs differ from the CPU run's: {same} / {cpu}")
    phase_s = time.perf_counter() - t_phase
    print(f"[{card}] 13 bounce, twin, journal and critical path == CPU run (oracle; walls s "
          f"{c_walls[0]:.3f} / {c_walls[1]:.3f}); phase 13 recovery s {phase_s:.1f}; launches {launches}")
    numbers = dict(phase_s=phase_s, bounce_wall_s=walls[0], twin_wall_s=walls[1],
                   replay_s=walls[2], cpu_walls_s=c_walls, bounce_ms=1e3 * b["bounce_s"],
                   snapshots=n_snap, snapshot_ms=ms["snapshot"], snapshot_rows_ms=ms["rows"],
                   snapshot_encode_ms=ms["encode"], state_digest_ms=ms["digest"], load_ms=ms["load"],
                   restore_ms=ms["restore"], tail_replay_ms=ms["tail"],
                   tail_records=same["tail_records"], journal_records=same["journal_records"],
                   memory_before=b["memory_before"], memory_end=b["memory_end"],
                   dead_mirror_bytes=b["mirror_bytes"],
                   launches_after_bounce=after)
    return launches, numbers


# ------------------------------------------------------------ phase 14


# BASELINE config 2 through the port's asyncio servers: rechunk + tensordot
# (bench.py's _tensordot_graph) on 16 one-thread workers, bench.py's
# overrides plus the periodic gate opened at 16 workers so K6, K7 and K8 run;
# no warm-up graph (its plan and its wall were cut when phase 16 came, to keep
# the whole script under 525 s): the timed graph's first plan is the run's
SRV_WORKERS, SRV_G, SRV_BLOCK = 16, 32, 4
SRV_CONFIG = {"scheduler.jax.enabled": True, "scheduler.jax.min-workers": 0,
              "scheduler.jax.min-transfer-ratio": 0, "scheduler.jax.periodic-min-workers": 16}
# 14b: the wire on the card, CUDA tensors between workers over tcp
WIRE_WORKERS, WIRE_G, WIRE_BLOCK = 4, 8, 1024
SRV_TIMEOUT_S = 600


def _result_digest(results) -> str:
    """blake2b of the results' dtypes, shapes and bytes, in order."""
    h = hashlib.blake2b(digest_size=16)
    for r in results:
        t = r.detach().contiguous().cpu()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _placement_stats(p) -> dict:
    return dict(plans=p.plans_computed, hits=p.plan_hits, parks=p.plan_parks,
                misses=p.plan_misses, miss_reasons=dict(p.miss_reasons),
                hint_drops=dict(p.hint_drops), enabled=p.enabled)


async def _servers_graph(device, addr, n_workers, G, n, probe=None):
    """The port's ``Scheduler(device=device)`` on ``addr``, ``n_workers``
    one-thread ``Worker``s joined one after another and a ``Client``,
    under :data:`SRV_CONFIG`: the timed ``tensordot_graph(G)`` of ``n x n`` blocks on
    ``device`` (CUDA for ``None``).  ``probe(scheduler, workers)`` runs
    after the timed graph, before the cluster closes.  Returns the results'
    digest, the wall, the task count and the placement's counters."""
    from distributed_tpu_torch import config, graphs
    from distributed_tpu_torch.client.client import Client
    from distributed_tpu_torch.scheduler.server import Scheduler
    from distributed_tpu_torch.worker.server import Worker

    blocks = "cuda" if device is None else str(device)
    out: dict = {}
    with config.set(SRV_CONFIG):
        async with Scheduler(listen_addr=addr, device=device) as s:
            workers = []
            try:
                for _ in range(n_workers):
                    workers.append(await Worker(s.address, nthreads=1).start())
                async with Client(s.address) as c:
                    p = s.state.placement
                    g, outs = graphs.tensordot_graph(G, n=n, device=blocks)
                    t0 = time.perf_counter()
                    futs = c.compute_graph(g, outs)
                    res = await c.gather([futs[k] for k in outs])
                    if device is None:
                        torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    out = dict(digest=_result_digest(res), wall_s=wall, n_tasks=len(g.tasks),
                               placement=_placement_stats(p) if p is not None else None)
                    del futs, res
                    if probe is not None:
                        out.update(probe(s, workers))
            finally:
                for w in workers:
                    await w.close()
    return out


class _TransferTimes:
    """Times each worker's ``_gather_dep`` (one fetch of a batch of keys
    from one peer, over the comm) and sums the bytes it brought."""

    def __init__(self):
        from distributed_tpu_torch.worker.server import Worker

        self.cls, self.fn = Worker, Worker._gather_dep
        self.seconds: list[float] = []
        self.nbytes = 0

    def __enter__(self):
        fn, times = self.fn, self

        async def timed(worker, *args, **kwargs):
            t0 = time.perf_counter()
            ev = await fn(worker, *args, **kwargs)
            times.seconds.append(time.perf_counter() - t0)
            times.nbytes += getattr(ev, "total_nbytes", 0)
            return ev

        self.cls._gather_dep = timed
        return self

    def __exit__(self, *exc):
        self.cls._gather_dep = self.fn


def _wire_run(device):
    """14b on ``device``: the tensordot graph of ``WIRE_BLOCK``-square
    blocks on ``WIRE_WORKERS`` workers over tcp, with the ``"torch"``
    family's counts and the transfers' times."""
    from distributed_tpu_torch.protocol.buffers import WIRE
    from distributed_tpu_torch.protocol.serialize import family_counts, reset_family_counts

    reset_family_counts()
    sent0, recv0 = WIRE.bytes_sent, WIRE.bytes_recv
    with _TransferTimes() as tt:
        out = asyncio.run(asyncio.wait_for(_servers_graph(
            device, "tcp://127.0.0.1:0", WIRE_WORKERS, WIRE_G, WIRE_BLOCK), SRV_TIMEOUT_S))
    out.update(torch_family=family_counts().get("torch", {}), transfers=len(tt.seconds),
               transfer_bytes=tt.nbytes, wire_bytes_sent=WIRE.bytes_sent - sent0,
               wire_bytes_recv=WIRE.bytes_recv - recv0,
               transfer_median_ms=1e3 * statistics.median(tt.seconds) if tt.seconds else None)
    return out


def servers_cpu():
    """Phase 14's two runs with ``device="cpu"`` (blocks, mirror, placement
    and periodic paths on the CPU), in a child process phase 14 starts
    beside its card runs: 14a's graph and 14b's."""
    torch.set_num_threads(CP_CPU_THREADS)
    a = asyncio.run(asyncio.wait_for(_servers_graph(
        "cpu", "inproc://", SRV_WORKERS, SRV_G, SRV_BLOCK), SRV_TIMEOUT_S))
    b = _wire_run("cpu")
    return {"a": a, "b": b}


def phase_servers(dev=None):
    """Phase 14, the port's asyncio servers and client on the card."""
    card = smi_line()
    t_phase = time.perf_counter()
    twin = subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke as c; print(json.dumps(c.servers_cpu()))"],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        launches, numbers = _servers_card(card, dev, twin)
    finally:
        if twin.poll() is None:
            twin.kill()
            twin.communicate()
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 14 servers s {numbers['phase_s']:.1f}")
    return launches, numbers


def _servers_card(card, dev, twin):
    """Phase 14's card runs, each held to the CPU twin's results."""
    from distributed_tpu_torch.ops import amm, leveled, partition, stealing
    from distributed_tpu_torch.ops import fleet as fleet_ops

    counters = {"place_wave": leveled.place_waves_cuda, "partition": partition.partition_cuda,
                "steal": stealing.steal_rounds_cuda, "amm_drop": amm.drop_rounds_cuda}

    def zero():
        for fn in counters.values():
            fn.launches = 0
        fleet_ops.scatter_rows_cuda.launches = 0

    def read():
        out = {name: fn.launches for name, fn in counters.items()}
        out["mirror_view"] = fleet_ops.scatter_rows_cuda.launches
        return out

    def probe(s, workers):
        """The scheduler's device paths and engine, read before it closes."""
        steal = s.extensions["stealing"]._device_path
        paths = {"steal": steal.counters() if steal is not None else None}
        for i, policy in enumerate(s.extensions["amm"].policies):
            path = getattr(policy, "_device_path", None)
            paths[f"amm{i}"] = path.counters() if path is not None else None
        for name, c in paths.items():
            check(c is None or c["failures"] == 0, f"14a: the {name} device path failed: {c}")
        eng = s.state.native
        engine = eng.counters() if eng is not None and eng.active() else None
        return dict(paths=paths, engine=engine, state_device=str(s.state.device),
                    placement_device=str(s.state.placement.device))

    # 14a: config 2 at full width on 16 inproc workers
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    zero()
    a = asyncio.run(asyncio.wait_for(_servers_graph(
        dev, "inproc://", SRV_WORKERS, SRV_G, SRV_BLOCK, probe=probe),
        SRV_TIMEOUT_S))
    launches = read()
    peak = torch.cuda.max_memory_allocated() - mem0
    pl = a["placement"]
    check(a["state_device"].startswith("cuda") and a["placement_device"].startswith("cuda"),
          f"14a: the state on {a['state_device']}, the placement on {a['placement_device']}")
    check(pl["enabled"] and pl["plans"] >= 1, f"14a: the placement planned {pl['plans']} times, "
          f"enabled {pl['enabled']}")
    check(launches["partition"] + launches["place_wave"] > 0 and launches["steal"] > 0,
          f"14a: launches {launches}: K4 or K1, and K7, must launch from inside the Scheduler")
    engine = ("the native engine: " + _native_line(a["engine"]) if a["engine"] is not None
              else "the Python oracle (no native engine attached)")
    n = a["n_tasks"]
    print(f"[{card}] 14a config 2: tensordot_graph({SRV_G}) of {SRV_BLOCK} x {SRV_BLOCK} CUDA blocks, "
          f"{n} tasks on {SRV_WORKERS} inproc workers x 1 thread, no warm-up graph: "
          f"wall s {a['wall_s']:.3f}, {n / a['wall_s']:.0f} tasks / s; plan {pl}; launches {launches} "
          f"(K4 partition, K1 place_wave, K6 mirror_view, K7 steal, K8 amm_drop); "
          f"device paths {a['paths']}; {engine}; peak device memory {peak} B")

    # 14b: the wire on the card
    b = _wire_run(None)
    fam = b["torch_family"]
    check(fam.get("dumps", 0) > 0 and fam.get("loads", 0) > 0 and fam.get("dumps_bytes", 0) > 0,
          f"14b: the torch family carried nothing over tcp: {fam}")
    check(b["transfers"] > 0, "14b: no worker fetched a dependency from another")
    print(f"[{card}] 14b tensordot_graph({WIRE_G}) of {WIRE_BLOCK} x {WIRE_BLOCK} f32 CUDA blocks, "
          f"{b['n_tasks']} tasks on {WIRE_WORKERS} workers over tcp://127.0.0.1: wall s "
          f"{b['wall_s']:.3f}; torch family {fam}; {b['transfers']} transfers of "
          f"{b['transfer_bytes']} B, median {b['transfer_median_ms']:.3f} ms; wire bytes sent "
          f"{b['wire_bytes_sent']}, received {b['wire_bytes_recv']}")

    out, err = twin.communicate(timeout=CP_TWIN_TIMEOUT_S)
    check(twin.returncode == 0, f"phase 14's CPU run failed ({twin.returncode}):\n{err[-3000:]}")
    cpu = json.loads(out.strip().splitlines()[-1])
    check(cpu["a"]["digest"] == a["digest"] and cpu["a"]["n_tasks"] == n,
          f"14a: the card's results differ from the CPU run's: {a['digest']} / {cpu['a']['digest']}")
    check(cpu["b"]["digest"] == b["digest"],
          f"14b: the card's results differ from the CPU run's: {b['digest']} / {cpu['b']['digest']}")
    print(f"[{card}] 14a and 14b results == the CPU run bit for bit (digests {a['digest']}, "
          f"{b['digest']}; CPU walls s {cpu['a']['wall_s']:.3f} / {cpu['b']['wall_s']:.3f}, in a "
          f"child process beside the card's)")
    numbers = dict(
        config2_wall_s=a["wall_s"], config2_tasks=n, config2_tasks_per_s=n / a["wall_s"],
        config2_plan=pl, config2_paths=a["paths"], config2_engine=a["engine"],
        config2_peak_bytes=peak, config2_cpu_wall_s=cpu["a"]["wall_s"],
        wire_wall_s=b["wall_s"], wire_torch_family=fam, wire_transfers=b["transfers"],
        wire_transfer_bytes=b["transfer_bytes"], wire_transfer_median_ms=b["transfer_median_ms"],
        wire_bytes_sent=b["wire_bytes_sent"], wire_cpu_wall_s=cpu["b"]["wall_s"],
        wire_cpu_torch_family=cpu["b"]["torch_family"])
    return launches, numbers



# ------------------------------------------------------------ phase 15


# 15a: BASELINE config 1 (bench.py's cfg_array_sum): ones((10000, 10000),
# chunks=1000).sum(), 100 blocks of 1,000 x 1,000 f64 (800 MB) and a fan-in-8
# sum tree, on LocalCluster(n_workers=4, threads_per_worker=2), then bench's
# probe of 500 trivial tasks
DEP_WORKERS, DEP_THREADS, DEP_PROBE = 4, 2, 500
DEP_GRID, DEP_BLOCK = 10, 1000
# 15b: the workers' memory_limit: its target (0.6 x) of 60 MB sits under each
# worker's share of ~200 MB of blocks, so every worker spills
SPILL_LIMIT = 100_000_000
# the RSS thresholds off: a process that holds a CUDA context has a large RSS
# before it holds any data, and in-process workers all read that one RSS
RSS_OFF = {"worker.memory.spill": False, "worker.memory.pause": False}
# 15c: BASELINE config 3 (bench.py's _run_steal); then Client.rebalance() of
# REB_KEYS single-replica keys (rebalance_block) held by REB_HOLDERS of its workers
STEAL_TASKS, STEAL_WORKERS, STEAL_DELAY = 320, 64, 0.02
REB_KEYS, REB_HOLDERS = 4096, 16
# 15d: two nannies of two threads, blocks of seeded small integers
NANNY_BLOCKS, NANNY_N = 8, 1024
# 15e: the client's extras on 2 inproc workers of 2 threads
ACTOR_ADDS, WC_SUBTASKS, EXEC_INPUTS, EXTRA_N = 100, 16, 32, 1024
DEP_TIMEOUT_S = 600


def _blocks(device) -> str:
    return "cuda" if device is None else str(device)


def _paths(s, phase="15") -> dict:
    """The scheduler's periodic device paths' counters (None where a path
    was never made); none may count a failure."""
    ext = s.extensions.get("stealing")
    steal = getattr(ext, "_device_path", None)
    out = {"steal": steal.counters() if steal is not None else None}
    amm = s.extensions.get("amm")
    for i, policy in enumerate(getattr(amm, "policies", ())):
        path = getattr(policy, "_device_path", None)
        out[f"amm{i}"] = path.counters() if path is not None else None
    reb = getattr(s, "rebalance_path", None)
    out["rebalance"] = reb.counters() if reb is not None else None
    for name, c in out.items():
        check(c is None or c["failures"] == 0, f"{phase}: the {name} device path failed: {c}")
    return out


async def _config1(device):
    """15a: config 1's graph on the port's ``LocalCluster(4, 2)``."""
    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.client.client import Client
    from distributed_tpu_torch.deploy.local import LocalCluster

    g, root, _ = graphs.array_sum_graph(grid=DEP_GRID, block=DEP_BLOCK, device=_blocks(device))
    async with LocalCluster(n_workers=DEP_WORKERS, threads_per_worker=DEP_THREADS,
                            device=device) as cl:
        async with Client(cl.scheduler_address) as c:
            t0 = time.perf_counter()
            futs = c.compute_graph(g, [root])
            result = await futs[root].result()
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            probe = await c.gather(c.map(graphs.slowinc, range(DEP_PROBE), delay=0.0))
            probe_s = time.perf_counter() - t0
            check(probe == list(range(DEP_PROBE)), "15a: the trivial-task probe's results")
            return dict(result=result, wall_s=wall, n_tasks=len(g.tasks),
                        overhead_us_per_task=1e6 * probe_s / DEP_PROBE, paths=_paths(cl.scheduler),
                        state_device=str(cl.scheduler.state.device))


def _watch_evictions(buf, refs: list) -> None:
    """Chain onto ``buf.metrics_cb``: at an eviction's ``serialize``
    sample the key being spilled is still the fast layer's first, so keep a
    weak reference to its tensor."""
    cb = buf.metrics_cb

    def watch(label, value, unit):
        if label == "serialize" and buf.fast:
            spilled = buf.fast[next(iter(buf.fast))]
            if isinstance(spilled, torch.Tensor):
                refs.append(weakref.ref(spilled))
            del spilled
        cb(label, value, unit)

    buf.metrics_cb = watch


def _spill_rates(workers) -> dict:
    """Keys, bytes and MB/s each way, from the workers' spill counts and the
    fine metrics their ``SpillBuffer``s report: ``serialize`` (the pickle,
    with its D2H copy) and ``disk-write`` out, ``disk-read`` and
    ``deserialize`` (the load back onto the key's device) in; the bytes are
    the files'."""
    t: dict = {}
    for w in workers:
        for (context, _, _, label, unit), v in w.fine_metrics.total.items():
            if context == "spill":
                t[label, unit] = t.get((label, unit), 0.0) + v
    out_s = t.get(("serialize", "seconds"), 0.0) + t.get(("disk-write", "seconds"), 0.0)
    in_s = t.get(("disk-read", "seconds"), 0.0) + t.get(("deserialize", "seconds"), 0.0)
    out_b, in_b = t.get(("disk-write", "bytes"), 0.0), t.get(("disk-read", "bytes"), 0.0)
    return dict(spilled_keys=sum(w.data.spilled_count for w in workers), spilled_bytes=int(out_b),
                spill_MBps=out_b / 1e6 / out_s if out_s else None,
                unspilled_keys=sum(w.data.unspilled_count for w in workers),
                unspilled_bytes=int(in_b), unspill_MBps=in_b / 1e6 / in_s if in_s else None)


async def _spill(device):
    """15b: config 1's 100 blocks persisted on 4 workers whose
    ``memory_limit`` makes each spill, then summed."""
    from distributed_tpu_torch import config, graphs
    from distributed_tpu_torch.client.client import Client
    from distributed_tpu_torch.deploy.local import LocalCluster
    from distributed_tpu_torch.utils.diskutils import WorkSpace

    blocks = _blocks(device)
    on_device = "cuda:0" if device is None else "cpu"
    nbytes = DEP_BLOCK * DEP_BLOCK * 8
    evicted: list = []
    with config.set(RSS_OFF):
        async with LocalCluster(n_workers=DEP_WORKERS, threads_per_worker=DEP_THREADS,
                                device=device,
                                worker_kwargs={"memory_limit": SPILL_LIMIT}) as cl:
            dirs = [w.data.spill_directory for w in cl.workers]
            base = WorkSpace().base_dir
            check(all(os.path.dirname(d) == base for d in dirs),
                  f"15b: spill directories {dirs} outside the WorkSpace {base}")
            for w in cl.workers:
                _watch_evictions(w.data, evicted)
            async with Client(cl.scheduler_address) as c:
                # garbage of earlier phases (a mirror's device tensors in a
                # reference cycle) is freed before the baseline, not inside it
                gc.collect()
                mem0 = _memory_allocated(blocks)
                futs = [c.submit(graphs.ones_block, (DEP_BLOCK, DEP_BLOCK), blocks,
                                 key=f"ones-{i}-{j}")
                        for i in range(DEP_GRID) for j in range(DEP_GRID)]
                while not all(f.done() for f in futs):
                    await asyncio.sleep(0.01)
                gc.collect()
                held = _memory_allocated(blocks) - mem0
                n_evicted, alive = len(evicted), sum(r() is not None for r in evicted)
                check(n_evicted and alive == 0,
                      f"15b: {alive} of the {n_evicted} evicted tensors are still held")
                per = []
                for w in cl.workers:
                    files = os.listdir(w.data.spill_directory)
                    check(len(files) == len(w.data.slow),
                          f"15b: {len(files)} files for {len(w.data.slow)} spilled keys")
                    per.append(dict(spilled=w.data.spilled_count, slow=len(w.data.slow),
                                    fast=len(w.data.fast), fast_bytes=w.data.fast_bytes))
                check(all(p["spilled"] > 0 for p in per), f"15b: a worker did not spill: {per}")
                on_disk = sum(p["slow"] for p in per)
                persisted = _spill_rates(cl.workers)
                parts = c.map(graphs.block_sum, futs)
                total = await c.submit(graphs.sum_list, parts).result()
                del parts
                rates = _spill_rates(cl.workers)
                check(rates["unspilled_keys"] > 0, f"15b: the sum unspilled nothing: {rates}")
                # every block read back from its worker, the spilled ones
                # unspilled: on its device, f64, all ones
                keys = {f.key for f in futs}
                read = 0
                for w in cl.workers:
                    for key in [k for k in (*w.data.slow, *w.data.fast) if k in keys]:
                        read += 1
                        v = w.data[key]
                        check(str(v.device) == on_device and v.dtype == torch.float64
                              and bool((v == 1).all()),
                              f"15b: {key} came back as {v.dtype} on {v.device}")
                        del v
                check(read == len(keys), f"15b: {read} of the {len(keys)} blocks read back")
    gone = [not os.path.exists(d) for d in dirs]
    check(all(gone), f"15b: spill directories left after close: {dirs}")
    return dict(result=total, per_worker=per, on_disk_keys=on_disk, on_disk_bytes=on_disk * nbytes,
                device_bytes_held=held, device_bytes_written=DEP_GRID ** 2 * nbytes,
                fast_bytes=sum(p["fast_bytes"] for p in per), block_bytes=nbytes,
                evicted=n_evicted, persist=persisted, **rates)


async def _steal(device, steal):
    """15c: config 3's 320 slowinc tasks pinned to one of 64 one-thread
    workers (``allow_other_workers``), with work stealing on or off; with
    stealing on, then :func:`_rebalance` on the same cluster."""
    from distributed_tpu_torch import config, graphs
    from distributed_tpu_torch.client.client import Client
    from distributed_tpu_torch.deploy.local import LocalCluster

    with config.set({"scheduler.work-stealing": steal}):
        async with LocalCluster(n_workers=STEAL_WORKERS, threads_per_worker=1,
                                device=device) as cl:
            async with Client(cl.scheduler_address) as c:
                w0 = cl.workers[0].address
                await c.submit(graphs.slowinc, -1, delay=STEAL_DELAY).result()
                t0 = time.perf_counter()
                futs = c.map(graphs.slowinc, range(STEAL_TASKS), delay=STEAL_DELAY,
                             workers=[w0], allow_other_workers=True)
                res = await c.gather(futs)
                wall = time.perf_counter() - t0
                ran_on = {w for ws in (await c.who_has(futs)).values() for w in ws}
                out = dict(results=res, wall_s=wall, ran_on=len(ran_on),
                           paths=_paths(cl.scheduler))
                if steal:
                    del futs
                    out["rebalance"] = await _rebalance(c, cl)
                return out


def rebalance_block(i):
    """15c's rebalance key ``i``: seeded bytes, 512 + 4i + i^2 // 2048 of
    them, so no two keys have one size."""
    return np.random.default_rng(i).integers(0, 256, 512 + 4 * i + i * i // 2048, dtype=np.uint8)


async def _settled(test, what, timeout=60.0):
    t0 = time.perf_counter()
    while not test():
        check(time.perf_counter() - t0 < timeout, f"15c: {what} within {timeout} s")
        await asyncio.sleep(0.01)


async def _rebalance(c, cl):
    """15c's rebalance: REB_KEYS keys of uneven sizes on the first
    REB_HOLDERS workers, then ``Client.rebalance()``; the plan the
    scheduler runs is recorded (``rebalance_spy``) and held to the CPU
    plan on the same batch, the moves enacted, every value gathered
    before and after equal, the imbalance of managed memory not grown."""
    from distributed_tpu_torch.ops import rebalance

    s = cl.scheduler
    workers = list(s.state.workers.values())
    # the slowinc results released: the rebalance sees only its own keys
    await _settled(lambda: all(not ws.has_what for ws in workers), "slowinc's results released")
    holders = [w.address for w in cl.workers[:REB_HOLDERS]]
    futs = [None] * REB_KEYS
    for h, addr in enumerate(holders):
        ids = range(h, REB_KEYS, REB_HOLDERS)
        for i, f in zip(ids, c.map(rebalance_block, ids, workers=[addr])):
            futs[i] = f
    before = await c.gather(futs)
    digest = _result_digest([torch.from_numpy(v) for v in before])
    mem0 = [ws.nbytes for ws in workers]
    path0 = s.rebalance_path.counters() if s.rebalance_path is not None else None
    with rebalance_spy(s) as seen:
        t0 = time.perf_counter()
        res = await c.rebalance()
        wall = time.perf_counter() - t0
    check(len(seen["plans"]) == 1 and len(seen["batches"]) == 1,
          f"15c: {len(seen['plans'])} device plans, {len(seen['batches'])} batches for one rebalance")
    plan = seen["plans"][0]
    batch = seen["batches"][0]
    cpu = rebalance.plan_rebalance(batch, device="cpu")
    got = list(zip(*(a.tolist() for a in seen["moves"][0])))
    check(got == cpu, f"15c: the scheduler's {len(got)} moves != the CPU plan's {len(cpu)} on the "
          "same batch")
    wss, cand = plan["wss"], plan["cand"]
    check([(ts.key, a.address, b.address) for ts, a, b in plan["moves"]]
          == [(cand[k].key, wss[a].address, wss[b].address) for k, a, b in cpu],
          "15c: the plan's moves are not the CPU plan's keys and workers")
    check(len(cpu) > 0 and res == {"status": "OK", "moves": len(cpu)},
          f"15c: rebalance returned {res}, the CPU plan has {len(cpu)} moves")
    await _settled(lambda: all(ts.who_has == {b} for ts, _, b in plan["moves"]),
                   "every moved key held by its recipient alone")
    after = await c.gather(futs)
    check(len(after) == len(before) and all(np.array_equal(x, y) for x, y in zip(after, before)),
          "15c: a value changed in the rebalance")
    mem1 = [ws.nbytes for ws in workers]
    imb0, imb1 = max(mem0) - min(mem0), max(mem1) - min(mem1)
    check(imb1 <= imb0, f"15c: the rebalance grew the imbalance {imb0} -> {imb1}")
    return dict(moves=len(cpu), cand=len(cand), wall_s=wall, plan_ms=plan["ms"], digest=digest,
                imbalance_before=imb0, imbalance_after=imb1, path_before=path0,
                path=s.rebalance_path.counters(), device=str(s.rebalance_path.device),
                nbytes=int(sum(mem0)))


def child_modules():
    """The worker process's imports of the JAX package, JAX and the
    libraries the port does without."""
    import sys

    return sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "distributed_tpu", "msgpack", "cloudpickle", "yaml"))


def process_rss():
    """This process's RSS (None where psutil is absent)."""
    try:
        import psutil
    except ImportError:
        return None
    return psutil.Process().memory_info().rss


def child_rss(device):
    """The worker process's RSS once it holds a context on ``device``."""
    torch.zeros(1, device=device)
    return process_rss()


async def _nannies(device):
    """15d: two ``Nanny``s on a tcp scheduler, each spawning a worker
    process that computes blocks on ``device``; one worker SIGKILLed,
    restarted by its nanny, its keys recomputed."""
    import signal

    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.client.client import Client
    from distributed_tpu_torch.protocol.serialize import family_counts, reset_family_counts
    from distributed_tpu_torch.scheduler.server import Scheduler
    from distributed_tpu_torch.worker.nanny import Nanny

    blocks = _blocks(device)

    async def started(n):
        t0 = time.perf_counter()
        await n.start()
        return time.perf_counter() - t0

    reset_family_counts()
    async with Scheduler(listen_addr="tcp://127.0.0.1:0", device=device) as s:
        nannies = [Nanny(s.address, nthreads=2, memory_limit=0) for _ in range(2)]
        try:
            spawn_s = await asyncio.gather(*(started(n) for n in nannies))
            check(all(n.worker_address in s.state.workers for n in nannies),
                  "15d: a nanny's worker did not register")
            async with Client(s.address) as c:
                addrs = [n.worker_address for n in nannies]
                futs = [c.submit(graphs.tensordot_block, "N", i, 0, NANNY_N, 0, blocks,
                                 workers=[addrs[i % 2]], allow_other_workers=True,
                                 key=f"nanny-block-{i}") for i in range(NANNY_BLOCKS)]
                before = await c.gather(futs)
                check(all(str(b.device) == ("cuda:0" if device is None else "cpu") for b in before),
                      f"15d: results on {sorted({str(b.device) for b in before})}")
                digest = _result_digest(before)
                del before
                mods = await c.run(child_modules)
                check(all(m == [] for m in mods.values()), f"15d: the worker processes import {mods}")
                rss = await c.run(child_rss, blocks)
                victim = nannies[0]
                old, old_pid = victim.worker_address, victim.process.pid
                t0 = time.perf_counter()
                os.kill(old_pid, signal.SIGKILL)
                while not (victim.worker_address != old and victim.worker_address in s.state.workers
                           and old not in s.state.workers):
                    check(time.perf_counter() - t0 < 120, "15d: the killed worker did not come back")
                    await asyncio.sleep(0.02)
                restart_s = time.perf_counter() - t0
                after = await c.gather(futs)
                recompute_s = time.perf_counter() - t0
                again = _result_digest(after)
                del after
                check(again == digest, f"15d: results after the restart {again} != before {digest}")
                mods = await c.run(child_modules)
                check(all(m == [] for m in mods.values()), f"15d: the restarted process imports {mods}")
                return dict(digest=digest, spawn_s=list(spawn_s), restart_s=restart_s,
                            recompute_s=recompute_s, child_rss=sorted(rss.values(), key=str),
                            new_pid=victim.process.pid != old_pid,
                            torch_family=family_counts().get("torch", {}))
        finally:
            for n in nannies:
                await n.close()


class Accumulator:
    """15e's actor: a running sum of seeded blocks on ``device``."""

    def __init__(self, n, device):
        self.n, self.device = n, device
        self.total = torch.zeros(n, n, dtype=torch.float32, device=device)

    def add(self, seed):
        from distributed_tpu_torch import graphs

        self.total += graphs.tensordot_block("E", seed, 0, self.n, 0, self.device)
        return seed

    def value(self):
        return self.total


def wc_parent(n, size, device):
    """15e's task: submits ``n`` block sub-tasks through ``worker_client``,
    gathers them and stacks them."""
    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.client.worker_client import worker_client

    with worker_client() as wc:
        futs = [wc.submit(graphs.tensordot_block, "W", i, 0, size, 0, device, pure=False)
                for i in range(n)]
        return torch.stack(wc.gather_sync(futs))


def block_total(seed, size, device):
    from distributed_tpu_torch import graphs

    return float(graphs.tensordot_block("X", seed, 0, size, 0, device).sum())


async def _extras(device):
    """15e: an actor, ``worker_client`` and the executor on ``device``."""
    from distributed_tpu_torch.client.client import Client
    from distributed_tpu_torch.deploy.local import LocalCluster

    blocks = _blocks(device)
    async with LocalCluster(n_workers=2, threads_per_worker=2, device=device) as cl:
        async with Client(cl.scheduler_address) as c:
            t0 = time.perf_counter()
            fut = c.submit(Accumulator, EXTRA_N, blocks, actor=True)
            acc = await fut.result()
            for seed in range(ACTOR_ADDS):
                check(await acc.add(seed) == seed, "15e: an actor call's result")
            value = await acc.value()
            actor_s = time.perf_counter() - t0
            check(str(value.device) == ("cuda:0" if device is None else "cpu"),
                  f"15e: the accumulator on {value.device}")
            t0 = time.perf_counter()
            stacked = await c.submit(wc_parent, WC_SUBTASKS, EXTRA_N, blocks).result()
            wc_s = time.perf_counter() - t0
            ex = c.get_executor()
            t0 = time.perf_counter()
            gen = ex.map(block_total, range(EXEC_INPUTS), [EXTRA_N] * EXEC_INPUTS,
                         [blocks] * EXEC_INPUTS)
            mapped = await asyncio.get_running_loop().run_in_executor(None, list, gen)
            ex_s = time.perf_counter() - t0
            ex.shutdown(wait=False)
            return dict(actor=_result_digest([value]), actor_s=actor_s,
                        worker_client=_result_digest([stacked]), worker_client_s=wc_s,
                        executor=mapped, executor_s=ex_s, paths=_paths(cl.scheduler))


def deploy_cpu():
    """Phase 15's parts with ``device="cpu"``, in the child process of
    :func:`start_deploy_twin`."""
    torch.set_num_threads(CP_CPU_THREADS)

    def run(coro):
        return asyncio.run(asyncio.wait_for(coro, DEP_TIMEOUT_S))

    return {"a": run(_config1("cpu")), "b": run(_spill("cpu")),
            "c_on": run(_steal("cpu", True)), "c_off": run(_steal("cpu", False)),
            "d": run(_nannies("cpu")), "e": run(_extras("cpu"))}


def start_deploy_twin():
    """Phase 15's CPU run in a child process, started before phase 14's card
    runs (beside phase 14's own twin) and read after phase 15's card runs,
    so that no host wall of phase 15's card runs is taken beside it.  Its
    output goes to files: a pipe left unread would stall it."""
    out, err = tempfile.TemporaryFile(mode="w+"), tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke as c; print(json.dumps(c.deploy_cpu()))"],
        cwd=Path(__file__).resolve().parent, stdout=out, stderr=err, text=True)
    proc.files = (out, err)
    proc.started = time.perf_counter()
    return proc


def phase_deploy(twin, dev=None):
    """Phase 15, the deploy layer and the client's extras on the card, then
    the CPU run ``twin`` (:func:`start_deploy_twin`) read and compared."""
    card = smi_line()
    t_phase = time.perf_counter()
    launches, numbers, parts = _deploy_card(card, dev)
    numbers["card_s"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    rc = twin.wait(timeout=CP_TWIN_TIMEOUT_S)
    numbers["cpu_wait_s"] = time.perf_counter() - t0
    numbers["cpu_run_s"] = time.perf_counter() - twin.started
    out, err = (f.seek(0) or f.read() for f in twin.files)
    check(rc == 0, f"phase 15's CPU run failed ({rc}):\n{err[-3000:]}")
    numbers.update(_deploy_compare(card, parts, json.loads(out.strip().splitlines()[-1])))
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 15 deploy s {numbers['phase_s']:.1f} (card runs s "
          f"{numbers['card_s']:.1f}, then s {numbers['cpu_wait_s']:.1f} waiting for the CPU run, "
          f"which started before phase 14 and took s {numbers['cpu_run_s']:.1f})")
    return launches, numbers


def _deploy_card(card, dev):
    """Phase 15's card runs; returns the launches, the numbers and each
    part's results for :func:`_deploy_compare`."""
    from distributed_tpu_torch.ops import amm, leveled, partition, rebalance, stealing
    from distributed_tpu_torch.ops import fleet as fleet_ops

    counters = {"place_wave": leveled.place_waves_cuda, "partition": partition.partition_cuda,
                "steal": stealing.steal_rounds_cuda, "amm_drop": amm.drop_rounds_cuda,
                "rebalance": rebalance.rebalance_rounds_cuda}

    def zero():
        for fn in counters.values():
            fn.launches = 0
        fleet_ops.scatter_rows_cuda.launches = 0

    def read():
        out = {name: fn.launches for name, fn in counters.items()}
        out["mirror_view"] = fleet_ops.scatter_rows_cuda.launches
        return out

    def part(coro):
        before = read()
        out = asyncio.run(asyncio.wait_for(coro, DEP_TIMEOUT_S))
        out["launches"] = {k: v - before[k] for k, v in read().items()}
        return out

    rss0 = process_rss()
    print(f"[{card}] 15: psutil {'absent' if rss0 is None else 'present'}; this process's RSS "
          f"{rss0} B before the phase (its CUDA context and phases 1-14 included: the RSS "
          f"thresholds worker.memory.spill and pause are off in 15b, the managed-bytes target spills)")
    check(rss0 is None or rss0 > 0, "15: psutil is present but read an RSS of 0")
    zero()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    a = part(_config1(dev))
    peak = torch.cuda.max_memory_allocated() - mem0
    check(a["result"] == float((DEP_GRID * DEP_BLOCK) ** 2), f"15a: the sum is {a['result']}")
    check(a["state_device"].startswith("cuda"), f"15a: the scheduler's state on {a['state_device']}")
    print(f"[{card}] 15a config 1: ones(({DEP_GRID * DEP_BLOCK}, {DEP_GRID * DEP_BLOCK}), "
          f"chunks={DEP_BLOCK}).sum() as f64 CUDA blocks, {a['n_tasks']} tasks on LocalCluster("
          f"n_workers={DEP_WORKERS}, threads_per_worker={DEP_THREADS}, device=cuda): sum "
          f"{a['result']!r}, wall s {a['wall_s']:.3f}, {a['n_tasks'] / a['wall_s']:.0f} tasks / s; "
          f"{DEP_PROBE} trivial tasks {a['overhead_us_per_task']:.0f} us a task; launches from "
          f"inside the scheduler {a['launches']}; device paths {a['paths']}; peak device memory "
          f"{peak} B")

    b = part(_spill(dev))
    check(b["result"] == float((DEP_GRID * DEP_BLOCK) ** 2), f"15b: the sum is {b['result']}")
    freed = b["device_bytes_written"] - b["device_bytes_held"]
    # every block is block_bytes: the card holds the fast layers' blocks and no
    # spilled one when what it holds beyond them is less than a block (the rest
    # is allocations outside the blocks, printed)
    other = b["device_bytes_held"] - b["fast_bytes"]
    check(0 <= other < b["block_bytes"],
          f"15b: device memory held {b['device_bytes_held']} B after persisting "
          f"{b['device_bytes_written']} B, the fast layers {b['fast_bytes']} B, with "
          f"{b['on_disk_bytes']} B on disk: a spilled block is still on the card")
    print(f"[{card}] 15b spill: the {DEP_GRID ** 2} blocks persisted on {DEP_WORKERS} workers of "
          f"memory_limit {SPILL_LIMIT} B (target {0.6 * SPILL_LIMIT:.0f} B), RSS thresholds off: per "
          f"worker {b['per_worker']}; after persisting {b['on_disk_keys']} keys ({b['on_disk_bytes']} "
          f"B) on disk and {b['device_bytes_held']} B held on the card of {b['device_bytes_written']} "
          f"B made (freed {freed} B; held: the fast layers' {b['fast_bytes']} B and {other} B outside "
          f"the blocks; the {b['evicted']} tensors the persist evicted all collected); the persist spilled "
          f"{b['persist']['spilled_keys']} keys, {b['persist']['spilled_bytes']} B of files at "
          f"{b['persist']['spill_MBps']:.1f} MB/s; by the sum's end {b['spilled_keys']} keys "
          f"({b['spilled_bytes']} B) spilled at {b['spill_MBps']:.1f} MB/s and "
          f"{b['unspilled_keys']} ({b['unspilled_bytes']} B) unspilled at {b['unspill_MBps']:.1f} "
          f"MB/s (the workers' spill metrics: serialize + disk-write, disk-read + deserialize); "
          f"every block read back on cuda:0 and all ones; sum {b['result']!r}; the spill "
          f"directories gone after close; launches {b['launches']}")

    c_on = part(_steal(dev, True))
    c_off = part(_steal(dev, False))
    ideal = STEAL_TASKS * STEAL_DELAY / STEAL_WORKERS
    check(c_on["launches"]["steal"] > 0, f"15c: K7 did not launch with stealing on: {c_on['launches']}")
    check(c_on["ran_on"] > 1, f"15c: with stealing on the tasks ran on {c_on['ran_on']} worker(s)")
    check(c_on["results"] == c_off["results"] == [i for i in range(STEAL_TASKS)],
          "15c: the results")
    print(f"[{card}] 15c config 3: {STEAL_TASKS} slowinc({STEAL_DELAY} s) pinned to one of "
          f"{STEAL_WORKERS} one-thread workers: stealing on wall s {c_on['wall_s']:.3f} on "
          f"{c_on['ran_on']} workers, launches {c_on['launches']}, paths {c_on['paths']}; stealing "
          f"off wall s {c_off['wall_s']:.3f} on {c_off['ran_on']} workers, launches "
          f"{c_off['launches']}; ideal {ideal:.3f} s")
    reb = c_on["rebalance"]
    check(reb["path_before"] is None and reb["path"] == {"launches": 1, "failures": 0,
                                                         "cycles_device": 1, "cycles_host": 0},
          f"15c: the rebalance path's counters {reb['path_before']} -> {reb['path']}")
    check(reb["device"].startswith("cuda") and c_on["launches"]["rebalance"] == 1,
          f"15c: K9 launched {c_on['launches']['rebalance']} times on {reb['device']}, not once")
    print(f"[{card}] 15c rebalance: {REB_KEYS} keys ({reb['nbytes']} B, {reb['cand']} candidates) on "
          f"{REB_HOLDERS} of the {STEAL_WORKERS} workers: Client.rebalance() wall s "
          f"{reb['wall_s']:.3f}, the plan ms {reb['plan_ms']:.2f} "
          f"({100 * reb['plan_ms'] / 1e3 / reb['wall_s']:.1f} %) on {reb['device']}, K9 launches 1, "
          f"path {reb['path']}; {reb['moves']} moves == the CPU plan on the same batch, enacted; "
          f"values == before ({reb['digest']}); imbalance {reb['imbalance_before']} -> "
          f"{reb['imbalance_after']} B")

    d = part(_nannies(dev))
    fam = d["torch_family"]
    check(fam.get("loads", 0) > 0, f"15d: the torch family carried nothing back: {fam}")
    check(d["new_pid"], "15d: the nanny's worker has the killed process's pid")
    check(rss0 is None or all(r and r > 0 for r in d["child_rss"]),
          f"15d: the worker processes' RSS {d['child_rss']}")
    print(f"[{card}] 15d nannies: 2 Nanny x 2 threads on tcp://127.0.0.1, spawn to registration s "
          f"{[round(x, 3) for x in d['spawn_s']]}; {NANNY_BLOCKS} blocks of {NANNY_N} x {NANNY_N} f32 "
          f"on cuda in the worker processes, back through the torch family {fam}; children import "
          f"no JAX package, no jax; child RSS after its CUDA context {d['child_rss']} B; SIGKILL to "
          f"the new worker registered s {d['restart_s']:.3f}, results recomputed and equal s "
          f"{d['recompute_s']:.3f}; launches {d['launches']}")

    e = part(_extras(dev))
    print(f"[{card}] 15e extras: an actor's CUDA accumulator took {ACTOR_ADDS} add calls in s "
          f"{e['actor_s']:.3f} (digest {e['actor']}); worker_client gathered {WC_SUBTASKS} CUDA "
          f"blocks in s {e['worker_client_s']:.3f}; get_executor().map over {EXEC_INPUTS} inputs s "
          f"{e['executor_s']:.3f}; launches {e['launches']}")
    launches = read()
    check(launches["steal"] > 0 and launches["mirror_view"] > 0,
          f"15: launches {launches}: K6 and K7 must launch from inside the port's cluster")

    numbers = dict(
        base_rss=rss0, config1_wall_s=a["wall_s"], config1_tasks=a["n_tasks"],
        config1_overhead_us_per_task=a["overhead_us_per_task"], config1_peak_bytes=peak,
        config1_launches=a["launches"],
        spill_per_worker=b["per_worker"], spill_on_disk_bytes=b["on_disk_bytes"],
        spill_device_bytes_held=b["device_bytes_held"], spill_freed_bytes=freed,
        spill_other_bytes=other,
        spill_keys=b["spilled_keys"], spill_bytes=b["spilled_bytes"], spill_MBps=b["spill_MBps"],
        unspill_keys=b["unspilled_keys"], unspill_bytes=b["unspilled_bytes"],
        unspill_MBps=b["unspill_MBps"],
        steal_on_wall_s=c_on["wall_s"], steal_off_wall_s=c_off["wall_s"], steal_ideal_s=ideal,
        steal_on_workers=c_on["ran_on"], steal_off_workers=c_off["ran_on"],
        steal_on_launches=c_on["launches"], steal_paths=c_on["paths"],
        rebalance_wall_s=reb["wall_s"], rebalance_plan_ms=reb["plan_ms"],
        rebalance_moves=reb["moves"], rebalance_imbalance=[reb["imbalance_before"],
                                                           reb["imbalance_after"]],
        nanny_spawn_s=d["spawn_s"], nanny_restart_s=d["restart_s"],
        nanny_recompute_s=d["recompute_s"], nanny_child_rss=d["child_rss"],
        nanny_torch_family=fam,
        actor_s=e["actor_s"], worker_client_s=e["worker_client_s"], executor_s=e["executor_s"])
    parts = {"a": a, "b": b, "c_on": c_on, "c_off": c_off, "d": d, "e": e}
    return launches, numbers, parts


def _deploy_compare(card, card_parts, cpu) -> dict:
    """Hold each of phase 15's card results to the CPU run's, bit for bit;
    returns the CPU run's walls and rates."""
    a, b, c_on, c_off, d, e = (card_parts[k] for k in ("a", "b", "c_on", "c_off", "d", "e"))
    check(cpu["a"]["result"] == a["result"] and cpu["b"]["result"] == b["result"],
          f"15a/b: the card's sums {a['result']} / {b['result']} != the CPU run's")
    check(cpu["c_on"]["results"] == c_on["results"] and cpu["c_off"]["results"] == c_off["results"],
          "15c: the card's results differ from the CPU run's")
    reb, reb_cpu = c_on["rebalance"], cpu["c_on"]["rebalance"]
    check(reb_cpu["device"] == "cpu" and reb_cpu["path"]["launches"] == 1,
          f"15c: the CPU run's rebalance path {reb_cpu['path']} on {reb_cpu['device']}")
    check((reb_cpu["moves"], reb_cpu["digest"]) == (reb["moves"], reb["digest"]),
          f"15c: the card's rebalance ({reb['moves']} moves, values {reb['digest']}) != the CPU "
          f"run's ({reb_cpu['moves']}, {reb_cpu['digest']})")
    check(cpu["d"]["digest"] == d["digest"],
          f"15d: the card's results {d['digest']} != the CPU run's {cpu['d']['digest']}")
    for k in ("actor", "worker_client", "executor"):
        check(cpu["e"][k] == e[k], f"15e: the card's {k} result differs from the CPU run's")
    print(f"[{card}] 15a-e results == the CPU run bit for bit (CPU walls: 15a s "
          f"{cpu['a']['wall_s']:.3f}, 15c on/off s {cpu['c_on']['wall_s']:.3f} / "
          f"{cpu['c_off']['wall_s']:.3f} on {cpu['c_on']['ran_on']} / {cpu['c_off']['ran_on']} "
          f"workers, its rebalance {reb_cpu['moves']} moves in s {reb_cpu['wall_s']:.3f}; 15d spawn s {[round(x, 3) for x in cpu['d']['spawn_s']]}, restart s "
          f"{cpu['d']['restart_s']:.3f}; 15b CPU spill {cpu['b']['spill_MBps']:.1f} / unspill "
          f"{cpu['b']['unspill_MBps']:.1f} MB/s; in a child process started before phase 14)")
    return dict(config1_cpu_wall_s=cpu["a"]["wall_s"], spill_cpu_MBps=cpu["b"]["spill_MBps"],
                unspill_cpu_MBps=cpu["b"]["unspill_MBps"],
                steal_cpu_on_wall_s=cpu["c_on"]["wall_s"],
                steal_cpu_off_wall_s=cpu["c_off"]["wall_s"], rebalance_cpu_wall_s=reb_cpu["wall_s"],
                nanny_cpu_spawn_s=cpu["d"]["spawn_s"],
                nanny_cpu_restart_s=cpu["d"]["restart_s"])



# ------------------------------------------------------------ phase 16


# 16a: BASELINE config 4 (bench.py's cfg_shuffle): 10,000,000 rows of an int64
# key in [0, 2^30) and an f64 value, in 128 partitions of 78,125 made by a
# mapped task, hash-shuffled on "key" into 128 outputs by p2p_shuffle_arrays on
# LocalCluster(n_workers=128, threads_per_worker=1) at its defaults
C4_WORKERS, C4_PARTS, C4_ROWS = 128, 128, 10_000_000
# 16b: the device shuffle through the cluster at phase 8's size: 8 shards of
# SHUF_ROWS rows (int32 keys in [0, 2^30), [SHUF_WIDTH] f32 values) made on
# the card, the store's mesh on 8 virtual shards of the one card
DS_ROWS = SHUF_ROWS
# 16c: the coordination objects carry a future of a 1,024 x 1,024 f32 block
COORD_N = 1024
SHUFFLE_TIMEOUT_S = 600


def config4_part(i, n):
    """16a's input partition ``i``: bench.py's ``cfg_shuffle`` ``make_part``."""
    rng = np.random.default_rng(i)
    return {"key": rng.integers(0, 1 << 30, n).astype(np.int64), "value": rng.random(n)}


def part_rows(p):
    return len(p["key"])


def _splitmix64(x):
    """The shuffle's row hash, written out again here: splitmix64's
    finalizer on the key's bits."""
    z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _stages(stream, sid) -> dict:
    """16a by part from the scheduler's task stream: for the transfers, the
    barrier, the unpacks and the ``len`` tasks, the seconds from the first
    transfer's start to the part's first start and last stop, and the part's
    compute seconds summed (the workers' one clock)."""
    parts = {"transfer": f"{sid}-transfer-", "barrier": f"{sid}-barrier",
             "unpack": f"{sid}-unpack-", "len": "part_rows"}
    spans: dict = {}
    for rec in stream:
        for ss in rec["startstops"]:
            if ss.get("action") != "compute":
                continue
            for name, prefix in parts.items():
                if str(rec["key"]).startswith(prefix):
                    spans.setdefault(name, []).append((ss["start"], ss["stop"]))
    if "transfer" not in spans:
        return {}
    t0 = min(a for a, _ in spans["transfer"])
    return {name: {"first_start_s": min(a for a, _ in v) - t0, "last_stop_s": max(b for _, b in v) - t0,
                   "compute_s": sum(b - a for a, b in v), "tasks": len(v)}
            for name, v in spans.items()}


def config4_expected(n_parts, rows_per):
    """16a's outputs computed without the cluster: output ``j`` holds every
    row whose key hashes to ``j`` (``splitmix64(key) % n_parts``), once,
    partition by partition in input order and in input order inside each."""
    parts = [config4_part(i, rows_per) for i in range(n_parts)]
    cols = {c: np.concatenate([p[c] for p in parts]) for c in ("key", "value")}
    dest = (_splitmix64(cols["key"]) % np.uint64(n_parts)).astype(np.int64)
    # rows by destination, then by position (input partition, row): a stable sort
    order = np.argsort(dest, kind="stable")
    bounds = np.searchsorted(dest[order], np.arange(n_parts + 1))
    return [{c: v[order[bounds[j]:bounds[j + 1]]] for c, v in cols.items()}
            for j in range(n_parts)]


async def _config4(device):
    """16a: config 4 on the port's ``LocalCluster``; returns the outputs,
    the wall from the shuffle call to the gathered sizes and the epoch."""
    from distributed_tpu_torch.client.client import Client
    from distributed_tpu_torch.deploy.local import LocalCluster
    from distributed_tpu_torch.shuffle import p2p_shuffle_arrays

    t0 = time.perf_counter()
    async with LocalCluster(n_workers=C4_WORKERS, threads_per_worker=1, device=device) as cl:
        start_s = time.perf_counter() - t0
        async with Client(cl.scheduler_address) as c:
            parts = c.map(config4_part, range(C4_PARTS), n=C4_ROWS // C4_PARTS)
            await c.gather(parts)
            t0 = time.perf_counter()
            outs = await p2p_shuffle_arrays(c, parts, npartitions_out=C4_PARTS, on="key")
            sizes = await c.gather(c.map(part_rows, outs))
            wall = time.perf_counter() - t0
            got = await c.gather(outs)
            ext = cl.scheduler.extensions["shuffle"]
            sid = outs[0].key.rsplit("-unpack-", 1)[0]
            run_id = ext.active[sid].run_id if sid in ext.active else None
            owners = {w for ws in (await c.who_has(outs)).values() for w in ws}
            stages = _stages(await c.get_task_stream(count=4 * C4_PARTS + 8), sid)
            out = dict(got=got, sizes=sizes, wall_s=wall, start_s=start_s, run_id=run_id,
                       stages=stages,
                       owners=len(owners), state_device=str(cl.scheduler.state.device),
                       paths=_paths(cl.scheduler, "16a"))
            t0 = time.perf_counter()
    out["close_s"] = time.perf_counter() - t0
    return out


def device_shuffle_part(i, n, width, device):
    """16b's input ``i`` made on ``device``: int32 keys in [0, 2^30) and
    ``[n, width]`` f32 values from a generator seeded with ``i``."""
    g = torch.Generator(device=device).manual_seed(1000 + i)
    keys = torch.randint(0, 1 << 30, (n,), generator=g, device=device, dtype=torch.int32)
    return keys, torch.rand((n, width), generator=g, device=device)


async def _device_shuffle(device):
    """16b: ``p2p_shuffle_device`` on the port's ``LocalCluster(n_dev)``,
    the store's mesh ``[device] * n_dev``; returns the inputs, the
    outputs, the wall, K12's launches during the shuffle and the epoch."""
    from distributed_tpu_torch.client.client import Client
    from distributed_tpu_torch.deploy.local import LocalCluster
    from distributed_tpu_torch.ops import ici
    from distributed_tpu_torch.shuffle.device import device_store, p2p_shuffle_device

    n_dev, n_rows = SHUF_SHARDS, DS_ROWS
    store = device_store()
    old = store.devices
    store.devices = [device] * n_dev
    try:
        async with LocalCluster(n_workers=n_dev, threads_per_worker=1, device=device) as cl:
            async with Client(cl.scheduler_address) as c:
                inputs = c.map(device_shuffle_part, range(n_dev), n=n_rows, width=SHUF_WIDTH,
                               device=str(device))
                parts = await c.gather(inputs)
                k0 = ici.shuffle_bucket_cuda.launches
                t0 = time.perf_counter()
                outs = await p2p_shuffle_device(c, inputs)
                got = await c.gather(outs)
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = ici.shuffle_bucket_cuda.launches - k0
                sid = outs[0].key.rsplit("-unpack-", 1)[0]
                st = cl.scheduler.extensions["shuffle"].active.get(sid)
                served = store.was_served(sid, st.run_id) if st is not None else False
                return dict(parts=parts, got=got, wall_s=wall, launches=launches,
                            run_id=st.run_id if st is not None else None, served=served)
    finally:
        store.devices = old


def coord_block(seed, n, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((n, n), generator=g, device=device)


async def _coordination(device):
    """16c: a future of a ``COORD_N``-square block on ``device`` handed from one
    client to another through a Queue, a Variable, an Event, a Lock, a
    Semaphore and a published dataset; returns each handed-over value."""
    from distributed_tpu_torch.client.client import Client
    from distributed_tpu_torch.coordination import Event, Lock, Queue, Semaphore, Variable
    from distributed_tpu_torch.deploy.local import LocalCluster

    t0 = time.perf_counter()
    async with LocalCluster(n_workers=2, threads_per_worker=1, device=device) as cl:
        addr = cl.scheduler_address
        async with Client(addr) as c1, Client(addr) as c2:
            start_s = time.perf_counter() - t0
            fut = c1.submit(coord_block, 16, COORD_N, str(device), key="coord-block")
            want = await fut.result()
            got = {}
            t0 = time.perf_counter()

            async def take(name, record):
                got[name] = await record.result()

            await Queue("q16", client=c1).put(fut)
            await take("queue", await Queue("q16", client=c2).get(timeout=30))
            await Variable("v16", client=c1).set(fut)
            await take("variable", await Variable("v16", client=c2).get(timeout=30))
            # the Event: c2 waits, c1 leaves the future in a Variable and sets it
            waiter = asyncio.ensure_future(Event("e16", client=c2).wait(timeout=30))
            await Variable("ve16", client=c1).set(fut)
            await Event("e16", client=c1).set()
            check(await waiter, "16c: the Event never reached the second client")
            await take("event", await Variable("ve16", client=c2).get(timeout=30))
            # the Lock and the Semaphore: c1 holds it while it leaves the
            # future, c2 is refused until c1 lets go
            for name, a, b in (("lock", Lock("l16", client=c1), Lock("l16", client=c2)),
                               ("semaphore", Semaphore(1, "s16", client=c1),
                                Semaphore(1, "s16", client=c2))):
                check(await a.acquire(timeout=30), f"16c: the first client's {name}")
                check(not await b.acquire(timeout=0.05), f"16c: the {name} let two holders in")
                await Variable(f"v{name}16", client=c1).set(fut)
                await a.release()
                check(await b.acquire(timeout=30), f"16c: the second client's {name}")
                await take(name, await Variable(f"v{name}16", client=c2).get(timeout=30))
                await b.release()
            await c1.publish_dataset("ds16", fut)
            await take("dataset", await c2.get_dataset("ds16"))
            await c2.unpublish_dataset("ds16")
            walls = {"start_s": start_s, "handoffs_s": time.perf_counter() - t0}
            t0 = time.perf_counter()
    walls["close_s"] = time.perf_counter() - t0
    return want, got, walls


def phase_shuffle(dev=None):
    """Phase 16, the port's shuffle and coordination extensions on the card."""
    from distributed_tpu_torch.ops import amm, ici, leveled, partition, stealing
    from distributed_tpu_torch.ops import fleet as fleet_ops

    card = smi_line()
    t_phase = time.perf_counter()
    counters = {"place_wave": leveled.place_waves_cuda, "partition": partition.partition_cuda,
                "steal": stealing.steal_rounds_cuda, "amm_drop": amm.drop_rounds_cuda,
                "shuffle_bucket": ici.shuffle_bucket_cuda}

    def zero():
        for fn in counters.values():
            fn.launches = 0
        fleet_ops.scatter_rows_cuda.launches = 0

    def read():
        out = {name: fn.launches for name, fn in counters.items()}
        out["mirror_view"] = fleet_ops.scatter_rows_cuda.launches
        return out

    def run(coro):
        return asyncio.run(asyncio.wait_for(coro, SHUFFLE_TIMEOUT_S))

    # 16a: config 4 at full width
    zero()
    a = run(_config4(dev))
    launches_a = read()
    t0 = time.perf_counter()
    want = config4_expected(C4_PARTS, C4_ROWS // C4_PARTS)
    got = a.pop("got")
    check(sum(a["sizes"]) == C4_ROWS and sum(len(p["key"]) for p in got) == C4_ROWS,
          f"16a: {sum(a['sizes'])} rows came out of {C4_ROWS}")
    for j, (g, w) in enumerate(zip(got, want)):
        check(bool(((_splitmix64(g["key"]) % np.uint64(C4_PARTS)) == j).all()),
              f"16a: output {j} holds a row of another partition")
        check(np.array_equal(g["key"], w["key"])
              and np.array_equal(g["value"].view(np.uint64), w["value"].view(np.uint64)),
              f"16a: output {j} differs from its rows in input-partition order")
    check_s = time.perf_counter() - t0
    del got, want
    check(a["state_device"].startswith("cuda") or dev is not None,
          f"16a: the scheduler's state on {a['state_device']}")
    print(f"[{card}] 16a config 4: p2p_shuffle_arrays of {C4_ROWS} rows (int64 key, f64 value) in "
          f"{C4_PARTS} partitions into {C4_PARTS} on LocalCluster(n_workers={C4_WORKERS}, "
          f"threads_per_worker=1) (started in s {a['start_s']:.3f}, closed in s {a['close_s']:.3f}): "
          f"wall s {a['wall_s']:.3f} from "
          f"the shuffle call to the gathered sizes, {C4_ROWS / a['wall_s']:.0f} rows / s; epoch "
          f"{a['run_id']}; outputs on {a['owners']} workers; every row once, in its hash partition, "
          f"in input-partition order (checked in s {check_s:.3f}); by part from the task stream "
          f"(s from the first transfer's start: first start, last stop, compute summed) "
          f"{json.dumps(a['stages'])}; launches {launches_a} (K1 "
          f"place_wave, K4 partition, K6 mirror_view, K7 steal, K8 amm_drop); device paths "
          f"{a['paths']}")

    # 16b: the device shuffle through the cluster
    torch.cuda.empty_cache()
    zero()
    b = run(_device_shuffle(dev if dev is not None else "cuda:0"))
    launches_b = read()
    check(b["run_id"] == 1 and b["served"], f"16b: epoch {b['run_id']}, served {b['served']}")
    check(b["launches"] == 4 and launches_b["shuffle_bucket"] == 4,
          f"16b: K12 launched {b['launches']} times in the shuffle (4 an exchange)")
    parts = b.pop("parts")
    mesh = ici.make_mesh_1d(SHUF_SHARDS, devices=[parts[0][0].device] * SHUF_SHARDS)
    ko, vo, counts, _ = ici.shuffle_on_mesh(mesh, [k for k, _ in parts], [v for _, v in parts],
                                            capacity=DS_ROWS)
    direct = ici.compact_shuffle_output(ko, vo, counts, SHUF_SHARDS)
    del ko, vo
    for d, ((gk, gv), (wk, wv)) in enumerate(zip(b["got"], direct)):
        check(gk.device == wk.device and gk.device.type == ("cuda" if dev is None else gk.device.type),
              f"16b: output {d} on {gk.device}")
        check(_same_bytes(gk, wk) and _same_bytes(gv, wv),
              f"16b: output {d} differs from shuffle_on_mesh's")
    rows_out = sum(int(k.shape[0]) for k, _ in b["got"])
    check(rows_out == SHUF_SHARDS * DS_ROWS, f"16b: {rows_out} rows came out")
    del parts, direct
    b.pop("got")
    torch.cuda.empty_cache()
    print(f"[{card}] 16b device shuffle: p2p_shuffle_device of {SHUF_SHARDS} x {DS_ROWS} rows "
          f"(int32 keys, [{SHUF_WIDTH}] f32 values) made on the card, on LocalCluster(n_workers="
          f"{SHUF_SHARDS}) with the store's mesh on {SHUF_SHARDS} shards of the card: wall s "
          f"{b['wall_s']:.3f}, {SHUF_SHARDS * DS_ROWS / b['wall_s']:.0f} rows / s; K12 launched "
          f"{b['launches']} times from the barrier task; outputs on the card, == a direct "
          f"shuffle_on_mesh bit for bit; launches {launches_b}")

    # 16c: coordination with a CUDA block
    zero()
    t0 = time.perf_counter()
    want_c, got_c, walls_c = run(_coordination(dev if dev is not None else "cuda"))
    coord_s = time.perf_counter() - t0
    launches_c = read()
    for name, t in got_c.items():
        check(t.device == want_c.device and _same_bytes(t, want_c),
              f"16c: the {name} handed over {t.device} / a value that differs")
    check(want_c.device.type == ("cuda" if dev is None else want_c.device.type),
          f"16c: the block on {want_c.device}")
    print(f"[{card}] 16c coordination: a future of a {COORD_N} x {COORD_N} f32 block on "
          f"{want_c.device} handed from one client to another through {sorted(got_c)}, each equal "
          f"bit for bit; s {coord_s:.3f} (cluster and clients up s {walls_c['start_s']:.3f}, the "
          f"handoffs s {walls_c['handoffs_s']:.3f}, closing s {walls_c['close_s']:.3f}); launches "
          f"{launches_c}")
    launches = {k: launches_a.get(k, 0) + launches_b.get(k, 0) + launches_c.get(k, 0)
                for k in launches_a}
    numbers = dict(config4_wall_s=a["wall_s"], config4_rows_per_s=C4_ROWS / a["wall_s"],
                   config4_start_s=a["start_s"], config4_close_s=a["close_s"],
                   config4_run_id=a["run_id"],
                   config4_owners=a["owners"], config4_stages=a["stages"],
                   config4_launches=launches_a,
                   config4_paths=a["paths"], config4_check_s=check_s,
                   device_shuffle_wall_s=b["wall_s"], device_shuffle_k12=b["launches"],
                   device_shuffle_launches=launches_b, coordination_s=coord_s,
                   coordination_walls=walls_c,
                   coordination_launches=launches_c)
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 16 shuffle s {numbers['phase_s']:.1f}")
    return launches, numbers


# ------------------------------------------------------------ phase 17


# 17a: a cluster of processes from the port's command line, config 1's shape
CLI_WORKERS, CLI_THREADS = 4, 2
# a batch past the placement's min-batch (512, config.py): it plans in the scheduler
CLI_DAG = 2_048
# the longest 17a waits for the scheduler's in-flight plan to land, s
CLI_PLAN_WAIT_S = 30
CLI_DAG_MOD = 1_000_003
# K2 in a worker process: seq, heads, head dim (bf16, causal), phase 2's headline
CLI_FLASH = (8192, 16, 128)
# 17b: timed scrapes of the scheduler's /metrics
CLI_SCRAPES = 20
# 17c: blocks fetched between two workers over ws://
WS_BLOCK, WS_FETCHES = 1024, 8
CLI_TIMEOUT_S = 600


# the placement's gates opened for a fleet of 4 (``min-workers`` 8 and the
# transfer-ratio skip, which phase 14's 16 workers pass) as a user of the
# CLI opens them: the port's DTPU_* overrides in the scheduler's environment
CLI_SCHEDULER_ENV = {"DTPU_SCHEDULER__JAX__MIN_WORKERS": "0",
                     "DTPU_SCHEDULER__JAX__MIN_TRANSFER_RATIO": "0"}


def cli_launches(zero=False, dtpu_scheduler=None):
    """On the CLI-started scheduler (``Client.run_on_scheduler``): K1's and
    K4's launches in its process, first set to 0 when ``zero``, its state's
    device, its placement's counters and the gates it read from its
    configuration."""
    from distributed_tpu_torch.ops import leveled, partition

    p = dtpu_scheduler.state.placement
    if zero:
        leveled.place_waves_cuda.launches = 0
        partition.partition_cuda.launches = 0
    return dict(place_wave=leveled.place_waves_cuda.launches,
                partition=partition.partition_cuda.launches,
                state_device=str(dtpu_scheduler.state.device),
                placement=_placement_stats(p) if p is not None else None,
                inflight=0 if p is None else p.plans_inflight,
                gates=None if p is None else dict(min_workers=p.min_workers,
                                                  min_transfer_ratio=p.min_transfer_ratio))


def cli_http_port(dtpu_worker=None):
    """A worker's own http port (``Client.run`` on every worker)."""
    return dtpu_worker.http_server.port


def cli_dag_task(i, *deps):
    return (i + sum(deps)) % CLI_DAG_MOD


def cli_dag(TaskSpec, TaskRef, Graph, prefix="dag"):
    """``graphs.random_dag(CLI_DAG)`` as tasks ``{prefix}-i`` of
    :func:`cli_dag_task`, and its results computed on the host."""
    from distributed_tpu_torch import graphs

    _, _, src, dst = graphs.random_dag(CLI_DAG, seed=0)
    deps = [[] for _ in range(CLI_DAG)]
    for a, b in zip(src.tolist(), dst.tolist()):
        deps[b].append(a)
    g = Graph()
    want = []
    for i in range(CLI_DAG):
        g.tasks[f"{prefix}-{i}"] = TaskSpec(
            cli_dag_task, (i, *[TaskRef(f"{prefix}-{j}") for j in deps[i]]))
        want.append(cli_dag_task(i, *[want[j] for j in deps[i]]))
    return g, [f"{prefix}-{i}" for i in range(CLI_DAG)], want


def cli_flash_task(seq, heads, dim, seed, device="cuda"):
    """In a worker process: ``flash_attention`` (K2, its launch counted from
    0 here) on seeded bf16 inputs made on the worker's card, causal, held
    to the plain version by ``flash.o_excess``."""
    from distributed_tpu_torch.ops import flash

    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((seq, heads, dim), generator=g, device=device).to(torch.bfloat16)
               for _ in range(3))
    flash.flash_forward_cuda.launches = 0
    out = flash.flash_attention(q, k, v, causal=True, device=q.device)
    if out.is_cuda:
        torch.cuda.synchronize()
    launches = flash.flash_forward_cuda.launches
    qt, kt, vt = (x.transpose(0, 1).contiguous() for x in (q, k, v))
    scale = 1.0 / dim ** 0.5
    o_p, lse_p = flash.flash_forward_reference(qt, kt, vt, True, scale)
    pv_term = flash.P_ROUNDOFF[torch.bfloat16] * flash.pv_rounding_term(
        qt, kt, vt, True, scale, lse_p)
    o = out.transpose(0, 1)
    return dict(launches=launches, o_excess=flash.o_excess(o, o_p, pv_term),
                max_abs_err=(o.float() - o_p.float()).abs().max().item(),
                shape=list(out.shape), dtype=str(out.dtype), device=str(out.device),
                finite=bool(torch.isfinite(out.float()).all()), pid=os.getpid())


def cli_ws_block(seed, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((WS_BLOCK, WS_BLOCK), generator=g, device=device)


def cli_touch(x):
    """The fetched block itself: its bytes come back to be compared."""
    return x


async def http_get(url: str, path: str) -> tuple[int, str, bytes, float]:
    """One GET of ``path`` at ``http://host:port``: status, content type,
    body and the wall in ms (connect to last byte)."""
    host, port = url.removeprefix("http://").rsplit(":", 1)
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection(host, int(port))
    writer.write(f"GET {path} HTTP/1.0\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    ms = 1e3 * (time.perf_counter() - t0)
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode("latin1").split("\r\n")
    ctype = [ln.split(":", 1)[1].strip() for ln in lines[1:] if ln.lower().startswith("content-type")]
    return int(lines[0].split()[1]), ctype[0] if ctype else "", body, ms


def build_info_labels(body: bytes) -> dict:
    (line,) = [ln for ln in body.decode().splitlines() if ln.startswith("dtpu_build_info{")]
    return dict((k, v.strip('"')) for k, v in (kv.split("=", 1) for kv in
                                                line[len("dtpu_build_info{"):line.rindex("}")].split(",")))


async def _cli_cluster(cs, dev):
    """17a and 17b on one ``SubprocessCluster``."""
    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.client.client import Client
    from distributed_tpu_torch.deploy.subprocess import SubprocessCluster
    from distributed_tpu_torch.graph.spec import Graph, TaskRef, TaskSpec

    cl = SubprocessCluster(n_workers=CLI_WORKERS, nthreads=CLI_THREADS, device=dev,
                           scheduler_options={"extra_env": CLI_SCHEDULER_ENV})
    cl.worker_spec[f"worker-{CLI_WORKERS - 1}"]["options"]["nanny"] = True
    out: dict = {}
    t0 = time.perf_counter()
    async with cl:
        out["start_s"] = time.perf_counter() - t0
        async with Client(cl.scheduler_address) as c:
            await c.wait_for_workers(CLI_WORKERS, timeout=CLI_TIMEOUT_S)
            out["up_s"] = time.perf_counter() - t0
            info = await c.scheduler_info()
            out["scheduler"] = cl.scheduler_address
            out["pids"] = [cl.scheduler.process.pid] + [w.process.pid for w in cl.workers.values()]
            # config 1 at full width, its blocks on the card in the worker processes
            g, root, _ = graphs.array_sum_graph(grid=DEP_GRID, block=DEP_BLOCK,
                                                device=_blocks(dev))
            t1 = time.perf_counter()
            futs = c.compute_graph(g, [root])
            out["config1"] = await futs[root].result()
            out["config1_s"] = time.perf_counter() - t1
            out["config1_tasks"] = len(g.tasks)
            del futs
            async def landed():
                # an async plan lands on the scheduler's loop after its
                # planner thread ends, maybe after the tasks
                deadline = time.perf_counter() + CLI_PLAN_WAIT_S
                while True:
                    dl = await c.run_on_scheduler(cs.cli_launches)
                    if not dl["inflight"] or time.perf_counter() > deadline:
                        return dl
                    await asyncio.sleep(0.1)

            # the scheduler process's first plan pays its one-time costs (the
            # card's context on the planner thread, the kernels' library) and
            # can land after most of its tasks ran: a warm-up DAG of its own
            # keys first
            g, keys, _ = cs.cli_dag(TaskSpec, TaskRef, Graph, prefix="warm")
            futs = c.compute_graph(g, keys)
            await c.gather([futs[k] for k in keys])
            del futs
            out["warm_plan"] = (await landed())["placement"]
            # a batch past min-batch: the placement plans it in the scheduler's process
            g, keys, want = cs.cli_dag(TaskSpec, TaskRef, Graph)
            await c.run_on_scheduler(cs.cli_launches, True)
            t1 = time.perf_counter()
            futs = c.compute_graph(g, keys)
            got = await c.gather([futs[k] for k in keys])
            out["dag_s"] = time.perf_counter() - t1
            out["dag_launches"] = await landed()
            out["dag_equal"] = got == want
            del futs, got
            # K2 in a worker process
            t1 = time.perf_counter()
            out["flash"] = await c.submit(cs.cli_flash_task, *CLI_FLASH, 0, _blocks(dev),
                                          pure=False).result()
            out["flash_s"] = time.perf_counter() - t1
            # 17b: the cluster over http
            t1 = time.perf_counter()
            dash = info["dashboard"]
            check(dash and dash.startswith("http://"), f"17b: the scheduler's dashboard is {dash}")
            reads = {}
            wname = str(next(iter(info["workers"].values()))["name"])
            for path in ("/", "/metrics", "/api/v1/workers", "/api/v1/tasks", "/dashboard",
                         f"/workers/{wname}/metrics"):
                status, ctype, body, ms = await http_get(dash, path)
                check(status == 200, f"17b: GET {path} answered {status}: {body[:300]!r}")
                reads[path] = (ctype, body, ms)
            index = json.loads(reads["/"][1])
            check(index["role"] == "scheduler" and {"/metrics", "/ledger", "/dashboard"}
                  <= set(index["routes"]), f"17b: the route index {index}")
            api_workers = json.loads(reads["/api/v1/workers"][1])
            check(len(api_workers) == CLI_WORKERS, f"17b: /api/v1/workers lists {len(api_workers)}")
            tasks = json.loads(reads["/api/v1/tasks"][1])
            check(reads["/dashboard"][0].startswith("text/html") and b"<svg" in reads["/dashboard"][1],
                  "17b: /dashboard is not the page")
            proxied = json.loads(reads[f"/workers/{wname}/metrics"][1])
            check(proxied["status"] == "running", f"17b: the proxy's worker page {proxied}")
            labels = {"scheduler": build_info_labels(reads["/metrics"][1])}
            ports = await c.run(cs.cli_http_port)
            check(len(ports) == CLI_WORKERS, f"17b: {len(ports)} workers told their http port")
            for addr, port in sorted(ports.items()):
                host = addr.split("://", 1)[1].rsplit(":", 1)[0]
                status, ctype, body, ms = await http_get(f"http://{host}:{port}", "/metrics")
                check(status == 200 and b"dtpu_worker_tasks_stored" in body,
                      f"17b: worker {addr}'s /metrics answered {status}")
                labels[addr] = build_info_labels(body)
            scrapes = []
            for _ in range(CLI_SCRAPES):
                status, _, body, ms = await http_get(dash, "/metrics")
                check(status == 200, f"17b: a scrape answered {status}")
                scrapes.append(ms)
            out["http"] = dict(
                routes=len(index["routes"]), api_workers=len(api_workers),
                tasks_by_state=tasks["by_state"], labels=labels,
                read_ms={p: r[2] for p, r in reads.items()},
                metrics_bytes=len(reads["/metrics"][1]),
                scrape_median_ms=statistics.median(scrapes), scrape_max_ms=max(scrapes),
                http_s=time.perf_counter() - t1)
        t1 = time.perf_counter()
    out["close_s"] = time.perf_counter() - t1
    return out


async def _ws_fetches(cs, dev):
    """17c: a scheduler and two workers on ``ws://`` in this process; blocks
    made on one worker are fetched by the other, one at a time."""
    from distributed_tpu_torch.client.client import Client
    from distributed_tpu_torch.scheduler.server import Scheduler
    from distributed_tpu_torch.worker.server import Worker

    device = _blocks(dev)
    async with Scheduler(listen_addr="ws://127.0.0.1:0", device=dev) as s:
        async with Worker(s.address, nthreads=1, listen_addr="ws://127.0.0.1:0") as a, \
                Worker(s.address, nthreads=1, listen_addr="ws://127.0.0.1:0") as b:
            async with Client(s.address) as c:
                made = [c.submit(cs.cli_ws_block, i, device, workers=[a.address])
                        for i in range(WS_FETCHES)]
                await c.gather(made)
                got = []
                with _TransferTimes() as tt:
                    for m in made:  # one block a fetch
                        got.append(await c.submit(cs.cli_touch, m, workers=[b.address]).result())
                addrs = (s.address, a.address, b.address)
    return dict(got=got, seconds=tt.seconds, nbytes=tt.nbytes, addrs=addrs)


def phase_cli(tcp_fetch_ms=None, dev=None):
    """Phase 17, the port's command line, http and ``ws://`` on the card."""
    import chip_smoke as cs  # task functions pickle by name: the nodes import this module

    card = smi_line()
    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(0) if dev is None else "cpu"
    backend = "cuda" if dev is None else "cpu"

    # 17a and 17b
    a = asyncio.run(asyncio.wait_for(_cli_cluster(cs, dev), CLI_TIMEOUT_S))
    want1 = float((DEP_GRID * DEP_BLOCK) ** 2)
    check(a["config1"] == want1, f"17a: config 1's sum {a['config1']} != {want1}")
    check(a["dag_equal"], "17a: the DAG's results differ from the host's")
    dl = a["dag_launches"]
    check(dl["state_device"].startswith(backend), f"17a: the scheduler's state on {dl['state_device']}")
    check(dl["gates"] == {"min_workers": 0, "min_transfer_ratio": 0.0},
          f"17a: the placement did not read {CLI_SCHEDULER_ENV}: its gates {dl['gates']}")
    check(dl["placement"] is not None and dl["placement"]["enabled"]
          and dl["placement"]["plans"] - a["warm_plan"]["plans"] >= 1,
          f"17a: the placement planned nothing for the DAG: {dl['placement']}, after the "
          f"warm-up DAG {a['warm_plan']}")
    k14 = dl["place_wave"] + dl["partition"]
    check(k14 >= 1 or dev is not None, f"17a: K1 and K4 launched {k14} times in the scheduler")
    f = a["flash"]
    check(f["shape"] == [CLI_FLASH[0], CLI_FLASH[1], CLI_FLASH[2]] and f["finite"]
          and f["dtype"] == "torch.bfloat16", f"17a: flash output {f}")
    check(f["device"].startswith(backend) and f["pid"] not in (os.getpid(), a["pids"][0]),
          f"17a: flash ran on {f['device']} in process {f['pid']}")
    check(f["launches"] == 1 or dev is not None, f"17a: K2 launched {f['launches']} times")
    check(f["o_excess"] <= 0.0, f"17a: K2's O off by {f['o_excess']} beyond its tolerance")
    h = a["http"]
    for who, labels in h["labels"].items():
        check(labels["backend"] == backend and labels["device"] == name,
              f"17b: {who}'s dtpu_build_info {labels}")
    print(f"[{card}] 17a SubprocessCluster(n_workers={CLI_WORKERS}, nthreads={CLI_THREADS}) "
          f"from python -m distributed_tpu_torch.cli.* (scheduler on {dl['state_device']}, "
          f"{a['scheduler']}, the last worker under --nanny; started s {a['start_s']:.3f}, all "
          f"workers up s {a['up_s']:.3f}, closed s {a['close_s']:.3f}): config 1 "
          f"({a['config1_tasks']} tasks, blocks on the card in the workers) sum {a['config1']:.0f} "
          f"in s {a['config1_s']:.3f}; random_dag({CLI_DAG}) == the host's in s {a['dag_s']:.3f}, "
          f"after a warm-up one (plan {a['warm_plan']}), plan {dl['placement']}, gates {dl['gates']} from the scheduler's environment "
          f"{CLI_SCHEDULER_ENV}, K1 place_wave {dl['place_wave']} + K4 partition "
          f"{dl['partition']} launches in the scheduler's process; flash_attention in worker "
          f"process {f['pid']} at {CLI_FLASH} bf16 causal: K2 launches {f['launches']}, max abs "
          f"err {f['max_abs_err']:.3g}, o_excess {f['o_excess']:.3g}, task s {a['flash_s']:.3f}")
    print(f"[{card}] 17b http: {h['routes']} routes at /, /metrics {h['metrics_bytes']} B, "
          f"/api/v1/workers {h['api_workers']}, tasks {h['tasks_by_state']}, read ms "
          f"{json.dumps({p: round(v, 3) for p, v in h['read_ms'].items()})}; {len(h['labels'])} "
          f"dtpu_build_info lines with backend={backend} device={name}; scrape of /metrics median "
          f"ms {h['scrape_median_ms']:.3f} (max {h['scrape_max_ms']:.3f}, {CLI_SCRAPES} scrapes); "
          f"17b s {h['http_s']:.3f}")

    # 17c
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    c = asyncio.run(asyncio.wait_for(_ws_fetches(cs, dev), CLI_TIMEOUT_S))
    ws_s = time.perf_counter() - t0
    check(all(x.startswith("ws://") for x in c["addrs"]), f"17c: addresses {c['addrs']}")
    for i, got in enumerate(c["got"]):
        check(got.device.type == backend and _same_bytes(got, cli_ws_block(i, _blocks(dev))),
              f"17c: block {i} came back on {got.device} or differs")
    check(len(c["seconds"]) >= 1, "17c: no worker fetched a block from the other")
    ws_ms = 1e3 * statistics.median(c["seconds"])
    print(f"[{card}] 17c ws://: {WS_FETCHES} blocks of {WS_BLOCK} x {WS_BLOCK} f32 on the card "
          f"fetched between two workers over ws:// ({len(c['seconds'])} fetches of {c['nbytes']} "
          f"B), each equal bit for bit; fetch median ms {ws_ms:.3f}, beside phase 14b's over tcp "
          f"{tcp_fetch_ms if tcp_fetch_ms is None else round(tcp_fetch_ms, 3)}; 17c s {ws_s:.3f}")
    launches = {"place_wave": dl["place_wave"], "partition": dl["partition"],
                "flash_fwd": f["launches"]}
    numbers = dict(start_s=a["start_s"], up_s=a["up_s"], close_s=a["close_s"],
                   config1_s=a["config1_s"], config1_sum=a["config1"], dag_s=a["dag_s"],
                   dag_plan=dl["placement"], warm_plan=a["warm_plan"], flash=f,
                   flash_task_s=a["flash_s"],
                   http=h, ws_fetch_median_ms=ws_ms, ws_fetches=len(c["seconds"]),
                   ws_s=ws_s, tcp_fetch_median_ms=tcp_fetch_ms, launches=launches)
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 17 cli s {numbers['phase_s']:.1f}")
    return launches, numbers


# ------------------------------------------------------------ phase 18


LINT_TIMEOUT_S = 300


def start_lint():
    """Phase 18's lint started now, in a child process beside the card
    phases (it is host work on one core): a future of the finished
    process and its wall."""
    root = Path(__file__).resolve().parent

    def run():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "distributed_tpu_torch.analysis", "--format", "json",
             "--verbose", "--root", str(root)],
            cwd=root, capture_output=True, text=True, timeout=LINT_TIMEOUT_S)
        return proc, time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run)
    pool.shutdown(wait=False)
    return future


def phase_lint(lint=None):
    """Phase 18, graft-lint for the port over the tree as shipped:
    ``python -m distributed_tpu_torch.analysis --format json`` in a child
    process (``lint``, from :func:`start_lint`, or started here).  A
    finding, an error, a stale baseline entry or a nonzero exit fails the
    script."""
    from distributed_tpu_torch.analysis.config import LintConfig
    from distributed_tpu_torch.analysis.core import _match_scope

    card = smi_line()
    root = Path(__file__).resolve().parent
    proc, wall = (lint or start_lint()).result()
    check(proc.returncode == 0, f"18: graft-lint exited {proc.returncode}:\n{proc.stdout[-4000:]}"
          f"\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout)
    check(report["findings"] == [] and report["errors"] == [] and report["stale_baseline"] == [],
          f"18: graft-lint findings {report['findings']}, errors {report['errors']}, stale "
          f"baseline entries {report['stale_baseline']}")
    rules = [ln.split()[2].rstrip(":") for ln in proc.stderr.splitlines()
             if ln.startswith("# rule ")]
    excluded = LintConfig.load(root).exclude_files
    files = [p for p in root.glob("distributed_tpu_torch/**/*.py")
             if not _match_scope(p.relative_to(root).as_posix(), excluded)]
    print(f"[{card}] 18 graft-lint (python -m distributed_tpu_torch.analysis, Python "
          f"{sys.version.split()[0]}): {len(rules)} rules {rules}; {len(files)} files parsed; "
          f"{len(report['findings'])} findings, {report['suppressed']} suppressed by pragma or "
          f"baseline, {len(report['errors'])} errors, {len(report['stale_baseline'])} stale "
          f"baseline entries; wall s {wall:.3f}")
    return dict(rules=rules, files=len(files), findings=len(report["findings"]),
                suppressed=report["suppressed"], wall_s=wall)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import distributed_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: distributed_tpu_torch not found; run from the "
              "repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    walls: dict[str, float] = {}

    def phase(label, fn, *args):
        """Run one phase and print its wall."""
        t = time.perf_counter()
        out = fn(*args)
        walls[label] = round(time.perf_counter() - t, 1)
        print(f"phase {label} wall s {walls[label]}")
        return out

    phase("0", phase_env)
    k3_ptxas, periodic_ptxas_info = phase("1", phase_build)
    # phase 18's lint runs from now on beside the card phases
    lint_run = start_lint()
    flash_entry = phase("2", phase_flash)
    bwd_entry = phase("2b", phase_flash_bwd, flash_entry, k3_ptxas)
    phase("2c", phase_flash_head_dims, flash_entry, bwd_entry)
    wave_entry, oneshot = phase("3", phase_placement)
    hints_1m = phase("4", phase_streamed, wave_entry, oneshot)
    partition_entry = phase("5", phase_partition, wave_entry, hints_1m)
    periodic_entries = phase("6", phase_periodic, periodic_ptxas_info)
    shard_entry, mirror_shard_entry = phase("7", phase_sharded, oneshot,
                                            periodic_ptxas_info.get("place_shard.cu"))
    shuffle_entry = phase("8", phase_data_plane, periodic_ptxas_info.get("shuffle_bucket.cu"))
    long_context = phase("8 long context", phase_long_context)
    training, k2_training, k3_training = phase("9", phase_long_context_training)
    flash_entry["launches_long_context_training"] = k2_training
    bwd_entry["launches_long_context_training"] = k3_training
    round1 = phase("10", phase_round1)
    periphery, periphery_ms = phase("11", phase_periphery)
    for e in (flash_entry, wave_entry, shard_entry, shuffle_entry):
        e["launches"] += periphery[e["name"]]
        e["launches_periphery"] = periphery[e["name"]]
    flash_entry["periphery_ms"] = periphery_ms
    # phase 13's CPU run starts now, beside phase 12's card runs and its own
    recovery_twin = start_recovery_twin()
    try:
        control, control_numbers = phase("12", phase_control_plane)
        recovery, recovery_numbers = phase("13", phase_recovery, recovery_twin)
    finally:
        if recovery_twin.poll() is None:
            recovery_twin.kill()
            recovery_twin.communicate()
    for e in (wave_entry, partition_entry, *periodic_entries):
        if e["name"] in control:
            e["launches"] += control[e["name"]]
            e["launches_control_plane"] = control[e["name"]]
            if e["name"] in control_numbers["sim_event_ms"]:
                e["control_plane_ms"] = control_numbers["sim_event_ms"][e["name"]]
    wave_entry["control_plane_ms"] = control_numbers["update_graph_k1_ms"]
    for e in periodic_entries:
        if e["name"] in recovery:
            e["launches"] += recovery[e["name"]]
            e["launches_recovery"] = recovery[e["name"]]
    # phase 15's CPU run starts now, beside phase 14's card runs and its twin
    deploy_twin = start_deploy_twin()
    try:
        servers, servers_numbers = phase("14", phase_servers)
        deploy, deploy_numbers = phase("15", phase_deploy, deploy_twin)
    finally:
        if deploy_twin.poll() is None:
            deploy_twin.kill()
            deploy_twin.wait()
    for e in (wave_entry, partition_entry, *periodic_entries):
        if e["name"] in servers:
            e["launches"] += servers[e["name"]]
            e["launches_servers"] = servers[e["name"]]
    for e in (wave_entry, partition_entry, *periodic_entries):
        if e["name"] in deploy:
            e["launches"] += deploy[e["name"]]
            e["launches_deploy"] = deploy[e["name"]]
    shuffle, shuffle_numbers = phase("16", phase_shuffle)
    for e in (wave_entry, partition_entry, *periodic_entries):
        if e["name"] in shuffle:
            e["launches"] += shuffle[e["name"]]
            e["launches_shuffle"] = shuffle[e["name"]]
    shuffle_entry["launches"] += shuffle["shuffle_bucket"]
    shuffle_entry["launches_shuffle_ext"] = shuffle["shuffle_bucket"]
    cli, cli_numbers = phase("17", phase_cli, servers_numbers["wire_transfer_median_ms"])
    for e in (flash_entry, wave_entry, partition_entry):
        e["launches"] += cli[e["name"]]
        e["launches_cli"] = cli[e["name"]]
    print(json.dumps({"control_plane": control_numbers}))
    print(json.dumps({"recovery": recovery_numbers}))
    print(json.dumps({"servers": servers_numbers}))
    print(json.dumps({"deploy": deploy_numbers}))
    print(json.dumps({"shuffle": shuffle_numbers}))
    lint = phase("18", phase_lint, lint_run)
    print(json.dumps({"cli": cli_numbers}, default=str))
    print(json.dumps({"lint": lint}))
    print(json.dumps({"phase_s": walls}))
    kernels = [flash_entry, bwd_entry, wave_entry, partition_entry, *periodic_entries, shard_entry,
               mirror_shard_entry, shuffle_entry, *long_context, *training, *round1]
    print(f"total_s {time.perf_counter() - t0:.1f}")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
