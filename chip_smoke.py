"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. build the CUDA sources of ``rabia_tpu_torch/csrc`` with nvcc (sm_90a),
   one nvcc per source, started together, while g++ builds the native
   host plane of ``rabia_tpu_torch/native`` (transport, codec, host
   kernel, state kernel, runtime, WAL kernel, session kernel; one g++ a
   source): the fused-window kernels
   (replica-major and [T,S,R]), the kv-window kernel (windows that write
   a table in the row form, and in the dictionary form on tables wider
   than 64 slots, with and without the folded decision), the kv-dict
   kernel (dictionary windows that write a table of at most 64 slots:
   the waves on the dictionary's key classes), the kv-read kernel
   (windows that only read: the probe, and the GET window with its
   decision), the mesh-window kernel, the packed-window kernel and its
   packers, the round kernels (the scanned weak-MVC protocol: n rounds a
   launch, one lane a receiver for R <= 8, the slot pipeline's
   full-delivery rule, and start_slot) and the node kernel (one node's
   weak-MVC tick: start the opened slots, then K chained steps);
2. hold both fused-window kernels against their plain PyTorch versions,
   bit for bit, on random votes over all four codes: R in
   {1,3,4,5,7,8}, S in {17,1000,4096}, odd T, a view that starts one
   byte into a buffer, with and without the phase plane;
2b. hold the mesh-window kernel (``slot_window`` / ``slot_pipeline``)
   against the plain loop over ``phase_step``, bit for bit: R in
   {1,3,4,5,7,64}, ragged S, T in {1,16}, max_phases in {1,4,8}, coin_p1
   in {0,0.5,1}, votes over all four codes, crash masks with a
   quorum-less shard, per-shard bases near 2^31-1 (``base + t`` wraps);
2c. hold the packed-window kernel against the plain packed window, bit
   for bit: R in {1,3,4,5,7,8}, every quorum from 0 to R+1, S in
   {17,1000,4096} (ragged pad lanes decide ABSENT), odd T, random codes
   over all four values, crash masks, a view one word into a buffer;
2d. hold the round kernels against the plain round, every field of the
   state after every launch: R in 1..8 and 64 (S in {17,1000,4096}; R 2
   and 6 at S=1000),
   coin_p1 in {0,0.5,1}; ``run_rounds`` chains of 1, 2, 7 and 80 rounds
   at p_deliver 1.0, 0.6 and 0.3 with a static partition on some, crash
   masks with a quorum-less shard, inactive shards, slots near 2^31-1,
   from a state taken mid-protocol; one ``round_step`` under an explicit
   mask, also in place; ``slot_pipeline`` and ``slot_pipeline_wide`` at
   0 to 6 rounds a slot with slots that wrap past 2^31-1, and for every R
   from 1 to 64 (one launch a call, S=33); then the
   port's ``WeakMVCOracle`` on four shards of one lossy trace, one launch
   a step;
3. hold the scanned protocol (``ClusterKernel.slot_pipeline``, the round
   kernel) against the fused entry on the card (S=4096, R=5, T=64,
   random votes, crash mask);
4. the decision core at full width (S=4096, R=5, T=32768 replica-major
   votes): a timed chain of launches over two buffers, every decision
   checked on the device, beside the plain closed form, and the packed
   window (the packed-window kernel) checked against it and timed
   beside the plain packed window; the scanned protocol at bench.py's
   depth (T=8192) through ``slot_pipeline`` held against
   ``slot_pipeline_fused`` and timed (the plain loop at T=64), then held
   bit for bit against ``slot_pipeline_wide_plain`` at 2 and at 4 rounds
   a slot (4 reaches the coin) and timed at both; the
   selftest's fault path at full width (replicas [dead, up, up, dead,
   up], 80 rounds at p_deliver=0.6: every shard decides, the state
   equals the plain loop's), its one launch timed beside an empty
   kernel; the packed window at bench.py's packed depth (T=393216, 2.0
   GB of unanimous-V1 words), every decision checked against the V1
   row. The packers (``pack_codes``, ``unpack_codes``, ``pack_alive``,
   and ``pack_inputs``: a window's votes and alive plane in one launch)
   and ``ClusterKernel.start_slot`` run their kernels on this path, and
   their launches count here (phase 16 (c) times them);
5. the serving lane at full width: ``MeshEngine`` over 4096 shards x 5
   replicas — SET/GET on every shard, replica snapshots, decision logs,
   minority and majority crashes, heal, checkpoint/restore; each window
   one ``mw_window`` launch on the engine's pinned staging buffer, and a
   wave under the profiler one launch a window and no copy;
6. hold the kv-window kernel against its plain PyTorch version, bit for
   bit: random tables and ops over all four kinds, full shards, versions
   near the wrap, S in {17, 1000, 4096}, P in {1, 7, 64}, key and value
   widths of 8 and 16 words and odd ones (3 and 5, 4 and 7), op widths
   below the table's, W in {1, 16}, and wider tables and longer windows
   (P of 130 and 200, W of 40 and 70); every output plane and the
   untouched input table are compared; on the same keys the kv-read
   kernel (a read of every non-empty key, no output table), and the
   wrapper refuses a window with no table that writes. Then both kernels
   with the window's decision folded in, against the plain composition
   (mesh window, wave scan, flags): SET (no kind plane), mixed and GET
   windows, crash masks with quorum-less and all-dead shards, bases near
   2^31-1, depth in {0,1,W}, max_phases in {0,1,4}, W in {1,16,40,70},
   the mixed windows also with their reads gathered to their GET waves
   (``mixed_apply``'s meta and gval rows), every output plane, the flags
   and the untouched input table;
7. the device-resident KV lane at full width: a ``device_store=True``
   engine beside a host-lane engine (``VectorShardedKV`` replicas) over
   4096 shards x 5 replicas, window 16, 64-slot tables (32 B keys, 64 B
   values): 64 SET waves fill every slot, then 8 GET waves, 8 mixed
   SET/GET/DEL/EXISTS waves, an overflow (dirty -> rollback -> demote),
   clean waves until re-promotion, a majority crash (stall, demote) and
   heal; every response frame, the slot counters, the decision logs and
   all replica stores are compared with the host engine's;
8. the dictionary form and the read lane: before the main path, the
   write kernels on dictionary-form ops (the kv-dict kernel for P <= 64,
   the kv-window kernel's wide path for P = 130; the plain window, and
   with the decision SET, mixed, mixed with gathered reads and lookup
   windows) and the read-only probe in both forms, against their plain
   versions (ragged S, P in {7, 64, 130}, D in {1, 2, 17, 32}, rows
   that share a key, ranks past D, W in {1, 16, 40, 64, 256}); on the
   main path, ``decide_apply``, ``lookup_window``, ``mixed_apply`` and
   ``lookup_only`` in the row and the dictionary form on phase 7's table
   (one launch of their form each, no mesh launch, one host-to-device
   upload), and a
   ``device_read_lane=True`` engine beside a device-lane engine without
   it and a host-lane engine at 4096 shards x 5 replicas: phase 7's fill,
   then groups of 9 GET blocks and 1 SET block, flushed, under a uniform
   and a Zipf(1.2) key stream; reads take no slot and every response
   equals the read-lane-off engine's (the first group's first 3 GET
   blocks and its SET block also the host lane's). After the main path, the kv-read kernel on
   phase 7's table: the probe and the GET window, row and dictionary
   form, on phase 7's keys and on Zipf(1.2) keys, every wave and the
   flags against the plain versions. Then the dictionary SET window
   (fill and Zipf streams) beside the row form, and the probe beside the
   GET window (both forms) and an empty kernel at its grid, are timed by
   graph replay, and the packers' host time and upload bytes are
   measured;
9. the latency governor's window ladder and the governed device lane:
   (a) on phase 7's table, at every window size of the governor's ladder
   W in {1, 2, 4, ..., 256}, ``decide_apply`` (the SET window with its
   decision), ``mixed_apply``, ``lookup_window`` (the GET window) and
   ``lookup_only`` (the probe), each in the row and the dictionary form
   and each one launch through the table's entry point, and
   ``slot_window`` at T=W, every output byte against the plain version;
   after the main path each kernel is timed there by graph replay beside
   the bytes its function must move at that W (the dictionary form's
   write windows also beside their least integer operations); (b) phase
   7's SET lane on
   fresh engines with the C pack gather (``csrc/host_pack.cpp``, built
   with g++) and under ``RABIA_PY_DEVPACK=1`` (numpy), in turns, equal
   responses and tables, and the packers' host ms at W=16 and at the
   largest window (c) reached, the two gathers' planes byte-identical;
   (c) ``MeshEngine(device_store=True, latency_target_ms=...)`` at 4096
   shards x 5 replicas under a saturating full-width SET stream and a
   90/10 GET/SET stream, with a loose target (it must resize the window;
   every response, the slot counters and the stores equal an ungoverned
   host block-lane engine's, and on the 90/10 stream an ungoverned
   device lane's) and a tight one (it must park at ``min_window`` with
   ``governor_stats()["unachievable"]`` and the floor reported); the
   governed lane's ladder is capped at ``GOV_MAX_WINDOW`` to keep the
   run's time, while (a) runs the whole ladder. The C gather must have
   packed every window of the main path (``pack_stats``; their counts
   are printed on a line of their own);
10. the transport engine beside the device plane, after the main path
   with its own counts (reset just before, read just after; its
   mesh-window launches join that kernel's count): (a) the port's
   plane-conformance gate (``run_schedule_on_both_planes``) at
   BASELINE.json config 3's shape, 4096 shards x 5 replicas, 3 waves of a
   batch of 4 SETs on every shard, through a cluster of the port's
   ``RabiaEngine`` (the native tick and codec, the asyncio
   orchestration, in-memory hub, ``InMemoryStateMachine`` replicas)
   and through a ``MeshEngine`` on the card: per-shard decisions,
   futures and replica state must be equal; it prints the transport
   cluster's decisions/s, p50/p99 submit-to-settle latency, each wave's
   and the whole wall time beside the card and the host CPU; (b) the same
   gate at config 2's shape, 64 shards x 3 replicas, 8 waves; (c)
   ``MeshEngine.save_to`` / ``load_from`` through
   ``FileSystemPersistence`` of (a)'s engine into a fresh one on the card
   (slot counters and stores equal, and a further wave decides the same
   slots and batches on both), and a transport replica shut down and
   restarted from its persistence layer, after which a further wave
   commits on every replica.

The launch counts of the kernels (the kv-window, kv-dict and kv-read
kernels' by form, the round kernels', packers' and node kernel's by
entry) are reset just before
phases 4-5, 7, 8 and 9
(the main path) and read just after; phase 4 drives both
fused-window entries (replica-major at full depth, and
``ClusterKernel.slot_pipeline_fused`` on [T,S,R] votes at full depth and
at ``__graft_entry__``'s T=8 beside ``slot_pipeline``), the packed
window and its three packers, and the round-kernel entries
(``slot_pipeline``, ``run_rounds`` and ``start_slot``). After it, phase 7
checks that one ``decide_apply`` and ``mixed_apply`` each launch the
kv-window kernel (rows) or the kv-dict kernel (dictionary) once,
``lookup_window`` and ``lookup_only`` the kv-read kernel once, and none
the mesh-window kernel, each after one upload, and the kernels are timed:
the fault path's one launch also with one mask for every round and with
none, beside an empty kernel, and its bound counted over the rounds each
shard runs before it settles. The last lines are a ``{"kernels": ...}``
JSON line, the card's name and power limit as nvidia-smi reports them,
and ``{"ok": true, "device": {...}}``. Exits non-zero without a GPU.

Phase 11 (after phase 10, with its own counts) drives the apps over the
engine at ``BASELINE.json`` configs 1-4, each on a transport cluster
(host code) beside a ``MeshEngine`` on the card fed the same commands:
(a) counter_smr, 3 replicas x 1 shard; (b) kvstore_smr, 3 x 64, through
``ShardedKVService`` with its block lane; (c) kvstore_smr, 5 x 4096 with
adaptive batching, beside the device KV lane (``kv_dict.cu``); (d)
banking_smr, 7 x 1024 on the fault-injection harness with 3 replicas
crashed. It prints one line a part (decisions/s, commands/s, p50/p99
submit-to-settle, (c)'s batch statistics and V0 openings, (d)'s commits
after the crash, the host CPU and the card), then its launches.

Phase 12 (after phase 11, with its own counts) runs ``BASELINE.json``
config 5 and the reference sweep's config 6 over TCP on 127.0.0.1 on the
card's host, beside the card: (a) kvstore (``VectorShardedKV``), 16384
shards x 5 replicas, Zipf(1.2) keys, the reference sweep's block pump for
8 s (the native tick and codec must run, the runtime declines a store
that is not native); (b) kvstore_smr on the native store, 4096 x 5, one
SET a shard a slot, on the GIL-free runtime (runtime, tick and apply
native, ``waves_native`` growing, ``gil_handoffs`` flat) and then on the
asyncio owner (``RABIA_PY_RUNTIME=1``). Each part's replicas must agree,
and a ``MeshEngine(device_store=True)`` on the card fed each shard's
committed SETs must hold the replicas' table. It prints decisions/s,
commands/s, p50/p99 submit-to-settle, V0 openings by reason, each
replica's planes, the runtime's counters and the launches by kernel with
their device ms.

Phase 13 (after phase 12, with its own counts) runs the durability plane
and the gateway at config 3's width, 4096 shards x 5 replicas, over TCP on
the card's host, beside the card: (a) ``GatewayCluster(5, 4096,
persistence="wal")`` (the WAL in a temporary directory, group-commit
fsync; every replica's runtime, tick, codec, store and WAL native), 64
``RabiaClient`` sessions, 2 waves of one SET on every shard (cut from 4:
the depth, to keep the script inside its time; 32-byte keys, 64-byte
values, one writer a key), the replay of every (client,
seq) answered from the session cache with no new slot, then every key
read by ReadIndex through a gateway whose reader is
``devkv_read_handler`` over a ``MeshEngine(device_store=True)`` on the
card fed every committed SET (one ``kv_read`` launch a probe round) and
through a gateway over a replica's native store: byte-equal answers,
equal to the last acknowledged write; (b) ``RecoveryHarness(5, 4096)``,
five replica processes on ``WalPersistence``, 2000 keys preloaded,
replica 1 killed by SIGKILL under load and restarted; every
acknowledged write reads back through its gateway and equals the answer
of ``devkv_read_handler(...).read_many`` over a ``MeshEngine`` on the
card fed the acknowledged writes. It prints acknowledged durable
writes/s, submit-to-ack and read p50/p99, the WAL's fsyncs, bytes and
records a fsync with its filesystem, the durable LSN, the probe rounds
and the ``kv_read`` device ms by CUDA events, the ratio of (a)'s
writes/s to phase 12 (b)'s runtime decisions/s, and (b)'s restore, WAL
replay, torn tail, rejoin-under-load and post-rejoin goodput. While (a)'s
writes run, the gateways' slow Submits are decomposed into critical-path
segments (``obs/critpath``: gateway queue, coalesce park, propose to
open, consensus phases, decide to apply, fsync barrier, result fanout,
unattributed), printed beside the runtime's stage clocks (RTS).

Phase 14 (after phase 13, with its own counts) runs a routed fleet at
config 3's width over phase 13's durable cluster: ``FleetHarness(3, 5,
4096, persistence="wal")``, 64 ``FleetSession`` clients through one
``FleetConnPool``, one wave of one SET a shard; a third of the way in
the ring drops a member (``rebalance``, sessions handed off, clients
follow MOVED), at two thirds gateway 0 is killed (``kill_gateway``; its
clients fail over to the ring's successor with the same seq). Every (client, seq) is replayed through the fleet (CACHED,
the original bytes, no new slot); the committed SETs feed a
``MeshEngine(device_store=True)`` on the card, the fleet gateways' reads
go to a replica gateway whose reader is ``devkv_read_handler`` over it,
and every key read by ReadIndex through the fleet equals a replica's
native store and the last acknowledged write. It prints the acknowledged
writes/s through the fleet, submit-to-ack p50/p99, MOVED redirects,
failovers and ledger records, the ``kv_read`` launches with their device
ms by CUDA events and the probe's by graph replay, the fleet aggregator's
table (``obs/fleet_obs``) and the critical path of the fleet's slow
Submits.

Phase 15 (after phase 14, with its own counts) runs the chaos smoke set's
profile that uses the card (``chaos.smoke_profiles()``'s
``mesh_device_read_lane``) at 4096 shards x 5 replicas with its engine on
the card, its events, rate and time scale as the reference defines them;
its pass, availability and problems are printed and checked (its verify:
probe reads, no lockstep divergence, the forced demotion). Then the mesh
fabric at that width is demoted (``demote_device``) and driven until its
device lane re-promotes, with probe reads after it and its verify sweep.
The set's six host-only profiles (simulator, real-TCP, membership,
coalescing, routed-fleet, shard-group) run in the CPU tests
(tests/test_torch_chaos.py) and through scripts/torch_chaos_probe.py.

Phase 16 (after phase 15) puts the transport engine's node kernel on the
card and runs the command line: (b) the node kernel
(``csrc/node_kernel.cu``: ``NodeKernel.node_cycle``, ``node_step`` and
``start_slots``, one launch each, reading the tick's planes from the
kernel's pinned plane buffer and writing the mirrored state and the
outbox into its pinned host image, both mapped) against
``node_cycle_plain`` bit for bit, every state field and outbox plane and
the fetched image's views, for R in {1, 3, 4, 5, 7, 8, 64}, S in {17,
1000, 4096}, K in {0, 1, 3, 8}, coin_p1 in {0, 0.5, 1}, states over all
four codes with slots and phases near 2^31-1, partial inboxes, adopted
decisions, inactive and done shards, on host arrays and on the kernel's
own plane views (the engine's way), and a ``node_cycle`` against
``start_slots`` and K ``node_step`` launches;
(c) the packer kernels (``pack_inputs`` too) against their plain
versions (R in {1, 5, 8}, ragged S, views one byte and one word into a
buffer), and ``start_slot`` (16 bytes a thread over each field's plane)
against ``start_slot_plain``: masks none, all and random, S in {17,
1000, 4095}, R in {1, 5, 8, 9}, out of place, in place and on buffers
one byte in, and 20 shard blocks in one call (two launches of its
table).
Then, on its own counts: (a) ``python -m rabia_tpu_torch`` and ``python
-m rabia_tpu_torch --selftest`` as processes on the card, each exiting
0, their lines printed; (d) the plane-conformance gate at config 3's
shape (4096 shards x 5 replicas, 3 waves of 4 SETs a shard) with the
transport engines on ``backend="jax"`` (their ``NodeKernel`` on the
card, one ``node_cycle`` launch on mapped memory and one event a tick),
with ``zero_copy_inbox`` off and on, each beside a ``MeshEngine``:
decisions, futures and replica state equal, one launch a tick, and
under the profiler (around the transport waves) one kernel launch a tick
and no copy or pinned allocation, and a tick's bytes over the link its
planes and host image; it prints decisions/s and p50/p99 submit-to-settle beside phase
10 (a)'s host kernel, ticks and launches, bytes, and a tick's upload,
launch and fetch spans by CUDA events (each holds host code too, so none
is a device time). After the timings of phase 4, the packers (T=32768;
``pack_inputs`` beside ``pack_codes``) and ``start_slot`` (S=4096 R=5)
are timed kernel and plain by graph replay beside an empty kernel (for
``start_slot`` one at its own grid and table, in the same turns) and
their bytes bounds; one engine tick's
``node_cycle`` at 4096 x 5 with K=3 and the engine's window
(``mw_window`` at T=16 on its pinned staging buffer) each alone by graph
replay beside an empty kernel at its grid, and each round trip by the
host clock around a chain (one launch and one event, no copy under the
profiler), beside their bounds over the link (pinned copies of their
bytes) and in device memory.

Phase 17 (after phase 16) runs the device mesh on the card, which serves
as every device of a logical mesh and as the device of one rank and of
two: (b) before the counts, ``slot_window`` at S=4096 R=5 T=16 on logical
meshes of 4x1, 1x5 and 4x5 (votes over all four codes, crash masks with
a quorum-less shard, bases near 2^31-1, 4 phases, so the coin is
reached) bit for bit against the one-device ``mw_window`` and the plain
loop, one launch a shard block, and ``phase_step`` over 4x5 against one
device's. Then, on its own counts: (a) ``MeshEngine(mesh=make_mesh())``
(1x1 on the card) beside ``MeshEngine()`` on a part of phase 5's
workload (SET and GET on every shard, a minority crash with SETs, heal,
GETs), decisions, futures and replica snapshots equal, and the 4x5
mesh's engine equal to them; (c) ``ShardedClusterKernel(4096, 5, 4x1)``:
``slot_pipeline`` at T=64 with 4 rounds a slot and the fault path's
``run_rounds``, bit for bit ``ClusterKernel``'s, and ``start_slot`` one
launch for the mesh's four shard blocks (``CLUSTER_ROUND.counts`` and,
under the profiler, one ``cudaLaunchKernel`` a call); (d) the multi-controller
engine, one rank on an NCCL group and two ranks sharing the card on a
gloo group (NCCL takes one card a rank), each a process running (a)'s
submissions through ``_run_window_multihost``, every rank equal to (a).
It prints each mesh shape's window time and the exchange's alone by CUDA
events, and mw_window launches a window, beside the card's name and
power limit. No time across cards exists here: one card stands in for
every device.

Phase 18 (after phase 17) runs the device KV lane and its read lane over
logical meshes of the card at config 3's width, 4096 shards x 5
replicas, on its own counts: (a) ``DeviceKVTable`` in shard blocks on the
4x1, 1x5 and 4x5 meshes against the one-device table on the same inputs
(four SET windows that fill every slot, two in the row form and two in
the dictionary form, a GET window, a mixed window and a probe, with a
replica down and bases near 2^31-1): flags, reads, gathered rows and
``dump()`` equal, and each window one kv launch a shard block and one
upload a block; (b) phase 7's device-lane stream on a
``MeshEngine(device_store=True)`` over the 4x1 mesh (SET, GET and mixed
windows, the overflow's demotion, re-promotion, a majority crash), every
response, the slot counters, the decision logs and every replica store
equal to what phase 7's host lane answered (recorded there, so the host
lane does not run again), then phase 8's read-lane stream on the same
mesh, equal to phase 8's with zero slots for probe reads; (c) the
dictionary SET window and the probe on the one-device table and the 4x1
table by CUDA events around a chain, host issue included, in turns.

Phase 19 (after phase 18) runs the README's device examples on the card
in process, on their own counts: ``examples/torch_device_kv_lane.py``,
``torch_mesh_engine_demo.py`` and ``torch_performance_benchmark.py``'s
``main`` at the reference examples' sizes (16 x 5, 8 x 5, 1024 x 5 x 32),
each card run's lines equal to the same ``main``'s on the CPU line for
line (the lines that print a time or rate excepted, named in
``P19_TIMED``), then the first two at config 3's width, 4096 x 5, where
the examples' own checks hold (every replica the same value and version,
the lane active after the heal). A profiler witness around the card runs
counts ``cudaLaunchKernel`` records and the device records of the kv,
mesh-window and slot-pipeline kernels (an empty trace fails).

Phase 20 (after phase 19) runs the port's conformance fuzz and chaos
soak on the card, on their own counts: (a)
``scripts/torch_fuzz_conformance.py``'s stepwise and fused trials for
``P20_FUZZ_S`` seconds after a warm-up, over the reference's geometry
pool and config 3's width, 4096 x 5 (each round the round kernel
against ``round_step_plain`` on every shard and the scalar oracle on
``oracle_sample``'s shards; the closed form, both fused entries, against
the scanned slot pipeline), its mesh trials over the reference's mesh
pool and 4096 x 5 on logical 4x1 and 4x5 meshes of the card, and one
planes trial; (b) ``scripts/torch_soak.py``'s device legs at 4096 x 5,
``--plane mesh --device-store`` and the transport soak on
``backend="jax"``, each with its own gates. It checks that every trial
passed (a divergence raises with its seed), that (a) launched
``fused_window`` (both entries), ``cr_rounds``, ``cr_start_slot``,
``cr_slot_pipeline`` and ``mw_window``, that (b) launched a kv write
kernel, ``kv_read``, ``mw_window`` and ``node_cycle``, and that the
device lane re-promoted at least once.

Phase 17 runs on the CPU over logical meshes of up to 8 blocks and over
gloo ranks in tests/test_torch_parallel.py, test_torch_mesh_engine_mesh.py
and test_torch_dcn.py; phase 18 at 64 shards on logical CPU meshes in
tests/test_torch_slice.py.

Phase 16 runs on the CPU at small sizes in tests/test_torch_node_kernel.py,
test_torch_engine_device.py (the gate at config 2's shape on the device
backend), test_torch_zero_copy.py, test_torch_packers.py and
test_torch_cli.py. Phases 3-5, 7, 8 and 9's lanes also run on the CPU at a small size
(tests/test_torch_slice.py), phase 10 at config 2's shape
(tests/test_torch_engine_conformance.py), phase 11 at a small size
(tests/test_torch_apps_engine.py), phase 12 at a small size
(tests/test_torch_native_conformance.py), phase 13 (a) at 3 x 8
(tests/test_torch_gateway.py), phase 14 at 3 fleet gateways over 3 x 32
(tests/test_torch_fleet.py), and phase 15's smoke profiles and lane cycle
(tests/test_torch_chaos.py; the mesh profile and the lane cycle at a
small size, tests/test_torch_fleet.py).
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import time

from typing import Optional

import numpy as np
import torch

from rabia_tpu_torch import ClusterKernel, MeshEngine, MeshPhaseKernel
from rabia_tpu_torch.apps.banking import BankCommand, BankingSMR, BankOp
from rabia_tpu_torch.apps.counter import CounterCommand, CounterSMR
from rabia_tpu_torch.apps.device_kv import HOST_PACK, DeviceDictOps, DeviceKVTable
from rabia_tpu_torch.apps.kvstore import (
    KVOperation,
    KVStoreSMR,
    decode_kv_response,
    decode_result_bin,
    encode_op_bin,
    encode_set_bin,
    shard_for_key,
)
from rabia_tpu_torch.apps.sharded import ShardedKVService, ShardedStateMachine, make_sharded_kv
from rabia_tpu_torch.apps.vector_kv import VectorKVStore, VectorShardedKV
from rabia_tpu_torch.chaos import run_profile, smoke_profiles
from rabia_tpu_torch.chaos.runner import _MeshFabric
from rabia_tpu_torch.core.blocks import build_block
from rabia_tpu_torch.core.errors import RabiaError
from rabia_tpu_torch.core.messages import ResultStatus, Submit
from rabia_tpu_torch.core.config import BatchConfig, RabiaConfig, TcpNetworkConfig
from rabia_tpu_torch.core.network import ClusterConfig
from rabia_tpu_torch.core.oracle import WeakMVCOracle
from rabia_tpu_torch.core.persistence import PersistedEngineState
from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
from rabia_tpu_torch.core.smr import SMRBridge
from rabia_tpu_torch.core.types import ABSENT, V0, V1, Command, CommandBatch, NodeId, quorum_size
from rabia_tpu_torch.engine import RabiaEngine
from rabia_tpu_torch.engine.leader import slot_proposer_vec
from rabia_tpu_torch.fleet.gateway_proc import _UpstreamLink
from rabia_tpu_torch.fleet.harness import FleetConnPool, FleetHarness, FleetSession
from rabia_tpu_torch.gateway import (
    GatewayConfig,
    GatewayServer,
    RabiaClient,
    devkv_read_handler,
)
from rabia_tpu_torch.kernel import (
    cluster_round,
    cuda_build,
    fused_window,
    kv_window,
    mesh_window,
    node_kernel,
    packed_window,
)
from rabia_tpu_torch.kernel.phase_driver import coin_threshold, device_coin
from rabia_tpu_torch.native import build as native_build
from rabia_tpu_torch.net import InMemoryHub, TcpNetwork
from rabia_tpu_torch.parallel import MeshArray, ShardedClusterKernel, make_mesh
from rabia_tpu_torch.obs.critpath import (
    CritpathAggregator,
    decompose,
    dominant_segment,
    inprocess_exemplar_timeline,
)
from rabia_tpu_torch.obs.fleet_obs import FleetAggregator, render_fleet_table
from rabia_tpu_torch.persistence import FileSystemPersistence
from rabia_tpu_torch.testing import dcn
from rabia_tpu_torch.testing.conformance import run_schedule_on_both_planes, settle_quantiles
from rabia_tpu_torch.testing.fault_injection import ConsensusTestHarness, Fault, FaultType
from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster
from rabia_tpu_torch.testing.loadsession import LoadSession
from rabia_tpu_torch.testing.recovery import RecoveryHarness

S_FULL, R_FULL, T_FULL = 4096, 5, 32768  # BASELINE.json config 3 geometry, bench.py depth
T_SCAN = 8192  # bench.py's depth for the scanned protocol (slot_pipeline)
T_PACKED = 393216  # bench.py's depth for the packed window (2.0 GB of votes at S=4096 R=5)
T_PLAIN_SCAN = 64  # the depth at which the plain slot_pipeline is timed
CHAIN = 32
P_FULL = 64  # the reference DeviceKVTable's per_shard_capacity (32 B keys, 64 B values)
# phase 7's GET and mixed waves: the host block lane serves reads op by op
# (about 2k ops/s), so these waves set most of the run's time
LANE_READ_WAVES = 8
LANE_HOST_GETS = 3  # phase 8: GET blocks of each stream's first group also sent to the host lane
# phase 9: the governor's window ladder (min_window 1 .. max_window 256),
# run whole by the ladder of programs; the governed lane's run caps its
# ladder at GOV_MAX_WINDOW to stay within the run's time
LADDER = tuple(1 << i for i in range(9))
GOV_MAX_WINDOW = 64
GOV_LOOSE_MS = 100.0  # p99 window latency target above the lane's floor
GOV_TIGHT_MS = 0.05  # below any window's floor: a host pack alone takes longer
GOV_SET_BLOCKS = 160  # the governed lane's saturating SET stream
GOV_GROUPS = 6  # its 90/10 GET/SET stream: groups of 9 GET blocks and 1 SET block
# phase 10: the transport engine beside the device plane, at BASELINE.json
# config 3's shape (4096 shards x 5 replicas, 4 SETs a shard a wave) and
# config 2's (64 shards x 3 replicas)
TRANSPORT_WAVES = 3
CFG2_S, CFG2_R, CFG2_WAVES = 64, 3, 8
# phase 11: the apps over the transport engine beside MeshEngine, at
# BASELINE.json configs 1-4 (config 2 reuses phase 10 (b)'s shape)
CFG1_R, CFG1_CMDS = 3, 48  # counter_smr: 3 replicas, one shard, one command a slot
CFG2_OP_WAVES = 6  # config 2: waves of one op a shard, then a set_many and a get_many
APP_WAVES = 3  # config 3: waves of concurrent set() calls (the only cut allowed: fewer)
APP_PER, APP_KEY, APP_VAL = 8, 32, 64  # keys a shard a wave; key and value bytes
# config 4: banking_smr, 7 replicas x 1024 shards, 3 crashed (no two of them
# adjacent in the slot proposer rotation), 2 waves after the crash
CFG4_S, CFG4_R, CFG4_CRASH, CFG4_POST = 1024, 7, (1, 3, 5), 2
# phase 12: BASELINE.json config 5 (kvstore_smr, 5 replicas, 16384 shards,
# TCP, Zipf keys) and config 6 (the reference's native runtime's home
# configuration, 4096 x 5 over TCP), the reference sweep's settings
CFG5_S, CFG5_R, CFG5_CAPACITY = 16384, 5, 1 << 18
CFG5_ZIPF_S, CFG5_DRAWS, CFG5_KEYS, CFG5_MAX_CMDS = 1.2, 30000, 99999, 32
CFG6_S, CFG6_R = 4096, 5
PUMP_S = 8.0  # the block pump's seconds in each leg
NATIVE_LIBS = ("transport", "codec", "hostkernel", "statekernel", "runtime", "walkernel",
               "sessionkernel")
# phase 13: the durability plane and the gateway at config 3's width (4096
# shards x 5 replicas): 64 client sessions, 2 waves of one SET a shard (cut
# from 4 to keep the script inside its time: its depth, not its width; its
# checks read back the last acknowledged write either way), 32-byte keys,
# 64-byte values; the kill -9 trial preloads
# benchmarks/recovery_bench.py's 10x point (RB_BASE_KEYS 200 x 10; its 100x
# point, 20000 keys, until the script outgrew its time: PERF.md section 4)
P13_SESSIONS, P13_WAVES, P13_KEY, P13_VAL = 64, 2, 32, 64
P13_PRELOAD = 2000
P13_LOAD_RATE = 50.0  # the load generator's SETs a second (the trial's)
# phase 14: a routed fleet of 3 gateways over phase 13's durable cluster at
# config 3's width: 64 sessions through one connection pool, one wave of one
# SET a shard (2 until the script outgrew its time: PERF.md section 4); the
# ring drops a member a third of the way in, a gateway is killed at two
# thirds
P14_GATEWAYS, P14_SESSIONS, P14_WAVES = 3, 64, 1
# phase 15: the chaos smoke set's profiles that run on the card (the mesh
# fabric's) at config 3's width; its host-only profiles run in the CPU tests
# (tests/test_torch_chaos.py), cut from here for the script's time
P15_MESH_S, P15_MESH_R = S_FULL, R_FULL
# phase 19: the README's device examples (examples/torch_*.py) on the card;
# each one's lines that print a time or rate (held out of the comparison
# with its CPU run), by a fragment they hold
P19_TIMED = {
    "device_kv_lane": ("client settle p99",),
    "mesh_engine_demo": (),
    "performance_benchmark": ("round-trips/s", "decisions/s", "batches/s"),
}
# the device records of the kernels the examples must reach, by a fragment
# of the kernel's name
P19_KERNELS = {"kv": ("kv_dict_kernel", "kv_read_kernel", "kv_window_kernel"),
               "mesh_window": ("mesh_window_kernel",),
               "slot_pipeline": ("pipeline_tsr_kernel", "pipeline_bytes_kernel")}
# phase 20: scripts/torch_fuzz_conformance.py and scripts/torch_soak.py on the
# card at config 3's width. The fuzz: the stepwise and fused trials for
# P20_FUZZ_S seconds after a warm-up (the reference's geometry pool and
# S_FULL x R_FULL with kernel seed P20_KSEED), the mesh trials
# P20_MESH_ROUNDS times over the mesh pool and 4x1 and 4x5 meshes at
# S_FULL x R_FULL, one planes trial; seeds from P20_SEED. The soak's mesh
# leg with the device store for P20_SOAK_MESH_S (seed 93: its chaos loses
# the quorum on the third wave and heals on the fifth, so a short run
# demotes and re-promotes the lane; it loses the quorum again from the
# fifteenth), the transport soak on backend="jax" for P20_SOAK_JAX_S (the
# reference's default seed)
P20_FUZZ_S, P20_SEED, P20_KSEED, P20_MESH_ROUNDS = 18.0, 20000, 3, 2
P20_SOAK_MESH_S, P20_SOAK_MESH_SEED = 10.0, 93
P20_SOAK_JAX_S, P20_SOAK_JAX_SEED = 8.0, 42
# int32 operations/s of an H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz
# (the Hopper white paper's per-SM unit count and the SXM boost clock)
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _random_votes(shape, gen, device) -> torch.Tensor:
    return torch.randint(0, 4, shape, generator=gen, device=device, dtype=torch.int8)


def _alive(shape, gen, device, p_dead=0.3) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) >= p_dead


def _max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def _state_err(a, b) -> int:
    """The largest absolute difference over every field of two states."""
    return max(_max_err(x, y) for x, y in zip(a, b))


# -- phase 2 -----------------------------------------------------------------


def kernel_vs_plain(device) -> tuple[int, int]:
    """Both fused-window kernels against the plain closed forms at ragged
    and misaligned shapes; returns the largest absolute difference seen
    by the replica-major and by the [T, S, R] kernel (both must be 0)."""
    gen = torch.Generator(device=device).manual_seed(2)
    worst = worst_tsr = 0

    def shifted(x):  # the same values, starting one byte into a buffer
        buf = torch.empty(x.numel() + 1, dtype=torch.int8, device=device)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out

    for R in (1, 3, 4, 5, 7, 8):
        q = quorum_size(R)
        for S, T in ((17, 33), (1000, 7), (4096, 65)):
            votes = _random_votes((R, T, S), gen, device)
            alive = _alive((R, S), gen, device)
            want_d, want_p = fused_window.closed_form_window_rmajor(votes, alive, q)
            for v in (votes, shifted(votes)):
                d, p = fused_window.FUSED_WINDOW(v, alive, q, want_phase=True)
                d2 = fused_window.FUSED_WINDOW(v, alive, q, want_phase=False)
                torch.cuda.synchronize(device)
                worst = max(worst, _max_err(d, want_d), _max_err(p, want_p), _max_err(d2, want_d))
                _check(torch.equal(d, want_d) and torch.equal(p, want_p) and torch.equal(d2, want_d),
                       f"kernel != plain at R={R} S={S} T={T}")
            # the [T, S, R] kernel on the same votes, read in place
            votes_api = votes.permute(1, 2, 0).contiguous()
            alive_api = alive.t().contiguous()
            wd, wp = fused_window.closed_form_window(votes_api, alive_api, q)
            _check(torch.equal(wd, want_d), "plain layouts disagree")
            for v in (votes_api, shifted(votes_api)):
                d, p = fused_window.FUSED_WINDOW_TSR(v, alive_api, q, want_phase=True)
                d2 = fused_window.FUSED_WINDOW_TSR(v, alive_api, q, want_phase=False)
                d3, p3 = fused_window.window(v, alive_api, q)
                torch.cuda.synchronize(device)
                worst_tsr = max(worst_tsr, _max_err(d, wd), _max_err(p, wp), _max_err(d2, wd),
                                _max_err(d3, wd), _max_err(p3, wp))
                _check(torch.equal(d, wd) and torch.equal(p, wp) and torch.equal(d2, wd)
                       and torch.equal(d3, wd) and torch.equal(p3, wp),
                       f"[T,S,R] kernel != plain at R={R} S={S} T={T}")
    return worst, worst_tsr


# -- phase 2b ----------------------------------------------------------------


def mesh_case(gen, S: int, R: int, T: int, device):
    """Votes over all four codes (every third shard split V0/V1, so the
    coin decides), a crash mask (random deaths, shard 0 without a
    quorum) and per-shard bases, half of them near the int32 wrap."""
    votes = _random_votes((T, S, R), gen, device)
    votes[:, 1::3] = torch.randint(0, 2, votes[:, 1::3].shape, generator=gen, device=device,
                                   dtype=torch.int8)
    alive = _alive((S, R), gen, device, p_dead=0.2)
    alive[0, : quorum_size(R)] = False
    base = torch.randint(0, 1000, (S,), generator=gen, device=device, dtype=torch.int32)
    base[::2] = 2**31 - 1 - torch.randint(0, T, base[::2].shape, generator=gen, device=device,
                                          dtype=torch.int32)
    return votes, alive, base


def mesh_kernel_vs_plain(device) -> int:
    """The mesh-window kernel against the plain loop over ``phase_step``;
    returns the largest absolute difference seen (must be 0)."""
    gen = torch.Generator(device=device).manual_seed(21)
    worst = 0
    for R in (1, 3, 4, 5, 7, 64):
        for S in (17, 1000, 4096):
            for T in (1, 16):
                votes, alive, base = mesh_case(gen, S, R, T, device)
                for max_phases in (1, 4, 8):
                    for p1 in (0.0, 0.5, 1.0):
                        mk = MeshPhaseKernel(S, R, coin_p1=p1, seed=S + R, device=device)
                        want = mk.decide_slots_plain(votes, alive, base, max_phases)
                        got = mesh_window.MESH_WINDOW(votes, alive, base, seed=mk.seed,
                                                      coin_p1=p1, max_phases=max_phases)
                        torch.cuda.synchronize(device)
                        worst = max(worst, _max_err(got, want))
                        _check(torch.equal(got, want),
                               f"mesh window kernel != plain at R={R} S={S} T={T} "
                               f"max_phases={max_phases} coin_p1={p1}")
                        _check(bool((want[:, 0] == ABSENT).all()), "a quorum-less shard decided")
    return worst


def mesh_work(mk, votes, alive, base, max_phases: int) -> tuple[int, int]:
    """(phases, coin flips) that the window's entries need: an entry with
    a live replica runs phases until its deciding one (or max_phases); a
    phase that decides nothing flips the coin. Counted with the plain
    loop at each depth."""
    live = alive.any(-1)[None, :]
    undecided = [live.expand(votes.shape[:2])]
    for k in range(1, max_phases + 1):
        undecided.append(live & (mk.decide_slots_plain(votes, alive, base, k) == ABSENT))
    phases = sum(int(u.sum()) for u in undecided[:-1])
    return phases, sum(int(u.sum()) for u in undecided[1:])


# -- phase 2c ----------------------------------------------------------------


def packed_kernel_vs_plain(device) -> int:
    """The packed-window kernel against the plain packed window, bit for
    bit; returns the largest absolute difference of the words (must be
    0)."""
    gen = torch.Generator(device=device).manual_seed(23)
    worst = 0

    def shifted(x):  # the same words, starting one word into a buffer
        buf = torch.empty(x.numel() + 1, dtype=torch.int32, device=device)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out

    for R in (1, 3, 4, 5, 7, 8):
        for S, T in ((17, 33), (1000, 7), (4096, 65)):
            votes = _random_votes((R, T, S), gen, device)
            alive = _alive((R, S), gen, device)
            packed, alive_p = packed_window.pack_inputs(votes, alive)
            for q in range(R + 2):
                want = packed_window.packed_window_rmajor(packed, alive_p, q)
                for v in (packed, shifted(packed)):
                    got = packed_window.PACKED_WINDOW(v, alive_p, q)
                    torch.cuda.synchronize(device)
                    worst = max(worst, _max_err(got, want))
                    _check(torch.equal(got, want),
                           f"packed window kernel != plain at R={R} S={S} T={T} q={q}")
                if q >= 1 and S % 16:
                    pads = packed_window.unpack_codes(want, packed.shape[-1] * 16)[:, S:]
                    _check(bool((pads == ABSENT).all()), "a pad lane decided")
    return worst


# -- phase 2d ----------------------------------------------------------------


def round_kernel_vs_plain(device) -> int:
    """The round kernel against the plain round: ``run_rounds`` chains of
    1, 2, 7 and 80 rounds at p_deliver 1.0, 0.6 and 0.3 (a static
    partition on some), one ``round_step`` under an explicit mask, the
    same launch in place, and ``slot_pipeline`` / ``slot_pipeline_wide``
    at 0 to 6 rounds a slot with slots that wrap past 2^31-1; every
    field of every state after every launch. Returns the largest
    absolute difference seen (must be 0)."""
    gen = torch.Generator(device=device).manual_seed(24)
    worst, case = 0, 0
    for R in (1, 2, 3, 4, 5, 6, 7, 8, 64):
        q = quorum_size(R)
        for S in (17, 1000, 4096) if R not in (2, 6) else (1000,):
            p1 = (0.0, 0.5, 1.0)[case % 3]
            k = ClusterKernel(S, R, coin_p1=p1, seed=S + R, device=device)
            votes = torch.randint(0, 2, (S, R), generator=gen, device=device, dtype=torch.int8)
            votes[::7] = _random_votes((votes[::7].shape[0], R), gen, device)  # V? and ABSENT
            alive = _alive((S, R), gen, device, p_dead=0.2)
            alive[0, :q] = False  # a quorum-less shard
            active = torch.ones(S, dtype=torch.bool, device=device)
            active[1::5] = False  # inactive shards
            st = k.start_slot(k.init_state(), active, votes)
            st = st._replace(slot=2**31 - 1 - torch.randint(
                0, 3, (S,), generator=gen, device=device, dtype=torch.int32))
            # a state taken mid-protocol: three plain rounds first
            st = k.run_rounds_plain(st, alive, 3, torch.Generator(device=device).manual_seed(case),
                                    p_deliver=0.6)
            side = torch.arange(R, device=device) < max(1, R // 3)
            part = side[:, None] == side[None, :]  # a static partition
            for i, p in enumerate((1.0, 0.6, 0.3)):
                link = part if i == 1 or (i == 0 and case % 2) else None
                for n in (1, 2, 7, 80):
                    gens = [torch.Generator(device=device).manual_seed(100 * case + n)
                            for _ in range(2)]
                    got = k.run_rounds(st, alive, n, gens[0], p_deliver=p, link_mask=link)
                    want = k.run_rounds_plain(st, alive, n, gens[1], p_deliver=p, link_mask=link)
                    torch.cuda.synchronize(device)
                    err = _state_err(got, want)
                    worst = max(worst, err)
                    _check(err == 0, f"run_rounds kernel != plain at R={R} S={S} p={p} n={n} "
                                     f"coin_p1={p1}")
                    st = got
            d = torch.rand((S, R, R), generator=gen, device=device) < 0.5
            want = k.round_step_plain(st, alive, d)
            got = k.round_step(st, alive, d)
            fields = [t.clone() for t in st]  # the same round, in place
            cluster_round.CLUSTER_ROUND.rounds(fields, alive, d, 1, out=fields,
                                               **k._kernel_args())
            torch.cuda.synchronize(device)
            err = max(_state_err(got, want), _state_err(fields, want))
            worst = max(worst, err)
            _check(err == 0, f"round_step kernel != plain at R={R} S={S}")
            T, start = 9, 2**31 - 5
            v = _random_votes((T, S, R), gen, device)
            v[:, 1::3] = torch.randint(0, 2, v[:, 1::3].shape, generator=gen, device=device,
                                       dtype=torch.int8)  # split V0/V1: the coin
            for rounds in range(7):
                want = k.slot_pipeline_plain(v, alive, T, rounds, start)
                got = k.slot_pipeline(v, alive, T, rounds, start)
                wide = k.slot_pipeline_wide(v, alive, T, rounds, start, block=3)
                torch.cuda.synchronize(device)
                err = max(_state_err(got, want), _state_err(wide, want))
                worst = max(worst, err)
                _check(err == 0, f"slot_pipeline kernel != plain at R={R} S={S} "
                                 f"rounds={rounds}")
            case += 1
    return worst


def pipeline_every_r(device) -> int:
    """``slot_pipeline`` and ``slot_pipeline_wide`` on the card for every R
    from 1 to 64 at 0 to 6 rounds a slot (S=33: two chunks of 16 shards
    and a ragged one; slots that wrap past 2^31-1 at odd R): each call is
    one launch of the slot-pipeline kernel and no other launch, and both
    equal ``slot_pipeline_wide_plain`` bit for bit. Returns the largest
    absolute difference seen (must be 0)."""
    gen = torch.Generator(device=device).manual_seed(64)
    K = cluster_round.CLUSTER_ROUND
    S, T, worst = 33, 4, 0
    for R in range(1, cluster_round.MAX_REPLICAS + 1):
        k = ClusterKernel(S, R, coin_p1=(0.0, 0.5, 1.0)[R % 3], seed=R, device=device)
        votes = _random_votes((T, S, R), gen, device)
        lean = torch.rand((T, S, R), generator=gen, device=device) < 0.9
        votes[:, 1::3] = torch.where(lean[:, 1::3], V1, votes[:, 1::3])  # quorums of V1
        alive = _alive((S, R), gen, device, p_dead=0.2)
        start = 2**31 - 2 if R % 2 else 0
        for rounds in range(7):
            before = dict(K.counts)
            got = k.slot_pipeline(votes, alive, T, rounds, start)
            wide = k.slot_pipeline_wide(votes, alive, T, rounds, start, block=2)
            _check(K.counts == {**before, "slot_pipeline": before["slot_pipeline"] + 2},
                   f"slot_pipeline at R={R} rounds={rounds} was not one slot-pipeline launch")
            want = k.slot_pipeline_wide_plain(votes, alive, T, rounds, start, block=T)
            torch.cuda.synchronize(device)
            err = max(_state_err(got, want), _state_err(wide, want))
            worst = max(worst, err)
            _check(err == 0, f"slot_pipeline kernel != plain at R={R} rounds={rounds}")
    return worst


def round_kernel_vs_oracle(device) -> None:
    """The port's WeakMVCOracle on four shards of one lossy trace, one
    round-kernel launch a step (tests/test_kernel.py's conformance
    check): decisions, decided phases, and every undecided live replica's
    phase, stage and votes agree after every step."""
    S, R, T, seed = 4, 5, 30, 5
    rng = np.random.default_rng(seed)
    initial = rng.integers(0, 2, size=(S, R)).astype(np.int8)
    alive = np.ones((S, R), bool)
    alive[:, 0] = False
    masks = rng.random((T, S, R, R)) < 0.6
    k = ClusterKernel(S, R, seed=seed, device=device)
    st = k.start_slot(k.init_state(), torch.ones(S, dtype=torch.bool, device=device),
                      torch.from_numpy(initial).to(device))
    oracles = [WeakMVCOracle(R, list(initial[s]), lambda ph, s=s: device_coin(seed, s, 0, ph),
                             alive=list(alive[s])) for s in range(S)]
    on_card = torch.from_numpy(alive).to(device)
    before = cluster_round.CLUSTER_ROUND.launches
    for t in range(T):
        st = k.round_step(st, on_card, torch.from_numpy(masks[t]).to(device))
        for s in range(S):
            oracles[s].step(lambda i, j, m=masks[t, s]: bool(m[i, j]))
        f = {name: getattr(st, name).cpu().numpy() for name in st._fields}
        for s, o in enumerate(oracles):
            kd = None if f["decided"][s] == ABSENT else int(f["decided"][s])
            kp = None if f["decided_phase"][s] < 0 else int(f["decided_phase"][s])
            _check((kd, kp) == (o.decided_value, o.decided_phase), f"oracle step {t} shard {s}")
            for r, node in enumerate(o.nodes):
                if not alive[s, r]:
                    continue
                _check(bool(f["done"][s, r]) == (node.decided is not None), f"oracle step {t}")
                if node.decided is None:
                    _check((f["phase"][s, r], f["stage"][s, r], f["my_r1"][s, r], f["my_r2"][s, r])
                           == (node.phase, node.stage, node.my_r1, node.my_r2),
                           f"oracle step {t} shard {s} replica {r}")
    _check(cluster_round.CLUSTER_ROUND.launches == before + T, "a step was not one launch")
    _check(all(o.decided_value is not None for o in oracles), "the oracle trace decided nothing")


# -- phase 3 -----------------------------------------------------------------


def protocol_vs_fused(device, S: int, R: int, T: int, seed: int = 3) -> None:
    """The scanned protocol and the fused entry agree bit for bit."""
    gen = torch.Generator(device=device).manual_seed(seed)
    k = ClusterKernel(S, R, seed=seed, device=device)
    votes = _random_votes((T, S, R), gen, device)
    alive = _alive((S, R), gen, device, p_dead=0.25)
    d1, p1 = k.slot_pipeline(votes, alive, T)
    d2, p2 = k.slot_pipeline_fused(votes, alive, T)
    _check(torch.equal(d1, d2) and torch.equal(p1, p2), "slot_pipeline != slot_pipeline_fused")
    _check(bool((d1 != ABSENT).any()) and bool((d1 == ABSENT).any()),
           "protocol check saw only one outcome")


# -- phase 4 -----------------------------------------------------------------


def decision_core(device, S: int, R: int, T: int, seed: int = 4):
    """One window through the user entry, every decision checked against
    the plain closed form and the plain packed window on the device.
    Returns (kernel, votes buffers, alive, max error)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    k = ClusterKernel(S, R, seed=seed, device=device)
    bufs = [_random_votes((R, T, S), gen, device) for _ in range(2)]
    alive = _alive((R, S), gen, device, p_dead=0.2)
    worst = 0
    for votes in bufs:
        dec = k.slot_pipeline_fused_rmajor(votes, alive, T, want_phase=False)
        want = fused_window.closed_form_window_rmajor(votes, alive, k.quorum, want_phase=False)
        worst = max(worst, _max_err(dec, want))
        _check(torch.equal(dec, want), "decision core != plain closed form")
        packed = k.slot_pipeline_fused_packed(*packed_window.pack_inputs(votes, alive), T)
        _check(torch.equal(packed_window.unpack_codes(packed, S), dec),
               "decision core != plain packed window")
    return k, bufs, alive, worst


def decision_core_tsr(device, S: int, R: int, T: int, seed: int = 5):
    """One window through ``ClusterKernel.slot_pipeline_fused`` on [T, S, R]
    votes (the [T, S, R] kernel, reading them in place) on each of two
    buffers, every decision and phase checked against the plain closed
    form on the device. Returns (kernel, votes buffers, alive, max error)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    k = ClusterKernel(S, R, seed=seed, device=device)
    bufs = [_random_votes((T, S, R), gen, device) for _ in range(2)]
    alive = _alive((S, R), gen, device, p_dead=0.2)
    worst = 0
    for votes in bufs:
        dec, ph = k.slot_pipeline_fused(votes, alive, T)
        want_d, want_p = fused_window.closed_form_window(votes, alive, k.quorum)
        worst = max(worst, _max_err(dec, want_d), _max_err(ph, want_p))
        _check(torch.equal(dec, want_d) and torch.equal(ph, want_p),
               "[T,S,R] decision core != plain closed form")
        del want_d, want_p
    return k, bufs, alive, worst


def scan_vs_fused(device, S: int, R: int, T: int, seed: int = 12):
    """The scanned protocol at bench.py's depth through ``slot_pipeline``
    (one round-kernel launch) on each of two buffers of random votes
    under a crash mask, every decision and phase held against
    ``slot_pipeline_fused`` on the card (under full delivery the two are
    identical). Returns (kernel, votes buffers, alive, max error)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    k = ClusterKernel(S, R, seed=seed, device=device)
    bufs = [_random_votes((T, S, R), gen, device) for _ in range(2)]
    alive = _alive((S, R), gen, device, p_dead=0.2)
    worst = 0
    for votes in bufs:
        d, ph = k.slot_pipeline(votes, alive, T)
        wd, wp = k.slot_pipeline_fused(votes, alive, T)
        worst = max(worst, _max_err(d, wd), _max_err(ph, wp))
        _check(torch.equal(d, wd) and torch.equal(ph, wp), "slot_pipeline != slot_pipeline_fused")
    return k, bufs, alive, worst


def fault_path(device, S: int, n_rounds: int = 80, p_deliver: float = 0.6, seed: int = 1):
    """``python -m rabia_tpu --selftest``'s fault path at full width: five
    replicas [dead, up, up, dead, up], every shard proposes V1, n_rounds
    rounds at p_deliver through ``run_rounds`` (one round-kernel launch);
    every shard must decide, and the state must equal the plain loop's
    under the same generator. Returns (kernel, start state, alive, max
    error)."""
    R = 5
    k = ClusterKernel(S, R, seed=42, device=device)
    st0 = k.start_slot(k.init_state(), torch.ones(S, dtype=torch.bool, device=device),
                       torch.full((S, R), V1, dtype=torch.int8, device=device))
    alive = torch.tensor([False, True, True, False, True], device=device).expand(S, R)
    got = k.run_rounds(st0, alive, n_rounds, torch.Generator(device=device).manual_seed(seed),
                       p_deliver=p_deliver)
    want = k.run_rounds_plain(st0, alive, n_rounds,
                              torch.Generator(device=device).manual_seed(seed),
                              p_deliver=p_deliver)
    _check(bool((got.decided != ABSENT).all()), "the fault path left a shard undecided")
    err = _state_err(got, want)
    _check(err == 0, "run_rounds kernel != plain on the fault path")
    return k, st0, alive, err


def packed_deep(device, S: int, R: int, T: int):
    """The packed window at bench.py's packed depth through
    ``slot_pipeline_fused_packed`` (the packed-window kernel) on two
    buffers of unanimous-V1 words, every decision checked on the card
    against the V1 row (bench.py's check). Returns (kernel, buffers,
    packed alive, V1 row, max error)."""
    k = ClusterKernel(S, R, seed=0, device=device)
    v1_word = int(packed_window.pack_codes(torch.full((16,), V1, dtype=torch.int8))[0])
    first = torch.full((R, T, packed_window.packed_width(S)), v1_word, dtype=torch.int32,
                       device=device)
    bufs = [first, first.clone()]
    alive_p = packed_window.pack_alive(torch.ones((R, S), dtype=torch.bool, device=device))
    row = packed_window.pack_codes(torch.full((S,), V1, dtype=torch.int8, device=device))
    worst = 0
    for buf in bufs:
        d = k.slot_pipeline_fused_packed(buf, alive_p, T)
        worst = max(worst, int((d.to(torch.int64) - row.to(torch.int64)).abs().max()))
        _check(bool((d == row[None, :]).all()), "packed window != the V1 row")
        del d
    return k, bufs, alive_p, row, worst


# the least integer operations of the two functions, counted from what
# each function must compute (not from the kernels' own code)

def packed_ops(R: int, T: int, SW: int) -> int:
    """``packed_window_rmajor`` per output word, with 3-input logic as one
    operation (alive bits lie at the lanes' low bits): 3 a replica for its
    planes (one shift, then V1 = w & ~(w >> 1) & a and V0 = ~(w | w >> 1)
    & a), 2 for each full adder of the two carry-save trees that sum R
    one-bit planes into bit_length(R) bits (R - bit_length(R) adders a
    tree), bit_length(R) for each quorum compare, and 3 for the codes."""
    cap = R.bit_length()
    return T * SW * (3 * R + 2 * 2 * (R - cap) + 2 * cap + 3)


def pipeline_ops(S: int, R: int, T: int, rounds: int = 2, coins: int = 0) -> int:
    """``slot_pipeline`` on T slots, ``rounds`` full-delivery rounds each:
    a fresh slot's rounds then collapse to the rule of
    ``csrc/cluster_round.cuh`` (``full_delivery``, derived there for every
    ``rounds``), so the least work a (slot, shard) is: none below 2
    rounds (every entry is ABSENT); from 2 rounds on 6 a replica (V0, V1
    and V? tests of its code, three adds under alive) and 8 (the sum of
    the counts, three quorum compares, the decision and its phase); from
    4 rounds on, 21 more for each of the ``coins`` entries that take the
    coin (two 10-operation hash steps past the part fixed by the seed and
    shard, and the compare)."""
    if rounds < 2:
        return 0
    return T * S * (6 * R + 8) + (21 * coins if rounds >= 4 else 0)


def dict_window_ops(S: int, P: int, D: int, W: int, K4: int) -> int:
    """Least integer operations of a dictionary-form write window, counted
    from what the function needs: each shard's D row keys and P slot keys
    hashed once to a 32-bit tag (a multiply and an add a word, and the
    length), every row's tag compared with every slot's, and 8 a wave
    (the rank's class, an AND, two lowest-bit finds, the step's compares
    and the mask updates)."""
    return S * ((D + P) * (2 * K4 + 1) + D * P + 8 * W)


def rounds_ops(R: int, shard_rounds: int) -> int:
    """The fault path's least integer operations: for each round a shard
    runs, 24 a receiver (the two ledgers' fills: an offer mask and a
    select of two code planes each, 8; the tallies: four popcounts and
    four quorum compares, 8; the step's selects, 8)."""
    return shard_rounds * R * 24


def settle_rounds(k, st0, alive, masks) -> torch.Tensor:
    """For each shard, the rounds of ``masks`` it runs before every live
    replica has decided: after that the shard is a fixed point
    (``csrc/cluster_round.cuh``, (d)) and needs neither work nor masks.
    Counted with the plain round on the same masks."""
    unsettled = lambda st: (alive & ~st.done).any(1)  # noqa: E731
    need = torch.zeros(k.S, dtype=torch.int64, device=masks.device)
    st, live = st0, unsettled(st0)
    for m in masks:
        if not bool(live.any()):
            break
        need += live
        st = k.round_step_plain(st, alive, m)
        live &= unsettled(st)
    return need


# -- phase 6 -----------------------------------------------------------------


def random_kv_case(gen, S: int, P: int, K4: int, VW4: int, W: int, ku4: int, vwu4: int,
                   device, *, p_used: float = 0.6, kinds=(0, 1, 2, 3, 4)):
    """A random device table (keys unique per shard, stale words in free
    slots, versions near the i32 wrap on some shards) and a random
    window of ops whose keys are drawn from the same key space, so ops
    hit, miss, fill and overflow shards. Returns (table, ops, depth)."""

    def ri(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=dtype)

    def key_words(ids):  # ids i64[...] -> (klen bytes, words i32[..., K4])
        nw = 1 + ids % K4
        j = torch.arange(K4, device=device)
        w = (ids[..., None] * 2654435761 + j * 40503 + 7) & 0x7FFFFFFF
        w = torch.where(j < nw[..., None], w ^ (j & 1) << 30, 0)
        return (4 * nw).to(torch.int32), w.to(torch.int32)

    ids = torch.rand((S, 2 * P), generator=gen, device=device).argsort(1)[:, :P]
    klen, keyw = key_words(ids)
    # the empty key (a legal key of the host store) in slot 0 of some shards
    empty = torch.rand(S, generator=gen, device=device) < 0.1
    klen[:, 0] = torch.where(empty, 0, klen[:, 0])
    keyw[:, 0] = torch.where(empty[:, None], 0, keyw[:, 0])
    used = torch.rand((S, P), generator=gen, device=device) < p_used
    ver = ri(0, 2**31 - 1, (S, P), torch.int32)
    valw = ri(-(2**31), 2**31 - 1, (S, P, VW4), torch.int32)
    vlen = ri(0, 4 * VW4 + 1, (S, P), torch.int32)
    sver = torch.where(torch.rand(S, generator=gen, device=device) < 0.2,
                       ri(2**31 - 2 - W, 2**31 - 1, (S,)), ri(0, 2**20, (S,))).to(torch.int32)
    table = kv_window.KVTable(used, keyw, klen, ver, valw, vlen, sver)

    kind = torch.tensor(kinds, dtype=torch.int8, device=device)[ri(0, len(kinds), (W, S))]
    op_ids = ri(0, 2 * P, (W, S))
    op_ids = (op_ids // K4) * K4 + op_ids % ku4  # keys no wider than ku4 words
    op_klen, op_kw = key_words(op_ids)
    op_klen = torch.where(kind == 0, ri(0, 4 * ku4 + 1, (W, S), torch.int32), op_klen)
    blank = (torch.rand((W, S), generator=gen, device=device) < 0.05) & (kind >= 2)
    op_klen = torch.where(blank, 0, op_klen)  # reads of the empty key
    op_kw = torch.where(blank[..., None], 0, op_kw)
    op_vlen = torch.where(kind == 1, ri(0, 4 * vwu4 + 1, (W, S), torch.int32), 0)
    vwin = ri(-(2**31), 2**31 - 1, (W, S, vwu4), torch.int32)
    ops = (kind, op_klen.to(torch.int16), op_vlen.to(torch.int16),
           op_kw[..., :ku4].contiguous(), vwin)
    depth = int(ri(0, W + 1, ()))
    return table, ops, depth


def _kv_case_vs_plain(gen, device, S, P, K4, VW4, W, ku4, vwu4, p_used, kinds) -> int:
    """One random case through the kv_window kernel and its plain version,
    every output plane and the untouched input table compared, and the
    read-only form; returns the largest absolute difference (must be 0)."""
    table, ops, depth = random_kv_case(
        gen, S, P, K4, VW4, W, ku4, vwu4, device, p_used=p_used, kinds=kinds
    )
    before = [x.clone() for x in table]
    want = kv_window.kv_window_plain(table, *ops, depth, want_reads=True)
    got = kv_window.KV_WINDOW(table, *ops, depth, want_reads=True)
    torch.cuda.synchronize(device)
    planes = [*zip(want[0], got[0]), (want[1], got[1]), *zip(want[2], got[2])]
    planes += list(zip(before, table))
    worst = 0
    for a, b in planes:
        worst = max(worst, _max_err(a, b))
        _check(torch.equal(a, b),
               f"kv_window kernel != plain at S={S} P={P} K4={K4} "
               f"VW4={VW4} W={W} ku4={ku4} vwu4={vwu4} kinds={kinds}")
    # the read-only kernel (no output table): a read of every non-empty
    # key; a window that writes has no read-only form
    kind, klen, _, kw, _ = ops
    want = kv_window.kv_window_plain(table, kv_window.KIND_GET, klen, None, kw, None, depth,
                                     want_table=False, want_reads=True)
    none, over, reads = kv_window.KV_WINDOW(table, kv_window.KIND_GET, klen, None, kw, None, depth,
                                            want_table=False, want_reads=True)
    torch.cuda.synchronize(device)
    _check(none is None and torch.equal(over, want[1])
           and all(torch.equal(a, b) for a, b in zip(reads, want[2])),
           f"kv_window read-only kernel != plain at S={S} P={P} K4={K4} VW4={VW4} W={W} "
           f"ku4={ku4}")
    try:
        kv_window.KV_WINDOW(table, kind, *ops[1:], depth, want_table=False, want_reads=True)
    except ValueError:
        pass
    else:
        _check(False, "a window without an output table was taken with a kind plane")
    return worst


def kv_kernel_vs_plain(device) -> int:
    """The kv_window kernel against its plain version, every output plane
    and the untouched input table compared; returns the largest absolute
    difference seen (must be 0)."""
    gen = torch.Generator(device=device).manual_seed(6)
    worst = 0
    # the reference's DeviceKVTable defaults (32 B keys, 64 B values) at
    # every S; odd widths (padded key rows, unaligned rows) at ragged S
    shapes = [(S, 8, 16) for S in (17, 1000, 4096)]
    shapes += [(S, K4, VW4) for S in (17, 1000) for K4, VW4 in ((3, 5), (4, 7))]
    for S, K4, VW4 in shapes:
        for P in (1, 7, 64):
            for W in (1, 16):
                for ku4, vwu4 in ((K4, VW4), (min(2, K4), min(4, VW4)), (1, 1)):
                    for p_used, kinds in ((0.6, (0, 1, 2, 3, 4)), (1.0, (1, 2)), (0.3, (0, 2))):
                        worst = max(worst, _kv_case_vs_plain(
                            gen, device, S, P, K4, VW4, W, ku4, vwu4, p_used, kinds))
    # tables wider than 64 slots (the kernel's masks then live in shared
    # memory) and windows longer than 32 waves (staged in chunks)
    for S, P, K4, VW4, W in ((33, 130, 8, 16, 16), (33, 64, 8, 16, 40), (9, 200, 3, 5, 70)):
        for p_used, kinds in ((0.6, (0, 1, 2, 3, 4)), (1.0, (1, 2))):
            worst = max(worst, _kv_case_vs_plain(
                gen, device, S, P, K4, VW4, W, K4, VW4, p_used, kinds))
    return worst


def decide_kernel_vs_plain(device) -> int:
    """The kv-window kernel with the window's decision folded in against
    the plain composition (mesh window, wave scan, flags), every output
    plane, the flags and the untouched input table compared, the table's
    first shard at global shard 0 or at a shard block's offset
    (``shard0``); returns the largest absolute difference seen (must be
    0)."""
    gen = torch.Generator(device=device).manual_seed(16)
    worst, i = 0, 0
    for S, P, K4, VW4 in ((17, 64, 8, 16), (4096, 64, 8, 16), (33, 130, 3, 5)):
        for W in (1, 16, 40, 70):
            for depth in sorted({0, 1, W}):
                for max_phases in (0, 1, 4):
                    i += 1
                    R = (1, 5, 7)[i % 3]
                    mode = ("set", "mixed", "lookup")[(i // 3) % 3]
                    kinds = {"set": (1,), "mixed": (0, 1, 2, 3, 4), "lookup": (0, 2)}[mode]
                    table, ops, _ = random_kv_case(gen, S, P, K4, VW4, W, K4, VW4, device,
                                                   kinds=kinds)
                    kind = {"set": None, "mixed": ops[0], "lookup": kv_window.KIND_GET}[mode]
                    planes = ops[1:] if mode != "lookup" else (ops[1], None, ops[3], None)
                    mk = MeshPhaseKernel(S, R, coin_p1=(0.0, 0.5, 1.0)[i % 3], seed=S + i,
                                         device=device)
                    _, alive, base = mesh_case(gen, S, R, 1, device)
                    if i % 2:  # healthy: every wave can decide V1
                        alive = torch.ones_like(alive)
                    else:  # shard 0 has no quorum (mesh_case), shard 1 no replica
                        alive[1 % S] = False
                    before = [x.clone() for x in table]
                    kw = dict(want_table=mode != "lookup", want_reads=mode != "set",
                              shard0=(0, 1024, 3 * 4096 + 5)[(i // 9) % 3])
                    want = kv_window.decide_window_plain(mk, table, kind, *planes, depth, alive,
                                                         base, max_phases, **kw)
                    got = kv_window.KV_WINDOW.decide(table, kind, *planes, depth, alive, base,
                                                     seed=mk.seed, coin_p1=mk.coin_p1,
                                                     max_phases=max_phases, **kw)
                    if mode == "mixed":  # and its reads gathered, as mixed_apply takes them
                        g = dict(kw, gidx=_gidx(kind))
                        want = (*want, *kv_window.decide_window_plain(
                            mk, table, kind, *planes, depth, alive, base, max_phases, **g))
                        got = (*got, *kv_window.KV_WINDOW.decide(
                            table, kind, *planes, depth, alive, base, seed=mk.seed,
                            coin_p1=mk.coin_p1, max_phases=max_phases, **g))
                    torch.cuda.synchronize(device)
                    want, got = _flat(want), _flat(got)
                    _check(len(want) == len(got), "decide window outputs differ in kind")
                    for a, b in [*zip(before, table), *zip(want, got)]:
                        worst = max(worst, _max_err(a, b))
                        _check(torch.equal(a, b),
                               f"kv_window with the decision != plain at S={S} P={P} W={W} "
                               f"depth={depth} max_phases={max_phases} R={R} mode={mode}")
    return worst


def random_dict_case(gen, S: int, P: int, K4: int, VW4: int, W: int, ku4: int, vwu4: int, D: int,
                     device, *, p_used: float = 0.6, kinds=(0, 1, 2, 3, 4)):
    """``random_kv_case``'s table and a window in the dictionary form:
    each shard's D rows are ``random_kv_case``'s ops of D waves, and the
    ranks pick among them (about one in thirty is D, which names no row).
    About one row in four takes the key of the row before it, keeping its
    own value: rows that share a key. Returns (table, kind i8[W, S],
    (dkl, dvl, dk, dv), idx u8[W, S], depth)."""
    table, rows, _ = random_kv_case(gen, S, P, K4, VW4, D, ku4, vwu4, device, p_used=p_used,
                                    kinds=kinds)
    _, klen, vlen, kw, vw = rows
    dict_ops = (klen.t().contiguous(), vlen.t().contiguous(), kw.transpose(0, 1).contiguous(),
                vw.transpose(0, 1).contiguous())
    idx = torch.randint(0, D, (W, S), generator=gen, device=device)
    idx = torch.where(torch.rand((W, S), generator=gen, device=device) < 0.03, D, idx)
    kind = torch.tensor(kinds, dtype=torch.int8, device=device)[
        torch.randint(0, len(kinds), (W, S), generator=gen, device=device)]
    depth = int(torch.randint(0, W + 1, (), generator=gen, device=device))
    share = torch.rand((S, D), generator=gen, device=device) < 0.25
    share[:, 0] = False
    dkl, _, dk, _ = dict_ops
    for r in range(1, D):  # in order, so a run of shared rows keeps one key
        dkl[:, r] = torch.where(share[:, r], dkl[:, r - 1], dkl[:, r])
        dk[:, r] = torch.where(share[:, r, None], dk[:, r - 1], dk[:, r])
    return table, kind, dict_ops, idx.to(torch.uint8), depth


def _flat(outputs) -> list:
    """The tensors of a window's outputs (tables and reads unpacked)."""
    out = []
    for x in outputs:
        if isinstance(x, tuple):
            out.extend(x)
        elif x is not None:
            out.append(x)
    return out


# -- phase 8 -----------------------------------------------------------------


def _gidx(kind: torch.Tensor) -> torch.Tensor:
    """``mixed_apply``'s row index of a kind plane: the waves with a read,
    padded to a power of two with wave 0 (one row where there is none)."""
    waves = torch.nonzero((kind >= 2).any(dim=1))[:, 0].to(torch.int32)
    out = torch.zeros(1 << max(0, len(waves) - 1).bit_length(), dtype=torch.int32,
                      device=kind.device)
    out[: len(waves)] = waves
    return out


def dict_kernel_vs_plain(device) -> int:
    """The write kernels on dictionary-form ops (``kv_dict.cu`` for P <=
    64, ``kv_window.cu``'s wide path for P = 130): the plain window, and
    with the decision the SET, mixed (every wave's reads, and gathered
    to its GET waves as ``mixed_apply`` takes them) and lookup windows; and the
    read-only probe in both forms; against their plain versions: every
    output plane, the flags and the untouched input table. Ragged S, P of
    7, 64 and 130, D in {1, 2, 17, 32}, W in {1, 16, 40, 64, 256}, rows
    that share a key, op widths at and below the table's, the decisions
    at global shard 0 or at a shard block's offset (``shard0``). Returns
    the largest absolute difference seen (must be 0)."""
    gen = torch.Generator(device=device).manual_seed(18)
    worst, i = 0, 0
    for S, P, K4, VW4 in ((17, 7, 8, 16), (1000, 64, 8, 16), (33, 130, 3, 5)):
        for D in (1, 2, 17, 32):
            for W in (1, 16, 40, 64, 256):
                i += 1
                ku4, vwu4 = (K4, VW4) if i % 2 else (min(2, K4), min(4, VW4))
                table, kind, dops, idx, depth = random_dict_case(gen, S, P, K4, VW4, W, ku4, vwu4,
                                                                 D, device)
                keys_only = (dops[0], None, dops[2], None)
                before = [x.clone() for x in table]
                cases = [("window", kv_window.kv_window_plain(table, kind, *dops, depth, idx=idx,
                                                              want_reads=True),
                          kv_window.KV_WINDOW(table, kind, *dops, depth, idx=idx, want_reads=True))]
                R = (1, 5, 7)[i % 3]
                mk = MeshPhaseKernel(S, R, coin_p1=(0.0, 0.5, 1.0)[i % 3], seed=S + i,
                                     device=device)
                _, alive, base = mesh_case(gen, S, R, 1, device)
                if i % 2:
                    alive = torch.ones_like(alive)
                for mode, k, planes, kw in (
                    ("set", None, dops, {}),
                    ("mixed", kind, dops, {"want_reads": True}),
                    ("mixed gathered", kind, dops, {"want_reads": True, "gidx": _gidx(kind)}),
                    ("lookup", kv_window.KIND_GET, keys_only,
                     {"want_table": False, "want_reads": True}),
                ):
                    kw["shard0"] = (0, 2048, 4096 + 17)[i % 3]
                    cases.append((mode, kv_window.decide_window_plain(
                        mk, table, k, *planes, depth, alive, base, 4, idx=idx, **kw),
                        kv_window.KV_WINDOW.decide(
                            table, k, *planes, depth, alive, base, seed=mk.seed,
                            coin_p1=mk.coin_p1, max_phases=4, idx=idx, **kw)))
                probe = {"want_table": False, "want_reads": True}
                rows = kv_window.expand_dict(idx, *keys_only)
                for form, planes, ix in (("probe", keys_only, idx), ("probe rows", rows, None)):
                    cases.append((form, kv_window.kv_window_plain(
                        table, kv_window.KIND_GET, *planes, 0, idx=ix, **probe),
                        kv_window.KV_WINDOW(table, kv_window.KIND_GET, *planes, 0, idx=ix, **probe)))
                torch.cuda.synchronize(device)
                for mode, want, got in cases:
                    want, got = _flat(want), _flat(got)
                    _check(len(want) == len(got), f"dictionary window outputs differ in kind ({mode})")
                    for a, b in [*zip(before, table), *zip(want, got)]:
                        worst = max(worst, _max_err(a, b))
                        _check(torch.equal(a, b),
                               f"kv_window {mode} on the dictionary form != plain at S={S} P={P} "
                               f"D={D} W={W} depth={depth} ku4={ku4} vwu4={vwu4} R={R}")
    return worst


def read_kernel_on_lane_table(dkv, mk, win: dict, zipf_get: list, W: int = 16) -> int:
    """The read-only kernel on phase 7's full table at the lane's shapes:
    the probe and the GET window (with its decision), in the row and the
    dictionary form, on phase 7's key stream (uniform) and on a Zipf(1.2)
    one, every wave and the flags, against ``kv_window_plain`` and
    ``decide_window_plain``. Returns the largest absolute difference seen
    (must be 0)."""
    S, R, dev = dkv.S, mk.R, dkv.device
    alive = torch.ones((S, R), dtype=torch.bool, device=dev)
    base = torch.zeros(S, dtype=torch.int32, device=dev)
    kw = dict(want_table=False, want_reads=True)
    worst = 0
    windows = {"uniform rows": win["get rows"], "uniform dict": win["get dict"],
               "zipf rows": dkv.pack_get_window(zipf_get),
               "zipf dict": dkv.pack_get_window_auto(zipf_get)}
    _check(isinstance(windows["zipf dict"], DeviceDictOps),
           "the Zipf GET window was not a dictionary")
    for name, ops in windows.items():
        idx, klen, _, kwin, _ = dkv._upload(dkv._host_ops(ops, W, values=False))
        cases = [("probe", kv_window.kv_window_plain(dkv.state, kv_window.KIND_GET, klen, None,
                                                     kwin, None, 0, idx=idx, **kw),
                  kv_window.KV_WINDOW(dkv.state, kv_window.KIND_GET, klen, None, kwin, None, 0,
                                      idx=idx, **kw)),
                 ("GET window", kv_window.decide_window_plain(
                     mk, dkv.state, kv_window.KIND_GET, klen, None, kwin, None, W, alive, base, 4,
                     idx=idx, **kw),
                  kv_window.KV_WINDOW.decide(dkv.state, kv_window.KIND_GET, klen, None, kwin, None,
                                             W, alive, base, seed=mk.seed, coin_p1=mk.coin_p1,
                                             max_phases=4, idx=idx, **kw))]
        torch.cuda.synchronize(dev)
        for what, want, got in cases:
            want, got = _flat(want), _flat(got)
            _check(len(want) == len(got), f"{what} outputs differ in kind ({name})")
            for a, b in zip(want, got):
                worst = max(worst, _max_err(a, b))
                _check(torch.equal(a, b), f"read-only kernel {what} != plain on the lane's table "
                                          f"({name})")
            _check(bool(got[1].any()), f"{what} ({name}) found nothing")
    return worst


def _time_ms(fn, reps: int) -> float:
    fn()  # warm
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(reps):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: the call is captured once in a
    CUDA graph and replayed ``reps`` times between CUDA events, so the
    host's time to launch it is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: library load and allocator pools
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_busy(fn, reps: int, kernel: str = "") -> dict:
    """Wall and device time of one call of ``fn`` under torch.profiler:
    ``wall_ms`` is the host clock around calls that end in a synchronize,
    ``device_ms`` the sum of the traced device activities (kernels and
    copies), ``kernel_ms`` the part whose name contains ``kernel``. The
    device times are None when the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    dev_us = kern_us = 0.0
    kernels = 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", 0)
            dev_us += t
            kern_us += t if kernel and kernel in e.key else 0
            if not e.key.startswith(("Memcpy", "Memset")):
                kernels += e.count
    per = lambda us: us / 1e3 / reps if dev_us else None  # noqa: E731
    return {"wall_ms": wall_ms, "device_ms": per(dev_us), "kernel_ms": per(kern_us),
            "kernels": kernels / reps if dev_us else None}


# -- phase 5 -----------------------------------------------------------------


def serving_lane(device, S: int, R: int, window: int = 16) -> dict:
    """MeshEngine end to end; returns ops/s and cycle counts."""
    eng = MeshEngine(InMemoryStateMachine, n_shards=S, n_replicas=R, window=window, device=device)
    mw0 = mesh_window.MESH_WINDOW.launches
    t0 = time.perf_counter()
    sets = [eng.submit([f"SET k{s} v{s}"], s) for s in range(S)]
    gets = [eng.submit([f"GET k{s}"], s) for s in range(S)]
    applied = eng.flush()
    dt = time.perf_counter() - t0
    _check(applied == 2 * S, f"applied {applied} of {2 * S}")
    for s in range(S):
        _check(sets[s].result() == [b"OK"], f"SET on shard {s}")
        _check(gets[s].result() == [f"v{s}".encode()], f"GET on shard {s}")
    snaps = [sm.create_snapshot().to_bytes() for sm in eng.sms]
    _check(all(x == snaps[0] for x in snaps), "replica snapshots differ")
    for s in sorted({0, 1, S // 2, S - 1}):
        log = eng.decisions_for(s)
        _check(sorted(log) == [0, 1], f"decision log slots of shard {s}")
        _check([c.data for c in log[0][1].commands] == [f"SET k{s} v{s}".encode()]
               and log[0][0] == V1 and log[1][0] == V1, f"decision log of shard {s}")
    cycles_first = eng.cycles
    traced_s = None  # the profiled wave's seconds, on a card
    if torch.device(device).type == "cuda":
        # the engine's windows: one mw_window launch each on its pinned
        # staging buffer, and no copy (a further wave under the profiler)
        _check(mesh_window.MESH_WINDOW.launches - mw0 == eng._ring.windows > 0,
               f"{mesh_window.MESH_WINDOW.launches - mw0} mw_window launches for "
               f"{eng._ring.windows} windows")
        w0 = eng._ring.windows

        def wave():
            futs = [eng.submit([f"SET t{s} 1"], s) for s in range(S)]
            eng.flush()
            _check(all(f.result() == [b"OK"] for f in futs), "the traced wave")

        traced_s = time.perf_counter()
        with _trace("mesh_window") as trace:
            wave()
        traced_s = time.perf_counter() - traced_s
        _check(trace["launches"] == eng._ring.windows - w0 and trace["copies"] == 0
               and trace["host_allocs"] == 0,
               f"a window is one mw_window launch and no copy: {trace} over "
               f"{eng._ring.windows - w0} windows")

    # minority crash: commits continue
    eng.crash_replica(R - 1)
    eng.crash_replica(R - 2)
    more = [eng.submit([f"SET m{s} w{s}"], s) for s in range(S)]
    eng.flush()
    _check(all(f.result() == [b"OK"] for f in more), "commits under a minority crash")
    # majority crash: the flush stalls with a RabiaError, the batch parks
    eng.crash_replica(R - 3)
    parked = eng.submit(["SET parked 1"], 0)
    stalled = False
    try:
        eng.flush(max_cycles=3)
    except RabiaError:
        stalled = True
    _check(stalled and not parked.done(), "flush under a majority crash did not stall")
    for r in (R - 3, R - 2, R - 1):
        eng.heal_replica(r)
    eng.flush()
    _check(parked.result() == [b"OK"], "parked batch after heal")

    # checkpoint -> fresh engine -> restore -> resumes
    ckpt = eng.checkpoint()
    fresh = MeshEngine(InMemoryStateMachine, n_shards=S, n_replicas=R, window=window, device=device)
    fresh.restore(ckpt)
    _check(list(fresh.next_slot) == list(eng.next_slot), "restored slot counters")
    after = fresh.submit(["GET m1"], 1)
    fresh.flush()
    _check(after.result() == [b"w1"], "restored state")
    _check(int(eng.next_slot[1]) in fresh.decisions_for(1), "resumed at the next slot")

    tput = fresh.throughput(batches_per_shard=4)
    return {
        "windows": eng._ring.windows + fresh._ring.windows,
        "mapped_bytes": eng._ring.mapped_bytes + fresh._ring.mapped_bytes,
        "traced_wave_s": traced_s,
        "first_flush_s": dt,
        "first_flush_ops_per_s": 2 * S / dt,
        "first_flush_cycles": cycles_first,
        "throughput_ops_per_s": tput["decisions_per_sec"],
        "throughput_applied": tput["applied"],
    }


# -- phase 7 -----------------------------------------------------------------


def _set_op(key: bytes, val: bytes) -> bytes:
    return b"\x01" + len(key).to_bytes(2, "little") + key + val


def _key_op(code: int, key: bytes) -> bytes:
    return bytes((code,)) + len(key).to_bytes(2, "little") + key


def _key(s: int, j: int) -> bytes:
    """Key j of shard s, 9 to 32 bytes long."""
    return (b"k%d.%d." % (j, s)).ljust(8 + (j * 7 + s) % 25, b"x")


def _value(rng, w: int, s: int) -> bytes:
    """0 to 64 bytes; about one value in twenty is not UTF-8."""
    n = int(rng.integers(0, 65))
    v = (b"v%d.%d." % (w, s) * 8)[:n]
    return v[:-1] + b"\xff" if n and rng.random() < 0.05 else v


def _snapshot_sans_clock(sm) -> bytes:
    """A replica's store snapshot with the wall-clock stamps zeroed (the
    two lanes write their rows at different times). Zeroes them in place."""
    st = sm.store
    st.created[:] = 0.0
    st.updated[:] = 0.0
    for ent in st._overflow.values():
        ent[2] = ent[3] = 0.0
    return st.snapshot_bytes()


def device_kv_lane(device, S: int, R: int, window: int = 16, P: int = P_FULL, seed: int = 7,
                   mesh=None, want: Optional[dict] = None):
    """A device_store=True engine and a host-lane engine, both over
    VectorShardedKV replicas, driven with the same blocks and compared
    (see phase 7 in the module doc). Returns (stats, device engine); the
    stats hold, under ``"_record"``, the host lane's responses, slot
    counters, decision logs and store. With ``want`` (such a record) the
    host lane is not run again: the device engine, over ``mesh`` where one
    is given, takes the same stream and is held against the record
    (phase 18 (b))."""
    rng = np.random.default_rng(seed)
    shards = list(range(S))

    def make(device_store: bool) -> MeshEngine:
        where = {"device": device} if mesh is None or not device_store else {"mesh": mesh}
        return MeshEngine(
            lambda: VectorShardedKV(S, capacity=max(1 << 16, 4 * S * P)), S, R,
            window=window, device_store=device_store,
            device_store_kw={"per_shard_capacity": P}, device_store_repromote=2, **where,
        )

    dev = make(True)
    host = make(False) if want is None else None
    engines = (dev,) if host is None else (dev, host)
    mw0 = mesh_window.MESH_WINDOW.launches
    pairs = []  # (device future, host future or None) per block

    def both(blocks) -> tuple[float, Optional[float]]:
        """Submit + flush on each engine; returns the wall times."""
        out = []
        for eng in engines:
            t0 = time.perf_counter()
            fs = [eng.submit_block(b) for b in blocks]
            eng.flush()
            out.append((fs, time.perf_counter() - t0))
        pairs.extend(zip(out[0][0], out[1][0] if host else [None] * len(blocks)))
        return out[0][1], out[1][1] if host else None

    def wave(ops) -> object:
        return build_block(shards, [[op] for op in ops])

    def lane_is(active: bool, what: str) -> None:
        _check(dev.device_lane_active == active,
               f"device lane {'inactive' if active else 'active'} {what}")

    def rates(what: str, ops: int, dev_s: float, host_s: Optional[float]) -> dict:
        out = {f"device_{what}_ops_per_s": ops / dev_s}
        if host_s is not None:
            out[f"host_{what}_ops_per_s"] = ops / host_s
        return out

    # a. fill every slot of every shard: 64 full-width SET waves
    fill = [wave([_set_op(_key(s, j), _value(rng, j, s)) for s in shards]) for j in range(P)]
    dev_s, host_s = both(fill)
    lane_is(True, "after the SET waves")
    stats = {"set_ops": P * S, "device_set_s": dev_s, **rates("set", P * S, dev_s, host_s)}
    if host_s is not None:
        stats["host_set_s"] = host_s
    # b. GET waves, some of keys never set
    gets = [wave([_key_op(2, _key(s, int(rng.integers(0, P + 8)))) for s in shards])
            for _ in range(LANE_READ_WAVES)]
    stats.update(rates("get", LANE_READ_WAVES * S, *both(gets)))
    lane_is(True, "after the GET waves")

    # c. mixed waves: per op SET (of a known key), GET, DEL, EXISTS; shard
    # 0 never deletes, so it stays full for the overflow below
    def mixed_op(w, s):
        j = int(rng.integers(0, P + 8))
        k = int(rng.integers(0, 4 if s else 3))
        if k == 0:
            return _set_op(_key(s, j % P), _value(rng, 100 + w, s))
        return _key_op((2, 4, 3)[k - 1], _key(s, j))

    mixed = [wave([mixed_op(w, s) for s in shards]) for w in range(LANE_READ_WAVES)]
    stats.update(rates("mixed", LANE_READ_WAVES * S, *both(mixed)))
    lane_is(True, "after the mixed waves")

    # d. a fresh key on full shard 0: overflow -> dirty -> rollback -> demote
    both([wave([_set_op(b"fresh", b"!")] + [_key_op(2, _key(s, 0)) for s in shards[1:]])])
    lane_is(False, "after the overflow")

    # e. clean waves until the lane re-promotes (shard 0 back to P keys)
    both([wave([_key_op(3, b"fresh")] + [_key_op(4, _key(s, 1)) for s in shards[1:]])])
    for w in range(8):
        both([wave([_set_op(_key(s, w), _value(rng, 200 + w, s)) for s in shards])])
        if dev.device_lane_active:
            break
    lane_is(True, "after the clean waves (no re-promotion)")
    stats["repromoted_after_waves"] = w + 1

    # f. majority crash: the flush stalls, the block parks; heal commits it
    for eng in engines:
        for r in range(R - quorum_size(R) + 1):
            eng.crash_replica(R - 1 - r)
    crash_block = wave([_set_op(_key(s, 2), b"crash") for s in shards])
    parked = []
    for eng in engines:
        parked.append(eng.submit_block(crash_block))
        stalled = False
        try:
            eng.flush(max_cycles=3)
        except RabiaError:
            stalled = True
        _check(stalled and not parked[-1].done(), "flush under a majority crash did not stall")
    for eng in engines:
        for r in range(R):
            eng.heal_replica(r)
        eng.flush()
    pairs.append((parked[0], parked[1] if host else None))
    lane_is(False, "after the majority crash")

    # g. heal: clean waves until the lane re-promotes again
    for w in range(8):
        both([wave([_set_op(_key(s, 3 + w), _value(rng, 300 + w, s)) for s in shards])])
        if dev.device_lane_active:
            break
    lane_is(True, "after the heal (no re-promotion)")

    # every response frame byte-equal, the slot counters and decision logs
    # equal (block ids aside: a replay builds its blocks anew)
    def frames(f) -> list:
        return [list(map(bytes, g)) for g in f.result()]

    def logs(eng, ids: bool = False) -> dict:
        return {s: {slot: (v, b.id if ids else None, [c.data for c in b.commands])
                    for slot, (v, b) in eng.decisions_for(s).items()}
                for s in sorted({0, 1, S // 2, S - 1})}

    if host is not None:
        # both engines took the same block objects: their logs agree on ids too
        _check(logs(dev, True) == logs(host, True), "decision logs differ")
        want = {"frames": [frames(fh) for _, fh in pairs], "next_slot": host.next_slot.copy(),
                "decided_v1": host.decided_v1, "logs": logs(host)}
    _check(len(pairs) == len(want["frames"]), "the device lane's stream has another length")
    for i, (fd, _) in enumerate(pairs):
        _check(frames(fd) == want["frames"][i], f"responses of block {i} differ from the host "
                                                f"lane's")
    _check(bool((dev.next_slot == want["next_slot"]).all())
           and dev.decided_v1 == want["decided_v1"], "slot counters differ")
    _check(logs(dev) == want["logs"], "decision logs differ")
    # the device table into the replicas: every store equals the host lane's
    dev.sync_to_host()
    lane_is(False, "after sync_to_host")
    if host is not None:
        want["snapshot"] = _snapshot_sans_clock(host.sms[0])
    for eng in engines:
        for sm in eng.sms:
            _check(_snapshot_sans_clock(sm) == want["snapshot"],
                   "replica store differs from the host lane's")
    stats.update(blocks=len(pairs), entries=len(dev.sms[0].store), cycles=dev.cycles)
    if mesh is None:
        stats["mw_windows"] = _check_window_launches(engines, mw0, "phase 7")
    stats["_record"] = want
    return stats, dev


def lane_programs(dkv, S: int, R: int, W: int = 16) -> dict:
    """``decide_apply``, ``lookup_window``, ``mixed_apply`` and
    ``lookup_only`` through a device table (on its current table, read
    and written functionally: nothing is adopted), each in the row form
    and in the dictionary form: each call must be one kv-window launch
    of its form, no mesh-window launch and one host-to-device upload,
    and a clean window's flags must be clean. Returns the packed windows,
    for timing."""
    alive, base = np.ones((S, R), bool), np.zeros(S, np.int32)
    shards = range(S)
    set_blocks = [build_block(shards, [[_set_op(_key(s, j), b"timed")] for s in shards])
                  for j in range(W)]
    get_blocks = [build_block(shards, [[_key_op(2, _key(s, j))] for s in shards]) for j in range(W)]
    mixed_blocks = [build_block(shards, [[_key_op((2, 3, 4)[(j + s) % 3], _key(s, j)) if (j + s) % 4
                                          else _set_op(_key(s, j), b"m")] for s in shards])
                    for j in range(W)]
    win = {
        "set rows": dkv.pack_window(set_blocks), "set dict": dkv.pack_window_dict(set_blocks),
        "get rows": dkv.pack_get_window(get_blocks), "get dict": dkv.pack_get_window_auto(get_blocks),
        "mixed rows": dkv.pack_mixed_window(mixed_blocks),
        "mixed dict": dkv.pack_mixed_window_auto(mixed_blocks)[:2],
    }
    _check(all(isinstance(win[f"{k} dict"], DeviceDictOps) or isinstance(win[f"{k} dict"][1],
                                                                         DeviceDictOps)
               for k in ("set", "get", "mixed")), "a W=16 window was not packed as a dictionary")
    for form in ("rows", "dict"):
        kind, mixed = win[f"mixed {form}"]
        get_waves = np.nonzero((kind >= 2).any(axis=1))[0].astype(np.int32)
        calls = {
            "decide_apply": lambda: dkv.decide_apply(alive, base, W, win[f"set {form}"], W=W),
            "lookup_window": lambda: dkv.lookup_window(alive, base, W, win[f"get {form}"], W=W),
            "mixed_apply": lambda: dkv.mixed_apply(alive, base, W, kind, get_waves, mixed, W=W),
            "lookup_only": lambda: dkv.lookup_only(win[f"get {form}"], W=W),
        }
        keys = {"lookup_only": f"probe {form}", "lookup_window": f"lookup {form}"}
        for what, call in calls.items():
            key = keys.get(what, f"{form}+decide")
            counts, mw0 = dict(kv_window.KV_WINDOW.counts), mesh_window.MESH_WINDOW.launches
            up0 = dkv.uploads
            out = call()
            torch.cuda.synchronize()
            counts[key] += 1
            _check(kv_window.KV_WINDOW.counts == counts
                   and mesh_window.MESH_WINDOW.launches == mw0,
                   f"{what} ({form}) was not one kv-window launch of its form and no mesh launch")
            _check(dkv.uploads - up0 == 1,
                   f"{what} ({form}) made {dkv.uploads - up0} host-to-device uploads, not one")
            if what == "lookup_only":
                _check(bool(out[0].any()), f"{what} ({form}) found nothing")
                continue
            flags = out[0] if what == "lookup_window" else out[1]
            _check(bool((flags == 1).all()) if what == "lookup_window"
                   else flags.tolist() == [1, 0, 0],
                   f"{what} ({form}): a clean window reported flags {flags.tolist()}")
    return win


def _zipf_keys(rng, n: int, S: int, P: int) -> np.ndarray:
    """Key ranks i64[n, S] of each shard's P keys under Zipf(1.2)
    (BASELINE config 5's ``zipf_s``), rank 0 the hottest."""
    w = 1.0 / np.arange(1, P + 1) ** 1.2
    return rng.choice(P, size=(n, S), p=w / w.sum())


def device_read_lane(device, S: int, R: int, window: int = 16, P: int = P_FULL, seed: int = 9,
                     groups: int = 4, mesh=None, want: Optional[dict] = None):
    """The read lane at full width: a ``device_read_lane=True`` engine, a
    device-lane engine with the read lane off, and a host block-lane
    engine, all filled with phase 7's 64 SET waves, then driven with a
    90/10 GET/SET stream of full-width blocks (groups of 9 GET blocks and
    1 SET block, a flush after each group) under two key streams:
    phase 7's (uniform keys, some never set, a fresh value per op) and a
    Zipf(1.2) one (a key repeats its value within a group). Every
    response of the read lane equals the read-lane-off engine's; the
    first LANE_HOST_GETS GET blocks and the SET block of each stream's
    first group are also held against the host lane (whose GETs are
    Python per op; the other blocks give it only their SET blocks, so the
    stores stay equal). Returns (stats, read-lane engine); the stats hold,
    under ``"_record"``, the read lane's responses and store. With
    ``want`` (such a record) only the read-lane engine runs, over ``mesh``
    where one is given, held against the record (phase 18 (b))."""
    rng = np.random.default_rng(seed)
    shards = list(range(S))

    def make(device_store: bool, read_lane: bool = False) -> MeshEngine:
        where = {"device": device} if mesh is None or not device_store else {"mesh": mesh}
        return MeshEngine(
            lambda: VectorShardedKV(S, capacity=max(1 << 16, 4 * S * P)), S, R,
            window=window, device_store=device_store,
            device_store_kw={"per_shard_capacity": P}, device_read_lane=read_lane, **where,
        )

    lane = make(True, True)
    slots, host = (make(True), make(False)) if want is None else (None, None)
    engines = [e for e in (lane, slots, host) if e is not None]
    mw0 = mesh_window.MESH_WINDOW.launches

    def wave(ops) -> object:
        return build_block(shards, [[op] for op in ops])

    def frames(f) -> list:
        return [list(map(bytes, x)) for x in f.result()]

    fill = [wave([_set_op(_key(s, j), _value(rng, j, s)) for s in shards]) for j in range(P)]
    for eng in engines:
        for b in fill:
            eng.submit_block(b)
        eng.flush()
    stats = {}
    record = {"frames": []}
    for stream in ("uniform", "zipf"):
        grps = []
        for g in range(groups):
            if stream == "uniform":
                ks = rng.integers(0, P + 8, (10, S))
                vals = [_value(rng, 400 + g, s) for s in shards]
            else:
                ks = _zipf_keys(rng, 10, S, P)
                vals = [b"z%d.%d" % (g, int(ks[9, s])) for s in shards]
            grp = [wave([_key_op(2, _key(s, int(ks[i, s]))) for s in shards]) for i in range(9)]
            grp.append(wave([_set_op(_key(s, int(ks[9, s]) % P), vals[s]) for s in shards]))
            grps.append(grp)
        futs, secs = {}, {}
        before = (lane.read_lane_stats(), lane.decided_v1,
                  None if slots is None else slots.decided_v1)
        for name, eng in (("lane", lane), ("slots", slots), ("host", host)):
            if eng is None:
                continue
            futs[name] = []
            t0 = time.perf_counter()
            for g, grp in enumerate(grps):
                sent = grp if name != "host" else grp[:LANE_HOST_GETS if g == 0 else 0] + grp[-1:]
                futs[name].append([eng.submit_block(b) for b in sent])
                eng.flush()
            secs[name] = time.perf_counter() - t0
        got = [[frames(f) for f in fs] for fs in futs["lane"]]
        record["frames"].append(got)
        if want is not None:
            _check(got == want["frames"][len(record["frames"]) - 1],
                   f"read lane responses differ from the recorded lane's ({stream})")
        else:
            for g in range(groups):
                for fl, fs in zip(futs["lane"][g], futs["slots"][g]):
                    _check(frames(fl) == frames(fs),
                           f"read lane responses differ from the consensus GET window's "
                           f"({stream}, group {g})")
            for fl, fh in zip(futs["lane"][0][:LANE_HOST_GETS] + futs["lane"][0][-1:],
                              futs["host"][0]):
                _check(frames(fl) == frames(fh),
                       f"read lane responses differ from the host lane's ({stream})")
        rl = lane.read_lane_stats()
        read_slots = lane.decided_v1 - before[1] - groups * S  # the SET blocks take S each
        _check(read_slots == 0, f"probe reads consumed {read_slots} slots ({stream})")
        _check(rl["probe"] - before[0]["probe"] == groups * 9 * S,
               f"not every GET was served off consensus ({stream})")
        if slots is not None:
            _check(slots.decided_v1 - before[2] == groups * 10 * S,
                   "the read-lane-off engine's slots")
        ops = groups * 10 * S
        stats[stream] = {
            "ops": ops, "probe_windows": rl["probe_windows"] - before[0]["probe_windows"],
            "read_slots": read_slots, "fallback": rl["fallback"] - before[0]["fallback"],
            "lane_ops_per_s": ops / secs["lane"],
        }
        if slots is not None:
            stats[stream]["lane_off_ops_per_s"] = ops / secs["slots"]
    for eng in engines:
        _check(eng.device_lane_active == (eng is not host), "a device lane demoted")
    # every store equal after the streams
    for eng in engines:
        if eng is not host:
            eng.sync_to_host()
    record["snapshot"] = (_snapshot_sans_clock(host.sms[0]) if want is None
                          else want["snapshot"])
    for eng in engines:
        _check(_snapshot_sans_clock(eng.sms[0]) == record["snapshot"],
               "a store differs from the host lane's")
    if mesh is None:
        stats["mw_windows"] = _check_window_launches(engines, mw0, "phase 8")
    stats["_record"] = record
    return stats, lane


def pack_costs(dkv, S: int, P: int = P_FULL, W: int = 16, seed: int = 10, reps: int = 5) -> dict:
    """Host ms of the packers and the op-plane bytes a window uploads, row
    form against the ``_auto`` (dictionary) packers, for a SET and a GET
    window of W full-width blocks under phase 7's fill stream (every op a
    distinct row) and the Zipf(1.2) stream."""
    rng = np.random.default_rng(seed)
    shards = range(S)
    out = {}
    for stream in ("fill", "zipf"):
        ks = (np.broadcast_to(np.arange(W)[:, None], (W, S)) if stream == "fill"
              else _zipf_keys(rng, W, S, P))
        sets = [build_block(shards, [[_set_op(_key(s, int(ks[t, s])),
                                               b"z%d" % ks[t, s] if stream == "zipf"
                                               else _value(rng, t, s))] for s in shards])
                for t in range(W)]
        gets = [build_block(shards, [[_key_op(2, _key(s, int(ks[t, s])))] for s in shards])
                for t in range(W)]
        for what, blocks, rows_fn, auto_fn, values in (
            ("set", sets, dkv.pack_window, dkv.pack_window_auto, True),
            ("get", gets, dkv.pack_get_window, dkv.pack_get_window_auto, False),
        ):
            row = {}
            for form, fn in (("rows", rows_fn), ("auto", auto_fn)):
                t0 = time.perf_counter()
                for _ in range(reps):
                    ops = fn(blocks)
                row[f"{form}_host_ms"] = (time.perf_counter() - t0) * 1e3 / reps
                row[f"{form}_upload_bytes"] = sum(
                    a.nbytes for a in dkv._host_ops(ops, W, values) if a is not None)
                if form == "auto":
                    row["D"] = int(ops.dkl.shape[1]) if isinstance(ops, DeviceDictOps) else None
            out[f"{stream} {what}"] = row
    return out


# -- phase 9 -----------------------------------------------------------------


def ladder_blocks(S: int, P: int = P_FULL, seed: int = 13) -> dict:
    """32 full-width blocks of each kind for the window ladder; wave t of
    a window is block t % 32, so a window of any W has at most 32
    distinct op rows a shard (its dictionary form exists at every W).
    Shard s's wave t names key (3t + s) mod (P + 8): keys past P were
    never set (a GET misses). SET values are phase 7's; a mixed wave's op
    is SET, GET, DEL or EXISTS by (t + s) mod 4."""
    rng = np.random.default_rng(seed)
    shards = range(S)
    j = [[(3 * t + s) % (P + 8) for s in shards] for t in range(32)]
    vals = [[_value(rng, 500 + t, s) for s in shards] for t in range(32)]

    def mixed_op(t, s):
        k = (t + s) % 4
        if k == 0:
            return _set_op(_key(s, j[t][s] % P), vals[t][s])
        return _key_op((2, 3, 4)[k - 1], _key(s, j[t][s]))

    return {
        "set": [build_block(shards, [[_set_op(_key(s, j[t][s] % P), vals[t][s])] for s in shards])
                for t in range(32)],
        "get": [build_block(shards, [[_key_op(2, _key(s, j[t][s]))] for s in shards])
                for t in range(32)],
        "mixed": [build_block(shards, [[mixed_op(t, s)] for s in shards]) for t in range(32)],
    }


def _ladder_planes(dkv, kind, ops, W: int, values: bool = True) -> list:
    """A window's planes on the device as the table's programs upload
    them: ``[kind, idx, klen, vlen, kwin, vwin]`` (``kind`` stays what it
    was unless it is a plane)."""
    planes = dkv._host_ops(ops, W, values)
    if isinstance(kind, np.ndarray):
        return dkv._upload([kind, *planes])
    return [kind, *dkv._upload(planes)]


def _gathered_rows(n: int, device) -> torch.Tensor:
    """``mixed_apply``'s row index: the GET waves, padded to a power of two."""
    return torch.zeros(1 << max(0, n - 1).bit_length(), dtype=torch.int64, device=device)


def window_ladder(dkv, mk, S: int, R: int, blocks: dict, seed: int = 14):
    """The device lane's programs at every W of the governor's ladder, on
    ``dkv``'s table, through the table's entry points (one kernel launch
    each: ``decide_apply``, ``mixed_apply``, ``lookup_window`` and
    ``lookup_only`` in the row and the dictionary form), and
    ``slot_window`` at T = W on phase 2b's votes (all four codes, a crash
    mask, bases near the wrap). Every output byte is held against the
    plain version on the same inputs. Returns ({W: (packed windows, the
    slot window's inputs)}, for timing; the largest error)."""
    dev = dkv.device
    alive = np.ones((S, R), bool)
    base = np.zeros(S, np.int32)
    alive_d, base_d = dkv._upload([alive, base])
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = dkv.state
    out, worst = {}, 0

    def check(got, want, what):
        nonlocal worst
        got, want = _flat(got), _flat(want)
        _check(len(got) == len(want), f"{what}: {len(got)} outputs, plain {len(want)}")
        err = max(_max_err(a, b) for a, b in zip(got, want))
        _check(err == 0, f"{what} != plain (max_abs_err {err})")
        worst = max(worst, err)

    for W in LADDER:
        take = {k: [blocks[k][t % 32] for t in range(W)] for k in blocks}
        win = {
            "set rows": dkv.pack_window(take["set"]), "set dict": dkv.pack_window_auto(take["set"]),
            "get rows": dkv.pack_get_window(take["get"]),
            "get dict": dkv.pack_get_window_auto(take["get"]),
            "mixed rows": dkv.pack_mixed_window(take["mixed"]),
            "mixed dict": dkv.pack_mixed_window_auto(take["mixed"])[:2],
        }
        _check(all(isinstance(win[f"{k} dict"], DeviceDictOps)
                   or isinstance(win[f"{k} dict"][1], DeviceDictOps)
                   for k in ("set", "get", "mixed")),
               f"a ladder window at W={W} was not packed as a dictionary")
        for form in ("rows", "dict"):
            _, idx, klen, vlen, kw, vw = _ladder_planes(dkv, None, win[f"set {form}"], W)
            new, flags = dkv.decide_apply(alive, base, W, win[f"set {form}"], W=W)
            want = kv_window.decide_window_plain(mk, state, None, klen, vlen, kw, vw, W, alive_d,
                                                 base_d, 4, idx=idx)
            check((new, flags), (want[0], want[3]), f"decide_apply ({form}) W={W}")
            _check(flags.tolist() == [1, 0, 0], f"decide_apply ({form}) W={W}: flags {flags.tolist()}")
            kind, mixed = win[f"mixed {form}"]
            get_waves = np.nonzero((kind >= 2).any(axis=1))[0].astype(np.int32)
            kind_d, idx, klen, vlen, kw, vw = _ladder_planes(dkv, kind, mixed, W)
            got = dkv.mixed_apply(alive, base, W, kind, get_waves, mixed, W=W)
            new, _, reads, flags = kv_window.decide_window_plain(
                mk, state, kind_d, klen, vlen, kw, vw, W, alive_d, base_d, 4, idx=idx,
                want_reads=True)
            g = _gathered_rows(len(get_waves), dev)
            g[: len(get_waves)] = torch.from_numpy(get_waves).to(dev)
            meta = torch.stack([reads.ver[g], (reads.vlen[g] << 1) | reads.found[g].to(torch.int32)])
            check(got, (new, flags, meta, reads.val[g]), f"mixed_apply ({form}) W={W}")
            _, idx, klen, _, kw, _ = _ladder_planes(dkv, kv_window.KIND_GET, win[f"get {form}"], W,
                                                    values=False)
            got = dkv.lookup_window(alive, base, W, win[f"get {form}"], W=W)
            _, _, reads, flags = kv_window.decide_window_plain(
                mk, state, kv_window.KIND_GET, klen, None, kw, None, W, alive_d, base_d, 4,
                idx=idx, want_table=False, want_reads=True)
            check(got, (flags[0], reads), f"lookup_window ({form}) W={W}")
            _check(bool(reads.found.any()) and (W < 8 or not bool(reads.found.all())),
                   f"lookup_window ({form}) W={W}: no hit, or no miss")
            got = dkv.lookup_only(win[f"get {form}"], W=W)
            want = kv_window.kv_window_plain(state, kv_window.KIND_GET, klen, None, kw, None, 0,
                                             idx=idx, want_table=False, want_reads=True)
            check(got, want[2], f"lookup_only ({form}) W={W}")
        votes, valive, vbase = mesh_case(gen, S, R, W, dev)
        check([mk.slot_window(votes, valive, vbase, n_slots=W)],
              [mk.decide_slots_plain(votes, valive, vbase, 4)], f"slot_window T={W}")
        out[W] = (win, (votes, valive, vbase))
    return out, worst


def _hits(found: torch.Tensor, ver: torch.Tensor) -> int:
    """Distinct (shard, version) pairs a read found: the slots whose
    version, value length and value it must read."""
    s = torch.nonzero(found)[:, 1].to(torch.int64)
    return int(torch.unique((s << 32) | ver[found].to(torch.int64)).numel())


def ladder_times(dkv, mk, S: int, R: int, ladder: dict, rate: float,
                 reps: int = 20) -> tuple[dict, dict]:
    """Device time (CUDA graph replay) of each ladder program's kernel at
    every W, beside its bound: the bytes that the function must read and
    write at that W (each input once, each output once; of the table, a
    read reads the used flags, keys and key lengths and the found slots'
    rows) over the card's memory rate; the slot window's also its least
    integer operations. Returns {W: {program: (ms, bound ms)}}, and {W:
    {program: ms}} of the dictionary form's write windows' least integer
    operations (``dict_window_ops``), which their bytes outweigh."""
    state = dkv.state
    tbl = sum(x.numel() * x.element_size() for x in state)
    alive_d, base_d = dkv._upload([np.ones((S, R), bool), np.zeros(S, np.int32)])
    decide_kw = dict(seed=mk.seed, coin_p1=mk.coin_p1, max_phases=4)
    decide_bytes = alive_d.numel() + 4 * S + 4 * 3  # alive, base, flags

    def nbytes(xs) -> int:
        return sum(x.numel() * x.element_size() for x in xs if isinstance(x, torch.Tensor))

    VW4, K4 = state.valw.shape[2], state.keyw.shape[2]
    times, ops_ms = {}, {}
    for W, (win, (votes, valive, vbase)) in ladder.items():
        row, ops_ms[W] = {}, {}
        reads_out = W * S * (1 + 4 + 4 + 4 * VW4)
        for form in ("rows", "dict"):
            sp = _ladder_planes(dkv, None, win[f"set {form}"], W)
            call = lambda i=0, a=sp: kv_window.KV_WINDOW.decide(  # noqa: E731
                state, None, *a[2:], W, alive_d, base_d, idx=a[1], **decide_kw)
            row[f"set {form}"] = (_graph_ms(call, reps),
                                  (2 * tbl + nbytes(sp) + S + decide_bytes) / rate * 1e3)
            # the mixed window as mixed_apply launches it: its reads gathered
            # to the GET waves (G rows: version, (vlen << 1) | found, value)
            kind, mixed = win[f"mixed {form}"]
            mp = _ladder_planes(dkv, kind, mixed, W)
            g = _gidx(mp[0])
            call = lambda i=0, a=mp, g=g: kv_window.KV_WINDOW.decide(  # noqa: E731
                state, a[0], *a[2:], W, alive_d, base_d, idx=a[1], want_reads=True, gidx=g,
                **decide_kw)
            gathered = g.numel() * S * (8 + 4 * VW4)
            row[f"mixed {form}"] = (_graph_ms(call, reps), (2 * tbl + nbytes((*mp, g)) + S
                                                           + gathered + decide_bytes) / rate * 1e3)
            if form == "dict":
                for k, planes in (("set dict", sp), ("mixed dict", mp)):
                    ops_ms[W][k] = dict_window_ops(S, state.used.shape[1], planes[2].shape[1], W,
                                                   K4) / INT32_OPS_PER_S * 1e3
            gp = _ladder_planes(dkv, kv_window.KIND_GET, win[f"get {form}"], W, values=False)
            probe = lambda i=0, a=gp: kv_window.KV_WINDOW(  # noqa: E731
                state, kv_window.KIND_GET, a[2], None, a[4], None, 0, idx=a[1], want_table=False,
                want_reads=True)
            lookup = lambda i=0, a=gp: kv_window.KV_WINDOW.decide(  # noqa: E731
                state, kv_window.KIND_GET, a[2], None, a[4], None, W, alive_d, base_d, idx=a[1],
                want_table=False, want_reads=True, **decide_kw)
            reads = probe()[2]
            read_in = (state.used.numel() + 4 * (state.keyw.numel() + state.klen.numel())
                       + _hits(reads.found, reads.ver) * (8 + 4 * VW4) + nbytes(gp))
            row[f"probe {form}"] = (_graph_ms(probe, reps), (read_in + reads_out + S) / rate * 1e3)
            row[f"get {form}"] = (_graph_ms(lookup, reps),
                                  (read_in + reads_out + S + decide_bytes + 4 * S) / rate * 1e3)
        mw_call = lambda i=0: mesh_window.MESH_WINDOW(  # noqa: E731
            votes, valive, vbase, seed=mk.seed, coin_p1=mk.coin_p1, max_phases=4)
        phases, coins = mesh_work(mk, votes, valive, vbase, 4)
        mw_bytes = votes.numel() + valive.numel() + 4 * vbase.numel() + W * S
        mw_ops = W * S * 3 * R + 10 * phases + 24 * coins
        row["slot_window"] = (_graph_ms(mw_call, reps),
                              max(mw_bytes / rate, mw_ops / INT32_OPS_PER_S) * 1e3)
        times[W] = row
    return times, ops_ms


def _drive(eng, blocks, walk: list) -> list:
    """Submit ``blocks`` and run cycles until the engine is idle, noting
    each window size the governor moves to. Returns the block futures."""
    futs = [eng.submit_block(b) for b in blocks]
    for _ in range(100_000):
        if not eng._has_pending():
            break
        eng.run_cycle()
        if eng.window != walk[-1]:
            walk.append(eng.window)
    _check(not eng._has_pending(), "a governed engine did not drain")
    return futs


def _same_responses(fa, fb, what: str) -> None:
    for i, (a, b) in enumerate(zip(fa, fb)):
        _check([list(map(bytes, g)) for g in a.result()] == [list(map(bytes, g)) for g in b.result()],
               f"{what}: the responses of block {i} differ")


def governed_lane(device, S: int, R: int, P: int = P_FULL, seed: int = 15,
                  set_blocks: int = GOV_SET_BLOCKS, groups: int = GOV_GROUPS):
    """The governed device lane at full width (phase 9c in the module
    doc). Returns (stats, the engines whose every window the C pack
    gather must have served)."""
    rng = np.random.default_rng(seed)
    shards = list(range(S))

    def make(target=None, device_store=True, **kw) -> MeshEngine:
        return MeshEngine(
            lambda: VectorShardedKV(S, capacity=max(1 << 16, 4 * S * P)), S, R, device=device,
            device_store=device_store, device_store_kw={"per_shard_capacity": P},
            latency_target_ms=target, **kw)

    loose = make(GOV_LOOSE_MS, window=4, min_window=1, max_window=GOV_MAX_WINDOW)
    tight = make(GOV_TIGHT_MS, window=16, min_window=1, max_window=GOV_MAX_WINDOW)
    host, plain = make(device_store=False, window=16), make(window=16)
    for eng in (loose, tight):
        _check(eng.governor_stats()["inflight"] == 1, "a governed lane is not one window deep")

    def wave(ops):
        return build_block(shards, [[op] for op in ops])

    # a saturating full-width SET stream (keys within each shard's P slots)
    sets = [wave([_set_op(_key(s, int(k)), _value(rng, 700 + t, s))
                  for s, k in enumerate(rng.integers(0, P, S))]) for t in range(set_blocks)]
    walks = {"loose": [loose.window], "tight": [tight.window]}
    t0 = time.perf_counter()
    f_loose = _drive(loose, sets, walks["loose"])
    loose_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f_tight = _drive(tight, sets, walks["tight"])
    tight_s = time.perf_counter() - t0
    f_host = [host.submit_block(b) for b in sets]
    host.flush()
    _same_responses(f_loose, f_host, "the loose target's SET stream vs the host lane")
    _same_responses(f_tight, f_host, "the tight target's SET stream vs the host lane")
    for eng in (loose, tight):
        _check(bool((eng.next_slot == host.next_slot).all()) and eng.decided_v1 == host.decided_v1,
               "a governed lane's slot counters differ from the host lane's")
    loose_set = loose.governor_stats()
    # the 90/10 GET/SET stream: groups of 9 GET blocks (keys within P + 8,
    # some never set) and 1 SET block. Every response of the governed lane
    # equals an ungoverned device lane's; the first GET block and every
    # SET block also the host lane's (which serves GETs op by op in
    # Python, about 2k ops/s)
    for b in sets:
        plain.submit_block(b)
    plain.flush()
    stream = []
    for g in range(groups):
        ks = rng.integers(0, P + 8, (10, S))
        stream += [wave([_key_op(2, _key(s, int(ks[i, s]))) for s in shards]) for i in range(9)]
        stream.append(wave([_set_op(_key(s, int(ks[9, s]) % P), _value(rng, 800 + g, s))
                            for s in shards]))
    slots0 = loose.next_slot.copy()
    t0 = time.perf_counter()
    f_loose = _drive(loose, stream, walks["loose"])
    mixed_s = time.perf_counter() - t0
    f_plain = [plain.submit_block(b) for b in stream]
    plain.flush()
    _same_responses(f_loose, f_plain, "the loose target's 90/10 stream vs the device lane")
    host_idx = [0] + [10 * g + 9 for g in range(groups)]
    f_host = [host.submit_block(stream[i]) for i in host_idx]
    host.flush()
    _same_responses([f_loose[i] for i in host_idx], f_host,
                    "the loose target's 90/10 stream vs the host lane")
    _check(bool((loose.next_slot == plain.next_slot).all())
           and bool((loose.next_slot - slots0 == len(stream)).all()),
           "the 90/10 stream's slot counters")
    for eng in (loose, tight, plain):
        _check(eng.device_lane_active, "a device lane demoted")
    loose_st, tight_st = loose.governor_stats(), tight.governor_stats()
    _check(loose.window_resizes >= 1, f"the loose target never resized the window: {loose_st}")
    _check(tight.window == tight.min_window and tight_st["unachievable"] is True
           and tight_st["floor_ms"] is not None,
           f"the tight target did not park at min_window as unachievable: {tight_st}")
    prom = [ln for ln in loose.metrics.render_prometheus().splitlines()
            if ln.startswith(("rabia_mesh_window", "rabia_engine_decided_total",
                              "rabia_mesh_device_lane_active", "rabia_commit_stage_seconds_count",
                              "rabia_commit_stage_seconds_sum"))]
    # every store equals the host lane's (GETs mutate nothing)
    for eng in (loose, plain):
        eng.sync_to_host()
    want = _snapshot_sans_clock(host.sms[0])
    for eng in (loose, plain):
        for sm in eng.sms:
            _check(_snapshot_sans_clock(sm) == want, "a replica store differs from the host lane's")
    stats = {
        "loose": {**loose_st, "after_set_stream": loose_set, "walk": walks["loose"],
                  "set_ops_per_s": set_blocks * S / loose_s,
                  "90/10_ops_per_s": len(stream) * S / mixed_s},
        "tight": {**tight_st, "walk": walks["tight"], "set_ops_per_s": set_blocks * S / tight_s},
        "blocks": {"set": set_blocks, "90/10": len(stream)},
        "prometheus": prom,
    }
    return stats, [loose, tight, plain]


def _devpack(gather: str) -> None:
    """Route the window packers to the C gather or to numpy."""
    os.environ["RABIA_PY_DEVPACK"] = "1" if gather == "numpy" else "0"


def pack_native_vs_numpy(dkv, S: int, Ws, P: int = P_FULL, seed: int = 16, reps: int = 3) -> dict:
    """Host ms of the row packer and ``pack_window_auto`` on phase 7's
    fill stream (every op a distinct row) at each W, with the C gather
    and under ``RABIA_PY_DEVPACK=1`` (numpy), in turns (native, numpy,
    numpy, native): the two gathers' planes are byte-identical, and
    ``pack_stats`` shows which one packed each window."""
    rng = np.random.default_rng(seed)
    blocks = [build_block(range(S), [[_set_op(_key(s, t % P), _value(rng, t, s))] for s in range(S)])
              for t in range(max(Ws))]
    out = {}
    try:
        for W in Ws:
            row, packed = {}, {}
            for gather in ("native", "numpy", "numpy", "native"):
                _devpack(gather)
                before = dict(dkv.pack_stats)
                for form, fn in (("rows", dkv.pack_window), ("auto", dkv.pack_window_auto)):
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        packed[gather, form] = fn(blocks[:W])
                    row.setdefault(f"{gather} {form} host ms", []).append(
                        (time.perf_counter() - t0) * 1e3 / reps)
                grew = {k: dkv.pack_stats[k] - before[k] for k in before}
                want = {"native": 2 * reps, "numpy": 0, "bounds_trip": 0}
                if gather == "numpy":
                    want = {"native": 0, "numpy": 2 * reps, "bounds_trip": 0}
                _check(grew == want, f"pack_stats after the {gather} gather at W={W}: {grew}")
            for form in ("rows", "auto"):
                a, b = packed["native", form], packed["numpy", form]
                _check(type(a) is type(b) and all(x.tobytes() == y.tobytes() for x, y in zip(a, b)),
                       f"the native and numpy {form} planes differ at W={W}")
            out[W] = row
    finally:
        os.environ.pop("RABIA_PY_DEVPACK", None)
    return out


def lane_native_vs_numpy(device, S: int, R: int, P: int = P_FULL, seed: int = 17) -> dict:
    """Phase 7's SET lane (64 full-width SET waves into empty 64-slot
    tables, window 16) on fresh device-lane engines, with the C gather and
    under ``RABIA_PY_DEVPACK=1``, in turns (native, numpy, numpy, native):
    ops/s of each run; every response and the final table are equal."""
    rng = np.random.default_rng(seed)
    fill = [build_block(range(S), [[_set_op(_key(s, j), _value(rng, j, s))] for s in range(S)])
            for j in range(P)]
    rates, first = {"native": [], "numpy": []}, None
    try:
        for gather in ("native", "numpy", "numpy", "native"):
            eng = MeshEngine(lambda: VectorShardedKV(S, capacity=max(1 << 16, 4 * S * P)), S, R,
                             window=16, device=device, device_store=True,
                             device_store_kw={"per_shard_capacity": P})
            _devpack(gather)
            t0 = time.perf_counter()
            futs = [eng.submit_block(b) for b in fill]
            eng.flush()
            rates[gather].append(P * S / (time.perf_counter() - t0))
            st = eng._dev.pack_stats
            _check(eng.device_lane_active and st["bounds_trip"] == 0
                   and (st["numpy"] == 0 < st["native"] if gather == "native"
                        else st["native"] == 0 < st["numpy"]),
                   f"pack_stats of the {gather} SET lane: {st}")
            got = ([[bytes(g[0]) for g in f.result()] for f in futs], eng._dev.dump())
            if first is None:
                first = got
            _check(got[0] == first[0], f"the {gather} SET lane's responses differ")
            _check(all(np.array_equal(got[1][k], first[1][k]) for k in first[1]),
                   f"the {gather} SET lane's table differs")
    finally:
        os.environ.pop("RABIA_PY_DEVPACK", None)
    return rates


# -- the run -----------------------------------------------------------------


# -- phase 10 ----------------------------------------------------------------


def _set_waves(S: int, waves: int, per: int = 4, tag: str = "k") -> list:
    """Per wave {shard: [per SET commands]} on every shard."""
    return [{s: [f"SET {tag}{s}_{i} w{w}" for i in range(per)] for s in range(S)}
            for w in range(waves)]


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it (this path is bound to the
    host): model name, vendor, family and model, and the cores this
    process may use."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                key = key.strip()
                if key in ("model name", "vendor_id", "cpu family", "model") and key not in fields:
                    fields[key] = val.strip()
    except OSError:
        pass
    return (f"{fields.get('model name', 'unknown')} ({fields.get('vendor_id', '?')} family "
            f"{fields.get('cpu family', '?')} model {fields.get('model', '?')}, "
            f"{len(os.sched_getaffinity(0))} cores)")


def planes_gate(device, S: int, R: int, waves: int) -> tuple[dict, MeshEngine]:
    """The port's plane-conformance gate: one schedule of SET waves through
    a cluster of transport engines over the in-memory hub (the Python
    tick and the asyncio orchestration on the host) and through a
    MeshEngine on the card; decisions, futures and replica state must be
    equal (the gate raises otherwise). Returns the transport plane's
    figures and the MeshEngine."""
    t0 = time.perf_counter()
    out = asyncio.run(run_schedule_on_both_planes(
        _set_waves(S, waves), S, R, tag=f"planes S={S} R={R}", device=device))
    gate_s = time.perf_counter() - t0
    eng = out["mesh_engine"]
    _check(eng.device.type == torch.device(device).type,
           f"the planes gate's MeshEngine is on {eng.device}, not {device}")
    p50, p99 = settle_quantiles(out["settle_s"])
    _check(out["decided_slots"] == S * waves, "the transport plane decided a slot per batch")
    wall = out["transport_wall_s"]
    return {
        "shards": S, "replicas": R, "waves": waves,
        "decided_slots": out["decided_slots"],
        "transport_wall_s": wall,
        "wave_s": out["wave_s"],
        "transport_decisions_per_s": out["decided_slots"] / wall,
        "settle_p50_s": p50, "settle_p99_s": p99,
        "gate_s": gate_s,
    }, eng


def _mesh_log(eng, S: int) -> dict:
    return {s: {slot: (v, tuple(c.data for c in b.commands) if b is not None else None)
                for slot, (v, b) in eng.decisions_for(s).items()} for s in range(S)}


def mesh_persistence(device, eng, S: int, R: int) -> dict:
    """save_to / load_from on the card: the engine that decided the
    planes gate saves through FileSystemPersistence, a fresh engine loads
    it; slot counters and every replica's store must be equal, and a
    further wave must decide the same slots with the same batches and
    leave the same stores on both."""
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        asyncio.run(eng.save_to(FileSystemPersistence(d)))
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(d, "state.dat"))
        fresh = MeshEngine(InMemoryStateMachine, n_shards=S, n_replicas=R, window=2, device=device)
        t0 = time.perf_counter()
        _check(asyncio.run(fresh.load_from(FileSystemPersistence(d))), "load_from found no state")
        load_s = time.perf_counter() - t0
    stores = lambda e: [sm.create_snapshot().data for sm in e.sms]  # noqa: E731
    _check(list(fresh.next_slot) == list(eng.next_slot), "restored slot counters")
    _check(stores(fresh) == stores(eng), "restored replica stores")
    before = _mesh_log(eng, S)
    for e in (eng, fresh):
        futs = [e.submit([f"SET p{s} after"], s) for s in range(S)]
        e.flush()
        _check(all(f.result() == [b"OK"] for f in futs), "the wave after restore")
    after = {s: {k: v for k, v in d.items() if k not in before[s]}
             for s, d in _mesh_log(eng, S).items()}
    _check(_mesh_log(fresh, S) == after, "decision logs after restore")
    _check(stores(fresh) == stores(eng), "replica stores after restore")
    return {"state_bytes": nbytes, "save_s": save_s, "load_s": load_s}


async def _quorum(engines, what: str) -> None:
    for _ in range(1000):
        await asyncio.sleep(0.01)
        if all([(await e.get_statistics()).has_quorum for e in engines]):
            return
    raise AssertionError(f"{what}: the transport cluster never formed quorum")


async def _stop(engines, tasks) -> None:
    for e in engines:
        await e.shutdown()
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)


async def _transport_restart(S: int, R: int, root: str) -> dict:
    config = RabiaConfig(phase_timeout=3.0, heartbeat_interval=0.05,
                         round_interval=0.002).with_kernel(num_shards=S, shard_pad_multiple=2)
    hub = InMemoryHub()
    nodes = [NodeId.from_int(i + 1) for i in range(R)]
    persists = [FileSystemPersistence(os.path.join(root, str(i))) for i in range(R)]
    sms = [InMemoryStateMachine() for _ in nodes]
    transports = [hub.register(n) for n in nodes]

    def start(i):
        return RabiaEngine(ClusterConfig.new(nodes[i], nodes), sms[i], transports[i],
                           persistence=persists[i], config=config)

    async def wave(eng, tag):
        futs = [await eng.submit_batch(CommandBatch.new([f"SET {tag}{s} v{s}"]), shard=s)
                for s in range(S)]
        for f in futs:
            _check(await asyncio.wait_for(f, 30.0) == [b"OK"], f"phase 10: wave {tag}")

    async def converged(tag):
        for _ in range(1000):
            if all(sm.get(f"{tag}{s}") == f"v{s}" for sm in sms for s in range(S)):
                return
            await asyncio.sleep(0.01)
        raise AssertionError(f"phase 10: wave {tag} did not reach every replica")

    engines = [start(i) for i in range(R)]
    tasks = [asyncio.ensure_future(e.run()) for e in engines]
    try:
        await _quorum(engines, "phase 10")
        await wave(engines[0], "a")
        await converged("a")
        # the last replica shuts down (a clean shutdown saves its state),
        # leaves the hub, and restarts from its persistence layer with a
        # fresh state machine
        await engines[-1].shutdown()
        tasks[-1].cancel()
        await asyncio.gather(tasks[-1], return_exceptions=True)
        hub.set_connected(nodes[-1], False)
        saved = PersistedEngineState.from_bytes(await persists[-1].load_state())
        _check(sum(saved.per_shard_committed) == S, "phase 10: the saved slot counters")
        sms[-1] = InMemoryStateMachine()
        hub.set_connected(nodes[-1], True)
        engines[-1] = start(R - 1)
        t0 = time.perf_counter()
        tasks[-1] = asyncio.ensure_future(engines[-1].run())
        await _quorum(engines, "phase 10")
        _check(all(sms[-1].get(f"a{s}") == f"v{s}" for s in range(S)),
               "phase 10: the restarted replica's restored state")
        # a further wave commits on every replica, the restarted one too
        await wave(engines[0], "b")
        await converged("b")
        return {"shards": S, "replicas": R, "rejoin_and_wave_s": time.perf_counter() - t0,
                "tainted_shards": int((engines[-1].rt.tainted_upto[:S] > 0).sum())}
    finally:
        await _stop(engines, tasks)


def transport_restart(S: int, R: int) -> dict:
    """A transport engine shut down and restarted from its persistence
    layer (FileSystemPersistence) rejoins its peers; a further wave
    commits on every replica."""
    with tempfile.TemporaryDirectory() as d:
        return asyncio.run(_transport_restart(S, R, d))


# -- phase 11 ----------------------------------------------------------------


class _AppEngine(RabiaEngine):
    """A transport engine that counts the slots it opens with V0, by
    reason: its peers were already voting in the slot, or the forward
    timeout on a proposer that did not propose (the counters of
    scripts/torch_transport_gate.py)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.v0_opened = {"votes_seen": 0, "forward_timeout": 0, "other": 0}

    def _open_slots(self):
        seen = self.rt.votes_seen_slot[: self.n_shards].copy()
        out = super()._open_slots()
        for s, slot, v in out:
            if v == V0:
                sh = self.rt.shards[s]
                why = ("votes_seen" if seen[s] >= slot else "forward_timeout"
                       if sh.queue and sh.queue[0].first_forwarded_at else "other")
                self.v0_opened[why] += 1
        return out


def _app_config(S: int) -> RabiaConfig:
    """The planes gate's timing (phase_timeout is the forward timer)."""
    return RabiaConfig(phase_timeout=3.0, heartbeat_interval=0.05,
                       round_interval=0.002).with_kernel(num_shards=S, shard_pad_multiple=2)


async def _hub_cluster(S: int, R: int, sm_factory, what: str):
    """R transport engines over one InMemoryHub, one state machine each."""
    hub = InMemoryHub()
    nodes = [NodeId.from_int(i + 1) for i in range(R)]
    sms = [sm_factory() for _ in nodes]
    engines = [_AppEngine(ClusterConfig.new(n, nodes), sm, hub.register(n), config=_app_config(S))
               for n, sm in zip(nodes, sms)]
    tasks = [asyncio.ensure_future(e.run()) for e in engines]
    await _quorum(engines, f"phase 11 {what}")
    return engines, sms, tasks


async def _converge(probe, what: str, seconds: float = 60.0) -> None:
    """Poll until probe() holds (peers apply after the submitter settles)."""
    deadline = time.perf_counter() + seconds
    while not probe():
        if time.perf_counter() > deadline:
            raise AssertionError(f"phase 11 {what}: the replicas did not converge")
        await asyncio.sleep(0.02)


async def _decided(engine) -> tuple[int, int]:
    st = await engine.get_statistics()
    return st.decided_v1, st.decided_v0


def _timed(fut, lat: list) -> None:
    t0 = time.perf_counter()
    fut.add_done_callback(lambda _f: lat.append(time.perf_counter() - t0))


def _rates(wall: float, decided: int, commands: int, lat: list, **extra) -> dict:
    p50, p99 = settle_quantiles(lat)
    return {"wall_s": wall, "decided_slots": decided, "commands": commands,
            "decisions_per_s": decided / wall, "commands_per_s": commands / wall,
            "settle_p50_s": p50, "settle_p99_s": p99, **extra}


def _keys_by_shard(S: int, per: int, prefix: str, width: int = 0) -> list:
    """``per`` distinct keys for each of S shards, routed by shard_for_key
    (keys padded to ``width`` bytes when it is given)."""
    out: list = [[] for _ in range(S)]
    short = S * per
    i = 0
    while short:
        k = f"{prefix}{i}"
        k = k.ljust(width, "~") if width else k
        i += 1
        s = shard_for_key(k, S)
        if len(out[s]) < per:
            out[s].append(k)
            short -= 1
    return out


def _kv(r) -> tuple:
    return (r.kind.value, r.value, r.version, r.error)


def _counter_cmds(n: int, seed: int) -> list:
    """Increments and decrements with seeded amounts, a set at a third,
    a reset at two thirds, and a read at the end."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n - 1):
        amount = int(rng.integers(1, 1000))
        if i == n // 3:
            out.append(CounterCommand.set(amount * 1000))
        elif i == 2 * n // 3:
            out.append(CounterCommand.reset())
        else:
            out.append(CounterCommand.increment(amount) if rng.random() < 0.6
                       else CounterCommand.decrement(amount))
    return out + [CounterCommand.get()]


async def _counter_transport(R: int, cmds: list) -> tuple[dict, list, CounterSMR]:
    counters = [CounterSMR() for _ in range(R)]
    it = iter(counters)
    engines, _sms, tasks = await _hub_cluster(1, R, lambda: SMRBridge(next(it)), "(a)")
    codec = counters[0]
    lat: list = []
    try:
        d0 = await _decided(engines[0])
        t0 = time.perf_counter()
        responses = []
        for i, cmd in enumerate(cmds):
            # one command a slot, submitted from every replica in turn
            batch = CommandBatch.new([Command.new(codec.encode_command(cmd))])
            fut = await engines[i % R].submit_batch(batch, shard=0)
            _timed(fut, lat)
            responses.append((await asyncio.wait_for(fut, 30.0))[0])
        wall = time.perf_counter() - t0
        want = (codec.value, codec.operations)
        await _converge(lambda: all((c.value, c.operations) == want for c in counters), "(a)")
        d1 = await _decided(engines[0])
    finally:
        await _stop(engines, tasks)
    stats = _rates(wall, sum(d1) - sum(d0), len(cmds), lat, null_slots=d1[1] - d0[1])
    return stats, responses, counters[0]


def counter_config1(device, R: int = CFG1_R, n: int = CFG1_CMDS, seed: int = 21) -> dict:
    """BASELINE.json config 1, counter_smr: 3 replicas, one shard, in
    memory. The commands go through SMRBridge(CounterSMR) over a
    transport cluster, one at a time from every replica in turn, and the
    same commands through a MeshEngine on the device with CounterSMR
    replicas: every response equal to a local counter's, and the state
    equal on every replica of both sides."""
    cmds = _counter_cmds(n, seed)
    local = CounterSMR()
    want = [local.encode_response(local.apply_command(c)) for c in cmds]
    stats, got, counter = asyncio.run(_counter_transport(R, cmds))
    _check(got == want, "phase 11 (a): transport responses")
    bridges: list = []

    def replica():
        bridges.append(SMRBridge(CounterSMR()))
        return bridges[-1]

    eng = MeshEngine(replica, 1, R, window=2, device=device)
    futs = [eng.submit([local.encode_command(c)], 0) for c in cmds]
    eng.flush()
    _check([f.result()[0] for f in futs] == want, "phase 11 (a): MeshEngine responses")
    state = (local.value, local.operations)
    _check((counter.value, counter.operations) == state, "phase 11 (a): transport counter")
    _check(all((b.typed.value, b.typed.operations) == state for b in bridges),
           "phase 11 (a): MeshEngine counters")
    stats.update(replicas=R, shards=1, value=local.value)
    return stats


def _kv_stream(S: int, waves: int, seed: int) -> tuple[list, list]:
    """Config 2's stream: ``waves`` of one operation a shard (SET, GET,
    DELETE, EXISTS, CAS over 4 keys a shard), and two block waves
    (set_many of 2 keys a shard, get_many of 3, one never set)."""
    rng = np.random.default_rng(seed)
    keys = _keys_by_shard(S, 4, "c2-")
    scalar = []
    for w in range(waves):
        wave = {}
        for s in range(S):
            k = keys[s][int(rng.integers(0, 4))]
            kind = ("set", "get", "delete", "exists", "cas")[int(rng.choice(5, p=[.4, .2, .1, .1, .2]))]
            wave[s] = (kind, k, f"v{w}.{s}.{int(rng.integers(0, 1 << 20))}", int(rng.integers(0, 4)))
        scalar.append(wave)
    sets = [(keys[s][j], f"b{s}.{j}") for s in range(S) for j in (1, 3)]
    gets = [keys[s][j] for s in range(S) for j in (0, 1, 2)]
    return scalar, [sets, gets]


def _kv_op(kind: str, k: str, v: str, ev: int) -> KVOperation:
    if kind == "set":
        return KVOperation.set(k, v)
    if kind == "cas":
        return KVOperation.cas(k, v, ev)
    return getattr(KVOperation, kind)(k)


async def _kv_transport(S: int, R: int, scalar: list, blocks: list):
    engines, sms, tasks = await _hub_cluster(S, R, lambda: make_sharded_kv(S)[0], "(b)")
    machines = [sm.machines for sm in sms]
    svc = ShardedKVService(S, engines[0].submit_batch, machines[0],
                           submit_block=engines[0].submit_block)
    lat: list = []

    async def one(kind, k, v, ev):
        t0 = time.perf_counter()
        if kind == "cas":  # no service method: the service's own codec path
            s = svc.shard_of(k)
            batch = CommandBatch.new([Command.new(machines[0][s].encode_command(
                KVOperation.cas(k, v, ev)))], shard=s)
            fut = await engines[0].submit_batch(batch, shard=s)
            out = _kv(machines[0][s].decode_response((await fut)[0]))
        elif kind == "set":
            out = _kv(await svc.set(k, v))
        elif kind == "exists":
            out = await svc.exists(k)
        else:
            out = _kv(await getattr(svc, kind)(k))
        lat.append(time.perf_counter() - t0)
        return out

    try:
        d0 = await _decided(engines[0])
        t0 = time.perf_counter()
        got = []
        for wave in scalar:
            got.append(await asyncio.wait_for(asyncio.gather(
                *[one(*wave[s]) for s in sorted(wave)]), 60.0))
        for call, arg in ((svc.set_many, blocks[0]), (svc.get_many, blocks[1])):
            t1 = time.perf_counter()
            got.append([_kv(r) for r in await asyncio.wait_for(call(arg), 60.0)])
            lat += [time.perf_counter() - t1] * len(arg)  # one round trip for the block's ops
        wall = time.perf_counter() - t0
        sums = lambda ms: [m.store.checksum() for m in ms]  # noqa: E731
        await _converge(lambda: all(sums(ms) == sums(machines[0]) for ms in machines), "(b)")
        d1 = await _decided(engines[0])
        await svc.close()
    finally:
        await _stop(engines, tasks)
    n_cmds = sum(len(w) for w in scalar) + len(blocks[0]) + len(blocks[1])
    stats = _rates(wall, sum(d1) - sum(d0), n_cmds, lat, null_slots=d1[1] - d0[1],
                   v0_opened=_v0_sum(engines))
    return stats, got, sums(machines[0])


def _v0_sum(engines) -> dict:
    out: dict = {}
    for e in engines:
        for k, v in e.v0_opened.items():
            out[k] = out.get(k, 0) + v
    return out


def kv_config2(device, S: int = CFG2_S, R: int = CFG2_R, waves: int = CFG2_OP_WAVES,
               seed: int = 22) -> dict:
    """BASELINE.json config 2, kvstore_smr at 64 shards x 3 replicas: a
    seeded stream of SET, GET, DELETE, EXISTS and CAS through
    ShardedKVService over make_sharded_kv stores on a transport cluster,
    with set_many and get_many on the engine's block lane, and the same
    commands, grouped by shard_for_key, through a MeshEngine on the device
    with make_sharded_kv replicas: every response and every shard's
    checksum() equal on every replica of both sides."""
    scalar, blocks = _kv_stream(S, waves, seed)
    stats, got, sums = asyncio.run(_kv_transport(S, R, scalar, blocks))
    eng = MeshEngine(lambda: make_sharded_kv(S)[0], S, R, window=2, device=device)
    codec = KVStoreSMR()
    mesh = []
    for wave in scalar:
        futs = {s: eng.submit([codec.encode_command(_kv_op(*wave[s]))], s) for s in sorted(wave)}
        eng.flush()
        mesh.append([decode_kv_response(futs[s].result()[0]).value == "true"
                     if wave[s][0] == "exists" else _kv(decode_kv_response(futs[s].result()[0]))
                     for s in sorted(wave)])
    sets, gets = blocks
    for ops in ([(k, encode_set_bin(k, v)) for k, v in sets],
                [(k, encode_op_bin(KVOperation.get(k))) for k in gets]):
        by_shard: dict = {}
        for pos, (k, op) in enumerate(ops):
            by_shard.setdefault(shard_for_key(k, S), []).append((pos, op))
        shards = sorted(by_shard)
        fut = eng.submit_block(build_block(shards, [[op for _p, op in by_shard[s]] for s in shards]))
        eng.flush()
        out = [None] * len(ops)
        for s, frames in zip(shards, fut.result()):
            for (pos, _op), raw in zip(by_shard[s], frames):
                out[pos] = _kv(decode_kv_response(raw))
        mesh.append(out)
    _check(mesh == [list(w) for w in got], "phase 11 (b): MeshEngine responses")
    _check(all([m.store.checksum() for m in sm.machines] == sums for sm in eng.sms),
           "phase 11 (b): MeshEngine replicas' shard checksums")
    stats.update(shards=S, replicas=R, scalar_waves=waves, block_waves=2,
                 ok_responses=sum(1 for w in got for r in w if r is True or (
                     isinstance(r, tuple) and r[0] == "success")))
    return stats


async def _batched_transport(S: int, R: int, waves: list) -> tuple:
    engines, sms, tasks = await _hub_cluster(S, R, lambda: make_sharded_kv(S)[0], "(c)")
    machines = [sm.machines for sm in sms]
    svc = ShardedKVService(S, engines[0].submit_batch, machines[0], batching=BatchConfig())
    lat: list = []

    async def one(k, v):
        t0 = time.perf_counter()
        r = await svc.set(k, v)
        lat.append(time.perf_counter() - t0)
        return r

    try:
        d0 = await _decided(engines[0])
        t0 = time.perf_counter()
        wave_s, results = [], []
        for pairs in waves:
            t = time.perf_counter()
            results.append(await asyncio.wait_for(asyncio.gather(*[one(k, v) for k, v in pairs]),
                                                  300.0))
            wave_s.append(time.perf_counter() - t)
        wall = time.perf_counter() - t0
        sums = lambda ms: [m.store.checksum() for m in ms]  # noqa: E731
        await _converge(lambda: all(sums(ms) == sums(machines[0]) for ms in machines), "(c)")
        d1 = await _decided(engines[0])
    finally:
        await svc.close()
        await _stop(engines, tasks)
    bs = svc.batch_stats
    created = sum(b.batches_created for b in bs)
    batched = sum(b.commands_batched for b in bs)
    targets = [b.current_target_size for b in bs]
    n_cmds = sum(len(p) for p in waves)
    stats = _rates(wall, sum(d1) - sum(d0), n_cmds, lat, wave_s=wave_s, null_slots=d1[1] - d0[1],
                   v0_opened=_v0_sum(engines),
                   batch_stats={"batches_created": created, "commands_batched": batched,
                                "avg_batch_size": batched / created if created else 0.0,
                                "size_flushes": sum(b.size_flushes for b in bs),
                                "timeout_flushes": sum(b.timeout_flushes for b in bs),
                                "manual_flushes": sum(b.manual_flushes for b in bs),
                                "target_size_min": min(targets), "target_size_max": max(targets)})
    return stats, results, machines[0]


def kv_config3(device, S: int = S_FULL, R: int = R_FULL, waves: int = APP_WAVES,
               per: int = APP_PER, P: int = P_FULL, seed: int = 23) -> dict:
    """BASELINE.json config 3, kvstore_smr at 4096 shards x 5 replicas with
    adaptive batching on: waves of concurrent set() calls (``per`` keys a
    shard, 32-byte keys, 64-byte values, in a seeded order) through
    ShardedKVService(batching=BatchConfig()) over a transport cluster, and
    the same SETs, as full-width blocks routed by shard_for_key in the
    order the cluster committed them, through MeshEngine(device_store=True)
    (the device KV lane, one SET a shard a block: kv_dict.cu decides and
    applies each window).
    Every set() must succeed; every key's value and version in the device
    table must equal the sharded KV's, and the device lane must serve it."""
    rng = np.random.default_rng(seed)
    keys = _keys_by_shard(S, per * waves, "c3-", APP_KEY)
    order = []
    for w in range(waves):
        pairs = [(keys[s][w * per + j], f"w{w}.{s}.{j}.".ljust(APP_VAL, "v"))
                 for s in range(S) for j in range(per)]
        order.append([pairs[i] for i in rng.permutation(len(pairs))])
    stats, results, machines = asyncio.run(_batched_transport(S, R, order))
    _check(all(r.ok for rs in results for r in rs), "phase 11 (c): a set() failed")
    # the committed order: versions count a shard's writes from 1
    version = {k: r.version for pairs, rs in zip(order, results) for (k, _v), r in zip(pairs, rs)}
    value = dict(p for pairs in order for p in pairs)
    per_shard = [sorted(ks, key=version.__getitem__) for ks in keys]
    _check(all([version[k] for k in ks] == list(range(1, len(ks) + 1)) for ks in per_shard),
           "phase 11 (c): a shard's versions are not 1..n")
    eng = MeshEngine(lambda: VectorShardedKV(S, capacity=max(1 << 16, 4 * S * P)), S, R,
                     window=16, device=device, device_store=True,
                     device_store_kw={"per_shard_capacity": P})
    # the device lane takes one op a shard a block: block j holds every
    # shard's j-th write in the committed order
    n = waves * per
    t0 = time.perf_counter()
    futs = [eng.submit_block(build_block(list(range(S)), [
        [_set_op(ks[j].encode(), value[ks[j]].encode())] for ks in per_shard])) for j in range(n)]
    eng.flush()
    dev_s = time.perf_counter() - t0
    _check(eng.device_lane_active, "phase 11 (c): the device lane was demoted")
    got = [[decode_kv_response(fr[0]).version for fr in f.result()] for f in futs]
    _check(got == [[j + 1] * S for j in range(n)], "phase 11 (c): device lane responses")
    d = eng._dev.dump()
    table = {(int(s), bytes(k[:kl]).decode()): (bytes(v[:vl]).decode(), int(ver))
             for s, k, kl, v, vl, ver in zip(d["shard"], d["key"], d["key_len"], d["value"],
                                             d["value_len"], d["version"])}
    host = {(s, k): (e.value, e.version) for s, m in enumerate(machines)
            for k in m.store.keys() for e in [m.store.get_with_metadata(k)]}
    _check(table == host, "phase 11 (c): the device table differs from the sharded KV")
    stats.update(shards=S, replicas=R, waves=waves, keys_per_shard_wave=per, key_bytes=APP_KEY,
                 value_bytes=APP_VAL, device_lane_s=dev_s, device_table_entries=len(table))
    return stats


def _bank_stream(S: int, post: int, seed: int) -> tuple[list, list, list]:
    """Config 4's stream: two accounts a shard (routed by shard_for_key);
    a first wave opens them and moves money inside the shard, then
    ``post`` waves of deposits, withdrawals and transfers."""
    rng = np.random.default_rng(seed)
    accts = _keys_by_shard(S, 2, "acct-")
    amt = lambda lo, hi: int(rng.integers(lo, hi))  # noqa: E731
    first = [[BankCommand.create(a, amt(1, 100_000)), BankCommand.create(b, amt(0, 50_000)),
              BankCommand.deposit(a, amt(1, 20_000)), BankCommand.transfer(a, b, amt(1, 60_000)),
              BankCommand.withdraw(b, amt(1, 40_000))] for a, b in accts]
    later = [[[BankCommand.deposit(a, amt(1, 9_000)), BankCommand.transfer(b, a, amt(1, 30_000)),
               BankCommand.withdraw(a, amt(1, 50_000)), BankCommand.transfer(a, b, amt(1, 20_000))]
              for a, b in accts] for _ in range(post)]
    return accts, first, later


def _bank_state(sm) -> list:
    """Per shard: balances and transaction counts, and the transaction log."""
    return [(sorted((k, a.balance_cents, a.transactions) for k, a in m.accounts.items()),
             [(t.op, t.account, t.to_account, t.amount_cents, t.seq) for t in m.history()])
            for m in sm.machines]


class _BankHarness(ConsensusTestHarness):
    """The fault-injection harness with ShardedStateMachine(BankingSMR)
    replicas."""

    def __init__(self, S: int, R: int, seed: int):
        super().__init__(R, config=_app_config(S), seed=seed)
        self._sm_factory = lambda: ShardedStateMachine([BankingSMR() for _ in range(S)])


async def _bank_transport(S: int, R: int, crash: tuple, waves: list) -> tuple:
    h = _BankHarness(S, R, seed=24)
    await h.start(quorum_wait=30.0)
    codec = BankingSMR()
    lat: list = []

    async def wave(cmds, submitters):
        futs = []
        for s, batch_cmds in enumerate(cmds):
            batch = CommandBatch.new([Command.new(codec.encode_command(c)) for c in batch_cmds],
                                     shard=s)
            f = await submitters[s % len(submitters)].submit_batch(batch, shard=s)
            _timed(f, lat)
            futs.append(f)
        return [[bytes(r) for r in x] for x in await asyncio.wait_for(asyncio.gather(*futs), 120.0)]

    try:
        t0 = time.perf_counter()
        got = [await wave(waves[0], h.engines)]
        pre_wall = time.perf_counter() - t0
        await _converge(lambda: all(_bank_state(sm) == _bank_state(h.sms[0]) for sm in h.sms),
                        "(d) before the crash")
        h.inject(Fault(delay=0.0, fault=FaultType.NodeCrash, nodes=crash))
        live = [i for i in range(R) if i not in crash]
        _check([i for i, n in enumerate(h.nodes) if not h.sim.is_crashed(n)] == live,
               "phase 11 (d): the crashed replicas")
        c0 = (await h.engines[live[0]].get_statistics()).committed_slots
        d0 = await _decided(h.engines[live[0]])
        lat.clear()
        t1 = time.perf_counter()
        for cmds in waves[1:]:
            got.append(await wave(cmds, [h.engines[i] for i in live]))
        post_wall = time.perf_counter() - t1
        want = lambda: _bank_state(h.sms[live[0]])  # noqa: E731
        await _converge(lambda: all(_bank_state(h.sms[i]) == want() for i in live),
                        "(d) after the crash")
        c1 = (await h.engines[live[0]].get_statistics()).committed_slots
        d1 = await _decided(h.engines[live[0]])
        state = want()
    finally:
        await h.stop()
    n_cmds = sum(len(b) for w in waves[1:] for b in w)
    stats = _rates(post_wall, sum(d1) - sum(d0), n_cmds, lat, pre_crash_wall_s=pre_wall,
                   commits_after_crash=c1 - c0, null_slots_after_crash=d1[1] - d0[1])
    return stats, got, state


def bank_config4(device, S: int = CFG4_S, R: int = CFG4_R, crash: tuple = CFG4_CRASH,
                 post: int = CFG4_POST, seed: int = 25) -> dict:
    """BASELINE.json config 4, banking_smr at 1024 shards x 7 replicas
    with a minority crash: ShardedStateMachine(BankingSMR) replicas on the
    fault-injection harness, accounts routed by shard_for_key; open,
    deposit, withdraw and transfer inside each shard, crash 3 replicas
    (FaultType.NodeCrash) and keep submitting. Every command after the
    crash commits on the live replicas, whose balances and transaction
    logs agree; money is conserved (balances sum to what was opened and
    deposited less what was withdrawn). A MeshEngine on the device with the
    same replicas, the same 3 crashed (crash_replica) and the same stream:
    its live replicas equal the transport cluster's."""
    _accts, first, later = _bank_stream(S, post, seed)
    waves = [first] + later
    stats, got, state = asyncio.run(_bank_transport(S, R, crash, waves))
    cmds = [c for w in waves for b in w for c in b]
    resp = [r for w in got for b in w for r in b]
    codec = BankingSMR()
    money = 0
    for c, raw in zip(cmds, resp):
        r = codec.decode_response(raw)
        if r.ok and c.op in (BankOp.CreateAccount, BankOp.Deposit):
            money += c.amount_cents
        elif r.ok and c.op == BankOp.Withdraw:
            money -= c.amount_cents
    total = sum(b for shard, _log in state for _k, b, _n in shard)
    _check(total == money, f"phase 11 (d): money not conserved ({total} != {money})")
    eng = MeshEngine(lambda: ShardedStateMachine([BankingSMR() for _ in range(S)]), S, R,
                     window=2, device=device)
    mesh = []
    for w, cmds_w in enumerate(waves):
        if w == 1:
            for r in crash:
                eng.crash_replica(r)
        futs = [eng.submit([codec.encode_command(c) for c in b], s) for s, b in enumerate(cmds_w)]
        eng.flush()
        mesh.append([[bytes(x) for x in f.result()] for f in futs])
    _check(mesh == got, "phase 11 (d): MeshEngine responses")
    live = [i for i in range(R) if i not in crash]
    _check(all(_bank_state(eng.sms[i]) == state for i in live),
           "phase 11 (d): MeshEngine live replicas' balances and logs")
    stats.update(shards=S, replicas=R, crashed=list(crash), accounts=2 * S, waves_after_crash=post,
                 money_cents=money)
    return stats


# -- phase 12 ----------------------------------------------------------------


def _tcp_config(S: int) -> RabiaConfig:
    """The reference sweep's cluster settings for configs 5 and 6."""
    return RabiaConfig(phase_timeout=2.0, heartbeat_interval=0.5,
                       round_interval=0.0002).with_kernel(
        num_shards=S, shard_pad_multiple=max(1, S), backend="host")


async def _tcp_cluster(S: int, R: int, sm_factory, what: str):
    """R transport engines meshed over TCP on 127.0.0.1, one state machine
    each."""
    ids = [NodeId.from_int(i + 1) for i in range(R)]
    nets = [TcpNetwork(i, TcpNetworkConfig(bind_port=0)) for i in ids]
    for i in range(R):
        for j in range(R):
            if i != j:
                nets[i].add_peer(ids[j], "127.0.0.1", nets[j].port)
    sms = [sm_factory() for _ in ids]
    engines = [_AppEngine(ClusterConfig.new(n, ids), sm, nets[i], config=_tcp_config(S))
               for i, (n, sm) in enumerate(zip(ids, sms))]
    tasks = [asyncio.ensure_future(e.run()) for e in engines]
    await _quorum(engines, f"phase 12 {what}")
    return engines, sms, tasks, nets


async def _tcp_stop(engines, tasks, nets) -> None:
    await _stop(engines, tasks)
    for n in nets:
        await n.close()


async def _block_pump(engines, S: int, R: int, dur: float, shard_cmds, lat: list) -> int:
    """The reference sweep's block pump: each cycle every engine proposes
    one block over the shards it proposes next and that are idle, and the
    cycle waits for all of them. Appends each block's submit-to-settle
    time to ``lat``; returns the commands acknowledged."""
    shard_ids = np.arange(S)
    stop_at = time.perf_counter() + dur
    acked = 0

    def settled(t_sub):
        return lambda _f: lat.append(time.perf_counter() - t_sub)

    while time.perf_counter() < stop_at:
        futs = []
        for e in engines:
            head = np.maximum(e.rt.next_slot[:S], e.rt.applied_upto[:S])
            mine = shard_ids[(slot_proposer_vec(shard_ids, head, R) == e.me)
                             & (e.rt.queue_len[:S] == 0) & ~e.rt.in_flight[:S]]
            if len(mine):
                t_sub = time.perf_counter()
                fut = asyncio.ensure_future(await e.submit_block(
                    build_block(mine, [shard_cmds(int(s)) for s in mine])))
                fut.add_done_callback(settled(t_sub))
                futs.append(fut)
        if not futs:
            await asyncio.sleep(0.001)
            continue
        results = await asyncio.wait_for(asyncio.gather(*futs), max(10.0, dur))
        for res in results:
            counts = getattr(res, "group_counts", None)
            acked += int(counts().sum()) if counts is not None else sum(
                len(r) for r in res if not isinstance(r, Exception))
    return acked


async def _committed(engines) -> float:
    sts = [await e.get_statistics() for e in engines]
    return sum(st.committed_slots for st in sts) / len(engines)


def _planes(engines) -> list:
    return [e.health()["planes"] for e in engines]


def _check_planes(planes: list, want: dict, what: str) -> None:
    for i, p in enumerate(planes):
        for k, v in want.items():
            _check(p[k] == v, f"phase 12 {what}: replica {i} runs {k} {p[k]}, not {v}")


def _vector_rows(sm) -> tuple[dict, np.ndarray]:
    """({(shard, key): (value, version)}, shard write counts) of a
    VectorShardedKV replica."""
    vers, rows, over = VectorKVStore._parse_snapshot(sm.store.snapshot_bytes())
    out = {(int(s), bytes(k)): (bytes(v), int(ver))
           for s, k, v, ver in zip(rows[0], rows[1], rows[2], rows[3])}
    for d in over:
        out[(int(d["shard"]), bytes.fromhex(d["key"]))] = (bytes.fromhex(d["value"]),
                                                           int(d["version"]))
    return out, vers


def _device_feed(device, S: int, R: int, streams: list) -> tuple[dict, dict]:
    """:func:`_device_feed_engine` without the engine."""
    table, stats, _eng = _device_feed_engine(device, S, R, streams, "12")
    return table, stats


def _device_feed_engine(device, S: int, R: int, streams: list,
                        phase: str) -> tuple[dict, dict, MeshEngine]:
    """Feed each shard's committed SETs, in committed order, to a
    ``MeshEngine(device_store=True)`` on the card (the reference
    ``DeviceKVTable``'s defaults: 64 slots a shard, 32-byte keys, 64-byte
    values) as full-width blocks of one op a shard: block j carries every
    shard's j-th SET, and a GET of the shard's first key where its stream
    has ended (a read leaves the table as it is). Returns the device
    table as {(shard, key): (value, version)}, what the feed took and the
    engine."""
    eng = MeshEngine(lambda: VectorShardedKV(S, capacity=CFG5_CAPACITY), S, R, window=16,
                     device=device, device_store=True,
                     device_store_kw={"per_shard_capacity": P_FULL})
    filler = [_key_op(2, _op_key(st[0]) if st else b"cold") for st in streams]
    n = max(len(st) for st in streams)
    on_card = torch.device(device).type == "cuda"
    # each launch of the feed timed by the wrappers' CUDA events
    kv_window.KV_WINDOW.events = [] if on_card else None
    mesh_window.MESH_WINDOW.events = [] if on_card else None
    n0 = _kernel_counts()
    t0 = time.perf_counter()
    futs = []
    try:
        for j in range(n):
            col = [[st[j] if j < len(st) else filler[s]] for s, st in enumerate(streams)]
            futs.append(eng.submit_block(build_block(np.arange(S), col)))
        eng.flush()
        if on_card:
            torch.cuda.synchronize()
        feed_s = time.perf_counter() - t0
        timed = [(_KV_FORM_KERNEL[form], a, b) for form, a, b in kv_window.KV_WINDOW.events or ()]
        timed += [("mesh_window", a, b) for a, b in mesh_window.MESH_WINDOW.events or ()]
    finally:
        kv_window.KV_WINDOW.events = mesh_window.MESH_WINDOW.events = None
    launched = {k: v - n0[k] for k, v in _kernel_counts().items() if v > n0[k]}
    dev_ms: dict = {}
    for tag, a, b in timed:
        dev_ms[tag] = dev_ms.get(tag, 0.0) + a.elapsed_time(b)
    if on_card:
        _check(set(dev_ms) == set(launched) and len(timed) == sum(launched.values()),
               f"phase {phase}: the feed's launches {launched} were not all timed ({len(timed)})")
    _check(eng.device_lane_active, f"phase {phase}: the device lane was demoted")
    for f in futs:  # a filler GET may find nothing; no op may fail
        _check(all(decode_kv_response(fr[0]).kind.value != "error" for fr in f.result()),
               f"phase {phase}: a device lane op failed")
    d = eng._dev.dump()
    table = {(int(s), bytes(k[:kl])): (bytes(v[:vl]), int(ver))
             for s, k, kl, v, vl, ver in zip(d["shard"], d["key"], d["key_len"], d["value"],
                                             d["value_len"], d["version"])}
    return table, {"blocks": n, "device_feed_s": feed_s, "device_table_entries": len(table),
                   "launches_by_kernel": launched,
                   "device_ms_by_kernel": dev_ms if on_card else "not measured (CPU)"}, eng


def _op_key(op: bytes) -> bytes:
    klen = int.from_bytes(op[1:3], "little")
    return op[3:3 + klen]


def _zipf_cmds(S: int) -> list:
    """Config 5's slot payloads, the reference sweep's: keys
    ``key{min(z, 99999)}`` for 30000 draws of ``default_rng(0).zipf(1.2)``,
    routed by shard_for_key; a shard's slot carries up to 32 of its hot
    keys' SETs of "v", or one SET of "cold"."""
    rng = np.random.default_rng(0)
    per_shard: dict = {}
    for z in rng.zipf(CFG5_ZIPF_S, size=CFG5_DRAWS):
        k = f"key{min(int(z), CFG5_KEYS)}"
        per_shard.setdefault(shard_for_key(k, S), []).append(encode_set_bin(k, "v"))
    cold = [encode_set_bin("cold", "v")]
    return [per_shard.get(s, cold)[:CFG5_MAX_CMDS] for s in range(S)]


def _streams_from_rows(rows: dict, writes: np.ndarray, cmds: list, what: str) -> tuple[list, int]:
    """Each shard's committed SETs in committed order, from a replica's
    store: every slot of shard s carries ``cmds[s]`` (L SETs), so after n_s
    slots the shard counts n_s * L writes and a key holds the version of
    its last write, (n_s - 1) * L + 1 + its last index in ``cmds[s]``.
    Checks that the shard holds exactly those keys at those versions, and
    returns the streams and the committed slots."""
    by_shard: dict = {}
    for (s, k), (v, ver) in rows.items():
        by_shard.setdefault(s, {})[k] = (v, ver)
    streams, slots = [], 0
    for s, ops in enumerate(cmds):
        L = len(ops)
        n_s = int(writes[s]) // L
        last = {_op_key(op): i for i, op in enumerate(ops)}
        want = {k: (b"v", (n_s - 1) * L + i + 1) for k, i in last.items()} if n_s else {}
        _check(int(writes[s]) == n_s * L and by_shard.get(s, {}) == want,
               f"phase 12 {what}: shard {s}'s store is not {n_s} slots of its payload")
        streams.append(list(ops) * n_s)
        slots += n_s
    return streams, slots


# kv_window.KV_WINDOW's count forms by the kernel that runs them
_KV_FORM_KERNEL = {
    "dict": "kv_dict", "dict+decide": "kv_dict",
    "rows": "kv_window", "rows+decide": "kv_window",
    "dict wide": "kv_window", "dict wide+decide": "kv_window",
    "probe rows": "kv_read", "probe dict": "kv_read",
    "lookup rows": "kv_read", "lookup dict": "kv_read",
}


def _kernel_counts() -> dict:
    out = {"mesh_window": mesh_window.MESH_WINDOW.launches,
           "kv_dict": 0, "kv_window": 0, "kv_read": 0,
           "node_kernel": node_kernel.NODE_CYCLE.launches,
           "packers": packed_window.PACKERS.launches,
           "start_slot": cluster_round.CLUSTER_ROUND.counts["start_slot"]}
    for form, n in kv_window.KV_WINDOW.counts.items():
        out[_KV_FORM_KERNEL[form]] += n
    return out


def _reset_counts() -> None:
    """Every kernel's launch counts to 0 (just before a path is driven)."""
    fused_window.FUSED_WINDOW.launches = 0
    fused_window.FUSED_WINDOW_TSR.launches = 0
    kv_window.KV_WINDOW.reset_counts()
    mesh_window.MESH_WINDOW.launches = 0
    packed_window.PACKED_WINDOW.launches = 0
    packed_window.PACKERS.reset_counts()
    cluster_round.CLUSTER_ROUND.reset_counts()
    node_kernel.NODE_CYCLE.reset_counts()


async def _config5_cluster(S: int, R: int, cmds: list, dur: float) -> tuple:
    engines, sms, tasks, nets = await _tcp_cluster(
        S, R, lambda: VectorShardedKV(S, capacity=CFG5_CAPACITY), "(a)")
    lat: list = []
    try:
        planes = _planes(engines)
        base = await _committed(engines)
        t0 = time.perf_counter()
        acked = await _block_pump(engines, S, R, dur, lambda s: cmds[s], lat)
        top = await _committed(engines)
        wall = time.perf_counter() - t0
        # peers apply after the submitter settles
        await _converge(lambda: len({_snapshot_sans_clock(sm) for sm in sms}) == 1,
                        "12 (a)")
        d = [await _decided(e) for e in engines]
    finally:
        await _tcp_stop(engines, tasks, nets)
    stats = {"wall_s": wall, "decisions_per_s": (top - base) / wall, "commands_acked": acked,
             "commands_per_s": acked / wall, "blocks_settled": len(lat)}
    p50, p99 = settle_quantiles(lat)
    stats.update(settle_p50_s=p50, settle_p99_s=p99, null_slots=sum(v0 for _v1, v0 in d) / R,
                 v0_opened=_v0_sum(engines), planes=planes)
    return stats, sms


def tcp_config5(device, S: int = CFG5_S, R: int = CFG5_R, dur: float = PUMP_S) -> dict:
    """BASELINE.json config 5 at full width: kvstore (VectorShardedKV, the
    reference sweep's store), 16384 shards x 5 replicas over TCP on
    127.0.0.1, Zipf(1.2) keys, the block pump for ``dur`` seconds. The
    native tick and codec must run on every replica (the runtime declines
    a store that is not native, as the reference's does). The replicas'
    stores must equal each other, and a ``MeshEngine(device_store=True)``
    on the card fed each shard's committed SETs must hold the same table."""
    cmds = _zipf_cmds(S)
    stats, sms = asyncio.run(_config5_cluster(S, R, cmds, dur))
    _check_planes(stats["planes"], {"tick": "native", "codec": "native", "apply": "python",
                                    "runtime": "python"}, "(a)")
    rows, writes = _vector_rows(sms[0])
    streams, slots = _streams_from_rows(rows, writes, cmds, "(a)")
    table, feed = _device_feed(device, S, R, streams)
    _check(table == rows, "phase 12 (a): the device table differs from the replicas' stores")
    stats.update(shards=S, replicas=R, committed_slots=slots,
                 committed_commands=sum(len(st) for st in streams), hot_shards=sum(
                     len(c) > 1 or _op_key(c[0]) != b"cold" for c in cmds), **feed)
    return stats


async def _config6_cluster(S: int, R: int, dur: float, native: bool) -> tuple:
    engines, sms, tasks, nets = await _tcp_cluster(S, R, lambda: make_sharded_kv(S)[0], "(b)")
    one_op = [[encode_set_bin(f"k{s}", "v")] for s in range(S)]
    lat: list = []
    try:
        planes = _planes(engines)
        rtm0 = [e._rtm.counters_dict() if e._rtm is not None else {} for e in engines]
        base = await _committed(engines)
        t0 = time.perf_counter()
        acked = await _block_pump(engines, S, R, dur, lambda s: one_op[s], lat)
        top = await _committed(engines)
        wall = time.perf_counter() - t0
        rtm1 = [e._rtm.counters_dict() if e._rtm is not None else {} for e in engines]
        sums = lambda sm: [m.store.checksum() for m in sm.machines]  # noqa: E731
        await _converge(lambda: all(sums(sm) == sums(sms[0]) for sm in sms), "12 (b)")
        versions = [sms[0].machines[s].store.get_with_metadata(f"k{s}") for s in range(S)]
    finally:
        await _tcp_stop(engines, tasks, nets)
    keep = ("waves_native", "waves_py", "slots_applied", "gil_handoffs", "frames_native",
            "frames_escalated", "ev_stalls", "decided_scalar")
    deltas = [{k: r1.get(k, 0) - r0.get(k, 0) for k in keep} for r0, r1 in zip(rtm0, rtm1)]
    if native:
        for i, dl in enumerate(deltas):
            _check(dl["waves_native"] > 0, f"phase 12 (b): replica {i} applied no native wave")
            _check(dl["waves_py"] == 0,
                   f"phase 12 (b): replica {i} applied {dl['waves_py']} waves in Python")
            # a slot still in flight on a lagging replica when the next
            # proposer's block arrives escalates and decides on the scalar
            # lane: one handoff each, named by decided_scalar. main() holds
            # the card's host to none at all.
            _check(dl["gil_handoffs"] == dl["decided_scalar"],
                   f"phase 12 (b): replica {i} took {dl['gil_handoffs']} GIL handoffs, "
                   f"{dl['decided_scalar']} of them scalar decides")
    p50, p99 = settle_quantiles(lat)
    stats = {"wall_s": wall, "decisions_per_s": (top - base) / wall, "commands_acked": acked,
             "commands_per_s": acked / wall, "blocks_settled": len(lat), "settle_p50_s": p50,
             "settle_p99_s": p99, "planes": planes, "runtime_counter_deltas": deltas}
    n = [e.version if e is not None else 0 for e in versions]
    return stats, n


def tcp_config6(device, S: int = CFG6_S, R: int = CFG6_R, dur: float = PUMP_S) -> dict:
    """The reference sweep's config 6, its native runtime's home
    configuration: kvstore_smr (``make_sharded_kv``: the native store),
    4096 shards x 5 replicas over TCP, the block pump with one SET a shard
    for ``dur`` seconds. On the native runtime (runtime, tick and apply
    native on every replica, ``waves_native`` growing and
    ``gil_handoffs`` flat), then on the asyncio owner
    (``RABIA_PY_RUNTIME=1``); each leg's replicas agree, and a
    ``MeshEngine(device_store=True)`` on the card fed each leg's committed
    SETs holds the same table."""
    out = {}
    for leg, native in (("runtime", True), ("asyncio", False)):
        prev = os.environ.pop("RABIA_PY_RUNTIME", None)
        if not native:
            os.environ["RABIA_PY_RUNTIME"] = "1"
        try:
            stats, n = asyncio.run(_config6_cluster(S, R, dur, native))
        finally:
            os.environ.pop("RABIA_PY_RUNTIME", None)
            if prev is not None:
                os.environ["RABIA_PY_RUNTIME"] = prev
        _check_planes(stats["planes"], {"tick": "native", "codec": "native", "apply": "native",
                                        "runtime": "native" if native else "python"}, f"(b) {leg}")
        streams = [[encode_set_bin(f"k{s}", "v")] * n[s] for s in range(S)]
        table, feed = _device_feed(device, S, R, streams)
        want = {(s, f"k{s}".encode()): (b"v", n[s]) for s in range(S) if n[s]}
        _check(table == want, f"phase 12 (b) {leg}: the device table differs from the replicas")
        stats.update(committed_slots=sum(n), **feed)
        out[leg] = stats
    out.update(shards=S, replicas=R)
    return out


# ---- phase 13: the durability plane and the gateway -----------------------

def _p13_key(s: int, tag: str = "g") -> str:
    """A 32-byte key of shard s (one writer: the session that owns s)."""
    return f"{tag}{s:07d}".ljust(P13_KEY, "k")


def _p13_val(w: int, s: int) -> str:
    return f"w{w}s{s}".ljust(P13_VAL, "v")


def _fs_type(path: str) -> str:
    """The filesystem type of the mount that holds ``path``
    (``/proc/mounts``), for the fsync figures."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3 and path.startswith(parts[1]) and len(parts[1]) > len(best):
                    best, kind = parts[1], parts[2]
    except OSError:
        pass
    return f"{kind} at {best or '?'}"


_P13_PLANES = {"runtime": "native", "tick": "native", "codec": "native", "apply": "native",
               "wal": "native"}


def _p13_check_planes(planes: list, what: str) -> None:
    for i, p in enumerate(planes):
        for k, v in _P13_PLANES.items():
            _check(p.get(k) == v, f"phase 13 {what}: replica {i} runs {k} {p.get(k)}, not {v}")


def _wal_totals(engines) -> dict:
    tot: dict = {}
    for e in engines:
        for k, v in e._wal.counters_dict().items():
            tot[k] = tot.get(k, 0) + int(v)
    return tot


async def _committed_slots(engines) -> list:
    return [(await e.get_statistics()).committed_slots for e in engines]


class _CountedReader:
    """``devkv_read_handler(engine)`` with a tally of its calls: reads the
    gateway served alone (``reader(shard, key)``) and ``read_many`` calls
    (the shards of each). A client that hears nothing re-sends its read,
    and a re-send that arrives after the answer left is served again, so
    the reads served can exceed the keys read."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self.base = devkv_read_handler(engine)
        self.alone = 0
        self.calls: list[list[int]] = []

    def __call__(self, shard: int, key: bytes) -> bytes:
        self.alone += 1
        return self.base(shard, key)

    def read_many(self, items: list) -> list:
        self.calls.append([int(s) for s, _ in items])
        return self.base.read_many(items)

    def launches(self) -> int:
        """The kv_read launches these calls made: a read alone is one, a
        ``read_many`` one a window of ``engine.window`` waves (a wave holds
        at most one read a shard), while the device lane is up."""
        W = self.engine.window
        return self.alone + sum(-(-max(collections.Counter(c).values()) // W) for c in self.calls)

    def check(self, kvr: int, rounds: int, what: str) -> None:
        """On a card: the kv_read launches are exactly the calls' (one a
        read served alone, one a window of a batch), and the probe rounds'
        batches carried several reads a call."""
        _check(self.engine.device_lane_active, f"{what}: the device lane went down")
        _check(0 < kvr == self.launches(),
               f"{what}: {kvr} kv_read launches for {len(self.calls)} read_many calls and "
               f"{self.alone} reads served alone ({rounds} probe rounds)")
        _check(sum(map(len, self.calls)) > len(self.calls),
               f"{what}: {len(self.calls)} read_many calls carried no batch")


async def _p13_reads(clients, items: list, lat: list) -> list:
    """Every (shard, key) of ``items`` read by ReadIndex, the items dealt
    to the sessions in turn, each session reading its share in order."""
    out: list = [None] * len(items)

    async def one(ci: int) -> None:
        c = clients[ci]
        for i in range(ci, len(items), len(clients)):
            s, k = items[i]
            t = time.perf_counter()
            out[i] = await c.get(s, k)
            lat.append(time.perf_counter() - t)

    await asyncio.gather(*(one(ci) for ci in range(len(clients))))
    return out


async def durable_gateway_run(device, S: int = S_FULL, R: int = R_FULL, waves: int = P13_WAVES,
                              sessions: int = P13_SESSIONS) -> dict:
    """Phase 13 (a): a durable gateway cluster (``GatewayCluster(R, S,
    persistence="wal")``, every replica's runtime, tick, codec, store and
    WAL native, TCP on 127.0.0.1, group-commit fsync into a temporary
    directory) under ``sessions`` ``RabiaClient`` sessions: ``waves``
    waves of one SET on every shard (32-byte keys, 64-byte values, shard s
    written only by session s % sessions), every ack checked; then the
    replay of every (client, seq), answered CACHED from the session table
    with the original bytes and no new decided slot; then every key read
    by ReadIndex through a gateway whose reader is ``devkv_read_handler``
    over a ``MeshEngine(device_store=True)`` on ``device`` fed every
    committed SET, and through a gateway over a replica's native store
    (``kv_read_handler``): both answers byte-equal and equal to the last
    acknowledged value and version. While the writes run, the gateways'
    slow Submits are decomposed into critical-path segments
    (``obs/critpath``), beside the runtime's stage clocks (RTS) over the
    same span. The engine, the gateways and the ``MeshEngine`` run on this
    one event-loop thread."""
    # result caches kept for the replay: no session GC inside the phase
    gw_cfg = GatewayConfig(gc_interval=3600.0)
    cluster = GatewayCluster(R, S, config=_tcp_config(S), gateway_config=gw_cfg,
                             persistence="wal")
    await cluster.start(quorum_wait=120.0)
    clients: list = []
    devgw = None
    try:
        planes = [e.health()["planes"] for e in cluster.engines]
        _p13_check_planes(planes, "(a)")
        eps = cluster.endpoints()
        clients = [RabiaClient([eps[i % R]], call_timeout=120.0) for i in range(sessions)]
        for c in clients:
            await c.connect()
        logs: list = [[] for _ in clients]  # (seq, shard, commands, response)
        lat: list = []
        wal0 = _wal_totals(cluster.engines)
        slots0 = await _committed_slots(cluster.engines)
        rts0 = _rts_seconds(cluster.engines)
        sampler = _CritpathSampler(lambda: cluster.gateways, lambda: cluster.engines,
                                   lambda: ()).start()

        async def writer(ci: int, w: int) -> None:
            c = clients[ci]
            for s in range(ci, S, sessions):
                cmds = [encode_set_bin(_p13_key(s), _p13_val(w, s))]
                t = time.perf_counter()
                resp = await c.submit(s, cmds)
                lat.append(time.perf_counter() - t)
                _check(decode_kv_response(resp[0]).ok, f"phase 13 (a): SET on shard {s} failed")
                logs[ci].append((c._seq, s, cmds, resp))  # sessions submit in order

        t0 = time.perf_counter()
        for w in range(waves):
            await asyncio.gather(*(writer(ci, w) for ci in range(sessions)))
        write_s = time.perf_counter() - t0
        cp = await sampler.stop()
        rts = _rts_delta(rts0, _rts_seconds(cluster.engines))
        wal1 = _wal_totals(cluster.engines)
        durable = [int(e._wal.durable_lsn()) for e in cluster.engines]
        acked = sum(len(lg) for lg in logs)
        _check(acked == waves * S, f"phase 13 (a): {acked} acks, not {waves * S}")

        # the replay: every (client, seq) again, from the session cache
        slots1 = await _committed_slots(cluster.engines)

        async def replay(ci: int) -> int:
            c, n = clients[ci], 0
            for seq, s, cmds, resp in logs[ci]:
                res = await c._call(seq, Submit(client_id=c.client_id, seq=seq, shard=s,
                                                commands=tuple(cmds), ack_upto=c._ack_upto))
                _check(res.status == ResultStatus.CACHED and list(res.payload) == resp,
                       f"phase 13 (a): replay of ({ci}, {seq}) not answered from the cache")
                n += 1
            return n

        t0 = time.perf_counter()
        replayed = sum(await asyncio.gather(*(replay(ci) for ci in range(sessions))))
        replay_s = time.perf_counter() - t0
        await asyncio.sleep(0.5)
        slots2 = await _committed_slots(cluster.engines)
        _check(slots2 == slots1, f"phase 13 (a): the replay decided new slots {slots1} -> {slots2}")

        # the device table: every committed SET of each shard, in order
        streams = [[encode_set_bin(_p13_key(s), _p13_val(w, s)) for w in range(waves)]
                   for s in range(S)]
        table, feed, mesh = _device_feed_engine(device, S, R, streams, "13 (a)")
        want = {(s, _p13_key(s).encode()): (_p13_val(waves - 1, s).encode(), waves)
                for s in range(S)}
        _check(table == want, "phase 13 (a): the device table differs from the acked writes")
        reader = _CountedReader(mesh)
        devgw = GatewayServer(cluster.engines[0], reader=reader,
                              config=GatewayConfig(gc_interval=3600.0))
        await devgw.start()
        for g in cluster.gateways:
            devgw.add_peer_gateway(g.node_id, "127.0.0.1", g.port)
            g.add_peer_gateway(devgw.node_id, "127.0.0.1", devgw.port)
        items = [(s, _p13_key(s).encode()) for s in range(S)]
        on_card = torch.device(device).type == "cuda"
        dev_clients = [RabiaClient([devgw.endpoint], call_timeout=120.0) for _ in range(sessions)]
        host_clients = [RabiaClient([eps[1 % R]], call_timeout=120.0) for _ in range(sessions)]
        for c in dev_clients + host_clients:
            await c.connect()
        clients += dev_clients + host_clients
        kv_window.KV_WINDOW.events = [] if on_card else None
        n0 = _kernel_counts()
        rounds0 = devgw.stats.probe_rounds
        dev_lat: list = []
        try:
            t0 = time.perf_counter()
            dev_ans = await _p13_reads(dev_clients, items, dev_lat)
            dev_read_s = time.perf_counter() - t0
            timed = [(_KV_FORM_KERNEL[f], a, b) for f, a, b in kv_window.KV_WINDOW.events or ()]
        finally:
            kv_window.KV_WINDOW.events = None
        kvr = _kernel_counts()["kv_read"] - n0["kv_read"]
        rounds = devgw.stats.probe_rounds - rounds0
        kvr_ms = sum(a.elapsed_time(b) for k, a, b in timed if k == "kv_read") if on_card else None
        host_lat: list = []
        t0 = time.perf_counter()
        host_ans = await _p13_reads(host_clients, items, host_lat)
        host_read_s = time.perf_counter() - t0
        equal = 0
        for (s, k), a, b in zip(items, dev_ans, host_ans):
            r = decode_result_bin(a)
            _check(a == b, f"phase 13 (a): shard {s}: device and host answers differ")
            _check(r.value == _p13_val(waves - 1, s) and r.version == waves,
                   f"phase 13 (a): shard {s} reads {r}, not the last acked write")
            equal += 1
        # a probe round's covered reads are one read_many (one kv_read
        # launch); reads waiting for the replica's apply go per shard
        if on_card:
            reader.check(kvr, rounds, "phase 13 (a)")
        _check(devgw.stats.reads >= S and devgw.stats.reads_failed == 0,
               f"phase 13 (a): the device reader served {devgw.stats.reads} reads, "
               f"{devgw.stats.reads_failed} failed")
        wp50, wp99 = settle_quantiles(lat)
        rp50, rp99 = settle_quantiles(dev_lat)
        hp50, hp99 = settle_quantiles(host_lat)
        fsyncs = wal1.get("fsyncs", 0) - wal0.get("fsyncs", 0)
        recs = wal1.get("group_records", 0) - wal0.get("group_records", 0)
        return {
            "shards": S, "replicas": R, "sessions": sessions, "waves": waves,
            "acked_writes": acked, "write_s": write_s, "writes_per_s": acked / write_s,
            "submit_ack_p50_s": wp50, "submit_ack_p99_s": wp99,
            "decided_slots": [b - a for a, b in zip(slots0, slots1)],
            "wal_fsyncs": fsyncs,
            "wal_bytes": wal1.get("flush_bytes", 0) - wal0.get("flush_bytes", 0),
            "wal_records": recs,
            "wal_records_per_fsync": recs / fsyncs if fsyncs else None,
            "wal_fsync_s": (wal1.get("fsync_ns", 0) - wal0.get("fsync_ns", 0)) / 1e9,
            "durable_lsn": min(durable), "durable_lsn_by_replica": durable,
            "wal_fs": _fs_type(cluster.wal_dir),
            "replayed_from_cache": replayed, "replay_s": replay_s,
            "reads_equal": equal, "probe_rounds": rounds, "kv_read_launches": kvr,
            "reads_batched": devgw.stats.reads_batched, "read_many_calls": len(reader.calls),
            "reads_alone": reader.alone,
            "kv_read_device_ms": kvr_ms if on_card else "not measured (CPU)",
            "devkv_read_s": dev_read_s, "devkv_read_p50_s": rp50, "devkv_read_p99_s": rp99,
            "host_read_s": host_read_s, "host_read_p50_s": hp50, "host_read_p99_s": hp99,
            "critpath": cp, "rts_stages": rts,
            "planes": planes[0], **{f"feed_{k}": v for k, v in feed.items()},
        }
    finally:
        for c in clients:
            await c.close()
        if devgw is not None:
            await devgw.close()
        await cluster.stop()
        import shutil

        shutil.rmtree(cluster.wal_dir, ignore_errors=True)


async def _recovery_trial(device, S: int, R: int, preload: int, kill: int) -> dict:
    h = RecoveryHarness(R, S)
    loop = asyncio.get_running_loop()
    clients: list = []
    try:
        t0 = time.perf_counter()
        ready = await loop.run_in_executor(None, lambda: h.start(timeout=600.0))
        start_s = time.perf_counter() - t0
        _p13_check_planes([r["planes"] for r in ready], "(b)")
        eps = h.endpoints()
        acked: dict = {}  # shard -> [SET ops in ack order]
        clients = [RabiaClient([eps[i % R]], call_timeout=120.0) for i in range(16)]
        for c in clients:
            await c.connect()
        by_shard: dict = {}
        for k in range(preload):
            by_shard.setdefault(k % S, []).append(
                encode_set_bin(_p13_key(k, "p"), _p13_val(0, k)))
        shard_list = sorted(by_shard)

        async def preloader(ci: int) -> None:
            c = clients[ci]
            for s in shard_list[ci::len(clients)]:
                resp = await c.submit(s, by_shard[s])
                _check(all(decode_kv_response(x).ok for x in resp),
                       f"phase 13 (b): preload of shard {s} failed")
                acked.setdefault(s, []).extend(by_shard[s])

        t0 = time.perf_counter()
        await asyncio.gather(*(preloader(ci) for ci in range(len(clients))))
        preload_s = time.perf_counter() - t0

        survivors = [eps[j] for j in range(R) if j != kill]
        load_cli = RabiaClient(survivors, call_timeout=120.0)
        await load_cli.connect()
        clients.append(load_cli)
        stop = asyncio.Event()
        load_ok = [0]

        async def loadgen() -> None:
            k = 0
            while not stop.is_set():
                s = k % S
                op = encode_set_bin(_p13_key(k, "l"), _p13_val(1, k))
                resp = await load_cli.submit(s, [op])
                _check(decode_kv_response(resp[0]).ok, "phase 13 (b): a load SET failed")
                acked.setdefault(s, []).append(op)
                load_ok[0] += 1
                k += 1
                await asyncio.sleep(1.0 / P13_LOAD_RATE)

        load_task = asyncio.ensure_future(loadgen())
        await asyncio.sleep(0.5)
        h.kill9(kill)
        await asyncio.sleep(1.0)  # decided waves the dead replica misses
        t_restart = time.perf_counter()
        report = await loop.run_in_executor(None, lambda: h.restart(kill, 600.0))
        ready_s = time.perf_counter() - t_restart
        _p13_check_planes([report["planes"]], "(b) restarted")
        rejoin_cli = RabiaClient([h.endpoints()[kill]], call_timeout=120.0)
        await rejoin_cli.connect()
        clients.append(rejoin_cli)
        probe = encode_set_bin(_p13_key(0, "r"), _p13_val(2, 0))
        resp = await rejoin_cli.submit(0, [probe])
        _check(decode_kv_response(resp[0]).ok, "phase 13 (b): the restarted replica's SET failed")
        acked.setdefault(0, []).append(probe)
        rejoin_s = time.perf_counter() - t_restart
        before = load_ok[0]
        await asyncio.sleep(1.0)
        goodput = load_ok[0] - before
        stop.set()
        await load_task
        _check(goodput > 0, "phase 13 (b): no goodput after the rejoin")

        # every acked write read back through the restarted replica's gateway
        last: dict = {}
        for s, ops in acked.items():
            for op in ops:
                last[(s, _op_key(op))] = op
        items = sorted(last)
        readers = [RabiaClient([h.endpoints()[kill]], call_timeout=120.0) for _ in range(32)]
        for c in readers:
            await c.connect()
        clients += readers
        lat: list = []
        t0 = time.perf_counter()
        answers = await _p13_reads(readers, items, lat)
        read_s = time.perf_counter() - t0
        table, feed, mesh = _device_feed_engine(
            device, S, R, [acked.get(s, []) for s in range(S)], "13 (b)")
        dev_answers = devkv_read_handler(mesh).read_many(items)
        for (s, k), a, d in zip(items, answers, dev_answers):
            op = last[(s, k)]
            r = decode_result_bin(a)
            _check(r.ok and r.value.encode() == op[3 + len(k):],
                   f"phase 13 (b): shard {s} key {k!r} reads {r} after the restart")
            _check(a == d, f"phase 13 (b): shard {s} key {k!r}: gateway and device table differ")
        rec = report.get("recovery") or {}
        p50, p99 = settle_quantiles(lat)
        return {
            "shards": S, "replicas": R, "preload_keys": preload, "killed": kill,
            "start_s": start_s, "preload_s": preload_s,
            "snapshot_restore_s": rec.get("snapshot_restore_s"),
            "wal_replay_s": rec.get("wal_replay_s"), "waves_replayed": rec.get("waves_replayed"),
            "wal_records": rec.get("wal_records"), "chain_files": rec.get("chain_files"),
            "torn": rec.get("torn"), "process_ready_s": ready_s, "rejoin_under_load_s": rejoin_s,
            "post_rejoin_goodput_per_s": goodput, "load_acked": load_ok[0],
            "reads": len(items), "read_s": read_s, "read_p50_s": p50, "read_p99_s": p99,
            "wal_fs": _fs_type(h.wal_root), **{f"feed_{k}": v for k, v in feed.items()},
        }
    finally:
        for c in clients:
            await c.close()
        h.stop()
        import shutil

        shutil.rmtree(h.wal_root, ignore_errors=True)


def recovery_run(device, S: int = S_FULL, R: int = R_FULL, preload: int = P13_PRELOAD,
                 kill: int = 1) -> dict:
    """Phase 13 (b): kill -9 and recovery at the same shape.
    ``RecoveryHarness(R, S)``: R replica processes on ``WalPersistence``,
    each behind its gateway (every plane native); ``preload`` keys with
    64-byte values sent as concurrent multi-op submits (one a shard);
    replica ``kill`` killed by SIGKILL under a load generator's traffic
    on the survivors, restarted, and timed (snapshot restore, WAL replay,
    rejoin under load, goodput after the rejoin). Every acknowledged
    write reads back by ReadIndex through the restarted replica's
    gateway, and equals ``devkv_read_handler(...).read_many`` over a
    ``MeshEngine(device_store=True)`` on ``device`` fed the acknowledged
    writes in order. The children are host replicas, spawned as new
    interpreters (never forked from this process, which holds the card)."""
    return asyncio.run(_recovery_trial(device, S, R, preload, kill))



# -- critical-path sampling (phases 13 (a) and 14) ----------------------------


class _CritpathSampler:
    """Decomposes the gateways' young slowlog exemplars while a phase runs
    (``obs/critpath``): every ``interval`` s, the ``per_tick`` slowest of
    the gateways' recent fresh-Submit completions (each reservoir's top
    ``per_gateway``) not seen yet are decomposed from the engines' (and
    fleet gateways') flight rings while the rings still hold them, and fed
    to one ``CritpathAggregator`` (a wrapped ring counts as truncated, a
    missing anchor as unanchored: neither enters the means). It runs on
    the phase's event loop; ``busy_s`` is what it took there."""

    def __init__(self, gateways, engines, fleet=(), interval: float = 2.0,
                 max_age_s: float = 3.0, per_gateway: int = 4, per_tick: int = 2) -> None:
        self.gateways, self.engines, self.fleet = gateways, engines, fleet
        self.interval, self.max_age_s = interval, max_age_s
        self.per_gateway, self.per_tick = per_gateway, per_tick
        self.agg = CritpathAggregator()
        self.seen: set = set()
        self.walls: list = []
        self.dominants: dict = {}
        self.busy_s = 0.0
        self.ticks = 0
        self._task = None

    def sample(self) -> None:
        t0 = time.perf_counter()
        fresh = []
        for g in self.gateways():
            if g is None:
                continue
            for ex in g.slowlog.document(self.per_gateway).get("exemplars", []):
                key = (ex.get("batch"), ex.get("wave"))
                if key not in self.seen and float(ex.get("age_s", 0.0)) <= self.max_age_s:
                    self.seen.add(key)
                    fresh.append(ex)
        # the slowest few a tick: each costs a pass over every engine's rings
        fresh = sorted(fresh, key=lambda e: -float(e.get("wall_s") or 0.0))[:self.per_tick]
        if fresh:
            engines = [e for e in self.engines() if e is not None]
            events = [e.flight_events() for e in engines]  # each ring read once a tick
            rec = [(g.flight, g.config.name, g._row) for g in self.fleet() if g is not None]
            for ex in fresh:
                d = decompose(inprocess_exemplar_timeline(engines, ex, rec, events=events),
                              coalesced=ex.get("coalesced"), wall_s=ex.get("wall_s"))
                if self.agg.add(d):
                    self.walls.append(float(ex.get("wall_s") or d["total_s"]))
                    dom = dominant_segment(d)
                    self.dominants[dom] = self.dominants.get(dom, 0) + 1
        self.ticks += 1
        self.busy_s += time.perf_counter() - t0

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            self.sample()

    def start(self) -> "_CritpathSampler":
        self._task = asyncio.ensure_future(self._run())
        return self

    async def stop(self) -> dict:
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass
        self.sample()
        s = self.agg.summary()
        segs = s["segments"]
        total = sum(segs.values())
        return {
            "exemplars": s["exemplars"], "decomposed": len(self.walls),
            "truncated": s["truncated"], "unanchored": s["unanchored"],
            "exemplar_wall_p50_s": settle_quantiles(self.walls)[0],
            "segments_mean_ms": {k: round(v * 1e3, 3) for k, v in segs.items()},
            "segments_share": {k: round(v / total, 4) for k, v in segs.items()} if total else {},
            "dominant_counts": self.dominants,
            "sampler_ticks": self.ticks, "sampler_busy_s": round(self.busy_s, 3),
        }


def _rts_seconds(engines) -> dict:
    """The native runtime's stage clocks (RTS, ns) summed over replicas."""
    out: dict = {}
    for e in engines:
        if e is not None and e._rtm is not None:
            for k, v in e._rtm.stages_dict().items():
                out[k] = out.get(k, 0) + int(v)
    return out


def _rts_delta(a: dict, b: dict) -> dict:
    d = {k: (b.get(k, 0) - a.get(k, 0)) / 1e9 for k in b}
    tot = sum(d.values())
    return {"seconds": {k: round(v, 4) for k, v in d.items()},
            "share": {k: round(v / tot, 4) for k, v in d.items()} if tot else {}}


def _fmt_critpath(cp: dict) -> str:
    segs = sorted(cp["segments_mean_ms"].items(), key=lambda kv: -kv[1])
    return (f"{cp['decomposed']} slow Submits decomposed ({cp['truncated']} truncated, "
            f"{cp['unanchored']} unanchored), mean ms by segment "
            + ", ".join(f"{k} {v:.1f} ({cp['segments_share'].get(k, 0) * 100:.0f}%)"
                        for k, v in segs))


# -- phase 14 ------------------------------------------------------------------


def _fleet_upstreams(gw, addrs: list) -> None:
    """Point a fleet gateway's proxied traffic (its reads' too) at
    ``addrs``, closing its links to the old upstreams."""
    old = gw._upstreams
    gw.config = dataclasses.replace(gw.config, upstreams=tuple(addrs))
    gw._upstreams = [_UpstreamLink(gw, h, p) for h, p in addrs]
    for up in old:
        asyncio.ensure_future(up.close())


async def _fleet_reads(readers, items: list, lat: list, retries: list) -> list:
    """Every (shard, key) read by ReadIndex through the fleet gateways, the
    items dealt to the readers in turn. A RETRY (a probe round that timed
    out) is read again and counted."""
    out: list = [None] * len(items)

    async def one(ri: int) -> None:
        r = readers[ri]
        for i in range(ri, len(items), len(readers)):
            s, k = items[i]
            t = time.perf_counter()
            for _ in range(10):
                res = await r.read(s, k, 120.0)
                if res.status != ResultStatus.RETRY:
                    break
                retries[0] += 1
            lat.append(time.perf_counter() - t)
            _check(res.status == ResultStatus.OK, f"phase 14: read of shard {s}: {res.status}")
            out[i] = bytes(res.payload[0])

    await asyncio.gather(*(one(ri) for ri in range(len(readers))))
    return out


async def fleet_run(device, S: int = S_FULL, R: int = R_FULL, waves: int = P14_WAVES,
                    sessions: int = P14_SESSIONS, n_gateways: int = P14_GATEWAYS) -> dict:
    """Phase 14: a routed fleet (``FleetHarness(n_gateways, R, S,
    persistence="wal")``: phase 13's durable cluster as the replica tier,
    ``n_gateways`` fleet gateways on a hash ring in front of it) under
    ``sessions`` ``FleetSession`` clients sharing one ``FleetConnPool``:
    ``waves`` waves of one SET on every shard (32-byte keys, 64-byte
    values, shard s written only by session s % sessions). Between the
    waves the ring drops its last member (``rebalance``: it hands its
    sessions off and answers MOVED); halfway through the last wave
    gateway 0 is killed (``kill_gateway``: no handoff, the survivors
    adopt the shrunken ring) and its clients fail over to the ring's
    successor with the same seq. With one wave the drop comes a third of
    the way in, the kill two thirds. Then every (client, seq) is replayed
    through the fleet and must answer CACHED with the original bytes and
    no new decided slot; the cluster's committed SETs feed a
    ``MeshEngine(device_store=True)`` on ``device``, the fleet gateways'
    reads go to a replica gateway whose reader is ``devkv_read_handler``
    over it, and every key read by ReadIndex through the fleet must equal
    a replica's native store byte for byte and the last acknowledged
    write (its version ``waves``: no write applied twice). The slow
    Submits are decomposed along the way (``obs/critpath``), and the
    fleet aggregator's table (``obs/fleet_obs``) is printed."""
    h = FleetHarness(n_gateways=n_gateways, n_replicas=R, n_shards=S, persistence="wal",
                     gateway_config=GatewayConfig(gc_interval=3600.0))
    h.cluster.config = _tcp_config(S)  # phase 12's engine settings, as in phase 13
    await h.start()
    pool = FleetConnPool(h.ser)
    clients: list = []
    readers: list = []
    devgw = None
    try:
        resolver = h.resolver()
        sess = [FleetSession(h.ser, resolver, pool=pool, call_timeout=120.0)
                for _ in range(sessions)]
        # a member that does not answer within the timeout is marked stale
        agg = FleetAggregator(("127.0.0.1", h.gateways[0].port), timeout=3.0)
        await agg.refresh()
        await agg.sample()
        sampler = _CritpathSampler(lambda: h.cluster.gateways, lambda: h.cluster.engines,
                                   lambda: h.gateways).start()
        logs: list = [[] for _ in sess]  # (seq, shard, commands, payload)
        lat: list = []
        acked = [0]
        total = waves * S
        marks = ([S, S + S // 2] if waves > 1 else [S // 3, 2 * S // 3])
        hit = [asyncio.Event(), asyncio.Event()]
        slots0 = await _committed_slots(h.cluster.engines)

        async def writer(ci: int, w: int) -> None:
            c = sess[ci]
            for s in range(ci, S, sessions):
                cmds = [encode_set_bin(_p13_key(s, "f"), _p13_val(w, s))]
                t = time.perf_counter()
                res = await c.submit(s, cmds, timeout=600.0)
                lat.append(time.perf_counter() - t)
                _check(res.status in (ResultStatus.OK, ResultStatus.CACHED)
                       and decode_kv_response(res.payload[0]).ok,
                       f"phase 14: SET on shard {s} answered {res.status}")
                logs[ci].append((res.seq, s, cmds, tuple(bytes(p) for p in res.payload)))
                acked[0] += 1
                for m, ev in zip(marks, hit):
                    if acked[0] == m:
                        ev.set()

        async def events() -> None:
            if waves == 1:
                await hit[0].wait()
                await h.rebalance(range(n_gateways - 1))
            await hit[1].wait()
            await h.kill_gateway(0)

        ev_task = asyncio.ensure_future(events())
        t0 = time.perf_counter()
        for w in range(waves):
            await asyncio.gather(*(writer(ci, w) for ci in range(sessions)))
            if w == 0 and waves > 1:
                await h.rebalance(range(n_gateways - 1))
        write_s = time.perf_counter() - t0
        await ev_task
        cp = await sampler.stop()
        _check(acked[0] == total, f"phase 14: {acked[0]} acks, not {total}")
        fleet_doc = await agg.sample()  # its inventory still lists the killed member
        table_txt = render_fleet_table(fleet_doc)
        redirects = sum(c.redirects for c in sess)
        failovers = sum(c.failovers for c in sess)
        live = [g for g in h.gateways if g is not None]
        st = {k: sum(getattr(g.stats, k) for g in live)
              for k in ("moved", "ledger_sent", "ledger_applied", "handoff_out_sessions",
                        "handoff_in_sessions", "forwarded", "cached_replays")}
        _check(redirects > 0, "phase 14: no client followed a MOVED")
        _check(failovers > 0, "phase 14: no client failed over after the kill")

        # the replay: every (client, seq) again through the fleet
        slots1 = await _committed_slots(h.cluster.engines)

        async def replay(ci: int) -> int:
            c, n = sess[ci], 0
            for seq, s, cmds, payload in logs[ci]:
                res = await c.submit_seq(seq, s, cmds, timeout=600.0)
                _check(res.status == ResultStatus.CACHED
                       and tuple(bytes(p) for p in res.payload) == payload,
                       f"phase 14: replay of ({ci}, {seq}) answered {res.status}")
                n += 1
            return n

        t0 = time.perf_counter()
        replayed = sum(await asyncio.gather(*(replay(ci) for ci in range(sessions))))
        replay_s = time.perf_counter() - t0
        await asyncio.sleep(0.5)
        slots2 = await _committed_slots(h.cluster.engines)
        _check(slots2 == slots1, f"phase 14: the replay decided new slots {slots1} -> {slots2}")

        # the card's table behind the fleet's reads
        await h.cluster.wait_converged(120)
        streams = [[encode_set_bin(_p13_key(s, "f"), _p13_val(w, s)) for w in range(waves)]
                   for s in range(S)]
        table, feed, mesh = _device_feed_engine(device, S, R, streams, "14")
        want = {(s, _p13_key(s, "f").encode()): (_p13_val(waves - 1, s).encode(), waves)
                for s in range(S)}
        _check(table == want, "phase 14: the device table differs from the acked writes")
        reader = _CountedReader(mesh)
        devgw = GatewayServer(h.cluster.engines[0], reader=reader,
                              config=GatewayConfig(gc_interval=3600.0))
        await devgw.start()
        for g in h.cluster.gateways:
            devgw.add_peer_gateway(g.node_id, "127.0.0.1", g.port)
            g.add_peer_gateway(devgw.node_id, "127.0.0.1", devgw.port)
        for g in live:
            _fleet_upstreams(g, [("127.0.0.1", devgw.port)])
        items = [(s, _p13_key(s, "f").encode()) for s in range(S)]
        readers = [LoadSession(h.ser) for _ in range(sessions)]
        for i, r in enumerate(readers):
            g = live[i % len(live)]
            await pool.attach(r, ("127.0.0.1", g.port), 60.0)
        on_card = torch.device(device).type == "cuda"
        kv_window.KV_WINDOW.events = [] if on_card else None
        n0 = _kernel_counts()
        rounds0 = devgw.stats.probe_rounds
        read_lat: list = []
        retries = [0]
        try:
            t0 = time.perf_counter()
            fleet_ans = await _fleet_reads(readers, items, read_lat, retries)
            read_s = time.perf_counter() - t0
            timed = [(_KV_FORM_KERNEL[f], a, b) for f, a, b in kv_window.KV_WINDOW.events or ()]
        finally:
            kv_window.KV_WINDOW.events = None
        kvr = _kernel_counts()["kv_read"] - n0["kv_read"]
        rounds = devgw.stats.probe_rounds - rounds0
        kvr_ms = sum(a.elapsed_time(b) for k, a, b in timed if k == "kv_read") if on_card else None
        _check(devgw.stats.reads >= S and devgw.stats.reads_failed == 0,
               f"phase 14: the device reader served {devgw.stats.reads} reads, "
               f"{devgw.stats.reads_failed} failed")
        if on_card:
            reader.check(kvr, rounds, "phase 14")
        hosts = [RabiaClient([h.cluster.endpoint(1)], call_timeout=120.0)
                 for _ in range(sessions)]
        for c in hosts:
            await c.connect()
        clients += hosts
        host_ans = await _p13_reads(hosts, items, [])
        equal = 0
        for (s, k), a, b in zip(items, fleet_ans, host_ans):
            r = decode_result_bin(a)
            _check(a == b, f"phase 14: shard {s}: the fleet's answer differs from a replica's")
            _check(r.value == _p13_val(waves - 1, s) and r.version == waves,
                   f"phase 14: shard {s} reads {r}, not the last acked write")
            equal += 1
        wp50, wp99 = settle_quantiles(lat)
        rp50, rp99 = settle_quantiles(read_lat)
        return {
            "shards": S, "replicas": R, "fleet_gateways": n_gateways, "sessions": sessions,
            "waves": waves, "acked_writes": acked[0], "write_s": write_s,
            "writes_per_s": acked[0] / write_s,
            "submit_ack_p50_s": wp50, "submit_ack_p99_s": wp99,
            "decided_slots": [b - a for a, b in zip(slots0, slots1)],
            "moved_redirects": redirects, "failovers": failovers, "fleet_stats": st,
            "replayed_from_cache": replayed, "replay_s": replay_s,
            "reads_equal": equal, "read_retries": retries[0], "read_s": read_s,
            "read_p50_s": rp50, "read_p99_s": rp99,
            "probe_rounds": rounds, "kv_read_launches": kvr,
            "reads_batched": devgw.stats.reads_batched, "read_many_calls": len(reader.calls),
            "reads_alone": reader.alone,
            "kv_read_device_ms": kvr_ms if on_card else "not measured (CPU)",
            "critpath": cp, "fleet_table": table_txt,
            **{f"feed_{k}": v for k, v in feed.items()},
            "_mesh": mesh,
        }
    finally:
        for r in readers:
            await r.close()
        for c in clients:
            await c.close()
        if devgw is not None:
            await devgw.close()
        await pool.close()
        await h.stop()
        import shutil

        shutil.rmtree(h.cluster.wal_dir, ignore_errors=True)


def probe_graph_ms(mesh, S: int) -> tuple[float, int]:
    """The probe kernel at phase 14's shape (one key a shard, the engine's
    window) on its table, by graph replay, and its largest difference
    from the plain version (must be 0). Called after the phase's counts
    are read: these launches compare and time, they are not the path's."""
    dkv = mesh._dev
    ops = dkv.pack_get_window_auto([build_block(
        np.arange(S), [[_key_op(2, _p13_key(s, "f").encode())] for s in range(S)])])
    idx, klen, _, kwin, _ = dkv._upload(dkv._host_ops(ops, mesh.window, values=False))
    kw = dict(want_table=False, want_reads=True, idx=idx)
    call = lambda i=0: kv_window.KV_WINDOW(dkv.state, kv_window.KIND_GET, klen, None,  # noqa: E731
                                           kwin, None, 0, **kw)
    want = _flat(kv_window.kv_window_plain(dkv.state, kv_window.KIND_GET, klen, None, kwin,
                                           None, 0, **kw))
    got = _flat(call())
    torch.cuda.synchronize()
    err = max(_max_err(a, b) for a, b in zip(want, got))
    _check(len(want) == len(got) and err == 0, "phase 14: the probe kernel != plain")
    return _graph_ms(call, 50), err


# -- phase 15 ------------------------------------------------------------------


async def _mesh_lane_cycle(device, S: int, R: int, mesh=None) -> dict:
    """The mesh fabric's forced demotion and re-promotion at S x R on
    ``device`` (or over ``mesh``): its SET waves on 8 keys a shard
    (inside the device table's 64 slots), a GET wave every third arrival
    (the read lane), ``demote_device``, arrivals until the lane
    re-promotes, then the fabric's verify sweep and convergence."""
    prof = dataclasses.replace(smoke_profiles()["mesh_device_read_lane"], n_shards=S,
                               n_replicas=R)
    fab = _MeshFabric(prof, device=None if mesh is not None else device, mesh=mesh)
    await fab.start()
    try:
        i = 1
        for _ in range(12):
            _check(await fab.submit(i, [(f"c{i % 8}", f"v{i}")], 120.0) == "ok",
                   "phase 15 lane cycle: an arrival failed")
            i += 1
        _check(fab.eng.device_lane_active, "phase 15 lane cycle: the lane was down before the demotion")
        probes0 = fab.eng.read_lane_stats()["probe"]
        fab.apply_event("demote_device", {})
        _check(not fab.eng.device_lane_active, "phase 15 lane cycle: demote_device left the lane up")
        t0 = time.perf_counter()
        demoted_arrivals = 0
        while not fab.eng.device_lane_active and demoted_arrivals < 200:
            _check(await fab.submit(i, [(f"c{i % 8}", f"v{i}")], 120.0) == "ok",
                   "phase 15 lane cycle: an arrival failed while demoted")
            i += 1
            demoted_arrivals += 1
        repromote_s = time.perf_counter() - t0
        _check(fab.eng.device_lane_active, "phase 15 lane cycle: the lane never re-promoted")
        for _ in range(3):
            _check(await fab.submit(i, [(f"c{i % 8}", f"v{i}")], 120.0) == "ok",
                   "phase 15 lane cycle: an arrival failed after the re-promotion")
            i += 1
        problems = await fab.verify()
        _check(not problems, f"phase 15 lane cycle: {problems}")
        _check(fab.eng.read_lane_stats()["probe"] > probes0,
               "phase 15 lane cycle: no probe read after the re-promotion")
        summary = fab.summary()
        _check(summary["forced_demotions"] == 1 and summary["lane_promotions"] >= 1,
               f"phase 15 lane cycle: {summary}")
        _check(await fab.converged(120.0), "phase 15 lane cycle: the replicas differ")
        return {**summary, "arrivals": i - 1, "demoted_arrivals": demoted_arrivals,
                "repromote_s": repromote_s}
    finally:
        await fab.stop()


def chaos_run(device, mesh_S: int = P15_MESH_S, mesh_R: int = P15_MESH_R) -> dict:
    """Phase 15: the chaos smoke set's (``smoke_profiles()``) profiles
    that use the card, the mesh fabric's, through ``run_profile``, each
    with the reference's events, rate and time scale at ``mesh_S``
    shards x ``mesh_R`` replicas, its engine on ``device``; then the
    mesh fabric's demotion and re-promotion at that width
    (:func:`_mesh_lane_cycle`). The set's host-only profiles run in the
    CPU tests. Every profile runs; the phase fails after them if any
    failed."""
    out: dict = {}
    for name, prof in smoke_profiles().items():
        if prof.fabric != "mesh":
            continue
        prof = dataclasses.replace(prof, n_shards=mesh_S, n_replicas=mesh_R)
        t0 = time.perf_counter()
        rep = asyncio.run(run_profile(prof, verbose=True, device=device))
        out[name] = {
            "fabric": rep["fabric"], "pass": rep["pass"], "problems": rep["problems"],
            "availability": rep["availability"],
            "final_quarter_availability": rep["final_quarter_availability"],
            "arrivals": rep["arrivals"], "outcomes": rep["outcomes"],
            "settle_ms": rep["settle_ms"], "decisions": rep["phases_to_decide"]["decisions"],
            "shards": rep["shards"], "replicas": rep["replicas"],
            "watchdog_fired": (rep["watchdog"] or {}).get("fired"),
            "fabric_summary": rep["fabric_summary"], "s": time.perf_counter() - t0,
        }
    t0 = time.perf_counter()
    lane = asyncio.run(_mesh_lane_cycle(device, mesh_S, mesh_R))
    lane["s"] = time.perf_counter() - t0
    return {"profiles": out, "lane_cycle": lane}


# -- phase 16 ----------------------------------------------------------------


def cli_run() -> list:
    """``python -m rabia_tpu_torch`` and ``python -m rabia_tpu_torch
    --selftest`` as processes of their own on the card, from the root of
    the checkout; each must exit 0. Returns their output lines."""
    root = os.path.dirname(os.path.abspath(__file__))
    lines = []
    for args in ([], ["--selftest"]):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "rabia_tpu_torch", *args], cwd=root,
                             capture_output=True, text=True, timeout=600)
        _check(out.returncode == 0, f"python -m rabia_tpu_torch {' '.join(args)} exited "
                                    f"{out.returncode}: {out.stderr[-3000:]}")
        lines.append(f"$ python -m rabia_tpu_torch {' '.join(args)} "
                     f"({time.perf_counter() - t0:.2f} s)")
        lines += out.stdout.strip().splitlines()
    return lines


def _codes(shape, gen, device, low: int = 0, high: int = 4) -> torch.Tensor:
    return torch.randint(low, high, shape, generator=gen, device=device, dtype=torch.int8)


def _near_max(n: int, gen, device, span: int = 6) -> torch.Tensor:
    """int32 values in [2^31-1-span, 2^31-1]: one step more wraps."""
    top = 2**31 - 1
    return torch.randint(top - span, top + 1, (n,), generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32)


def random_node_case(gen, S: int, R: int, device):
    """A node state over all four codes (stages 0/1, done and inactive
    shards, slots and phases near 2^31-1) and one tick's inputs (a mask,
    slots near 2^31-1, V0/V1 initial votes, partial inboxes over all four
    codes, decisions to adopt on a few shards)."""
    from rabia_tpu_torch.kernel.phase_driver import NodeState

    def rand(shape):
        return torch.rand(shape, generator=gen, device=device)

    absent = lambda shape: torch.full(shape, ABSENT, dtype=torch.int8, device=device)  # noqa: E731
    st = NodeState(
        slot=_near_max(S, gen, device), phase=_near_max(S, gen, device),
        stage=_codes((S,), gen, device, 0, 2), my_r1=_codes((S,), gen, device),
        my_r2=_codes((S,), gen, device), led1=_codes((S, R), gen, device),
        led2=_codes((S, R), gen, device), decided=_codes((S,), gen, device),
        done=rand((S,)) < 0.2, active=rand((S,)) < 0.8,
    )
    ins = (
        rand((S,)) < 0.4, _near_max(S, gen, device), _codes((S,), gen, device, 0, 2),
        torch.where(rand((S, R)) < 0.5, _codes((S, R), gen, device), absent((S, R))),
        torch.where(rand((S, R)) < 0.5, _codes((S, R), gen, device), absent((S, R))),
        torch.where(rand((S,)) < 0.1, _codes((S,), gen, device, 0, 2), absent((S,))),
    )
    return st, ins


def node_kernel_vs_plain(device, Rs=(1, 3, 4, 5, 7, 8, 64), Ss=(17, 1000, 4096),
                         Ks=(0, 1, 3, 8), seed: int = 31) -> tuple[int, int]:
    """The node kernel (``NodeKernel.node_cycle`` on the card, one launch
    that reads its planes from pinned host memory and writes the host
    image there) against ``node_cycle_plain`` on the same inputs (on the
    card), every state field and every outbox plane (the launch leaves
    the state it was given as it was, or the plain version would differ),
    and the fetch's views of the host image against the plain state and
    outbox; against the same tick on the kernel's own plane views (the
    engine's way, donating the state); and against ``start_slots`` and K
    ``node_step``s on the card (K + 1 launches, each donating its state).
    Returns (max_abs_err, cases)."""
    from rabia_tpu_torch.kernel.phase_driver import NodeKernel, NodeState

    gen = torch.Generator(device=device).manual_seed(seed)
    worst, cases = 0, 0
    p1s = (0.0, 0.5, 1.0)
    for R in Rs:
        for S in Ss:
            for K in Ks:
                p1 = p1s[cases % 3]
                me = cases % R
                kw = dict(coin_p1=p1, seed=seed + cases, device=device)
                st, ins = random_node_case(gen, S, R, device)
                host = [x.cpu() for x in ins]
                nk = NodeKernel(S, R, me, **kw)
                a, oa = nk.node_cycle(st, *host, K)
                b, ob = nk.node_cycle_plain(st, *ins, K)
                err = max(_state_err(a, b), _state_err(oa, ob) if K else 0)
                hst, hob = nk.fetch(a, oa if K else None)
                for got, want in zip(hst, b):
                    if got is not None:  # the ledgers stay on the card
                        err = max(err, _max_err(torch.from_numpy(got).to(device), want))
                if K:
                    err = max(err, *(_max_err(torch.from_numpy(g).to(device), w)
                                     for g, w in zip(hob, ob)))
                # the engine's way: the planes written into the kernel's
                # views, the state donated (a copy of st in a tick buffer)
                eng = NodeKernel(S, R, me, **kw)
                mine = eng.init_state()
                for t, x in zip(mine, st):
                    t.copy_(x)
                for view, x in zip(eng.planes, host):
                    view[...] = x.numpy()
                e, oe = eng.node_cycle(NodeState(*mine), *eng.planes, K, donate=True)
                err = max(err, _state_err(e, b), _state_err(oe, ob) if K else 0)
                # start_slots, then K node_steps (ABSENT inboxes after the first)
                chain = NodeKernel(S, R, me, **kw)
                c = chain.start_slots(st, *host[:3], donate=True)
                absent = np.full((S, R), ABSENT, np.int8)
                no_dec = np.full((S,), ABSENT, np.int8)
                steps = []
                for k in range(K):
                    first = k == 0
                    c, o = chain.node_step(c, host[3] if first else absent,
                                           host[4] if first else absent, host[5] if first else no_dec,
                                           donate=True)
                    steps.append([t.clone() for t in o])  # the next step overwrites o
                err = max(err, _state_err(a, c))
                if K:
                    err = max(err, _state_err(oa, [torch.stack(x) for x in zip(*steps)]))
                _check(err == 0, f"node kernel != plain at R={R} S={S} K={K} p1={p1}")
                _check(nk.fetch_bytes == 0 and eng.fetch_bytes == 0,
                       "the node kernel's fetch copied bytes")
                worst = max(worst, err)
                cases += 1
    return worst, cases


def random_cluster_state(gen, S: int, R: int, device):
    """A ClusterState of protocol values: slots near 2^31-1, active and
    inactive shards, phases, stages, votes and ledgers over all codes."""
    from rabia_tpu_torch.kernel.phase_driver import ClusterState

    def rand(shape):
        return torch.rand(shape, generator=gen, device=device)

    return ClusterState(
        slot=_near_max(S, gen, device),
        phase=torch.randint(0, 9, (S, R), generator=gen, device=device, dtype=torch.int32),
        stage=_codes((S, R), gen, device, 0, 2), my_r1=_codes((S, R), gen, device),
        my_r2=_codes((S, R), gen, device), prev_r1=_codes((S, R), gen, device),
        prev_r2=_codes((S, R), gen, device), led1=_codes((S, R, R), gen, device),
        led2=_codes((S, R, R), gen, device), decided=_codes((S,), gen, device),
        decided_phase=torch.randint(-1, 9, (S,), generator=gen, device=device,
                                    dtype=torch.int32),
        done=rand((S, R)) < 0.3, active=rand((S,)) < 0.7,
    )


def packers_vs_plain(device, Rs=(1, 5, 8), Ss=(17, 1000, 4095), T: int = 33,
                     seed: int = 32) -> int:
    """``pack_codes``, ``pack_alive``, ``pack_inputs`` and ``unpack_codes``
    (the packer kernels) against their plain versions on the card: ragged
    S, codes over all four values, unpacking to fewer lanes, inputs that
    start one word and one byte into a buffer. Returns the max_abs_err."""
    gen = torch.Generator(device=device).manual_seed(seed)
    worst = 0
    for R in Rs:
        for S in Ss:
            votes = _codes((R, T, S), gen, device)
            alive = torch.rand((R, S), generator=gen, device=device) < 0.7
            packed = packed_window.pack_codes(votes)
            alive_p = packed_window.pack_alive_plain(alive)
            both = packed_window.pack_inputs(votes, alive)
            errs = [_max_err(packed, packed_window.pack_codes_plain(votes)),
                    _max_err(packed_window.pack_alive(alive), alive_p),
                    _max_err(both[0], packed), _max_err(both[1], alive_p),
                    _max_err(packed_window.unpack_codes(packed, S), votes),
                    _max_err(packed_window.unpack_codes(packed, S - 3),
                             packed_window.unpack_codes_plain(packed, S - 3))]
            for off in (1, 4):  # one byte, one word into a buffer
                raw = torch.empty(off + votes.numel(), dtype=torch.int8, device=device)
                view = raw[off:].view(votes.shape)
                view.copy_(votes)
                errs.append(_max_err(packed_window.pack_codes(view), packed))
                araw = torch.empty(off + alive.numel(), dtype=torch.bool, device=device)
                aview = araw[off:].view(alive.shape)
                aview.copy_(alive)
                moved = packed_window.pack_inputs(view, aview)
                errs += [_max_err(moved[0], packed), _max_err(moved[1], alive_p)]
            words = torch.empty(1 + packed.numel(), dtype=torch.int32, device=device)
            wview = words[1:].view(packed.shape)
            wview.copy_(packed)
            errs.append(_max_err(packed_window.unpack_codes(wview, S), votes))
            err = max(errs)
            _check(err == 0, f"packer kernels != plain at R={R} S={S}: {errs}")
            worst = max(worst, err)
    return worst


def start_slot_vs_plain(device, Rs=(1, 5, 8, 9), Ss=(17, 1000, 4095), seed: int = 34) -> int:
    """``ClusterKernel.start_slot`` (the round kernels' ``start_slot``
    entry: 16 bytes a thread over each field's plane, the [S] fields 16
    shards a thread) against ``start_slot_plain`` on the card: masks none,
    all and random over states of protocol values; ragged S; out of
    place, in place (``out`` the state itself) and on buffers that start
    one byte (an int32 field: one element) in; then 20 shard blocks in
    one call, more than a launch's table holds (two launches). Returns
    the max_abs_err."""
    from rabia_tpu_torch.kernel.phase_driver import ClusterState

    gen = torch.Generator(device=device).manual_seed(seed)
    cr = cluster_round.CLUSTER_ROUND
    worst = 0

    def shifted(t):  # the same values, one element into a buffer
        raw = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
        out = raw[1:].view(t.shape)
        out.copy_(t)
        return out

    for R in Rs:
        for S in Ss:
            k = ClusterKernel(S, R, device=device)
            st = random_cluster_state(gen, S, R, device)
            masks = {"none": torch.zeros(S, dtype=torch.bool, device=device),
                     "all": torch.ones(S, dtype=torch.bool, device=device),
                     "random": torch.rand((S,), generator=gen, device=device) < 0.5}
            for mname, mask in masks.items():
                init = _codes((S, R), gen, device)
                want = k.start_slot_plain(st, mask, init)
                errs = [_state_err(k.start_slot(st, mask, init), want)]
                fields = [t.clone() for t in st]
                cr.start_slot(fields, mask, init, out=fields)
                errs.append(_state_err(fields, want))
                errs.append(_state_err(cr.start_slot([shifted(t) for t in st], shifted(mask),
                                                     shifted(init)), want))
                err = max(errs)
                _check(err == 0, f"start_slot kernel != plain at R={R} S={S} mask {mname} "
                                 f"(out of place, in place, one byte in): {errs}")
                worst = max(worst, err)
    S, R = 1000, 5
    k = ClusterKernel(S, R, device=device)
    blocks = [(list(random_cluster_state(gen, S, R, device)),
               torch.rand((S,), generator=gen, device=device) < 0.5, _codes((S, R), gen, device))
              for _ in range(20)]
    n0 = cr.counts["start_slot"]
    outs = cr.start_slot_blocks(blocks)
    _check(cr.counts["start_slot"] - n0 == 2,
           f"20 shard blocks took {cr.counts['start_slot'] - n0} start_slot launches, not 2")
    for b, ((f, m, v), o) in enumerate(zip(blocks, outs)):
        err = _state_err(o, k.start_slot_plain(ClusterState(*f), m, v))
        _check(err == 0, f"start_slot kernel != plain on block {b} of 20")
        worst = max(worst, err)
    return worst


def _start_slot_bytes(st, mask, R: int) -> int:
    """The bytes ``start_slot`` must move on this mask: every shard's mask,
    slot and active read (a masked shard bumps its slot by active), a
    masked shard's R votes (the rest of its fields are constants), an
    unmasked shard's other fields (it keeps them), and the whole state
    written."""
    S = mask.numel()
    per_shard = sum(x.numel() * x.element_size() for x in st) // S
    read_all = 1 + st.slot.element_size() + st.active.element_size()
    masked = int(mask.sum())
    kept = per_shard - st.slot.element_size() - st.active.element_size()
    return S * read_all + masked * R + (S - masked) * kept + S * per_shard


def packer_times(device, name: str, votes, alive, k) -> dict:
    """The packers and ``start_slot`` at S=4096 R=5 (T=32768 votes), each
    kernel and its plain version by CUDA graph replay in turns (kernel,
    plain, plain, kernel; ``start_slot`` with an empty kernel at its own
    grid and table in the same turns: kernel, empty, plain, plain, empty,
    kernel), beside an empty kernel of the mesh window's grid and the
    bytes each function must move; the plain versions' kernels a call
    under the profiler."""
    packed = packed_window.pack_codes(votes)
    alive_p = packed_window.pack_alive(alive)
    S, R = k.S, k.R
    st = k.init_state()
    mask = torch.ones(S, dtype=torch.bool, device=device)
    init = torch.full((S, R), V1, dtype=torch.int8, device=device)
    fields = list(st)
    rate = _card_rate_bytes_per_s(name)
    progs = {
        "pack_codes": (lambda i=0: packed_window.pack_codes(votes),
                       lambda i=0: packed_window.pack_codes_plain(votes),
                       votes.numel() + 4 * packed.numel()),
        "unpack_codes": (lambda i=0: packed_window.unpack_codes(packed, S),
                         lambda i=0: packed_window.unpack_codes_plain(packed, S),
                         4 * packed.numel() + votes.numel()),
        "pack_alive": (lambda i=0: packed_window.pack_alive(alive),
                       lambda i=0: packed_window.pack_alive_plain(alive),
                       alive.numel() + 4 * alive_p.numel()),
        "pack_inputs": (lambda i=0: packed_window.pack_inputs(votes, alive),
                        lambda i=0: (packed_window.pack_codes_plain(votes),
                                     packed_window.pack_alive_plain(alive)),
                        votes.numel() + 4 * packed.numel() + alive.numel() + 4 * alive_p.numel()),
        "start_slot": (lambda i=0: k.start_slot(st, mask, init),
                       lambda i=0: k.start_slot_plain(st, mask, init),
                       _start_slot_bytes(st, mask, R)),
    }
    empty_grid = lambda i=0: cluster_round.CLUSTER_ROUND.start_slot_blocks(  # noqa: E731
        [(fields, mask, init)], empty=True)
    out = {"empty_kernel_ms": _graph_ms(lambda i=0: mesh_window.MESH_WINDOW.empty(1, S, device),
                                        200)}
    for pname, (kern, plain, nbytes) in progs.items():
        # start_slot and its empty kernel at the launch floor: as many replays each
        runs = {"kernel": (kern, 200 if pname == "start_slot" else 50), "plain": (plain, 20),
                "empty": (empty_grid, 200)}
        order = (("kernel", "empty", "plain", "plain", "empty", "kernel") if pname == "start_slot"
                 else ("kernel", "plain", "plain", "kernel"))
        turns = [_graph_ms(*runs[what]) for what in order]
        best = {what: min(t for o, t in zip(order, turns) if o == what) for what in order}
        out[pname] = {"ms": best["kernel"], "plain_ms": best["plain"],
                      "turns_ms": list(zip(order, turns)), "bytes": nbytes,
                      "bound_ms": nbytes / rate * 1e3,
                      "plain_kernels": _device_busy(plain, 5)["kernels"],
                      "kernels": _device_busy(kern, 5)["kernels"]}
        if "empty" in best:
            out[pname]["empty_ms"] = best["empty"]  # an empty kernel at its grid and table
    return out


def device_backend_gate(device, S: int, R: int, waves: int) -> dict:
    """The plane-conformance gate with the transport engines on the device
    backend (``KernelConfig.backend="jax"``: ``NodeKernel`` on the card,
    one ``node_cycle`` launch and one fetch a tick), once with
    ``zero_copy_inbox`` off and once on, each beside a ``MeshEngine`` on
    the card: decisions, futures and replica state equal (the gate
    raises otherwise). On a card a tick is one launch on mapped pinned
    memory on both legs: under the profiler (CUDA activity, held around
    the transport plane's waves, where the ticks are the only device
    work) the runtime issues one kernel launch a tick and no copy or
    pinned allocation, and the bytes over the link a tick are its inbox
    and decision planes, its open planes when it opens a slot, and its
    host image. Returns each leg's figures:
    decisions/s, submit-to-settle p50/p99, ticks, launches, bytes and the
    tick's upload (the open planes written), launch and fetch spans by
    CUDA events (host code included)."""
    from rabia_tpu_torch.core.config import KernelConfig
    from rabia_tpu_torch.kernel import node_kernel

    K = KernelConfig().device_substeps
    per_tick = 2 * S * R + S + 14 * S + 10 * K * S  # inboxes, decisions, image
    opens = 6 * S  # mask, slots, initial votes
    legs = {}
    for zc in (False, True):
        before = dict(node_kernel.NODE_CYCLE.counts)
        trace: dict = {}
        t0 = time.perf_counter()
        out = asyncio.run(run_schedule_on_both_planes(
            _set_waves(S, waves), S, R, tag=f"device backend S={S} R={R} zc={zc}",
            device=device, kernel={"backend": "jax", "zero_copy_inbox": zc},
            engine_device=device, time_device_ticks=True,
            around_transport=lambda engines: _tick_trace(engines, trace)))
        gate_s = time.perf_counter() - t0
        _check(out["decided_slots"] == S * waves,
               "the device backend decided a slot per batch")
        launches = {e: node_kernel.NODE_CYCLE.counts[e] - before[e] for e in before}
        dt = out["device_ticks"]
        _check(launches["node_cycle"] == dt["ticks"] > 0,
               f"one node_cycle launch a tick: {launches} over {dt['ticks']} ticks")
        extra = dt["mapped_bytes"] - dt["ticks"] * per_tick
        _check(trace["ticks"] > 0 and trace["launches"] == trace["ticks"]
               and trace["copies"] == 0 and trace["host_allocs"] == 0,
               f"under the profiler a tick is one launch, no copy and no pinned allocation: "
               f"{trace}")
        _check(0 <= extra <= dt["ticks"] * opens and extra % opens == 0,
               f"a tick's mapped bytes are not its planes and image: {dt['mapped_bytes']} "
               f"over {dt['ticks']} ticks")
        p50, p99 = settle_quantiles(out["settle_s"])
        wall = out["transport_wall_s"]
        timed = max(1, dt["timed_ticks"])
        legs["zero_copy" if zc else "copy"] = {
            "decided_slots": out["decided_slots"], "transport_wall_s": wall,
            "decisions_per_s": out["decided_slots"] / wall,
            "settle_p50_s": p50, "settle_p99_s": p99,
            "ticks": dt["ticks"], "launches": launches,
            "h2d_bytes": dt["h2d_bytes"], "d2h_bytes": dt["d2h_bytes"],
            "mapped_bytes": dt["mapped_bytes"], "opening_ticks": extra // opens,
            "trace": trace,
            "mapped_bytes_per_tick": dt["mapped_bytes"] / max(1, dt["ticks"]),
            "upload_span_ms_per_tick": dt["upload_span_ms"] / timed,
            "launch_span_ms_per_tick": dt["launch_span_ms"] / timed,
            "fetch_span_ms_per_tick": dt["fetch_span_ms"] / timed,
            "gate_s": gate_s,
        }
        del out
    return legs


def _pinned_copy_ms(device, nbytes: int, up: bool, reps: int = 100) -> float:
    """A pinned copy of ``nbytes`` over the link (to the card when ``up``),
    by CUDA events over a chain of copies: the link's time for that many
    bytes, each copy's start included."""
    host = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
    card = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)
    src, dst = (host, card) if up else (card, host)
    return _time_ms(lambda i=0: dst.copy_(src, non_blocking=True), reps)


def _host_ms(fn, reps: int) -> float:
    """Host clock around a chain of ``reps`` calls that each end readable
    on the host, then a synchronise: one call's round trip."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


@contextlib.contextmanager
def _trace(kernel: str, families: Optional[dict] = None):
    """The profiler (device activity and the CUDA runtime calls) around a
    block. The dict it yields is filled on exit with the kernel launches
    the block issued (``cudaLaunchKernel`` calls), the device records of
    the kernel whose name holds ``kernel`` (a short session may lose some),
    the copies (device Memcpy records and ``cudaMemcpy*`` calls) and the
    pinned allocations (``cudaHostAlloc`` and ``cudaMallocHost`` calls);
    with ``families`` (name -> fragments of kernel names), also each
    family's device records under ``"families"``.
    Raises when the trace holds no record: a block that launches anything
    on a card leaves some, so an empty trace is a profiler that saw
    nothing, and its zero copies would prove nothing."""
    from torch.profiler import ProfilerActivity, profile

    counts: dict = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield counts
        torch.cuda.synchronize()
    launches = kernels = copies = allocs = records = 0
    fams = dict.fromkeys(families or (), 0)
    for e in prof.key_averages():
        records += e.count
        for fam, frags in (families or {}).items():
            if any(f in e.key for f in frags):
                fams[fam] += e.count
        if e.key.startswith("cudaLaunchKernel"):
            launches += e.count
        elif kernel in e.key:
            kernels += e.count
        if e.key.startswith(("Memcpy", "cudaMemcpy")):
            copies += e.count
        if e.key.startswith(("cudaHostAlloc", "cudaMallocHost")):
            allocs += e.count
    _check(records > 0, "the profiler recorded nothing on the card")
    counts.update(launches=launches, kernels=kernels, copies=copies, host_allocs=allocs)
    if families:
        counts["families"] = fams


def _traced(fn, reps: int, kernel: str) -> dict:
    """``reps`` calls of ``fn`` (after one to warm) under the profiler:
    what :func:`_trace` counts of them."""
    fn()
    with _trace(kernel) as counts:
        for i in range(reps):
            fn(i)
    return {"calls": reps, **counts}


@contextlib.contextmanager
def _tick_trace(engines, out: dict):
    """The device-backend engines' ticks under :func:`_trace`: ``out``
    gets what it counts and the ticks the engines took meanwhile."""
    ticks = sum(e.device_tick_stats["ticks"] for e in engines)
    with _trace("node_cycle") as counts:
        yield
    out.update(counts, ticks=sum(e.device_tick_stats["ticks"] for e in engines) - ticks)


def _check_window_launches(engines, mw0: int, what: str) -> int:
    """On a card, the one-device engines' windows were one ``mw_window``
    launch each on their staging rings (launches since ``mw0`` equal the
    windows the rings dispatched); returns those windows."""
    windows = sum(e._ring.windows for e in engines)
    if any(e.device.type == "cuda" for e in engines):
        _check(mesh_window.MESH_WINDOW.launches - mw0 == windows,
               f"{what}: {mesh_window.MESH_WINDOW.launches - mw0} mw_window launches for "
               f"{windows} windows on the engines' staging rings")
    return windows


def _link_bound(device, name: str, read: int, written: int, hbm: int) -> dict:
    """The least time for a call that reads ``read`` bytes and writes
    ``written`` bytes over the link and moves ``hbm`` bytes in device
    memory: the larger of the link's time and the device memory's. The
    link's rate each way is measured by pinned copies, of the call's size
    and of 64 MiB (a copy of a few hundred KB pays the copy engine's start
    too, so the faster rate of the two is the link's); the link is full
    duplex, so its time is the longer of the two directions."""
    big = 64 << 20
    up, down = _pinned_copy_ms(device, read, True), _pinned_copy_ms(device, written, False)
    big_up, big_down = _pinned_copy_ms(device, big, True, 10), _pinned_copy_ms(device, big, False, 10)
    rate_up = max(read / up, big / big_up) / 1e6  # GB/s
    rate_down = max(written / down, big / big_down) / 1e6
    link_ms = max(read / rate_up / 1e6, written / rate_down / 1e6)
    hbm_ms = hbm / _card_rate_bytes_per_s(name) * 1e3
    return {"link_read_bytes": read, "link_written_bytes": written, "hbm_bytes": hbm,
            "pinned_up_ms": up, "pinned_down_ms": down, "link_GBps_up": rate_up,
            "link_GBps_down": rate_down, "link_bound_ms": link_ms, "hbm_bound_ms": hbm_ms,
            "bound_ms": max(link_ms, hbm_ms)}


def node_tick_times(device, name: str, S: int, R: int, K: int, seed: int = 33,
                    reps: int = 200) -> dict:
    """One engine tick's ``node_cycle`` at S x R with K steps, as the
    engine's tick runs it (its planes in the kernel's pinned plane buffer,
    the state in place, the results into the pinned host image): the
    kernel alone by CUDA graph replay beside an empty kernel at its grid,
    ``node_cycle_plain`` by CUDA events over a chain of calls (in turns
    kernel, empty, plain, plain, empty, kernel); the round trip (planes in
    host memory -> state and outbox readable on the host: the launch, its
    event, the image's views) by the host clock around a chain of ticks;
    the ticks under the profiler (node_cycle launches and copies); the
    bytes over the link and in device memory and both bounds."""
    from rabia_tpu_torch.kernel.phase_driver import NodeKernel, NodeState

    gen = torch.Generator(device="cpu").manual_seed(seed)
    nk = NodeKernel(S, R, 0, seed=seed, device=device)
    st, ins = random_node_case(gen, S, R, "cpu")
    for view, x in zip(nk.planes, ins):
        view[...] = x.numpy()
    # into a tick buffer of K steps: later ticks run in place
    st, ob = nk.node_cycle(NodeState(*(t.to(device) for t in st)), *nk.planes, K)
    buf, layout = nk._tick
    image, image_layout, _ = nk._image
    plain_st = NodeState(*(t.clone() for t in st))
    dev_ins = [x.to(device) for x in ins]
    kw = dict(me=nk.me, quorum=nk.quorum, f1=nk.f1, seed=nk.seed,
              threshold=coin_threshold(nk.coin_p1))
    kern = lambda i=0: node_kernel.NODE_CYCLE(  # noqa: E731
        "node_cycle", list(st), list(st), list(ob), nk._plane_buf, nk._plane_layout, [True] * 6,
        image, image_layout, K, **kw)
    empty = lambda i=0: node_kernel.NODE_CYCLE.empty(S, R, K, device)  # noqa: E731
    plain = lambda i=0: nk.node_cycle_plain(plain_st, *dev_ins, K)  # noqa: E731
    turns = [_graph_ms(kern, reps), _graph_ms(empty, reps), _time_ms(plain, 20),
             _time_ms(plain, 20), _graph_ms(empty, reps), _graph_ms(kern, reps)]
    cur = [st, ob]

    def tick(i=0):
        cur[0], cur[1] = nk.node_cycle(cur[0], *nk.planes, K, donate=True)
        return nk.fetch_start(cur[0], cur[1]).result()

    mapped0, fetched0 = nk.mapped_bytes, nk.fetch_bytes
    rt = [_host_ms(tick, reps), _host_ms(tick, reps)]
    ticks = 2 * (reps + 1)
    per_tick = (nk.mapped_bytes - mapped0) / ticks
    trace = _traced(tick, 20, "node_cycle")
    read = sum(nk._plane_layout.size(i) for i in range(6))
    written = S * (4 + 4 + 6) + K * S * 10
    _check(per_tick == read + written,
           f"a tick's mapped bytes {per_tick} != planes {read} + image {written}")
    _check(nk.fetch_bytes == fetched0, "the ticks' fetches copied bytes")
    _check(trace["launches"] == trace["calls"] and trace["copies"] == 0
           and trace["host_allocs"] == 0, f"a tick is one node_cycle launch and no copy: {trace}")
    state = sum(t.numel() * t.element_size() for t in st)
    hbm = 2 * state + K * S * 10  # the state read and written, the outbox written
    return {"ms": min(turns[0], turns[5]), "empty_ms": min(turns[1], turns[4]),
            "plain_ms": min(turns[2], turns[3]), "turns_ms": turns,
            "round_trip_ms": min(rt), "round_trip_turns_ms": rt,
            "mapped_bytes_per_tick": per_tick, "trace": trace,
            **_link_bound(device, name, read, written, hbm),
            "old_bytes": 2 * state + sum(x.numel() * x.element_size() for x in ins) + K * S * 10,
            "plain_kernels": _device_busy(plain, 5)["kernels"]}


def window_times(device, name: str, S: int, R: int, T: int, seed: int = 34,
                 reps: int = 200) -> dict:
    """The engine's window as it runs it: ``mw_window`` on a pinned
    staging buffer (votes over all four codes, a crash mask, bases near
    2^31-1), the kernel alone by CUDA graph replay beside an empty kernel
    at its grid, in turns; the round trip (votes staged -> decided
    readable: the launch, its event, the view) by the host clock around a
    chain of windows; the windows under the profiler (mw_window launches
    and copies); the bytes over the link and both bounds. The decisions
    are held against the plain loop."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    votes, alive, base = mesh_case(gen, S, R, T, "cpu")
    mk = MeshPhaseKernel(S, R, seed=seed, device=device)
    stage = mesh_window.WindowStage(S, R, T, pinned=True)
    stage.votes[...], stage.alive[...], stage.base[...] = votes.numpy(), alive.numpy(), base.numpy()
    mk.decide_staged(stage, T, 4)
    stage.wait()
    want = mk.decide_slots_plain(votes.to(device), alive.to(device), base.to(device), 4)
    err = _max_err(torch.from_numpy(stage.decided[:T].copy()).to(device), want)
    _check(err == 0, "the mapped mw_window != plain")
    kern = lambda i=0: mk.decide_staged(stage, T, 4)  # noqa: E731
    empty = lambda i=0: mesh_window.MESH_WINDOW.empty(T, S, device)  # noqa: E731

    def window(i=0):
        mk.decide_staged(stage, T, 4)
        stage.wait()
        return stage.decided[:T]

    turns = [_graph_ms(kern, reps), _graph_ms(empty, reps), _graph_ms(empty, reps),
             _graph_ms(kern, reps)]
    rt = [_host_ms(window, reps), _host_ms(window, reps)]
    trace = _traced(window, 20, "mesh_window")
    _check(trace["launches"] == trace["calls"] and trace["copies"] == 0
           and trace["host_allocs"] == 0, f"a window is one mw_window launch and no copy: {trace}")
    read = T * S * R + S * R + 4 * S
    written = T * S
    return {"ms": min(turns[0], turns[3]), "empty_ms": min(turns[1], turns[2]),
            "turns_ms": turns, "round_trip_ms": min(rt), "round_trip_turns_ms": rt,
            "trace": trace, "max_abs_err": err,
            **_link_bound(device, name, read, written, read + written)}


# -- phase 17 ----------------------------------------------------------------

P17_SHAPES = ((4, 1), (1, 5), (4, 5))  # logical meshes of the card: (shard, replica) axes
P17_T = 16  # the window's depth (the engine's window)
P17_SEED = 17


def mesh_windows_vs_one_device(device, S: int, R: int) -> dict:
    """(b), before the counts: on logical meshes of the card (the card
    is every device of the mesh, each block a tensor of its own),
    ``slot_window`` at T = 16 on votes over all four codes, crash masks
    with a quorum-less shard, bases near 2^31 - 1 and 4 phases (the coin
    is reached) is bit for bit the one-device ``mw_window`` and the plain
    loop, in one launch a shard block; ``phase_step`` over 4 x 5 (its
    two exchanges over the replica axis) equals one device's for 4
    phases."""
    gen = torch.Generator(device=device).manual_seed(71)
    votes, alive, base = mesh_case(gen, S, R, P17_T, device)
    one = MeshPhaseKernel(S, R, seed=P17_SEED, device=device)
    want = mesh_window.MESH_WINDOW(votes, alive, base, seed=P17_SEED, coin_p1=0.5, max_phases=4)
    plain = one.decide_slots_plain(votes, alive, base, 4)
    _check(torch.equal(want, plain), "phase 17 (b): the one-device mw_window != plain")
    phases, coins = mesh_work(one, votes, alive, base, 4)
    _check(coins > 0, "phase 17 (b): the window never reached the coin")
    worst = _max_err(want, plain)
    for a, b in P17_SHAPES:
        mk = MeshPhaseKernel(S, R, make_mesh([device] * (a * b), a, b), seed=P17_SEED)
        n0 = mesh_window.MESH_WINDOW.launches
        got = mk.slot_window(votes, alive, base, n_slots=P17_T, max_phases=4)
        torch.cuda.synchronize(device)
        _check(mesh_window.MESH_WINDOW.launches - n0 == a,
               f"phase 17 (b): a {a}x{b} window is not one launch a shard block")
        worst = max(worst, _max_err(got, want), _max_err(got, plain))
        _check(torch.equal(got, want), f"phase 17 (b): the {a}x{b} window != mw_window")
    mk = MeshPhaseKernel(S, R, make_mesh([device] * 20, 4, 5), seed=P17_SEED)
    slots = base[:, None].expand(S, R).contiguous()
    st = mk.init_state(votes[0])._replace(slot=mk.place(slots))
    st1 = one.init_state(votes[0])._replace(slot=slots)
    for _ in range(4):
        st = mk.phase_step(st, mk.place(alive), mk.shard_index_array())
        st1 = one.phase_step(st1, alive, one.shard_index_array())
    for f, g, w in zip(st._fields, st, st1):
        worst = max(worst, _max_err(g.full(), w))
        _check(torch.equal(g.full(), w), f"phase 17 (b): phase_step 4x5 {f} != one device")
    return {"max_abs_err": worst, "phases": phases, "coins": coins}


def _p17_engine(device, mesh=None):
    kw = {"device": device} if mesh is None else {"mesh": mesh}
    eng = MeshEngine(InMemoryStateMachine, S_FULL, R_FULL, window=P17_T, **kw)
    return eng, dcn.engine_workload(eng)


def mesh_engines(device) -> dict:
    """(a) ``MeshEngine(mesh=make_mesh())`` beside ``MeshEngine()`` on a
    part of phase 5's workload (SET and GET on every shard, a minority
    crash, heal): decisions, futures and replica snapshots equal; (b) the
    4 x 5 logical mesh's engine on the same workload, equal to (a)."""
    t0 = time.perf_counter()
    _, want = _p17_engine(device)
    t_one = time.perf_counter() - t0
    mesh = make_mesh()
    _check(mesh.shape == {"shard": torch.cuda.device_count(), "replica": 1},
           f"phase 17 (a): make_mesh() is {mesh.shape}")
    t0 = time.perf_counter()
    eng11, got = _p17_engine(device, mesh)
    t_mesh = time.perf_counter() - t0
    _check(got == want, "phase 17 (a): MeshEngine(mesh=make_mesh()) != MeshEngine()")
    t0 = time.perf_counter()
    eng45, got45 = _p17_engine(device, make_mesh([device] * 20, 4, 5))
    t_45 = time.perf_counter() - t0
    _check(got45 == want, "phase 17 (b): the 4x5 mesh engine != MeshEngine()")
    return {"digest": dcn.digest(want), "seconds": {"one device": t_one, "1x1": t_mesh,
                                                   "4x5": t_45},
            "windows": {"1x1": eng11.cycles, "4x5": eng45.cycles},
            "decided_v1": eng11.decided_v1, "S": {"1x1": eng11.S, "4x5": eng45.S}}


def sharded_cluster(device, S: int, R: int, T: int = 64) -> dict:
    """(c) ``ShardedClusterKernel(S, R, 4 x 1)``: ``slot_pipeline`` at
    T = 64, 4 rounds a slot, votes over all four codes with split rows and
    a crash mask (the coin decides some slots), and the fault path's
    ``run_rounds`` (80 rounds at p = 0.6 from the selftest's start), each
    block on its device's round kernels with its global shard base: bit
    for bit ``ClusterKernel``'s. The same at 1024 x 9 (the kernels' paths
    above 8 replicas), with lossy rounds on split votes."""
    mesh = make_mesh([device] * 4, 4, 1)
    gen = torch.Generator(device=device).manual_seed(72)
    start = 2**31 - 5
    err = coins = 0
    # the main shape, and R = 9 for the kernels' paths above 8 replicas
    for Sx, Rx, Tx in ((S, R, T), (1024, 9, 16)):
        sk = ShardedClusterKernel(Sx, Rx, mesh, seed=P17_SEED)
        ck = ClusterKernel(Sx, Rx, seed=P17_SEED, device=device)
        votes, alive, _ = mesh_case(gen, Sx, Rx, Tx, device)
        got = sk.slot_pipeline(sk.place_votes(votes), alive, Tx, rounds_per_slot=4,
                               start_slot_index=start)
        want = ck.slot_pipeline(votes, alive, Tx, rounds_per_slot=4, start_slot_index=start)
        err = max(err, *(_max_err(g.full(), w) for g, w in zip(got, want)))
        _check(err == 0, f"phase 17 (c): sharded slot_pipeline != ClusterKernel's at R={Rx}")
        coins += int((want[1] == 1).sum())
        if Rx == 9:  # lossy rounds on split votes: replicas reach the coin
            st0 = ck.start_slot(ck.init_state(), torch.ones(Sx, dtype=torch.bool, device=device),
                                votes[0])
            sst0 = sk.start_slot(sk.init_state(), torch.ones(Sx, dtype=torch.bool, device=device),
                                 votes[0])
            a = ck.run_rounds(st0, alive, 40, torch.Generator(device=device).manual_seed(2), 0.7)
            b = sk.run_rounds(sst0, alive, 40, torch.Generator(device=device).manual_seed(2), 0.7)
            err = max(err, *(_max_err(g.full(), w) for g, w in zip(b, a)))
            _check(err == 0, "phase 17 (c): sharded run_rounds != ClusterKernel's at R=9")
    sk = ShardedClusterKernel(S, R, mesh, seed=P17_SEED)
    ck = ClusterKernel(S, R, seed=P17_SEED, device=device)
    _check(coins > 0, "phase 17 (c): the pipeline never reached the coin")
    # start_slot on a state of protocol values: one launch for the four
    # shard blocks, row for row one device's plain version
    rst = random_cluster_state(gen, S, R, device)
    rmask = torch.rand((S,), generator=gen, device=device) < 0.5
    rvotes = _codes((S, R), gen, device)
    n0 = cluster_round.CLUSTER_ROUND.counts["start_slot"]
    got = sk.start_slot(rst, rmask, rvotes)
    one_launch = cluster_round.CLUSTER_ROUND.counts["start_slot"] - n0
    on_card = int(device.type == "cuda")  # the CPU runs each block's plain version
    _check(one_launch == on_card, f"phase 17 (c): a sharded start_slot over {len(sk.blocks)} "
                                  f"shard blocks took {one_launch} launches")
    err = max(err, *(_max_err(g.full(), w) for g, w in zip(
        got, ck.start_slot_plain(rst, rmask, rvotes))))
    _check(err == 0, "phase 17 (c): sharded start_slot != ClusterKernel.start_slot_plain")
    every = torch.ones(S, dtype=torch.bool, device=device)
    v1 = torch.full((S, R), V1, dtype=torch.int8, device=device)
    falive = torch.tensor([False, True, True, False, True], device=device).expand(S, R)
    st = sk.run_rounds(sk.start_slot(sk.init_state(), every, v1), falive, 80,
                       torch.Generator(device=device).manual_seed(1), p_deliver=0.6)
    st1 = ck.run_rounds(ck.start_slot(ck.init_state(), every, v1), falive, 80,
                        torch.Generator(device=device).manual_seed(1), p_deliver=0.6)
    ferr = max(_max_err(g.full(), w) for g, w in zip(st, st1))
    _check(ferr == 0, "phase 17 (c): sharded run_rounds != ClusterKernel's")
    _check(bool((st1.decided != ABSENT).all()), "phase 17 (c): the fault path left a shard")
    return {"max_abs_err": max(err, ferr), "coin_slots": coins,
            "blocks": len(sk.blocks), "start_slot_launches_a_call": one_launch}


def mesh_ranks(want_digest: str) -> dict:
    """(d) the multi-controller engine: one rank on an NCCL group, and
    two ranks sharing the card on a gloo group (NCCL takes one card a
    rank), each rank a process running (a)'s submissions through
    ``_run_window_multihost``; every rank's decisions, futures and
    stores equal (a)'s. Returns each leg's ranks' results (their window
    and exchange times by CUDA events, mw_window launches a window)."""
    legs = {}
    for world, backend in ((1, "nccl"), (2, "gloo")):
        t0 = time.perf_counter()
        ranks = dcn.spawn_ranks(world, backend=backend, device="cuda", workload="engine",
                                timeout=300, args=(S_FULL, R_FULL, P17_T))
        for r in ranks:
            _check(r["digest"] == want_digest,
                   f"phase 17 (d): rank {r['rank']} of {world} ({backend}) != (a)")
        legs[f"{world}x{backend}"] = {"ranks": ranks, "seconds": time.perf_counter() - t0}
    return legs


def mesh_times(device, S: int, R: int) -> dict:
    """The window's time on each logical mesh shape of the card by CUDA
    events (cut inputs in, the decided ``[T, S]`` out: the exchange and
    the launches), the exchange's time alone, and mw_window launches a
    window; the one-device window beside them."""
    gen = torch.Generator(device=device).manual_seed(73)
    votes, alive, base = mesh_case(gen, S, R, P17_T, device)
    one = MeshPhaseKernel(S, R, seed=P17_SEED, device=device)
    out = {"1 device": {"window_ms": _time_ms(lambda i=0: one.slot_window(
        votes, alive, base, n_slots=P17_T, max_phases=4), 20)}}
    for a, b in ((1, 1), *P17_SHAPES):
        mesh = make_mesh([device] * (a * b), a, b)
        mk = MeshPhaseKernel(S, R, mesh, seed=P17_SEED)
        V, A = MeshArray.cut(mesh, votes, 1, 2), MeshArray.cut(mesh, alive, 0, 1)
        n0 = mesh_window.MESH_WINDOW.launches
        win = _time_ms(lambda i=0: mk.slot_window(V, A, base, n_slots=P17_T, max_phases=4), 20)
        out[f"{a}x{b}"] = {"window_ms": win,
                           "exchange_ms": _time_ms(lambda i=0: mk.exchange_window(V, A), 20),
                           "launches_per_window": (mesh_window.MESH_WINDOW.launches - n0) / 21}
    # the plain version over 4 x 5: every shard block's rows by
    # decide_blocks_plain on what the exchange gathered
    rows = mk.exchange_window(V, A)
    out["4x5"]["plain_ms"] = _time_ms(lambda i=0: [mk.decide_blocks_plain(
        v, al, base[r * mk.S_blk:(r + 1) * mk.S_blk], 4, r * mk.S_blk)
        for r, (v, al) in rows.items()], 3)
    return out


def sharded_times(device, S: int, R: int) -> dict:
    """``ShardedClusterKernel(S, R, 4 x 1)``'s programs by CUDA events
    (a chain of calls; each call four launches, a block of S/4 shards
    each with its shard0, but ``start_slot`` one launch for the four) in
    turns with ``ClusterKernel``'s one launch on the same inputs (one,
    sharded, sharded, one): ``slot_pipeline`` at T=8192 with 2 rounds a
    slot, ``start_slot`` on every shard, and the fault path's
    ``run_rounds`` (80 rounds at p=0.6, its mask draws included). The
    sharded ``start_slot`` also under the profiler: one kernel launch
    (``cudaLaunchKernel``) a call."""
    mesh = make_mesh([device] * 4, 4, 1)
    sk = ShardedClusterKernel(S, R, mesh, seed=P17_SEED)
    ck = ClusterKernel(S, R, seed=P17_SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(74)
    votes = _random_votes((T_SCAN, S, R), gen, device)
    alive = _alive((S, R), gen, device)
    V, A = sk.place_votes(votes), MeshArray.cut(mesh, alive, 0)
    every = torch.ones(S, dtype=torch.bool, device=device)
    v1 = torch.full((S, R), V1, dtype=torch.int8, device=device)
    falive = torch.tensor([False, True, True, False, True], device=device).expand(S, R)
    st, sst = ck.start_slot(ck.init_state(), every, v1), sk.start_slot(sk.init_state(), every, v1)
    fgen = lambda: torch.Generator(device=device).manual_seed(1)  # noqa: E731
    calls = {
        "slot_pipeline": (lambda i=0: ck.slot_pipeline(votes, alive, T_SCAN),
                          lambda i=0: sk.slot_pipeline(V, A, T_SCAN)),
        "start_slot": (lambda i=0: ck.start_slot(st, every, v1),
                       lambda i=0: sk.start_slot(sst, every, v1)),
        "run_rounds": (lambda i=0: ck.run_rounds(st, falive, 80, fgen(), p_deliver=0.6),
                       lambda i=0: sk.run_rounds(sst, falive, 80, fgen(), p_deliver=0.6)),
    }
    out = {}
    for name, (one, sharded) in calls.items():
        reps = 4 if name == "run_rounds" else 10
        turns = [_time_ms(one, reps), _time_ms(sharded, reps), _time_ms(sharded, reps),
                 _time_ms(one, reps)]
        out[name] = {"one_ms": min(turns[0], turns[3]), "sharded_ms": min(turns[1], turns[2]),
                     "turns_ms": turns}
    trace = _traced(calls["start_slot"][1], 10, "start_slot_kernel")
    _check(trace["launches"] == trace["calls"],
           f"phase 17: {trace['calls']} sharded start_slot calls over {len(sk.blocks)} shard "
           f"blocks took {trace['launches']} kernel launches under the profiler, not one a call")
    out["start_slot"]["trace"] = trace
    return out


# -- phase 18 ----------------------------------------------------------------

P18_W = 16  # the device lane's window
P18_SEED = 18
P18_REPS = 20  # calls in a timed chain


def _p18_windows(dkv, S: int, R: int, P: int, seed: int = P18_SEED) -> dict:
    """Phase 18 (a)'s inputs at S x R, packed by ``dkv``'s packers (host
    code, the same for every layout): four SET windows that fill P keys a
    shard (two in the row form, two in the dictionary form), a GET window
    of keys some never set, a mixed window of SET, GET, DEL and EXISTS, an
    alive mask with replica R-1 down (a quorum is left) and bases near
    2^31-1 on every seventh shard."""
    rng = np.random.default_rng(seed)
    shards = range(S)
    W = P18_W

    def wave(ops):
        return build_block(shards, [[op] for op in ops])

    sets = []
    for k in range(P // W):
        blocks = [wave([_set_op(_key(s, k * W + j), _value(rng, k * W + j, s)) for s in shards])
                  for j in range(W)]
        sets.append(dkv.pack_window(blocks) if k < 2 else dkv.pack_window_dict(blocks))
    gets = [wave([_key_op(2, _key(s, int(rng.integers(0, P + 8)))) for s in shards])
            for _ in range(W)]

    def mixed_op(s):
        j = int(rng.integers(0, P + 8))
        k = int(rng.integers(0, 4))
        return (_set_op(_key(s, j % P), _value(rng, 500, s)) if k == 0
                else _key_op((2, 3, 4)[k - 1], _key(s, j)))

    kind, mixed = dkv.pack_mixed_window_auto([wave([mixed_op(s) for s in shards])
                                              for _ in range(W)])[:2]
    alive = np.ones((S, R), bool)
    alive[:, R - 1] = False
    base = rng.integers(0, 2**31 - 1 - W, S).astype(np.int64)
    base[::7] = 2**31 - 1 - rng.integers(0, W, len(base[::7]))
    _check(all(isinstance(x, DeviceDictOps) for x in sets[2:]) and isinstance(mixed, DeviceDictOps),
           "phase 18: a window was not packed as a dictionary")
    return {"sets": sets, "get": dkv.pack_get_window_auto(gets), "kind": kind, "mixed": mixed,
            "get_waves": np.nonzero((kind >= 2).any(axis=1))[0].astype(np.int32),
            "alive": alive, "base": base.astype(np.int32)}


def _p18_program(dkv, win: dict, blocks: int, what: str) -> tuple[list, dict]:
    """Phase 18 (a)'s windows through ``dkv`` in order (each SET and the
    mixed window adopted): each call must upload once a shard block, and
    on a card raise the kv kernels' count of its form by ``blocks`` (one
    launch a shard block) and nothing else, and launch no mesh window
    (on the CPU the plain versions launch nothing). Returns the outputs
    on the host and the final ``dump()``."""
    W, alive, base = P18_W, win["alive"], win["base"]
    on_card = dkv.device.type == "cuda"

    def form(ops, decide: bool, read: str = "") -> str:
        f = "dict" if isinstance(ops, DeviceDictOps) else "rows"
        return f"{read} {f}" if read else f + ("+decide" if decide else "")

    out = []

    def call(key: str, fn):
        counts, mw0, up0 = dict(kv_window.KV_WINDOW.counts), mesh_window.MESH_WINDOW.launches, \
            dkv.uploads
        got = fn()
        if on_card:
            torch.cuda.synchronize()
            counts[key] += blocks
        _check(kv_window.KV_WINDOW.counts == counts and mesh_window.MESH_WINDOW.launches == mw0,
               f"phase 18 (a) {what}: a {key} window was not one kv launch a shard block "
               f"({blocks}) and no mesh launch")
        _check(dkv.uploads - up0 == blocks,
               f"phase 18 (a) {what}: a {key} window made {dkv.uploads - up0} uploads")
        return got

    for ops in win["sets"]:
        new, flags = call(form(ops, True), lambda ops=ops: dkv.decide_apply(
            alive, base, W, ops, W=W))
        dkv.adopt(new)
        out.append(flags)
    out += call(form(win["get"], True, "lookup"), lambda: dkv.lookup_window(
        alive, base, W, win["get"], W=W))
    new, *rest = call(form(win["mixed"], True), lambda: dkv.mixed_apply(
        alive, base, W, win["kind"], win["get_waves"], win["mixed"], W=W))
    dkv.adopt(new)
    out += rest
    out += call(form(win["get"], False, "probe"), lambda: dkv.lookup_only(win["get"], W=W))
    return [x.cpu().numpy() for x in out], dkv.dump()


def mesh_tables_vs_one_device(device, S: int, R: int, P: int = P_FULL) -> dict:
    """Phase 18 (a): the device table in shard blocks on each logical mesh
    of the card in ``P17_SHAPES`` against the one-device table on the
    same inputs (:func:`_p18_windows`): flags, reads, gathered rows and
    ``dump()`` equal after the SET windows in both forms, a GET window, a
    mixed window and a probe, each one kv launch a shard block. Returns
    each shape's shard blocks and seconds, and the tables for (c)."""
    one = DeviceKVTable(S, MeshPhaseKernel(S, R, device=device), per_shard_capacity=P)
    win = _p18_windows(one, S, R, P)
    want, want_dump = _p18_program(one, win, 1, "one device")
    _check(all(f.tolist() == [1, 0, 0] for f in want[:4]), "phase 18 (a): a SET window was dirty")
    out = {"tables": {"1 device": one}, "win": win}
    for a, b in P17_SHAPES:
        t0 = time.perf_counter()
        mesh = make_mesh([device] * (a * b), a, b)
        dkv = DeviceKVTable(S, MeshPhaseKernel(S, R, mesh), per_shard_capacity=P)
        got, dump = _p18_program(dkv, win, a, f"{a}x{b}")
        for i, (x, y) in enumerate(zip(got, want)):
            _check(x.shape == y.shape and np.array_equal(x, y),
                   f"phase 18 (a): output {i} of the {a}x{b} table != one device's")
        for k, v in want_dump.items():
            _check(np.array_equal(dump[k], v), f"phase 18 (a): the {a}x{b} table's dump {k} "
                                               f"!= one device's")
        out[f"{a}x{b}"] = {"shard_blocks": a, "s": time.perf_counter() - t0}
        out["tables"][f"{a}x{b}"] = dkv
    return out


def mesh_lane_times(tables: dict, win: dict) -> dict:
    """Phase 18 (c): the dictionary SET window (``decide_apply``, not
    adopted) and the probe (``lookup_only``) on the one-device table and
    the 4 x 1 mesh's, by CUDA events around a chain of calls, host issue
    included (the copies in, the launches a block, the joins and the flag
    reduction), in turns (one device, mesh, mesh, one device)."""
    W, alive, base = P18_W, win["alive"], win["base"]
    ops = win["sets"][-1]
    calls = {
        "dict_set": lambda t: (lambda i=0: t.decide_apply(alive, base, W, ops, W=W)),
        "probe": lambda t: (lambda i=0: t.lookup_only(win["get"], W=W)),
    }
    out = {}
    for name, make in calls.items():
        one, mesh = make(tables["1 device"]), make(tables["4x1"])
        turns = [_time_ms(one, P18_REPS), _time_ms(mesh, P18_REPS), _time_ms(mesh, P18_REPS),
                 _time_ms(one, P18_REPS)]
        out[name] = {"one_ms": min(turns[0], turns[3]), "mesh_4x1_ms": min(turns[1], turns[2]),
                     "turns_ms": turns}
    return out


# -- phase 19 ----------------------------------------------------------------


def _torch_module(folder: str, name: str):
    """``<folder>/torch_<name>.py`` of this repo as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), folder, f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_main(name: str):
    """``examples/torch_<name>.py``'s ``main`` (the examples import their
    ``_torch_common`` from their own directory)."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")
    if here not in sys.path:
        sys.path.insert(0, here)
    return _torch_module("examples", name).main


def _run_example(main, device, **sizes) -> tuple[list, float]:
    """One example's result lines (its printing kept off this script's
    output) and its seconds."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        lines = list(main(device=device, **sizes))
    return lines, time.perf_counter() - t0


def device_examples(device) -> dict:
    """Phase 19: the device examples on the card at the reference's sizes,
    each held line for line against its CPU run (timed lines excepted),
    then device_kv_lane and mesh_engine_demo at S_FULL x R_FULL with their
    own checks; the card runs under the profiler (the witness)."""
    mains = {name: _example_main(name) for name in P19_TIMED}
    untimed = lambda name, lines: [  # noqa: E731
        ln for ln in lines if not any(f in ln for f in P19_TIMED[name])]
    out: dict = {"runs": {}}
    card: dict = {}
    with _trace("", P19_KERNELS) as witness:
        for name, main in mains.items():
            card[name], secs = _run_example(main, device)
            out["runs"][name] = {"card_s": secs}
        for name in ("device_kv_lane", "mesh_engine_demo"):
            lines, secs = _run_example(mains[name], device, S=S_FULL, R=R_FULL)
            out["runs"][f"{name} {S_FULL}x{R_FULL}"] = {"card_s": secs, "lines": lines}
    for name, main in mains.items():
        cpu, secs = _run_example(main, "cpu")
        out["runs"][name]["cpu_s"] = secs
        a, b = untimed(name, card[name]), untimed(name, cpu)
        _check(a == b and len(a) >= 2,
               f"phase 19: {name} on the card != on the CPU:\n{card[name]}\n{cpu}")
        out["runs"][name]["lines_equal"] = len(a)
        out["runs"][name]["timed_lines"] = len(card[name]) - len(a)
    kv = out["runs"][f"device_kv_lane {S_FULL}x{R_FULL}"]["lines"]
    _check("healed; device lane re-promoted: True" in kv and kv[-1] == "OK",
           f"phase 19: device_kv_lane at {S_FULL}x{R_FULL}: {kv}")
    _check(any(ln.startswith("3/5 crashed: RabiaError") for ln in kv),
           f"phase 19: device_kv_lane at {S_FULL}x{R_FULL} never lost its quorum: {kv}")
    mesh = out["runs"][f"mesh_engine_demo {S_FULL}x{R_FULL}"]["lines"]
    _check(mesh[-1] == "OK" and any(ln.startswith("user3 on every replica") for ln in mesh),
           f"phase 19: mesh_engine_demo at {S_FULL}x{R_FULL}: {mesh}")
    _check(all(witness["families"].values()),
           f"phase 19: the profiler saw no device record of a kernel family: {witness}")
    out["witness"] = witness
    return out


# -- phase 20 ----------------------------------------------------------------


def _p20_counts() -> dict:
    """Launches by kernel so far: ``_kernel_counts``' with the fused
    windows' and the round kernel's entries (``cr_<entry>``)."""
    out = _kernel_counts()
    out.update(fused_window=fused_window.FUSED_WINDOW.launches,
               fused_window_tsr=fused_window.FUSED_WINDOW_TSR.launches,
               **{f"cr_{k}": v for k, v in cluster_round.CLUSTER_ROUND.counts.items()})
    return out


def conformance_fuzz(device, budget_s: float = P20_FUZZ_S, seed0: int = P20_SEED,
                     mesh_rounds: int = P20_MESH_ROUNDS) -> dict:
    """Phase 20 (a): ``scripts/torch_fuzz_conformance.py``'s trials on
    ``device``. Warm-up (each geometry once), then the stepwise and fused
    trials for ``budget_s`` over the reference's geometry pool and config
    3's width (the stepwise trial at S_FULL holds every shard against
    ``round_step_plain`` and the oracle's sample, ``oracle_sample``), the
    mesh trials over the reference's mesh pool and S_FULL x R_FULL on
    logical 4x1 and 4x5 meshes of the card, then one planes trial. A
    divergence raises with its seed. Returns the trials by kind and
    geometry, the seeds and the seconds."""
    fz = _torch_module("scripts", "fuzz_conformance")
    pool = fz.GEOMETRY_POOL + [(S_FULL, R_FULL, P20_KSEED)]
    sample = fz.oracle_sample(S_FULL)
    get = fz._kernels(device)
    trials: collections.Counter = collections.Counter()

    def one(seed: int) -> None:
        g = pool[seed % len(pool)]
        fz._trial_stepwise(get, seed, pool, sample if g[0] == S_FULL else None)
        trials[f"stepwise {g[0]}x{g[1]}"] += 1
        g = pool[(seed + 1) % len(pool)]
        fz._trial_fused(get, seed, pool)
        trials[f"fused {g[0]}x{g[1]}"] += 1

    t0 = time.perf_counter()
    for i in range(len(pool)):
        one(seed0 + i)
    warm_s = time.perf_counter() - t0
    n = len(pool)
    deadline = time.perf_counter() + budget_s
    while time.perf_counter() < deadline:
        one(seed0 + n)
        n += 1
    t1 = time.perf_counter()
    mesh_pool = fz.MESH_GEOMETRY_POOL + [(S_FULL, R_FULL, 4, 1), (S_FULL, R_FULL, 4, 5)]
    get_mesh = fz._mesh_kernels(device)
    for i in range(mesh_rounds * len(mesh_pool)):
        seed = seed0 + i
        S, R, a, b = mesh_pool[seed % len(mesh_pool)]
        fz._trial_mesh_crash(get_mesh, seed, mesh_pool)
        trials[f"mesh-crash {S}x{R} on {a}x{b}"] += 1
        S, R, a, b = mesh_pool[(seed + 1) % len(mesh_pool)]
        fz._trial_sharded_lossy(get_mesh, seed, mesh_pool)
        trials[f"sharded-lossy {S}x{R} on {a}x{b}"] += 1
    t2 = time.perf_counter()
    asyncio.run(fz._trial_planes(seed0, device))
    trials["planes"] += 1
    return {"trials": dict(trials), "seeds": [seed0, seed0 + n - 1],
            "oracle_sample": len(sample), "warmup_s": warm_s, "budget_s": t1 - t0 - warm_s,
            "mesh_s": t2 - t1, "planes_s": time.perf_counter() - t2}


def chaos_soak(device, S: int = S_FULL, mesh_s: float = P20_SOAK_MESH_S,
               jax_s: float = P20_SOAK_JAX_S) -> dict:
    """Phase 20 (b): ``scripts/torch_soak.py``'s device legs at S shards x
    5 replicas, each with all of its own gates: ``--plane mesh
    --device-store`` (crash/heal cycles through the device KV lane's
    demotions and re-promotions, DEL and GET-only waves), then the
    transport soak on ``backend="jax"`` (the engines' node kernel on the
    card). Their printed lines are kept off this script's output and
    returned; each leg's launches by kernel are returned too."""
    sk = _torch_module("scripts", "soak")
    out: dict = {}
    for leg, run in (
        ("mesh --device-store", lambda rep: sk.soak_mesh(
            mesh_s, S, P20_SOAK_MESH_SEED, device_store=True, device=device,
            report=rep)),
        ("transport --backend jax", lambda rep: asyncio.run(sk.soak(
            jax_s, S, P20_SOAK_JAX_SEED, backend="jax", device=device,
            report=rep))),
    ):
        before = _p20_counts()
        rep: dict = {}
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run(rep)
        lines = buf.getvalue().splitlines()
        _check(rc == 0, f"phase 20 (b) soak {leg} failed: {lines[-6:]}")
        after = _p20_counts()
        out[leg] = {**rep, "seconds": time.perf_counter() - t0, "last": lines[-1],
                    "chaos": sum(ln.startswith("[chaos]") for ln in lines),
                    "launches": {k: after[k] - before[k] for k in after if after[k] > before[k]}}
    return out


def _card_rate_bytes_per_s(name: str) -> float:
    """Peak device-memory rate of the card, from its name (data sheets)."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM (HBM3)


def main() -> int:
    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"card: {smi}")
    # each phase's seconds, printed on lines of their own before the
    # kernels line: lap(name) adds the time since the previous lap
    phase_s: dict = {}
    t_lap = [t_main]

    def lap(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = phase_s.get(name, 0.0) + now - t_lap[0]
        t_lap[0] = now

    # 1. build the eight CUDA sources (one nvcc per source, started
    # together) and the host pack gather (g++)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the native host plane (g++, one process a source) while nvcc runs
        native = pool.submit(native_build.build, *NATIVE_LIBS)
        libs = cuda_build.build(["fused_window", "kv_window", "kv_dict", "kv_read",
                                 "mesh_window", "packed_window", "cluster_round",
                                 "node_kernel"])
        host_lib = cuda_build.build_host("host_pack")
        native.result()  # raises the compiler's output when a build failed
    native_libs = [native_build.library_path(n) for n in NATIVE_LIBS]
    HOST_PACK.load()
    fused_window.FUSED_WINDOW.load()
    fused_window.FUSED_WINDOW_TSR.load()
    kv_window.KV_WINDOW.load()
    mesh_window.MESH_WINDOW.load()
    packed_window.PACKED_WINDOW.load()
    packed_window.PACKERS.load()
    cluster_round.CLUSTER_ROUND.load()
    node_kernel.NODE_CYCLE.load()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(p.name for p in [*libs.values(), host_lib, *native_libs])})")
    for lib in libs.values():
        print(lib.with_suffix(".log").read_text().strip())
    lap("1 (build)")

    # 2. kernel vs plain, many shapes
    t0 = time.perf_counter()
    err2, err2_tsr = kernel_vs_plain(device)
    print(f"phase 2 fused_window kernels vs plain: max_abs_err {err2} (replica-major), "
          f"{err2_tsr} ([T,S,R]) ({time.perf_counter() - t0:.2f} s)")

    # 2b. mesh-window kernel vs plain (not counted: before the main path)
    t0 = time.perf_counter()
    err2b = mesh_kernel_vs_plain(device)
    print(f"phase 2b mesh_window kernel vs plain: max_abs_err {err2b} "
          f"({time.perf_counter() - t0:.2f} s)")

    # 2c. packed-window kernel vs plain (not counted: before the main path)
    t0 = time.perf_counter()
    err2c = packed_kernel_vs_plain(device)
    print(f"phase 2c packed_window kernel vs plain: max_abs_err {err2c} "
          f"({time.perf_counter() - t0:.2f} s)")

    # 2d. round kernels vs plain and vs the oracle (not counted)
    t0 = time.perf_counter()
    err2d = max(round_kernel_vs_plain(device), pipeline_every_r(device))
    round_kernel_vs_oracle(device)
    print(f"phase 2d cluster_round kernels vs plain (run_rounds, round_step, in place, "
          f"slot_pipeline, slot_pipeline_wide at 0-6 rounds; the slot pipeline also for every R "
          f"in 1..64, one launch a call): max_abs_err {err2d}; vs the port's "
          f"WeakMVCOracle on a lossy trace: equal ({time.perf_counter() - t0:.2f} s)")

    # 3. protocol (the slot-pipeline kernel) vs the fused kernel
    t0 = time.perf_counter()
    protocol_vs_fused(device, S_FULL, R_FULL, 64)
    print(f"phase 3 slot_pipeline == slot_pipeline_fused at S={S_FULL} R={R_FULL} T=64 "
          f"({time.perf_counter() - t0:.2f} s)")

    # 6. kv-window kernel vs plain (before the main path: these launches
    # compare the kernel with its plain version and are not counted)
    t0 = time.perf_counter()
    err6 = kv_kernel_vs_plain(device)
    print(f"phase 6 kv_window kernel vs plain: max_abs_err {err6} ({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    err6_fold = decide_kernel_vs_plain(device)
    print(f"phase 6 kv_window with the decision vs plain: max_abs_err {err6_fold} "
          f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    err8 = dict_kernel_vs_plain(device)
    print(f"phase 8 kv_window on the dictionary form (window, SET/mixed/lookup with the "
          f"decision) and the read-only probe vs plain: max_abs_err {err8} "
          f"({time.perf_counter() - t0:.2f} s)")

    lap("2, 2b, 2c, 2d, 3, 6, 8 (kernels against their plain versions)")

    # ---- the main path: counts reset just before, read just after ----
    _reset_counts()
    t0 = time.perf_counter()
    k, bufs, alive, err4 = decision_core(device, S_FULL, R_FULL, T_FULL)
    kernel_ms = _time_ms(
        lambda i=0: k.slot_pipeline_fused_rmajor(bufs[i % 2], alive, T_FULL, want_phase=False),
        CHAIN,
    )
    tk, tbufs, talive, err4_tsr = decision_core_tsr(device, S_FULL, R_FULL, T_FULL)
    tsr_ms = _time_ms(lambda i=0: tk.slot_pipeline_fused(tbufs[i % 2], talive, T_FULL), CHAIN)
    # __graft_entry__'s shapes: the scanned protocol and the fused entry agree
    protocol_vs_fused(device, S_FULL, R_FULL, 8)
    # the scan at bench.py's depth, the selftest's fault path, and the
    # packed window at bench.py's packed depth
    sk, sbufs, salive, err_scan = scan_vs_fused(device, S_FULL, R_FULL, T_SCAN)
    scan_turns = [_time_ms(lambda i=0: sk.slot_pipeline(sbufs[i % 2], salive, T_SCAN), 8)]
    fk, fst0, falive, err_fault = fault_path(device, S_FULL)
    pk, pbufs, palive, prow, err_deep = packed_deep(device, S_FULL, R_FULL, T_PACKED)
    deep_ms = _time_ms(lambda i=0: pk.slot_pipeline_fused_packed(pbufs[i % 2], palive, T_PACKED), 8)
    d = pk.slot_pipeline_fused_packed(pbufs[0], palive, T_PACKED)
    _check(bool((d == prow[None, :]).all()), "packed window != the V1 row after the timed chain")
    del d, pbufs
    lane = serving_lane(device, S_FULL, R_FULL)
    t7 = time.perf_counter()
    kv_lane, kv_eng = device_kv_lane(device, S_FULL, R_FULL)
    lane7 = kv_lane.pop("_record")  # the host lane's, for phase 18 (b)
    t7 = time.perf_counter() - t7
    # the device table's programs in both forms, one launch of their form each
    win = lane_programs(kv_eng._dev, S_FULL, R_FULL)
    t8 = time.perf_counter()
    read_lane, rl_eng = device_read_lane(device, S_FULL, R_FULL)
    lane8 = read_lane.pop("_record")
    t8 = time.perf_counter() - t8
    # 9. the governor's window ladder on phase 7's table, every program
    # through its entry point and held against plain; the governed device
    # lane under a loose and a tight target; phase 7's SET lane with the C
    # pack gather and with numpy
    t9 = time.perf_counter()
    dkv = kv_eng._dev
    ladder, err9 = window_ladder(dkv, dkv.kernel, S_FULL, R_FULL, ladder_blocks(S_FULL))
    t9a = time.perf_counter() - t9
    gov, gov_engines = governed_lane(device, S_FULL, R_FULL)
    lane_pack = lane_native_vs_numpy(device, S_FULL, R_FULL)
    t9 = time.perf_counter() - t9
    pack_paths = {"phase 7": dict(dkv.pack_stats), "phase 8": dict(rl_eng._dev.pack_stats),
                  "phase 9 loose, tight, ungoverned": [dict(e._dev.pack_stats)
                                                       for e in gov_engines]}
    launches = fused_window.FUSED_WINDOW.launches
    tsr_launches = fused_window.FUSED_WINDOW_TSR.launches
    kv_counts = dict(kv_window.KV_WINDOW.counts)
    mesh_launches = mesh_window.MESH_WINDOW.launches
    packed_launches = packed_window.PACKED_WINDOW.launches
    packer_counts = dict(packed_window.PACKERS.counts)
    round_counts = dict(cluster_round.CLUSTER_ROUND.counts)
    main_s = time.perf_counter() - t0
    _check(launches > 0, "the main path never launched the fused window kernel")
    _check(tsr_launches > 0, "the main path never launched the [T,S,R] fused window kernel")
    _check(kv_counts["rows+decide"] > 0, "the main path never launched the kv window kernel")
    _check(kv_counts["dict+decide"] > 0,
           "the main path never launched the dictionary kernel (kv_dict.cu)")
    _check(kv_counts["probe dict"] + kv_counts["probe rows"] > 0,
           "the main path never launched the read-only kernel as the probe")
    _check(kv_counts["lookup dict"] + kv_counts["lookup rows"] > 0,
           "the main path never launched the read-only kernel as the GET window")
    _check(mesh_launches > 0, "the main path never launched the mesh window kernel")
    _check(packed_launches > 0, "the main path never launched the packed window kernel")
    _check(round_counts["slot_pipeline"] > 0 and round_counts["rounds"] > 0
           and round_counts["start_slot"] > 0,
           "the main path never launched the three round kernel entries")
    _check(all(n > 0 for n in packer_counts.values()),
           f"the main path never launched every packer kernel: {packer_counts}")
    for eng in (kv_eng, rl_eng, *gov_engines):
        st = eng._dev.pack_stats
        _check(st["native"] > 0 and st["numpy"] == 0,
               f"the C pack gather did not serve every grid window of the main path: {st}")
    # ---- end of the main path ----
    lap("main path (4, 5, 7, 8, 9)")

    # ---- phase 10, the transport engine beside the device plane: its own
    # path, counts reset just before and read just after ----
    _reset_counts()
    # the earlier phases' objects stay alive for the timings below: keep
    # the collector from rescanning them during the transport engine's run
    gc.collect()
    gc.freeze()
    t10 = time.perf_counter()
    gate3, gate3_eng = planes_gate(device, S_FULL, R_FULL, TRANSPORT_WAVES)
    gate2, _ = planes_gate(device, CFG2_S, CFG2_R, CFG2_WAVES)
    mesh_ckpt = mesh_persistence(device, gate3_eng, S_FULL, R_FULL)
    restart = transport_restart(CFG2_S, CFG2_R)
    p10_mesh = mesh_window.MESH_WINDOW.launches
    p10_other = (fused_window.FUSED_WINDOW.launches + fused_window.FUSED_WINDOW_TSR.launches
                 + sum(kv_window.KV_WINDOW.counts.values()) + packed_window.PACKED_WINDOW.launches
                 + sum(cluster_round.CLUSTER_ROUND.counts.values()))
    t10 = time.perf_counter() - t10
    gc.unfreeze()
    _check(p10_mesh > 0, "phase 10 never launched the mesh window kernel")
    del gate3_eng
    cpu = host_cpu()
    print(f"phase 10 (a) planes gate at BASELINE.json config 3's shape S={S_FULL} R={R_FULL}, "
          f"{TRANSPORT_WAVES} waves of 4 SETs on every shard, transport cluster (native tick and "
          f"codec, in-memory hub, host CPU: {cpu}) vs MeshEngine on the card ({smi}): decisions, "
          f"futures and replica stores equal; {json.dumps(gate3)}")
    print(f"phase 10 (b) planes gate at config 2's shape S={CFG2_S} R={CFG2_R}, {CFG2_WAVES} "
          f"waves: equal; {json.dumps(gate2)}")
    print(f"phase 10 (c) persistence: MeshEngine.save_to / load_from on the card after (a) "
          f"(FileSystemPersistence; stores, slot counters and a further wave's decision logs "
          f"equal): {json.dumps(mesh_ckpt)}; transport engine shut down and restarted from its "
          f"persistence layer, a further wave on every replica: {json.dumps(restart)}")
    print(f"phase 10 path: {p10_mesh} mesh-window launches, {p10_other} launches of the other "
          f"kernels, {t10:.2f} s")
    lap("10")

    # ---- phase 11, the apps over the engine at BASELINE.json configs 1-4:
    # its own path, counts reset just before and read just after ----
    _reset_counts()
    gc.collect()
    gc.freeze()
    t11 = time.perf_counter()
    app1 = counter_config1(device)
    app2 = kv_config2(device)
    app3 = kv_config3(device)
    app4 = bank_config4(device)
    p11_mesh = mesh_window.MESH_WINDOW.launches
    p11_kv = dict(kv_window.KV_WINDOW.counts)
    p11_other = (fused_window.FUSED_WINDOW.launches + fused_window.FUSED_WINDOW_TSR.launches
                 + packed_window.PACKED_WINDOW.launches
                 + sum(cluster_round.CLUSTER_ROUND.counts.values()))
    t11 = time.perf_counter() - t11
    gc.unfreeze()
    p11_dict = p11_kv["dict"] + p11_kv["dict+decide"]
    _check(p11_mesh > 0, "phase 11 never launched the mesh window kernel")
    _check(p11_dict > 0, "phase 11 (c) never launched the dictionary kernel (kv_dict.cu)")
    where = f"host CPU: {cpu}; card: {smi}"
    print(f"phase 11 (a) BASELINE.json config 1, counter_smr {CFG1_R} replicas x 1 shard, "
          f"{CFG1_CMDS} increments, decrements, a set and a reset through SMRBridge(CounterSMR) "
          f"over a transport cluster (in-memory hub), one command a slot from every replica in "
          f"turn, and through MeshEngine on the card: responses and every replica's counter "
          f"equal; {where}; {json.dumps(app1)}")
    print(f"phase 11 (b) config 2, kvstore_smr {CFG2_R} replicas x {CFG2_S} shards: "
          f"ShardedKVService over make_sharded_kv, {CFG2_OP_WAVES} waves of one SET/GET/DELETE/"
          f"EXISTS/CAS a shard, a set_many and a get_many (block lane), and the same commands "
          f"through MeshEngine on the card: responses and every shard's checksum() on every "
          f"replica equal; {where}; {json.dumps(app2)}")
    print(f"phase 11 (c) config 3, kvstore_smr {R_FULL} replicas x {S_FULL} shards, adaptive "
          f"batching on (BatchConfig()): {APP_WAVES} waves of concurrent set() calls, {APP_PER} "
          f"keys a shard, {APP_KEY}-byte keys, {APP_VAL}-byte values (cut: none), beside "
          f"MeshEngine(device_store=True) on the card fed the same SETs (kv_dict.cu): every "
          f"set() ok, the device table's values and versions equal the sharded KV's; {where}; "
          f"{json.dumps(app3)}")
    print(f"phase 11 (d) config 4, banking_smr {CFG4_R} replicas x {CFG4_S} shards, replicas "
          f"{list(CFG4_CRASH)} crashed (FaultType.NodeCrash) after the first wave, "
          f"{CFG4_POST} waves after: every command committed on the live replicas, balances and "
          f"transaction logs equal, money conserved; MeshEngine on the card with the same "
          f"replicas crashed: live replicas equal; {where}; {json.dumps(app4)}")
    print(f"phase 11 path: {p11_mesh} mesh-window launches, {p11_dict} kv-dict launches "
          f"({json.dumps({k: v for k, v in p11_kv.items() if v})}), {p11_other} launches of the "
          f"other kernels, {t11:.2f} s")
    lap("11")

    # ---- phase 12, BASELINE.json configs 5 and 6 over TCP on the card's
    # host, beside the card: its own path, counts reset just before and
    # read just after ----
    _reset_counts()
    gc.collect()
    gc.freeze()
    t12 = time.perf_counter()
    tcp5 = tcp_config5(device)
    p12a = _kernel_counts()
    tcp6 = tcp_config6(device)
    p12 = _kernel_counts()
    for i, dl in enumerate(tcp6["runtime"]["runtime_counter_deltas"]):
        _check(dl["gil_handoffs"] == 0,
               f"phase 12 (b): replica {i} took {dl['gil_handoffs']} GIL handoffs")
    t12 = time.perf_counter() - t12
    gc.unfreeze()
    _check(p12["kv_dict"] + p12["kv_window"] > 0, "phase 12 never launched a kv kernel")
    print(f"phase 12 (a) BASELINE.json config 5, kvstore (VectorShardedKV) {CFG5_R} replicas x "
          f"{CFG5_S} shards over TCP (127.0.0.1), Zipf({CFG5_ZIPF_S}) keys, the block pump for "
          f"{PUMP_S} s (cut: none), beside MeshEngine(device_store=True) on the card fed each "
          f"shard's committed SETs: replicas equal, device table equal; planes as asserted; "
          f"{where}; {json.dumps(tcp5)}")
    print(f"phase 12 (a) launches by kernel: {json.dumps(p12a)}")
    print(f"phase 12 (b) config 6, kvstore_smr (native store) {CFG6_R} replicas x {CFG6_S} "
          f"shards over TCP, one SET a shard a slot, the block pump for {PUMP_S} s on the native "
          f"runtime and on the asyncio owner (RABIA_PY_RUNTIME=1): decisions/s "
          f"{tcp6['runtime']['decisions_per_s']:.1f} / {tcp6['asyncio']['decisions_per_s']:.1f}; "
          f"{where}; {json.dumps(tcp6)}")
    print(f"phase 12 path: launches by kernel {json.dumps(p12)}, {t12:.2f} s")
    lap("12")

    # ---- phase 13, the durability plane and the gateway at config 3's
    # width, beside the card: its own path, counts reset just before and
    # read just after ----
    _reset_counts()
    gc.collect()
    gc.freeze()
    t13 = time.perf_counter()
    gw13 = asyncio.run(durable_gateway_run(device))
    t13a = time.perf_counter() - t13
    rec13 = recovery_run(device)
    p13 = _kernel_counts()
    t13 = time.perf_counter() - t13
    gc.unfreeze()
    _check(p13["kv_read"] > 0, "phase 13 never launched the kv-read kernel")
    _check(p13["kv_dict"] > 0, "phase 13 never launched the kv-dict kernel")
    durable_cost = gw13["writes_per_s"] / tcp6["runtime"]["decisions_per_s"]
    print(f"phase 13 (a) durable gateway cluster, kvstore_smr (native store) {R_FULL} replicas x "
          f"{S_FULL} shards over TCP (127.0.0.1), WalPersistence with group-commit fsync "
          f"(WAL on {gw13['wal_fs']}), {P13_SESSIONS} RabiaClient sessions, {P13_WAVES} waves of "
          f"one SET a shard ({P13_KEY}-byte keys, {P13_VAL}-byte values; cut: from 4 waves, "
          f"the depth, to keep the script inside its time): "
          f"{gw13['writes_per_s']:.1f} acknowledged durable writes/s, submit-to-ack p50 "
          f"{gw13['submit_ack_p50_s']:.4f} s p99 {gw13['submit_ack_p99_s']:.4f} s; "
          f"{gw13['wal_fsyncs']} fsyncs, {gw13['wal_bytes']} bytes, "
          f"{gw13['wal_records_per_fsync']} records a fsync, durable LSN {gw13['durable_lsn']}; "
          f"replay of every (client, seq): {gw13['replayed_from_cache']} answered from the "
          f"session cache, no new slot; ReadIndex reads of every key through "
          f"devkv_read_handler over MeshEngine(device_store=True) on the card and through "
          f"kv_read_handler over a replica's store: {gw13['reads_equal']} equal, "
          f"{gw13['probe_rounds']} probe rounds, {gw13['kv_read_launches']} kv_read launches, "
          f"{gw13['kv_read_device_ms']} device ms (CUDA events), read p50 "
          f"{gw13['devkv_read_p50_s']:.4f} s p99 {gw13['devkv_read_p99_s']:.4f} s; durable "
          f"writes/s over phase 12 (b)'s runtime decisions/s {durable_cost:.4f}; {t13a:.2f} s; "
          f"{where}; {json.dumps(gw13)}")
    print(f"phase 13 (b) kill -9 and recovery, {R_FULL} replica processes x {S_FULL} shards on "
          f"WalPersistence (WAL on {rec13['wal_fs']}), {P13_PRELOAD} keys preloaded (cut: from 20000), "
          f"replica {rec13['killed']} killed under load and restarted: snapshot_restore_s "
          f"{rec13['snapshot_restore_s']}, wal_replay_s {rec13['wal_replay_s']}, waves_replayed "
          f"{rec13['waves_replayed']}, torn {rec13['torn']}, rejoin_under_load_s "
          f"{rec13['rejoin_under_load_s']:.3f}, post-rejoin goodput "
          f"{rec13['post_rejoin_goodput_per_s']}/s; every acknowledged write ({rec13['reads']}) "
          f"read back through the restarted gateway equals the device table's answer; {where}; "
          f"{json.dumps(rec13)}")
    print(f"phase 13 (a) critical path of the slow Submits during the writes (obs/critpath, "
          f"CritpathAggregator over the gateways' slowlog exemplars): "
          f"{_fmt_critpath(gw13['critpath'])}; the runtime's stage clocks (RTS) over the same "
          f"span, seconds summed over the replicas: {json.dumps(gw13['rts_stages'])}; "
          f"{json.dumps(gw13['critpath'])}")
    print(f"phase 13 path: launches by kernel {json.dumps(p13)}, {t13:.2f} s")
    lap("13")

    # ---- phase 14, a routed fleet over the durable cluster at config 3's
    # width, its reads from the card's table: its own path, counts reset
    # just before and read just after ----
    _reset_counts()
    gc.collect()
    gc.freeze()
    t14 = time.perf_counter()
    fl14 = asyncio.run(fleet_run(device))
    p14 = _kernel_counts()
    p14_forms = dict(kv_window.KV_WINDOW.counts)
    t14 = time.perf_counter() - t14
    gc.unfreeze()
    _check(p14["kv_read"] > 0, "phase 14 never launched the kv-read kernel")
    _check(p14["kv_dict"] > 0, "phase 14 never launched the kv-dict kernel")
    mesh14 = fl14.pop("_mesh")
    table14 = fl14.pop("fleet_table")
    probe14_ms, probe14_err = probe_graph_ms(mesh14, S_FULL)
    del mesh14
    print(f"phase 14 routed fleet, {P14_GATEWAYS} fleet gateways (FleetHarness) over "
          f"GatewayCluster({R_FULL}, {S_FULL}, persistence=\"wal\"), {P14_SESSIONS} FleetSessions "
          f"through one FleetConnPool, {P14_WAVES} wave(s) of one SET a shard (cut: from 2); the ring "
          f"dropped gw{P14_GATEWAYS - 1}, gw0 killed mid-wave: "
          f"{fl14['writes_per_s']:.1f} acknowledged writes/s through the fleet, submit-to-ack "
          f"p50 {fl14['submit_ack_p50_s']:.4f} s p99 {fl14['submit_ack_p99_s']:.4f} s; "
          f"{fl14['moved_redirects']} MOVED redirects, {fl14['failovers']} failovers, "
          f"{fl14['fleet_stats']['ledger_sent']} ledger records sent / "
          f"{fl14['fleet_stats']['ledger_applied']} applied; replay of every (client, seq): "
          f"{fl14['replayed_from_cache']} answered CACHED, no new slot; ReadIndex reads of every "
          f"key through the fleet, served by devkv_read_handler over MeshEngine(device_store=True) "
          f"on the card: {fl14['reads_equal']} equal to a replica's store and the last acked "
          f"write, {fl14['probe_rounds']} probe rounds, {fl14['kv_read_launches']} kv_read "
          f"launches, {fl14['kv_read_device_ms']} device ms (CUDA events), the probe at this "
          f"shape {probe14_ms:.4f} ms by graph replay (max_abs_err {probe14_err}), read p50 "
          f"{fl14['read_p50_s']:.4f} s p99 {fl14['read_p99_s']:.4f} s; {t14:.2f} s; {where}; "
          f"{json.dumps(fl14)}")
    print("phase 14 fleet aggregator (render_fleet_table):")
    print(table14)
    print(f"phase 14 critical path of the fleet's slow Submits: {_fmt_critpath(fl14['critpath'])}")
    print(f"phase 14 path: launches by kernel {json.dumps(p14)}, {t14:.2f} s")
    lap("14")

    # ---- phase 15, the chaos smoke set, the mesh profile at config 3's
    # width on the card: its own path, counts reset just before and read
    # just after ----
    _reset_counts()
    gc.collect()
    gc.freeze()
    t15 = time.perf_counter()
    ch15 = chaos_run(device)
    p15 = _kernel_counts()
    p15_forms = dict(kv_window.KV_WINDOW.counts)
    t15 = time.perf_counter() - t15
    gc.unfreeze()
    for pname, r in ch15["profiles"].items():
        print(f"phase 15 {pname} ({r['fabric']}, {r['replicas']} x {r['shards']}): pass "
              f"{r['pass']}, availability {r['availability']}, final quarter "
              f"{r['final_quarter_availability']}, problems {r['problems']}; {json.dumps(r)}")
    print(f"phase 15 mesh fabric lane cycle at {P15_MESH_R} x {P15_MESH_S} on the card: "
          f"{json.dumps(ch15['lane_cycle'])}")
    failed = [n for n, r in ch15["profiles"].items() if not r["pass"]]
    _check(not failed, f"phase 15: profiles failed: {failed}")
    mesh15 = ch15["profiles"]["mesh_device_read_lane"]["fabric_summary"]
    _check(mesh15["read_lane"]["probe"] > 0 and mesh15["divergences"] == 0
           and mesh15["forced_demotions"] == 1,
           f"phase 15: the mesh profile's verify read {mesh15}")
    _check(p15["kv_read"] > 0, "phase 15 never launched the kv-read kernel")
    print(f"phase 15 path: launches by kernel {json.dumps(p15)}, {t15:.2f} s")
    lap("15")

    # ---- phase 16, the engine's node kernel on the card, the CLI and the
    # packers: (b) and (c) compare kernels with their plain versions
    # (before the counts reset, not counted); then (a) and (d) on their
    # own counts, reset just before and read just after ----
    t16 = time.perf_counter()
    err16b, cases16b = node_kernel_vs_plain(device)
    t16b = time.perf_counter() - t16
    err16c = max(packers_vs_plain(device), start_slot_vs_plain(device))
    t16c = time.perf_counter() - t16 - t16b
    _reset_counts()
    gc.collect()
    gc.freeze()
    t16d = time.perf_counter()
    cli16 = cli_run()
    t16a = time.perf_counter() - t16d
    t16d = time.perf_counter()
    dev16 = device_backend_gate(device, S_FULL, R_FULL, TRANSPORT_WAVES)
    p16 = _kernel_counts()
    p16_node = dict(node_kernel.NODE_CYCLE.counts)
    t16d = time.perf_counter() - t16d
    gc.unfreeze()
    _check(p16_node["node_cycle"] > 0, "phase 16 (d) never launched the node kernel")
    for line in cli16:
        print(f"phase 16 (a) {line}")
    print(f"phase 16 (a) python -m rabia_tpu_torch and --selftest as processes on the card: "
          f"exit 0 ({t16a:.2f} s)")
    print(f"phase 16 (b) node kernel (NodeKernel.node_cycle, one launch of node_kernel.cu on "
          f"its pinned plane buffer and host image, mapped) vs node_cycle_plain on the card, "
          f"every state field and outbox plane and the fetched image's views, on host arrays "
          f"and on the kernel's own plane views, and vs start_slots + K node_steps: {cases16b} "
          f"cases (R in 1,3,4,5,7,8,64; S in 17,1000,4096; K "
          f"in 0,1,3,8; coin_p1 0/0.5/1; slots and phases near 2^31-1; all four codes, partial "
          f"inboxes, adopted decisions, inactive and done shards): max_abs_err {err16b} "
          f"({t16b:.2f} s)")
    print(f"phase 16 (c) packer kernels (pack_codes, unpack_codes, pack_alive, pack_inputs) vs "
          f"plain: R in 1,5,8, S in 17,1000,4095, views one byte and one word into a buffer; "
          f"start_slot vs start_slot_plain: masks none, all and random, R in 1,5,8,9, S in "
          f"17,1000,4095, out of place, in place and one byte into a buffer, and 20 shard blocks "
          f"in one call (two launches): max_abs_err {err16c} ({t16c:.2f} s)")
    host10 = gate3
    for leg, r in dev16.items():
        print(f"phase 16 (d) planes gate at S={S_FULL} R={R_FULL}, {TRANSPORT_WAVES} waves of 4 "
              f"SETs on every shard, transport cluster on the device backend "
              f"(KernelConfig.backend='jax', NodeKernel on the card, zero_copy_inbox="
              f"{leg == 'zero_copy'}) vs MeshEngine on the card: decisions, futures and replica "
              f"stores equal; {r['decisions_per_s']:.1f} decisions/s, settle p50 "
              f"{r['settle_p50_s']:.4f} s p99 {r['settle_p99_s']:.4f} s (phase 10 (a)'s host "
              f"kernel in this run: {host10['transport_decisions_per_s']:.1f} decisions/s, p50 "
              f"{host10['settle_p50_s']:.4f} s p99 {host10['settle_p99_s']:.4f} s); "
              f"{r['ticks']} ticks, {r['launches']['node_cycle']} node_cycle launches (one a "
              f"tick); under the profiler (CUDA activity) over {r['trace']['ticks']} ticks: "
              f"{r['trace']['launches']} kernel launches, {r['trace']['copies']} copies, "
              f"{r['trace']['host_allocs']} pinned allocations; over the "
              f"link {r['mapped_bytes']} bytes ({r['mapped_bytes_per_tick']:.0f} a tick: the "
              f"planes and the host image, {r['opening_ticks']} ticks with open planes); a "
              f"tick's spans by "
              f"CUDA events, host code included: upload {r['upload_span_ms_per_tick']:.4f} ms, "
              f"launch {r['launch_span_ms_per_tick']:.4f} ms, fetch "
              f"{r['fetch_span_ms_per_tick']:.4f} ms; card: {smi}; host CPU: {cpu}; "
              f"{json.dumps(r)}")
    print(f"phase 16 path: launches by kernel {json.dumps(p16)}, node kernel by entry "
          f"{json.dumps(p16_node)}, {t16d:.2f} s (d), {time.perf_counter() - t16:.2f} s in all")
    lap("16")

    # ---- phase 17, the device mesh on the card (the card is every device
    # of a logical mesh, and the device of one rank and of two): (b)'s
    # windows against the one-device kernel and plain before the counts
    # (not counted); then (a), (b)'s engine, (c) and (d) on their own
    # counts, reset just before and read just after ----
    t17 = time.perf_counter()
    win17 = mesh_windows_vs_one_device(device, S_FULL, R_FULL)
    t17b = time.perf_counter() - t17
    _reset_counts()
    t17m = time.perf_counter()
    eng17 = mesh_engines(device)
    sc17 = sharded_cluster(device, S_FULL, R_FULL)
    ranks17 = mesh_ranks(eng17["digest"])
    p17 = _kernel_counts()
    p17_round = dict(cluster_round.CLUSTER_ROUND.counts)
    p17_ranks = sum(r["launches"] for leg in ranks17.values() for r in leg["ranks"])
    t17m = time.perf_counter() - t17m
    _check(p17["mesh_window"] > 0, "phase 17 never launched the mesh window kernel")
    _check(p17_ranks > 0, "phase 17 (d): the ranks never launched the mesh window kernel")
    _check(p17_round["slot_pipeline"] > 0 and p17_round["rounds"] > 0
           and p17_round["start_slot"] > 0, "phase 17 (c) never launched the round kernels")
    times17 = mesh_times(device, S_FULL, R_FULL)
    stimes17 = sharded_times(device, S_FULL, R_FULL)
    print(f"phase 17 (b) logical meshes of the card {', '.join(f'{a}x{b}' for a, b in P17_SHAPES)} "
          f"(shard x replica): slot_window at S={S_FULL} R={R_FULL} T={P17_T}, votes over all four "
          f"codes, crash masks with a quorum-less shard, bases near 2^31-1, 4 phases "
          f"({win17['phases']} phases, {win17['coins']} coins) == the one-device mw_window == the "
          f"plain loop, one launch a shard block; phase_step on 4x5 (two exchanges over the "
          f"replica axis) == one device's for 4 phases: max_abs_err {win17['max_abs_err']} "
          f"({t17b:.2f} s)")
    print(f"phase 17 (a) MeshEngine(mesh=make_mesh()) (1x1 on the card) == MeshEngine() at "
          f"S={S_FULL} R={R_FULL} window={P17_T} (SET and GET on every shard, a minority crash "
          f"with SETs, heal, GETs): decisions, futures and replica snapshots equal; (b) the 4x5 "
          f"logical mesh's engine == (a); {json.dumps(eng17)}")
    print(f"phase 17 (c) ShardedClusterKernel({S_FULL}, {R_FULL}, 4x1) vs ClusterKernel: "
          f"slot_pipeline T=64 at 4 rounds a slot ({sc17['coin_slots']} slots by the coin) and "
          f"the fault path's run_rounds (80 rounds, p=0.6), block by block with each block's "
          f"global shard base; start_slot on a state of protocol values, one launch for the "
          f"{sc17['blocks']} shard blocks ({sc17['start_slot_launches_a_call']} by "
          f"CLUSTER_ROUND.counts): max_abs_err {sc17['max_abs_err']}")
    for leg, r in ranks17.items():
        world, backend = leg.split("x")
        for rank in r["ranks"]:
            times = ("" if "window_ms" not in rank else
                     f"window {rank['window_ms']:.4f} ms by CUDA events (cut, exchange, "
                     f"{rank['launches_per_window']:.0f} mw_window launch a window, gather over "
                     f"the shard group, copy to the host), exchange alone "
                     f"{rank['exchange_ms']:.4f} ms; ")
            print(f"phase 17 (d) {world} rank(s) on a {backend} group, rank {rank['rank']}: "
                  f"{rank['mesh']}, (a)'s submissions through _run_window_multihost == (a) "
                  f"({rank['windows']} windows, {rank['launches']} mw_window launches); {times}"
                  f"card: {smi}; leg {r['seconds']:.2f} s")
    for shape, r in times17.items():
        extra = ("" if "exchange_ms" not in r else
                 f", exchange alone {r['exchange_ms']:.4f} ms, "
                 f"{r['launches_per_window']:.0f} mw_window launches a window")
        print(f"phase 17 window times at S={S_FULL} R={R_FULL} T={P17_T}, {shape}: window "
              f"{r['window_ms']:.4f} ms by CUDA events (a chain of 20){extra}; card: {smi}")
    print(f"phase 17 window times: the 4x5 plain version (decide_blocks_plain a shard block "
          f"on the gathered layout) {times17['4x5']['plain_ms']:.3f} ms; card: {smi}")
    for prog, r in stimes17.items():
        # (not `launches`: that name holds the main path's fused-window count)
        how = ("one launch for the four shard blocks, against one; under the profiler "
               f"{r['trace']['launches']} kernel launches in {r['trace']['calls']} calls"
               if prog == "start_slot" else "four launches, one a shard block, against one")
        print(f"phase 17 (c) ShardedClusterKernel(4096, 5, 4x1).{prog} by CUDA events, in turns "
              f"with ClusterKernel's (one, sharded, sharded, one): "
              f"{' / '.join(f'{t:.4f}' for t in r['turns_ms'])} ms ({how})"
              f"{' at T=8192, 2 rounds' if prog == 'slot_pipeline' else ''}"
              f"{', 80 rounds with their mask draws' if prog == 'run_rounds' else ''}; "
              f"card: {smi}")
    print(f"phase 17 path: launches by kernel {json.dumps(p17)}, round kernel by entry "
          f"{json.dumps(p17_round)}, the ranks' mw_window launches {p17_ranks}; "
          f"{t17m:.2f} s (a)-(d), {time.perf_counter() - t17:.2f} s in all")
    lap("17")

    # ---- phase 18, the device KV lane and its read lane over logical
    # meshes of the card at config 3's width: (a) and (b) on their own
    # counts, reset just before and read just after; then (c)'s times ----
    _reset_counts()
    gc.collect()
    gc.freeze()
    t18 = time.perf_counter()
    tab18 = mesh_tables_vs_one_device(device, S_FULL, R_FULL)
    t18a = time.perf_counter() - t18
    mesh18 = make_mesh([device] * 4, 4, 1)
    lane18, eng18 = device_kv_lane(device, S_FULL, R_FULL, mesh=mesh18, want=lane7)
    lane18.pop("_record")
    read18, rl18 = device_read_lane(device, S_FULL, R_FULL, mesh=mesh18, want=lane8)
    read18.pop("_record")
    p18 = _kernel_counts()
    p18_forms = dict(kv_window.KV_WINDOW.counts)
    t18b = time.perf_counter() - t18 - t18a
    gc.unfreeze()
    _check(eng18._dev.mesh is mesh18 and rl18._dev.mesh is mesh18,
           "phase 18 (b): an engine's table is not in the mesh's shard blocks")
    _check(p18["kv_dict"] > 0 and p18["kv_window"] > 0 and p18["kv_read"] > 0,
           f"phase 18 never launched every kv kernel: {p18}")
    del eng18, rl18
    times18 = mesh_lane_times(tab18.pop("tables"), tab18.pop("win"))
    t18 = time.perf_counter() - t18
    print(f"phase 18 (a) DeviceKVTable at S={S_FULL} R={R_FULL} P={P_FULL} in shard blocks on "
          f"logical meshes of the card {', '.join(f'{a}x{b}' for a, b in P17_SHAPES)} (shard x "
          f"replica) against the one-device table on the same inputs: four SET windows filling "
          f"every slot (two in the row form, two in the dictionary form), a GET window, a mixed "
          f"window, a probe, replica {R_FULL - 1} down and bases near 2^31-1: flags, reads, "
          f"gathered rows and dump() equal, each window one kv launch a shard block "
          f"({json.dumps(tab18)}; {t18a:.2f} s)")
    print(f"phase 18 (b) phase 7's device KV lane stream on MeshEngine(device_store=True) over "
          f"the 4x1 mesh (SET, GET and mixed waves, overflow demotion, re-promotion, majority "
          f"crash): every response, the slot counters, the decision logs and every replica "
          f"store equal to phase 7's host lane; {json.dumps(lane18)}; phase 8's read-lane "
          f"stream on the same mesh: responses and store equal to phase 8's, zero slots for "
          f"probe reads; {json.dumps(read18)} ({t18b:.2f} s)")
    for prog, r in times18.items():
        what = ("the dictionary SET window (decide_apply)" if prog == "dict_set"
                else "the probe (lookup_only)")
        print(f"phase 18 (c) {what} at S={S_FULL} W={P18_W}, by CUDA events over a chain of "
              f"{P18_REPS}, host issue included, in turns (one device, 4x1, 4x1, one device): "
              f"{' / '.join(f'{t:.4f}' for t in r['turns_ms'])} ms; card: {smi}")
    print(f"phase 18 path: launches by kernel {json.dumps(p18)}, kv kernels by form "
          f"{json.dumps({k: v for k, v in p18_forms.items() if v})}; {t18a + t18b:.2f} s (a)-(b), "
          f"{t18:.2f} s in all")
    lap("18")

    # ---- phase 19, the README's device examples on the card (the
    # reference's sizes against their CPU runs, then 4096 x 5), on their
    # own counts, reset just before and read just after ----
    _reset_counts()
    t19 = time.perf_counter()
    ex19 = device_examples(device)
    p19 = _kernel_counts()
    p19_forms = dict(kv_window.KV_WINDOW.counts)
    p19_round = dict(cluster_round.CLUSTER_ROUND.counts)
    t19 = time.perf_counter() - t19
    _check(p19["mesh_window"] > 0, "phase 19 never launched the mesh window kernel")
    _check(p19["kv_dict"] + p19["kv_window"] > 0 and p19["kv_read"] > 0,
           f"phase 19 never launched the kv kernels: {p19}")
    _check(p19_round["slot_pipeline"] > 0, "phase 19 never launched the slot pipeline kernel")
    for run, r in ex19["runs"].items():
        lines = r.pop("lines", None)
        what = (f"the reference's size: {r['lines_equal']} lines equal to its CPU run's, "
                f"{r['timed_lines']} timed lines held out ({r['card_s']:.2f} s on the card, "
                f"{r['cpu_s']:.2f} s on the CPU)" if lines is None else
                f"its own checks hold ({r['card_s']:.2f} s): "
                f"{' | '.join(ln[:100] + ('...' if len(ln) > 100 else '') for ln in lines[-4:])}")
        print(f"phase 19 examples/torch_{run.split()[0]}.py{run[len(run.split()[0]):]}: {what}")
    print(f"phase 19 witness (profiler over the card runs): {ex19['witness']['launches']} "
          f"cudaLaunchKernel records, device records by kernel "
          f"{json.dumps(ex19['witness']['families'])}")
    print(f"phase 19 path: launches by kernel {json.dumps(p19)}, kv kernels by form "
          f"{json.dumps({k: v for k, v in p19_forms.items() if v})}, round kernel by entry "
          f"{json.dumps(p19_round)}; {t19:.2f} s")
    lap("19")

    # ---- phase 20, the conformance fuzz and the chaos soak on the card at
    # config 3's width (scripts/torch_fuzz_conformance.py, torch_soak.py),
    # on their own counts, reset just before and read just after ----
    _reset_counts()
    t20 = time.perf_counter()
    fuzz20 = conformance_fuzz(device)
    p20a = _p20_counts()
    soak20 = chaos_soak(device)
    p20 = _p20_counts()
    p20_forms = dict(kv_window.KV_WINDOW.counts)
    t20 = time.perf_counter() - t20
    p20b = {k: p20[k] - p20a[k] for k in p20}
    for kern in ("fused_window", "fused_window_tsr", "cr_rounds", "cr_start_slot",
                 "cr_slot_pipeline", "mesh_window"):
        _check(p20a[kern] > 0, f"phase 20 (a) never launched {kern}: {p20a}")
    _check(p20b["kv_dict"] + p20b["kv_window"] > 0 and p20b["kv_read"] > 0,
           f"phase 20 (b) never launched the kv kernels: {p20b}")
    _check(p20b["mesh_window"] > 0 and p20b["node_kernel"] > 0,
           f"phase 20 (b) never launched mw_window and node_cycle: {p20b}")
    reprom = soak20["mesh --device-store"]["repromotions"]
    _check(reprom >= 1, f"phase 20 (b): the device lane never re-promoted: {soak20}")
    print(f"phase 20 (a) scripts/torch_fuzz_conformance.py at S={S_FULL} R={R_FULL} and the "
          f"reference's pools, seeds {fuzz20['seeds'][0]}-{fuzz20['seeds'][1]} (the stepwise "
          f"trial at {S_FULL} shards against round_step_plain on every shard and the oracle on "
          f"{fuzz20['oracle_sample']}): every trial conformant; trials by kind and geometry "
          f"{json.dumps(fuzz20['trials'])}; warm-up {fuzz20['warmup_s']:.2f} s, stepwise and "
          f"fused {fuzz20['budget_s']:.2f} s, mesh {fuzz20['mesh_s']:.2f} s, planes "
          f"{fuzz20['planes_s']:.2f} s")
    for leg, rep20 in soak20.items():
        print(f"phase 20 (b) scripts/torch_soak.py {leg} at S={S_FULL}: {rep20['last']} "
              f"({json.dumps({f: v for f, v in rep20.items() if f != 'last'})})")
    print(f"phase 20 path: launches by kernel (a) {json.dumps(p20a)}, (b) {json.dumps(p20b)}, "
          f"kv kernels by form {json.dumps({k: v for k, v in p20_forms.items() if v})}; "
          f"{reprom} re-promotions; {t20:.2f} s")
    lap("20")

    q = quorum_size(R_FULL)
    votes = bufs[0]
    phase_ms = _time_ms(lambda i=0: fused_window.FUSED_WINDOW(bufs[i % 2], alive, q), 8)
    plain_ms = _time_ms(
        lambda i=0: fused_window.closed_form_window_rmajor(bufs[i % 2], alive, q, want_phase=False), 4
    )
    packed = [packed_window.pack_codes(b) for b in bufs]
    alive_p = packed_window.pack_alive(alive)
    packed_ms = _time_ms(lambda i=0: packed_window.packed_window_rmajor(packed[i % 2], alive_p, q), 4)
    pw_call = lambda i=0: packed_window.PACKED_WINDOW(packed[i % 2], alive_p, q)  # noqa: E731
    pw_turns = [_time_ms(pw_call, CHAIN), _time_ms(pw_call, CHAIN)]
    pw_ms = min(pw_turns)
    pw_err = _max_err(pw_call(), packed_window.packed_window_rmajor(packed[0], alive_p, q))
    SW = packed[0].shape[-1]
    pw_bytes = 4 * (R_FULL * T_FULL * SW + R_FULL * SW + T_FULL * SW)
    pw_bytes_ms = pw_bytes / _card_rate_bytes_per_s(name) * 1e3
    pw_ops_ms = packed_ops(R_FULL, T_FULL, SW) / INT32_OPS_PER_S * 1e3
    # phase 16 (c): the packers at T_FULL and ClusterKernel.start_slot at
    # S_FULL x R_FULL, kernels and plain versions by graph replay; and
    # one engine tick's node_cycle at S_FULL x R_FULL, 3 steps
    ptimes = packer_times(device, name, votes, alive, k)
    t_floor = time.perf_counter()
    nc_times = node_tick_times(device, name, S_FULL, R_FULL, 3)
    t_tick = time.perf_counter() - t_floor
    win_times = window_times(device, name, S_FULL, R_FULL, 16)
    t_window = time.perf_counter() - t_floor - t_tick
    deep_bytes = 4 * (R_FULL * T_PACKED * SW + R_FULL * SW + T_PACKED * SW)
    deep_bound_ms = max(deep_bytes / _card_rate_bytes_per_s(name) * 1e3,
                        packed_ops(R_FULL, T_PACKED, SW) / INT32_OPS_PER_S * 1e3)
    # the round kernels: the scan at T_SCAN at 2 and 4 rounds a slot, in
    # turns, each held equal to the batched plain version, the kernel and
    # the plain loop at T_PLAIN_SCAN (held equal), the fault path's one
    # launch of 80 rounds beside an empty kernel at its grid, the whole
    # run_rounds call and the plain loop
    scan_call = lambda i=0: sk.slot_pipeline(sbufs[i % 2], salive, T_SCAN)  # noqa: E731
    scan_turns.append(_time_ms(scan_call, 8))
    short = sbufs[0][:T_PLAIN_SCAN]
    scan_short_ms = _time_ms(lambda i=0: sk.slot_pipeline(short, salive, T_PLAIN_SCAN), 20)
    scan_short_plain_ms = _time_ms(
        lambda i=0: sk.slot_pipeline_plain(short, salive, T_PLAIN_SCAN), 2)
    err_short = max(_max_err(a, b) for a, b in zip(
        sk.slot_pipeline(short, salive, T_PLAIN_SCAN),
        sk.slot_pipeline_plain(short, salive, T_PLAIN_SCAN)))
    _check(err_short == 0, f"slot_pipeline kernel != plain at T={T_PLAIN_SCAN}")
    # the plain version at the scan's own depth: slot_pipeline_wide_plain,
    # 256 slots a step (32 steps), the same function bit for bit
    wide_call = lambda i=0: sk.slot_pipeline_wide_plain(  # noqa: E731
        sbufs[i % 2], salive, T_SCAN, block=256)
    scan_plain_ms = _time_ms(wide_call, 1)
    err_wide = max(_max_err(a, b) for a, b in zip(
        sk.slot_pipeline(sbufs[0], salive, T_SCAN), wide_call()))
    _check(err_wide == 0, f"slot_pipeline kernel != slot_pipeline_wide_plain at T={T_SCAN}")
    # 4 rounds a slot: the slots without a quorum of one value take the coin
    scan4_call = lambda i=0: sk.slot_pipeline(sbufs[i % 2], salive, T_SCAN, 4)  # noqa: E731
    scan4_turns = [_time_ms(scan4_call, 8)]
    d4, p4 = scan4_call()
    coins4 = int((p4 == 1).sum())
    err_wide4 = max(_max_err(a, b) for a, b in zip(
        (d4, p4), sk.slot_pipeline_wide_plain(sbufs[0], salive, T_SCAN, 4, block=256)))
    _check(err_wide4 == 0, f"slot_pipeline kernel != slot_pipeline_wide_plain at T={T_SCAN}, "
                           f"4 rounds")
    _check(coins4 > 0, "no slot took the coin at 4 rounds")
    scan4_turns.append(_time_ms(scan4_call, 8))
    scan_turns.append(_time_ms(scan_call, 8))
    scan_ms, scan4_ms = min(scan_turns), min(scan4_turns)
    del d4, p4
    scan_bytes = T_SCAN * S_FULL * (R_FULL + 1 + 4) + S_FULL * R_FULL
    scan_bytes_ms = scan_bytes / _card_rate_bytes_per_s(name) * 1e3
    scan_ops_ms = pipeline_ops(S_FULL, R_FULL, T_SCAN) / INT32_OPS_PER_S * 1e3
    scan4_ops_ms = pipeline_ops(S_FULL, R_FULL, T_SCAN, 4, coins4) / INT32_OPS_PER_S * 1e3
    fgen = torch.Generator(device=device).manual_seed(1)
    fmasks = torch.stack([torch.rand((S_FULL, R_FULL, R_FULL), generator=fgen, device=device) < 0.6
                          for _ in range(80)])
    ffields = [t.contiguous() for t in fst0]
    falive_c = falive.contiguous()
    fault_call = lambda i=0: cluster_round.CLUSTER_ROUND.rounds(  # noqa: E731
        ffields, falive_c, fmasks, 80, **fk._kernel_args())
    # an empty kernel of as many threads as the round kernel's 256 blocks of 128
    fempty = lambda i=0: mesh_window.MESH_WINDOW.empty(1, S_FULL * 8, device)  # noqa: E731
    # the same launch with one mask for every round (mask stride 0) and
    # with none (full delivery): the share of the masks in its time
    fstatic = fmasks[0].contiguous()
    fault_split = {
        "stack": lambda i=0: fault_call(),
        "stride 0": lambda i=0: cluster_round.CLUSTER_ROUND.rounds(
            ffields, falive_c, fstatic, 80, **fk._kernel_args()),
        "none": lambda i=0: cluster_round.CLUSTER_ROUND.rounds(
            ffields, falive_c, None, 80, **fk._kernel_args()),
    }
    fault_times = {form: [] for form in fault_split}
    for form in [*fault_split, *list(fault_split)[::-1]]:
        fault_times[form].append(_graph_ms(fault_split[form], 20))
    fault_turns = fault_times["stack"]
    fempty_turns = [_graph_ms(fempty, 200), _graph_ms(fempty, 200)]
    fault_err = max(_max_err(a, b) for a, b in zip(fault_call(), fk.run_rounds_plain(
        fst0, falive, 80, torch.Generator(device=device).manual_seed(1), p_deliver=0.6)))
    _check(fault_err == 0, "the timed fault-path launch != run_rounds_plain")
    fault_run_ms = _time_ms(lambda i=0: fk.run_rounds(
        fst0, falive, 80, torch.Generator(device=device).manual_seed(1), p_deliver=0.6), 5)
    fault_plain_run_ms = _time_ms(lambda i=0: fk.run_rounds_plain(
        fst0, falive, 80, torch.Generator(device=device).manual_seed(1), p_deliver=0.6), 2)

    def fault_plain_loop(i=0):  # the kernel's function in plain PyTorch: 80 rounds on its masks
        st = fst0
        for m in fmasks:
            st = fk.round_step_plain(st, falive, m)
        return st

    fault_plain_ms = _time_ms(fault_plain_loop, 2)
    fneed = settle_rounds(fk, fst0, falive, fmasks)
    shard_rounds = int(fneed.sum())
    state_bytes = 2 * sum(t.numel() * t.element_size() for t in ffields)  # read once, written once
    fault_bytes = state_bytes + falive_c.numel() + shard_rounds * R_FULL * R_FULL
    fault_bytes_all = state_bytes + falive_c.numel() + fmasks.numel()  # every round's masks
    fault_bytes_ms = fault_bytes / _card_rate_bytes_per_s(name) * 1e3
    fault_ops_ms = rounds_ops(R_FULL, shard_rounds) / INT32_OPS_PER_S * 1e3
    fault_bound_ms = max(fault_bytes_ms, fault_ops_ms)
    del sbufs, short, fmasks
    # the [T, S, R] kernel beside the path it replaces (a relayout to
    # replica-major, then the replica-major kernel with phase), in turns
    talive_rm = talive.t().contiguous()
    relayout = lambda i=0: fused_window.FUSED_WINDOW(  # noqa: E731
        tbufs[i % 2].permute(2, 0, 1).contiguous(), talive_rm, q)
    tsr_call = lambda i=0: fused_window.FUSED_WINDOW_TSR(tbufs[i % 2], talive, q)  # noqa: E731
    relayout_ms = [_time_ms(relayout, 8)]
    tsr_turns = [_time_ms(tsr_call, CHAIN), _time_ms(tsr_call, CHAIN)]
    relayout_ms.append(_time_ms(relayout, 8))
    tsr_nophase_ms = _time_ms(
        lambda i=0: fused_window.FUSED_WINDOW_TSR(tbufs[i % 2], talive, q, want_phase=False), CHAIN)
    api_plain_ms = _time_ms(lambda i=0: fused_window.closed_form_window(tbufs[i % 2], talive, q), 2)
    del packed, bufs, tbufs
    # one serving-lane window on the device (16 slots, 2 queued per shard)
    mk = MeshPhaseKernel(S_FULL, R_FULL, device=device)
    wvotes = torch.zeros((16, S_FULL, R_FULL), dtype=torch.int8, device=device)
    wvotes[:2] = V1
    walive = torch.ones((S_FULL, R_FULL), dtype=torch.bool, device=device)
    wbase = torch.zeros(S_FULL, dtype=torch.int32, device=device)
    window_ms = _time_ms(lambda i=0: mk.slot_window(wvotes, walive, wbase, n_slots=16), 10)
    # the mesh-window kernel at the lane's shapes (16 slots, 2 voted V1),
    # beside an empty kernel at the same grid: the floor of a launch
    mw_call = lambda i=0: mesh_window.MESH_WINDOW(  # noqa: E731
        wvotes, walive, wbase, seed=mk.seed, coin_p1=mk.coin_p1, max_phases=4)
    empty_call = lambda i=0: mesh_window.MESH_WINDOW.empty(16, S_FULL, device)  # noqa: E731
    mw_turns = [_graph_ms(mw_call, 200)]  # device time of the kernel alone
    empty_turns = [_graph_ms(empty_call, 200), _graph_ms(empty_call, 200)]
    mw_turns.append(_graph_ms(mw_call, 200))
    mw_ms = min(mw_turns)
    mw_call_ms = _time_ms(mw_call, 50)  # one wrapper call, host launch time included
    mw_plain_ms = _time_ms(lambda i=0: mk.decide_slots_plain(wvotes, walive, wbase, 4), 10)
    mw_err = _max_err(mw_call(), mk.decide_slots_plain(wvotes, walive, wbase, 4))
    mw_phases, mw_coins = mesh_work(mk, wvotes, walive, wbase, 4)
    mw_bytes = wvotes.numel() + walive.numel() + 4 * wbase.numel() + wvotes.shape[0] * S_FULL
    # integer operations: fold R votes and alive flags into masks (3 a
    # replica), 10 a phase (tallies, selects), 24 a coin (4 hash rounds)
    mw_ops = wvotes.shape[0] * S_FULL * 3 * R_FULL + 10 * mw_phases + 24 * mw_coins
    mw_bytes_ms = mw_bytes / _card_rate_bytes_per_s(name) * 1e3
    mw_ops_ms = mw_ops / INT32_OPS_PER_S * 1e3

    # the kv window at the lane's shapes: a full random table (every op
    # scans all P slots), W=16 mixed ops at the table's widths, the reads
    # gathered to the GET waves as mixed_apply launches it; alone and with
    # the window's decision folded in, in turns
    gen = torch.Generator(device=device).manual_seed(8)
    K4, VW4, W = 8, 16, 16
    table, ops, _ = random_kv_case(gen, S_FULL, P_FULL, K4, VW4, W, K4, VW4, device, p_used=1.0)
    rkw = dict(want_reads=True, gidx=_gidx(ops[0]))
    kv_call = lambda i=0: kv_window.KV_WINDOW(table, *ops, W, **rkw)  # noqa: E731
    fold_call = lambda i=0: kv_window.KV_WINDOW.decide(  # noqa: E731
        table, *ops, W, walive, wbase, seed=mk.seed, coin_p1=mk.coin_p1, max_phases=4, **rkw)
    kv_turns = [_graph_ms(kv_call, 50)]  # device time of the kernel alone
    fold_turns = [_graph_ms(fold_call, 50), _graph_ms(fold_call, 50)]
    kv_turns.append(_graph_ms(kv_call, 50))
    kv_ms, fold_ms = min(kv_turns), min(fold_turns)
    kv_call_ms = _time_ms(kv_call, 20)  # one wrapper call, host launch time included
    fold_call_ms = _time_ms(fold_call, 20)
    kv_plain_ms = _time_ms(lambda i=0: kv_window.kv_window_plain(table, *ops, W, **rkw), 3)
    fold_plain_ms = _time_ms(lambda i=0: kv_window.decide_window_plain(
        mk, table, *ops, W, walive, wbase, 4, **rkw), 3)
    fold_err = max(_max_err(a, b) for a, b in zip(
        _flat(kv_window.decide_window_plain(mk, table, *ops, W, walive, wbase, 4, **rkw)),
        _flat(fold_call())))
    tbl_bytes = sum(x.numel() * x.element_size() for x in table)
    op_bytes = sum(x.numel() * x.element_size() for x in (*ops, rkw["gidx"]))
    read_bytes = rkw["gidx"].numel() * S_FULL * (8 + 4 * VW4) + S_FULL
    decide_bytes = walive.numel() + 4 * wbase.numel() + 4 * 3  # alive, base, flags
    rate = _card_rate_bytes_per_s(name)
    kv_bound_ms = (2 * tbl_bytes + op_bytes + read_bytes) / rate * 1e3
    fold_bound_ms = (2 * tbl_bytes + op_bytes + read_bytes + decide_bytes) / rate * 1e3

    # the dictionary form and the probe on the phase-7 table, at the lane's
    # shapes: the SET window with the decision on phase 7's fill stream (D
    # = W: every op its own row) and on the Zipf stream, beside the row
    # form, in turns; the probe beside the lookup window's kernel
    lane_alive = np.ones((S_FULL, R_FULL), bool)
    lane_base = np.zeros(S_FULL, np.int32)
    costs = pack_costs(dkv, S_FULL)
    zrng = np.random.default_rng(11)
    zk = _zipf_keys(zrng, W, S_FULL, P_FULL)
    zipf_sets = dkv.pack_window_dict([
        build_block(range(S_FULL), [[_set_op(_key(s, int(zk[t, s])), b"z%d" % zk[t, s])]
                                    for s in range(S_FULL)]) for t in range(W)])
    state = dkv.state

    def on_card(ops, values=True):
        return dkv._upload(dkv._host_ops(ops, W, values))

    fill_rows, fill_dict, zipf_dict = (on_card(win["set rows"]), on_card(win["set dict"]),
                                       on_card(zipf_sets))
    decide_kw = dict(seed=mk.seed, coin_p1=mk.coin_p1, max_phases=4)

    def set_call(planes):
        idx, klen, vlen, kw, vw = planes
        return lambda i=0: kv_window.KV_WINDOW.decide(state, None, klen, vlen, kw, vw, W, walive,
                                                      wbase, idx=idx, **decide_kw)

    row_call, dict_call, zdict_call = set_call(fill_rows), set_call(fill_dict), set_call(zipf_dict)
    set_turns = {"rows": [_graph_ms(row_call, 50)], "dict": [], "zipf": []}
    for _ in range(2):
        set_turns["dict"].append(_graph_ms(dict_call, 50))
        set_turns["zipf"].append(_graph_ms(zdict_call, 50))
    set_turns["rows"].append(_graph_ms(row_call, 50))
    dict_ms, zdict_ms = min(set_turns["dict"]), min(set_turns["zipf"])
    dict_plain_ms = _time_ms(lambda i=0: kv_window.decide_window_plain(
        mk, state, None, *fill_dict[1:], W, walive, wbase, 4, idx=fill_dict[0]), 3)
    dict_err = 0
    for planes in (fill_dict, zipf_dict):
        got = set_call(planes)()
        want = kv_window.decide_window_plain(mk, state, None, *planes[1:], W, walive, wbase, 4,
                                             idx=planes[0])
        dict_err = max([dict_err] + [_max_err(a, b) for a, b in zip(_flat(want), _flat(got))])
    # the read-only kernel on the phase-7 table, every wave of the probe and
    # the GET window in both forms, on phase 7's keys and on Zipf keys
    zget = [build_block(range(S_FULL), [[_key_op(2, _key(s, int(zk[t, s])))]
                                        for s in range(S_FULL)]) for t in range(W)]
    read_err = read_kernel_on_lane_table(dkv, mk, win, zget, W)
    # the probe on the GET window of lane_programs (D = 16), beside the GET
    # window (the read kernel with the decision) on the row and dictionary
    # forms of the same keys, beside an empty kernel at its grid
    gidx, gklen, _, gkw, _ = on_card(win["get dict"], values=False)
    _, rklen, _, rkw, _ = on_card(win["get rows"], values=False)
    probe_kw = dict(want_table=False, want_reads=True)
    probe_call = lambda i=0: kv_window.KV_WINDOW(  # noqa: E731
        state, kv_window.KIND_GET, gklen, None, gkw, None, 0, idx=gidx, **probe_kw)
    lookup_call = lambda i=0: kv_window.KV_WINDOW.decide(  # noqa: E731
        state, kv_window.KIND_GET, rklen, None, rkw, None, W, walive, wbase, **decide_kw,
        **probe_kw)
    dlookup_call = lambda i=0: kv_window.KV_WINDOW.decide(  # noqa: E731
        state, kv_window.KIND_GET, gklen, None, gkw, None, W, walive, wbase, idx=gidx,
        **decide_kw, **probe_kw)
    rempty = lambda i=0: mesh_window.MESH_WINDOW.empty(1, S_FULL * 32, device)  # noqa: E731
    probe_turns, lookup_turns, dlookup_turns = [_graph_ms(probe_call, 50)], [], []
    rempty_ms = _graph_ms(rempty, 200)
    for _ in range(2):
        lookup_turns.append(_graph_ms(lookup_call, 50))
        dlookup_turns.append(_graph_ms(dlookup_call, 50))
    probe_turns.append(_graph_ms(probe_call, 50))
    probe_ms, lookup_ms = min(probe_turns), min(lookup_turns)
    lookup_plain_ms = _time_ms(lambda i=0: kv_window.decide_window_plain(
        mk, state, kv_window.KIND_GET, rklen, None, rkw, None, W, walive, wbase, 4, **probe_kw), 3)
    lookup_err = max(_max_err(a, b) for a, b in zip(
        _flat(kv_window.decide_window_plain(mk, state, kv_window.KIND_GET, rklen, None, rkw, None,
                                            W, walive, wbase, 4, **probe_kw)),
        _flat(lookup_call())))
    probe_plain_ms = _time_ms(lambda i=0: kv_window.kv_window_plain(
        state, kv_window.KIND_GET, gklen, None, gkw, None, 0, idx=gidx, **probe_kw), 3)
    probe_want = kv_window.kv_window_plain(state, kv_window.KIND_GET, gklen, None, gkw, None, 0,
                                           idx=gidx, **probe_kw)
    probe_err = max(_max_err(a, b) for a, b in zip(_flat(probe_want), _flat(probe_call())))
    probe_prof = _device_busy(lambda i=0: dkv.lookup_only(win["get dict"], W=W), 10,
                              kernel="kv_window")
    # bounds: each input byte read once, each output byte written once
    nbytes = lambda xs: sum(x.numel() * x.element_size() for x in xs if x is not None)  # noqa: E731
    dict_bound_ms = (2 * tbl_bytes + nbytes(fill_dict) + S_FULL + decide_bytes) / rate * 1e3
    dict_ops_ms = dict_window_ops(S_FULL, P_FULL, int(fill_dict[1].shape[1]), W,
                                  state.keyw.shape[2]) / INT32_OPS_PER_S * 1e3
    zdict_bound_ms = (2 * tbl_bytes + nbytes(zipf_dict) + S_FULL + decide_bytes) / rate * 1e3
    # the probe reads the shards' used flags, keys and key lengths, and for
    # each distinct slot a GET finds, its version, value length and value
    found, ver = probe_want[2].found, probe_want[2].ver
    hit_slots = len({(int(s), int(v)) for s, v in zip(
        *(x.cpu().numpy() for x in (torch.nonzero(found)[:, 1], ver[found])))})
    probe_in = (state.used.numel() + 4 * (state.keyw.numel() + state.klen.numel())
                + hit_slots * (8 + 4 * state.valw.shape[2]))
    probe_out = W * S_FULL * (1 + 4 + 4 + 4 * state.valw.shape[2]) + S_FULL
    probe_bound_ms = (probe_in + nbytes((gidx, gklen, gkw)) + probe_out) / rate * 1e3
    # the GET window (row form, the same keys) adds the alive rows, the
    # bases, the flags and each shard's version counter (the wrap flag)
    lookup_bound_ms = (probe_in + nbytes((rklen, rkw)) + probe_out + decide_bytes
                       + 4 * S_FULL) / rate * 1e3

    # one whole SET window of the device lane (one upload, one launch) on
    # the phase-7 table, under the profiler
    lane_prof = _device_busy(lambda i=0: dkv.decide_apply(
        lane_alive, lane_base, W, win["set dict"], W=W), 10, kernel="kv_dict")
    rows_prof = _device_busy(lambda i=0: dkv.decide_apply(
        lane_alive, lane_base, W, win["set rows"], W=W), 10, kernel="kv_window")
    slot_prof = _device_busy(lambda i=0: mk.slot_window(wvotes, walive, wbase, n_slots=16), 10)

    # the ladder's kernels by graph replay beside their bounds, and the
    # packers with the C gather and with numpy at W=16 and at the largest
    # window the governed lane reached
    ladder_ms, ladder_ops_ms = ladder_times(dkv, dkv.kernel, S_FULL, R_FULL, ladder, rate)
    gov_top = max(gov["loose"]["walk"])
    pack9 = pack_native_vs_numpy(dkv, S_FULL, sorted({16, gov_top}))

    R, T, S = votes.shape
    nbytes = R * T * S + R * S + T * S
    bound_ms = nbytes / rate * 1e3
    bound_phase_ms = (nbytes + 4 * T * S) / rate * 1e3
    print(f"phase 4 decision core S={S} R={R} T={T}: kernel {kernel_ms:.4f} ms/window "
          f"({T * S / kernel_ms * 1e3:.4g} decisions/s, {nbytes / kernel_ms / 1e6:.1f} GB/s, "
          f"{bound_ms / kernel_ms:.1%} of the {bound_ms:.4f} ms bytes bound), "
          f"with phase {phase_ms:.4f} ms ({bound_phase_ms / phase_ms:.1%} of the "
          f"{bound_phase_ms:.4f} ms bound), "
          f"plain closed form {plain_ms:.3f} ms, plain packed window {packed_ms:.3f} ms, "
          f"max_abs_err {err4}")
    tsr_bytes = nbytes + 4 * T * S
    tsr_best = min(tsr_turns)
    print(f"phase 4 [T,S,R] entry (slot_pipeline_fused, with phase) S={S} R={R} T={T}: "
          f"{tsr_ms:.4f} ms/window through the entry; kernel "
          f"{' / '.join(f'{x:.4f}' for x in tsr_turns)} ms ({tsr_bytes / tsr_best / 1e6:.1f} GB/s, "
          f"{bound_phase_ms / tsr_best:.1%} of the {bound_phase_ms:.4f} ms bytes bound; the "
          f"replica-major kernel with phase: {bound_phase_ms / phase_ms:.1%}), "
          f"without phase {tsr_nophase_ms:.4f} ms ({bound_ms / tsr_nophase_ms:.1%} of "
          f"{bound_ms:.4f} ms); the relayout path it replaces "
          f"{' / '.join(f'{x:.4f}' for x in relayout_ms)} ms (in turns: relayout, kernel, kernel, "
          f"relayout); plain closed_form_window {api_plain_ms:.3f} ms; max_abs_err {err4_tsr}")
    device_share = window_ms * lane["first_flush_cycles"] / (lane["first_flush_s"] * 1e3)
    print(f"phase 4 packed window S={S} R={R} T={T} (SW={SW}): kernel "
          f"{' / '.join(f'{x:.4f}' for x in pw_turns)} ms ({pw_bytes / pw_ms / 1e6:.1f} GB/s; "
          f"bound {max(pw_bytes_ms, pw_ops_ms):.4f} ms: bytes {pw_bytes} -> {pw_bytes_ms:.4f} ms, "
          f"least int ops {packed_ops(R, T, SW)} -> {pw_ops_ms:.4f} ms; "
          f"{max(pw_bytes_ms, pw_ops_ms) / pw_ms:.1%}), plain {packed_ms:.3f} ms; beside the "
          f"replica-major kernel {kernel_ms:.4f} ms and the [T,S,R] kernel {tsr_best:.4f} ms; "
          f"max_abs_err {pw_err}")
    print(f"phase 4 packed window at bench.py's depth S={S_FULL} R={R_FULL} T={T_PACKED} "
          f"({deep_bytes / 1e9:.3f} GB, unanimous V1, every decision = the V1 row): "
          f"{deep_ms:.4f} ms a window ({S_FULL * T_PACKED / deep_ms * 1e3:.4g} decisions/s, "
          f"{deep_bytes / deep_ms / 1e6:.1f} GB/s, {deep_bound_ms / deep_ms:.1%} of the "
          f"{deep_bound_ms:.4f} ms bound); max_abs_err {err_deep}")
    scan4_bound_ms = max(scan_bytes_ms, scan4_ops_ms)
    print(f"phase 4 scanned protocol (slot_pipeline, the slot-pipeline kernel) S={S_FULL} "
          f"R={R_FULL} T={T_SCAN}, crash mask, in turns (2 rounds in the main path; then 2, 4, 4, "
          f"2): 2 rounds a slot {' / '.join(f'{x:.4f}' for x in scan_turns)} ms a window "
          f"({S_FULL * T_SCAN / scan_ms * 1e3:.4g} decisions/s; bound {max(scan_bytes_ms, scan_ops_ms):.4f} "
          f"ms: bytes {scan_bytes} -> {scan_bytes_ms:.4f} ms, least int ops "
          f"{pipeline_ops(S_FULL, R_FULL, T_SCAN)} -> {scan_ops_ms:.4f} ms; "
          f"{max(scan_bytes_ms, scan_ops_ms) / scan_ms:.1%}); 4 rounds a slot "
          f"{' / '.join(f'{x:.4f}' for x in scan4_turns)} ms ({coins4} entries took the coin; "
          f"bound {scan4_bound_ms:.4f} ms, least int ops "
          f"{pipeline_ops(S_FULL, R_FULL, T_SCAN, 4, coins4)} -> {scan4_ops_ms:.4f} ms; "
          f"{scan4_bound_ms / scan4_ms:.1%}); = slot_pipeline_fused at 2 rounds, max_abs_err "
          f"{err_scan}; = slot_pipeline_wide_plain (block 256) at T={T_SCAN}, max_abs_err "
          f"{err_wide} at 2 rounds, {err_wide4} at 4, plain {scan_plain_ms:.3f} ms at 2 rounds; "
          f"at T={T_PLAIN_SCAN}: kernel "
          f"{scan_short_ms:.4f} ms, plain slot_pipeline {scan_short_plain_ms:.3f} ms, max_abs_err "
          f"{err_short}")
    print(f"phase 4 fault path (python -m rabia_tpu --selftest's, at full width) S={S_FULL} "
          f"R={R_FULL} replicas [dead, up, up, dead, up], 80 rounds at p_deliver=0.6: every shard "
          f"decided, state = the plain loop's (max_abs_err {max(err_fault, fault_err)}); one "
          f"launch of 80 rounds (CUDA graph replay), in turns (stack, stride 0, none, none, stride 0, "
          f"stack): the 80-mask stack {' / '.join(f'{x:.4f}' for x in fault_times['stack'])} ms, "
          f"one mask for every round {' / '.join(f'{x:.4f}' for x in fault_times['stride 0'])} "
          f"ms, no mask (full delivery) {' / '.join(f'{x:.4f}' for x in fault_times['none'])} ms; "
          f"an empty kernel of as many threads {fempty_turns[0]:.4f} / {fempty_turns[1]:.4f} ms; "
          f"rounds before each shard settles: max {int(fneed.max())}, mean "
          f"{shard_rounds / S_FULL:.2f} ({shard_rounds} shard-rounds); bound "
          f"{fault_bound_ms:.5f} ms (bytes {fault_bytes} -> {fault_bytes_ms:.5f} ms, least int "
          f"ops {rounds_ops(R_FULL, shard_rounds)} -> {fault_ops_ms:.5f} ms; every round's masks: "
          f"{fault_bytes_all} bytes -> "
          f"{fault_bytes_all / _card_rate_bytes_per_s(name) * 1e3:.5f} ms); the whole run_rounds "
          f"call (80 mask draws, one launch) {fault_run_ms:.4f} ms; plain: 80 round_step_plain on "
          f"the same masks {fault_plain_ms:.3f} ms, run_rounds_plain {fault_plain_run_ms:.3f} ms")
    print(f"phase 16 (c) packers at S={S_FULL} R={R_FULL} T={T_FULL} and start_slot at "
          f"S={S_FULL} R={R_FULL} (device ms by CUDA graph replay, kernel / plain, in turns "
          f"kernel, plain, plain, kernel; bytes bound; the plain version's kernels a call "
          f"under the profiler), beside an empty kernel of the mesh window's grid "
          f"{ptimes['empty_kernel_ms']:.4f} ms: " + ", ".join(
              f"{pname} {r['ms']:.4f} / {r['plain_ms']:.4f} ms (bound {r['bound_ms']:.5f} ms, "
              f"{r['bound_ms'] / r['ms']:.1%}; plain {r['plain_kernels']} kernels"
              + (f"; an empty kernel at its grid and table {r['empty_ms']:.4f} ms, in turns "
                 f"kernel, empty, plain, plain, empty, kernel" if "empty_ms" in r else "") + ")"
              for pname, r in ptimes.items() if pname != "empty_kernel_ms")
          + f"; {json.dumps(ptimes)}")
    print(f"phase 16 (b) one engine tick's node_cycle at S={S_FULL} R={R_FULL} K=3 as the "
          f"engine runs it (planes in the kernel's pinned buffer, state in place, results into "
          f"the pinned host image, both mapped), in turns (kernel, empty, plain, plain, empty, "
          f"kernel; the kernel and an empty kernel at its grid by graph replay, the plain "
          f"version by CUDA events over a chain): {' / '.join(f'{x:.4f}' for x in nc_times['turns_ms'])} "
          f"ms; kernel {nc_times['ms']:.4f} ms over the empty kernel's {nc_times['empty_ms']:.4f} "
          f"ms, plain {nc_times['plain_ms']:.4f} ms ({nc_times['plain_kernels']} kernels); "
          f"round trip (planes in host memory -> state and outbox readable: one launch, one "
          f"event) {nc_times['round_trip_ms']:.4f} ms by the host clock over a chain; "
          f"{nc_times['mapped_bytes_per_tick']:.0f} bytes over the link a tick "
          f"({nc_times['link_read_bytes']} read, {nc_times['link_written_bytes']} written), "
          f"{nc_times['hbm_bytes']} in device memory; bound {nc_times['bound_ms']:.5f} ms "
          f"(the link {nc_times['link_bound_ms']:.5f} ms at {nc_times['link_GBps_up']:.2f} GB/s "
          f"up and {nc_times['link_GBps_down']:.2f} GB/s down, pinned copies; copies of the "
          f"tick's sizes alone {nc_times['pinned_up_ms']:.4f} / {nc_times['pinned_down_ms']:.4f} ms; "
          f"device memory {nc_times['hbm_bound_ms']:.5f} ms; the copy design's bytes bound "
          f"{nc_times['old_bytes'] / rate * 1e3:.5f} ms), {nc_times['bound_ms'] / nc_times['ms']:.1%}"
          f"; under the profiler {nc_times['trace']}; card: {smi}; {t_tick:.2f} s; "
          f"{json.dumps(nc_times)}")
    print(f"phase 16 (b) the engine's window, mw_window at S={S_FULL} R={R_FULL} T=16 on a "
          f"pinned staging buffer (mapped: votes, alive rows and bases read, decisions written "
          f"in place), in turns (kernel, empty, empty, kernel; graph replay): "
          f"{' / '.join(f'{x:.4f}' for x in win_times['turns_ms'])} ms; round trip (votes "
          f"staged -> decided readable: one launch, one event) {win_times['round_trip_ms']:.4f} "
          f"ms by the host clock over a chain; {win_times['link_read_bytes']} bytes read and "
          f"{win_times['link_written_bytes']} written over the link (a block of 16 entries x 16 "
          f"shards reads each byte once); bound {win_times['bound_ms']:.5f} ms (the link "
          f"{win_times['link_bound_ms']:.5f} ms at {win_times['link_GBps_up']:.2f} GB/s up and "
          f"{win_times['link_GBps_down']:.2f} GB/s down, pinned copies; copies of the window's "
          f"sizes alone {win_times['pinned_up_ms']:.4f} / {win_times['pinned_down_ms']:.4f} ms; "
          f"device memory "
          f"{win_times['hbm_bound_ms']:.5f} ms), {win_times['bound_ms'] / win_times['ms']:.1%}; "
          f"max_abs_err {win_times['max_abs_err']}; under the profiler {win_times['trace']}; "
          f"card: {smi}; {t_window:.2f} s; {json.dumps(win_times)}")
    print(f"phase 5 serving lane S={S_FULL} R={R_FULL} window=16: {json.dumps(lane)}; "
          f"slot_window on the device {window_ms:.4f} ms, {device_share:.2%} of the first submit+flush")
    print(f"phase 7 device KV lane S={S_FULL} R={R_FULL} window=16 P={P_FULL}: "
          f"{json.dumps(kv_lane)} ({t7:.2f} s)")
    print(f"phase 7 kv_window S={S_FULL} P={P_FULL} W={W} mixed, full table, device time (CUDA "
          f"graph replay), in turns (alone, fold, fold, alone): alone "
          f"{kv_turns[0]:.4f} / {kv_turns[1]:.4f} ms, with the decision folded in "
          f"{fold_turns[0]:.4f} / {fold_turns[1]:.4f} ms ({fold_ms / kv_ms - 1:+.1%}); "
          f"bytes bound {kv_bound_ms:.4f} ms ({kv_bound_ms / kv_ms:.1%} alone, "
          f"{fold_bound_ms / fold_ms:.1%} with the fold); one wrapper call {kv_call_ms:.4f} ms "
          f"alone, {fold_call_ms:.4f} ms with the fold; plain {kv_plain_ms:.3f} ms alone, "
          f"{fold_plain_ms:.3f} ms with the plain decision")

    def _fmt(p):
        dev = "device not measured" if p["device_ms"] is None else (
            f"device {p['device_ms']:.4f} ms ({p['device_ms'] / p['wall_ms']:.1%} busy), "
            f"{p['kernels']:g} kernels a call")
        return f"wall {p['wall_ms']:.4f} ms, {dev}"

    print("phase 7 decide_apply, lookup_window, mixed_apply, lookup_only: one kv-window launch "
          "of their form and no mesh-window launch each, in the row and the dictionary form")
    print(f"phase 8 read lane S={S_FULL} R={R_FULL} window=16 P={P_FULL}, 90/10 GET/SET groups: "
          f"{json.dumps(read_lane)} ({t8:.2f} s)")
    print(f"phase 8 packers (host ms a window of 16 full-width blocks, op-plane upload bytes; "
          f"rows vs auto): {json.dumps(costs)}")
    print(f"phase 8 kv_window SET with the decision S={S_FULL} P={P_FULL} W={W}, full table, "
          f"device time (CUDA graph replay), in turns (rows, dict, zipf, dict, zipf, rows): rows "
          f"{set_turns['rows'][0]:.4f} / {set_turns['rows'][1]:.4f} ms, dictionary D=16 "
          f"{set_turns['dict'][0]:.4f} / {set_turns['dict'][1]:.4f} ms "
          f"({dict_bound_ms / dict_ms:.1%} of its {dict_bound_ms:.4f} ms bytes bound; least int "
          f"ops {dict_ops_ms:.5f} ms), "
          f"Zipf dictionary D={int(zipf_dict[1].shape[1])} {set_turns['zipf'][0]:.4f} / "
          f"{set_turns['zipf'][1]:.4f} ms ({zdict_bound_ms / zdict_ms:.1%} of "
          f"{zdict_bound_ms:.4f} ms); plain {dict_plain_ms:.3f} ms; max_abs_err {dict_err}")
    print(f"phase 8 read-only kernel on the phase-7 table (probe and GET window, rows and "
          f"dictionary, uniform and Zipf keys) vs plain: max_abs_err {read_err}")
    print(f"phase 8 lookup_only probe S={S_FULL} W={W} D={int(gklen.shape[1])}, device time "
          f"(CUDA graph replay), in turns (probe, empty, GET window rows, dict, rows, dict, "
          f"probe): {probe_turns[0]:.4f} / {rempty_ms:.4f} / {lookup_turns[0]:.4f} / "
          f"{dlookup_turns[0]:.4f} / {lookup_turns[1]:.4f} / {dlookup_turns[1]:.4f} / "
          f"{probe_turns[1]:.4f} ms (the empty kernel at the read kernel's grid, {S_FULL // 8} "
          f"blocks of 256); probe bytes bound {probe_bound_ms:.5f} ms "
          f"({probe_bound_ms / probe_ms:.1%}; {hit_slots} slots read), GET window (rows) {lookup_bound_ms:.5f} ms "
          f"({lookup_bound_ms / lookup_ms:.1%}); plain {probe_plain_ms:.3f} ms probe, "
          f"{lookup_plain_ms:.3f} ms GET window; one lookup_only call under the profiler: "
          f"{_fmt(probe_prof)}; max_abs_err {probe_err} probe, {lookup_err} GET window")
    print(f"phase 7 one device-lane SET window (one upload, one kv_dict launch with the "
          f"decision, dictionary form) under the profiler: {_fmt(lane_prof)}"
          + ("" if lane_prof["kernel_ms"] is None else f", kv_dict {lane_prof['kernel_ms']:.4f} ms")
          + f"; the row form {_fmt(rows_prof)}"
          + ("" if rows_prof["kernel_ms"] is None else f", kv_window {rows_prof['kernel_ms']:.4f} ms"))
    print(f"phase 7 slot_window alone (S={S_FULL} R={R_FULL} 16 slots; the queue and host block "
          f"lanes) under the profiler: {_fmt(slot_prof)}")
    print(f"phase 7 mesh_window S={S_FULL} R={R_FULL} T=16: device time (CUDA graph replay), in "
          f"turns (window, empty, empty, window): {mw_turns[0]:.4f} / {empty_turns[0]:.4f} / "
          f"{empty_turns[1]:.4f} / {mw_turns[1]:.4f} ms; the window {mw_ms - min(empty_turns):+.4f} "
          f"ms over an empty kernel at its grid; one wrapper call {mw_call_ms:.4f} ms, "
          f"plain {mw_plain_ms:.3f} ms; "
          f"bound {max(mw_bytes_ms, mw_ops_ms):.5f} ms (bytes {mw_bytes} -> {mw_bytes_ms:.5f} ms, "
          f"int ops {mw_ops} -> {mw_ops_ms:.5f} ms; {mw_phases} phases, {mw_coins} coins)")
    print(f"phase 9 window ladder W={list(LADDER)} on the phase-7 table S={S_FULL} P={P_FULL}: "
          f"decide_apply, mixed_apply, lookup_window, lookup_only (rows and dictionary) and "
          f"slot_window at T=W, each one launch through its entry point: max_abs_err {err9} "
          f"against plain ({t9a:.2f} s)")
    for Wl, row in ladder_ms.items():
        print(f"phase 9 ladder W={Wl}: device ms (CUDA graph replay) / bound ms / share: " + ", ".join(
            f"{k} {ms:.4f} / {b:.5f} / {b / ms:.1%}" for k, (ms, b) in row.items())
            + "; the dictionary form's least int ops: " + ", ".join(
                f"{k} {o:.5f} ms" for k, o in ladder_ops_ms[Wl].items()))
    print(f"phase 9 governed device lane S={S_FULL} R={R_FULL} P={P_FULL} (loose target "
          f"{GOV_LOOSE_MS} ms, tight {GOV_TIGHT_MS} ms, max_window {GOV_MAX_WINDOW}): "
          f"{json.dumps(gov)} ({t9:.2f} s with the ladder and the SET lanes)")
    print(f"phase 9 SET lane (phase 7's fill) ops/s, in turns (native, numpy, numpy, native): "
          f"{json.dumps(lane_pack)}")
    print(f"phase 9 packers, host ms a window of phase 7's fill stream, C gather vs numpy, in turns: "
          f"{json.dumps(pack9)}")
    print(f"pack paths (windows by gather, main path): {json.dumps(pack_paths)}")
    print(f"main path: {launches} fused-window launches, {tsr_launches} [T,S,R] fused-window "
          f"launches, kv-window launches {json.dumps(kv_counts)}, {mesh_launches} mesh-window "
          f"launches, {packed_launches} packed-window launches, packer launches "
          f"{json.dumps(packer_counts)}, round-kernel launches {json.dumps(round_counts)}, "
          f"{main_s:.2f} s")

    kernels = [{
        "name": "fused_window",
        "route": "cuda",
        "source": "rabia_tpu_torch/csrc/fused_window.cu",
        "replaces": "rabia_tpu/kernel/fused_window.py:156",
        "launches": launches + p20["fused_window"],  # and phase 20's fuzz
        "max_abs_err": max(err2, err4),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes the quorum tally
    }, {
        "name": "fused_window_tsr",
        "route": "cuda",
        "source": "rabia_tpu_torch/csrc/fused_window.cu",
        "replaces": "rabia_tpu/kernel/fused_window.py:213",
        "launches": tsr_launches + p20["fused_window_tsr"],  # and phase 20's fuzz
        "max_abs_err": max(err2_tsr, err4_tsr),
        "ms": tsr_best,
        "plain_ms": api_plain_ms,
        "bound_ms": bound_phase_ms,
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes the quorum tally
    }, {
        "name": "kv_window",
        "route": "cuda",
        "source": "rabia_tpu_torch/csrc/kv_window.cu",
        "replaces": "rabia_tpu/apps/device_kv.py:1218",
        # and phases 12-15's, phase 18's (one a shard block over a mesh), 19's and 20's
        "launches": (kv_counts["rows+decide"] + p12["kv_window"] + p13["kv_window"]
                     + p14["kv_window"] + p15["kv_window"] + p18["kv_window"] + p19["kv_window"]
                     + p20["kv_window"]),
        "max_abs_err": max(err6, err6_fold, fold_err, err9),
        "ms": fold_ms,  # with the decision folded in, as the device lane launches it
        "plain_ms": fold_plain_ms,
        "bound_ms": fold_bound_ms,
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes an associative match-and-update
    }, {
        "name": "kv_window_dict",
        "route": "cuda",
        "source": "rabia_tpu_torch/csrc/kv_dict.cu",
        "replaces": "rabia_tpu/apps/device_kv.py:1003",
        # and phases 11 (c), 12-15, 18 (one a shard block over a mesh), 19 and 20
        "launches": (kv_counts["dict"] + kv_counts["dict+decide"] + p11_dict + p12["kv_dict"]
                     + p13["kv_dict"] + p14["kv_dict"] + p15["kv_dict"] + p18["kv_dict"]
                     + p19["kv_dict"] + p20["kv_dict"]),
        "max_abs_err": max(err8, dict_err, err9),
        "ms": dict_ms,  # SET window with the decision, D = W = 16 (phase 7's fill stream)
        "plain_ms": dict_plain_ms,
        "bound_ms": max(dict_bound_ms, dict_ops_ms),
        "bound_by": "bytes" if dict_bound_ms >= dict_ops_ms else "operations",
        "bytes_bound_ms": dict_bound_ms,
        "ops_bound_ms": dict_ops_ms,
        # phase 18 (c): the window through DeviceKVTable by CUDA events, host
        # issue included, on one device and on the 4x1 mesh (a launch a block)
        "table_ms": times18["dict_set"]["one_ms"],
        "mesh_4x1_ms": times18["dict_set"]["mesh_4x1_ms"],
        "library_ms": None,  # no single PyTorch call computes an associative match-and-update
    }, {
        "name": "kv_read_probe",
        "route": "cuda",
        "source": "rabia_tpu_torch/csrc/kv_read.cu",
        "replaces": "rabia_tpu/apps/device_kv.py:850",
        # and phases 13-15's: the gateway's ReadIndex reads (one a probe
        # round) and the mesh fabric's read lane; and phase 18's
        "launches": (kv_counts["probe dict"] + kv_counts["probe rows"] + p13["kv_read"]
                     + sum(f.get("probe dict", 0) + f.get("probe rows", 0)
                           for f in (p14_forms, p15_forms, p18_forms, p19_forms, p20_forms))),
        "max_abs_err": max(err8, probe_err, read_err, err9, probe14_err),
        "ms": probe_ms,
        "plain_ms": probe_plain_ms,
        "bound_ms": probe_bound_ms,
        "bound_by": "bytes",
        "table_ms": times18["probe"]["one_ms"],  # phase 18 (c), as the dictionary row's
        "mesh_4x1_ms": times18["probe"]["mesh_4x1_ms"],
        "library_ms": None,  # no single PyTorch call matches keys against a slot table
    }, {
        "name": "kv_read_get_window",
        "route": "cuda",
        "source": "rabia_tpu_torch/csrc/kv_read.cu",
        "replaces": "rabia_tpu/apps/device_kv.py:692",
        # and phases 14-15's and 18's GET windows with their decision
        "launches": sum(f.get("lookup dict", 0) + f.get("lookup rows", 0)
                        for f in (kv_counts, p14_forms, p15_forms, p18_forms, p19_forms,
                                  p20_forms)),
        "max_abs_err": max(err6_fold, err8, lookup_err, read_err, err9),
        "ms": lookup_ms,  # the row form with its decision, W=16 on the phase-7 table
        "plain_ms": lookup_plain_ms,
        "bound_ms": lookup_bound_ms,
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call matches keys against a slot table
    }, {
        "name": "mesh_window",
        "route": "cuda",
        "source": "rabia_tpu_torch/csrc/mesh_window.cu",
        "replaces": "rabia_tpu/parallel/mesh.py:353",
        # the main path's, phases 10 to 15, 17, 18 (the demoted lane's host path), 19 and 20
        "launches": (mesh_launches + p10_mesh + p11_mesh + p12["mesh_window"] + p13["mesh_window"]
                     + p14["mesh_window"] + p15["mesh_window"] + p17["mesh_window"] + p17_ranks
                     + p18["mesh_window"] + p19["mesh_window"] + p20["mesh_window"]),
        "max_abs_err": max(err2b, mw_err, err9, win17["max_abs_err"], win_times["max_abs_err"]),
        "ms": mw_ms,  # T=16 on device tensors, the mesh's blocks (as in every earlier line)
        "plain_ms": mw_plain_ms,
        "bound_ms": max(mw_bytes_ms, mw_ops_ms),
        "bound_by": "bytes" if mw_bytes_ms >= mw_ops_ms else "operations",
        # the engine's window: T=16 on its pinned stage, mapped; its bound
        # the link's (pinned copies) or device memory's, and its round trip
        "mapped_ms": win_times["ms"],
        "mapped_bound_ms": max(win_times["bound_ms"], mw_ops_ms),
        "round_trip_ms": win_times["round_trip_ms"],
        "library_ms": None,  # no single PyTorch call runs the weak-MVC phases
    }, {
        "name": "packed_window",
        "route": "cuda",
        "source": "rabia_tpu_torch/csrc/packed_window.cu",
        "replaces": "rabia_tpu/kernel/packed_window.py:139",
        "launches": packed_launches,
        "max_abs_err": max(err2c, pw_err, err_deep),
        "ms": pw_ms,  # S=4096 R=5 T=32768
        "plain_ms": packed_ms,
        "bound_ms": max(pw_bytes_ms, pw_ops_ms),
        "bound_by": "bytes" if pw_bytes_ms >= pw_ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes a bit-sliced quorum tally
    }, {
        "name": "cr_rounds",
        "route": "cuda",
        "source": "rabia_tpu_torch/csrc/cluster_round.cu",
        "replaces": "rabia_tpu/kernel/phase_driver.py:386",
        # and phase 17 (c)'s blocks, phase 19's and phase 20's fuzz
        "launches": (round_counts["rounds"] + p17_round["rounds"] + p19_round["rounds"]
                     + p20["cr_rounds"]),
        "max_abs_err": max(err2d, err_fault, fault_err, sc17["max_abs_err"]),
        "ms": min(fault_turns),  # the fault path: 80 rounds, S=4096 R=5, one launch
        "plain_ms": fault_plain_ms,  # 80 round_step_plain on the same masks
        "bound_ms": fault_bound_ms,
        "bound_by": "bytes" if fault_bytes_ms >= fault_ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call runs the weak-MVC rounds
    }, {
        "name": "cr_slot_pipeline",
        "route": "cuda",
        "source": "rabia_tpu_torch/csrc/cluster_round.cu",
        "replaces": "rabia_tpu/kernel/phase_driver.py:420",
        "launches": (round_counts["slot_pipeline"] + p17_round["slot_pipeline"]
                     + p19_round["slot_pipeline"] + p20["cr_slot_pipeline"]),
        "max_abs_err": max(err2d, err_scan, err_wide, err_wide4, err_short, sc17["max_abs_err"]),
        "ms": scan_ms,  # slot_pipeline, S=4096 R=5 T=8192
        "plain_ms": scan_plain_ms,  # slot_pipeline_wide_plain on the same votes
        "bound_ms": max(scan_bytes_ms, scan_ops_ms),
        "bound_by": "bytes" if scan_bytes_ms >= scan_ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call runs the weak-MVC rounds
    }, {
        "name": "cr_start_slot",
        "route": "cuda",
        "source": "rabia_tpu_torch/csrc/cluster_round.cu",
        "replaces": "rabia_tpu/kernel/phase_driver.py:202",
        "launches": (round_counts["start_slot"] + p17_round["start_slot"]
                     + p19_round["start_slot"] + p20["cr_start_slot"]),
        "max_abs_err": max(err16c, err2d, err_fault, sc17["max_abs_err"]),
        "ms": ptimes["start_slot"]["ms"],  # S=4096 R=5, every shard masked
        "empty_ms": ptimes["start_slot"]["empty_ms"],  # an empty kernel at its grid and table
        "sharded_ms": stimes17["start_slot"]["sharded_ms"],  # 4 shard blocks, one launch
        "plain_ms": ptimes["start_slot"]["plain_ms"],
        "bound_ms": ptimes["start_slot"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call opens a weak-MVC slot
    }, {
        "name": "node_cycle",
        "route": "cuda",
        "source": "rabia_tpu_torch/csrc/node_kernel.cu",
        "replaces": "rabia_tpu/kernel/phase_driver.py:761",
        # phase 16 (d)'s engine ticks (with node_step and start_slots, the
        # same kernel's launches with no mask and K = 1, and K = 0), and
        # phase 20's soak on backend="jax"
        "launches": sum(p16_node.values()) + p20["node_kernel"],
        "max_abs_err": err16b,
        "ms": nc_times["ms"],  # one tick, S=4096 R=5 K=3, in place, mapped planes and image
        "plain_ms": nc_times["plain_ms"],
        "bound_ms": nc_times["bound_ms"],  # the link's, by pinned copies, or device memory's
        "bound_by": "bytes",
        "round_trip_ms": nc_times["round_trip_ms"],
        "library_ms": None,  # no single PyTorch call runs the weak-MVC node step
    }] + [{
        "name": pname,
        "route": "cuda",
        "source": "rabia_tpu_torch/csrc/packed_window.cu",
        "replaces": f"rabia_tpu/kernel/packed_window.py:{line}",
        "launches": packer_counts[pname],
        "max_abs_err": max(err16c, err2c),
        # S=4096 R=5 T=32768 (pack_alive: R x S; pack_inputs: both)
        "ms": ptimes[pname]["ms"],
        "plain_ms": ptimes[pname]["plain_ms"],
        "bound_ms": ptimes[pname]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call packs 2-bit codes into words
    } for pname, line in (("pack_codes", 56), ("unpack_codes", 75), ("pack_alive", 84),
                          ("pack_inputs", 56))]
    _check(all(isinstance(r["launches"], int) and r["launches"] > 0 for r in kernels),
           f"the kernels line's launches: {[(r['name'], r['launches']) for r in kernels]}")
    lap("timings (phases 4-9, 16 (b)-(c)) and the kernels line")
    for name_, secs in phase_s.items():
        print(f"chip_smoke phase {name_}: {secs:.1f} s")
    print(f"chip_smoke: {time.perf_counter() - t_main:.1f} s in all, the build included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
